"""Silent data corruption (counterpart of ``neuronx_distributed_tpu/integrity``):
:mod:`.sentinel`, the trainer's canary check with rollback; :mod:`.voting`,
the host vote over replicas' fingerprints; :mod:`.checkpoint`, the CRC
manifests of verified checkpoints; :mod:`.chaos`, the bit-flip hands of the
``flip_bits`` schedules. The fingerprint itself lives in
``utils/fingerprint.py``."""

from neuronx_distributed_tpu_torch.integrity.sentinel import (  # noqa: F401
    SentinelConfig,
    SentinelVerdict,
    TrainerSentinel,
)
from neuronx_distributed_tpu_torch.integrity.voting import VoteVerdict, vote, vote_sequence  # noqa: F401
