"""Silent data corruption: the serving side (counterpart of
``neuronx_distributed_tpu/integrity``): :mod:`.voting`, the host vote over
replicas' fingerprints, and :mod:`.chaos`, the bit-flip hands of the
``flip_bits`` schedules. The fingerprint itself lives in
``utils/fingerprint.py``. The trainer's sentinel and the verified
checkpoints wait for the trainer loop (``ROADMAP.md`` item 7)."""

from neuronx_distributed_tpu_torch.integrity.voting import VoteVerdict, vote, vote_sequence  # noqa: F401
