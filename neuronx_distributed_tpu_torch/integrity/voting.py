"""Cross-replica fingerprint voting, host arithmetic only (counterpart of
``neuronx_distributed_tpu/integrity/voting.py``: ``VoteVerdict``, ``vote``
``:45``, ``vote_sequence``).

Replicas serving one model must hold bit-identical weights, so their
fingerprints must agree: a divergent value convicts its replica, the
majority wins and no golden recompute is needed. This module sees host
integers only (the router's probes return them over the transport)."""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, Sequence, Tuple

__all__ = ["VoteVerdict", "vote", "vote_sequence"]


@dataclasses.dataclass(frozen=True)
class VoteVerdict:
    """The outcome of one vote. ``clean``: every voter agreed.
    ``convicted``: the voters holding a strict-minority value (empty when
    clean or when no strict majority exists). ``localized`` False: the values
    disagree but no voter can be blamed (a tie), so the caller fences
    nobody."""

    clean: bool
    convicted: Tuple = ()
    localized: bool = True
    quorum_value: int = 0
    values: Dict = dataclasses.field(default_factory=dict)

    @property
    def detected(self) -> bool:
        return not self.clean


def vote(values: Dict) -> VoteVerdict:
    """Majority vote over ``{voter: fingerprint}``: one distinct value is
    clean; a strict-majority value convicts every voter holding another;
    no strict majority (1-1, 2-2, a three-way split) is detected but not
    localized."""
    if not values:
        return VoteVerdict(clean=True)
    counts = Counter(values.values())
    if len(counts) == 1:
        (only,) = counts
        return VoteVerdict(clean=True, quorum_value=only, values=dict(values))
    majority, n_major = counts.most_common(1)[0]
    if n_major * 2 > len(values):
        convicted = tuple(k for k, v in values.items() if v != majority)
        return VoteVerdict(clean=False, convicted=convicted, localized=True,
                           quorum_value=majority, values=dict(values))
    return VoteVerdict(clean=False, convicted=(), localized=False, values=dict(values))


def vote_sequence(pairs: Sequence[Tuple]) -> VoteVerdict:
    """:func:`vote` over ``[(voter, value)]`` pairs."""
    return vote(dict(pairs))
