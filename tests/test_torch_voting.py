"""The cross-replica vote (``integrity/voting.py``) against the JAX
package's on the cases of ``tests/integrity/test_voting.py``, as one
parametrised test: every verdict field equal (host integers, no tolerance)."""

import pytest

from neuronx_distributed_tpu.integrity.voting import VoteVerdict as JVoteVerdict
from neuronx_distributed_tpu.integrity.voting import vote as jvote
from neuronx_distributed_tpu.integrity.voting import vote_sequence as jvote_sequence
from neuronx_distributed_tpu_torch.integrity import VoteVerdict, vote, vote_sequence

CASES = {
    "unanimous": {0: 7, 1: 7, 2: 7, 3: 7},
    "empty": {},
    "single_voter": {0: 123},
    "strict_minority": {0: 7, 1: 7, 2: 9, 3: 7},
    "multiple_divergent": {0: 7, 1: 8, 2: 9, 3: 7, 4: 7},
    "even_split": {0: 7, 1: 7, 2: 9, 3: 9},
    "two_replicas": {0: 7, 1: 9},
    "three_way_split": {0: 1, 1: 2, 2: 3},
    "string_voters": {"a": 5, "b": 5, "c": 6},
}


def _fields(v):
    return (v.clean, v.detected, tuple(v.convicted), v.localized, v.quorum_value, dict(v.values))


@pytest.mark.parametrize("case", sorted(CASES))
def test_vote_equals_jax(case):
    values = CASES[case]
    got, want = vote(values), jvote(values)
    assert _fields(got) == _fields(want)
    pairs = list(values.items())
    assert _fields(vote_sequence(pairs)) == _fields(jvote_sequence(pairs)) == _fields(want)
    if case == "strict_minority":
        assert got.convicted == (2,) and got.quorum_value == 7
    if case in ("even_split", "two_replicas", "three_way_split"):
        assert got.detected and not got.localized and got.convicted == ()


def test_verdict_detected_property():
    assert not VoteVerdict(clean=True).detected and not JVoteVerdict(clean=True).detected
    assert VoteVerdict(clean=False).detected and JVoteVerdict(clean=False).detected
