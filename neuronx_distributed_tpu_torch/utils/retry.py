"""The shared transient-fault retry policy (counterpart of
``neuronx_distributed_tpu/utils/retry.py``: ``RetryPolicy`` and
``with_retries``).

One wait schedule serves every consumer that has to ride out a burst of
transient failures; here the serving engine's dispatch-recovery loop
(``serving/engine.py``). The schedule DEcrements: the first wait is the
longest (outlast the burst), later waits shrink toward ``min_wait``, and
every wait is jittered into ``[0.5, 1.5) x wait`` so that many retriers
never retry in phase. ``rng`` and ``sleep`` are injectable so that tests pin
the exact schedule."""

from __future__ import annotations

import dataclasses
import logging
import random as _random
import time as _time
from typing import Callable, Optional, Tuple

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with decrementing jittered waits.

    ``max_attempts`` counts TOTAL tries (1 initial + max_attempts - 1
    retries). ``wait(k)`` is the pause after failed attempt ``k`` (0-based):
    ``max(min_wait, first_wait / (k + 1))`` scaled by a jitter factor in
    ``[0.5, 1.5)``."""

    max_attempts: int = 5
    first_wait: float = 4.0
    min_wait: float = 0.5

    def base_wait(self, attempt: int) -> float:
        """The un-jittered wait after 0-based failed attempt ``attempt``."""
        return max(self.min_wait, self.first_wait / (attempt + 1))

    def wait(self, attempt: int, rng=None) -> float:
        """The jittered wait after 0-based failed attempt ``attempt``."""
        r = (rng if rng is not None else _random).random()
        return self.base_wait(attempt) * (0.5 + r)


def with_retries(
    fn: Callable,
    what: str,
    policy: RetryPolicy = RetryPolicy(),
    transient: Tuple[type, ...] = (OSError, IOError, TimeoutError),
    passthrough: Tuple[type, ...] = (FileNotFoundError,),
    sleep: Optional[Callable[[float], None]] = None,
    rng=None,
):
    """Call ``fn()``, riding out up to ``policy.max_attempts`` transient
    failures. ``passthrough`` errors raise at once (a missing object is a
    result, not a fault); after the final attempt the last transient error
    raises. ``sleep``/``rng`` default to ``time.sleep`` and the global
    ``random`` module."""
    last: Optional[BaseException] = None
    for attempt in range(policy.max_attempts):
        try:
            return fn()
        except passthrough:
            raise
        except transient as e:  # noqa: PERF203
            last = e
            if attempt == policy.max_attempts - 1:
                break
            pause = policy.wait(attempt, rng=rng)
            logger.warning("%s failed (%s: %s) — retry %d/%d in %.1fs", what,
                           type(e).__name__, e, attempt + 1, policy.max_attempts - 1, pause)
            (sleep if sleep is not None else _time.sleep)(pause)
    raise last  # type: ignore[misc]
