"""Cooperative sharing of the card between a benchmark and long-running
training (the port's copy of `faster_voxelpose_tpu/utils/bench_lock.py`,
the same lock file).

A benchmark holds :func:`hold_bench_lock` around its measurements; the
train and eval batch loops call :func:`wait_if_bench_locked` once per
step, and while the lock exists they sleep instead of dispatching, so
the card drains to the benchmark within one step.  A lock older than
``STALE_S`` is ignored (a crashed benchmark must never hang training),
and the waiter re-checks its age each poll.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

logger = logging.getLogger(__name__)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LOCK_PATH = os.path.join(_REPO, ".bench_lock")
STALE_S = 1800.0  # a bench run is minutes, not half-hours
POLL_S = 2.0


def _lock_age(path: str = LOCK_PATH) -> float | None:
    """Seconds since the lock was created, or None if absent."""
    try:
        return time.time() - os.stat(path).st_mtime
    except OSError:
        return None


@contextlib.contextmanager
def hold_bench_lock(path: str = LOCK_PATH):
    """Create the lock for the duration of a benchmark run."""
    with open(path, "w") as f:
        f.write(str(os.getpid()))
    try:
        yield
    finally:
        try:
            os.remove(path)
        except OSError:
            pass


def wait_if_bench_locked(path: str = LOCK_PATH) -> float:
    """Sleep while a fresh bench lock exists; return seconds waited."""
    waited = 0.0
    announced = False
    while True:
        age = _lock_age(path)
        if age is None or age > STALE_S:
            return waited
        if not announced:
            logger.info("bench lock %s present; pausing dispatch", path)
            announced = True
        time.sleep(POLL_S)
        waited += POLL_S
