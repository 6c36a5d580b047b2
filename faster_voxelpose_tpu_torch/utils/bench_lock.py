"""Cooperative sharing of the card between a benchmark and long-running
training (the port's copy of `faster_voxelpose_tpu/utils/bench_lock.py`,
the same lock file).

A benchmark holds :func:`hold_bench_lock` around its measurements; the
train and eval batch loops call :func:`wait_if_bench_locked` once per
step, and while the lock exists they sleep instead of dispatching, so
the card drains to the benchmark within one step.  A lock older than
``STALE_S`` is ignored (a crashed benchmark must never hang training),
and the waiter re-checks its age each poll.

Two repairs of the JAX package's copy: the lock is created with
``O_CREAT | O_EXCL``, so a second holder waits for (or refuses) a fresh
lock instead of overwriting it, and only the holder that made a lock
removes it; and a daemon thread refreshes the lock's mtime every
``STALE_S / 4`` while it is held, so a run longer than ``STALE_S`` keeps
it.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time

logger = logging.getLogger(__name__)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LOCK_PATH = os.path.join(_REPO, ".bench_lock")
STALE_S = 1800.0  # a bench run is minutes, not half-hours
POLL_S = 2.0


class BenchLockHeld(RuntimeError):
    """A fresh bench lock is held by another run."""


def _lock_age(path: str = LOCK_PATH) -> float | None:
    """Seconds since the lock was created or last refreshed, or None if
    absent."""
    try:
        return time.time() - os.stat(path).st_mtime
    except OSError:
        return None


def _read(path: str) -> str | None:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def _create(path: str, token: str) -> bool:
    """Create the lock holding `token`; False if it exists already."""
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
    except FileExistsError:
        return False
    with os.fdopen(fd, "w") as f:
        f.write(token)
    return True


def _refresh(path: str, token: str, stop: threading.Event, every_s: float) -> None:
    while not stop.wait(every_s):
        if _read(path) != token:  # taken away (removed, or replaced as stale)
            return
        try:
            os.utime(path)
        except OSError:
            return


@contextlib.contextmanager
def hold_bench_lock(path: str = LOCK_PATH, wait_s: float = 0.0):
    """Hold the lock for the duration of a benchmark run.  A fresh lock
    of another holder is waited for up to `wait_s` seconds, then refused
    with BenchLockHeld; a stale one is taken over.  While held, a daemon
    thread refreshes the lock's mtime; on exit the lock is removed if it
    is still this holder's."""
    token = f"{os.getpid()} {threading.get_ident()} {time.time_ns()}"
    deadline = time.monotonic() + wait_s
    while not _create(path, token):
        age = _lock_age(path)
        if age is not None and age > STALE_S:
            logger.warning("bench lock %s is %.0f s old; taking it over", path, age)
            with contextlib.suppress(OSError):
                os.remove(path)
            continue
        if time.monotonic() >= deadline:
            raise BenchLockHeld(f"bench lock {path} is held ({_read(path)!r}, "
                                f"{age if age is None else round(age, 1)} s old)")
        time.sleep(min(POLL_S, max(deadline - time.monotonic(), 0.0)))
    stop = threading.Event()
    refresher = threading.Thread(target=_refresh, args=(path, token, stop, STALE_S / 4),
                                 name="bench_lock_refresh", daemon=True)
    refresher.start()
    try:
        yield
    finally:
        stop.set()
        refresher.join()
        if _read(path) == token:
            with contextlib.suppress(OSError):
                os.remove(path)


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
