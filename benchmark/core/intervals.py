"""Device intervals of the program's span log found by the program's own
names (`faster_voxelpose_tpu_torch.utils.profiling.DEVICE_INTERVALS`),
for intervals beyond the five columns `spans.py` reads by position.
Nothing to read (None) where the program names no such interval, or
where `spans.window` finds nothing."""

from __future__ import annotations

from typing import Optional

from . import spans


def device_p50(run, name: str) -> Optional[float]:
    """p50 over the window's requests of the program's device interval
    `name`, ms."""
    try:
        from faster_voxelpose_tpu_torch.utils import profiling
    except ImportError:
        return None
    names = tuple(getattr(profiling, "DEVICE_INTERVALS", ()))
    w = spans.window(run)
    if w is None or name not in names or w["device_ms"].shape[1] <= names.index(name):
        return None
    return spans.p50(w["device_ms"][:, names.index(name)])
