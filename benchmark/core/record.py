"""What one run measured, for the metric readers (`metrics/*.py`)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Request:
    due: float  # s, host clock (perf_counter)
    entered: float  # when the call into the program began
    done: float  # when its answer was decoded on the host
    entry: int  # the pool input it carried
    ok: bool


@dataclass
class Run:
    cell: str
    seconds: float
    yaml: dict = field(default_factory=dict)  # the configuration's published YAML
    setup_s: float = 0.0
    requests: List[Request] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    # --trace 1: the traced segment's analysis (core/trace.py), its
    # requests' pool entries, and per-stage device times of lone graphs
    trace: Optional[dict] = None
    traced_entries: List[int] = field(default_factory=list)
    stage_ms: Dict[str, float] = field(default_factory=dict)
    # work counts of the cell (counts/): FLOPs a request; per pool entry
    # the live crop voxels of the reference's valid proposals
    flops_per_request: float = 0.0
    live_voxels: Dict[int, int] = field(default_factory=dict)
    peaks: Dict[str, float] = field(default_factory=dict)

    def latencies_ms(self) -> np.ndarray:
        """Due -> answered, ms, every request answered."""
        return np.array([(r.done - r.due) * 1e3 for r in self.requests if r.ok])

    def queue_waits_ms(self) -> np.ndarray:
        return np.array([(r.entered - r.due) * 1e3 for r in self.requests if r.ok])
