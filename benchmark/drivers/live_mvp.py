"""Entry `live_mvp`: one camera rig's stream of frames served by the port's
`PoseService` with MvP (`MODEL: mvp`), as an open loop: `live_service`'s
loop, with MvP's seeded weights (`core/mvp_weights.py`) beside the planted
Pose-ResNet-50 of `core/weights.py`, its plain reference
(`reference/mvp.py`) and its work count (`counts/mvp.py`).  A program
without MvP fails at once, on its import.

After the window, every pool input the window used is replayed once
through the same captured graph for all its instance slots
(`infer_images_raw`); an answer that is not its input's slots above the
threshold, poses and scores as the graph gave them, counts as a failed
request.  Then the program's state is freed and the reference computes
the same inputs on the same device in float32.  The comparison is slot
for slot (MvP's queries have a fixed order, so each slot pairs with its
own, whatever its score), over the window's answered requests:

- pose_mean_mm (the cell's `limits`): `core/compare.py`'s number with that
  pairing, the mean over every slot of its mean joint error (mm), capped
  at MISS_MM; no slot is dropped or served in excess;
- slot_pose_mm (`slot_limits`): over the N slots, the largest mean over
  the requests of the slot's mean joint error;
- score_gap (`slot_limits`): the largest |served - reference| person score
  of any slot of any request.

`load_arrays`, `build_service` and `reference_answers` keep
`live_service`'s signatures, so that `tools/knee.py` runs on this entry
(`tools/mvp.py`): the configuration's weights are drawn, not read, and the
drawn state dicts are kept in the `arrays` holder for the reference.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Iterable, List, Mapping, Tuple

import numpy as np
import torch

from ..core import compare, trace as tracing
from ..core.mvp_weights import mvp_weights
from ..core.record import Run
from ..core.weights import backbone_weights
from ..counts import mvp as counts
from ..counts.peaks import peaks_for
from ..reference.mvp import Geometry, MvPReference
from ..reference.precision import pin_float32
from ..traffic.generate import Traffic, make_traffic
from .live_service import GRAPHS, WARM_REQUESTS, port_config, serve

SLOT_NUMBERS = ("slot_pose_mm", "score_gap")
NUMBERS = ("pose_mean_mm",) + SLOT_NUMBERS


def load_arrays(path) -> dict:
    """A holder for the drawn weights (`build_service` fills it); the
    configuration names no file."""
    return {}


def build_service(cell, traffic: Traffic, arrays, seed: int, device):
    """The service with the seed's Pose-ResNet-50 and MvP loaded and the
    'images_u8' graph captured; returns it and (backbone, mvp) state
    dicts."""
    from faster_voxelpose_tpu_torch.engine.service import PoseService
    from faster_voxelpose_tpu_torch.models.mvp import MvPNet

    if cell.workload["method"] != "infer_images":
        raise ValueError(f"live_mvp drives infer_images, not {cell.workload['method']}")
    cfg = port_config(cell.config)
    svc = PoseService(cfg, rig=traffic.rig, device=device, seed=0, aot=False)
    if not isinstance(svc.model, MvPNet):
        raise TypeError(f"the port built {type(svc.model).__name__} for MODEL mvp")
    weights = (backbone_weights(cfg.DATASET.NUM_JOINTS, seed, device),
               mvp_weights(cell.config["yaml"], seed, device))
    svc.backbone.load_state_dict(weights[0])
    svc.model.load_state_dict(weights[1])
    arrays["state"] = weights
    if device.type == "cuda":
        svc.warmup((GRAPHS["infer_images"],))
    return svc, weights


def program_slots(svc, traffic: Traffic, entries: Iterable[int]) -> Dict[int, np.ndarray]:
    """Every instance slot (N, J, 5) the service's graph gives for each pool
    entry in `entries`."""
    return {e: svc.infer_images_raw(traffic.pool[e])[0][0] for e in sorted(set(entries))}


def answer_is_slots(answer: Mapping, slots: np.ndarray) -> bool:
    """Whether a served answer is exactly the slots above the threshold:
    their poses and scores, in slot order."""
    valid = slots[:, 0, 3] >= 0
    poses = np.asarray(answer["poses_mm"], np.float32).reshape(-1, slots.shape[1], 3)
    return (np.array_equal(poses, slots[valid][:, :, :3])
            and np.array_equal(np.asarray(answer["scores"], np.float32), slots[valid][:, 0, 4]))


def reference_answers(cell, traffic: Traffic, arrays, weights, entries, device,
                      precision: str = "float32") -> Dict[int, Dict[str, np.ndarray]]:
    """The reference's slots for each pool entry in `entries`: 'poses' (N,
    J, 3), 'scores' (N,), 'valid' (N,)."""
    pin_float32()
    backbone, state = weights if weights is not None else arrays["state"]
    ref = MvPReference(Geometry.from_config(cell.config["yaml"]), backbone, state, device,
                       precision)
    cams = torch.as_tensor(traffic.rig, device=device)
    out = {}
    for e in sorted(set(entries)):
        r = ref(torch.as_tensor(traffic.pool[e]).to(device), cams)
        out[e] = {k: v.cpu().numpy() for k, v in r.items()}
    return out


def judge(slots: Mapping[int, np.ndarray], entries: List[int],
          refs: Mapping[int, Mapping]) -> Dict[str, float]:
    """`pose_mean_mm`, `slot_pose_mm` and `score_gap` over the requests'
    pool entries (repeats counted), slot for slot; infinite where no
    request was answered."""
    if not entries:
        return {k: float("inf") for k in NUMBERS}
    err = np.stack([np.linalg.norm(slots[e][:, :, :3].astype(np.float64) - refs[e]["poses"],
                                   axis=-1).mean(-1) for e in entries])  # (requests, N)
    gap = np.stack([np.abs(slots[e][:, 0, 4].astype(np.float64) - refs[e]["scores"])
                    for e in entries])
    return {"pose_mean_mm": float(np.minimum(err, compare.MISS_MM).mean()),
            "slot_pose_mm": float(err.mean(0).max()), "score_gap": float(gap.max())}


def checks_of(readings: Mapping, workload: Mapping) -> Dict[str, Tuple[float, float]]:
    """{name: (reading, limit)} of the cell's `limits` and `slot_limits`."""
    limits = dict(workload["limits"], **workload.get("slot_limits", {}))
    return {k: (readings[k], float(limits[k])) for k in NUMBERS if k in limits}


def run(ctx) -> Tuple[Run, Dict[str, Tuple[float, float]], dict]:
    """One run of the cell: set-up, the window, with --trace 1 a traced
    segment, the graph's slots of every input used, then the reference
    and the checks."""
    # a program without MvP fails here, at once
    import faster_voxelpose_tpu_torch.models.mvp  # noqa: F401

    cell, device = ctx.cell, ctx.device
    w = cell.workload
    record = Run(cell.name, ctx.seconds, cell.config["yaml"])
    traffic = make_traffic(cell.mix, cell.config, float(w["rate"]), ctx.seconds, ctx.seed,
                           device)
    arrays = load_arrays(None)
    svc, weights = build_service(cell, traffic, arrays, ctx.seed, device)
    call = getattr(svc, w["method"])
    for i in range(min(WARM_REQUESTS, len(traffic.pool))):
        call(traffic.pool[traffic.order[i % len(traffic.order)]])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    # the client's own garbage stays uncollected through the window
    gc.collect()
    gc.disable()

    t0 = time.perf_counter() + 0.01
    record.setup_s = t0 - ctx.t_start
    reqs, answers = serve(call, traffic, traffic.order, traffic.due, t0, t0 + ctx.seconds)
    gc.enable()
    device_info = ctx.device_info()

    if ctx.trace:
        n = int(w["trace_requests"])
        order = np.resize(traffic.order, n)
        due = traffic.due[:n] if n <= len(traffic.due) else np.arange(n) / float(w["rate"])

        def segment():
            s0 = time.perf_counter() + 0.01
            seg, _ = serve(call, traffic, order, due, s0, s0 + due[-1],
                           span=tracing.REQUEST_SPAN)
            record.traced_entries = [r.entry for r in seg]

        record.trace = tracing.profile(segment)
    answered = [r.entry for r, a in zip(reqs, answers) if a is not None]
    slots = program_slots(svc, traffic, set(answered) | set(record.traced_entries))
    for r, a in zip(reqs, answers):
        if a is not None and not answer_is_slots(a, slots[r.entry]):
            r.ok = False
    record.requests = reqs
    record.attempted = len(traffic.due)
    record.failed = record.attempted - sum(r.ok for r in reqs)
    del svc, call
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    refs = reference_answers(cell, traffic, arrays, weights, slots, device)
    checks = checks_of(judge(slots, [r.entry for r in reqs if r.ok], refs), w)
    record.flops_per_request = counts.request_flops(cell.config["yaml"])
    record.peaks = peaks_for(device_info["kind"])
    return record, checks, device_info
