"""Entry `live_voxelpose`: one camera rig's stream of heatmaps served by
the port's `PoseService` with VoxelPose (`MODEL: voxelpose`), as an open
loop: `live_service`'s loop, answers and judgement, with VoxelPose's
seeded, planted weights (`core/voxelpose_weights.py`), its plain
reference (`reference/voxelpose.py`) and its work count
(`counts/voxelpose.py`).  A program without VoxelPose fails at once, on
its import.

After the window the program's state is freed and the reference computes
every pool input the window used, on the same device in float32; each
answer is compared with its input's reference (`core/compare.py`), and
slot by slot (`judge`): a fault confined to one of the ten proposal
slots, or a shift of the cubes by a voxel, moves the mean over every
person too little to pass `limits`, so the cell's `slot_limits` hold each
slot's own numbers.

`load_arrays`, `build_service` and `reference_answers` keep
`live_service`'s signatures, so that `tools/knee.py` and
`tools/readings.py` run on this entry (`tools/voxelpose.py`): the
configuration's weights are drawn, not read, and the drawn state dict is
kept in the `arrays` holder for the reference.
"""

from __future__ import annotations

import gc
import time
from collections import defaultdict
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core import compare, trace as tracing
from ..core.record import Run
from ..core.voxelpose_weights import voxelpose_weights
from ..counts import voxelpose as counts
from ..counts.peaks import peaks_for
from ..reference.precision import pin_float32
from ..reference.voxelpose import Geometry, VoxelPoseReference
from ..traffic.generate import Traffic, make_traffic
from .live_service import GRAPHS, WARM_REQUESTS, port_config, serve

SLOT_NUMBERS = ("slot_pose_mm", "slot_bias_mm")
SLOT_PEOPLE = 50  # a slot is judged where it holds at least this many people in the run


def load_arrays(path) -> dict:
    """A holder for the drawn weights (`build_service` fills it); the
    configuration names no file."""
    return {}


def build_service(cell, traffic: Traffic, arrays, seed: int, device):
    """The service with VoxelPose's seeded weights loaded and the
    'heatmaps' graph captured."""
    from faster_voxelpose_tpu_torch.engine.service import PoseService
    from faster_voxelpose_tpu_torch.models.voxelpose import VoxelPoseNet

    if cell.workload["method"] != "infer_heatmaps":
        raise ValueError(f"live_voxelpose drives infer_heatmaps, not {cell.workload['method']}")
    svc = PoseService(port_config(cell.config), rig=traffic.rig, device=device, seed=0,
                      aot=False)
    if not isinstance(svc.model, VoxelPoseNet):
        raise TypeError(f"the port built {type(svc.model).__name__} for MODEL voxelpose")
    weights = voxelpose_weights(cell.config["yaml"], seed, device)
    svc.model.load_state_dict(weights)
    arrays["state"] = weights
    if device.type == "cuda":
        svc.warmup((GRAPHS["infer_heatmaps"],))
    return svc, weights


def reference_answers(cell, traffic: Traffic, arrays, weights, entries, device,
                      precision: str = "float32") -> Dict[int, Dict[str, np.ndarray]]:
    """The reference's slots for each pool entry in `entries`."""
    pin_float32()
    state = weights if weights is not None else arrays["state"]
    ref = VoxelPoseReference(Geometry.from_config(cell.config["yaml"]), state, device, precision)
    cams = torch.as_tensor(traffic.rig, device=device)
    out = {}
    for e in sorted(set(entries)):
        r = ref(torch.as_tensor(traffic.pool[e], device=device), cams)
        r["hdn_score"] = r["confidence"]  # the proposal's score, under the name readings dump
        out[e] = {k: v.cpu().numpy() for k, v in r.items()}
    return out


def slot_people(answer: Mapping, ref: Mapping) -> List[Tuple[int, float, Optional[np.ndarray]]]:
    """Every person of an answer and of its reference, paired as
    `core/compare.py` pairs them, by the proposal slot that served it:
    (slot, error mm capped at MISS_MM, mean offset (3,) served - reference
    mm over the joints, or None where unpaired or off by MISS_MM or more).
    The valid slots of a top-K sorted by value are its first ones, so an
    answer's i-th person is the program's slot i; a reference person left
    unpaired counts in its own slot."""
    valid = np.asarray(ref["valid"], bool)
    ref_slot = np.flatnonzero(valid)
    slots = np.asarray(ref["poses"], np.float64)[valid]
    served = np.asarray(answer["poses_mm"], np.float64).reshape(-1, *slots.shape[1:])
    dist = np.linalg.norm(served[:, None] - slots[None], axis=-1).mean(-1)  # (P, V)
    out, used_p, used_k = [], set(), set()
    for flat in np.argsort(dist, axis=None, kind="stable"):
        p, k = divmod(int(flat), slots.shape[0])
        if p in used_p or k in used_k or dist[p, k] >= compare.PAIR_MM:
            continue
        used_p.add(p)
        used_k.add(k)
        near = dist[p, k] < compare.MISS_MM
        out.append((p, min(float(dist[p, k]), compare.MISS_MM),
                    (served[p] - slots[k]).mean(0) if near else None))
    out += [(p, compare.MISS_MM, None) for p in range(len(served)) if p not in used_p]
    out += [(int(ref_slot[k]), compare.MISS_MM, None) for k in range(len(slots))
            if k not in used_k]
    return out


def slot_summary(people) -> Dict[str, float]:
    """Over the slots that hold at least SLOT_PEOPLE people: the largest
    mean error of a slot's people (`slot_pose_mm`) and the largest length
    of a slot's mean offset over its pairs (`slot_bias_mm`); 0 where no
    slot holds so many."""
    errors, offsets = defaultdict(list), defaultdict(list)
    for slot, error, offset in people:
        errors[slot].append(error)
        if offset is not None:
            offsets[slot].append(offset)
    judged = [s for s in errors if len(errors[s]) >= SLOT_PEOPLE]
    return {"slot_pose_mm": max((float(np.mean(errors[s])) for s in judged), default=0.0),
            "slot_bias_mm": max((float(np.linalg.norm(np.mean(offsets[s], axis=0)))
                                 for s in judged if offsets[s]), default=0.0)}


def judge(answers, reqs, refs) -> Dict[str, float]:
    """`live_service.judge`'s numbers, and `slot_summary`'s."""
    pairs = [(a, refs[r.entry]) for a, r in zip(answers, reqs) if a is not None]
    out = compare.summarize(compare.compare_answer(a, ref) for a, ref in pairs)
    out.update(slot_summary([p for a, ref in pairs for p in slot_people(a, ref)]))
    return out


def checks_of(readings: Mapping, workload: Mapping) -> Dict[str, Tuple[float, float]]:
    """{name: (reading, limit)} of the cell's `limits` and `slot_limits`."""
    limits = dict(workload["limits"], **workload.get("slot_limits", {}))
    return {k: (readings[k], float(limits[k])) for k in compare.NUMBERS + SLOT_NUMBERS
            if k in limits}


def run(ctx) -> Tuple[Run, Dict[str, Tuple[float, float]], dict]:
    """One run of the cell: set-up, the window, with --trace 1 a traced
    segment, then the reference and the checks."""
    # a program without VoxelPose fails here, at once
    import faster_voxelpose_tpu_torch.models.voxelpose  # noqa: F401

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
    record.requests = reqs
    record.attempted = len(traffic.due)
    record.failed = record.attempted - sum(r.ok for r in reqs)
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
    del svc, call
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    used = {r.entry for r in reqs} | set(record.traced_entries)
    refs = reference_answers(cell, traffic, arrays, weights, used, device)
    checks = checks_of(judge(answers, reqs, refs), w)

    record.flops_per_request = counts.request_flops(cell.config["yaml"])
    record.peaks = peaks_for(device_info["kind"])
    return record, checks, device_info
