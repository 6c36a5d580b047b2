"""Entry `live_vitpose`: one camera rig's stream of frames served by the
port's `PoseService` with a ViTPose backbone (`BACKBONE: vitpose`), as an
open loop: `live_service`'s loop, answers and judgement, with the
ViTPose's seeded weights (`core/vit_weights.py`), its plain reference
(`reference/vitpose.py`) and its work count (`counts/vitpose.py`).

After the window the program's state is freed and the reference computes
every pool input the window used, on the same device in float32: the
ViTPose one view at a time, then the fusion; each answer is compared
with its input's reference (`core/compare.py`).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Tuple

import numpy as np
import torch

from ..core import compare, trace as tracing
from ..core.record import Run
from ..core.vit_weights import vitpose_weights, widths
from ..counts import vitpose as vit_counts
from ..counts.peaks import peaks_for
from ..reference.fusion import FusionReference, Geometry
from ..reference.precision import pin_float32
from ..reference.vitpose import ViTPoseReference
from ..traffic.generate import Traffic, make_traffic
from .live_service import (GRAPHS, WARM_REQUESTS, judge, load_arrays, port_config, serve,
                           stage_times)


def build_service(cell, traffic: Traffic, arrays, seed: int, device):
    """The service with the ViTPose's seeded weights loaded and the
    'images_u8' graph captured."""
    from faster_voxelpose_tpu_torch.engine.service import PoseService

    if cell.workload["method"] != "infer_images":
        raise ValueError(f"live_vitpose drives infer_images, not {cell.workload['method']}")
    cfg = port_config(cell.config)
    svc = PoseService(cfg, variables=arrays, rig=traffic.rig, device=device, seed=0, aot=False)
    weights = vitpose_weights(cell.config["yaml"], seed, device)
    svc.backbone.load_state_dict(weights)
    if device.type == "cuda":
        svc.warmup((GRAPHS["infer_images"],))
    return svc, weights


def reference_answers(cell, traffic: Traffic, arrays, weights, entries, device,
                      precision: str = "float32") -> Dict[int, Dict[str, np.ndarray]]:
    """The reference's slots for each pool entry in `entries`."""
    pin_float32()
    y = cell.config["yaml"]
    fusion = FusionReference(Geometry.from_config(y), arrays, device, precision)
    w = widths(y)
    backbone = ViTPoseReference(weights, bool(y["DATASET"]["COLOR_RGB"]), w["heads"], w["pad"],
                                precision)
    cams = torch.as_tensor(traffic.rig, device=device)
    out = {}
    for e in sorted(set(entries)):
        hm = backbone(torch.as_tensor(traffic.pool[e], device=device))
        out[e] = {k: v.cpu().numpy() for k, v in fusion(hm, cams).items()}
    return out


def run(ctx) -> Tuple[Run, Dict[str, Tuple[float, float]], dict]:
    """One run of the cell: set-up, the window, with --trace 1 a traced
    segment and the stages alone, then the reference and the checks."""
    cell, device = ctx.cell, ctx.device
    port_config(cell.config)  # a program without the VIT section fails here, at once
    w = cell.workload
    record = Run(cell.name, ctx.seconds, cell.config["yaml"])
    traffic = make_traffic(cell.mix, cell.config, float(w["rate"]), ctx.seconds, ctx.seed,
                           device)
    arrays = load_arrays(ctx.root / cell.config["weights"])
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
        if device.type == "cuda":
            record.stage_ms = stage_times(svc, cell, traffic, device)
    del svc, call
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    used = {r.entry for r in reqs} | set(record.traced_entries)
    refs = reference_answers(cell, traffic, arrays, weights, used, device)
    readings = judge(answers, reqs, refs)
    limits = w["limits"]
    checks = {k: (readings[k], float(limits[k])) for k in compare.NUMBERS if k in limits}

    record.flops_per_request = vit_counts.request_flops(cell.config["yaml"])
    record.live_voxels = {e: int(r["live_voxels"][r["valid"]].sum()) for e, r in refs.items()}
    record.peaks = peaks_for(device_info["kind"])
    return record, checks, device_info
