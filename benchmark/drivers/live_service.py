"""Entry `live_service`: one camera rig's stream served by the port's
`PoseService`, as an open loop.

Requests are due on the traffic's schedule whatever the service does;
one client thread sends each when it is due, or as soon as the one
before it is answered, so a slow answer delays the ones behind it as a
queue would.  A request's latency runs from when it was due to its
poses decoded on the host.  The workload's `method` names the entry
(`infer_images` with uint8 frames, `infer_heatmaps` with float32
heatmaps), and the service captures that entry's graph alone.

After the window the program's state is freed and the reference
(`benchmark/reference/`) computes every pool input the window used, on
the same device in float32; each answer is compared with its input's
reference (`core/compare.py`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from ..core import compare, timing, trace as tracing
from ..core.record import Request, Run
from ..core.weights import backbone_weights
from ..counts import flops as flops_counts
from ..counts.peaks import peaks_for
from ..reference.fusion import FusionReference, Geometry
from ..reference.precision import pin_float32
from ..reference.resnet import ResNetReference
from ..traffic.generate import Traffic, make_traffic

GRAPHS = {"infer_images": "images_u8", "infer_heatmaps": "heatmaps"}
WARM_REQUESTS = 8
LATE_LIMIT_S = 60.0  # past the window's close, an unanswered request is failed


def port_config(config: Mapping):
    """The port's Config of a configuration file: its published YAML,
    then the keys it serves with ('SECTION.KEY': value)."""
    from faster_voxelpose_tpu_torch.config import Config

    def apply(obj, values):
        for key, value in values.items():
            cur = getattr(obj, key)  # an unknown key raises
            if dataclasses.is_dataclass(cur):
                apply(cur, value)
                if hasattr(cur, "__post_init__"):
                    cur.__post_init__()
            else:
                setattr(obj, key, value)

    cfg = Config()
    apply(cfg, config["yaml"])
    for path, value in config.get("served", {}).items():
        section, key = path.split(".")
        apply(cfg, {section: {key: value}})
    return cfg


def load_arrays(path) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def build_service(cell, traffic: Traffic, arrays, seed: int, device):
    """The service of the cell's entry with its graph captured, and the
    backbone's weights where the entry takes frames."""
    from faster_voxelpose_tpu_torch.engine.service import PoseService

    method = cell.workload["method"]
    cfg = port_config(cell.config)
    svc = PoseService(cfg, variables=arrays, rig=traffic.rig, device=device, seed=0, aot=False)
    weights = None
    if method == "infer_images":
        weights = backbone_weights(cfg.DATASET.NUM_JOINTS, seed, device)
        svc.backbone.load_state_dict(weights)
    if device.type == "cuda":
        svc.warmup((GRAPHS[method],))
    return svc, weights


def wait_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        if left > 0.002:
            time.sleep(left - 0.001)


def serve(call, traffic: Traffic, order, due, t0: float, close: float,
          span=None) -> Tuple[List[Request], List[dict]]:
    """Send each request when due (after the one before it is answered);
    stop sending LATE_LIMIT_S past `close`.  Returns the requests and
    their answers (None where the call raised)."""
    reqs, answers = [], []
    for i, d in zip(order, due):
        if time.perf_counter() > close + LATE_LIMIT_S:
            break
        wait_until(t0 + d)
        entered = time.perf_counter()
        try:
            with torch.profiler.record_function(span) if span else contextlib.nullcontext():
                answer = call(traffic.pool[i])
            ok = True
        except Exception as e:  # a request that raises is failed, the loop goes on
            answer, ok = {"error": repr(e)}, False
        reqs.append(Request(t0 + d, entered, time.perf_counter(), int(i), ok))
        answers.append(answer if ok else None)
    return reqs, answers


def stage_times(svc, cell, traffic: Traffic, device) -> Dict[str, float]:
    """ms of the backbone and of the fusion model, each captured alone."""
    from faster_voxelpose_tpu_torch.models.resnet import images_to_heatmaps

    cams = torch.as_tensor(traffic.rig, device=device)[None]
    out = {}
    with torch.inference_mode():
        if cell.workload["method"] == "infer_images":
            frames = torch.as_tensor(traffic.pool[0], device=device)[None]
            color = svc.cfg.DATASET.COLOR_RGB
            hm = images_to_heatmaps(svc.backbone, frames, color).clone()
            out["backbone"] = timing.graph_ms(
                lambda: images_to_heatmaps(svc.backbone, frames, color))
        else:
            hm = torch.as_tensor(traffic.pool[0], device=device)[None]
    out["fusion"] = timing.graph_ms(lambda: svc.model(hm, cams))
    return out


def reference_answers(cell, traffic: Traffic, arrays, weights, entries, device,
                      precision: str = "float32") -> Dict[int, Dict[str, np.ndarray]]:
    """The reference's slots for each pool entry in `entries`."""
    pin_float32()
    geom = Geometry.from_config(cell.config["yaml"])
    fusion = FusionReference(geom, arrays, device, precision)
    backbone = None
    if weights is not None:
        backbone = ResNetReference(weights, bool(cell.config["yaml"]["DATASET"]["COLOR_RGB"]),
                                   precision)
    cams = torch.as_tensor(traffic.rig, device=device)
    out = {}
    for e in sorted(set(entries)):
        x = torch.as_tensor(traffic.pool[e], device=device)
        hm = backbone(x) if backbone is not None else x
        out[e] = {k: v.cpu().numpy() for k, v in fusion(hm, cams).items()}
    return out


def judge(answers, reqs, refs) -> Dict[str, float]:
    return compare.summarize(compare.compare_answer(a, refs[r.entry])
                             for a, r in zip(answers, reqs) if a is not None)


def run(ctx) -> Tuple[Run, Dict[str, Tuple[float, float]], dict]:
    """One run of the cell: set-up, the window, with --trace 1 a traced
    segment and the stages alone, then the reference and the checks."""
    cell, device = ctx.cell, ctx.device
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
    # the client's own garbage stays uncollected through the window: a
    # collection pass over its growing answer list would stall the sender
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

    y = cell.config["yaml"]
    record.flops_per_request = flops_counts.request_flops(y, w["method"] == "infer_images")
    record.live_voxels = {e: int(r["live_voxels"][r["valid"]].sum()) for e, r in refs.items()}
    record.peaks = peaks_for(device_info["kind"])
    return record, checks, device_info
