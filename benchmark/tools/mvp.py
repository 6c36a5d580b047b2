"""`knee.py`'s sweep, and the readings that the limits of `correct` are set
from, for a cell of the `live_mvp` entry, on the card:

    python3 -m benchmark.tools.mvp knee <cell> <seconds> <rate> [<rate> ...]
    python3 -m benchmark.tools.mvp readings [--faults <n>] <cell> <seed> [<seed> ...]
    python3 -m benchmark.tools.mvp frames <cell> <seed> [<seed> ...]

`knee` points `knee.py`'s module global at `drivers/live_mvp.py` for the
call and runs it unchanged.  `readings` does what `readings.py` does, with
the weights drawn from each seed as a run of the cell draws them: per
seed, the pool served once through a service holding that seed's weights,
its graph's slots compared with the float32 reference as a run compares
(`live_mvp.judge`, every pool entry once), then the fp8 control in the
program's place.  With `--faults n`, on the first n seeds the program is
served again with each fault of `FAULTS` planted in its graph, and
compared the same way: each must break the cell's limits.  One line per
seed, and a last JSON line with the largest program reading, the smallest
control reading, and each fault's readings.  `frames` reads how far
the answers follow the frames, per seed (`follows_frames`).
"""

from __future__ import annotations

import gc
import json
import sys
import time
from typing import Callable, Dict

import numpy as np
import torch

from benchmark.core.spec import load_cell
from benchmark.drivers import live_mvp as live
from benchmark.tools import knee
from benchmark.traffic.generate import Traffic, host_memory, make_pool

LAYER = 3  # the layer whose refinement the last fault skips


def _view_zeroed(pa):
    def fault(values, ref, offsets, logits, cams, geom):
        s = pa(values, ref, offsets, logits, cams, geom).clone()
        s[:, 0] = 0.0  # view 0's weighted taps, every head
        return s
    return fault


def _level_dropped(pa):
    def fault(values, ref, offsets, logits, cams, geom):
        return pa([*values[:2], torch.zeros_like(values[2])], ref, offsets, logits, cams, geom)
    return fault


# each takes the model and returns a function that puts it back
def _patch_attention(make: Callable) -> Callable:
    def plant(model):
        from faster_voxelpose_tpu_torch.models import mvp

        pa = mvp.projective_attention
        mvp.projective_attention = make(pa)
        return lambda: setattr(mvp, "projective_attention", pa)
    return plant


def _refinement_skipped(model):
    pose = model.pose_embed[LAYER]
    pose.forward = lambda t: torch.zeros((*t.shape[:-1], 3), dtype=torch.float32,
                                         device=t.device)
    return lambda: delattr(pose, "forward")


FAULTS: Dict[str, Callable] = {
    "view_zeroed": _patch_attention(_view_zeroed),  # view 0's taps lost
    "level2_dropped": _patch_attention(_level_dropped),  # the stride-4 level reads zeros
    "refinement_skipped": _refinement_skipped,  # layer LAYER leaves y as it was
}


def serve_pool(cell, traffic, arrays, seed, device, fault=None):
    """The graph's slots of every pool entry from a service with `seed`'s
    weights, with `fault` planted before its graph is captured."""
    from faster_voxelpose_tpu_torch.engine.service import PoseService

    undo = None
    if fault is not None:  # planted on the class's module before the capture
        capture = PoseService.warmup

        def warmup(svc, graphs=None):
            nonlocal undo
            undo = fault(svc.model)
            return capture(svc, graphs)
        PoseService.warmup = warmup
    try:
        svc, weights = live.build_service(cell, traffic, arrays, seed, device)
        slots = live.program_slots(svc, traffic, range(len(traffic.pool)))
    finally:
        if fault is not None:
            PoseService.warmup = capture
            if undo is not None:
                undo()
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    return slots, weights


def as_slots(ref: dict) -> np.ndarray:
    """The reference's slots in the graph's (N, J, 5) layout."""
    n, j = ref["poses"].shape[:2]
    flag = ref["valid"].astype(np.float32) - 1.0
    tail = np.broadcast_to(np.stack([flag, ref["scores"]], -1)[:, None], (n, j, 2))
    return np.concatenate([ref["poses"], tail], -1).astype(np.float32)


def readings(cell_name: str, seeds, device, faults: int = 0) -> dict:
    cell = load_cell(cell_name)
    limits = dict(cell.workload["limits"], **cell.workload.get("slot_limits", {}))
    out = {"program": {}, "control": {}, "valid": {}, "faults": {}}
    for n, seed in enumerate(seeds):
        t = time.perf_counter()
        rig, pool, people = make_pool(cell.mix, cell.config, seed, device)
        pool = host_memory(pool, cell.mix.get("host_memory", "pageable"), device)
        traffic = Traffic(rig, pool, np.arange(len(pool)), np.zeros(len(pool)), people)
        arrays = live.load_arrays(None)
        slots, weights = serve_pool(cell, traffic, arrays, seed, device)
        entries = list(range(len(pool)))
        refs = live.reference_answers(cell, traffic, arrays, weights, entries, device)
        ctrl = live.reference_answers(cell, traffic, arrays, weights, entries, device,
                                      precision="fp8")
        out["program"][seed] = live.judge(slots, entries, refs)
        out["control"][seed] = live.judge({e: as_slots(ctrl[e]) for e in entries}, entries, refs)
        out["valid"][seed] = float(np.mean([r["valid"].mean() for r in refs.values()]))
        if n < faults:
            for name, fault in FAULTS.items():
                got = live.judge(serve_pool(cell, traffic, arrays, seed, device, fault)[0],
                                 entries, refs)
                got["breaks"] = sorted(k for k in limits if got[k] > limits[k])
                out["faults"].setdefault(name, {})[seed] = got
        print(f"{cell_name} seed {seed}: program {out['program'][seed]} control "
              f"{out['control'][seed]} faults "
              f"{ {f: r[seed] for f, r in out['faults'].items() if seed in r} } valid share "
              f"(ref) {out['valid'][seed]:.3f} ({time.perf_counter() - t:.1f} s)", flush=True)
    return out


def follows_frames(cell_name: str, seeds, device) -> dict:
    """Per seed, over the pool's scenes: the float32 reference's mean joint
    movement (mm) of each layer's refinement, and the first references'
    mean distance from the space's centre; the served slots' mean joint
    distance between two scenes, over every pair and over the pairs whose
    people counts differ by at least 5 or by at most 1; the largest range
    of a slot's score over the scenes; valid slots against people; and
    `live_mvp.judge` of the served answers (`own`) beside the same with
    each scene's answer judged against the next scene's reference
    (`blind`): what a program that ignored its frames would read."""
    cell = load_cell(cell_name)
    centre = np.asarray(cell.config["yaml"]["CAPTURE_SPEC"]["SPACE_CENTER"], np.float64)
    out = {}
    for seed in seeds:
        rig, pool, people = make_pool(cell.mix, cell.config, seed, device)
        pool = host_memory(pool, cell.mix.get("host_memory", "pageable"), device)
        traffic = Traffic(rig, pool, np.arange(len(pool)), np.zeros(len(pool)), people)
        arrays = live.load_arrays(None)
        slots, weights = serve_pool(cell, traffic, arrays, seed, device)
        entries = list(range(len(pool)))
        refs = live.reference_answers(cell, traffic, arrays, weights, entries, device)
        trail = np.stack([refs[e]["trail"] for e in entries]).astype(np.float64)
        poses = np.stack([slots[e][:, :, :3] for e in entries]).astype(np.float64)
        scores = np.stack([slots[e][:, 0, 4] for e in entries])
        pairs = [(a, b) for a in entries for b in entries if a < b]
        dist = {(a, b): float(np.linalg.norm(poses[a] - poses[b], axis=-1).mean())
                for a, b in pairs}
        apart = [dist[p] for p in pairs if abs(people[p[0]] - people[p[1]]) >= 5]
        close = [dist[p] for p in pairs if abs(people[p[0]] - people[p[1]]) <= 1]
        row = {"layer_step_mm": np.linalg.norm(np.diff(trail, axis=1), axis=-1)
               .mean(axis=(0, 2, 3)).tolist(),
               "first_ref_from_centre_mm": float(np.linalg.norm(trail[:, 0] - centre,
                                                                axis=-1).mean()),
               "between_scenes_mm": {"mean": float(np.mean(list(dist.values()))),
                                     "min": float(min(dist.values())),
                                     "people_apart_ge5": float(np.mean(apart)),
                                     "people_within_1": float(np.mean(close))},
               "slot_score_range_max": float(np.ptp(scores, axis=0).max()),
               "people": [int(people[e]) for e in entries],
               "valid_slots": [int((slots[e][:, 0, 3] >= 0).sum()) for e in entries],
               "own": live.judge(slots, entries, refs),
               "blind": live.judge({e: slots[(e + 1) % len(entries)] for e in entries},
                                   entries, refs)}
        print(f"{cell_name} seed {seed}: {json.dumps(row)}", flush=True)
        out[seed] = row
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    tool, args = argv[0], argv[1:]
    if tool == "knee":
        knee.live = live
        knee.sweep(args[0], float(args[1]), [float(r) for r in args[2:]])
        return
    if tool == "frames":
        res = follows_frames(args[0], [int(s) for s in args[1:]], torch.device("cuda", 0))
        print(json.dumps({"cell": args[0], **{str(k): v for k, v in res.items()}}))
        return
    if tool != "readings":
        raise SystemExit(f"unknown tool {tool!r}: knee, readings or frames")
    faults = 0
    if args[0] == "--faults":
        faults, args = int(args[1]), args[2:]
    res = readings(args[0], [int(s) for s in args[1:]], torch.device("cuda", 0), faults)
    summary = {side: {k: (max if side == "program" else min)(r[k] for r in res[side].values())
                      for k in live.NUMBERS} for side in ("program", "control")}
    print(json.dumps({"cell": args[0], "largest_program": summary["program"],
                      "smallest_control": summary["control"], **res}))


if __name__ == "__main__":
    main()
