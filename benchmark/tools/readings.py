"""Readings that the limits of `correct` are set from, for one cell, in one
process on the card:

    python3 -m benchmark.tools.readings [--dump <dir>] <cell> <seed> [<seed> ...]

For each seed: the cell's traffic pool, every pool input served once
through the cell's entry (its captured graph, as in the window), and
compared with the float32 reference as a run compares; then the control,
the reference with fp8 operands (`reference/precision.py`) put in the
program's place, compared the same way.  Prints one line per seed and
side, and a last JSON line with all of them; with --dump, each seed's
raw answers and reference slots as `<dir>/<cell>.<seed>.npz`.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from benchmark.core import compare
from benchmark.core.record import Request
from benchmark.core.spec import load_cell
from benchmark.core.weights import backbone_weights
from benchmark.drivers import live_service as live
from benchmark.run import ROOT
from benchmark.traffic.generate import Traffic, host_memory, make_pool


def as_answer(ref: dict) -> dict:
    """The reference's slots as the service decodes an answer."""
    v = ref["valid"]
    return {"poses_mm": ref["poses"][v].tolist(), "scores": ref["confidence"][v].tolist()}


def readings(cell_name: str, seeds, device, dump=None) -> dict:
    cell = load_cell(cell_name)
    arrays = live.load_arrays(ROOT / cell.config["weights"])
    out = {"program": {}, "control": {}, "people": {}}
    svc = None
    for seed in seeds:
        t = time.perf_counter()
        rig, pool, people = make_pool(cell.mix, cell.config, seed, device)
        pool = host_memory(pool, cell.mix.get("host_memory", "pageable"), device)
        traffic = Traffic(rig, pool, np.arange(len(pool)), np.zeros(len(pool)), people)
        if svc is None:
            svc, weights = live.build_service(cell, traffic, arrays, seed, device)
        elif cell.workload["method"] == "infer_images":
            weights = backbone_weights(svc.cfg.DATASET.NUM_JOINTS, seed, device)
            svc.backbone.load_state_dict(weights)
        else:
            weights = None
        call = getattr(svc, cell.workload["method"])
        answers = [call(x) for x in pool]
        reqs = [Request(0, 0, 0, i, True) for i in range(len(pool))]
        refs = live.reference_answers(cell, traffic, arrays, weights, range(len(pool)), device)
        ctrl = live.reference_answers(cell, traffic, arrays, weights, range(len(pool)), device,
                                      precision="fp8")
        out["program"][seed] = live.judge(answers, reqs, refs)
        out["control"][seed] = live.judge([as_answer(ctrl[i]) for i in range(len(pool))],
                                          reqs, refs)
        out["people"][seed] = [int(r["valid"].sum()) for r in refs.values()]
        if dump is not None:  # the raw answers, to recompute the numbers offline
            flat = {}
            for i in range(len(pool)):
                flat[f"p{i}_poses"] = np.asarray(answers[i]["poses_mm"], np.float32)
                flat[f"p{i}_scores"] = np.asarray(answers[i]["scores"], np.float32)
                for side, r in (("r", refs[i]), ("c", ctrl[i])):
                    for k in ("poses", "valid", "hdn_score", "confidence"):
                        flat[f"{side}{i}_{k}"] = r[k]
            np.savez_compressed(f"{dump}/{cell_name}.{seed}.npz", **flat)
        print(f"{cell_name} seed {seed}: program {out['program'][seed]} control "
              f"{out['control'][seed]} valid slots (ref) mean "
              f"{np.mean(out['people'][seed]):.2f} ({time.perf_counter() - t:.1f} s)",
              flush=True)
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    dump = None
    if argv[0] == "--dump":
        dump, argv = argv[1], argv[2:]
    res = readings(argv[0], [int(s) for s in argv[1:]], torch.device("cuda", 0), dump)
    summary = {side: {k: (max if side == "program" else min)(r[k] for r in res[side].values())
                      for k in compare.NUMBERS} for side in ("program", "control")}
    print(json.dumps({"cell": argv[0], "largest_program": summary["program"],
                      "smallest_control": summary["control"], **res}))


if __name__ == "__main__":
    main()
