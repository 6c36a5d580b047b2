"""`knee.py`'s sweep, and the readings that the limits of `correct` are set
from, for a cell of the `live_voxelpose` entry, on the card:

    python3 -m benchmark.tools.voxelpose knee <cell> <seconds> <rate> [<rate> ...]
    python3 -m benchmark.tools.voxelpose readings [--dump <dir>] [--faults <n>] <cell> <seed> [<seed> ...]

`knee` points `knee.py`'s module global at `drivers/live_voxelpose.py` for
the call and runs it unchanged.  `readings` does what `readings.py` does,
with the weights drawn from each seed as a run of the cell draws them:
per seed, the pool served once through a service holding that seed's
weights, compared with the float32 reference as a run compares
(`live_voxelpose.judge`), then the fp8 control in the program's place.
With `--faults n`, on the first n seeds the program is served again with
each fault of `FAULTS` planted in its graph, and compared the same way:
each must break the cell's limits.  One line per seed, and a last JSON
line with the largest program reading, the smallest control reading, and
each fault's readings.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from typing import Callable, Dict

import numpy as np
import torch

from benchmark.core.record import Request
from benchmark.core.spec import load_cell
from benchmark.drivers import live_voxelpose as live
from benchmark.tools import knee
from benchmark.tools.readings import as_answer
from benchmark.traffic.generate import Traffic, host_memory, make_pool

SLOT = 9  # the slot the one-slot faults hit: the last of K = 10


def _slot_zeroed(cubes: torch.Tensor) -> torch.Tensor:
    cubes = cubes.clone()
    cubes[SLOT] = 0.0
    return cubes


def _slot_shifted(cubes: torch.Tensor) -> torch.Tensor:
    cubes = cubes.clone()
    cubes[SLOT] = torch.roll(cubes[SLOT], 1, dims=0)
    return cubes


# planted in the PRN's input, the cubes (K, 64, 64, 64, J) of one frame
FAULTS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "slot_zeroed": _slot_zeroed,  # one slot's cube lost
    "slot_shifted": _slot_shifted,  # one slot's cube one voxel off along x
    "all_shifted": lambda cubes: torch.roll(cubes, 1, dims=1),  # every cube one voxel off
}


def serve_pool(cell, traffic, arrays, seed, device, fault=None):
    """The pool's answers from a service with `seed`'s weights, with
    `fault` applied to the PRN's cubes in the captured graph."""
    from faster_voxelpose_tpu_torch.models import voxelpose as vp

    sample = vp.sample_crop_cube
    if fault is not None:
        vp.sample_crop_cube = lambda *a, **k: fault(sample(*a, **k))
    try:
        svc, weights = live.build_service(cell, traffic, arrays, seed, device)
        answers = [svc.infer_heatmaps(x) for x in traffic.pool]
    finally:
        vp.sample_crop_cube = sample
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    return answers, weights


def readings(cell_name: str, seeds, device, dump=None, faults: int = 0) -> dict:
    cell = load_cell(cell_name)
    limits = dict(cell.workload["limits"], **cell.workload.get("slot_limits", {}))
    out = {"program": {}, "control": {}, "people": {}, "faults": {}}
    for n, seed in enumerate(seeds):
        t = time.perf_counter()
        rig, pool, people = make_pool(cell.mix, cell.config, seed, device)
        pool = host_memory(pool, cell.mix.get("host_memory", "pageable"), device)
        traffic = Traffic(rig, pool, np.arange(len(pool)), np.zeros(len(pool)), people)
        arrays = live.load_arrays(None)
        answers, weights = serve_pool(cell, traffic, arrays, seed, device)
        reqs = [Request(0, 0, 0, i, True) for i in range(len(pool))]
        entries = range(len(pool))
        refs = live.reference_answers(cell, traffic, arrays, weights, entries, device)
        ctrl = live.reference_answers(cell, traffic, arrays, weights, entries, device,
                                      precision="fp8")
        out["program"][seed] = live.judge(answers, reqs, refs)
        out["control"][seed] = live.judge([as_answer(ctrl[i]) for i in entries], reqs, refs)
        out["people"][seed] = [int(r["valid"].sum()) for r in refs.values()]
        if n < faults:
            for name, fault in FAULTS.items():
                got = live.judge(serve_pool(cell, traffic, arrays, seed, device, fault)[0],
                                 reqs, refs)
                got["breaks"] = sorted(k for k in limits if got[k] > limits[k])
                out["faults"].setdefault(name, {})[seed] = got
        if dump is not None:  # the raw answers, to recompute the numbers offline
            flat = {}
            for i in entries:
                flat[f"p{i}_poses"] = np.asarray(answers[i]["poses_mm"], np.float32)
                flat[f"p{i}_scores"] = np.asarray(answers[i]["scores"], np.float32)
                for side, r in (("r", refs[i]), ("c", ctrl[i])):
                    for k in ("poses", "valid", "confidence", "centres"):
                        flat[f"{side}{i}_{k}"] = r[k]
            np.savez_compressed(f"{dump}/{cell_name}.{seed}.npz", **flat)
        print(f"{cell_name} seed {seed}: program {out['program'][seed]} control "
              f"{out['control'][seed]} faults "
              f"{ {f: r[seed] for f, r in out['faults'].items() if seed in r} } valid slots "
              f"(ref) mean {np.mean(out['people'][seed]):.2f} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    tool, args = argv[0], argv[1:]
    if tool == "knee":
        knee.live = live
        knee.sweep(args[0], float(args[1]), [float(r) for r in args[2:]])
        return
    if tool != "readings":
        raise SystemExit(f"unknown tool {tool!r}: knee or readings")
    dump, faults = None, 0
    while args[0].startswith("--"):
        if args[0] == "--dump":
            dump = args[1]
        elif args[0] == "--faults":
            faults = int(args[1])
        else:
            raise SystemExit(f"unknown option {args[0]!r}")
        args = args[2:]
    res = readings(args[0], [int(s) for s in args[1:]], torch.device("cuda", 0), dump, faults)
    numbers = live.compare.NUMBERS + live.SLOT_NUMBERS
    summary = {side: {k: (max if side == "program" else min)(r[k] for r in res[side].values())
                      for k in numbers} for side in ("program", "control")}
    print(json.dumps({"cell": args[0], "largest_program": summary["program"],
                      "smallest_control": summary["control"], **res}))


if __name__ == "__main__":
    main()
