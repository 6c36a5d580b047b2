"""Serving latency of a checkout's PoseService on the card: the committed
panoptic_synthetic weights, the 'heatmaps' graph, one request per
held-out scene (heatmaps rendered on the card beforehand), the
per-request wall time from the call to the poses on the host.  Run by
path with the checkout to measure on PYTHONPATH, so that two checkouts
are compared by one script in one call:

    PYTHONPATH=<checkout> python3 <this file> [--requests 200] [--rounds 3]

Prints one JSON line per round ({"checkout", "round", "requests",
"p50_ms", "p95_ms", "mean_ms"}) after a line with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="PoseService serving latency of a checkout")
    p.add_argument("--requests", type=int, default=200)
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    import faster_voxelpose_tpu_torch as pkg
    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile
    from faster_voxelpose_tpu_torch.datasets import collate
    from faster_voxelpose_tpu_torch.device import pin_float32
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.ops.heatmap_render import render_heatmaps_device
    from faster_voxelpose_tpu_torch.tools.timing import card_line
    from faster_voxelpose_tpu_torch.tools.validate import held_out_dataset

    root = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    pin_float32()
    cfg = panoptic_synthetic_profile()
    with np.load(os.path.join(root, "checkpoints", "panoptic_synthetic", "model_best.npz")) as npz:
        variables = {k: npz[k] for k in npz.files}
    ds = held_out_dataset(cfg, args.requests)
    b = collate([ds[i] for i in range(len(ds))])
    W, H = cfg.DATASET.HEATMAP_SIZE
    frames = render_heatmaps_device(torch.as_tensor(b["hm_params"]).cuda(), H, W)
    svc = PoseService(cfg, variables=variables, rig=np.asarray(b["cameras"][0], np.float32),
                      device="cuda")
    svc.warmup(("heatmaps",))
    torch.cuda.synchronize()
    print(card_line())
    for r in range(args.rounds):
        ms = np.array([svc.infer_heatmaps(f)["latency_ms"] for f in frames])
        print(json.dumps({"checkout": root, "round": r, "requests": len(ms),
                          "p50_ms": float(np.percentile(ms, 50)),
                          "p95_ms": float(np.percentile(ms, 95)), "mean_ms": float(ms.mean())}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
