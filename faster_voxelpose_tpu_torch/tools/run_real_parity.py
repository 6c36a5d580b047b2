"""One command from the real datasets and the upstream model zoo's released
checkpoints to PARITY.md (counterpart of scripts/run_real_parity.py and
scripts/run_real_parity.sh):

    python3 -m faster_voxelpose_tpu_torch.tools.run_real_parity --preprocess \
        --data-dir data --weights-dir weights \
        [--datasets panoptic,shelf,campus] [--max-frames N] \
        [--weights-mode torch|best|random] [--out PARITY.md] [--device cpu]

For each benchmark dataset: (with --preprocess, the image source only) the
images resized on disk once (`tools/preprocess.py`), the upstream
`.pth.tar` converted to the port's state dict (`weights.convert_model`;
the Pose-ResNet backbone by `weights.convert_backbone`), the test set
scored on the card by `tools/validate.evaluate_model`, and the metric
written to PARITY.md beside the model zoo's published numbers
(`REFERENCE_ZOO`).  The `.sh` wrapper's one line is the `--preprocess`
flag of the command above; no root-level script is added.

Expected layout (the same `data/` that the JAX package's download scripts
fill; they fetch from the network and are not copied):

    data/Panoptic, data/Shelf, data/Campus
    weights/panoptic_model_best.pth.tar, weights/shelf_model_best.pth.tar,
    weights/campus_model_best.pth.tar
    backbone/pose_resnet50_panoptic.pth.tar (or weights/<its basename>)

A dataset whose data, checkpoint or backbone is absent is recorded as a
skip ('no-data', 'no-weights', 'no-backbone') in PARITY.md, not an error.
`run_parity` is importable with the script's signature (plus the device);
`cfg_hook(name, cfg)` may adjust each loaded config and
`dataset_hook(name, cfg)` may build its test set (the tests' fixtures).
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys
import time
from typing import Optional, Sequence

REPO = pathlib.Path(__file__).resolve().parents[2]

# the upstream model zoo (its README's results table)
REFERENCE_ZOO = {
    "panoptic": {"metric_name": "AP25", "MPJPE": 18.41, "AP25": 86.66,
                 "AP50": 98.08, "AP100": 99.26, "AP150": 99.53},
    "shelf": {"metric_name": "PCP3D", "PCP3D": 97.6},
    "campus": {"metric_name": "PCP3D", "PCP3D": 96.9},
}

CONFIGS = {
    "panoptic": "configs/panoptic/jln64.yaml",
    "shelf": "configs/shelf/jln64.yaml",
    "campus": "configs/campus/jln64.yaml",
}

WEIGHT_FILES = {
    "panoptic": "panoptic_model_best.pth.tar",
    "shelf": "shelf_model_best.pth.tar",
    "campus": "campus_model_best.pth.tar",
}


class _Truncated:
    """Evaluate only the first n frames (smoke runs / fixtures); proxies
    everything else to the underlying dataset."""

    def __init__(self, ds, n):
        self._ds = ds
        self._n = min(n, len(ds))

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        return self._ds[i]

    def evaluate(self, preds):
        return self._ds.evaluate(preds)

    def __getattr__(self, name):
        return getattr(self._ds, name)


def run_parity(
    data_dir: str,
    weights_dir: str = "",
    datasets=("panoptic", "shelf", "campus"),
    max_frames: int = 0,
    weights_mode: str = "torch",
    preprocess: bool = False,
    out_path: str = "PARITY.md",
    cfg_hook=None,
    dataset_hook=None,
    device=None,
):
    """Run checkpoint -> metric for every requested dataset; write
    out_path.  weights_mode: 'torch' converts
    {weights_dir}/{name}_model_best.pth.tar; 'best' loads the port's own
    model_best.npz under the config's OUTPUT_DIR/<name>; 'random' dry-runs
    the pipeline with a model seeded with 0 (fixtures).  Returns the list
    of per-dataset result dicts."""
    from ..config import load_config
    from ..datasets import get_dataset
    from ..device import resolve_device
    from .validate import evaluate_model

    device = resolve_device(device)
    results = []
    for name in datasets:
        cfg = load_config(str(REPO / CONFIGS[name]))
        cfg.DATASET.DATADIR = os.path.join(data_dir, cfg.DATASET.DATADIR.split("/")[-1])
        if cfg_hook is not None:
            cfg_hook(name, cfg)
        if not os.path.isdir(cfg.DATASET.DATADIR) and dataset_hook is None:
            print(f"[{name}] SKIP: no data at {cfg.DATASET.DATADIR}")
            results.append({"name": name, "status": "no-data"})
            continue

        torch_weights = None
        if weights_mode == "torch":
            torch_weights = os.path.join(weights_dir, WEIGHT_FILES[name])
            if not os.path.isfile(torch_weights):
                print(f"[{name}] SKIP: no checkpoint at {torch_weights}")
                results.append({"name": name, "status": "no-weights"})
                continue

        if cfg.DATASET.TEST_HEATMAP_SRC == "image":
            # the image path (Panoptic): the released backbone checkpoint at
            # the config's own path, else weights_dir/<basename>
            bb = cfg.NETWORK.PRETRAINED_BACKBONE
            if not os.path.isfile(bb):
                cand = os.path.join(weights_dir, os.path.basename(bb))
                if os.path.isfile(cand):
                    cfg.NETWORK.PRETRAINED_BACKBONE = cand
                else:
                    print(f"[{name}] SKIP: image heatmap source but no "
                          f"backbone checkpoint at {bb} or {cand}")
                    results.append({"name": name, "status": "no-backbone"})
                    continue

        if preprocess and cfg.DATASET.TEST_HEATMAP_SRC == "image":
            _preprocess_images(cfg)

        if dataset_hook is not None:
            test_ds = dataset_hook(name, cfg)
        else:
            test_ds = get_dataset(cfg.DATASET.TEST_DATASET)(cfg, is_train=False)
        if max_frames:
            test_ds = _Truncated(test_ds, max_frames)

        t0 = time.time()
        metric, msg, preds, _ = evaluate_model(
            cfg,
            output_dir=os.path.join(cfg.OUTPUT_DIR, name),
            torch_weights=torch_weights,
            weights_mode=weights_mode if weights_mode != "torch" else "best",
            test_ds=test_ds,
            device=device,
        )
        dt = time.time() - t0
        print(f"[{name}] metric {metric:.4f} over {len(test_ds)} frames "
              f"in {dt:.1f}s\n{msg}")
        results.append({
            "name": name, "status": "ok", "metric": float(metric),
            "frames": len(test_ds), "seconds": dt, "table": msg,
            "weights": torch_weights or weights_mode,
        })

    write_parity_md(results, out_path, weights_mode)
    return results


def _preprocess_images(cfg):
    """In-place idempotent resize of the test set's images
    (tools/preprocess.py's operation)."""
    from ..datasets import get_dataset
    from ..geometry.transforms import get_resize_transform
    from . import preprocess as pp

    ds = get_dataset(cfg.DATASET.TEST_DATASET)(cfg, is_train=False)
    transform = get_resize_transform(cfg.DATASET.ORI_IMAGE_SIZE, cfg.DATASET.IMAGE_SIZE)
    pp._init(transform, cfg.DATASET.IMAGE_SIZE)
    n = 0
    for rec in ds.records:
        for p in rec.image_paths or []:
            n += bool(pp._process(p))
    print(f"preprocessed {n} images")


def write_parity_md(results, out_path, weights_mode):
    lines = [
        "# Real-data parity vs the reference model zoo",
        "",
        f"Generated by faster_voxelpose_tpu_torch/tools/run_real_parity.py (weights: {weights_mode}).",
        "Reference numbers: the upstream README's model zoo table.",
        "",
        "| dataset | status | frames | our metric | zoo headline | eval time |",
        "|---|---|---|---|---|---|",
    ]
    for r in results:
        zoo = REFERENCE_ZOO[r["name"]]
        head = f"{zoo['metric_name']} {zoo[zoo['metric_name']]}"
        if r["status"] != "ok":
            lines.append(f"| {r['name']} | {r['status']} | - | - | {head} | - |")
        else:
            lines.append(
                f"| {r['name']} | ok | {r['frames']} | {r['metric']:.4f} | "
                f"{head} | {r['seconds']:.1f}s |"
            )
    lines.append("")
    for r in results:
        if r["status"] == "ok":
            lines += [f"## {r['name']}", "", "```", r["table"].strip(), "```", ""]
    with open(out_path, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {out_path}")


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-dir", default="data")
    p.add_argument("--weights-dir", default="weights")
    p.add_argument("--datasets", default="panoptic,shelf,campus")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--weights-mode", default="torch",
                   choices=["torch", "best", "random"])
    p.add_argument("--preprocess", action="store_true")
    p.add_argument("--out", default="PARITY.md")
    p.add_argument("--device", default=None, help="default: the CUDA device (cpu: tests only)")
    a = p.parse_args(argv)
    return run_parity(
        a.data_dir, a.weights_dir, a.datasets.split(","), a.max_frames,
        a.weights_mode, a.preprocess, a.out, device=a.device,
    )


if __name__ == "__main__":
    main(sys.argv[1:])
