"""One-time on-disk resize of a config's dataset images to the network
input size (counterpart of run/preprocess.py):

    python3 -m faster_voxelpose_tpu_torch.tools.preprocess --cfg configs/panoptic/jln64.yaml [--workers 8]

Every image of the train and test datasets' records (a dataset whose
files are absent is skipped) is warped through the original -> input
affine (`geometry.transforms.get_resize_transform`) by `cv2.warpAffine`
with bilinear interpolation, the JAX module's operation, so that both
write the same files, in a pool of spawn processes.  An image already at
IMAGE_SIZE is not rewritten, so a second run resizes nothing.  Needs no
GPU.  The workers need only cv2 and the affine: this module imports the
package's modules (and with them torch) inside `main`, so that a spawned
worker, which imports this module, does not.
"""

from __future__ import annotations

import argparse
import sys
from multiprocessing import get_context
from typing import Optional, Sequence

import numpy as np

_TRANSFORM = None
_SIZE = None


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Resize dataset images in place")
    p.add_argument("--cfg", required=True)
    p.add_argument("--workers", type=int, default=4)
    return p.parse_args(argv)


def _init(transform, size):
    global _TRANSFORM, _SIZE
    _TRANSFORM, _SIZE = transform, size


def _process(path: str) -> bool:
    """Warp one image to IMAGE_SIZE in place; False where it is unreadable
    or already at that size."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    if img is None:
        return False
    W, H = _SIZE
    if img.shape[1] == W and img.shape[0] == H:
        return False
    out = cv2.warpAffine(img, _TRANSFORM.astype(np.float32), (W, H), flags=cv2.INTER_LINEAR)
    cv2.imwrite(path, out)
    return True


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Returns the number of images resized."""
    from ..config import load_config
    from ..datasets import get_dataset
    from ..geometry.transforms import get_resize_transform

    args = parse_args(argv)
    cfg = load_config(args.cfg)
    transform = get_resize_transform(cfg.DATASET.ORI_IMAGE_SIZE, cfg.DATASET.IMAGE_SIZE)
    paths = []
    for is_train in (True, False):
        name = cfg.DATASET.TRAIN_DATASET if is_train else cfg.DATASET.TEST_DATASET
        try:
            ds = get_dataset(name)(cfg, is_train=is_train)
        except (FileNotFoundError, KeyError):
            continue
        for rec in ds.records:
            if rec.image_paths:
                paths.extend(rec.image_paths)
    print(f"{len(paths)} images to check")
    with get_context("spawn").Pool(args.workers, initializer=_init,
                                   initargs=(transform, cfg.DATASET.IMAGE_SIZE)) as pool:
        changed = sum(pool.map(_process, paths))
    print(f"resized {changed} images to {cfg.DATASET.IMAGE_SIZE}")
    return changed


if __name__ == "__main__":
    main(sys.argv[1:])
