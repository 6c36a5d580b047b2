"""Probe of windowed sampling on the card (counterpart of
scripts/probe_pallas.py):

    python3 -m faster_voxelpose_tpu_torch.tools.probe_sampling [--blocks N] [--device cpu]

The JLN's 13.1M bilinear samples per frame (K = 10 crops of 64^3 voxels,
5 views) sampled from a staged window: blocks of 256 samples share a
24 x 24 heatmap window, x interpolated first and then y, the prototype's
float32 arithmetic (`ops/window_kernels.py`: the kernel stages each
block's footprint in shared memory and takes each sample's 2 x 2 live
taps from it).  First the kernel is held against the exact bilinear sampler on
64 blocks (1e-5), then it is timed at 10240 blocks beside the baseline,
the port's gather kernel `sample_whole` on the same coordinates flattened
to (5, N, 2), and the ratio is printed.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import pin_float32, resolve_device
from ..ops import sampling_kernels as sk
from ..ops import window_kernels as wk
from .timing import device_line, time_ms

# the Panoptic JLN profile
V, J, W, H = 5, 15, 240, 128
K = 10
CUBE = 64 * 64 * 64
TOL = 1e-5


def make_block_coords(n_blocks: int, rng: np.random.RandomState, spread: float = 10.0,
                      s: int = 256) -> np.ndarray:
    """(n_blocks, V, 2, s) float32 pixel coords, coherent per block: a
    block centre anywhere in or near the image and samples within `spread`
    pixels of it, as a 4x4x4-voxel crop block projects
    (scripts/probe_pallas.py:139-151, the same draws)."""
    centers = np.stack(
        [rng.uniform(-10, W + 10, (n_blocks, V, 1, 1)),
         rng.uniform(-10, H + 10, (n_blocks, V, 1, 1))], axis=2,
    ).reshape(n_blocks, V, 2, 1)
    jitter = rng.uniform(-spread / 2, spread / 2, (n_blocks, V, 2, s))
    return (centers + jitter).astype(np.float32)


def flat_pixels(coords: torch.Tensor) -> torch.Tensor:
    """Block coords (n, V, 2, S) -> the samplers' (V, n*S, 2)."""
    n, v, _, s = coords.shape
    return coords.permute(1, 0, 3, 2).reshape(v, n * s, 2).contiguous()


def exact_reference(heatmaps: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """The exact zeros-padding bilinear sampler (`sample_whole_plain`) in
    the window kernel's layout: (n, 16, S), the padding channels 0."""
    n, _, _, s = coords.shape
    vals = sk.sample_whole_plain(heatmaps, flat_pixels(coords))  # (n*S, J)
    vals = torch.nn.functional.pad(vals, (0, wk.JP - vals.shape[-1]))
    return vals.reshape(n, s, wk.JP).permute(0, 2, 1).contiguous()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--blocks", type=int, default=K * CUBE // wk.PROBE_CONFIG.s,
                   help="sample blocks to time (default: the JLN's 10240)")
    p.add_argument("--device", default=None, help="'cpu' runs the plain versions")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    pin_float32()
    cfg = wk.PROBE_CONFIG
    where = device_line(device)

    rng = np.random.RandomState(0)
    hm = torch.as_tensor(rng.rand(V, H, W, J).astype(np.float32), device=device)

    # correctness at small scale
    small = torch.as_tensor(make_block_coords(64, rng), device=device)
    err = float((wk.window_sample(hm, small, cfg) - exact_reference(hm, small)).abs().max())
    print(f"correctness max|err| = {err:.3e}")
    if not err < TOL:
        raise AssertionError(f"window kernel differs from the exact sampler by {err}")

    # throughput at the JLN's scale
    big = torch.as_tensor(make_block_coords(args.blocks, rng), device=device)
    n_samples = args.blocks * cfg.s * V
    t_window = time_ms(lambda: wk.window_sample(hm, big, cfg), device=device)
    print(f"window: {t_window:.4f} ms for {n_samples / 1e6:.1f}M samples "
          f"({t_window / n_samples * 1e6:.4f} ns/sample) | {where}")

    # baseline: the gather kernel at the same scale
    pix = flat_pixels(big)
    t_gather = time_ms(lambda: sk.sample_whole(hm, pix), device=device)
    print(f"gather (sample_whole): {t_gather:.4f} ms "
          f"({t_gather / n_samples * 1e6:.4f} ns/sample) | {where}")
    print(f"speedup of the window over the gather: {t_gather / t_window:.3f}x")
    return dict(config=cfg, blocks=args.blocks, samples=n_samples, err=err,
                window_ms=t_window, gather_ms=t_gather, heatmaps=hm, coords=big)


if __name__ == "__main__":
    main(sys.argv[1:])
