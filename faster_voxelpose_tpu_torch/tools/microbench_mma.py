"""Tensor-core cost against contraction size and window origin
(counterpart of scripts/microbench_matmul.py):

    python3 -m faster_voxelpose_tpu_torch.tools.microbench_mma [--device cpu]

The shape of the sampling kernel's first stage: B = 512 steps, each
slicing a (K, 640) window from a resident (128, 640) bf16 buffer at a
static origin or at one read from a device array, and contracting it
5 times against a per-step (K, 2048) bf16 operand with float32
accumulation (`ops/window_kernels.mma_window`).  Six cases, K in
(128, 64, 32) times the two origins; each line gives microseconds per
product, TMAC/s and the MACs the time stands for.  It says whether a
half-height window halves the product's cost, and what a data-dependent
origin costs.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

import torch

from ..device import resolve_device
from ..ops import window_kernels as wk
from .timing import device_line, time_ms

M, N = 640, 2048
B = 512
NMAT = 5
SEED = 0
CASES = tuple((k, dyn) for k in (128, 64, 32) for dyn in (False, True))


def make_operands(steps: int, k: int, device: torch.device, seed: int = SEED, m: int = M, n: int = N):
    """lhs (128, m) and rhs (steps, 128, n) uniform in [0, 1) as bf16, and
    row origins (steps,) int32, multiples of 16 in [0, 128 - k], made on
    `device` from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    lhs = torch.rand((wk.MMA_ROWS, m), generator=gen, device=device).to(torch.bfloat16)
    rhs = torch.rand((steps, wk.MMA_ROWS, n), generator=gen, device=device).to(torch.bfloat16)
    oy = torch.randint(0, (wk.MMA_ROWS - k) // 16 + 1, (steps,), generator=gen,
                       device=device).to(torch.int32) * 16
    return lhs, rhs, oy


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="'cpu' runs the plain version")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    where = device_line(device)
    rows = []
    for k, dyn in CASES:
        lhs, rhs, oy = make_operands(B, k, device)
        origin = oy if dyn else None
        ms = time_ms(lambda: wk.mma_window(lhs, rhs, origin, k, NMAT), device=device)
        per_us = ms * 1e3 / B / NMAT
        macs = M * k * N
        rows.append(dict(k=k, dyn=dyn, ms=ms, us_per_product=per_us,
                         tmacs=macs / (per_us * 1e-6) / 1e12, macs_timed=macs * NMAT * B))
        print(f"K={k:4d} dyn={int(dyn)} nmat={NMAT}: {per_us:8.3f} us/matmul "
              f"({rows[-1]['tmacs']:7.2f} TMAC/s) {ms:.4f} ms for {rows[-1]['macs_timed']:.4g} MACs "
              f"| {where}")
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
