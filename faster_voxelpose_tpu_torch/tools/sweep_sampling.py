"""Parameter sweep of the window kernel on the card (counterpart of
scripts/sweep_pallas.py):

    python3 -m faster_voxelpose_tpu_torch.tools.sweep_sampling [SPREAD] [--samples N] [--device cpu]

Nine configurations of (samples per block, window width and height,
product precision, contracted axis) at the Panoptic JLN's scale.  Each
line gives ms, ns per sample and the max error against the exact bilinear
sampler on 64 blocks.  SPREAD (default 12) is how many pixels a block's
samples scatter over: a window covers a spread of XW - 9 by YW - 9, so at
the default the 16-wide windows cut samples off and their error column is
large; that is what the sweep is there to show.  A configuration that
fails to launch prints FAILED with the reason, and the tool then exits
non-zero.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import pin_float32, resolve_device
from ..ops import window_kernels as wk
from .probe_sampling import CUBE, H, J, K, V, W, exact_reference
from .timing import device_line, time_ms


def sweep_coords(n_blocks: int, s: int, spread: float, rng: np.random.RandomState) -> np.ndarray:
    """(n_blocks, V, 2, s) float32 block coords with the script's draws
    (scripts/sweep_pallas.py:167-171)."""
    coords = np.empty((n_blocks, V, 2, s), np.float32)
    cx = rng.uniform(-10, W + 10, (n_blocks, V, 1))
    cy = rng.uniform(-10, H + 10, (n_blocks, V, 1))
    coords[:, :, 0, :] = cx + rng.uniform(-spread / 2, spread / 2, (n_blocks, V, s))
    coords[:, :, 1, :] = cy + rng.uniform(-spread / 2, spread / 2, (n_blocks, V, s))
    return coords


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("spread", nargs="?", type=float, default=12.0)
    p.add_argument("--samples", type=int, default=K * CUBE,
                   help="samples per view to time (default: the JLN's 2.6M)")
    p.add_argument("--device", default=None, help="'cpu' runs the plain versions")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    pin_float32()
    where = device_line(device)

    rng = np.random.RandomState(0)
    hm = torch.as_tensor(rng.rand(V, H, W, J).astype(np.float32), device=device)
    rows, failed = [], []
    for cfg in wk.SWEEP_CONFIGS:
        n_blocks = max(args.samples // cfg.s, 1)
        coords = torch.as_tensor(sweep_coords(n_blocks, cfg.s, args.spread, rng), device=device)
        try:
            small = coords[:64]
            err = float((wk.window_sample(hm, small, cfg) - exact_reference(hm, small)).abs().max())
            t = time_ms(lambda: wk.window_sample(hm, coords, cfg), device=device)
            if device.type == "cuda":
                torch.cuda.synchronize()
        except Exception as e:  # reported here, and the tool fails at the end
            failed.append(cfg)
            print(f"{cfg.label()} : FAILED {str(e)[:120]}")
            continue
        finally:
            sys.stdout.flush()
        n_samples = n_blocks * cfg.s * V
        rows.append(dict(config=cfg, blocks=n_blocks, ms=t, ns_per_sample=t / n_samples * 1e6,
                         err=err, heatmaps=hm, coords=coords))
        print(f"{cfg.label()} : {t:8.4f} ms  {t / n_samples * 1e6:7.4f} ns/sample  "
              f"err={err:.2e} | {where}")
    if failed:
        raise RuntimeError(f"{len(failed)} of {len(wk.SWEEP_CONFIGS)} configurations failed: "
                           + "; ".join(c.label() for c in failed))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
