"""PyTorch port, the window kernel's premise on the CPU: the dense
contraction of `window_sample_plain` equals the sum of its live taps, the
pixels floor(c) and floor(c) + 1 of each sample on each axis that lie
inside the window, 2 x 2 per (sample, view, joint).  That is all that
csrc/window.cu computes, so this holds "the zero terms drop out exactly"
where the kernel cannot run.  The sparse form is written out here, with
its own window origin, window cut and roundings, for the nine configs of
the sweep at spreads 6, 12 and 30 and at the image's edges.

Tolerances:
- float64, 1e-12: both sides sum the same handful of products of values
  in [0, 1], each rounding about 1e-16; a missing or extra tap moves a
  value by its weight times a heatmap value, far above 1e-12 for random
  coords.
- float32, 1e-6: the plain version's products are CPU matrix products,
  whose order and fused multiply-adds differ from the kernel's chain; a
  value collects at most 5 views x 3 roundings of 2^-24 relative on
  values <= 1, under 1e-6.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from faster_voxelpose_tpu_torch.ops.window_kernels import tf32_round

CASES = ["spread6", "spread12", "spread30", "edges"]
TOLS = {torch.float64: 1e-12, torch.float32: 1e-6}


def _inputs(cfg, case, seed=0):
    from chip_smoke import edge_coords
    from faster_voxelpose_tpu_torch.tools import sweep_sampling as sw

    rng = np.random.RandomState(seed)
    hm = rng.rand(sw.V, sw.H, sw.W, sw.J).astype(np.float32)
    if case == "edges":
        coords = edge_coords(cfg.s, rng)
    else:
        coords = sw.sweep_coords(4, cfg.s, float(case[len("spread"):]), rng)
    return hm, coords


def _taps(c, size, width):
    """The two taps of coords c (NB, V, S) on one axis: [(pixel, weight,
    live)] at floor(c) and floor(c) + 1, live inside the window whose
    origin is floor(min) clipped to [0, size - width] and rounded down to a
    multiple of 8; a dead tap weighs 0 and reads a pixel inside the image."""
    origin = (torch.div(c.amin(-1).floor().clamp(0, size - width).long(), 8,
                        rounding_mode="floor") * 8)[..., None]
    taps = []
    for p in (c.floor(), c.floor() + 1):
        live = (p >= origin) & (p < origin + width)
        w = torch.where(live, (1 - (c - p).abs()).clamp_min(0), torch.zeros_like(c))
        taps.append((p.long().clamp(0, size - 1), w[..., None], live))
    return taps


def _tf32(x):
    """x rounded to TF32's 10 mantissa bits, nearest with ties away from
    zero: float32 as the kernel rounds it, float64 by the same rule."""
    if x.dtype != torch.float64:
        return tf32_round(x)
    return ((x.contiguous().view(torch.int64) + (1 << 41)) & -(1 << 42)).view(torch.float64)


def _contract(w0, b0, w1, b1, prec):
    """The contracted axis over its two taps, operands rounded as `prec`."""
    r = _tf32
    if prec == "fp32":
        return w0 * b0 + w1 * b1
    W0, W1, B0, B1 = r(w0), r(w1), r(b0), r(b1)
    hi = W0 * B0 + W1 * B1
    if prec == "tf32":
        return hi
    lo_hi = r(b0 - B0) * W0 + r(b1 - B1) * W1
    hi_lo = B0 * r(w0 - W0) + B1 * r(w1 - W1)
    return hi + (lo_hi + hi_lo)


def sparse_window(hm, coords, cfg):
    """hm (V, H, W, J), coords (NB, V, 2, S) -> (NB, 16, S): the window
    sampler from its 2 x 2 live taps, and the taps themselves."""
    V, H, W, J = hm.shape
    hmp = F.pad(hm, (0, 16 - J))
    views = torch.arange(V)[None, :, None]
    (x0, wx0, lx0), (x1, wx1, lx1) = _taps(coords[:, :, 0], W, cfg.xw)
    (y0, wy0, ly0), (y1, wy1, ly1) = _taps(coords[:, :, 1], H, cfg.yw)

    def px(ix, iy):  # (NB, V, S, 16)
        return hmp[views, iy, ix]

    if cfg.contract == "x":
        t0 = _contract(wx0, px(x0, y0), wx1, px(x1, y0), cfg.prec)
        t1 = _contract(wx0, px(x0, y1), wx1, px(x1, y1), cfg.prec)
        per_view = t0 * wy0 + t1 * wy1
    else:
        t0 = _contract(wy0, px(x0, y0), wy1, px(x0, y1), cfg.prec)
        t1 = _contract(wy0, px(x1, y0), wy1, px(x1, y1), cfg.prec)
        per_view = t0 * wx0 + t1 * wx1
    acc = torch.zeros_like(per_view[:, 0])
    for v in range(V):
        acc = acc + per_view[:, v]
    out = (acc * (1.0 / V)).clamp(0.0, 1.0).permute(0, 2, 1)
    return out, ((x0, lx0), (x1, lx1)), ((y0, ly0), (y1, ly1))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("index", range(9))
def test_live_taps_equal_the_dense_window(index, case, dtype, monkeypatch):
    """The sparse 2 x 2-tap sum equals `window_sample_plain` for every
    config of the sweep; every live tap lies inside the footprint that the
    kernel stages (`chip_smoke.window_footprint`).  In float64 both sides
    round TF32 operands by the float64 form of the kernel's rule."""
    from chip_smoke import staged_bytes, window_footprint
    from faster_voxelpose_tpu_torch.ops import window_kernels as wk

    monkeypatch.setattr(wk, "tf32_round", _tf32)

    cfg = wk.SWEEP_CONFIGS[index]
    hm, coords = (torch.as_tensor(a).to(dtype) for a in _inputs(cfg, case))
    want = wk.window_sample_plain(hm, coords, cfg)
    got, x_taps, y_taps = sparse_window(hm, coords, cfg)
    assert got.shape == want.shape == (coords.shape[0], 16, cfg.s) and got.dtype == dtype
    torch.testing.assert_close(got, want, atol=TOLS[dtype], rtol=0)
    assert float(want.abs().max()) > 0.1  # the case samples something

    V, H, W, _ = hm.shape
    foot = window_footprint(coords, cfg, W, H)[..., None]  # (NB, V, 4, 1)
    for taps, lo, hi in ((x_taps, foot[:, :, 0], foot[:, :, 1]),
                         (y_taps, foot[:, :, 2], foot[:, :, 3])):
        for p, live in taps:
            assert bool(((p >= lo) & (p <= hi))[live].all())
    nx = (foot[:, :, 1] - foot[:, :, 0] + 1).clamp_min(0)
    ny = (foot[:, :, 3] - foot[:, :, 2] + 1).clamp_min(0)
    assert bool((nx <= cfg.xw).all() and (ny <= cfg.yw).all())
    assert staged_bytes(coords, cfg, W, H) == int((nx * ny).sum()) * 64
    if case == "edges":  # the last block lies past the right edge: nothing staged
        assert int(nx[5].max()) == 0 and float(want[5].abs().max()) == 0.0


@pytest.mark.parametrize("index", range(9))
def test_window_cut_shows_in_the_sparse_form(index):
    """At spread 30 every config's window cuts samples off, and at spread 6
    none does: with float32 operands the sparse form then reads the exact
    bilinear sampler's value (1e-5), and at 30 it is off by more than
    1e-2."""
    import dataclasses

    from faster_voxelpose_tpu_torch.ops import window_kernels as wk
    from faster_voxelpose_tpu_torch.tools.probe_sampling import exact_reference

    cfg = dataclasses.replace(wk.SWEEP_CONFIGS[index], prec="fp32")
    for case, cut in (("spread6", False), ("spread30", True)):
        hm, coords = (torch.as_tensor(a) for a in _inputs(cfg, case, seed=1))
        err = float((sparse_window(hm, coords, cfg)[0] - exact_reference(hm, coords)).abs().max())
        assert (err > 1e-2) if cut else (err <= 1e-5), (case, err)
