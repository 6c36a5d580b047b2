"""The tuning kernels of the port: windowed sampling and the tensor-core
cost of a windowed product, with their plain PyTorch versions.

They are the counterparts of the three prototypes that chose the JAX
package's production kernel on the TPU (window sizes, block size,
matrix-unit precision), and the entry points under `tools/` run them to
ask the same questions of an H100.  Each wrapper takes its plain version
for tensors on the CPU, and for CUDA tensors launches its hand-written
kernel (`csrc/window.cu`, `csrc/mma_window.cu`, built by
`ops/cuda_build.py`) or raises.  Launches are counted in
`sampling_kernels.LAUNCHES` under 'window_sample' and 'mma_window'.

window_sample
    Replaces `_sample_kernel` (scripts/probe_pallas.py:48, called at :117)
    and `make_kernel(s, xw, yw, precision, contract)`
    (scripts/sweep_pallas.py:30, called at :83).  Samples come in blocks of
    S that share a heatmap window of XW x YW pixels per view; the window
    origin is floor(min) of the block's coords, clipped into the image and
    rounded down to a multiple of 8.  The bilinear weights are separable,
    max(0, 1 - |x - xi|); the prototypes contract one axis as a matrix
    product against the window and the other as a multiply and sum; then
    the view mean and a clamp.  A sample farther than XW - 9 (YW - 9)
    pixels from its block's minimum may fall outside the window and reads
    less than the bilinear value: that is the window's answer, and kernel
    and plain version agree on it.  The TPU's three matrix-unit precisions
    map to `prec`, the rounding of the contracted axis's operands: 'fp32'
    (HIGHEST), 'tf32x3' (HIGH: operands split in two TF32 parts, hi*hi +
    (lo*hi + hi*lo)) and 'tf32' (DEFAULT: operands rounded to TF32).
    Bound on an H100, as a function: bytes (coords in, (NB, 16, S) out,
    the packed heatmaps once: 282 MB at 10240 blocks of 256, about
    0.084 ms at 3.35 TB/s).  Design: of the dense product's KW weights per
    contracted row two are non-zero, at floor(c) and floor(c) + 1, and the
    zero terms drop out of the sum exactly, so the kernel takes only those
    2 x 2 taps per (sample, view, joint), in the dense chain's order.  One
    block of 256 threads per sample block; per view the footprint of the
    block's taps (floor(min) .. floor(max) + 1 per axis, clipped to the
    window) is copied into shared memory by bulk asynchronous copies, one
    per footprint row of 64-byte pixels, into an arena that holds as many
    views' footprints as fit (all five at the tools' spreads), each copied
    as soon as the place it takes is free; the arena is sized at launch
    from the device's shared memory for three blocks per SM.  Four threads
    per sample, one float4 of joints each.  Its time is set by
    the device-memory traffic of the bound (coords in, output out) and the
    per-tap instructions; the TF32 modes' roundings add to the latter.
    The wrapper packs the heatmaps as (V, H, W, 16) for both contract axes
    (`pack_heatmap`).

mma_window
    Replaces the body of `bench` (scripts/microbench_matmul.py:31, called
    at :65): per grid step b, `nmat` identical products of a (K, M) window
    of a resident (128, M) bf16 buffer, at row 0 or at `oy[b]`, against
    rhs[b, :K] (K, N) bf16, summed in float32; the first 8 rows of the
    mean are written as bf16.  Bound on an H100: operations
    (2 * M * K * N * nmat * B flops against 989 TFLOP/s: 0.87 ms at
    K = 128, M = 640, N = 2048, B = 512; rhs is 268 MB, 0.08 ms).  Design:
    a persistent, warp-specialised kernel; a producer thread stages tiles
    of 128 window rows and of 256 rhs columns by TMA in 128-byte swizzle
    into two rings on mbarriers, and two consumer warpgroups issue
    wgmma m64n256k16 on them, all nmat products of a tile on the same
    staged operands.  `mma_plan` sizes the rings from the device's shared
    memory and the grid from its SM count; the wrapper passes the plan to
    the kernel.

Both kernels are forward only and raise on an input that requires grad.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .sampling_kernels import LAUNCHES, _check, _on_cpu, _raise_on, _stream

JP = 16  # joints padded to 16; the padding channels read 0
PRECISIONS = ("fp32", "tf32x3", "tf32")  # the TPU's HIGHEST, HIGH, DEFAULT
CONTRACTS = ("x", "y")
MMA_ROWS = 128  # rows of mma_window's lhs and of one rhs step
MMA_KS = (128, 64, 32)  # the window heights mma_window is instantiated for


@dataclass(frozen=True)
class WindowConfig:
    """One instantiation of the window kernel: samples per block, window
    width and height, product precision and the contracted axis."""

    s: int
    xw: int
    yw: int
    prec: str = "fp32"
    contract: str = "x"

    def __post_init__(self):
        if self.prec not in PRECISIONS or self.contract not in CONTRACTS:
            raise ValueError(f"unknown precision or contract axis in {self}")

    def label(self) -> str:
        return f"S={self.s:4d} XW={self.xw} YW={self.yw} {self.prec:7s} {self.contract}"


# the probe's configuration (scripts/probe_pallas.py:39-45, HIGHEST)
PROBE_CONFIG = WindowConfig(256, 24, 24, "fp32", "x")
# the sweep's nine (scripts/sweep_pallas.py:152-163), in its order
SWEEP_CONFIGS: Tuple[WindowConfig, ...] = (
    WindowConfig(256, 24, 24, "fp32", "x"),
    WindowConfig(256, 24, 24, "tf32x3", "x"),
    WindowConfig(256, 24, 24, "tf32", "x"),
    WindowConfig(256, 24, 24, "tf32x3", "y"),
    WindowConfig(256, 16, 40, "tf32x3", "y"),
    WindowConfig(128, 16, 40, "tf32x3", "y"),
    WindowConfig(256, 24, 40, "tf32x3", "y"),
    WindowConfig(512, 24, 24, "tf32x3", "x"),
    WindowConfig(512, 16, 40, "tf32x3", "y"),
)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def pack_heatmap(heatmaps: torch.Tensor) -> torch.Tensor:
    """(V, H, W, J) -> (V, H, W*16), joints padded to 16: the window
    kernel's layout for both contract axes (the sweep prototype's layout
    for contract 'y')."""
    V, H, W, J = heatmaps.shape
    return F.pad(heatmaps, (0, JP - J)).reshape(V, H, W * JP).contiguous()


def window_origin(lowest: torch.Tensor, limit: int) -> torch.Tensor:
    """floor(min) clipped to [0, limit] and rounded down to a multiple of
    8 (scripts/probe_pallas.py:60-63), as int64."""
    return torch.div(lowest.floor().clamp(0.0, float(limit)).long(), 8, rounding_mode="floor") * 8


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, nearest with ties away
    from zero, by bit operations (what cvt.rna.tf32.f32 does on the card)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x as a TF32 value plus the TF32-rounded remainder."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _product(win: torch.Tensor, wk: torch.Tensor, eq: str, prec: str) -> torch.Tensor:
    """The contraction `eq` of window and weights in float32, with the
    operands rounded (and for 'tf32x3' split) as the kernel rounds them."""
    if prec == "fp32":
        return torch.einsum(eq, win, wk)
    if prec == "tf32":
        return torch.einsum(eq, tf32_round(win), tf32_round(wk))
    (a_hi, a_lo), (b_hi, b_lo) = tf32_split(win), tf32_split(wk)
    small = torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
    return torch.einsum(eq, a_hi, b_hi) + small


def window_sample_plain(heatmaps: torch.Tensor, coords: torch.Tensor, cfg: WindowConfig,
                        chunk: int = 128) -> torch.Tensor:
    """heatmaps (V, H, W, J <= 16) f32, coords (NB, V, 2, S) f32 pixel
    (x; y) -> (NB, 16, S) f32: the window kernel's arithmetic step by step
    (origin, window slice, weights, product, the other axis, view mean,
    clamp), `chunk` sample blocks at a time.  float32 matrix products must
    run in full float32 (`device.pin_float32`)."""
    V, H, W, J = heatmaps.shape
    hmp = F.pad(heatmaps, (0, JP - J))
    dev = heatmaps.device
    views = torch.arange(V, device=dev)[None, :, None, None]
    ax, ay = torch.arange(cfg.xw, device=dev), torch.arange(cfg.yw, device=dev)
    outs = []
    for c in coords.split(chunk):
        x, y = c[:, :, 0], c[:, :, 1]  # (n, V, S)
        xi = window_origin(x.amin(-1), W - cfg.xw)[..., None] + ax  # (n, V, XW)
        yi = window_origin(y.amin(-1), H - cfg.yw)[..., None] + ay  # (n, V, YW)
        wx = (1.0 - (x[:, :, None, :] - xi[..., None].float()).abs()).clamp_min(0.0)
        wy = (1.0 - (y[:, :, None, :] - yi[..., None].float()).abs()).clamp_min(0.0)
        win = hmp[views, yi[:, :, :, None], xi[:, :, None, :]]  # (n, V, YW, XW, 16)
        if cfg.contract == "x":
            t = _product(win, wx, "nvyxj,nvxs->nvyjs", cfg.prec)
            per_view = (t * wy[:, :, :, None, :]).sum(2)  # (n, V, 16, S)
        else:
            t = _product(win, wy, "nvyxj,nvys->nvxjs", cfg.prec)
            per_view = (t * wx[:, :, :, None, :]).sum(2)
        acc = torch.zeros_like(per_view[:, 0])
        for v in range(V):
            acc = acc + per_view[:, v]
        outs.append((acc * (1.0 / V)).clamp(0.0, 1.0))
    return torch.cat(outs)


def mma_window_plain(lhs: torch.Tensor, rhs: torch.Tensor, oy: Optional[torch.Tensor],
                     k: int, nmat: int = 5) -> torch.Tensor:
    """lhs (128, M) bf16, rhs (B, 128, N) bf16, oy (B,) int32 row origins
    or None for row 0 -> (B, 8, N) bf16: the sum of `nmat` float32
    products lhs[o:o+k].T @ rhs[b, :k] of the bf16 values, its first 8
    rows times 1 / nmat."""
    B = rhs.shape[0]
    origin = torch.zeros(B, dtype=torch.long, device=rhs.device) if oy is None else oy.long()
    rows = origin[:, None] + torch.arange(k, device=rhs.device)  # (B, k)
    win = lhs.float()[rows]  # (B, k, M)
    right = rhs[:, :k].float()
    acc = torch.zeros((B, lhs.shape[1], rhs.shape[2]), dtype=torch.float32, device=rhs.device)
    for _ in range(nmat):
        acc = acc + torch.einsum("bkm,bkn->bmn", win, right)
    return (acc[:, :8] * (1.0 / nmat)).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# mma_window's launch plan (csrc/mma_window.cu takes it as given)
# ---------------------------------------------------------------------------

MMA_TILE_M, MMA_TILE_N = 128, 256  # two consumer warpgroups of m64n256k16
MMA_THREADS = 384  # one producer and two consumer warpgroups
MMA_REGS = 168  # registers per thread under __launch_bounds__(384, 1)
MMA_B_STAGES = 2  # the kernel's kBStages
MMA_MAX_A_STAGES = 8
MMA_ALIGN = 1024  # the stage buffers start on a 128-byte swizzle atom
SMEM_RESERVED_PER_BLOCK = 1024  # what an H100 keeps of each block's shared memory
REGS_PER_SM = 65_536


@dataclass(frozen=True)
class MmaPlan:
    """One launch of mma_window: the tile (rows, columns), the stages of
    its A ring (the B ring has MMA_B_STAGES), dynamic shared memory per
    block, blocks per SM, the persistent grid, and the row and column
    tiles of one step."""

    tile_m: int
    tile_n: int
    a_stages: int
    smem: int
    blocks_per_sm: int
    grid: int
    m_tiles: int
    n_tiles: int

    @property
    def tiles_per_step(self) -> int:
        return self.m_tiles * self.n_tiles


def mma_smem_bytes(k: int, a_stages: int) -> int:
    """Dynamic shared memory of the kernel's layout: slack to align the
    stage buffers, the A stages (128 x k bf16), the B stages (256 x k
    bf16), two 8-byte barriers per stage."""
    return (MMA_ALIGN + (a_stages * MMA_TILE_M + MMA_B_STAGES * MMA_TILE_N) * k * 2
            + 16 * (a_stages + MMA_B_STAGES))


@functools.lru_cache(maxsize=64)
def mma_plan(M: int, N: int, K: int, B: int, sm_count: int, smem_per_sm: int,
             smem_per_block: int) -> MmaPlan:
    """The launch for lhs (128, M), rhs (B, 128, N), window height K on a
    device with `sm_count` SMs of `smem_per_sm` bytes of shared memory, of
    which one block may ask for `smem_per_block` (`mma_device` reads all
    three): as many A stages (up to 8) as a block's shared memory holds
    beside the two B stages, blocks per SM as shared memory and
    MMA_REGS registers per thread allow, and one persistent block per
    such slot, or per tile where there are fewer tiles.  On the card,
    `mma_kernel_layout` holds the shared memory and blocks per SM
    against the kernel as built."""
    limit = min(smem_per_sm - SMEM_RESERVED_PER_BLOCK, smem_per_block)
    free = limit - mma_smem_bytes(K, 0)
    a_stages = min(MMA_MAX_A_STAGES, free // (MMA_TILE_M * K * 2 + 16))
    if a_stages < 1:
        raise ValueError(f"mma_window: K = {K} leaves no A stage in {limit} bytes")
    smem = mma_smem_bytes(K, a_stages)
    blocks = min(smem_per_sm // (smem + SMEM_RESERVED_PER_BLOCK),
                 REGS_PER_SM // (MMA_THREADS * MMA_REGS))
    m_tiles, n_tiles = -(-M // MMA_TILE_M), -(-N // MMA_TILE_N)
    return MmaPlan(MMA_TILE_M, MMA_TILE_N, a_stages, smem, blocks,
                   min(B * n_tiles * m_tiles, sm_count * blocks), m_tiles, n_tiles)


def mma_schedule(plan: MmaPlan, B: int, block: int) -> list:
    """The tiles block `block` computes, in the kernel's order, as (step,
    first column, first row): of the T = B * n_tiles * m_tiles tiles in
    (step, column tile, row tile) order, those from block * T // grid to
    (block + 1) * T // grid.  A block loads a column tile once for its
    run of that unit's row tiles.  This is a copy of the kernel's walk
    (csrc/mma_window.cu, `first` and `last`) for the CPU tests of the
    plan; the card tests that compare the kernel with its plain version
    on ragged tiles and on a grid that wraps over the steps
    (tests/test_torch_cuda.py) are what hold it against the kernel."""
    total = B * plan.n_tiles * plan.m_tiles
    tiles = []
    for t in range(total * block // plan.grid, total * (block + 1) // plan.grid):
        u, mt = divmod(t, plan.m_tiles)
        b, nt = divmod(u, plan.n_tiles)
        tiles.append((b, nt * plan.tile_n, mt * plan.tile_m))
    return tiles


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _window_lib():
    from .cuda_build import load

    lib = load("window")
    if not getattr(lib, "_fvp_typed", False):
        lib.fvp_window_sample.argtypes = [_P, _P, _P, _I, _I, _I, _I, _F] + [_I] * 5 + [_P]
        lib.fvp_window_sample.restype = _I
        lib._fvp_typed = True
    return lib


def _mma_lib():
    from .cuda_build import load

    lib = load("mma_window")
    if not getattr(lib, "_fvp_typed", False):
        lib.fvp_mma_window.argtypes = [_P] * 4 + [_I] * 6 + [_F] + [_I] * 3 + [_P]
        lib.fvp_mma_window.restype = _I
        lib.fvp_mma_layout.argtypes = [_I, _I, _P]
        lib.fvp_mma_layout.restype = _I
        lib.fvp_mma_device.argtypes = [_P, _P, _P]
        lib.fvp_mma_device.restype = _I
        lib._fvp_typed = True
    return lib


def window_sample(heatmaps: torch.Tensor, coords: torch.Tensor, cfg: WindowConfig) -> torch.Tensor:
    """heatmaps (V, H, W, J <= 16) f32, coords (NB, V, 2, S) f32 pixel
    (x; y) -> (NB, 16, S) f32.  The heatmaps are packed here
    (`pack_heatmap`); only the configurations of PROBE_CONFIG and
    SWEEP_CONFIGS are instantiated."""
    if _on_cpu(heatmaps, coords):
        return window_sample_plain(heatmaps, coords, cfg)
    V, H, W, J = heatmaps.shape
    NB = coords.shape[0]
    _check(heatmaps, "heatmaps", torch.float32, (V, H, W, J))
    _check(coords, "coords", torch.float32, (NB, V, 2, cfg.s))
    if not (0 < J <= JP and 0 < V <= 8):
        raise ValueError(f"window_sample takes 1..{JP} joints and 1..8 views, got {J} and {V}")
    if W < cfg.xw or H < cfg.yw:
        raise ValueError(f"a {cfg.xw} x {cfg.yw} window does not fit a {W} x {H} heatmap")
    if coords.data_ptr() % 16:
        raise ValueError("window_sample: coords must start on 16 bytes")
    packed = pack_heatmap(heatmaps)
    out = torch.empty((NB, JP, cfg.s), dtype=torch.float32, device=heatmaps.device)
    err = _window_lib().fvp_window_sample(
        coords.data_ptr(), packed.data_ptr(), out.data_ptr(), NB, V, W, H, 1.0 / V,
        cfg.s, cfg.xw, cfg.yw, PRECISIONS.index(cfg.prec), CONTRACTS.index(cfg.contract),
        _stream(heatmaps.device),
    )
    if err == -1:
        raise ValueError(f"window_sample: no kernel is instantiated for {cfg}")
    _raise_on(err, "window_sample")
    LAUNCHES["window_sample"] += 1
    return out


@functools.lru_cache(maxsize=None)
def mma_device(index: int) -> Tuple[int, int, int]:
    """(SM count, shared memory per SM, the most shared memory one block
    may opt in to, in bytes) of CUDA device `index`, as the kernel's
    library reads them: the last three arguments of `mma_plan`."""
    sm, smem, block = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(index):
        err = _mma_lib().fvp_mma_device(ctypes.byref(sm), ctypes.byref(smem), ctypes.byref(block))
    _raise_on(err, "mma_window's device query")
    return sm.value, smem.value, block.value


def mma_kernel_layout(k: int, a_stages: int) -> Tuple[int, int, int, int, int, int]:
    """The kernel's own (tile rows, tile columns, threads, dynamic shared
    memory, B stages, blocks per SM) for these A stages on the current
    device, the last by the runtime's occupancy calculator on the kernel
    as built: what a plan is held against."""
    out = (ctypes.c_int * 6)()
    err = _mma_lib().fvp_mma_layout(k, a_stages, out)
    if err == -1:
        raise ValueError(f"mma_window: no kernel is instantiated for K = {k}")
    _raise_on(err, "mma_window's occupancy query")
    return tuple(out)


_MMA_ERRORS = {
    -2: "the plan's A stages do not fit its shared memory",
    -3: "the CUDA driver has no cuTensorMapEncodeTiled",
    -4: "a TMA tensor map could not be encoded",
}


def mma_window(lhs: torch.Tensor, rhs: torch.Tensor, oy: Optional[torch.Tensor],
               k: int, nmat: int = 5) -> torch.Tensor:
    """lhs (128, M) bf16, rhs (B, 128, N) bf16, oy (B,) int32 row origins
    (multiples of 16 in [0, 128 - k]) or None for the static origin 0
    -> (B, 8, N) bf16; M a multiple of 16, N of 64, k in (128, 64, 32).
    A step whose origin is not such a multiple is written as NaN."""
    args = (lhs, rhs) if oy is None else (lhs, rhs, oy)
    if _on_cpu(*args):
        return mma_window_plain(lhs, rhs, oy, k, nmat)
    M, (B, _, N) = lhs.shape[1], rhs.shape
    _check(lhs, "lhs", torch.bfloat16, (MMA_ROWS, M))
    _check(rhs, "rhs", torch.bfloat16, (B, MMA_ROWS, N))
    if oy is not None:
        _check(oy, "oy", torch.int32, (B,))
    if M % 16 or N % 64 or M <= 0 or nmat <= 0:
        raise ValueError(f"mma_window: M {M} must be a multiple of 16, N {N} of 64, nmat > 0")
    if lhs.data_ptr() % 16 or rhs.data_ptr() % 16:
        raise ValueError("mma_window: lhs and rhs must start on 16 bytes (TMA)")
    plan = mma_plan(M, N, k, B, *mma_device(rhs.device.index))
    out = torch.empty((B, 8, N), dtype=torch.bfloat16, device=rhs.device)
    err = _mma_lib().fvp_mma_window(
        lhs.data_ptr(), rhs.data_ptr(), None if oy is None else oy.data_ptr(), out.data_ptr(),
        B, M, N, k, int(oy is not None), nmat, 1.0 / nmat, plan.a_stages, plan.grid,
        plan.smem, _stream(rhs.device),
    )
    if err == -1:
        raise ValueError(f"mma_window: no kernel is instantiated for K = {k}")
    if err in _MMA_ERRORS:
        raise RuntimeError(f"mma_window: {_MMA_ERRORS[err]}")
    _raise_on(err, "mma_window")
    LAUNCHES["mma_window"] += 1
    return out
