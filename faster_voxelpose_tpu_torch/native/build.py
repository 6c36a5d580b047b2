"""Build and load the port's native host code (the counterpart of
`faster_voxelpose_tpu/native/build.py`): `render.cpp`, the heatmap
renderer of the 'gt' and 'pred' sources, and `warp.cpp`, the fused warp
and normalisation of the 'image' source.

Each source is compiled with g++ at first use into
`build/native/` at the root of the checkout, under a name keyed by a hash
of the source and the flags, so an edited source is rebuilt and an
unchanged one is not; a concurrent build by another process (a spawn
worker) writes its own temporary file and the last rename wins.  A build
that fails raises NativeBuildError with the compiler's output: the port
has no quiet fallback to numpy or cv2 (the JAX package's loader returns
None and renders in numpy instead).  Nothing here runs when the module
is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess

import numpy as np

SRC_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parents[1] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


class NativeBuildError(RuntimeError):
    """The C++ compiler is missing or refused a source."""


def library_path(name: str) -> pathlib.Path:
    src = (SRC_DIR / f"{name}.cpp").read_bytes()
    key = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(name: str) -> pathlib.Path:
    """Compile <name>.cpp unless it is built already; its library path."""
    path = library_path(name)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SRC_DIR / f"{name}.cpp"), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeBuildError(f"cannot build native/{name}.cpp: {' '.join(cmd)}: {e}") from e
    if r.returncode != 0:
        raise NativeBuildError(f"native/{name}.cpp failed to build (exit {r.returncode}): "
                               f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
    os.replace(tmp, path)
    return path


_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_INT = ctypes.c_int
_SIGNATURES = {
    "render": {
        # out, H, W, J, M, mu, joint_id, sigma, tmp_size, scale, occl
        "render_joints": [_F32, _INT, _INT, _INT, _INT, _I32, _I32, _F32, _F32, _F32, _I32],
    },
    "warp": {
        # src, h_in, w_in, dst, h_out, w_out, inv 2x3, mean, std, swap_rb
        "warp_normalize": [_U8, _INT, _INT, _F32, _INT, _INT, _F32, _F32, _F32, _INT],
        # src, h, w, dst, mean, std, swap_rb
        "normalize_u8": [_U8, _INT, _INT, _F32, _F32, _F32, _INT],
    },
}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load native/<name>.cpp with its functions'
    signatures bound; one handle per process."""
    lib = ctypes.CDLL(str(build(name)))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).restype = None
        getattr(lib, fn).argtypes = argtypes
    return lib


def render_joints_native(H: int, W: int, J: int, mu: np.ndarray, joint_id: np.ndarray,
                         sigma: np.ndarray, tmp_size: np.ndarray, scale: np.ndarray,
                         occl: np.ndarray) -> np.ndarray:
    """Rasterise M joint instances into (H, W, J) float32 heatmaps:
    mu (M, 2) int32 centres, joint_id (M,) int32, sigma, tmp_size and
    scale (M,) float32, occl (M, 4) int32 [y0, y1, x0, x1) in the local
    window.  The plain version is `datasets.base._render_joints_numpy`."""
    lib = load("render")
    out = np.zeros((H, W, J), np.float32)
    M = int(mu.shape[0])
    if M:
        lib.render_joints(
            out, H, W, J, M,
            np.ascontiguousarray(mu, np.int32), np.ascontiguousarray(joint_id, np.int32),
            np.ascontiguousarray(sigma, np.float32), np.ascontiguousarray(tmp_size, np.float32),
            np.ascontiguousarray(scale, np.float32), np.ascontiguousarray(occl, np.int32))
    return out


def warp_normalize_native(img: np.ndarray, out_size, inv_transform: np.ndarray,
                          mean: np.ndarray, std: np.ndarray, swap_rb: bool) -> np.ndarray:
    """(h_in, w_in, 3) uint8 -> (H, W, 3) float32 for out_size (W, H):
    bilinear samples at the 2x3 dst->src affine `inv_transform`, zero
    outside the source, normalised by the per-output-channel mean and std
    of v / 255, channels reversed when `swap_rb`."""
    lib = load("warp")
    W, H = int(out_size[0]), int(out_size[1])
    dst = np.empty((H, W, 3), np.float32)
    lib.warp_normalize(
        np.ascontiguousarray(img, np.uint8), img.shape[0], img.shape[1], dst, H, W,
        np.ascontiguousarray(inv_transform, np.float32).reshape(-1),
        np.ascontiguousarray(mean, np.float32), np.ascontiguousarray(std, np.float32),
        int(swap_rb))
    return dst


def normalize_u8_native(img: np.ndarray, mean: np.ndarray, std: np.ndarray,
                        swap_rb: bool) -> np.ndarray:
    """(h, w, 3) uint8 -> float32 (v / 255 - mean) / std, channels
    reversed when `swap_rb`."""
    lib = load("warp")
    dst = np.empty(img.shape[:2] + (3,), np.float32)
    lib.normalize_u8(
        np.ascontiguousarray(img, np.uint8), img.shape[0], img.shape[1], dst,
        np.ascontiguousarray(mean, np.float32), np.ascontiguousarray(std, np.float32),
        int(swap_rb))
    return dst
