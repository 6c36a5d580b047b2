"""Build and load the port's CUDA kernels.

Each source under `faster_voxelpose_tpu_torch/csrc/` is compiled by
`nvcc` for `sm_90a` into a shared library with a plain C interface,
loaded with ctypes.  The build runs at first use, into `build/kernels/`
at the root of the checkout, under a name keyed by a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
not.  Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Iterable

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else
    /usr/local/cuda/bin/nvcc."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    candidates += [found] if found else []
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build_all(names: Iterable[str]) -> Dict[str, pathlib.Path]:
    """Compile every named source that is not built yet, one nvcc process
    per source, all started together.  Writes each compiler log (with the
    `-Xptxas -v` register and spill report) beside its library as
    `<lib>.log`, and raises with the log of any build that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {n: library_path(n) for n in names}
    todo = {n: p for n, p in libs.items() if not p.exists()}
    if not todo:
        return libs
    nvcc = nvcc_path()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        todo[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; one handle per process."""
    return ctypes.CDLL(str(build_all([name])[name]))
