"""Build and load the port's CUDA kernels.

Each source under `faster_voxelpose_tpu_torch/csrc/` is compiled by
`nvcc` for `sm_90a` into a shared library with a plain C interface,
loaded with ctypes.  The build runs at first use, into `build/kernels/`
at the root of the checkout, under a name keyed by a hash of the source,
the shared headers (`csrc/*.cuh`) and the flags, so an edited source is
rebuilt and an unchanged one is not.  Nothing here runs when the module
is imported.

A variant of a source is built with preprocessor defines (`-DNAME=VALUE`,
e.g. the block shapes that `csrc/sampling.cu` guards with `#ifndef`) into
a library of its own, `<name>-<defines>-<hash>.so`; the production build
passes no define, and its library name is the one it always had.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

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


Defines = Tuple[str, ...]  # ("FVP_CROP_TX=8", ...): -D flags of a variant
Target = Union[str, Tuple[str, Defines]]  # a source's name, or (name, defines)


def _flags(defines: Sequence[str]) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines: Sequence[str] = ()) -> pathlib.Path:
    """The library of csrc/<name>.cu built with `defines`, keyed by the
    source, the headers under csrc/ (`projection.cuh`) and the flags."""
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    key = hashlib.sha256(src + " ".join(_flags(defines)).encode()).hexdigest()[:16]
    tag = "".join(f"-{d.replace('=', '')}" for d in defines)
    return BUILD_DIR / f"{name}{tag}-{key}.so"


def _split(target: Target) -> Tuple[str, Defines]:
    return (target, ()) if isinstance(target, str) else (target[0], tuple(target[1]))


def build_all(targets: Iterable[Target]) -> Dict[Target, pathlib.Path]:
    """Compile every target (a source's name, or (name, defines) for a
    variant) that is not built yet, one nvcc process per target, all
    started together.  Writes each compiler log (with the `-Xptxas -v`
    register and spill report) beside its library as `<lib>.log`, and
    raises with the log of any build that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {t: library_path(*_split(t)) for t in targets}
    todo = {t: p for t, p in libs.items() if not p.exists()}
    if not todo:
        return libs
    nvcc = nvcc_path()
    procs = {}
    for t, p in todo.items():
        name, defines = _split(t)
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[t] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for t, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        todo[t].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{todo[t].stem} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, todo[t])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


@functools.lru_cache(maxsize=None)
def load(name: str, defines: Defines = ()) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu, with `defines` for a
    variant; one handle per process and variant.  The first load is the
    set-up span `setup.kernels`, a child of the span open around it."""
    from ..utils.profiling import SPANS

    target = (name, tuple(defines)) if defines else name
    with SPANS.span("setup.kernels", label=name):
        return ctypes.CDLL(str(build_all([target])[target]))


def build_variants(name: str, variants: Iterable[Defines]) -> Dict[Defines, Optional[str]]:
    """Build csrc/<name>.cu once per set of defines, all in parallel
    (`build_all`); returns {defines: None when built, else the reason it
    failed}, so that a caller can report each variant and go on."""
    variants = [tuple(v) for v in variants]
    targets = [(name, v) if v else name for v in variants]
    try:
        build_all(targets)
        return {v: None for v in variants}
    except RuntimeError as e:  # the libraries that built are in place
        why = str(e)
        return {v: None if library_path(name, v).exists() else why for v in variants}
