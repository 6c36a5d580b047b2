"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port."""

import ast
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "faster_voxelpose_tpu"}


def _modules():
    out = []
    for p in sorted(HERE.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        if "tests" in rel.parts or "." in rel.name:
            continue
        out.append(".".join(rel.parts).removesuffix(".__init__"))
    return out


def _loaded_after(imports):
    code = ("import importlib, sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            f"for m in {imports!r}: importlib.import_module(m)\n"
            "import benchmark.core.spec as s\n"
            "for w in s.benchmark_json()['workloads']: s.load_cell(w['name'])\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_every_benchmark_module_loads_no_jax():
    loaded = _loaded_after(_modules())
    assert not loaded & FORBIDDEN
    assert "faster_voxelpose_tpu_torch" not in FORBIDDEN  # names compared whole


def test_reference_imports_nothing_of_the_port():
    for p in (HERE / "reference").rglob("*.py"):
        tree = ast.parse(p.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"faster_voxelpose_tpu_torch",
                                                          "benchmark"}, (p, n)
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import benchmark.reference.fusion, benchmark.reference.resnet\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"faster_voxelpose_tpu_torch"})
