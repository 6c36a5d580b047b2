"""PyTorch port, the sampling tools against the JAX repo's scripts (CPU):

- `tools/check_sampling_parity.py` against scripts/check_pallas_parity.py:
  `dome_cameras` and `structured_heatmaps` bit for bit, the script's
  variant list and defaults (read from its source) plus the port's one
  added variant, the route each variant resolves to and its command line
  at the tiny geometry (gaps of 0 on the CPU, where every route runs the
  plain versions);
- `tools/smoke_kernels.py` against scripts/smoke_kernel_tpu.py: the
  script's heatmaps and coords of each check bit for bit (captured where
  the script hands them to its reference), and its command line;
- `tools/sweep_planes.py` and `tools/sweep_whole.py`: their command lines,
  the production row built with no define, and a variant that fails
  reported as FAILED with a non-zero exit;
- `ops/cuda_build.py`'s variants: the production library's name and flags
  unchanged, a library per set of defines, builds that fail reported per
  variant (a stand-in compiler), and `csrc/sampling.cu`'s block-shape
  guards defaulting to the production constants.
"""

import ast
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = str(REPO / "scripts")


def _script(name):
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    return __import__(name)


@pytest.fixture(scope="module")
def tiny_yaml(tmp_path_factory):
    from tests.test_torch_bench import TINY_YAML

    path = tmp_path_factory.mktemp("tiny") / "tiny.yaml"
    path.write_text(TINY_YAML)
    return str(path)


# -- check_sampling_parity ---------------------------------------------------

def _script_lists():
    """The script's `variants` and `defaults` literals, evaluated from its
    source (they are local to its main)."""
    tree = ast.parse((REPO / "scripts" / "check_pallas_parity.py").read_text())
    found = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id in ("variants", "defaults") \
                and isinstance(node.value, (ast.List, ast.Call)):
            found[node.targets[0].id] = eval(compile(ast.Expression(node.value), "script", "eval"),
                                             {"dict": dict})
    return found["variants"], found["defaults"]


def test_parity_inputs_and_variants_match_the_script():
    from faster_voxelpose_tpu_torch.tools import check_sampling_parity as csp

    script = _script("check_pallas_parity")
    for B, V, seed in ((1, 5, 100), (2, 3, 7)):
        assert np.array_equal(csp.dome_cameras(B, V, seed), script.dome_cameras(B, V, seed))
    for shape in ((1, 5, 32, 40, 15), (2, 3, 40, 48, 17)):
        a = csp.structured_heatmaps(np.random.RandomState(0), *shape)
        b = script.structured_heatmaps(np.random.RandomState(0), *shape)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    variants, defaults = _script_lists()
    assert csp.VARIANTS[:-1] == variants and csp.VARIANTS[-1][0] == "pallas_t444"
    assert csp.DEFAULTS == defaults


def test_parity_routes_and_cli_at_tiny(tiny_yaml, capsys):
    """The tiny profile (16^3 crops: the script's (8, 8, 32) tiles do not
    fit it, so those variants are left out): each variant's route, 'same
    route as' for a repeat, gaps of 0 and a time per variant."""
    from faster_voxelpose_tpu_torch.tools import check_sampling_parity as csp

    names = "quad,pallas_exact,pallas_fast,pallas_fast_t4416,pallas_fast_bf16,pallas_t444"
    out = csp.main(["--cfg", tiny_yaml, "--device", "cpu", f"--only={names}",
                    "--lengths", "1,2"])
    text = capsys.readouterr().out
    assert list(out) == names.split(",")
    crop = {n: r["route"]["crop"] for n, r in out.items()}
    assert crop == {"quad": "sample_crop_planes", "pallas_exact": "sample_crop_planes_coords",
                    "pallas_fast": "sample_crop_planes_coords",
                    "pallas_fast_t4416": "sample_crop_planes_coords",
                    "pallas_fast_bf16": "sample_crop_planes_coords",
                    "pallas_t444": "sample_crop_cube"}
    assert out["pallas_fast"]["same_route_as"] == "pallas_exact"
    assert out["pallas_fast_bf16"]["same_route_as"] is None  # another dtype
    assert "pallas_fast: route" in text and "same route as pallas_exact" in text
    for n, r in out.items():
        assert r["route"]["whole"] == "sample_whole_projected"
        assert r["launches"] == {} and r["device_ms"] is None and r["ms"] > 0
        if n != "quad":
            assert r["agreement"] == 1.0
            if r["dtype"] == "float32":
                assert r["gap_mm"] == 0.0
    assert "max fused-pose delta" in text and text.strip().splitlines()[-1].startswith("{")
    # --no-timing reads no time
    quiet = csp.check(tiny_yaml, torch.device("cpu"), ["quad"], timing=False)
    assert "ms" not in quiet["quad"]


# -- smoke_kernels -----------------------------------------------------------

def test_smoke_inputs_match_the_script(monkeypatch):
    """Each of the script's coords checks hands its heatmaps and coords to
    `xla_reference`: the port draws the same arrays from the same seed."""
    import jax.numpy as jnp

    import faster_voxelpose_tpu.ops.pallas_sampling as ps
    from faster_voxelpose_tpu.ops.pallas_sampling import SampleKernelSpec
    from faster_voxelpose_tpu_torch.tools import smoke_kernels as smk

    script = _script("smoke_kernel_tpu")
    seen = []
    monkeypatch.setattr(ps, "pack_heatmaps", lambda h, spec: h)
    monkeypatch.setattr(ps, "sample_tiles", lambda h, c, spec: jnp.zeros(()))
    monkeypatch.setattr(script, "xla_reference",
                        lambda hm, coords, spec: seen.append((np.asarray(hm), np.asarray(coords)))
                        or jnp.zeros(()))
    cases = [(dict(n_views=5, height=128, width=240, num_joints=15, tile=(8, 8, 8)), 64, 8, None),
             (dict(n_views=5, height=128, width=240, num_joints=15, tile=(8, 8, 8)), 64, 8, 4),
             (dict(n_views=5, height=152, width=200, num_joints=17, tile=(8, 8, 8)), 64, 8, 8),
             (dict(n_views=5, height=128, width=240, num_joints=15, tile=(4, 4, 20)), 40, 20, 3)]
    for kw, nb, jitter, wild in cases:
        spec = SampleKernelSpec(window_x=40, window_y=48, exact=True, **kw)
        script.check("x", spec, nb=nb, jitter=jitter, wild_every=wild)
        hm, coords = seen[-1]
        rng = np.random.RandomState(0)
        V, H, W, J = kw["n_views"], kw["height"], kw["width"], kw["num_joints"]
        assert np.array_equal(rng.rand(V, H, W, J).astype(np.float32), hm)
        ours = smk.block_coords(rng, V, H, W, int(np.prod(kw["tile"])), nb, jitter, wild)
        assert ours.dtype == np.float32 and np.array_equal(ours, coords)


def test_smoke_kernels_cli_at_tiny(tiny_yaml, capsys):
    from faster_voxelpose_tpu_torch.tools import smoke_kernels as smk

    line = smk.main(["--device", "cpu", "--cfg", tiny_yaml, "--lengths", "1,2"])
    text = capsys.readouterr().out
    assert line["misses"] == [] and line["tolerance"] == 1e-5
    assert set(line["errors"]) == {"jln compact", "jln wild", "shelf17 wild", "whole wild",
                                   "whole near camera"}
    assert all(e == 0.0 for case in line["errors"].values() for e in case.values())
    assert len(line["ms"]) == 3 and all(t > 0 for t in line["ms"].values())
    assert text.count("(OK)") == 13 and "FAIL" not in text
    quick = smk.main(["--device", "cpu", "--quick"])
    assert quick["ms"] == {} and "whole near camera" not in quick["errors"]


# -- the sweeps --------------------------------------------------------------

@pytest.mark.parametrize("tool", ["sweep_planes", "sweep_whole"])
def test_sweep_cli_at_tiny(tool, tiny_yaml, capsys):
    import importlib

    mod = importlib.import_module(f"faster_voxelpose_tpu_torch.tools.{tool}")
    production = next(n for n, d in mod.VARIANTS if not d)
    assert production == mod.PRODUCTION and "(production)" in production
    assert len({d for _, d in mod.VARIANTS}) == len(mod.VARIANTS)
    wanted = [mod.VARIANTS[0][0].split()[0], production.split()[0], mod.VARIANTS[-1][0]]
    rows = mod.main(["--device", "cpu", "--cfg", tiny_yaml, "--lengths", "1,2",
                     "--variants", ",".join(wanted)])
    text = capsys.readouterr().out
    assert [r["name"] for r in rows] == [n for n, _ in mod.VARIANTS if n.split()[0] in wanted]
    assert "FAILED" not in text and text.strip().splitlines()[-1].startswith("{")
    for r in rows:
        errs = [r["err"]] if "err" in r else [v["err"] for k, v in r.items()
                                              if isinstance(v, dict) and "err" in v]
        assert errs and all(e == 0.0 for e in errs)
    if tool == "sweep_planes":
        assert set(rows[0]) >= {"all K valid", "served (4 of 4 valid)"}


def test_sweep_reports_a_failed_variant(tiny_yaml, monkeypatch, capsys):
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk
    from faster_voxelpose_tpu_torch.tools import sweep_whole

    real = sk.kernel_variant

    def failing(defines):
        if "FVP_WHOLE_VOXELS=64" in defines:
            raise RuntimeError("no launch for this variant")
        return real(defines)

    monkeypatch.setattr(sk, "kernel_variant", failing)
    with pytest.raises(SystemExit, match="1 of 2 variants failed"):
        sweep_whole.main(["--device", "cpu", "--cfg", tiny_yaml, "--lengths", "1,2",
                          "--variants", "v64,v256"])
    text = capsys.readouterr().out
    assert "v64                 : FAILED no launch for this variant" in text
    assert re.search(r"v256 \(production\)\s*:\s+[0-9.]+ ms", text)


# -- cuda_build variants -----------------------------------------------------

def test_production_build_is_unchanged_by_the_variants():
    from faster_voxelpose_tpu_torch.ops import cuda_build as cb

    prod = cb.library_path("sampling")
    assert prod == cb.library_path("sampling", ())
    assert re.fullmatch(r"sampling-[0-9a-f]{16}\.so", prod.name)
    assert cb._flags(()) == cb.NVCC_FLAGS
    var = cb.library_path("sampling", ("FVP_CROP_TX=8", "FVP_THREADS=512"))
    assert re.fullmatch(r"sampling-FVP_CROP_TX8-FVP_THREADS512-[0-9a-f]{16}\.so", var.name)
    assert var != cb.library_path("sampling", ("FVP_CROP_TX=4", "FVP_THREADS=512"))
    src = (cb.CSRC / "sampling.cu").read_text()
    defaults = dict(re.findall(r"#ifndef (FVP_\w+)\n#define \1 (\d+)\n#endif", src))
    assert defaults == {"FVP_THREADS": "256", "FVP_CROP_TX": "4", "FVP_CROP_TY": "4",
                        "FVP_CROP_TZ": "32", "FVP_WHOLE_VOXELS": "256"}
    for name in ("kThreads = FVP_THREADS", "kTX = FVP_CROP_TX, kTY = FVP_CROP_TY, kTZ = FVP_CROP_TZ",
                 "kWholeVoxels = FVP_WHOLE_VOXELS"):
        assert name in src


def test_build_variants_reports_each_failure(tmp_path, monkeypatch):
    """A stand-in compiler that writes its output unless a define says
    FVP_CROP_TX=99: the production build and one variant are built, the
    other variant's reason is returned, and one process ran per target."""
    from faster_voxelpose_tpu_torch.ops import cuda_build as cb

    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho \"$@\" >> %s\ncase \"$*\" in *FVP_CROP_TX=99*) "
                    "echo 'error: bad tile'; exit 2;; esac\n"
                    "while [ \"$1\" != -o ]; do shift; done; touch \"$2\"\n" % calls)
    nvcc.chmod(0o755)
    monkeypatch.setattr(cb, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(cb, "nvcc_path", lambda: str(nvcc))
    good, bad = ("FVP_CROP_TX=8",), ("FVP_CROP_TX=99",)
    got = cb.build_variants("sampling", [(), good, bad])
    assert got[()] is None and got[good] is None
    assert "error: bad tile" in got[bad] and "exit 2" in got[bad]
    assert cb.library_path("sampling").exists() and cb.library_path("sampling", good).exists()
    assert not cb.library_path("sampling", bad).exists()
    lines = calls.read_text().splitlines()
    assert len(lines) == 3 and sum("-D" in ln for ln in lines) == 2
    assert cb.build_variants("sampling", [(), good]) == {(): None, good: None}
    assert len(calls.read_text().splitlines()) == 3  # built ones are not rebuilt


def test_kernel_variant_selects_and_restores():
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    assert sk._VARIANT == ()
    with sk.kernel_variant(["FVP_THREADS=128"]):
        assert sk._VARIANT == ("FVP_THREADS=128",)
        with sk.kernel_variant(()):
            assert sk._VARIANT == ()
        assert sk._VARIANT == ("FVP_THREADS=128",)
    assert sk._VARIANT == ()
    with pytest.raises(KeyError):
        with sk.kernel_variant(["FVP_THREADS=64"]):
            raise KeyError("inside")
    assert sk._VARIANT == ()
