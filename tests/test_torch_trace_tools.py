"""PyTorch port, the trace and backbone tools against the JAX repo's
scripts (CPU):

- `tools/analyze_trace.py` against scripts/analyze_trace.py: on a
  fabricated Chrome trace with known device events, the same top-N rows
  as the script prints and the same trace found in a directory; the sums,
  the busy share (the union of the device intervals over the span) and
  the idle gaps with the host op at each, exactly; device annotations
  ignored;
- `tools/capture_trace.py` on the CPU at the tiny geometry: a
  torch.profiler trace that the analyzer reads through its fallback,
  labelled "host";
- `tools/profile_backbone.py` against scripts/profile_backbone.py, run at
  V = 1 images of 64 x 96 in float32: the MAC counts stage by stage, and
  each stem candidate against the JAX candidate's output on the same
  weights within 1e-5; its command line at tiny lengths.
"""

import gzip
import inspect
import json
import os
import pathlib
import re
import sys
import types

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = str(REPO / "scripts")


def _script(name):
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    return __import__(name)


# -- analyze_trace -----------------------------------------------------------

def _x(name, cat, pid, tid, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "pid": pid, "tid": tid, "ts": ts, "dur": dur}


def _fabricated(annotation=False):
    """A Chrome trace: device lane pid 0 ("GPU 0", streams 7 and 8), host
    pid 1.  Device intervals (us) [100, 150], [160, 200], [190, 210],
    [300, 340], [400, 410]; their union is 150 us busy over a 310 us span,
    with gaps of 10 us at 150 (host: aten::conv2d), 90 us at 210
    (cudaLaunchKernel, inside the conv) and 60 us at 340 (aten::sum)."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "python"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7, "args": {"name": "stream 7"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 8, "args": {"name": "stream 8"}},
        _x("void whole_kernel<15>(float const*)", "kernel", 0, 7, 100, 50),
        _x("void crop_kernel<false, false>(float const*)", "kernel", 0, 7, 160, 40),
        _x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 0, 8, 190, 20),
        _x("void crop_kernel<false, false>(float const*)", "kernel", 0, 7, 300, 40),
        _x("Memset (Device)", "gpu_memset", 0, 7, 400, 10),
        _x("aten::conv2d", "cpu_op", 1, 1, 150, 100),
        _x("cudaLaunchKernel", "cuda_runtime", 1, 1, 205, 10),
        _x("aten::sum", "cpu_op", 1, 1, 340, 80),
    ]
    if annotation:  # a record_function's span on the device lane: no device work
        ev.append(_x("frame", "gpu_user_annotation", 0, 7, 0, 1000))
    return {"traceEvents": ev}


def _rows(text):
    """The table rows of an analyzer's output (after its header line)."""
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("op ")) + 1
    return [ln for ln in lines[start:] if re.search(r"%$", ln)]


def test_analyze_trace_matches_the_script_and_reads_busy_share_and_gaps(tmp_path, monkeypatch,
                                                                        capsys):
    from faster_voxelpose_tpu_torch.tools import analyze_trace as at

    script = _script("analyze_trace")
    old = tmp_path / "a" / "old.pt.trace.json"
    new = tmp_path / "b" / "host_1.123.pt.trace.json.gz"
    for p in (old, new):
        p.parent.mkdir()
    old.write_text(json.dumps({"traceEvents": []}))
    with gzip.open(new, "wt") as f:
        json.dump(_fabricated(), f)
    os.utime(old, (1, 1))
    assert at.find_trace(str(tmp_path)) == script.find_trace(str(tmp_path)) == str(new)
    assert at.load_events(str(new)) == script.load_events(str(new))

    monkeypatch.setattr(sys, "argv", ["analyze_trace.py", str(new), "40"])
    script.main()
    want = _rows(capsys.readouterr().out)
    res = at.main([str(tmp_path), "40", "--frames", "2"])
    out = capsys.readouterr().out
    assert _rows(out) == want and len(want) == 4
    assert res["kind"] == "device" and "device lanes read" in out
    assert res["lanes"] == ["GPU 0 / stream 7", "GPU 0 / stream 8"]
    assert res["total_us"] == {"void whole_kernel<15>(float const*)": 50.0,
                               "void crop_kernel<false, false>(float const*)": 80.0,
                               "Memcpy DtoH (Device -> Pinned)": 20.0, "Memset (Device)": 10.0}
    assert res["count"]["void crop_kernel<false, false>(float const*)"] == 2
    assert res["sum_us"] == 160.0 and res["span_us"] == 310.0 and res["busy_us"] == 150.0
    assert res["busy_share"] == 150.0 / 310.0
    assert res["gaps"] == [(90.0, 110.0, "cudaLaunchKernel"), (60.0, 240.0, "aten::sum"),
                           (10.0, 50.0, "aten::conv2d")]
    assert "0.0800 ms a frame over 2" in out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["busy_share"] == res["busy_share"] and summary["frames"] == 2
    # a device-side annotation spans the lane but is no device work
    assert at.analyze(_fabricated(annotation=True)["traceEvents"]) == at.analyze(
        _fabricated()["traceEvents"])


def test_capture_trace_on_the_cpu_reads_as_host(tmp_path, capsys):
    """The worst case's frames at the tiny geometry under the CPU profiler:
    a trace under logdir that the analyzer reads through its fallback,
    labelled "host", with the model's convolutions in it."""
    from faster_voxelpose_tpu_torch.tools import analyze_trace, capture_trace
    from tests.test_torch_bench import TINY_YAML

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_YAML)
    res = capture_trace.main([str(tmp_path / "trace"), "2", "--device", "cpu", "--cfg", str(cfg)])
    assert res["trace"].endswith(".pt.trace.json.gz") and res["frames"] == 2
    assert not any(res["launches"].values())  # the plain versions on the CPU
    capsys.readouterr()
    got = analyze_trace.main([str(tmp_path / "trace"), "10"])
    out = capsys.readouterr().out
    assert got["kind"] == "host" and "host: no device event" in out
    assert got["lanes"] and any("conv" in n for n in got["total_us"])
    assert 0 < got["busy_share"] <= 1


# -- profile_backbone --------------------------------------------------------

TINY_IMAGES = (1, 64, 96)


@pytest.fixture(scope="module")
def script_backbone_run():
    """scripts/profile_backbone.py's main at V = 1 images of 64 x 96 in
    float32 (its source with those two constants replaced), its timer
    replaced by one that keeps what it is given and returns 1 s and its
    peak set to 1 FLOP/s, so that each printed share is 100 x the FLOPs:
    {tag: FLOPs} and the (fn, x) of each timed call."""
    src = (REPO / "scripts" / "profile_backbone.py").read_text()
    for a, b in (("V, ih, iw = 5, 512, 960", "V, ih, iw = %d, %d, %d" % TINY_IMAGES),
                 ("dtype = jnp.bfloat16", "dtype = jnp.float32")):
        assert src.count(a) == 1
        src = src.replace(a, b)
    mod = types.ModuleType("profile_backbone_tiny")  # flax's dataclasses look their module up
    mod.__file__ = str(REPO / "scripts" / "profile_backbone.py")
    ns = mod.__dict__
    stages = _script("profile_stages")
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, mod.__name__, mod)
        exec(compile(src, mod.__name__, "exec"), ns)
        ns["PEAK"] = 1.0
        mp.setattr(stages, "slope", lambda fn, x: calls.append((fn, x)) or 1.0)
        mp.setattr(sys, "argv", ["profile_backbone.py"])
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ns["main"]()
    flops = {}
    for line in buf.getvalue().splitlines():
        m = re.match(r"^(\S+)\s.*, +([0-9.]+)% of bf16 peak\)$", line)
        flops[m.group(1)] = int(round(float(m.group(2)) / 100))
    return flops, calls


def test_profile_backbone_flops_match_the_script(script_backbone_run):
    from faster_voxelpose_tpu_torch.tools import profile_backbone as pb

    flops, _ = script_backbone_run
    V, ih, iw = TINY_IMAGES
    macs = pb.stage_macs(ih, iw)
    assert set(flops) == set(pb.TAGS)
    assert {t: pb.gf(macs[t], V) for t in pb.TAGS} == flops
    # and at the bench shapes, the full network's count is the stages' sum
    full = pb.stage_macs(512, 960)
    assert full["full"] == sum(full[s] for s in pb.STAGES)


CANDIDATE_OF = {"S2DStem": "s2d", "S2DSliceStem": "s2dslice", "PadC8Stem": "padc8",
                "K8Stem": "k8", "Stride4Stem": "fusedpool"}


@pytest.mark.parametrize("kind", list(CANDIDATE_OF.values()))
def test_profile_backbone_candidates_match_the_script(script_backbone_run, kind):
    """Each stem candidate with the JAX candidate's weights on the
    script's input: the same output within 1e-5 (float32)."""
    from faster_voxelpose_tpu_torch.tools import profile_backbone as pb
    from faster_voxelpose_tpu_torch.weights import flatten_variables, from_jax_variables

    _, calls = script_backbone_run
    found = {}
    for fn, x in calls:
        nl = inspect.getclosurevars(fn).nonlocals
        if "mod" in nl and type(nl["mod"]).__name__ in CANDIDATE_OF:
            found[CANDIDATE_OF[type(nl["mod"]).__name__]] = (nl["mod"], nl["vs"], np.array(x))
    mod, vs, x = found[kind]
    want = np.asarray(mod.apply(vs, x, mutable=False))
    cand = pb.StemCandidate(kind, torch.float32)
    cand.load_state_dict(from_jax_variables(flatten_variables(vs), cand))
    with torch.no_grad():
        got = cand(torch.as_tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5


def test_profile_backbone_cli_at_tiny(capsys):
    from faster_voxelpose_tpu_torch.tools import profile_backbone as pb

    line = pb.main(["stem,l1,final,full,k8", "--device", "cpu", "--images", "1,64,96",
                    "--lengths", "1,2"])
    out = capsys.readouterr().out
    assert set(line) == {"stem", "l1", "final", "full", "k8"}
    assert all(r["device_ms"] is None and r["tflops"] is None and r["ms"] > 0
               for r in line.values())  # no device rate from the host's clock
    assert "host clock: no device rate" in out and "989 TFLOP/s" in out
    assert line["full"]["shape"] == [1, 64, 96, 3] and line["l1"]["shape"] == [1, 64, 16, 24]
    with pytest.raises(SystemExit, match="unknown tags"):
        pb.main(["l5", "--device", "cpu"])


def test_profile_backbone_folded_stages(capsys):
    """--folded times the backbone as served: its stages are the folded
    module's and compute what the unfolded stages compute, within float32
    rounding at the tool's seed."""
    from faster_voxelpose_tpu_torch.models.resnet import PoseResNet
    from faster_voxelpose_tpu_torch.tools import profile_backbone as pb

    line = pb.main(["stem,deconv,full", "--device", "cpu", "--images", "1,64,96",
                    "--lengths", "1,2", "--folded"])
    assert set(line) == {"stem", "deconv", "full"} and all(r["ms"] > 0 for r in line.values())
    assert "BatchNorm folded" in capsys.readouterr().out
    torch.manual_seed(0)
    plain = PoseResNet(50, 15).eval()
    folded = PoseResNet(50, 15).eval()
    folded.load_state_dict(plain.state_dict())
    fns, want = pb.stage_fns(folded.fold()), pb.stage_fns(plain)
    x = torch.randn(1, 3, 64, 96, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        np.testing.assert_allclose(fns["stem"](x).numpy(), want["stem"](x).numpy(),
                                   rtol=0, atol=1e-5)
