"""The ViTPose cell's files: the cell loads by name, the planted weights
fit the port's module key for key, the work count against a per-layer sum
of the reference's own calls, the planted path, and the new metrics with
nothing to read."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.core.record import Run
from benchmark.core.spec import load_cell
from benchmark.core.vit_weights import vitpose_spec, vitpose_weights, widths
from benchmark.counts import vitpose as counts
from benchmark.drivers.live_service import port_config
from benchmark.reference.vitpose import ViTPoseReference
from benchmark.tests.tiny import run_tiny, tiny_cell

CELL = "shelf_vitpose_h.images.live"
METRICS = ("vit.blocks_served_ms", "vit.head_served_ms", "roofline.vit_attention", "mfu.vit_live")


def tiny_vit_cell(**kw):
    """The cell at the tiny geometry with a ViTPose of width 160, 2 heads
    of 80, 2 blocks (frames 128x64: 4 x 8 tokens)."""
    cell = tiny_cell(CELL, **kw)
    cell.config["yaml"]["VIT"].update(EMBED_DIM=160, NUM_HEADS=2, DEPTH=2)
    return cell


def test_the_cell_loads_with_its_files_and_metrics():
    from faster_voxelpose_tpu_torch.config import VitConfig

    cell = load_cell(CELL)
    assert cell.workload["entry"] == "live_vitpose" and cell.config["reduced"] == []
    assert set(METRICS) <= {m.name for m in cell.metrics}
    cfg = port_config(cell.config)
    assert cfg.BACKBONE == "vitpose" and cfg.VIT == VitConfig()  # the published widths
    assert cfg.DATASET.IMAGE_SIZE == (800, 608) and cfg.DATASET.HEATMAP_SIZE == (200, 152)
    assert widths(cell.config["yaml"])["tokens"] == 38 * 50
    old = load_cell("panoptic_jln64.images.live")
    assert not set(METRICS) & {m.name for m in old.metrics}


def test_planted_weights_fit_the_ports_module():
    """Every key and shape of the port's ViTPose-H (built on the meta
    device) is in the spec; the tiny cell's drawn weights load strictly."""
    from faster_voxelpose_tpu_torch.models.resnet import build_backbone

    cell = load_cell(CELL)
    full = build_backbone(port_config(cell.config), torch.device("meta")).state_dict()
    spec = {}
    for key, shape, kind in vitpose_spec(cell.config["yaml"]):
        names = {"norm": ("weight", "bias"),
                 "bn": ("weight", "bias", "running_mean", "running_var")}.get(kind)
        spec.update({f"{key}.{n}": shape for n in names} if names else {key: shape})
    assert spec == {k: tuple(v.shape) for k, v in full.items()}
    tiny = tiny_vit_cell()
    module = build_backbone(port_config(tiny.config))
    module.load_state_dict(vitpose_weights(tiny.config["yaml"], 5, torch.device("cpu")))


def test_counts_match_the_reference_calls(monkeypatch):
    """The tiny ViTPose's MACs by part against the MACs of every conv,
    transposed conv, dense layer and attention product the reference
    calls on one view; the attention kernel's work by hand."""
    cell = tiny_vit_cell()
    y = cell.config["yaml"]
    macs = {"conv": 0, "matmul": 0}

    def wrap(fn, name):
        def call(x, w, *a, **k):
            out = fn(x, w, *a, **k)
            if name == "linear":
                macs["conv"] += out.numel() * w.shape[1]
            elif name == "conv_transpose2d":
                macs["conv"] += x.numel() * w.shape[1] * int(np.prod(w.shape[2:]))
            else:
                macs["conv"] += out.numel() * w.shape[1] * int(np.prod(w.shape[2:]))
            return out
        return call

    for name in ("conv2d", "conv_transpose2d", "linear"):
        monkeypatch.setattr(F, name, wrap(getattr(F, name), name))
    matmul = torch.Tensor.__matmul__

    def counted(a, b):
        out = matmul(a, b)
        macs["matmul"] += out.numel() * a.shape[-1]
        return out

    monkeypatch.setattr(torch.Tensor, "__matmul__", counted)
    w = widths(y)
    frames = torch.zeros((1, 64, 128, 3), dtype=torch.uint8)
    ViTPoseReference(vitpose_weights(y, 1, torch.device("cpu")), True, w["heads"])(frames)
    parts = counts.vitpose_macs(y)
    assert macs["matmul"] == parts["attention"] == 2 * 2 * 32 * 32 * 160
    assert macs["conv"] == parts["patch"] + parts["linear"] + parts["head"]
    work = counts.attention_kernel(y)
    assert work == {"ops": 3 * 4 * 32 * 32 * 160, "bytes": 3 * 4 * 32 * 160 * 2}
    full = load_cell(CELL).config["yaml"]
    assert counts.request_flops(full) / 1e12 == pytest.approx(15.1, abs=0.1)
    assert counts.attention_kernel(full)["ops"] * 32 / 1e12 == pytest.approx(2.96, abs=0.01)


@pytest.mark.parametrize("joint", [0, 4, 16])
def test_planted_path_turns_marks_into_heatmaps(joint):
    """Each joint's mark comes out in its own heatmap, not in the others'
    (the reference on a dark 128x64 frame with a 32 px square of the
    mark); the fp8 control moves it."""
    from benchmark.core.weights import joint_mark

    y = tiny_vit_cell().config["yaml"]
    weights = vitpose_weights(y, 7, torch.device("cpu"))
    frame = np.full((1, 64, 128, 3), 20, np.uint8)
    c, level, _ = joint_mark(joint, 17)
    frame[0, 16:48, 48:80, 2 - c] = level  # BGR
    x = torch.as_tensor(frame)
    hm = ViTPoseReference(weights, True, 2)(x)[0]
    centre = hm[7:9, 15:17]  # the square's 2 x 2 tokens' centres
    assert centre[..., joint].min() > 0.5
    assert centre[..., [j for j in range(17) if j != joint]].max() < 0.2
    assert hm[:2, :2].max() < 0.2
    ctrl = ViTPoseReference(weights, True, 2, precision="fp8")(x)[0]
    assert (ctrl - hm).abs().max() > 0.1


def test_control_fails_the_limits():
    """The reference with fp8 operands in the program's place breaks the
    cell's limits at the tiny size (the chip's readings at the cell's
    size are in PERF.md)."""
    from benchmark.core.compare import compare_answer, summarize
    from benchmark.drivers import live_vitpose as live
    from benchmark.tools.readings import as_answer
    from benchmark.traffic.generate import make_traffic

    cell = tiny_vit_cell()
    cell.config["yaml"]["CAPTURE_SPEC"]["MIN_SCORE"] = -10.0
    t = make_traffic(cell.mix, cell.config, 10.0, 1.0, 2**33 + 5, "cpu")
    arrays = live.load_arrays(cell.root_weights)
    weights = vitpose_weights(cell.config["yaml"], 2**33 + 5, torch.device("cpu"))
    entries = range(len(t.pool))
    refs = live.reference_answers(cell, t, arrays, weights, entries, "cpu")
    ctrl = live.reference_answers(cell, t, arrays, weights, entries, "cpu", precision="fp8")
    got = summarize(compare_answer(as_answer(ctrl[e]), refs[e]) for e in entries)
    limits = cell.workload["limits"]
    assert any(got[k] > limits[k] for k in limits), (got, limits)


def test_clean_run_is_correct():
    res, checks = run_tiny(tiny_vit_cell())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) >= {"latency_p50_ms", "latency_p95_ms", "setup_s"}


@pytest.mark.parametrize("case", ["empty run", "traced, nothing matched"])
def test_new_metrics_read_none_with_nothing_to_read(case):
    readers = {m.name: m.reader for m in load_cell(CELL).metrics}
    run = Run(CELL, 1.0, load_cell(CELL).config["yaml"])
    if case != "empty run":
        run.trace = {"total_s": {"gemm": 1.0}, "count": {"gemm": 5}}
        run.traced_entries = [0, 1]
        run.peaks = {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}
    for name in METRICS:
        assert readers[name].read(run) is None, (case, name)


def test_attention_roofline_reads_the_kernels_by_name():
    """Two traced requests, 32 launches each, at half the least time's rate."""
    reader = {m.name: m.reader for m in load_cell(CELL).metrics}["roofline.vit_attention"]
    y = load_cell(CELL).config["yaml"]
    peaks = {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}
    least = counts.least_seconds(counts.attention_kernel(y), peaks)
    run = Run(CELL, 1.0, y)
    run.traced_entries, run.peaks = [0, 1], peaks
    name = "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<96, 128, 64, 4>>"
    run.trace = {"total_s": {name: 2 * 64 * least, "gemm": 1.0}, "count": {name: 64, "gemm": 9}}
    assert reader.read(run) == pytest.approx(50.0)
    assert math.isclose(least, 18.48e9 * 5 / 989e12, rel_tol=1e-3)
