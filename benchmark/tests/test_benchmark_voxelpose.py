"""The VoxelPose cell's files: the cell loads by name with its new metrics,
the planted weights fit the port's module key for key, the work count at
Panoptic's sizes and against the reference's own calls at a tiny size,
the reference loads nothing of the port, the planted path finds
separated people at a small size, a program without VoxelPose fails at
once, the slot limits against faults that the mean over every person
lets pass, and the new metrics with nothing to read."""

import copy
import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.core.record import Run
from benchmark.core.spec import ROOT, load_cell
from benchmark.core.voxelpose_weights import v2v_spec, voxelpose_weights
from benchmark.counts import voxelpose as counts
from benchmark.drivers.live_service import port_config
from benchmark.reference.voxelpose import Geometry, VoxelPoseReference
from benchmark.tests.tiny import run_tiny, tiny_cell

CELL = "panoptic_voxelpose.heatmaps.live"
METRICS = ("voxelpose.cpn_served_ms", "voxelpose.prn_served_ms", "mfu.voxelpose_live",
           "roofline.voxelpose_cube")


def test_the_cell_loads_with_its_files_and_metrics():
    cell = load_cell(CELL)
    assert cell.workload["entry"] == "live_voxelpose" and cell.config["reduced"] == []
    assert cell.workload["method"] == "infer_heatmaps" and cell.workload["chips"] == 1
    assert cell.mix == load_cell("panoptic_jln64.heatmaps.live").mix
    assert set(METRICS) <= {m.name for m in cell.metrics}
    cfg = port_config(cell.config)
    assert cfg.MODEL == "voxelpose" and cfg.NETWORK.COMPUTE_DTYPE == "bfloat16"
    assert cfg.CAPTURE_SPEC.VOXELS_PER_AXIS == (80, 80, 20)
    assert cfg.CAPTURE_SPEC.SPACE_SIZE == (8000.0, 8000.0, 2000.0)
    assert cfg.CAPTURE_SPEC.SPACE_CENTER == (0.0, -500.0, 800.0)
    assert cfg.INDIVIDUAL_SPEC.VOXELS_PER_AXIS == (64, 64, 64)
    assert cfg.CAPTURE_SPEC.MAX_PEOPLE == 10 and cfg.NETWORK.BETA == 100
    assert cfg.DATASET.HEATMAP_SIZE == (240, 128) and cfg.DATASET.NUM_JOINTS == 15
    for old in ("panoptic_jln64.heatmaps.live", "shelf_vitpose_h.images.live"):
        assert not set(METRICS) & {m.name for m in load_cell(old).metrics}


def test_planted_weights_fit_the_ports_module():
    """Every key and shape of the port's VoxelPose at Panoptic's sizes
    (built on the meta device) is in the spec; the drawn weights load
    strictly."""
    from faster_voxelpose_tpu_torch.models.voxelpose import VoxelPoseNet

    cell = load_cell(CELL)
    with torch.device("meta"):
        full = VoxelPoseNet(port_config(cell.config)).state_dict()
    spec = {}
    for net, cout in (("cpn", 1), ("prn", 15)):
        for key, shape, kind in v2v_spec(net, 15, cout):
            if kind == "bn":
                spec.update({f"{key}.{n}": shape for n in
                             ("weight", "bias", "running_mean", "running_var")})
            else:
                spec[f"{key}.weight"] = shape
                spec[f"{key}.bias"] = shape[1:2] if kind == "deconv" else shape[:1]
    assert spec == {k: tuple(v.shape) for k, v in full.items()}
    tiny = tiny_cell(CELL)
    module = VoxelPoseNet(port_config(tiny.config))
    module.load_state_dict(voxelpose_weights(tiny.config["yaml"], 5, torch.device("cpu")))


def test_counts_at_panoptic_and_against_the_reference_calls(monkeypatch):
    """1.636 TFLOP a request at Panoptic's sizes (CPN 76.1 GFLOP, PRN 10 x
    156.0); at the tiny size, the MACs of every conv and transposed conv
    the reference calls; the cube kernel's bytes by hand."""
    y = load_cell(CELL).config["yaml"]
    macs = counts.voxelpose_macs(y)
    assert counts.request_flops(y) / 1e12 == pytest.approx(1.636, abs=0.001)
    assert 2 * macs["cpn"] / 1e9 == pytest.approx(76.07, abs=0.01)
    assert 2 * macs["prn"] / 1e9 == pytest.approx(1560.2, abs=0.1)
    assert counts.cube_kernel(y)["bytes"] == 4 * (5 * 128 * 240 * 15 + 105 + 30
                                                  + 10 * 64 ** 3 * 15)
    cell = tiny_cell(CELL)
    ty = cell.config["yaml"]
    seen = {"macs": 0}

    def wrap(fn, transposed):
        def call(x, w, *a, **k):
            out = fn(x, w, *a, **k)
            taps = int(np.prod(w.shape[2:]))
            seen["macs"] += (x.numel() * w.shape[1] * taps if transposed
                             else out.numel() * w.shape[1] * taps)
            return out
        return call

    monkeypatch.setattr(F, "conv3d", wrap(F.conv3d, False))
    monkeypatch.setattr(F, "conv_transpose3d", wrap(F.conv_transpose3d, True))
    ref = VoxelPoseReference(Geometry.from_config(ty), voxelpose_weights(ty, 1, "cpu"), "cpu")
    V, (W, H) = ty["DATASET"]["CAMERA_NUM"], ty["DATASET"]["HEATMAP_SIZE"]
    from benchmark.traffic.generate import config_rig

    ref(torch.zeros((V, H, W, 15)), torch.as_tensor(config_rig(cell.config), dtype=torch.float32))
    assert seen["macs"] == sum(counts.voxelpose_macs(ty).values())


def test_reference_imports_nothing_of_the_port():
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import benchmark.reference.voxelpose\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "faster_voxelpose_tpu",
                         "faster_voxelpose_tpu_torch"}


def small_yaml():
    """Panoptic's configuration at a small size: 5 views of 120x64
    heatmaps, a 4 x 4 x 1.6 m space of 20 x 20 x 8 voxels, 24^3 cubes of
    2 m, K = 4."""
    y = copy.deepcopy(load_cell(CELL).config["yaml"])
    y["DATASET"].update(ORI_IMAGE_SIZE=[960, 540], IMAGE_SIZE=[480, 256], HEATMAP_SIZE=[120, 64])
    y["CAPTURE_SPEC"].update(SPACE_SIZE=[4000.0, 4000.0, 1600.0], SPACE_CENTER=[0.0, 0.0, 800.0],
                             VOXELS_PER_AXIS=[20, 20, 8], MAX_PEOPLE=4)
    y["INDIVIDUAL_SPEC"]["VOXELS_PER_AXIS"] = [24, 24, 24]
    return y


@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_planted_weights_find_separated_people(seed):
    """Two people 2.8 m apart, seen by 5 cameras around the space (the
    planted path cannot tell one person's joint from another's in a
    PRN cube, nor a ray that one view alone sees from a joint): each has a
    valid proposal within 1.5 voxels of its root, and that slot's pose
    lands within 2 of the cube's voxels (87 mm) of its joints, MPJPE."""
    from benchmark.reference.fusion import resize_affine
    from benchmark.traffic.heatmaps import render_scene
    from benchmark.traffic.poses import make_pose_bank
    from benchmark.traffic.rig import make_rig

    y = small_yaml()
    d = y["DATASET"]
    rig = make_rig(5, 7000.0, 2200.0, [0.0, 0.0], d["ORI_IMAGE_SIZE"]).astype(np.float32)
    rng = np.random.default_rng(seed % 2**32)
    bank = make_pose_bank(50, "panoptic15")
    people = []
    for root_xy in ([-1000.0, -1000.0], [1000.0, 1000.0]):
        pose = bank[rng.integers(50)].copy()
        pose[:, :2] += np.asarray(root_xy) - pose[2, :2]
        people.append(pose)
    people = np.asarray(people)
    hm = render_scene(people, rig, resize_affine(d["ORI_IMAGE_SIZE"], d["IMAGE_SIZE"]),
                      d["ORI_IMAGE_SIZE"], d["IMAGE_SIZE"], d["HEATMAP_SIZE"], 3.0, 2.0, rng)
    ref = VoxelPoseReference(Geometry.from_config(y), voxelpose_weights(y, seed, "cpu"), "cpu")
    r = ref(torch.as_tensor(hm), torch.as_tensor(rig))
    step = 4000.0 / 19
    for person in torch.as_tensor(people, dtype=torch.float32):
        d_root = (r["centres"] - person[2]).norm(dim=-1)
        k = int(d_root.argmin())
        assert r["valid"][k] and d_root[k] < 1.5 * step
        assert (r["poses"][k] - person).norm(dim=-1).mean() < 2 * 2000.0 / 23


def test_a_program_without_voxelpose_fails_at_once(monkeypatch):
    """The parent of this cell has no `models/voxelpose.py`: the entry
    raises on its import before it makes any traffic."""
    import benchmark.drivers.live_voxelpose as live

    monkeypatch.setitem(sys.modules, "faster_voxelpose_tpu_torch.models.voxelpose", None)
    ctx = type("Ctx", (), {"cell": tiny_cell(CELL), "device": torch.device("cpu")})()
    with pytest.raises(ImportError):
        live.run(ctx)


def test_clean_run_is_correct():
    res, checks = run_tiny(tiny_cell(CELL))
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) >= {"latency_p50_ms", "latency_p95_ms", "setup_s"}


@pytest.mark.parametrize("fault", [None, "slot_lost", "slot_shifted", "all_shifted"])
def test_slot_limits_catch_what_the_mean_lets_pass(fault):
    """60 frames of ten reference people, answered with 18 mm of noise a
    joint and axis (about the served bf16's mean error): the cell's limits
    hold.  The person of slot 9 answered 400 mm off, or slot 9's or every
    person moved one cube voxel (2000 / 63 mm) along x, breaks a slot
    limit; the mean over every person lets the one-slot faults pass."""
    from benchmark.core.record import Request
    from benchmark.drivers import live_voxelpose as live

    workload = load_cell(CELL).workload
    rng = np.random.default_rng(5)
    K, J, frames = 10, 15, 60
    refs, answers = {}, []
    for e in range(frames):
        roots = np.stack([np.arange(K) * 1500.0 - 7000.0, rng.uniform(-3000, 3000, K),
                          rng.uniform(800, 1000, K)], -1)
        poses = roots[:, None] + rng.normal(0, 300, (K, J, 3))
        conf = np.linspace(0.99, 0.5, K)
        refs[e] = {"poses": poses, "valid": np.ones(K, bool), "confidence": conf}
        served = poses + rng.normal(0, 18, poses.shape)
        if fault == "slot_lost":
            served[9, :, 0] += 400.0
        elif fault == "slot_shifted":
            served[9, :, 0] += 2000.0 / 63
        elif fault == "all_shifted":
            served[..., 0] += 2000.0 / 63
        answers.append({"poses_mm": served.tolist(), "scores": conf.tolist()})
    reqs = [Request(0, 0, 0, e, True) for e in range(frames)]
    checks = live.checks_of(live.judge(answers, reqs, refs), workload)
    assert set(checks) == set(workload["limits"]) | set(live.SLOT_NUMBERS)
    broken = {k for k, (value, limit) in checks.items() if value > limit}
    if fault is None:
        assert not broken, checks
    else:
        assert broken & set(live.SLOT_NUMBERS), (fault, checks)
    if fault in ("slot_lost", "slot_shifted"):
        assert "pose_mean_mm" not in broken, checks


@pytest.mark.parametrize("case", ["empty run", "traced, nothing matched"])
def test_new_metrics_read_none_with_nothing_to_read(case):
    readers = {m.name: m.reader for m in load_cell(CELL).metrics}
    run = Run(CELL, 1.0, load_cell(CELL).config["yaml"])
    if case != "empty run":
        run.trace = {"total_s": {"gemm": 1.0, "void (anonymous namespace)::crop_kernel<false, "
                                 "false, false>(float const*)": 1.0},
                     "count": {"gemm": 5, "void (anonymous namespace)::crop_kernel<false, "
                               "false, false>(float const*)": 2}}
        run.traced_entries = [0, 1]
        run.peaks = {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}
    for name in METRICS:
        assert readers[name].read(run) is None, (case, name)


def test_cube_roofline_reads_the_kernel_by_name():
    """Two traced requests, one bounded cube launch each, at a quarter of
    the least time's rate; Faster VoxelPose's crop launches are not it."""
    reader = {m.name: m.reader for m in load_cell(CELL).metrics}["roofline.voxelpose_cube"]
    y = load_cell(CELL).config["yaml"]
    peaks = {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}
    least = counts.least_seconds(counts.cube_kernel(y), peaks)
    run = Run(CELL, 1.0, y)
    run.traced_entries, run.peaks = [0, 1], peaks
    name = ("void (anonymous namespace)::crop_kernel<false, true, true>(float const*, float "
            "const*, int const*, float const*, unsigned char const*)")
    other = "void (anonymous namespace)::crop_kernel<false, false, false>(float const*)"
    run.trace = {"total_s": {name: 2 * 4 * least, other: 1.0}, "count": {name: 2, other: 2}}
    assert reader.read(run) == pytest.approx(25.0)
    assert math.isclose(least, 4 * (5 * 128 * 240 * 15 + 135 + 10 * 64 ** 3 * 15) / 3.35e12)


def test_configuration_states_its_departures():
    c = json.loads((ROOT / "benchmark/configs/panoptic_voxelpose.json").read_text())
    assert c["reduced"] == [] and c["weights"] == "seeded"
    for key in ("CAPTURE_SPEC.MIN_SCORE", "all_slots", "NETWORK.COMPUTE_DTYPE", "weights", "rig",
                "pose_bank"):
        assert key in c["assumed"]
