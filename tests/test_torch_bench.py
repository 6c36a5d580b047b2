"""PyTorch port, the end-to-end benchmark: tools/bench.py (the counterpart
of bench.py), tools/timing.scan_slope, tools/profile_stages.py and
tools/bench_width.py on the CPU, at the tiny geometry of
__graft_entry__._tiny_config.

Each of bench.py's steps (frame_fn, batched_frame_fn, the realistic
fusion_step and e2e_step) against the JAX package's composition of the
same calls (`backbone.apply`, then `model.apply`) on the same weights and
inputs, at MIN_SCORE -1 and the default: the same valid slots, proposal
scores to 1e-3 and fused poses within 0.5 mm (the JAX package's golden
bound).  The scan against separate frames, and each tool's line, exactly.
"""

import ast
import dataclasses
import json
import math
import pathlib
import pickle

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_geometry import jax_schema, tiny_configs, tiny_rig
from tests.test_torch_model import _frames
from tests.test_torch_modules import nest, randomize

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY = dict(INDIVIDUAL_SPEC__SPACE_SIZE=(2100.0,) * 3, RESNET__NUM_LAYERS=18,
            RESNET__NUM_DECONV_FILTERS=(32, 32, 32))
DEFAULT_MIN_SCORE = 0.1
# the tiny geometry as a config file for the tools' command lines: the
# Panoptic demo rig's DATADIR (its held-out scenes), 3 views, K = 4
TINY_YAML = """\
DATASET:
  DATADIR: "data/DemoPanoptic"
  TRAIN_DATASET: 'synthetic'
  TEST_DATASET: 'synthetic'
  CAMERA_NUM: 3
  ORI_IMAGE_SIZE: [320, 240]
  IMAGE_SIZE: [160, 128]
  HEATMAP_SIZE: [40, 32]
  NUM_JOINTS: 15
  ROOT_JOINT_ID: 2
SYNTHETIC:
  MAX_PEOPLE: 3
NETWORK:
  COMPUTE_DTYPE: float32
RESNET:
  NUM_LAYERS: 18
  NUM_DECONV_FILTERS: [32, 32, 32]
CAPTURE_SPEC:
  SPACE_SIZE: [4000.0, 4000.0, 1600.0]
  SPACE_CENTER: [0.0, 0.0, 800.0]
  VOXELS_PER_AXIS: [16, 16, 8]
  MAX_PEOPLE: 4
INDIVIDUAL_SPEC:
  SPACE_SIZE: [2100.0, 2100.0, 2100.0]
  VOXELS_PER_AXIS: [16, 16, 16]
"""
NARROW = """\
  WIDTH_MULT: 0.5
  NUM_CHANNEL_JOINT_FEAT: 16
  NUM_CHANNEL_JOINT_HIDDEN: 32
"""


@pytest.fixture(scope="module")
def weights():
    """Random flax weights of the tiny model (bbox sizes near (0.6, 0.7), so
    that the crops keep voxels; proposal confidences around the default
    MIN_SCORE) and of a ResNet-18 backbone whose heatmaps are of order 1,
    on the shapes of the JAX package's init."""
    from faster_voxelpose_tpu.models.faster_voxelpose import build_model as jax_build
    from faster_voxelpose_tpu.models.resnet import build_backbone as jax_backbone

    jcfg, _ = tiny_configs(**TINY)
    V, J = jcfg.DATASET.CAMERA_NUM, jcfg.DATASET.NUM_JOINTS
    W, H = jcfg.DATASET.HEATMAP_SIZE
    iw, ih = jcfg.DATASET.IMAGE_SIZE
    shapes = jax.eval_shape(lambda: jax_build(jcfg).init(
        jax.random.PRNGKey(0), np.zeros((1, V, H, W, J), np.float32), tiny_rig(V)[None],
        train=False))
    flat = randomize(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes), seed=5)
    flat["params/hdn/center_net/size_out/kernel"] *= 0.01
    flat["params/hdn/center_net/size_out/bias"] = np.array([0.6, 0.7], np.float32)
    # proposal confidences of about 0.1 (30-50 unscaled): the default
    # MIN_SCORE keeps some slots and drops others
    for leaf in ("kernel", "bias"):
        flat[f"params/hdn/center_net/hm_out/{leaf}"] /= np.float32(350.0)
    backbone = jax_backbone(jcfg)
    bshapes = jax.eval_shape(lambda: backbone.init(jax.random.PRNGKey(1),
                                                   np.zeros((1, ih, iw, 3), np.float32)))
    bflat = randomize(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), bshapes), seed=9)
    x = np.random.RandomState(7).randn(V, ih, iw, 3).astype(np.float32)
    raw = np.asarray(jax.jit(backbone.apply)(nest(bflat), x))
    for leaf in ("kernel", "bias"):
        bflat[f"params/final/{leaf}"] /= np.float32(np.abs(raw).max())
    return flat, bflat


@pytest.fixture(scope="module")
def reference(weights):
    """Per MIN_SCORE: the port's config and the JAX package's model.apply
    and backbone.apply, jitted once each."""
    from faster_voxelpose_tpu.models.faster_voxelpose import build_model as jax_build
    from faster_voxelpose_tpu.models.resnet import build_backbone as jax_backbone

    flat, bflat = weights
    out = {}
    for min_score in (-1.0, DEFAULT_MIN_SCORE):
        jcfg, pcfg = tiny_configs(CAPTURE_SPEC__MIN_SCORE=min_score, **TINY)
        model, backbone = jax_build(jcfg), jax_backbone(jcfg)
        fwd = jax.jit(lambda h, c, m=model: m.apply(nest(flat), h, c, train=False,
                                                     mutable=False).fused_poses)
        bb = jax.jit(lambda x, b=backbone: b.apply(nest(bflat), x, train=False, mutable=False))
        out[min_score] = (pcfg, lambda h, c, f=fwd: np.asarray(f(h, c)),
                          lambda x, f=bb: np.asarray(f(x)))
    return out


def _port(pcfg, flat, bflat):
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.models.resnet import build_backbone
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    model, backbone = build_model(pcfg), build_backbone(pcfg)
    model.load_state_dict(from_jax_variables(flat, model))
    backbone.load_state_dict(from_jax_variables(bflat, backbone))
    return model, backbone


def _inputs(pcfg, B):
    """B frames of images, heatmaps with blobs, and the tiny rig per frame."""
    V, J = pcfg.DATASET.CAMERA_NUM, pcfg.DATASET.NUM_JOINTS
    W, H = pcfg.DATASET.HEATMAP_SIZE
    iw, ih = pcfg.DATASET.IMAGE_SIZE
    images = np.random.RandomState(0).randn(B, V, ih, iw, 3).astype(np.float32)
    return images, _frames(V, H, W, J, B, seed=3), np.stack([tiny_rig(V)] * B)


def _same_poses(got, want):
    got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 3], want[..., 3])  # the same valid slots
    np.testing.assert_allclose(got[..., 4], want[..., 4], atol=1e-3)
    assert np.max(np.abs(got[..., :3] - want[..., :3])) <= 0.5


@pytest.mark.parametrize("min_score", [-1.0, DEFAULT_MIN_SCORE])
@pytest.mark.parametrize("kind", ["frame", "batched", "fusion", "e2e"])
def test_step_matches_jax_composition(kind, min_score, weights, reference):
    """bench.py's scan bodies, one step from a carry: the port's step
    against the JAX package's calls in bench.py's order on the same
    weights, inputs and carry (`:79-113`, `:278-327`)."""
    from faster_voxelpose_tpu_torch.tools import bench

    pcfg, jfwd, jbb = reference[min_score]
    model, backbone = _port(pcfg, *weights)
    images, hm, cams = _inputs(pcfg, 2)
    V = pcfg.DATASET.CAMERA_NUM
    c = np.float32(0.25)  # a carry that reaches the images
    carry = torch.tensor(c)
    t = torch.as_tensor
    with torch.no_grad():
        if kind == "frame":
            new, got = bench.frame_step(model, backbone, t(cams[:1]))(carry, (t(images[0]),))
            want = jfwd(jbb(images[0] + c)[None], cams[:1])[0]
            assert abs(float(new) - float(want[0, 0, 0]) * 1e-30) <= 0.5e-30
        elif kind == "batched":
            new, got = bench.batched_frame_step(model, backbone, t(cams[:1]))(carry, (t(images),))
            flat = jbb(images.reshape(2 * V, *images.shape[2:]) + c)
            want = jfwd(flat.reshape(2, V, *flat.shape[1:]), cams)
            assert abs(float(new) - float(want[0, 0, 0, 0]) * 1e-30) <= 0.5e-30
        elif kind == "fusion":
            got = bench.fusion_step(model)(carry, (t(hm[0]), t(cams[0])))
            want = jfwd(hm[:1] + c * np.float32(1e-30), cams[:1])
        else:
            got = bench.e2e_step(model, backbone)(carry, (t(hm[0]), t(cams[0]), t(images[0])))
            bb = jbb(images[0] + c)
            want = jfwd(hm[:1] + bb[None] * np.float32(1e-30), cams[:1])
            fusion = bench.fusion_step(model)(carry, (t(hm[0]), t(cams[0])))
            assert torch.equal(got[..., 3], fusion[..., 3])  # the fold leaves the detections
        ss, out = bench.summed(lambda *_: got)(carry, None)
        assert ss is out
        assert math.isclose(float(ss), float(got[..., :1].sum()) * 1e-30, rel_tol=1e-6)
    _same_poses(got, want)
    valid = (want[..., 0, 3] >= 0).sum()
    if min_score < 0:
        assert valid == want[..., 0, 3].size  # every slot valid
    elif kind in ("fusion", "e2e"):
        assert 0 < valid < want[..., 0, 3].size  # a mix: the default is a real threshold


def test_scan_equals_separate_frames(weights, reference):
    """scan_time's outputs for F frames equal F separate steps, each from the
    carry of the one before; scan_slope reads both lengths, with no device
    time on the CPU."""
    from faster_voxelpose_tpu_torch.tools import bench
    from faster_voxelpose_tpu_torch.tools.timing import scan_slope, scan_time

    pcfg = reference[-1.0][0]
    model, backbone = _port(pcfg, *weights)
    images, _, cams = _inputs(pcfg, 3)
    step = bench.frame_step(model, backbone, torch.as_tensor(cams[:1]))
    x = torch.as_tensor(images)
    reading = scan_time(step, (x,), 3, torch.device("cpu"), reps=1)
    carry, want = torch.zeros(()), []
    with torch.no_grad():
        for i in range(3):
            carry, out = step(carry, (x[i],))
            want.append(out)
    assert reading.outputs.shape == (3, 4, 15, 5) and reading.device_ms is None
    assert torch.equal(reading.outputs, torch.stack(want)) and reading.launches == {}
    s = scan_slope(step, 1, 2, torch.device("cpu"), lambda F: (x[:F],), reps=1)
    assert s.short.outputs.shape[0] == 1 and s.long.outputs.shape[0] == 2
    assert s.device_ms is None and math.isfinite(s.host_ms)
    assert torch.equal(s.long.outputs, reading.outputs[:2])
    with pytest.raises(ValueError, match="0 < n1 < n2"):
        scan_slope(step, 2, 2, torch.device("cpu"))


def test_worst_case_config_equals_jax():
    """The worst case's config: the port's load_config of
    configs/panoptic/jln64.yaml with MIN_SCORE -1, key for key the JAX
    package's."""
    from faster_voxelpose_tpu.config import load_config as jax_load
    from faster_voxelpose_tpu_torch.tools.bench import WORST_CASE_CFG, worst_case_config

    want = jax_load(REPO / "configs/panoptic/jln64.yaml")
    want.CAPTURE_SPEC.MIN_SCORE = -1.0
    got = worst_case_config()
    assert WORST_CASE_CFG == REPO / "configs/panoptic/jln64.yaml"
    assert jax_schema(got) == dataclasses.asdict(want)
    assert got.CAPTURE_SPEC.MAX_PEOPLE == 10 and got.NETWORK.COMPUTE_DTYPE == "bfloat16"


def test_realistic_scenes_are_the_jax_bench_scenes(tmp_path):
    """The realistic frames are the ones bench.py reads: the JAX package's
    synthetic test dataset of configs/demo/panoptic_synthetic.yaml
    (DEVICE_RENDER false, NUM_DATA 64) on the files that bench.py's
    make_demo_data.py line writes; the port makes them from seeds."""
    from faster_voxelpose_tpu.config import load_config as jax_load
    from faster_voxelpose_tpu.datasets import get_dataset
    from faster_voxelpose_tpu_torch.config import load_config
    from faster_voxelpose_tpu_torch.tools.bench import REALISTIC_CFG, realistic_scenes
    from scripts import make_demo_data as script

    (tmp_path / "calibration_demo.json").write_text(
        json.dumps(script.make_rig(5, 2800.0, 2200.0, (0.0, -500.0), (1920, 1080))))
    with open(tmp_path / "demo_pose_bank.pkl", "wb") as f:
        pickle.dump(script.make_pose_bank(2000, skeleton="panoptic15"), f)
    jcfg = jax_load(REPO / "configs/demo/panoptic_synthetic.yaml")
    jcfg.DATASET.DEVICE_RENDER = False
    jcfg.SYNTHETIC.NUM_DATA = 64
    jcfg.DATASET.DATADIR = str(tmp_path)
    ds = get_dataset(jcfg.DATASET.TEST_DATASET)(jcfg, is_train=False)
    got = realistic_scenes(load_config(REALISTIC_CFG), frames=3)
    for i in range(3):
        want = ds[i]
        np.testing.assert_allclose(got["heatmaps"][i], want["input_heatmaps"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got["cameras"][i], want["cameras"])
        assert got["num_person"][i] == int(want["num_person"])
    assert got["heatmaps"].shape == (3, 5, 128, 240, 15)


def _bench_py_keys(path, functions):
    """The string keys of the dict literals and subscript stores in
    `functions` of a script, read from its source."""
    tree = ast.parse((REPO / path).read_text())
    keys = []
    for fn in (n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in functions):
        for node in ast.walk(fn):
            if isinstance(node, ast.Dict):
                keys += [k.value for k in node.keys if isinstance(k, ast.Constant)]
            elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store) \
                    and isinstance(node.slice, ast.Constant):
                keys.append(node.slice.value)
    return keys


def _write_tiny(root, weights):
    """The tiny YAML, its half-width variant and a snapshot of the tiny
    model's weights under `root`."""
    from faster_voxelpose_tpu_torch.config import load_config
    from faster_voxelpose_tpu_torch.engine.checkpoint import save_best_npz

    (root / "tiny.yaml").write_text(TINY_YAML)
    (root / "tiny_w05.yaml").write_text(TINY_YAML.replace(
        "  COMPUTE_DTYPE: float32\n", "  COMPUTE_DTYPE: float32\n" + NARROW))
    model, _ = _port(load_config(root / "tiny.yaml"), *weights)
    save_best_npz(str(root / "snap" / "model_best.npz"), model)
    return root / "tiny.yaml", root / "tiny_w05.yaml", root / "snap" / "model_best.npz"


def _last_json(out):
    lines = out.strip().splitlines()
    assert sum(line.startswith("{") for line in lines) == 1  # one JSON line, the last
    return json.loads(lines[-1])


def test_bench_main_prints_bench_py_line(tmp_path, weights, monkeypatch, capsys):
    """main(["--device", "cpu", ...]) at the tiny profile with short
    lengths prints one JSON line holding every key bench.py prints
    (read from its source; realistic_error excepted: a failure raises),
    its headline keys first in bench.py's order, a device time per mode
    (none on the CPU), finite positive rates, every worst-case slot valid,
    and detected and true people averaged over the same 24 frames."""
    from faster_voxelpose_tpu_torch.config import load_config
    from faster_voxelpose_tpu_torch.engine.checkpoint import load_best_npz
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.tools import bench

    cfg_path, _, snap = _write_tiny(tmp_path, weights)
    monkeypatch.setenv("BENCH_THROUGHPUT_BATCH", "2")
    assert bench.main(["--device", "cpu", "--cfg", str(cfg_path), "--realistic-cfg",
                       str(cfg_path), "--checkpoint", str(snap), "--lengths", "1,3"]) == 0
    line = _last_json(capsys.readouterr().out)
    keys = _bench_py_keys("bench.py", ("main", "realistic_bench"))
    assert "metric" in keys and "realistic_detected_people" in keys
    assert set(keys) - {"realistic_error"} <= set(line)
    assert tuple(line)[:6] == bench.HEADLINE_KEYS
    assert line["metric"] == "panoptic_5view_e2e_fps_per_chip" and line["throughput_batch"] == 2
    assert all(line[k] is None for k in bench.DEVICE_KEYS)
    bench.check_line(line)
    assert line["worst_case_valid_slots"] == [4, 4]
    cfg = load_config(cfg_path)
    scenes = bench.realistic_scenes(cfg)
    model = load_best_npz(str(snap), build_model(cfg))
    detected = bench.detected_people(model, torch.as_tensor(scenes["heatmaps"]),
                                     torch.as_tensor(scenes["cameras"]))
    assert len(detected) == len(scenes["num_person"]) == bench.REALISTIC_FRAMES
    assert line["realistic_detected_people"] == round(float(detected.mean()), 2)
    assert line["realistic_true_people"] == round(float(scenes["num_person"].mean()), 2)
    assert detected[:8].mean() != detected.mean()  # bench.py's 8 frames would read otherwise
    assert line["realistic_min_score"] == DEFAULT_MIN_SCORE
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        bench.main(["--device", "cpu", "--cfg", str(cfg_path), "--realistic-cfg",
                    str(cfg_path), "--checkpoint", str(tmp_path / "none.npz"), "--lengths", "1,2"])


def test_profile_stages_at_tiny(tmp_path, weights, capsys):
    """Every ported stage runs and prints its host ms (no device ms on the
    CPU); the full-model stage is the model's forward, and its scan's
    outputs are the script's chained sums."""
    from faster_voxelpose_tpu_torch.config import load_config
    from faster_voxelpose_tpu_torch.geometry import dome_rig
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.tools import profile_stages as ps
    from faster_voxelpose_tpu_torch.tools.bench import seeded
    from faster_voxelpose_tpu_torch.tools.timing import scan_time

    cfg_path = _write_tiny(tmp_path, weights)[0]
    assert ps.main(["--device", "cpu", "--cfg", str(cfg_path), "--lengths", "1,2"]) == 0
    line = _last_json(capsys.readouterr().out)
    assert set(line) == {"backbone", "whole_projection", "hdn", "jln_planes", "full_model",
                         "center_net", "c2c_net", "nms2d_topk", "p2p_net", "weight_net",
                         "soft_argmax"}
    assert all(math.isfinite(v["host_ms"]) and v["device_ms"] is None for v in line.values())
    cpu = torch.device("cpu")
    (name, (fn, x)), = ps.stages(cfg_path, cpu, ["6"]).items()
    cfg = load_config(cfg_path)
    cfg.CAPTURE_SPEC.MIN_SCORE, cfg.NETWORK.COMPUTE_DTYPE = -1.0, "float32"
    model = seeded(build_model, cfg, 0, cpu)
    cams = torch.as_tensor(dome_rig(1, cfg.DATASET.CAMERA_NUM))
    with torch.no_grad():
        want = model(x, cams).fused_poses[..., 0]
        assert name == "full_model" and torch.equal(fn(x), want)
        sums, carry = [], torch.zeros(())
        for _ in range(3):
            carry = model(x + carry * 1e-30, cams).fused_poses[..., 0].sum() * 1e-30
            sums.append(carry)
    got = scan_time(ps.stage_step(fn, x), (), 3, cpu, reps=1).outputs
    assert torch.equal(got, torch.stack(sums))
    with pytest.raises(SystemExit, match="unknown stage tags"):
        ps.main(["1", "--device", "cpu", "--cfg", str(cfg_path)])


def test_bench_width_at_tiny(tmp_path, weights, capsys):
    """Both widths' fusion forwards timed: the script's keys (read from its
    source), random weights where no snapshot of the stem exists, and the
    parameter count of the JAX package's variables of each config."""
    from faster_voxelpose_tpu.config import load_config as jax_load
    from faster_voxelpose_tpu.models.faster_voxelpose import build_model as jax_build
    from faster_voxelpose_tpu_torch.tools import bench_width

    base, narrow, _ = _write_tiny(tmp_path, weights)
    assert bench_width.main(["--device", "cpu", "--cfg", str(base), "--cfg-narrow", str(narrow),
                             "--lengths", "1,3"]) == 0
    line = _last_json(capsys.readouterr().out)
    keys = _bench_py_keys("scripts/bench_width.py", ("time_fusion", "main"))
    assert "fusion_ms_per_frame" in keys and set(keys) <= set(line) | set(line["base"])
    for side, path in (("base", base), ("narrow", narrow)):
        jcfg = jax_load(path)
        V, J = jcfg.DATASET.CAMERA_NUM, jcfg.DATASET.NUM_JOINTS
        W, H = jcfg.DATASET.HEATMAP_SIZE
        shapes = jax.eval_shape(lambda: jax_build(jcfg).init(
            jax.random.PRNGKey(0), np.zeros((1, V, H, W, J), np.float32),
            tiny_rig(V)[None], train=False))
        n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
        assert line[side]["params"] == n
        assert line[side]["weights"] == "random init (timing only)"
        assert line[side]["fusion_device_ms_per_frame"] is None
    assert line["base"]["width_mult"] == 1.0 and line["narrow"]["width_mult"] == 0.5
    assert line["narrow_speedup"] > 0 and "narrow_device_speedup" not in line
