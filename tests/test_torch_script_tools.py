"""PyTorch port, the real-data harness, the snapshot export, the Campus
diagnosis and the realistic bench against the JAX repo's scripts (CPU):

- `tools/run_real_parity.py` against scripts/run_real_parity.py: the same
  skip statuses and PARITY.md rows with data, weights or the backbone
  missing; then both harnesses on a fabricated Shelf fixture
  (tests/test_shelf_campus_loader.write_fixtures) and a Panoptic image
  sequence (tests/test_torch_datasets.write_panoptic_sequence), each
  preprocessing its own copy of the images (--preprocess), from the same
  upstream `.pth.tar` files, written from random weights on the JAX
  package's shapes through `weights.upstream_model` /
  `upstream_backbone`: the same metric within 1e-4 and the same PARITY.md
  rows (eval time aside);
- `tools/export_best_npz.py`: the snapshot it writes loads in the JAX
  package's `load_best_npz` to the same arrays; the JAX forward on it
  equals the forward on the source weights within 1e-5, and the port's
  forward on it agrees with the JAX forward to the golden bound (0.5 mm);
  the record has tests/test_model_zoo.py's schema, and the best epoch
  parsed from a shared set of train logs equals the script's;
- `tools/diagnose_campus.py`: on the same predictions, the script's
  printed per-axis split, PCP table, per-slot and per-limb lines;
- `tools/bench_realistic.py` at the tiny geometry: detected and true
  people of bench.py's realistic functions, finite times.
"""

import contextlib
import io
import json
import os
import pathlib
import re
import shutil
import sys
import types

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_modules import nest, randomize

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = str(REPO / "scripts")
SHELF_FRAMES = [300, 301, 302, 305]
SEQ = "160906_pizza1"


def _script(name):
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    return __import__(name)


def _quiet(fn, *args, **kwargs):
    """fn's result, its printed output discarded."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


# -- run_real_parity ---------------------------------------------------------

def _hook(name, cfg):
    """The JAX harness test's shrink (tests/test_parity_harness.py), every
    slot valid, and the Panoptic image path at 320 x 240 frames with a
    narrow ResNet-18 whose checkpoint the harness finds in weights_dir."""
    cfg.CAPTURE_SPEC.VOXELS_PER_AXIS = (16, 16, 8)
    cfg.CAPTURE_SPEC.MAX_PEOPLE = 4
    cfg.CAPTURE_SPEC.MIN_SCORE = -1e9
    cfg.INDIVIDUAL_SPEC.VOXELS_PER_AXIS = (16, 16, 16)
    cfg.INDIVIDUAL_SPEC.SPACE_SIZE = (2100.0,) * 3
    cfg.CAPTURE_SPEC.__post_init__()
    cfg.INDIVIDUAL_SPEC.__post_init__()
    cfg.TEST.BATCH_SIZE = 1
    cfg.WORKERS = 0
    cfg.NETWORK.COMPUTE_DTYPE = "float32"
    if name == "shelf":
        cfg.DATASET.CAMERA_NUM = 3  # the fixture's rig
    if name == "panoptic":
        cfg.DATASET.CAMERA_NUM = 5
        cfg.DATASET.ORI_IMAGE_SIZE = (320, 240)
        cfg.DATASET.IMAGE_SIZE = (160, 128)
        cfg.DATASET.HEATMAP_SIZE = (40, 32)
        cfg.DATASET.__post_init__()
        cfg.RESNET.NUM_LAYERS = 18
        cfg.RESNET.NUM_DECONV_FILTERS = (32, 32, 32)
        cfg.RESNET.__post_init__()
        # repo-relative and absent: the harness falls back to weights_dir/<basename>
        cfg.NETWORK.PRETRAINED_BACKBONE = "backbone/pose_resnet_fixture.pth.tar"


def _upstream_files(weights_dir):
    """Upstream checkpoints of random weights on the JAX package's shapes
    (the model of each shrunk profile; the backbone of Panoptic's, its
    output layer scaled to heatmaps of order 1), written through the
    port's inverse converters."""
    from faster_voxelpose_tpu.config import load_config as jax_load
    from faster_voxelpose_tpu.models.faster_voxelpose import build_model as jax_build
    from faster_voxelpose_tpu.models.resnet import build_backbone as jax_backbone
    from faster_voxelpose_tpu_torch.config import load_config
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.models.resnet import build_backbone
    from faster_voxelpose_tpu_torch.tools.run_real_parity import CONFIGS, WEIGHT_FILES
    from faster_voxelpose_tpu_torch.weights import (from_jax_variables, upstream_backbone,
                                                    upstream_model)

    weights_dir.mkdir()
    for name in ("panoptic", "shelf"):
        jcfg, pcfg = jax_load(str(REPO / CONFIGS[name])), load_config(str(REPO / CONFIGS[name]))
        for cfg in (jcfg, pcfg):
            _hook(name, cfg)
        V, J = jcfg.DATASET.CAMERA_NUM, jcfg.DATASET.NUM_JOINTS
        W, H = jcfg.DATASET.HEATMAP_SIZE
        shapes = jax.eval_shape(lambda: jax_build(jcfg).init(
            jax.random.PRNGKey(0), np.zeros((1, V, H, W, J), np.float32),
            np.zeros((1, V, 21), np.float32), train=False))
        flat = randomize(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes), seed=5)
        flat["params/hdn/center_net/size_out/kernel"] *= 0.01
        flat["params/hdn/center_net/size_out/bias"] = np.array([0.6, 0.7], np.float32)
        model = build_model(pcfg)
        model.load_state_dict(from_jax_variables(flat, model))
        torch.save({"state_dict": upstream_model(model.state_dict())},
                   weights_dir / WEIGHT_FILES[name])
        if name == "panoptic":
            iw, ih = jcfg.DATASET.IMAGE_SIZE
            bshapes = jax.eval_shape(lambda: jax_backbone(jcfg).init(
                jax.random.PRNGKey(1), np.zeros((1, ih, iw, 3), np.float32)))
            bflat = randomize(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), bshapes), seed=9)
            backbone = build_backbone(pcfg)
            backbone.load_state_dict(from_jax_variables(bflat, backbone))
            with torch.no_grad():
                x = torch.as_tensor(np.random.RandomState(7).randn(2, ih, iw, 3).astype(np.float32))
                scale = float(backbone(x).abs().max())
                backbone.final.weight /= scale
                backbone.final.bias /= scale
            torch.save({"state_dict": upstream_backbone(backbone.state_dict(), 18)},
                       weights_dir / "pose_resnet_fixture.pth.tar")


@pytest.fixture(scope="module")
def parity_tree(tmp_path_factory):
    """Two copies of one data tree (Shelf fixture, Panoptic image sequence
    of 13 frames at 320 x 240: validation frames 0 and 12), one for each
    harness's preprocessing, and the upstream checkpoints."""
    from tests.test_shelf_campus_loader import write_fixtures
    from tests.test_torch_datasets import write_panoptic_sequence

    root = tmp_path_factory.mktemp("parity")
    data = root / "jax" / "data"
    write_fixtures(str(data / "Shelf"), SHELF_FRAMES)
    write_panoptic_sequence(data / "Panoptic", SEQ, n_frames=13, size=(320, 240))
    shutil.copytree(data, root / "port" / "data")
    _upstream_files(root / "weights")
    return root


@pytest.fixture
def fixture_datasets(monkeypatch):
    from faster_voxelpose_tpu.datasets import panoptic as jp
    from faster_voxelpose_tpu.datasets import shelf_campus as jsc
    from faster_voxelpose_tpu_torch.datasets import panoptic as pp
    from faster_voxelpose_tpu_torch.datasets import shelf_campus as psc

    for mod in (jp, pp):
        monkeypatch.setattr(mod, "VAL_SEQUENCES", [SEQ])
    for mod in (jsc, psc):
        monkeypatch.setattr(mod.ShelfDataset, "FRAME_RANGE", SHELF_FRAMES)


def _table_rows(path, mask_time=True):
    rows = [ln for ln in pathlib.Path(path).read_text().splitlines() if ln.startswith("| ")]
    return [re.sub(r"\| [0-9.]+s \|$", "| <s> |", r) if mask_time else r for r in rows]


def _both(tmp_path, **kw):
    """Both harnesses' results and PARITY.md rows on the same arguments."""
    from faster_voxelpose_tpu_torch.tools import run_real_parity as port

    script = _script("run_real_parity")
    out = {}
    for side, run, extra in (("jax", script.run_parity, {}), ("port", port.run_parity,
                                                               {"device": "cpu"})):
        md = tmp_path / f"{side}.md"
        out[side] = (_quiet(run, out_path=str(md), **kw, **extra), _table_rows(md))
    return out


def test_run_real_parity_skips_match_the_script(parity_tree, tmp_path):
    data = str(parity_tree / "jax" / "data")
    torch_mode = _both(tmp_path, data_dir=data, weights_dir=str(tmp_path / "none"),
                       datasets=("panoptic", "shelf", "campus"), weights_mode="torch")
    random_mode = _both(tmp_path, data_dir=data, weights_dir=str(tmp_path / "none"),
                        datasets=("panoptic",), weights_mode="random")
    for got, statuses in ((torch_mode, ["no-weights", "no-weights", "no-data"]),
                          (random_mode, ["no-backbone"])):
        assert [r["status"] for r in got["port"][0]] == statuses
        assert got["port"][0] == got["jax"][0]
        assert got["port"][1] == got["jax"][1]
    assert "| campus | no-data | - | - | PCP3D 96.9 | - |" in torch_mode["port"][1]


def test_run_real_parity_matches_the_script_on_fixtures(parity_tree, fixture_datasets,
                                                        tmp_path):
    """Both harnesses end to end with --preprocess from the same upstream
    checkpoints: the same frames, metric within 1e-4, the same rows."""
    from faster_voxelpose_tpu_torch.tools import run_real_parity as port

    script = _script("run_real_parity")
    got = {}
    for side, run, extra in (("jax", script.run_parity, {}),
                             ("port", port.run_parity, {"device": "cpu"})):
        md = tmp_path / f"{side}.md"
        res = _quiet(run, data_dir=str(parity_tree / side / "data"),
                     weights_dir=str(parity_tree / "weights"), datasets=("panoptic", "shelf"),
                     max_frames=3, weights_mode="torch", preprocess=True, out_path=str(md),
                     cfg_hook=_hook, **extra)
        got[side] = (res, _table_rows(md))
    (jres, jrows), (pres, prows) = got["jax"], got["port"]
    assert [r["status"] for r in pres] == ["ok", "ok"]
    for a, b in zip(pres, jres):
        assert a["frames"] == b["frames"] and a["frames"] >= 2
        assert abs(a["metric"] - b["metric"]) <= 1e-4
    assert prows == jrows
    # the preprocessed frames are at the input size, byte-equal on both sides
    sides = [sorted((parity_tree / s / "data" / "Panoptic").rglob("*.jpg")) for s in ("jax", "port")]
    assert len(sides[0]) == len(sides[1]) > 0
    assert all(a.read_bytes() == b.read_bytes() for a, b in zip(*sides))


# -- export_best_npz ---------------------------------------------------------

TRAIN_LOGS = {
    "tiny_2026-01-01-00-00_train.log": [
        "2026-01-01 00:00:01,000 epoch 0",
        "2026-01-01 00:00:02,000 epoch 0 trained in 1.204 s",
        "2026-01-01 00:00:03,000 => saved best model to output/synthetic/tiny/model_best.npz",
        "2026-01-01 00:00:04,000 epoch 1",
        "2026-01-01 00:00:05,000 epoch 2",
        "2026-01-01 00:00:06,000 => saved best model to output/synthetic/tiny/model_best.npz",
    ],
    "tiny_2026-01-02-00-00_train.log": [
        "2026-01-02 00:00:01,000 epoch 3",
        "2026-01-02 00:00:02,000 saved best model (metric 0.1)",
        "2026-01-02 00:00:03,000 epoch 4",
        "2026-01-02 00:00:04,000 epoch 4 trained in 1.1 s",
    ],
    "tiny_2026-01-03-00-00_validate.log": ["epoch 9", "saved best model"],
}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The tiny experiment (tests/test_torch_engine.py's) with a random
    best model and the shared train logs under its output directory,
    exported by the port into a snapshot directory of its own."""
    from faster_voxelpose_tpu_torch.config import load_config
    from faster_voxelpose_tpu_torch.engine.checkpoint import save_best_npz
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.tools import export_best_npz
    from faster_voxelpose_tpu_torch.weights import from_jax_variables
    from tests.test_torch_cli import _random_weights
    from tests.test_torch_engine import _root_handlers_restored, _tiny_experiment

    root = tmp_path_factory.mktemp("export")
    cfg_path = _tiny_experiment(root)
    # every slot valid, and crop origins off the tiny geometry's rounding ties
    # (tests/test_torch_model.py's tiny_pair)
    text = cfg_path.read_text().replace("  MAX_PEOPLE: 4\n", "  MAX_PEOPLE: 4\n  MIN_SCORE: -1.0e+9\n")
    cfg_path.write_text(text.replace("SPACE_SIZE: [2000.0, 2000.0, 2000.0]",
                                     "SPACE_SIZE: [2100.0, 2100.0, 2100.0]"))
    out = root / "output" / "synthetic" / "tiny"
    out.mkdir(parents=True)
    for name, lines in TRAIN_LOGS.items():
        (out / name).write_text("\n".join(lines) + "\n")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        pcfg = load_config(cfg_path)
        model = build_model(pcfg)
        model.load_state_dict(from_jax_variables(_random_weights(pcfg), model))
        save_best_npz(str(out / "model_best.npz"), model)
        with _root_handlers_restored():
            record = _quiet(export_best_npz.main, ["--cfg", str(cfg_path), "--snapshot-dir",
                                                   str(root / "snap" / "tiny"), "--device", "cpu"])
    finally:
        os.chdir(cwd)
    return root, cfg_path, model, record


def test_export_best_npz_loads_in_the_jax_package(exported):
    from faster_voxelpose_tpu.config import load_config as jax_load
    from faster_voxelpose_tpu.engine.checkpoint import load_best_npz
    from faster_voxelpose_tpu.models.faster_voxelpose import build_model as jax_build
    from faster_voxelpose_tpu_torch.config import load_config
    from faster_voxelpose_tpu_torch.engine.checkpoint import load_best_npz as port_load
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.weights import flatten_variables, to_jax_variables
    from tests.test_torch_geometry import tiny_rig
    from tests.test_torch_model import _frames

    root, cfg_path, model, record = exported
    npz = root / "snap" / "tiny" / "model_best.npz"
    jcfg = jax_load(str(cfg_path))
    jmodel = jax_build(jcfg)
    V, J = jcfg.DATASET.CAMERA_NUM, jcfg.DATASET.NUM_JOINTS
    W, H = jcfg.DATASET.HEATMAP_SIZE
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), np.zeros((1, V, H, W, J), np.float32),
        np.zeros((1, V, 21), np.float32), train=False))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    restored = load_best_npz(str(npz), template)
    source = to_jax_variables(model.state_dict())
    loaded = flatten_variables(restored)
    assert loaded.keys() == source.keys()
    assert all(np.array_equal(np.asarray(loaded[k]), source[k]) for k in source)

    hm = _frames(V, H, W, J, 1, seed=2)
    cams = tiny_rig(V)[None]
    fwd = jax.jit(lambda v, h, c: jmodel.apply(v, h, c, train=False, mutable=False).fused_poses)
    from_npz = np.asarray(fwd(restored, hm, cams))
    from_source = np.asarray(fwd(nest(source), hm, cams))
    assert np.abs(from_npz - from_source).max() <= 1e-5
    port = port_load(str(npz), build_model(load_config(str(cfg_path))))
    with torch.no_grad():
        got = port(torch.as_tensor(hm), torch.as_tensor(cams)).fused_poses.numpy()
    valid = from_npz[..., 0, 3] >= 0
    assert valid.all() and np.array_equal(got[..., 0, 3] >= 0, valid)
    assert np.abs(got[..., :3] - from_npz[..., :3]).max() <= 0.5


def test_export_best_npz_record_and_best_epoch_match_the_script(exported, monkeypatch):
    """The record's schema (tests/test_model_zoo.py), its config path, and
    the best epoch: the script's main, with its model, checkpoint and
    validation calls stubbed, reads the same logs to the same epoch."""
    import faster_voxelpose_tpu.datasets as jd
    import faster_voxelpose_tpu.engine.checkpoint as jck
    import faster_voxelpose_tpu.engine.validator as jv
    import faster_voxelpose_tpu.models.faster_voxelpose as jfvp
    from faster_voxelpose_tpu_torch.tools.export_best_npz import best_epoch
    from tests.test_torch_engine import _root_handlers_restored

    root, cfg_path, _, record = exported
    assert isinstance(record["epoch"], int) and record["epoch"] >= 0
    assert 0.0 <= record["metric"] <= 1.0 and "seed" in record
    snap = root / "snap" / "tiny"
    assert json.loads((snap / "eval_record.json").read_text()) == record
    assert (snap / ".." / ".." / record["config"]).resolve() == pathlib.Path(cfg_path).resolve()
    assert record["eval_set"] == "synthetic/8 samples (held-out synthetic)"

    jsnap = root / "jax_snap"
    jsnap.mkdir()
    monkeypatch.setattr(jfvp, "build_model", lambda cfg: types.SimpleNamespace(
        init=lambda *a, **k: {}))
    monkeypatch.setattr(jck, "load_best_model", lambda d, t: {})
    monkeypatch.setattr(jck, "load_best_npz", lambda p, t: {})
    monkeypatch.setattr(jck, "save_best_npz", lambda p, v: None)
    monkeypatch.setattr(jck, "repo_snapshot_dir", lambda d: str(jsnap))
    monkeypatch.setattr(jd, "get_dataset", lambda name: lambda cfg, is_train: [0] * 8)
    monkeypatch.setattr(jv, "run_validation", lambda *a, **k: (0.5, "msg", None))
    monkeypatch.setattr(sys, "argv", ["export_best_npz.py", "--cfg", str(cfg_path)])
    monkeypatch.chdir(root)
    with _root_handlers_restored():
        _quiet(_script("export_best_npz").main)
    theirs = json.loads((jsnap / "eval_record.json").read_text())
    assert theirs["epoch"] == record["epoch"] == best_epoch(str(root / "output" / "synthetic" /
                                                               "tiny")) == 3
    assert set(theirs) == set(record)


# -- diagnose_campus ---------------------------------------------------------

def _campus_predictions(frames=6, seed=0):
    """Fabricated COCO-17 ground truth (1-3 people a frame, one joint
    unseen now and then) and predictions near it: noise of 0-60 mm, a
    dropped slot, a far-off one, empty slots flagged -1."""
    rng = np.random.RandomState(seed)
    records, preds = [], []
    for f in range(frames):
        n = 1 + f % 3
        gts = rng.uniform([-3000, -3000, 0], [3000, 3000, 1800], (n, 17, 3))
        vis = np.ones((n, 17))
        vis[0, f % 17] = 0.0
        records.append(types.SimpleNamespace(joints_3d=gts, joints_3d_vis=vis))
        p = np.zeros((5, 17, 5))
        p[:, :, 3] = -1.0
        for i, g in enumerate(gts):
            if f == 2 and i == 0:
                continue  # a missed person
            p[i, :, :3] = g + rng.normal(0, 10 + 20 * i, (17, 3))
            p[i, :, 3] = 0.9
        p[4, :, :3] = rng.uniform(-3000, 3000, (17, 3)) + 4000.0  # a far-off false positive
        p[4, :, 3] = 0.3
        preds.append(p)
    return np.stack(preds), records


def test_diagnose_campus_prints_the_script_readings(tmp_path, monkeypatch, capsys):
    import run.validate as jax_validate
    from faster_voxelpose_tpu_torch.tools import diagnose_campus
    from faster_voxelpose_tpu_torch.tools import validate as port_validate
    from tests.test_torch_engine import _root_handlers_restored

    preds, records = _campus_predictions()
    ds = types.SimpleNamespace(records=records)
    script = _script("diagnose_campus")
    (ex, ey, ez), n = diagnose_campus.per_axis_split(preds, [(r.joints_3d, r.joints_3d_vis)
                                                             for r in records])
    want, wn = script.per_axis_split(preds, [(r.joints_3d, r.joints_3d_vis) for r in records])
    assert n == wn == 11 and np.array_equal(np.array([ex, ey, ez]), want)

    ret = (0.5, "the metric table", preds, ds)
    monkeypatch.setattr(jax_validate, "evaluate_model", lambda cfg, out: ret)
    monkeypatch.setattr(port_validate, "evaluate_model", lambda *a, **k: ret)
    monkeypatch.chdir(tmp_path)
    cfg = str(REPO / "configs" / "demo" / "campus_synthetic_ref.yaml")
    monkeypatch.setattr(sys, "argv", ["diagnose_campus.py", "--cfg", cfg])
    with _root_handlers_restored():
        script.main()
        theirs = capsys.readouterr().out.splitlines()
        res = diagnose_campus.main(["--cfg", cfg, "--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()
    assert ours[:len(theirs)] == theirs and len(theirs) == 14
    assert res["matched"] == 11 and 0 < res["pcp"] <= 1


# -- bench_realistic ---------------------------------------------------------

def test_bench_realistic_at_tiny(tmp_path, monkeypatch, capsys):
    """A tiny experiment's 24 test scenes, its best model from the output
    directory: the people of bench.py's realistic functions, finite
    times on the host's clock and none on the device's."""
    from faster_voxelpose_tpu_torch.config import load_config
    from faster_voxelpose_tpu_torch.engine.checkpoint import save_best_npz
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.tools import bench, bench_realistic
    from tests.test_torch_engine import _tiny_experiment

    cfg_path = _tiny_experiment(tmp_path)
    cfg_path.write_text(cfg_path.read_text().replace("NUM_DATA: 8", "NUM_DATA: 24"))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("BENCH_THROUGHPUT_BATCH", "2")
    cfg = load_config(str(cfg_path))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        model = build_model(cfg)
    save_best_npz(str(tmp_path / "output" / "synthetic" / "tiny" / "model_best.npz"), model)
    line = bench_realistic.main([str(cfg_path), "--device", "cpu", "--lengths", "1,2"])
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(json.dumps(line))
    scenes = bench.realistic_scenes(cfg, 24, bench_realistic.config_test_set)
    detected = bench.detected_people(model, torch.as_tensor(scenes["heatmaps"]),
                                     torch.as_tensor(scenes["cameras"]))
    assert line["true_people"] == float(scenes["num_person"].mean())
    assert line["detected_people"] == float(detected.mean())
    assert line["min_score"] == cfg.CAPTURE_SPEC.MIN_SCORE and line["batch"] == 2
    assert np.isfinite(line["ms_per_frame"]) and np.isfinite(line["batched_ms_per_frame"])
    assert line["device_ms_per_frame"] is None and line["batched_device_ms_per_frame"] is None
    with pytest.raises(FileNotFoundError):
        bench_realistic.main([str(tmp_path / "absent.yaml"), "--device", "cpu"])
