"""PyTorch port, the remaining CLIs against the JAX package's on the same
fixtures and weights (CPU):

- `tools/validate.py`: `evaluate_model` against run/validate.py's on a
  Panoptic sequence written here ('gt' source, weights from
  `model_best.npz` under the output directory), and the `--cfg
  --torch-weights` CLI with TEST.VISUALIZATION against run/validate.py's
  main on an upstream-named state dict written here: the same metric
  message, and the same visualisation files; the parser keeps `--cfg`
  and `--checkpoint` apart;
- `tools/train.py` with TRAIN.VISUALIZATION: the artifacts, and the
  trainer's state after the epoch bit for bit that of a run without;
- `tools/demo.py` against run/demo.py with upstream model and backbone
  state dicts written here: fused poses within 0.5 mm (the golden
  bound), the same valid slots, the `demo` artifact;
- `tools/preprocess.py` against run/preprocess.py on two copies of one
  fixture tree: byte-equal images, and a second run resizes nothing.
"""

import importlib.util
import json
import os
import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_engine import TINY_YAML, _root_handlers_restored, _tiny_experiment

REPO = pathlib.Path(__file__).resolve().parent.parent
SEQ = "160906_pizza1"

CLI_YAML = """\
OUTPUT_DIR: '{out}'
LOG_DIR: '{out}/log'
WORKERS: 0
DATASET:
  DATADIR: "{datadir}"
  TRAIN_DATASET: 'panoptic'
  TEST_DATASET: 'panoptic'
  TRAIN_HEATMAP_SRC: 'gt'
  TEST_HEATMAP_SRC: 'gt'
  CAMERA_NUM: 3
  ORI_IMAGE_SIZE: [{ori_w}, {ori_h}]
  IMAGE_SIZE: [160, 128]
  HEATMAP_SIZE: [40, 32]
  NUM_JOINTS: 15
  ROOT_JOINT_ID: 2
NETWORK:
  PRETRAINED_BACKBONE: ""
  COMPUTE_DTYPE: 'float32'
RESNET:
  NUM_LAYERS: 18
  NUM_DECONV_FILTERS: [32, 32, 32]
TEST:
  BATCH_SIZE: 2
  VISUALIZATION: {vis}
CAPTURE_SPEC:
  SPACE_SIZE: [4000.0, 4000.0, 1600.0]
  SPACE_CENTER: [0.0, 0.0, 800.0]
  VOXELS_PER_AXIS: [16, 16, 8]
  MAX_PEOPLE: 4
  MIN_SCORE: -1.0e+9
INDIVIDUAL_SPEC:
  SPACE_SIZE: [2100.0, 2100.0, 2100.0]
  VOXELS_PER_AXIS: [16, 16, 16]
"""


def _write_yaml(path, out, datadir, vis=False, ori=(1920, 1080)):
    path = pathlib.Path(path)
    path.write_text(CLI_YAML.format(out=out, datadir=datadir, vis=str(vis).lower(),
                                    ori_w=ori[0], ori_h=ori[1]))
    return str(path)


def _run_module(name):
    """run/<name>.py, imported under a name of its own."""
    spec = importlib.util.spec_from_file_location(f"run_{name}", REPO / "run" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_sequence(monkeypatch):
    from faster_voxelpose_tpu.datasets import panoptic as jp
    from faster_voxelpose_tpu_torch.datasets import panoptic as pp

    for mod in (jp, pp):
        monkeypatch.setattr(mod, "TRAIN_SEQUENCES", [SEQ])
        monkeypatch.setattr(mod, "VAL_SEQUENCES", [SEQ])


def _random_weights(cfg):
    """Fan-in scaled weights for the port's model of `cfg` (every proposal
    slot valid, the size head tamed, as tests/test_torch_datasets.py's),
    flat in the flax layout, made from the port's module tree: a flax
    init takes half a minute here."""
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.weights import to_jax_variables
    from tests.test_torch_modules import nest, randomize

    torch.manual_seed(0)
    flat = randomize(nest(to_jax_variables(build_model(cfg).state_dict())), seed=5)
    flat["params/hdn/center_net/size_out/kernel"] *= 0.01
    flat["params/hdn/center_net/size_out/bias"] = np.array([0.6, 0.7], np.float32)
    return flat


@pytest.fixture(scope="module")
def panoptic_models():
    """(JAX cfg, port cfg, JAX model, flat weights, port model) of the
    tiny geometry with the same random weights."""
    from faster_voxelpose_tpu.models.faster_voxelpose import build_model as jax_build
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.weights import from_jax_variables
    from tests.test_torch_datasets import _panoptic_cfgs

    jcfg, pcfg = _panoptic_cfgs("unused", "gt", CAPTURE_SPEC__MIN_SCORE=-1e9,
                                INDIVIDUAL_SPEC__SPACE_SIZE=(2100.0,) * 3, TEST__BATCH_SIZE=2)
    jcfg.WORKERS = pcfg.WORKERS = 0  # spawn workers would not see the one-sequence patch
    flat = _random_weights(pcfg)
    model = build_model(pcfg)
    model.load_state_dict(from_jax_variables(flat, model))
    return jcfg, pcfg, jax_build(jcfg), flat, model


@pytest.fixture(scope="module")
def panoptic_root(tmp_path_factory):
    """A Panoptic sequence of 25 frames (3 validation frames at interval
    12); small JPEGs, which the 'gt' source only needs to exist."""
    from tests.test_torch_datasets import write_panoptic_sequence

    root = tmp_path_factory.mktemp("panoptic")
    write_panoptic_sequence(root, SEQ, n_frames=25, size=(96, 54))
    return root


def test_evaluate_model_matches_jax(panoptic_root, panoptic_models, one_sequence, tmp_path,
                                    monkeypatch):
    """weights_mode 'best': both read <output_dir>/model_best.npz (the JAX
    package's orbax lookup pointed at the same file); the same records,
    metric and message, fused poses within 0.5 mm."""
    import faster_voxelpose_tpu.engine.checkpoint as jck
    from faster_voxelpose_tpu_torch.tools import validate
    from tests.test_torch_datasets import _close_preds

    jcfg, pcfg, jmodel, flat, _ = panoptic_models
    for cfg in (jcfg, pcfg):
        cfg.DATASET.DATADIR = str(panoptic_root)
    out = tmp_path / "output"
    out.mkdir()
    np.savez(out / "model_best.npz", **flat)
    monkeypatch.setattr(jck, "load_best_model", lambda d, template: jck.load_best_npz(
        os.path.join(d, "model_best.npz"), template))
    rmetric, rmsg, rpreds, rds = _run_module("validate").evaluate_model(jcfg, str(out))
    metric, msg, preds, ds = validate.evaluate_model(pcfg, str(out), device="cpu")
    assert len(ds.records) == len(rds.records) == 3
    _close_preds(preds, rpreds, (3, 4, 15, 5))
    assert msg == rmsg and metric == rmetric
    with pytest.raises(FileNotFoundError, match="repo_snapshot_fallback"):
        validate.evaluate_model(pcfg, str(tmp_path / "absent"), test_ds=ds, device="cpu")
    with pytest.raises(ValueError, match="weights_mode"):
        validate.evaluate_model(pcfg, str(out), weights_mode="last", test_ds=ds, device="cpu")


def test_validate_cli_torch_weights_and_visualization_match_jax(
        panoptic_root, panoptic_models, one_sequence, tmp_path, monkeypatch, capsys):
    """`--cfg --torch-weights` with TEST.VISUALIZATION in both CLIs: an
    upstream-named state dict of the same weights, the same printed
    metric table and metric line, the same files in validation_vis."""
    from faster_voxelpose_tpu_torch.tools import validate
    from tests.test_torch_backbone import _upstream_name

    *_, model = panoptic_models
    sd = {_upstream_name(k): v.clone() for k, v in model.state_dict().items()}
    weights = tmp_path / "model_best.pth.tar"
    torch.save({"state_dict": sd}, weights)
    printed, vis = {}, {}
    for name in ("jax", "port"):
        root = tmp_path / name
        root.mkdir()
        cfg = _write_yaml(root / "cli.yaml", str(root / "output"), str(panoptic_root), vis=True)
        args = ["--cfg", cfg, "--torch-weights", str(weights)]
        with _root_handlers_restored():
            if name == "jax":
                monkeypatch.setattr(sys, "argv", ["validate.py", *args])
                _run_module("validate").main()
            else:
                res = validate.main([*args, "--device", "cpu"])
        printed[name] = capsys.readouterr().out
        vis_dir = root / "output" / "panoptic" / "cli" / "validation_vis"
        vis[name] = sorted(p.name for p in vis_dir.iterdir())
    assert printed["port"] == printed["jax"] and "metric: " in printed["port"]
    assert vis["port"] == vis["jax"] and sorted(pathlib.Path(p).name for p in res["vis"]) == vis["jax"]
    # three predictions: a plane figure each, then each view's frame and heatmaps
    assert len(vis["port"]) == 3 * (1 + 3 + 3)


def test_validate_parser_keeps_the_modes_apart():
    from faster_voxelpose_tpu_torch.tools import validate

    for argv in (["--cfg", "a.yaml", "--checkpoint", "checkpoints/x"],
                 ["--torch-weights", "w.pth"], ["--profile", "trace"],
                 ["--cfg", "a.yaml", "--scenes", "4"]):
        with pytest.raises(SystemExit):
            validate.parse_args(argv)
    args = validate.parse_args(["--cfg", "a.yaml", "--torch-weights", "w.pth", "--profile", "t"])
    assert (args.cfg, args.torch_weights, args.profile) == ("a.yaml", "w.pth", "t")
    assert validate.parse_args([]).checkpoint == validate.DEFAULT_CHECKPOINT


def test_train_cli_visualization_leaves_the_training_as_it_was(tmp_path, monkeypatch):
    """TRAIN.VISUALIZATION draws TRAIN.VIS_TYPE on the batch after its
    step (an eval forward outside the step); the trainer's state after
    the epoch (parameters, BatchNorm statistics, both Adams) is bit for
    bit that of the same run without it."""
    from faster_voxelpose_tpu_torch.tools import train

    states = {}
    for vis in (False, True):
        root = tmp_path / f"vis_{vis}"
        cfg = _tiny_experiment(root)
        text = TINY_YAML.replace("PRINT_FREQ: 2", "PRINT_FREQ: 4")
        if vis:
            text = text.replace("  ACCUMULATION_STEPS: 2\n", "  ACCUMULATION_STEPS: 2\n"
                                "  VISUALIZATION: true\n  VIS_TYPE: ['2d_planes', 'heatmaps']\n")
        cfg.write_text(text)
        monkeypatch.chdir(root)
        with _root_handlers_restored():
            assert train.main(["--cfg", "tiny.yaml", "--device", "cpu", "--num-data", "8",
                               "--epochs", "1", "--snapshot-dir", "snap"]) == 0
        out = root / "output" / "synthetic" / "tiny"
        states[vis] = torch.load(out / "checkpoint.pt", weights_only=True)["trainer"]
        drawn = sorted(p.name for p in (out / "train_vis").iterdir()) \
            if (out / "train_vis").exists() else []
        # PRINT_FREQ 4 of 4 steps: batch 0 only, its 2 samples, 3 views
        assert drawn == ([] if not vis else [
            f"0_000000_{i:04d}_{kind}" for i in range(2) for kind in
            ("2d_planes.png", "view0_heatmaps.png", "view1_heatmaps.png", "view2_heatmaps.png")])

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{prefix}{k}/").items()}
        return {prefix: tree}

    a, b = flat(states[False]), flat(states[True])
    assert sorted(a) == sorted(b) and any("running_mean" in k for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _demo_inputs(tmp_path):
    """A tiny config, a flat calibration, 3 JPEG views, and upstream-named
    model and backbone state dicts written to files."""
    import cv2

    from faster_voxelpose_tpu_torch.config import load_config
    from faster_voxelpose_tpu_torch.datasets.demo_data import make_rig
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.weights import from_jax_variables
    from tests.test_torch_backbone import _upstream_backbone, _upstream_name

    cfg_path = _write_yaml(tmp_path / "demo.yaml", str(tmp_path / "out"), "unused", ori=(320, 240))
    pcfg = load_config(cfg_path)
    calib = tmp_path / "calib.json"
    calib.write_text(json.dumps(make_rig(3, radius_mm=3000.0, height_mm=2000.0, center=(0.0, 0.0),
                                         image_size=(320, 240)), default=lambda a: a.tolist()))
    rng = np.random.RandomState(0)
    images = []
    for v in range(3):
        p = str(tmp_path / f"view{v}.jpg")
        cv2.imwrite(p, rng.randint(0, 255, (240, 320, 3), np.uint8))
        images.append(p)
    model = build_model(pcfg)
    sd = {_upstream_name(k): v for k, v in from_jax_variables(_random_weights(pcfg), model).items()}
    torch.save({"state_dict": sd}, tmp_path / "model.pth")
    bsd = _upstream_backbone(18, np.random.RandomState(1), joints=15, filters=32)
    for leaf in ("weight", "bias"):  # heatmaps of a sensible range
        bsd[f"final_layer.{leaf}"] = bsd[f"final_layer.{leaf}"] * np.float32(0.02)
    torch.save({k: torch.as_tensor(v) for k, v in bsd.items()}, tmp_path / "backbone.pth")
    return cfg_path, str(calib), images


def test_demo_matches_jax_demo(tmp_path, monkeypatch, capsys):
    cfg, calib, images = _demo_inputs(tmp_path)
    common = ["--cfg", cfg, "--calibration", calib, "--images", *images,
              "--torch-weights", str(tmp_path / "model.pth"),
              "--backbone-weights", str(tmp_path / "backbone.pth"), "--repeat", "2"]
    monkeypatch.setattr(sys, "argv", ["demo.py", *common, "--out", str(tmp_path / "jax")])
    _run_module("demo").main()
    capsys.readouterr()
    from faster_voxelpose_tpu_torch.tools import demo

    res = demo.main([*common, "--out", str(tmp_path / "port"), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "steady-state latency" in printed and "detected" in printed
    ref = np.load(tmp_path / "jax" / "fused_poses.npy")
    got = np.load(tmp_path / "port" / "fused_poses.npy")
    assert got.shape == ref.shape == (4, 15, 5)
    valid = ref[:, 0, 3] >= 0
    np.testing.assert_array_equal(got[:, 0, 3] >= 0, valid)
    assert valid.any()
    assert np.max(np.abs(got[valid][..., :3] - ref[valid][..., :3])) <= 0.5
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) \
        == ["demo_2d_planes.png", "fused_poses.npy"]
    assert res["stats"]["requests"] == 3 and not res["stats"]["random_init"]
    assert not res["stats"]["backbone_random_init"]


def test_preprocess_matches_jax_preprocess(tmp_path, one_sequence, monkeypatch, capsys):
    """Two copies of one Panoptic tree at 320x240, one per package: the
    same images resized to 160x128 with the same bytes; a second run of
    each resizes none."""
    from faster_voxelpose_tpu_torch.tools import preprocess
    from tests.test_torch_datasets import write_panoptic_sequence

    write_panoptic_sequence(tmp_path / "jax", SEQ, n_frames=13, size=(320, 240))
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    cfgs = {name: _write_yaml(tmp_path / f"{name}.yaml", str(tmp_path / f"out_{name}"),
                              str(tmp_path / name), ori=(320, 240)) for name in ("jax", "port")}
    monkeypatch.syspath_prepend(str(REPO / "run"))  # its pool's workers import it by name
    import preprocess as jax_pre
    printed = {}
    for run in range(2):
        monkeypatch.setattr(sys, "argv", ["preprocess.py", "--cfg", cfgs["jax"], "--workers", "1"])
        jax_pre.main()
        changed = preprocess.main(["--cfg", cfgs["port"], "--workers", "1"])
        printed[run] = capsys.readouterr().out.splitlines()
        assert printed[run][:2] == printed[run][2:]  # the same lines from both
        assert changed == (0 if run else int(printed[run][1].split()[1]))
    assert int(printed[0][1].split()[1]) > 0 and printed[1][1].startswith("resized 0 ")

    def images(root):
        return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*.jpg"))}

    ref, got = images(tmp_path / "jax"), images(tmp_path / "port")
    assert sorted(got) == sorted(ref) and len(got) == 13 * 5
    assert all(got[k] == ref[k] for k in ref)
