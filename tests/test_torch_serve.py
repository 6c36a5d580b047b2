"""PyTorch port, serving: the port's JSON-lines server
(`faster_voxelpose_tpu_torch/tools/serve.py`) against the JAX package's
(`run/serve.py`) on one request script, with the same weights carried
across by `weights.from_jax_variables`; the image-file loader, the
best-model loader and the server's argument handling; and the two
properties the compiled service stands on, checked on the CPU: the
served forward builds no tensor from host data (a CUDA graph could not
hold the copy), and `set_rig` writes into the one rig tensor the graphs
read.  The graphs themselves run only on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`).

Tolerances: fused poses within 0.5 mm of the JAX package's (its golden
bound: float32 convolutions summed in another order); proposal scores
to 1e-3; everything else in the protocol's answers exactly, latencies
and the port's own `stats` keys (`device`, `backbone_random_init`,
`backbone_folded`, `fusion_folded`) apart.  Image decoding and weight loading are exact.
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

from tests.test_cli_surfaces import _write_cfg
from tests.test_torch_backbone import _upstream_backbone, _upstream_name
from tests.test_torch_modules import nest, randomize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATENCY_KEYS = {"latency_ms", "mean_ms", "p50_ms", "p95_ms"}
PORT_ONLY_STATS = {"device", "backbone_random_init", "backbone_folded", "fusion_folded"}


def _calibration(path, radius=3000.0, seed=0):
    """A 3-camera flat calibration file for the tiny config's 320x240
    sensor (the port's copy of make_demo_data.make_rig)."""
    from faster_voxelpose_tpu_torch.datasets.demo_data import make_rig, write_calibration

    write_calibration(str(path), make_rig(3, radius, 2000.0, (0.0, 0.0), (320, 240), seed=seed))
    return str(path)


def _image_files(tmp_path, n, size=(320, 240), seed=0, name="v"):
    import cv2

    rng = np.random.RandomState(seed)
    paths = []
    for v in range(n):
        p = str(tmp_path / f"{name}{v}.jpg")
        cv2.imwrite(p, rng.randint(0, 255, (size[1], size[0], 3), np.uint8))
        paths.append(p)
    return paths


def _tiny_configs(cfg_path):
    """The tiny YAML loaded by both packages, every proposal slot valid
    (so that every fused pose is compared) and crops that stay clear of
    the crop origin's rounding ties."""
    from faster_voxelpose_tpu.config import load_config as jax_load
    from faster_voxelpose_tpu_torch.config import load_config

    cfgs = jax_load(cfg_path), load_config(cfg_path)
    for cfg in cfgs:
        cfg.CAPTURE_SPEC.MIN_SCORE = -1e9
        cfg.INDIVIDUAL_SPEC.SPACE_SIZE = (2100.0,) * 3
    return cfgs


def _jax_weights(jcfg):
    """Fan-in scaled random model and backbone variables of the tiny
    config, flat, with bbox sizes near 0.6 and the backbone's heatmaps in
    about [-1, 1]."""
    from faster_voxelpose_tpu.datasets.images import normalize_images_device
    from faster_voxelpose_tpu.models.faster_voxelpose import build_model as jax_build
    from faster_voxelpose_tpu.models.resnet import build_backbone as jax_backbone

    V, J = jcfg.DATASET.CAMERA_NUM, jcfg.DATASET.NUM_JOINTS
    W, H = jcfg.DATASET.HEATMAP_SIZE
    iw, ih = jcfg.DATASET.IMAGE_SIZE
    model, backbone = jax_build(jcfg), jax_backbone(jcfg)

    def shapes(module, *args, **kw):  # every value is redrawn: trace the init, run nothing
        tree = jax.eval_shape(lambda key: module.init(key, *args, **kw), jax.random.PRNGKey(0))
        return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tree)

    flat = randomize(shapes(model, np.zeros((1, V, H, W, J), np.float32),
                            np.zeros((1, V, 21), np.float32), train=False), seed=5)
    flat["params/hdn/center_net/size_out/kernel"] *= 0.01
    flat["params/hdn/center_net/size_out/bias"] = np.array([0.6, 0.7], np.float32)
    bflat = randomize(shapes(backbone, np.zeros((1, ih, iw, 3), np.float32)), seed=9)
    u8 = np.random.RandomState(8).randint(0, 256, (1, ih, iw, 3)).astype(np.uint8)
    raw = backbone.apply(nest(bflat), normalize_images_device(u8, jcfg.DATASET.COLOR_RGB))
    for leaf in ("kernel", "bias"):
        bflat[f"params/final/{leaf}"] /= np.float32(np.abs(np.asarray(raw)).max())
    return flat, bflat


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    cfg_path = _write_cfg(tmp)
    jcfg, pcfg = _tiny_configs(cfg_path)
    flat, bflat = _jax_weights(jcfg)
    return tmp, cfg_path, jcfg, pcfg, flat, bflat


def _script(tmp):
    """The request script, and the heatmaps frame and image files it
    names: every command of the protocol, each error answer (bad JSON, a
    missing payload, too few views, an unknown command), and a rig
    swap between two heatmap requests."""
    hm = str(tmp / "frame.npy")
    np.save(hm, np.random.RandomState(3).rand(3, 32, 40, 15).astype(np.float32) * 0.3)
    images = _image_files(tmp, 3, seed=4)
    requests = [
        {"cmd": "ping"},
        {"cmd": "infer", "heatmaps": hm},
        {"cmd": "infer", "images": images},
        {"cmd": "rig", "calibration": _calibration(tmp / "calib2.json", radius=4000.0, seed=1)},
        {"cmd": "infer", "heatmaps": hm},
        {"cmd": "infer"},
        {"cmd": "infer", "images": images[:2]},
        {"cmd": "nope"},
        {"cmd": "stats"},
        {"cmd": "quit"},
        {"cmd": "ping"},  # after quit: never answered
    ]
    return "not json\n" + "".join(json.dumps(r) + "\n" for r in requests)


def _same_line(ours: dict, ref: dict) -> None:
    if "poses_mm" in ref:
        assert ours["n_people"] == ref["n_people"] == len(ref["poses_mm"]) > 0
        np.testing.assert_allclose(ours["scores"], ref["scores"], rtol=0, atol=1e-3)
        d = np.abs(np.asarray(ours["poses_mm"]) - np.asarray(ref["poses_mm"]))
        assert float(d.max()) <= 0.5
        assert "latency_ms" in ours
        return
    drop = LATENCY_KEYS | PORT_ONLY_STATS
    assert {k: v for k, v in ours.items() if k not in drop} == \
        {k: v for k, v in ref.items() if k not in LATENCY_KEYS}


def test_port_server_answers_as_the_jax_server(tiny):
    """The same JSON-lines script through run/serve.py's `serve` over the
    JAX PoseService (aot=False) and through the port's over its
    PoseService on the CPU: line for line the same answers (the ready
    line, ping, errors, rig, stats, bye), the same proposals and fused
    poses within 0.5 mm for heatmap and image-file requests, before and
    after the rig swap."""
    sys.path.insert(0, os.path.join(REPO, "run"))
    import serve as jax_serve

    from faster_voxelpose_tpu.engine.service import PoseService as JaxService
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.tools import serve

    tmp, _, jcfg, pcfg, flat, bflat = tiny
    calib = _calibration(tmp / "calib.json")
    script = _script(tmp)
    ref_svc = JaxService(jcfg, variables=nest(flat), backbone_vars=nest(bflat), aot=False)
    ref_svc.set_rig_from_calibration(calib)
    ours_svc = PoseService(pcfg, variables=flat, backbone_variables=bflat, device="cpu")
    ours_svc.set_rig_from_calibration(calib)
    ref_out, ours_out = io.StringIO(), io.StringIO()
    jax_serve.serve(ref_svc, io.StringIO(script), ref_out)
    serve.serve(ours_svc, io.StringIO(script), ours_out)

    ref = [json.loads(line) for line in ref_out.getvalue().splitlines()]
    ours = [json.loads(line) for line in ours_out.getvalue().splitlines()]
    assert len(ours) == len(ref) == 12  # ready, 10 answers, no answer after quit
    for a, b in zip(ours, ref):
        _same_line(a, b)
    assert ours[0]["ready"] and "bad json" in ours[1]["error"]
    assert ours[7] == {"error": "infer needs 'images' or 'heatmaps'"}
    assert ours[8] == {"error": "ValueError: need 3 views, got 2"}
    assert ours[10]["requests"] == 3 and ours[10]["compiled"] == []
    assert ours[10]["device"] == "cpu" and ours[-1] == {"ok": True, "bye": True}
    # the swap moved the answer
    assert not np.allclose(ours[3]["poses_mm"], ours[6]["poses_mm"])


@pytest.mark.parametrize("size", [(320, 240), (160, 128)], ids=["warped", "at-size"])
def test_load_view_images_u8_matches_jax(tmp_path, size):
    """uint8 frames decoded (and warped to IMAGE_SIZE where they are not
    at it) equal the JAX package's, exactly."""
    from faster_voxelpose_tpu.datasets.images import load_view_images_u8 as jax_load
    from faster_voxelpose_tpu_torch.datasets.images import load_view_images_u8
    from faster_voxelpose_tpu_torch.geometry.transforms import get_resize_transform

    paths = _image_files(tmp_path, 3, size=size, seed=2)
    rt = get_resize_transform((320, 240), (160, 128))
    got = load_view_images_u8(paths, (160, 128), rt)
    assert got.shape == (3, 128, 160, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_load(paths, (160, 128), rt))
    if size != (160, 128):
        with pytest.raises(ValueError, match="resize_transform"):
            load_view_images_u8(paths, (160, 128))
    with pytest.raises(FileNotFoundError):
        load_view_images_u8([str(tmp_path / "missing.jpg")], (160, 128), rt)


def test_load_view_images_u8_needs_cv2(tmp_path, monkeypatch):
    """Without cv2 the loader raises ImportError naming it; it has no
    other decoder."""
    from faster_voxelpose_tpu_torch.datasets.images import load_view_images_u8

    paths = _image_files(tmp_path, 1, size=(160, 128))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        load_view_images_u8(paths, (160, 128))


def test_load_best_model(tmp_path):
    """load_best_model raises without <dir>/model_best.npz, loads a
    snapshot exactly as load_best_npz does, and reaches the repo's
    checkpoints/<basename> only through repo_snapshot_fallback."""
    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile
    from faster_voxelpose_tpu_torch.engine.checkpoint import (
        load_best_model,
        load_best_npz,
        save_best_npz,
    )
    from faster_voxelpose_tpu_torch.models import build_model

    cfg = panoptic_synthetic_profile()
    snapshot = os.path.join(REPO, "checkpoints", "panoptic_synthetic")
    want = load_best_npz(os.path.join(snapshot, "model_best.npz"), build_model(cfg)).state_dict()

    def same(model):
        got = model.state_dict()
        return sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)

    assert same(load_best_model(snapshot, build_model(cfg)))
    mistyped = tmp_path / "panoptic_synthetic"  # a run dir named like the snapshot, empty
    mistyped.mkdir()
    with pytest.raises(FileNotFoundError, match="repo_snapshot_fallback"):
        load_best_model(str(mistyped), build_model(cfg))
    assert same(load_best_model(str(mistyped), build_model(cfg), repo_snapshot_fallback=True))
    with pytest.raises(FileNotFoundError):
        load_best_model(str(tmp_path), build_model(cfg), repo_snapshot_fallback=True)
    # a model of the run's own, saved under its output dir, wins over the repo's
    torch.manual_seed(1)
    own = build_model(cfg)
    save_best_npz(str(mistyped / "model_best.npz"), own)
    got = load_best_model(str(mistyped), build_model(cfg), repo_snapshot_fallback=True)
    assert all(torch.equal(got.state_dict()[k], v) for k, v in own.state_dict().items())


class _HostData(torch.utils._python_dispatch.TorchDispatchMode):
    """Records each tensor built from host data (aten.lift_fresh:
    torch.tensor, torch.as_tensor of numpy data or lists, a Python list
    used as an index) and each read of a tensor's value by the host
    (aten._local_scalar_dense: .item(), bool(), int()), except while
    `paused`.  On the card each is a copy or a synchronisation that a
    CUDA graph cannot capture."""

    def __init__(self):
        super().__init__()
        self.seen, self.paused = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused and func in (torch.ops.aten.lift_fresh.default,
                                        torch.ops.aten._local_scalar_dense.default):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def _guarded(monkeypatch, run, inference=True):
    """run() with torch.tensor, torch.as_tensor and torch.from_numpy
    raising and host data recorded, except inside the sampling kernels'
    plain versions: on the card the kernel runs in their place and takes
    its constants by value.  Under inference mode unless `inference` is
    false (a train step's backward needs autograd).  Returns what was
    recorded."""
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    mode = _HostData()

    def refuse(name, fn):
        def call(*a, **k):
            if not mode.paused:
                raise AssertionError(f"torch.{name} in the forward")
            return fn(*a, **k)
        return call

    def paused(fn):
        def call(*a, **k):
            mode.paused += 1
            try:
                return fn(*a, **k)
            finally:
                mode.paused -= 1
        return call

    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse(name, getattr(torch, name)))
    for name in ("sample_whole_projected_plain", "sample_crop_planes_plain"):
        monkeypatch.setattr(sk, name, paused(getattr(sk, name)))
    with (torch.inference_mode() if inference else contextlib.nullcontext()), mode:
        run()
    monkeypatch.undo()
    return mode.seen


@pytest.mark.parametrize("graph", ["heatmaps", "images_u8"])
def test_served_forward_builds_no_tensor_from_host_data(tiny, monkeypatch, graph):
    """The forward that PoseService captures, at batch 1, copies nothing
    from the host and reads no value back: the crop constants, the
    ImageNet statistics and the plane offsets' indices are tensors built
    at construction.  The guard itself catches a list index (the plane
    offsets' former `off[..., [0, 1]]`)."""
    from faster_voxelpose_tpu_torch.engine import PoseService

    _, _, _, pcfg, flat, bflat = tiny
    svc = PoseService(pcfg, variables=flat, backbone_variables=bflat, device="cpu")
    svc.set_rig(np.asarray(svc._placeholder_rig()))
    V, J = pcfg.DATASET.CAMERA_NUM, pcfg.DATASET.NUM_JOINTS
    W, H = pcfg.DATASET.HEATMAP_SIZE
    iw, ih = pcfg.DATASET.IMAGE_SIZE
    rng = np.random.RandomState(6)
    x = (torch.from_numpy(rng.rand(1, V, H, W, J).astype(np.float32)) if graph == "heatmaps"
         else torch.from_numpy(rng.randint(0, 256, (1, V, ih, iw, 3)).astype(np.uint8)))
    forward = svc._forward(graph)
    out = []
    assert _guarded(monkeypatch, lambda: out.append(forward(x))) == []
    assert out[0].fused_poses.shape == (1, pcfg.CAPTURE_SPEC.MAX_PEOPLE, J, 5)
    off = torch.zeros(2, 3)
    assert _guarded(monkeypatch, lambda: off[..., [0, 1]]) == ["aten.lift_fresh.default"]


def test_set_rig_writes_in_place(tiny):
    """set_rig copies into the service's one rig tensor (its storage
    unchanged, so a captured graph reads the new rig) and moves the
    answers: after the swap the service answers as a service built on the
    new rig, exactly."""
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.geometry import dome_rig

    _, _, _, pcfg, flat, _ = tiny
    center = pcfg.CAPTURE_SPEC.SPACE_CENTER
    rig1 = dome_rig(1, 3, space_center=center, ori_image_size=(320, 240), focal=240.0)[0]
    rig2 = dome_rig(1, 3, space_center=center, ori_image_size=(320, 240), focal=240.0,
                    seed=7, radius_range=(3200.0, 3600.0))[0]
    hm = np.random.RandomState(2).rand(3, 32, 40, 15).astype(np.float32) * 0.2
    hm[:, 10:18, 14:22, :] = 1.0
    svc = PoseService(pcfg, variables=flat, rig=rig1, device="cpu")
    ptr = svc._rig.data_ptr()
    first = svc.infer_heatmaps(hm)
    svc.set_rig(rig2)
    assert svc._rig.data_ptr() == ptr
    np.testing.assert_array_equal(svc._rig.numpy()[0], rig2)
    second = svc.infer_heatmaps(hm)
    fresh = PoseService(pcfg, variables=flat, rig=rig2, device="cpu").infer_heatmaps(hm)
    assert second["poses_mm"] == fresh["poses_mm"] and second["scores"] == fresh["scores"]
    assert not np.allclose(first["poses_mm"], second["poses_mm"])
    svc.set_rig(rig1[None])
    assert svc._rig.data_ptr() == ptr and svc.infer_heatmaps(hm)["poses_mm"] == first["poses_mm"]
    with pytest.raises(ValueError, match="rig shape"):
        svc.set_rig(np.zeros((5, 21), np.float32))


def test_cpu_service_captures_nothing(tiny, tmp_path, monkeypatch):
    """On the CPU construction runs no forward even with aot; warmup runs
    one eager forward per graph and lists it under `compiled` (the
    renamed `warm`); requests before any rig is set raise, though warmup
    ran on its placeholder rig."""
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.models.faster_voxelpose import FasterVoxelPoseNet

    _, _, _, pcfg, flat, _ = tiny
    calls = []
    forward = FasterVoxelPoseNet.forward
    monkeypatch.setattr(FasterVoxelPoseNet, "forward",
                        lambda self, *a, **k: calls.append(1) or forward(self, *a, **k))
    svc = PoseService(pcfg, variables=flat, device="cpu", aot=True)
    assert calls == [] and svc.stats() == {"requests": 0, "random_init": False,
                                           "backbone_random_init": True,
                                           "backbone_folded": False,
                                           "fusion_folded": False}
    assert svc.warmup() == ["heatmaps"] and len(calls) == 1
    assert svc.warmup() == ["heatmaps"] and len(calls) == 1  # once per graph
    with pytest.raises(RuntimeError, match="no camera rig"):
        svc.infer_heatmaps(np.zeros((3, 32, 40, 15), np.float32))
    svc.set_rig_from_calibration(_calibration(tmp_path / "calib.json"))
    svc.infer_heatmaps(np.zeros((3, 32, 40, 15), np.float32))
    stats = svc.stats()
    assert stats["compiled"] == ["heatmaps"] and "warm" not in stats


def test_build_service_from_argv(tiny, tmp_path, capsys):
    """tools/serve.py's build_service: upstream state dicts by
    --torch-weights and --backbone-weights (converted exactly), a run's
    own model_best.npz by --best-from, and the random-init warning on
    stderr when no weights are given."""
    from faster_voxelpose_tpu_torch.engine.checkpoint import save_best_npz
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.tools import serve
    from faster_voxelpose_tpu_torch.weights import convert_backbone, convert_model

    _, cfg_path, _, pcfg, _, _ = tiny
    calib = _calibration(tmp_path / "calib.json")
    rng = np.random.RandomState(0)
    sd = {_upstream_name(k): rng.randn(*v.shape).astype(np.float32)
          for k, v in build_model(pcfg).state_dict().items()}
    bsd = _upstream_backbone(18, rng, joints=15, filters=256)
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, tmp_path / "model.pth.tar")
    torch.save({"state_dict": {f"module.{k}": torch.as_tensor(v) for k, v in bsd.items()}},
               tmp_path / "backbone.pth")
    base = ["--cfg", cfg_path, "--calibration", calib, "--device", "cpu"]
    svc = serve.build_service(serve.parse_args(
        base + ["--torch-weights", str(tmp_path / "model.pth.tar"),
                "--backbone-weights", str(tmp_path / "backbone.pth")]))
    for module, want in ((svc.model, convert_model(sd)), (svc.backbone, convert_backbone(bsd, 18))):
        got = module.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert not svc.random_init and not svc.backbone_random_init and svc._rig_set
    assert "RANDOM-INIT" not in capsys.readouterr().err

    torch.manual_seed(3)
    own = build_model(pcfg)
    save_best_npz(str(tmp_path / "run" / "model_best.npz"), own)
    svc = serve.build_service(serve.parse_args(base + ["--best-from", str(tmp_path / "run")]))
    assert all(torch.equal(svc.model.state_dict()[k], v) for k, v in own.state_dict().items())
    assert "RANDOM-INIT" not in capsys.readouterr().err

    svc = serve.build_service(serve.parse_args(base + ["--no-aot"]))
    assert svc.random_init and "RANDOM-INIT" in capsys.readouterr().err


def test_serve_config_resolution(tiny):
    """--cfg: a committed profile by its stem or its YAML is built in code
    (config.profile), any other YAML is read by load_config; without
    --cfg the snapshot's eval record names the profile, and with neither
    the server refuses to start."""
    import dataclasses

    from faster_voxelpose_tpu_torch.config import load_config, profile
    from faster_voxelpose_tpu_torch.tools.serve import resolve_config

    _, cfg_path, _, _, _, _ = tiny
    asdict = dataclasses.asdict
    campus = asdict(profile("campus_synthetic"))
    assert asdict(resolve_config("campus_synthetic", None)) == campus
    assert asdict(resolve_config(os.path.join(REPO, "configs/demo/campus_synthetic.yaml"),
                                 None)) == campus
    assert asdict(resolve_config(cfg_path, None)) == asdict(load_config(cfg_path))
    snapshot = os.path.join(REPO, "checkpoints", "shelf_synthetic_ref")
    assert asdict(resolve_config(None, snapshot)) == asdict(profile("shelf_synthetic_ref"))
    with pytest.raises(SystemExit):
        resolve_config(None, None)
