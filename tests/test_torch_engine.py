"""PyTorch port, the training entry point on the CPU: the loader and its
worker pool against the JAX package's loader, `prefetch_to_device`, the
resumable checkpoint, the validator's padded final batch, the logging
utilities against the JAX package's (byte for byte), the demo-data tool
against `scripts/make_demo_data.py`, and `tools/train.py` end to end
(two epochs, a resume equal bit for bit to the uninterrupted run, and
nothing written under the repository's `checkpoints/`).

Loader batches, demo files and scalar records are compared for exact
equality; the eval step of a padded final batch against the same records
one at a time within 1e-3 mm (float32, batch-size-dependent sums).
"""

import contextlib
import hashlib
import json
import logging
import pathlib
import pickle
import threading

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent


class ToyDataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((3,), i, np.float32), "idx": np.int32(i)}


def _same_batches(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        for k in a:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("n, bs, shuffle, drop_last, count, index, seed", [
    (10, 4, False, True, 1, 0, 0),   # drop_last
    (10, 4, False, False, 1, 0, 0),  # padded final batch, _valid
    (11, 3, True, False, 1, 0, 5),   # shuffled, padded
    (17, 4, True, False, 2, 1, 1),   # a process's strided slice
    (9, 2, True, True, 2, 0, 3),
    (9, 2, False, False, 3, 2, 0),
])
def test_loader_matches_jax_loader(n, bs, shuffle, drop_last, count, index, seed):
    """Order, drop_last, padding and `_valid`, process slices: two epochs
    of the port's DataLoader equal the JAX package's batch for batch."""
    from faster_voxelpose_tpu.engine.loader import DataLoader as JaxLoader
    from faster_voxelpose_tpu_torch.engine.loader import DataLoader

    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=seed, process_count=count,
              process_index=index)
    ours, ref = DataLoader(ToyDataset(n), bs, **kw), JaxLoader(ToyDataset(n), bs, **kw)
    assert len(ours) == len(ref)
    for _ in range(2):
        _same_batches(list(ours), list(ref))
    with pytest.raises(ValueError):
        DataLoader(ToyDataset(n), bs, process_count=2, process_index=2)
    with pytest.raises(ValueError, match="dataset_factory"):
        DataLoader(ToyDataset(n), bs, num_workers=1)


TINY_YAML = """\
OUTPUT_DIR: 'output'
LOG_DIR: 'log'
WORKERS: 0
PRINT_FREQ: 2
DATASET:
  DATADIR: "data/Tiny"
  TRAIN_DATASET: 'synthetic'
  TEST_DATASET: 'synthetic'
  TRAIN_HEATMAP_SRC: 'gt'
  TEST_HEATMAP_SRC: 'gt'
  CAMERA_NUM: 3
  ORI_IMAGE_SIZE: [320, 240]
  IMAGE_SIZE: [160, 128]
  HEATMAP_SIZE: [40, 32]
  NUM_JOINTS: 15
  ROOT_JOINT_ID: 2
  DEVICE_RENDER: true
SYNTHETIC:
  CAMERA_FILE: 'calibration_demo.json'
  POSE_FILE: 'demo_pose_bank.pkl'
  MAX_PEOPLE: 3
  NUM_DATA: 8
  DATA_AUGMENTATION: true
NETWORK:
  COMPUTE_DTYPE: float32
TRAIN:
  BATCH_SIZE: 2
  LR: 0.001
  ACCUMULATION_STEPS: 2
TEST:
  BATCH_SIZE: 3
CAPTURE_SPEC:
  SPACE_SIZE: [4000.0, 4000.0, 1600.0]
  SPACE_CENTER: [0.0, 0.0, 800.0]
  VOXELS_PER_AXIS: [16, 16, 8]
  MAX_PEOPLE: 4
INDIVIDUAL_SPEC:
  SPACE_SIZE: [2000.0, 2000.0, 2000.0]
  VOXELS_PER_AXIS: [16, 16, 16]
"""
DEMO_ARGS = ["--views", "3", "--poses", "50", "--radius", "3000", "--image-size", "320", "240"]


def _tiny_experiment(root: pathlib.Path) -> pathlib.Path:
    """A tiny synthetic experiment under `root`: its demo data (written by
    tools/make_demo_data.py) and its YAML config; returns the config."""
    from faster_voxelpose_tpu_torch.tools import make_demo_data

    root.mkdir(parents=True, exist_ok=True)
    make_demo_data.main(["--out", str(root / "data" / "Tiny"), *DEMO_ARGS])
    cfg = root / "tiny.yaml"
    cfg.write_text(TINY_YAML)
    return cfg


def _tiny_cfgs(root: pathlib.Path, augmentation: bool):
    """(JAX config, port config) of the tiny experiment, DATADIR absolute."""
    from faster_voxelpose_tpu.config import load_config as jax_load
    from faster_voxelpose_tpu_torch.config import load_config

    path = _tiny_experiment(root)
    cfgs = jax_load(path), load_config(path)
    for cfg in cfgs:
        cfg.DATASET.DATADIR = str(root / "data" / "Tiny")
        cfg.SYNTHETIC.DATA_AUGMENTATION = augmentation
    return cfgs


def test_worker_pool_matches_jax_loader(tmp_path):
    """Two spawn workers that rebuild the dataset from its files
    (`DatasetFactory`) give the JAX loader's batches, augmentation off."""
    from faster_voxelpose_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
    from faster_voxelpose_tpu.engine.loader import DataLoader as JaxLoader
    from faster_voxelpose_tpu_torch.datasets import get_dataset
    from faster_voxelpose_tpu_torch.engine.loader import DataLoader, DatasetFactory

    jcfg, pcfg = _tiny_cfgs(tmp_path, augmentation=False)
    factory = DatasetFactory("synthetic", pcfg, True)
    ours = DataLoader(get_dataset("synthetic")(pcfg, is_train=True), 3, shuffle=True,
                      num_workers=2, seed=4, dataset_factory=factory)
    ref = JaxLoader(JaxSynthetic(jcfg, is_train=True), 3, shuffle=True, seed=4)
    try:
        for _ in range(2):
            _same_batches(list(ours), list(ref))
    finally:
        ours.close()
    assert ours._pool is None


def test_prefetch_keeps_order_and_values():
    from faster_voxelpose_tpu_torch.engine.loader import DataLoader, prefetch_to_device

    dl = DataLoader(ToyDataset(7), 2, shuffle=True, seed=2)
    direct = list(DataLoader(ToyDataset(7), 2, shuffle=True, seed=2))
    got = list(prefetch_to_device(iter(dl), size=2, device="cpu"))
    assert len(got) == len(direct) == 4
    for a, b in zip(got, direct):
        assert isinstance(a["x"], torch.Tensor) and isinstance(a["_valid"], np.ndarray)
        _same_batches([{k: np.asarray(v) for k, v in a.items()}], [b])
    with pytest.raises(RuntimeError, match="CUDA"):
        next(prefetch_to_device(iter(dl)))


def _threads():
    return [t for t in threading.enumerate() if t.name == "prefetch_to_device"]


def test_prefetch_raises_the_producers_error():
    """The producer's exception reaches the consumer after the batches
    made before it; closing the generator early ends the thread."""
    from faster_voxelpose_tpu_torch.engine.loader import DataLoader, prefetch_to_device

    def failing():
        yield from DataLoader(ToyDataset(4), 2)
        raise OSError("decode failed")

    got = []
    with pytest.raises(OSError, match="decode failed"):
        for b in prefetch_to_device(failing(), device="cpu"):
            got.append(b["idx"].tolist())
    assert got == [[0, 1], [2, 3]]
    gen = prefetch_to_device(iter(DataLoader(ToyDataset(40), 1)), size=1, device="cpu")
    next(gen)
    gen.close()
    assert not _threads()


def _tiny_trainer(pcfg, seed=0):
    from faster_voxelpose_tpu_torch.engine.trainer import Trainer
    from faster_voxelpose_tpu_torch.models import build_model

    torch.manual_seed(seed)
    return Trainer(pcfg, build_model(pcfg))


def _equal_trees(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal_trees(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


def test_checkpoint_round_trip(tmp_path):
    """save_checkpoint then load_checkpoint into a fresh trainer and
    loader: the trainer's state, the loader's order and the dataset's
    augmentation draws continue where they were; model_best.npz is
    written for a best epoch."""
    from faster_voxelpose_tpu_torch.datasets import get_dataset
    from faster_voxelpose_tpu_torch.engine.checkpoint import (
        BEST_NPZ,
        load_best_npz,
        load_checkpoint,
        save_checkpoint,
    )
    from faster_voxelpose_tpu_torch.engine.loader import DataLoader
    from faster_voxelpose_tpu_torch.models import build_model

    _, pcfg = _tiny_cfgs(tmp_path / "exp", augmentation=True)

    def loader():
        return DataLoader(get_dataset("synthetic")(pcfg, is_train=True), 2, shuffle=True,
                          drop_last=True, seed=1)

    out = tmp_path / "out"
    tr, ld = _tiny_trainer(pcfg), loader()
    assert load_checkpoint(str(out), tr, ld) == (0, -np.inf)
    for batch in ld:
        tr.step(batch)
    save_checkpoint(str(out), tr, 3, 0.25, True, ld)
    assert sorted(p.name for p in out.iterdir()) == ["checkpoint.pt", BEST_NPZ]
    best = load_best_npz(str(out / BEST_NPZ), build_model(pcfg))
    assert all(torch.equal(v, tr.model.state_dict()[k]) for k, v in best.state_dict().items())

    tr2, ld2 = _tiny_trainer(pcfg, seed=1), loader()
    assert load_checkpoint(str(out), tr2, ld2) == (3, 0.25)
    _equal_trees(tr2.state_dict(), tr.state_dict())
    assert ld2._host_order().tolist() == ld._host_order().tolist()
    assert ld2.dataset._rng.randint(1 << 30) == ld.dataset._rng.randint(1 << 30)


def test_eval_padded_batch_equals_records_alone(tmp_path):
    """run_validation at batch 3 over 8 records: the final batch (2
    records) is padded to 3 and its padding row dropped; every record's
    fused poses equal those of the record evaluated alone (1e-3 mm)."""
    from faster_voxelpose_tpu_torch.datasets import collate, get_dataset
    from faster_voxelpose_tpu_torch.engine.trainer import batch_to_device
    from faster_voxelpose_tpu_torch.engine.validator import make_eval_step, run_validation
    from faster_voxelpose_tpu_torch.models import build_model

    _, pcfg = _tiny_cfgs(tmp_path, augmentation=False)
    pcfg.CAPTURE_SPEC.MIN_SCORE = -1e9  # every slot valid
    torch.manual_seed(0)
    model = build_model(pcfg)
    ds = get_dataset("synthetic")(pcfg, is_train=False)
    assert len(ds) == 8 and pcfg.TEST.BATCH_SIZE == 3
    metric, msg, preds = run_validation(pcfg, model, ds, device="cpu")
    assert preds.shape == (8, 4, 15, 5) and "ap@50" in msg and np.isfinite(metric)
    step = make_eval_step(pcfg, model)
    for i in range(len(ds)):
        batch = batch_to_device(collate([ds[i]]), "cpu")
        alone = step({k: batch[k] for k in ("cameras", "hm_params")}).numpy()[0]
        np.testing.assert_array_equal(preds[i][..., 3], alone[..., 3])
        np.testing.assert_allclose(preds[i], alone, atol=1e-3, rtol=0, err_msg=i)


def test_scalar_writer_records_match_jax(tmp_path, monkeypatch):
    """The same scalars at the same wall times give the JAX writer's JSONL
    and TensorBoard event file byte for byte; the port's reader decodes
    them."""
    import time

    from faster_voxelpose_tpu.utils.logging_utils import ScalarWriter as JaxWriter
    from faster_voxelpose_tpu_torch.utils.logging_utils import ScalarWriter
    from faster_voxelpose_tpu_torch.utils.tb_events import read_events

    written = {}
    for name, cls in (("ours", ScalarWriter), ("ref", JaxWriter)):
        clock = iter(1_700_000_000.0 + 0.25 * i for i in range(100))
        monkeypatch.setattr(time, "time", lambda: next(clock))
        d = tmp_path / name
        d.mkdir()
        w = cls(str(d))
        for step, (tag, value) in enumerate([("train_loss_total", 3.5), ("eval_metric", 0.8125),
                                             ("train_loss_2d", 1e-7)]):
            w.add_scalar(tag, value, step)
        w.close()
        events = sorted(d.glob("events.out.tfevents.*"))
        assert len(events) == 1
        written[name] = ((d / "scalars.jsonl").read_bytes(), events[0].read_bytes(), events[0])
    monkeypatch.undo()
    assert written["ours"][:2] == written["ref"][:2]
    decoded = read_events(str(written["ours"][2]))
    assert decoded[0]["file_version"] == "brain.Event:2"
    assert [(e["tag"], e["step"]) for e in decoded[1:]] == [
        ("train_loss_total", 0), ("eval_metric", 1), ("train_loss_2d", 2)]


def test_make_demo_data_matches_the_script(tmp_path, monkeypatch):
    import sys

    from faster_voxelpose_tpu_torch.tools import make_demo_data
    from scripts import make_demo_data as script

    args = ["--views", "4", "--poses", "30", "--skeleton", "coco17", "--center", "450", "-320",
            "--radius", "4100", "--image-size", "1032", "776"]
    make_demo_data.main(["--out", str(tmp_path / "ours"), *args])
    monkeypatch.setattr(sys, "argv", ["make_demo_data.py", "--out", str(tmp_path / "ref"), *args])
    script.main()
    for name in ("ours", "ref"):
        assert sorted(p.name for p in (tmp_path / name).iterdir()) == [
            "calibration_demo.json", "demo_pose_bank.pkl"]
    load = lambda n: json.loads((tmp_path / n / "calibration_demo.json").read_text())  # noqa: E731
    assert load("ours") == load("ref") and len(load("ours")) == 4
    banks = [pickle.loads((tmp_path / n / "demo_pose_bank.pkl").read_bytes())
             for n in ("ours", "ref")]
    assert len(banks[0]) == len(banks[1]) == 30
    for a, b in zip(*banks):
        assert a.keys() == b.keys() == {"pose", "vis"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_get_dataset_names_what_is_not_ported():
    """Every dataset of the JAX package's registry is ported; an unknown
    name raises KeyError, as in the JAX package."""
    from faster_voxelpose_tpu.datasets import DATASETS as JAX_DATASETS
    from faster_voxelpose_tpu_torch.datasets import (CampusDataset, PanopticDataset,
                                                     ShelfDataset, SyntheticDataset, get_dataset)

    ours = {"synthetic": SyntheticDataset, "panoptic": PanopticDataset, "shelf": ShelfDataset,
            "campus": CampusDataset}
    assert set(ours) == set(JAX_DATASETS)
    for name, cls in ours.items():
        assert get_dataset(name) is cls
    with pytest.raises(KeyError):
        get_dataset("coco")


def test_step_timer_and_trace(tmp_path):
    from faster_voxelpose_tpu_torch.utils.profiling import StepTimer, trace

    timer = StepTimer()
    assert timer.summary() == "no steps"
    for _ in range(2):
        with timer.step() as st:
            st.set(torch.ones(3).sum())
    assert timer.steps == 2 and timer.device_steps == 0
    assert timer.summary().startswith("2 steps: host ") and "CUDA events" not in timer.summary()
    with trace(None):
        pass
    with trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert list((tmp_path / "trace").iterdir())


def test_bench_lock_is_the_jax_packages(tmp_path):
    from faster_voxelpose_tpu.utils import bench_lock as jax_lock
    from faster_voxelpose_tpu_torch.utils import bench_lock

    assert bench_lock.LOCK_PATH == jax_lock.LOCK_PATH
    path = str(tmp_path / "lock")
    assert bench_lock.wait_if_bench_locked(path) == 0.0
    with bench_lock.hold_bench_lock(path):
        assert pathlib.Path(path).exists()
    assert not pathlib.Path(path).exists()


def test_bench_lock_refuses_or_waits_for_a_second_holder(tmp_path, monkeypatch):
    """The JAX copy opens the lock with "w": a second holder overwrites
    it and the first one's exit removes the second's lock.  The port's
    refuses a fresh lock, or waits for it, and leaves it to its maker."""
    import time

    from faster_voxelpose_tpu_torch.utils import bench_lock

    monkeypatch.setattr(bench_lock, "POLL_S", 0.02)
    path = str(tmp_path / "lock")
    with bench_lock.hold_bench_lock(path):
        first = pathlib.Path(path).read_text()
        with pytest.raises(bench_lock.BenchLockHeld, match="is held"):
            with bench_lock.hold_bench_lock(path):
                pass
        assert pathlib.Path(path).read_text() == first  # not overwritten, not removed

    held, order = threading.Event(), []

    def first_holder():
        with bench_lock.hold_bench_lock(path):
            held.set()
            time.sleep(0.3)
            order.append("first out")

    t = threading.Thread(target=first_holder)
    t.start()
    held.wait(5)
    t0 = time.monotonic()
    with bench_lock.hold_bench_lock(path, wait_s=10):
        order.append("second in")
        assert time.monotonic() - t0 >= 0.1
        assert pathlib.Path(path).exists()
    t.join()
    assert order == ["first out", "second in"]
    assert not pathlib.Path(path).exists()

    # a stale lock (a crashed holder) is taken over at once
    pathlib.Path(path).write_text("crashed")
    old = time.time() - bench_lock.STALE_S - 10
    import os

    os.utime(path, (old, old))
    with bench_lock.hold_bench_lock(path):
        assert pathlib.Path(path).read_text() != "crashed"
    assert not pathlib.Path(path).exists()


def test_bench_lock_stays_fresh_through_a_long_hold(tmp_path, monkeypatch):
    """A hold longer than STALE_S keeps the lock: its mtime is refreshed
    every STALE_S / 4, so waiters go on waiting (the JAX copy's lock
    goes stale under a long run)."""
    import time

    from faster_voxelpose_tpu_torch.utils import bench_lock

    monkeypatch.setattr(bench_lock, "STALE_S", 0.4)
    monkeypatch.setattr(bench_lock, "POLL_S", 0.02)
    path = str(tmp_path / "lock")
    ages = []
    with bench_lock.hold_bench_lock(path):
        for _ in range(12):  # 1.2 s, three times STALE_S
            time.sleep(0.1)
            ages.append(bench_lock._lock_age(path))
        with pytest.raises(bench_lock.BenchLockHeld):
            with bench_lock.hold_bench_lock(path):
                pass
    assert all(a is not None and a < bench_lock.STALE_S for a in ages), ages
    assert not pathlib.Path(path).exists()


@contextlib.contextmanager
def _root_handlers_restored():
    """create_logger adds handlers to the root logger, as the JAX
    package's does: close and drop them after the run."""
    root = logging.getLogger()
    before = list(root.handlers)
    try:
        yield
    finally:
        for h in root.handlers[:]:
            if h not in before:
                root.removeHandler(h)
                h.close()


def _checkpoints_digest():
    h = hashlib.sha256()
    for p in sorted((REPO / "checkpoints").rglob("*")):
        if p.is_file():
            h.update(p.relative_to(REPO).as_posix().encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def _train(root: pathlib.Path, monkeypatch, *args):
    from faster_voxelpose_tpu_torch.tools import train

    monkeypatch.chdir(root)
    with _root_handlers_restored():
        assert train.main(["--cfg", "tiny.yaml", "--device", "cpu", "--num-data", "8",
                           "--snapshot-dir", "snap", *args]) == 0
    return root / "output" / "synthetic" / "tiny"


@pytest.fixture(scope="module")
def two_epochs(tmp_path_factory):
    """tools/train.py --device cpu --epochs 2 on the tiny experiment, and
    the digest of the repository's checkpoints/ before it."""
    before = _checkpoints_digest()
    root = tmp_path_factory.mktemp("straight")
    _tiny_experiment(root)
    with pytest.MonkeyPatch.context() as mp:
        out = _train(root, mp, "--epochs", "2")
    return root, out, before


def test_train_cli_runs_two_epochs(two_epochs):
    """Two epochs on the CPU: the checkpoint, the snapshot and its record,
    the log file, scalars.jsonl and a TensorBoard event file that reads
    back; nothing under the repository's checkpoints/ changed."""
    from faster_voxelpose_tpu_torch.engine.checkpoint import load_best_npz
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.utils.tb_events import read_events

    root, out, before = two_epochs
    assert _checkpoints_digest() == before
    ckpt = torch.load(out / "checkpoint.pt", weights_only=True)
    assert ckpt["epoch"] == 2 and int(ckpt["trainer"]["pose"]["count"]) == 4  # 8 steps, k = 2
    record = json.loads((root / "snap" / "eval_record.json").read_text())
    assert record["config"] == str(root / "tiny.yaml") and record["seed"] == 0
    assert record["epoch"] in (1, 2) and "ap@50" in record["message"]
    from faster_voxelpose_tpu_torch.config import load_config

    load_best_npz(str(root / "snap" / "model_best.npz"), build_model(load_config(root / "tiny.yaml")))
    log = next(out.glob("tiny_*_train.log")).read_text()
    assert "epoch 1 trained in" in log and "validated 8 frames" in log
    assert "kernel launches" in log and "done; best metric" in log
    (logdir,) = (root / "log" / "synthetic").iterdir()
    tags = [json.loads(line)["tag"] for line in (logdir / "scalars.jsonl").read_text().splitlines()]
    assert tags.count("eval_metric") == 2 and tags.count("train_loss_total") == 4
    (events,) = logdir.glob("events.out.tfevents.*")
    assert [e.get("tag") for e in read_events(str(events))[1:]] == tags


def test_resumed_run_equals_an_uninterrupted_one(two_epochs, tmp_path, monkeypatch):
    """One epoch, then --resume --epochs 2: the checkpoint equals the
    two-epoch run's bit for bit (model, both Adams, accumulator,
    mini-step, the loader's and the dataset's RandomStates)."""
    _, straight, before = two_epochs
    _tiny_experiment(tmp_path)
    _train(tmp_path, monkeypatch, "--epochs", "1")
    out = _train(tmp_path, monkeypatch, "--epochs", "2", "--resume")
    log = sorted(out.glob("tiny_*_train.log"))[-1].read_text()
    assert "resumed from" in log and "epoch 1" in log
    _equal_trees(torch.load(out / "checkpoint.pt", weights_only=True),
                 torch.load(straight / "checkpoint.pt", weights_only=True))
    assert _checkpoints_digest() == before


def test_train_cli_records_repo_relative_config_and_refuses_vis(tmp_path, monkeypatch):
    from faster_voxelpose_tpu_torch.tools import train

    assert train.config_path_for_record(str(REPO / "configs/demo/panoptic_synthetic.yaml")) \
        == "configs/demo/panoptic_synthetic.yaml"
    monkeypatch.chdir(REPO)
    assert train.config_path_for_record("configs/demo/synthetic.yaml") == \
        "configs/demo/synthetic.yaml"
    assert train.config_path_for_record(str(tmp_path / "x.yaml")) == str(tmp_path / "x.yaml")
    # TRAIN.VISUALIZATION runs (tests/test_torch_cli.py); the key the JAX
    # package declares and never reads is refused, not ignored
    cfg = _tiny_experiment(tmp_path)
    cfg.write_text(TINY_YAML.replace("  ACCUMULATION_STEPS: 2\n",
                                     "  ACCUMULATION_STEPS: 2\n  UPDATE_BACKBONE_BN_STATS: true\n"))
    with pytest.raises(NotImplementedError, match="never reads it"):
        train.main(["--cfg", str(cfg), "--device", "cpu"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--cfg", str(_tiny_experiment(tmp_path / "b"))])


def test_a_graph_asked_for_on_the_cpu_raises(tmp_path):
    """No compiled step falls back to eager on the CPU: a compiled
    trainer or validator on a CPU model raises."""
    from faster_voxelpose_tpu_torch.datasets import get_dataset
    from faster_voxelpose_tpu_torch.engine.trainer import Trainer
    from faster_voxelpose_tpu_torch.engine.validator import run_validation
    from faster_voxelpose_tpu_torch.models import build_model

    _, pcfg = _tiny_cfgs(tmp_path, augmentation=False)
    with pytest.raises(ValueError, match="CUDA"):
        Trainer(pcfg, build_model(pcfg), compiled=True)
    assert not Trainer(pcfg, build_model(pcfg)).compiled
    with pytest.raises(ValueError, match="CUDA"):
        run_validation(pcfg, build_model(pcfg), get_dataset("synthetic")(pcfg, is_train=False),
                       device="cpu", compiled=True)
