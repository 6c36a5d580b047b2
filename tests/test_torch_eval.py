"""PyTorch port, the evaluation path on the CPU: the port's own copy of
the metric functions against the JAX package's on seeded fixtures
(1e-12: the same numpy arithmetic), the held-out synthetic scenes, and
`run_validation` of both packages on the tiny geometry with the same
weights (fused poses within 0.5 mm, the JAX package's golden bound, and
the same metric message).
"""

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_data import _assert_same, _fixtures, _synthetic_cfgs
from tests.test_torch_modules import nest, randomize


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=1e-12)


def _panoptic_fixture(seed, n_frames=12, J=15, empty_preds=False, empty_gt=False):
    """Frames of 0-4 ground-truth people and 4 prediction slots: some
    predictions near a person (10-200 mm off), some far, some invalid;
    scores random, two predictions may claim one person."""
    rng = np.random.RandomState(seed)
    preds, gts = [], []
    for f in range(n_frames):
        G = 0 if empty_gt else int(rng.randint(0, 5))
        gt = rng.uniform(-2000, 2000, (G, 1, 3)) + rng.normal(0, 300, (G, J, 3))
        vis = (rng.rand(G, J) > 0.15).astype(np.float64)
        vis[:, 0] = 1.0
        p = np.zeros((4, J, 5))
        p[:, :, :3] = rng.uniform(-2000, 2000, (4, 1, 3)) + rng.normal(0, 300, (4, J, 3))
        for k in range(min(G, 3)):
            p[k, :, :3] = gt[rng.randint(G)] + rng.normal(0, rng.choice([10, 40, 90, 200]), (J, 3))
        p[:, :, 3] = np.where(rng.rand(4) < 0.25, -1.0, 0.0)[:, None]
        if empty_preds:
            p[:, :, 3] = -1.0
        p[:, :, 4] = rng.rand(4)[:, None]
        preds.append(p)
        gts.append((gt, vis))
    return preds, gts


@pytest.mark.parametrize("case", ["mixed", "other seed", "empty predictions", "empty ground truth"])
def test_panoptic_metrics_match_jax(case):
    from faster_voxelpose_tpu.datasets import evaluate as ref
    from faster_voxelpose_tpu_torch.datasets import evaluate as ours

    preds, gts = _panoptic_fixture(
        {"mixed": 0, "other seed": 1}.get(case, 2),
        empty_preds=case == "empty predictions", empty_gt=case == "empty ground truth")
    lo, lt = ours.match_predictions(preds, gts)
    ro, rt = ref.match_predictions(preds, gts)
    assert lt == rt and len(lo) == len(ro)
    for a, b in zip(lo, ro):
        assert a["gt_id"] == b["gt_id"]
        _close([a["mpjpe"], a["score"]], [b["mpjpe"], b["score"]])
    for t in (25.0, 100.0, 150.0):
        _close(ours.ap_at_threshold(lo, lt, t), ref.ap_at_threshold(ro, rt, t))
    for t in (150.0, 500.0):
        _close(ours.mpjpe_at_threshold(lo, t), ref.mpjpe_at_threshold(ro, t))
        _close(ours.recall_at_threshold(lo, lt, t), ref.recall_at_threshold(ro, rt, t))
    (m, msg, detail), (rm, rmsg, rdetail) = ours.panoptic_metrics(preds, gts), ref.panoptic_metrics(preds, gts)
    assert msg == rmsg and detail.keys() == rdetail.keys()
    _close(m, rm)
    for k in detail:
        _close(detail[k], rdetail[k])
    if case in ("mixed", "other seed"):
        assert 0.0 < detail["ap@150"] < 1.0 and 0.0 < detail["recall@500mm"] <= 1.0
        assert np.isfinite(detail["mpjpe@500mm"])
    else:
        assert m == 0.0 and detail["mpjpe@500mm"] == float("inf")


def _pcp_fixture(seed, n_frames=10, empty_preds=False):
    """COCO-17 predictions around 14-joint actors laid out so that the
    remapped prediction of actor a lands near its ground truth."""
    from faster_voxelpose_tpu_torch.datasets.demo_data import SKELETON_COCO17

    rng = np.random.RandomState(seed)
    preds, actors = [], []
    for f in range(n_frames):
        frame_preds = np.zeros((4, 17, 5))
        frame_gt = []
        for a in range(3):
            root = rng.uniform(-1500, 1500, 3) * np.array([1, 1, 0]) + np.array([0, 0, 900.0])
            coco = SKELETON_COCO17 + root + rng.normal(0, 15, (17, 3))
            frame_preds[a, :, :3] = coco + rng.normal(0, rng.choice([5, 60, 250]), (17, 3))
            frame_gt.append(coco if rng.rand() > 0.2 else np.zeros((0, 3)))
        frame_preds[3, :, :3] = rng.uniform(-3000, 3000, (17, 3))
        frame_preds[:, :, 3] = np.where(rng.rand(4) < 0.2, -1.0, 0.0)[:, None]
        if empty_preds:
            frame_preds[:, :, 3] = -1.0
        preds.append(frame_preds)
        actors.append(frame_gt)
    return preds, actors


@pytest.mark.parametrize("layout", ["shelf", "campus"])
@pytest.mark.parametrize("empty_preds", [False, True], ids=["mixed", "empty predictions"])
def test_pcp3d_matches_jax(layout, empty_preds):
    from faster_voxelpose_tpu.datasets import evaluate as ref
    from faster_voxelpose_tpu_torch.datasets import evaluate as ours

    name = f"coco_to_{layout}_pose"
    remap, ref_remap = getattr(ours, name), getattr(ref, name)
    preds, coco_actors = _pcp_fixture(3 if layout == "shelf" else 4, empty_preds=empty_preds)
    for frame in preds:
        for pose in frame:
            _close(remap(pose[:, :3]), ref_remap(pose[:, :3]))
    # ground truth in the dataset's 14-joint layout
    actors = [[remap(g) if len(g) else g for g in frame] for frame in coco_actors]
    (m, msg, d), (rm, rmsg, rd) = (ours.pcp3d_metrics(preds, actors, remap),
                                   ref.pcp3d_metrics(preds, actors, ref_remap))
    assert msg == rmsg
    _close(m, rm)
    _close(d["actor_pcp"], rd["actor_pcp"])
    _close(d["recall"], rd["recall"])
    assert list(d["bone_pcp"]) == list(rd["bone_pcp"]) == list(ours.PCP_BONE_GROUPS)
    for k in d["bone_pcp"]:
        _close(d["bone_pcp"][k], rd["bone_pcp"][k])
    assert ours.PCP_LIMBS == ref.PCP_LIMBS
    if empty_preds:
        assert m == 0.0
    else:
        assert 0.2 < m < 1.0 and 0.5 < d["recall"] <= 1.0


def test_held_out_scenes_match_jax():
    """is_train=False draws the scenes from TRAIN.SEED + 10007 in both
    packages: the same records, other than the training set's, and the
    same samples (augmentation draws included) after the same number of
    __getitem__ calls; an explicit seed overrides the default."""
    from faster_voxelpose_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
    from faster_voxelpose_tpu_torch.datasets import SyntheticDataset

    jcfg, pcfg = _synthetic_cfgs(num_data=5)
    bank, cams = _fixtures(pcfg)
    ref = JaxSynthetic(jcfg, is_train=False, pose_bank=bank, cameras=cams)
    ours = SyntheticDataset(pcfg, is_train=False, pose_bank=bank, cameras=cams)
    train = SyntheticDataset(pcfg, pose_bank=bank, cameras=cams)
    assert not ours.is_train and train.is_train and len(ours) == len(ref) == 5
    for r, o in zip(ref.records, ours.records):
        np.testing.assert_array_equal(o.joints_3d, r.joints_3d)
        np.testing.assert_array_equal(o.joints_3d_vis, r.joints_3d_vis)
    assert any(o.joints_3d.shape != t.joints_3d.shape or not np.array_equal(o.joints_3d, t.joints_3d)
               for o, t in zip(ours.records, train.records))
    for i in range(3):
        _assert_same(ours[i], ref[i])
    by_seed = SyntheticDataset(pcfg, is_train=False, pose_bank=bank, cameras=cams,
                               seed=pcfg.TRAIN.SEED + 10007)
    for a, b in zip(by_seed.records, ours.records):
        np.testing.assert_array_equal(a.joints_3d, b.joints_3d)
    other = JaxSynthetic(jcfg, pose_bank=bank, cameras=cams, seed=5)
    mine = SyntheticDataset(pcfg, pose_bank=bank, cameras=cams, seed=5)
    for a, b in zip(mine.records, other.records):
        np.testing.assert_array_equal(a.joints_3d, b.joints_3d)
    # the first N scenes of a longer set are that set's prefix
    pcfg.SYNTHETIC.NUM_DATA = 3
    prefix = SyntheticDataset(pcfg, is_train=False, pose_bank=bank, cameras=cams)
    for a, b in zip(prefix.records, ours.records):
        np.testing.assert_array_equal(a.joints_3d, b.joints_3d)


def test_dataset_evaluate_is_the_panoptic_table():
    from faster_voxelpose_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
    from faster_voxelpose_tpu_torch.datasets import PoseDatasetBase, SyntheticDataset

    jcfg, pcfg = _synthetic_cfgs(num_data=6)
    bank, cams = _fixtures(pcfg)
    ref = JaxSynthetic(jcfg, is_train=False, pose_bank=bank, cameras=cams)
    ours = SyntheticDataset(pcfg, is_train=False, pose_bank=bank, cameras=cams)
    rng = np.random.RandomState(0)
    K, J = pcfg.CAPTURE_SPEC.MAX_PEOPLE, pcfg.DATASET.NUM_JOINTS
    preds = np.zeros((len(ours), K, J, 5), np.float32)
    preds[..., 3] = -1.0
    for i, rec in enumerate(ours.records):  # the ground truth, 5-60 mm off
        n = len(rec.joints_3d)
        preds[i, :n, :, :3] = rec.joints_3d + rng.normal(0, rng.choice([5, 20, 60]), (n, J, 3))
        preds[i, :n, :, 3] = 0.0
        preds[i, :n, :, 4] = rng.rand(n)[:, None]
    (m, msg), (rm, rmsg) = ours.evaluate(preds), ref.evaluate(preds)
    assert msg == rmsg and msg.startswith("Evaluation results on Panoptic dataset:")
    _close(m, rm)
    assert 0.3 < m <= 1.0
    with pytest.raises(NotImplementedError):
        PoseDatasetBase.evaluate(ours, preds)


@pytest.fixture(scope="module")
def validation_pair():
    """run_validation of both packages on 5 held-out tiny scenes (batch 2:
    the last batch is short in the port and padded in the JAX package)
    with the same random weights; every proposal slot valid."""
    from faster_voxelpose_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
    from faster_voxelpose_tpu.engine.validator import run_validation as jax_validate
    from faster_voxelpose_tpu.models.faster_voxelpose import build_model as jax_build
    from faster_voxelpose_tpu_torch.datasets import SyntheticDataset
    from faster_voxelpose_tpu_torch.engine.validator import run_validation
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    jcfg, pcfg = _synthetic_cfgs(num_data=5)
    for cfg in (jcfg, pcfg):
        cfg.DATASET.TEST_DATASET, cfg.DATASET.TEST_HEATMAP_SRC = "synthetic", "gt"
        cfg.CAPTURE_SPEC.MIN_SCORE = -1e9
        cfg.INDIVIDUAL_SPEC.SPACE_SIZE = (2100.0,) * 3  # no crop-origin ties
        cfg.TEST.BATCH_SIZE = 2
    bank, cams = _fixtures(pcfg)
    jds = JaxSynthetic(jcfg, is_train=False, pose_bank=bank, cameras=cams)
    pds = SyntheticDataset(pcfg, is_train=False, pose_bank=bank, cameras=cams)
    V, J = jcfg.DATASET.CAMERA_NUM, jcfg.DATASET.NUM_JOINTS
    W, H = jcfg.DATASET.HEATMAP_SIZE
    jmodel = jax_build(jcfg)
    flat = randomize(jmodel.init(jax.random.PRNGKey(0), np.zeros((1, V, H, W, J), np.float32),
                                 np.zeros((1, V, 21), np.float32), train=False), seed=5)
    flat["params/hdn/center_net/size_out/kernel"] *= 0.01
    flat["params/hdn/center_net/size_out/bias"] = np.array([0.6, 0.7], np.float32)
    ref = jax_validate(jcfg, jmodel, nest(flat), jds)
    model = build_model(pcfg)
    model.load_state_dict(from_jax_variables(flat, model))
    ours = run_validation(pcfg, model, pds, device="cpu")
    return pds, ours, ref


def test_run_validation_matches_jax(validation_pair):
    from faster_voxelpose_tpu_torch.datasets.evaluate import match_predictions

    pds, (metric, msg, preds), (rmetric, rmsg, rpreds) = validation_pair
    assert preds.shape == rpreds.shape == (5, 4, 15, 5)
    assert np.max(np.abs(preds[..., :3] - rpreds[..., :3])) <= 0.5
    np.testing.assert_allclose(preds[..., 3:], rpreds[..., 3:], atol=1e-3)
    # no matched error sits within 1 mm of a threshold of the table, so
    # 0.5 mm between the packages cannot move a prediction across one
    gts = [(r.joints_3d, r.joints_3d_vis) for r in pds.records]
    errs = np.array([e["mpjpe"] for e in match_predictions(list(preds), gts)[0]])
    assert len(errs) == 5 * 4
    assert np.abs(errs[:, None] - np.array([25, 50, 75, 100, 125, 150, 500.0])).min() > 1.0
    assert msg == rmsg
    assert abs(metric - rmetric) <= 1e-12


def test_run_validation_needs_cuda_or_cpu(monkeypatch, validation_pair):
    from faster_voxelpose_tpu_torch.engine import make_eval_step, run_validation
    from faster_voxelpose_tpu_torch.models import build_model

    pds = validation_pair[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_validation(pds.cfg, build_model(pds.cfg), pds)
    # the eval step renders 'hm_params' and takes rendered heatmaps alike
    from faster_voxelpose_tpu_torch.datasets import collate
    from faster_voxelpose_tpu_torch.engine.trainer import batch_to_device
    from faster_voxelpose_tpu_torch.ops.heatmap_render import render_heatmaps_device

    torch.manual_seed(0)
    model = build_model(pds.cfg)
    batch = batch_to_device(collate([pds[0]]), "cpu")
    step = make_eval_step(pds.cfg, model)
    W, H = pds.cfg.DATASET.HEATMAP_SIZE
    rendered = {"cameras": batch["cameras"],
                "input_heatmaps": render_heatmaps_device(batch["hm_params"], H, W)}
    a, b = step(batch), step(rendered)
    assert a.shape == (1, 4, 15, 5) and torch.equal(a, b)


def test_held_out_profile_builds_from_seeds():
    """tools.validate's dataset: the Panoptic profile's held-out scenes on
    the demo rig and bank, a prefix of the longer set."""
    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile
    from faster_voxelpose_tpu_torch.tools.validate import held_out_dataset

    ds = held_out_dataset(panoptic_synthetic_profile(), scenes=3)
    assert len(ds) == 3 and not ds.is_train and ds.data_augmentation
    more = held_out_dataset(panoptic_synthetic_profile(), scenes=4)
    for a, b in zip(ds.records, more.records):
        np.testing.assert_array_equal(a.joints_3d, b.joints_3d)
    sample = ds[0]
    assert sample["hm_params"].shape == (5, 10, 15, 12) and sample["cameras"].shape == (5, 21)
    assert 1 <= int(sample["num_person"]) <= 10


def test_centre_heatmap_keeps_its_float32_sums_in_bf16():
    """With bf16 conv stacks a head's last layer rounds its operands to
    bf16 but returns the float32 sums.  Held against the JAX package's own
    layer (flax `nn.Conv(dtype=bfloat16)` then `.astype(float32)`) on the
    same input and weights: on the CPU flax rounds the conv's sums to
    bf16, adds the bf16 bias and rounds again before the cast.  The port's
    sums, rounded at those two points, equal flax's (to one bf16 ulp,
    2^-7 relative: the order of the float32 sums may differ); unrounded,
    the port's output lies within those two roundings of it and is not
    itself bf16-representable.  That is the port's
    one stated departure from the JAX package's CPU arithmetic; it follows
    the snapshot's evaluation record instead (rounded to bf16, flat peaks
    of the centre heatmap tie under the max-pool NMS and one person is
    proposed twice)."""
    import flax.linen as fnn
    import jax.numpy as jnp

    from faster_voxelpose_tpu_torch.models.cnns import C2CNet, CenterNet, P2PNet, WeightNet

    rng = np.random.RandomState(0)
    x = rng.rand(1, 8, 8, 8).astype(np.float32)  # NHWC
    kernel = (rng.randn(1, 1, 8, 1) * 0.5).astype(np.float32)  # HWIO
    bias = rng.randn(1).astype(np.float32)
    layer = fnn.Conv(1, (1, 1), padding="VALID", dtype=jnp.bfloat16)
    y = layer.apply({"params": {"kernel": kernel, "bias": bias}}, x)
    assert y.dtype == jnp.bfloat16  # the JAX package's CPU arithmetic rounds here
    want = np.array(y.astype(jnp.float32)).transpose(0, 3, 1, 2)

    torch.manual_seed(0)
    net = CenterNet(15, dtype=torch.bfloat16, width=0.25).eval()
    with torch.no_grad():
        net.hm_out.weight.copy_(torch.as_tensor(kernel).permute(3, 2, 0, 1))
        xt = torch.as_tensor(x).permute(0, 3, 1, 2)
        sums = net.hm_out(xt)  # the bias is still 0
        net.hm_out.bias.copy_(torch.as_tensor(bias))
        got = net.hm_out(xt)
        assert got.dtype == torch.float32
        assert not torch.equal(got, got.bfloat16().float())
        twice = (sums.bfloat16() + torch.as_tensor(bias).bfloat16()).float()
        np.testing.assert_allclose(twice.numpy(), want, rtol=2.0 ** -7, atol=0)
        assert bool(((got - torch.as_tensor(want)).abs() <= 2.0 ** -7 * (sums.abs() + got.abs())).all())

        # one rule for every head's last layer
        for p in net.parameters():
            if p.ndim > 1:
                p.normal_(0.0, (2.0 / p[0].numel()) ** 0.5)
        hm, size = net(torch.rand(1, 8, 8, 4, 15))
    assert hm.dtype == size.dtype == torch.float32
    assert not torch.equal(hm, hm.bfloat16().float())
    assert not torch.equal(size, size.bfloat16().float())
    heads = [net.hm_out, net.size_out, C2CNet(15, torch.bfloat16, 0.25).output,
             P2PNet(15, 15, torch.bfloat16, 0.25).output, WeightNet(dtype=torch.bfloat16).fc2]
    assert all(h.dtype == torch.bfloat16 and h.out_dtype == torch.float32 for h in heads)
    assert net.hm_conv.out_dtype == torch.bfloat16
