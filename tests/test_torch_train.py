"""PyTorch port, the training path: train-mode BatchNorm against flax,
the proposal-to-GT matching, each loss term, and one train step of the
tiny model against the JAX package's (same flax weights, same batch, CPU),
the step body against the JAX package's jitted train step over three
calls (optimizer states included), the masked Adam, the step's freedom
from host data, its image branch, plus the optimizers' schedule.

Tolerances: BatchNorm outputs and running statistics 1e-5 (float32
reductions in another order); loss terms on the same outputs 1e-6
relative; a whole train step's losses 1e-4 relative and each gradient
tensor 1e-3 in relative L2 norm.

The train step runs its conv stacks in float64 (COMPUTE_DTYPE) on both
sides, the JAX side under jax.enable_x64.  In float32 the train-mode
gradients of the U-Nets are conditioned too badly for a 1e-3 comparison:
against a float64 run, the P2PNet gradients of either package are 3e-3
to 9e-3 off in float32, for fan-in scaled and for the default N(0, 0.001)
weights alike, because the BatchNorm backward subtracts nearly equal
sums.  A conv bias followed by a train-mode BatchNorm has a zero gradient
in exact arithmetic; for such a tensor the norm is taken against 1e-6 of
the largest gradient norm of the model, so that rounding noise on a zero
is not read as a relative error.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_geometry import tiny_configs, tiny_rig
from tests.test_torch_model import _frames
from tests.test_torch_modules import nest, randomize


@pytest.mark.parametrize("rank", [1, 2])
def test_batchnorm_train_mode_matches_flax(rank):
    """Output and updated running statistics of a train-mode BatchNorm
    (biased variance, momentum 0.9) against flax."""
    import flax.linen as fnn

    from faster_voxelpose_tpu_torch.models.blocks import BatchNorm

    rng = np.random.RandomState(rank)
    shape = (6, 9, 8, 5)[: rank + 1] + (5,) if rank == 2 else (6, 11, 5)
    x = (rng.randn(*shape) * 2.0 + 0.7).astype(np.float32)  # channels last
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
                   "bias": rng.randn(5).astype(np.float32)},
        "batch_stats": {"mean": rng.randn(5).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, 5).astype(np.float32)},
    }
    y, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])

    port = BatchNorm(5)
    with torch.no_grad():
        port.weight.copy_(torch.as_tensor(variables["params"]["scale"]))
        port.bias.copy_(torch.as_tensor(variables["params"]["bias"]))
        port.running_mean.copy_(torch.as_tensor(variables["batch_stats"]["mean"]))
        port.running_var.copy_(torch.as_tensor(variables["batch_stats"]["var"]))
    xt = torch.as_tensor(x).movedim(-1, 1).contiguous()
    out = port(xt, train=True).movedim(1, -1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), atol=1e-5)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]), atol=1e-5)


def test_match_proposals_to_gt_matches_jax():
    from faster_voxelpose_tpu.models.hdn import match_proposals_to_gt as jax_match
    from faster_voxelpose_tpu_torch.models.hdn import match_proposals_to_gt

    rng = np.random.RandomState(3)
    B, K, Kgt = 4, 10, 10
    gt = rng.uniform(-3000, 3000, (B, Kgt, 3)).astype(np.float32)
    centers = rng.uniform(-3000, 3000, (B, K, 3)).astype(np.float32)
    centers[:, :4] = gt[:, [0, 2, 2, 5]] + rng.uniform(-300, 300, (B, 4, 3))  # near, shared
    bbox_gt = rng.uniform(0.3, 0.9, (B, Kgt, 2)).astype(np.float32)
    bbox = rng.uniform(0.2, 1.0, (B, K, 2)).astype(np.float32)
    num = np.array([0, 1, 3, 10], np.int32)
    ji, jb = jax_match(*(jnp.asarray(a) for a in (centers, bbox, gt, bbox_gt, num)))
    pi, pb = match_proposals_to_gt(*(torch.as_tensor(a) for a in (centers, bbox, gt, bbox_gt, num)))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    assert (pi[0] == -1).all() and (pi[2:, :4] >= 0).any()


def _random_outputs(cfg, rng, any_valid=True):
    """Random HDN/JLN outputs, targets and meta at the tiny shapes."""
    B, K = 2, cfg.CAPTURE_SPEC.MAX_PEOPLE
    J = cfg.DATASET.NUM_JOINTS
    vx, vy, vz = cfg.CAPTURE_SPEC.VOXELS_PER_AXIS
    f = lambda *s: rng.rand(*s).astype(np.float32)  # noqa: E731
    p2g = np.where(rng.rand(B, K) < 0.6, rng.randint(0, K, (B, K)), -1).astype(np.float32)
    if not any_valid:
        p2g[:] = -1
    pc = np.concatenate([f(B, K, 3) * 1000, p2g[..., None], f(B, K, 3)], -1)
    hdn = dict(heatmaps_2d=f(B, vx, vy), heatmaps_1d=f(B, K, vz), bbox_maps=f(B, vx * vy, 2),
               proposal_centers=pc, feature_cubes=np.zeros((B, 1, 1, 1, J), np.float32))
    jln = dict(fused_poses=f(B, K, J, 3) * 2000, plane_poses=f(3, B, K, J, 2) * 2000,
               confidences=f(B, K))
    targets = {"2d_heatmaps": f(B, vx, vy), "1d_heatmaps": f(B, K, vz),
               "index": rng.randint(0, vx * vy, (B, K)).astype(np.float32),
               "bbox": f(B, K, 2), "mask": rng.rand(B, K) < 0.5}
    meta = {"joints_3d": f(B, K, J, 3) * 2000, "joints_3d_vis": (rng.rand(B, K, J) < 0.8).astype(np.float32)}
    return hdn, jln, p2g >= 0, targets, meta


@pytest.mark.parametrize("any_valid", [True, False])
def test_loss_terms_match_jax(any_valid):
    from faster_voxelpose_tpu.models.faster_voxelpose import FasterVoxelPoseNet as JaxNet, build_model as jax_build
    from faster_voxelpose_tpu.models.hdn import HDNOutputs as JHDN
    from faster_voxelpose_tpu.models.jln import JLNOutputs as JJLN
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.models.hdn import HDNOutputs
    from faster_voxelpose_tpu_torch.models.jln import JLNOutputs

    jcfg, pcfg = tiny_configs()
    hdn, jln, mask, targets, meta = _random_outputs(pcfg, np.random.RandomState(int(any_valid)), any_valid)
    jm = jax_build(jcfg)
    ref = jm.apply({}, JHDN(**{k: jnp.asarray(v) for k, v in hdn.items()}),
                   JJLN(**{k: jnp.asarray(v) for k, v in jln.items()}), jnp.asarray(mask),
                   {k: jnp.asarray(v) for k, v in targets.items()},
                   {k: jnp.asarray(v) for k, v in meta.items()}, method=JaxNet._losses)
    t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}  # noqa: E731
    ours = build_model(pcfg)._losses(HDNOutputs(**t(hdn)), JLNOutputs(**t(jln)),
                                     torch.as_tensor(mask), t(targets), t(meta))
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-6, atol=0, err_msg=k)
    assert (float(ours["joint"]) == 0.0) == (not any_valid)


@pytest.fixture(scope="module")
def train_pair():
    """Tiny model with float64 conv stacks, random flax weights, one batch
    whose GT roots sit near the model's own train-mode proposals (so the
    matching, and with it the 1D and joint losses, is active); from one
    jit of the JAX package's train step (ACCUMULATION_STEPS 2, LR 1e-3):
    the first call's losses, gradients and BatchNorm statistics, and over
    three calls (`ref["calls"]`) the losses and the states before and
    after each (`ref["states"]`: parameters, BatchNorm statistics,
    optimizer states)."""
    from faster_voxelpose_tpu.engine.trainer import create_train_state, make_train_step
    from faster_voxelpose_tpu.models.faster_voxelpose import build_model as jax_build
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    jcfg, pcfg = tiny_configs(INDIVIDUAL_SPEC__SPACE_SIZE=(2100.0,) * 3,
                              NETWORK__COMPUTE_DTYPE="float64")
    for cfg in (jcfg, pcfg):
        cfg.TRAIN.ACCUMULATION_STEPS, cfg.TRAIN.LR = 2, 1e-3
    V, J, K = jcfg.DATASET.CAMERA_NUM, jcfg.DATASET.NUM_JOINTS, jcfg.CAPTURE_SPEC.MAX_PEOPLE
    W, H = jcfg.DATASET.HEATMAP_SIZE
    vx, vy, vz = jcfg.CAPTURE_SPEC.VOXELS_PER_AXIS
    B = 2
    rng = np.random.RandomState(11)
    batch = {"input_heatmaps": _frames(V, H, W, J, B, seed=12),
             "cameras": np.stack([tiny_rig(V)] * B)}
    jm = jax_build(jcfg)
    with jax.enable_x64(True):
        flat = randomize(jm.init(jax.random.PRNGKey(0), batch["input_heatmaps"][:1],
                                 batch["cameras"][:1], train=False), seed=13)
    flat["params/hdn/center_net/size_out/kernel"] *= 0.01
    flat["params/hdn/center_net/size_out/bias"] = np.array([0.6, 0.7], np.float32)

    model = build_model(pcfg)
    model.load_state_dict(from_jax_variables(flat, model))
    with torch.no_grad():
        pc = model(torch.as_tensor(batch["input_heatmaps"]), torch.as_tensor(batch["cameras"]),
                   train=True).proposal_centers[..., :3].numpy()
    roots = (pc + rng.uniform(-150, 150, pc.shape)).astype(np.float32)
    batch.update({
        "2d_heatmaps": rng.rand(B, vx, vy).astype(np.float32),
        "1d_heatmaps": rng.rand(B, K, vz).astype(np.float32),
        "index": rng.randint(0, vx * vy, (B, K)).astype(np.float32),
        "bbox": (rng.rand(B, K, 2) * 0.5 + 0.3).astype(np.float32),
        "mask": np.tile(np.arange(K) < 3, (B, 1)),
        "roots_3d": roots,
        "num_person": np.array([3, 2], np.int32),
        "joints_3d": (roots[:, :, None] + rng.uniform(-200, 200, (B, K, J, 3))).astype(np.float32),
        "joints_3d_vis": (rng.rand(B, K, J) < 0.9).astype(np.float32),
    })

    # the JAX package's jitted train step over the calls of `calls`: the
    # batch, the batch with no GT person (joint loss 0, the JLN's Adam
    # skipped; the HDN's k-th call), the batch again; the state before
    # each call and after the last.  The first call's gradients are read
    # from the optimizer states it leaves: MultiSteps' running mean of one
    # call is the HDN gradient itself, and Adam's first moment after one
    # step is 0.1 of the JLN gradient.
    calls = [batch, {**batch, "num_person": np.zeros_like(batch["num_person"])}, batch]

    def snapshot(state):
        pose, joint = state.opt_state_pose.inner_opt_state[0], state.opt_state_joint[0]
        return {"params": _flat(state.params, "params"),
                "stats": _flat(state.batch_stats, "batch_stats"),
                "pose": {"mu": _flat(pose.mu, "params"), "nu": _flat(pose.nu, "params"),
                         "count": int(pose.count),
                         "acc": _flat(state.opt_state_pose.acc_grads, "params"),
                         "mini_step": int(state.opt_state_pose.mini_step)},
                "joint": {"mu": _flat(joint.mu, "params"), "nu": _flat(joint.nu, "params"),
                          "count": int(joint.count)}}

    with jax.enable_x64(True):
        step = jax.jit(make_train_step(jcfg, jm))
        state = create_train_state(jcfg, nest(flat))
        states, trajectory = [snapshot(state)], []
        for b in calls:
            state, losses = step(state, b)
            states.append(snapshot(state))
            trajectory.append({k: float(v) for k, v in losses.items()})
    after = states[1]
    ref = {"losses": trajectory[0],
           "grads": {**after["pose"]["acc"],
                     **{k: v / np.float32(0.1) for k, v in after["joint"]["mu"].items()}},
           "stats": after["stats"], "calls": calls, "trajectory": trajectory, "states": states}
    return pcfg, flat, batch, ref


def _flat(tree, prefix=""):
    """A flax tree as flat numpy arrays keyed 'prefix/path'."""
    from faster_voxelpose_tpu_torch.weights import flatten_variables

    return {f"{prefix}/{k}" if prefix else k: np.asarray(v)
            for k, v in flatten_variables(tree).items()}


def _trainer(pcfg, flat):
    from faster_voxelpose_tpu_torch.engine.trainer import Trainer
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    model = build_model(pcfg)
    model.load_state_dict(from_jax_variables(flat, model))
    return Trainer(pcfg, model)


def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_train_step_matches_jax(train_pair):
    """Losses, every parameter's gradient and the BatchNorm statistics
    after one train-mode forward, against the JAX package's train step."""
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    pcfg, flat, batch, ref = train_pair
    tr = _trainer(pcfg, flat)
    tr.model.zero_grad(set_to_none=True)
    losses = tr.loss(_tensors(batch))
    losses["total"].backward()
    assert ref["losses"]["joint"] > 0 and ref["losses"]["1d_heatmaps"] > 0
    for k, v in ref["losses"].items():
        np.testing.assert_allclose(float(losses[k].detach()), v, rtol=1e-4, atol=0, err_msg=k)

    want = from_jax_variables(ref["grads"])
    params = dict(tr.model.named_parameters())
    assert set(want) == set(params)
    scale = max(float(np.linalg.norm(g.numpy())) for g in want.values())
    worst = {}
    for k, g in want.items():
        got = params[k].grad.numpy()
        den = max(float(np.linalg.norm(g.numpy())), 1e-6 * scale)
        worst[k] = float(np.linalg.norm(got - g.numpy())) / den
    bad = {k: v for k, v in worst.items() if v > 1e-3}
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:8]

    stats = from_jax_variables(ref["stats"])
    buffers = dict(tr.model.named_buffers())
    for k, v in stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def test_bf16_train_forward_within_rounding_of_jax(train_pair):
    """The train-mode forward with bf16 conv stacks, as training runs on
    the card, against the JAX package's on the same weights and batch:
    the same proposal-to-GT matching, each loss term within 2e-2 relative
    and the updated BatchNorm statistics within 2e-2 relative L2.  The
    two packages round bf16 at different points (fusion in XLA, op by op
    in PyTorch), so this bound holds the bf16 path against gross faults
    only; float32 and float64 carry the tight bounds."""
    from faster_voxelpose_tpu.models.faster_voxelpose import build_model as jax_build
    from faster_voxelpose_tpu_torch.engine.trainer import META_KEYS, TARGET_KEYS
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    _, flat, batch, _ = train_pair
    jcfg, pcfg = tiny_configs(INDIVIDUAL_SPEC__SPACE_SIZE=(2100.0,) * 3,
                              NETWORK__COMPUTE_DTYPE="bfloat16")
    jm = jax_build(jcfg)

    def forward(variables, b):
        out, mut = jm.apply(variables, b["input_heatmaps"], b["cameras"],
                            targets={k: b[k] for k in TARGET_KEYS},
                            meta={k: b[k] for k in META_KEYS}, train=True, mutable=["batch_stats"])
        return out.losses, mut["batch_stats"], out.proposal_centers

    losses, stats, centers = jax.jit(forward)(nest(flat), batch)
    model = build_model(pcfg)
    model.load_state_dict(from_jax_variables(flat, model))
    b = _tensors(batch)
    with torch.no_grad():
        out = model(b["input_heatmaps"], b["cameras"], targets={k: b[k] for k in TARGET_KEYS},
                    meta={k: b[k] for k in META_KEYS}, train=True)
    np.testing.assert_array_equal(out.proposal_centers[..., 3].numpy(), np.asarray(centers)[..., 3])
    assert float(losses["joint"]) > 0 and float(losses["1d_heatmaps"]) > 0
    for k, v in losses.items():
        np.testing.assert_allclose(float(out.losses[k]), float(v), rtol=2e-2, atol=0, err_msg=k)
    buffers = dict(model.named_buffers())
    for k, v in from_jax_variables({f"batch_stats/{p}": s for p, s in _flat(stats).items()}).items():
        err = float((buffers[k] - v).norm() / v.norm())
        assert err <= 2e-2, (k, err)


def test_pose_optimizer_steps_every_k_calls(train_pair):
    """ACCUMULATION_STEPS = 2: the HDN is unchanged after one step and
    updated after the second; the JLN updates on every step."""
    pcfg, flat, batch, _ = train_pair
    tr = _trainer(pcfg, flat)
    b = _tensors(batch)
    hdn0 = {k: v.clone() for k, v in tr.model.hdn.state_dict().items() if "running" not in k}
    jln0 = [p.detach().clone() for p in tr.model.jln.parameters()]

    def moved(before, module):
        now = {k: v for k, v in module.state_dict().items() if "running" not in k}
        return sum(float((now[k] - v).abs().sum()) for k, v in before.items())

    losses = tr.step(b)
    assert float(losses["joint"]) > 0
    assert moved(hdn0, tr.model.hdn) == 0.0
    assert sum(float((p.detach() - q).abs().sum()) for p, q in zip(tr.model.jln.parameters(), jln0)) > 0
    assert int(tr.opt_pose.count) == 0 and int(tr.mini_step) == 1
    assert not tr.opt_pose.mu.any() and tr.acc.any()
    tr.step(b)
    assert moved(hdn0, tr.model.hdn) > 0
    assert int(tr.mini_step) == 0 and not tr.acc.any()
    assert int(tr.opt_pose.count) == 1 and int(tr.opt_joint.count) == 2


def test_joint_optimizer_skips_when_joint_loss_is_zero(train_pair):
    """No GT person: no proposal matches, the joint loss is exactly 0 and
    the JLN's parameters and Adam state stay untouched."""
    pcfg, flat, batch, _ = train_pair
    tr = _trainer(pcfg, flat)
    b = _tensors(batch)
    b["num_person"] = torch.zeros_like(b["num_person"])
    jln0 = [p.detach().clone() for p in tr.model.jln.parameters()]
    losses = tr.step(b)
    assert float(losses["joint"]) == 0.0 and float(losses["1d_heatmaps"]) == 0.0
    assert all(torch.equal(p, q) for p, q in zip(tr.model.jln.parameters(), jln0))
    assert int(tr.opt_joint.count) == 0
    assert not tr.opt_joint.mu.any() and not tr.opt_joint.nu.any()


def _named(model, prefix, views):
    """{parameter name: tensor} of an Adam's flat-buffer views."""
    names = [n for n, _ in model.named_parameters() if n.startswith(prefix)]
    return dict(zip(names, views))


def _rel_l2(got, want, floor):
    """{name: relative L2 error}, each norm taken against at least `floor`
    times the largest norm of `want` (a near-zero tensor is rounding
    noise, not a scale)."""
    scale = max(float(np.linalg.norm(w)) for w in want.values())
    return {k: float(np.linalg.norm(np.asarray(got[k], np.float64) - w))
            / (max(float(np.linalg.norm(w)), floor * scale) or 1.0) for k, w in want.items()}


def _load_jax_state(tr, state):
    """Copy a JAX train state (the fixture's snapshot) into trainer `tr`."""
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    tr.model.load_state_dict(from_jax_variables({**state["params"], **state["stats"]}))

    def flat_of(prefix, tree):
        want = from_jax_variables(tree)
        return torch.cat([want[n].reshape(-1) for n, _ in tr.model.named_parameters()
                          if n.startswith(prefix)])

    for name, opt, prefix in (("pose", tr.opt_pose, "hdn."), ("joint", tr.opt_joint, "jln.")):
        opt.mu.copy_(flat_of(prefix, state[name]["mu"]))
        opt.nu.copy_(flat_of(prefix, state[name]["nu"]))
        opt.count.fill_(state[name]["count"])
    tr.acc.copy_(flat_of("hdn.", state["pose"]["acc"]))
    tr.mini_step.fill_(state["pose"]["mini_step"])


def test_step_body_matches_jax_train_step(train_pair):
    """The step body, eager on the CPU, against the JAX package's jitted
    train step over ACCUMULATION_STEPS + 1 = 3 calls, the second with no
    GT person (joint loss 0: the JLN's Adam skipped, on the HDN's k-th
    call, which steps the HDN's Adam on the mean of two gradients).  Each
    call starts from the JAX state before it: Adam's first steps move an
    element by about +-LR whatever its gradient's size, so an element
    whose gradient is within rounding of 0 moves either way, and two free
    trajectories part by more than rounding (the WeightNet's moments by
    2.4e-2 after three calls, measured).  After each call: the losses 1e-4
    relative; every parameter, both Adams' moments and the HDN's
    accumulator 1e-3 relative L2 per tensor (norms floored at 1e-6 of the
    largest); the step counts and the mini-step exact."""
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    pcfg, flat, _, ref = train_pair
    tr = _trainer(pcfg, flat)
    states = ref["states"]

    def port(d):
        return {k: v.numpy() for k, v in from_jax_variables(d).items()}

    assert [t["joint"] > 0 for t in ref["trajectory"]] == [True, False, True]
    worst = {}
    for i, (b, losses) in enumerate(zip(ref["calls"], ref["trajectory"])):
        _load_jax_state(tr, states[i])
        got = tr.step(_tensors(b))
        for k, v in losses.items():
            np.testing.assert_allclose(float(got[k]), v, rtol=1e-4, atol=1e-12, err_msg=(i, k))
        want = states[i + 1]
        params = {k: v.detach().numpy() for k, v in tr.model.named_parameters()}
        worst[i, "params"] = max(_rel_l2(params, port(want["params"]), 1e-6).values())
        for name, opt, prefix in (("pose", tr.opt_pose, "hdn."), ("joint", tr.opt_joint, "jln.")):
            bufs = {"mu": opt.mu, "nu": opt.nu, **({"acc": tr.acc} if name == "pose" else {})}
            for key, flat_buf in bufs.items():
                ours = {k: v.numpy() for k, v in _named(tr.model, prefix, opt.views(flat_buf)).items()}
                theirs = port(want[name][key])
                assert set(ours) == set(theirs)
                worst[i, f"{name} {key}"] = max(_rel_l2(ours, theirs, 1e-6).values())
            assert int(opt.count) == want[name]["count"], (i, name)
        assert int(tr.mini_step) == want["pose"]["mini_step"], i
    assert [(s["pose"]["count"], s["joint"]["count"], s["pose"]["mini_step"])
            for s in states[1:]] == [(0, 1, 1), (1, 1, 0), (1, 2, 1)]
    assert all(v <= 1e-3 for v in worst.values()), worst


def test_masked_adam_leaves_state_bit_for_bit():
    """A step under a false mask leaves parameters (-0.0 and NaN among
    them), moments and step count bit for bit; under a true mask it is
    optax's adam."""
    import optax

    from faster_voxelpose_tpu_torch.engine.trainer import Adam

    rng = np.random.RandomState(0)
    params = [torch.nn.Parameter(torch.as_tensor(rng.randn(3, 4).astype(np.float32))),
              torch.nn.Parameter(torch.tensor([-0.0, float("nan"), 1.5]))]
    opt = Adam(params, 1e-2)
    grads = [rng.randn(3, 4).astype(np.float32), np.array([0.5, -1.0, 2.0], np.float32)]
    flat = torch.cat([torch.as_tensor(g).reshape(-1) for g in grads])
    before = [p.detach().clone() for p in params] + [opt.mu.clone(), opt.nu.clone()]
    opt.step(flat, torch.tensor(False))
    after = [p.detach() for p in params] + [opt.mu, opt.nu]
    assert all(a.view(torch.int32).equal(b.view(torch.int32)) for a, b in zip(before, after))
    assert int(opt.count) == 0

    tx = optax.adam(1e-2)
    jp = [np.asarray(b) for b in before[:2]]
    state = tx.init(jp)
    for i in range(2):
        opt.step(flat, torch.tensor(True))
        upd, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, q in zip(params, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), rtol=1e-6,
                                       atol=1e-7, equal_nan=True, err_msg=i)
    assert int(opt.count) == int(state[0].count) == 2


def test_step_body_builds_no_tensor_from_host_data(train_pair, monkeypatch):
    """The train step a CUDA graph captures copies nothing from the host
    and reads no value back: the gates are device tensors, the losses
    slice the planes' coordinates (no list index)."""
    from tests.test_torch_serve import _guarded

    pcfg, flat, batch, _ = train_pair
    tr = _trainer(pcfg, flat)
    b = _tensors(batch)
    out = []
    assert _guarded(monkeypatch, lambda: out.append(tr.step_body(b)), inference=False) == []
    assert float(out[0]["joint"]) > 0


def test_image_branch_equals_heatmap_branch(train_pair):
    """A step on uint8 images through the frozen backbone equals a step on
    the heatmaps the same backbone makes of them, bit for bit."""
    from faster_voxelpose_tpu_torch.engine.trainer import Trainer
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.models.resnet import build_backbone, images_to_heatmaps

    _, pcfg = tiny_configs(INDIVIDUAL_SPEC__SPACE_SIZE=(2100.0,) * 3)
    pcfg.RESNET.NUM_LAYERS = 18
    _, _, batch, _ = train_pair
    torch.manual_seed(3)
    backbone = build_backbone(pcfg)
    iw, ih = pcfg.DATASET.IMAGE_SIZE
    B, V = batch["cameras"].shape[:2]
    images = torch.as_tensor(np.random.RandomState(4).randint(0, 256, (B, V, ih, iw, 3))
                             .astype(np.uint8))
    with torch.no_grad():
        heatmaps = images_to_heatmaps(backbone, images, pcfg.DATASET.COLOR_RGB)
    b = {k: v for k, v in _tensors(batch).items() if k != "input_heatmaps"}
    results = []
    for src in ({"images": images}, {"input_heatmaps": heatmaps}):
        torch.manual_seed(5)
        tr = Trainer(pcfg, build_model(pcfg), backbone=backbone)
        losses = tr.step({**b, **src})
        results.append((losses, [p.detach().clone() for p in tr.model.parameters()]))
    (la, pa), (lb, pb) = results
    assert all(torch.equal(la[k], lb[k]) for k in la)
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))


def test_partition_covers_every_parameter():
    from torch import nn

    from faster_voxelpose_tpu_torch.engine.trainer import AverageMeter, partition_params
    from faster_voxelpose_tpu_torch.models import build_model

    _, pcfg = tiny_configs()
    model = build_model(pcfg)
    pose, joint = partition_params(model)
    assert len(pose) + len(joint) == len(list(model.parameters()))
    model.extra = nn.Linear(2, 2)
    with pytest.raises(ValueError, match="extra"):
        partition_params(model)
    m = AverageMeter()
    m.update(2.0, 3)
    m.update(4.0)
    assert m.avg == 2.5 and m.val == 4.0
