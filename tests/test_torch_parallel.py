"""PyTorch port, scale-out (`parallel/mesh.py`) on torch.distributed over
gloo on the CPU, against one process on the global batch and against the
JAX package's `parallel/mesh.py` on its 8 virtual CPU devices.

One spawned group of two ranks runs every check of that world size: the
data-parallel eval step, the data-parallel train step on a global batch
of 8 (and the same with rank 1's shard holding no person, so that only
the global count and the global any give one process's losses), the
view-sharded forward at V = 4, and the loader's two-process slices.  The
rank bodies are this module's top-level functions, and this module
imports JAX only inside its test functions, so that a spawned rank,
which imports the module for its body, never imports JAX.  Each rank is
joined with its own timeout, so that a hang fails its test.

The train step runs its conv stacks in float64 on both sides, as the
train-parity tests do (tests/test_torch_train.py): in float32 the
gradients of the conv biases ahead of a train-mode BatchNorm, zero in
exact arithmetic, are rounding noise (up to 2.25 here, the JAX package's
3.2), and the summation order of two ranks differs from one process's.
Adam steps an element by about +-LR whatever its gradient's size, so an
element whose gradient is within rounding of 0 moves either way, and two
free trajectories part: after three free steps 6 of 418 tensors (23 with
the empty shard) are outside rtol 2e-4, atol 2e-6 in float64, by up to
2.9e-4, about 3 LR (97 and 99 in float32).  So each step's parameters
are held from the one process's state before it, as the train-parity
tests hold the JAX package's steps.

Tolerances: eval and view-sharded poses rtol 1e-4, atol 1e-3 of one
process (the JAX package's tests/test_parallel.py), the eval poses
within the port's JAX parity bound of the JAX package's DP eval (xyz
0.5 mm, flags and scores 1e-3); DP train losses 1e-5 relative of one
process at each of 3 free steps; the first step's summed gradients 1e-6
relative L2 per tensor (norms floored at 1e-6 of the largest; Adam is
blind to a gradient's scale, so only this sees a sum that is off by the
number of ranks); every parameter and BatchNorm statistic after each of
the 3 steps, each from one process's state before it, rtol 2e-4, atol
2e-6 (the JAX test's bound); against the JAX package's DP step
(float64, jax.enable_x64), each of the 3 steps from that same state
loaded into both packages, the losses 1e-4 relative and every parameter
and BatchNorm statistic after the step rtol 2e-4, atol 2e-6; the stream
against the serial path 1e-5.
"""

import multiprocessing as mp
import os
import traceback

import numpy as np
import pytest
import torch

WORLD = 2
JOIN_TIMEOUT_S = 120
LOSS_KEYS = ("total", "2d_heatmaps", "1d_heatmaps", "bbox", "joint")


class ToyDataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": np.int32(i)}


def _train_steps(trainer, batch, steps=3):
    """The losses (steps, len(LOSS_KEYS)) of `steps` train steps."""
    rows = []
    for _ in range(steps):
        losses = trainer.step(batch)
        rows.append([float(losses[k]) for k in LOSS_KEYS])
    return np.array(rows)


def _state(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _grads(trainer):
    """The last step's gradients, HDN then JLN, as one flat array."""
    return torch.cat([trainer.opt_pose.grad, trainer.opt_joint.grad]).numpy().copy()


def _numpy(tree):
    """A trainer state as numpy copies: pickling a tensor for a spawned
    process moves its storage to shared memory, under any numpy view."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {k: _numpy(v) for k, v in items}
        return out if isinstance(tree, dict) else list(out.values())
    return tree.detach().numpy().copy()


def _optimizer_state(state):
    """A trainer state's (`_numpy(Trainer.state_dict())`) optimizer part
    as flat arrays: both Adams' moments and step counts, the HDN
    accumulator and mini-step."""
    return {"pose/mu": state["pose"]["mu"], "pose/nu": state["pose"]["nu"],
            "pose/count": state["pose"]["count"], "joint/mu": state["joint"]["mu"],
            "joint/nu": state["joint"]["nu"], "joint/count": state["joint"]["count"],
            "acc": state["acc"], "mini_step": state["mini_step"]}


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.as_tensor(tree)


def _port_model(cfg, weights):
    from faster_voxelpose_tpu_torch.models import build_model

    torch.manual_seed(0)
    model = build_model(cfg)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()})
    return model


def _rank_body(rank, job, out_dir):
    import torch.distributed as dist

    from faster_voxelpose_tpu_torch.engine.loader import DataLoader
    from faster_voxelpose_tpu_torch.models.blocks import BatchNorm
    from faster_voxelpose_tpu_torch.parallel import (
        Sharding, make_dp_eval_step, make_dp_train_step, make_mesh, make_view_sharded_forward,
        replicated, shard_batch)

    mesh = make_mesh(WORLD, device="cpu")
    cfg, weights = job["cfg"], job["weights"]
    out = {}
    model = _port_model(cfg, weights)
    eval_step = make_dp_eval_step(cfg, model, mesh)
    ev = shard_batch({"hm": job["eval_hm"], "cams": job["eval_cams"]}, mesh)
    out["eval"] = eval_step(ev["hm"], ev["cams"]).numpy()

    tcfg = job["train_cfg"]
    for name in ("train", "empty"):
        model = _port_model(tcfg, weights)
        trainer = make_dp_train_step(tcfg, model, mesh, compiled=False)
        shard = shard_batch(job[name], mesh)
        first = _train_steps(trainer, shard, steps=1)
        out[f"{name}_grads"] = _grads(trainer)
        out[f"{name}_losses"] = np.concatenate([first, _train_steps(trainer, shard, steps=2)])
        step_losses = []
        for i, before in enumerate(job[f"{name}_states"][:-1]):  # each step from one state
            trainer.load_state_dict(_tensors(before))
            losses = trainer.step(shard)
            step_losses.append([float(losses[k]) for k in LOSS_KEYS])
            for k, v in _state(model).items():
                out[f"{name}_state{i + 1}/{k}"] = v
            for k, v in _optimizer_state(_numpy(trainer.state_dict())).items():
                out[f"{name}_opt_state{i + 1}/{k}"] = v
        out[f"{name}_step_losses"] = np.array(step_losses)
        out[f"{name}_mode_off"] = model.global_sum is None and all(
            m.global_sum is None for m in model.modules() if isinstance(m, BatchNorm))
    try:
        make_dp_train_step(cfg, _port_model(cfg, weights), mesh, compiled=True)
        out["compiled_raises"] = False
    except ValueError:
        out["compiled_raises"] = True

    vcfg = job["view_cfg"]
    forward = make_view_sharded_forward(vcfg, _port_model(vcfg, weights), mesh)
    views = Sharding(mesh, 1)  # (B, V/2, ...) per rank
    out["view"] = forward(views.shard(job["view_hm"]), views.shard(job["view_cams"])).numpy()
    out["replicated"] = replicated(mesh).shard(job["eval_cams"]).numpy()

    loader = DataLoader(ToyDataset(16), 2, shuffle=True, seed=3, process_count=WORLD,
                        process_index=rank)
    orders = []
    for _ in range(2):  # two epochs: each rank's slice of each epoch's order
        mine = [int(i) for b in loader for i in b["idx"]]
        every = [None] * WORLD
        dist.all_gather_object(every, mine)
        orders.append(every)
    out["loader"] = np.array(orders)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def _rank_main(rank, job, out_dir):
    """One rank of the group: init over gloo, run `_rank_body`, write its
    results or its traceback."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method="file://" + os.path.join(out_dir, "init"),
                                world_size=WORLD, rank=rank)
        try:
            _rank_body(rank, job, out_dir)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _train_batch(cfg, B, rng, cams):
    """A training batch of the tiny geometry (tests/test_parallel.py's)."""
    V = cfg.DATASET.CAMERA_NUM
    W, H = cfg.DATASET.HEATMAP_SIZE
    J = cfg.DATASET.NUM_JOINTS
    K = cfg.CAPTURE_SPEC.MAX_PEOPLE
    vx, vy, vz = cfg.CAPTURE_SPEC.VOXELS_PER_AXIS
    roots = rng.uniform(-1200, 1200, (B, K, 3)).astype(np.float32)
    roots[..., 2] = rng.uniform(600, 1000, (B, K))
    return {
        "input_heatmaps": rng.rand(B, V, H, W, J).astype(np.float32) * 0.4,
        "cameras": cams,
        "2d_heatmaps": rng.rand(B, vx, vy).astype(np.float32),
        "1d_heatmaps": rng.rand(B, K, vz).astype(np.float32),
        "index": rng.randint(0, vx * vy, (B, K)).astype(np.float32),
        "bbox": rng.rand(B, K, 2).astype(np.float32) * 0.5 + 0.3,
        "mask": np.tile(np.arange(K) < 2, (B, 1)),
        "roots_3d": roots,
        "num_person": np.full((B,), 2, np.int32),
        "joints_3d": (roots[:, :, None, :] + rng.uniform(-200, 200, (B, K, J, 3))).astype(np.float32),
        "joints_3d_vis": np.ones((B, K, J), np.float32),
    }


def _trajectory(cfg, weights, batch, steps=3):
    """One process's Trainer on the global batch: the losses of `steps`
    steps, the first step's gradients, and the trainer's state before
    each step and after the last."""
    from faster_voxelpose_tpu_torch.engine.trainer import Trainer

    model = _port_model(cfg, weights)
    tr = Trainer(cfg, model, compiled=False)
    states, losses, grads = [_numpy(tr.state_dict())], [], None
    for i in range(steps):
        losses.append(_train_steps(tr, batch, steps=1)[0])
        grads = _grads(tr) if i == 0 else grads
        states.append(_numpy(tr.state_dict()))
    return np.array(losses), grads, states, [n for p in (tr.opt_pose, tr.opt_joint)
                                             for n in _names(model, p)]


def _names(model, opt):
    """(name, size) of an Adam's parameters, in its flat buffer's order."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [(names[id(p)], p.numel()) for p in opt.params]


def _jax_state(jcfg, state, names):
    """A port trainer state (`_numpy(Trainer.state_dict())`) as the JAX
    package's TrainState: the parameters and BatchNorm statistics, both
    Adams' moments and step counts, the HDN accumulator and mini-step.
    `names`: (name, size) of the Adams' parameters, in their flat
    buffers' order."""
    import jax.numpy as jnp

    from faster_voxelpose_tpu.engine.trainer import create_train_state
    from faster_voxelpose_tpu_torch.weights import to_jax_variables
    from tests.test_torch_modules import nest

    model = state["model"]
    js = create_train_state(jcfg, nest(to_jax_variables(_tensors(model))))

    def tree(flat, prefix):
        """An Adam's flat buffer as its partition's parameter tree."""
        mine = [(n, size) for n, size in names if n.startswith(prefix)]
        bounds = np.cumsum([0] + [size for _, size in mine])
        return nest(to_jax_variables({n: torch.as_tensor(flat[a:b].reshape(model[n].shape))
                                      for (n, _), a, b in zip(mine, bounds[:-1], bounds[1:])
                                      }))["params"]

    def adam(old, opt, prefix):
        return old._replace(count=jnp.asarray(opt["count"], old.count.dtype),
                            mu=tree(opt["mu"], prefix), nu=tree(opt["nu"], prefix))

    pose, joint = js.opt_state_pose, js.opt_state_joint
    pose = pose._replace(
        inner_opt_state=(adam(pose.inner_opt_state[0], state["pose"], "hdn."),
                         *pose.inner_opt_state[1:]),
        acc_grads=tree(state["acc"], "hdn."),
        mini_step=jnp.asarray(state["mini_step"], pose.mini_step.dtype),
        gradient_step=jnp.asarray(state["pose"]["count"], pose.gradient_step.dtype))
    joint = (adam(joint[0], state["joint"], "jln."), *joint[1:])
    return js._replace(opt_state_pose=pose, opt_state_joint=joint)


def _port_state(jstate):
    """A JAX TrainState's parameters and BatchNorm statistics under the
    port's names."""
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    return {k: v.numpy() for k, v in from_jax_variables(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}).items()}


def _port_optimizer_state(jstate, names):
    """A JAX TrainState's optimizer part in `_optimizer_state`'s layout:
    each tree flattened in the port's flat buffers' order `names`."""
    from faster_voxelpose_tpu_torch.weights import from_jax_variables

    def flat(tree, prefix):
        sd = from_jax_variables({"params": tree})
        return np.concatenate([sd[n].numpy().ravel() for n, _ in names if n.startswith(prefix)])

    pose, joint = jstate.opt_state_pose, jstate.opt_state_joint[0]
    adam = pose.inner_opt_state[0]
    return {"pose/mu": flat(adam.mu, "hdn."), "pose/nu": flat(adam.nu, "hdn."),
            "pose/count": np.asarray(adam.count), "joint/mu": flat(joint.mu, "jln."),
            "joint/nu": flat(joint.nu, "jln."), "joint/count": np.asarray(joint.count),
            "acc": flat(pose.acc_grads, "hdn."), "mini_step": np.asarray(pose.mini_step)}


def _roots_at_proposals(cfg, weights, batch, people=2):
    """Move each sample's first GT people (roots and joints) to its first
    proposals in train mode, so that every sample has proposals matched
    to people (the JLN's loss is then on every rank's shard)."""
    model = _port_model(cfg, weights)
    t = {k: torch.as_tensor(v) for k, v in batch.items()}
    meta = {k: t[k] for k in ("roots_3d", "bbox", "joints_3d", "joints_3d_vis")}
    meta["num_person"] = torch.zeros_like(t["num_person"])
    with torch.no_grad():
        pc = model(t["input_heatmaps"], t["cameras"], meta=meta, train=True).proposal_centers
    shift = np.zeros_like(batch["roots_3d"])
    shift[:, :people] = pc[:, :people, :3].numpy() - batch["roots_3d"][:, :people]
    batch["roots_3d"] = (batch["roots_3d"] + shift).astype(np.float32)
    batch["joints_3d"] = (batch["joints_3d"] + shift[:, :, None]).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Compute one process's train trajectories, spawn the two ranks,
    compute the one-process eval readings and the JAX package's while
    they run, join them; returns (inputs, the ranks' results, readings)."""
    import jax

    from __graft_entry__ import _example_cameras
    from faster_voxelpose_tpu.engine.trainer import create_train_state, make_train_step
    from faster_voxelpose_tpu.models.faster_voxelpose import build_model as jax_build
    from faster_voxelpose_tpu.parallel import mesh as jmesh
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.weights import from_jax_variables, to_jax_variables
    from tests.test_torch_geometry import tiny_configs
    from tests.test_torch_model import _frames
    from tests.test_torch_modules import nest, randomize

    # every slot valid (no score on a threshold), and a 2100 mm person box,
    # which keeps every crop origin off a rounding tie (tests/test_torch_model.py)
    every = dict(CAPTURE_SPEC__MIN_SCORE=-1e9, INDIVIDUAL_SPEC__SPACE_SIZE=(2100.0,) * 3)
    jcfg, cfg = tiny_configs(**every)
    jcfg64, cfg64 = tiny_configs(NETWORK__COMPUTE_DTYPE="float64", **every)
    _, vcfg = tiny_configs(DATASET__CAMERA_NUM=4, **every)
    B, V = 8, cfg.DATASET.CAMERA_NUM
    W, H = cfg.DATASET.HEATMAP_SIZE
    J = cfg.DATASET.NUM_JOINTS
    eval_hm = _frames(V, H, W, J, B, seed=0)  # blobs: no near-tie among the proposals
    eval_cams = _example_cameras(B, V)
    jmodel = jax_build(jcfg)
    # fan-in scaled weights from the port's module tree (a flax init takes
    # 35 s here), the size head tamed (tests/test_torch_datasets.py)
    torch.manual_seed(0)
    model = build_model(cfg)
    flat = randomize(nest(to_jax_variables(model.state_dict())), seed=5)
    flat["params/hdn/center_net/size_out/kernel"] *= 0.01
    flat["params/hdn/center_net/size_out/bias"] = np.array([0.6, 0.7], np.float32)
    weights = {k: v.numpy().copy() for k, v in from_jax_variables(flat, model).items()}
    variables = nest(flat)
    train = _roots_at_proposals(cfg64, weights,
                                _train_batch(cfg, B, np.random.RandomState(3), eval_cams))
    empty = {k: v.copy() for k, v in train.items()}
    empty["num_person"][B // 2:] = 0  # rank 1's shard: no person
    empty["mask"][B // 2:] = False
    ref = {}
    job = dict(cfg=cfg, train_cfg=cfg64, weights=weights, eval_hm=eval_hm, eval_cams=eval_cams,
               train=train, empty=empty, view_cfg=vcfg,
               view_hm=_frames(4, H, W, J, 2, seed=1),
               view_cams=_example_cameras(2, 4))
    for name in ("train", "empty"):
        (ref[f"{name}_losses"], ref[f"{name}_grads"], states,
         ref["grad_names"]) = _trajectory(cfg64, weights, job[name])
        job[f"{name}_states"] = states
        ref[f"{name}_states"] = [s["model"] for s in states]

    out_dir = str(tmp_path_factory.mktemp("dp"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, job, out_dir)) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        single = _port_model(cfg, weights)
        with torch.no_grad():
            ref["eval"] = single(torch.as_tensor(eval_hm), torch.as_tensor(eval_cams)).fused_poses.numpy()
            ref["view"] = _port_model(vcfg, weights)(
                torch.as_tensor(job["view_hm"]), torch.as_tensor(job["view_cams"])).fused_poses.numpy()
        # the JAX package's DP steps over 2 of its 8 virtual devices
        mesh = jmesh.make_mesh(WORLD)
        ref["jax_eval"] = np.asarray(jmesh.make_dp_eval_step(jcfg, jmodel, mesh)(
            jax.device_put(variables, jmesh.replicated(mesh)), eval_hm, eval_cams))
        # each of the 3 steps from the port's one-process state before it,
        # by the JAX package's DP step and its one-process step
        with jax.enable_x64(True):
            jmodel64 = jax_build(jcfg64)
            step = jmesh.make_dp_train_step(jcfg64, jmodel64, mesh)
            one = jax.jit(make_train_step(jcfg64, jmodel64))
            for name in ("train", "empty"):
                sharded = jmesh.shard_batch(job[name], mesh, jcfg64.PARALLEL.MESH_AXIS_NAME)
                jax_losses = []
                for i, before in enumerate(job[f"{name}_states"][:-1]):
                    state = _jax_state(jcfg64, before, ref["grad_names"])
                    if i == 0:  # the first state converted is create_train_state's
                        fresh = create_train_state(jcfg64, variables)
                        assert jax.tree_util.tree_structure(state) \
                            == jax.tree_util.tree_structure(fresh)
                        assert all(np.array_equal(a, b) for a, b in zip(
                            jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(fresh)))
                    after, jl = step(jax.device_put(state, jmesh.replicated(mesh)), sharded, None)
                    jax_losses.append([float(jl[k]) for k in LOSS_KEYS])
                    ref[f"jax_{name}_state{i + 1}"] = _port_state(after)
                    ref[f"jax_{name}_opt{i + 1}"] = _port_optimizer_state(after, ref["grad_names"])
                    after1 = one(state, job[name])[0]
                    ref[f"jax1_{name}_state{i + 1}"] = _port_state(after1)
                    ref[f"jax1_{name}_opt{i + 1}"] = _port_optimizer_state(after1, ref["grad_names"])
                ref[f"jax_{name}_losses"] = np.array(jax_losses)
    finally:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    errors = [open(os.path.join(out_dir, f"rank{r}.err")).read() for r in range(WORLD)
              if os.path.exists(os.path.join(out_dir, f"rank{r}.err"))]
    assert not alive, f"ranks {[procs.index(p) for p in alive]} still ran after {JOIN_TIMEOUT_S} s"
    assert not errors and all(p.exitcode == 0 for p in procs), \
        f"exit codes {[p.exitcode for p in procs]}:\n" + "\n".join(errors)
    ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(WORLD)]
    return job, ranks, ref


def _state_after(rank, name, step):
    prefix = f"{name}_state{step}/"
    return {k[len(prefix):]: v for k, v in rank.items() if k.startswith(prefix)}


def test_dp_eval_matches_one_process_and_jax(group):
    """Against the port's one process at the JAX test's bound; against the
    JAX package's DP eval step at the port's bound for the JAX package's
    poses (tests/test_torch_model.py): xyz within 0.5 mm (measured 0.031),
    flags and scores 1e-3."""
    job, ranks, ref = group
    for r in ranks:
        assert r["eval"].shape == ref["eval"].shape == ref["jax_eval"].shape
        np.testing.assert_allclose(r["eval"], ref["eval"], rtol=1e-4, atol=1e-3)
        assert np.max(np.abs(r["eval"][..., :3] - ref["jax_eval"][..., :3])) <= 0.5
        np.testing.assert_allclose(r["eval"][..., 3:], ref["jax_eval"][..., 3:], atol=1e-3)


@pytest.mark.parametrize("name", ["train", "empty"])
def test_dp_train_matches_one_process(group, name):
    """Three DP steps over two ranks against three steps of one process
    on the global batch: the losses at every step, the first step's
    summed gradients, and every parameter and BatchNorm statistic after
    each step taken from one process's state before it; the two ranks
    hold one state and the global-sum mode is off after the step.
    'empty': rank 1's shard holds no person."""
    job, ranks, ref = group
    if name == "empty":
        assert (job["empty"]["num_person"][4:] == 0).all()
        assert (job["empty"]["num_person"][:4] > 0).all()
    assert (ref[f"{name}_losses"][:, LOSS_KEYS.index("joint")] > 0).all()  # proposals matched
    for r in ranks:
        np.testing.assert_allclose(r[f"{name}_losses"], ref[f"{name}_losses"], rtol=1e-5)
        assert r[f"{name}_mode_off"], "the global-sum mode stayed on after the step"
    got, want = ranks[0][f"{name}_grads"], ref[f"{name}_grads"]
    bounds = np.cumsum([0] + [n for _, n in ref["grad_names"]])
    norms = [np.linalg.norm(want[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
    for (param, _), a, b, norm in zip(ref["grad_names"], bounds[:-1], bounds[1:], norms):
        rel = np.linalg.norm(got[a:b] - want[a:b]) / max(norm, 1e-6 * max(norms))
        assert rel <= 1e-6, (param, rel)
    for step in (1, 2, 3):
        states = [_state_after(r, name, step) for r in ranks]
        want = ref[f"{name}_states"][step]
        assert sorted(states[0]) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(states[0][k], states[1][k], err_msg=k)
            np.testing.assert_allclose(states[0][k], v, rtol=2e-4, atol=2e-6,
                                       err_msg=f"step {step}: {k}")


def _off(a, b):
    """Where `a` is outside rtol 2e-4, atol 2e-6 of `b`, per key."""
    return {k: ~np.isclose(a[k], v, rtol=2e-4, atol=2e-6) for k, v in b.items()}


@pytest.mark.parametrize("name", ["train", "empty"])
def test_dp_train_matches_jax_dp_step(group, name):
    """The DP step against the JAX package's DP step on the same batch,
    each of 3 steps from one state (the port's one-process state before
    it, loaded into both packages), beside the two packages' one-process
    steps from that state (the port's Trainer, the JAX package's jitted
    train step):

    * the losses 1e-4 relative (the first free step starts from that
      state too, so its losses are held as well);
    * every parameter and BatchNorm statistic 1e-3 relative L2 per tensor
      (norms floored at 1e-6 of the largest), tests/test_torch_train.py's
      bound for the one-process steps;
    * elementwise (rtol 2e-4, atol 2e-6), the two DP steps part only
      where the one-process steps already part, or where the JAX
      package's DP step parts from its own one-process step: Adam's
      sign-like first steps move an element whose gradient is within
      rounding of 0 by +-LR either way;
    * both Adams' moments and the HDN accumulator (at the first step the
      summed gradients themselves) per tensor no further from the JAX DP
      step's, in relative L2, than the port's one-process step's are
      from the JAX one-process step's, plus 1e-4: the port's DP step adds
      no gap of its own to the packages' (the DP steps' HDN accumulators,
      the summed gradients, part by 1.68e-3 at the first step; the
      largest excess read 1.08e-5, the JLN's first moment at step 2 with
      the empty shard);
    * the step counts and the mini-step exact.

    'empty': rank 1's shard holds no person."""
    from tests.test_torch_train import _rel_l2

    job, ranks, ref = group
    names = ref["grad_names"]
    want = ref[f"jax_{name}_losses"]
    assert want.shape == (3, len(LOSS_KEYS))
    np.testing.assert_allclose(ranks[0][f"{name}_losses"][0], want[0], rtol=1e-4)
    np.testing.assert_allclose(ranks[0][f"{name}_step_losses"], want, rtol=1e-4)

    def per_tensor(key, flat):
        mine = [(n, size) for n, size in names
                if n.startswith("jln." if "joint" in key else "hdn.")]
        bounds = np.cumsum([0] + [size for _, size in mine])
        return {n: flat[a:b] for (n, _), a, b in zip(mine, bounds[:-1], bounds[1:])}

    worst, excess = {}, {}
    for step in (1, 2, 3):
        got, jax_dp = _state_after(ranks[0], name, step), ref[f"jax_{name}_state{step}"]
        one, jax_one = ref[f"{name}_states"][step], ref[f"jax1_{name}_state{step}"]
        assert sorted(got) == sorted(jax_dp) == sorted(jax_one)
        worst[step] = max(_rel_l2(got, jax_dp, 1e-6).values())
        off, one_off, jax_off = _off(got, jax_dp), _off(one, jax_one), _off(jax_dp, jax_one)
        unexplained = {k: int((m & ~one_off[k] & ~jax_off[k]).sum()) for k, m in off.items()}
        assert not any(unexplained.values()), (step, {k: v for k, v in unexplained.items() if v})

        opt, jax_opt = _state_after(ranks[0], f"{name}_opt", step), ref[f"jax_{name}_opt{step}"]
        one_opt = _optimizer_state(job[f"{name}_states"][step])
        jax_one_opt = ref[f"jax1_{name}_opt{step}"]
        for key in ("pose/mu", "pose/nu", "acc", "joint/mu", "joint/nu"):
            dp = _rel_l2(per_tensor(key, opt[key]), per_tensor(key, jax_opt[key]), 1e-6)
            single = _rel_l2(per_tensor(key, one_opt[key]), per_tensor(key, jax_one_opt[key]), 1e-6)
            excess[step, key] = max(dp[k] - single[k] for k in dp)
        for key in ("pose/count", "joint/count", "mini_step"):
            assert int(opt[key]) == int(jax_opt[key]) == int(one_opt[key]), (step, key)
    assert all(v <= 1e-3 for v in worst.values()), worst
    assert all(v <= 1e-4 for v in excess.values()), {k: v for k, v in excess.items() if v > 1e-4}


def test_view_sharded_forward_matches_one_device(group):
    job, ranks, ref = group
    for r in ranks:
        np.testing.assert_allclose(r["view"], ref["view"], rtol=1e-4, atol=1e-3)


def test_shardings_and_gloo_capture(group):
    """`replicated` gives every rank the whole array; a gloo step cannot
    be captured into a CUDA graph, so compiled=True raises."""
    job, ranks, ref = group
    for r in ranks:
        np.testing.assert_array_equal(r["replicated"], job["eval_cams"])
        assert r["compiled_raises"]


def test_loader_process_slices_cover_the_epoch(group):
    """Two processes' DataLoader slices of one seeded order: each epoch's
    union is every record exactly once, and both ranks agree on it."""
    job, ranks, ref = group
    np.testing.assert_array_equal(ranks[0]["loader"], ranks[1]["loader"])
    for epoch in ranks[0]["loader"]:
        assert sorted(epoch.ravel().tolist()) == list(range(16))
    assert not np.array_equal(ranks[0]["loader"][0], ranks[0]["loader"][1])  # reshuffled


def test_make_mesh_needs_a_process_group():
    from faster_voxelpose_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh()


def test_make_mesh_defaults_to_the_card_under_gloo(tmp_path):
    """Under gloo, as under NCCL, a mesh with no device named is on the
    card (rank % device count), and raises where there is none: the CPU
    is a mesh's device only where the caller names it."""
    import torch.distributed as dist

    from faster_voxelpose_tpu_torch.parallel import make_mesh

    dist.init_process_group("gloo", init_method="file://" + str(tmp_path / "init"),
                            world_size=1, rank=0)
    try:
        assert make_mesh(device="cpu").device == torch.device("cpu")
        if torch.cuda.is_available():
            assert make_mesh().device == torch.device("cuda", 0)
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                make_mesh()
    finally:
        dist.destroy_process_group()


def test_pipelined_stream_matches_serial():
    """Backbone -> fusion as two stages on ('cpu', 'cpu'): frame t's push
    returns frame t-1's poses and centres, equal to the serial path; the
    first push returns None, flush() drains the last frame and then
    returns None."""
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.models.resnet import build_backbone, images_to_heatmaps
    from faster_voxelpose_tpu_torch.parallel import PipelinedStream
    from tests.test_torch_geometry import tiny_configs, tiny_rig

    _, cfg = tiny_configs(RESNET__NUM_LAYERS=18, RESNET__NUM_DECONV_FILTERS=(32, 32, 32))
    torch.manual_seed(0)
    model, backbone = build_model(cfg), build_backbone(cfg)
    V = cfg.DATASET.CAMERA_NUM
    iw, ih = cfg.DATASET.IMAGE_SIZE
    rng = np.random.RandomState(7)
    frames = [rng.rand(V, ih, iw, 3).astype(np.float32),
              rng.randint(0, 256, (V, ih, iw, 3)).astype(np.uint8),
              rng.rand(V, ih, iw, 3).astype(np.float32)]
    cams = tiny_rig(V)
    serial = []
    with torch.no_grad():
        for f in frames:
            hm = images_to_heatmaps(backbone, torch.as_tensor(f)[None], cfg.DATASET.COLOR_RGB)
            out = model(hm, torch.as_tensor(cams)[None])
            serial.append((out.fused_poses[0].numpy(), out.proposal_centers[0].numpy()))

    stream = PipelinedStream(cfg, model, backbone, cams, devices=("cpu", "cpu"))
    assert stream.push(frames[0]) is None
    outs = [stream.push(frames[1]), stream.push(frames[2]), stream.flush()]
    assert stream.flush() is None
    for t, (got, want) in enumerate(zip(outs, serial)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=f"frame {t}")
    if not torch.cuda.is_available():  # the default devices are the cards
        with pytest.raises(RuntimeError, match="CUDA"):
            PipelinedStream(cfg, model, backbone, cams)
