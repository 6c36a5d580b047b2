"""The port's entry point and multi-rank dry run (counterpart of the JAX
repo's `__graft_entry__.py`): `entry()`, the tiny model's forward, and
`dryrun_multichip(n)`, every scale-out mode of `parallel/mesh.py` over
`n` ranks against one process:

    python3 -m faster_voxelpose_tpu_torch.tools.dryrun_multichip [n] [--device cpu]

prints `entry ok: (1, 4, 15, 5)`, then one line per check of the dry
run.  The ranks are spawned processes in a torch.distributed gloo group
(a `file://` rendezvous in a temporary directory), on the card
`rank % device_count` or, with `--device cpu`, on the CPU; with no card
and no `--device cpu` it raises.  The checks and their bounds are the
JAX file's:

* the data-parallel train step over `n` ranks (one sample each) against
  one process's step on the same global batch of `n`, from one state:
  every parameter within 1e-4;
* the view-sharded forward over the first `vdev` ranks, `vdev` the
  largest divisor of the camera count (3) that is at most `n`, on a
  sub-group of the world (`dist.new_group`), against one process's
  forward: fused poses within 1e-2 mm;
* the data-parallel eval step over `n` ranks against the same forward:
  within 1e-2 mm;
* `PipelinedStream` with a ResNet-18 backbone over 2 frames against the
  serial backbone -> fusion path: within 1e-2 mm (on the card the two
  stages run on two CUDA streams, on two cards where there are two).

The train step runs in three variants.  The profile's own bf16 conv
stacks (the JAX file's dtype) are printed, recorded, not judged.  Float64
conv stacks over float32 parameters, the DP path as
tests/test_torch_parallel.py runs it, are held on the summed gradients
(the HDN's accumulated and the JLN's, within 1e-6 relative L2) and the
BatchNorm statistics (rtol 2e-4, atol 2e-6), that test's bounds.  The
parameters' 1e-4 is held in float64 throughout, the parameters too.
Adam's first step moves an element by LR * g / (|g| + eps), about +-LR
(1e-4) wherever |g| is well above eps (1e-8).  The gradients of the conv
biases ahead of a train-mode BatchNorm are zero in exact arithmetic;
their rounding noise is far above eps in bf16, and with float32
parameters each rank's share is rounded to float32 before the ranks'
shares are summed, which leaves noise above eps too, where one process's
float64 sum leaves noise below it.  Two such steps then part by up to
2 LR, or by LR and a little more.  In float64 throughout the noise stays
below eps on both sides.  The unjudged readings are printed beside the
judged ones, and where a variant's parameters miss 1e-4 its worst
tensors are printed with the gradient magnitudes there, one process's
and the ranks' sum, against eps.

With the seeded weights the JLN takes no step at n <= 4 (no proposal
reaches MIN_SCORE, so its loss is 0) and the HDN's Adam steps every
ACCUMULATION_STEPS (4) calls, so after one step no parameter has moved;
at n = 8 the JLN steps.  No slot of the forward is valid at MIN_SCORE
0.1, so the poses compared there are the invalid slots' zeros and
scores; the view-sharded and DP eval checks therefore run once more at
MIN_SCORE -1e9, where every slot is valid and the poses carry the JLN's
output (row 2 of the kernel table), under the same 1e-2 mm.
"""

from __future__ import annotations

import argparse
import copy
import multiprocessing as mp
import os
import pickle
import shutil
import sys
import tempfile
import traceback
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..device import DeviceLike, pin_float32, resolve_device
from ..engine.trainer import EPS, Trainer
from ..geometry import ring_rig
from ..models import build_backbone, build_model
from ..models.resnet import images_to_heatmaps
from ..ops import sampling_kernels as sk
from ..parallel import (PipelinedStream, Sharding, make_dp_eval_step, make_dp_train_step,
                        make_mesh, make_view_sharded_forward, shard_batch)
from .bench import seeded

JOIN_TIMEOUT_S = 300
TRAIN_BOUND = 1e-4  # params max|d|, the JAX file's
GRAD_BOUND = 1e-6  # summed gradients' relative L2, tests/test_torch_parallel.py's
F64_CONV = "float64 conv stacks"  # judged on the summed gradients and BatchNorm statistics
F64_ALL = "float64 throughout"  # judged on the parameters
ALL_VALID_SCORE = -1e9  # MIN_SCORE at which every proposal slot is valid
POSE_BOUND_MM = 1e-2  # fused poses max|d|, the JAX file's
PIPELINE_FRAMES = 2


def tiny_config() -> Config:
    """Small static geometry for fast runs (the code paths of the full
    Panoptic profile, scaled down): the JAX repo's
    `__graft_entry__._tiny_config`, built from the port's Config."""
    cfg = Config()
    cfg.DATASET.ORI_IMAGE_SIZE = (320, 240)
    cfg.DATASET.IMAGE_SIZE = (160, 128)
    cfg.DATASET.HEATMAP_SIZE = (40, 32)
    cfg.DATASET.NUM_JOINTS = 15
    cfg.DATASET.CAMERA_NUM = 3
    cfg.CAPTURE_SPEC.SPACE_SIZE = (4000.0, 4000.0, 1600.0)
    cfg.CAPTURE_SPEC.SPACE_CENTER = (0.0, 0.0, 800.0)
    cfg.CAPTURE_SPEC.VOXELS_PER_AXIS = (16, 16, 8)
    cfg.CAPTURE_SPEC.MAX_PEOPLE = 4
    cfg.INDIVIDUAL_SPEC.VOXELS_PER_AXIS = (16, 16, 16)
    cfg.CAPTURE_SPEC.__post_init__()
    cfg.INDIVIDUAL_SPEC.__post_init__()
    cfg.DATASET.__post_init__()
    return cfg


def _forward(model, heatmaps: torch.Tensor, cams: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return model(heatmaps, cams).fused_poses


def entry(device: DeviceLike = None):
    """(fn, (model, heatmaps, cameras)): the tiny model's eval-mode forward
    `fn(model, heatmaps, cameras)` -> fused poses (1, 4, 15, 5), its
    weights drawn from torch's generator seeded 0, heatmaps
    (1, 3, 32, 40, 15) from `np.random.RandomState(0)` and the ring rig,
    on `device` (default: the card; raises where there is none)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        pin_float32()
    cfg = tiny_config()
    model = seeded(build_model, cfg, 0, dev)
    B, V = 1, cfg.DATASET.CAMERA_NUM
    W, H = cfg.DATASET.HEATMAP_SIZE
    J = cfg.DATASET.NUM_JOINTS
    heatmaps = np.random.RandomState(0).rand(B, V, H, W, J).astype(np.float32)
    cams = ring_rig(B, V)
    return _forward, (model, torch.as_tensor(heatmaps).to(dev), torch.as_tensor(cams).to(dev))


def view_shards(n_devices: int, n_views: int) -> int:
    """The largest divisor of the camera count that is at most n_devices:
    how many ranks the view-sharded forward spans."""
    return max(d for d in range(1, min(n_views, n_devices) + 1) if n_views % d == 0)


def _global_batch(cfg: Config, B: int, rng: np.random.RandomState) -> Dict[str, np.ndarray]:
    """The dry run's training batch of B samples, drawn in the JAX file's
    order."""
    V = cfg.DATASET.CAMERA_NUM
    W, H = cfg.DATASET.HEATMAP_SIZE
    J = cfg.DATASET.NUM_JOINTS
    K = cfg.CAPTURE_SPEC.MAX_PEOPLE
    vx, vy, vz = cfg.CAPTURE_SPEC.VOXELS_PER_AXIS
    return {
        "input_heatmaps": rng.rand(B, V, H, W, J).astype(np.float32),
        "cameras": ring_rig(B, V),
        "2d_heatmaps": rng.rand(B, vx, vy).astype(np.float32),
        "1d_heatmaps": rng.rand(B, K, vz).astype(np.float32),
        "index": rng.randint(0, vx * vy, (B, K)).astype(np.float32),
        "bbox": rng.rand(B, K, 2).astype(np.float32),
        "mask": np.tile(np.arange(K) < 2, (B, 1)),
        "roots_3d": rng.uniform(-1000, 1000, (B, K, 3)).astype(np.float32),
        "num_person": np.full((B,), 2, np.int32),
        "joints_3d": rng.uniform(-1000, 1000, (B, K, J, 3)).astype(np.float32),
        "joints_3d_vis": np.ones((B, K, J), np.float32),
    }


def _model(cfg: Config, weights: Dict[str, np.ndarray], device,
           float64_params: bool = False) -> torch.nn.Module:
    model = build_model(cfg)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()})
    if float64_params:  # the buffers (grids, BatchNorm statistics) stay float32
        for p in model.parameters():
            p.data = p.data.double()
    return model.to(device)


def _params(model) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy() for k, v in model.named_parameters()}


def _step_reading(trainer, losses) -> dict:
    """A train step's total loss, parameters, buffers (the BatchNorm
    statistics) and gradients: the HDN's accumulated one and the JLN's,
    each the global batch's (summed over the ranks)."""
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    return {"total": float(losses["total"]), "params": _params(trainer.model),
            "stats": {k: v.cpu().numpy().copy() for k, v in trainer.model.named_buffers()},
            "grad": torch.cat([trainer.acc, trainer.opt_joint.grad]).cpu().numpy(),
            "grad_names": [names[id(p)]
                           for p in trainer.opt_pose.params + trainer.opt_joint.params]}


def _train_variants(cfg: Config) -> Dict[str, tuple]:
    """The train check's variants, name -> (config, float64 parameters):
    the profile's own dtype (recorded), float64 conv stacks over float32
    parameters (judged on the gradients and statistics), and float64
    throughout, the parameters too, so that the gradients are stored and
    summed over the ranks in float64 (judged on the parameters)."""
    f64 = copy.deepcopy(cfg)
    f64.NETWORK.COMPUTE_DTYPE = "float64"
    return {f"{cfg.NETWORK.COMPUTE_DTYPE} conv stacks": (cfg, False),
            F64_CONV: (f64, False), F64_ALL: (f64, True)}


def _all_valid(cfg: Config) -> Config:
    """`cfg` with MIN_SCORE so low that every proposal slot is valid."""
    out = copy.deepcopy(cfg)
    out.CAPTURE_SPEC.MIN_SCORE = ALL_VALID_SCORE
    return out


def _rank_body(rank: int, world: int, job: dict) -> dict:
    """One rank's part of every check: the DP train step (each variant), the
    view-sharded forward on the sub-group of the first `vdev` ranks, and
    the DP eval step."""
    cfg, weights, batch, dev = job["cfg"], job["weights"], job["batch"], job["device"]
    mesh = make_mesh(world, device=dev)
    out = {"device": str(mesh.device)}
    sk.reset_launch_counts()
    for name, (tcfg, float64_params) in _train_variants(cfg).items():
        model = _model(tcfg, weights, mesh.device, float64_params)
        trainer = make_dp_train_step(tcfg, model, mesh, compiled=False)
        out[f"train/{name}"] = _step_reading(trainer, trainer.step(shard_batch(batch, mesh)))

    # every rank takes part in new_group, only its members in the forward;
    # each forward at the JAX file's MIN_SCORE and with every slot valid
    vdev = job["vdev"]
    group = dist.new_group(list(range(vdev)))
    vmesh = make_mesh(vdev, device=dev, group=group) if rank < vdev else None
    shard = shard_batch({"hm": batch["input_heatmaps"], "cams": batch["cameras"]}, mesh)
    for key, fcfg in (("", cfg), ("/all valid", _all_valid(cfg))):
        model = _model(fcfg, weights, mesh.device)
        if vmesh is not None:
            forward = make_view_sharded_forward(fcfg, model, vmesh)
            views = Sharding(vmesh, 1)
            out["view" + key] = forward(views.shard(batch["input_heatmaps"]),
                                        views.shard(batch["cameras"])).cpu().numpy()
        eval_step = make_dp_eval_step(fcfg, model, mesh)
        out["eval" + key] = eval_step(shard["hm"], shard["cams"]).cpu().numpy()
    out["launches"] = sk.launch_counts()
    return out


def _rank_main(rank: int, world: int, job: dict, out_dir: str) -> None:
    """One rank: join the gloo group, run `_rank_body`, write its results
    or its traceback to `out_dir`."""
    try:
        if job["device"] == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
            pin_float32()
        dist.init_process_group("gloo", init_method="file://" + os.path.join(out_dir, "init"),
                                world_size=world, rank=rank)
        try:
            out = _rank_body(rank, world, job)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _spawn(world: int, job: dict, out_dir: str):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, job, out_dir)) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join(procs, out_dir: str) -> list:
    """Each rank joined with its own timeout; a rank's traceback raised
    here; the ranks' results in rank order."""
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    alive = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = []
    for r in range(len(procs)):
        path = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    if errors:
        raise RuntimeError("dryrun_multichip: a rank failed\n" + "\n".join(errors))
    if alive or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"dryrun_multichip: ranks {alive} still ran after {JOIN_TIMEOUT_S} s; "
                           f"exit codes {[p.exitcode for p in procs]}")
    ranks = []
    for r in range(len(procs)):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def _max_gap(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> float:
    if sorted(got) != sorted(want):
        raise AssertionError("dryrun_multichip: the ranks hold other tensors than one process")
    return max(float(np.max(np.abs(got[k].astype(np.float64) - want[k]))) for k in want)


def _train_gaps(ranks: list, one: dict) -> dict:
    """The ranks' train-step readings against one process's: parameters
    and buffers max|d|, the buffers within rtol 2e-4 / atol 2e-6, the
    gradients' relative L2."""
    grad = max(float(np.linalg.norm(r["grad"] - one["grad"])) for r in ranks)
    return {"params": max(_max_gap(r["params"], one["params"]) for r in ranks),
            "stats": max(_max_gap(r["stats"], one["stats"]) for r in ranks),
            "stats_within": all(np.allclose(r["stats"][k], v, rtol=2e-4, atol=2e-6)
                                for r in ranks for k, v in one["stats"].items()),
            "grad": grad / max(float(np.linalg.norm(one["grad"])), 1e-30)}


def _over_bound(rank: dict, one: dict, top: int = 3) -> str:
    """The tensors with elements that part by TRAIN_BOUND or more, worst
    first: how many elements, the largest gap, and the largest gradient
    magnitude there, one process's and the ranks' sum, against Adam's
    eps."""
    grads, o = {}, 0
    for name in one["grad_names"]:
        n = one["params"][name].size
        grads[name] = (one["grad"][o:o + n], rank["grad"][o:o + n])
        o += n
    rows = []
    for name, want in one["params"].items():
        gap = np.abs(rank["params"][name].astype(np.float64) - want).ravel()
        over = gap >= TRAIN_BOUND
        if over.any():
            g1, gn = (np.abs(g[over]).max() for g in grads[name])
            rows.append((gap.max(), f"{name} {over.sum()} of {gap.size} by up to {gap.max():.4e}, "
                                    f"|g| {g1:.3g} (one process) and {gn:.3g} (ranks)"))
    rows.sort(reverse=True)
    return f"{len(rows)} tensors" + "".join(f"; {r}" for _, r in rows[:top])


def _check(ok: bool, message: str) -> None:
    if not ok:
        raise AssertionError(message)


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> dict:
    """Every scale-out mode over `n_devices` gloo ranks against one
    process, at the JAX file's bounds (the module docstring); prints one
    line per check and returns the readings.  `device`: None for the
    cards (raises where there is none), 'cpu' for ranks on the CPU."""
    dev = resolve_device(device)
    on_cpu = dev.type == "cpu"
    if not on_cpu:
        pin_float32()
    cfg = tiny_config()
    B, V = n_devices, cfg.DATASET.CAMERA_NUM  # one sample per rank
    rng = np.random.RandomState(0)
    batch = _global_batch(cfg, B, rng)
    weights = {k: v.numpy() for k, v in seeded(build_model, cfg, 0, "cpu").state_dict().items()}
    vdev = view_shards(n_devices, V)
    job = {"cfg": cfg, "weights": weights, "batch": batch, "vdev": vdev,
           "device": "cpu" if on_cpu else None}

    out_dir = tempfile.mkdtemp(prefix="dryrun_multichip_")
    launches: Dict[str, int] = {}
    try:
        procs = _spawn(n_devices, job, out_dir)
        try:
            # one process's readings while the ranks run
            single = {}
            sk.reset_launch_counts()
            for name, (tcfg, float64_params) in _train_variants(cfg).items():
                trainer = Trainer(tcfg, _model(tcfg, weights, dev, float64_params),
                                  compiled=False)
                single[name] = _step_reading(trainer, trainer.step(batch))
            hm = torch.as_tensor(batch["input_heatmaps"]).to(dev)
            cams = torch.as_tensor(batch["cameras"]).to(dev)
            ref_all = _forward(_model(_all_valid(cfg), weights, dev), hm, cams).cpu().numpy()
            model = _model(cfg, weights, dev)
            ref_poses = _forward(model, hm, cams).cpu().numpy()
            launches = sk.launch_counts()
        finally:
            ranks = _join(procs, out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v

    gaps = {t: _train_gaps([r[f"train/{t}"] for r in ranks], single[t]) for t in single}
    _check(all(np.isfinite(r[f"train/{t}"]["total"]) for r in ranks for t in single),
           "non-finite training loss in dry run")
    total = ranks[0][f"train/{F64_ALL}"]["total"]
    max_dev, g = gaps[F64_ALL]["params"], gaps[F64_CONV]
    _check(max_dev < TRAIN_BOUND, f"dp-train params deviate from single-device: {max_dev}")
    _check(g["grad"] <= GRAD_BOUND and g["stats_within"],
           f"dp-train gradients or BatchNorm statistics deviate from single-device ({F64_CONV}): "
           f"{g}")
    print(f"dryrun_multichip({n_devices}) ok: total loss {total:.4f}; "
          f"dp-vs-single param parity max|Δ|={max_dev:.2e} ({F64_ALL}; {F64_CONV} over float32 "
          f"parameters: summed gradients relative L2 {g['grad']:.2e}, BatchNorm statistics "
          f"max|Δ|={g['stats']:.2e})")
    print("dryrun_multichip train readings (recorded, not judged): " + "; ".join(
        f"{t}: params max|Δ|={v['params']:.4e}, gradients {v['grad']:.2e}, statistics "
        f"{v['stats']:.2e}" for t, v in gaps.items() if t != F64_ALL))
    for t in gaps:
        if t != F64_ALL and gaps[t]["params"] >= TRAIN_BOUND:
            print(f"dryrun_multichip train readings, {t}, rank 0 over {TRAIN_BOUND:g} (Adam's "
                  f"eps {EPS:g}): {_over_bound(ranks[0][f'train/{t}'], single[t])}")

    n_valid = int((ref_all[..., 0, 3] >= 0).sum())
    _check(n_valid == ref_all.shape[0] * ref_all.shape[1],
           f"{n_valid} of {ref_all.shape[0] * ref_all.shape[1]} slots valid at MIN_SCORE "
           f"{ALL_VALID_SCORE:g}")
    valid_note = f"every slot valid ({n_valid}) at MIN_SCORE {ALL_VALID_SCORE:g}"

    def delta(key: str, members: list) -> tuple:
        return (max(float(np.max(np.abs(ref_poses - r[key]))) for r in members),
                max(float(np.max(np.abs(ref_all - r[key + "/all valid"]))) for r in members))

    vdelta, vdelta_all = delta("view", ranks[:vdev])
    _check(max(vdelta, vdelta_all) < POSE_BOUND_MM,
           f"view-sharded inference deviates: {vdelta}, {vdelta_all} with every slot valid")
    print(f"dryrun_multichip view-shard ok: {vdev}-way camera sharding, "
          f"pose parity max|Δ|={vdelta:.2e} mm; {valid_note}: max|Δ|={vdelta_all:.2e} mm")

    edelta, edelta_all = delta("eval", ranks)
    _check(max(edelta, edelta_all) < POSE_BOUND_MM,
           f"dp-eval inference deviates: {edelta}, {edelta_all} with every slot valid")
    print(f"dryrun_multichip dp-eval ok: {n_devices}-way batch sharding, "
          f"pose parity max|Δ|={edelta:.2e} mm; {valid_note}: max|Δ|={edelta_all:.2e} mm")

    # two-stage pipelined streaming (backbone | fusion) against the serial path
    cfg.RESNET.NUM_LAYERS = 18  # a small backbone: the dry run stays fast
    iw, ih = cfg.DATASET.IMAGE_SIZE
    frames = rng.rand(PIPELINE_FRAMES, V, ih, iw, 3).astype(np.float32)
    cams1 = batch["cameras"][0]
    devices = ("cpu", "cpu") if on_cpu else None
    sk.reset_launch_counts()
    backbone = seeded(build_backbone, cfg, 1, dev)
    stream = PipelinedStream(cfg, model, backbone, cams1, devices=devices)
    piped = [stream.push(f) for f in frames] + [stream.flush()]
    piped = [p for p in piped if p is not None]
    _check(len(piped) == len(frames), "pipeline dropped a frame")

    def serial(f):
        with torch.no_grad():
            hm = images_to_heatmaps(stream.backbone, torch.as_tensor(f)[None].to(stream.d0),
                                    cfg.DATASET.COLOR_RGB)
            return _forward(stream.model, hm.to(stream.d1), stream.cams)[0].cpu().numpy()

    pdelta = max(float(np.max(np.abs(serial(f) - p[0]))) for f, p in zip(frames, piped))
    for k, v in sk.launch_counts().items():
        launches[k] = launches.get(k, 0) + v
    _check(pdelta < POSE_BOUND_MM, f"pipelined stream deviates from serial: {pdelta}")
    print(f"dryrun_multichip pipeline ok: 2-chip backbone|fusion stream, "
          f"{len(frames)} frames, serial parity max|Δ|={pdelta:.2e} mm "
          f"(stages on {stream.d0} and {stream.d1})")
    return {"total_loss": total, "train_max_dev": max_dev, "train": gaps, "view_shards": vdev,
            "view_max_dev": vdelta, "eval_max_dev": edelta,
            "view_all_valid_max_dev": vdelta_all, "eval_all_valid_max_dev": edelta_all,
            "pipeline_max_dev": pdelta, "devices": [r["device"] for r in ranks],
            "launches": launches}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=2, help="ranks of the dry run")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU (default: the card; raises without one)")
    args = ap.parse_args(argv)
    fn, fn_args = entry(args.device)
    print("entry ok:", tuple(fn(*fn_args).shape))
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
