#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (`faster_voxelpose_tpu_torch`) only, at the Panoptic
profile of configs/demo/panoptic_synthetic.yaml (5 views, 240x128x15
heatmaps, 80x80x20 grid, 64^3 crops, K = 10):

1. builds the CUDA kernels from csrc/ with nvcc and prints the ptxas report;
2. kernel phases: each kernel on the card at main-path shapes against its
   plain PyTorch version (float32, max abs error <= 1e-5 on values in
   [0, 1]), timed beside its plain version, a grid_sample-based PyTorch
   yardstick and its bound;
3. parity phase: a small seeded model through the kernels on the card
   against its plain path on the CPU;
4. serving phase: PoseService with the committed panoptic_synthetic
   weights answers rendered 1-6-person frames; both kernels' launch
   counters must rise on every request, someone must be detected and the
   median matched MPJPE must stay under 150 mm.

Any failed phase raises, so the script exits non-zero.  The last line is
{"ok": true, "device": {...}}; the line before it holds the kernel table
as JSON.  Exits non-zero without printing a result when no CUDA device
is present or the port is not beside this file.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
TOL = 1e-5
N_REQUESTS = 24

# a 15-joint (panoptic-order) template skeleton, mm offsets from mid-hip
# (the template of scripts/make_demo_data.py, which the weights trained on)
SKELETON = np.array([
    [0, 0, 450], [0, 40, 560], [0, 0, 0], [150, 0, 430], [230, 0, 200],
    [260, 30, -20], [90, 0, -20], [100, 20, -420], [110, 0, -800],
    [-150, 0, 430], [-230, 0, 200], [-260, 30, -20], [-90, 0, -20],
    [-100, 20, -420], [-110, 0, -800],
], dtype=np.float64)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps=25, warm=3) -> float:
    """Median of `reps` single-call times by CUDA events, after `warm` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------


def make_people(rng, n, center):
    """n people: the template with N(0, 40) mm jitter, a random yaw, the
    mid-hip 850-1000 mm up, roots inside the camera ring and >= 700 mm apart."""
    roots = []
    while len(roots) < n:
        r, a = 1700 * np.sqrt(rng.uniform()), rng.uniform(0, 2 * np.pi)
        xy = np.array(center[:2]) + r * np.array([np.cos(a), np.sin(a)])
        if all(np.linalg.norm(xy - q) >= 700 for q in roots):
            roots.append(xy)
    people = []
    for xy in roots:
        yaw = rng.uniform(0, 2 * np.pi)
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        pose = (SKELETON + rng.normal(0, 40, SKELETON.shape)) @ rot.T
        pose[:, :2] += xy
        pose[:, 2] += rng.uniform(850, 1000)
        people.append(pose)
    return np.stack(people)


def heatmap_params(people, rig, cfg):
    """(V, K, J, 12) Gaussian parameters of `people` in every view, as the
    JAX package's dataset builds them for its device renderer (no
    augmentation): in-frame visibility, scale-adaptive sigma."""
    import torch

    from faster_voxelpose_tpu_torch.geometry import get_resize_transform, project_points

    d = cfg.DATASET
    W, H = d.HEATMAP_SIZE
    stride = np.asarray(d.IMAGE_SIZE, np.float64) / np.asarray(d.HEATMAP_SIZE)
    rt = get_resize_transform(d.ORI_IMAGE_SIZE, d.IMAGE_SIZE)
    K, J = cfg.CAPTURE_SPEC.MAX_PEOPLE, d.NUM_JOINTS
    out = np.zeros((len(rig), K, J, 12), np.float32)
    for v, cam in enumerate(rig):
        for n, pose in enumerate(people):
            p = project_points(torch.as_tensor(pose), torch.as_tensor(cam, dtype=torch.float64)).numpy()
            vis = (p[:, 0] >= 0) & (p[:, 0] <= d.ORI_IMAGE_SIZE[0] - 1) & \
                  (p[:, 1] >= 0) & (p[:, 1] <= d.ORI_IMAGE_SIZE[1] - 1)
            p = p @ rt[:, :2].T + rt[:, 2]
            vis &= (p[:, 0] >= 0) & (p[:, 1] >= 0) & (p[:, 0] < d.IMAGE_SIZE[0]) & (p[:, 1] < d.IMAGE_SIZE[1])
            q = p / stride
            extent = max(np.ptp(q[:, 0]), np.ptp(q[:, 1]))
            scale2 = 2 * float(np.clip(extent ** 2, 96 ** 2 / 4.0, 4 * 96 ** 2))
            sigma = cfg.NETWORK.SIGMA * np.sqrt(scale2 / (96.0 * 96.0))
            tmp = sigma * 3
            for j in range(J):
                mu_x, mu_y = int(q[j, 0]), int(q[j, 1])
                if not vis[j] or int(mu_x - tmp) >= W or int(mu_y - tmp) >= H \
                        or int(mu_x + tmp + 1) < 0 or int(mu_y + tmp + 1) < 0:
                    continue
                ul_x, ul_y = int(mu_x - tmp), int(mu_y - tmp)
                c = (2 * tmp + 1) // 2
                out[v, n, j, :8] = (ul_x + c, ul_y + c, 1 / (2 * sigma * sigma), 1.0,
                                    max(0, ul_x), min(int(mu_x + tmp + 1), W),
                                    max(0, ul_y), min(int(mu_y + tmp + 1), H))
    return out


def render_frame(people, rig, cfg, device):
    import torch

    from faster_voxelpose_tpu_torch.ops.heatmap_render import render_heatmaps_device

    W, H = cfg.DATASET.HEATMAP_SIZE
    params = torch.as_tensor(heatmap_params(people, rig, cfg), device=device)
    return render_heatmaps_device(params, H, W).contiguous()  # (V, H, W, J)


def matched_mpjpe(gt, poses):
    """Per GT person, the MPJPE of its nearest detection if < 500 mm."""
    errs = []
    for g in gt:
        if len(poses):
            e = np.linalg.norm(np.asarray(poses) - g[None], axis=-1).mean(-1)
            if e.min() < 500:
                errs.append(float(e.min()))
    return errs


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def build_phase():
    from faster_voxelpose_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    libs = cuda_build.build_all(["sampling"])
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "ptxas" in line:
                    print("  " + line.strip())


def whole_phase(cfg, geom, rig, hm, card):
    import torch
    import torch.nn.functional as F

    from faster_voxelpose_tpu_torch.geometry import project_to_norm_coords
    from faster_voxelpose_tpu_torch.models.projection import whole_pixels
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    grid = torch.as_tensor(geom.whole_grid, device=hm.device)
    cams = torch.as_tensor(rig, device=hm.device)
    pix = whole_pixels(geom, grid, cams)
    out, ref = sk.sample_whole(hm, pix), sk.sample_whole_plain(hm, pix)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if not (err <= TOL and torch.isfinite(out).all()):
        raise AssertionError(f"sample_whole disagrees with its plain version: {err}")

    norm = project_to_norm_coords(grid, cams, geom.resize_transform, geom.ori_image_size,
                                  geom.image_size, geom.heatmap_size)
    hm_nchw = hm.permute(0, 3, 1, 2).contiguous()

    def library():
        s = F.grid_sample(hm_nchw, norm[:, None], align_corners=True, padding_mode="zeros")
        return s.mean(0).clamp(0, 1)

    lib_err = float((library()[:, 0].t() - ref).abs().max())
    V, H, W, J = hm.shape
    N = pix.shape[1]
    nbytes = 4 * (V * H * W * J + V * N * 2 + N * J)
    flops = N * V * (12 + 8 * J) + 2 * N * J
    b_ms, b_by = bound(nbytes, flops)
    row = dict(name="sample_whole", ms=time_ms(lambda: sk.sample_whole(hm, pix)),
               plain_ms=time_ms(lambda: sk.sample_whole_plain(hm, pix)),
               library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    print(f"kernel sample_whole: err {err:.3g} (library err {lib_err:.3g}) kernel_ms "
          f"{row['ms']:.4f} plain_ms {row['plain_ms']:.4f} library_ms {row['library_ms']:.4f} "
          f"bound_ms {b_ms:.4f} ({b_by}) shapes V{V} {H}x{W}x{J} N{N} | {card}")
    return row


def crop_phase(cfg, geom, rig, hm, card, rng):
    import torch
    import torch.nn.functional as F

    from faster_voxelpose_tpu_torch.geometry import project_to_norm_coords
    from faster_voxelpose_tpu_torch.models import projection as pj
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    dev = hm.device
    K = cfg.CAPTURE_SPEC.MAX_PEOPLE
    center = np.asarray(cfg.CAPTURE_SPEC.SPACE_CENTER)
    centers = center + rng.uniform([-1800, -1800, -100], [1800, 1800, 200], (K, 3))
    valid = np.ones(K, bool)
    valid[rng.choice(K, 3, replace=False)] = False
    bbox = rng.uniform(0.2, 1.0, (K, 2))
    tl, _ = pj.compute_crop_origin(geom, torch.as_tensor(centers, dtype=torch.float32, device=dev))
    masks = pj.crop_axis_masks(geom, tl, torch.as_tensor(bbox, dtype=torch.float32, device=dev))
    cams = torch.as_tensor(rig, device=dev)
    crop = pj.crop_projection(geom)
    args = (hm, cams, tl.contiguous(), *(m.to(torch.uint8) for m in masks),
            torch.as_tensor(valid, device=dev).to(torch.uint8), crop)
    out, ref = sk.sample_crop_planes(*args), sk.sample_crop_planes_plain(*args)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    if not (err <= TOL and all(torch.isfinite(a).all() for a in out)):
        raise AssertionError(f"sample_crop_planes disagrees with its plain version: {err}")

    # grid_sample yardstick: the valid slots' crops projected, sampled,
    # averaged, clamped, masked and max-projected by stock PyTorch ops
    vx, vy, vz = geom.ind_voxels_per_axis
    vk = np.flatnonzero(valid)
    pts = torch.cat([sk.crop_world_points(crop, tl[k], (vx, vy, vz)) for k in vk])
    mk = torch.stack([(masks[0][k][:, None, None] & masks[1][k][None, :, None]
                       & masks[2][k][None, None, :]) for k in vk]).float()
    hm_nchw = hm.permute(0, 3, 1, 2).contiguous()
    rt = geom.resize_transform

    def library():
        norm = project_to_norm_coords(pts, cams, rt, geom.ori_image_size,
                                      geom.image_size, geom.heatmap_size)
        s = F.grid_sample(hm_nchw, norm[:, None], align_corners=True, padding_mode="zeros")
        cube = s.mean(0).clamp(0, 1)[:, 0].t().reshape(len(vk), vx, vy, vz, -1) * mk[..., None]
        return cube.amax(3), cube.amax(2), cube.amax(1)

    vk_t = torch.as_tensor(vk, device=dev)
    lib_err = max(float((a - b[vk_t]).abs().max()) for a, b in zip(library(), ref))
    V, H, W, J = hm.shape
    live = sum(int(masks[0][k].sum() * masks[1][k].sum() * masks[2][k].sum()) for k in vk)
    nbytes = 4 * (V * H * W * J + V * 21 + 3 * K) + K * (vx + vy + vz + 1) \
        + 4 * K * J * (vx * vy + vx * vz + vy * vz)
    flops = live * V * (70 + 8 * J) + live * J * 4
    b_ms, b_by = bound(nbytes, flops)
    row = dict(name="sample_crop_planes", ms=time_ms(lambda: sk.sample_crop_planes(*args)),
               plain_ms=time_ms(lambda: sk.sample_crop_planes_plain(*args)),
               library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    print(f"kernel sample_crop_planes: err {err:.3g} (library err {lib_err:.3g}) kernel_ms "
          f"{row['ms']:.4f} plain_ms {row['plain_ms']:.4f} library_ms {row['library_ms']:.4f} "
          f"bound_ms {b_ms:.4f} ({b_by}) K{K} valid {len(vk)} live voxels {live} "
          f"samples {live * V} | {card}")
    return row


def parity_phase():
    """A small model (3 views, 40x32 heatmaps, 16x16x8 grid, 16^3 crops,
    K = 4, float32, seeded random weights) through the kernels on the card
    against its plain path on the CPU: the same proposals to 1e-3 and
    fused poses within 0.5 mm."""
    import torch

    from faster_voxelpose_tpu_torch.config import Config
    from faster_voxelpose_tpu_torch.geometry import dome_rig
    from faster_voxelpose_tpu_torch.models import build_model

    cfg = Config()
    d, c = cfg.DATASET, cfg.CAPTURE_SPEC
    d.ORI_IMAGE_SIZE, d.IMAGE_SIZE, d.HEATMAP_SIZE, d.CAMERA_NUM = (320, 240), (160, 128), (40, 32), 3
    c.SPACE_SIZE, c.SPACE_CENTER = (4000.0, 4000.0, 1600.0), (0.0, 0.0, 800.0)
    c.VOXELS_PER_AXIS, c.MAX_PEOPLE, c.MIN_SCORE = (16, 16, 8), 4, -1e9
    # a 2100 mm person box keeps every crop origin away from a .5 tie
    cfg.INDIVIDUAL_SPEC.SPACE_SIZE, cfg.INDIVIDUAL_SPEC.VOXELS_PER_AXIS = (2100.0,) * 3, (16, 16, 16)
    cfg.NETWORK.COMPUTE_DTYPE = "float32"
    torch.manual_seed(0)
    model = build_model(cfg)
    with torch.no_grad():  # fan-in scaled weights keep activations O(1)
        for p in model.parameters():
            if p.ndim > 1:
                p.normal_(0.0, (2.0 / p[0].numel()) ** 0.5)
        model.hdn.center_net.size_out.weight.mul_(0.01)  # bbox sizes near 0.6
        model.hdn.center_net.size_out.bias.fill_(0.6)
    rig = torch.as_tensor(dome_rig(1, 3, space_center=c.SPACE_CENTER,
                                   ori_image_size=d.ORI_IMAGE_SIZE, focal=240.0))
    hm = torch.rand((1, 3, 32, 40, 15), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = model(hm, rig)
        out = model.to("cuda")(hm.cuda(), rig.cuda())
    d_prop = float((out.proposal_centers.cpu() - ref.proposal_centers).abs().max())
    d_pose = float((out.fused_poses.cpu() - ref.fused_poses)[..., :3].abs().max())
    print(f"parity: small model card vs CPU: proposals {d_prop:.3g}, fused poses {d_pose:.3g} mm")
    if not (d_prop <= 1e-3 and d_pose <= 0.5 and torch.isfinite(out.fused_poses).all()):
        raise AssertionError(f"card and CPU paths disagree: proposals {d_prop}, poses {d_pose} mm")


def serving_phase(cfg, rig, card, rng):
    import torch

    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    with np.load(ROOT / "checkpoints/panoptic_synthetic/model_best.npz") as npz:
        variables = {k: npz[k] for k in npz.files}
    svc = PoseService(cfg, variables=variables, rig=rig, device="cuda")
    svc.warmup()
    center = cfg.CAPTURE_SPEC.SPACE_CENTER
    most = min(6, cfg.CAPTURE_SPEC.MAX_PEOPLE)
    scenes = [make_people(rng, int(rng.randint(1, most + 1)), center) for _ in range(N_REQUESTS)]
    frames = [render_frame(p, rig, cfg, svc.device) for p in scenes]
    torch.cuda.synchronize()

    sk.reset_launch_counts()
    results = [svc.infer_heatmaps(f) for f in frames]
    launches = sk.launch_counts()

    n_true = np.mean([len(p) for p in scenes])
    n_det = np.mean([r["n_people"] for r in results])
    errs = [e for p, r in zip(scenes, results) for e in matched_mpjpe(p, r["poses_mm"])]
    stats = svc.stats()
    print(f"serving: {json.dumps(stats)} | {card}")
    print(f"serving: {N_REQUESTS} requests, mean true people {n_true:.3f}, mean detected "
          f"{n_det:.3f}, matched {len(errs)}, MPJPE median {np.median(errs) if errs else float('nan'):.2f} "
          f"mm mean {np.mean(errs) if errs else float('nan'):.2f} mm, launches {launches}")
    for name, count in launches.items():
        if count < N_REQUESTS:
            raise AssertionError(f"{name} launched {count} times for {N_REQUESTS} requests")
    if not any(r["n_people"] for r in results):
        raise AssertionError("no person detected in any frame")
    if not errs or not np.median(errs) < 150.0:
        raise AssertionError(f"median matched MPJPE {np.median(errs) if errs else None} >= 150 mm")
    for r in results:
        if not np.isfinite(np.asarray(r["poses_mm"], np.float64)).all():
            raise AssertionError("non-finite poses")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "faster_voxelpose_tpu_torch").is_dir():
        print("chip_smoke: the faster_voxelpose_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile
    from faster_voxelpose_tpu_torch.device import pin_float32
    from faster_voxelpose_tpu_torch.geometry import dome_rig
    from faster_voxelpose_tpu_torch.models.projection import make_projection_geometry

    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | {card}")
    pin_float32()
    build_phase()

    cfg = panoptic_synthetic_profile()
    geom = make_projection_geometry(cfg)
    rig = dome_rig(1, cfg.DATASET.CAMERA_NUM, space_center=cfg.CAPTURE_SPEC.SPACE_CENTER)[0]
    rng = np.random.RandomState(0)
    hm = render_frame(make_people(rng, 4, cfg.CAPTURE_SPEC.SPACE_CENTER), rig, cfg, "cuda")
    hm = (hm + 0.05 * torch.rand(hm.shape, generator=torch.Generator().manual_seed(0))
          .to(hm.device)).clamp(0, 1).contiguous()  # no exact zeros between people

    rows = [whole_phase(cfg, geom, rig, hm, card), crop_phase(cfg, geom, rig, hm, card, rng)]
    parity_phase()
    launches = serving_phase(cfg, rig, card, rng)

    replaces = {"sample_whole": "faster_voxelpose_tpu/ops/pallas_sampling.py:947",
                "sample_crop_planes": "faster_voxelpose_tpu/ops/pallas_sampling.py:1010"}
    kernels = [dict(name=r["name"], route="cuda", source="faster_voxelpose_tpu_torch/csrc/sampling.cu",
                    replaces=replaces[r["name"]], launches=launches[r["name"]],
                    max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"])
               for r in rows]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
