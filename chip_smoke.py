#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels   # the kernel rows alone (no path run)

Drives the port (`faster_voxelpose_tpu_torch`) only, at the Panoptic
profile of configs/demo/panoptic_synthetic.yaml (5 views, 240x128x15
heatmaps, 80x80x20 grid, 64^3 crops, K = 10) unless a phase names
another committed snapshot's profile (`config.profile`):

1. builds the CUDA kernels from csrc/ with nvcc and prints the ptxas report;
2. kernel phases: each kernel, and the crop sampler in each of its modes
   (planes projected in the kernel, planes from coords, the masked cube
   from either), on the card at main-path shapes against its plain
   PyTorch version (float32, max abs error <= 1e-5 on values in [0, 1]),
   timed beside its plain version, a grid_sample-based PyTorch yardstick
   and its bound; the crop modes' planes equal bit for bit, and each crop
   line prints the launch (grid, threads, shared memory) as the kernel's
   source computes it, and an upper bound on the global atomics it
   issues, computed from the masks.  Row 1, the whole-space sampler, runs
   at the Panoptic profile (B = 1 on the served rig and frame, B = 4) and
   at the Shelf and Campus shapes (B = 4 and 8): its projected mode
   against the plain version, and equal bit for bit to its coords mode on
   whole_pixels of the same cameras; each case prints both modes' times,
   the coords mode with the coords built per sample as the HDN did
   before, the launch and its shared memory.  Every kernel is timed three
   ways (tools/timing.py): single calls (`ms`), device time from a CUDA
   graph of back-to-back calls (`device_ms`) and the host's wall time per
   call (`host_ms`); its library yardstick on the first two
   (`library_ms`, `library_device_ms`), so that each ratio is read on one
   clock.  The crop sampler's three kernels run again at the Shelf shape
   (5 views, 200x152x17, K = 10) and the Campus shape (3 views,
   200x160x17, K = 5) of their profiles and rigs, each against its plain
   version, timed and printed with its bound, yardstick and launch;
3. parity phase: a small seeded model through the kernels on the card
   against its plain path on the CPU;
4. route phase: the served path answers the same 6 frames under the
   default config, PALLAS_FUSED_COORDS false and PALLAS_TILE [4, 4, 4];
   each route launches its own crop kernel once per request and no
   other, and the fused poses agree within 0.01 mm;
5. train-parity phase: one train step of a small seeded model on the card
   and on the CPU from the same weights and batch: with float64 conv
   stacks, losses within 1e-4 relative and every gradient tensor within
   1e-3 relative L2; with float32, within limits set between its own
   reading and a bf16 control's, which must break them;
6. training phase: the Panoptic profile at full width, seeded random
   weights: 8 steps on one batch of 4 synthetic scenes from the port's
   generator, rendered on the card, must give finite losses and lower
   the detection loss (2D + 1D) below 0.9 of its first value; then 20
   steps on fresh batches are timed;
7. window phase: the window kernel (windowed sampling from the live taps
   of a footprint staged in shared memory, csrc/window.cu) in each of its
   nine instantiations against its plain version on 64 blocks at spreads
   6 and 12 and on blocks at the image's edges (1e-5), then the tools
   `probe_sampling` and `sweep_sampling` at full scale (13.1M samples);
8. mma phase: the bf16 tensor-core kernel (csrc/mma_window.cu: wgmma on
   tiles staged by TMA) with its ptxas registers and spills, the HGMMA
   instructions in its SASS (cuobjdump; none, or no cuobjdump, fails) and
   its launch plan for each K held against the kernel's own layout; its
   six cases against its plain version (one bf16 ulp), then the tool
   `microbench_mma` at 512 steps; its time must rise with K and with M
   and stay under the card's peak, and each case prints its share of its
   bound; its yardstick is one bmm of the five products of every step
   concatenated along K;
9. eval phase: `run_validation` on the first 500 held-out synthetic
   scenes with the committed weights, held to AP@50 >= the snapshot's
   record - 0.025, MPJPE <= the record + 1.5 mm and 0.97-1.01 people
   detected for each one there is (`eval_limits`); a control with every
   head rounded to bf16 must break those limits;
10. profiles phase: each of the other five committed snapshots
   (checkpoints/*) on the first 500 held-out scenes of its own profile,
   rig and pose bank (`tools.validate`), held to the same limits against
   its own record; then PoseService at the Campus profile
   (campus_synthetic_ref: 3 views, 17 joints, K = 5) answers the first
   24 of those scenes at batch 1 with the validator's fused poses at
   batch 1 (0.01 mm), rows 1 and 2 launching once per request and no
   other kernel; in float32 the service at batch 1 and the validator at
   the profile's test batch (8) agree within 0.01 mm too;
11. images phase: at the Panoptic profile with the committed weights and
   a seeded random ResNet-50 backbone, 5 uint8 frames of 960x512 per
   request: the backbone on the card against the CPU on the same weights
   and one frame in float32 (relative L2 <= BACKBONE_F32_TOL; the served
   bf16 backbone, the control, must break it); in float32,
   `infer_images` of uint8 frames equal to `infer_heatmaps` of the CPU
   backbone's heatmaps of the frames normalised on the host, and as
   served, to `infer_images` of the float32-normalised frames (every slot
   valid, 0.01 mm); then 24 timed
   requests, rows 1 and 2 once per request and no other kernel, with
   latency p50 / p95, each request's device and host ms and the
   backbone's device ms alone (recorded, not judged).
The serving phase (PoseService with the committed panoptic_synthetic
weights answering 24 rendered 1-6-person frames: the default route's two
kernels, the projected whole-space sampler and the crop sampler, launch
once per request and no other kernel does, someone is detected, the
median matched MPJPE stays under 150 mm) runs between phases 3 and 4,
then the compiled phase (`compiled_phase`): PoseService's CUDA graphs
against eager services on the same 24 requests (the same people; float32
within 0.01 mm, the bf16 gap printed), rows 1 and 2 once per replayed
request, a rig hot-swap with no recapture, the 'images_u8' graph on
uint8 frames, a capture holding a host synchronisation that must raise,
the JSON-lines server (tools/serve.py) in a subprocess, and eager and
compiled latencies.  PoseService captures its graphs at construction on
the card, so the serving, profiles and images phases answer through
them too (the profiles phase's Campus service against an eager one as
well); the route phase runs eagerly, since the coords route builds its
pixels from host constants, which a graph cannot hold.
Training and evaluation launch the whole-space sampler once per batch
and the crop sampler once per sample, at every profile; the coords mode
of row 1 runs only as the gather baseline of tools/probe_sampling.py.

Any failed phase raises, so the script exits non-zero.  The last line is
{"ok": true, "device": {...}}; the line before it holds the kernel table
as JSON.  Exits non-zero without printing a result when no CUDA device
is present or the port is not beside this file.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # its tensor cores, dense
SAMPLING_CU = "faster_voxelpose_tpu_torch/csrc/sampling.cu"
PALLAS = "faster_voxelpose_tpu/ops/pallas_sampling.py"
TOL = 1e-5
# float32 train step, card against CPU: between the sound reading and the
# bf16 control's (train_parity_phase)
F32_LOSS_TOL, F32_GRAD_TOL = 1e-4, 0.5
N_REQUESTS = 24
CARD = "cuda"  # the device the phases drive

# a 15-joint (panoptic-order) template skeleton, mm offsets from mid-hip
# (the template of scripts/make_demo_data.py, which the weights trained on)
SKELETON = np.array([
    [0, 0, 450], [0, 40, 560], [0, 0, 0], [150, 0, 430], [230, 0, 200],
    [260, 30, -20], [90, 0, -20], [100, 20, -420], [110, 0, -800],
    [-150, 0, 430], [-230, 0, 200], [-260, 30, -20], [-90, 0, -20],
    [-100, 20, -420], [-110, 0, -800],
], dtype=np.float64)


def bound(nbytes: float, flops: float, peak: float = F32_FLOPS):
    """(least ms, what bounds it) of work that moves `nbytes` and does
    `flops` operations of a type whose peak rate is `peak`."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
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
    libs = cuda_build.build_all(["sampling", "window", "mma_window"])
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "ptxas" in line or "spill" in line:
                    print("  " + line.strip())


# the Shelf and Campus shapes of rows 1-4: the profiles of these snapshots
# (configs/demo/<stem>.yaml) and the rigs of their make_demo_data.py lines
OTHER_SHAPES = {"shelf": "shelf_synthetic_ref", "campus": "campus_synthetic_ref"}


def held_out_rigs(cfg, B):
    """(B, V, 21) float32: the rig of `cfg`'s make_demo_data.py line for
    seeds 0 .. B-1 (each seed jitters the cameras' angles)."""
    from faster_voxelpose_tpu_torch.datasets.demo_data import RIG_RADIUS_MM, make_rig
    from faster_voxelpose_tpu_torch.geometry import pack_rig

    d = cfg.DATASET
    rigs = [make_rig(d.CAMERA_NUM, RIG_RADIUS_MM[d.DATADIR], 2200.0,
                     cfg.CAPTURE_SPEC.SPACE_CENTER[:2], d.ORI_IMAGE_SIZE, seed=b)
            for b in range(B)]
    return np.stack([pack_rig([r[str(v)] for v in range(d.CAMERA_NUM)])
                     for r in rigs]).astype(np.float32)


def whole_cases(cfg, geom, rig, hm):
    """Row 1's cases, (label, geometry, heatmaps (B, V, H, W, J), cams
    (B, V, 21)) on the card: the Panoptic profile at B = 1 on the served
    rig and frame (the inputs of earlier readings) and at B = 4 on
    held-out rigs; Shelf and Campus at B = 4 and 8.  Heatmaps other than
    the frame are uniform in [0, 1) from a seed."""
    import torch

    from faster_voxelpose_tpu_torch.config import profile
    from faster_voxelpose_tpu_torch.models.projection import make_projection_geometry

    rng = np.random.RandomState(7)
    cases = [("panoptic B=1", geom, hm[None], torch.as_tensor(rig, device=CARD)[None])]
    shapes = [("panoptic", cfg, geom, 4)]
    for name, stem in OTHER_SHAPES.items():
        other = profile(stem)
        shapes += [(name, other, make_projection_geometry(other), B) for B in (4, 8)]
    for name, pcfg, g, B in shapes:
        W, H = g.heatmap_size
        d = pcfg.DATASET
        heat = rng.rand(B, d.CAMERA_NUM, H, W, d.NUM_JOINTS).astype(np.float32)
        cases.append((f"{name} B={B}", g, torch.as_tensor(heat, device=CARD),
                      torch.as_tensor(held_out_rigs(pcfg, B), device=CARD)))
    return cases


def whole_case(label, g, heat, cams, card):
    """One case of row 1: the projected mode against the plain version
    (1e-5) and against the coords mode on whole_pixels of the same cams
    (bit for bit), the coords mode against its plain version, their times
    by every timer, the library yardstick and the bound."""
    import torch
    import torch.nn.functional as F

    from faster_voxelpose_tpu_torch.geometry import project_to_norm_coords
    from faster_voxelpose_tpu_torch.models import projection as pj
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk
    from faster_voxelpose_tpu_torch.tools.timing import time_ms

    B, V, H, W, J = heat.shape
    X, Y, Z = g.voxels_per_axis
    N = X * Y * Z
    grid = torch.as_tensor(g.whole_grid, device=CARD)
    pix = [pj.whole_pixels(g, grid, cams[b]) for b in range(B)]

    def coords_path():  # the HDN's path before the projected mode: coords, then the kernel
        return torch.stack([sk.sample_whole(heat[b].contiguous(), pj.whole_pixels(g, grid, cams[b]))
                            for b in range(B)])

    coords = torch.stack([sk.sample_whole(heat[b].contiguous(), pix[b]) for b in range(B)])
    ref = torch.stack([sk.sample_whole_plain(heat[b], pix[b]) for b in range(B)])
    torch.cuda.synchronize()
    coords_err = float((coords - ref).abs().max())
    if not (coords_err <= TOL and torch.isfinite(coords).all()):
        raise AssertionError(f"sample_whole ({label}) disagrees with its plain version: {coords_err}")
    case = dict(label=label, B=B, coords_err=coords_err,
                coords_path=timings(coords_path),
                coords_kernel=timings(lambda: [sk.sample_whole(heat[b], pix[b]) for b in range(B)]))
    line = (f"kernel row 1 [{label}] V{V} {H}x{W}x{J} grid {X}x{Y}x{Z}: coords mode err "
            f"{coords_err:.3g}, its kernel x{B} {fmt(case['coords_kernel'])}, with the coords "
            f"built per sample (the HDN's path before) {fmt(case['coords_path'])}")
    axes = tuple(torch.as_tensor(a, device=CARD) for a in pj.whole_axes(g))
    proj = pj.whole_projection(g)
    out = sk.sample_whole_projected(heat, cams, axes, proj)
    plain = sk.sample_whole_projected_plain(heat, cams, axes, proj)
    torch.cuda.synchronize()
    err = float((out - plain).abs().max())
    diff = float((out.reshape(B, N, J) - coords).abs().max())
    if not (err <= TOL and torch.isfinite(out).all()):
        raise AssertionError(f"sample_whole_projected ({label}) disagrees with its plain "
                             f"version: {err}")
    if not torch.equal(out.reshape(B, N, J), coords):
        raise AssertionError(f"sample_whole_projected ({label}) differs from the coords mode "
                             f"by {diff}")
    hm_nchw = heat.reshape(B * V, H, W, J).permute(0, 3, 1, 2).contiguous()

    def library():  # the projection is part of this mode's work
        norm = project_to_norm_coords(grid, cams, g.resize_transform, g.ori_image_size,
                                      g.image_size, g.heatmap_size)  # (B, V, N, 2)
        s = F.grid_sample(hm_nchw, norm.reshape(B * V, 1, N, 2), align_corners=True,
                          padding_mode="zeros")
        return s.reshape(B, V, J, N).mean(1).clamp(0, 1)

    lib_err = float((library().transpose(1, 2) - plain.reshape(B, N, J)).abs().max())
    nbytes = 4 * (B * V * H * W * J + B * N * J + B * V * 21 + X + Y + Z)
    b_ms, b_by = bound(nbytes, B * N * V * (70 + 8 * J) + 2 * B * N * J)
    geo = sk.whole_launch_geometry(V, (X, Y, Z), B)
    busy = N / (geo["grid"][0] * geo["voxels"])  # pairs at work over lanes launched
    case.update(err=err, lib_err=lib_err, bound_ms=b_ms, bound_by=b_by,
                projected=timings(lambda: sk.sample_whole_projected(heat, cams, axes, proj)),
                plain_ms=time_ms(lambda: sk.sample_whole_projected_plain(heat, cams, axes, proj),
                                 reps=5, warm=1),
                **library_readings(library))
    print(f"{line}; projected mode err {err:.3g} (equal to the coords mode bit for bit; library "
          f"err {lib_err:.3g}) {fmt(case['projected'])}, plain_ms {case['plain_ms']:.4f} "
          f"{fmt_library(case)} bound_ms {b_ms:.4f} ({b_by}, {nbytes / 1e6:.1f} MB); launch grid "
          f"{geo['grid']} threads {geo['threads']} smem {geo['smem']} B, lanes at work "
          f"{busy:.4f} (the coords mode's {J / 2 ** int(np.ceil(np.log2(J))):.4f}) | {card}")
    return case


def device_readings(fn):
    """The readings of tools/timing.py beside the single-call `ms`: the
    device time per call (`device_ms`, and the method that read it) and
    the host's wall time per call (`host_ms`)."""
    from faster_voxelpose_tpu_torch.tools.timing import device_timing, host_ms

    dev, method = device_timing(fn)
    return dict(device_ms=dev, device_method=method, host_ms=host_ms(fn))


def timings(fn):
    """The three readings of tools/timing.py of one call, in ms."""
    from faster_voxelpose_tpu_torch.tools.timing import time_ms

    return dict(ms=time_ms(fn), **device_readings(fn))


def library_readings(fn):
    """A library yardstick's time on both clocks of the kernels' rows: the
    single-call `library_ms` and the device time `library_device_ms`."""
    from faster_voxelpose_tpu_torch.tools.timing import device_timing, time_ms

    return dict(library_ms=time_ms(fn), library_device_ms=device_timing(fn)[0])


def fmt_library(row):
    return f"library_ms {row['library_ms']:.4f} library_device_ms {row['library_device_ms']:.4f}"


def fmt(t):
    return (f"ms {t['ms']:.4f} device_ms {t['device_ms']:.4f} ({t['device_method']}) host_ms "
            f"{t['host_ms']:.4f}")


def whole_phase(cfg, geom, rig, hm, card):
    """Kernel row 1 in both modes on every case of `whole_cases`; returns
    the coords mode's row and the projected mode's, both read at the
    Panoptic profile and B = 1.  The coords mode's bound: the heatmaps and
    coords in, the cube out."""
    import torch

    from faster_voxelpose_tpu_torch.models import projection as pj
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk
    from faster_voxelpose_tpu_torch.tools.timing import time_ms

    cases = [whole_case(*c, card) for c in whole_cases(cfg, geom, rig, hm)]
    first = cases[0]
    grid = torch.as_tensor(geom.whole_grid, device=CARD)
    pix = pj.whole_pixels(geom, grid, torch.as_tensor(rig, device=CARD))
    norm = pixel_to_norm(pix, geom)
    hm_nchw = hm.permute(0, 3, 1, 2).contiguous()

    def library():
        import torch.nn.functional as F

        s = F.grid_sample(hm_nchw, norm[:, None], align_corners=True, padding_mode="zeros")
        return s.mean(0).clamp(0, 1)

    V, H, W, J = hm.shape
    N = pix.shape[1]
    b_ms, b_by = bound(4 * (V * H * W * J + V * N * 2 + N * J), N * V * (12 + 8 * J) + 2 * N * J)
    t = first["coords_kernel"]
    rows = [dict(name="sample_whole", source=SAMPLING_CU, replaces=f"{PALLAS}:947", path="tools",
                 ms=t["ms"], device_ms=t["device_ms"], host_ms=t["host_ms"],
                 plain_ms=time_ms(lambda: sk.sample_whole_plain(hm, pix)),
                 **library_readings(library), bound_ms=b_ms, bound_by=b_by,
                 max_abs_err=first["coords_err"]),
            projected_row(first, cases)]
    print(f"kernel row 1 coords mode [panoptic B=1]: {fmt_library(rows[0])} | {card}")
    return rows


def projected_row(first, cases):
    """The projected mode's row, read at the Panoptic profile and B = 1,
    with every case's readings."""
    keys = ("label", "B", "err", "bound_ms", "plain_ms", "library_ms", "library_device_ms")
    t = first["projected"]
    return dict(
        name="sample_whole_projected", source=SAMPLING_CU, replaces=f"{PALLAS}:947",
        path="serving", ms=t["ms"], device_ms=t["device_ms"], host_ms=t["host_ms"],
        plain_ms=first["plain_ms"], library_ms=first["library_ms"],
        library_device_ms=first["library_device_ms"], bound_ms=first["bound_ms"],
        bound_by=first["bound_by"], max_abs_err=first["err"],
        coords_path_device_ms=first["coords_path"]["device_ms"],
        cases=[dict({k: c[k] for k in keys}, ms=c["projected"]["ms"],
                    device_ms=c["projected"]["device_ms"],
                    coords_path_device_ms=c["coords_path"]["device_ms"]) for c in cases])


def crop_case(cfg, geom, rig, hm, rng):
    """K crops at random centres (3 in 10 dead slots, random bbox sizes)
    with their masks, in the layout the crop sampler takes."""
    import torch

    from faster_voxelpose_tpu_torch.models import projection as pj
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    dev = hm.device
    K = cfg.CAPTURE_SPEC.MAX_PEOPLE
    center = np.asarray(cfg.CAPTURE_SPEC.SPACE_CENTER)
    centers = center + rng.uniform([-1800, -1800, -100], [1800, 1800, 200], (K, 3))
    valid = np.ones(K, bool)
    valid[rng.choice(K, K * 3 // 10, replace=False)] = False
    bbox = rng.uniform(0.2, 1.0, (K, 2))
    tl, _ = pj.compute_crop_origin(geom, torch.as_tensor(centers, dtype=torch.float32, device=dev))
    masks = pj.crop_axis_masks(geom, tl, torch.as_tensor(bbox, dtype=torch.float32, device=dev))
    cams = torch.as_tensor(rig, device=dev)
    crop = pj.crop_projection(geom)
    vk = np.flatnonzero(valid)
    mx, my, mz = (m.to(torch.uint8) for m in masks)
    v8 = torch.as_tensor(valid, device=dev).to(torch.uint8)
    return dict(
        K=K, cams=cams, tl=tl.contiguous(), masks=(mx, my, mz, v8), crop=crop, vk=vk,
        pix=sk.crop_pixels(crop, cams, tl.contiguous(), geom.ind_voxels_per_axis),
        live=sum(int(masks[0][k].sum() * masks[1][k].sum() * masks[2][k].sum()) for k in vk),
        keep=torch.stack([(masks[0][k][:, None, None] & masks[1][k][None, :, None]
                           & masks[2][k][None, None, :]) for k in vk]).float(),
    )


def library_crop(geom, hm, case, norm, planes=True):
    """grid_sample yardstick of the crop sampler on the valid slots:
    sample at normalized coords norm (V, n_valid * N, 2), mean over views,
    clamp, mask, then the three max planes (or the cube)."""
    import torch.nn.functional as F

    vx, vy, vz = geom.ind_voxels_per_axis
    hm_nchw = hm.permute(0, 3, 1, 2).contiguous()
    s = F.grid_sample(hm_nchw, norm[:, None], align_corners=True, padding_mode="zeros")
    cube = s.mean(0).clamp(0, 1)[:, 0].t().reshape(len(case["vk"]), vx, vy, vz, -1)
    cube = cube * case["keep"][..., None]
    return (cube.amax(3), cube.amax(2), cube.amax(1)) if planes else cube


def crop_bound(hm, case, geom, project, cube):
    """The least time of one crop-sampler mode on this run's masks: the
    heatmaps, the rig or the live voxels' coords, the masks in, the planes
    or the cube out; operations of the live voxels (projection ~70 flops
    per voxel and view when in the kernel, ~8 per joint and view for the
    bilinear sample, ~4 per joint for mean, clamp, mask and max)."""
    V, H, W, J = hm.shape
    K, live = case["K"], case["live"]
    vx, vy, vz = geom.ind_voxels_per_axis
    nbytes = 4 * V * H * W * J + K * (vx + vy + vz + 1)
    nbytes += 4 * (V * 21 + 3 * K) if project else 8 * V * live
    nbytes += 4 * K * J * (vx * vy * vz if cube else vx * vy + vx * vz + vy * vz)
    flops = live * V * ((70 if project else 0) + 8 * J) + live * J * 4
    return bound(nbytes, flops)


def crop_launch(hm, case, geom, project, cube):
    """The crop sampler's launch on this run's case, as its source computes
    it, and upper bounds, computed from the masks, on the global atomicMax
    it issues.  It issues one per plane cell and joint whose reduction on
    chip holds a value > 0, so at most: now, one per (column, z chunk) on
    xy and per (tile, cell) on xz and yz with a live voxel; before this
    kernel's tiling, one per live (voxel, joint).  The cube mode issues
    none.  For the phase's own line only: no number here is measured."""
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    V, _, _, J = hm.shape
    voxels = geom.ind_voxels_per_axis
    geo = sk.crop_launch_geometry(V, J, case["K"], voxels, project=project, cube=cube)
    counts = []  # per valid slot and axis: live voxels per tile along that axis
    for m, n, t in zip(case["masks"][:3], voxels, geo["tile"]):
        padded = np.zeros((case["K"], -(-n // t) * t), np.int64)
        padded[:, :n] = m.cpu().numpy()
        counts.append(padded[case["vk"]].reshape(len(case["vk"]), -1, t).sum(-1))
    cx, cy, cz = counts
    # sums over every (slot, tile x, tile y, z chunk)
    xy = np.einsum("kx,ky,kz->", cx, cy, cz > 0)
    xz = np.einsum("kx,ky,kz->", cx, cy > 0, cz)
    yz = np.einsum("kx,ky,kz->", cx > 0, cy, cz)
    atomics = 0 if cube else int(J * (xy + xz + yz))
    before = 0 if cube else case["live"] * J
    return (f"launch grid {geo['grid']} threads {geo['threads']} smem {geo['smem']} B "
            f"tile {geo['tile']} global atomics at most {atomics} "
            f"(before this tiling: at most {before})")


def crop_phase(cfg, geom, rig, hm, card, case, label="panoptic"):
    import torch

    from faster_voxelpose_tpu_torch.geometry import project_to_norm_coords
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk
    from faster_voxelpose_tpu_torch.tools.timing import time_ms

    args = (hm, case["cams"], case["tl"], *case["masks"], case["crop"])
    out, ref = sk.sample_crop_planes(*args), sk.sample_crop_planes_plain(*args)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    if not (err <= TOL and all(torch.isfinite(a).all() for a in out)):
        raise AssertionError(f"sample_crop_planes disagrees with its plain version: {err}")

    vx, vy, vz = geom.ind_voxels_per_axis
    vk = case["vk"]
    pts = torch.cat([sk.crop_world_points(case["crop"], case["tl"][k], (vx, vy, vz)) for k in vk])

    def library():  # the projection is part of this mode's work
        norm = project_to_norm_coords(pts, case["cams"], geom.resize_transform,
                                      geom.ori_image_size, geom.image_size, geom.heatmap_size)
        return library_crop(geom, hm, case, norm)

    vk_t = torch.as_tensor(vk, device=hm.device)
    lib_err = max(float((a - b[vk_t]).abs().max()) for a, b in zip(library(), ref))
    b_ms, b_by = crop_bound(hm, case, geom, project=True, cube=False)
    again = sk.sample_crop_planes(*args)
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError("two launches of sample_crop_planes differ")
    launch = crop_launch(hm, case, geom, project=True, cube=False)
    row = dict(name="sample_crop_planes", source=SAMPLING_CU, replaces=f"{PALLAS}:1010",
               path="train", ms=time_ms(lambda: sk.sample_crop_planes(*args)),
               plain_ms=time_ms(lambda: sk.sample_crop_planes_plain(*args)),
               **library_readings(library), bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
               **device_readings(lambda: sk.sample_crop_planes(*args)))
    V = hm.shape[0]
    print(f"kernel sample_crop_planes [{label}]: err {err:.3g} (library err {lib_err:.3g}) "
          f"kernel_ms {fmt(row)} plain_ms {row['plain_ms']:.4f} {fmt_library(row)} "
          f"bound_ms {b_ms:.4f} ({b_by}) hm {tuple(hm.shape)} K{case['K']} valid {len(vk)} "
          f"live voxels {case['live']} "
          f"samples {case['live'] * V} | {launch} | {card}")
    return row


def pixel_to_norm(pix, geom):
    """Heatmap pixels -> grid_sample's normalized coords."""
    import torch

    w, h = geom.heatmap_size
    scale = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)], device=pix.device)
    return pix * scale - 1.0


def coords_phase(cfg, geom, hm, card, case, label="panoptic"):
    """Kernel row 3: the planes from precomputed coords."""
    import torch

    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk
    from faster_voxelpose_tpu_torch.tools.timing import time_ms

    pix, masks = case["pix"], case["masks"]
    out = sk.sample_crop_planes_coords(hm, pix, *masks)
    ref = sk.sample_crop_coords_plain(hm, pix, *masks)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    if not (err <= TOL and all(torch.isfinite(a).all() for a in out)):
        raise AssertionError(f"sample_crop_planes_coords disagrees with its plain version: {err}")
    # the same planes as the projecting kernel's, to the tolerance
    proj = sk.sample_crop_planes(hm, case["cams"], case["tl"], *masks, case["crop"])
    route_err = max(float((a - b).abs().max()) for a, b in zip(out, proj))
    if not all(torch.equal(a, b) for a, b in zip(out, proj)):
        raise AssertionError(f"coords and project routes' planes differ: {route_err}")
    vk_t = torch.as_tensor(case["vk"], device=hm.device)
    norm = pixel_to_norm(pix[vk_t], geom).transpose(0, 1).reshape(hm.shape[0], -1, 2)

    def library():
        return library_crop(geom, hm, case, norm)

    lib_err = max(float((a - b[vk_t]).abs().max()) for a, b in zip(library(), ref))
    b_ms, b_by = crop_bound(hm, case, geom, project=False, cube=False)
    launch = crop_launch(hm, case, geom, project=False, cube=False)
    row = dict(name="sample_crop_planes_coords", source=SAMPLING_CU, replaces=f"{PALLAS}:947",
               path="route",
               ms=time_ms(lambda: sk.sample_crop_planes_coords(hm, pix, *masks)),
               plain_ms=time_ms(lambda: sk.sample_crop_coords_plain(hm, pix, *masks)),
               **library_readings(library), bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
               **device_readings(lambda: sk.sample_crop_planes_coords(hm, pix, *masks)))
    print(f"kernel sample_crop_planes_coords [{label}]: err {err:.3g} (vs project route "
          f"{route_err:.3g}, "
          f"library err {lib_err:.3g}) kernel_ms {fmt(row)} plain_ms {row['plain_ms']:.4f} "
          f"{fmt_library(row)} bound_ms {b_ms:.4f} ({b_by}) coords "
          f"{tuple(pix.shape)} {pix.numel() * 4 / 1e6:.1f} MB | "
          f"{launch} | {card}")
    return row


def cube_phase(cfg, geom, hm, card, case, label="panoptic"):
    """Kernel row 4: the masked cube, from in-kernel projection and from
    coords; its max planes against the planes kernel's."""
    import torch

    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk
    from faster_voxelpose_tpu_torch.tools.timing import time_ms

    pix, masks = case["pix"], case["masks"]
    proj = dict(cams=case["cams"], centers_tl=case["tl"], crop=case["crop"])
    sources = {"project": proj, "coords": dict(pix=pix)}
    plains = {
        "project": lambda: sk.sample_crop_planes_plain(hm, case["cams"], case["tl"], *masks,
                                                       case["crop"], cube=True),
        "coords": lambda: sk.sample_crop_coords_plain(hm, pix, *masks, cube=True),
    }
    errs = {}
    for src, kw in sources.items():
        out, ref = sk.sample_crop_cube(hm, *masks, **kw), plains[src]()
        torch.cuda.synchronize()
        errs[src] = float((out - ref).abs().max())
        if not (errs[src] <= TOL and torch.isfinite(out).all()):
            raise AssertionError(f"sample_crop_cube ({src}) disagrees with its plain version: {errs[src]}")
    cube = sk.sample_crop_cube(hm, *masks, **proj)
    planes = sk.sample_crop_planes(hm, case["cams"], case["tl"], *masks, case["crop"])
    if not all(torch.equal(a, b) for a, b in zip((cube.amax(3), cube.amax(2), cube.amax(1)), planes)):
        raise AssertionError("the cube's max planes differ from the planes kernel's")
    vk_t = torch.as_tensor(case["vk"], device=hm.device)
    norm = pixel_to_norm(pix[vk_t], geom).transpose(0, 1).reshape(hm.shape[0], -1, 2)

    def library():  # the cube: no plane max
        return library_crop(geom, hm, case, norm, planes=False)

    lib_err = float((library() - cube[vk_t]).abs().max())
    times = {src: time_ms(lambda kw=kw: sk.sample_crop_cube(hm, *masks, **kw))
             for src, kw in sources.items()}
    plain_ms = time_ms(plains["project"])
    b_ms, b_by = crop_bound(hm, case, geom, project=True, cube=True)
    bc_ms, bc_by = crop_bound(hm, case, geom, project=False, cube=True)
    launch = crop_launch(hm, case, geom, project=True, cube=True)
    row = dict(name="sample_crop_cube", source=SAMPLING_CU, replaces=f"{PALLAS}:1010", path="route",
               ms=times["project"], plain_ms=plain_ms,
               **library_readings(library), bound_ms=b_ms, bound_by=b_by,
               max_abs_err=max(errs.values()), coords_ms=times["coords"], coords_bound_ms=bc_ms,
               **device_readings(lambda: sk.sample_crop_cube(hm, *masks, **proj)))
    row["coords_device_ms"] = device_readings(
        lambda: sk.sample_crop_cube(hm, *masks, pix=pix))["device_ms"]
    print(f"kernel sample_crop_cube [{label}]: err project {errs['project']:.3g} coords "
          f"{errs['coords']:.3g} "
          f"(library err {lib_err:.3g}) kernel_ms project {fmt(row)}, coords "
          f"{times['coords']:.4f} device_ms {row['coords_device_ms']:.4f} plain_ms {plain_ms:.4f} "
          f"{fmt_library(row)} "
          f"bound_ms project {b_ms:.4f} ({b_by}) coords {bc_ms:.4f} ({bc_by}) cube "
          f"{tuple(cube.shape)} {cube.numel() * 4 / 1e6:.1f} MB | {launch} | {card}")
    return row


def crop_shapes_phase(card):
    """Rows 2-4, the crop sampler's three kernels, at the Shelf shape (5
    views, 200x152, J = 17, K = 10) and the Campus shape (3 views,
    200x160, J = 17, K = 5) on their profiles' rigs, each against its
    plain version (1e-5), timed beside its bound and yardstick, its launch
    printed.  Heatmaps uniform in [0, 1) from a seed.  Returns
    {kernel name: [its reading at each shape]}."""
    import torch

    from faster_voxelpose_tpu_torch.config import profile
    from faster_voxelpose_tpu_torch.models.projection import make_projection_geometry

    rng = np.random.RandomState(11)
    keys = ("ms", "device_ms", "host_ms", "plain_ms", "library_ms", "library_device_ms",
            "bound_ms", "bound_by", "max_abs_err")
    readings = {}
    for label, stem in OTHER_SHAPES.items():
        cfg = profile(stem)
        geom = make_projection_geometry(cfg)
        rig = held_out_rigs(cfg, 1)[0]
        d = cfg.DATASET
        W, H = d.HEATMAP_SIZE
        hm = torch.as_tensor(rng.rand(d.CAMERA_NUM, H, W, d.NUM_JOINTS).astype(np.float32),
                             device=CARD)
        case = crop_case(cfg, geom, rig, hm, rng)
        for row in (crop_phase(cfg, geom, rig, hm, card, case, label),
                    coords_phase(cfg, geom, hm, card, case, label),
                    cube_phase(cfg, geom, hm, card, case, label)):
            readings.setdefault(row["name"], []).append(
                dict({k: row[k] for k in keys}, label=label, shape=list(hm.shape), K=case["K"],
                     valid=len(case["vk"]), live=case["live"]))
        del case
    return readings


def small_config(dtype="float32"):
    """3 views, 40x32 heatmaps, 16x16x8 grid, 16^3 crops, K = 4; a
    2100 mm person box keeps every crop origin away from a .5 tie."""
    from faster_voxelpose_tpu_torch.config import Config

    cfg = Config()
    d, c = cfg.DATASET, cfg.CAPTURE_SPEC
    d.ORI_IMAGE_SIZE, d.IMAGE_SIZE, d.HEATMAP_SIZE, d.CAMERA_NUM = (320, 240), (160, 128), (40, 32), 3
    c.SPACE_SIZE, c.SPACE_CENTER = (4000.0, 4000.0, 1600.0), (0.0, 0.0, 800.0)
    c.VOXELS_PER_AXIS, c.MAX_PEOPLE, c.MIN_SCORE = (16, 16, 8), 4, -1e9
    cfg.INDIVIDUAL_SPEC.SPACE_SIZE, cfg.INDIVIDUAL_SPEC.VOXELS_PER_AXIS = (2100.0,) * 3, (16, 16, 16)
    cfg.NETWORK.COMPUTE_DTYPE = dtype
    return cfg


def small_model(cfg):
    """Seeded fan-in scaled weights (O(1) activations), bbox sizes near 0.6."""
    import torch

    from faster_voxelpose_tpu_torch.models import build_model

    torch.manual_seed(0)
    model = build_model(cfg)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim > 1:
                p.normal_(0.0, (2.0 / p[0].numel()) ** 0.5)
        model.hdn.center_net.size_out.weight.mul_(0.01)
        model.hdn.center_net.size_out.bias.fill_(0.6)
    return model


def parity_phase():
    """The small float32 model through the kernels on the card against its
    plain path on the CPU: the same proposals to 1e-3 and fused poses
    within 0.5 mm."""
    import torch

    from faster_voxelpose_tpu_torch.geometry import dome_rig

    cfg = small_config()
    d, c = cfg.DATASET, cfg.CAPTURE_SPEC
    model = small_model(cfg)
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


def route_phase(cfg, rig, card, rng):
    """The served path under the three crop routes that the sampling keys
    select at this profile, on the same 6 frames: each route's kernel
    launches once per request and no other crop kernel does; the fused
    poses agree within 0.01 mm.  Returns each route kernel's launches."""
    import copy

    import torch

    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.models.projection import resolve_crop_route
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    with np.load(ROOT / "checkpoints/panoptic_synthetic/model_best.npz") as npz:
        variables = {k: npz[k] for k in npz.files}
    center = cfg.CAPTURE_SPEC.SPACE_CENTER
    most = min(6, cfg.CAPTURE_SPEC.MAX_PEOPLE)
    frames = [render_frame(make_people(rng, int(rng.randint(1, most + 1)), center), rig, cfg, CARD)
              for _ in range(6)]
    routes = {
        "sample_crop_planes": ("default", {}),
        "sample_crop_planes_coords": ("PALLAS_FUSED_COORDS false", {"PALLAS_FUSED_COORDS": False}),
        "sample_crop_cube": ("PALLAS_TILE [4, 4, 4]", {"PALLAS_TILE": (4, 4, 4)}),
    }
    results, launches = {}, {}
    for kernel, (label, keys) in routes.items():
        rcfg = copy.deepcopy(cfg)
        for k, v in keys.items():
            setattr(rcfg.NETWORK, k, v)
        # eager: the coords route builds its pixels from host constants,
        # which no CUDA graph can hold (only the default route is captured)
        svc = PoseService(rcfg, variables=variables, rig=rig, device=CARD, aot=False)
        svc.infer_heatmaps(frames[0])  # warm-up
        sk.reset_launch_counts()
        results[kernel] = [svc.infer_heatmaps(f) for f in frames]
        counts = sk.launch_counts()
        launches[kernel] = counts[kernel]
        stats = svc.stats()
        print(f"route {label}: {resolve_crop_route(rcfg)} launches {counts} p50_ms "
              f"{stats['p50_ms']} | {card}")
        want = {n: 0 for n in counts}
        want.update({"sample_whole_projected": len(frames), kernel: len(frames)})
        if counts != want:
            raise AssertionError(f"route {label}: launches {counts}, expected {want}")
    ref = results["sample_crop_planes"]
    worst = 0.0
    for kernel, res in results.items():
        for a, b in zip(res, ref):
            pa, pb = np.asarray(a["poses_mm"]), np.asarray(b["poses_mm"])
            if pa.shape != pb.shape:
                raise AssertionError(f"{kernel}: {len(pa)} people against {len(pb)}")
            if pa.size:
                worst = max(worst, float(np.abs(pa - pb).max()))
    people = [r["n_people"] for r in ref]
    print(f"route: fused poses of the three routes agree within {worst:.3g} mm over 6 frames, "
          f"people {people}")
    if not (worst <= 0.01 and sum(people) > 0):
        raise AssertionError(f"routes disagree by {worst} mm (people {people})")
    return launches


def anchored_batch(cfg, model, cams, rng, device):
    """The batch of the JAX package's own training check
    (tests/test_training.py:21-72): random heatmaps (x 0.3) and dense
    random targets, and GT roots within 120 mm of the model's own
    train-mode proposals, 2 people per sample, so that the matching and
    the 1D and joint losses are active from the first step."""
    import torch

    d, c = cfg.DATASET, cfg.CAPTURE_SPEC
    B, V, J, K = cams.shape[0], d.CAMERA_NUM, d.NUM_JOINTS, c.MAX_PEOPLE
    W, H = d.HEATMAP_SIZE
    vx, vy, vz = c.VOXELS_PER_AXIS
    hm = torch.as_tensor(rng.rand(B, V, H, W, J).astype(np.float32) * 0.3)
    cams = torch.as_tensor(cams)
    with torch.no_grad():
        pc = model(hm.to(device), cams.to(device), train=True).proposal_centers[..., :3].cpu().numpy()
    roots = (pc + rng.uniform(-120, 120, pc.shape)).astype(np.float32)
    batch = {
        "input_heatmaps": hm, "cameras": cams,
        "2d_heatmaps": rng.rand(B, vx, vy).astype(np.float32),
        "1d_heatmaps": rng.rand(B, K, vz).astype(np.float32),
        "index": rng.randint(0, vx * vy, (B, K)).astype(np.float32),
        "bbox": (rng.rand(B, K, 2) * 0.5 + 0.3).astype(np.float32),
        "mask": np.tile(np.arange(K) < 2, (B, 1)),
        "roots_3d": roots, "num_person": np.full((B,), 2, np.int32),
        "joints_3d": (roots[:, :, None] + rng.uniform(-200, 200, (B, K, J, 3))).astype(np.float32),
        "joints_3d_vis": np.ones((B, K, J), np.float32),
    }
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _train_step_grads(cfg, state, batch, dev):
    """Losses and parameter gradients of one train-mode forward and
    backward of the small model from `state` on `dev`."""
    from faster_voxelpose_tpu_torch.engine.trainer import Trainer
    from faster_voxelpose_tpu_torch.models import build_model

    model = build_model(cfg)
    model.load_state_dict(state)
    tr = Trainer(cfg, model.to(dev))
    tr.model.zero_grad(set_to_none=True)
    loss = tr.loss({k: v.to(dev) for k, v in batch.items()})
    loss["total"].backward()
    return ({k: float(v.detach()) for k, v in loss.items()},
            {k: p.grad.detach().double().cpu() for k, p in tr.model.named_parameters()})


def _step_gap(ref, got, floor):
    """(worst relative loss error, {tensor: relative L2 gradient error})
    of step `got` against step `ref`; a gradient norm below `floor` of the
    model's largest is taken as that floor."""
    (l_ref, g_ref), (l_got, g_got) = ref, got
    d_loss = max(abs(l_got[k] - v) / max(abs(v), 1e-30) for k, v in l_ref.items())
    scale = max(float(g.norm()) for g in g_ref.values())
    rel = {k: float((g_got[k] - g).norm()) / max(float(g.norm()), floor * scale)
           for k, g in g_ref.items()}
    return d_loss, rel


def train_parity_readings(card):
    """One train step of the small seeded model on the card against the
    same step on the CPU, same weights and batch, in three settings:
    float64 and float32 conv stacks on both devices, and a control with
    bf16 conv stacks on the card against float32 on the CPU, which is what
    a cast to a narrower type on the card's path looks like.  Returns
    {setting: (worst relative loss error, worst relative L2 gradient
    error)}, gradients below 1e-4 of the largest norm taken against that
    floor (see train_parity_phase)."""
    from faster_voxelpose_tpu_torch.geometry import dome_rig

    readings = {}
    for dtype in ("float64", "float32", "bfloat16"):
        if dtype != "bfloat16":  # the control reuses float32's weights, batch and CPU step
            cfg = small_config(dtype)
            cfg.TRAIN.ACCUMULATION_STEPS, cfg.TRAIN.LR = 2, 1e-3
            model = small_model(cfg)
            cams = dome_rig(2, 3, space_center=cfg.CAPTURE_SPEC.SPACE_CENTER,
                            ori_image_size=cfg.DATASET.ORI_IMAGE_SIZE, focal=240.0)
            batch = anchored_batch(cfg, model, cams, np.random.RandomState(5), "cpu")
            state = {k: v.clone() for k, v in model.state_dict().items()}
            ref = _train_step_grads(cfg, state, batch, "cpu")
            if min(ref[0]["joint"], ref[0]["1d_heatmaps"]) <= 0:
                raise AssertionError(f"train parity: a loss term is inactive: {ref[0]}")
        got = _train_step_grads(small_config(dtype), state, batch, CARD)
        d_loss, rel = _step_gap(ref, got, 1e-4)
        name = max(rel, key=rel.get)
        label = "bf16 on the card against float32 on the CPU (control)" \
            if dtype == "bfloat16" else f"{dtype} conv stacks"
        extra = ""
        if dtype == "float64":  # the same reading with a floor of 1e-6
            fine = _step_gap(ref, got, 1e-6)[1]
            k6 = max(fine, key=fine.get)
            extra = f"; with a 1e-6 floor worst {fine[k6]:.3g} ({k6})"
        print(f"train parity ({label}): card losses {got[0]} rel {d_loss:.3g}; gradients worst "
              f"rel L2 {rel[name]:.3g} ({name}), {sum(v > 1e-3 for v in rel.values())}/{len(rel)} "
              f"tensors above 1e-3{extra} | {card}")
        readings[dtype] = (d_loss, rel[name])
    return readings


def train_parity_phase(card):
    """Holds the readings of `train_parity_readings`.

    float64 conv stacks: losses within 1e-4 relative, every gradient
    tensor within 1e-3 relative L2.  float32 carries its own rounding: its
    train-mode U-Net gradients are 3e-3 to 9e-3 from a float64 run on any
    device (tests/test_torch_train.py), so float32 is held to the limits
    F32_LOSS_TOL and F32_GRAD_TOL, set between its reading on the card and
    the bf16 control's, and the control must break both.

    A gradient below 1e-4 of the model's largest norm is a near-cancelling
    sum (a conv bias before a train-mode BatchNorm is exactly 0; P2PNet's
    output bias is 6e-6 of the largest): for such a tensor the error is
    taken against that 1e-4 floor.  A 1e-7 change of the input heatmaps,
    the size of the kernels' difference from their plain versions, moves
    that output bias by 3.4e-3 relative in float64 and no gradient above
    1e-2 of the largest by more than 1.6e-4 (measured on the CPU)."""
    r = train_parity_readings(card)
    bounds = {"float64": (1e-4, 1e-3), "float32": (F32_LOSS_TOL, F32_GRAD_TOL)}
    for dtype, (loss_tol, grad_tol) in bounds.items():
        d_loss, d_grad = r[dtype]
        if not (d_loss <= loss_tol and d_grad <= grad_tol):
            raise AssertionError(f"train step card vs CPU ({dtype}): losses {d_loss} > {loss_tol} "
                                 f"or gradients {d_grad} > {grad_tol}")
    d_loss, d_grad = r["bfloat16"]
    if not (d_loss > F32_LOSS_TOL and d_grad > F32_GRAD_TOL):
        raise AssertionError(f"the bf16 control passes the float32 limits: losses {d_loss}, "
                             f"gradients {d_grad}")


def synthetic_loader(cfg, n_batches, seed=0):
    """The port's own synthetic scenes for `cfg`: the demo rig and pose
    bank of its make_demo_data.py line, made here from seeds."""
    from faster_voxelpose_tpu_torch.datasets import SyntheticDataset
    from faster_voxelpose_tpu_torch.datasets.demo_data import demo_pose_bank, demo_rig
    from faster_voxelpose_tpu_torch.engine.loader import make_loader

    cfg.SYNTHETIC.NUM_DATA = n_batches * cfg.TRAIN.BATCH_SIZE
    ds = SyntheticDataset(cfg, pose_bank=demo_pose_bank(cfg), cameras=demo_rig(cfg))
    return make_loader(ds, cfg.TRAIN.BATCH_SIZE, shuffle=True, drop_last=True, seed=seed)


def fixed_batch_check(cfg, model, batch, label, terms, steps=8):
    """The JAX package's own training check (tests/test_training.py:21-86:
    LR 1e-3, ACCUMULATION_STEPS 2): `steps` train steps on one batch give
    finite losses and lower the sum of the loss `terms` below 0.9 of its
    first value.  Returns that sum at every step."""
    import copy

    from faster_voxelpose_tpu_torch.engine.trainer import Trainer

    fcfg = copy.deepcopy(cfg)
    fcfg.TRAIN.LR, fcfg.TRAIN.ACCUMULATION_STEPS = 1e-3, 2
    tr = Trainer(fcfg, model)
    watched = []
    for i in range(steps):
        losses = {k: float(v) for k, v in tr.step(batch).items()}
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"non-finite loss at {label} step {i}: {losses}")
        watched.append(sum(losses[t] for t in terms))
        print(f"train {label} step {i}: " + " ".join(f"{k} {v:.6g}" for k, v in losses.items()))
    what = " + ".join(terms)
    print(f"train {label}: people {batch['num_person'].tolist()}, {what} loss "
          f"{watched[0]:.6g} -> {watched[-1]:.6g} ({watched[-1] / watched[0]:.4f} of the first)")
    if not watched[-1] < 0.9 * watched[0]:
        raise AssertionError(f"{label}: the {what} loss did not fall below 0.9x: {watched}")
    return watched


def training_phase(card, fresh_steps=20):
    """Full-width training on the card at the Panoptic profile (bf16 conv
    stacks, batch 4) from seeded random weights.

    First the JAX package's own check (`fixed_batch_check`) on the first
    batch of synthetic scenes from the port's generator, heatmaps rendered
    on the card: the detection loss (2D + 1D) must fall.  Then
    `fresh_steps` timed steps on fresh synthetic batches at the profile's
    LR 1e-4 and ACCUMULATION_STEPS 4.  Returns the kernels' launches over
    the timed steps."""
    import time

    import torch

    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile
    from faster_voxelpose_tpu_torch.engine.trainer import Trainer, batch_to_device
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    cfg = panoptic_synthetic_profile()
    B = cfg.TRAIN.BATCH_SIZE
    batches = iter(synthetic_loader(cfg, 1 + fresh_steps))
    torch.manual_seed(1)
    model = build_model(cfg).cuda()
    fixed_batch_check(cfg, model, batch_to_device(next(batches), "cuda"), "synthetic batch",
                      ("2d_heatmaps", "1d_heatmaps"))

    tr = Trainer(cfg, model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    device_ms, data_ms = [], []
    t_start = time.perf_counter()
    for i in range(fresh_steps):
        t0 = time.perf_counter()
        batch = batch_to_device(next(batches), "cuda")
        data_ms.append((time.perf_counter() - t0) * 1e3)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        losses = tr.step(batch)
        b.record()
        b.synchronize()
        device_ms.append(a.elapsed_time(b))
        if not all(torch.isfinite(v) for v in losses.values()):
            raise AssertionError(f"non-finite loss at fresh step {i}: {losses}")
    wall = time.perf_counter() - t_start
    launches = sk.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / fresh_steps for k, v in launches.items()}
    print(f"train fresh batches: {fresh_steps} steps of batch {B}: device ms/step median "
          f"{np.median(device_ms):.3f} (min {min(device_ms):.3f} max {max(device_ms):.3f}), host "
          f"data ms/batch median {np.median(data_ms):.3f}, samples/s {fresh_steps * B / wall:.3f} "
          f"(data and steps in series), peak memory {peak / 2**30:.3f} GiB, launches per step "
          f"{per_step}, last losses {({k: round(float(v), 6) for k, v in losses.items()})} | {card}")
    # the whole-space sampler once per forward (one batch), the crop sampler
    # once per sample, the coords mode never
    want = {"sample_whole_projected": fresh_steps, "sample_crop_planes": B * fresh_steps,
            "sample_whole": 0}
    for name, count in want.items():
        if launches[name] != count:
            raise AssertionError(f"{name} launched {launches[name]} times in {fresh_steps} steps "
                                 f"of {B}, expected {count}")
    return launches


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
    route = ("sample_whole_projected", "sample_crop_planes")  # the default route's kernels

    n_true = np.mean([len(p) for p in scenes])
    n_det = np.mean([r["n_people"] for r in results])
    errs = [e for p, r in zip(scenes, results) for e in matched_mpjpe(p, r["poses_mm"])]
    stats = svc.stats()
    print(f"serving: {json.dumps(stats)} | {card}")
    print(f"serving: {N_REQUESTS} requests, mean true people {n_true:.3f}, mean detected "
          f"{n_det:.3f}, matched {len(errs)}, MPJPE median {np.median(errs) if errs else float('nan'):.2f} "
          f"mm mean {np.mean(errs) if errs else float('nan'):.2f} mm, launches {launches}")
    for name, count in launches.items():  # once per request (batch 1) each, no other kernel
        if count != (N_REQUESTS if name in route else 0):
            raise AssertionError(f"{name} launched {count} times for {N_REQUESTS} requests")
    if not any(r["n_people"] for r in results):
        raise AssertionError("no person detected in any frame")
    if not errs or not np.median(errs) < 150.0:
        raise AssertionError(f"median matched MPJPE {np.median(errs) if errs else None} >= 150 mm")
    for r in results:
        if not np.isfinite(np.asarray(r["poses_mm"], np.float64)).all():
            raise AssertionError("non-finite poses")
    return launches


def answers_gap(got, want):
    """(whether every request found the same people, the largest gap in
    mm between their fused poses)."""
    same, worst = True, 0.0
    for a, b in zip(got, want):
        if a["n_people"] != b["n_people"]:
            same = False
        elif a["n_people"]:
            worst = max(worst, float(np.abs(np.asarray(a["poses_mm"])
                                            - np.asarray(b["poses_mm"])).max()))
    return same, worst


def percentiles(ms):
    return f"p50 {np.percentile(ms, 50):.4f} ms p95 {np.percentile(ms, 95):.4f} ms"


def graph_against_eager(label, got, want, f32, card):
    """Hold compiled answers to eager ones: the same people in every
    request, and in float32 (TF32 off) fused poses within 0.01 mm (bit for
    bit is expected; cuBLAS or cuDNN may choose another algorithm under
    capture).  In bf16 the gap is printed, not judged: the float32
    reading is the witness."""
    same, worst = answers_gap(got, want)
    people = [a["n_people"] for a in got]
    print(f"compiled [{label}]: {len(got)} requests, graph against eager: same people {same} "
          f"{people}, fused poses within {worst:.3g} mm "
          f"({'float32, limit 0.01' if f32 else 'bf16, recorded'}) | {card}")
    if not (same and sum(people) > 0):
        raise AssertionError(f"compiled [{label}]: the graph finds other people than eager")
    if f32 and not worst <= 0.01:
        raise AssertionError(f"compiled [{label}]: float32 graph {worst} mm from eager")
    return worst


def compiled_phase(cfg, rig, card, rng, requests=N_REQUESTS):
    """The compiled service (PoseService's CUDA graphs, captured at
    construction) at the Panoptic profile with the committed weights:
    `requests` rendered requests through an eager and a compiled service,
    in float32 and in bf16 as served (`graph_against_eager`); rows 1 and
    2 once per replayed request; a rig hot-swap with no recapture, held to
    eager on the new rig and bit for bit to the first answers on the way
    back; the 'images_u8' graph on uint8 frames through a seeded random
    ResNet-50 (every slot valid) held the same way; a forward holding a
    host synchronisation, whose capture must raise; the JSON-lines server
    (tools/serve.py) in a subprocess.  Prints eager and compiled latency
    p50 / p95 from frames on the card and from numpy frames, and one
    replay's device ms between two CUDA events.  Returns the launches of
    the compiled bf16 heatmap requests."""
    import copy
    import subprocess
    import tempfile

    import torch

    from faster_voxelpose_tpu_torch.datasets.demo_data import (
        RIG_RADIUS_MM,
        make_rig,
        write_calibration,
    )
    from faster_voxelpose_tpu_torch.datasets.shelf_campus import load_flat_calibration
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.geometry import dome_rig, pack_rig
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    with np.load(ROOT / "checkpoints/panoptic_synthetic/model_best.npz") as npz:
        variables = {k: npz[k] for k in npz.files}
    d, center = cfg.DATASET, cfg.CAPTURE_SPEC.SPACE_CENTER
    most = min(6, cfg.CAPTURE_SPEC.MAX_PEOPLE)
    scenes = [make_people(rng, int(rng.randint(1, most + 1)), center) for _ in range(requests)]
    frames = [render_frame(p, rig, cfg, CARD) for p in scenes]
    rig2 = dome_rig(1, d.CAMERA_NUM, space_center=center, seed=200,
                    radius_range=(2900.0, 3500.0))[0]
    frames2 = [render_frame(p, rig2, cfg, CARD) for p in scenes[:8]]
    torch.cuda.synchronize()

    f32 = copy.deepcopy(cfg)
    f32.NETWORK.COMPUTE_DTYPE = "float32"
    launches = {}
    for label, c in (("float32", f32), (cfg.NETWORK.COMPUTE_DTYPE, cfg)):
        eager = PoseService(c, variables=variables, rig=rig, device=CARD, aot=False)
        t0 = time.perf_counter()
        svc = PoseService(c, variables=variables, rig=rig, device=CARD)
        capture_s = time.perf_counter() - t0
        if svc.warmup() != ["heatmaps"]:
            raise AssertionError(f"compiled: captured {svc.warmup()}, expected ['heatmaps']")
        for f in frames[:3]:
            eager.infer_heatmaps(f)  # the compiled one warmed in its capture
        want = [eager.infer_heatmaps(f) for f in frames]
        sk.reset_launch_counts()
        got = [svc.infer_heatmaps(f) for f in frames]
        counts = sk.launch_counts()
        expect = {n: 0 for n in counts}
        expect.update({"sample_whole_projected": requests, "sample_crop_planes": requests})
        if counts != expect:
            raise AssertionError(f"compiled [{label}]: launches {counts}, expected {expect}")
        graph_against_eager(f"{label} heatmaps", got, want, c is f32, card)
        errs = [e for p, r in zip(scenes, got) for e in matched_mpjpe(p, r["poses_mm"])]
        print(f"compiled [{label}]: service built and heatmaps captured in {capture_s:.2f} s; "
              f"launches {counts}; matched MPJPE median {np.median(errs):.3f} mm | {card}")
        launches = counts

        # rig hot-swap: no recapture, eager's answers on the new rig, the
        # first answers bit for bit on the way back
        graph = svc._compiled["heatmaps"]
        svc.set_rig(rig2)
        eager.set_rig(rig2)
        swapped = [svc.infer_heatmaps(f) for f in frames2]
        graph_against_eager(f"{label} rig swap", swapped,
                            [eager.infer_heatmaps(f) for f in frames2], c is f32, card)
        svc.set_rig(rig)
        back = [svc.infer_heatmaps(f) for f in frames[:8]]
        if svc._compiled["heatmaps"] is not graph or sorted(svc._compiled) != ["heatmaps"]:
            raise AssertionError(f"compiled [{label}]: the rig swap recaptured")
        if [a["poses_mm"] for a in back] != [a["poses_mm"] for a in got[:8]]:
            raise AssertionError(f"compiled [{label}]: swapping the rig back changed the answers")
        print(f"compiled [{label}]: rig swap and back: the same graph ({svc.stats()['compiled']}), "
              f"the first answers bit for bit | {card}")

        if c is cfg:  # latency as served: frames on the card, then as numpy arrays
            host = [f.cpu().numpy() for f in frames]
            lat = {}
            for name, service in (("eager", eager), ("compiled", svc)):
                for src, fs in (("card", frames), ("numpy", host)):
                    lat[name, src] = [service.infer_heatmaps(f)["latency_ms"] for f in fs]
            g = svc._compiled["heatmaps"]
            replay_ms = []
            for _ in range(20):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                g.graph.replay()
                b.record()
                b.synchronize()
                replay_ms.append(a.elapsed_time(b))
            print("compiled: latency per heatmap request (host clock, call to poses on the host), "
                  + "; ".join(f"{n} from {src} frames {percentiles(v)}" for (n, src), v in lat.items())
                  + f"; one replay's device time (CUDA events) median {np.median(replay_ms):.4f} ms, "
                  f"min {min(replay_ms):.4f} | {card}")
        del eager, svc

    # the images_u8 graph: random uint8 frames, a seeded random ResNet-50,
    # every slot valid
    iw, ih = d.IMAGE_SIZE
    img_rng = np.random.RandomState(22)
    u8 = [img_rng.randint(0, 256, (d.CAMERA_NUM, ih, iw, 3)).astype(np.uint8)
          for _ in range(requests)]
    for label, c in (("float32", f32), (cfg.NETWORK.COMPUTE_DTYPE, cfg)):
        every = copy.deepcopy(c)
        every.CAPTURE_SPEC.MIN_SCORE = -1e9
        eager = PoseService(every, variables=variables, rig=rig, device=CARD, seed=0, aot=False)
        svc = PoseService(every, variables=variables, rig=rig, device=CARD, seed=0)
        if svc.warmup(("images_u8",)) != ["heatmaps", "images_u8"]:
            raise AssertionError("compiled: the images_u8 graph was not captured")
        for f in u8[:3]:
            eager.infer_images(f)
        want = [eager.infer_images(f) for f in u8]
        sk.reset_launch_counts()
        got = [svc.infer_images(f) for f in u8]
        counts = sk.launch_counts()
        if counts["sample_whole_projected"] != requests or counts["sample_crop_planes"] != requests:
            raise AssertionError(f"compiled [{label} images_u8]: launches {counts}")
        graph_against_eager(f"{label} images_u8", got, want, c is f32, card)
        if c is cfg:
            lat = {n: [s.infer_images(f)["latency_ms"] for f in u8] for n, s in
                   (("eager", eager), ("compiled", svc))}
            print("compiled: latency per image request (5 uint8 frames from numpy), "
                  + "; ".join(f"{n} {percentiles(v)}" for n, v in lat.items()) + f" | {card}")
        del eager, svc

    # negative control: a forward that reads a value back to the host
    # cannot be captured, and the service's capture raises
    bad = PoseService(cfg, variables=variables, rig=rig, device=CARD, aot=False)
    forward = bad.model.forward

    def synced(*args, **kwargs):
        out = forward(*args, **kwargs)
        out.fused_poses.sum().item()  # a host synchronisation
        return out

    bad.model.forward = synced
    try:
        bad.warmup(("heatmaps",))
    except RuntimeError as e:
        raised = f"{type(e).__name__}: {str(e).strip().splitlines()[0][:160]}"
    else:
        raise AssertionError("compiled: a forward holding a host synchronisation was captured")
    if bad._compiled:
        raise AssertionError(f"compiled: a failed capture left graphs {sorted(bad._compiled)}")
    del bad.model.forward
    after = bad.infer_heatmaps(frames[0])
    print(f"compiled: negative control, capturing a forward with .item() raised {raised!r}; the "
          f"service then answered eagerly ({after['n_people']} people) | {card}")
    if not after["n_people"]:
        raise AssertionError("compiled: no answer after the failed capture")
    del bad

    # the JSON-lines server on the card, in a subprocess
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        radius = RIG_RADIUS_MM[d.DATADIR]
        for name, r, seed in (("calib.json", radius, 0), ("calib2.json", radius * 1.1, 1)):
            write_calibration(str(tmp / name), make_rig(d.CAMERA_NUM, r, 2200.0, center[:2],
                                                        d.ORI_IMAGE_SIZE, seed=seed))
        cams = load_flat_calibration(str(tmp / "calib.json"))
        served_rig = pack_rig([cams[k] for k in sorted(cams)]).astype(np.float32)
        frame = render_frame(scenes[0], served_rig, cfg, CARD)
        np.save(tmp / "frame.npy", frame.cpu().numpy())
        images = [str(tmp / f"v{v}.jpg") for v in range(d.CAMERA_NUM)]
        try:  # image files where cv2 is installed; else the answer must name it
            import cv2
        except ImportError:
            cv2 = None
        if cv2 is not None:
            ori_w, ori_h = d.ORI_IMAGE_SIZE
            for path in images:
                cv2.imwrite(path, rng.randint(0, 256, (ori_h, ori_w, 3)).astype(np.uint8))
        lines = ["not json"] + [json.dumps(r) for r in (
            {"cmd": "ping"},
            {"cmd": "infer", "heatmaps": str(tmp / "frame.npy")},
            {"cmd": "infer", "images": images},
            {"cmd": "rig", "calibration": str(tmp / "calib2.json")},
            {"cmd": "infer", "heatmaps": str(tmp / "frame.npy")},
            {"cmd": "stats"},
            {"cmd": "quit"},
        )]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "faster_voxelpose_tpu_torch.tools.serve", "--best-from",
             "checkpoints/panoptic_synthetic", "--calibration", str(tmp / "calib.json")],
            input="\n".join(lines) + "\n", capture_output=True, text=True, cwd=ROOT,
            timeout=600)
        server_s = time.perf_counter() - t0
        local = PoseService(cfg, variables=variables, rig=served_rig, device=CARD)
        want = local.infer_heatmaps(frame)
        want_images = local.infer_image_paths(images) if cv2 is not None else None
        del local
    out = [json.loads(line) for line in proc.stdout.splitlines()]
    print(f"compiled: server (python3 -m faster_voxelpose_tpu_torch.tools.serve --best-from "
          f"checkpoints/panoptic_synthetic) exited {proc.returncode} after {server_s:.1f} s; "
          f"answers: {json.dumps([{k: v for k, v in a.items() if k not in ('poses_mm', 'scores')} for a in out])}"
          f"; stderr tail {proc.stderr.strip()[-300:]!r} | {card}")
    if proc.returncode != 0 or len(out) != 9:
        raise AssertionError(f"compiled: server exited {proc.returncode} with {len(out)} lines")
    ready, bad_json, ping, first, image_answer, swap, second, stats, bye = out
    checks = {
        "ready": ready.get("ready") is True and ready.get("random_init") is False,
        "bad json": "bad json" in bad_json.get("error", ""),
        "ping": ping == {"ok": True},
        "infer": answers_gap([first], [want])[0] and first["n_people"] > 0
                 and np.isfinite(np.asarray(first["poses_mm"], np.float64)).all(),
        "images": ("n_people" in image_answer and answers_gap([image_answer], [want_images])[0]
                   if cv2 is not None else "cv2" in image_answer.get("error", "")),
        "rig": swap == {"ok": True} and "n_people" in second,
        "stats": stats.get("compiled") == ["heatmaps"]
                 and str(stats.get("device", "")).startswith("cuda")
                 and stats.get("requests") == (3 if cv2 is not None else 2),
        "quit": bye == {"ok": True, "bye": True},
    }
    print(f"compiled: server checks {checks}; its first answer {first['n_people']} people, "
          f"within {answers_gap([first], [want])[1]:.3g} mm of this process's compiled service; "
          f"image files ({'cv2 ' + cv2.__version__ if cv2 is not None else 'no cv2'}): "
          f"{image_answer.get('n_people', image_answer.get('error'))} | {card}")
    if not all(checks.values()):
        raise AssertionError(f"compiled: server checks failed: {checks}")
    return launches


def window_footprint(coords, cfg, width, height):
    """coords (NB, V, 2, S) -> (NB, V, 4) int64: per block and view the
    pixels x lo, x hi, y lo, y hi (inclusive) whose values the window
    kernel stages (csrc/window.cu), floor(min) .. floor(max) + 1 of the
    block's coords on each axis clipped to the window; lo > hi where no
    tap of the view lies inside it."""
    import torch

    from faster_voxelpose_tpu_torch.ops.window_kernels import window_origin

    bounds = []
    for c, size, win in ((coords[:, :, 0], width, cfg.xw), (coords[:, :, 1], height, cfg.yw)):
        lowest = c.amin(-1)
        o = window_origin(lowest, size - win).to(c.dtype)
        bounds.append(torch.minimum(torch.maximum(lowest.floor(), o), o + win))
        bounds.append(torch.maximum(torch.minimum(c.amax(-1).floor() + 1, o + win - 1), o - 1))
    return torch.stack(bounds, -1).long()


def staged_bytes(coords, cfg, width, height):
    """Bytes the window kernel copies into shared memory for `coords`: its
    footprints' pixels times 64 (16 float32 joints), computed on the host."""
    f = window_footprint(coords, cfg, width, height)
    nx, ny = (f[..., 1] - f[..., 0] + 1).clamp_min(0), (f[..., 3] - f[..., 2] + 1).clamp_min(0)
    return int((nx * ny).sum()) * 64


def edge_coords(s, rng, views=5, width=240, height=128):
    """(6, views, 2, s) float32 block coords at the image's edges: blocks
    that run past the left, right, top and bottom edges (window origins
    clipped at 0 and at W - XW or H - YW), one of samples on integer
    pixels up to the last column and row, and one wholly past the right
    edge, where no tap lies inside any window."""
    coords = np.empty((6, views, 2, s), np.float32)
    mid = rng.uniform([[30], [30]], [[width - 30], [height - 30]], (6, views, 2, 1))
    coords[:] = mid + rng.uniform(-5, 5, (6, views, 2, s))
    coords[0, :, 0] = rng.uniform(-6, 4, (views, s))
    coords[1, :, 0] = rng.uniform(width - 5, width + 5, (views, s))
    coords[2, :, 1] = rng.uniform(-6, 4, (views, s))
    coords[3, :, 1] = rng.uniform(height - 5, height + 5, (views, s))
    coords[4, :, 0] = rng.randint(width - 12, width, (views, s))
    coords[4, :, 1] = rng.randint(height - 12, height, (views, s))
    coords[4, :, :, 0] = (width - 1, height - 1)
    coords[5, :, 0] = rng.uniform(width + 1, width + 9, (views, s))
    return coords


def library_window(hm, coords):
    """grid_sample yardstick of the window kernel: a closure that samples
    block coords (n, V, 2, S) bilinearly, takes the view mean and clamps,
    -> (J, 1, n * S).  Layout changes are made once, outside the closure."""
    import torch
    import torch.nn.functional as F

    from faster_voxelpose_tpu_torch.tools.probe_sampling import flat_pixels

    V, H, W, J = hm.shape
    scale = torch.tensor([2.0 / (W - 1), 2.0 / (H - 1)], device=hm.device)
    norm = (flat_pixels(coords) * scale - 1.0)[:, None]  # (V, 1, n * S, 2)
    hm_nchw = hm.permute(0, 3, 1, 2).contiguous()
    return lambda: F.grid_sample(hm_nchw, norm, align_corners=True,
                                 padding_mode="zeros").mean(0).clamp(0, 1)


def window_full_err(hm, coords, cfg):
    """Max error of the window kernel against its plain version on the
    tool's own full-scale inputs, the ones its time was read on; held to
    1e-5 like the 64-block check."""
    import torch

    from faster_voxelpose_tpu_torch.ops import window_kernels as wk

    out = wk.window_sample(hm, coords, cfg)
    err = float((out - wk.window_sample_plain(hm, coords, cfg)).abs().max())
    if not (err <= TOL and torch.isfinite(out).all()):
        raise AssertionError(f"window_sample {cfg} disagrees with its plain version on "
                             f"{coords.shape[0]} blocks: {err}")
    return err


def window_row(name, replaces, cfg, ms, hm, coords, err, card, **extra):
    """Table row of one window-kernel configuration timed at `ms` on
    `coords`, `err` its error against the plain version on those coords:
    the plain version and the grid_sample yardstick timed on the same
    inputs, and the function's bound (the heatmaps and coords read once,
    the (NB, 16, S) output written once; a bilinear sample's operations as
    for sample_whole).  The phase's own line also prints the bytes the
    kernel stages in shared memory for these coords, computed on the host
    from its footprints, not measured."""
    from faster_voxelpose_tpu_torch.ops import window_kernels as wk
    from faster_voxelpose_tpu_torch.tools.timing import time_ms

    V, H, W, J = hm.shape
    NB, S = coords.shape[0], cfg.s
    n = NB * S
    b_ms, b_by = bound(4 * (hm.numel() + coords.numel() + NB * wk.JP * S),
                       n * V * (12 + 8 * J) + 2 * n * J)
    library = library_window(hm, coords)
    lib_err = float((library()[:, 0].reshape(J, NB, S).permute(1, 0, 2)
                     - wk.window_sample(hm, coords, cfg)[:, :J]).abs().max())
    row = dict(name=name, source="faster_voxelpose_tpu_torch/csrc/window.cu", replaces=replaces,
               path="tools", ms=ms,
               plain_ms=time_ms(lambda: wk.window_sample_plain(hm, coords, cfg), reps=5, warm=1),
               **library_readings(library), bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
               config=cfg.label(), **extra,
               **device_readings(lambda: wk.window_sample(hm, coords, cfg)))
    staged = staged_bytes(coords, cfg, W, H)
    print(f"kernel {name} [{cfg.label()}]: err {err:.3g} (kernel against library {lib_err:.3g}) "
          f"kernel_ms {fmt(row)} plain_ms {row['plain_ms']:.4f} {fmt_library(row)} "
          f"bound_ms {b_ms:.4f} ({b_by}) blocks {NB} samples {n * V}; staged in shared memory "
          f"{staged / 1e6:.1f} MB per launch (computed from the footprints, not measured) | {card}")
    return row


def window_phase(card):
    """Kernel rows 5 and 6.  Every instantiation of the window kernel
    against its plain version on 64 blocks, at a spread every window covers
    (6) and at the sweep's default (12), and on the six blocks of
    `edge_coords` (origins clipped at both ends of each axis, integer
    pixels, a block with no tap inside its windows), within 1e-5: the
    plain version rounds its operands as the kernel does, so one tolerance
    serves the three precisions.  Each one's error against the exact bilinear sampler
    is printed; it is judged (1e-5) only for float32 at the covered spread.
    Then the probe and the sweep run at full scale as a user would run
    them, and every configuration is held against its plain version again
    on the tool's own coords (10240 blocks of 256, 1e-5): that error is the
    rows' `max_abs_err`.  Returns the two rows and the launches of the two
    tools."""
    import torch

    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk
    from faster_voxelpose_tpu_torch.ops import window_kernels as wk
    from faster_voxelpose_tpu_torch.tools import probe_sampling as ps
    from faster_voxelpose_tpu_torch.tools import sweep_sampling as sw

    rng = np.random.RandomState(1)
    hm = torch.as_tensor(rng.rand(ps.V, ps.H, ps.W, ps.J).astype(np.float32), device=CARD)
    draws = {"spread 6": lambda s: sw.sweep_coords(64, s, 6.0, rng),
             "spread 12": lambda s: sw.sweep_coords(64, s, 12.0, rng),
             "edges": lambda s: edge_coords(s, rng)}
    for label, draw in draws.items():
        for cfg in wk.SWEEP_CONFIGS:  # the probe's configuration is the first
            coords = torch.as_tensor(draw(cfg.s), device=CARD)
            out, ref = wk.window_sample(hm, coords, cfg), wk.window_sample_plain(hm, coords, cfg)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            exact = float((out - ps.exact_reference(hm, coords)).abs().max())
            print(f"window {cfg.label()} {label}: against its plain version {err:.3g}, "
                  f"against the exact sampler {exact:.3g}")
            if not (err <= TOL and torch.isfinite(out).all()):
                raise AssertionError(f"window_sample {cfg} disagrees with its plain version: {err}")
            if label == "spread 6" and cfg.prec == "fp32" and not exact <= TOL:
                raise AssertionError(f"window_sample {cfg} differs from the exact sampler: {exact}")

    sk.reset_launch_counts()
    probe = ps.main([])
    # the probe's gather baseline is row 1's coords mode
    launches = {k: sk.launch_counts()[k] for k in ("window_sample", "sample_whole")}
    sk.reset_launch_counts()
    rows_sweep = sw.main([])
    launches["window_sample_sweep"] = sk.launch_counts()["window_sample"]

    row5 = window_row("window_sample", "scripts/probe_pallas.py:117", probe["config"],
                      probe["window_ms"], probe["heatmaps"], probe["coords"],
                      window_full_err(probe["heatmaps"], probe["coords"], probe["config"]),
                      card, gather_ms=probe["gather_ms"])
    for r in rows_sweep:
        r["full_err"] = window_full_err(r["heatmaps"], r["coords"], r["config"])
        staged = staged_bytes(r["coords"], r["config"], ps.W, ps.H)
        print(f"window {r['config'].label()} on the sweep's {r['blocks']} blocks: against its "
              f"plain version {r['full_err']:.3g}; staged in shared memory {staged / 1e6:.1f} MB "
              f"per launch (computed from the footprints, not measured)")
    exact_rows = [r for r in rows_sweep if r["err"] <= TOL]
    if not exact_rows:
        raise AssertionError("no sweep configuration agrees with the exact sampler")
    best = min(exact_rows, key=lambda r: r["ms"])
    configs = [dict(config=r["config"].label(), ms=r["ms"], ns_per_sample=r["ns_per_sample"],
                    err_exact=r["err"], max_abs_err=r["full_err"]) for r in rows_sweep]
    row6 = window_row("window_sample_sweep", "scripts/sweep_pallas.py:83", best["config"],
                      best["ms"], best["heatmaps"], best["coords"], best["full_err"], card,
                      configs=configs)
    return [row5, row6], launches


def mma_build_report():
    """What the build says of csrc/mma_window.cu: ptxas registers and
    spills of each instantiation, and the count of HGMMA (wgmma)
    instructions in the built library's SASS, by the toolkit's
    cuobjdump.  Raises if cuobjdump is missing or finds no HGMMA, or if an
    instantiation uses more registers than the launch plan counts on
    (`window_kernels.MMA_REGS`)."""
    import re
    import subprocess

    from faster_voxelpose_tpu_torch.ops import cuda_build
    from faster_voxelpose_tpu_torch.ops import window_kernels as wk

    lib = cuda_build.library_path("mma_window")
    log = lib.with_suffix(".log").read_text()
    entries = re.findall(r"Compiling entry function '[^']*mma_window_kernelILi(\d+)ELb(\d)E[^']*'"
                         r".*?(\d+) bytes spill stores, (\d+) bytes spill loads"
                         r".*?Used (\d+) registers", log, re.S)
    for k, dyn, stores, loads, regs in entries:
        print(f"mma_window ptxas K={k} dyn={dyn}: {regs} registers, spill stores {stores} B, "
              f"spill loads {loads} B")
    if len(entries) != 6:
        raise AssertionError(f"mma_window: {len(entries)} instantiations in the ptxas report, not 6")
    regs = max(int(e[4]) for e in entries)
    if regs > wk.MMA_REGS:
        raise AssertionError(f"mma_window: {regs} registers per thread, the plan counts on "
                             f"{wk.MMA_REGS}")
    injected = log.count("warpgroup.arrive is injected")
    serialized = log.count("serialized")
    print(f"mma_window ptxas: warpgroup.arrive injected {injected} times, wgmma serialized "
          f"{serialized} times")
    cuobjdump = pathlib.Path(cuda_build.nvcc_path()).parent / "cuobjdump"
    if not cuobjdump.is_file():
        raise AssertionError(f"mma_window: no cuobjdump beside nvcc ({cuobjdump})")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    hgmma = len(re.findall(r"\bHGMMA\.", sass))
    print(f"mma_window SASS ({cuobjdump.name} -sass): {hgmma} HGMMA instructions")
    if hgmma <= 0:
        raise AssertionError("mma_window: the built library holds no HGMMA instruction")


def mma_phase(card):
    """Kernel row 7.  The build report (ptxas registers and spills, HGMMA
    count), and the launch plan of each K at the tool's shapes, held
    against the kernel's own layout and occupancy; both are printed on
    their own lines, not in the row.  The six cases against the plain
    version on 8 steps: the output is bf16, so the limit is one bf16 ulp
    of the value (2^-7 relative); the float32 sums inside differ only by
    the tensor cores' order.  Then the microbenchmark at full scale, and
    the six cases against the plain version again on the tool's own
    operands (512 steps, the same seed), to the same limit: the row's
    `max_abs_err` is that of the case whose time it reports.  That the
    product is really computed (only 8 of its 640 rows are stored) shows
    in the time: it must rise with K, rise with M, and stay under the
    card's bf16 peak; each case's share of its bound is printed."""
    import torch

    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk
    from faster_voxelpose_tpu_torch.ops import window_kernels as wk
    from faster_voxelpose_tpu_torch.tools import microbench_mma as mb
    from faster_voxelpose_tpu_torch.tools.timing import time_ms

    mma_build_report()
    device = wk.mma_device(torch.cuda.current_device())
    for k in (128, 64, 32):
        plan = wk.mma_plan(mb.M, mb.N, k, mb.B, *device)
        layout = wk.mma_kernel_layout(k, plan.a_stages)
        print(f"mma_window plan K={k} (M={mb.M}, N={mb.N}, B={mb.B}; {device[0]} SMs, "
              f"{device[1]} B shared memory per SM, {device[2]} B per block): tile "
              f"{plan.tile_m}x{plan.tile_n}, {plan.a_stages} A + {wk.MMA_B_STAGES} B stages, "
              f"{plan.smem} B dynamic shared memory, {plan.blocks_per_sm} block per SM, grid "
              f"{plan.grid}, {plan.tiles_per_step} tiles per step; the kernel's own (tile, "
              f"threads, shared memory, B stages, blocks per SM) {layout}")
        if layout != (plan.tile_m, plan.tile_n, wk.MMA_THREADS, plan.smem, wk.MMA_B_STAGES,
                      plan.blocks_per_sm):
            raise AssertionError(f"mma_window: the plan {plan} disagrees with the kernel's "
                                 f"layout {layout}")

    def compare(steps, seed):
        """{(k, dyn): max abs error} of the six cases on `steps` steps of
        operands made from `seed`."""
        errs = {}
        for k, dyn in mb.CASES:
            lhs, rhs, oy = mb.make_operands(steps, k, CARD, seed=seed)
            origin = oy if dyn else None
            out = wk.mma_window(lhs, rhs, origin, k, mb.NMAT).float()
            ref = wk.mma_window_plain(lhs, rhs, origin, k, mb.NMAT).float()
            torch.cuda.synchronize()
            rel = float(((out - ref).abs() / ref.abs().clamp_min(1e-30)).max())
            errs[(k, dyn)] = float((out - ref).abs().max())
            print(f"mma_window K={k} dyn={int(dyn)} B={steps}: against its plain version rel "
                  f"{rel:.3g} abs {errs[(k, dyn)]:.3g} (values up to {float(ref.max()):.3g})")
            if not (rel <= 2.0 ** -7 and torch.isfinite(out).all()):
                raise AssertionError(f"mma_window K={k} dyn={dyn} B={steps} disagrees with its "
                                     f"plain version: {rel}")
        return errs

    compare(8, 1)
    sk.reset_launch_counts()
    cases = mb.main([])
    launches = {"mma_window": sk.launch_counts()["mma_window"]}
    full_errs = compare(mb.B, mb.SEED)  # the operands the tool timed

    peak_tmacs = BF16_FLOPS / 2 / 1e12
    by_case = {(c["k"], c["dyn"]): c for c in cases}
    for c in cases:
        if not c["tmacs"] < peak_tmacs:
            raise AssertionError(f"mma_window K={c['k']}: {c['tmacs']} TMAC/s is above the peak")
        c["bound_ms"], _ = bound(2 * (mb.M * wk.MMA_ROWS + mb.B * c["k"] * mb.N + mb.B * 8 * mb.N),
                                 2 * mb.M * c["k"] * mb.N * mb.NMAT * mb.B, BF16_FLOPS)
        print(f"mma_window K={c['k']} dyn={int(c['dyn'])}: {c['ms']:.4f} ms against its bound "
              f"{c['bound_ms']:.4f} ms: {c['bound_ms'] / c['ms']:.3f} of it | {card}")
    for dyn in (False, True):
        t = [by_case[(k, dyn)]["ms"] for k in (128, 64, 32)]
        if not t[0] > t[1] > t[2]:
            raise AssertionError(f"mma_window: time does not rise with K (dyn={dyn}): {t}")
    k = 128
    lhs, rhs, _ = mb.make_operands(mb.B, k, CARD)
    half = lhs[:, :mb.M // 2].contiguous()
    t_full = time_ms(lambda: wk.mma_window(lhs, rhs, None, k, mb.NMAT))
    t_half = time_ms(lambda: wk.mma_window(half, rhs, None, k, mb.NMAT))
    print(f"mma_window K={k}: M={mb.M} {t_full:.4f} ms, M={mb.M // 2} {t_half:.4f} ms "
          f"({t_full / t_half:.3f}x) | {card}")
    if not t_full > 1.3 * t_half:
        raise AssertionError(f"mma_window: time does not rise with M: {t_full} against {t_half}")

    # yardstick: the sum of a step's nmat (M, K) x (K, N) products is one
    # (M, nmat K) x (nmat K, N) product of the operands concatenated along
    # K, so one bmm over the steps forms all of them with the kernel's
    # operations (the concatenated operands are made once, outside the
    # timed call).  Beside it, printed only: the same products stacked
    # along the batch, each written out, and one product per step
    left = lhs[:k].t().expand(mb.B, mb.M, k)
    left_cat = lhs[:k].t().repeat(1, mb.NMAT).expand(mb.B, mb.M, mb.NMAT * k)
    right_cat = rhs[:, None, :k].expand(mb.B, mb.NMAT, k, mb.N).reshape(mb.B, mb.NMAT * k, mb.N)
    lib = library_readings(lambda: torch.bmm(left_cat, right_cat))
    lib_err = float((torch.bmm(left_cat[:8], right_cat[:8])[:, :8].float() / mb.NMAT
                     - wk.mma_window_plain(lhs, rhs[:8], None, k, mb.NMAT).float()).abs().max())
    del right_cat
    stacked = rhs[:, None, :k].expand(mb.B, mb.NMAT, k, mb.N).reshape(mb.B * mb.NMAT, k, mb.N)
    stacked_ms = time_ms(lambda: torch.bmm(left[:1].expand(mb.B * mb.NMAT, mb.M, k), stacked))
    del stacked
    one_ms = time_ms(lambda: torch.bmm(left, rhs[:, :k]))
    b_ms, b_by = bound(2 * (lhs.numel() + mb.B * k * mb.N + mb.B * 8 * mb.N),
                       2 * mb.M * k * mb.N * mb.NMAT * mb.B, BF16_FLOPS)
    top = by_case[(k, False)]
    row = dict(name="mma_window", source="faster_voxelpose_tpu_torch/csrc/mma_window.cu",
               replaces="scripts/microbench_matmul.py:65", path="tools", ms=top["ms"],
               plain_ms=time_ms(lambda: wk.mma_window_plain(lhs, rhs, None, k, mb.NMAT),
                                reps=5, warm=1),
               **lib, bound_ms=b_ms, bound_by=b_by, max_abs_err=full_errs[(k, False)],
               cases=[dict({key: c[key] for key in ("k", "dyn", "ms", "us_per_product", "tmacs",
                                                    "macs_timed", "bound_ms")},
                           max_abs_err=full_errs[(c["k"], c["dyn"])]) for c in cases],
               **device_readings(lambda: wk.mma_window(lhs, rhs, None, k, mb.NMAT)))
    print(f"kernel mma_window [K={k} static, B={mb.B}, nmat={mb.NMAT}]: err "
          f"{row['max_abs_err']:.3g} kernel_ms {fmt(row)} plain_ms {row['plain_ms']:.4f} "
          f"library (one bmm, the {mb.NMAT} products of a step concatenated along K) "
          f"{fmt_library(lib)} (its 8 rows against the plain version {lib_err:.3g}; the {mb.NMAT} "
          f"products stacked along the batch {stacked_ms:.4f}, one product per step "
          f"{one_ms:.4f}) bound_ms {b_ms:.4f} ({b_by}) | {card}")
    return [row], launches


EVAL_AP50_BELOW_RECORD = 0.025  # the bf16 control reads about 0.04 below, the port 0.015
EVAL_MPJPE_ABOVE_RECORD = 1.5  # mm
EVAL_DETECTED_PER_PERSON = (0.97, 1.01)  # duplicate proposals push the bf16 control to 1.02
# shelf_synthetic_5k (5 of its 10 epochs) over-detects: 1.0087 people per person on its
# whole held-out set (27814 of 27574; AP@50 and MPJPE 0.0001 and 0.007 mm from its record)
# and 1.0108 on the 500-scene prefix, so its upper limit is 1.015, under the bf16 control's 1.02
EVAL_DETECTED_PER_PERSON_OF = {"shelf_synthetic_5k": (0.97, 1.015)}


def eval_limits(res, name="panoptic_synthetic"):
    """The limits of the eval phase on one reading of snapshot `name`;
    returns the list of those it breaks."""
    from faster_voxelpose_tpu_torch.tools.validate import metric_table

    got, rec = metric_table(res["message"]), metric_table(res["record"]["message"])
    per_person = res["detected"] / res["people"]
    lo, hi = EVAL_DETECTED_PER_PERSON_OF.get(name, EVAL_DETECTED_PER_PERSON)
    broken = []
    if not got["ap@50"] >= rec["ap@50"] - EVAL_AP50_BELOW_RECORD:
        broken.append(f"AP@50 {got['ap@50']} under the record's {rec['ap@50']} by more than "
                      f"{EVAL_AP50_BELOW_RECORD}")
    if not got["mpjpe@500mm"] <= rec["mpjpe@500mm"] + EVAL_MPJPE_ABOVE_RECORD:
        broken.append(f"MPJPE {got['mpjpe@500mm']} mm over the record's {rec['mpjpe@500mm']} mm "
                      f"by more than {EVAL_MPJPE_ABOVE_RECORD}")
    if not lo <= per_person <= hi:
        broken.append(f"{res['detected']} people detected where there are {res['people']} "
                      f"({per_person:.4f}, outside {lo}..{hi})")
    return broken


def eval_phase(card, scenes=500):
    """The evaluator on the first `scenes` held-out synthetic scenes with
    the committed weights, bf16 conv stacks as served, against the
    snapshot's own record (5000 scenes): AP@50 at least the record's less
    0.025, MPJPE at most the record's plus 1.5 mm, and between 0.97 and
    1.01 people detected for each one there is.  Two controls on the same
    scenes, made here by turning the heads' float32 sums off (`blocks.Conv`,
    `float32_out`): with every head rounded to bf16 the reading must break
    those limits (duplicate proposals from a bf16 centre heatmap); with the
    centre heatmap alone in float32 it is printed, to say what the other
    four heads' float32 sums change.  Returns the launches of the first
    run."""
    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile
    from faster_voxelpose_tpu_torch.engine.checkpoint import load_best_npz
    from faster_voxelpose_tpu_torch.models.faster_voxelpose import build_model
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk
    from faster_voxelpose_tpu_torch.tools import validate

    def control(float32_heads):
        model = load_best_npz(str(validate.DEFAULT_CHECKPOINT / "model_best.npz"),
                              build_model(panoptic_synthetic_profile()))
        rounded = validate.round_head_sums(model, keep=float32_heads)
        if len(rounded) != 5 - len(float32_heads):
            raise AssertionError(f"eval: expected five head layers with float32 sums: {rounded}")
        return validate.evaluate_snapshot(scenes=scenes, device=CARD, model=model)

    def line(name, res):
        return (f"eval [{name}]: {res['scenes']} held-out scenes, {res['detected']} people "
                f"detected where there are {res['people']}, {res['frames_per_s']:.3f} frames/s "
                f"(samples made on the host included) | {card}\n{res['message']}")

    sk.reset_launch_counts()
    res = validate.evaluate_snapshot(scenes=scenes, device=CARD)
    launches = sk.launch_counts()
    print(f"{line('as served', res)}\neval: launches {launches}\n"
          f"eval: the snapshot's record ({res['record']['eval_set']}):\n{res['record']['message']}")
    preds = res["preds"]
    if preds.shape[0] != scenes or preds.shape[2:] != (15, 5) or not np.isfinite(preds).all():
        raise AssertionError(f"eval: predictions of shape {preds.shape} or not finite")
    batches = -(-scenes // panoptic_synthetic_profile().TEST.BATCH_SIZE)
    want = {"sample_whole_projected": batches, "sample_crop_planes": scenes, "sample_whole": 0}
    for name, count in want.items():
        if launches[name] != count:
            raise AssertionError(f"eval: {name} launched {launches[name]} times for {scenes} "
                                 f"scenes in {batches} batches, expected {count}")
    broken = eval_limits(res)
    if broken:
        raise AssertionError("eval: " + "; ".join(broken))

    print(line("control: only the centre heatmap's sums in float32", control(("hm_out",))))
    rounded = control(())
    broken = eval_limits(rounded)
    print(line("control: every head rounded to bf16", rounded)
          + f"\neval: the bf16 control breaks: {broken}")
    if not broken:
        raise AssertionError("eval: the control with every head rounded to bf16 passes the limits")
    return launches


# the other committed snapshots, each scored on its own profile's scenes
PROFILE_SNAPSHOTS = ("panoptic_synthetic_w05", "shelf_synthetic_5k", "shelf_synthetic_ref",
                     "campus_synthetic", "campus_synthetic_ref")
SERVICE_SNAPSHOT = "campus_synthetic_ref"


def expected_eval_launches(cfg, scenes):
    """Row 1 once per batch, row 2 once per scene, row 1's coords mode never."""
    batches = -(-scenes // cfg.TEST.BATCH_SIZE)
    return {"sample_whole_projected": batches, "sample_crop_planes": scenes, "sample_whole": 0}


def profiles_phase(card, scenes=500, requests=N_REQUESTS):
    """Every committed snapshot besides panoptic_synthetic (the eval
    phase's) on the first `scenes` held-out scenes of its own profile,
    held to `eval_limits` against its own record; then PoseService at the
    SERVICE_SNAPSHOT profile answers the first `requests` of those scenes
    at batch 1, with the validator's fused poses (0.01 mm) and rows 1
    and 2 once per request.  Returns the launches summed over the runs."""
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk
    from faster_voxelpose_tpu_torch.tools import validate

    total, broken, results = {}, [], {}
    for name in PROFILE_SNAPSHOTS:
        sk.reset_launch_counts()
        res = validate.evaluate_snapshot(ROOT / "checkpoints" / name, scenes=scenes, device=CARD)
        counts = sk.launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        cfg, rec = res["cfg"], res["record"]
        d = cfg.DATASET
        print(f"profiles [{name}]: {d.CAMERA_NUM} views, {d.HEATMAP_SIZE[0]}x{d.HEATMAP_SIZE[1]}"
              f"x{d.NUM_JOINTS}, K = {cfg.CAPTURE_SPEC.MAX_PEOPLE}, width "
              f"{cfg.NETWORK.WIDTH_MULT}: {res['scenes']} held-out scenes, {res['detected']} "
              f"people detected where there are {res['people']}, {res['frames_per_s']:.3f} "
              f"frames/s, launches {counts} | {card}\n{res['message']}\nbeside the record "
              f"({rec.get('eval_set', 'its own eval set')}):\n"
              f"{validate.side_by_side(res['message'], rec['message'])}")
        preds = res["preds"]
        K, J = cfg.CAPTURE_SPEC.MAX_PEOPLE, d.NUM_JOINTS
        if preds.shape != (scenes, K, J, 5) or not np.isfinite(preds).all():
            raise AssertionError(f"profiles [{name}]: predictions of shape {preds.shape} or "
                                 f"not finite")
        want = expected_eval_launches(cfg, scenes)
        if any(counts[k] != v for k, v in want.items()):
            raise AssertionError(f"profiles [{name}]: launches {counts}, expected {want}")
        broken += [f"{name}: {b}" for b in eval_limits(res, name)]
        results[name] = res
    if broken:
        raise AssertionError("profiles: " + "; ".join(broken))
    counts = service_replay(card, results[SERVICE_SNAPSHOT], requests)
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def service_replay(card, res, requests):
    """PoseService at `res`'s profile, compiled, answers the first
    `requests` of its held-out scenes at batch 1 (the same samples,
    rendered on the card), as an eager service does
    (`graph_against_eager`, in bf16 and in float32), and:
    the same people as the validator run on those scenes at batch 1, and
    fused poses within 0.01 mm of it; rows 1 and 2 launch once per request
    and no other kernel.  The gap to `res`'s own run, at the profile's
    test batch, is printed.  The same two runs in float32 (TF32 off),
    the validator at the profile's test batch and the service at batch
    1, must agree within 0.01 mm too: a fault that mixed the samples of a
    batch would show there, where bf16 convolutions may round otherwise
    at another batch size."""
    import copy

    import torch

    from faster_voxelpose_tpu_torch.engine import PoseService, run_validation
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk
    from faster_voxelpose_tpu_torch.ops.heatmap_render import render_heatmaps_device
    from faster_voxelpose_tpu_torch.tools import validate

    cfg = res["cfg"]
    W, H = cfg.DATASET.HEATMAP_SIZE
    with np.load(ROOT / "checkpoints" / SERVICE_SNAPSHOT / "model_best.npz") as npz:
        variables = {k: npz[k] for k in npz.files}
    ds = validate.held_out_dataset(cfg, requests)  # a fresh set: the same first samples
    samples = [ds[i] for i in range(requests)]
    rig = samples[0]["cameras"]
    if not all(np.array_equal(s["cameras"], rig) for s in samples):
        raise AssertionError("service: the held-out scenes do not share one rig")
    svc = PoseService(cfg, variables=variables, rig=rig, device=CARD)  # compiled
    frames = [render_heatmaps_device(torch.as_tensor(s["hm_params"], device=CARD), H, W)
              for s in samples]
    torch.cuda.synchronize()
    sk.reset_launch_counts()
    answers = [svc.infer_heatmaps(f) for f in frames]
    counts = sk.launch_counts()
    eager = PoseService(cfg, variables=variables, rig=rig, device=CARD, aot=False)
    graph_against_eager(f"{SERVICE_SNAPSHOT} bf16", answers,
                        [eager.infer_heatmaps(f) for f in frames], False, card)
    del eager
    one = run_validation(cfg, svc.model, validate.held_out_dataset(cfg, requests), batch_size=1,
                         device=CARD)[2]

    def gap(preds, answers=answers):
        worst = 0.0
        for i, a in enumerate(answers):
            valid = preds[i, :, 0, 3] >= 0
            if a["n_people"] != int(valid.sum()):
                return float("inf")
            if a["n_people"]:
                worst = max(worst, float(np.abs(np.asarray(a["poses_mm"])
                                                - preds[i, valid, :, :3]).max()))
        return worst

    people = [a["n_people"] for a in answers]
    worst, batched = gap(one), gap(res["preds"])
    stats = svc.stats()
    del svc

    f32 = copy.deepcopy(cfg)
    f32.NETWORK.COMPUTE_DTYPE = "float32"
    svc32 = PoseService(f32, variables=variables, rig=rig, device=CARD)
    answers32 = [svc32.infer_heatmaps(f) for f in frames]
    eager32 = PoseService(f32, variables=variables, rig=rig, device=CARD, aot=False)
    graph_against_eager(f"{SERVICE_SNAPSHOT} float32", answers32,
                        [eager32.infer_heatmaps(f) for f in frames], True, card)
    del eager32
    batched32 = run_validation(f32, svc32.model, validate.held_out_dataset(f32, requests),
                               device=CARD)[2]
    worst32 = gap(batched32, answers32)
    people32 = [a["n_people"] for a in answers32]
    del svc32
    print(f"profiles: PoseService [{SERVICE_SNAPSHOT}] {requests} held-out scenes at batch 1: "
          f"people {people}, fused poses within {worst:.3g} mm of the validator's at batch 1 "
          f"({batched:.3g} mm of its run above at batch {cfg.TEST.BATCH_SIZE}), launches "
          f"{counts}, p50_ms {stats['p50_ms']} p95_ms {stats['p95_ms']}; in float32 the "
          f"service at batch 1 within {worst32:.3g} mm of the validator at batch "
          f"{f32.TEST.BATCH_SIZE} (people {people32}) | {card}")
    want = {n: 0 for n in counts}
    want.update({"sample_whole_projected": requests, "sample_crop_planes": requests})
    if counts != want:
        raise AssertionError(f"service: launches {counts}, expected {want}")
    if not (worst <= 0.01 and sum(people) > 0):
        raise AssertionError(f"service: fused poses {worst} mm from the validator's "
                             f"(people {people})")
    if not (worst32 <= 0.01 and sum(people32) > 0):
        raise AssertionError(f"service: in float32, fused poses at batch 1 {worst32} mm from "
                             f"the validator's at batch {f32.TEST.BATCH_SIZE} (people {people32})")
    return counts


# float32 backbone, card against CPU (images_phase): set between the float32
# reading, 3.3e-6 relative L2 on an H100, and the bf16 control's, 1.1e-2
BACKBONE_F32_TOL = 1e-4


def rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def images_phase(card, requests=N_REQUESTS):
    """The image path at the Panoptic profile: committed model weights, a
    seeded random ResNet-50 backbone, 5 uint8 frames of 960x512 per
    request (uniform noise from a seed).  Checks the backbone on the card
    against the CPU; in float32, `infer_images` of the uint8 frames
    against `infer_heatmaps` of the CPU backbone's heatmaps of the frames
    normalised on the host (an independent path); as served, uint8
    frames against the float32-normalised ones; then times `requests`
    requests.  Returns the launches of the timed ones."""
    import copy

    import torch

    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile
    from faster_voxelpose_tpu_torch.datasets.images import normalize_image
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.geometry import dome_rig
    from faster_voxelpose_tpu_torch.models.resnet import build_backbone
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk
    from faster_voxelpose_tpu_torch.tools.timing import device_timing

    cfg = panoptic_synthetic_profile()
    d = cfg.DATASET
    iw, ih = d.IMAGE_SIZE
    rig = dome_rig(1, d.CAMERA_NUM, space_center=cfg.CAPTURE_SPEC.SPACE_CENTER)[0]
    with np.load(ROOT / "checkpoints/panoptic_synthetic/model_best.npz") as npz:
        variables = {k: npz[k] for k in npz.files}
    rng = np.random.RandomState(21)
    frames = [rng.randint(0, 256, (d.CAMERA_NUM, ih, iw, 3)).astype(np.uint8)
              for _ in range(requests)]
    svc = PoseService(cfg, variables=variables, rig=rig, device=CARD, seed=0)
    warm = svc.warmup(("heatmaps", "images", "images_u8"))

    # the backbone, float32, card against CPU, one frame; the served bf16
    # backbone is the control
    f32cfg = copy.deepcopy(cfg)
    f32cfg.NETWORK.COMPUTE_DTYPE = "float32"
    cpu = build_backbone(f32cfg)
    cpu.load_state_dict(svc.backbone.state_dict())
    x = torch.as_tensor(normalize_image(frames[0][0]))[None]  # as served: BGR, COLOR_RGB false
    card_f32 = copy.deepcopy(cpu).to(CARD)
    with torch.inference_mode():
        want = cpu(x)
        got = card_f32(x.to(CARD)).cpu()
        control = svc.backbone(x.to(CARD)).cpu()
    r_f32, r_bf16 = rel_l2(got, want), rel_l2(control, want)
    print(f"images: backbone ResNet-{cfg.RESNET.NUM_LAYERS} on one {iw}x{ih} frame, card against "
          f"CPU, float32 with TF32 off: relative L2 {r_f32:.3g} (limit {BACKBONE_F32_TOL}); the "
          f"served bf16 backbone (control) {r_bf16:.3g}; heatmaps {tuple(want.shape)} max "
          f"{float(want.abs().max()):.4g} | {card}")
    if not (r_f32 <= BACKBONE_F32_TOL and torch.isfinite(got).all()):
        raise AssertionError(f"images: float32 backbone card vs CPU {r_f32} > {BACKBONE_F32_TOL}")
    if not r_bf16 > BACKBONE_F32_TOL:
        raise AssertionError(f"images: the bf16 control {r_bf16} passes the float32 limit")
    del card_f32

    def compare(name, got, want, worst):
        if got["n_people"] != want["n_people"] or not np.allclose(
                got["scores"], want["scores"], rtol=0, atol=1e-5):
            raise AssertionError(f"images: {name} proposes otherwise than infer_images(uint8)")
        return max(worst, float(np.abs(np.asarray(got["poses_mm"])
                                       - np.asarray(want["poses_mm"])).max()))

    # every slot valid, so that every fused pose is compared; frames
    # normalised on the host as BGR (COLOR_RGB false)
    worst = {"cpu backbone": 0.0, "float32 frames": 0.0}
    all_cfg = copy.deepcopy(f32cfg)
    all_cfg.CAPTURE_SPEC.MIN_SCORE = -1e9
    every = PoseService(all_cfg, variables=variables, rig=rig, device=CARD, seed=0)
    every.backbone.load_state_dict(cpu.state_dict())
    every.warmup(("heatmaps", "images_u8"))
    for u8 in frames[:2]:
        with torch.inference_mode():
            hm = cpu(torch.as_tensor(normalize_image(u8)))  # (V, ih/4, iw/4, J) on the CPU
        worst["cpu backbone"] = compare("the CPU backbone's heatmaps", every.infer_images(u8),
                                        every.infer_heatmaps(hm.to(CARD)), worst["cpu backbone"])
    del every, cpu
    all_cfg.NETWORK.COMPUTE_DTYPE = cfg.NETWORK.COMPUTE_DTYPE
    every = PoseService(all_cfg, variables=variables, rig=rig, device=CARD, seed=0)
    every.warmup(("heatmaps", "images", "images_u8"))
    for u8 in frames[:4]:
        worst["float32 frames"] = compare("the float32-normalised frames", every.infer_images(u8),
                                          every.infer_images(normalize_image(u8)),
                                          worst["float32 frames"])
    print(f"images: float32, infer_images(uint8) against infer_heatmaps of the CPU backbone's "
          f"heatmaps of the frames normalised on the host {worst['cpu backbone']:.3g} mm (2 "
          f"requests); as served ({cfg.NETWORK.COMPUTE_DTYPE}), infer_images(uint8) against "
          f"infer_images of the float32-normalised frames {worst['float32 frames']:.3g} mm (4 "
          f"requests); {all_cfg.CAPTURE_SPEC.MAX_PEOPLE} slots each, all valid | {card}")
    if not max(worst.values()) <= 0.01:
        raise AssertionError(f"images: the image path's poses differ: {worst}")
    del every

    # the timed requests, as served
    for u8 in frames[:3]:
        svc.infer_images(u8)
    torch.cuda.synchronize()
    sk.reset_launch_counts()
    device_ms, host_ms, people = [], [], []
    for u8 in frames:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        r = svc.infer_images(u8)  # ends with the poses on the host
        b.record()
        b.synchronize()
        device_ms.append(a.elapsed_time(b))
        host_ms.append(r["latency_ms"])
        people.append(r["n_people"])
    launches = sk.launch_counts()
    stats = svc.stats()
    x5 = torch.as_tensor(normalize_image(frames[0]), device=CARD)  # normalised on the host

    def backbone_only():
        with torch.inference_mode():
            return svc.backbone(x5)

    bb_ms, method = device_timing(backbone_only, n=5)
    each = {k: ", ".join(f"{t:.3f}" for t in v) for k, v in (("device", device_ms),
                                                             ("host", host_ms))}
    print(f"images: {requests} requests of {d.CAMERA_NUM} uint8 frames {iw}x{ih}, warmed "
          f"{warm}, backbone random ({stats['backbone_random_init']}): latency p50 "
          f"{stats['p50_ms']} ms p95 {stats['p95_ms']} ms; per request device span ms (events "
          f"around it) median {np.median(device_ms):.4f} [{each['device']}], host ms median "
          f"{np.median(host_ms):.4f} [{each['host']}]; "
          f"the backbone alone on {d.CAMERA_NUM} normalised frames device_ms "
          f"{bb_ms:.4f} ({method}); people {people}; launches {launches} | {card}")
    want = {n: 0 for n in launches}
    want.update({"sample_whole_projected": requests, "sample_crop_planes": requests})
    if launches != want:
        raise AssertionError(f"images: launches {launches}, expected {want}")
    return launches


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="only the kernel rows (1-7), each timed by tools/timing.py's three "
                         "timers, then their table; no path runs, no result line")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
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
    from faster_voxelpose_tpu_torch.tools.timing import card_line

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

    case = crop_case(cfg, geom, rig, hm, rng)
    rows = [*whole_phase(cfg, geom, rig, hm, card), crop_phase(cfg, geom, rig, hm, card, case),
            coords_phase(cfg, geom, hm, card, case), cube_phase(cfg, geom, hm, card, case)]
    del case
    for name, cases in crop_shapes_phase(card).items():  # rows 2-4 at the Shelf and Campus shapes
        next(r for r in rows if r["name"] == name)["cases"] = cases
    if args.kernels:
        for phase in (window_phase, mma_phase):
            rows += phase(card)[0]
        print(f"chip_smoke --kernels: {time.perf_counter() - t_start:.1f} s from start")
        print(json.dumps({"kernels": rows}))
        return 0
    parity_phase()
    # serving before the training phases, so that its latency is read on a
    # host and card that training has not yet loaded, as in earlier runs
    paths = {"serving": serving_phase(cfg, rig, card, rng)}
    paths["compiled"] = compiled_phase(cfg, rig, card, np.random.RandomState(9))
    paths["route"] = route_phase(cfg, rig, card, rng)
    train_parity_phase(card)
    paths["train"] = training_phase(card)
    paths["tools"] = {}
    for phase in (window_phase, mma_phase):
        tool_rows, launches = phase(card)
        rows += tool_rows
        paths["tools"].update(launches)
    paths["eval"] = eval_phase(card)
    paths["profiles"] = profiles_phase(card)
    paths["images"] = images_phase(card)

    # launches: the run of the path that reaches each kernel (the row's
    # `path`): training for the default route's kernels, the route phase
    # for the crop sampler's other modes, the tools for the tuning kernels
    kernels = []
    for r in rows:
        launches = paths[r["path"]][r["name"]]
        if launches <= 0:
            raise AssertionError(f"{r['name']} was not launched on its path")
        kernels.append(dict(r, route="cuda", launches=launches,
                            launches_by_path={p: c.get(r["name"], 0) for p, c in paths.items()}))
    print(f"chip_smoke: every phase passed, {time.perf_counter() - t_start:.1f} s from start "
          "(torch import and kernel build included)")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
