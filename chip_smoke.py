#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels   # the kernel rows alone (no path run)
    python3 chip_smoke.py --voxelpose   # the build, rows 9 and 11 and the VoxelPose phase alone
    python3 chip_smoke.py --mvp   # the build, row 10 and the MvP phase alone

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
   version, timed and printed with its bound, yardstick and launch.  Row
   8, WeightNet's front (`weightnet_front`), at the Shelf and Panoptic
   shapes in bf16 and at Shelf in float32, against its plain version
   within one bf16 ulp (float32 1e-5), timed beside its bound and the
   library chain it replaced (cuDNN's fused conv + ReLU, max pool, mean).
   Row 9, VoxelPose's 7x7x7 front (`front3d`), at the PRN's (10 cubes of
   64^3) and the CPN's (80x80x20) shapes at 15 joints, against its plain
   version in float64 on the same bf16 operands within one bf16 ulp, timed
   beside its bound
   (bf16 operations), its plain version and cuDNN's `F.conv3d` + ReLU on
   the cast cube, which the port no longer calls.  Row 11, the head of
   VoxelPose's `front_res` block (`front_res3d`), at the same two shapes
   on 16 bf16 channels: h and s against the plain version in float64 on
   the same bf16 operands within one bf16 ulp, timed beside its bound
   (bytes), its plain version and the two cuDNN calls it replaced;
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
6. training phases: the compiled trainer (its step a CUDA graph) against
   the eager one at the Panoptic profile, batch 4, 12 float32 steps
   free-running from one seeded model (the same gates; losses and state
   within limits that a bf16 control must break) and each call from the
   same state; then, compiled, the Panoptic profile at full width from
   seeded random weights: 8 steps on one batch of 4 synthetic scenes
   from the port's generator, rendered on the card, must give finite
   losses and lower the detection loss (2D + 1D) below 0.9 of its first
   value; then 20 steps on fresh batches with the data in series and 20
   through `prefetch_to_device` are timed; then the training CLI in
   subprocesses in a temporary directory (tools/make_demo_data.py, then
   tools/train.py on configs/demo/panoptic_synthetic.yaml: 2 epochs on
   64 scenes, then --resume to a third; the snapshot served; nothing
   under checkpoints/ changed, by hash), and the other CLIs there:
   tools/validate.py --cfg on that config's first 64 held-out scenes
   against `evaluate_snapshot` on the same scenes (the committed
   snapshot, the same metric table), again with TEST.VISUALIZATION (the
   drawings decode), tools/train.py one epoch with TRAIN.VISUALIZATION
   (the drawings, the losses of the step after one finite), tools/demo.py
   on a calibration JSON of the served dome rig, 5 JPEGs and upstream
   checkpoints of the committed weights and a seeded ResNet-50 (--repeat
   20, its latency printed; every slot against a PoseService on the same
   files within 0.01), tools/preprocess.py twice on a written Panoptic
   sequence (20 frames resized, then none);
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
   backbone's device ms alone (recorded, not judged);
12. bench phase: tools/bench.py (the counterpart of bench.py) once, full
   size, in a subprocess with nothing else on the card: the worst case
   (configs/panoptic/jln64.yaml, MIN_SCORE -1, seeded random model and
   ResNet-50) at latency and batch-8 throughput, the realistic load
   (committed weights, 24 held-out scenes) fused alone and end to end at
   batch 1 and 8, each measurement one CUDA graph of F steps; its last
   line must hold bench.py's keys and a device time per mode, finite
   positive rates, every worst-case slot valid, rows 1 and 2 in each
   graph (row 1 once a step, row 2 once a frame) and detected people
   within 10% of true people; then the worst case's 2-frame graph
   against the eager step (float32: the same slots, all valid, poses
   within 0.01 mm; bf16 printed) and the live voxels of every crop; then
   tools.profile_stages and tools.bench_width in this process;
13. script tools phase, after the bench phase: the counterparts of the
   JAX repo's last eleven scripts, in this process at short settings in a
   temporary directory: capture_trace and analyze_trace (4 worst-case
   frames in one graph under torch.profiler: rows 1 and 2 by name, once
   a frame, and the trace's device ms a frame within 5% of the bench's
   latency_device_ms); profile_backbone (the stages and the whole
   ResNet-50, each under the card's bf16 peak); run_real_parity (with no
   data a skip per dataset and PARITY.md only in the temporary directory;
   then --preprocess, conversion and validation of a 4-frame Panoptic
   'image' sequence from upstream checkpoints of the committed weights
   and a seeded ResNet-50); export_best_npz (panoptic_synthetic's
   committed npz as the best model, --snapshot-dir in the temporary
   directory: the same arrays, the record's epoch from a train log),
   diagnose_campus (campus_synthetic_ref's npz) and bench_realistic
   (panoptic_synthetic) on 64 scenes of data written by make_demo_data;
   check_sampling_parity at Panoptic and Campus without timing (every
   float32 route within 0.01 mm of 'quad', rows 2-4 each reached);
   smoke_kernels whole; each sweep on three variants, the production
   build among them; checkpoints/ hashed before and after;
14. datasets phase, after the failed-capture control: the host
   renderers at the Panoptic and Shelf shapes (native against numpy,
   2e-6; host against the device renderer on the same draws, 2e-5);
   panoptic_synthetic and shelf_synthetic_ref on 256 held-out scenes
   with heatmaps rendered on the host by 8 spawn workers against the
   device-rendered reading of the same run (AP@50 within 0.002, MPJPE
   within 0.2 mm); the 'pred' source: Shelf- and Campus-format fixtures
   written from 128 held-out scenes of their profiles, scored by PCP3D
   with the committed weights, and on the frames with every joint inside
   every view the same valid slots and fused poses within 1 mm of the
   'gt' device path; the 'image' source: a Panoptic sequence of
   1920x1080 JPEGs at the configs/panoptic/jln64.yaml profile, one
   validation through the graphed image step and 6 compiled train steps
   on loader-made 'images' batches (8 spawn workers, seeded random model
   and ResNet-50); the host's cost: a loader-fed compiled trainer at
   configs/demo/synthetic.yaml with device rendering and with host
   rendering in the prefetch thread and in 8 workers, then tools/train.py
   on that config with WORKERS 0 and 8;
15. entry phase (`tools/dryrun_multichip.py`, the counterpart of the JAX
   repo's `__graft_entry__.py`): `entry()`'s tiny-model forward on the
   card (shape (1, 4, 15, 5), finite, rows 1 and 2 launched once each)
   against the same function and weights on the CPU (the same valid
   slots, proposals 1e-3, fused poses 0.5 mm); `dryrun_multichip(2)`,
   two gloo ranks on the one card: DP train (params 1e-4 in float64
   throughout; summed gradients and BatchNorm statistics in float64 conv
   stacks over float32 parameters; the bf16 readings printed), the view
   forward on a sub-group and DP eval (1e-2 mm, at MIN_SCORE 0.1 and
   with every slot valid), PipelinedStream on two streams (1e-2 mm),
   every line printed;
16. scale-out phase (`parallel/mesh.py`), last: one rank over NCCL, the
   compiled DP train step (collectives in its CUDA graph) against the
   compiled Trainer on one batch of 4 at the Panoptic profile in float32,
   and the DP eval step against run_validation on 8 held-out scenes; two
   ranks over gloo on the card in spawned processes: DP train in float64
   conv stacks (3 free steps' losses; every parameter after each step
   from one process's state), DP eval, the view-sharded forward at V = 4;
   PipelinedStream on two CUDA streams, 24 frames of 5 uint8 960x512
   images against the serial path, frames/s of both.
The serving phase (PoseService with the committed panoptic_synthetic
weights answering 24 rendered 1-6-person frames: the default route's two
kernels, the projected whole-space sampler and the crop sampler, launch
once per request and no other kernel does, someone is detected, the
median matched MPJPE stays under 150 mm) runs between phases 3 and 4,
then the compiled phase (`compiled_phase`): PoseService's CUDA graphs
against eager services on the same 24 requests (the same people; float32
within 0.01 mm, the bf16 gap printed), rows 1 and 2 once per replayed
request, a rig hot-swap with no recapture, the 'images_u8' graph on
uint8 frames, the JSON-lines server (tools/serve.py) in a subprocess,
and eager and compiled latencies; a capture holding a host
synchronisation that must raise runs after the bench phase
(`failed_capture_phase`: `graphs.capture` puts PyTorch's state back, so
the device generator draws and cached memory is given back after it,
and the datasets phase is measured after it).  Between phases the card's
cached memory is given back (`released`, which prints the seconds from
the start).  The VoxelPose phase (`voxelpose_phase`) follows the
compiled one: `MODEL: voxelpose` at the widths of the benchmark's
`panoptic_voxelpose` configuration, rows 1 and 4 in their bounded modes
(the whole space, and the K = 10 cubes of 64^3 about the CPN's float
centres) against their plain versions at those shapes, the served
graph's launches, and its answers against eager ones in float32.
PoseService captures its graphs at construction on
the card, so the serving, profiles and images phases answer through
them too (the profiles phase's Campus service against an eager one as
well); the route phase runs eagerly, since the coords route builds its
pixels from host constants, which a graph cannot hold.
Training and evaluation launch the whole-space sampler once per batch
and the crop sampler once per sample (evaluation: per row of a batch
padded to TEST.BATCH_SIZE), at every profile, from CUDA graphs; the
coords mode of row 1 runs only as the gather baseline of
tools/probe_sampling.py.

Any failed phase raises, so the script exits non-zero.  The last line is
{"ok": true, "device": {...}}; the line before it holds the kernel table
as JSON.  Exits non-zero without printing a result when no CUDA device
is present or the port is not beside this file.
"""

from __future__ import annotations

import json
import math
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
T_START = time.perf_counter()

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
    libs = cuda_build.build_all(["sampling", "window", "mma_window", "weightnet", "front3d",
                                 "front_res3d", "projattn"])
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


# WeightNet's front at the served shapes: M = 3 planes x K = 10 slots, J
# joints, 64x64 planes, C = 32 channels
WEIGHTNET_SHAPES = {"shelf": (30, 17), "panoptic": (30, 15)}
WEIGHTNET_RTOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}  # as tests/test_torch_cuda.py


def weightnet_case(M, J, dtype, seed=0):
    """P2PNet-like feats (M, J, 64, 64) float32 channels-last, a folded
    channels-last weight (32, 1, 3, 3) and bias in `dtype`."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    feats = torch.rand(M, 64, 64, J, generator=gen).permute(0, 3, 1, 2).to(CARD)
    w = (torch.randn(32, 1, 3, 3, generator=gen) * (2.0 / 9) ** 0.5).to(dtype)
    b = (torch.randn(32, generator=gen) * 0.2).to(dtype)
    return feats, w.contiguous(memory_format=torch.channels_last).to(CARD), b.to(CARD)


def weightnet_phase(card):
    """Kernel row 8, weightnet_front, at the Shelf (510 maps) and Panoptic
    (450) shapes in bf16 (as served) and at Shelf in float32: against its
    plain version on the CPU within one bf16 ulp (float32 1e-5), two
    launches equal, timed beside its bound (float32 FMA on the CUDA cores;
    the benchmark's share counts the same work at the bf16 peak, where the
    bytes bound), its plain version and the library chain the folded
    WeightNet served before it: the cast, cuDNN's fused conv + bias + ReLU,
    the NCHW max pool and the mean.  Returns the row, Shelf bf16 first and
    the other cases under `cases`."""
    import torch
    import torch.nn.functional as F

    from faster_voxelpose_tpu_torch.ops import weightnet_kernels as wk

    cases = []
    for label, (M, J), dt in (("shelf", WEIGHTNET_SHAPES["shelf"], "bfloat16"),
                              ("panoptic", WEIGHTNET_SHAPES["panoptic"], "bfloat16"),
                              ("shelf", WEIGHTNET_SHAPES["shelf"], "float32")):
        feats, w, b = weightnet_case(M, J, getattr(torch, dt))
        # the plain version as the CPU runs it: on the card `F.conv2d` adds
        # the bias after rounding the conv to bf16 (tests/test_torch_cuda.py)
        out = wk.weightnet_front(feats, w, b)
        ref = wk.weightnet_front_plain(feats.cpu(), w.cpu(), b.cpu()).to(CARD)

        def share_of_tolerance(got):  # <= 1 within the tests' tolerance
            gap = (got.float() - ref.float()).abs()
            return float((gap / (1e-7 + WEIGHTNET_RTOL[dt] * ref.float().abs())).max())

        rel, equal = share_of_tolerance(out), float((out == ref).float().mean())
        if not (rel <= 1.0 and torch.equal(out, wk.weightnet_front(feats, w, b))):
            raise AssertionError(f"weightnet_front [{label} {dt}] off its plain version: "
                                 f"{rel} of the tolerance")
        maps = M * J

        def library():
            x = feats.reshape(maps, 1, 64, 64).to(w.dtype)
            y = torch.cudnn_convolution_relu(x, w, b, (1, 1), (1, 1), (1, 1), 1)
            return F.max_pool2d(y, 2).mean(dim=(2, 3))

        lib_rel = share_of_tolerance(library())
        nbytes = 4 * maps * 64 * 64 + out.element_size() * maps * 32
        b_ms, b_by = bound(nbytes, 2 * maps * 64 * 64 * 32 * 9)
        least_bf16 = bound(nbytes, maps * 32 * (19 * 64 * 64 + 5 * 32 * 32 + 1), BF16_FLOPS)
        row = dict(name="weightnet_front", source="faster_voxelpose_tpu_torch/csrc/weightnet.cu",
                   replaces="none (WeightNet, faster_voxelpose_tpu/models/cnns.py, flax layers)",
                   path="serving", label=label, dtype=dt, maps=maps,
                   **timings(lambda: wk.weightnet_front(feats, w, b)),
                   plain_ms=device_readings(lambda: wk.weightnet_front_plain(feats, w, b))
                   ["device_ms"],
                   **library_readings(library), bound_ms=b_ms, bound_by=b_by,
                   bf16_least_ms=least_bf16[0], share_of_tolerance=rel, equal=equal)
        print(f"kernel weightnet_front [{label} {dt}]: {maps} maps, against the plain version "
              f"{rel:.3g} of the tolerance, {equal:.4f} of the values equal (the library chain "
              f"{lib_rel:.3g} of it) kernel_ms {fmt(row)} "
              f"plain_ms (device) {row['plain_ms']:.4f} {fmt_library(row)} bound_ms "
              f"{b_ms:.4f} ({b_by}; at the bf16 peak {least_bf16[0]:.4f}, {least_bf16[1]}) "
              f"| {card}")
        cases.append(row)
    return dict(cases[0], cases=cases[1:])


FRONT3D_SHAPES = {"prn": (10, 15, 64, 64, 64), "cpn": (1, 15, 80, 80, 20)}


def front3d_case(N, C, X, Y, Z, seed=0):
    """The samplers' cube (N, X, Y, Z, C) float32 in [0, 1] permuted to
    (N, C, X, Y, Z), a fan-in scaled bf16 weight (16, C, 7, 7, 7)
    channels-last-3d as the fold keeps it, its packing and a bias."""
    import torch

    from faster_voxelpose_tpu_torch.ops import front3d_kernels as fk

    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(N, X, Y, Z, C, generator=gen).to(CARD).permute(0, 4, 1, 2, 3)
    w = (torch.randn(16, C, 7, 7, 7, generator=gen) * (2.0 / (C * 343)) ** 0.5).to(torch.bfloat16)
    w = w.contiguous(memory_format=torch.channels_last_3d).to(CARD)
    b = (torch.randn(16, generator=gen) * 0.2).to(torch.bfloat16).to(CARD)
    return x, w, b, fk.pack_weight(w)


def front3d_phase(card):
    """Kernel row 9, front3d, at the PRN's and the CPN's shapes: against
    its plain version in float64 on the same bf16 operands within one bf16
    ulp of the larger value and 2^-16 of the products' magnitude (as
    tests/test_torch_cuda.py; the plain version in bf16, whose `F.conv3d`
    rounds the conv before it adds the bias, is read against the same),
    two launches equal, timed beside its bound (bf16 operations at 989
    TFLOP/s, over the J channels), its plain version (the cast, `F.conv3d`
    with the bias, ReLU) and cuDNN's `F.conv3d` + ReLU on the cast cube.
    Returns the row, the PRN first and the CPN under `cases`."""
    import torch
    import torch.nn.functional as F

    from faster_voxelpose_tpu_torch.ops import front3d_kernels as fk

    def ulp(v):
        a = v.float().abs()
        return torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a.clamp_min(1e-30))) - 7),
                           0.0)

    cases = []
    for label, (N, C, X, Y, Z) in FRONT3D_SHAPES.items():
        x, w, b, p = front3d_case(N, C, X, Y, Z)
        out, ref = fk.front3d(x, w, b, p), fk.front3d_plain(x, w, b)
        xb = x.to(torch.bfloat16)
        xd, wd = xb.double().contiguous(), w.double().contiguous()
        exact = fk.front3d_plain(xd, wd, b.double())
        magnitude = F.conv3d(xd.abs(), wd.abs(), b.double().abs(), 1, 3)
        del xd, wd

        def off(y):  # <= 1 within the tests' tolerance
            tol = ulp(torch.maximum(y.float().abs(), exact.float().abs())).double()
            return float(((y.double() - exact).abs() / (tol + 2.0 ** -16 * magnitude + 1e-30))
                         .max())

        kernel_off, plain_off = off(out), off(ref)
        equal = float((out == ref).float().mean())
        del exact, magnitude
        if not (kernel_off <= 1.0 and torch.equal(out, fk.front3d(x, w, b, p))):
            raise AssertionError(f"front3d [{label}] off its plain version in float64: "
                                 f"{kernel_off} of the tolerance")
        voxels = N * X * Y * Z
        flops = 2 * 16 * C * 343 * voxels
        b_ms, b_by = bound(4 * C * voxels + 2 * 16 * voxels, flops, BF16_FLOPS)
        row = dict(name="front3d", source="faster_voxelpose_tpu_torch/csrc/front3d.cu",
                   replaces="none (the JAX package has no V2VNet)", path="voxelpose",
                   label=label, shape=[N, C, X, Y, Z],
                   **timings(lambda: fk.front3d(x, w, b, p)),
                   plain_ms=device_readings(lambda: fk.front3d_plain(x, w, b))["device_ms"],
                   **library_readings(lambda: F.conv3d(xb, w, b, 1, 3).relu_()),
                   bound_ms=b_ms, bound_by=b_by, share_of_tolerance=kernel_off,
                   plain_share_of_tolerance=plain_off, equal=equal)
        row["share_of_bound"] = b_ms / row["device_ms"]
        row["library_over_kernel"] = row["library_device_ms"] / row["device_ms"]
        print(f"kernel front3d [{label} {N}x{X}x{Y}x{Z}x{C}]: against the plain version in "
              f"float64 {kernel_off:.3g} of the tolerance (the plain version in bf16 "
              f"{plain_off:.3g}), {equal:.4f} of the values equal to the bf16 one; kernel_ms "
              f"{fmt(row)} plain_ms (device) {row['plain_ms']:.4f} {fmt_library(row)} bound_ms "
              f"{b_ms:.4f} ({b_by}; {100 * row['share_of_bound']:.1f}% of it), cuDNN's conv + "
              f"ReLU {row['library_over_kernel']:.2f}x the kernel's device time | {card}")
        cases.append(row)
    return dict(cases[0], cases=cases[1:])


FRONT_RES3D_SHAPES = {"prn": (10, 64, 64, 64), "cpn": (1, 80, 80, 20)}


def front_res3d_phase(card):
    """Kernel row 11, front_res3d, at the PRN's and the CPN's shapes: h and
    s against the plain version in float64 on the same bf16 operands
    within one bf16 ulp of the larger value and 2^-16 of the products'
    magnitude (tests/test_torch_cuda.py's case and check; the plain
    version in bf16 is read against the same), two launches equal, timed
    beside its bound (bytes: 16 bf16 channels in and 2 x 32 out, 160
    bytes a voxel at 3.35 TB/s), its plain version (`F.conv3d` with the
    bias and ReLU, `F.conv3d` with the bias) and the two cuDNN calls that
    the port made before it, which it no longer calls
    (`torch.cudnn_convolution_relu`, `F.conv3d` with the bias).  Returns
    the row, the PRN first and the CPN under `cases`."""
    import torch
    import torch.nn.functional as F

    from faster_voxelpose_tpu_torch.ops import front_res3d_kernels as rk

    sys.path.insert(0, str(ROOT / "tests"))  # not `tests.`: an installed package may take it
    from test_torch_cuda import _front_res3d_case, _front_res3d_off

    cases = []
    for label, (N, X, Y, Z) in FRONT_RES3D_SHAPES.items():
        x, w1, b1, ws, bs, p = _front_res3d_case(CARD, N, X, Y, Z)
        out, ref = rk.front_res3d(x, w1, b1, ws, bs, p), rk.front_res3d_plain(x, w1, b1, ws, bs)
        offs = [_front_res3d_off(y, x, w1, b1, 1) for y in (out[0], ref[0])]
        offs += [_front_res3d_off(y, x, ws, bs, 0) for y in (out[1], ref[1])]
        kernel_off, plain_off = max(offs[0], offs[2]), max(offs[1], offs[3])
        equal = float(sum((a == b).float().mean() for a, b in zip(out, ref)) / 2)
        again = rk.front_res3d(x, w1, b1, ws, bs, p)
        if not (kernel_off <= 1.0 and all(map(torch.equal, out, again))):
            raise AssertionError(f"front_res3d [{label}] off its plain version in float64: "
                                 f"{kernel_off} of the tolerance")

        def library():
            return (torch.cudnn_convolution_relu(x, w1, b1, (1, 1, 1), (1, 1, 1), (1, 1, 1), 1),
                    F.conv3d(x, ws, bs))

        voxels = N * X * Y * Z
        b_ms, b_by = bound(160 * voxels, 2 * 32 * 16 * 28 * voxels, BF16_FLOPS)
        row = dict(name="front_res3d", source="faster_voxelpose_tpu_torch/csrc/front_res3d.cu",
                   replaces="none (the JAX package has no V2VNet)", path="voxelpose",
                   label=label, shape=[N, 16, X, Y, Z],
                   **timings(lambda: rk.front_res3d(x, w1, b1, ws, bs, p)),
                   plain_ms=device_readings(lambda: rk.front_res3d_plain(x, w1, b1, ws, bs))[
                       "device_ms"],
                   **library_readings(library),
                   bound_ms=b_ms, bound_by=b_by, share_of_tolerance=kernel_off,
                   plain_share_of_tolerance=plain_off, equal=equal)
        row["share_of_bound"] = b_ms / row["device_ms"]
        row["library_over_kernel"] = row["library_device_ms"] / row["device_ms"]
        print(f"kernel front_res3d [{label} {N}x{X}x{Y}x{Z}x16]: h and s against the plain "
              f"version in float64 {kernel_off:.3g} of the tolerance (the plain version in bf16 "
              f"{plain_off:.3g}), {equal:.4f} of the values equal to the bf16 one; kernel_ms "
              f"{fmt(row)} plain_ms (device) {row['plain_ms']:.4f} {fmt_library(row)} bound_ms "
              f"{b_ms:.4f} ({b_by}; {100 * row['share_of_bound']:.1f}% of it), cuDNN's two calls "
              f"{row['library_over_kernel']:.2f}x the kernel's device time | {card}")
        cases.append(row)
    return dict(cases[0], cases=cases[1:])


def voxelpose_phase(card, requests=8):
    """VoxelPose (`MODEL: voxelpose`) at the widths of the benchmark's
    `panoptic_voxelpose` (5 views of 240x128x15, 80x80x20, K = 10 cubes of
    64^3), on its rig and a rendered 4-person frame: row 1's bounded mode
    (`whole_kernel<true>`) and row 4's float-centred bounded cube
    (`crop_kernel<false, true, true>`, about the CPN's own centres) against
    their plain versions (1e-5), timed; then the bf16 service as the cell
    serves it: one replay of its 'heatmaps' graph launches each of the two
    once, front3d twice (the CPN's and the PRN's 7x7x7 fronts),
    front_res3d twice (their `front_res` heads) and no other kernel
    (counts reset just before it), `requests` more launch as many each;
    last, with every slot answered (MIN_SCORE -1e9), the bf16 graph
    against an eager bf16 service (both through the kernels; the gap
    recorded) and the float32 graph (no kernel of the V2VNets) against an
    eager service within 0.01 mm.  Returns the launch counts of the
    `requests` bf16 requests."""
    import torch

    from benchmark.drivers.live_service import port_config
    from benchmark.traffic.generate import config_rig
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.models import VoxelPoseNet
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    config = json.loads((ROOT / "benchmark/configs/panoptic_voxelpose.json").read_text())
    cfg = port_config(config)
    rig = config_rig(config).astype(np.float32)
    cams = torch.as_tensor(rig, device=CARD)
    hm = render_frame(make_people(np.random.RandomState(24), 4, cfg.CAPTURE_SPEC.SPACE_CENTER),
                      rig, cfg, CARD)
    svc = PoseService(cfg, rig=rig, device=CARD, seed=0)
    model = svc.model
    if not isinstance(model, VoxelPoseNet) or svc.warmup() != ["heatmaps"]:
        raise AssertionError(f"voxelpose: {type(model).__name__}, graphs {svc.warmup()}")

    axes = (model.whole_gx, model.whole_gy, model.whole_gz)
    masks = (model.mask_x, model.mask_y, model.mask_z, model.all_slots)
    with torch.no_grad():
        centres = model.proposals(hm[None], cams[None])[1][0].contiguous()  # (K, 3) mm

    def whole():
        return sk.sample_whole_projected(hm[None], cams[None], axes, model.whole, bounded=True)

    def cube():
        return sk.sample_crop_cube(hm, *masks, cams=cams, crop=model.crop, centres=centres)

    plains = (sk.sample_whole_projected_plain(hm[None], cams[None], axes, model.whole,
                                              bounded=True),
              sk.sample_crop_centred_plain(hm, cams, centres, *masks, model.crop))
    rows = {}
    for name, fn, plain in (("sample_whole_projected", whole, plains[0]),
                            ("sample_crop_cube", cube, plains[1])):
        out = fn()
        err = float((out - plain).abs().max())
        if not (err <= TOL and torch.isfinite(out).all() and torch.equal(out, fn())):
            raise AssertionError(f"voxelpose: bounded {name} {tuple(out.shape)} off its plain "
                                 f"version by {err}")
        rows[name] = dict(err=err, shape=tuple(out.shape), **timings(fn))
        print(f"voxelpose: bounded {name} {tuple(out.shape)} against its plain version "
              f"{err:.3g} (limit {TOL:g}) {fmt(rows[name])} | {card}")
    del plains

    sk.reset_launch_counts()
    svc.infer_heatmaps(hm)
    one = sk.launch_counts()
    expect = {n: 0 for n in one}
    expect.update({"sample_whole_projected": 1, "sample_crop_cube": 1, "front3d": 2,
                   "front_res3d": 2})
    if one != expect:
        raise AssertionError(f"voxelpose: one replay launched {one}, expected {expect}")
    sk.reset_launch_counts()
    for _ in range(requests):
        svc.infer_heatmaps(hm)
    launches = sk.launch_counts()
    if launches != {n: c * requests for n, c in expect.items()}:
        raise AssertionError(f"voxelpose: {requests} requests launched {launches}")
    print(f"voxelpose: one replay of the bf16 'heatmaps' graph launched "
          f"{ {n: c for n, c in one.items() if c} }; {requests} requests "
          f"{ {n: c for n, c in launches.items() if c} } | {card}")
    del svc, model

    frames = [render_frame(make_people(np.random.RandomState(s), n, cfg.CAPTURE_SPEC.SPACE_CENTER),
                           rig, cfg, CARD) for s, n in ((25, 1), (26, 6), (27, 10))]
    for dtype in ("bfloat16", "float32"):
        every = port_config(config)
        every.NETWORK.COMPUTE_DTYPE = dtype
        every.CAPTURE_SPEC.MIN_SCORE = -1e9
        graph = PoseService(every, rig=rig, device=CARD, seed=0)
        eager = PoseService(every, rig=rig, device=CARD, seed=0, aot=False)
        got = [graph.infer_heatmaps(f) for f in frames]
        graph_against_eager(f"voxelpose {dtype}", got, [eager.infer_heatmaps(f) for f in frames],
                            dtype == "float32", card)
        del graph, eager
    return launches


PROJATTN_CASE = (1, 5, 150, 8, 32, 4, [(32, 60), (64, 120), (128, 240)])  # MvP at Panoptic


def projattn_phase(card):
    """Kernel row 10, projattn, at MvP's Panoptic shapes (150 queries, 5
    views, 8 heads of 32, 3 levels of 32x60 to 128x240, 4 points): against
    its plain version in float64 on the same bf16 operands within one bf16
    ulp of the value plus 2^-12 of the maps' largest magnitude (as
    tests/test_torch_cuda.py), two launches equal, timed beside its bound
    (`benchmark/counts/mvp.py`: each tap's 4 corners x 32 channels of bf16
    read once, at 3.35 TB/s), its plain version (one `F.grid_sample` a
    level over every view and head, the softmax and the sums, in float32)
    and the library's part of that alone (the three `F.grid_sample` calls
    on the maps laid out as they take them, bf16).  Returns the row."""
    import torch
    import torch.nn.functional as F

    from faster_voxelpose_tpu_torch.ops import projattn_kernels as pk

    sys.path.insert(0, str(ROOT / "tests"))  # not `tests.`: an installed package may take it
    from test_torch_cuda import _projattn_case

    values, ref, offsets, logits, cams, geom = _projattn_case(CARD, *PROJATTN_CASE)
    out = pk.projective_attention(values, ref, offsets, logits, cams, geom)
    exact = pk.projective_attention_plain([v.double() for v in values], ref.double(),
                                          offsets.double(), logits.double(), cams.double(), geom)
    vmax = max(float(v.abs().max()) for v in values)
    a = torch.maximum(out.double().abs(), exact.abs())
    ulp = torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a.clamp_min(1e-30))) - 7), 0.0)
    share = float(((out.double() - exact).abs() / (ulp + 2.0 ** -12 * vmax)).max())
    del exact
    if not (share <= 1.0 and torch.equal(out, pk.projective_attention(values, ref, offsets,
                                                                       logits, cams, geom))):
        raise AssertionError(f"projattn off its plain version in float64: {share} of the "
                             "tolerance")
    B, V, Q, M, Dh, P, sizes = PROJATTN_CASE
    L = len(sizes)
    taps = B * V * Q * M * L * P
    nbytes = taps * 4 * Dh * 2 + Q * M * L * P * 3 * 4 + V * Q * M * Dh * 2
    b_ms, b_by = bound(nbytes, taps * Dh * 10, BF16_FLOPS)
    f32 = [v.float() for v in values]
    maps = [v.reshape(V, h, w, M, Dh).permute(0, 3, 4, 1, 2).reshape(V * M, Dh, h, w)
            .contiguous() for v, (h, w) in zip(values, sizes)]
    grid = (torch.rand((V * M, Q, P, 2), device=CARD) * 2 - 1).to(torch.bfloat16)

    def library():
        return [F.grid_sample(m, grid, align_corners=False) for m in maps]

    row = dict(name="projattn", source="faster_voxelpose_tpu_torch/csrc/projattn.cu",
               replaces="none (the JAX package has no MvP)", path="mvp",
               shape=[B, V, Q, M, Dh, P, sizes], **timings(
                   lambda: pk.projective_attention(values, ref, offsets, logits, cams, geom)),
               plain_ms=device_readings(lambda: pk.projective_attention_plain(
                   f32, ref, offsets, logits, cams, geom))["device_ms"],
               **library_readings(library), bound_ms=b_ms, bound_by=b_by,
               share_of_tolerance=share)
    row["share_of_bound"] = b_ms / row["device_ms"]
    row["library_over_kernel"] = row["library_device_ms"] / row["device_ms"]
    print(f"kernel projattn [{Q} queries x {V} views x {M} heads x {L} levels x {P} points]: "
          f"against the plain version in float64 {share:.3g} of the tolerance; kernel_ms "
          f"{fmt(row)} plain_ms (device) {row['plain_ms']:.4f} {fmt_library(row)} (the three "
          f"grid_samples alone) bound_ms {b_ms:.4f} ({b_by}; {100 * row['share_of_bound']:.1f}% "
          f"of it) | {card}")
    return row


def mvp_phase(card, requests=8):
    """MvP (`MODEL: mvp`) at the widths of the benchmark's `panoptic_mvp`
    (5 views of 960x512, a Pose-ResNet-50's three levels, 6 decoder layers
    of 256), its seeded weights (`benchmark/core/mvp_weights.py`) on the
    configuration's rig, frames of the benchmark's `images.live` pool: one
    replay of the bf16 'images_u8' graph launches projattn once per layer
    and no other kernel of the port (counts reset just before it),
    `requests` more launch as many each; then the graph against an eager
    service with the same weights on 3 frames (every slot; the gap in mm
    printed, the people judged).  Returns the launch counts of the
    `requests` requests."""
    from benchmark.core.mvp_weights import mvp_weights
    from benchmark.core.weights import backbone_weights
    from benchmark.drivers.live_service import port_config
    from benchmark.traffic.generate import make_pool
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.models import MvPNet
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    config = json.loads((ROOT / "benchmark/configs/panoptic_mvp.json").read_text())
    mix = json.loads((ROOT / "benchmark/traffic/mixes/images.live.json").read_text())
    cfg = port_config(config)
    rig, pool, _ = make_pool(mix, config, 26, CARD)
    weights = (backbone_weights(cfg.DATASET.NUM_JOINTS, 26, CARD),
               mvp_weights(config["yaml"], 26, CARD))

    def service(aot):
        svc = PoseService(cfg, rig=rig, device=CARD, seed=0, aot=False)
        svc.backbone.load_state_dict(weights[0])
        svc.model.load_state_dict(weights[1])
        if aot and svc.warmup() != ["images_u8"]:
            raise AssertionError(f"mvp: graphs {svc.warmup()}")
        return svc

    svc = service(True)
    if not isinstance(svc.model, MvPNet):
        raise AssertionError(f"mvp: {type(svc.model).__name__}")
    svc.infer_images(pool[0])
    sk.reset_launch_counts()
    svc.infer_images(pool[0])
    one = sk.launch_counts()
    expect = {n: 0 for n in one}
    expect["projattn"] = len(svc.model.layers)
    if one != expect:
        raise AssertionError(f"mvp: one replay launched {one}, expected {expect}")
    sk.reset_launch_counts()
    for i in range(requests):
        svc.infer_images(pool[i % len(pool)])
    launches = sk.launch_counts()
    if launches != {n: c * requests for n, c in expect.items()}:
        raise AssertionError(f"mvp: {requests} requests launched {launches}")
    print(f"mvp: one replay of the bf16 'images_u8' graph launched "
          f"{ {n: c for n, c in one.items() if c} }; {requests} requests "
          f"{ {n: c for n, c in launches.items() if c} } | {card}")
    eager = service(False)
    gaps, same = [], True
    for f in pool[:3]:
        got, want = svc.infer_images_raw(f)[0][0], eager.infer_images_raw(f)[0][0]
        gaps.append(float(np.abs(got[..., :3] - want[..., :3]).max()))
        same &= bool(np.array_equal(got[:, 0, 3], want[:, 0, 3]))
    print(f"mvp: graph against eager (bf16) on 3 frames: the same slots valid {same}, joints "
          f"within {max(gaps):.3g} mm ({gaps}) | {card}")
    if not same:
        raise AssertionError("mvp: the graph answers other people than eager")
    return launches


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
        want.update({"sample_whole_projected": len(frames), kernel: len(frames),
                     "weightnet_front": len(frames)})
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
    from faster_voxelpose_tpu_torch.engine.loader import DataLoader

    cfg.SYNTHETIC.NUM_DATA = n_batches * cfg.TRAIN.BATCH_SIZE
    ds = SyntheticDataset(cfg, pose_bank=demo_pose_bank(cfg), cameras=demo_rig(cfg))
    return DataLoader(ds, cfg.TRAIN.BATCH_SIZE, shuffle=True, drop_last=True, seed=seed)


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
    stacks, batch 4) from seeded random weights, the trainer compiled (a
    CUDA graph, replayed after CAPTURE_WARMUP eager steps).

    First the JAX package's own check (`fixed_batch_check`) on the first
    batch of synthetic scenes from the port's generator, heatmaps rendered
    on the card: the detection loss (2D + 1D) must fall.  Then, at the
    profile's LR 1e-4 and ACCUMULATION_STEPS 4, a new compiled trainer
    warmed up and captured on 4 batches takes `fresh_steps` timed steps
    with the data in series (each batch made, uploaded and stepped, then
    a synchronisation) and `fresh_steps` through `prefetch_to_device`
    (batches made and uploaded ahead by its thread).  Prints the device
    time of each step (its copy into the graph's inputs and one replay,
    between CUDA events), the host's time to issue it, samples/s both
    ways and peak memory.  Returns the kernels' launches over the timed
    steps: rows 1 and 2 once and B times per replay."""
    import time

    import torch

    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile
    from faster_voxelpose_tpu_torch.engine.graphs import CAPTURE_WARMUP
    from faster_voxelpose_tpu_torch.engine.loader import prefetch_to_device
    from faster_voxelpose_tpu_torch.engine.trainer import Trainer, batch_to_device
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    cfg = panoptic_synthetic_profile()
    B = cfg.TRAIN.BATCH_SIZE
    loader = synthetic_loader(cfg, 2 + CAPTURE_WARMUP + 2 * fresh_steps)
    batches = iter(loader)
    torch.manual_seed(1)
    model = build_model(cfg).cuda()
    fixed_batch_check(cfg, model, batch_to_device(next(batches), "cuda"), "synthetic batch",
                      ("2d_heatmaps", "1d_heatmaps"))

    tr = Trainer(cfg, model)
    for _ in range(CAPTURE_WARMUP + 1):
        tr.step(batch_to_device(next(batches), "cuda"))
    if tr._graph.captured is None:
        raise AssertionError("train: the compiled trainer captured no graph")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    device_ms, host_ms, data_ms = [], [], []
    t_start = time.perf_counter()
    for i in range(fresh_steps):
        t0 = time.perf_counter()
        batch = batch_to_device(next(batches), "cuda")
        t1 = time.perf_counter()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        losses = tr.step(batch)
        b.record()
        t2 = time.perf_counter()
        b.synchronize()
        data_ms.append((t1 - t0) * 1e3)
        host_ms.append((t2 - t1) * 1e3)
        device_ms.append(a.elapsed_time(b))
        if not all(torch.isfinite(v) for v in losses.values()):
            raise AssertionError(f"non-finite loss at fresh step {i}: {losses}")
    series_s = time.perf_counter() - t_start
    t_start = time.perf_counter()
    n_fed = 0
    for batch in prefetch_to_device(batches, device="cuda"):
        losses = tr.step(batch)
        n_fed += 1
    torch.cuda.synchronize()
    fed_s = time.perf_counter() - t_start
    if n_fed != fresh_steps or not all(torch.isfinite(v) for v in losses.values()):
        raise AssertionError(f"train: prefetch fed {n_fed} batches, last losses {losses}")
    launches = sk.launch_counts()
    # the graph's pool is reserved, not allocated, between replays
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    n = 2 * fresh_steps
    print(f"train compiled, fresh batches: {fresh_steps} steps of batch {B} with the data in "
          f"series: device ms/step (copy in + one replay, CUDA events) median "
          f"{np.median(device_ms):.4f} (min {min(device_ms):.4f} max {max(device_ms):.4f}), "
          f"host ms to issue a step median {np.median(host_ms):.4f}, host data ms/batch median "
          f"{np.median(data_ms):.3f}, samples/s {fresh_steps * B / series_s:.3f}; "
          f"{fresh_steps} steps through prefetch_to_device: samples/s "
          f"{fresh_steps * B / fed_s:.3f}; peak memory allocated {peak / 2**30:.3f} GiB, reserved "
          f"(the graph's pool included) {reserved / 2**30:.3f} GiB, launches per "
          f"replay {({k: v / n for k, v in launches.items() if v})}, last losses "
          f"{({k: round(float(v), 6) for k, v in losses.items()})} | {card}")
    # the whole-space sampler once per replayed step (one batch), the crop
    # sampler once per sample, the coords mode never
    want = {"sample_whole_projected": n, "sample_crop_planes": B * n, "sample_whole": 0}
    for name, count in want.items():
        if launches[name] != count:
            raise AssertionError(f"{name} launched {launches[name]} times in {n} steps "
                                 f"of {B}, expected {count}")
    return launches


# Compiled against eager training in float32 (TF32 off), 12 steps: limits
# set between the float32 readings and a bf16 control's (compiled_train_phase).
# Six runs on an NVIDIA H100 80GB HBM3 at 700 W read float32 losses
# 2.8e-4-5.3e-3 and, for all tensors of a kind together, parameters
# 1.3e-4-1.6e-4, mu 3.4e-3-3.3e-2, nu 2.0e-4-3.5e-3 (the drift varies from
# run to run: cuDNN's backward is not bit for bit); the control losses
# 6.7e-2-7.4e-2, parameters 4.2e-3, mu 0.42-0.43, nu 0.28.
TRAIN_GRAPH_LOSS_TOL = 2e-2
TRAIN_GRAPH_STATE_TOL = {"param": 1e-3, "mu": 0.1, "nu": 3e-2}


def _trainer_run(tr, batches):
    """Losses (host floats) and (HDN Adam count, JLN Adam count, mini-step)
    after each step, and the trainer's parameters and moments after the
    last, by name."""
    import torch

    losses, gates = [], []
    for b in batches:
        out = tr.step(b)
        losses.append({k: float(v) for k, v in out.items()})
        gates.append((int(tr.opt_pose.count), int(tr.opt_joint.count), int(tr.mini_step)))
    state = {f"param {k}": p.detach().double().cpu() for k, p in tr.model.named_parameters()}
    for name, opt, prefix in (("pose", tr.opt_pose, "hdn."), ("joint", tr.opt_joint, "jln.")):
        names = [n for n, _ in tr.model.named_parameters() if n.startswith(prefix)]
        for key in ("mu", "nu"):
            for n, v in zip(names, opt.views(getattr(opt, key))):
                state[f"{key} {n}"] = v.detach().double().cpu()
    torch.cuda.synchronize()
    return losses, gates, state


def _trainer_gap(ref, got):
    """(worst relative loss error over steps and terms, {kind: relative L2
    error of all the tensors of that kind together} for parameters, mu and
    nu, the worst single tensor's relative L2 error and its name); a
    tensor's norm below 1e-3 of the largest of its kind is taken at that
    floor, as the train-parity phase floors its gradients."""
    import torch

    (l_ref, _, s_ref), (l_got, _, s_got) = ref, got
    d_loss = max(abs(b[k] - a[k]) / max(abs(a[k]), 1e-6) for a, b in zip(l_ref, l_got) for k in a)
    kinds = {}
    for k in s_ref:
        kinds.setdefault(k.split(" ", 1)[0], []).append(k)
    whole, rel = {}, {}
    for kind, keys in kinds.items():
        a = torch.cat([s_ref[k].reshape(-1) for k in keys])
        b = torch.cat([s_got[k].reshape(-1) for k in keys])
        whole[kind] = float((b - a).norm() / a.norm())
        scale = max(float(s_ref[k].norm()) for k in keys)
        rel.update({k: float((s_got[k] - s_ref[k]).norm()) / max(float(s_ref[k].norm()),
                                                                  1e-3 * scale) for k in keys})
    worst = max(rel, key=rel.get)
    return d_loss, whole, rel[worst], worst


def compiled_train_phase(card, steps=12):
    """The compiled trainer against the eager one at the Panoptic profile,
    batch 4, from the same seeded weights (torch.manual_seed(1)) on the
    same `steps` synthetic batches, one of them with no GT person so that
    the JLN's Adam is skipped there.  In float32 conv stacks (TF32 off):
    the same gates on every call (the JLN's skip and the HDN's k-th
    step), losses at every step within TRAIN_GRAPH_LOSS_TOL relative, and
    after the last step the parameters and both Adams' moments within
    TRAIN_GRAPH_STATE_TOL, the relative L2 of all tensors of a kind
    together.  cuDNN's float32 backward is not bit for bit (atomics) and
    Adam's first steps move an element by about +-LR whatever the size of
    its gradient, so the two trajectories drift apart, and the limits lie
    between that reading and a control's: the compiled trainer with bf16
    conv stacks from the same weights, which must break every one.  The
    same comparison with each call started from the same state is printed
    too: the step itself, without the drift."""
    import copy

    import torch

    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile
    from faster_voxelpose_tpu_torch.engine.trainer import Trainer, batch_to_device
    from faster_voxelpose_tpu_torch.models import build_model

    cfg = panoptic_synthetic_profile()
    cfg.NETWORK.COMPUTE_DTYPE = "float32"
    batches = [batch_to_device(b, CARD) for b in synthetic_loader(cfg, steps, seed=3)]
    batches[steps // 2]["num_person"].zero_()
    torch.manual_seed(1)
    state0 = copy.deepcopy(build_model(cfg).state_dict())

    def run(dtype, compiled):
        c = copy.deepcopy(cfg)
        c.NETWORK.COMPUTE_DTYPE = dtype
        model = build_model(c)
        model.load_state_dict(state0)
        tr = Trainer(c, model.to(CARD), compiled=compiled)
        out = _trainer_run(tr, batches)
        if compiled and tr._graph.captured is None:
            raise AssertionError("train graph: no capture in the compiled run")
        return out

    eager = run("float32", False)
    compiled = run("float32", True)
    control = run("bfloat16", True)
    # the same comparison with each call from the eager trainer's state,
    # copied into the tensors the graph reads: the step itself, without
    # the trajectories' drift
    c = copy.deepcopy(cfg)
    models = [build_model(c) for _ in range(2)]
    for m in models:
        m.load_state_dict(state0)
    te, tc = (Trainer(c, m.to(CARD), compiled=f) for m, f in zip(models, (False, True)))
    synced = []
    for b in batches:
        tc.load_state_dict(te.state_dict())
        le = {k: float(v) for k, v in te.step(b).items()}
        lc = {k: float(v) for k, v in tc.step(b).items()}
        synced.append(max(abs(lc[k] - v) / max(abs(v), 1e-6) for k, v in le.items()))
    print(f"train graph: each call from the same state, compiled float32 against eager: losses "
          f"worst rel {max(synced):.4g} (per call {[f'{x:.3g}' for x in synced]})")
    del te, tc, models
    joint = [l["joint"] > 0 for l in eager[0]]
    print(f"train graph: {steps} steps of batch {cfg.TRAIN.BATCH_SIZE}, float32; joint loss > 0 "
          f"on {sum(joint)} of {steps} calls; gates (HDN count, JLN count, mini-step) eager "
          f"{eager[1]}, compiled {compiled[1]}, bf16 control {control[1]} | {card}")
    if eager[1] != compiled[1]:
        raise AssertionError("train graph: the compiled trainer gated other calls than eager")
    if eager[1][steps // 2][1] != eager[1][steps // 2 - 1][1] or eager[1][-1][0] != steps // 4:
        raise AssertionError(f"train graph: the skip or the k-th steps were not taken: {eager[1]}")
    readings = {}
    for label, got in (("compiled float32", compiled), ("bf16 control", control)):
        d_loss, whole, d_tensor, worst = _trainer_gap(eager, got)
        readings[label] = d_loss, whole
        print(f"train graph [{label}] against eager float32: losses worst rel {d_loss:.4g}; "
              f"relative L2 of all parameters, mu, nu together "
              f"{({k: float(f'{v:.4g}') for k, v in whole.items()})}; worst single tensor "
              f"{d_tensor:.4g} ({worst})")
    d_loss, whole = readings["compiled float32"]
    if not (d_loss <= TRAIN_GRAPH_LOSS_TOL
            and all(whole[k] <= tol for k, tol in TRAIN_GRAPH_STATE_TOL.items())):
        raise AssertionError(f"train graph: compiled float32 off eager by {d_loss} (losses) or "
                             f"{whole} (state), limits {TRAIN_GRAPH_LOSS_TOL}, "
                             f"{TRAIN_GRAPH_STATE_TOL}")
    d_loss, whole = readings["bf16 control"]
    if not (d_loss > TRAIN_GRAPH_LOSS_TOL
            and all(whole[k] > tol for k, tol in TRAIN_GRAPH_STATE_TOL.items())):
        raise AssertionError(f"train graph: the bf16 control passes a float32 limit: "
                             f"{d_loss}, {whole}")


def _tree_digest(root):
    import hashlib

    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.is_file():
            h.update(p.relative_to(root).as_posix().encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def _run_tool(args, cwd, label, fails_with=None):
    """python -m <args> in `cwd` with the checkout importable; raises with
    its output when it fails (or, given `fails_with`, unless it fails
    with that text in its output); returns its standard output and
    error."""
    import os
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)
    out = proc.stdout + proc.stderr
    if (proc.returncode != 0) != (fails_with is not None) or (fails_with or "") not in out:
        raise AssertionError(f"cli: {label} exited {proc.returncode}:\n{out[-4000:]}")
    print(f"cli: {label} exited {proc.returncode} in {time.perf_counter() - t0:.1f} s")
    return out


def cli_phase(card, num_data=64):
    """The training CLI end to end, in subprocesses in a temporary
    directory: tools/make_demo_data.py writes the Panoptic profile's data
    there; tools/train.py trains configs/demo/panoptic_synthetic.yaml for
    2 epochs on `num_data` scenes (compiled, validating every epoch,
    snapshots into the temporary directory), then resumes for a third.
    Checks: both exit 0; the resumed run starts at epoch 2; the log file,
    scalars.jsonl and a TensorBoard event file exist and the event file
    reads back; the eval record names the config repo-relative; the
    snapshot loads and a PoseService on it answers; rows 1 and 2 were
    launched; nothing under checkpoints/ changed.  Prints each epoch's
    wall time and each validation's frames/s.  Returns the kernel launches
    of the two training processes, summed."""
    import json
    import re
    import tempfile

    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile
    from faster_voxelpose_tpu_torch.datasets.demo_data import demo_rig
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.engine.checkpoint import load_best_npz
    from faster_voxelpose_tpu_torch.geometry import pack_rig
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.utils.tb_events import read_events
    from faster_voxelpose_tpu_torch.weights import to_jax_variables

    before = _tree_digest(ROOT / "checkpoints")
    cfg_path = ROOT / "configs" / "demo" / "panoptic_synthetic.yaml"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        tmp = pathlib.Path(tmp)
        _run_tool(["faster_voxelpose_tpu_torch.tools.make_demo_data", "--out",
                   str(tmp / "data" / "DemoPanoptic"), "--views", "5", "--poses", "2000",
                   "--skeleton", "panoptic15", "--center", "0", "-500", "--radius", "2800",
                   "--image-size", "1920", "1080"], tmp, "make_demo_data")
        train = ["faster_voxelpose_tpu_torch.tools.train", "--cfg", str(cfg_path),
                 "--num-data", str(num_data), "--snapshot-dir", str(tmp / "snap")]
        logs = [_run_tool(train + ["--epochs", "2"], tmp, "train --epochs 2"),
                _run_tool(train + ["--resume", "--epochs", "3"], tmp, "train --resume --epochs 3")]
        for i, log in enumerate(logs):
            epochs = re.findall(r"epoch (\d+) trained in ([0-9.]+) s", log)
            fps = re.findall(r"validated (\d+) frames in [0-9.]+s \(([0-9.]+) frames/s\)", log)
            print(f"cli run {i + 1}: epochs trained (epoch, wall s) {epochs}; validations "
                  f"(frames, frames/s) {fps}")
        if "resumed from" not in logs[1] or re.findall(r"epoch (\d+) trained", logs[1]) != ["2"]:
            raise AssertionError(f"cli: the resumed run did not start at epoch 2:\n{logs[1][-3000:]}")
        out_dir = tmp / "output" / "synthetic" / "panoptic_synthetic"
        if not list(out_dir.glob("panoptic_synthetic_*_train.log")) \
                or not (out_dir / "checkpoint.pt").exists():
            raise AssertionError(f"cli: no log file or checkpoint in {out_dir}")
        scalars = list((tmp / "log" / "synthetic").glob("panoptic_synthetic_*/scalars.jsonl"))
        events = list((tmp / "log" / "synthetic").glob("panoptic_synthetic_*/events.out.tfevents.*"))
        tags = [e.get("tag") for ev in events for e in read_events(str(ev))[1:]]
        if not scalars or not events or tags.count("eval_metric") != 3:
            raise AssertionError(f"cli: scalars {scalars}, events {events}, tags {tags}")
        record = json.loads((tmp / "snap" / "eval_record.json").read_text())
        if record["config"] != "configs/demo/panoptic_synthetic.yaml":
            raise AssertionError(f"cli: the record's config is {record['config']!r}")
        cfg = panoptic_synthetic_profile()
        model = load_best_npz(str(tmp / "snap" / "model_best.npz"), build_model(cfg))
        rig = demo_rig(cfg)
        svc = PoseService(cfg, variables=to_jax_variables(model.state_dict()),
                          rig=pack_rig([rig[k] for k in sorted(rig)]).astype(np.float32),
                          device=CARD)
        rng = np.random.RandomState(4)
        frame = render_frame(make_people(rng, 3, cfg.CAPTURE_SPEC.SPACE_CENTER),
                             svc._rig.cpu().numpy()[0], cfg, CARD)
        answer = svc.infer_heatmaps(frame)
        print(f"cli: snapshot of epoch {record['epoch']} (metric {record['metric']:.4f}) served: "
              f"{answer['n_people']} people in {answer['latency_ms']} ms | {card}")
        launches = _summed_launches(logs)
        print(f"cli: launches in the two training processes {launches}")
        tool_logs = cli_validate(tmp, card) + cli_panoptic(tmp, card) + cli_demo(tmp, card)
        for k, v in _summed_launches(tool_logs).items():
            launches[k] = launches.get(k, 0) + v
    if _tree_digest(ROOT / "checkpoints") != before:
        raise AssertionError("cli: a file under checkpoints/ changed")
    print(f"cli: launches in every tool process {launches}; checkpoints/ unchanged")
    return launches


def _summed_launches(logs):
    """The kernel launches that each tool's log reports last, summed."""
    import re

    launches = {}
    for log in logs:
        for k, v in json.loads(re.findall(r"kernel launches: (\{.*\})", log)[-1]).items():
            launches[k] = launches.get(k, 0) + v
    return launches


def _config_variant(dst, edits, src=ROOT / "configs" / "demo" / "panoptic_synthetic.yaml"):
    """A copy of a committed config at `dst` with each (old, new) edit made
    where `old` stands once; the stem stays the source's, so that the
    validator's fallback finds the same committed snapshot."""
    text = src.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise AssertionError(f"cli: {old!r} is not once in {src}")
        text = text.replace(old, new)
    dst.mkdir(parents=True, exist_ok=True)
    (dst / src.name).write_text(text)
    return dst / src.name


def cli_validate(tmp, card, scenes=64):
    """tools/validate.py --cfg in a subprocess, in `tmp` where
    tools/make_demo_data.py wrote data/DemoPanoptic: on the Panoptic
    profile's first `scenes` held-out scenes it scores the committed
    snapshot as `evaluate_snapshot` does (the same message).  Returns its
    log."""
    import re

    from faster_voxelpose_tpu_torch.tools.validate import evaluate_snapshot

    logs = []
    snapshot = ROOT / "checkpoints" / "panoptic_synthetic"
    val = _config_variant(tmp / "validate", [("  NUM_DATA: 5000", f"  NUM_DATA: {scenes}"),
                                             ("OUTPUT_DIR: 'output'", "OUTPUT_DIR: 'output_validate'")])
    log = _run_tool(["faster_voxelpose_tpu_torch.tools.validate", "--cfg", str(val), "--device",
                     CARD], tmp, "validate --cfg")
    logs.append(log)
    res = evaluate_snapshot(snapshot, scenes, CARD)
    loaded = re.findall(r"=> loaded best model (\S+)", log)
    printed = re.findall(r"^metric: ([0-9.]+)$", log, re.M)
    print(f"cli: validate --cfg {val.name} ({scenes} scenes) loaded {loaded}, printed metric "
          f"{printed}; evaluate_snapshot on the same scenes {res['metric']:.4f} | {card}")
    if loaded != [str(snapshot / "model_best.npz")] or printed != [f"{res['metric']:.4f}"] \
            or res["message"] not in log:
        raise AssertionError(f"cli: validate --cfg does not score what evaluate_snapshot scores:\n"
                             f"{log[-3000:]}\n{res['message']}")

    return logs


def cli_demo(tmp, card, repeat=20):
    """tools/demo.py in `tmp` on a calibration JSON of the served dome rig,
    5 JPEGs of 1920x1080 and upstream checkpoints of the committed
    weights and a seeded ResNet-50, --repeat 20, against a PoseService on
    the same files.  Returns its log."""
    import importlib.util
    import re

    import cv2

    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile
    from faster_voxelpose_tpu_torch.datasets.images import load_view_images_u8
    from faster_voxelpose_tpu_torch.engine import PoseService
    from faster_voxelpose_tpu_torch.geometry.example_rigs import dome_camera
    from faster_voxelpose_tpu_torch.geometry.transforms import get_resize_transform
    from faster_voxelpose_tpu_torch.weights import to_jax_variables

    cfg = panoptic_synthetic_profile()
    V = cfg.DATASET.CAMERA_NUM
    cams = {str(i): {k: np.asarray(v).tolist() for k, v in
                     dome_camera(i, V, space_center=cfg.CAPTURE_SPEC.SPACE_CENTER).items()}
            for i in range(V)}
    (tmp / "calibration.json").write_text(json.dumps(cams))
    rng = np.random.RandomState(11)
    images = [str(tmp / f"view{v}.jpg") for v in range(V)]
    for path in images:
        cv2.imwrite(path, rng.randint(0, 256, (1080, 1920, 3), np.uint8))
    model, backbone = _upstream_checkpoints(tmp)
    # the plane figure needs matplotlib, which the card's machine may lack:
    # there the demo fails at the figure, after writing the poses
    plotting = importlib.util.find_spec("matplotlib") is not None
    log = _run_tool(["faster_voxelpose_tpu_torch.tools.demo", "--cfg",
                     str(ROOT / "configs" / "demo" / "panoptic_synthetic.yaml"), "--calibration",
                     str(tmp / "calibration.json"), "--images", *images, "--torch-weights",
                     str(tmp / "model.pth"), "--backbone-weights", str(tmp / "backbone.pth"),
                     "--out", str(tmp / "demo_out"), "--repeat", str(repeat), "--device", CARD],
                    tmp, f"demo --repeat {repeat}",
                    fails_with=None if plotting else "No module named 'matplotlib'")
    fused = np.load(tmp / "demo_out" / "fused_poses.npy")
    svc = PoseService(cfg, to_jax_variables(model.state_dict()),
                      to_jax_variables(backbone.state_dict()), device=CARD, aot=False)
    svc.set_rig_from_calibration(str(tmp / "calibration.json"))
    svc.warmup(("images_u8",))
    d = cfg.DATASET
    want = svc.infer_images_raw(load_view_images_u8(
        images, d.IMAGE_SIZE, get_resize_transform(d.ORI_IMAGE_SIZE, d.IMAGE_SIZE)))[0][0]
    valid = want[:, 0, 3] >= 0
    gap = float(np.abs(fused - want).max()) if fused.shape == want.shape else float("inf")
    latency = re.findall(r"steady-state latency: .*", log)
    print(f"cli: demo, 5 JPEGs of 1920x1080 through the 'images_u8' graph: {latency}; "
          f"{int(valid.sum())} people; every slot's fused pose, flag and score against a "
          f"PoseService on the same files: largest gap {gap:.3g} | {card}")
    drawn = (tmp / "demo_out" / "demo_2d_planes.png").exists()
    if not (np.isfinite(fused).all() and latency and gap <= 0.01 and drawn == plotting):
        raise AssertionError(f"cli: demo:\n{log[-3000:]}")
    return [log]


def _upstream_checkpoints(tmp):
    """The committed panoptic_synthetic weights and a seeded ResNet-50 as
    upstream checkpoints under `tmp` (what --torch-weights and
    --backbone-weights read); returns (model, backbone) as loaded."""
    import torch

    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile
    from faster_voxelpose_tpu_torch.engine.checkpoint import load_best_npz
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.models.resnet import build_backbone
    from faster_voxelpose_tpu_torch.weights import upstream_backbone, upstream_model

    cfg = panoptic_synthetic_profile()
    model = load_best_npz(str(ROOT / "checkpoints" / "panoptic_synthetic" / "model_best.npz"),
                          build_model(cfg))
    torch.manual_seed(0)
    backbone = build_backbone(cfg)
    if not (tmp / "model.pth").exists():
        torch.save({"state_dict": upstream_model(model.state_dict())}, tmp / "model.pth")
        torch.save(upstream_backbone(backbone.state_dict(), cfg.RESNET.NUM_LAYERS),
                   tmp / "backbone.pth")
    return model, backbone


def cli_panoptic(tmp, card):
    """The CLIs on Panoptic sequences of 1920x1080 JPEGs written in `tmp`
    under configs/panoptic/jln64.yaml's DATADIR (4 validation frames, 8
    training frames, 5 views, the people of held-out scenes on the
    profile's rig): tools/validate.py --cfg with the 'image' source, an
    upstream checkpoint of the committed weights (--torch-weights), a
    seeded ResNet-50 and TEST.VISUALIZATION; tools/train.py one epoch (2
    steps of 4) on 'images' with TRAIN.VISUALIZATION; then
    tools/preprocess.py twice on a tree of its own (one frame of each
    sequence: every image resized to 960x512 once, then none), in a
    thread beside the validation and the training.  The drawings are 'image_with_poses', which needs cv2 alone
    (matplotlib, which the plane and heatmap figures need, may be absent
    beside the card).  Returns the logs."""
    import math
    import re
    from concurrent.futures import ThreadPoolExecutor

    import cv2

    from faster_voxelpose_tpu_torch.config import profile
    from faster_voxelpose_tpu_torch.datasets import panoptic
    from faster_voxelpose_tpu_torch.datasets.demo_data import demo_rig
    from faster_voxelpose_tpu_torch.tools.validate import held_out_dataset

    src = profile("panoptic_synthetic")
    rig = demo_rig(src)
    cams = [rig[k] for k in sorted(rig)]
    scenes = held_out_dataset(src, 16).records
    root = tmp / "data" / "Panoptic"  # configs/panoptic/jln64.yaml's DATADIR, from tmp
    write_panoptic_sequence(root, panoptic.VAL_SEQUENCES[0], cams, scenes[:4], 12)
    write_panoptic_sequence(root, panoptic.TRAIN_SEQUENCES[0], cams, scenes[:8], 3)
    pre = tmp / "pre" / "data" / "Panoptic"  # preprocess's tree, from tmp / "pre"
    write_panoptic_sequence(pre, panoptic.VAL_SEQUENCES[0], cams, scenes[:1], 12)
    write_panoptic_sequence(pre, panoptic.TRAIN_SEQUENCES[0], cams, scenes[1:2], 3)
    for p in sorted(pre.rglob("*.jpg")):  # a file of its own per frame: no shared inode
        data = p.read_bytes()
        p.unlink()
        p.write_bytes(data)
    _upstream_checkpoints(tmp)
    jln64 = ROOT / "configs" / "panoptic" / "jln64.yaml"

    def preprocess_twice():
        return [re.findall(r"^resized (\d+) images", _run_tool(
            ["faster_voxelpose_tpu_torch.tools.preprocess", "--cfg", str(jln64), "--workers", "2"],
            tmp / "pre", f"preprocess, run {run}"), re.M) for run in (1, 2)]

    # preprocess needs no card: its two runs go on beside the validation and
    # training subprocesses, whose times no check reads
    pool = ThreadPoolExecutor(1)
    preprocessed = pool.submit(preprocess_twice)
    common = [("WORKERS: 8", "WORKERS: 0"),
              ('"backbone/pose_resnet50_panoptic.pth.tar"', f'"{tmp / "backbone.pth"}"')]
    logs = []
    val = _config_variant(tmp / "vis", common + [
        ("OUTPUT_DIR: 'output'", "OUTPUT_DIR: 'output_vis'"),
        ("  MODEL_FILE: 'model_best'\n  BATCH_SIZE: 8\n  VISUALIZATION: false",
         "  MODEL_FILE: 'model_best'\n  BATCH_SIZE: 8\n  VISUALIZATION: true\n"
         "  VIS_TYPE: ['image_with_poses']")], src=jln64)
    log = _run_tool(["faster_voxelpose_tpu_torch.tools.validate", "--cfg", str(val),
                     "--torch-weights", str(tmp / "model.pth"), "--device", CARD], tmp,
                    "validate --cfg, 'image' source, TEST.VISUALIZATION")
    logs.append(log)
    vis_dir = tmp / "output_vis" / "panoptic" / "jln64" / "validation_vis"
    want = {f"val_{i:04d}_view{v}_poses.jpg" for i in range(4) for v in range(5)}
    drawn = {p.name for p in vis_dir.iterdir()} if vis_dir.is_dir() else set()
    metric = re.findall(r"^metric: ([0-9.]+)$", log, re.M)
    print(f"cli: validate --cfg at jln64 ('image' source, upstream checkpoints): metric {metric}; "
          f"TEST.VISUALIZATION drew {len(drawn)} frames")
    if drawn != want or any(cv2.imread(str(vis_dir / n)) is None for n in want) or not metric:
        raise AssertionError(f"cli: validation drawings {sorted(drawn)}:\n{log[-3000:]}")

    tv = _config_variant(tmp / "trainvis", common + [
        ("OUTPUT_DIR: 'output'", "OUTPUT_DIR: 'output_trainvis'"),
        ("TRAIN:\n  BATCH_SIZE: 8", "TRAIN:\n  BATCH_SIZE: 4"),
        ("PRINT_FREQ: 100", "PRINT_FREQ: 1"),
        ("  VISUALIZATION: false\n\nTEST:", "  VISUALIZATION: true\n  VIS_TYPE: ['image_with_poses']"
                                            "\n\nTEST:")], src=jln64)
    log = _run_tool(["faster_voxelpose_tpu_torch.tools.train", "--cfg", str(tv), "--epochs", "1",
                     "--snapshot-dir", str(tmp / "snap_vis"), "--device", CARD], tmp,
                    "train, 'image' source, TRAIN.VISUALIZATION")
    logs.append(log)
    tv_dir = tmp / "output_trainvis" / "panoptic" / "jln64" / "train_vis"
    drawn = sorted(p.name for p in tv_dir.iterdir()) if tv_dir.is_dir() else []
    after = re.findall(r"Epoch \[0\]\[1/2\].* Loss (\S+) \(2d (\S+) 1d (\S+) bbox (\S+) "
                       r"joint (\S+)\)", log)
    print(f"cli: TRAIN.VISUALIZATION drew {len(drawn)} frames; losses of step 1, after the "
          f"drawing of step 0: {after}")
    if drawn != sorted(f"0_{i:06d}_{s:04d}_view{v}_poses.jpg" for i in range(2) for s in range(4)
                       for v in range(5)) \
            or len(after) != 1 or not all(math.isfinite(float(x)) for x in after[0]):
        raise AssertionError(f"cli: train with TRAIN.VISUALIZATION:\n{log[-3000:]}")

    resized = preprocessed.result()
    pool.shutdown()
    frames = sorted(p for p in pre.rglob("*_*_*.jpg"))
    sizes = {cv2.imread(str(p)).shape[:2] for p in frames}
    print(f"cli: preprocess resized {resized[0]} of {len(frames)} frames, then {resized[1]}; "
          f"sizes now {sorted(sizes)}")
    if resized != [[str(len(frames))], ["0"]] or sizes != {(512, 960)} or len(frames) != 10:
        raise AssertionError(f"cli: preprocess: {resized}, {len(frames)} frames, sizes {sizes}")
    return logs


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
    # the default route's kernels, and WeightNet's front of the folded model
    route = ("sample_whole_projected", "sample_crop_planes", "weightnet_front")

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
    ResNet-50 (every slot valid) held the same way; the JSON-lines server
    (tools/serve.py) in a subprocess (a forward holding a host
    synchronisation, whose capture must raise, is `failed_capture_phase`,
    the script's last).  Prints eager and compiled latency
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
        expect.update({"sample_whole_projected": requests, "sample_crop_planes": requests,
                       "weightnet_front": requests})
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
                g.captured.graph.replay()
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
    want = expected_eval_launches(panoptic_synthetic_profile(), scenes)
    for name, count in want.items():
        if launches[name] != count:
            raise AssertionError(f"eval: {name} launched {launches[name]} times for {scenes} "
                                 f"scenes, expected {count}")
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
    """Row 1 once per batch, row 2 once per row of a batch (the final
    batch is padded to TEST.BATCH_SIZE, as the JAX validator pads it),
    row 1's coords mode never."""
    batches = -(-scenes // cfg.TEST.BATCH_SIZE)
    return {"sample_whole_projected": batches,
            "sample_crop_planes": batches * cfg.TEST.BATCH_SIZE, "sample_whole": 0}


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
    want = {n: 0 for n in counts}  # the service serves the folded model: WeightNet's kernel too
    want.update({"sample_whole_projected": requests, "sample_crop_planes": requests,
                 "weightnet_front": requests})
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
    want.update({"sample_whole_projected": requests, "sample_crop_planes": requests,
                 "weightnet_front": requests})
    if launches != want:
        raise AssertionError(f"images: launches {launches}, expected {want}")
    return launches


# -- bench phase: the end-to-end benchmark and its stage and width tools -----

BENCH_GRAPH_TOL = 0.01  # mm: float32 graph against eager, as for the service's graphs
BENCH_DETECTED_OF_TRUE = 0.10  # realistic detected people within 10% of true people


def _graph_launch_check(line, K):
    """Each measurement's graph of F steps launched rows 1 and 2: row 1
    once a step, row 2 once a frame."""
    batch = line["throughput_batch"]
    per = {("graph_launches", "latency"): 1, ("graph_launches", "throughput"): batch,
           ("realistic_graph_launches", "fusion"): 1,
           ("realistic_graph_launches", "fusion_batched"): batch,
           ("realistic_graph_launches", "e2e"): 1,
           ("realistic_graph_launches", "e2e_batched"): batch}
    for (key, mode), frames in per.items():
        for steps, counts in line[key][mode].items():
            want = {"sample_whole_projected": int(steps),
                    "sample_crop_planes": int(steps) * frames}
            if counts != want:
                raise AssertionError(f"bench: the {mode} graph of {steps} steps launched "
                                     f"{counts}, expected {want}")
    if line["worst_case_valid_slots"] != [K, K]:
        raise AssertionError(f"bench: worst-case valid slots per frame (min, max) "
                             f"{line['worst_case_valid_slots']}, expected all {K}")


def bench_graph_check(card):
    """The worst case's 2-frame latency graph (bench.py's first frames,
    RandomState(0)) against the same 2 frames through the eager step: in
    float32 with TF32 off the same valid slots, all K, and fused poses
    within BENCH_GRAPH_TOL mm; in bf16, as the bench runs, the gap is
    printed.  The live voxels of each crop of the first frame (from an
    eager forward's proposals, float32) must cover every slot."""
    import torch

    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.models.projection import compute_crop_origin, crop_axis_masks
    from faster_voxelpose_tpu_torch.models.resnet import build_backbone
    from faster_voxelpose_tpu_torch.tools import bench
    from faster_voxelpose_tpu_torch.tools.timing import scan_time

    dev = torch.device(CARD)
    cfg = bench.worst_case_config()
    V, K = cfg.DATASET.CAMERA_NUM, cfg.CAPTURE_SPEC.MAX_PEOPLE
    iw, ih = cfg.DATASET.IMAGE_SIZE
    frames = torch.as_tensor(np.random.RandomState(0).randn(2, V, ih, iw, 3)
                             .astype(np.float32)).to(dev)
    gaps = {}
    for dtype in ("float32", "bfloat16"):
        cfg.NETWORK.COMPUTE_DTYPE = dtype
        model = bench.seeded(build_model, cfg, 0, dev)
        backbone = bench.seeded(build_backbone, cfg, 0, dev)
        cams = torch.as_tensor(bench.bench_rig(cfg)).to(dev)
        step = bench.frame_step(model, backbone, cams)
        graph = scan_time(step, (frames,), 2, dev, reps=1).outputs
        with torch.inference_mode():
            carry, eager = torch.zeros((), device=dev), []
            for i in range(2):
                carry, out = step(carry, (frames[i],))
                eager.append(out)
            eager = torch.stack(eager).cpu()
            if dtype == "float32":
                pc = model(backbone(frames[0])[None], cams).proposal_centers[0]
                tl, _ = compute_crop_origin(model.geom, pc[:, :3])
                mx, my, mz = crop_axis_masks(model.geom, tl, pc[:, 5:7])
                live = [int(mx[k].sum() * my[k].sum() * mz[k].sum())
                        for k in range(K) if pc[k, 3] >= 0]
        same = torch.equal(graph[..., 0, 3], eager[..., 0, 3])
        valid = int((graph[..., 0, 3] >= 0).sum())
        gaps[dtype] = float((graph[..., :3] - eager[..., :3]).abs().max())
        print(f"bench: worst case, 2-frame graph against eager, {dtype}: same valid slots "
              f"{same} ({valid} of {2 * K}), fused poses max gap {gaps[dtype]:.3g} mm | {card}")
        if dtype == "float32" and not (same and valid == 2 * K
                                       and gaps[dtype] <= BENCH_GRAPH_TOL):
            raise AssertionError(f"bench: float32 graph against eager: slots equal {same}, "
                                 f"{valid} valid, gap {gaps[dtype]} mm > {BENCH_GRAPH_TOL}")
        del model, backbone, step
    print(f"bench: live voxels of the {len(live)} crops of the first frame {live} "
          f"(of {np.prod(cfg.INDIVIDUAL_SPEC.VOXELS_PER_AXIS)} each)")
    if len(live) != K or min(live) <= 0:
        raise AssertionError(f"bench: the worst case's crops are not all live: {live}")
    return gaps


def _tool_in_process(tool, label):
    """tool.main([]) in this process, its output printed; returns its JSON
    line and the kernel launches of its run."""
    import contextlib
    import io

    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tool.main([])
    print(buf.getvalue(), end="")
    if rc != 0:
        raise AssertionError(f"bench: {label} returned {rc}")
    print(f"bench: {label} ran in {time.perf_counter() - t0:.1f} s")
    return json.loads(buf.getvalue().strip().splitlines()[-1]), sk.launch_counts()


def bench_phase(card):
    """The end-to-end benchmark: `python3 -m faster_voxelpose_tpu_torch.tools.bench`
    once, full size, in a subprocess with nothing else on the card; its
    last line holds every key of bench.py's line and a device time per
    mode, finite positive rates, every worst-case slot valid, each
    graph's launches of rows 1 and 2, and realistic detected people
    within 10% of true people over the same 24 frames.  Then the worst
    case's graph against eager (`bench_graph_check`), and the stage and
    width tools (tools.profile_stages, tools.bench_width) in this process.
    Returns the launches of the bench process and of the two tools, and
    the bench's line."""
    from faster_voxelpose_tpu_torch.tools import bench, bench_width, profile_stages

    t0 = time.perf_counter()
    out = _run_tool(["faster_voxelpose_tpu_torch.tools.bench"], ROOT, "tools.bench")
    print("\n".join(out.strip().splitlines()[-4:]))
    line = json.loads(next(ln for ln in reversed(out.splitlines()) if ln.startswith('{"metric"')))
    bench.check_line(line)
    _graph_launch_check(line, bench.worst_case_config().CAPTURE_SPEC.MAX_PEOPLE)
    true, detected = line["realistic_true_people"], line["realistic_detected_people"]
    if not abs(detected - true) <= BENCH_DETECTED_OF_TRUE * true:
        raise AssertionError(f"bench: detected people {detected} not within "
                             f"{BENCH_DETECTED_OF_TRUE:.0%} of true people {true}")
    launches = {"bench": _summed_launches([out])}
    print(f"bench: tools.bench in {time.perf_counter() - t0:.1f} s: worst case "
          f"{line['value']} frames/s (device {line['latency_device_ms']:.4f} ms a frame), "
          f"batch {line['throughput_batch']} {line['throughput_fps']} frames/s (device "
          f"{line['throughput_device_ms']:.4f} ms a step); realistic detected {detected} of "
          f"{true} people; launches {launches['bench']} | {card}")
    bench_graph_check(card)
    stages, counts = _tool_in_process(profile_stages, "tools.profile_stages")
    if not all(math.isfinite(v["host_ms"]) and v["device_ms"] > 0 for v in stages.values()):
        raise AssertionError(f"bench: profile_stages readings {stages}")
    width, more = _tool_in_process(bench_width, "tools.bench_width")
    sides = (width["base"], width["narrow"])
    if not all(w["weights"] == "trained snapshot" and w["fusion_device_ms_per_frame"] > 0
               for w in sides):
        raise AssertionError(f"bench: bench_width readings {width}")
    launches["bench tools"] = {k: counts[k] + more[k] for k in counts}
    print(f"bench: phase {time.perf_counter() - t0:.1f} s; launches of the stage and width "
          f"tools {launches['bench tools']} | {card}")
    return launches, line


# -- script tools phase: the counterparts of the JAX repo's last scripts ------

TRACE_OF_BENCH = 0.05  # the trace's device ms a frame within 5% of the bench's latency_device_ms
TRACE_FRAMES = 4
ROUTE_TOL = 0.01  # mm: every float32 route against 'quad', as in route_phase


def _in_process(label, fn, *args, **kwargs):
    """fn(*args, **kwargs) in this process, its printed output shown after
    it, its seconds printed; the root logger's handlers, which the tools'
    create_logger extends, are put back."""
    import contextlib
    import io
    import logging

    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            return fn(*args, **kwargs)
    finally:
        for h in root.handlers:
            if h not in handlers:
                h.close()
        root.handlers[:] = handlers
        root.setLevel(level)
        print(buf.getvalue(), end="")
        print(f"script tools: {label} ran in {time.perf_counter() - t0:.1f} s")


def _tools_trace(tmp, card, bench_ms):
    """capture_trace and analyze_trace: the worst case's frames in one
    graph under the profiler; rows 1 and 2 by name in the trace, once a
    frame, and the trace's device time a frame within TRACE_OF_BENCH of
    the bench's device ms a frame, `bench_ms`."""
    from faster_voxelpose_tpu_torch.tools import analyze_trace, capture_trace

    logdir = str(tmp / "trace")
    res = _in_process("capture_trace", capture_trace.main, [logdir, str(TRACE_FRAMES)])
    got = _in_process("analyze_trace", analyze_trace.main,
                      [logdir, "15", "--frames", str(TRACE_FRAMES)])
    count = {row: sum(n for name, n in got["count"].items() if key in name)
             for row, key in (("row 1", "whole_kernel"), ("row 2", "crop_kernel<false, false, false>"))}
    per_frame = got["sum_us"] / 1e3 / TRACE_FRAMES
    print(f"script tools: trace of {TRACE_FRAMES} worst-case frames: device {per_frame:.4f} ms "
          f"a frame against the bench's {bench_ms:.4f} ({per_frame / bench_ms - 1:+.2%}), busy "
          f"share {got['busy_share']:.4f}, kernels by name {count}, launches "
          f"{ {k: n for k, n in res['launches'].items() if n} } | {card}")
    if got["kind"] != "device" or count != {"row 1": TRACE_FRAMES, "row 2": TRACE_FRAMES} \
            or abs(per_frame / bench_ms - 1) > TRACE_OF_BENCH:
        raise AssertionError(f"script tools: the trace reads {got['kind']}, {count}, "
                             f"{per_frame} ms a frame against {bench_ms}")


def _tools_backbone(card):
    """profile_backbone: the stages and the whole backbone, each a finite
    time under the card's peak."""
    from faster_voxelpose_tpu_torch.tools import profile_backbone

    tags = ",".join(profile_backbone.STAGES + ("full",))
    line = _in_process("profile_backbone", profile_backbone.main, [tags, "--lengths", "1,3"])
    bad = {t: r for t, r in line.items() if isinstance(r, dict)
           and not (r["device_ms"] > 0 and 0 < r["share_of_peak"] < 1)}
    if bad or "stage_sum_ms" not in line:
        raise AssertionError(f"script tools: profile_backbone readings {bad or line}")


def _tools_parity(tmp, card):
    """run_real_parity: with no data a skip for each dataset and PARITY.md
    in the temporary directory only; then, on a Panoptic 'image' sequence
    of 4 frames with the committed weights and a seeded ResNet-50 as
    upstream checkpoints, --preprocess, conversion and validation."""
    import shutil

    from faster_voxelpose_tpu_torch.config import profile
    from faster_voxelpose_tpu_torch.datasets import panoptic
    from faster_voxelpose_tpu_torch.datasets.demo_data import demo_rig
    from faster_voxelpose_tpu_torch.tools import run_real_parity
    from faster_voxelpose_tpu_torch.tools.validate import held_out_dataset

    repo_md = (ROOT / "PARITY.md").exists(), pathlib.Path("PARITY.md").exists()
    none = str(tmp / "none")
    skips = _in_process("run_real_parity, no data", run_real_parity.main,
                        ["--data-dir", none, "--weights-dir", none, "--out",
                         str(tmp / "PARITY.md")])
    if [r["status"] for r in skips] != ["no-data"] * 3 or not (tmp / "PARITY.md").exists() \
            or ((ROOT / "PARITY.md").exists(), pathlib.Path("PARITY.md").exists()) != repo_md:
        raise AssertionError(f"script tools: run_real_parity without data: {skips}")

    src = profile("panoptic_synthetic")
    rig = demo_rig(src)
    write_panoptic_sequence(tmp / "data" / "Panoptic", panoptic.VAL_SEQUENCES[0],
                            [rig[k] for k in sorted(rig)], held_out_dataset(src, 4).records, 12)
    _upstream_checkpoints(tmp)
    weights = tmp / "weights"
    weights.mkdir()
    shutil.copy(tmp / "model.pth", weights / "panoptic_model_best.pth.tar")
    shutil.copy(tmp / "backbone.pth", weights / "pose_resnet50_panoptic.pth.tar")

    def hook(name, cfg):  # no spawn workers; outputs in the temporary directory
        cfg.WORKERS = 0
        cfg.OUTPUT_DIR = str(tmp / "output")

    res = _in_process("run_real_parity, Panoptic image fixture", run_real_parity.run_parity,
                      str(tmp / "data"), str(weights), ("panoptic",), 4, "torch", True,
                      str(tmp / "PARITY_fixture.md"), hook)
    print(f"script tools: run_real_parity on the fixture: {[(r['status'], r.get('frames'), r.get('metric')) for r in res]} | {card}")
    if [r["status"] for r in res] != ["ok"] or res[0]["frames"] != 4 \
            or not math.isfinite(res[0]["metric"]):
        raise AssertionError(f"script tools: run_real_parity on the fixture: {res}")


def _tools_snapshots(tmp, card):
    """export_best_npz (panoptic_synthetic's committed weights as the best
    model, --snapshot-dir in the temporary directory, 64 held-out scenes),
    diagnose_campus (campus_synthetic_ref's committed npz where
    load_best_model reads it, 64 scenes) and bench_realistic
    (panoptic_synthetic), on data written by tools/make_demo_data.py."""
    import shutil

    from faster_voxelpose_tpu_torch.tools import (bench_realistic, diagnose_campus,
                                                  export_best_npz, make_demo_data)

    demo = {"panoptic_synthetic": ("DemoPanoptic", ["--views", "5", "--skeleton", "panoptic15",
                                                    "--center", "0", "-500", "--radius", "2800",
                                                    "--image-size", "1920", "1080"], "5000"),
            "campus_synthetic_ref": ("DemoCampus", ["--views", "3", "--skeleton", "coco17",
                                                    "--center", "3000", "4500", "--radius",
                                                    "10500", "--image-size", "360", "288"],
                                     "10000")}
    cfgs = {}
    for stem, (datadir, args, n) in demo.items():
        _in_process(f"make_demo_data {datadir}", make_demo_data.main,
                    ["--out", str(tmp / "data" / datadir), "--poses", "2000", *args])
        cfgs[stem] = _config_variant(tmp / "cfg", [
            ("OUTPUT_DIR: 'output'", f"OUTPUT_DIR: '{tmp}/output'"),
            ("LOG_DIR: 'log'", f"LOG_DIR: '{tmp}/log'"),
            (f'DATADIR: "data/{datadir}"', f'DATADIR: "{tmp}/data/{datadir}"'),
            (f"NUM_DATA: {n}", "NUM_DATA: 64")], src=ROOT / "configs" / "demo" / f"{stem}.yaml")
        out = tmp / "output" / "synthetic" / stem
        out.mkdir(parents=True)
        shutil.copy(ROOT / "checkpoints" / stem / "model_best.npz", out / "model_best.npz")
    (tmp / "output" / "synthetic" / "panoptic_synthetic" / "run_train.log").write_text(
        "2026-01-01 00:00:00,000 epoch 7\n2026-01-01 00:00:01,000 => saved best model to x\n")

    snap = tmp / "snap"
    record = _in_process("export_best_npz", export_best_npz.main,
                         ["--cfg", str(cfgs["panoptic_synthetic"]), "--snapshot-dir", str(snap)])
    with np.load(snap / "model_best.npz") as a, \
            np.load(ROOT / "checkpoints" / "panoptic_synthetic" / "model_best.npz") as b:
        same = sorted(a.files) == sorted(b.files) and all(np.array_equal(a[k], b[k])
                                                          for k in a.files)
    print(f"script tools: export_best_npz: the npz equals the committed one {same}; record "
          f"epoch {record['epoch']}, metric {record['metric']:.4f} on {record['eval_set']} | {card}")
    if not (same and record["epoch"] == 7 and 0 < record["metric"] <= 1
            and json.loads((snap / "eval_record.json").read_text()) == record):
        raise AssertionError(f"script tools: export_best_npz: {record}")

    res = _in_process("diagnose_campus", diagnose_campus.main,
                      ["--cfg", str(cfgs["campus_synthetic_ref"])])
    print(f"script tools: diagnose_campus on 64 scenes: |dx|, |dy|, |dz| {res['axis_mm']} mm over "
          f"{res['matched']} matched poses, PCP3D {res['pcp']:.4f} | {card}")
    if not (res["matched"] > 0 and all(math.isfinite(v) for v in res["axis_mm"])
            and 0 < res["pcp"] <= 1):
        raise AssertionError(f"script tools: diagnose_campus: {res}")

    line = _in_process("bench_realistic", bench_realistic.main, [str(cfgs["panoptic_synthetic"])])
    true, detected = line["true_people"], line["detected_people"]
    steps = [int(n) for n in line["launches"]["fusion"]]
    if not (abs(detected - true) <= BENCH_DETECTED_OF_TRUE * true
            and line["device_ms_per_frame"] > 0 and line["batched_device_ms_per_frame"] > 0
            and all(c == {"sample_whole_projected": s, "sample_crop_planes": s}
                    for s, c in zip(steps, line["launches"]["fusion"].values()))):
        raise AssertionError(f"script tools: bench_realistic: {line}")


def _tools_sampling(card):
    """check_sampling_parity at Panoptic and Campus (every float32 route
    within ROUTE_TOL of 'quad', each launching its own crop kernel once),
    smoke_kernels whole, and each sweep on three variants, the
    production constants among them."""
    import torch

    from faster_voxelpose_tpu_torch.tools import (check_sampling_parity, smoke_kernels,
                                                  sweep_planes, sweep_whole)

    for cfg in ("configs/panoptic/jln64.yaml", "configs/campus/jln64.yaml"):
        out = _in_process(f"check_sampling_parity {cfg}", check_sampling_parity.check,
                          ROOT / cfg, torch.device(CARD), timing=False)
        crops = {r["route"]["crop"] for r in out.values()}
        worst = max(r["gap_mm"] for n, r in out.items() if n != "quad" and r["dtype"] == "float32")
        bad = [n for n, r in out.items()
               if r["launches"] != {"sample_whole_projected": 1, r["route"]["crop"]: 1}
               or (n != "quad" and r["dtype"] == "float32"
                   and not (r["agreement"] == 1.0 and r["gap_mm"] <= ROUTE_TOL))]
        print(f"script tools: check_sampling_parity {cfg}: {len(out)} variants, crop kernels "
              f"{sorted(crops)}, float32 routes within {worst:.3g} mm of 'quad' | {card}")
        if bad or len(crops) != 3:
            raise AssertionError(f"script tools: check_sampling_parity {cfg}: {bad}, {crops}")
    _in_process("smoke_kernels", smoke_kernels.main, [])
    for tool, names in ((sweep_whole, "v128,v256,v512"),
                        (sweep_planes, "t4432_n256,t8832_n256,t4432_n128")):
        rows = _in_process(tool.__name__.rsplit(".", 1)[1], tool.main,
                           ["--variants", names, "--lengths", "2,6"])
        if [r["name"].split()[0] for r in rows] != names.split(",") \
                or not any(r["name"] == tool.PRODUCTION for r in rows):
            raise AssertionError(f"script tools: {tool.__name__}: {rows}")


def script_tools_phase(card, bench_line):
    """The counterparts of the JAX repo's last eleven scripts, each run on
    the card at short settings in a temporary directory and checked:
    capture_trace + analyze_trace, profile_backbone, run_real_parity,
    export_best_npz, diagnose_campus, bench_realistic,
    check_sampling_parity, smoke_kernels, sweep_whole and sweep_planes.
    Nothing under checkpoints/ changes (`_tree_digest`).  `bench_line`
    is the bench phase's, whose latency_device_ms the trace is held to.
    Returns the kernel launches of the phase."""
    import tempfile

    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    t0 = time.perf_counter()
    before = _tree_digest(ROOT / "checkpoints")
    sk.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        tmp = pathlib.Path(tmp)
        _tools_trace(tmp, card, bench_line["latency_device_ms"])
        _tools_backbone(card)
        _tools_parity(tmp, card)
        _tools_snapshots(tmp, card)
        _tools_sampling(card)
    launches = sk.launch_counts()
    unchanged = _tree_digest(ROOT / "checkpoints") == before
    print(f"script tools: phase {time.perf_counter() - t0:.1f} s; checkpoints/ unchanged "
          f"{unchanged}; launches {launches} | {card}")
    if not unchanged:
        raise AssertionError("script tools: checkpoints/ changed")
    missing = [k for k in ("sample_whole", "sample_whole_projected", "sample_crop_planes",
                           "sample_crop_planes_coords", "sample_crop_cube") if launches[k] <= 0]
    if missing:
        raise AssertionError(f"script tools: kernels never launched: {missing}")
    return launches


# -- datasets phase: every heatmap source and dataset -----------------------

NATIVE_NUMPY_TOL = 2e-6  # the native renderer against its numpy plain version
HOST_DEVICE_RENDER_TOL = 2e-5  # host rendering against ops/heatmap_render.py (the JAX tests')
# host-rendered accuracy (8 spawn workers) against the device-rendered reading of the same
# scenes in the same run, augmentation off in both (the workers draw their own)
HOST_AP50_TOL = 0.002
HOST_MPJPE_TOL = 0.2  # mm
# 'pred' source (the GT projected into every view, rendered on the host) against the 'gt'
# device path, on frames where every joint lands inside every view: the same valid slots,
# and fused poses within this many mm, for every person in float32 (the heatmaps differ by at
# most 2e-5); as served in bf16 one run read a gap of 26.02 mm at Campus (a crop moved by a
# voxel), so there a share of the people is held
PRED_GT_POSE_TOL = 1.0
PRED_GT_SHARE_BF16 = 0.95  # as served, the share of people within it


def render_readings(card, scenes=2):
    """The host renderers on held-out scenes of the Panoptic (5 views,
    128x240x15) and Shelf (5 views, 152x200x17) profiles, augmentation off
    and on, each view from the same RandomState: the native renderer
    (native/render.cpp) against its numpy plain version, and host
    rendering against the device renderer (ops/heatmap_render.py on the
    card) on `render_heatmap_params` of the same draws.  Prints the
    errors and the host ms per sample of both host renderers."""
    import torch

    from faster_voxelpose_tpu_torch.config import profile
    from faster_voxelpose_tpu_torch.datasets.base import _render_joints_numpy
    from faster_voxelpose_tpu_torch.native.build import render_joints_native
    from faster_voxelpose_tpu_torch.ops.heatmap_render import render_heatmaps_device
    from faster_voxelpose_tpu_torch.tools.validate import held_out_dataset

    for name in ("panoptic_synthetic", "shelf_synthetic_ref"):
        cfg = profile(name)
        ds = held_out_dataset(cfg, scenes)
        W, H = (int(v) for v in ds.heatmap_size)
        for aug in (False, True):
            ds.data_augmentation = aug
            e_plain = e_dev = 0.0
            t_native = t_plain = 0.0
            peak = 0.0
            for rec in ds.records:
                native, params = [], []
                for j2d, vis in ds._gt_joints_2d(rec):
                    state = ds._rng.get_state()
                    inst = ds.heatmap_instances(j2d, vis)
                    t0 = time.perf_counter()
                    native.append(render_joints_native(*inst))
                    t1 = time.perf_counter()
                    plain = _render_joints_numpy(*inst)
                    t2 = time.perf_counter()
                    t_native, t_plain = t_native + t1 - t0, t_plain + t2 - t1
                    e_plain = max(e_plain, float(np.abs(plain - native[-1]).max()))
                    ds._rng.set_state(state)
                    params.append(ds.render_heatmap_params(j2d, vis))
                dev = render_heatmaps_device(torch.as_tensor(np.stack(params)).to(CARD), H, W)
                native = np.stack(native)
                e_dev = max(e_dev, float(np.abs(dev.cpu().numpy() - native).max()))
                peak = max(peak, float(native.max()))
            n = len(ds.records)
            print(f"datasets: renderers at {name} {tuple(native.shape)}, augmentation {aug}, "
                  f"{n} scenes: native against numpy max abs {e_plain:.3g} (limit "
                  f"{NATIVE_NUMPY_TOL}), host against the device renderer {e_dev:.3g} (limit "
                  f"{HOST_DEVICE_RENDER_TOL}); host ms per sample: native {t_native / n * 1e3:.3f}, "
                  f"numpy {t_plain / n * 1e3:.3f} | {card}")
            if not (e_plain <= NATIVE_NUMPY_TOL and e_dev <= HOST_DEVICE_RENDER_TOL and peak > 0.3):
                raise AssertionError(f"datasets: renderers at {name}, augmentation {aug}: "
                                     f"{e_plain}, {e_dev}, peak {peak}")


def host_render_accuracy(card, scenes=256, workers=8):
    """Two snapshots scored on their first `scenes` held-out scenes twice
    in this run, augmentation off: heatmaps rendered on the card from
    'hm_params' (samples in the prefetch thread), and rendered on the host
    by `workers` spawn processes (`tools.validate.HeldOutFactory` through
    the loader), both through the compiled validator.  The host reading
    must lie within HOST_AP50_TOL and HOST_MPJPE_TOL of the device one."""
    from faster_voxelpose_tpu_torch.tools import validate

    for name in ("panoptic_synthetic", "shelf_synthetic_ref"):
        ckpt = ROOT / "checkpoints" / name
        dev = validate.evaluate_snapshot(ckpt, scenes, CARD, augmentation=False)
        host = validate.evaluate_snapshot(ckpt, scenes, CARD, workers=workers, device_render=False,
                                          augmentation=False)
        got, want = (validate.metric_table(r["message"]) for r in (host, dev))
        rec = validate.metric_table(dev["record"]["message"])
        keys = ("ap@25", "ap@50", "ap@100", "mpjpe@500mm")
        table = "; ".join(f"{k} host {got[k]:.4f} device {want[k]:.4f} record {rec[k]:.4f}"
                          for k in keys)
        print(f"datasets: {name} on {scenes} held-out scenes, augmentation off, host rendering "
              f"in {workers} spawn workers against device rendering: {table}; people detected "
              f"{host['detected']} / {dev['detected']} of {dev['people']}; frames/s host "
              f"{host['frames_per_s']:.3f}, device {dev['frames_per_s']:.3f} | {card}")
        if not (abs(got["ap@50"] - want["ap@50"]) <= HOST_AP50_TOL
                and abs(got["mpjpe@500mm"] - want["mpjpe@500mm"]) <= HOST_MPJPE_TOL):
            raise AssertionError(f"datasets: {name} host-rendered reading {got} outside the "
                                 f"limits of the device-rendered {want}")


def write_pred_fixture(root, ds, dataset_cls, remap):
    """Shelf/Campus-format files under `root` from the held-out scenes of
    `ds` (the profile's own rig and poses): the rig as the flat
    calibration JSON, the GT COCO-17 poses through `remap` as actorsGT.mat
    (actor a = the scene's person a, metres; one frame slot of the
    dataset's FRAME_RANGE per scene), and the GT projected into each view
    with a score column of 1 as the prediction pickle.  Returns the frame
    slots written."""
    import pickle

    import scipy.io as scio

    from faster_voxelpose_tpu_torch.geometry.cameras import project_points_np

    cams = ds.cameras["synthetic"]
    (root / dataset_cls.CALIB_FILE).write_text(json.dumps(
        {str(k): {kk: np.asarray(vv).tolist() for kk, vv in v.items()} for k, v in cams.items()}))
    rig = ds.packed_rig("synthetic")
    frames = dataset_cls.FRAME_RANGE[:len(ds.records)]
    actors_n = max(len(r.joints_3d) for r in ds.records)
    actors = np.empty((actors_n, 1), dtype=object)
    for a in range(actors_n):
        per_frame = np.empty((max(frames) + 1, 1), dtype=object)
        for fi in range(max(frames) + 1):
            per_frame[fi, 0] = np.zeros((1, 0))
        actors[a, 0] = per_frame
    preds = {}
    for fi, rec in zip(frames, ds.records):
        for a, pose in enumerate(rec.joints_3d):
            actors[a, 0][fi, 0] = remap(np.asarray(pose)) / 1000.0
        for v in range(rig.shape[0]):
            preds[f"{v}_{fi}"] = [
                {"pred": np.concatenate([project_points_np(pose, rig[v]), np.ones((len(pose), 1))],
                                        1)} for pose in rec.joints_3d]
    scio.savemat(str(root / "actorsGT.mat"), {"actor3D": actors})
    with open(root / dataset_cls.PRED_FILE, "wb") as f:
        pickle.dump(preds, f)
    return frames


def pred_readings(card, scenes=128):
    """The 'pred' source at the Shelf and Campus profiles: Shelf- and
    Campus-format fixtures written from `scenes` held-out scenes of
    shelf_synthetic_ref and campus_synthetic_ref (`write_pred_fixture`),
    read by ShelfDataset / CampusDataset and scored with the committed
    weights through the compiled validator (PCP3D table, frames/s); the
    same scenes through the 'gt' device path.  On the frames where every
    joint lands inside every view the two paths' heatmaps differ by at
    most 2e-5 (host against device rendering), and they must give the
    same valid slots; in float32 (TF32 off) every person's fused pose
    within PRED_GT_POSE_TOL mm, and as served (bf16 conv stacks) at least
    PRED_GT_SHARE_BF16 of them (a bf16 rounding flipped by the heatmaps'
    last bits can move a proposal's crop by a voxel, 31 mm).
    Augmentation off."""
    import copy
    import tempfile

    from faster_voxelpose_tpu_torch.config import profile
    from faster_voxelpose_tpu_torch.datasets import get_dataset
    from faster_voxelpose_tpu_torch.datasets.evaluate import coco_to_campus_pose, coco_to_shelf_pose
    from faster_voxelpose_tpu_torch.engine.checkpoint import load_best_npz
    from faster_voxelpose_tpu_torch.engine.validator import run_validation
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.tools.validate import held_out_dataset

    for snap, name, remap in (("shelf_synthetic_ref", "shelf", coco_to_shelf_pose),
                              ("campus_synthetic_ref", "campus", coco_to_campus_pose)):
        cfg = profile(snap)
        cfg.SYNTHETIC.DATA_AUGMENTATION = cfg.DATASET.DATA_AUGMENTATION = False
        gt_ds = held_out_dataset(copy.deepcopy(cfg), scenes)
        cls = get_dataset(name)
        inside = np.array([all(bool(np.all(v)) for _, vs in gt_ds._gt_joints_2d(rec) for v in vs)
                           for rec in gt_ds.records])
        with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{name}_") as tmp:
            root = pathlib.Path(tmp)
            frames = write_pred_fixture(root, gt_ds, cls, remap)
            for dtype in ("bfloat16", "float32"):
                mcfg = copy.deepcopy(cfg)
                mcfg.NETWORK.COMPUTE_DTYPE = dtype
                model = load_best_npz(str(ROOT / "checkpoints" / snap / "model_best.npz"),
                                      build_model(mcfg))
                pcfg = copy.deepcopy(mcfg)
                d = pcfg.DATASET
                d.DATADIR, d.TEST_DATASET, d.TEST_HEATMAP_SRC = str(root), name, "pred"
                pred_ds = cls(pcfg, is_train=False)
                if pred_ds.used_frames != frames:
                    raise AssertionError(f"datasets: {name} used frames "
                                         f"{pred_ds.used_frames[:5]}... of {len(pred_ds)}, "
                                         f"wrote {len(frames)}")
                t0 = time.perf_counter()
                metric, msg, pred = run_validation(pcfg, model, pred_ds, device=CARD)
                fps = len(pred_ds) / (time.perf_counter() - t0)
                _, _, gt = run_validation(mcfg, model, gt_ds, device=CARD)
                valid_p, valid_g = pred[..., 0, 3] >= 0, gt[..., 0, 3] >= 0
                same_slots = bool((valid_p[inside] == valid_g[inside]).all())
                both = valid_p & valid_g & inside[:, None]
                gaps = np.abs(pred[both][..., :3] - gt[both][..., :3]).max(axis=(-1, -2))
                share = float((gaps <= PRED_GT_POSE_TOL).mean()) if len(gaps) else 0.0
                need = 1.0 if dtype == "float32" else PRED_GT_SHARE_BF16
                over = np.sort(gaps[gaps > PRED_GT_POSE_TOL])[::-1]
                print(f"datasets: {name} 'pred' source from {len(frames)} held-out scenes of "
                      f"{snap} (GT projected into {cfg.DATASET.CAMERA_NUM} views, rendered on "
                      f"the host), the committed weights in {dtype} through the compiled "
                      f"validator: {fps:.3f} frames/s (host rendering in the prefetch thread "
                      f"included); against the 'gt' device path on the {int(inside.sum())} frames "
                      f"with every joint inside every view: valid slots "
                      f"{'equal' if same_slots else 'DIFFER'}, {len(gaps)} people, fused poses "
                      f"max abs per person: median {np.median(gaps) if len(gaps) else 0:.4g} mm, "
                      f"{share:.4f} within {PRED_GT_POSE_TOL} mm (limit {need}), over it "
                      f"{[round(float(g), 3) for g in over[:8]]} | {card}\n{msg}")
                if not (np.isfinite(pred).all() and inside.sum() > 0 and same_slots
                        and share >= need and metric > 0.5):
                    raise AssertionError(f"datasets: {name} 'pred' path in {dtype}: metric "
                                         f"{metric}, slots equal {same_slots}, share {share}")


PANOPTIC_CAMS = [(0, 3), (0, 6), (0, 12), (0, 13), (0, 23)]
AXIS_SWAP = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])


def write_panoptic_sequence(root, seq, cams, scenes, interval, size=(1920, 1080)):
    """A Panoptic sequence in the raw format under root/seq: `cams` (flat
    calibration, one per HD camera) converted back to Panoptic axes and
    cm, one joints19 body file per frame index (cm, confidence 1, the
    scene's 15 joints and 4 more) of which only every `interval`-th is
    read and written out (the others stay empty), and a 1920x1080 JPEG per
    camera written once by cv2 and hard-linked into every frame read."""
    import os

    import cv2

    seq_dir = root / seq
    anno = seq_dir / "hdPose3d_stage1_coco19"
    anno.mkdir(parents=True)
    raw_cams = []
    for (panel, node), c in zip(PANOPTIC_CAMS, cams):
        K = np.array([[c["fx"], 0, c["cx"]], [0, c["fy"], c["cy"]], [0, 0, 1.0]], dtype=float)
        R = np.asarray(c["R"], float)
        dist = np.zeros(5)
        dist[[0, 1, 4]] = np.asarray(c["k"]).ravel()
        dist[[2, 3]] = np.asarray(c["p"]).ravel()
        raw_cams.append({"panel": panel, "node": node, "K": K.tolist(), "distCoef": dist.tolist(),
                         "R": (R @ np.linalg.inv(AXIS_SWAP)).tolist(),
                         "t": (-(R @ np.asarray(c["T"], float).reshape(3, 1)) / 10.0).tolist()})
    (seq_dir / f"calibration_{seq}.json").write_text(json.dumps({"cameras": raw_cams}))
    W, H = size
    ys, xs = np.mgrid[0:H, 0:W]
    first = []
    for v, (panel, node) in enumerate(PANOPTIC_CAMS):
        prefix = f"{panel:02d}_{node:02d}"
        (seq_dir / "hdImgs" / prefix).mkdir(parents=True)
        img = np.stack([(xs * (v + 1)) % 256, (ys * 2 + 40 * v) % 256, ((xs + ys) // 4) % 256],
                       -1).astype(np.uint8)
        first.append(seq_dir / "hdImgs" / prefix / f"{prefix}.jpg")
        cv2.imwrite(str(first[-1]), img)
    for i in range(len(scenes) * interval):
        path = anno / f"body3DScene_{i:08d}.json"
        if i % interval:
            path.write_text("")
            continue
        joints = scenes[i // interval].joints_3d
        bodies = []
        for pose in joints:
            j19 = np.zeros((19, 4))
            j19[:15, :3] = (np.asarray(pose) / 10.0) @ np.linalg.inv(AXIS_SWAP)
            j19[:15, 3] = 1.0
            bodies.append({"joints19": j19.ravel().tolist()})
        path.write_text(json.dumps({"bodies": bodies}))
        for (panel, node), src in zip(PANOPTIC_CAMS, first):
            prefix = f"{panel:02d}_{node:02d}"
            os.link(src, seq_dir / "hdImgs" / prefix / f"{prefix}_{i:08d}.jpg")


def image_readings(card, workers=0, val_batches=8, train_steps=6):
    """The 'image' source at the configs/panoptic/jln64.yaml profile
    (PanopticDataset, 5 views of 1920x1080 JPEGs decoded and warped to
    960x512 on the host, uint8 to the card): a validation and a training
    sequence written here (`write_panoptic_sequence`, the people of
    held-out scenes of the Panoptic profile on its rig); host ms per
    sample for decode + warp; one validation through the graphed image
    step, samples made by the loader (in `workers` spawn processes, or
    the prefetch thread: the pool's start, about 10 s, would dominate
    here) with a seeded random model and ResNet-50 backbone, as the images
    phase; `train_steps` steps of the compiled Trainer on loader-made
    'images' batches.  Returns the kernels' launches."""
    import tempfile

    import torch

    from faster_voxelpose_tpu_torch.config import load_config, profile
    from faster_voxelpose_tpu_torch.datasets import panoptic
    from faster_voxelpose_tpu_torch.datasets.demo_data import demo_rig
    from faster_voxelpose_tpu_torch.datasets.images import load_view_images_u8
    from faster_voxelpose_tpu_torch.engine.loader import (DataLoader, DatasetFactory,
                                                          prefetch_to_device)
    from faster_voxelpose_tpu_torch.engine.trainer import Trainer
    from faster_voxelpose_tpu_torch.engine.validator import run_validation
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.models.resnet import build_backbone
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk
    from faster_voxelpose_tpu_torch.tools.validate import held_out_dataset

    cfg = load_config(ROOT / "configs" / "panoptic" / "jln64.yaml")
    cfg.NETWORK.PRETRAINED_BACKBONE = ""
    cfg.WORKERS = workers
    B, TB = cfg.TRAIN.BATCH_SIZE, cfg.TEST.BATCH_SIZE
    src = profile("panoptic_synthetic")  # the same room: its rig and people
    rig = demo_rig(src)
    scenes = held_out_dataset(src, max(val_batches * TB, train_steps * B)).records
    sk.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_panoptic_") as tmp:
        root = pathlib.Path(tmp)
        cfg.DATASET.DATADIR = str(root)
        cams = [rig[k] for k in sorted(rig)]
        write_panoptic_sequence(root, panoptic.VAL_SEQUENCES[0], cams, scenes[:val_batches * TB], 12)
        write_panoptic_sequence(root, panoptic.TRAIN_SEQUENCES[0], cams, scenes[:train_steps * B], 3)
        val_ds = panoptic.PanopticDataset(cfg, is_train=False)
        train_ds = panoptic.PanopticDataset(cfg, is_train=True)
        if len(val_ds) != val_batches * TB or len(train_ds) != train_steps * B:
            raise AssertionError(f"images source: {len(val_ds)} and {len(train_ds)} records")
        t0 = time.perf_counter()
        frames = [load_view_images_u8(r.image_paths, cfg.DATASET.IMAGE_SIZE,
                                      val_ds.resize_transform) for r in val_ds.records[:8]]
        decode_ms = (time.perf_counter() - t0) / len(frames) * 1e3
        sample = val_ds[0]
        torch.manual_seed(0)
        model, backbone = build_model(cfg).to(CARD), build_backbone(cfg).to(CARD).eval()
        t0 = time.perf_counter()
        metric, msg, preds = run_validation(
            cfg, model, val_ds, device=CARD, backbone=backbone, num_workers=workers,
            dataset_factory=DatasetFactory("panoptic", cfg, False) if workers else None)
        val_s = time.perf_counter() - t0
        tr = Trainer(cfg, model, backbone=backbone)
        loader = DataLoader(train_ds, B, shuffle=True, drop_last=True, num_workers=workers,
                            seed=0,
                            dataset_factory=DatasetFactory("panoptic", cfg, True) if workers else None)
        losses, steps, t0 = None, 0, time.perf_counter()
        try:
            for batch in prefetch_to_device(iter(loader), device=CARD):
                losses = {k: float(v) for k, v in tr.step(batch).items()}
                steps += 1
        finally:
            loader.close()
        train_s = time.perf_counter() - t0
    launches = sk.launch_counts()
    print(f"datasets: 'image' source at configs/panoptic/jln64.yaml ({cfg.DATASET.CAMERA_NUM} "
          f"views of 1920x1080 JPEGs -> {tuple(sample['images'].shape)} {sample['images'].dtype}): "
          f"host ms per sample for decode + warp {decode_ms:.2f}; validation of {len(val_ds)} "
          f"frames at batch {TB} through the graphed image step (WORKERS {workers}, random "
          f"model and ResNet-{cfg.RESNET.NUM_LAYERS}) {len(val_ds) / val_s:.3f} frames/s, metric "
          f"{metric:.4f}; {steps} compiled train steps of batch {B} on loader-made 'images' "
          f"batches in {train_s:.2f} s (captured: {tr._graph.captured is not None}), last losses "
          f"{losses}; launches {launches} | {card}")
    if not (np.isfinite(preds).all() and preds.shape[0] == len(val_ds) and steps == train_steps
            and tr._graph.captured is not None and all(np.isfinite(list(losses.values())))):
        raise AssertionError(f"datasets: 'image' source: preds {preds.shape}, steps {steps}, "
                             f"losses {losses}")
    return launches


def _batch_bytes(batch):
    return sum(v.nbytes for k, v in batch.items() if not k.startswith("_"))


def loader_readings(cfg, label, workers, card, steps=8):
    """A compiled trainer at `cfg` fed by the loader (host rendering where
    DEVICE_RENDER is false), seeded random weights: CAPTURE_WARMUP + 1
    steps to capture, then `steps` with the data in series (make, upload,
    step, synchronise) and `steps` through prefetch_to_device.  Prints
    host ms per batch, samples/s both ways, the step's device ms (copy in
    and one replay, CUDA events) and the upload bytes per step."""
    import copy

    import torch

    from faster_voxelpose_tpu_torch.datasets import SyntheticDataset
    from faster_voxelpose_tpu_torch.engine.graphs import CAPTURE_WARMUP
    from faster_voxelpose_tpu_torch.engine.loader import (DataLoader, DatasetFactory,
                                                          prefetch_to_device)
    from faster_voxelpose_tpu_torch.engine.trainer import Trainer, batch_to_device
    from faster_voxelpose_tpu_torch.models import build_model

    cfg = copy.deepcopy(cfg)
    B = cfg.TRAIN.BATCH_SIZE
    cfg.SYNTHETIC.NUM_DATA = B * (CAPTURE_WARMUP + 1 + 2 * steps)
    loader = DataLoader(SyntheticDataset(cfg, is_train=True), B, shuffle=True, drop_last=True,
                        num_workers=workers, seed=cfg.TRAIN.SEED,
                        dataset_factory=DatasetFactory("synthetic", cfg, True) if workers else None)
    try:
        batches = iter(loader)
        torch.manual_seed(1)
        tr = Trainer(cfg, build_model(cfg).to(CARD))
        for _ in range(CAPTURE_WARMUP + 1):
            tr.step(batch_to_device(next(batches), CARD))
        torch.cuda.synchronize()
        data_ms, device_ms, nbytes = [], [], 0
        t_start = time.perf_counter()
        for _ in range(steps):
            t0 = time.perf_counter()
            batch = next(batches)
            data_ms.append((time.perf_counter() - t0) * 1e3)
            nbytes = _batch_bytes(batch)
            batch = batch_to_device(batch, CARD)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            losses = tr.step(batch)
            b.record()
            b.synchronize()
            device_ms.append(a.elapsed_time(b))
        series = steps * B / (time.perf_counter() - t_start)
        t_start, fed = time.perf_counter(), 0
        for batch in prefetch_to_device(batches, device=CARD):
            losses = tr.step(batch)
            fed += 1
        torch.cuda.synchronize()
        prefetched = fed * B / (time.perf_counter() - t_start)
    finally:
        loader.close()
    if fed != steps or not all(torch.isfinite(v) for v in losses.values()):
        raise AssertionError(f"datasets: {label}: {fed} prefetched steps, losses {losses}")
    print(f"datasets: train at configs/demo/synthetic.yaml, {label}, WORKERS {workers}: host ms "
          f"per batch median {np.median(data_ms):.3f}, samples/s in series {series:.3f}, "
          f"prefetched {prefetched:.3f}; compiled step device ms median {np.median(device_ms):.4f}; "
          f"upload {nbytes / 1e6:.3f} MB per step of {B} | {card}")
    return dict(data_ms=float(np.median(data_ms)), series=series, prefetched=prefetched)


def host_cost_readings(card, workers=8, num_data=32):
    """The host's cost of host rendering at configs/demo/synthetic.yaml
    (5 views, 152x200x15, batch 4) on data that tools/make_demo_data.py
    writes into a temporary directory: the loader-fed compiled trainer
    (`loader_readings`) with device rendering, with host rendering in the
    prefetch thread (WORKERS 0) and in `workers` spawn processes; then
    tools/train.py on the config in subprocesses, one epoch on `num_data`
    scenes, once as committed (WORKERS 0) and once with WORKERS
    `workers`.  Returns the launches of the two training processes."""
    import re
    import tempfile

    from faster_voxelpose_tpu_torch.config import load_config
    from faster_voxelpose_tpu_torch.tools import make_demo_data

    yaml_path = ROOT / "configs" / "demo" / "synthetic.yaml"
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_host_") as tmp:
        tmp = pathlib.Path(tmp)
        make_demo_data.main(["--out", str(tmp / "data" / "Demo")])
        cfg = load_config(yaml_path)
        cfg.DATASET.DATADIR = str(tmp / "data" / "Demo")
        cfg.DATASET.DEVICE_RENDER = True
        loader_readings(cfg, "device rendering", 0, card)
        cfg.DATASET.DEVICE_RENDER = False
        loader_readings(cfg, "host rendering", 0, card)
        loader_readings(cfg, "host rendering", workers, card)
        text = yaml_path.read_text()
        for w in (0, workers):
            cfg_w = tmp / f"synthetic_w{w}.yaml"
            cfg_w.write_text(text.replace("WORKERS: 0", f"WORKERS: {w}"))
            log = _run_tool(["faster_voxelpose_tpu_torch.tools.train", "--cfg", str(cfg_w),
                             "--epochs", "1", "--num-data", str(num_data), "--snapshot-dir",
                             str(tmp / f"snap{w}")], tmp, f"train synthetic.yaml WORKERS {w}")
            speed = re.findall(r"Speed ([0-9.]+) samples/s", log)
            epochs = re.findall(r"epoch (\d+) trained in ([0-9.]+) s", log)
            fps = re.findall(r"validated (\d+) frames in [0-9.]+s \(([0-9.]+) frames/s\)", log)
            print(f"datasets: tools/train.py configs/demo/synthetic.yaml WORKERS {w}, host "
                  f"rendering, {num_data} scenes: epoch (index, wall s) {epochs}, logged samples/s "
                  f"{speed}, validation (frames, frames/s) {fps} | {card}")
            for k, v in json.loads(re.findall(r"kernel launches: (\{.*\})", log)[-1]).items():
                launches[k] = launches.get(k, 0) + v
    return launches


def datasets_phase(card):
    """Every dataset and heatmap source on the card: the renderers
    (`render_readings`), accuracy through host rendering in spawn workers
    (`host_render_accuracy`), the 'pred' source at Shelf and Campus
    (`pred_readings`), the 'image' source at the Panoptic jln64 profile
    (`image_readings`), and the host's cost of host rendering
    (`host_cost_readings`).  Returns the kernels' launches of the phase,
    the training subprocesses' included."""
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk

    sk.reset_launch_counts()
    render_readings(card)
    host_render_accuracy(card)
    pred_readings(card)
    launches = sk.launch_counts()
    for k, v in image_readings(card).items():
        launches[k] = launches.get(k, 0) + v
    sk.reset_launch_counts()
    cli = host_cost_readings(card)
    for counts in (sk.launch_counts(), cli):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    print(f"datasets: launches {launches}")
    for name in ("sample_whole_projected", "sample_crop_planes"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"datasets: {name} was not launched")
    return launches


def failed_capture_phase(cfg, rig, card):
    """Negative control: a forward that reads a value back to the host
    cannot be captured, and the service's capture raises and leaves no
    graph; the service then answers eagerly.  `graphs.capture` puts
    PyTorch's state back after a failed capture (`abandon_capture`): the
    device's generator draws again, and `empty_cache` gives the cached
    memory back (both checked here), so the measured datasets phase runs
    after this one."""
    import gc

    import torch

    from faster_voxelpose_tpu_torch.engine import PoseService

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    with np.load(ROOT / "checkpoints/panoptic_synthetic/model_best.npz") as npz:
        variables = {k: npz[k] for k in npz.files}
    frames = [render_frame(make_people(np.random.RandomState(9), 4, cfg.CAPTURE_SPEC.SPACE_CENTER),
                           rig, cfg, CARD)]
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
    del bad, after, forward
    gc.collect()
    torch.randn(16, device=CARD).sum().item()  # the generator is out of capture mode
    torch.empty(2 ** 28, device=CARD)  # 1 GiB, freed at once
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    print(f"compiled: after the failed capture the device generator draws, and a 1 GiB block "
          f"freed, empty_cache leaves {reserved / 2**30:.3f} GiB reserved ({base / 2**30:.3f} GiB "
          f"before the phase) | {card}")
    if reserved > base + 2 ** 29:  # unrepaired, the freed 1 GiB block stays reserved
        raise AssertionError(f"compiled: {reserved} bytes stay reserved after the failed "
                             f"capture, {base} before it")


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _states_equal(a, b, rtol=2e-4, atol=2e-6):
    """(every tensor within rtol/atol, bit for bit, the largest gap) of two
    state dicts of one model."""
    import torch

    gaps = {k: (a[k].double() - b[k].double()).abs() for k in a}
    within = all(bool((g <= atol + rtol * b[k].double().abs()).all()) for k, g in gaps.items())
    return (within, all(torch.equal(a[k], b[k]) for k in a),
            max(float(g.max()) for g in gaps.values()))


def _eval_batches(cfg, scenes):
    """The held-out scenes' samples in record order (as the validator's
    loader makes them), collated by TEST.BATCH_SIZE, heatmaps rendered on
    the card: [(heatmaps, cameras)]."""
    import torch

    from faster_voxelpose_tpu_torch.datasets import collate
    from faster_voxelpose_tpu_torch.ops.heatmap_render import render_heatmaps_device
    from faster_voxelpose_tpu_torch.tools.validate import held_out_dataset

    ds = held_out_dataset(cfg, scenes)
    W, H = cfg.DATASET.HEATMAP_SIZE
    bs = cfg.TEST.BATCH_SIZE
    out = []
    for i in range(0, scenes, bs):
        b = collate([ds[j] for j in range(i, i + bs)])
        out.append((render_heatmaps_device(torch.as_tensor(b["hm_params"]).to(CARD), H, W),
                    torch.as_tensor(b["cameras"]).to(CARD)))
    return out


def _trajectory(cfg, weights, batch, steps=3):
    """One process's Trainer (eager) on the card from `weights`: the
    losses of `steps` steps and its state (numpy) before each step and
    after the last."""
    from faster_voxelpose_tpu_torch.engine.trainer import Trainer
    from faster_voxelpose_tpu_torch.models import build_model

    model = build_model(cfg)
    model.load_state_dict(weights)
    tr = Trainer(cfg, model.to(CARD), compiled=False)
    states, losses = [_host(tr.state_dict())], []
    for _ in range(steps):
        losses.append([float(v) for v in tr.step(batch).values()])
        states.append(_host(tr.state_dict()))
    return np.array(losses), states


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def _as_tensors(state):
    import torch

    return {k: torch.as_tensor(v) for k, v in state.items()}


def _tensors(tree, device):
    import torch

    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)


def _gloo_rank(rank, world, port, job_path, out_path, device):
    """One rank of the two-rank gloo group on the one card: the DP train
    step (3 free steps, then each step from one process's state before
    it), the DP eval step and the view-sharded forward, on the job's
    inputs; writes its results (and its kernel launches) to out_path."""
    import pickle
    import traceback

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from faster_voxelpose_tpu_torch.device import pin_float32
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk
    from faster_voxelpose_tpu_torch.parallel import (Sharding, make_dp_eval_step,
                                                     make_dp_train_step, make_mesh,
                                                     make_view_sharded_forward, shard_batch)

    if device == "cuda":
        torch.cuda.set_device(0)
    pin_float32()
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    out = {}
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        mesh = make_mesh(world)  # no device named: the card, under gloo too
        if mesh.device != torch.device(device, 0):
            raise AssertionError(f"make_mesh under gloo chose {mesh.device}, not the card")

        def model_of(cfg, weights):
            model = build_model(cfg)
            model.load_state_dict(_tensors(weights, "cpu"))
            return model

        sk.reset_launch_counts()
        tr = make_dp_train_step(job["cfg64"], model_of(job["cfg64"], job["weights64"]), mesh,
                                compiled=False)
        shard = shard_batch(job["batch"], mesh)
        out["losses"] = np.array([[float(v) for v in tr.step(shard).values()] for _ in range(3)])
        out["states"] = []
        for before in job["states"][:-1]:
            tr.load_state_dict(_tensors(before, device))
            tr.step(shard)
            out["states"].append(_host(tr.model.state_dict()))
        eval_step = make_dp_eval_step(job["cfg"], model_of(job["cfg"], job["weights"]), mesh)
        out["eval"] = [eval_step(*shard_batch({"h": h, "c": c}, mesh).values()).cpu().numpy()
                       for h, c in job["eval"]]
        forward = make_view_sharded_forward(job["view_cfg"],
                                            model_of(job["view_cfg"], job["weights"]), mesh)
        views = Sharding(mesh, 1)
        out["view"] = forward(views.shard(job["view_hm"]), views.shard(job["view_cams"])).cpu().numpy()
        out["launches"] = sk.launch_counts()
    except BaseException:
        out["error"] = traceback.format_exc()
    finally:
        dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def entry_phase(card):
    """`tools/dryrun_multichip.py` on the card.  `entry()`'s forward: shape
    (1, 4, 15, 5), finite, rows 1 and 2 launched once each and no other
    kernel; the same `fn` and weights on the CPU (`entry(device='cpu')`,
    the card model's state dict loaded): the same valid slots, proposal
    centres (a second forward on the card) within 1e-3 and fused poses
    within 0.5 mm (the parity phase's bounds).  No slot is valid at the
    entry's MIN_SCORE 0.1, so the poses compared are zeros and scores:
    the parity phase holds row 2 on the card at these shapes with every
    slot valid, and so do the dry run's view and eval checks at MIN_SCORE
    -1e9.  Then `dryrun_multichip(2)`: two gloo ranks on the one card,
    every check at the JAX file's bounds (it raises otherwise), each of
    its lines printed.  Returns the kernel launches of both, the two card
    forwards of `entry()` counted together."""
    import contextlib
    import io

    import torch

    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk
    from faster_voxelpose_tpu_torch.tools.dryrun_multichip import dryrun_multichip, entry

    t0 = time.perf_counter()
    fn, (model, hm, cams) = entry()
    if hm.device.type != "cuda" or next(model.parameters()).device.type != "cuda":
        raise AssertionError(f"entry: entry() put its tensors on {hm.device}, not the card")
    sk.reset_launch_counts()
    out = fn(model, hm, cams)
    torch.cuda.synchronize()
    per_forward = sk.launch_counts()
    with torch.no_grad():  # the proposal centres: a second forward on the card
        pc = model(hm, cams).proposal_centers.cpu()
    launches = sk.launch_counts()  # both card forwards
    fn_cpu, (model_cpu, hm_cpu, cams_cpu) = entry(device="cpu")
    model_cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    ref = fn_cpu(model_cpu, hm_cpu, cams_cpu)
    with torch.no_grad():
        pc_cpu = model_cpu(hm_cpu, cams_cpu).proposal_centers
    got = out.cpu()
    d_prop = float((pc - pc_cpu).abs().max())
    d_pose = float((got - ref)[..., :3].abs().max())
    valid = int((got[..., 0, 3] >= 0).sum())
    expected = {k: int(k in ("sample_whole_projected", "sample_crop_planes")) for k in per_forward}
    twice = {k: 2 * v for k, v in expected.items()}
    print(f"entry: entry() on the card: fused poses {tuple(got.shape)}, finite "
          f"{bool(torch.isfinite(got).all())}, {valid} of {got.shape[1]} slots valid; against "
          f"entry(device='cpu') on the same weights: same valid slots "
          f"{torch.equal(got[..., 3], ref[..., 3])}, proposals {d_prop:.3g}, fused poses "
          f"{d_pose:.3g} mm (no slot valid at MIN_SCORE 0.1: the parity phase holds row 2 on "
          f"the card at these shapes with every slot valid, and the dry run's view and eval "
          f"checks do at MIN_SCORE -1e9); launches in one forward {per_forward} | {card}")
    if not (tuple(got.shape) == (1, 4, 15, 5) and torch.isfinite(got).all()
            and torch.equal(got[..., 3], ref[..., 3]) and d_prop <= 1e-3 and d_pose <= 0.5
            and per_forward == expected and launches == twice):
        raise AssertionError(f"entry: entry() off its CPU path or its launches: proposals "
                             f"{d_prop}, poses {d_pose} mm, launches {per_forward}, "
                             f"{launches} in two forwards")
    t1 = time.perf_counter()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        readings = dryrun_multichip(2)
    lines = text.getvalue().splitlines()
    for line in lines:
        print(f"entry: {line}")
    heads = ("dryrun_multichip(2) ok:", "dryrun_multichip train readings",
             "dryrun_multichip view-shard ok: 1-way", "dryrun_multichip dp-eval ok: 2-way",
             "dryrun_multichip pipeline ok:")
    if [h for h in heads if not any(line.startswith(h) for line in lines)] \
            or readings["devices"] != ["cuda:0", "cuda:0"]:
        raise AssertionError(f"entry: dryrun_multichip(2) printed {lines}, ranks on "
                             f"{readings['devices']}")
    for k, v in readings["launches"].items():
        launches[k] += v
    print(f"entry: dryrun_multichip(2), two gloo ranks on the one card: train params "
          f"{readings['train_max_dev']:.3g} (< 1e-4), view {readings['view_max_dev']:.3g} "
          f"(every slot valid {readings['view_all_valid_max_dev']:.3g}), eval "
          f"{readings['eval_max_dev']:.3g} (every slot valid "
          f"{readings['eval_all_valid_max_dev']:.3g}), pipeline {readings['pipeline_max_dev']:.3g} mm "
          f"(< 1e-2); {time.perf_counter() - t1:.1f} s; the phase "
          f"{time.perf_counter() - t0:.1f} s; launches {launches} | {card}")
    return launches


def scale_out_phase(card, steps=5):
    """`parallel/mesh.py` on the one card.  (1) One rank over NCCL: the
    compiled DP train step (its collectives captured into the trainer's
    CUDA graph) against the compiled single-process Trainer, `steps`
    steps of one batch of 4 synthetic scenes at the Panoptic profile in
    float32 from one seeded model: the losses of the free steps, the state
    after them (rtol 2e-4, atol 1e-5), and every parameter and BatchNorm
    statistic after each step replayed from the Trainer's state before it
    (bit for bit on the eager steps, rtol 2e-4 and atol 1e-5 on all);
    beside them, as the witness of what two runs
    of one graph give, a second compiled Trainer from the same seed
    against the first; the DP eval step against run_validation's
    poses on 8 held-out scenes with the committed weights.  (2) Two ranks
    over gloo on the card in spawned subprocesses (compiled=False), which
    start before (1) and run beside it: DP
    train in float64 conv stacks (as the CPU tests: float32 rounding of
    gradients that are zero in exact arithmetic makes Adam's sign-like
    steps part free trajectories), the losses of 3 free steps and every
    parameter after each step taken from one process's state; DP eval;
    the view-sharded forward at V = 4 over 2 ranks.  (3) PipelinedStream
    on two CUDA streams: 24 frames of 5 uint8 960x512 images, committed
    weights and a seeded ResNet-50 in float32, against the serial path
    per frame with the one-frame lag; frames/s of both.  Tolerances are
    the CPU tests' (tests/test_torch_parallel.py).  Returns the kernel
    launches of the DP steps, the ranks and the stream."""
    import copy
    import multiprocessing as mp
    import pickle
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from faster_voxelpose_tpu_torch.config import panoptic_synthetic_profile
    from faster_voxelpose_tpu_torch.engine.checkpoint import load_best_npz
    from faster_voxelpose_tpu_torch.engine.graphs import CAPTURE_WARMUP
    from faster_voxelpose_tpu_torch.engine.trainer import Trainer
    from faster_voxelpose_tpu_torch.engine.validator import run_validation
    from faster_voxelpose_tpu_torch.geometry import dome_rig
    from faster_voxelpose_tpu_torch.models import build_model
    from faster_voxelpose_tpu_torch.models.resnet import build_backbone, images_to_heatmaps
    from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk
    from faster_voxelpose_tpu_torch.parallel import (PipelinedStream, make_dp_eval_step,
                                                     make_dp_train_step, make_mesh, shard_batch)
    from faster_voxelpose_tpu_torch.tools.validate import held_out_dataset

    launches = {}

    def count(fn):
        sk.reset_launch_counts()
        result = fn()
        for k, v in sk.launch_counts().items():
            launches[k] = launches.get(k, 0) + v
        return result

    snapshot = str(ROOT / "checkpoints" / "panoptic_synthetic" / "model_best.npz")
    cfg = panoptic_synthetic_profile()
    cfg.NETWORK.COMPUTE_DTYPE = "float32"
    batch = next(iter(synthetic_loader(copy.deepcopy(cfg), 1)))

    # the gloo ranks' job: inputs and one process's references
    committed = load_best_npz(snapshot, build_model(cfg)).state_dict()
    cfg64 = copy.deepcopy(cfg)
    cfg64.NETWORK.COMPUTE_DTYPE = "float64"
    torch.manual_seed(0)
    weights64 = build_model(cfg64).state_dict()
    losses64, states64 = _trajectory(cfg64, weights64, {k: torch.as_tensor(v).to(CARD)
                                                      for k, v in batch.items()
                                                      if not k.startswith("_")})
    model = build_model(cfg)
    model.load_state_dict(committed)
    model.to(CARD)
    evals = _eval_batches(copy.deepcopy(cfg), 8)
    with torch.no_grad():
        one_eval = np.concatenate([model(h, c).fused_poses.cpu().numpy() for h, c in evals])
    vcfg = copy.deepcopy(cfg)
    vcfg.DATASET.CAMERA_NUM = 4
    view_cams = dome_rig(2, 4, space_center=cfg.CAPTURE_SPEC.SPACE_CENTER)
    W, H = cfg.DATASET.HEATMAP_SIZE
    view_hm = torch.rand((2, 4, H, W, cfg.DATASET.NUM_JOINTS),
                         generator=torch.Generator().manual_seed(5)).numpy()
    vmodel = build_model(vcfg)
    vmodel.load_state_dict(committed)
    with torch.no_grad():
        one_view = vmodel.to(CARD)(torch.as_tensor(view_hm).to(CARD),
                                   torch.as_tensor(view_cams).to(CARD)).fused_poses.cpu().numpy()
    del model, vmodel
    job = {"cfg": cfg, "cfg64": cfg64, "weights": _host(committed), "weights64": _host(weights64),
           "batch": {k: v for k, v in batch.items() if not k.startswith("_")}, "states": states64,
           "eval": [(h.cpu().numpy(), c.cpu().numpy()) for h, c in evals], "view_cfg": vcfg,
           "view_hm": view_hm, "view_cams": view_cams}
    # (2) two ranks over gloo on the one card, spawned first: they run
    # beside (1), whose times no check reads
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_gloo_"))
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank, args=(r, 2, port, str(tmp / "job.pkl"),
                                                    str(tmp / f"rank{r}.pkl"), CARD))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        # (1) one rank over NCCL
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", world_size=1,
                                rank=0)
        try:
            mesh = make_mesh(1)
            torch.manual_seed(0)
            single = Trainer(cfg, build_model(cfg).to(CARD))
            states, losses = [_host(single.state_dict())], []
            for _ in range(steps):
                losses.append([float(v) for v in single.step(batch).values()])
                states.append(_host(single.state_dict()))
            g1 = single._graph.captured if single.compiled else None
            del single
            # the witness: a second compiled Trainer from the same seed, free and
            # then each step from the first's state, holds two runs of one graph
            # against each other
            torch.manual_seed(0)
            twin = Trainer(cfg, build_model(cfg).to(CARD))
            for _ in range(steps):
                twin.step(batch)
            twin_free = _states_equal(*(_as_tensors(t) for t in (_host(twin.model.state_dict()),
                                                                 states[-1]["model"])),
                                      atol=1e-5)
            twin_step = []
            for before, after in zip(states[:-1], states[1:]):
                twin.load_state_dict(_tensors(before, CARD))
                twin.step(batch)
                twin_step.append(_states_equal(_as_tensors(_host(twin.model.state_dict())),
                                               _as_tensors(after["model"])))
            del twin
            torch.manual_seed(0)
            model = build_model(cfg).to(CARD)
            dp, feed = make_dp_train_step(cfg, model, mesh), shard_batch(batch, mesh)
            free = count(lambda: [[float(v) for v in dp.step(feed).values()] for _ in range(steps)])
            free_state = _host(model.state_dict())
            # then each step replayed from the one process's state before it, so
            # that no step inherits a gap of the ones before: the eager steps
            # bit for bit, every step within rtol 2e-4 and atol 1e-5 (two
            # compiled Trainers from one state, the witness above, part by up
            # to 2.42e-6 on a replay, over an atol of 2e-6)
            per_step = []
            for before, after in zip(states[:-1], states[1:]):
                dp.load_state_dict(_tensors(before, CARD))
                count(lambda: dp.step(feed))
                per_step.append(_states_equal(_as_tensors(_host(model.state_dict())),
                                              _as_tensors(after["model"]), atol=1e-5))
            eager_exact = all(b for _, b, _ in per_step[:CAPTURE_WARMUP])
            g2 = dp._graph.captured if dp.compiled else None
            del dp, model
            d_loss = float(np.max(np.abs(np.array(free) - losses) / np.maximum(np.abs(losses), 1e-12)))
            # after the free steps: within rtol 2e-4 and atol 1e-5, above the
            # 5.36e-6 that two compiled Trainers read (a DP step that drifts
            # still fails)
            free_ok, _, free_gap = _states_equal(_as_tensors(free_state),
                                                 _as_tensors(states[-1]["model"]), atol=1e-5)
            print(f"scale-out: NCCL, 1 rank: compiled DP train step against the compiled Trainer, "
                  f"{steps} steps of batch 4 at the Panoptic profile in float32 (captured after 3): "
                  f"losses {d_loss:.3g} relative, state after {steps} free steps largest gap "
                  f"{free_gap:.3g} (within rtol 2e-4 atol 1e-5: {free_ok}); each step from the "
                  f"Trainer's state: within rtol 2e-4 atol 1e-5 {[w for w, _, _ in per_step]}, bit "
                  f"for bit {[b for _, b, _ in per_step]}, largest gap "
                  f"{max(g for _, _, g in per_step):.3g}; DP graph's launches per replay "
                  f"{g2.launches if g2 else None} | {card}")
            print(f"scale-out: witness, a second compiled Trainer from the same seed against the "
                  f"first: state after {steps} free steps largest gap {twin_free[2]:.3g} (bit "
                  f"for bit {twin_free[1]}, within rtol 2e-4 atol 1e-5 {twin_free[0]}); each "
                  f"step from the first's state: within rtol 2e-4 atol 2e-6 "
                  f"{[w for w, _, _ in twin_step]}, bit for bit {[b for _, b, _ in twin_step]}, "
                  f"largest gap {max(g for _, _, g in twin_step):.3g} | {card}")
            if not ((g1 is not None and g2 is not None or CARD != "cuda") and d_loss <= 1e-5
                    and free_ok and eager_exact and all(w for w, _, _ in per_step)):
                raise AssertionError(f"scale-out: NCCL DP step off the Trainer: losses {d_loss}, "
                                     f"free steps {free_gap}, per step {per_step}, captured "
                                     f"{g1 is not None}, {g2 is not None}")
            model = load_best_npz(snapshot, build_model(cfg)).to(CARD)
            _, _, preds = run_validation(cfg, model, held_out_dataset(copy.deepcopy(cfg), 8),
                                         device=CARD)
            eval_step = make_dp_eval_step(cfg, model, mesh)
            dp = count(lambda: np.concatenate([eval_step(h, c).cpu().numpy()
                                                for h, c in _eval_batches(copy.deepcopy(cfg), 8)]))
            gap = float(np.abs(dp - preds).max())
            print(f"scale-out: NCCL, 1 rank: DP eval step against run_validation on 8 held-out "
                  f"scenes, committed weights: largest gap {gap:.3g}")
            if dp.shape != preds.shape or not np.allclose(dp, preds, rtol=1e-4, atol=1e-3):
                raise AssertionError(f"scale-out: DP eval off run_validation by {gap}")
        finally:
            dist.destroy_process_group()

    finally:
        for p in procs:
            p.join(300)
        alive = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    try:
        if alive or any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"scale-out: gloo ranks alive after 300 s {alive}, exit codes "
                                 f"{[p.exitcode for p in procs]}")
        ranks = []
        for r in range(2):
            with open(tmp / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    errors = [r["error"] for r in ranks if "error" in r]
    if errors:
        raise AssertionError("scale-out: a gloo rank failed (gloo refused a CUDA collective, or "
                             "the step did not run):\n" + "\n".join(errors))
    d_loss = max(float(np.max(np.abs(r["losses"] - losses64) / np.maximum(np.abs(losses64), 1e-12)))
                 for r in ranks)
    gaps, ok = [], True
    for step, (got0, got1) in enumerate(zip(ranks[0]["states"], ranks[1]["states"]), 1):
        want = states64[step]["model"]
        for k, v in want.items():
            ok &= bool(np.array_equal(got0[k], got1[k])
                       and np.allclose(got0[k], v, rtol=2e-4, atol=2e-6))
            gaps.append((float(np.abs(got0[k] - v).max()), step, k))
    d_eval = max(float(np.abs(np.concatenate(r["eval"]) - one_eval).max()) for r in ranks)
    d_view = max(float(np.abs(r["view"] - one_view).max()) for r in ranks)
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    print(f"scale-out: gloo, 2 ranks on the one card beside the NCCL rank, "
          f"{time.perf_counter() - t0:.1f} s from spawn to join: DP train "
          f"(float64 conv stacks, batch 4) losses of 3 free steps {d_loss:.3g} relative, every "
          f"parameter after each step from one process's state within rtol 2e-4 atol 2e-6: "
          f"{ok} (largest gap {max(gaps)[0]:.3g}, {max(gaps)[2]} after step {max(gaps)[1]}); DP eval on 8 scenes largest gap {d_eval:.3g}; "
          f"view-sharded forward (V = 4 over 2 ranks) largest gap {d_view:.3g} | {card}")
    if not (d_loss <= 1e-5 and ok
            and all(np.allclose(np.concatenate(r["eval"]), one_eval, rtol=1e-4, atol=1e-3)
                    and np.allclose(r["view"], one_view, rtol=1e-4, atol=1e-3) for r in ranks)):
        raise AssertionError(f"scale-out: gloo ranks off one process: losses {d_loss}, "
                             f"states {ok}, eval {d_eval}, view {d_view}")

    # (3) PipelinedStream on two CUDA streams
    model = load_best_npz(snapshot, build_model(cfg)).to(CARD)
    torch.manual_seed(0)
    backbone = build_backbone(cfg).to(CARD)
    rig = dome_rig(1, cfg.DATASET.CAMERA_NUM, space_center=cfg.CAPTURE_SPEC.SPACE_CENTER)[0]
    iw, ih = cfg.DATASET.IMAGE_SIZE
    rng = np.random.RandomState(3)
    frames = [rng.randint(0, 256, (cfg.DATASET.CAMERA_NUM, ih, iw, 3)).astype(np.uint8)
              for _ in range(24)]
    cams = torch.as_tensor(rig)[None].to(CARD)

    def serial_frame(f):
        with torch.no_grad():
            hm = images_to_heatmaps(backbone, torch.as_tensor(f)[None].to(CARD),
                                    cfg.DATASET.COLOR_RGB)
            out = model(hm, cams)
        return out.fused_poses[0].cpu().numpy(), out.proposal_centers[0].cpu().numpy()

    serial_frame(frames[0])  # cuDNN's algorithms chosen outside the timings
    t0 = time.perf_counter()
    serial = [serial_frame(f) for f in frames]
    serial_s = time.perf_counter() - t0
    stream = PipelinedStream(cfg, model, backbone, rig, devices=(CARD, CARD))

    def pipelined():
        t = time.perf_counter()
        outs = [stream.push(f) for f in frames] + [stream.flush()]
        return outs, time.perf_counter() - t

    outs, stream_s = count(pipelined)
    gap = max(float(np.abs(g - w).max()) for o, s_ in zip(outs[1:], serial)
              for g, w in zip(o, s_)) if all(o is not None for o in outs[1:]) else float("inf")
    print(f"scale-out: PipelinedStream, one card, two CUDA streams: 24 frames of 5 uint8 "
          f"{iw}x{ih} images (committed weights, seeded ResNet-{cfg.RESNET.NUM_LAYERS}, float32): "
          f"{24 / stream_s:.3f} frames/s pipelined against {24 / serial_s:.3f} serial; poses and "
          f"centres against the serial path with the lag: largest gap {gap:.3g} | {card}")
    if not (outs[0] is None and stream.flush() is None and gap <= 1e-5):
        raise AssertionError(f"scale-out: PipelinedStream off the serial path by {gap}")
    print(f"scale-out: launches {launches}")
    return launches


def released(result, label):
    """`result`, after the card's cached memory is given back: each phase's
    CUDA graphs have memory pools and side streams of their own, whose
    blocks the caching allocator keeps for reuse and no later phase can
    use.  Prints what stays allocated and reserved."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    print(f"memory after {label}: allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB, "
          f"reserved {torch.cuda.memory_reserved() / 2**30:.3f} GiB; "
          f"{time.perf_counter() - T_START:.1f} s from start")
    return result


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="only the kernel rows (1-11), each timed by tools/timing.py's three "
                         "timers, then their table; no path runs, no result line")
    ap.add_argument("--voxelpose", action="store_true",
                    help="only the build, kernel rows 9 and 11 and the VoxelPose phase; no "
                         "result line")
    ap.add_argument("--mvp", action="store_true",
                    help="only the build, kernel row 10 and the MvP phase; no result line")
    args = ap.parse_args(argv)
    t_start = T_START
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
    if args.voxelpose:
        rows = [released(front3d_phase(card), "front3d"),
                released(front_res3d_phase(card), "front_res3d")]
        print(json.dumps({"kernels": rows,
                          "voxelpose": released(voxelpose_phase(card), "voxelpose")}))
        print(f"chip_smoke --voxelpose: {time.perf_counter() - t_start:.1f} s from start")
        return 0
    if args.mvp:
        row = released(projattn_phase(card), "projattn")
        print(json.dumps({"kernels": [row], "mvp": released(mvp_phase(card), "mvp")}))
        print(f"chip_smoke --mvp: {time.perf_counter() - t_start:.1f} s from start")
        return 0

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
    rows.append(weightnet_phase(card))
    rows.append(released(front3d_phase(card), "front3d"))
    rows.append(released(front_res3d_phase(card), "front_res3d"))
    rows.append(released(projattn_phase(card), "projattn"))
    if args.kernels:
        for phase in (window_phase, mma_phase):
            rows += phase(card)[0]
        print(f"chip_smoke --kernels: {time.perf_counter() - t_start:.1f} s from start")
        print(json.dumps({"kernels": rows}))
        return 0
    parity_phase()
    # serving before the training phases, so that its latency is read on a
    # host and card that training has not yet loaded, as in earlier runs
    paths = {"serving": released(serving_phase(cfg, rig, card, rng), "serving")}
    paths["compiled"] = released(compiled_phase(cfg, rig, card, np.random.RandomState(9)),
                                 "compiled")
    paths["voxelpose"] = released(voxelpose_phase(card), "voxelpose")
    paths["mvp"] = released(mvp_phase(card), "mvp")
    paths["route"] = released(route_phase(cfg, rig, card, rng), "route")
    released(train_parity_phase(card), "train parity")
    released(compiled_train_phase(card), "train graph")
    paths["train"] = released(training_phase(card), "train")
    paths["cli"] = released(cli_phase(card), "cli")
    paths["tools"] = {}
    for phase in (window_phase, mma_phase):
        tool_rows, launches = released(phase(card), phase.__name__)
        rows += tool_rows
        paths["tools"].update(launches)
    paths["eval"] = released(eval_phase(card), "eval")
    paths["profiles"] = released(profiles_phase(card), "profiles")
    paths["images"] = released(images_phase(card), "images")
    bench_launches, bench_line = released(bench_phase(card), "bench")
    paths.update(bench_launches)
    paths["script tools"] = released(script_tools_phase(card, bench_line), "script tools")
    released(failed_capture_phase(cfg, rig, card), "failed capture")
    paths["datasets"] = released(datasets_phase(card), "datasets")
    paths["entry"] = released(entry_phase(card), "entry")
    paths["scale-out"] = released(scale_out_phase(card), "scale-out")

    # launches: the run of the path that reaches each kernel (the row's
    # `path`): compiled training and serving for the default route's
    # kernels, the route phase for the crop sampler's other modes, the
    # tools for the tuning kernels
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
