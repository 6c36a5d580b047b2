"""A cell of the benchmark at a size the CPU runs in seconds: the
configurations' widths and checkpoints (joint counts and channels are
what the weights fix), a small space, small frames and heatmaps, K = 4."""

from __future__ import annotations

import copy
import time

import torch

from benchmark.core.spec import ROOT, benchmark_json, load_cell


def tiny_cell(name: str, rate: float = 20.0, pool: int = 3):
    cell = load_cell(name, benchmark_json())
    cell.config = copy.deepcopy(cell.config)
    y = cell.config["yaml"]
    y["DATASET"]["CAMERA_NUM"] = 3
    y["DATASET"]["IMAGE_SIZE"] = [128, 64]
    y["DATASET"]["HEATMAP_SIZE"] = [32, 16]
    y["CAPTURE_SPEC"]["VOXELS_PER_AXIS"] = [16, 16, 8]
    y["CAPTURE_SPEC"]["MAX_PEOPLE"] = 4
    y["INDIVIDUAL_SPEC"]["VOXELS_PER_AXIS"] = [16, 16, 16]
    cell.workload = dict(cell.workload, rate=rate, trace_requests=4)
    cell.mix = dict(cell.mix, pool=pool)
    cell.root_weights = ROOT / cell.config["weights"]
    return cell


def run_tiny(cell, seed: int = 2**33 + 5, seconds: float = 0.3, trace: bool = False):
    from benchmark.run import run_cell

    return run_cell(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter())
