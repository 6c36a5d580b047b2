"""Persistent inference service of the port (counterpart of
`faster_voxelpose_tpu/engine/service.py`): a long-lived model on one
device that answers heatmaps -> poses requests, with a hot-swappable
camera rig and latency accounting.  The image path (`infer_images`)
belongs to the backbone slice and is not ported yet.
"""

from __future__ import annotations

import collections
import time
from typing import Mapping, Optional

import numpy as np
import torch

from ..datasets.shelf_campus import load_flat_calibration
from ..device import DeviceLike, pin_float32, resolve_device
from ..geometry.cameras import pack_rig
from ..models.faster_voxelpose import build_model
from ..weights import from_jax_variables


class PoseService:
    """Heatmaps -> multi-person 3D poses on one device.

    Parameters
    ----------
    cfg : config (faster_voxelpose_tpu_torch.config)
    variables : flax variables of the JAX package, flat path-keyed (an
        opened `model_best.npz`) or nested; None -> random init from
        `seed` (a dry-run mode, reported by `stats()["random_init"]`)
    rig : packed (V, 21) rig; may be swapped later with `set_rig`
    device : where to run; None -> the CUDA device, raising if there is none
    """

    def __init__(self, cfg, variables: Optional[Mapping] = None,
                 rig: Optional[np.ndarray] = None, device: DeviceLike = None,
                 seed: int = 0):
        self.device = resolve_device(device)
        pin_float32()
        self.cfg = cfg
        self._V = cfg.DATASET.CAMERA_NUM
        self._W, self._H = cfg.DATASET.HEATMAP_SIZE
        self._J = cfg.DATASET.NUM_JOINTS
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = build_model(cfg)
        self.random_init = variables is None
        if variables is not None:
            self.model.load_state_dict(from_jax_variables(variables, self.model))
        self.model.to(self.device)
        self._rig = None
        if rig is not None:
            self.set_rig(rig)
        self._latencies_ms = collections.deque(maxlen=10000)
        self._total_requests = 0
        self._warm = False

    def warmup(self) -> None:
        """One forward on zero heatmaps: builds the kernels and lets
        cuDNN pick its algorithms before the first request is timed."""
        hm = torch.zeros((1, self._V, self._H, self._W, self._J), device=self.device)
        cams = self._require_rig()
        with torch.inference_mode():
            self.model(hm, cams)
        self._sync()
        self._warm = True

    def set_rig(self, rig: np.ndarray) -> None:
        """Hot-swap the camera calibration: a packed (V, 21) rig or a
        (1, V, 21) batch of one."""
        rig = np.asarray(rig, np.float32)
        if rig.ndim == 2:
            rig = rig[None]
        if rig.shape != (1, self._V, 21):
            raise ValueError(f"rig shape {rig.shape} != (1, {self._V}, 21)")
        self._rig = torch.as_tensor(rig, device=self.device)

    def set_rig_from_calibration(self, path: str) -> np.ndarray:
        """Hot-swap the rig from a flat calibration JSON
        ({cam_id: {R, T, fx, fy, cx, cy, k, p}}, cameras in id order,
        the first CAMERA_NUM of them); returns the packed rig."""
        cams = load_flat_calibration(path)
        if len(cams) < self._V:
            raise ValueError(f"{path} holds {len(cams)} cameras, the model takes {self._V}")
        rig = pack_rig([cams[k] for k in sorted(cams)][: self._V]).astype(np.float32)
        self.set_rig(rig)
        return rig

    def _require_rig(self) -> torch.Tensor:
        if self._rig is None:
            raise RuntimeError("no camera rig set; call set_rig")
        return self._rig

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _decode(fused: np.ndarray) -> dict:
        fused = fused[0]
        valid = fused[:, 0, 3] >= 0
        return {
            "poses_mm": fused[valid][:, :, :3].tolist(),
            "scores": fused[valid][:, 0, 4].tolist(),
            "n_people": int(valid.sum()),
        }

    def infer_heatmaps(self, heatmaps) -> dict:
        """(V, H, W, J) or (1, V, H, W, J) float32 heatmaps, numpy or a
        tensor -> poses.  The latency runs from the call to the poses on
        the host, the host->device copy included."""
        rig = self._require_rig()
        t0 = time.perf_counter()
        hm = torch.as_tensor(heatmaps, dtype=torch.float32).to(self.device)
        if hm.ndim == 4:
            hm = hm[None]
        with torch.inference_mode():
            out = self.model(hm, rig)
        fused = out.fused_poses.cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        self._latencies_ms.append(ms)
        self._total_requests += 1
        res = self._decode(fused)
        res["latency_ms"] = round(ms, 3)
        return res

    def stats(self) -> dict:
        lat = np.asarray(self._latencies_ms, np.float64)
        if lat.size == 0:
            return {"requests": 0, "random_init": self.random_init}
        return {
            "requests": self._total_requests,
            "mean_ms": round(float(lat.mean()), 3),
            "p50_ms": round(float(np.percentile(lat, 50)), 3),
            "p95_ms": round(float(np.percentile(lat, 95)), 3),
            "device": str(self.device),
            "warm": self._warm,
            "random_init": self.random_init,
        }
