"""Persistent inference service of the port (counterpart of
`faster_voxelpose_tpu/engine/service.py`): a long-lived model and 2D
backbone on one device that compile once and then answer heatmaps ->
poses and images -> poses requests, with a hot-swappable camera rig and
latency accounting.  The backbone is the one `cfg.BACKBONE` names
(`models.resnet.build_backbone`): a Pose-ResNet, or a ViTPose
(`models/vitpose.py`), whose parameters are drawn on the service's
device.

- **Compiled graphs.** The JAX service lowers and compiles its batch-1
  graphs before the first request and runs one executable per request.
  Here each named graph ('heatmaps', 'images', 'images_u8') is captured
  once into a CUDA graph at batch 1 (`warmup`, at construction with
  `aot`); a request copies its input into the graph's static input,
  replays the graph and copies the poses out, so the host issues one
  graph launch in place of the forward's several hundred kernels.  An
  input of another shape, or a graph not captured, runs the same forward
  eagerly, on the same kernels.
- **Folded weights.**  Every graph runs the fusion model with its
  served weights prepared once, and the image graphs run the backbone so
  too, both by the one `blocks.FoldedModule.fold`: every BatchNorm
  folded into the convolution before it, every weight cast to the
  compute dtype.  Each is folded before it first runs (a graph's
  warm-up, or the first eager request).  On each request the host
  compares the version counters of the tensors each fold read with
  those at its last fold and, where one moved, refolds into the same
  buffers, which the captured graph reads (`blocks.FoldedModule`): in an
  eager forward, and once a graph's replay is launched, while the card
  runs it, which is then replayed again after a refold (`_run`).
- **Camera-rig hot-swap.** Every graph reads one static rig tensor;
  `set_rig` copies the new calibration into it, so a swap costs one
  host->device copy and no recapture.
- **Spans.** Each request writes six host stamps into the process's
  span log (`utils/profiling.SPANS`): `service.request` and its five
  contiguous children `service.input` (conversion and checks),
  `service.upload` (the copy into the graph's input), `service.launch`
  (the replay, or the eager forward), `service.wait` (the poses to the
  host) and `service.decode`, and its counters (`jln.slots`,
  `jln.people`).  One request in `GraphMarks.EVERY` answered by a
  captured graph adds its device intervals from CUDA events
  (`device.upload`, `device.launch_gap`, and from marks captured into
  the graph `device.backbone`, `device.hdn`, `device.jln`, with a
  ViTPose `device.vit_blocks` and `device.vit_head`, and for VoxelPose
  (`cfg.MODEL` "voxelpose", `models/voxelpose.py`) `device.cpn` and
  `device.prn` alone; its PRN's slots and valid people fill the same
  counters; for MvP (`cfg.MODEL` "mvp", `models/mvp.py`) `device.backbone`,
  `device.mvp_values` and `device.mvp_decoder`, its instance slots and
  valid people in the same counters).
  Construction, each graph's capture and each fold of the model or the
  backbone are set-up spans (`setup.build`, `setup.capture`, `setup.fold`
  labelled "fusion", or "voxelpose" for VoxelPose, "mvp" for MvP, or the
  backbone's "backbone" or "vitpose").  `stats`
  gives count / mean / p50 / p95 of the request spans, `trace_summary`
  every span, interval, counter and set-up span.
- **MvP.** MvP reads the Pose-ResNet's feature levels
  (`resnet.images_to_features`), not its heatmaps: its service serves
  frames alone, captures the image graphs only, and `infer_heatmaps`
  raises.
- **Raw outputs.** Each graph returns the fused poses and the proposal
  centres.  A request copies the poses alone to the host;
  `infer_images_raw` replays a graph for both (`tools/demo.py` draws its
  proposals' boxes from the centres).

`tools/serve.py` wraps this in the JSON-lines protocol of `run/serve.py`.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..datasets.images import load_view_images_u8
from ..datasets.shelf_campus import load_flat_calibration
from ..device import DeviceLike, pin_float32, resolve_device
from ..geometry.cameras import pack_rig
from ..geometry.example_rigs import dome_rig
from ..geometry.transforms import get_resize_transform
from ..models import ModelOutputs, build_fusion_model
from ..models.resnet import build_backbone, images_to_features, images_to_heatmaps
from ..utils import profiling
from ..weights import from_jax_variables
from . import graphs

GRAPHS = ("heatmaps", "images", "images_u8")


class CompiledGraph(NamedTuple):
    """One forward captured at batch 1 (its graph, fused poses and
    proposal centres, and the kernel launches that one replay makes), its
    static input, and its CUDA events (None where it was captured with
    the span log off)."""

    captured: graphs.Captured
    input: torch.Tensor
    marks: Optional[profiling.GraphMarks] = None

    @property
    def launches(self) -> Dict[str, int]:
        return self.captured.launches


def _poses_and_centers(out: ModelOutputs) -> Tuple[torch.Tensor, torch.Tensor]:
    return out.fused_poses, out.proposal_centers


class PoseService:
    """Heatmaps or images -> multi-person 3D poses on one device.

    Parameters
    ----------
    cfg : config (faster_voxelpose_tpu_torch.config)
    variables : flax variables of the JAX package's model, flat
        path-keyed (an opened `model_best.npz`) or nested; None -> random
        init from `seed` (a dry-run mode, reported by
        `stats()["random_init"]`)
    backbone_variables : flax variables of the JAX package's `PoseResNet`,
        flat or nested; None -> a random backbone from `seed`
        (`stats()["backbone_random_init"]`).  A ViTPose has no flax
        counterpart: its weights are loaded into `self.backbone` as a
        state dict, and flax variables with it raise ValueError.  An
        upstream Pose-ResNet state dict enters as `weights.to_jax_variables(
        weights.convert_backbone(sd, num_layers))`; weights loaded into
        `self.backbone` afterwards are not seen by `stats()` or by the
        default `warmup`.  The heatmaps path never runs the backbone.
    rig : packed (V, 21) rig; may be swapped later with `set_rig`
    device : where to run; None -> the CUDA device, raising if there is none
    aot : on a CUDA device, capture the default graphs at construction
        (`warmup()`), as the JAX service compiles them; on the CPU
        construction runs no forward

    The model and the backbone are served folded, each by
    `blocks.FoldedModule.fold` at its first use (`setup.fold` spans
    labelled "fusion", and "backbone" or "vitpose").
    """

    def __init__(self, cfg, variables: Optional[Mapping] = None,
                 backbone_variables: Optional[Mapping] = None,
                 rig: Optional[np.ndarray] = None, device: DeviceLike = None,
                 seed: int = 0, aot: bool = True):
        self.device = resolve_device(device)
        pin_float32()
        self.cfg = cfg
        self._V = cfg.DATASET.CAMERA_NUM
        self._W, self._H = cfg.DATASET.HEATMAP_SIZE
        self._J = cfg.DATASET.NUM_JOINTS
        self._iw, self._ih = cfg.DATASET.IMAGE_SIZE
        # the service's id in the span log, for its requests and set-up
        self._owner = profiling.SPANS.new_owner()
        if backbone_variables is not None and cfg.BACKBONE != "resnet":
            raise ValueError(f"backbone_variables hold a flax Pose-ResNet; a {cfg.BACKBONE} "
                             "backbone takes a state dict (self.backbone.load_state_dict)")
        with profiling.SPANS.span("setup.build", owner=self._owner):
            on_card = [self.device] if self.device.type == "cuda" else []
            with torch.random.fork_rng(devices=on_card):
                torch.manual_seed(seed)
                self.model = build_fusion_model(cfg)
                self.backbone = build_backbone(cfg, self.device)
            self.random_init = variables is None
            self.backbone_random_init = backbone_variables is None
            if variables is not None:
                self.model.load_state_dict(from_jax_variables(variables, self.model))
            if backbone_variables is not None:
                self.backbone.load_state_dict(
                    from_jax_variables(backbone_variables, self.backbone))
            self.model.to(self.device)
            self.backbone.to(self.device)
        # the one rig every graph reads: set_rig copies into it
        self._rig = torch.zeros((1, self._V, 21), device=self.device)
        self._rig_set = False
        if rig is not None:
            self.set_rig(rig)
        self._total_requests = 0
        # graph name -> its CompiledGraph, or None where nothing can be
        # captured (the CPU) and requests run eagerly
        self._compiled: Dict[str, Optional[CompiledGraph]] = {}
        if aot and self.device.type == "cuda":
            self.warmup()

    # -- compilation ----------------------------------------------------

    def warmup(self, graphs: Optional[Sequence[str]] = None) -> list:
        """Compile the named graphs for batch 1: 'heatmaps', 'images'
        (normalised float32 frames) or 'images_u8' (uint8 frames).
        Default: 'heatmaps', plus 'images_u8' when backbone weights were
        given; for MvP, which takes no heatmaps, 'images_u8' alone.  On a
        CUDA device each is captured into a CUDA graph
        (`_capture`); a capture that fails raises, and the service never
        answers eagerly in place of a graph it was asked to compile.  On
        the CPU nothing can be captured: each graph runs one eager
        forward, and requests run eagerly.  Before any rig is set the
        forwards run on a placeholder dome rig (`geometry.dome_rig`),
        which `set_rig` overwrites.  Returns the graphs compiled so far
        (`stats()["compiled"]`).

        Every graph runs the folded model, and an image graph the folded
        backbone (`fold`, folded here before its first forward).  A graph
        reads the folded weights where they lie: weights loaded in place
        afterwards (`load_state_dict`) are seen by the next request through
        a refold into the same buffers (`sync_fold`, a `setup.fold` span;
        `_run`); modules replaced by new objects are not."""
        if graphs is None:
            graphs = ("heatmaps",) if self.backbone_random_init else ("heatmaps", "images_u8")
            graphs = ("images_u8",) if self._reads_features() else graphs
        unknown = set(graphs) - set(GRAPHS)
        if unknown:
            raise ValueError(f"unknown graphs {sorted(unknown)}; known: {GRAPHS}")
        if "heatmaps" in graphs:
            self._takes_heatmaps()
        if not self._rig_set:
            self._rig.copy_(torch.as_tensor(self._placeholder_rig()))
        for name in graphs:
            if name in self._compiled:
                continue
            x = torch.zeros(self._input_shape(name), device=self.device,
                            dtype=torch.uint8 if name == "images_u8" else torch.float32)
            forward = self._forward(name)
            for m in self._folded(name):
                self._fold_once(m)
            with profiling.SPANS.span("setup.capture", owner=self._owner, label=name):
                if self.device.type == "cuda":
                    self._compiled[name] = self._capture(forward, x)
                else:
                    with torch.inference_mode():
                        forward(x)
                    self._compiled[name] = None
        return sorted(self._compiled)

    def _capture(self, forward: Callable[[torch.Tensor], ModelOutputs],
                 static_input: torch.Tensor) -> CompiledGraph:
        """forward(static_input) captured into a CUDA graph, by PyTorch's
        recipe: CAPTURE_WARMUP eager forwards on a side stream, then the
        capture on that stream under inference mode (`graphs.capture`:
        the graph's own memory pool, its launches kept as what one replay
        launches).  With the span log on, the graph records its marks
        (`profiling.GraphMarks`): at its start, after the backbone (image
        graphs; a ViTPose's also after its patch embedding and after its
        last block), after the HDN and at its end.  Raises what the capture
        raises, e.g. for a host synchronisation or a copy from pageable
        host memory inside the forward."""
        stream = torch.cuda.Stream(self.device)
        for _ in range(graphs.CAPTURE_WARMUP):
            graphs.run_on(stream, lambda: forward(static_input), inference=True)
        marks = profiling.GraphMarks() if profiling.SPANS.enabled else None

        def marked():
            profiling.mark("start")
            out = _poses_and_centers(forward(static_input))
            profiling.mark("end")
            return out

        with profiling.marking(marks):
            c = graphs.capture(marked, stream, inference=True)
        return CompiledGraph(c, static_input, marks)

    def _folded(self, name: str) -> tuple:
        """The folded modules the graph `name` runs."""
        return (self.model,) if name == "heatmaps" else (self.model, self.backbone)

    def _fold_once(self, module) -> None:
        """Fold the model or the backbone at its first use; a folded
        module's eager forward checks its fold itself (`serving`), a
        graph's replay is checked by `_run`."""
        if not module.folded:
            module.fold(self._owner)

    def _input_shape(self, name: str) -> tuple:
        if name == "heatmaps":
            return (1, self._V, self._H, self._W, self._J)
        return (1, self._V, self._ih, self._iw, 3)

    def _forward(self, name: str) -> Callable[[torch.Tensor], ModelOutputs]:
        if name == "heatmaps":
            return lambda x: self.model(x, self._cams(x))
        return lambda x: self._images_forward(x, self._cams(x))

    def _cams(self, x: torch.Tensor) -> torch.Tensor:
        """The rig for a batch of x.shape[0] samples."""
        return self._rig if x.shape[0] == 1 else self._rig.expand(x.shape[0], -1, -1)

    def _images_forward(self, images: torch.Tensor, cams: torch.Tensor) -> ModelOutputs:
        if self._reads_features():
            feats = images_to_features(self.backbone, images, self.cfg.DATASET.COLOR_RGB)
            profiling.mark("backbone")
            return self.model(feats, cams)
        hm = images_to_heatmaps(self.backbone, images, self.cfg.DATASET.COLOR_RGB)
        profiling.mark("backbone")
        return self.model(hm, cams)

    def _reads_features(self) -> bool:
        """Whether the model reads the backbone's features (`READS =
        "features"`, MvP) and not its heatmaps (the default)."""
        return getattr(self.model, "READS", "heatmaps") == "features"

    def _takes_heatmaps(self) -> None:
        if self._reads_features():
            raise ValueError("MvP reads the backbone's feature levels, not heatmaps: serve it "
                             "frames (infer_images)")

    def _placeholder_rig(self) -> np.ndarray:
        """A dome rig around the capture space, for forwards before any
        rig is set."""
        ori = self.cfg.DATASET.ORI_IMAGE_SIZE
        return dome_rig(1, self._V, space_center=self.cfg.CAPTURE_SPEC.SPACE_CENTER,
                        ori_image_size=ori, focal=0.75 * ori[0])

    # -- rig management --------------------------------------------------

    def set_rig(self, rig: np.ndarray) -> None:
        """Hot-swap the camera calibration (no recapture): a packed (V, 21)
        rig or a (1, V, 21) batch of one, copied into the rig tensor that
        every graph reads."""
        rig = np.asarray(rig, np.float32)
        if rig.ndim == 2:
            rig = rig[None]
        if rig.shape != (1, self._V, 21):
            raise ValueError(f"rig shape {rig.shape} != (1, {self._V}, 21)")
        self._rig.copy_(torch.from_numpy(rig))
        self._rig_set = True

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
        if not self._rig_set:
            raise RuntimeError("no camera rig set; call set_rig")
        return self._rig

    # -- inference --------------------------------------------------------

    def _run(self, name: str, x: torch.Tensor, req):
        """The fused poses and proposal centres of x, by the compiled
        graph `name` where there is one for x's shape, else by the eager
        forward; and the graph's marks where `req` is timed and reads them
        (`GraphMarks.sampled`).  Ends `req`'s input span, stamps the
        upload's end, and leaves the launch open.

        The folded weights' version check (`sync_fold` of the model, and
        of the backbone for frames) runs in an eager forward, and after a
        graph's replay is launched, while the card runs it: the check
        reads a counter of each of several hundred tensors, which costs
        the host a tenth of a millisecond or more between requests.  Where
        a tensor moved, the refold is queued behind that replay and the
        graph replays again, so the answer is the refolded weights'."""
        folded = self._folded(name)
        for m in folded:
            self._fold_once(m)
        g = self._compiled.get(name)
        if g is not None and x.shape == g.input.shape:
            req.next()
            marks = g.marks if req.timed and g.marks is not None and g.marks.sampled() else None
            if marks is not None:
                marks.upload[0].record()
            g.input.copy_(x)
            if marks is not None:
                marks.upload[1].record()
            req.next()
            out = graphs.replay(g.captured)
            if any([m.sync_fold() for m in folded]):
                out = graphs.replay(g.captured)
            return out, marks
        req.next()
        x = x.to(self.device)
        req.next()
        with torch.inference_mode():
            return _poses_and_centers(self._forward(name)(x)), None

    @staticmethod
    def _decode(fused: np.ndarray) -> dict:
        fused = fused[0]
        valid = fused[:, 0, 3] >= 0
        return {
            "poses_mm": fused[valid][:, :, :3].tolist(),
            "scores": fused[valid][:, 0, 4].tolist(),
            "n_people": int(valid.sum()),
        }

    def _answer(self, req, name: str, x: torch.Tensor) -> dict:
        """The decoded poses of the request `req` on input x, its spans
        closed; the poses are copied to the host, so that the next replay
        does not overwrite them.  The graph's events are read after the
        last stamp, once the copy has waited for them."""
        (fused, _), marks = self._run(name, x, req)
        req.next()
        fused = fused.cpu().numpy()
        req.next()
        res = self._decode(fused)
        self._total_requests += 1
        req.close(self._owner, (fused.shape[1], res["n_people"]))
        if marks is not None:
            req.device(marks.read())
        res["latency_ms"] = round(req.ms(), 3)
        return res

    def infer_heatmaps(self, heatmaps) -> dict:
        """(V, H, W, J) or (1, V, H, W, J) float32 heatmaps, numpy or a
        tensor -> poses.  The latency (`latency_ms`, the request span)
        runs from the call to the poses decoded on the host, the
        host->device copy included.  An MvP service raises ValueError: MvP
        takes frames."""
        self._takes_heatmaps()
        self._require_rig()
        with profiling.SPANS.request() as req:
            hm = torch.as_tensor(heatmaps, dtype=torch.float32)
            if hm.ndim == 4:
                hm = hm[None]
            return self._answer(req, "heatmaps", hm)

    def infer_images(self, images) -> dict:
        """(V, ih, iw, 3) or (1, V, ih, iw, 3) frames at IMAGE_SIZE, numpy
        or a tensor -> poses.  uint8 frames are decoded BGR and normalised
        on the device (`datasets.images.normalize_images_device`, the
        'images_u8' graph); float frames are taken as ImageNet-normalised
        already (RGB when COLOR_RGB; the 'images' graph).  The latency is
        counted as for `infer_heatmaps`."""
        self._require_rig()
        with profiling.SPANS.request() as req:
            return self._answer(req, *self._images_input(images))

    def infer_images_raw(self, images) -> Tuple[np.ndarray, np.ndarray]:
        """The frames of `infer_images` -> the fused poses (1, K, J, 5) and
        proposal centres (1, K, 7) on the host, from the same graph; not a
        request (no latency recorded)."""
        self._require_rig()
        (fused, centers), _ = self._run(*self._images_input(images), profiling.Untimed())
        return fused.cpu().numpy(), centers.cpu().numpy()

    def _images_input(self, images) -> Tuple[str, torch.Tensor]:
        """The graph's name and the (1, V, ih, iw, 3) input of frames."""
        x = torch.as_tensor(images)
        if x.dtype != torch.uint8:
            x = x.to(torch.float32)
        if x.ndim == 4:
            x = x[None]
        if tuple(x.shape[1:]) != (self._V, self._ih, self._iw, 3):
            raise ValueError(f"images of shape {tuple(x.shape)}, the service takes "
                             f"(1, {self._V}, {self._ih}, {self._iw}, 3)")
        return ("images_u8" if x.dtype == torch.uint8 else "images"), x

    def infer_image_paths(self, paths: Sequence[str]) -> dict:
        """One image file per view, in camera order -> poses: each decoded
        with cv2 and warped to IMAGE_SIZE where it is not at that size
        (`datasets.images.load_view_images_u8`), then sent as uint8
        frames through the 'images_u8' graph."""
        if len(paths) != self._V:
            raise ValueError(f"need {self._V} views, got {len(paths)}")
        d = self.cfg.DATASET
        rt = get_resize_transform(d.ORI_IMAGE_SIZE, d.IMAGE_SIZE)
        return self.infer_images(load_view_images_u8(list(paths), d.IMAGE_SIZE, rt))

    # -- observability ----------------------------------------------------

    def stats(self) -> dict:
        """Requests answered, and count / mean / p50 / p95 (ms) of the
        request spans the log keeps (none with the log off); whether the
        backbone and the fusion model run folded."""
        stamps = profiling.SPANS.requests(self._owner)["stamps_ns"]
        lat = profiling.durations_ms(stamps)[profiling.REQUEST_SPANS[0]]
        if lat.size == 0:
            return {"requests": self._total_requests, "random_init": self.random_init,
                    "backbone_random_init": self.backbone_random_init,
                    "backbone_folded": self.backbone.folded,
                    "fusion_folded": self.model.folded}
        return {
            "requests": self._total_requests,
            "mean_ms": round(float(lat.mean()), 3),
            "p50_ms": round(float(np.percentile(lat, 50)), 3),
            "p95_ms": round(float(np.percentile(lat, 95)), 3),
            "compiled": sorted(self._compiled),
            "device": str(self.device),
            "random_init": self.random_init,
            "backbone_random_init": self.backbone_random_init,
            "backbone_folded": self.backbone.folded,
            "fusion_folded": self.model.folded,
        }

    def trace_summary(self) -> dict:
        """This service's spans in the log: count, p50 and p95 (ms) of each
        request span and device interval, the counters' totals and the
        set-up spans (s; `profiling.summary`)."""
        return profiling.summary(profiling.SPANS, self._owner)
