"""Persistent inference server: JSON lines over stdin and stdout
(counterpart of run/serve.py).  A long-lived process that captures the
pipeline once (`PoseService`, CUDA graphs at batch 1), then answers frame
requests until EOF or `quit`.

    python3 -m faster_voxelpose_tpu_torch.tools.serve \\
        --best-from checkpoints/panoptic_synthetic --calibration calib.json
    python3 -m faster_voxelpose_tpu_torch.tools.serve --cfg tiny.yaml \\
        --calibration calib.json --torch-weights model_best.pth.tar --device cpu

Protocol (one JSON object per line, one answer per line on stdout):
    {"cmd": "ping"}                                -> {"ok": true}
    {"cmd": "infer", "images": ["v0.jpg", ...]}    -> poses + latency
    {"cmd": "infer", "heatmaps": "frame.npy"}      -> poses + latency
    {"cmd": "rig", "calibration": "other.json"}    -> hot-swap cameras
    {"cmd": "stats"}                               -> latency summary
    {"cmd": "trace"}                               -> spans, device intervals,
                                                      counters, set-up
    {"cmd": "quit"}                                -> exits

`heatmaps` .npy files are (V, H, W, J) float32; `images` is one path per
view in camera order, decoded with cv2.  A bad request is answered with
{"error": ...} and the server keeps serving.

The config: `--cfg` names a committed profile (`configs/demo/<stem>.yaml`,
or its stem alone), built in code by `config.profile`, or any other YAML
file, read by `config.load_config` (which needs PyYAML).  Without
`--cfg`, `--best-from` must name a snapshot directory whose
`eval_record.json` names its profile, as `tools/validate.py` reads it.
The server runs on the CUDA device unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Optional

import numpy as np

from ..config import PROFILES, Config, load_config, profile
from ..engine.checkpoint import load_best_model
from ..engine.service import PoseService
from ..models.faster_voxelpose import build_model
from ..weights import (
    convert_backbone,
    convert_model,
    load_torch_state_dict,
    to_jax_variables,
)
from .validate import REPO, snapshot_profile


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Faster-VoxelPose server (PyTorch/CUDA port)")
    p.add_argument("--cfg", default=None,
                   help="a committed profile's YAML (or stem), or any experiment YAML; "
                        "optional with --best-from a snapshot that has an eval_record.json")
    p.add_argument("--calibration", required=True,
                   help="flat {cam_id: {...}} calibration json")
    p.add_argument("--torch-weights", default=None,
                   help="reference model_best.pth.tar to convert")
    p.add_argument("--backbone-weights", default=None)
    p.add_argument("--best-from", default=None, metavar="OUTPUT_DIR",
                   help="load OUTPUT_DIR/model_best.npz")
    p.add_argument("--no-aot", action="store_true",
                   help="capture no graph at start (every request runs eagerly)")
    p.add_argument("--device", default=None, help="'cpu' runs the plain PyTorch path")
    return p.parse_args(argv)


def resolve_config(cfg: Optional[str], best_from: Optional[str]) -> Config:
    """The server's config: a committed profile by its stem (or its YAML
    under configs/demo), any other YAML by `load_config`, or with no
    `cfg` the profile named by `best_from`'s eval record."""
    if cfg is None:
        if best_from is None:
            raise SystemExit("serve: --cfg is needed unless --best-from names a snapshot "
                             "with an eval_record.json")
        return snapshot_profile(pathlib.Path(best_from))
    path = pathlib.Path(cfg)
    committed = REPO / "configs" / "demo" / f"{path.stem}.yaml"
    if path.stem in PROFILES and (not path.exists() or path.resolve() == committed.resolve()):
        return profile(path.stem)
    return load_config(path)


def build_service(args) -> PoseService:
    cfg = resolve_config(args.cfg, args.best_from)
    variables = backbone_variables = None
    if args.torch_weights:
        variables = to_jax_variables(convert_model(load_torch_state_dict(args.torch_weights)))
    elif args.best_from:
        model = load_best_model(args.best_from, build_model(cfg))
        variables = to_jax_variables(model.state_dict())
    path = args.backbone_weights or cfg.NETWORK.PRETRAINED_BACKBONE
    if path:
        backbone_variables = to_jax_variables(
            convert_backbone(load_torch_state_dict(path), cfg.RESNET.NUM_LAYERS))

    svc = PoseService(cfg, variables=variables, backbone_variables=backbone_variables,
                      device=args.device, aot=not args.no_aot)
    if svc.random_init:
        # make dry-run mode unmissable: a server with untrained weights
        # answers every request with garbage poses
        print("WARNING: no --torch-weights/--best-from given — serving "
              "RANDOM-INIT weights (dry-run mode, poses are meaningless)", file=sys.stderr)
    svc.set_rig_from_calibration(args.calibration)
    return svc


def handle(svc: PoseService, req: dict) -> dict:
    cmd = req.get("cmd")
    if cmd == "ping":
        return {"ok": True}
    if cmd == "stats":
        return svc.stats()
    if cmd == "trace":
        return svc.trace_summary()
    if cmd == "rig":
        svc.set_rig_from_calibration(req["calibration"])
        return {"ok": True}
    if cmd == "infer":
        if "heatmaps" in req:
            return svc.infer_heatmaps(np.load(req["heatmaps"]))
        if "images" in req:
            return svc.infer_image_paths(req["images"])
        return {"error": "infer needs 'images' or 'heatmaps'"}
    return {"error": f"unknown cmd {cmd!r}"}


def serve(svc: PoseService, fin, fout) -> None:
    """Pump the JSON-lines loop until EOF or quit; never dies on a bad
    request (serving must degrade, not crash)."""
    print(json.dumps({"ready": True, **svc.stats()}), file=fout, flush=True)
    for line in fin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            print(json.dumps({"error": f"bad json: {e}"}), file=fout, flush=True)
            continue
        if req.get("cmd") == "quit":
            print(json.dumps({"ok": True, "bye": True}), file=fout, flush=True)
            return
        try:
            resp = handle(svc, req)
        except Exception as e:  # noqa: BLE001 — report, keep serving
            resp = {"error": f"{type(e).__name__}: {e}"}
        print(json.dumps(resp), file=fout, flush=True)


def main(argv=None) -> None:
    args = parse_args(argv)
    svc = build_service(args)
    serve(svc, sys.stdin, sys.stdout)


if __name__ == "__main__":
    main()
