"""Model registry (counterpart of `faster_voxelpose_tpu/models/__init__.py`,
reference lib/models/__init__.py)."""

from .common import ModelOutputs
from .faster_voxelpose import FasterVoxelPoseNet, build_model
from .mvp import MvPNet, build_mvp
from .resnet import PoseResNet, build_backbone
from .voxelpose import VoxelPoseNet, build_voxelpose

FUSION_MODELS = {"faster_voxelpose": build_model, "voxelpose": build_voxelpose, "mvp": build_mvp}


def get(name: str):
    """The function that builds the model `name`: 'faster_voxelpose',
    'voxelpose', 'mvp' or 'resnet'."""
    if name == "resnet":
        return build_backbone
    if name in FUSION_MODELS:
        return FUSION_MODELS[name]
    raise KeyError(f"unknown model '{name}'")


def build_fusion_model(cfg):
    """The model that `cfg.MODEL` names, in eval mode, for serving:
    Faster VoxelPose ("faster_voxelpose"; training passes train=True),
    VoxelPose ("voxelpose", `models/voxelpose.py`, served only) or MvP
    ("mvp", `models/mvp.py`, served only, on the backbone's features)."""
    if cfg.MODEL not in FUSION_MODELS:
        raise ValueError(f"unknown MODEL {cfg.MODEL!r}: {' or '.join(FUSION_MODELS)}")
    return FUSION_MODELS[cfg.MODEL](cfg)
