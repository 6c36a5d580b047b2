"""Model registry (counterpart of `faster_voxelpose_tpu/models/__init__.py`,
reference lib/models/__init__.py)."""

from .common import ModelOutputs
from .faster_voxelpose import FasterVoxelPoseNet, build_model
from .resnet import PoseResNet, build_backbone
from .voxelpose import VoxelPoseNet, build_voxelpose

FUSION_MODELS = {"faster_voxelpose": build_model, "voxelpose": build_voxelpose}


def get(name: str):
    """The function that builds the model `name`: 'faster_voxelpose',
    'voxelpose' or 'resnet'."""
    if name == "resnet":
        return build_backbone
    if name in FUSION_MODELS:
        return FUSION_MODELS[name]
    raise KeyError(f"unknown model '{name}'")


def build_fusion_model(cfg):
    """The fusion model that `cfg.MODEL` names, in eval mode, for serving:
    Faster VoxelPose ("faster_voxelpose"; training passes train=True) or
    VoxelPose ("voxelpose", `models/voxelpose.py`, served only)."""
    if cfg.MODEL not in FUSION_MODELS:
        raise ValueError(f"unknown MODEL {cfg.MODEL!r}: {' or '.join(FUSION_MODELS)}")
    return FUSION_MODELS[cfg.MODEL](cfg)
