"""Model registry (counterpart of `faster_voxelpose_tpu/models/__init__.py`,
reference lib/models/__init__.py)."""

from .faster_voxelpose import FasterVoxelPoseNet, ModelOutputs, build_model
from .resnet import PoseResNet, build_backbone


def get(name: str):
    """The function that builds the model `name`: 'faster_voxelpose' or 'resnet'."""
    if name == "faster_voxelpose":
        return build_model
    if name == "resnet":
        return build_backbone
    raise KeyError(f"unknown model '{name}'")
