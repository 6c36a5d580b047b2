from .faster_voxelpose import FasterVoxelPoseNet, ModelOutputs, build_model
