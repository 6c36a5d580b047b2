"""PyTorch/CUDA port of faster_voxelpose_tpu: multi-view heatmaps and a
packed camera rig in, multi-person 3D poses out, on an NVIDIA H100.

The JAX package `faster_voxelpose_tpu` stays the reference; this package
imports nothing of it.  Module names follow the JAX package's, so each
module's counterpart is found under the same path.
"""
