"""Plain float32 PyTorch reference of what the served path computes.

Written from the published description of Faster-VoxelPose (ECCV 2022)
and Simple-Baselines Pose-ResNet, with the conventions of the repo's
checkpoints (flax layouts, "SAME" padding).  It imports nothing of the
port, of `jax` or of the JAX package, and derives everything from the
raw checkpoint file, the benchmark's weights and the request's inputs.
"""
