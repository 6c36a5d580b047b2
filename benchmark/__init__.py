"""The benchmark of the PyTorch/CUDA port (`faster_voxelpose_tpu_torch`):
`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`.
See README.md."""
