"""Command-line tools of the port, each runnable as
`python3 -m faster_voxelpose_tpu_torch.tools.<name>` on a machine with one
NVIDIA GPU:

probe_sampling   windowed sampling against the gather kernel (counterpart
                 of scripts/probe_pallas.py)
sweep_sampling   the window kernel's nine configurations (counterpart of
                 scripts/sweep_pallas.py)
microbench_mma   tensor-core cost against contraction size and window
                 origin (counterpart of scripts/microbench_matmul.py)
validate         AP / recall / MPJPE of any committed snapshot on the
                 held-out synthetic scenes of its own profile
                 (counterpart of run/validate.py)
serve            the JSON-lines inference server over PoseService's
                 compiled graphs (counterpart of run/serve.py)
train            the training CLI: compiled train and eval steps, prefetch,
                 resumable checkpoints (counterpart of run/train.py)
make_demo_data   the synthetic rig and pose bank that a synthetic
                 config's DATADIR holds (counterpart of
                 scripts/make_demo_data.py; needs no GPU)

They run on the card unless `--device cpu` is given, and raise when there
is no CUDA device.
"""
