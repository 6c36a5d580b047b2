"""Command-line tools of the port, each runnable as
`python3 -m faster_voxelpose_tpu_torch.tools.<name>` on a machine with one
NVIDIA GPU:

probe_sampling   windowed sampling against the gather kernel (counterpart
                 of scripts/probe_pallas.py)
sweep_sampling   the window kernel's nine configurations (counterpart of
                 scripts/sweep_pallas.py)
microbench_mma   tensor-core cost against contraction size and window
                 origin (counterpart of scripts/microbench_matmul.py)
validate         a config's test set with its best model or an upstream
                 checkpoint, with TEST.VISUALIZATION (--cfg, counterpart
                 of run/validate.py); AP / recall / MPJPE of any committed
                 snapshot on the held-out synthetic scenes of its own
                 profile (--checkpoint)
demo             multi-view images and a calibration JSON -> 3D poses
                 through PoseService's compiled image graph (counterpart
                 of run/demo.py)
preprocess       resize a config's dataset images on disk once
                 (counterpart of run/preprocess.py; needs no GPU)
serve            the JSON-lines inference server over PoseService's
                 compiled graphs (counterpart of run/serve.py)
serve_latency    PoseService's per-request latency on held-out scenes, run
                 by path against the checkout on PYTHONPATH (compares two
                 checkouts in one call)
train            the training CLI: compiled train and eval steps, prefetch,
                 resumable checkpoints, TRAIN.VISUALIZATION (counterpart of
                 run/train.py)
bench            the end-to-end benchmark: the worst case (every proposal
                 slot valid) at latency and batch-8 throughput and the
                 realistic load (committed weights, held-out scenes), each
                 measurement one CUDA graph of F frames, on the host's and
                 the device's clocks (counterpart of bench.py)
profile_stages   per-stage time of the pipeline by the same scan slope
                 (counterpart of scripts/profile_stages.py)
bench_width      the half-width fusion trunk against full width
                 (counterpart of scripts/bench_width.py)
make_demo_data   the synthetic rig and pose bank that a synthetic
                 config's DATADIR holds (counterpart of
                 scripts/make_demo_data.py; needs no GPU)

They run on the card unless `--device cpu` is given, and raise when there
is no CUDA device (make_demo_data and preprocess need none).
"""
