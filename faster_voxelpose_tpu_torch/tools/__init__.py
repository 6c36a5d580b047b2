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
capture_trace    a torch.profiler trace of the worst case's frames in one
                 CUDA graph (counterpart of scripts/capture_trace.py)
analyze_trace    a trace's device ms by kernel name, busy share and idle
                 gaps (counterpart of scripts/analyze_trace.py; needs no
                 GPU)
profile_backbone the ResNet-50 by stage against the card's bf16 peak, and
                 the stem candidates (scripts/profile_backbone.py)
run_real_parity  the real datasets and the model zoo's checkpoints to
                 PARITY.md (scripts/run_real_parity.py and .sh)
export_best_npz  a best model published as a snapshot, validated from the
                 written file (scripts/export_best_npz.py)
diagnose_campus  the Campus profile's per-axis error and PCP tables
                 (scripts/diagnose_campus.py)
bench_realistic  any config's trained detector on 24 of its test scenes
                 (scripts/bench_realistic.py)
check_sampling_parity
                 every sampling route of the full model against the
                 default, timed (scripts/check_pallas_parity.py)
smoke_kernels    the sampling kernels against their plain versions on
                 compact, wild, COCO-17 and near-camera cases, and their
                 times (scripts/smoke_kernel_tpu.py)
sweep_whole      the whole-space kernel's block size (scripts/sweep_whole.py)
sweep_planes     the crop kernel's tile and threads under two validity
                 modes (scripts/sweep_planes.py)
dryrun_multichip entry(), the tiny model's forward, and every scale-out
                 mode over n gloo ranks against one process (the JAX
                 repo's __graft_entry__.py)

They run on the card unless `--device cpu` is given, and raise when there
is no CUDA device (make_demo_data, preprocess and analyze_trace need none).
"""
