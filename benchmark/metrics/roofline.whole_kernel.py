"""Share of its roofline that the whole-space sampler reaches in the
traced requests: the least time of its work (`counts/kernels.py`), one
launch per request, over its device time by kernel name, in %."""

from benchmark.counts.kernels import least_seconds, whole_kernel

KERNEL = "whole_kernel"


def read(run):
    if not run.trace or not run.peaks:
        return None
    names = [n for n in run.trace["total_s"] if KERNEL in n and "crop" not in n]
    launches = sum(run.trace["count"][n] for n in names)
    if not names or launches != len(run.traced_entries):
        return None
    d, c = run.yaml["DATASET"], run.yaml["CAPTURE_SPEC"]
    work = whole_kernel(d["CAMERA_NUM"], d["HEATMAP_SIZE"][::-1], d["NUM_JOINTS"],
                        c["VOXELS_PER_AXIS"])
    spent = sum(run.trace["total_s"][n] for n in names)
    return 100.0 * launches * least_seconds(work, run.peaks) / spent
