"""Share of its roofline that the crop sampler's bounded cube mode (the
PRN's cubes) reaches in the traced requests: the least time of its bytes
(`counts/voxelpose.py`: the heatmaps read, the K cubes written, at the
memory bandwidth) over its device time, found by the kernel's name, in %.
Nothing to read where the trace holds no such launch, or not one per
traced request."""

from benchmark.counts.voxelpose import cube_kernel, least_seconds

KERNEL = "crop_kernel<false, true, true>"


def read(run):
    if not run.trace or not run.peaks:
        return None
    names = [n for n in run.trace["total_s"] if KERNEL in n]
    launches = sum(run.trace["count"][n] for n in names)
    if not names or launches != len(run.traced_entries):
        return None
    least = len(run.traced_entries) * least_seconds(cube_kernel(run.yaml), run.peaks)
    return 100.0 * least / sum(run.trace["total_s"][n] for n in names)
