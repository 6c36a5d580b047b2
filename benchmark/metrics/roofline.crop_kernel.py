"""Share of its roofline that the crop sampler reaches in the traced
requests: the least time of the work of each request's input, over the
voxels that the reference's valid proposals keep (`counts/kernels.py`),
over its device time by kernel name, in %.  Nothing to read where no
traced request has a valid proposal."""

from benchmark.counts.kernels import crop_kernel, least_seconds

KERNEL = "crop_kernel"


def read(run):
    if not run.trace or not run.peaks:
        return None
    names = [n for n in run.trace["total_s"] if KERNEL in n]
    launches = sum(run.trace["count"][n] for n in names)
    if not names or launches != len(run.traced_entries):
        return None
    d, c, i = run.yaml["DATASET"], run.yaml["CAPTURE_SPEC"], run.yaml["INDIVIDUAL_SPEC"]
    least = 0.0
    for e in run.traced_entries:
        live = run.live_voxels[e]
        if live:
            least += least_seconds(crop_kernel(d["CAMERA_NUM"], d["HEATMAP_SIZE"][::-1],
                                               d["NUM_JOINTS"], i["VOXELS_PER_AXIS"],
                                               c["MAX_PEOPLE"], live), run.peaks)
    if least == 0.0:
        return None
    return 100.0 * least / sum(run.trace["total_s"][n] for n in names)
