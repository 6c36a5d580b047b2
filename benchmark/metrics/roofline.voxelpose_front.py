"""Share of its roofline that VoxelPose's 7x7x7 front kernel
(`front3d_kernel`, the port's `csrc/front3d.cu`) reaches in the traced
requests: the least time of its work, two launches per request (the
CPN's front and the PRN's), over its device time by kernel name, in %.
Nothing to read where the traced requests launched it other than twice
each (a program without the kernel).

The work of one request, from the published YAML: the folded conv from J
joints to 16 channels, 7^3 taps, over the CPN's whole space (X * Y * Z
voxels) and the PRN's K = MAX_PEOPLE cubes.  Operations: 2 * 16 * J * 343
a voxel, counted over the J channels (not the lanes an implementation
pads them to) at the bf16 peak, so that the share reads the same work
whatever implements it; bytes: the float32 cubes in and the bf16 output
out.  The operations bound it: 452.7 GFLOP, 0.458 ms, at Panoptic."""

KERNEL = "front3d_kernel"
TAPS, COUT = 7 ** 3, 16


def work(yaml) -> dict:
    d, c, i = yaml["DATASET"], yaml["CAPTURE_SPEC"], yaml["INDIVIDUAL_SPEC"]
    J, K = int(d["NUM_JOINTS"]), int(c["MAX_PEOPLE"])
    X, Y, Z = c["VOXELS_PER_AXIS"]
    x, y, z = i["VOXELS_PER_AXIS"]
    voxels = X * Y * Z + K * x * y * z
    return {"bytes": (4 * J + 2 * COUT) * voxels, "ops": 2 * COUT * J * TAPS * voxels}


def least_seconds(yaml, peaks) -> float:
    w = work(yaml)
    return max(w["bytes"] / peaks["hbm_bytes"], w["ops"] / peaks["bf16_flops"])


def read(run):
    if not run.trace or not run.peaks:
        return None
    names = [n for n in run.trace["total_s"] if KERNEL in n]
    launches = sum(run.trace["count"][n] for n in names)
    requests = len(run.traced_entries)
    if not names or not requests or launches != 2 * requests:
        return None
    least = requests * least_seconds(run.yaml, run.peaks)
    return 100.0 * least / sum(run.trace["total_s"][n] for n in names)
