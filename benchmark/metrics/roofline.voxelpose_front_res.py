"""Share of its roofline that the head of VoxelPose's `front_res` block
(`front_res3d_kernel`, the port's `csrc/front_res3d.cu`) reaches in the
traced requests: the least time of its work, two launches per request
(the CPN's block and the PRN's), over its device time by kernel name, in
%.  Nothing to read where the traced requests launched it other than
twice each (a program without the kernel).

The work of one request, from the published YAML: the block's 3x3x3
conv1 and its 1x1x1 skip, each from the 16 channels of the V2VNet's front
to 32, over the CPN's whole space (X * Y * Z voxels) and the PRN's K =
MAX_PEOPLE cubes.  Bytes: the 16 bf16 channels in and the two 32-channel
bf16 outputs out, (2 * 16 + 4 * 32) a voxel; operations: 2 * 32 * 16 *
(27 + 1) a voxel at the bf16 peak, so that the share reads the same work
whatever implements it.  The bytes bound it: 439.9 MB, 0.1313 ms, at
Panoptic."""

KERNEL = "front_res3d_kernel"
CIN, COUT, TAPS = 16, 32, 3 ** 3 + 1


def work(yaml) -> dict:
    c, i = yaml["CAPTURE_SPEC"], yaml["INDIVIDUAL_SPEC"]
    K = int(c["MAX_PEOPLE"])
    X, Y, Z = c["VOXELS_PER_AXIS"]
    x, y, z = i["VOXELS_PER_AXIS"]
    voxels = X * Y * Z + K * x * y * z
    return {"bytes": (2 * CIN + 4 * COUT) * voxels, "ops": 2 * COUT * CIN * TAPS * voxels}


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
