"""Share of its roofline that WeightNet's front kernel (`weightnet_kernel`,
the port's `csrc/weightnet.cu`) reaches in the traced requests: the
least time of its work, one launch per request, over its device time by
kernel name, in %.  Nothing to read where the traced requests launched
it other than once each (a program without the kernel).

The work of one request, from the published YAML: the JLN's WeightNet
runs on the 3 planes of every one of the K = MAX_PEOPLE slots, M = 3K
maps per joint, J joints, H x W = the crop's x and y voxels, C =
NUM_CHANNEL_JOINT_FEAT channels.  Bytes: the float32 maps in, the M*J*C
means out in bf16 (the dtype the configurations serve).  Operations: per
conv output the 9 multiply-adds and the bias (19), per pooled output the
3 comparisons of the 2x2 max, the ReLU and its add to the mean (5), per
mean its scaling (1), counted at the bf16 tensor-core peak, so that the
share reads the same work whatever implements it."""

KERNEL = "weightnet_kernel"


def work(yaml) -> dict:
    d, c, i = yaml["DATASET"], yaml["CAPTURE_SPEC"], yaml["INDIVIDUAL_SPEC"]
    maps = 3 * c["MAX_PEOPLE"] * d["NUM_JOINTS"]
    H, W = i["VOXELS_PER_AXIS"][0], i["VOXELS_PER_AXIS"][1]
    C = yaml.get("NETWORK", {}).get("NUM_CHANNEL_JOINT_FEAT", 32)
    return {"bytes": 4 * maps * H * W + 2 * maps * C,
            "ops": maps * C * (19 * H * W + 5 * (H // 2) * (W // 2) + 1)}


def read(run):
    if not run.trace or not run.peaks:
        return None
    names = [n for n in run.trace["total_s"] if KERNEL in n]
    launches = sum(run.trace["count"][n] for n in names)
    if not names or launches != len(run.traced_entries):
        return None
    w = work(run.yaml)
    least = max(w["bytes"] / run.peaks["hbm_bytes"], w["ops"] / run.peaks["bf16_flops"])
    return 100.0 * launches * least / sum(run.trace["total_s"][n] for n in names)
