"""Share of its roofline that MvP's projective attention kernel
(`projattn_kernel`, the port's `csrc/projattn.cu`) reaches in the traced
requests: the least time of its work, one launch per decoder layer and
request (`counts/mvp.py`: each tap's 4 corners x Dh channels of bf16 read
once, the offsets and logits in, the output out, at the memory bandwidth;
its operations at the bf16 peak, whichever is longer), over its device
time by kernel name, in %.  Nothing to read where the traced requests
launched it other than once a layer each (a program without the
kernel).  At Panoptic: 72,000 taps, 18.99 MB, 5.67 us a launch."""

from benchmark.counts.mvp import least_seconds, projattn_kernel

KERNEL = "projattn_kernel"


def read(run):
    if not run.trace or not run.peaks or "MVP" not in run.yaml:
        return None
    names = [n for n in run.trace["total_s"] if KERNEL in n]
    launches = sum(run.trace["count"][n] for n in names)
    expected = int(run.yaml["MVP"]["DEC_LAYERS"]) * len(run.traced_entries)
    if not names or not expected or launches != expected:
        return None
    least = expected * least_seconds(projattn_kernel(run.yaml), run.peaks)
    return 100.0 * least / sum(run.trace["total_s"][n] for n in names)
