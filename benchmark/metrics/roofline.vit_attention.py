"""Share of its roofline that the ViTPose's attention kernel reaches in
the traced requests: the least time of its work (`counts/vitpose.py`:
4 n^2 C operations a view at the bf16 rate, or Q, K, V and O at the
memory bandwidth, whichever is longer), one launch per block and
request, over its device time by kernel name, in %.  Nothing to read
where the trace holds no such kernel, or not a whole number of them per
block and request."""

from benchmark.counts.vitpose import attention_kernel, least_seconds

# the names of `F.scaled_dot_product_attention`'s fused kernels: flash,
# memory-efficient (cutlass fmha), cuDNN
KERNELS = ("flash_fwd", "fmha", "sdpa", "attention")


def read(run):
    if not run.trace or not run.peaks or "VIT" not in run.yaml:
        return None
    names = [n for n in run.trace["total_s"] if any(k in n.lower() for k in KERNELS)]
    blocks = int(run.yaml["VIT"].get("DEPTH", 32)) * len(run.traced_entries)
    launches = sum(run.trace["count"][n] for n in names)
    if not names or not blocks or launches % blocks:
        return None
    spent = sum(run.trace["total_s"][n] for n in names)
    return 100.0 * blocks * least_seconds(attention_kernel(run.yaml), run.peaks) / spent
