"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peaks_for(kind: str) -> dict:
    """The peaks of the card named `kind`; an unknown card has none, and
    the shares of a peak are then left out."""
    return PEAKS.get(kind, {})
