"""Rounding of the convolution operands in the reference.

The reference computes in float32 with TF32 off.  Its control runs the
same arithmetic with every convolution, transposed convolution and
dense layer fed operands rounded to fp8 (e4m3, per-tensor scaled: the
tensor's largest magnitude maps to 448), one step below the bf16 that
the configurations state for the conv stacks; sums stay in float32.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
MODES = ("float32", "fp8")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to per-tensor scaled e4m3 and back to float32."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def operand_rounding(mode: str):
    """The function applied to every operand of a conv, deconv or dense
    layer under `mode`."""
    if mode == "float32":
        return lambda x: x
    if mode == "fp8":
        return fp8_round
    raise ValueError(f"unknown precision {mode!r}; known: {MODES}")


def pin_float32() -> None:
    """Full float32 in cuDNN and cuBLAS (no TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
