"""Device selection and float32 precision settings of the port.

Entry points run on the card unless the caller names another device:
with no device given and no CUDA device present they raise, so that no
run silently falls back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` as a torch.device; None means the current CUDA device and
    raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def pin_float32() -> None:
    """Keep float32 convolutions and matrix products at full float32.

    cuDNN runs float32 convolutions in TF32 by default (about three
    decimal digits); the soft-argmax expectation and the float32 conv
    stacks need full float32, as the JAX package pins
    `Precision.HIGHEST` there."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
