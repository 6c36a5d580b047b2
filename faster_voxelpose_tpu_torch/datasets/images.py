"""Image normalisation for the backbone (counterpart of
`faster_voxelpose_tpu/datasets/images.py`, reference run/train.py:60-66:
ToTensor then ImageNet Normalize), channels last.

`normalize_images_device` runs on the tensor's device, so that frames
travel to the card as uint8; `normalize_image` and `denormalize_images`
are the host's numpy forms.  The file loaders of the JAX package
(`load_view_images`, `load_view_images_u8`) decode with cv2 and are not
ported here.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_images_device(images: torch.Tensor, color_rgb: bool = True) -> torch.Tensor:
    """uint8 (..., 3) BGR frames, as decoded -> ImageNet-normalised
    float32 on the same device, channels reversed to RGB when
    `color_rgb`."""
    if color_rgb:
        images = images.flip(-1)
    x = images.to(torch.float32) * (1.0 / 255.0)
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8 HWC RGB -> float32 HWC, ImageNet-normalised."""
    return (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def denormalize_images(imgs: np.ndarray) -> np.ndarray:
    """The inverse of `normalize_image` for viewing: float32
    (..., H, W, 3) -> uint8 frames."""
    out = (imgs * IMAGENET_STD + IMAGENET_MEAN) * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)
