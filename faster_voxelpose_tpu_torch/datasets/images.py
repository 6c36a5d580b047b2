"""Image normalisation for the backbone (counterpart of
`faster_voxelpose_tpu/datasets/images.py`, reference run/train.py:60-66:
ToTensor then ImageNet Normalize), channels last.

`normalize_images_device` runs on the tensor's device, so that frames
travel to the card as uint8; `normalize_image` and `denormalize_images`
are the host's numpy forms.  `load_view_images_u8` decodes a frame's
files with cv2, as the JAX package does; `load_view_images`, which
normalises on the host with the native warp, is not ported here.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_images_device(images: torch.Tensor, color_rgb: bool = True,
                            mean: Optional[torch.Tensor] = None,
                            std: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uint8 (..., 3) BGR frames, as decoded -> ImageNet-normalised
    float32 on the same device, channels reversed to RGB when
    `color_rgb`.  `mean` and `std` are IMAGENET_MEAN and IMAGENET_STD as
    tensors on that device (a backbone's buffers); without them they are
    copied from the host for this call."""
    if color_rgb:
        images = images.flip(-1)
    x = images.to(torch.float32) * (1.0 / 255.0)
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device) if mean is None else mean
    std = torch.as_tensor(IMAGENET_STD, device=x.device) if std is None else std
    return (x - mean) / std


def load_view_images_u8(paths: List[str], image_size,
                        resize_transform: Optional[np.ndarray] = None) -> np.ndarray:
    """One image file per view -> (V, H, W, 3) uint8 frames, BGR as
    decoded, each warped to image_size (W, H) by the 2x3
    `resize_transform` where it is not at that size already (counterpart
    of `load_view_images_u8`, faster_voxelpose_tpu/datasets/images.py:68-100).
    Decodes with cv2 and with nothing else: without cv2 it raises
    ImportError."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("load_view_images_u8 decodes images with cv2 (OpenCV), which "
                          "is not installed") from e

    W, H = int(image_size[0]), int(image_size[1])
    views = []
    for p in paths:
        img = cv2.imread(p, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        if img is None:
            raise FileNotFoundError(p)
        if img.shape[1] != W or img.shape[0] != H:
            if resize_transform is None:
                raise ValueError(f"image {p} is {img.shape[1]}x{img.shape[0]}, expected {W}x{H}; "
                                 "pass resize_transform for on-the-fly warping")
            img = cv2.warpAffine(img, resize_transform.astype(np.float32), (W, H),
                                 flags=cv2.INTER_LINEAR)
        views.append(np.ascontiguousarray(img))
    return np.stack(views, axis=0)


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8 HWC RGB -> float32 HWC, ImageNet-normalised."""
    return (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def denormalize_images(imgs: np.ndarray) -> np.ndarray:
    """The inverse of `normalize_image` for viewing: float32
    (..., H, W, 3) -> uint8 frames."""
    out = (imgs * IMAGENET_STD + IMAGENET_MEAN) * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)
