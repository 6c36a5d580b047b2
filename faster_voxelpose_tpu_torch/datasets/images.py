"""Image loading and normalisation for the backbone (counterpart of
`faster_voxelpose_tpu/datasets/images.py`, reference run/train.py:60-66:
ToTensor then ImageNet Normalize), channels last.

- `load_view_images_u8`: a frame's files decoded with cv2 and warped to
  the network's input size, uint8 BGR, as the 'image' source ships them;
  `normalize_images_device` normalises them on the tensor's device.
- `load_view_images`: the same frames normalised on the host, float32,
  through `preprocess_view_native` (cv2's warp, then the native fused
  normalisation and channel swap of `native/warp.cpp`).  The native
  code is built at first use; a failed build raises (the JAX package
  falls back to a numpy chain instead).
- `normalize_image` and `denormalize_images`: the host's numpy forms.
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


def load_view_images(paths: List[str], image_size,
                     resize_transform: Optional[np.ndarray] = None,
                     color_rgb: bool = True) -> np.ndarray:
    """One image file per view -> (V, H, W, 3) float32, ImageNet-
    normalised, RGB when `color_rgb`, each warped to image_size (W, H) by
    the 2x3 `resize_transform` where it is not at that size already
    (preprocessed datasets skip the warp, as reference preprocess.py)."""
    import cv2

    W, H = int(image_size[0]), int(image_size[1])
    views = []
    for p in paths:
        img = cv2.imread(p, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        if img is None:
            raise FileNotFoundError(p)
        if (img.shape[1] != W or img.shape[0] != H) and resize_transform is None:
            raise ValueError(f"image {p} is {img.shape[1]}x{img.shape[0]}, expected {W}x{H}; "
                             "pass resize_transform for on-the-fly warping")
        views.append(preprocess_view_native(img, (W, H), resize_transform, color_rgb))
    return np.stack(views, axis=0)


def preprocess_view_native(img: np.ndarray, image_size,
                           resize_transform: Optional[np.ndarray],
                           color_rgb: bool) -> np.ndarray:
    """A decoded uint8 HWC BGR frame -> (H, W, 3) float32 normalised:
    cv2's fixed-point bilinear warpAffine on the BGR frame where it is not
    at image_size (W, H) (the warp commutes with the channel swap), then
    the native fused normalisation and swap (`native/warp.cpp`
    normalize_u8).  `native.build.warp_normalize_native` is the fully
    native single pass, for callers without cv2."""
    from ..native.build import normalize_u8_native

    W, H = int(image_size[0]), int(image_size[1])
    if img.shape[1] != W or img.shape[0] != H:
        import cv2

        img = cv2.warpAffine(img, resize_transform.astype(np.float32), (W, H),
                             flags=cv2.INTER_LINEAR)
    return normalize_u8_native(img, IMAGENET_MEAN, IMAGENET_STD, color_rgb)


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8 HWC RGB -> float32 HWC, ImageNet-normalised."""
    return (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def denormalize_images(imgs: np.ndarray) -> np.ndarray:
    """The inverse of `normalize_image` for viewing: float32
    (..., H, W, 3) -> uint8 frames."""
    out = (imgs * IMAGENET_STD + IMAGENET_MEAN) * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)
