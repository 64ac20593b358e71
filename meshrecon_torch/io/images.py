"""PNG dumps with the reference's normalization (port of
meshrecon/io/images.py, util.cpp:482-519).

An image whose channel count is not 1 or 3 is padded or cut to 3 channels,
its first two channels becoming G and R as the reference's mixChannels
{-1,0, 0,1, 1,2} does (util.cpp:492-497); ``normalize`` maps the joint
min..max of all channels to 0..255. Written on the host by cv2, the
port's one image library (the JAX package uses imageio); channels are
RGB, as imageio takes them.
"""

from __future__ import annotations

import cv2
import numpy as np
import torch


def save_image(image, file_name: str, normalize: bool = False) -> None:
    """Write ``image`` (a numpy array or a tensor on any device; (H, W) or
    (H, W, C)) to ``file_name`` as 8-bit PNG."""
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    img = np.asarray(image)
    if img.ndim == 3 and img.shape[2] not in (1, 3):
        out = np.zeros(img.shape[:2] + (3,), dtype=img.dtype)
        n = min(2, img.shape[2])
        out[..., 1: 1 + n] = img[..., :n]
        img = out
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if normalize:
        lo, hi = float(np.min(img)), float(np.max(img))
        if hi > lo:
            img = (img.astype(np.float64) - lo) * 255.0 / (hi - lo)
    img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 3:
        img = np.ascontiguousarray(img[..., ::-1])  # cv2 writes BGR
    if not cv2.imwrite(file_name, img):
        raise OSError(f"cannot write {file_name}")


def read_image(file_name: str) -> np.ndarray:
    """An image file as a numpy array, RGB(A) channels last (as imageio
    reads it)."""
    img = cv2.imread(file_name, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(f"cannot read {file_name}")
    if img.ndim == 3:
        order = [2, 1, 0] + list(range(3, img.shape[2]))
        img = img[..., order]
    return img
