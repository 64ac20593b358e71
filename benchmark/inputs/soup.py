"""A recorded mesh as the update renders it: a frozen copy of what the
program's renderer does to the triangle soup it loads (its ``state.
pack_soup``): the triangles sorted by the Morton code of their centroids
(10 bits an axis, numpy float32 centroids, a stable sort), padded with
zeros to a power of two of at least 64, the real ones marked valid."""

from __future__ import annotations

import json

import numpy as np
import torch


def load_soup(path) -> np.ndarray:
    """The (T, 3, 3) float32 triangle soup of a recorded mesh file."""
    with open(path) as f:
        return np.asarray(json.load(f)["soup"], dtype=np.float32)


def morton_order(soup: np.ndarray) -> np.ndarray:
    """The stable permutation that sorts the triangles by the Morton code
    of their centroids."""
    cent = soup.mean(axis=1)
    lo = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo, 1e-12)
    q = np.minimum(((cent - lo) / span * 1023.0).astype(np.uint64), 1023)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    code = (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))
    return np.argsort(code, kind="stable")


def pack_soup(soup: np.ndarray):
    """(soup (cap, 3, 3) float32, valid (cap,) bool), numpy: sorted, padded
    to cap = the next power of two of at least 64."""
    soup = np.asarray(soup, dtype=np.float32)
    t = soup.shape[0]
    if t:
        soup = soup[morton_order(soup)]
    cap = 64
    while cap < t:
        cap *= 2
    padded = np.zeros((cap, 3, 3), dtype=np.float32)
    padded[:t] = soup
    valid = np.zeros(cap, dtype=bool)
    valid[:t] = True
    return padded, valid


def packed_soup(path, device):
    """The recorded mesh packed, as tensors on ``device``."""
    soup, valid = pack_soup(load_soup(path))
    return (torch.from_numpy(soup).to(device),
            torch.from_numpy(valid).to(device))
