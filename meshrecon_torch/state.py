"""State carried into and out of the fused update, as tensors.

The JAX package passes the update's ten inputs as numpy or jax arrays
(``__graft_entry__._fused_problem``, ``Renderer``); here they become tensors
on an explicit device, with the same dtypes: float32, ``torch.bool`` and
int32.
"""

from __future__ import annotations

import numpy as np
import torch

from meshrecon_torch.raster.binned import morton_order

# order of fused_main_update_batched's positional inputs
INPUT_NAMES = ("soup", "soup_valid", "cam_mains", "frames_main", "side_cams",
               "side_frames", "side_valid", "centers", "centers_valid",
               "n_side")


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int32)
    elif a.dtype != np.bool_:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def from_numpy(args, device) -> tuple:
    """The ten update inputs (numpy arrays, in INPUT_NAMES order) as tensors
    on ``device``: floats float32, bools torch.bool, ints int32."""
    if len(args) != len(INPUT_NAMES):
        raise ValueError(f"expected {len(INPUT_NAMES)} inputs "
                         f"{INPUT_NAMES}, got {len(args)}")
    return tuple(_tensor(a, device) for a in args)


def to_numpy(out: dict) -> dict:
    """Output dict of tensors -> dict of numpy arrays (other values kept)."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def pack_soup(soup: np.ndarray):
    """What ``Renderer.load_mesh`` does to a (T, 3, 3) triangle soup: sort it
    by centroid Morton code (tight chunk bboxes for the binned raster), pad
    it to its capacity class (a power of two, at least 64) and mark the real
    triangles valid. Returns numpy (soup (cap, 3, 3) float32, valid (cap,)
    bool)."""
    soup = np.asarray(soup, dtype=np.float32)
    t = soup.shape[0]
    if t:
        soup = soup[morton_order(soup)]
    cap = max(64, _next_pow2(t))
    padded = np.zeros((cap, 3, 3), dtype=np.float32)
    padded[:t] = soup
    valid = np.zeros(cap, dtype=bool)
    valid[:t] = True
    return padded, valid
