"""Flow-based warping. Port of meshrecon/flow/remap.py :func:`bilinear_warp`,
the plain version of K3 (``flow/tile_warp.py::tile_warp_flow_batched``).
The bicubic re-warp (taps=4) is not ported yet."""

from __future__ import annotations

import torch

from meshrecon_torch.raster.fragment import bilinear_sample


def bilinear_warp(image, flow):
    """out(r, c) = image(c + fx(r, c), r + fy(r, c)), bilinear, clamped.

    image: (..., H, W); flow: (..., H, W, 2) with channels (fx, fy)."""
    h, w = image.shape[-2:]
    cols = torch.arange(w, dtype=torch.float32, device=image.device)[None, :]
    rows = torch.arange(h, dtype=torch.float32, device=image.device)[:, None]
    return bilinear_sample(image.to(torch.float32), cols + flow[..., 0],
                           rows + flow[..., 1])
