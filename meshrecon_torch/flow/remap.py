"""Flow-based warping. Port of meshrecon/flow/remap.py.

:func:`bilinear_warp` is the plain version of K3
(``flow/tile_warp.py::tile_warp_flow_batched`` with taps=2, the flow
solver's warps). :func:`flow_remap` is the plain version of K3b (taps=4):
the reference's remap-then-compare re-warp (util.cpp:390-403, cv::remap
with CV_INTER_CUBIC), a Keys bicubic kernel with a = -0.75 over 4x4 taps,
each tap index clamped to the border.
"""

from __future__ import annotations

import torch

from meshrecon_torch.raster.fragment import _gather, _index, bilinear_sample


def _rows(flow, row0: int):
    """The global rows of a flow field's rows, (hb, 1) float32."""
    hb = flow.shape[-3]
    return torch.arange(row0, row0 + hb, dtype=torch.float32,
                        device=flow.device)[:, None]


def bilinear_warp(image, flow, *, row0: int = 0, height=None,
                  src_row0: int = 0):
    """out(r, c) = image(c + fx(r, c), r + fy(r, c)), bilinear, clamped.

    image: (..., H, W); flow: (..., H, W, 2) with channels (fx, fy). A band
    (``sharding/tiles.py``): flow holds rows [row0, row0 + hb) of an image
    of ``height`` rows and ``image`` its rows [src_row0, src_row0 + hs),
    every tap the samples read; out is (..., hb, W)."""
    w = image.shape[-1]
    cols = torch.arange(w, dtype=torch.float32, device=image.device)[None, :]
    return bilinear_sample(image.to(torch.float32), cols + flow[..., 0],
                           _rows(flow, row0) + flow[..., 1], height=height,
                           src_row0=src_row0)


def _cubic_weights(t, a=-0.75):
    """Four kernel weights for the fractional offset t in [0, 1): taps at
    -1, 0, 1, 2 (polynomials in t, as the XLA twin writes them)."""
    t2 = t * t
    t3 = t2 * t
    w0 = a * (t3 - 2 * t2 + t)
    w1 = (a + 2) * t3 - (a + 3) * t2 + 1
    w2 = -(a + 2) * t3 + (2 * a + 3) * t2 - a * t
    w3 = a * (t2 - t3)
    return w0, w1, w2, w3


def bicubic_sample(image, col, row, *, height=None, src_row0: int = 0):
    """Bicubic sample of image (..., H, W) at continuous (col, row) of the
    same leading shape; every tap index clamped to the border. Sums run
    over the columns j inside the rows i, as in the XLA twin. ``height``
    and ``src_row0`` as for ``fragment.bilinear_sample``: the image may
    hold some rows of a taller one."""
    h, w = image.shape[-2:]
    h = h if height is None else height
    c0 = _index(torch.floor(col))
    r0 = _index(torch.floor(row))
    wc = _cubic_weights(col - c0)
    wr = _cubic_weights(row - r0)
    out = torch.zeros_like(col)
    for i in range(4):
        ri = (r0 + (i - 1)).clamp(0, h - 1)
        if src_row0:
            ri = ri - src_row0
        row_acc = torch.zeros_like(col)
        for j in range(4):
            cj = (c0 + (j - 1)).clamp(0, w - 1)
            row_acc = row_acc + wc[j] * _gather(image, ri, cj)
        out = out + wr[i] * row_acc
    return out


def bicubic_remap(image, map_col, map_row, **band):
    return bicubic_sample(image.to(torch.float32), map_col, map_row, **band)


def flow_remap(flow, image, *, row0: int = 0, height=None,
               src_row0: int = 0):
    """Warp ``image`` by ``flow``: out(r, c) = image(c + fx, r + fy),
    bicubic. flow: (..., H, W, >=2) with channels (fx, fy, ...); image:
    (..., H, W). Mirrors util.cpp:390-403. A band as for
    :func:`bilinear_warp`."""
    flow = flow.to(torch.float32)
    w = flow.shape[-2]
    cols = torch.arange(w, dtype=torch.float32, device=flow.device)[None, :]
    return bicubic_remap(image, cols + flow[..., 0],
                         _rows(flow, row0) + flow[..., 1], height=height,
                         src_row0=src_row0)
