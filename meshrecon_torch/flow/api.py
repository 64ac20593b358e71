"""Public flow entry point with the reference's calculateFlow contract.

Port of meshrecon/flow/api.py. calculateFlow (flow.cpp:19-42) returns a
4-channel field per pixel, (fx, fy, variance, 0), where the variance is
the pyramid-summed L1 error between ``prev`` and ``next`` warped by the
flow through the bicubic re-warp (K3b on a CUDA tensor, its plain version
``remap.flow_remap`` on the CPU). ``use_farneback`` mirrors the ``-f`` CLI
flag (configuration.cpp:94-96).
"""

from __future__ import annotations

import torch

from meshrecon_torch.flow.pyramid import compare
from meshrecon_torch.flow.tile_warp import tile_warp_flow_batched
from meshrecon_torch.flow.variational import variational_flow


def farneback_params(height: int, width: int) -> dict:
    """The size-dependent Farneback parameters of the reference
    (flow.cpp:24-26): winsize (h+w)/100, poly_sigma (h+w)/1000, poly_n 5
    if sigma < 1.5 else 7, with the JAX package's floors."""
    poly_sigma = max((height + width) / 1000.0, 0.7)
    return dict(poly_n=5 if poly_sigma < 1.5 else 7, poly_sigma=poly_sigma,
                winsize=int(max((height + width) // 100, 5)))


def calculate_flow(prev, next_, use_farneback: bool = False,
                   levels: int = 2, warps: int = 1, iters: int | None = None,
                   solver: str = "cheb", fine_warps: int = 1):
    """Dense flow + per-pixel variance; returns (..., H, W, 4) float32.

    prev: the real frame, broadcasting against next_ (..., H, W), the
    reprojected prediction. Convention: ``next(x + flow(x)) ~= prev(x)``.
    The variational flow's knobs default to the pipeline's 2-level
    single-warp pyramid (the flow update's); Farneback ignores them.
    """
    prev = prev.to(torch.float32)
    next_ = next_.to(torch.float32)
    if use_farneback:
        from meshrecon_torch.flow.farneback import farneback_flow

        flow = farneback_flow(prev, next_,
                              **farneback_params(*prev.shape[-2:]))
    else:
        flow = variational_flow(prev, next_, levels=levels, warps=warps,
                                iters=iters, solver=solver,
                                fine_warps=fine_warps)
    shape = flow.shape[:-1]
    rewarped = tile_warp_flow_batched(
        next_.expand(shape).contiguous(), flow[..., 0].contiguous(),
        flow[..., 1].contiguous(), taps=4)
    variance = compare(prev, rewarped)
    return torch.cat([flow, variance[..., None],
                      torch.zeros_like(variance)[..., None]], dim=-1)
