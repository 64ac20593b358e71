"""Horn-Schunck relaxation of one warp linearization: the K4 wrapper.

Port of meshrecon/flow/pallas_jacobi.py::hs_level_fused. The plain version
is ``flow.variational._hs_sweeps_cheb`` (Chebyshev) / ``_hs_sweeps``
(Jacobi). On a CUDA tensor each sweep is one K4 launch
(``csrc/hs_sweep.cu``); the first launch also derives and stores the
linearization (Ix, Iy, cc, 1/denom). The Chebyshev schedule is one global
schedule over all ``iters`` sweeps, never restarted.
"""

from __future__ import annotations

import torch

from meshrecon_torch.kernels._build import Kernel, check_cuda

K4 = Kernel("hs_sweep", "mr_hs_sweep", "meshrecon_torch/csrc/hs_sweep.cu",
            "meshrecon/flow/pallas_jacobi.py:222")


def hs_level_fused(prev, warped, u0, v0, alpha2: float, iters: int = 60,
                   solver: str = "jacobi", rho: float = 0.98):
    """Relax the HS system linearized at (u0, v0); returns (u, v).

    prev broadcasts against warped, u0, v0 (..., H, W) float32 (the solver
    shares one source frame across K targets). solver: "cheb" or "jacobi".
    """
    from meshrecon_torch.flow.variational import (_hs_sweeps,
                                                  _hs_sweeps_cheb,
                                                  cheb_coeffs_f32)

    if solver not in ("cheb", "jacobi"):
        raise ValueError(f"solver must be cheb|jacobi: {solver!r}")
    if not warped.is_cuda:
        if solver == "cheb":
            return _hs_sweeps_cheb(prev, warped, u0, v0, alpha2, iters, rho)
        return _hs_sweeps(prev, warped, u0, v0, alpha2, iters)

    shape = warped.shape
    h, w = shape[-2:]
    n = warped.numel() // (h * w)
    a = prev.expand(shape).contiguous()
    b, u0, v0 = warped.contiguous(), u0.contiguous(), v0.contiguous()
    fields = [torch.empty_like(b) for _ in range(4)]   # ix, iy, cc, 1/denom
    bufs = [torch.empty_like(b) for _ in range(4)]     # u, v ping-pong
    check_cuda("hs_level_fused", a, b, u0, v0, *fields, *bufs)
    if solver == "cheb":
        coeffs = cheb_coeffs_f32(iters, rho)
    else:
        coeffs = [(1.0, 0.0)] * iters
    # state: (u, v) current, (up, vp) previous; the output overwrites the
    # previous iterate in place (each pixel reads only its own previous
    # value), except on the first sweep, whose previous iterate is u0/v0
    u, v, up, vp = u0, v0, u0, v0
    spare_u, spare_v = bufs[0], bufs[1]
    other_u, other_v = bufs[2], bufs[3]
    for k, (a_k, b_k) in enumerate(coeffs):
        if k < 2:
            out_u, out_v = (spare_u, spare_v) if k == 0 else (other_u, other_v)
        else:
            out_u, out_v = up, vp
        K4.launch(a, b, u0, v0, *fields, u, v, up, vp, out_u, out_v,
                  float(a_k), float(b_k), float(alpha2), 1 if k == 0 else 0,
                  n, h, w)
        u, v, up, vp = out_u, out_v, u, v
    return u.reshape(shape), v.reshape(shape)
