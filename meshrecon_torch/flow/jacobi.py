"""Horn-Schunck relaxation: the K4 and K6 wrappers.

Port of meshrecon/flow/pallas_jacobi.py.

- :func:`hs_level_fused` (K4) relaxes one warp linearization. The plain
  version is ``flow.variational._hs_sweeps_cheb`` (Chebyshev) /
  ``_hs_sweeps`` (Jacobi). On a CUDA tensor each sweep is one K4 launch
  (``csrc/hs_sweep.cu``); the first launch also derives and stores the
  linearization (Ix, Iy, cc, 1/denom). The Chebyshev schedule is one
  global schedule over all ``iters`` sweeps, never restarted.
- :func:`hs_jacobi` (K6) runs plain Jacobi sweeps given the fields
  (Ix, Iy, c): the fixed-point reference of the multigrid solver. The
  plain version is :func:`hs_jacobi_plain`. On a CUDA tensor each sweep is
  one K6 launch; the first also stores 1/denom.
"""

from __future__ import annotations

import torch

from meshrecon_torch.kernels._build import Kernel, check_cuda

K4 = Kernel("hs_sweep", "mr_hs_sweep", "meshrecon_torch/csrc/hs_sweep.cu",
            "meshrecon/flow/pallas_jacobi.py:222")
K6 = Kernel("hs_jacobi_fields", "mr_hs_jacobi_fields",
            "meshrecon_torch/csrc/hs_sweep.cu",
            "meshrecon/flow/pallas_jacobi.py:44")


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


def hs_jacobi_plain(ix, iy, c, u0, v0, alpha2: float, iters: int = 60):
    """``iters`` plain Jacobi sweeps of the HS system given (ix, iy, c),
    c = It - Ix*u0 - Iy*v0 (the fields form of
    ``variational._hs_sweeps``, edge-clamped borders); returns (u, v)."""
    from meshrecon_torch.flow.variational import _hs_average

    invd = 1.0 / (alpha2 + ix * ix + iy * iy)
    u, v = u0, v0
    for _ in range(iters):
        ub = _hs_average(u)
        vb = _hs_average(v)
        num = (ix * ub + iy * vb + c) * invd
        u, v = ub - ix * num, vb - iy * num
    return u, v


def hs_jacobi(ix, iy, c, u0, v0, alpha2: float, iters: int = 60):
    """Run ``iters`` Horn-Schunck Jacobi sweeps given the fields; returns
    (u, v). ix, iy, c, u0, v0: (..., H, W) float32 of one shape."""
    if not ix.is_cuda:
        return hs_jacobi_plain(ix, iy, c, u0, v0, alpha2, iters)
    shape = ix.shape
    for t in (iy, c, u0, v0):
        if t.shape != shape:
            raise ValueError(f"shape {tuple(t.shape)} != {tuple(shape)}")
    h, w = shape[-2:]
    n = ix.numel() // (h * w)
    ix, iy, c = ix.contiguous(), iy.contiguous(), c.contiguous()
    u, v = u0.contiguous(), v0.contiguous()
    invd = torch.empty_like(ix)
    bufs = [torch.empty_like(ix) for _ in range(4)]  # (u, v) ping-pong
    check_cuda("hs_jacobi", ix, iy, c, u, v, invd, *bufs)
    if iters == 0:
        return u.clone(), v.clone()
    for k in range(iters):
        out_u, out_v = bufs[0:2] if k % 2 == 0 else bufs[2:4]
        K6.launch(ix, iy, c, invd, u, v, out_u, out_v, float(alpha2),
                  1 if k == 0 else 0, n, h, w)
        u, v = out_u, out_v
    return u, v
