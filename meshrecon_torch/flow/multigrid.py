"""Linear multigrid solver for the Horn-Schunck linearized flow system.

Port of meshrecon/flow/multigrid.py (``--flow-solver mg``). Each warp
linearization is solved by truncated W-cycles: a few coupled Jacobi sweeps
per level, the residual restricted by the 5-tap pyramid (``pyr_down``),
the error equation solved on the coarser grid with alpha^2 / 4 per level
(the rediscretization rule of ``h^2 * Laplacian``), the correction
prolonged back (``pyr_up``). The fine level uses exactly the operator of
``variational._hs_sweeps``, so the cycles converge to the Jacobi path's
fixed point; ``flow.jacobi.hs_jacobi`` (K6) is the reference of that
fixed point on the card.

System (per pixel, ``avg`` the 1/6-1/12 HS neighbourhood average):

    (alpha2 + ixx + iyy) * u - (alpha2 + iyy) * avg(u) + ixy * avg(v) = bu
    (alpha2 + ixx + iyy) * v - (alpha2 + ixx) * avg(v) + ixy * avg(u) = bv

with ixx = Ix^2, iyy = Iy^2, ixy = Ix*Iy, bu = -Ix*c, bv = -Iy*c and
c = It - Ix*u0 - Iy*v0. Every op is an elementwise torch op or a pyramid
filter written as shifted adds; the JAX package has no kernel here either.
Tensors broadcast over leading axes: prev (B, 1, H, W) against warped
(B, K, H, W) solves all B*K systems at once.
"""

from __future__ import annotations

import torch

from meshrecon_torch.flow.pyramid import pyr_down, pyr_up
from meshrecon_torch.flow.variational import _hs_average, _pad_hw

# cycle shape (meshrecon/flow/multigrid.py:67-72): sweeps before and after
# the coarse-grid correction, recursive visits per level (GAMMA at the top
# GAMMA_DEPTH levels: a truncated W-cycle), coarsest-level sweeps, and the
# size at which the recursion stops
NU_PRE = 2
NU_POST = 2
GAMMA = 2
GAMMA_DEPTH = 2
COARSE_SWEEPS = 24
COARSE_SIZE = 8


def _smooth(u, v, au, av, axy, bu, bv, iters):
    """``iters`` coupled Jacobi sweeps with premultiplied coefficients:
    au = (alpha2+iyy)/denom, av = (alpha2+ixx)/denom, axy = ixy/denom,
    bu/bv already divided by denom."""
    for _ in range(iters):
        ub = _hs_average(u)
        vb = _hs_average(v)
        u, v = au * ub - axy * vb + bu, av * vb - axy * ub + bv
    return u, v


def _level_coeffs(ixx, iyy, ixy, alpha2):
    denom = alpha2 + ixx + iyy
    inv = 1.0 / denom
    return (alpha2 + iyy) * inv, (alpha2 + ixx) * inv, ixy * inv, denom


def _residual(u, v, ixx, iyy, ixy, denom, bu, bv, alpha2):
    ub = _hs_average(u)
    vb = _hs_average(v)
    r_u = bu - (denom * u - (alpha2 + iyy) * ub + ixy * vb)
    r_v = bv - (denom * v - (alpha2 + ixx) * vb + ixy * ub)
    return r_u, r_v


def _build_hierarchy(ixx, iyy, ixy, alpha2):
    """Per-level coefficient fields (restricted) and the premultiplied
    smoother coefficients, shared by all cycles."""
    levels = []
    a2 = alpha2
    while True:
        au, av, axy_n, denom = _level_coeffs(ixx, iyy, ixy, a2)
        levels.append(dict(ixx=ixx, iyy=iyy, ixy=ixy, denom=denom,
                           au=au, av=av, axy=axy_n, inv=1.0 / denom,
                           alpha2=a2, shape=ixx.shape[-2:]))
        if min(ixx.shape[-2:]) <= COARSE_SIZE:
            break
        ixx = pyr_down(ixx)
        iyy = pyr_down(iyy)
        ixy = pyr_down(ixy)
        a2 = a2 * 0.25
    return levels


def _vcycle(lvl, levels, u, v, bu, bv):
    L = levels[lvl]
    bu_n = bu * L["inv"]
    bv_n = bv * L["inv"]
    if lvl == len(levels) - 1:
        return _smooth(u, v, L["au"], L["av"], L["axy"], bu_n, bv_n,
                       COARSE_SWEEPS)
    u, v = _smooth(u, v, L["au"], L["av"], L["axy"], bu_n, bv_n, NU_PRE)
    r_u, r_v = _residual(u, v, L["ixx"], L["iyy"], L["ixy"], L["denom"],
                         bu, bv, L["alpha2"])
    r_uc = pyr_down(r_u)
    r_vc = pyr_down(r_v)
    e_u = torch.zeros_like(r_uc)
    e_v = torch.zeros_like(r_vc)
    for _ in range(GAMMA if lvl < GAMMA_DEPTH else 1):
        e_u, e_v = _vcycle(lvl + 1, levels, e_u, e_v, r_uc, r_vc)
    u = u + pyr_up(e_u, L["shape"])
    v = v + pyr_up(e_v, L["shape"])
    return _smooth(u, v, L["au"], L["av"], L["axy"], bu_n, bv_n, NU_POST)


def hs_solve_mg(prev, warped, u0, v0, alpha2, cycles: int = 2):
    """Multigrid solve of the HS linearization at (u0, v0); returns (u, v).

    The same operator, edge-clamped boundary and warp-anchored data term as
    ``variational._hs_sweeps``. prev broadcasts against warped, u0, v0
    (..., H, W) float32.
    """
    ix, iy, c = hs_fields(prev, warped, u0, v0)
    return hs_solve_mg_fields(ix, iy, c, u0, v0, alpha2, cycles=cycles)


def hs_fields(prev, warped, u0, v0):
    """The linearization's fields (Ix, Iy, c) at (u0, v0): central
    differences of the mean image (edge-clamped), c = It - Ix*u0 - Iy*v0.
    The input of :func:`hs_solve_mg_fields` and of ``jacobi.hs_jacobi``."""
    m = 0.5 * (prev + warped)
    p = _pad_hw(m)
    ix = (p[..., 1:-1, 2:] - p[..., 1:-1, :-2]) * 0.5
    iy = (p[..., 2:, 1:-1] - p[..., :-2, 1:-1]) * 0.5
    it = warped - prev
    return ix, iy, it - ix * u0 - iy * v0


def hs_solve_mg_fields(ix, iy, c, u0, v0, alpha2, cycles: int = 2):
    """Multigrid solve given (ix, iy, c); see :func:`hs_solve_mg`."""
    ixx = ix * ix
    iyy = iy * iy
    ixy = ix * iy
    bu = -ix * c
    bv = -iy * c
    levels = _build_hierarchy(ixx, iyy, ixy, alpha2)
    u, v = u0, v0
    for _ in range(cycles):
        u, v = _vcycle(0, levels, u, v, bu, bv)
    return u, v
