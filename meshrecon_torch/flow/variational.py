"""Coarse-to-fine variational (Horn-Schunck) dense optical flow.

Port of meshrecon/flow/variational.py. At each pyramid level (coarse to
fine): warp ``next`` by the upsampled flow (bilinear, K3), linearize
around that flow, and relax the Horn-Schunck system with Chebyshev- or
Jacobi-weighted sweeps (K4), or solve it by multigrid cycles
(``solver="mg"``, ``flow/multigrid.py``, torch ops).
:func:`_hs_sweeps` and :func:`_hs_sweeps_cheb` are the plain versions of
K4.

On a CUDA tensor every level goes through the kernels; the JAX package's
TPU size floors for its Pallas paths are not ported.
"""

from __future__ import annotations

import torch

from meshrecon_torch.flow.jacobi import hs_level_fused
from meshrecon_torch.flow.pyramid import pyr_down, pyr_up
from meshrecon_torch.flow.tile_warp import tile_warp_flow_batched


def _pad_hw(u):
    """Edge (clamp) pad of the last two axes by one."""
    h, w = u.shape[-2:]
    ri = torch.arange(-1, h + 1, device=u.device).clamp(0, h - 1)
    ci = torch.arange(-1, w + 1, device=u.device).clamp(0, w - 1)
    return u.index_select(u.dim() - 2, ri).index_select(u.dim() - 1, ci)


def _hs_average(u):
    """Horn-Schunck neighbourhood average: 4-neighbours 1/6, diagonals
    1/12, over the last two axes."""
    p = _pad_hw(u)
    s4 = (p[..., :-2, 1:-1] + p[..., 2:, 1:-1]
          + p[..., 1:-1, :-2] + p[..., 1:-1, 2:])
    s8 = (p[..., :-2, :-2] + p[..., :-2, 2:]
          + p[..., 2:, :-2] + p[..., 2:, 2:])
    return s4 / 6.0 + s8 / 12.0


def _gradients(a, b):
    """Spatial gradients of the temporal average (central differences)."""
    m = 0.5 * (a + b)
    p = _pad_hw(m)
    ix = (p[..., 1:-1, 2:] - p[..., 1:-1, :-2]) * 0.5
    iy = (p[..., 2:, 1:-1] - p[..., :-2, 1:-1]) * 0.5
    return ix, iy


def _hs_sweeps(prev, warped, u0, v0, alpha2, iters):
    """Plain Jacobi relaxation given the warped image (linearized at
    (u0, v0))."""
    ix, iy = _gradients(prev, warped)
    it = warped - prev
    denom = alpha2 + ix * ix + iy * iy
    u, v = u0, v0
    for _ in range(iters):
        ub = _hs_average(u)
        vb = _hs_average(v)
        num = (ix * (ub - u0) + iy * (vb - v0) + it) / denom
        u, v = ub - ix * num, vb - iy * num
    return u, v


def cheb_coeffs(iters: int, rho: float):
    """Chebyshev semi-iteration coefficients (a_k, b_k) for ``iters`` steps
    (Python floats; see meshrecon/flow/variational.py for the theory)."""
    mus = [1.0, 1.0 / rho]
    ab = [(1.0, 0.0)]
    for k in range(1, iters):
        mu_next = 2.0 / rho * mus[k] - mus[k - 1]
        ab.append((2.0 * mus[k] / (rho * mu_next), -mus[k - 1] / mu_next))
        mus.append(mu_next)
    return ab


def cheb_coeffs_f32(iters: int, rho: float):
    """(a_k, b_k) rounded to float32, as Python floats."""
    t = torch.tensor(cheb_coeffs(iters, rho), dtype=torch.float32)
    return [tuple(row) for row in t.tolist()]


def _hs_sweeps_cheb(prev, warped, u0, v0, alpha2, iters, rho: float = 0.98):
    """Chebyshev-accelerated Jacobi relaxation, one global schedule; same
    fixed point as :func:`_hs_sweeps`."""
    ix, iy = _gradients(prev, warped)
    it = warped - prev
    denom = alpha2 + ix * ix + iy * iy

    def jac(u, v):
        ub = _hs_average(u)
        vb = _hs_average(v)
        num = (ix * (ub - u0) + iy * (vb - v0) + it) / denom
        return ub - ix * num, vb - iy * num

    u, v, up, vp = u0, v0, u0, v0
    for a_k, b_k in cheb_coeffs_f32(iters, rho):
        yu, yv = jac(u, v)
        un = a_k * yu + b_k * up
        vn = a_k * yv + b_k * vp
        u, v, up, vp = un, vn, u, v
    return u, v


def _hs_level(prev, next_, u0, v0, alpha2, iters, solver: str = "cheb",
              rho: float = 0.98, cycles: int = 2):
    """One warp iteration: warp ``next_`` by (u0, v0) (K3), linearize
    there and relax the total flow (K4), or solve it by ``cycles``
    multigrid cycles (solver "mg"). Returns (u, v, warped)."""
    if solver not in ("cheb", "jacobi", "mg"):
        raise ValueError(f"solver must be cheb|jacobi|mg: {solver!r}")
    warped = tile_warp_flow_batched(next_.contiguous(), u0.contiguous(),
                                    v0.contiguous())
    if solver == "mg":
        from meshrecon_torch.flow.multigrid import hs_solve_mg

        u, v = hs_solve_mg(prev, warped, u0, v0, alpha2, cycles=cycles)
    else:
        u, v = hs_level_fused(prev, warped, u0, v0, alpha2, iters=iters,
                              solver=solver, rho=rho)
    return u, v, warped


def variational_flow(prev, next_, levels: int = 6, iters: int | None = None,
                     warps: int = 2, alpha: float = 12.0, min_size: int = 12,
                     solver: str = "cheb", want_residual: bool = False,
                     rho: float = 0.98, fine_warps: int = 1,
                     cycles: int = 2):
    """Dense flow prev -> next: next(x + flow(x)) ~= prev(x).

    prev: (..., H, W) grayscale float (0..255 scale), broadcasting against
    next_: (..., H, W), e.g. (B, 1, H, W) against (B, K, H, W). Returns
    flow (..., H, W, 2) float32 (fx, fy) in pixels of next_'s shape, and
    with ``want_residual`` also the first-order re-warped image
    ``warped + Ix*(u - u0) + Iy*(v - v0)`` through the finest level's
    linearization.

    The finest level runs ``fine_warps`` warps (default one); coarser
    levels run ``warps``.
    iters defaults to 14 Chebyshev sweeps (schedule parameter ``rho``) or
    60 Jacobi sweeps; solver "mg" runs ``cycles`` multigrid cycles per
    warp instead and ignores ``iters``.
    """
    if iters is None:
        iters = 14 if solver == "cheb" else 60
    prev = prev.to(torch.float32)
    next_ = next_.to(torch.float32)
    alpha2 = float(alpha * alpha)

    pyr_a = [prev]
    pyr_b = [next_]
    for _ in range(levels - 1):
        if min(pyr_a[-1].shape[-2:]) <= min_size:
            break
        pyr_a.append(pyr_down(pyr_a[-1]))
        pyr_b.append(pyr_down(pyr_b[-1]))

    u = torch.zeros_like(pyr_b[-1])
    v = torch.zeros_like(pyr_b[-1])
    for lvl in range(len(pyr_a) - 1, -1, -1):
        a, b = pyr_a[lvl], pyr_b[lvl]
        if u.shape[-2:] != a.shape[-2:]:
            # flow values double at 2x resolution
            u = pyr_up(u, a.shape[-2:]) * 2.0
            v = pyr_up(v, a.shape[-2:]) * 2.0
        n_warps = fine_warps if lvl == 0 else warps
        for _ in range(n_warps):
            u_lin, v_lin = u, v
            u, v, warped = _hs_level(a, b, u, v, alpha2, iters,
                                     solver=solver, rho=rho, cycles=cycles)
    flow = torch.stack([u, v], dim=-1)
    if not want_residual:
        return flow
    ix, iy = _gradients(pyr_a[0], warped)
    rewarped = warped + ix * (u - u_lin) + iy * (v - v_lin)
    return flow, rewarped
