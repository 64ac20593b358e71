"""Horn-Schunck relaxation: the K4 and K6 wrappers.

Port of meshrecon/flow/pallas_jacobi.py.

- :func:`hs_level_fused` (K4) relaxes one warp linearization. The plain
  version is ``flow.variational._hs_sweeps_cheb`` (Chebyshev) /
  ``_hs_sweeps`` (Jacobi). On a CUDA tensor one K4 launch
  (``csrc/hs_sweep.cu``) derives the linearization (Ix, Iy, cc, 1/denom)
  and runs up to :data:`MAX_SWEEPS_PER_LAUNCH` sweeps in shared memory, so
  the update's 14 Chebyshev sweeps are one launch a pyramid level; more
  sweeps split into the fewest launches, which carry the state through
  device memory. The Chebyshev schedule is one global schedule over all
  ``iters`` sweeps, never restarted.
- :func:`hs_jacobi` (K6) runs plain Jacobi sweeps given the fields
  (Ix, Iy, c): the fixed-point reference of the multigrid solver. The
  plain version is :func:`hs_jacobi_plain`. On a CUDA tensor each K6
  launch runs :data:`K6_SWEEPS_PER_LAUNCH` sweeps (the last fewer).

Both take a private ``_sweeps_per_launch``: 1 runs one sweep a launch, the
schedule before the kernel was blocked, which the tests and
``chip_smoke.py`` compare it with bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from meshrecon_torch.kernels._build import Kernel, check_cuda, library

K4 = Kernel("hs_sweep", "mr_hs_sweep", "meshrecon_torch/csrc/hs_sweep.cu",
            "meshrecon/flow/pallas_jacobi.py:222")
K6 = Kernel("hs_jacobi_fields", "mr_hs_jacobi_fields",
            "meshrecon_torch/csrc/hs_sweep.cu",
            "meshrecon/flow/pallas_jacobi.py:44")

MAX_SWEEPS_PER_LAUNCH = 24  # kMaxSweeps in csrc/hs_sweep.cu
# K6's sweeps a launch: the fastest of those timed by chip_smoke.py's K6
# phase at 12x480x640, 60 sweeps (PERF.md)
K6_SWEEPS_PER_LAUNCH = 10


def chunk_sizes(iters: int, per_launch: int) -> list[int]:
    """Sweeps of each launch: ``iters`` in ceil(iters / per_launch) near-
    equal parts (the larger first), each at most ``per_launch``."""
    if not 1 <= per_launch <= MAX_SWEEPS_PER_LAUNCH:
        raise ValueError(f"sweeps a launch must be 1-{MAX_SWEEPS_PER_LAUNCH}"
                         f": {per_launch}")
    if iters <= 0:
        return []
    n = -(-iters // per_launch)
    q, r = divmod(iters, n)
    return [q + 1] * r + [q] * (n - r)


@functools.lru_cache(maxsize=64)
def _schedules(iters: int, rho: float, cheb: bool, sizes: tuple):
    """Per launch, its (a_k, b_k) pairs as a host float array (None for
    plain Jacobi, which the kernel fills in)."""
    from meshrecon_torch.flow.variational import cheb_coeffs_f32

    if not cheb:
        return (None,) * len(sizes)
    flat = [x for pair in cheb_coeffs_f32(iters, rho) for x in pair]
    out, k = [], 0
    for s in sizes:
        out.append((ctypes.c_float * (2 * s))(*flat[2 * k:2 * (k + s)]))
        k += s
    return tuple(out)


def block_shape(sweeps: int, height: int, width: int) -> dict:
    """The launch geometry of ``sweeps`` sweeps a launch on a (height,
    width) image, from the built library: the tile each CTA writes
    (rows, columns), its dynamic shared memory in bytes and the CTAs an
    image."""
    out = (ctypes.c_int * 4)()
    if library().cdll.mr_hs_block_shape(sweeps, height, width, out) != 0:
        raise ValueError(f"no launch of {sweeps} sweeps on {height}x{width}")
    return {"tile": (out[1], out[0]), "smem_bytes": out[2],
            "ctas_per_image": out[3]}


def hs_level_fused(prev, warped, u0, v0, alpha2: float, iters: int = 60,
                   solver: str = "jacobi", rho: float = 0.98, *,
                   _sweeps_per_launch: int = MAX_SWEEPS_PER_LAUNCH):
    """Relax the HS system linearized at (u0, v0); returns (u, v).

    prev broadcasts against warped, u0, v0 (..., H, W) float32 (the solver
    shares one source frame across K targets). solver: "cheb" or "jacobi".
    """
    from meshrecon_torch.flow.variational import _hs_sweeps, _hs_sweeps_cheb

    if solver not in ("cheb", "jacobi"):
        raise ValueError(f"solver must be cheb|jacobi: {solver!r}")
    if not warped.is_cuda:
        if solver == "cheb":
            return _hs_sweeps_cheb(prev, warped, u0, v0, alpha2, iters, rho)
        return _hs_sweeps(prev, warped, u0, v0, alpha2, iters)

    cheb = solver == "cheb"
    shape = warped.shape
    a = prev.expand(shape).contiguous()
    b, u0, v0 = warped.contiguous(), u0.contiguous(), v0.contiguous()
    u, v = u0, v0
    up, vp = (u0, v0) if cheb else (None, None)
    plan = hs_launches(iters, solver, rho, _sweeps_per_launch)
    for j, (sweeps, coeffs) in enumerate(plan):
        u, v, up, vp = hs_launch(a, b, u0, v0, u, v, up, vp, sweeps, coeffs,
                                 alpha2, carry=cheb and j < len(plan) - 1)
    return u.reshape(shape), v.reshape(shape)


def hs_launches(iters: int, solver: str, rho: float = 0.98,
                per_launch: int = MAX_SWEEPS_PER_LAUNCH) -> list:
    """The K4 launches of :func:`hs_level_fused`: (sweeps, that launch's
    (a_k, b_k) pairs as a host array, None for Jacobi) each."""
    sizes = chunk_sizes(iters, per_launch)
    return list(zip(sizes, _schedules(iters, float(rho), solver == "cheb",
                                      tuple(sizes))))


def hs_launch(prev, warped, u0, v0, u, v, up, vp, sweeps: int, coeffs,
              alpha2: float, carry: bool):
    """One K4 launch of :func:`hs_launches` on CUDA tensors, into new
    buffers (a CTA's halo reads its neighbours' pixels of the launch
    before): ``sweeps`` sweeps from the iterate (u, v) and, Chebyshev, the
    one before, (up, vp) ((u0, v0) at the first launch; None for Jacobi).
    Returns (u, v, up, vp), the last two None unless ``carry`` (Chebyshev
    with launches still to come). The tile axis (``sharding/tiles.py``)
    launches it on each band's window of rows."""
    shape = warped.shape
    h, w = shape[-2:]
    a = prev.expand(shape).contiguous()
    b, u0, v0, u, v = (t.contiguous() for t in (warped, u0, v0, u, v))
    outs = [torch.empty_like(b) for _ in range(4 if carry else 2)]
    check_cuda("hs_launch", a, b, u0, v0, u, v, *outs)
    if up is not None:
        up, vp = up.contiguous(), vp.contiguous()
    outs += [None] * (4 - len(outs))
    # the schedule passes as the host array's address (None: Jacobi)
    K4.launch(a, b, u0, v0, u, v, up, vp, *outs,
              None if coeffs is None else ctypes.addressof(coeffs), sweeps,
              float(alpha2), b.numel() // (h * w), h, w)
    return tuple(outs)


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


def hs_jacobi(ix, iy, c, u0, v0, alpha2: float, iters: int = 60, *,
              _sweeps_per_launch: int = K6_SWEEPS_PER_LAUNCH):
    """Run ``iters`` Horn-Schunck Jacobi sweeps given the fields; returns
    (u, v). ix, iy, c, u0, v0: (..., H, W) float32 of one shape."""
    if not ix.is_cuda:
        return hs_jacobi_plain(ix, iy, c, u0, v0, alpha2, iters)
    sizes = chunk_sizes(iters, _sweeps_per_launch)
    shape = ix.shape
    for t in (iy, c, u0, v0):
        if t.shape != shape:
            raise ValueError(f"shape {tuple(t.shape)} != {tuple(shape)}")
    h, w = shape[-2:]
    n = ix.numel() // (h * w)
    ix, iy, c = ix.contiguous(), iy.contiguous(), c.contiguous()
    u, v = u0.contiguous(), v0.contiguous()
    # (u, v) in one pair of buffers, out to the other
    bufs = [torch.empty_like(ix) for _ in range(2 * min(len(sizes), 2))]
    check_cuda("hs_jacobi", ix, iy, c, u, v, *bufs)
    if not sizes:
        return u.clone(), v.clone()
    for j, s in enumerate(sizes):
        out_u, out_v = bufs[2 * (j % 2):2 * (j % 2) + 2]
        K6.launch(ix, iy, c, u, v, out_u, out_v, s, float(alpha2), n, h, w)
        u, v = out_u, out_v
    return u, v
