"""meshrecon_torch.flow.multigrid (``--flow-solver mg``) against
meshrecon.flow.multigrid on the CPU, and its convergence to the Jacobi
fixed point of K6's plain version.

Tolerances: 1e-4 px against JAX (the same elementwise ops and pyramid
filters; XLA's CPU backend contracts multiply-adds, measured 1.2e-7 px at
64x80). The convergence bounds are the JAX package's
(tests/test_multigrid.py:28-46): 2 cycles beat 60 Jacobi sweeps against a
1,500-sweep fixed point, with an interior error under 1 px.
"""

import jax
import numpy as np
import torch

from meshrecon.flow import multigrid as jm
from meshrecon.flow.variational import variational_flow as j_flow
from meshrecon_torch.flow import jacobi as tj
from meshrecon_torch.flow import multigrid as tm
from meshrecon_torch.flow import variational as tv
from meshrecon_torch.flow.remap import bilinear_warp
from test_flow import shift_image, smooth_image

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _linearization(h=120, w=160, seed=4, dx=3, dy=-2):
    """tests/test_multigrid.py's problem: a shifted smooth image warped by
    a constant flow half a pixel off the shift."""
    img = _t(smooth_image(h, w, seed=seed))
    moved = _t(shift_image(smooth_image(h, w, seed=seed), dx, dy))
    u0 = torch.full((h, w), float(dx) - 0.5)
    v0 = torch.full((h, w), float(dy) + 0.5)
    warped = bilinear_warp(moved, torch.stack([u0, v0], -1))
    return img, warped, u0, v0


def test_mg_matches_jax_single_and_batched():
    prev, warped, u0, v0 = _linearization(h=64, w=80)
    prev_b = torch.stack([prev, prev * 0.5 + 10.0])
    warped_b = torch.stack([warped, warped * 0.5 + 10.0])
    u0_b = torch.stack([u0, u0 * 0.0])
    v0_b = torch.stack([v0, v0 * 0.0])
    j_mg = jax.jit(jm.hs_solve_mg, static_argnames=("cycles",))
    for args in ((prev, warped, u0, v0), (prev_b, warped_b, u0_b, v0_b)):
        ju, jv = j_mg(*(a.numpy() for a in args), 144.0)
        tu, tv_ = tm.hs_solve_mg(*args, 144.0)
        assert tu.shape == args[1].shape
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(tv_.numpy(), np.asarray(jv), rtol=0,
                                   atol=1e-4)
    # the batch's first item is the single solve
    ub, _ = tm.hs_solve_mg(prev_b, warped_b, u0_b, v0_b, 144.0)
    u1, _ = tm.hs_solve_mg(prev, warped, u0, v0, 144.0)
    np.testing.assert_allclose(ub[0].numpy(), u1.numpy(), rtol=0, atol=1e-4)


def test_mg_converges_to_jacobi_fixed_point():
    """2 cycles beat 60 Jacobi sweeps (K6's plain version) against a
    1,500-sweep fixed point."""
    prev, warped, u0, v0 = _linearization()
    ix, iy, c = tm.hs_fields(prev, warped, u0, v0)
    u_star, v_star = tj.hs_jacobi(ix, iy, c, u0, v0, 144.0, iters=1500)
    u60, v60 = tj.hs_jacobi(ix, iy, c, u0, v0, 144.0, iters=60)
    um, vm = tm.hs_solve_mg(prev, warped, u0, v0, 144.0, cycles=2)

    def interior_err(u, v):
        return float((u - u_star)[8:-8, 8:-8].abs().max()
                     + (v - v_star)[8:-8, 8:-8].abs().max())

    err_mg, err_j60 = interior_err(um, vm), interior_err(u60, v60)
    assert err_mg < err_j60, (err_mg, err_j60)
    assert err_mg < 1.0, err_mg


def test_variational_flow_mg_matches_jax():
    """solver="mg" inside the pipeline's 2-level single-warp pyramid, and
    its translation recovery (tests/test_multigrid.py::
    test_mg_flow_recovers_translation)."""
    img = smooth_image(72, 96, seed=4)
    moved = shift_image(img, 3, -2)
    ref = np.asarray(j_flow(img, moved, levels=2, warps=1, solver="mg",
                            engine="xla"))
    ours = tv.variational_flow(_t(img), _t(moved), levels=2, warps=1,
                               solver="mg").numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-3)
    flow = tv.variational_flow(_t(img), _t(moved), solver="mg").numpy()
    err = np.hypot(flow[12:-12, 12:-12, 0] - 3, flow[12:-12, 12:-12, 1] + 2)
    assert np.median(err) < 0.5, np.median(err)
