"""The premise of K4's and K6's temporal blocking (csrc/hs_sweep.cu), held
on the CPU with the plain sweeps.

The kernel runs S sweeps a launch on a region that holds its output tile
and a halo of S pixels on each side, clipped to the image and shifted
inward at its edges; borders that are not the image's clamp to the region
and only corrupt pixels closer to them than the sweeps run. Here the image
is cut the same way (tiles of 16x16), each crop runs S plain sweeps
(``_hs_sweeps_cheb``'s and ``hs_jacobi_plain``'s arithmetic, fields formed
on the crop), and the tiles are kept: the result equals the global plain
sweeps bit for bit, launch after launch with the state carried between
(for Chebyshev the iterate before too, on one global schedule), while a
halo one short does not. Also: the wrappers' launch schedule on a stub
library (what reaches the C entries) and their unchanged CPU path.
"""

import ctypes

import numpy as np
import pytest
import torch

from meshrecon_torch.flow import jacobi
from meshrecon_torch.flow.variational import (_gradients, _hs_average,
                                              _hs_sweeps, _hs_sweeps_cheb,
                                              cheb_coeffs_f32)
from meshrecon_torch.kernels import _build

torch.set_num_threads(1)

ALPHA2 = 144.0
SHAPE = (2, 37, 53)
TILE = 16


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    prev = rng.uniform(0.0, 255.0, SHAPE).astype(np.float32)
    warped = prev + rng.normal(0.0, 5.0, SHAPE).astype(np.float32)
    u0, v0 = rng.normal(0.0, 1.0, (2, *SHAPE)).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (prev, warped, u0, v0)]


def _spans(n, tile, halo):
    """(region start, region end, tile start, tile end) along an axis of
    ``n`` pixels: each tile with ``halo`` pixels on each side, clipped to
    the axis and shifted inward at its ends, as the kernel places them."""
    ext = min(tile + 2 * halo, n)
    out = []
    for t0 in range(0, n, tile):
        start = min(max(t0 - halo, 0), n - ext)
        out.append((start, start + ext, t0, min(t0 + tile, n)))
    return out


def _cheb_sweeps(planes, state, coeffs):
    """``_hs_sweeps_cheb``'s arithmetic from the state (u, v, up, vp) over
    the (a_k, b_k) of ``coeffs``; the fields are formed on these planes."""
    prev, warped, u0, v0 = planes
    ix, iy = _gradients(prev, warped)
    it = warped - prev
    denom = ALPHA2 + ix * ix + iy * iy
    u, v, up, vp = state
    for a_k, b_k in coeffs:
        ub, vb = _hs_average(u), _hs_average(v)
        num = (ix * (ub - u0) + iy * (vb - v0) + it) / denom
        yu, yv = ub - ix * num, vb - iy * num
        u, v, up, vp = a_k * yu + b_k * up, a_k * yv + b_k * vp, u, v
    return u, v, up, vp


def _jacobi_sweeps(planes, state, coeffs):
    ix, iy, c = planes
    return jacobi.hs_jacobi_plain(ix, iy, c, *state, ALPHA2, len(coeffs))


def _blocked(sweeps, planes, state, coeffs, per_launch, short=0):
    """The launches of ``per_launch`` sweeps at most, each computing every
    tile from its crop with a halo of its sweeps less ``short``; the state
    crosses launches whole, as through device memory."""
    h, w = SHAPE[-2:]
    k = 0
    for s in jacobi.chunk_sizes(len(coeffs), per_launch):
        halo = s - short
        new = [torch.empty_like(x) for x in state]
        for r0, r1, t0, t1 in _spans(h, TILE, halo):
            for c0, c1, s0, s1 in _spans(w, TILE, halo):
                def crop(x):
                    return x[..., r0:r1, c0:c1]

                out = sweeps([crop(p) for p in planes],
                             [crop(x) for x in state], coeffs[k:k + s])
                for dst, src in zip(new, out):
                    dst[..., t0:t1, s0:s1] = src[..., t0 - r0:t1 - r0,
                                                 s0 - c0:s1 - c0]
        state, k = new, k + s
    return state


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_cheb_state_sweeps_are_the_plain_version():
    """The helper that runs from a state is ``_hs_sweeps_cheb`` from
    (u0, v0, u0, v0), bit for bit."""
    planes = _inputs()
    u0, v0 = planes[2:]
    got = _cheb_sweeps(planes, (u0, v0, u0, v0), cheb_coeffs_f32(14, 0.98))
    assert _equal(got[:2], _hs_sweeps_cheb(*planes, ALPHA2, 14))


@pytest.mark.parametrize("per_launch", [1, 2, 5, 14])
def test_blocked_cheb_equals_global_sweeps(per_launch):
    """14 Chebyshev sweeps (the update's) in launches of ``per_launch``:
    tiles with a halo of the launch's sweeps equal the global sweeps."""
    planes = _inputs()
    u0, v0 = planes[2:]
    coeffs = cheb_coeffs_f32(14, 0.98)
    want = _cheb_sweeps(planes, (u0, v0, u0, v0), coeffs)
    got = _blocked(_cheb_sweeps, planes, (u0, v0, u0, v0), coeffs,
                   per_launch)
    assert _equal(got, want)


@pytest.mark.parametrize("per_launch", [1, 7, 20])
def test_blocked_jacobi_equals_global_sweeps(per_launch):
    """20 plain Jacobi sweeps given the fields (K6) in launches of
    ``per_launch``."""
    prev, warped, u0, v0 = _inputs(1)
    ix, iy = _gradients(prev, warped)
    c = (warped - prev) - ix * u0 - iy * v0
    coeffs = [(1.0, 0.0)] * 20
    want = jacobi.hs_jacobi_plain(ix, iy, c, u0, v0, ALPHA2, 20)
    got = _blocked(_jacobi_sweeps, (ix, iy, c), (u0, v0), coeffs,
                   per_launch)
    assert _equal(got, want)


@pytest.mark.parametrize("solver,per_launch", [("cheb", 5), ("cheb", 14),
                                               ("jacobi", 7),
                                               ("jacobi", 10)])
def test_a_halo_one_short_is_not_exact(solver, per_launch):
    """(A region that covers the whole image, 20 sweeps at 16x16 tiles, has
    no edge inside the image and is exact at any halo: not a case.)"""
    planes = _inputs(2)
    u0, v0 = planes[2:]
    if solver == "cheb":
        fn, state, coeffs = (_cheb_sweeps, (u0, v0, u0, v0),
                             cheb_coeffs_f32(14, 0.98))
    else:
        ix, iy = _gradients(planes[0], planes[1])
        c = (planes[1] - planes[0]) - ix * u0 - iy * v0
        fn, planes, state, coeffs = (_jacobi_sweeps, (ix, iy, c), (u0, v0),
                                     [(1.0, 0.0)] * 20)
    want = fn(planes, state, coeffs)
    assert _equal(_blocked(fn, planes, state, coeffs, per_launch), want)
    assert not _equal(_blocked(fn, planes, state, coeffs, per_launch,
                               short=1), want)


@pytest.mark.parametrize("iters,per_launch,want", [
    (14, 24, [14]), (60, 24, [20, 20, 20]), (60, 15, [15] * 4),
    (16, 15, [8, 8]), (30, 24, [15, 15]), (1500, 15, [15] * 100),
    (25, 24, [13, 12]), (1, 1, [1]), (0, 24, [])])
def test_chunk_sizes(iters, per_launch, want):
    sizes = jacobi.chunk_sizes(iters, per_launch)
    assert sizes == want
    assert sum(sizes) == iters and len(sizes) == -(-iters // per_launch)


def test_chunk_sizes_refuse_what_a_launch_cannot_hold():
    with pytest.raises(ValueError):
        jacobi.chunk_sizes(14, jacobi.MAX_SWEEPS_PER_LAUNCH + 1)
    with pytest.raises(ValueError):
        jacobi.chunk_sizes(14, 0)


@pytest.mark.parametrize("per_launch", [1, 24])
def test_cpu_path_is_the_plain_version(per_launch):
    """On CPU tensors the wrappers return the plain versions, whatever the
    sweeps a launch."""
    prev, warped, u0, v0 = _inputs(3)
    got = jacobi.hs_level_fused(prev, warped, u0, v0, ALPHA2, iters=14,
                                solver="cheb", _sweeps_per_launch=per_launch)
    assert _equal(got, _hs_sweeps_cheb(prev, warped, u0, v0, ALPHA2, 14))
    got = jacobi.hs_level_fused(prev, warped, u0, v0, ALPHA2, iters=20,
                                solver="jacobi", _sweeps_per_launch=per_launch)
    assert _equal(got, _hs_sweeps(prev, warped, u0, v0, ALPHA2, 20))
    ix, iy = _gradients(prev, warped)
    got = jacobi.hs_jacobi(ix, iy, warped - prev, u0, v0, ALPHA2, iters=20,
                           _sweeps_per_launch=per_launch)
    assert _equal(got, jacobi.hs_jacobi_plain(ix, iy, warped - prev, u0, v0,
                                              ALPHA2, 20))


class _Entry:
    def __init__(self, name):
        self.name = name
        self.calls = []

    def __call__(self, *args):
        # tensors as data_ptr(), as the binding passes them on; K4's
        # schedule is a host array's address (argument 12, 2 floats a
        # sweep): read it while the call lasts
        args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        if self.name == "mr_hs_sweep" and args[12] is not None:
            args[12] = list((ctypes.c_float * (2 * args[13])).from_address(
                args[12]))
        self.calls.append(tuple(args))
        return 0


class _Binding:
    def __init__(self):
        self.entries = {}

    @staticmethod
    def launch(fn, *args):
        """The C launch on device 0, stream 0, never capturing."""
        return fn(*args, 0), False

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.entries.setdefault(name, _Entry(name))


@pytest.fixture
def stub(monkeypatch):
    """The wrappers' card path against a stub library: tensors on the CPU
    pass as device 0, and the binding's functions record their
    arguments."""
    ext = _Binding()
    monkeypatch.setattr(_build, "library",
                        lambda: _build.Library(None, ext, None, 0.0, ""))
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    for k in (jacobi.K4, jacobi.K6):
        monkeypatch.setattr(k, "_fn", None)
    return ext


@pytest.mark.parametrize("solver,iters,per_launch", [
    ("cheb", 14, 24), ("cheb", 30, 24), ("cheb", 14, 1), ("jacobi", 60, 24)])
def test_k4_launch_schedule(stub, solver, iters, per_launch):
    """One launch a chunk, each with its part of the global schedule; the
    state of one launch is the next one's input; no output aliases an
    input; the iterate before leaves only the non-last Chebyshev
    launches."""
    prev, warped, u0, v0 = _inputs()
    before = jacobi.K4.launches
    jacobi.hs_level_fused(prev, warped, u0, v0, ALPHA2, iters=iters,
                          solver=solver, _sweeps_per_launch=per_launch)
    calls = stub.entries["mr_hs_sweep"].calls
    sizes = jacobi.chunk_sizes(iters, per_launch)
    assert jacobi.K4.launches - before == len(calls) == len(sizes)
    coeffs = cheb_coeffs_f32(iters, 0.98)
    k, state = 0, (u0.data_ptr(), v0.data_ptr())
    state += state if solver == "cheb" else (None, None)
    for j, (call, s) in enumerate(zip(calls, sizes)):
        assert call[:4] == tuple(t.data_ptr() for t in (prev, warped, u0, v0))
        assert call[4:8] == state
        assert call[13:] == (s, ALPHA2, 2, 37, 53, 0)
        outs = [p for p in call[8:12] if p is not None]
        assert not set(outs) & set(call[:8])
        assert len(set(outs)) == len(outs)
        last = j == len(sizes) - 1
        if solver == "cheb":
            assert call[12] == [x for pair in coeffs[k:k + s] for x in pair]
            assert (call[10] is None) == last
        else:
            assert call[12] is None and call[10] is None
        state, k = call[8:12], k + s


def test_k6_launch_schedule(stub):
    prev, warped, u0, v0 = _inputs()
    ix, iy = _gradients(prev, warped)
    c = warped - prev
    before = jacobi.K6.launches
    jacobi.hs_jacobi(ix, iy, c, u0, v0, ALPHA2, iters=60)
    calls = stub.entries["mr_hs_jacobi_fields"].calls
    sizes = jacobi.chunk_sizes(60, jacobi.K6_SWEEPS_PER_LAUNCH)
    assert jacobi.K6.launches - before == len(calls) == len(sizes)
    state = (u0.data_ptr(), v0.data_ptr())
    for call, s in zip(calls, sizes):
        assert call[:3] == tuple(t.data_ptr() for t in (ix, iy, c))
        assert call[3:5] == state
        assert not set(call[5:7]) & set(call[:5])
        assert call[7:] == (s, ALPHA2, 2, 37, 53, 0)
        state = call[5:7]
