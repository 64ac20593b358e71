"""The tile axis: image rows split over a device group, with exact band
exchanges.

The JAX package has no module of its own for this: its tile axis is one
``NamedSharding`` of the image rows (meshrecon/sharding/meshes.py:111-121,
161-172), and XLA inserts the exchanges between bands. Here a camera shard
owns a *tile group*, the ``n_tile`` devices of its row of the mesh, and one
controller (:class:`TileGroup`, a thread per camera shard) walks the dense
update's stages in order: at each stage it runs every band's work on the
band's device, then exchanges rows. There are no barriers between threads.

Bands. Device j of a group holds rows [r_j, r_{j+1}) of every dense plane
of its items (:func:`band_starts`: contiguous, as even as the alignment
allows, at least 2 rows each). A stage of reach r runs on the window
[r_j - r, r_{j+1} + r), clipped to the image, as if that window were the
image, and keeps rows [r_j, r_{j+1}): its own border rule (reflect, clamp
or zeros) then acts only at a window edge, which is either an image edge,
where it is right, or a discarded halo. :meth:`TileGroup.rows` copies a
window's rows from whichever bands own them, more than the neighbour where
the reach is deeper than a band. Where a pixel's arithmetic needs its
global row (the renders, the projective texturing's NDC, the warps' sample
rows, the triangulation), the stage function takes the band's first row
and the image's height. Every stage then computes each kept pixel with the
whole frame's operations on the whole frame's values, so the update equals
the unsharded one bit for bit.

The stages and their reach:

- renders: each band renders its rows of the main and side cameras (K1's
  row window); the side depth maps are dilated in windows of reach 1 and
  all-gathered, since the shadow test reads them anywhere;
- projective texturing (K2, its output plane apart from the whole side
  frames and shadow maps) and the mix chain: pointwise on the band;
- pyramids (flow, variance, Farneback): ``pyr_down`` and ``pyr_up`` reach
  2 rows a level (``pyr_up`` 3 where a band start is odd). A level stays
  in bands only while every band start of the level below is even (so
  that ``pyr_down`` keeps the image's own even rows) and every band of it
  holds at least 2 rows (:func:`next_level`). The first level that fails
  is still computed in bands, each band the rows whose kept rows it holds,
  then gathered whole onto each device of the group (at most a quarter of
  the pixels); every coarser level runs whole there;
- the flow solver's warps (K3; the re-warp's K3b or bicubic remap): reach
  ``ceil(max |v|) + taps / 2``, the max over the group, one host sync a
  warp; Farneback's samples the same;
- the Horn-Schunck sweeps (K4): a window of reach ``sweeps + 1`` a launch,
  the iterate exchanged between launches; the plain path takes all of its
  sweeps in one window;
- the variance's residual: reach 1 (the gradients);
- triangulation: reach 1 (Sobel), or with exact sampling ``ceil(max |fly|)
  + 2``; the Gauss-Newton exit counts active pixels over the whole frame,
  the bands' counts summed (``depth.triangulate.solve_bands``: every sweep
  on the CPU, the bands' step-count histograms once on CUDA) so that every
  band of an item takes the unsharded sweeps;
- normals: reach 10 (the 21x21 window).

Each window is logged (:attr:`TileGroup.log`), and the bytes the exchanges
copy from one band's device to another's are counted
(:attr:`TileGroup.exchanged`). The multigrid solver has no tile form.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from meshrecon_torch.depth.normals import estimate_normals_batched
from meshrecon_torch.depth.triangulate import gauss_newton_band, solve_bands
from meshrecon_torch.flow import farneback as fb
from meshrecon_torch.flow.jacobi import hs_launch, hs_launches, hs_level_fused
from meshrecon_torch.flow.pyramid import pyr_down, pyr_up
from meshrecon_torch.flow.remap import flow_remap
from meshrecon_torch.flow.tile_warp import tile_warp_flow_batched
from meshrecon_torch.flow.variational import _gradients, _hs_level
from meshrecon_torch.raster.binned import render_depth_binned
from meshrecon_torch.raster.fragment import dilate3x3_max, projected_image_batched
from meshrecon_torch.sharding.meshes import _on

ALIGN = 16  # the largest band alignment: K1's tile, four pyramid levels
PYR_HALO = 2  # pyr_down / pyr_up rows each way: the 5-tap filter
NORMALS_RADIUS = 10


def band_starts(height: int, n: int) -> tuple:
    """The n + 1 row starts of ``height`` rows in n contiguous bands: each
    start the multiple of the alignment nearest j * height / n, the
    alignment the largest power of two up to ALIGN that is at most half a
    mean band. Fewer than 2 rows a band raise ValueError."""
    if n < 1 or height < 2 * n:
        raise ValueError(f"{height} rows cannot make {n} bands of at least "
                         "2 rows each")
    align = 1
    while align * 2 <= min(ALIGN, height // n // 2):
        align *= 2
    starts = [0] + [round(j * height / n / align) * align
                    for j in range(1, n)] + [height]
    if any(b - a < 2 for a, b in zip(starts, starts[1:])):
        raise ValueError(f"{height} rows in {n} bands of alignment {align}: "
                         f"starts {starts} leave a band under 2 rows")
    return tuple(starts)


def next_level(starts: tuple | None) -> tuple | None:
    """The band starts of ``pyr_down``'s output of a level split at
    ``starts``, or None where that level is gathered: a start of this
    level is odd, or a band of the next would hold fewer than PYR_HALO
    rows."""
    if starts is None or any(s % 2 for s in starts[:-1]):
        return None
    out = tuple(s // 2 for s in starts[:-1]) + ((starts[-1] + 1) // 2,)
    if any(b - a < PYR_HALO for a, b in zip(out, out[1:])):
        return None
    return out


@dataclass
class Plane:
    """A dense plane of a tile group: ``parts[j]`` on the group's device j,
    rows on ``axis``. ``starts`` gives the band rows each part holds; None
    means every part is the whole plane (a gathered pyramid level)."""

    parts: list
    starts: tuple | None
    height: int
    axis: int = -2

    @property
    def shape(self) -> tuple:
        """The whole plane's shape."""
        shape = list(self.parts[0].shape)
        shape[self.axis] = self.height
        return tuple(shape)


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_max_abs(parts: list) -> float:
    """max |x| over the bands (NaN if any is NaN): one host sync."""
    first = parts[0].device
    return torch.stack([p.abs().amax().to(first) for p in parts]).amax().item()


def _flow_reach(parts: list, taps: int, height: int) -> int:
    """Rows a sample at ``row + v`` reaches each way, with ``taps``-tap
    interpolation: ceil(max |v|) + taps / 2, or the whole image where
    some v is not finite or larger."""
    m = _group_max_abs(parts)
    if not math.isfinite(m) or m >= height:
        return height
    return math.ceil(m) + taps // 2


class TileGroup:
    """One camera shard's devices along the tile axis and the controller of
    its bands (see the module docstring). ``devices`` may repeat one
    device (the CPU tests pass ``[torch.device("cpu")] * n``)."""

    def __init__(self, devices, height: int):
        self.devices = [torch.device(d) for d in devices]
        self.height = height
        self.starts = band_starts(height, len(self.devices))
        self.exchanged = 0  # bytes copied from one band's device to another's
        self.log = []  # dict(stage, band, lo, hi, reach, w0, w1, height)
        self.gathered = []  # (stage, rows, columns) of levels run whole

    # ---- layout ----------------------------------------------------------

    def scatter(self, x: torch.Tensor, axis: int = -2) -> Plane:
        """A whole plane's bands, each on its device (no exchange)."""
        return Plane([x.narrow(axis, a, b - a).to(d) for d, a, b in zip(
            self.devices, self.starts, self.starts[1:])], self.starts,
            self.height, axis)

    def replicate(self, x) -> list:
        """``x`` (a tensor) on each device of the group."""
        return [x.to(d) for d in self.devices]

    def rows(self, plane: Plane, lo: int, hi: int, j: int) -> torch.Tensor:
        """Rows [lo, hi) of ``plane``, clipped to it, on device j, copied
        from whichever bands own them."""
        lo, hi = max(lo, 0), min(hi, plane.height)
        if plane.starts is None:
            return plane.parts[j].narrow(plane.axis, lo, hi - lo)
        pieces = []
        for k, (a, b) in enumerate(zip(plane.starts, plane.starts[1:])):
            a2, b2 = max(a, lo), min(b, hi)
            if a2 >= b2:
                continue
            piece = plane.parts[k].narrow(plane.axis, a2 - a, b2 - a2)
            if k != j:
                piece = piece.to(self.devices[j])
                self.exchanged += _bytes(piece)
            pieces.append(piece)
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces,
                                                            plane.axis)

    def all_gather(self, plane: Plane) -> list:
        """The whole plane on each device."""
        return [self.rows(plane, 0, plane.height, j)
                for j in range(len(self.devices))]

    def gather(self, plane: Plane, device) -> torch.Tensor:
        """The whole plane on ``device``, bands in row order."""
        if plane.starts is None:
            return plane.parts[0].to(device)
        return torch.cat([p.to(device) for p in plane.parts], plane.axis)

    def bands(self, plane: Plane):
        """(j, device, lo, hi) of each band of a banded plane."""
        starts = plane.starts
        return zip(range(len(self.devices)), self.devices, starts,
                   starts[1:])

    # ---- per-band work ----------------------------------------------------

    def map(self, fn, *planes: Plane, per_band=(), axis: int | None = None):
        """``fn`` on each band's parts, then each of ``per_band``'s (lists
        of a value a band) band-j value (pointwise work: no exchange),
        under the band's device; a Plane, or a tuple of them where ``fn``
        returns a tuple. All planes share the first one's split."""
        first = planes[0]
        outs = []
        for j, dev in enumerate(self.devices):
            with _on(dev):
                outs.append(fn(*(p.parts[j] for p in planes),
                               *(x[j] for x in per_band)))
        return self._planes(outs, first.starts, first.height,
                            first.axis if axis is None else axis)

    @staticmethod
    def _planes(outs, starts, height, axis):
        if isinstance(outs[0], tuple):
            return tuple(Plane([o[i] for o in outs], starts, height, axis)
                         for i in range(len(outs[0])))
        return Plane(outs, starts, height, axis)

    def window(self, stage: str, reach: int, fn, *planes: Plane,
               per_band=(), axis: int = -2):
        """A stage of reach ``reach`` on banded planes of one split: for
        each band, ``fn(w0, *windows, *band_values)`` on rows [w0, w1) =
        [lo - reach, hi + reach) clipped to the image (``per_band`` as for
        :meth:`map`), its output rows (on ``axis``) then cut to the band's
        [lo, hi). Returns a Plane or a tuple of them."""
        first = planes[0]
        outs = []
        for j, dev, lo, hi in self.bands(first):
            w0, w1 = max(lo - reach, 0), min(hi + reach, first.height)
            self.log.append(dict(stage=stage, band=j, lo=lo, hi=hi,
                                 reach=reach, w0=w0, w1=w1,
                                 height=first.height))
            with _on(dev):
                out = fn(w0, *(self.rows(p, w0, w1, j) for p in planes),
                         *(x[j] for x in per_band))
                if isinstance(out, tuple):
                    out = tuple(o.narrow(axis, lo - w0, hi - lo) for o in out)
                else:
                    out = out.narrow(axis, lo - w0, hi - lo)
            outs.append(out)
        return self._planes(outs, first.starts, first.height, axis)

    def whole(self, stage: str, fn, *planes: Plane):
        """``fn`` on gathered planes, the whole level on each device."""
        first = planes[0]
        self.gathered.append((stage, first.height, first.shape[-1]))
        outs = []
        for j, dev in enumerate(self.devices):
            with _on(dev):
                outs.append(fn(*(p.parts[j] for p in planes)))
        return self._planes(outs, None, first.height, first.axis)

    # ---- pyramids ----------------------------------------------------------

    def pyr_down(self, x: Plane) -> Plane:
        """``pyr_down`` of a plane. Each band computes the output rows whose
        kept (even) input rows it holds, from its rows and 2 more each way;
        where the output cannot stay in bands (:func:`next_level`), those
        rows are then gathered whole onto each device (module docstring).
        A gathered plane's output is computed whole on each device."""
        oh = (x.height + 1) // 2
        if x.starts is None:
            out = self.whole("pyr_down", pyr_down, x)
            out.height = oh
            return out
        outs = tuple(-(-s // 2) for s in x.starts)
        parts = []
        for j, dev, lo, hi in self.bands(x):
            n0, n1 = outs[j], outs[j + 1]
            w0 = max(2 * n0 - PYR_HALO, 0)
            w1 = min(2 * n1 - 1 + PYR_HALO, x.height)
            self.log.append(dict(stage="pyr_down", band=j, lo=lo, hi=hi,
                                 reach=PYR_HALO, w0=w0, w1=w1,
                                 height=x.height))
            with _on(dev):
                out = pyr_down(self.rows(x, w0, w1, j))
                parts.append(out[..., (2 * n0 - w0) // 2:
                                 (2 * n0 - w0) // 2 + n1 - n0, :])
        out = Plane(parts, outs, oh, x.axis)
        if next_level(x.starts) is None:
            self.gathered.append(("pyr_down", oh, out.shape[-1]))
            out = Plane(self.all_gather(out), None, oh, x.axis)
        return out

    def pyr_up(self, x: Plane, like: Plane) -> Plane:
        """``pyr_up(x, like's rows and columns)`` in ``like``'s layout: from
        the coarse rows around each band (the whole coarse level where it
        was gathered)."""
        oh, ow = like.height, like.shape[-1]
        if like.starts is None:
            return self.whole("pyr_up", lambda t: pyr_up(t, (oh, ow)), x)
        parts = []
        for j, dev, lo, hi in self.bands(like):
            c0 = max(lo - PYR_HALO, 0) // 2
            c1 = min(-(-(hi + PYR_HALO) // 2), x.height)
            w0, w1 = 2 * c0, min(2 * c1, oh)
            self.log.append(dict(stage="pyr_up", band=j, lo=lo, hi=hi,
                                 reach=PYR_HALO + 1, w0=w0, w1=w1, height=oh))
            with _on(dev):
                up = pyr_up(self.rows(x, c0, c1, j), (w1 - w0, ow))
                parts.append(up[..., lo - w0:hi - w0, :])
        return Plane(parts, like.starts, oh, like.axis)

    # ---- the flow's stages ---------------------------------------------------

    def warp(self, images: Plane, u: Plane, v: Plane, taps: int = 2,
             plain_bicubic: bool = False) -> Plane:
        """``tile_warp_flow_batched(images, u, v, taps)`` (or, with
        ``plain_bicubic``, ``flow_remap``), each band from the image rows
        its samples reach."""
        reach = _flow_reach(v.parts, taps, u.height)
        parts = []
        for j, dev, lo, hi in self.bands(u):
            w0, w1 = max(lo - reach, 0), min(hi + reach, u.height)
            self.log.append(dict(stage="warp", band=j, lo=lo, hi=hi,
                                 reach=reach, w0=w0, w1=w1, height=u.height))
            band = dict(row0=lo, height=u.height, src_row0=w0)
            with _on(dev):
                src = self.rows(images, w0, w1, j)
                if plain_bicubic:
                    out = flow_remap(torch.stack([u.parts[j], v.parts[j]], -1),
                                     src, **band)
                else:
                    out = tile_warp_flow_batched(
                        src.contiguous(), u.parts[j].contiguous(),
                        v.parts[j].contiguous(), taps, **band)
            parts.append(out)
        return Plane(parts, u.starts, u.height, u.axis)

    def hs_level(self, a: Plane, warped: Plane, u0: Plane, v0: Plane,
                 alpha2: float, iters: int, solver: str, rho: float):
        """``hs_level_fused`` in bands: the plain path in one window of
        reach ``iters + 1``; on CUDA each K4 launch in a window of reach
        ``sweeps + 1``, the iterate exchanged between launches."""
        if not warped.parts[0].is_cuda:
            return self.window(
                "hs_level", iters + 1, lambda w0, *t: hs_level_fused(
                    *t, alpha2, iters=iters, solver=solver, rho=rho),
                a, warped, u0, v0)
        cheb = solver == "cheb"
        u, v = u0, v0
        up, vp = (u0, v0) if cheb else (None, None)
        plan = hs_launches(iters, solver, rho)
        for i, (sweeps, coeffs) in enumerate(plan):
            carry = cheb and i < len(plan) - 1
            state = (u, v) + ((up, vp) if cheb else ())

            def launch(w0, a_w, b_w, u0_w, v0_w, u_w, v_w, *prev):
                up_w, vp_w = prev if prev else (None, None)
                outs = hs_launch(a_w, b_w, u0_w, v0_w, u_w, v_w, up_w, vp_w,
                                 sweeps, coeffs, alpha2, carry)
                return outs if carry else outs[:2]

            out = self.window("hs_level", sweeps + 1, launch, a, warped, u0,
                              v0, *state)
            u, v = out[:2]
            up, vp = out[2:] if carry else (None, None)
        return u, v


def check_solver(solver: str) -> None:
    """Raise ValueError unless the flow solver has a tile form."""
    if solver == "mg":
        raise ValueError("flow_solver='mg' has no tile form: its multigrid "
                         "cycles need whole levels (a tile axis of 1 runs "
                         "it; cheb and jacobi run on any)")
    if solver not in ("cheb", "jacobi"):
        raise ValueError(f"solver must be cheb|jacobi|mg: {solver!r}")


def _hw(plane: Plane) -> tuple:
    return plane.shape[-2:]


def variational_flow(g: TileGroup, prev: Plane, next_: Plane,
                     levels: int = 6, iters: int | None = None,
                     warps: int = 2, alpha: float = 12.0, min_size: int = 12,
                     solver: str = "cheb", want_residual: bool = False,
                     rho: float = 0.98, fine_warps: int = 1):
    """``flow.variational.variational_flow`` in bands: returns the flow's
    planes (u, v), and with ``want_residual`` also the re-warped plane."""
    check_solver(solver)
    if iters is None:
        iters = 14 if solver == "cheb" else 60
    alpha2 = float(alpha * alpha)
    pyr_a, pyr_b = [prev], [next_]
    for _ in range(levels - 1):
        if min(_hw(pyr_a[-1])) <= min_size:
            break
        pyr_a.append(g.pyr_down(pyr_a[-1]))
        pyr_b.append(g.pyr_down(pyr_b[-1]))
    u = g.map(torch.zeros_like, pyr_b[-1])
    v = g.map(torch.zeros_like, pyr_b[-1])
    for lvl in range(len(pyr_a) - 1, -1, -1):
        a, b = pyr_a[lvl], pyr_b[lvl]
        if _hw(u) != _hw(a):
            # flow values double at 2x resolution
            u = g.map(lambda t: t * 2.0, g.pyr_up(u, b))
            v = g.map(lambda t: t * 2.0, g.pyr_up(v, b))
        for _ in range(fine_warps if lvl == 0 else warps):
            u_lin, v_lin = u, v
            if a.starts is None:
                u, v, warped = g.whole("hs_level", lambda *t: _hs_level(
                    *t, alpha2, iters, solver=solver, rho=rho), a, b, u, v)
            else:
                warped = g.warp(b, u, v)
                u, v = g.hs_level(a, warped, u, v, alpha2, iters, solver, rho)
    if not want_residual:
        return u, v

    def residual(w0, a_w, warped_w, u_w, ul_w, v_w, vl_w):
        ix, iy = _gradients(a_w, warped_w)
        return warped_w + ix * (u_w - ul_w) + iy * (v_w - vl_w)

    return u, v, g.window("residual", 1, residual, pyr_a[0], warped, u,
                          u_lin, v, v_lin)


def compare(g: TileGroup, prev: Plane, next_: Plane) -> Plane:
    """``flow.pyramid.compare`` in bands; its coarse tail gathered."""
    d = g.map(lambda p, n: p.to(torch.float32) - n.to(torch.float32), prev,
              next_)
    diffs = []
    size = min(_hw(d))
    while True:
        diffs.append(g.map(torch.abs, d))
        if size <= 2:
            break
        d = g.pyr_down(d)
        size //= 2
    acc = diffs[-1]
    for lvl in range(len(diffs) - 2, -1, -1):
        acc = g.map(torch.add, diffs[lvl], g.pyr_up(acc, diffs[lvl]))
    return acc


def farneback_flow(g: TileGroup, prev: Plane, next_: Plane, levels: int = 5,
                   iters: int = 5, poly_n: int = 5, poly_sigma: float = 1.2,
                   winsize: int = 15, min_size: int = 16):
    """``flow.farneback.farneback_flow`` in bands: the polynomial
    expansion in windows of reach ``poly_n``, each iteration in windows of
    reach ``winsize // 2`` (the box), its samples from the rows they reach
    around them. Returns the flow's planes (dx, dy)."""
    f1 = g.map(lambda t: t.to(torch.float32), prev)
    f2 = g.map(lambda a, b: b.to(torch.float32).expand(
        torch.broadcast_shapes(a.shape, b.shape)), prev, next_)
    win = max(int(winsize) // 2, 1)
    poly = fb._poly_exp_setup(poly_n, poly_sigma)
    pyr1, pyr2 = [f1], [f2]
    for _ in range(levels - 1):
        if min(_hw(pyr1[-1])) <= min_size:
            break
        pyr1.append(g.pyr_down(pyr1[-1]))
        pyr2.append(g.pyr_down(pyr2[-1]))
    dx = g.map(torch.zeros_like, pyr2[-1])
    dy = g.map(torch.zeros_like, pyr2[-1])
    for lvl in range(len(pyr1) - 1, -1, -1):
        a, b = pyr1[lvl], pyr2[lvl]
        if _hw(dx) != _hw(a):
            dx = g.map(lambda t: t * 2.0, g.pyr_up(dx, b))
            dy = g.map(lambda t: t * 2.0, g.pyr_up(dy, b))
        if a.starts is None:
            dx, dy = g.whole("farneback_level", lambda *t: fb._flow_level(
                *t, poly, win, iters), a, b, dx, dy)
        else:
            dx, dy = _farneback_level(g, a, b, dx, dy, poly, win, iters)
    return dx, dy


def _farneback_level(g, a, b, dx, dy, poly, win, iters):
    u, w, g_inv = poly
    n = (len(u) - 1) // 2

    def expand(w0, img):
        return fb._poly_expansion(img, u, w, g_inv)

    pa = g.window("poly_expansion", n, expand, a)
    pb = tuple(g.map(torch.Tensor.contiguous, p)
               for p in g.window("poly_expansion", n, expand, b))
    height = dx.height
    for _ in range(iters):
        reach = _flow_reach(dy.parts, 2, height)
        parts = ([], [])
        for j, dev, lo, hi in g.bands(dx):
            w0, w1 = max(lo - win, 0), min(hi + win, height)
            g.log.append(dict(stage="farneback_step", band=j, lo=lo, hi=hi,
                              reach=win, w0=w0, w1=w1, height=height))
            g.log.append(dict(stage="farneback_warp", band=j, lo=lo, hi=hi,
                              reach=win + reach, w0=max(w0 - reach, 0),
                              w1=min(w1 + reach, height), height=height))
            with _on(dev):
                dxc = g.rows(dx, w0, w1, j).contiguous()
                dyc = g.rows(dy, w0, w1, j).contiguous()
                s0 = max(w0 - reach, 0)

                def samp(img):
                    src = g.rows(img, s0, w1 + reach, j).contiguous()
                    return tile_warp_flow_batched(src, dxc, dyc, row0=w0,
                                                  height=height, src_row0=s0)

                out = fb.flow_step([g.rows(p, w0, w1, j) for p in pa], pb,
                                   samp, dxc, dyc, win)
            for part, o in zip(parts, out):
                part.append(o.narrow(-2, lo - w0, hi - lo))
        dx, dy = (Plane(p, dx.starts, height, dx.axis) for p in parts)
    return dx, dy


def _exact_reach(g: TileGroup, fly: Plane) -> int:
    """Rows of depth exact sampling reads each way: its taps, ceil(max
    |fly|) + 1, and one more for the Sobel gradients there."""
    return min(_flow_reach(fly.parts, 2, fly.height) + 1, fly.height)


def triangulate(g: TileGroup, flx: Plane, fly: Plane, var: Plane,
                main_cams: list, side_cams: list, side_valid: list,
                depth: Plane, sampling: str, gn_iters: int = 50) -> tuple:
    """``triangulate_pixels_batched`` in bands: each band's fields from
    its depth window, then the Gauss-Newton sweeps with the exit's
    active-pixel count summed over the group. Returns (point4, pdf, valid)
    planes and the sweep count."""
    reach = _exact_reach(g, fly) if sampling == "exact" else 1
    bands = []
    for j, dev, lo, hi in g.bands(flx):
        w0, w1 = max(lo - reach, 0), min(hi + reach, depth.height)
        g.log.append(dict(stage="triangulate", band=j, lo=lo, hi=hi,
                          reach=reach, w0=w0, w1=w1, height=depth.height))
        with _on(dev):
            bands.append(gauss_newton_band(
                flx.parts[j], fly.parts[j], var.parts[j], main_cams[j],
                side_cams[j], side_valid[j], g.rows(depth, w0, w1, j),
                sampling, row0=lo, height=depth.height, depth_row0=w0))
    res = solve_bands(bands, gn_iters)
    sweeps = res[0]["gn_sweeps"]
    outs = [(r["point4"], r["pdf"], r["valid"]) for r in res]
    point4 = Plane([o[0] for o in outs], flx.starts, flx.height, -3)
    pdf, valid = (Plane([o[i] for o in outs], flx.starts, flx.height)
                  for i in (1, 2))
    return point4, pdf, valid, sweeps


def normals(g: TileGroup, point4: Plane, valid: Plane, pdf: Plane,
            centers: list, centers_valid: list, n_side: list) -> Plane:
    """``estimate_normals_batched`` in windows of its window's radius;
    centers, centers_valid and n_side: a tensor a band."""
    def fn(w0, *args):
        return estimate_normals_batched(*args, radius=NORMALS_RADIUS)

    # point4 (B, H, W, 4) rows on -3, valid and pdf on -2: their windows
    # are the same rows
    return g.window("normals", NORMALS_RADIUS, fn, point4, valid, pdf,
                    per_band=(centers, centers_valid, n_side), axis=-3)


def fused_update(g: TileGroup, soup, soup_valid, cam_mains, frames_main,
                 side_cams, side_frames, side_valid, centers, centers_valid,
                 n_side, height: int, width: int,
                 use_farneback: bool = False, sampling: str = "taylor",
                 flow_solver: str = "cheb", variance: str = "taylor",
                 variance_taps: int = 4, shadow_sample: str = "nearest",
                 levels: int = 2, warps: int = 1, iters: int | None = None,
                 alpha: float = 12.0, rho: float = 0.98,
                 fine_warps: int = 1) -> dict:
    """``pipeline.fused.fused_main_update_batched`` over the group's bands:
    the same ten inputs (on any device), the same options, the same
    outputs bit for bit, gathered onto the group's first device; and
    ``gn_sweeps``."""
    from meshrecon_torch.flow.api import farneback_params
    from meshrecon_torch.pipeline.fused import check_options, mix_chain

    check_options(variance, variance_taps)
    if not use_farneback:
        check_solver(flow_solver)
    f32 = torch.float32
    rep = g.replicate
    cam_mains_r = rep(cam_mains.to(f32))
    side_cams_r = rep(side_cams.to(f32))
    side_valid_r = rep(side_valid.to(torch.bool))
    frames = g.scatter(frames_main.to(f32))
    side_frames_r = rep(side_frames.to(f32))
    b, k = side_frames.shape[:2]

    # 1: each band renders its rows of every camera (K1's row window)
    all_cams = torch.cat([cam_mains.to(f32)[:, None], side_cams.to(f32)],
                         dim=1).reshape(b * (k + 1), 4, 4)
    depths = []
    for dev, lo, hi, cams, sp, sv in zip(
            g.devices, g.starts, g.starts[1:], rep(all_cams), rep(soup),
            rep(soup_valid)):
        with _on(dev):
            depths.append(render_depth_binned(
                cams, sp, sv, height, width, rows=(lo, hi)).reshape(
                    b, k + 1, hi - lo, width))
    all_depths = Plane(depths, g.starts, height)
    depth0 = g.map(lambda t: t[:, 0], all_depths)
    shadow = g.all_gather(g.window(
        "dilate", 1, lambda w0, t: dilate3x3_max(t[:, 1:]), all_depths))

    # 2: projective texturing of the band's pixels, then the mix chain
    def texture(d0, frame, row0, cams, frames_k, cams_k, shadow_k,
                valid_k):
        intens, masks = projected_image_batched(
            cams, d0, frames_k, cams_k, None, shadow_sample=shadow_sample,
            row0=row0, shadow=shadow_k)
        return mix_chain(intens, masks, frame, d0, valid_k)

    mixed_all, depth_final = g.map(
        texture, depth0, frames, per_band=(
            g.starts[:-1], cam_mains_r, side_frames_r, side_cams_r, shadow,
            side_valid_r))
    main = g.map(lambda t: t[:, None], frames)

    # 3: the flow solve; 4: the variance's re-warp
    rewarped = None
    if use_farneback:
        u, v = farneback_flow(g, main, mixed_all,
                              **farneback_params(height, width))
    else:
        flow = variational_flow(
            g, main, mixed_all, levels=levels, iters=iters, warps=warps,
            alpha=alpha, solver=flow_solver,
            want_residual=variance == "taylor", rho=rho,
            fine_warps=fine_warps)
        u, v = flow[:2]
        if variance == "taylor":
            rewarped = flow[2]
    if rewarped is None:
        rewarped = g.warp(mixed_all, u, v, taps=variance_taps)
    var = compare(g, main, rewarped)

    # 5: triangulation and normals
    point4, pdf, valid, sweeps = triangulate(
        g, u, v, var, cam_mains_r, side_cams_r, side_valid_r, depth_final,
        sampling)
    nrm = normals(g, point4, valid, pdf, rep(centers), rep(centers_valid),
                  rep(n_side))
    dev0 = g.devices[0]
    return {"point4": g.gather(point4, dev0), "normals": g.gather(nrm, dev0),
            "pdf": g.gather(pdf, dev0), "valid": g.gather(valid, dev0),
            "depth": g.gather(depth_final, dev0), "gn_sweeps": sweeps}


def dense_update(g: TileGroup, frames_main, frames_proj, main_cams,
                 side_cams, side_valid, depths, centers, centers_valid,
                 n_side, flow_quality: str = "full") -> tuple:
    """``sharding.meshes.dense_update_batch`` over the group's bands: the
    same nine inputs and four outputs, bit for bit, on the group's first
    device."""
    from meshrecon_torch.sharding.meshes import _FLOW_PRESETS

    preset = _FLOW_PRESETS[flow_quality]
    fm = g.scatter(frames_main.to(torch.float32)[:, None])
    fp = g.scatter(frames_proj.to(torch.float32))
    u, v = variational_flow(g, fm, fp, **preset)
    var = compare(g, fm, g.warp(fp, u, v, taps=4, plain_bicubic=True))
    rep = g.replicate
    point4, pdf, valid, _ = triangulate(
        g, u, v, var, rep(main_cams.to(torch.float32)),
        rep(side_cams.to(torch.float32)), rep(side_valid.to(torch.bool)),
        g.scatter(depths.to(torch.float32)), "exact")
    nrm = normals(g, point4, valid, pdf, rep(centers), rep(centers_valid),
                  rep(n_side))
    dev0 = g.devices[0]
    return tuple(g.gather(p, dev0) for p in (point4, nrm, pdf, valid))
