"""Sweep the binned rasterizer's chunk size at several triangle counts.

Counterpart of tools/raster_sweep.py (the JAX package's) for the port:

    python -m meshrecon_torch.tools.raster_sweep [--chunks 8,16,32,64]
        [--reps 10] [--batched] [--device cuda|cpu]
        [--height 480] [--width 640] [--tris 3200,16384,65536]

Cases: ``bench578``, the soup of ``problems.fused_problem`` with its first
main camera, and random tessellated spheres of ``--tris`` triangles,
Morton-sorted (:func:`make_soup`). For each case and chunk size it renders
with one-level K1 and two-level K5a on that camera, with ``--batched`` K5b
on 4 copies of it, and always K5b and K1 on the 16 cameras of the fused
update at B=4, K=3; for ``bench578`` also the plain ``render_depth``. Each
row gives the whole wrapper's ms, the binning's ms (``bin_soup``:
``pack_records`` and ``bin_chunks`` / ``bin_superchunks``), the kernel's ms
on those bins (``raster_binned``), the peak device memory of one wrapper
call above what was allocated before it, and the entries of the tile-list
table. Every render must equal the one-level render of the same cameras at
the first chunk size.

Times are CUDA-event means over ``--reps`` calls after one warm-up. The tool
runs on the card unless ``--device cpu`` is passed (and raises without
CUDA); on the CPU every wrapper takes the plain render, the times are host
clock, and no kernel or device memory is measured.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from meshrecon_torch import problems
from meshrecon_torch.pipeline.config import resolve_device
from meshrecon_torch.raster import binned
from meshrecon_torch.raster.rasterizer import render_depth
from meshrecon_torch.utils.profiling import best_ms, device_line


def make_soup(t: int) -> np.ndarray:
    """t small triangles on a unit sphere around the fused problem's scene
    (0, 0, -5), Morton-sorted (tools/raster_sweep.py's make_soup)."""
    rng = np.random.default_rng(1)
    ctr = np.array([0.0, 0.0, -5.0], np.float32)
    p = rng.normal(size=(t, 3)).astype(np.float32)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    e1 = rng.normal(scale=0.05, size=(t, 3)).astype(np.float32)
    e2 = rng.normal(scale=0.05, size=(t, 3)).astype(np.float32)
    s = np.stack([p, p + e1, p + e2], axis=1) + ctr
    return s[binned.morton_order(s)]


def _peak_mb(fn, device):
    """Peak device memory of one call of ``fn`` above what was allocated
    before it, in MB; None on the CPU."""
    if device.type == "cpu":
        return None
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    torch.cuda.synchronize(device)
    return (torch.cuda.max_memory_allocated(device) - base) / 1e6


def _fmt(v, width: int, digits: int) -> str:
    return f"{'-':>{width}}" if v is None else f"{v:>{width}.{digits}f}"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m meshrecon_torch.tools.raster_sweep",
        description="Time the binned raster (K1, K5a, K5b) and its binning "
                    "over chunk sizes and triangle counts.")
    p.add_argument("--chunks", default="8,16,32,64",
                   help="comma-separated chunk sizes (of 8, 16, 32, 64)")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--batched", action="store_true",
                   help="also time K5b on 4 copies of the case's camera")
    p.add_argument("--device", default="cuda")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--tris", default="3200,16384,65536",
                   help="comma-separated triangle counts of the spheres")
    return p


def main(argv=None) -> list[dict]:
    """Run the sweep; print one line per row and return the rows."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    h, w = args.height, args.width
    chunks = [int(c) for c in args.chunks.split(",")]
    print(device_line(device), flush=True)

    prob = problems.fused_problem(4, 3, h, w, seed=0)
    cams16 = torch.from_numpy(np.concatenate(
        [prob[2][:, None], prob[4]], 1).reshape(16, 4, 4)).to(device)
    cam1 = cams16[:1]
    cams4 = cam1.expand(4, 4, 4).contiguous()
    cases = [("bench578", prob[0], prob[1])]
    cases += [(f"sphere{t}", make_soup(t), np.ones(t, bool))
              for t in (int(x) for x in args.tris.split(","))]

    def render(cams, kernel, soup, valid, chunk):
        """The wrapper that launches ``kernel``."""
        if kernel is binned.K5B:
            return binned.render_depth_binned_batched(cams, soup, valid, h,
                                                      w, chunk=chunk)
        return binned.render_depth_binned(cams, soup, valid, h, w,
                                          chunk=chunk,
                                          two_level=kernel is binned.K5A)

    variants = [("one-level", cam1, binned.K1),
                ("two-level", cam1, binned.K5A)]
    if args.batched:
        variants.append(("batched x4", cams4, binned.K5B))
    variants += [("one-level x16", cams16, binned.K1),
                 ("batched x16", cams16, binned.K5B)]

    print(f"{'case':<12} {'variant':<14} {'chunk':>5} {'wrapper ms':>11} "
          f"{'binning ms':>11} {'kernel ms':>10} {'peak MB':>9} "
          f"{'list entries':>13}", flush=True)
    rows = []
    for name, soup_np, valid_np in cases:
        soup = torch.from_numpy(np.ascontiguousarray(soup_np)).to(device)
        valid = torch.from_numpy(valid_np).to(device)
        refs = {}
        for chunk in chunks:
            for label, cams, kernel in variants:
                def run():
                    return render(cams, kernel, soup, valid, chunk)

                def binning():
                    return binned.bin_soup(cams, soup, valid, h, w, chunk,
                                           kernel is not binned.K1)

                out = run()
                # the first render of these cameras is the one-level one
                ref = refs.setdefault("x16" if cams is cams16 else "x1", out)
                if not torch.equal(out, ref.expand_as(out)):
                    raise AssertionError(f"{name} {label} chunk={chunk}: "
                                         "differs from the one-level render")
                bins = binning()
                row = dict(
                    case=name, tris=int(valid_np.sum()), variant=label,
                    cameras=cams.shape[0], chunk=chunk,
                    wrapper_ms=best_ms(run, args.reps, device),
                    binning_ms=best_ms(binning, args.reps, device),
                    kernel_ms=None if device.type == "cpu" else best_ms(
                        lambda: binned.raster_binned(kernel, bins),
                        args.reps, device),
                    peak_mb=_peak_mb(run, device),
                    list_entries=bins["lists"].numel())
                del bins
                rows.append(row)
                print(f"{name:<12} {label:<14} {chunk:>5} "
                      f"{row['wrapper_ms']:>11.4f} {row['binning_ms']:>11.4f} "
                      f"{_fmt(row['kernel_ms'], 10, 4)} "
                      f"{_fmt(row['peak_mb'], 9, 1)} "
                      f"{row['list_entries']:>13}", flush=True)
        if name == "bench578":
            row = dict(case=name, tris=int(valid_np.sum()), variant="plain",
                       cameras=1, chunk=None,
                       wrapper_ms=best_ms(lambda: render_depth(
                           cam1, soup, valid, h, w), args.reps, device),
                       binning_ms=None, kernel_ms=None, peak_mb=None,
                       list_entries=None)
            rows.append(row)
            print(f"{name:<12} {'plain':<14} {'-':>5} "
                  f"{row['wrapper_ms']:>11.4f}", flush=True)
    return rows


if __name__ == "__main__":
    main()
