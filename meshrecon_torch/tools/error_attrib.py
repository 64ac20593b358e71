"""Quality attribution: where does the median error live?

Port of tools/error_attrib.py. Runs the refinement loop once per seed on
koule-tr's synthetic sphere frames (``-n 2`` hybrid, ``--trim``) and
decomposes the final error against the analytic sphere:

  A. CLOUD vs MESH: median/p90 of the filtered cloud against the mesh's.
  B. PER-BUNDLE: the error by provenance code (iteration * 1000 + main
     camera, ``hint.point_provenance``), with each bundle's share of the
     error mass, its cross-support distance (to the nearest point of any
     other bundle, in filter-radius units) and its median confidence.
  C. CONFIDENCE: the median error per quartile of the normal magnitude.
  E. Ground-truth-free rejection rules, simulated: re-mesh after each and
     report the mesh's error.
  D. ORACLE: re-mesh with the points above ``--oracle`` dropped (the
     ceiling of any point filter), and with ``--sensitivity`` under Poisson
     grid/sigma variations.

    python -m meshrecon_torch.tools.error_attrib [--scale 8] [--seeds 3,5]
        [--trim 2.0] [--oracle 0.10] [--sensitivity] [--dump PATH]
        [--device cuda|cpu]

``--dump`` saves the refined cloud and its provenance to an npz (a
``{seed}`` placeholder; the JAX tool's keys) for
:mod:`meshrecon_torch.tools.remesh_lab`. Runs on the card unless
``--device cpu`` is given (and raises without CUDA).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
from scipy.spatial import cKDTree

from meshrecon_torch.pipeline.config import resolve_device


def _p3(points4):
    p = np.asarray(points4, np.float64)
    return p[:, :3] / p[:, 3:4] if p.shape[1] == 4 else p


def _err(p3, center, radius):
    return np.abs(np.linalg.norm(p3 - center, axis=1) - radius) / radius


def _stats(e):
    if len(e) == 0:
        return float("nan"), float("nan")
    return float(np.median(e)), float(np.percentile(e, 90))


def _mesh_err(mesh, center, radius):
    return _err(_p3(mesh.vertices), center, radius)


def _bundle_rule(prov, iters, values, pred):
    """Keep-mask from a per-bundle rule: bundle statistic = median of
    ``values`` over its points; ``pred(stat, within-iteration median of the
    bundle stats)`` decides whether the whole bundle is kept."""
    keep = np.ones(len(prov), bool)
    for it in np.unique(iters):
        codes = np.unique(prov[iters == it])
        if len(codes) < 3:
            continue  # no robust within-iteration median to compare to
        stats = {c: float(np.median(values[prov == c])) for c in codes}
        med = float(np.median(list(stats.values())))
        for c, v in stats.items():
            if not pred(v, med):
                keep[prov == c] = False
    return keep


def _remesh(hint, points, normals, **overrides):
    """tessellate() under temporary config overrides; alpha_vals restored
    (tessellate appends a halved alpha per call)."""
    saved_cfg, saved_alpha = hint.config, list(hint.alpha_vals)
    try:
        hint.config = dataclasses.replace(hint.config, **overrides) \
            if overrides else hint.config
        return hint.tessellate(points, normals)
    finally:
        hint.config, hint.alpha_vals = saved_cfg, saved_alpha


def main(argv=None, timer=None):
    """Run the attribution; returns 0. ``timer``: the StageTimer the
    refinements fill (a fresh, enabled one by default)."""
    ap = argparse.ArgumentParser(
        prog="python -m meshrecon_torch.tools.error_attrib")
    ap.add_argument("--scale", type=int, default=8)
    ap.add_argument("--seeds", default="3,5")
    ap.add_argument("--trim", type=float, default=2.0)
    ap.add_argument("--oracle", type=float, default=0.10,
                    help="oracle point-drop threshold (err/r)")
    ap.add_argument("--sensitivity", action="store_true",
                    help="also run the poisson grid/sigma sensitivity table")
    ap.add_argument("--dump", default=None, metavar="PATH",
                    help="save the refined cloud + provenance to an npz "
                         "('{seed}' placeholder) for offline remeshing "
                         "experiments (meshrecon_torch.tools.remesh_lab)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from meshrecon_torch.io.synthetic import fit_sphere, synthetic_frames
    from meshrecon_torch.io.tracks import load_tracks
    from meshrecon_torch.pipeline.config import Config
    from meshrecon_torch.pipeline.reconstruct import _refine_cloud
    from meshrecon_torch.utils.profiling import StageTimer

    timer = timer or StageTimer()

    track = load_tracks("tracks/koule-tr.yaml")
    w, h = track.width // args.scale, track.height // args.scale
    frames = synthetic_frames(track, w, h, mode="sphere", seed=0,
                              device=device)
    center, radius = fit_sphere(track.bundles)
    print(f"# koule {w}x{h}, n=2 hybrid, trim={args.trim}, "
          f"radius {radius:.3f}", flush=True)

    for seed in (int(s) for s in args.seeds.split(",")):
        cfg = Config(track=track, frames=frames, device=str(device),
                     seed=seed, iteration_count=2, depth_mode="hybrid",
                     verbosity=1, poisson_trim=args.trim,
                     out_file_name=os.path.join(tempfile.gettempdir(),
                                                f"attrib_{seed}.obj"))
        t0 = time.perf_counter()
        points, normals, hint = _refine_cloud(cfg, timer)
        prov = hint.point_provenance
        assert len(prov) == len(points), "one provenance code per point"
        print(f"\n== seed {seed}: {len(points)} filtered points "
              f"({time.perf_counter() - t0:.0f}s)", flush=True)
        if args.dump:
            np.savez(args.dump.format(seed=seed), points=points,
                     normals=normals,
                     prov=prov,
                     alpha_vals=np.asarray(hint.alpha_vals, np.float64),
                     iteration=hint.iteration, center=center, radius=radius,
                     scale=args.scale, seed=seed,
                     poisson_grid=cfg.poisson_grid,
                     poisson_sigma=cfg.poisson_sigma,
                     poisson_trim=cfg.poisson_trim)
            print(f"   dumped -> {args.dump.format(seed=seed)}", flush=True)

        # A. cloud vs mesh
        ec = _err(_p3(points), center, radius)
        med_c, p90_c = _stats(ec)
        mesh = _remesh(hint, points, normals)
        em = _mesh_err(mesh, center, radius)
        med_m, p90_m = _stats(em)
        print(f"A  cloud med/p90 {med_c:.4f}/{p90_c:.4f}   "
              f"mesh med/p90 {med_m:.4f}/{p90_m:.4f}   "
              f"({len(mesh.faces)} faces)", flush=True)

        # B. per-bundle error (provenance codes: iter*1000 + main camera)
        # plus the two GROUND-TRUTH-FREE per-bundle signals a production
        # filter could use: median cross-support distance (to the nearest
        # point of any OTHER bundle, in filter-radius units) and median
        # confidence (normal magnitude). If cross-support separates the
        # bad bundles as well as the true error does, a bundle-outlier
        # filter needs no ground truth.
        p3 = _p3(points)
        runit = float(np.sqrt(hint.filter_radius_sq()))
        conf = np.linalg.norm(np.asarray(normals, np.float64), axis=1)
        rows = []
        for code in np.unique(prov):
            sel = prov == code
            other = ~sel
            if other.any() and sel.any():
                d, _ = cKDTree(p3[other]).query(p3[sel], k=1)
                xsup = float(np.median(d)) / max(runit, 1e-12)
            else:
                xsup = float("nan")
            m, p = _stats(ec[sel])
            # error mass: how much of the total summed error this
            # bundle carries (bad bundles dominate this, not count)
            rows.append((code, int(sel.sum()), m, p,
                         float(ec[sel].sum() / max(ec.sum(), 1e-12)),
                         xsup, float(np.median(conf[sel]))))
        rows.sort(key=lambda r: -r[4])
        print("B  bundle  it  cam   count    med    p90  err-mass"
              "   xsup/r  medconf")
        for code, n, m, p, mass, xsup, mc in rows:
            it, cam = (code // 1000, code % 1000) if code >= 0 \
                else (-1, -1)
            print(f"   {code:>6} {it:>3} {cam:>4} {n:>7} {m:>6.4f} "
                  f"{p:>6.4f} {mass:>9.3f} {xsup:>8.2f} {mc:>8.4f}",
                  flush=True)

        # C. confidence (normal magnitude) vs error
        conf = np.linalg.norm(np.asarray(normals, np.float64), axis=1)
        if len(conf) and conf.max() > 0:
            qs = np.quantile(conf, [0.25, 0.5, 0.75])
            bins = np.digitize(conf, qs)
            meds = [float(np.median(ec[bins == b])) if (bins == b).any()
                    else float("nan") for b in range(4)]
            print("C  conf-quartile med err (low->high): "
                  + " ".join(f"{m:.4f}" for m in meds), flush=True)

        # E. candidate GROUND-TRUTH-FREE rejection rules, simulated: re-mesh
        # after each rule and report the real mesh error. Rules are
        # within-iteration relative (confidence scales differ ~50x between
        # the plane-sweep bootstrap and flow iterations).
        iters = prov // 1000
        xsup_pt = np.zeros(len(points))
        for code in np.unique(prov):
            sel = prov == code
            other = ~sel
            if other.any() and sel.any():
                d, _ = cKDTree(p3[other]).query(p3[sel], k=1)
                xsup_pt[sel] = d / max(runit, 1e-12)
        for rule, keep in [
            ("bundle xsup>3x med", _bundle_rule(
                prov, iters, xsup_pt, lambda v, m: v <= 3.0 * m)),
            ("bundle conf<med/8", _bundle_rule(
                prov, iters, conf, lambda v, m: v >= m / 8.0)),
            ("point xsup>0.25", xsup_pt <= 0.25),
        ]:
            if keep.all() or not keep.any():
                print(f"E  {rule}: no-op", flush=True)
                continue
            mr = _remesh(hint, points[keep], normals[keep])
            mm, mp = _stats(_mesh_err(mr, center, radius))
            print(f"E  {rule}: kept {int(keep.sum())}/{len(points)} "
                  f"-> mesh med/p90 {mm:.4f}/{mp:.4f}", flush=True)

        # D. oracle experiments
        good = ec <= args.oracle
        if good.any() and not good.all():
            mo = _remesh(hint, points[good], normals[good])
            mm, mp = _stats(_mesh_err(mo, center, radius))
            print(f"D  oracle drop err>{args.oracle}: kept "
                  f"{int(good.sum())}/{len(points)} -> mesh med/p90 "
                  f"{mm:.4f}/{mp:.4f}  (<- ceiling for any point filter)",
                  flush=True)
        if args.sensitivity:
            for grid in (96, 128, 192):
                for sigma in (1.0, 1.5, 2.5):
                    ms = _remesh(hint, points, normals, poisson_grid=grid,
                                 poisson_sigma=sigma)
                    mm, mp = _stats(_mesh_err(ms, center, radius))
                    print(f"D  grid={grid} sigma={sigma}: med/p90 "
                          f"{mm:.4f}/{mp:.4f} ({len(ms.faces)} faces)",
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
