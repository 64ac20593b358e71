"""Offline remeshing lab: try point-rejection and meshing rules on a dumped
cloud (``meshrecon_torch.tools.error_attrib --dump``, or the JAX tool's
dump: the same keys) without re-running the refinement.

Port of tools/remesh_lab.py. For each dump it re-meshes the cloud under the
rules of the JAX tool (the oracle drop, within-iteration confidence ranks,
cross-bundle support in nearest-neighbour units, splat-weight powers, and
the mesh-consensus drop at 2, 3 and 5 neighbour spacings) at the dump's
Poisson grid and at grid 192, and prints each rule's kept count and the
mesh's median and p90 error against the dump's sphere.

Meshing is ``Heuristic.tessellate``'s sequence without the pipeline
(:func:`mesh_cloud`): normalize-average normals -> Poisson on ``--device``
-> supported components -> support-distance trim.

    python -m meshrecon_torch.tools.remesh_lab DUMP.npz [DUMP.npz ...]
        [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given (and raises without
CUDA).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
from scipy.spatial import cKDTree

from meshrecon_torch.meshing.components import (keep_supported_components,
                                                trim_unsupported_faces)
from meshrecon_torch.meshing.extras import normalize_normals_average
from meshrecon_torch.meshing.poisson import poisson_surface, robust_grid_frame
from meshrecon_torch.pipeline.config import resolve_device


def _p3(points4):
    p = np.asarray(points4, np.float64)
    return p[:, :3] / p[:, 3:4] if p.shape[1] == 4 else p


def mesh_cloud(points, normals, grid, sigma, trim, support_points=None,
               conf_power=1.0, device="cuda"):
    """The tessellate() meshing sequence on a raw cloud (the production
    form is pipeline/heuristic.py's ``Heuristic._poisson_mesh``);
    support_points defaults to the splatted cloud."""
    nrm = np.asarray(normals, np.float64)
    if conf_power != 1.0:
        mag = np.linalg.norm(nrm, axis=1, keepdims=True)
        unit = nrm / np.maximum(mag, 1e-30)
        nrm = unit * np.power(np.maximum(mag, 1e-30), conf_power)
    mesh = poisson_surface(points, normalize_normals_average(
        nrm.astype(np.float32)), grid=grid, sigma=sigma, device=device)
    sup = points if support_points is None else support_points
    mesh = keep_supported_components(mesh, sup)
    if trim > 0.0 and len(mesh.faces):
        sp3 = _p3(points)
        _, scale = robust_grid_frame(sp3, grid)
        mesh = trim_unsupported_faces(mesh, _p3(sup), trim / scale)
    return mesh


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m meshrecon_torch.tools.remesh_lab")
    ap.add_argument("dumps", nargs="*", metavar="DUMP.npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.dumps:
        print("usage: remesh_lab DUMP.npz [...]", file=sys.stderr)
        return 2
    device = resolve_device(args.device)

    for path in args.dumps:
        d = np.load(path)
        points, normals, prov = d["points"], d["normals"], d["prov"]
        center, radius = d["center"], float(d["radius"])
        grid = int(d["poisson_grid"])
        sigma = float(d["poisson_sigma"])
        trim = float(d["poisson_trim"])
        p3 = _p3(points)
        ec = np.abs(np.linalg.norm(p3 - center, axis=1) - radius) / radius
        conf = np.linalg.norm(np.asarray(normals, np.float64), axis=1)
        iters = prov // 1000 if len(prov) == len(points) else \
            np.zeros(len(points), np.int32)

        # per-point cross-bundle support distance (filter-radius-free:
        # normalized by the cloud's own median nearest-neighbor distance)
        xsup = np.zeros(len(points))
        if len(prov) == len(points) and len(np.unique(prov)) > 1:
            for code in np.unique(prov):
                sel = prov == code
                other = ~sel
                if other.any() and sel.any():
                    dd, _ = cKDTree(p3[other]).query(p3[sel], k=1)
                    xsup[sel] = dd
        dnn, _ = cKDTree(p3).query(p3, k=2)
        nn_med = float(np.median(dnn[:, 1])) or 1e-9
        xsup_r = xsup / nn_med

        # within-iteration confidence percentile rank
        crank = np.zeros(len(points))
        for it in np.unique(iters):
            sel = iters == it
            order = conf[sel].argsort().argsort()
            crank[sel] = order / max(sel.sum() - 1, 1)

        def stats(mesh):
            v3 = _p3(mesh.vertices)
            e = np.abs(np.linalg.norm(v3 - center, axis=1) - radius) / radius
            return float(np.median(e)), float(np.percentile(e, 90))

        rules = {
            "baseline": np.ones(len(points), bool),
            "oracle>0.1": ec <= 0.10,
            "conf<p25": crank >= 0.25,
            "conf<p40": crank >= 0.40,
            "xsup>3nn": xsup_r <= 3.0,
            "xsup>6nn": xsup_r <= 6.0,
            "conf25+xsup3": (crank >= 0.25) & (xsup_r <= 3.0),
        }
        print(f"== {path}: {len(points)} pts, cloud med/p90 "
              f"{np.median(ec):.4f}/{np.percentile(ec, 90):.4f}, "
              f"grid={grid} sigma={sigma} trim={trim}", flush=True)
        print(f"{'rule':<16}{'kept':>7}{'med':>9}{'p90':>9}"
              f"{'  (grid192)':>19}", flush=True)
        for name, keep in rules.items():
            if not keep.any():
                continue
            m = mesh_cloud(points[keep], normals[keep], grid, sigma, trim,
                           device=device)
            med, p90 = stats(m)
            m2 = mesh_cloud(points[keep], normals[keep], 192, sigma, trim,
                            device=device)
            med2, p902 = stats(m2)
            print(f"{name:<16}{int(keep.sum()):>7}{med:>9.4f}{p90:>9.4f}"
                  f"   {med2:>8.4f}/{p902:.4f}", flush=True)
        # splat-weight shaping on the full cloud (no rejection)
        for pw in (2.0, 4.0):
            m = mesh_cloud(points, normals, grid, sigma, trim, conf_power=pw,
                           device=device)
            med, p90 = stats(m)
            print(f"{'conf^%.0f' % pw:<16}{len(points):>7}{med:>9.4f}"
                  f"{p90:>9.4f}", flush=True)

        # MESH-CONSENSUS rejection: the first Poisson surface is dominated
        # by the good majority, so a point's distance to it is a ground-
        # truth-free badness score — drop far points, re-mesh. (The static
        # per-point signals above can't find high-confidence, cross-
        # supported garbage; the surface consensus can.)
        m0 = mesh_cloud(points, normals, grid, sigma, trim, device=device)
        v0 = _p3(m0.vertices)
        dmesh, _ = cKDTree(v0).query(p3, k=1)
        for tau in (2.0, 3.0, 5.0):
            keep = dmesh <= tau * nn_med
            if not keep.any() or keep.all():
                print(f"{'consensus%.0fnn' % tau:<16} no-op", flush=True)
                continue
            m = mesh_cloud(points[keep], normals[keep], grid, sigma, trim,
                           device=device)
            med, p90 = stats(m)
            m2 = mesh_cloud(points[keep], normals[keep], 192, sigma, trim,
                            device=device)
            med2, p902 = stats(m2)
            print(f"{'consensus%.0fnn' % tau:<16}{int(keep.sum()):>7}"
                  f"{med:>9.4f}{p90:>9.4f}   {med2:>8.4f}/{p902:.4f}",
                  flush=True)
        # how good is the consensus signal vs the oracle?
        bad = ec > 0.10
        if bad.any():
            print(f"# consensus-vs-oracle: med dmesh good "
                  f"{np.median(dmesh[~bad])/nn_med:.2f}nn bad "
                  f"{np.median(dmesh[bad])/nn_med:.2f}nn  corr(dmesh,err)="
                  f"{np.corrcoef(dmesh, ec)[0,1]:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
