"""Standalone meshing driver, the TEST_BUILD mains of alpha_shapes.cpp:107-143
and cgal_poisson.cpp:139-167; port of meshrecon/meshing/driver.py.

    python -m meshrecon_torch.meshing.driver [alpha|poisson|greedy]
        [--device cuda|cpu]

The reference's fixtures (bunny_5000, suzanne) are not shipped: every mode
runs on a generated 5,000-point torus with normals and writes
``test/torus_<mode>.obj`` into the working directory. The Poisson mode
solves its indicator on ``--device``; alpha and greedy are host geometry.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from meshrecon_torch.io.obj import Mesh, save_mesh
from meshrecon_torch.meshing import (alpha_shape_faces, greedy_projection,
                                     poisson_surface)
from meshrecon_torch.pipeline.config import resolve_device


def fixture_points(n=5000, seed=0):
    """(points, normals) float32 of a torus (R 1, r 0.4): nontrivial
    topology for alpha shapes."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(0, 2 * np.pi, n)
    R, r = 1.0, 0.4
    pts = np.stack(
        [(R + r * np.cos(v)) * np.cos(u), (R + r * np.cos(v)) * np.sin(u),
         r * np.sin(v)], axis=1
    )
    normals = np.stack(
        [np.cos(v) * np.cos(u), np.cos(v) * np.sin(u), np.sin(v)], axis=1
    )
    return pts.astype(np.float32), normals.astype(np.float32)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m meshrecon_torch.meshing.driver",
        description="Mesh a generated torus to test/torus_<mode>.obj")
    parser.add_argument("mode", nargs="?", default="alpha",
                        choices=("alpha", "poisson", "greedy"))
    parser.add_argument("--device", default="cuda",
                        help="the Poisson solve's device (cuda or cpu)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs("test", exist_ok=True)
    pts, normals = fixture_points()

    if args.mode == "alpha":
        print(f"Calculating alpha shape of {len(pts)} points...")
        faces, alpha = alpha_shape_faces(pts)
        print(f"{len(faces)} faces, alpha={alpha:g}")
        verts4 = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], 1)
        mesh = Mesh(verts4, faces)
    elif args.mode == "greedy":
        print(f"Greedy projection triangulation of {len(pts)} points...")
        mesh = greedy_projection(pts, normals)
        print(f"{len(mesh.vertices)} vertices, {len(mesh.faces)} faces")
    else:
        print(f"Running Poisson reconstruction of {len(pts)} points...")
        mesh = poisson_surface(pts, normals, grid=96, device=device)
        print(f"{len(mesh.vertices)} vertices, {len(mesh.faces)} faces")
    out = f"test/torus_{args.mode}.obj"
    save_mesh(mesh, out)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
