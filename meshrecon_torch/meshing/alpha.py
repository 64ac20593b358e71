"""Alpha-shape surface extraction for the initial tessellation.

Functional equivalent of the reference's CGAL wrapper
(``alpha_shapes.cpp:36-104``): Delaunay-tetrahedralize the point cloud, pick
the smallest alpha (squared circumradius threshold, CGAL convention) for
which the solid is a single connected component covering every input point
(``find_optimal_alpha(1)``, alpha_shapes.cpp:67-78), and return the outward-
oriented boundary facets of the union of interior tetrahedra (the REGULAR
facets, alpha_shapes.cpp:81-96).

CGAL is not available in this environment; the Delaunay tetrahedralization
comes from Qhull via ``scipy.spatial.Delaunay`` (native code), and the alpha
classification, optimal-alpha search, facet extraction and orientation are
implemented here. The returned ``alpha`` feeds the point-filter radius
(``radius = alpha / 4``, heuristic.cpp:63) exactly like the reference.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay


def _circumradius2(points: np.ndarray, tets: np.ndarray) -> np.ndarray:
    """Squared circumradius of each tetrahedron; inf for degenerate ones."""
    p = points[tets]  # (T, 4, 3)
    a = p[:, 0]
    rhs = np.einsum("tij,tij->ti", p[:, 1:], p[:, 1:]) - np.einsum(
        "ti,ti->t", a, a
    )[:, None]
    A = 2.0 * (p[:, 1:] - a[:, None, :])  # (T, 3, 3)
    det = np.linalg.det(A)
    good = np.abs(det) > 1e-12
    r2 = np.full(len(tets), np.inf)
    if np.any(good):
        centers = np.linalg.solve(A[good], rhs[good][..., None])[..., 0]
        diff = centers - a[good]
        r2[good] = np.einsum("ti,ti->t", diff, diff)
    return r2


def _solid_components(tets, neighbors, interior):
    """Count connected components of interior tets under facet adjacency."""
    n = len(tets)
    idx = np.where(interior)[0]
    if len(idx) == 0:
        return 0
    comp = np.full(n, -1, dtype=np.int64)
    ncomp = 0
    for seed in idx:
        if comp[seed] >= 0:
            continue
        ncomp += 1
        stack = [seed]
        comp[seed] = ncomp
        while stack:
            t = stack.pop()
            for nb in neighbors[t]:
                if nb >= 0 and interior[nb] and comp[nb] < 0:
                    comp[nb] = ncomp
                    stack.append(nb)
    return ncomp


def _vertices_covered(tets, interior, n_points):
    covered = np.zeros(n_points, dtype=bool)
    covered[np.unique(tets[interior])] = True
    return covered.all()


def alpha_shape_faces(points: np.ndarray, alpha: float | None = None):
    """Compute alpha-shape boundary faces of a 3-D point cloud.

    points: (N, 3) Cartesian or (N, 4) homogeneous (row layout like
    recon.hpp:19-21). If ``alpha`` is None, the optimal value is searched;
    otherwise the given squared-radius threshold is used.

    Returns (faces (M, 3) int32 indices into the *input* rows, alpha_used).
    Faces are oriented outward (normals away from the solid).
    """
    points = np.asarray(points, dtype=np.float64)
    if points.size == 0:
        return np.zeros((0, 3), dtype=np.int32), float(alpha or 0.0)
    if points.shape[1] == 4:
        points = points[:, :3] / points[:, 3:4]
    n = points.shape[0]
    if n < 4:
        return np.zeros((0, 3), dtype=np.int32), float(alpha or 0.0)

    tri = Delaunay(points, qhull_options="QJ")  # joggle for robustness
    tets = tri.simplices  # (T, 4)
    neighbors = tri.neighbors  # (T, 4); -1 = hull boundary; [t, j] opposite vtx j
    r2 = _circumradius2(points, tets)

    if alpha is None:
        candidates = np.unique(r2[np.isfinite(r2)])
        # smallest alpha giving one solid component that covers all vertices;
        # binary search over the spectrum like CGAL's find_optimal_alpha
        lo, hi = 0, len(candidates) - 1
        best = None
        while lo <= hi:
            mid = (lo + hi) // 2
            a = candidates[mid]
            interior = r2 <= a
            ok = _vertices_covered(tets, interior, n) and (
                _solid_components(tets, neighbors, interior) == 1
            )
            if ok:
                best = a
                hi = mid - 1
            else:
                lo = mid + 1
        if best is None:
            # fall back to the largest candidate (whole Delaunay hull)
            best = candidates[-1] if len(candidates) else 0.0
        alpha = float(best)

    interior = r2 <= alpha

    # Boundary facets: facet j of interior tet t whose neighbor across j is
    # exterior or outside the hull.
    faces = []
    facet_order = [(1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1)]  # opposite 0..3
    for t in np.where(interior)[0]:
        for j in range(4):
            nb = neighbors[t, j]
            if nb >= 0 and interior[nb]:
                continue
            tet = tets[t]
            tri_idx = [tet[k] for k in facet_order[j]]
            a, b, c = points[tri_idx]
            opp = points[tet[j]]
            # orient outward: normal must point away from the interior vertex
            normal = np.cross(b - a, c - a)
            if np.dot(normal, opp - a) > 0:
                tri_idx = [tri_idx[0], tri_idx[2], tri_idx[1]]
            faces.append(tri_idx)

    return np.asarray(faces, dtype=np.int32).reshape(-1, 3), float(alpha)
