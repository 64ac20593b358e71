"""Greedy projection triangulation — local tangent-plane surface stitching.

Port of meshrecon/meshing/greedy.py, the counterpart of the reference's
experimental ``greedyProjection`` (pcl.cpp:247-280, unused by the
pipeline). It keeps PCL's contract and parameters (search radius as max
edge length, mu density scaling, neighbour cap, the 45/10/120-degree angle
constraints) with a simpler construction:

  1. kd-tree neighbourhoods per point (radius = mu * local spacing, capped),
  2. projection of each neighbourhood onto the point's tangent plane,
  3. a local 2-D Delaunay triangulation of the projected neighbourhood,
  4. the point's incident-triangle star, subject to the edge-length and
     angle constraints,
  5. global deduplication with a 2-votes rule (a triangle survives only if
     the local stars of at least two of its vertices propose it).

Host float64 geometry (scipy), as the reference's PCL stage; the same
operations in the same order as the JAX package's, so the faces are equal.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay, QhullError, cKDTree

from meshrecon_torch.io.obj import Mesh
from meshrecon_torch.meshing.extras import estimated_normals


def _dehom(points) -> np.ndarray:
    p = np.asarray(points, np.float64)
    if p.ndim != 2 or len(p) == 0:
        return np.zeros((0, 3))
    if p.shape[1] == 4:
        p = p[:, :3] / p[:, 3:4]
    return p


def _angles_ok(p, a, b, c, min_angle, max_angle) -> bool:
    """The triangle's three angles within [min_angle, max_angle]
    (pcl.cpp:262-263)."""
    with np.errstate(invalid="ignore"):
        angs = []
        for (x, y, z) in ((a, b, c), (b, c, a), (c, a, b)):
            e1 = p[y] - p[x]
            e2 = p[z] - p[x]
            cosang = e1 @ e2 / max(
                np.linalg.norm(e1) * np.linalg.norm(e2), 1e-300)
            angs.append(np.arccos(np.clip(cosang, -1.0, 1.0)))
    return not (min(angs) < min_angle or max(angs) > max_angle)


def greedy_projection(points, normals=None, search_radius: float | None = None,
                      mu: float = 2.5, max_nn: int = 100,
                      max_surface_angle: float = np.pi / 4,
                      min_angle: float = np.pi / 18,
                      max_angle: float = 2 * np.pi / 3) -> Mesh:
    """Triangulate a point cloud by stitched local tangent-plane Delaunay.

    points: (N, 3) or (N, 4) homogeneous; normals: optional (N, 3)
    (:func:`estimated_normals` when absent). search_radius: maximum edge
    length; default ``mu`` times the median nearest-neighbour spacing.
    Other parameters mirror pcl.cpp:258-265.
    """
    p = _dehom(points)
    n = len(p)
    if n < 3:
        return Mesh(np.zeros((0, 4), np.float32), np.zeros((0, 3), np.int32))

    tree = cKDTree(p)
    if search_radius is None:
        d, _ = tree.query(p[: min(n, 2000)], k=2)
        spacing = float(np.median(d[:, 1]))
        search_radius = mu * max(spacing, 1e-12)

    if normals is None:
        nrm = estimated_normals(p).astype(np.float64)
    else:
        nrm = np.asarray(normals, np.float64)
        ln = np.linalg.norm(nrm, axis=1, keepdims=True)
        nrm = np.where(ln > 1e-12, nrm / np.maximum(ln, 1e-12),
                       np.array([0.0, 0.0, 1.0]))

    cos_max_surf = np.cos(max_surface_angle)
    votes: dict[tuple[int, int, int], int] = {}

    neighborhoods = tree.query_ball_point(p, search_radius)
    for i in range(n):
        idx = np.asarray(neighborhoods[i], dtype=np.int64)
        if len(idx) < 3:
            continue
        if len(idx) > max_nn:
            d = np.linalg.norm(p[idx] - p[i], axis=1)
            idx = idx[np.argsort(d)[:max_nn]]
        # the maximumSurfaceAngle constraint: neighbours whose normals
        # disagree too much belong to another sheet of the surface
        keep = np.abs(nrm[idx] @ nrm[i]) >= cos_max_surf
        keep |= idx == i
        idx = idx[keep]
        if len(idx) < 3:
            continue

        # tangent-plane basis at p_i
        zaxis = nrm[i]
        helper = np.array([1.0, 0.0, 0.0])
        if abs(zaxis[0]) > 0.9:
            helper = np.array([0.0, 1.0, 0.0])
        u = np.cross(zaxis, helper)
        u /= np.linalg.norm(u)
        v = np.cross(zaxis, u)
        rel = p[idx] - p[i]
        uv = np.stack([rel @ u, rel @ v], axis=1)

        try:
            tri = Delaunay(uv)
        except QhullError:
            continue
        self_local = int(np.nonzero(idx == i)[0][0]) if i in idx else -1
        for simplex in tri.simplices:
            if self_local >= 0 and self_local not in simplex:
                continue  # only the point's own star (greedy locality)
            a, b, c = idx[simplex]
            # edge-length constraint (searchRadius = max edge, pcl.cpp:258)
            ab = np.linalg.norm(p[a] - p[b])
            bc = np.linalg.norm(p[b] - p[c])
            ca = np.linalg.norm(p[c] - p[a])
            if max(ab, bc, ca) > search_radius:
                continue
            if not _angles_ok(p, a, b, c, min_angle, max_angle):
                continue
            key = tuple(sorted((int(a), int(b), int(c))))
            votes[key] = votes.get(key, 0) + 1

    faces = np.array([k for k, cnt in votes.items() if cnt >= 2],
                     dtype=np.int32)
    if len(faces) == 0:
        faces = np.zeros((0, 3), np.int32)

    # orient each face along the average vertex normal (normalConsistency
    # false in the reference: orientation is per-face best effort)
    if len(faces):
        fn = np.cross(p[faces[:, 1]] - p[faces[:, 0]],
                      p[faces[:, 2]] - p[faces[:, 1]])
        ref = nrm[faces[:, 0]] + nrm[faces[:, 1]] + nrm[faces[:, 2]]
        flip = np.einsum("ij,ij->i", fn, ref) < 0
        faces[flip] = faces[flip][:, ::-1]

    verts4 = np.concatenate([p, np.ones((n, 1))], axis=1).astype(np.float32)
    return Mesh(verts4, faces)
