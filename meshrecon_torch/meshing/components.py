"""Connected-component support filtering for reconstructed meshes.

The FFT Poisson indicator can produce spurious detached sheets far from the
data (halos from outlier points and periodic-boundary leakage) — measured as
the heavy p90 tail in tools/quality_harness.py. CGAL's surface mesher largely
avoids this because its Delaunay refinement only grows from a seed inside the
implicit surface (cgal_poisson.cpp:81). Equivalent cure here: label mesh
components (vertex-sharing, scipy sparse connected_components) and keep those
actually SUPPORTED by the input cloud — each input point votes for the
component of its nearest mesh vertex.
"""

from __future__ import annotations

import numpy as np
from scipy import sparse
from scipy.spatial import cKDTree

from meshrecon_torch.io.obj import Mesh


def keep_supported_components(mesh: Mesh, points, min_vote_frac: float = 0.01,
                              max_votes: int = 5000, seed: int = 0) -> Mesh:
    """Drop mesh components that receive fewer than min_vote_frac of the
    input points' nearest-vertex votes."""
    if len(mesh.faces) == 0 or len(points) == 0:
        return mesh
    pts = np.asarray(points, np.float64)
    if pts.shape[1] == 4:
        pts = pts[:, :3] / pts[:, 3:4]

    nv = len(mesh.vertices)
    e = np.concatenate([mesh.faces[:, [0, 1]], mesh.faces[:, [1, 2]],
                        mesh.faces[:, [2, 0]]])
    adj = sparse.coo_matrix(
        (np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(nv, nv)
    )
    n_comp, labels = sparse.csgraph.connected_components(adj, directed=False)
    if n_comp <= 1:
        return mesh

    if len(pts) > max_votes:
        sel = np.random.default_rng(seed).choice(len(pts), max_votes,
                                                 replace=False)
        pts = pts[sel]
    v3 = mesh.vertices[:, :3] / mesh.vertices[:, 3:4]
    tree = cKDTree(v3)
    _, nearest = tree.query(pts, k=1)
    votes = np.bincount(labels[nearest], minlength=n_comp)
    keep = votes >= max(1, min_vote_frac * len(pts))
    if not keep.any():
        keep[np.argmax(votes)] = True

    face_keep = keep[labels[mesh.faces[:, 0]]]
    return _compact(mesh, face_keep)


def _compact(mesh: Mesh, face_keep: np.ndarray) -> Mesh:
    faces = mesh.faces[face_keep]
    nv = len(mesh.vertices)
    used = np.zeros(nv, bool)
    used[faces.reshape(-1)] = True
    remap = -np.ones(nv, np.int64)
    remap[used] = np.arange(used.sum())
    return Mesh(mesh.vertices[used], remap[faces].astype(np.int32))


def trim_unsupported_faces(mesh: Mesh, points, max_dist: float,
                           max_support: int = 100_000,
                           seed: int = 0) -> Mesh:
    """Drop faces whose centroid lies farther than ``max_dist`` from every
    input point (then re-drop any detached slivers the cut created).

    The analog of screened Poisson's density trimming (SPSR ``--trim``):
    the FFT indicator closes the surface through regions with NO data —
    on partial-coverage scenes (koule's camera arc sees one side) the
    far side is pure hallucination, attached to the supported sheet, so
    component voting (above) cannot remove it. Measured round-3: the
    error p90 ~0.5 r is config-insensitive precisely because it lives on
    those unsupported regions.
    """
    if len(mesh.faces) == 0 or len(points) == 0 or max_dist <= 0:
        return mesh
    pts = np.asarray(points, np.float64)
    if pts.shape[1] == 4:
        pts = pts[:, :3] / pts[:, 3:4]
    if len(pts) > max_support:
        sel = np.random.default_rng(seed).choice(len(pts), max_support,
                                                 replace=False)
        pts = pts[sel]
    v3 = (mesh.vertices[:, :3] / mesh.vertices[:, 3:4]).astype(np.float64)
    centroids = v3[mesh.faces].mean(axis=1)
    dist, _ = cKDTree(pts).query(centroids, k=1,
                                 distance_upper_bound=max_dist * 1.0001)
    trimmed = _compact(mesh, np.isfinite(dist) & (dist <= max_dist))
    # the cut can strand slivers of the formerly-connected sheet
    return keep_supported_components(trimmed, pts)
