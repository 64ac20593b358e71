"""Vertex-clustering mesh decimation.

The reference's CGAL Poisson mesher is ADAPTIVE (triangle size tracks the
point-set spacing, cgal_poisson.cpp:93-95), so its meshes stay small; our
uniform-grid marching tetrahedra can emit hundreds of thousands of faces on
large scenes, which the renderer then pays for every depth pass. Vertex
clustering (quantize vertices to a grid, merge clusters, drop degenerate
faces) brings face counts back to the adaptive regime with bounded error of
one cluster cell.
"""

from __future__ import annotations

import numpy as np

from meshrecon_torch.io.obj import Mesh


def decimate_vertex_clustering(mesh: Mesh, target_faces: int) -> Mesh:
    """Cluster vertices on a uniform grid sized to hit ~target_faces."""
    if len(mesh.faces) <= target_faces or len(mesh.faces) == 0:
        return mesh
    v3 = mesh.vertices[:, :3] / mesh.vertices[:, 3:4]
    lo = v3.min(axis=0)
    hi = v3.max(axis=0)
    span = float(np.max(hi - lo))
    if span <= 0:
        return mesh
    # face count scales ~ (span/cell)^2 for surfaces: an initial cell,
    # refined by the loop below
    cell = span / max(2.0, (np.sqrt(2.0 * target_faces)))

    faces = mesh.faces
    for _ in range(8):
        q = np.floor((v3 - lo) / cell).astype(np.int64)
        key = (q[:, 0] << 42) | (q[:, 1] << 21) | q[:, 2]
        uniq, inv = np.unique(key, return_inverse=True)
        # cluster representative: mean position
        sums = np.zeros((len(uniq), 3))
        np.add.at(sums, inv, v3)
        counts = np.bincount(inv)
        reps = sums / counts[:, None]
        f = inv[faces]
        ok = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
        f = f[ok]
        # dedup identical faces (ignoring rotation)
        fs = np.sort(f, axis=1)
        _, first = np.unique(
            (fs[:, 0].astype(np.int64) * len(uniq) + fs[:, 1]) * len(uniq)
            + fs[:, 2],
            return_index=True,
        )
        f = f[np.sort(first)]
        if len(f) <= target_faces or len(f) == 0:
            verts4 = np.concatenate(
                [reps, np.ones((len(reps), 1))], axis=1
            ).astype(np.float32)
            return Mesh(verts4, f.astype(np.int32))
        cell *= (len(f) / target_faces) ** 0.5 * 1.1
    verts4 = np.concatenate([reps, np.ones((len(reps), 1))], axis=1).astype(
        np.float32
    )
    return Mesh(verts4, f.astype(np.int32))
