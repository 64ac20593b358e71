"""Minimal OBJ mesh IO plus the Mesh container used across the framework.

Matches the reference's subset: vertices and triangle faces only
(util.cpp:523-581). Vertices are stored homogeneous (N, 4) like
recon.hpp:19-21; `save_mesh` writes the dehomogenized coordinates and 1-based
face indices.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray  # (N, 4) float32 homogeneous
    faces: np.ndarray  # (M, 3) int32 vertex indices

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, dtype=np.float32).reshape(-1, 4)
        self.faces = np.asarray(self.faces, dtype=np.int32).reshape(-1, 3)

    @property
    def triangle_soup(self) -> np.ndarray:
        """(M, 3, 3) Cartesian triangle vertices (render_glx.cpp:230-258)."""
        verts3 = self.vertices[:, :3] / self.vertices[:, 3:4]
        return verts3[self.faces]


def read_mesh(file_name: str) -> Mesh:
    """Read a simple OBJ file (v/f lines only; util.cpp:523-566)."""
    verts = []
    faces = []
    with open(file_name, "r") as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(parts[1]), float(parts[2]), float(parts[3]), 1.0])
            elif parts[0] == "f":
                # face entries may be "i", "i/..." forms; fan-split polygons
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return Mesh(
        np.asarray(verts, dtype=np.float32).reshape(-1, 4),
        np.asarray(faces, dtype=np.int32).reshape(-1, 3),
    )


def save_mesh(mesh: Mesh, file_name: str) -> None:
    """Write dehomogenized vertices and 1-based faces (util.cpp:569-581)."""
    v = np.asarray(mesh.vertices, dtype=np.float64)
    f = np.asarray(mesh.faces, dtype=np.int64)
    with open(file_name, "w") as fh:
        w = v[:, 3]
        for i in range(v.shape[0]):
            fh.write(f"v {v[i, 0] / w[i]:g} {v[i, 1] / w[i]:g} {v[i, 2] / w[i]:g}\n")
        for i in range(f.shape[0]):
            fh.write(f"f {f[i, 0] + 1} {f[i, 1] + 1} {f[i, 2] + 1}\n")
