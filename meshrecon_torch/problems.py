"""Seeded synthetic problems for the fused dense update (numpy only).

A copy of ``__graft_entry__._make_camera``, ``_plane_depth``,
``_sphere_soup`` and ``_fused_problem`` of the JAX repository, so that the
port and its chip check need nothing of the JAX side; CPU tests hold the
two array for array.
"""

from __future__ import annotations

import numpy as np


def make_camera(fov=1.1, aspect=0.75, near=1.0, far=30.0, eye=(0, 0, 0)):
    """Projection @ world-to-camera (a translation to ``eye``), float32."""
    f = 1.0 / np.tan(fov / 2.0)
    proj = np.array(
        [
            [f, 0, 0, 0],
            [0, f / aspect, 0, 0],
            [0, 0, (near + far) / (near - far), 2 * near * far / (near - far)],
            [0, 0, -1, 0],
        ],
        dtype=np.float32,
    )
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = -np.asarray(eye, dtype=np.float32)
    return proj @ w2c


def plane_depth(camera, z_world, h, w):
    """(h, w) float32 NDC depth of the world plane z = ``z_world`` seen by
    ``camera`` (float64 inverse), 1.0 where the plane lies outside the
    depth range."""
    inv = np.linalg.inv(camera.astype(np.float64))
    cols = (np.arange(w) - w / 2.0) * 2.0 / w
    rows = (h / 2.0 - np.arange(h)) * 2.0 / h
    x, y = np.meshgrid(cols, rows)
    a = np.einsum("ij,hwj->hwi", inv,
                  np.stack([x, y, np.zeros_like(x), np.ones_like(x)], axis=-1))
    b = inv[:, 2]
    t = (z_world * a[..., 3] - a[..., 2]) / (b[2] - z_world * b[3])
    return np.where(np.abs(t) <= 1, t, 1.0).astype(np.float32)


def sphere_soup(n_theta=16, n_phi=16, center=(0, 0, -5.0), radius=1.5):
    """Triangulated UV sphere as a (2*n_theta*n_phi, 3, 3) float32 soup."""
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi + 1)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    pts = np.stack(
        [
            radius * np.sin(tt) * np.cos(pp) + center[0],
            radius * np.sin(tt) * np.sin(pp) + center[1],
            radius * np.cos(tt) + center[2],
        ],
        axis=-1,
    )
    tris = []
    for i in range(n_theta):
        for j in range(n_phi):
            a, b = pts[i, j], pts[i + 1, j]
            c, d = pts[i + 1, j + 1], pts[i, j + 1]
            tris.append([a, b, c])
            tris.append([a, c, d])
    return np.asarray(tris, dtype=np.float32)


def fused_problem(b, k, h, w, seed=0, n_tris=512):
    """B fused-update problems against K sides each, at H x W: the ten
    inputs of ``fused_main_update_batched`` as numpy arrays (a 512-triangle
    sphere padded to a power of two, cameras on a line, uniform random
    frames from ``seed``)."""
    rng = np.random.default_rng(seed)
    soup = sphere_soup()
    t = len(soup)
    cap = 1
    while cap < max(t, n_tris):
        cap *= 2
    soup_pad = np.zeros((cap, 3, 3), np.float32)
    soup_pad[:t] = soup
    soup_valid = np.zeros(cap, bool)
    soup_valid[:t] = True

    mains = np.stack([make_camera(eye=(0.2 * i, 0, 0)) for i in range(b)])
    sides = np.stack(
        [
            np.stack(
                [make_camera(eye=(0.2 * i + 1.0, 0.4 * j, 0)) for j in range(k)]
            )
            for i in range(b)
        ]
    )
    fm = rng.uniform(0, 255, size=(b, h, w)).astype(np.float32)
    fs = rng.uniform(0, 255, size=(b, k, h, w)).astype(np.float32)
    centers = np.zeros((b, k + 1, 3), np.float32)
    cvalid = np.ones((b, k + 1), bool)
    return (
        soup_pad,
        soup_valid,
        mains.astype(np.float32),
        fm,
        sides.astype(np.float32),
        fs,
        np.ones((b, k), bool),
        centers,
        cvalid,
        np.full(b, k, np.int32),
    )
