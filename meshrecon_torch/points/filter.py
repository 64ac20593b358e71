"""Density-based point-cloud filtering (outlier cut + redundancy suppression).

Port of meshrecon/points/filter.py (Heuristic::filterPoints,
heuristic.cpp:55-176):

1. the half-edge neighbour graph within the squared radius (pairs j < i,
   weight ``1 - d^2 / radius_sq``, at most 64 nearest per point), built with
   scipy's cKDTree on the host;
2. the clamped density power iteration (L1 normalization, clamp 2.0,
   1e-6 mean-square convergence, <= 200 iterations) as ``index_add_``
   segment sums on the caller's device;
3. greedy suppression along descending density in the native library.

Above 5,000 points the whole filter runs in one native call (grid-hash
neighbour search, density iteration, greedy suppression), as in the
reference package; below, the graph holds at most 64 edges per point, so
the reference's host iteration for graphs above 2M edges is never
reached and is not ported. The native library is built from the reference's C++
source (``meshing/native.py``); a failed build raises.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial import cKDTree

from meshrecon_torch.meshing import native
from meshrecon_torch.pipeline.config import resolve_device

DENSITY_LIMIT = 0.7  # heuristic.cpp:139
DENSITY_CLAMP = 2.0  # heuristic.cpp:128-129


MAX_NEIGHBORS = 64  # per-point cap; dense clouds would otherwise explode


def build_half_edges(points3: np.ndarray, radius_sq: float,
                     max_neighbors: int = MAX_NEIGHBORS):
    """Half-edge neighbor graph: pairs (i, j), j < i, with squared distance
    <= radius_sq; weights 1 - d^2/radius_sq. Returns (ei, ej, w) arrays.

    Each point contributes at most its `max_neighbors` NEAREST in-radius
    neighbors. Dense reconstructions reach ~10^6 points whose in-radius
    neighborhoods hold tens of thousands of points (radius = alpha/4 comes
    from the SPARSE bundle alpha shape, heuristic.cpp:63) — the uncapped
    graph is quadratic. Capping keeps the strongest (closest, hence
    highest-weight) edges, which dominate both the density iteration and the
    suppression.
    """
    n = len(points3)
    if n == 0:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float32)
    tree = cKDTree(points3)
    # shrink the cap for huge clouds: the kNN query cost and the edge count
    # scale with k, and dense clouds only need the strongest edges
    if n > 500_000:
        max_neighbors = min(max_neighbors, 16)
    elif n > 100_000:
        max_neighbors = min(max_neighbors, 32)
    k = min(max_neighbors + 1, n)
    ub = float(np.sqrt(radius_sq))
    rows_l, cols_l, d_l = [], [], []
    chunk = 200_000  # bound the (chunk, k) distance/index temporaries
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        dist, idx = tree.query(points3[s:e], k=k, distance_upper_bound=ub)
        rr = np.repeat(np.arange(s, e, dtype=np.int64), k)
        cc = idx.reshape(-1).astype(np.int64)
        dd = dist.reshape(-1)
        ok = (cc < n) & (cc != rr) & np.isfinite(dd)
        rows_l.append(rr[ok])
        cols_l.append(cc[ok])
        d_l.append(dd[ok])
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    d = np.concatenate(d_l)
    d2 = d * d
    ok2 = d2 <= radius_sq
    rows, cols, d2 = rows[ok2], cols[ok2], d2[ok2]
    # half edges (j < i), deduplicated (each pair may appear twice)
    ei = np.maximum(rows, cols)
    ej = np.minimum(rows, cols)
    key = ei * n + ej
    _, first = np.unique(key, return_index=True)
    ei, ej, d2 = ei[first], ej[first], d2[first]
    w = (1.0 - d2 / radius_sq).astype(np.float32)
    return ei, ej, w


def _power_iteration(ei, ej, w, n: int, max_iters: int = 200):
    """Clamped power iteration for local density on the tensors' device;
    returns (density, raw_score), where raw_score is the last accumulation
    (from the previous density), the state the reference leaves in its
    ``score`` array (heuristic.cpp:107-136). One host sync per iteration
    for the convergence test."""
    density = torch.ones(n, dtype=torch.float32, device=w.device)
    score = torch.zeros(n, dtype=torch.float32, device=w.device)
    for _ in range(max_iters):
        score = torch.zeros(n, dtype=torch.float32, device=w.device)
        score.index_add_(0, ei, density[ej] * w)
        score.index_add_(0, ej, density[ei] * w)
        total = score.sum()
        normalizer = torch.where(total > 0, n / total, 0.0)
        new_density = torch.clamp(score * normalizer, max=DENSITY_CLAMP)
        change = torch.mean((density - new_density) ** 2)
        density = new_density
        if not bool(change > 1e-6):
            break
    return density, score


def density_scores(points3: np.ndarray, radius_sq: float, device="cuda"):
    """Neighbour graph + converged density and raw scores (numpy)."""
    device = resolve_device(device)
    n = len(points3)
    ei, ej, w = build_half_edges(points3, radius_sq)
    density, score = _power_iteration(
        torch.from_numpy(ei).to(device), torch.from_numpy(ej).to(device),
        torch.from_numpy(w).to(device), n)
    return density.cpu().numpy(), score.cpu().numpy(), (ei, ej, w)


def filter_points(points4: np.ndarray, normals: np.ndarray, radius_sq: float,
                  device="cuda"):
    """Filter a point cloud; returns (points4_kept, normals_kept, kept_idx).

    radius_sq: the squared-distance radius (alpha/4 with the CGAL-convention
    alpha, heuristic.cpp:63). ``device`` runs the density iteration of
    clouds of up to 5,000 points.
    """
    device = resolve_device(device)
    points4 = np.asarray(points4, np.float32)
    normals = np.asarray(normals, np.float32)
    n = len(points4)
    if n == 0:
        return points4, normals, np.zeros(0, np.int64)
    p3 = points4[:, :3] / points4[:, 3:4]

    if n > 5_000:
        if n > 500_000:
            cap = 16
        elif n > 100_000:
            cap = 32
        else:
            cap = MAX_NEIGHBORS
        kept, _, _ = native.filter_points_full(p3, radius_sq, DENSITY_LIMIT,
                                               max_neighbors=cap,
                                               max_iters=60)
        return points4[kept], normals[kept], kept

    density, score, (ei, ej, w) = density_scores(p3, radius_sq, device)

    # descending-density order (heuristic.cpp:146)
    order = np.argsort(-density, kind="stable").astype(np.int64)

    # CSR of lower-index neighbours per point (the reference's half lists)
    sort_by_i = np.argsort(ei, kind="stable")
    ei_s, ej_s, w_s = ei[sort_by_i], ej[sort_by_i], w[sort_by_i]
    nbr_ptr = np.zeros(n + 1, np.int64)
    np.add.at(nbr_ptr, ei_s + 1, 1)
    nbr_ptr = np.cumsum(nbr_ptr)

    kept = native.greedy_suppress(order, score.astype(np.float32),
                                  density.astype(np.float32), nbr_ptr, ej_s,
                                  w_s, DENSITY_LIMIT)
    return points4[kept], normals[kept], kept
