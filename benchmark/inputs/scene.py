"""The inputs of a track's dense flow update, made from a seed: the
track's cameras and frames, the mesh the update renders, and the bundles
of main and side cameras.

- Frames: a frozen copy of the program's ``--synthetic sphere`` frame
  maker, the sphere fitted to the track's bundle points ray-traced for
  every camera and textured with 3-D value noise, on the card.
- Mesh: a UV sphere (``rings`` x ``segments`` quads, two triangles each,
  so the pole rows hold one degenerate triangle a quad) on the fitted
  sphere, its radius moved by a smooth seeded field whose median |r - R|/R
  is the configuration's ``radial_noise``; sorted by the Morton code of
  the centroids, as the program's renderer loads a mesh.
- Bundles: a main camera and its distinct sides among the main's nearest
  cameras, padded to the side bucket as the program's batching pads:
  identity cameras, zero frames, invalid; the centers of the main and its
  sides, padded to the next power of two above the bucket.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.inputs.tracks import load_tracks
from benchmark.reference.raster import pixel_grid


def value_noise(p, seed: int):
    """Procedural 3-D value noise in [0, 1]; p: (..., 3) world coords."""
    acc = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    amp = 0.5
    seed_term = torch.tensor(float(seed), dtype=torch.float32) * 13.7

    def fma(a, b: float, c):
        b = float(np.float32(b))
        return (a.to(torch.float64) * b + c.to(torch.float64)).to(
            torch.float32)

    def hash3(c):
        h = fma(c[..., 2], 74.7, fma(c[..., 0], 127.1, c[..., 1] * 311.7))
        h = h + seed_term.to(c.device)
        return torch.remainder((torch.sin(h) * 43758.5453).abs(), 1.0)

    for octave in range(4):
        q = p * (2.0 ** octave) * 3.0
        base = torch.floor(q)
        f = q - base
        f = f * f * (3.0 - 2.0 * f)
        v = 0.0
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    corner = base + torch.tensor([dx, dy, dz],
                                                 dtype=torch.float32,
                                                 device=p.device)
                    w = ((f[..., 0] if dx else 1 - f[..., 0])
                         * (f[..., 1] if dy else 1 - f[..., 1])
                         * (f[..., 2] if dz else 1 - f[..., 2]))
                    v = v + w * hash3(corner)
        acc = acc + amp * v
        amp *= 0.5
    return acc / 0.9375


def _camera_rays(cam, x, y):
    inv = torch.linalg.inv(cam)
    a = torch.einsum("ij,hwj->hwi", inv,
                     torch.stack([x, y, torch.zeros_like(x),
                                  torch.ones_like(x)], dim=-1))
    b = inv[:, 2][None, None, :]

    def at(t):
        h = a + t * b
        return h[..., :3] / h[..., 3:4]

    o = at(-1.0)
    return o, at(1.0) - o


def sphere_frames(cameras, center, radius, height: int, width: int,
                  seed: int):
    """(frames (F, H, W) float32 in 0..255, the share of each frame's
    pixels on the sphere (F,)), on the cameras' device."""
    dev = cameras.device
    cols, rows = pixel_grid(height, width, dev)
    x = cols[None, :].expand(height, width)
    y = rows[:, None].expand(height, width)
    center = torch.as_tensor(center, dtype=torch.float32, device=dev)
    r2 = float(np.float32(radius) * np.float32(radius))
    bg = value_noise(torch.stack([x * 4.0, y * 4.0, torch.zeros_like(x)],
                                 dim=-1), seed + 1) * 40.0 + 10.0
    frames, shares = [], []
    for cam in cameras.to(torch.float32):
        o, d = _camera_rays(cam, x, y)
        oc = o - center
        A = (d * d).sum(-1)
        B = 2.0 * (oc * d).sum(-1)
        C = (oc * oc).sum(-1) - r2
        disc = B * B - 4 * A * C
        hit = disc > 0
        sq = torch.sqrt(disc.clamp(min=0.0))
        s = (-B - sq) / (2 * A.clamp(min=1e-12))
        s = torch.where(s > 0, s, (-B + sq) / (2 * A.clamp(min=1e-12)))
        hit &= s > 0
        p = o + s[..., None] * d
        tex = value_noise(p, seed) * 175.0 + 60.0
        frames.append(torch.where(hit, tex, bg))
        shares.append(hit.to(torch.float32).mean())
    return torch.stack(frames), torch.stack(shares)


def fit_sphere(bundles: np.ndarray):
    """Centroid and mean distance of the bundle cloud: (center, radius)."""
    p3 = bundles[:, :3] / bundles[:, 3:4]
    center = p3.mean(axis=0)
    radius = float(np.mean(np.linalg.norm(p3 - center, axis=1)))
    return center.astype(np.float32), max(radius, 1e-3)


def morton_order(soup: torch.Tensor) -> torch.Tensor:
    """Permutation ordering triangles by the Morton code of their centroid
    (10 bits an axis), stable."""
    cent = soup.to(torch.float64).mean(dim=1)
    lo = cent.amin(dim=0)
    span = (cent.amax(dim=0) - lo).clamp(min=1e-12)
    q = ((cent - lo) / span * 1023.0).to(torch.int64).clamp(max=1023)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return torch.sort(code, stable=True).indices


def noisy_uv_sphere(center, radius: float, rings: int, segments: int,
                    median_noise: float, rng: np.random.Generator,
                    device, terms: int = 12):
    """(soup (2*rings*segments, 3, 3) float32, valid (T,) bool): a UV
    sphere whose radius at each vertex is R (1 + f), f a sum of ``terms``
    low-frequency products of sines with seeded frequencies, phases and
    weights, scaled so that the median |f| over the vertices is
    ``median_noise``; Morton-sorted."""
    theta = torch.linspace(0.0, np.pi, rings + 1, dtype=torch.float64,
                           device=device)[:, None]
    phi = torch.linspace(0.0, 2 * np.pi, segments + 1, dtype=torch.float64,
                         device=device)[None, :]
    freq_t = rng.integers(1, 7, size=terms)
    freq_p = rng.integers(0, 7, size=terms)
    phase = rng.uniform(0.0, 2 * np.pi, size=(terms, 2))
    weight = rng.normal(size=terms) / np.arange(1, terms + 1)
    f = torch.zeros((rings + 1, segments + 1), dtype=torch.float64,
                    device=device)
    for j in range(terms):
        f = f + float(weight[j]) * torch.sin(
            int(freq_t[j]) * theta + float(phase[j, 0])) * torch.cos(
                int(freq_p[j]) * phi + float(phase[j, 1]))
    # one radius a pole, and the seam's two columns alike
    f[0, :] = f[0, 0]
    f[-1, :] = f[-1, 0]
    f[:, -1] = f[:, 0]
    f = f * (median_noise / f.abs().median())
    r = radius * (1.0 + f)
    verts = torch.stack([r * torch.sin(theta) * torch.cos(phi),
                         r * torch.sin(theta) * torch.sin(phi),
                         r * torch.cos(theta).expand_as(r)], dim=-1)
    verts = verts + torch.as_tensor(center, dtype=torch.float64,
                                    device=device)
    v00 = verts[:-1, :-1].reshape(-1, 3)
    v01 = verts[:-1, 1:].reshape(-1, 3)
    v10 = verts[1:, :-1].reshape(-1, 3)
    v11 = verts[1:, 1:].reshape(-1, 3)
    tris = torch.cat([torch.stack([v00, v10, v11], dim=1),
                      torch.stack([v00, v11, v01], dim=1)]).to(torch.float32)
    tris = tris[morton_order(tris)].contiguous()
    return tris, torch.ones(tris.shape[0], dtype=torch.bool, device=device)


def camera_center(camera: np.ndarray) -> np.ndarray:
    """Cartesian center of a 4x4 camera: the null vector of its x, y and w
    rows."""
    p34 = np.asarray(camera, dtype=np.float64)[(0, 1, 3), :]
    c = np.linalg.svd(p34)[2][-1]
    if c[3] < 0:
        c = -c
    return (c[:3] / c[3]).astype(np.float32)


def draw_bundles(centers: np.ndarray, side_counts, n_bundles: int,
                 nearest: int, rng: np.random.Generator):
    """``n_bundles`` (main, sides) pairs: the mains a seeded walk through
    every camera in turn (each as often as the count allows), each main's
    sides distinct cameras among its ``nearest`` neighbours by center, as
    many as the side counts (cycled to the bundle count, then shuffled)
    say."""
    n = len(centers)
    counts = np.resize(np.asarray(side_counts, int), n_bundles)
    counts = counts[rng.permutation(n_bundles)]
    mains = np.concatenate([rng.permutation(n)
                            for _ in range(-(-n_bundles // n))])[:n_bundles]
    dist = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
    bundles = []
    for main, k in zip(mains, counts):
        near = [int(j) for j in np.argsort(dist[main], kind="stable")
                if j != main][:nearest]
        sides = rng.choice(near, size=int(k), replace=False)
        bundles.append((int(main), [int(s) for s in sides]))
    return bundles


def batch_inputs(group, cameras, frames, centers, soup, soup_valid, kb: int):
    """The ten update inputs of a group of bundles, sides padded to ``kb``
    and centers to the next power of two above ``kb``; on the frames'
    device."""
    dev = frames.device
    h, w = frames.shape[1:]
    b = len(group)
    cb = 1
    while cb < kb + 1:
        cb *= 2
    mains = np.zeros((b, 4, 4), np.float32)
    scs = np.tile(np.eye(4, dtype=np.float32), (b, kb, 1, 1))
    svs = np.zeros((b, kb), bool)
    ctrs = np.zeros((b, cb, 3), np.float32)
    cvs = np.zeros((b, cb), bool)
    ks = np.zeros(b, np.int32)
    fms = torch.stack([frames[fa] for fa, _ in group])
    sfs = torch.zeros((b, kb, h, w), dtype=torch.float32, device=dev)
    for i, (fa, sides) in enumerate(group):
        mains[i] = cameras[fa]
        for j, fb in enumerate(sides):
            scs[i, j] = cameras[fb]
            sfs[i, j] = frames[fb]
            svs[i, j] = True
        c3 = np.stack([centers[fa]] + [centers[fb] for fb in sides])
        ctrs[i, :len(c3)] = c3
        cvs[i, :len(c3)] = True
        ks[i] = len(sides)
    host = [torch.from_numpy(a).to(dev) for a in (mains, scs, svs, ctrs, cvs,
                                                  ks)]
    mains_t, scs_t, svs_t, ctrs_t, cvs_t, ks_t = host
    return (soup, soup_valid, mains_t, fms.contiguous(), scs_t, sfs, svs_t,
            ctrs_t, cvs_t, ks_t)


def load_track(path: str):
    """(cameras (F, 4, 4) float32, bundle points (N, 4)) of a track."""
    track = load_tracks(path)
    return np.asarray(track.cameras, np.float32), track.bundles
