"""Per-frame exposure estimation and normalization (port of
meshrecon/pipeline/exposure.py, Configuration::estimateExposure,
configuration.cpp:270-426).

Each sparse bundle's color is sampled from every frame whose track enables
it (a box average over a radius^2 = 16 disc, clipped 0/255 texels
rejected; configuration.cpp:299, util.cpp:408-433) on the host in float64.
The solve alternates per-point brightness and per-frame, per-channel gains
on the configuration's device (configuration.cpp:345-392), and the frames
collapse to grayscale as ``sum_c channel_c * exposure[c]``
(configuration.cpp:417-425).

The per-frame least squares is the minimum-norm SVD solution with the
cutoff of the JAX package's least-squares solve (singular values kept
where ``s > 0`` and ``s >= eps(float32) * max(N, C) * s[0]``). Rank-deficient
frames are the normal case, not an edge: a grayscale clip stored as BGR
has three equal channels, rank 1. torch's own least-squares solver would
not do: on CUDA it has only the ``gels`` driver, which assumes full rank,
and on the CPU its default ``gelsy`` cuts at another threshold.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from meshrecon_torch.geometry.camera import project_points
from meshrecon_torch.pipeline.config import resolve_device

OMEGA = 0.4  # over-relaxation of the gains (configuration.cpp:380)
TOLERANCE = 0.1  # stop once the mean residual is below this
MAX_ROUNDS = 100

def sample_box(image: np.ndarray, radius_sq: float, x: float, y: float,
               channel: int) -> float:
    """Mean of one channel over the disc of ``radius_sq`` around (x, y),
    texels of 0 or 255 left out; -1 when none is usable."""
    h, w = image.shape[:2]
    radius = np.sqrt(radius_sq)
    y0, y1 = int(max(0, y - radius)), int(min(y + radius + 1, h))
    x0, x1 = int(max(0, x - radius)), int(min(x + radius + 1, w))
    if y0 >= y1 or x0 >= x1:
        return -1.0
    patch = image[y0:y1, x0:x1, channel].astype(np.float64)
    yy, xx = np.mgrid[y0:y1, x0:x1]
    m = ((xx - x) ** 2 + (yy - y) ** 2 <= radius_sq) & (patch > 0) & (
        patch < 255)
    if not np.any(m):
        return -1.0
    return float(patch[m].mean())


def _solve_exposure_device(sampled, valid, device="cuda"):
    """The alternating brightness / gain solve on ``device``.

    sampled: (F, N, C) host array, -1 where unsampled; valid: (F, N) bool.
    Rows of invalid samples are zeroed in both sides of each frame's
    system, which leaves its minimum-norm solution unchanged. The SVD of
    the (F, N, C) batch is the same every round, so it is taken once.
    Returns (exposure (C, F) float64, brightness (N,) float64, info), info
    the solve's device, rounds, final mean residual and wall ms.
    """
    dev = resolve_device(device)
    t0 = time.perf_counter()
    f_count, p_count, ch = sampled.shape
    s = torch.as_tensor(np.where(valid[..., None], sampled, 0.0),
                        dtype=torch.float32, device=dev)
    v = torch.as_tensor(valid, dtype=torch.float32, device=dev)
    sum_brightness = s.sum() / ch
    wsum = v.sum(0)
    nvalid = v.sum(1).clamp(min=1.0)

    u, sv, vh = torch.linalg.svd(s, full_matrices=False)
    cutoff = torch.finfo(torch.float32).eps * max(p_count, ch)
    keep = (sv > 0) & (sv >= cutoff * sv[:, :1])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, sv, 1.0), 0.0)
    ut, vv = u.transpose(1, 2), vh.transpose(1, 2)

    exposure = torch.full((ch, f_count), 1.0 / ch, dtype=torch.float32,
                          device=dev)
    brightness = torch.ones(p_count, dtype=torch.float32, device=dev)
    err, rounds = float("inf"), 0
    while err >= TOLERANCE and rounds < MAX_ROUNDS:
        # (a) the gains held: per-point brightness
        per_fp = torch.einsum("fpc,cf->fp", s, exposure)
        brightness = torch.where(wsum > 0, per_fp.sum(0) / wsum.clamp(min=1.0),
                                 0.0)
        brightness = brightness * (sum_brightness
                                   / per_fp.sum().clamp(min=1e-12))
        # (b) the brightness held: each frame's gains by least squares
        b = brightness[None, :] * v
        utb = (ut @ b[..., None])[..., 0]
        sol = (vv @ (s_inv * utb)[..., None])[..., 0]  # (F, C)
        exposure = sol.T * (1 + OMEGA) - exposure * OMEGA
        resid = torch.einsum("fpc,cf->fp", s, exposure) - b
        err = float(torch.mean(torch.linalg.vector_norm(resid, dim=1)
                               / nvalid))
        rounds += 1
    exposure = exposure.cpu().numpy().astype(np.float64)
    brightness = brightness.cpu().numpy().astype(np.float64)
    info = dict(device=str(dev), rounds=rounds, err=err,
                ms=(time.perf_counter() - t0) * 1e3)
    return exposure, brightness, info


def estimate_exposure(frames, cameras, bundles, bundles_enabled,
                      lens_distortion, center_x, center_y, width, height,
                      verbose=False, dump_tab: bool = False, device="cuda"):
    """Estimate the exposure gains and return the normalized gray frames.

    frames: (H, W, 3) uint8 BGR frames; cameras: (F, 4, 4); bundles:
    (N, 4). The projection and the solve run on ``device``; the sampling,
    ``exposure.tab`` (with ``dump_tab``, in the working directory, as the
    reference writes it) and the gray blend (float64, cast to float32,
    clipped to 0..255) on the host. Returns (gray (F, H, W) float32 numpy,
    exposure (C, F) float64).
    """
    f_count = len(cameras)
    p_count = len(bundles)
    ch = frames[0].shape[2]
    aspect = float(height) / float(width)

    sampled = np.full((f_count, p_count, ch), -1.0)
    valid = np.zeros((f_count, p_count), bool)
    for i in range(f_count):
        ndc = project_points(cameras[i], bundles, lens_distortion, aspect,
                             device=device).cpu().numpy()
        for j in range(p_count):
            if i not in bundles_enabled[j]:
                continue
            img_x = center_x + ndc[j, 0] * width * 0.5
            img_y = height - center_y - ndc[j, 1] * height * 0.5
            vals = [sample_box(frames[i], 16.0, img_x, img_y, c)
                    for c in range(ch)]
            if all(v >= 0 for v in vals):
                sampled[i, j] = vals
                valid[i, j] = True
        if valid[i].sum() < ch:
            raise RuntimeError(
                f"frame {i}: too few valid exposure samples "
                "(configuration.cpp:315-318 aborts here too)")

    exposure, brightness, info = _solve_exposure_device(sampled, valid,
                                                        device)
    if verbose:
        print(f"exposure: solve on {info['device']}, {info['rounds']} "
              f"rounds, mean residual {info['err']:.6f}, {info['ms']:.3f} ms")

    if dump_tab:
        # per frame the channel gains and the residual's RMS
        # (configuration.cpp:395-415)
        with open("exposure.tab", "w") as fh:
            for i in range(f_count):
                res = []
                for j in range(p_count):
                    if not valid[i, j]:
                        continue
                    for c in range(ch):
                        res.append(sampled[i, j, c]
                                   - exposure[c, i] * brightness[j])
                stddev = float(np.sqrt(np.mean(np.square(res)))) if res \
                    else 0.0
                gains = "\t".join(f"{exposure[c, i]:f}" for c in range(ch))
                fh.write(f"{gains}\t{stddev:f}\n")

    gray = np.zeros((f_count,) + frames[0].shape[:2], np.float32)
    for i in range(f_count):
        gray[i] = np.einsum("hwc,c->hw", frames[i].astype(np.float32),
                            exposure[:, i]).astype(np.float32)
    return np.clip(gray, 0, 255), exposure
