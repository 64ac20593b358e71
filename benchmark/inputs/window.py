"""The inputs of a sliding-window plane sweep, made from a seed: a frozen
copy of the texture and the cameras of BASELINE configuration 4's tool.

The clip's frames are one 8x8-block uniform texture (0..255), frame j
rolled by (j mod 7, 3j mod 11) pixels; camera j looks down -z from the eye
(0.15 j, 0.05 (j mod 3), 0) with the tool's projection (fov 1.1, near 1,
far 30, aspect H/W).
"""

from __future__ import annotations

import numpy as np
import torch


def make_camera(fov=1.1, aspect=0.75, near=1.0, far=30.0, eye=(0, 0, 0)):
    """Projection @ world-to-camera (a translation to ``eye``), float32."""
    f = 1.0 / np.tan(fov / 2.0)
    proj = np.array(
        [[f, 0, 0, 0], [0, f / aspect, 0, 0],
         [0, 0, (near + far) / (near - far), 2 * near * far / (near - far)],
         [0, 0, -1, 0]], dtype=np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = -np.asarray(eye, dtype=np.float32)
    return proj @ w2c


def clip(height: int, width: int, frames: int, seed: int, device):
    """(frames (F, H, W) float32, cameras (F, 4, 4) float32) on
    ``device``; the texture drawn by a generator on that device."""
    if height % 8 or width % 8:
        raise ValueError(f"the clip's size must be a multiple of 8: "
                         f"{height}x{width}")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    base = torch.rand((height // 8, width // 8), generator=gen,
                      device=device) * 255.0
    tex = base.repeat_interleave(8, dim=0).repeat_interleave(8, dim=1)
    out = torch.stack([torch.roll(tex, (j % 7, (3 * j) % 11), dims=(0, 1))
                       for j in range(frames)])
    cams = np.stack([make_camera(eye=(0.15 * j, 0.05 * (j % 3), 0),
                                 aspect=height / width)
                     for j in range(frames)]).astype(np.float32)
    return out.contiguous(), torch.from_numpy(cams).to(device)
