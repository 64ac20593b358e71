"""Per-iteration checkpoint/resume.

The reference has no true checkpointing (SURVEY.md section 5): only the `-m`
initial-mesh flag and `-V` artifact dumps. Here every iteration serializes
(points, normals, alpha values, iteration index, RNG state) so long runs can
resume exactly; `--resume` picks up the latest checkpoint.
"""

from __future__ import annotations

import os
import pickle

import numpy as np


def save_checkpoint(dir_path, points, normals, alpha_vals, iteration, rng_state):
    os.makedirs(dir_path, exist_ok=True)
    path = os.path.join(dir_path, f"iter_{iteration:03d}.npz")
    tmp = path + ".tmp.npz"  # write-then-rename for crash safety
    np.savez(
        tmp,
        points=points,
        normals=normals,
        alpha_vals=np.asarray(alpha_vals, np.float64),
        iteration=np.asarray(iteration),
        rng_state=np.frombuffer(pickle.dumps(rng_state), dtype=np.uint8),
    )
    os.replace(tmp, path)


def load_checkpoint(dir_path):
    if not os.path.isdir(dir_path):
        return None
    snaps = sorted(f for f in os.listdir(dir_path)
                   if f.startswith("iter_") and f.endswith(".npz"))
    if not snaps:
        return None
    data = np.load(os.path.join(dir_path, snaps[-1]), allow_pickle=False)
    rng_state = pickle.loads(data["rng_state"].tobytes())
    return (
        data["points"].astype(np.float32),
        data["normals"].astype(np.float32),
        list(data["alpha_vals"]),
        int(data["iteration"]),
        rng_state,
    )
