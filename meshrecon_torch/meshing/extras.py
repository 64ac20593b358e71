"""Normal scaling for the Poisson splat (port of
meshrecon/meshing/extras.py::normalize_normals_average, pcl.cpp:39-44).
"""

from __future__ import annotations

import numpy as np


def normalize_normals_average(normals: np.ndarray) -> np.ndarray:
    """Scale so the AVERAGE normal length is 1 (magnitude = confidence).

    Non-finite rows are zeroed first: a single NaN would otherwise poison
    the average and with it every normal."""
    n = np.asarray(normals, np.float32)
    n = np.where(np.isfinite(n), n, 0.0)
    lengths = np.linalg.norm(n, axis=1)
    avg = float(lengths.mean()) if len(lengths) else 0.0
    if avg <= 0:
        return n
    return n / avg
