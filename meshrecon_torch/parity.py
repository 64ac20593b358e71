"""Agreement between two runs of the fused update on the same inputs.

One set of bounds for every comparison of whole-update outputs: the port
against the JAX package on the CPU, the port's CUDA run against its plain
CPU run. Why each bound has its size:

- depth: renders agree to the last bits; the background-mix chain can
  flip a mask at a shadow-test tie.
- valid: a last-bit change can flip a threshold test on a few pixels.
- point4: the Gauss-Newton solve agrees to float32 rounding, except at the
  at most 64 pixels per item that the global exit leaves mid-oscillation
  (0.08% of the valid pixels at 640x480).
- pdf = exp(log det + quadratic form / variance): the quadratic form is
  large where the reprojection Jacobian is small, so log pdf amplifies the
  last bits of the flow and the variance.
- normals: the axis is the smallest eigenvector of a 21x21-window
  covariance of the triangulated points. Where those points are rough
  (noise frames) the covariance is near-isotropic and the axis follows
  the points' last bits: at 640x480 on the seeded noise problem, a
  one-ulp perturbation of point4 alone moves the axis by more than 1e-3
  on 12.2% of pixels and by more than 0.1 on 1.1% (float32 vs float64
  inside the eigen-solve: 1.3e-7). The orientation is the sign of a
  camera vote sum 1/(n.(c - p)), near 0 where the view ray grazes the
  surface (0.06% flip under that perturbation). The length follows
  pdf^(1/K).
"""

from __future__ import annotations

import numpy as np

# name -> (kind, bound): "min" metrics must be >= bound, "max" <= bound
SLICE_BOUNDS = {
    "depth_within_1e-3": ("min", 0.995),
    "valid_agree": ("min", 0.995),
    "point4_within_1e-3": ("min", 0.999),
    "pdf_within_1e-3": ("min", 0.98),
    "log_pdf_diff": ("max", 0.25),
    "normal_len_rel": ("max", 0.15),
    "normal_axis_within_1e-3": ("min", 0.8),
    "normal_axis_within_0.1": ("min", 0.97),
    "normal_flips": ("max", 2e-3),
}


def _norm(v):
    return np.linalg.norm(v, axis=-1)


def slice_agreement(ours: dict, ref: dict) -> dict:
    """Metrics of SLICE_BOUNDS for two output dicts of numpy arrays
    (point4, normals, pdf, valid, depth; any leading shape)."""
    both = ours["valid"] & ref["valid"]
    p4o, p4r = ours["point4"][both], ref["point4"][both]
    po, pr = ours["pdf"][both], ref["pdf"][both]
    no, nr = ours["normals"][both], ref["normals"][both]
    lo, lr = _norm(no), _norm(nr)
    uo, ur = no / lo[:, None], nr / lr[:, None]
    axis = np.minimum(_norm(uo - ur), _norm(uo + ur))
    return {
        "depth_within_1e-3": float(np.mean(
            np.abs(ours["depth"] - ref["depth"]) <= 1e-3)),
        "valid_agree": float(np.mean(ours["valid"] == ref["valid"])),
        "point4_within_1e-3": float(np.mean(
            _norm(p4o - p4r) <= 1e-3 * _norm(p4r))),
        "pdf_within_1e-3": float(np.mean(np.abs(po - pr) <= 1e-3 * pr)),
        "log_pdf_diff": float(np.abs(np.log(po) - np.log(pr)).max()),
        "normal_len_rel": float((np.abs(lo - lr) / lr).max()),
        "normal_axis_within_1e-3": float(np.mean(axis <= 1e-3)),
        "normal_axis_within_0.1": float(np.mean(axis <= 0.1)),
        "normal_flips": float(np.mean(np.sum(uo * ur, axis=-1) < 0)),
    }


def check_slice(ours: dict, ref: dict, bounds: dict | None = None) -> dict:
    """slice_agreement, raising AssertionError on any bound it misses;
    ``bounds`` replaces some of SLICE_BOUNDS' values (name -> bound)."""
    metrics = slice_agreement(ours, ref)
    limits = {k: (kind, (bounds or {}).get(k, bound))
              for k, (kind, bound) in SLICE_BOUNDS.items()}
    missed = [f"{k} {metrics[k]:.3e} ({kind} {bound})"
              for k, (kind, bound) in limits.items()
              if not (metrics[k] >= bound if kind == "min"
                      else metrics[k] <= bound)]
    if missed:
        raise AssertionError("fused outputs disagree: " + "; ".join(missed))
    return metrics
