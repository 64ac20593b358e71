"""The numbers that decide ``correct``: what the timed path produced against
the plain reference's answer to the same inputs, each a widest or tail gap
over the checked outputs, in NumPy.

The limits are a cell's own (``benchmark/limits/<cell>.json``); a cell is
correct when every number is at or under its limit.
"""

from __future__ import annotations

import numpy as np


def _gap(a, b):
    """|a - b|, float64, where both are finite; 0 where both are the same
    non-finite value (NaN with NaN); inf where only one is finite or the
    two non-finite values differ."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    fa, fb = np.isfinite(a), np.isfinite(b)
    same = (np.isnan(a) & np.isnan(b)) | (a == b)
    with np.errstate(invalid="ignore"):
        gap = np.abs(a - b)
    return np.where(fa & fb, gap, np.where(same, 0.0, np.inf))


def _points(point4):
    p = point4.astype(np.float64)
    w = np.where(np.abs(p[..., 3:4]) < 1e-30, 1e-30, p[..., 3:4])
    return p[..., :3] / w


def _tail(values, q: float) -> float:
    return (float(np.quantile(values, q, method="higher")) if values.size
            else float("inf"))


def _scaled(gap, ref_size):
    """gap over the larger of the reference's own size and the median of
    its finite sizes."""
    finite = ref_size[np.isfinite(ref_size)]
    floor = float(np.median(finite)) if finite.size else 0.0
    size = np.where(np.isfinite(ref_size), ref_size, 0.0)
    return gap / np.maximum(np.maximum(size, floor), 1e-30)


def flow_readings(prog: dict, ref: dict, radius: float) -> dict:
    """The flow update's numbers over its B main frames:

    - ``depth_max``: widest gap of the mixed depth (NDC);
    - ``valid_mismatch``: share of pixels whose validity differs;
    - ``point_p50``, ``point_p99``, ``point_max``: over pixels valid on
      both sides, the median, 99th percentile and largest 3-D distance
      between the points, over the fitted sphere's radius;
    - ``normal_p99``, ``pdf_p99``: over the same pixels, the 99th
      percentile of the gap of the (pdf-scaled) normal and of the pdf,
      each over the larger of the reference's own size and its median.
    """
    vp = prog["valid"].astype(bool)
    vr = ref["valid"].astype(bool)
    both = vp & vr
    dist = np.linalg.norm(_gap(_points(prog["point4"])[both],
                               _points(ref["point4"])[both]),
                          axis=-1) / radius
    n_r = ref["normals"].astype(np.float64)[both]
    n_gap = np.linalg.norm(_gap(prog["normals"][both], n_r), axis=-1)
    pdf_r = ref["pdf"].astype(np.float64)[both]
    pdf_gap = _gap(prog["pdf"][both], pdf_r)
    return {
        "depth_max": float(_gap(prog["depth"], ref["depth"]).max()),
        "valid_mismatch": float((vp != vr).mean()),
        "point_p50": _tail(dist, 0.5),
        "point_p99": _tail(dist, 0.99),
        "point_max": _tail(dist, 1.0),
        "normal_p99": _tail(_scaled(n_gap, np.linalg.norm(n_r, axis=-1)),
                            0.99),
        "pdf_p99": _tail(_scaled(pdf_gap, pdf_r), 0.99),
    }


def sweep_readings(prog: dict, ref: dict) -> dict:
    """The plane sweep's numbers over its main frame:

    - ``depth_max``: widest gap of the refined depth (NDC; background
      where invalid);
    - ``cost_max``: widest gap of the best cost over the reference's
      median cost;
    - ``valid_mismatch``: share of pixels whose validity differs.
    """
    c_r = ref["cost"].astype(np.float64)
    finite = np.abs(c_r[np.isfinite(c_r)])
    scale = max(float(np.median(finite)) if finite.size else 0.0, 1e-30)
    return {
        "depth_max": float(_gap(prog["depth"], ref["depth"]).max()),
        "cost_max": float(_gap(prog["cost"], c_r).max() / scale),
        "valid_mismatch": float((prog["valid"].astype(bool)
                                 != ref["valid"].astype(bool)).mean()),
    }


def worst(readings: list) -> dict:
    """Each number's largest reading over several checked outputs."""
    if not readings:
        return {}
    return {k: max(r[k] for r in readings) for k in readings[0]}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every limited number at or
    under its limit, and every limit read."""
    table = {name: {"value": numbers.get(name, float("inf")),
                    "limit": limit} for name, limit in limits.items()}
    ok = bool(table) and all(row["value"] <= row["limit"]
                             for row in table.values())
    return ok, table
