"""The yardstick's arithmetic: the card's published peaks, the least bytes
and float32 operations of each stage of the measured work, computed from
shapes, and the least time they need.

The stage split and the kernels' operation counts are frozen copies of
the program's stage arithmetic (its fused-update breakdown tool and its
chip check's count for the masked bilinear sample, K3c): each tensor a
stage reads from the inputs or from earlier stages counted once, each it
hands on once, whatever the implementation reads again.
"""

from __future__ import annotations

# NVIDIA H100 SXM, published (data sheet; dense, no sparsity), at its
# 700 W power limit: HBM3 bandwidth and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# float32 operations a pixel of the ported kernels: K2 (bilinear weights
# and taps, the nearest pick), K3 (the bilinear warp), K4 (22 for the
# linearization, 33 a sweep)
K2_OPS = 24
K3_OPS = 22
K4_LIN_OPS = 22
K4_SWEEP_OPS = 33
# K3c a valid pixel (coordinates, weights, four taps)
K3C_OPS = 22
# the sweep's cost a side and pixel: the side projection (three rows of
# the 4x4 product, two divides, the frame tests, the pixel coordinates)
# and the weighted absolute difference summed over the sides
SWEEP_COST_OPS = 37


def least_s(nbytes: float, ops: float) -> float:
    """The least seconds the card needs to move ``nbytes`` and to do
    ``ops`` float32 operations: the larger of the two."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS)


def raster_ops(ncam: int, ntri: int, covered: float, h: int, w: int):
    """The raster's operations for ``ncam`` renders of ``ntri`` valid
    triangles: each vertex projected by each camera (4x4 x 4: 28) and, at
    least, one fragment a covered pixel (3 edge functions + the depth
    plane, 4 each)."""
    return ncam * ntri * 3 * 28 + covered * ncam * h * w * 16


def flow_levels(height: int, width: int, levels: int):
    """The (h, w) of each pyramid level the flow solves."""
    h, w, out = height, width, []
    for _ in range(levels):
        out.append((h, w))
        if min(h, w) <= 12:
            break
        h, w = (h + 1) // 2, (w + 1) // 2
    return out


def flow_update_stages(b: int, k: int, height: int, width: int,
                       n_tri: int, n_tri_valid: int, n_centers: int,
                       covered: float, levels: int, sweeps: int) -> dict:
    """Per stage of the flow update, (least bytes, float32 operations of
    the ported kernels or 0) of an update of ``b`` mains with ``k`` padded
    sides, on a soup of ``n_tri`` triangles (``n_tri_valid`` valid)."""
    n, ncam, px = b * k, b * (k + 1), height * width
    plane = px * 4
    mat = 64
    flow_ops = sum(n * h * w * (K3_OPS + K4_LIN_OPS + sweeps * K4_SWEEP_OPS)
                   for h, w in flow_levels(height, width, levels))
    return {
        "depth0": (ncam * mat + n_tri * 36 + n_tri + ncam * plane,
                   raster_ops(ncam, n_tri_valid, covered, height, width)),
        "scan": (ncam * mat + (2 * b + 2 * n) * plane + n + (b + n) * plane,
                 K2_OPS * n * px),
        "flow": ((b + n) * plane + 5 * n * plane, flow_ops),
        "rewarp": ((b + 6 * n) * plane, 0),
        "var": ((b + 2 * n) * plane, 0),
        "tri": (3 * n * plane + ncam * mat + n + b * plane + 5 * b * plane
                + b * px, 0),
        "all": (5 * b * plane + b * px + n_centers * 12 + n_centers + b * 4
                + 3 * b * plane, 0),
    }


def k4_work(n: int, height: int, width: int, levels: int, sweeps: int):
    """(bytes, operations) of the flow solve's K4 launches, one a level:
    the source, the warped target and the linearization point's two
    planes read, the flow's two planes written; the linearization and
    ``sweeps`` sweeps a pixel."""
    nbytes = ops = 0
    for h, w in flow_levels(height, width, levels):
        nbytes += n * h * w * 6 * 4
        ops += n * h * w * (K4_LIN_OPS + sweeps * K4_SWEEP_OPS)
    return nbytes, ops


def k3c_work(px: float, share: float):
    """(bytes, operations) of K3c on ``px`` pixels of which ``share`` are
    valid, as the data needs them: every pixel's mask byte read and float
    written; a valid pixel's two coordinates and, at most, one image float
    read, and its operations (an invalid pixel reads nothing more)."""
    valid = share * px
    return 5 * px + 12 * valid, K3C_OPS * valid


def sweep_plane_work(k: int, height: int, width: int, share: float):
    """(bytes, operations) of one depth plane of the sweep over ``k``
    sides: K3c's, the plane's cost map written and read once, and the
    cost's operations a side and pixel."""
    px = k * height * width
    nbytes, ops = k3c_work(px, share)
    return nbytes + 8 * height * width, ops + SWEEP_COST_OPS * px
