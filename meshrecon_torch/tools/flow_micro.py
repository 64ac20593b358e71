"""Time and quality of the variational flow's knobs (K=3).

Port of tools/flow_micro.py, with its rows in its order:

    python -m meshrecon_torch.tools.flow_micro [--height 480] [--width 640]
        [--k 3] [--reps 25] [--device cuda|cpu]

On the fused problem's frames (``problems.fused_problem(b=1, k=K, h=H,
w=W, seed=0)``): the batched flow of the main frame (1, 1, H, W) against
its K sides (1, K, H, W) under each variant, one solver level
(``flow.variational._hs_level``: K3, then K4's Chebyshev sweeps) at
production sweep counts, and ``pyr_down``. Each row is ms a call
(``utils/profiling.RowTimer``: one warm-up call, then CUDA events over
``reps`` calls, best of 3; the host clock on the CPU). The JAX tool's
carry perturbation and its measured no-op dispatch floor are not carried
over.

Then a quality line a variant: the L1 remap self-check (flow.cpp:133)
``sum |prev - flow_remap(flow, next)| * sqrt(3)`` of the flow against the
first side, with ``flow.remap.flow_remap`` (bicubic, torch ops).

Two variants name what the port does not have, and print n/a with the
reason, keeping their names and places:
- ``xla engine lv3`` selects the TPU package's second engine (its timing
  row and its quality line);
- ``prod minpx5e5`` sets ``--hs-fused-min-px``, a TPU layout flag that the
  port refuses (``pipeline/config.py``).
Without ``--device cpu`` a missing CUDA device raises.
"""

from __future__ import annotations

import math

import torch

from meshrecon_torch.flow.pyramid import pyr_down
from meshrecon_torch.flow.remap import flow_remap
from meshrecon_torch.flow.variational import _hs_level, variational_flow
from meshrecon_torch.tools import ENGINE_NA, fused_frames, size_args, start
from meshrecon_torch.utils.profiling import RowTimer

# the JAX tool's variants; None marks the engine switch the port lacks
VARIANTS = [
    ("prod lv2 w1", dict(levels=2, warps=1)),
    ("lv2 w2", dict(levels=2)),
    ("lv3 w2 (r4 default)", dict(levels=3)),
    ("lv3 w1", dict(levels=3, warps=1)),
    ("xla engine lv3", None),
]
MINPX_NA = ("--hs-fused-min-px is a TPU layout flag; the port refuses it "
            "(pipeline/config.py)")


def diff_sum(a, b, **kw) -> float:
    """The remap self-check of the flow a -> b (two (H, W) frames)."""
    fl = variational_flow(a[None, None], b[None, None], **kw)[0, 0]
    return float((a - flow_remap(fl, b)).abs().sum()) * math.sqrt(3.0)


def main(argv=None) -> dict:
    """Print the rows; returns {row: ms or None, "quality": {variant:
    diff_sum or None}}."""
    args = size_args("flow_micro", 25, argv)
    device = start(args.device)
    a, bs = fused_frames(args.height, args.width, args.k, device)
    t = RowTimer(device, args.reps, best_of=3, width=40)
    for name, kw in VARIANTS:
        if kw is None:
            t.na(f"flowK3 {name}", ENGINE_NA)
            continue
        t.time(f"flowK3 {name}", lambda kw=kw: variational_flow(
            a[None, None], bs[None], **kw))
    t.na("flowK3 prod minpx5e5", MINPX_NA)

    # one level in isolation (a single side, then the K-stack)
    a1, b1 = pyr_down(a), pyr_down(bs[0])
    z0, z1 = torch.zeros_like(a), torch.zeros_like(a1)
    for it in (14, 2):
        t.time(f"hs_level L0 cheb{it} pallas", lambda it=it: _hs_level(
            a, bs[0], z0, z0, 144.0, it, solver="cheb"))
    t.time("hs_level L1 cheb14 pallas", lambda: _hs_level(
        a1, b1, z1, z1, 144.0, 14, solver="cheb"))
    zk = torch.zeros_like(bs)
    t.time("hs_level L0 cheb14 K3", lambda: _hs_level(
        a[None].expand(bs.shape), bs, zk, zk, 144.0, 14, solver="cheb"))
    t.time("pyr_down L0", lambda: pyr_down(a))

    quality = {}
    for name, kw in VARIANTS:
        if kw is None:
            print(f"quality {name:<32} diff_sum =       n/a ({ENGINE_NA})",
                  flush=True)
            quality[name] = None
            continue
        quality[name] = diff_sum(a, bs[0], **kw)
        print(f"quality {name:<32} diff_sum = {quality[name]:9.0f}",
              flush=True)
    return {**t.rows, "quality": quality}


if __name__ == "__main__":
    main()
