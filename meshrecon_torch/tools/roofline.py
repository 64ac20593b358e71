"""The card's measured ceilings, and the four probes (R1-R4) that read them.

Port of tools/roofline.py:

    python -m meshrecon_torch.tools.roofline [--device cuda|cpu]

It bounds each stage of the flow update (``tools/fused_breakdown.py``) by
``max(bytes / bandwidth, operations / rate, launches x launch cost)``, and
measures those ceilings with the reference's four sections, shapes and
repetition counts:

1. HBM stream: R1 (``copy_scale``, ``o = x * 1.0000001``) on a 4096 x 4096
   float32 array (64 MiB), 100 round trips of 128 MiB. Two buffers
   ping-pong, so each launch reads what the last one wrote (the reference's
   ``fori_loop`` carry), and 64 MiB exceeds the 50 MB L2. Yardstick:
   ``torch.mul(x, 1.0000001, out=y)``.
2. float32 FMA rate: R2 (``fma_chain``, 2,048 dependent fused
   multiply-adds an element from ``acc = x``) on one (256, 512) block, 100
   calls. No PyTorch call computes it. The kernel hides the FMA latency
   inside each thread (four elements' chains interleaved) on a grid sized
   from the SM count (:func:`fma_shape`), so the rate it reads is the
   card's, not the first design's loop overhead and wave imbalance.
3. bf16 matmul rate: 500 chained 1024^3 products, each renormalized by
   x 0.18 (``torch.matmul``, as the reference's is ``jnp.dot``, not
   Pallas), against the tensor cores' 989 TFLOP/s.
4. Launch floor: R3 (``add_one``, ``o = x + 1`` on (8, 128) in one CTA),
   5,000 launches three ways: eager ``Kernel.launch`` calls from Python
   (what every eager launch of the port pays), the same launches captured
   once in a CUDA graph and replayed (the device-side floor), and 5,000
   eager ``x + 1`` (the torch op the binning's eager ops each pay). Then
   the grid-step marginal: R4 (``add_one_grid``) on (512, 128) in 1 and in
   64 CTAs, 2,000 launches each, reported as the reference's
   ``(t64 - t1) / 63``. On the card the CTAs run in parallel on 132 SMs,
   so that figure measures that parallelism, not a sequential step.
   Yardstick: ``torch.add`` at (512, 128).

The reference repeats each section inside one program (``fori_loop``), so
it times the device, not the dispatch. Here each section's repetitions are
captured once in a CUDA graph and replayed, and CUDA events time the
replays after a warm-up, best of 3; sections 1-3 and R3 also give the
eager time a call, from Python. The reference's scalar-fetch barrier and
measured dispatch floor worked around a remote TPU's dispatch and are not
carried over. With ``--device cpu`` every section runs once on the plain
versions, on the host clock, no kernel runs and no rate is given; without
it a missing CUDA device raises.

The probes' wrappers (``copy_scale``, ``fma_chain``, ``add_one``,
``add_one_grid``) launch their kernel (``csrc/roofline.cu``) for a CUDA
tensor and take the plain version for a CPU tensor. The data-sheet peaks
and :func:`bound` are the port's one yardstick of the least time a call
could take (``chip_smoke.py`` imports them).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from meshrecon_torch.kernels._build import Kernel, check_like
from meshrecon_torch.pipeline.config import resolve_device
from meshrecon_torch.utils.profiling import best_ms, device_line

# H100 SXM data sheet: HBM bandwidth, the float32 rate outside the tensor
# cores, and the tensor cores' dense bf16 rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12


def bound(nbytes, flops):
    """(bound_ms, bound_by): the least time the card could take to move
    ``nbytes`` (each input read once, each output written once) and to do
    ``flops`` float32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_SOURCE = "meshrecon_torch/csrc/roofline.cu"
R1 = Kernel("roofline_copy", "mr_roofline_copy", _SOURCE,
            "tools/roofline.py:83")
R2 = Kernel("roofline_fma", "mr_roofline_fma", _SOURCE,
            "tools/roofline.py:117")
R3 = Kernel("roofline_tiny", "mr_roofline_tiny", _SOURCE,
            "tools/roofline.py:171")
R4 = Kernel("roofline_tiny_grid", "mr_roofline_tiny", _SOURCE,
            "tools/roofline.py:171 (on a grid of n steps, :198)")

COPY_SCALE = 1.0000001  # float32 1 + 2**-23 on both sides
FMA_ADD = 1e-7
INNER = 2048            # FMAs an element in one R2 call
TINY_COLS = 128

FMA_CHAINS = 4          # R2's independent chains a thread (csrc)
FMA_MAX_THREADS = 1024

COPY_SHAPE = (4096, 4096)
FMA_SHAPE = (256, 512)
MM_N = 1024
TINY_ROWS = 8
GRID_ROWS = 512
REPS = dict(copy=100, fma=100, mm=500, launch=5000, grid=2000)


def copy_scale_plain(x):
    """R1's plain version."""
    return x * COPY_SCALE


def fma_chain_plain(x, inner: int = INNER):
    """R2's plain version: ``inner`` steps of acc = fma(acc, x, 1e-7) from
    acc = x. The product of two float32 values is exact in float64, so
    adding there and rounding once to float32 gives the fused operation,
    except where the float64 sum itself rounded (at most 1 ulp)."""
    xd = x.double()
    add = float(np.float32(FMA_ADD))
    acc = x
    for _ in range(inner):
        acc = (acc.double() * xd + add).float()
    return acc


def fma_shape(n: int, sms: int):
    """R2's launch geometry for ``n`` elements on ``sms`` SMs, as
    ``csrc/roofline.cu``'s ``mr_roofline_fma_shape`` computes it: (CTAs,
    threads a CTA, chains a thread). A CTA takes one SM's share of the
    elements, ``FMA_CHAINS`` a thread, in whole warps; thread t of the grid
    runs elements t + c * (CTAs x threads) for c < chains that lie below
    n."""
    if n < 1 or sms < 1:
        raise ValueError(f"fma_shape: n {n} and sms {sms} must be >= 1")
    per_sm = -(-n // sms)
    threads = -(-per_sm // FMA_CHAINS)
    threads = min(max(-(-threads // 32) * 32, 32), FMA_MAX_THREADS)
    return -(-n // (threads * FMA_CHAINS)), threads, FMA_CHAINS


def add_one_plain(x):
    """R3's and R4's plain version."""
    return x + 1.0


def _prepare(name, x, out):
    """Check ``x`` (and ``out``) and return the output tensor, allocated
    when not given: a contiguous float32 tensor of x's shape on x's CPU or
    CUDA device."""
    if out is None:
        out = torch.empty_like(x)
    if x.is_cuda:
        check_like(name, x, out)  # one pass: device, type, layout, shape
    else:
        if x.device.type != "cpu":
            raise ValueError(f"{name}: tensor on {x.device}; the probes "
                             "take CPU or CUDA tensors")
        if out.shape != x.shape:
            raise ValueError(f"{name}: out {tuple(out.shape)} != "
                             f"{tuple(x.shape)}")
        for t in (x, out):
            if t.device != x.device or t.dtype != torch.float32:
                raise ValueError(f"{name}: expected float32 on {x.device}, "
                                 f"got {t.dtype} on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: tensor is not contiguous")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{name}: {x.numel()} elements exceed int32")
    return out


def copy_scale(x, out=None):
    """R1: out = x * 1.0000001, float32, any shape."""
    out = _prepare("copy_scale", x, out)
    if not x.is_cuda:
        return out.copy_(copy_scale_plain(x))
    if (x.data_ptr() | out.data_ptr()) % 16:
        raise ValueError("copy_scale: the kernel takes 16-byte aligned "
                         "tensors (float4 loads and stores)")
    R1.launch(x, out, x.numel())
    return out


def fma_chain(x, inner: int = INNER, out=None):
    """R2: ``inner`` dependent fused multiply-adds acc = acc * x + 1e-7 an
    element, from acc = x; float32, any shape."""
    if inner < 0:
        raise ValueError(f"fma_chain: inner {inner} < 0")
    out = _prepare("fma_chain", x, out)
    if not x.is_cuda:
        return out.copy_(fma_chain_plain(x, inner))
    R2.launch(x, out, x.numel(), inner)
    return out


def _add_one(kernel, name, x, nblocks, out):
    shape = x.shape
    if len(shape) != 2 or shape[1] != TINY_COLS:
        raise ValueError(f"{name}: takes (rows, {TINY_COLS}), got "
                         f"{tuple(shape)}")
    if nblocks < 1 or shape[0] % nblocks:
        raise ValueError(f"{name}: {shape[0]} rows do not split into "
                         f"{nblocks} blocks")
    out = _prepare(name, x, out)
    if not x.is_cuda:
        return out.copy_(add_one_plain(x))
    if (x.data_ptr() | out.data_ptr()) % 16:
        raise ValueError(f"{name}: the kernel takes 16-byte aligned tensors "
                         "(float4 loads and stores)")
    kernel.launch(x, out, shape[0], nblocks)
    return out


def add_one(x, out=None):
    """R3: out = x + 1 on (rows, 128) float32 in one CTA."""
    return _add_one(R3, "add_one", x, 1, out)


def add_one_grid(x, nblocks: int, out=None):
    """R4: out = x + 1 on (rows, 128) float32 in ``nblocks`` CTAs (grid
    steps), each taking rows / nblocks rows."""
    return _add_one(R4, "add_one_grid", x, nblocks, out)


def _ping_pong(fn, a):
    """A call of ``fn(src, dst)`` that alternates between ``a`` and a
    second buffer, so each call reads what the last one wrote."""
    bufs = [a, torch.empty_like(a)]
    state = [0]

    def call():
        fn(bufs[state[0]], bufs[1 - state[0]])
        state[0] ^= 1
    return call


def _uniform(seed, shape, low=0.0, high=1.0):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        low, high, size=shape).astype(np.float32))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m meshrecon_torch.tools.roofline",
        description="Measure the card's HBM, float32 FMA and bf16 matmul "
                    "rates and its launch and grid-step floors.")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> dict:
    """Run the four sections; print one line each and return the numbers
    (times in ms or us as named; ``graph_launches``: each kernel's launches
    made by CUDA-graph replays, which ``Kernel.launch`` does not count)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    line = device_line(device)
    print(line, flush=True)
    where = f"[{line[len('device: '):]}]"

    def timed(fn, reps):
        """ms per call: best of 3 passes of ``reps`` calls on the card; one
        call on the host clock on the CPU."""
        if on_card:
            return best_ms(fn, reps, device, best_of=3)
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    graph_launches = {k.name: 0 for k in (R1, R2, R3, R4)}

    def graph_ms(kernel, call, reps):
        """ms per call of ``reps`` calls of ``call`` captured in one CUDA
        graph and replayed; counts the replayed launches of ``kernel``."""
        call()  # eager first: the library is loaded and the call checked
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                call()
        replays = [0]

        def replay():
            graph.replay()
            replays[0] += 1
        ms = timed(replay, 1) / reps
        if kernel is not None:
            graph_launches[kernel.name] += replays[0] * reps
        return ms

    def device_ms(kernel, call, reps):
        """(ms a call in a CUDA graph, ms a call eager) on the card: the
        device's time and what an eager caller sees; on the CPU (one call
        on the host clock, None)."""
        if not on_card:
            return timed(call, reps), None
        return graph_ms(kernel, call, reps), timed(call, reps)

    def rate(value, unit):
        """A rate of the card; the CPU's host clock gives none."""
        return f"{value:.0f} {unit}" if on_card else f"{unit} not measured"

    def us(ms, how=""):
        return f"{ms * 1e3:.1f} us" + (f" {how}" if how else "")

    out = {"device": line}
    in_graph = "in a CUDA graph" if on_card else "(host clock)"

    # 1. HBM stream (R1)
    a = _uniform(0, COPY_SHAPE).to(device)
    nbytes = a.numel() * 4
    ms, eager = device_ms(R1, _ping_pong(
        lambda s, d: copy_scale(s, out=d), a), REPS["copy"])
    lib = graph_ms(None, _ping_pong(
        lambda s, d: torch.mul(s, COPY_SCALE, out=d), a),
        REPS["copy"]) if on_card else None
    out.update(copy_ms=ms, copy_eager_ms=eager, copy_torch_ms=lib,
               copy_gbs=2 * nbytes / (ms * 1e-3) / 1e9 if on_card else None)
    print(f"R1 HBM stream: {rate(out['copy_gbs'], 'GB/s')} ("
          f"{us(ms, in_graph)} per 128 MiB round trip"
          + (f", eager {us(eager)}; torch.mul {us(lib, in_graph)}"
             if on_card else "")
          + f"; data sheet {HBM_BYTES_PER_S / 1e9:.0f} GB/s) {where}",
          flush=True)
    del a

    # 2. float32 FMA rate (R2)
    b = _uniform(1, FMA_SHAPE, 0.999, 1.001).to(device)
    fma_out = torch.empty_like(b)
    ms, eager = device_ms(R2, lambda: fma_chain(b, out=fma_out),
                          REPS["fma"])
    out.update(fma_ms=ms, fma_eager_ms=eager,
               fma_gflops=2 * b.numel() * INNER / (ms * 1e-3) / 1e9
               if on_card else None)
    print(f"R2 float32 FMA: {rate(out['fma_gflops'], 'GFLOP/s')} ("
          f"{us(ms, in_graph)} per {INNER}-deep {FMA_SHAPE[0]}x"
          f"{FMA_SHAPE[1]} block"
          + (f", eager {us(eager)}" if on_card else "")
          + f"; no single PyTorch call; data sheet {FP32_FLOPS / 1e9:.0f} "
          f"GFLOP/s) {where}", flush=True)

    # 3. bf16 matmul rate (torch.matmul, the reference's jnp.dot)
    m = _uniform(2, (MM_N, MM_N), -0.03, 0.03).to(device, torch.bfloat16)
    prod = torch.empty_like(m)

    def mm(src, dst):
        # renormalize so values stay finite, as the reference does
        torch.matmul(src, m, out=prod)
        torch.mul(prod, 0.18, out=dst)
    ms, eager = device_ms(None, _ping_pong(mm, m.clone()), REPS["mm"])
    out.update(mm_ms=ms, mm_eager_ms=eager,
               mm_tflops=2 * MM_N ** 3 / (ms * 1e-3) / 1e12
               if on_card else None)
    print(f"bf16 matmul: {rate(out['mm_tflops'], 'TFLOP/s')} ("
          f"{us(ms, in_graph)} per {MM_N}^3 product and its x 0.18"
          + (f", eager {us(eager)}" if on_card else "")
          + f"; data sheet {BF16_FLOPS / 1e12:.0f} TFLOP/s) {where}",
          flush=True)

    # 4. launch floor (R3) and grid-step marginal (R4)
    c = torch.ones((TINY_ROWS, TINY_COLS), device=device)
    tiny = _ping_pong(lambda s, d: add_one(s, out=d), c)
    eager = timed(tiny, REPS["launch"]) * 1e3
    graph = (graph_ms(R3, tiny, REPS["launch"]) * 1e3 if on_card
             else None)
    op = timed(lambda: c + 1, REPS["launch"]) * 1e3
    out.update(launch_eager_us=eager, launch_graph_us=graph,
               torch_op_us=op)
    print(f"R3 launch floor: eager {eager:.2f} us/launch ("
          f"{REPS['launch']} Kernel.launch calls from Python), graph "
          + (f"{graph:.2f} us/launch ({REPS['launch']} launches captured "
             "in one CUDA graph, replayed)" if on_card else "not measured")
          + f", torch op x + 1 {op:.2f} us/op {where}", flush=True)

    g = torch.ones((GRID_ROWS, TINY_COLS), device=device)
    step = {}
    for n in (1, 64):
        call = _ping_pong(lambda s, d, n=n: add_one_grid(s, n, out=d), g)
        step[n] = (graph_ms(R4, call, REPS["grid"]) if on_card
                   else timed(call, REPS["grid"])) * 1e3
    lib = (graph_ms(None, _ping_pong(
        lambda s, d: torch.add(s, 1.0, out=d), g), REPS["grid"]) * 1e3
        if on_card else None)
    marginal = (step[64] - step[1]) / 63
    out.update(grid_t1_us=step[1], grid_t64_us=step[64],
               grid_step_us=marginal, grid_torch_us=lib,
               graph_launches=graph_launches)
    print(f"R4 grid-step marginal: {marginal:.3f} us/step (1 CTA "
          f"{step[1]:.2f} us, 64 CTAs {step[64]:.2f} us a launch, "
          + ("CUDA-graph replays" if on_card else "eager, host clock")
          + "; torch.add "
          + (f"{lib:.2f} us" if on_card else "not measured")
          + "; the CTAs run in parallel on the SMs, so this measures that "
          f"parallelism, not a sequential step) {where}", flush=True)
    if not on_card:
        print("cpu: plain versions, one call each, host clock; no kernel "
              "ran", flush=True)
    return out


if __name__ == "__main__":
    main()
