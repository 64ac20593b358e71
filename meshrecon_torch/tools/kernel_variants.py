"""Time the designs K3b and R2 were chosen from against the kernels kept.

    python -m meshrecon_torch.tools.kernel_variants [--rounds 7]

The variants (``kernel_variants.cu`` beside this file: K3b's first design,
float4 pixels with clamped taps, the CTA's window staged in shared memory
with and without a register cap; R2's first design and its loop unrolled
alone) are built apart from the kernel library with its nvcc flags, into
``build/meshrecon_torch/``, and launched through ctypes; the kept kernels
are the library's entries, through ctypes too, so every row pays the same
launch path. Each variant must equal the kept kernel bit for bit. K3b runs
on fields made as chip_smoke.py makes its own (12x480x640 and
4x8x480x640: a smooth flow of up to 3 px pushed 20 px off the left and
bottom borders), R2 on the roofline tool's 256x512 block of 2,048 FMAs. Each row is the device time
of a call from a CUDA graph of 100 calls, median [min-max] of ``--rounds``
alternating rounds, in us. The tool needs the card: a kernel has no CPU
mode, and without CUDA it raises.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import statistics
import subprocess
from pathlib import Path

import torch

from meshrecon_torch.kernels import _build, library
from meshrecon_torch.tools import roofline
from meshrecon_torch.utils.profiling import device_line

SOURCE = Path(__file__).resolve().with_suffix(".cu")
K3B = {0: "first design (1-D grid, 64-bit division a pixel)",
       1: "float4 pixels, clamped taps", 2: "window in shared memory",
       3: "window, 6 CTAs an SM"}
R2 = {0: "first design (one chain, unroll 16)", 1: "one chain, unroll 128"}
GRAPH_CALLS = 100
H, W = 480, 640


def build() -> ctypes.CDLL:
    """Build kernel_variants.cu (once per source hash) and load it."""
    digest = hashlib.sha256(SOURCE.read_bytes() + (
        _build.CSRC / "common.cuh").read_bytes()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"kernel_variants_{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        done = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
             f"-I{_build.CSRC}", "-o", str(out), str(SOURCE)],
            capture_output=True, text=True, timeout=600)
        if done.returncode:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{done.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.mr_variant_k3b.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.mr_variant_r2.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    return lib


def _checked(fn, *args):
    def call():
        code = fn(*args, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"{fn.__name__}: CUDA error {code}")
    return call


def _graph_us(call):
    """A function returning the us a call of ``call`` takes from a CUDA
    graph of GRAPH_CALLS calls (mean of 5 replays after one)."""
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            call()
    graph.replay()

    def timed():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(5):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e3 / (5 * GRAPH_CALLS)
    return timed


def _rounds(label, timers, rounds):
    got = {name: [] for name in timers}
    for _ in range(rounds):
        for name, fn in timers.items():
            got[name].append(fn())
    print(f"{label}, us a call from a CUDA graph, median [min-max] of "
          f"{rounds} alternating rounds:")
    for name, v in got.items():
        print(f"  {name}: {statistics.median(v):.3f} "
              f"[{min(v):.3f}-{max(v):.3f}]")
    return {name: statistics.median(v) for name, v in got.items()}


def _smooth(gen, shape, scale, device):
    x = torch.randn(shape, generator=gen).to(device)
    x = x.reshape(-1, *shape[-2:])
    for _ in range(2):
        x = torch.nn.functional.avg_pool2d(x[:, None], 9, 1, 4,
                                           count_include_pad=False)[:, 0]
    x = x.reshape(shape)
    return x * (scale / x.abs().amax().clamp(min=1e-6))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m meshrecon_torch.tools.kernel_variants",
        description="Time K3b's and R2's rejected designs against the kept "
                    "kernels on the card.")
    p.add_argument("--rounds", type=int, default=7)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_variants times CUDA kernels: no CUDA "
                           "device")
    device = torch.device("cuda", 0)
    print(device_line(device), flush=True)
    var = build()
    kept = library().cdll
    kept.mr_warp_bicubic.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    kept.mr_roofline_fma.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    out = {}
    gen = torch.Generator().manual_seed(1)
    for shape in ((12, H, W), (32, H, W)):
        img = (127.5 + _smooth(gen, shape, 120.0, device)).contiguous()
        u = _smooth(gen, shape, 3.0, device)
        v = _smooth(gen, shape, 3.0, device)
        u[..., :16] -= 20.0
        v[..., -8:, :] += 20.0
        u, v = u.contiguous(), v.contiguous()
        n = shape[0]
        ptrs = (img.data_ptr(), u.data_ptr(), v.data_ptr())
        ref = torch.empty_like(img)
        timers = {"kept (csrc/warp.cu)": _graph_us(_checked(
            kept.mr_warp_bicubic, *ptrs, ref.data_ptr(), n, H, W))}
        outs = []  # a graph's output lives as long as its replays
        for k, name in K3B.items():
            o = torch.empty_like(img)
            outs.append(o)
            call = _checked(var.mr_variant_k3b, k, *ptrs, o.data_ptr(), n,
                            H, W)
            call()
            torch.cuda.synchronize()
            if not torch.equal(o, ref):
                raise AssertionError(f"K3b variant {name} differs from the "
                                     "kept kernel")
            timers[name] = _graph_us(call)
        out[f"k3b {n}x{H}x{W}"] = _rounds(
            f"K3b {n}x{H}x{W} (each variant equal to the kept kernel bit for "
            "bit)", timers, args.rounds)
    x = (0.999 + 0.002 * torch.rand(roofline.FMA_SHAPE,
                                    generator=gen)).to(device)
    n = x.numel()
    ref = torch.empty_like(x)
    timers = {"kept (csrc/roofline.cu)": _graph_us(_checked(
        kept.mr_roofline_fma, x.data_ptr(), ref.data_ptr(), n,
        roofline.INNER))}
    outs = []
    for k, name in R2.items():
        o = torch.empty_like(x)
        outs.append(o)
        call = _checked(var.mr_variant_r2, k, x.data_ptr(), o.data_ptr(), n,
                        roofline.INNER)
        call()
        torch.cuda.synchronize()
        if not torch.equal(o, ref):
            raise AssertionError(f"R2 variant {name} differs from the kept "
                                 "kernel")
        timers[name] = _graph_us(call)
    out["r2"] = _rounds(f"R2 256x512, {roofline.INNER} FMAs (each equal to "
                        "the kept kernel bit for bit)", timers, args.rounds)
    return out


if __name__ == "__main__":
    main()
