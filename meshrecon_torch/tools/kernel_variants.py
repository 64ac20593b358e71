"""Time the designs K3b, R2, SETUP and BIN were chosen from against the
kernels kept.

    python -m meshrecon_torch.tools.kernel_variants [--rounds 7]
        [--kernels k3b,r2,setup,bin]

The variants (``kernel_variants.cu`` beside this file: K3b's first design,
float4 pixels with clamped taps, the CTA's window staged in shared memory
with and without a register cap; R2's first design and its loop unrolled
alone) are built apart from the kernel library with its nvcc flags, into
``build/meshrecon_torch/``, and launched through ctypes; the kept kernels
are the library's entries, through ctypes too, so every row pays the same
launch path. Each variant must equal the kept kernel bit for bit. K3b runs
on fields made as chip_smoke.py makes its own (12x480x640 and
4x8x480x640: a smooth flow of up to 3 px pushed 20 px off the left and
bottom borders), R2 on the roofline tool's 256x512 block of 2,048 FMAs,
SETUP's register caps and CTA sizes and BIN's block shapes, cluster
sizes and CTA widths (the kept templates of ``csrc/raster_setup.cu``,
included by the variants' source) on chip_smoke.py's binning shapes: the
flow update's 16 cameras at 640x480 on the 16,384- and 65,536-triangle
spheres, BIN at chunks 8 and 16 and superchunks of 8 chunks of 8 (each
variant's records bitwise, its counts and list prefixes equal to the kept
kernel's). Each row is the device time of a call from a CUDA graph of 100
calls, median [min-max] of ``--rounds`` alternating rounds, in us.
``bin_split`` prints BIN's CTAs phase by phase (clock stamps of a timed
build of the kernel). The tool needs the card: a kernel has no CPU mode,
and without CUDA it raises.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from meshrecon_torch.kernels import _build, library
from meshrecon_torch.tools import roofline
from meshrecon_torch.utils.profiling import device_line

SOURCE = Path(__file__).resolve().with_suffix(".cu")
K3B = {0: "first design (1-D grid, 64-bit division a pixel)",
       1: "float4 pixels, clamped taps", 2: "window in shared memory",
       3: "window, 6 CTAs an SM"}
R2 = {0: "first design (one chain, unroll 16)", 1: "one chain, unroll 128"}
SETUP = {0: "a thread a record", 1: "4 CTAs an SM", 2: "6 CTAs an SM",
         3: "10 CTAs an SM", 4: "64 triangles, 16 an SM",
         5: "64 triangles, 20 an SM"}
BIN = {0: "8 x 4 tiles, clusters of 4", 1: "8 x 4 tiles, clusters of 8",
       2: "8 x 2 tiles, clusters of 4", 3: "8 x 2 tiles, clusters of 8",
       4: "8 x 1 tiles, clusters of 8", 5: "16 warps, 8 x 4 tiles"}
BIN_TIMED = {0: "8 x 4 tiles", 1: "8 x 2 tiles"}
KERNELS = ("k3b", "r2", "setup", "bin", "bin_split")
GRAPH_CALLS = 100
H, W = 480, 640


def build() -> ctypes.CDLL:
    """Build kernel_variants.cu (once per source hash) and load it."""
    digest = hashlib.sha256(SOURCE.read_bytes() + (
        _build.CSRC / "common.cuh").read_bytes() + (
        _build.CSRC / "raster_setup.cu").read_bytes()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"kernel_variants_{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        done = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
             f"-I{_build.CSRC}", "-o", str(out), str(SOURCE)],
            capture_output=True, text=True, timeout=600)
        if done.returncode:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{done.stderr}")
        lines = (done.stdout + done.stderr).splitlines()
        for i, line in enumerate(lines):  # the binning variants' registers
            if "Compiling entry" in line and "raster_" in line:
                print("ptxas:", line.split("'")[1], "|",
                      " | ".join(x.strip() for x in lines[i + 2:i + 4]))
    lib = ctypes.CDLL(str(out))
    lib.mr_variant_k3b.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.mr_variant_r2.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.mr_variant_setup.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.mr_variant_bin.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.mr_variant_bin_timed.argtypes = [ctypes.c_int] + [
        ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    return lib


def _checked(fn, *args):
    def call():
        code = fn(*args, torch.cuda.current_stream().cuda_stream)
        if code:
            name = getattr(fn, "__name__", None) or fn.func.__name__
            raise RuntimeError(f"{name}: CUDA error {code}")
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


def k3b_rows(var, kept, gen, device, rounds) -> dict:
    out = {}
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
            kept.mr_warp_bicubic, *ptrs, ref.data_ptr(), n, H, W, 0, H, 0,
            H))}
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
            "bit)", timers, rounds)
    return out


def r2_rows(var, kept, gen, device, rounds) -> dict:
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
    return {"r2": _rounds(f"R2 256x512, {roofline.INNER} FMAs (each equal to "
                          "the kept kernel bit for bit)", timers, rounds)}


def _binning_inputs(device):
    """chip_smoke.py's binning inputs: the flow update's 16 cameras (B=4
    main cameras and K=3 sides of the fused problem, seed 0) and the
    16,384- and 65,536-triangle spheres, Morton-ordered."""
    from meshrecon_torch import problems, state

    args = problems.fused_problem(4, 3, H, W, seed=0)
    cams = torch.from_numpy(np.concatenate(
        [args[2][:, None], args[4]], 1).reshape(-1, 4, 4)).to(device)
    soups = [(2 * nt * nph, *(torch.from_numpy(a).to(device) for a in
                              state.pack_soup(problems.sphere_soup(nt, nph))))
             for nt, nph in ((64, 128), (128, 256))]
    return cams, soups


def _setup_call(fn, cams, soup, valid, chunk):
    n, t = cams.shape[0], soup.shape[0]
    n_rec = -(-2 * t // chunk) * chunk
    packed = torch.empty((n, 16, n_rec), device=cams.device)
    cbox = torch.empty((n, 4, n_rec // chunk), device=cams.device)
    return (_checked(fn, cams.data_ptr(), soup.data_ptr(), valid.data_ptr(),
                     packed.data_ptr(), cbox.data_ptr(), n, t, n_rec, chunk),
            packed, cbox)


def setup_rows(var, kept, device, rounds) -> dict:
    """SETUP's variants at chunk 8 on both spheres, bitwise against the
    kept kernel."""
    from functools import partial

    cams, soups = _binning_inputs(device)
    out = {}
    for tris, soup, valid in soups:
        call, ref, ref_box = _setup_call(kept.mr_raster_setup, cams, soup,
                                         valid, 8)
        timers = {"kept (csrc/raster_setup.cu)": _graph_us(call)}
        outs = []
        for k, name in SETUP.items():
            call, o, o_box = _setup_call(partial(var.mr_variant_setup, k),
                                         cams, soup, valid, 8)
            outs.append((o, o_box))
            call()
            torch.cuda.synchronize()
            if not (torch.equal(o.view(torch.int32), ref.view(torch.int32))
                    and torch.equal(o_box, ref_box)):
                raise AssertionError(f"SETUP variant {name} differs from "
                                     "the kept kernel")
            timers[name] = _graph_us(call)
        out[f"setup {tris}"] = _rounds(
            f"SETUP {len(cams)}x{H}x{W}, {tris} tris, chunk 8 (each variant "
            "equal to the kept kernel bit for bit)", timers, rounds)
    return out


def bin_rows(var, kept, device, rounds) -> dict:
    """BIN's variants at the binning phase's six shapes, on the kept
    SETUP's chunk boxes; counts and list prefixes equal to the kept
    kernel's."""
    from functools import partial

    from meshrecon_torch.raster import binned

    cams, soups = _binning_inputs(device)
    tiles = binned._screen(H, W, device)[1]
    ntx, nty = -(-W // binned.TILE), -(-H // binned.TILE)
    out = {}
    for tris, soup, valid in soups:
        for chunk, supers in ((8, 1), (16, 1), (8, 8)):
            cbox = binned.setup_records(cams, soup, valid, chunk * supers,
                                        chunk)[1]
            n, nch = cbox.shape[0], cbox.shape[2]

            def make(fn):
                lists = torch.empty((n, nty * ntx, nch // supers),
                                    dtype=torch.int32, device=device)
                counts = torch.empty((n, nty * ntx), dtype=torch.int32,
                                     device=device)
                return (_checked(fn, cbox.data_ptr(),
                                 *(t.data_ptr() for t in tiles),
                                 lists.data_ptr(), counts.data_ptr(), n, nch,
                                 supers, ntx, nty), lists, counts)

            call, ref, ref_n = make(kept.mr_raster_bin)
            call()
            torch.cuda.synchronize()
            live = (torch.arange(ref.shape[-1], device=device)
                    < ref_n[..., None])
            want = torch.where(live, ref, 0)
            timers = {"kept (csrc/raster_setup.cu)": _graph_us(call)}
            outs = []
            for k, name in BIN.items():
                call, o, o_n = make(partial(var.mr_variant_bin, k))
                outs.append((o, o_n))
                call()
                torch.cuda.synchronize()
                if not (torch.equal(o_n, ref_n)
                        and torch.equal(torch.where(live, o, 0), want)):
                    raise AssertionError(f"BIN variant {name} differs from "
                                         "the kept kernel")
                timers[name] = _graph_us(call)
            del live, want
            label = f"{tris} tris, chunk {chunk}" + (
                f", {supers} chunks a superchunk" if supers > 1 else "")
            out[f"bin {label}"] = _rounds(
                f"BIN {n}x{H}x{W}, {label} (each variant's counts and list "
                "prefixes equal to the kept kernel's)", timers, rounds)
    return out


def bin_split_rows(var, device) -> dict:
    """BIN's CTAs phase by phase (the timed variants' stamps) at the six
    shapes, after one untimed call: the launch's span on the global timer,
    the CTAs' start offsets and durations, and their SM cycles to the
    coarse level, to the survivors and in all, the survivors and the runs
    walked, median and max over the CTAs with tiles."""
    from functools import partial

    from meshrecon_torch.raster import binned

    cams, soups = _binning_inputs(device)
    tiles = binned._screen(H, W, device)[1]
    ntx, nty = -(-W // binned.TILE), -(-H // binned.TILE)
    out = {}
    for tris, soup, valid in soups:
        for chunk, supers in ((8, 1), (16, 1), (8, 8)):
            cbox = binned.setup_records(cams, soup, valid, chunk * supers,
                                        chunk)[1]
            n, nch = cbox.shape[0], cbox.shape[2]
            lists = torch.empty((n, nty * ntx, nch // supers),
                                dtype=torch.int32, device=device)
            counts = torch.empty((n, nty * ntx), dtype=torch.int32,
                                 device=device)
            ctas = n * -(-(-(-ntx // 8) * nty) // 8) * 8
            stamps = torch.zeros((ctas, 12), dtype=torch.int64, device=device)
            label = f"{tris} tris, chunk {chunk}" + (
                f", {supers} chunks a superchunk" if supers > 1 else "")
            for k, name in BIN_TIMED.items():
                call = _checked(partial(var.mr_variant_bin_timed, k),
                                cbox.data_ptr(),
                                *(t.data_ptr() for t in tiles),
                                lists.data_ptr(), counts.data_ptr(), n, nch,
                                supers, ntx, nty, stamps.data_ptr())
                stamps.zero_()
                call()
                call()
                torch.cuda.synchronize()
                st = stamps.cpu().numpy()
                st = st[st[:, 1] > 0]  # the grid's CTAs
                t0 = st[:, 0].min()
                start = (st[:, 0] - t0) / 1e3
                dur = (st[:, 1] - st[:, 0]) / 1e3
                row = dict(span_us=float((st[:, 1].max() - t0) / 1e3),
                           ctas=int(len(st)))
                for key, v in (("start_us", start), ("cta_us", dur),
                               ("coarse_cyc", st[:, 2]), ("blocks", st[:, 3]),
                               ("staged_cyc", st[:, 4]),
                               ("all_cyc", st[:, 5]), ("survivors", st[:, 6]),
                               ("walked", st[:, 7]), ("surv_cyc", st[:, 9]),
                               ("walk_cyc", st[:, 10]),
                               ("fetch_cyc", st[:, 11])):
                    row[key] = (float(np.median(v)), float(v.max()))
                row["sms"] = int(len(set(st[:, 8].tolist())))
                out[f"bin_split {label} {name}"] = row
                print(f"BIN split [{label}, {name}]: span {row['span_us']:.1f}"
                      f" us, {row['ctas']} CTAs; median/max: " + "; ".join(
                          f"{key} {v[0]:.1f}/{v[1]:.1f}"
                          for key, v in row.items()
                          if isinstance(v, tuple)) + f"; SMs {row['sms']}")
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m meshrecon_torch.tools.kernel_variants",
        description="Time K3b's, R2's, SETUP's and BIN's rejected designs "
                    "against the kept kernels on the card.")
    p.add_argument("--rounds", type=int, default=7)
    p.add_argument("--kernels", default=",".join(KERNELS),
                   help="the kernels whose variants to time, of "
                        f"{','.join(KERNELS)}")
    args = p.parse_args(argv)
    chosen = args.kernels.split(",")
    if not set(chosen) <= set(KERNELS):
        p.error(f"--kernels takes {','.join(KERNELS)}")
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_variants times CUDA kernels: no CUDA "
                           "device")
    device = torch.device("cuda", 0)
    print(device_line(device), flush=True)
    var = build()
    kept = library().cdll
    kept.mr_warp_bicubic.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    kept.mr_roofline_fma.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    kept.mr_raster_setup.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    kept.mr_raster_bin.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    out = {}
    gen = torch.Generator().manual_seed(1)
    if "k3b" in chosen:
        out.update(k3b_rows(var, kept, gen, device, args.rounds))
    if "r2" in chosen:
        out.update(r2_rows(var, kept, gen, device, args.rounds))
    if "setup" in chosen:
        out.update(setup_rows(var, kept, device, args.rounds))
    if "bin" in chosen:
        out.update(bin_rows(var, kept, device, args.rounds))
    if "bin_split" in chosen:
        out.update(bin_split_rows(var, device))
    return out


if __name__ == "__main__":
    main()
