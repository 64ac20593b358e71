"""Build ``meshrecon_torch/csrc/*.cu`` into one shared library and bind it.

The sources have a plain C interface, so ``nvcc`` compiles them in seconds
without PyTorch's headers; ``ctypes`` loads the result. The library lands
in ``build/meshrecon_torch/`` beside the package (git-ignored), named by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once. Nothing is built until a kernel is first
launched: importing this module needs neither ``nvcc`` nor a GPU.

Every kernel's wrapper owns a :class:`Kernel`, which launches on
``torch.cuda.current_stream()``, raises on a non-zero CUDA status, and
counts its launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "meshrecon_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
    # a*b+c stays two rounded operations, as in torch's eager ops (see
    # csrc/common.cuh)
    "-fmad=false",
    "-Xptxas=-v",
)

# C entry points: argument kinds, P = pointer (or stream), I = int,
# F = float. The stream is always the last argument.
_SIGNATURES = {
    "mr_raster_tiles": "PPPPPPPPPP" + "IIIIIII" + "P",
    "mr_raster_tiles2": "PPPPPPPPPPP" + "IIIIIIII" + "P",
    "mr_sample_shadow_frame": "PPPPPP" + "IIII" + "P",
    "mr_warp_bilinear": "PPPP" + "III" + "P",
    "mr_warp_bicubic": "PPPP" + "III" + "P",
    "mr_sample_bilinear_masked": "PPPPP" + "III" + "P",
    "mr_hs_sweep": "PPPP" + "PPPP" + "PPPPPP" + "FFF" + "IIII" + "P",
    "mr_hs_jacobi_fields": "PPPP" + "PPPP" + "F" + "IIII" + "P",
    "mr_roofline_copy": "PP" + "I" + "P",
    "mr_roofline_fma": "PP" + "II" + "P",
    "mr_roofline_tiny": "PP" + "II" + "P",
}
_CTYPES = {"P": ctypes.c_void_p, "I": ctypes.c_int, "F": ctypes.c_float}


@dataclass
class Library:
    cdll: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was loaded
    build_log: str


def _sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    path = home / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the meshrecon_torch kernels "
            "are built from source on first use")
    return str(path)


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel and return their joined output; the
    first that fails raises, after the others are stopped."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    log = ""
    try:
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate()
            log += out
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return log


@functools.lru_cache(maxsize=None)
def library() -> Library:
    """Build (if needed) and load the kernel library; cached per process."""
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    path = BUILD_DIR / f"libmeshrecon_torch_{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        # one nvcc per source, all started together, then one link
        srcs = [s for s in _sources() if s.suffix == ".cu"]
        objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in srcs]
        log = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                        for s, o in zip(srcs, objs)])
        log += _run_all([[_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                          "-shared", "-o", str(tmp), *map(str, objs)]])
        seconds = time.perf_counter() - t0
        for obj in objs:
            obj.unlink()
        os.replace(tmp, path)  # atomic: a concurrent build never sees half
    cdll = ctypes.CDLL(str(path))
    for name, kinds in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = [_CTYPES[k] for k in kinds]
        fn.restype = ctypes.c_int
    cdll.mr_error_string.argtypes = [ctypes.c_int]
    cdll.mr_error_string.restype = ctypes.c_char_p
    return Library(cdll, path, seconds, log)


_REGISTRY: list["Kernel"] = []


class Kernel:
    """One hand-written kernel: its C entry point and its launch count.

    ``launches`` rises by one for each launch this object makes and for
    nothing else; callers reset it by assignment. A launch recorded into a
    CUDA graph under capture runs nothing and is not counted: whoever
    replays the graph counts its replays.
    """

    def __init__(self, name: str, entry: str, source: str, replaces: str):
        if entry not in _SIGNATURES:
            raise ValueError(f"unknown entry point {entry}")
        self.name = name
        self.entry = entry
        self.source = source      # path in the repo
        self.replaces = replaces  # file:line of the TPU kernel
        self.launches = 0
        _REGISTRY.append(self)

    def launch(self, *args) -> None:
        """Launch on the current CUDA stream; tensors pass as data_ptr()."""
        lib = library()
        device = next(a.device for a in args if isinstance(a, torch.Tensor))
        cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                 for a in args]
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            code = getattr(lib.cdll, self.entry)(*cargs, stream)
            capturing = torch.cuda.is_current_stream_capturing()
        if code != 0:
            text = lib.cdll.mr_error_string(code).decode()
            raise RuntimeError(f"{self.name} ({self.entry}): CUDA error "
                               f"{code}: {text}")
        if not capturing:
            self.launches += 1


def all_kernels() -> list[Kernel]:
    """Every Kernel created so far (import the wrapper modules first)."""
    return list(_REGISTRY)


def check_cuda(name: str, *tensors: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype`` on
    the first one's device."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: argument {i} on {t.device}, "
                             f"expected {dev} (CUDA)")
        if t.dtype != dtype:
            raise ValueError(f"{name}: argument {i} is {t.dtype}, "
                             f"expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")
