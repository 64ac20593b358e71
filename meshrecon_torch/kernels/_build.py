"""Build ``meshrecon_torch/csrc/*.cu`` into one shared library and bind it.

The sources have a plain C interface, so ``nvcc`` compiles them in seconds
without PyTorch's headers; ``ctypes`` loads the result. The library lands
in ``build/meshrecon_torch/`` beside the package (git-ignored), named by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once. Nothing is built until a kernel is first
launched: importing this module needs neither ``nvcc`` nor a GPU.

Every kernel's wrapper owns a :class:`Kernel`, which launches on
``torch.cuda.current_stream()``, raises on a non-zero CUDA status, and
counts its launches. Its launch path costs a few microseconds of Python:
the ctypes entry is resolved once, the device comes from the first
argument, the device context is entered only when that device is not the
current one, and the stream is read as a raw handle (:func:`_raw_stream`).
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
    "mr_raster_setup": "PPPPP" + "IIII" + "P",
    "mr_raster_bin": "PPPPPPP" + "IIIII" + "P",
    "mr_sample_shadow_frame": "PPPPPP" + "IIII" + "P",
    "mr_warp_bilinear": "PPPP" + "III" + "P",
    "mr_warp_bicubic": "PPPP" + "III" + "P",
    "mr_sample_bilinear_masked": "PPPPP" + "III" + "P",
    # the schedule's (a_k, b_k) pairs are a host pointer (P) before "IF"
    "mr_hs_sweep": "PPPP" + "PPPP" + "PPPP" + "P" + "IF" + "III" + "P",
    "mr_hs_jacobi_fields": "PPP" + "PP" + "PP" + "IF" + "III" + "P",
    "mr_hs_divide": "PPP" + "I" + "P",
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
    cdll.mr_hs_block_shape.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    cdll.mr_hs_block_shape.restype = ctypes.c_int
    return Library(cdll, path, seconds, log)


_REGISTRY: list["Kernel"] = []


def _current_device() -> int:
    """The index of the current CUDA device."""
    return torch._C._cuda_getDevice()


def _raw_stream(index: int) -> int:
    """The current stream of CUDA device ``index`` as a raw
    ``cudaStream_t``: ``torch._C._cuda_getCurrentRawStream(index)``, the
    handle ``torch.cuda.current_stream(index).cuda_stream`` gives, without
    building a ``Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(index)


def _capturing() -> bool:
    """True while the current stream records into a CUDA graph."""
    return torch._C._cuda_isCurrentStreamCapturing()


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
        self._fn = None           # the ctypes entry, resolved at first launch
        _REGISTRY.append(self)

    def launch(self, *args) -> None:
        """Launch on the current stream of the first argument's device (a
        CUDA tensor; the wrappers check the rest); tensors pass as
        data_ptr(), the stream last."""
        fn = self._fn
        if fn is None:
            fn = self._fn = getattr(library().cdll, self.entry)
        index = args[0].get_device()
        if index < 0:
            raise ValueError(f"{self.name}: the first argument is not a "
                             "CUDA tensor")
        cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                 for a in args]
        if index == _current_device():
            code = fn(*cargs, _raw_stream(index))
            capturing = _capturing()
        else:
            with torch.cuda.device(index):
                code = fn(*cargs, _raw_stream(index))
                capturing = _capturing()
        if code != 0:
            text = library().cdll.mr_error_string(code).decode()
            raise RuntimeError(f"{self.name} ({self.entry}): CUDA error "
                               f"{code}: {text}")
        if not capturing:
            self.launches += 1


def all_kernels() -> list[Kernel]:
    """Every Kernel created so far (import the wrapper modules first)."""
    return list(_REGISTRY)


def _refuse(name: str, i: int, t: torch.Tensor, dev, dtype) -> None:
    if t.device != dev or t.device.type != "cuda":
        raise ValueError(f"{name}: argument {i} on {t.device}, "
                         f"expected {dev} (CUDA)")
    if t.dtype != dtype:
        raise ValueError(f"{name}: argument {i} is {t.dtype}, "
                         f"expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: argument {i} is not contiguous")


def check_cuda(name: str, *tensors: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype`` on
    the first one's device."""
    index = tensors[0].get_device()
    for i, t in enumerate(tensors):
        if (index < 0 or t.get_device() != index or t.dtype != dtype
                or not t.is_contiguous()):
            _refuse(name, i, t, tensors[0].device, dtype)


def check_like(name: str, ref: torch.Tensor, *others: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> None:
    """One pass of :func:`check_cuda` that also holds every tensor to the
    shape of ``ref``."""
    index, shape = ref.get_device(), ref.shape
    for i, t in enumerate((ref, *others)):
        if (index < 0 or t.get_device() != index or t.dtype != dtype
                or not t.is_contiguous() or t.shape != shape):
            if t.shape != shape:
                raise ValueError(f"{name}: argument {i} has shape "
                                 f"{tuple(t.shape)}, expected "
                                 f"{tuple(shape)}")
            _refuse(name, i, t, ref.device, dtype)
