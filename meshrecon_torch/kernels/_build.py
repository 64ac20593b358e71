"""Build ``meshrecon_torch/csrc`` into one shared library and bind it.

The kernels (``csrc/*.cu``) have a plain C interface, so ``nvcc`` compiles
them in seconds without PyTorch's headers. ``csrc/bind.cpp`` makes their
launch entries a CPython extension module (:data:`BIND_MODULE`): the host
compiler (``g++``) builds it against Python's headers alone, and it is
linked into the same library. The library lands in
``build/meshrecon_torch/`` beside the package (git-ignored), named by a
hash of the sources, the flags and the Python headers' path and ABI, so an
edited source rebuilds and an unchanged one loads at once. Nothing is
built until a kernel is first launched: importing this module needs
neither ``nvcc``, ``g++`` nor a GPU. A failed build or import raises:
there is no other way to launch. The helpers that are not launches
(``mr_error_string``, the launch geometries ``mr_hs_block_shape``,
``mr_roofline_fma_shape``, ``mr_warp_bicubic_shape`` and
``mr_raster_setup_shape``, and K3b's path
count ``mr_warp_bicubic_paths``) are called through ctypes.

Every kernel's wrapper owns a :class:`Kernel`, which launches through the
extension module on ``torch.cuda.current_stream()``, raises on a non-zero
CUDA status, and counts its launches. Its launch path is one call into the
binding (``launch``, resolved once a kernel): it reads each tensor's
``data_ptr()``, holds the first argument's device to the current one,
takes that device's current stream, calls the entry and asks whether the
stream is capturing, through torch's own C functions handed over once
(``set_launch_hooks``). Only a launch on another device than the current
one enters the device context in Python.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "meshrecon_torch"
BIND_SOURCE = CSRC / "bind.cpp"
BIND_MODULE = "_meshrecon_torch_bind"  # PyInit__meshrecon_torch_bind
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-Wall")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
    # a*b+c stays two rounded operations, as in torch's eager ops (see
    # csrc/common.cuh)
    "-fmad=false",
    "-Xptxas=-v",
)

# The launch entries (csrc/bind.cpp declares each with these parameter
# types): argument kinds, P = pointer (or stream), I = int, F = float. The
# stream is always the last argument.
_SIGNATURES = {
    "mr_raster_tiles": "PPPPPPPPPP" + "IIIIIIIII" + "P",
    "mr_raster_tiles2": "PPPPPPPPPPP" + "IIIIIIII" + "P",
    "mr_raster_setup": "PPPPP" + "IIII" + "P",
    "mr_raster_bin": "PPPPPPP" + "IIIII" + "P",
    "mr_sample_shadow_frame": "PPPPPP" + "IIIII" + "P",
    "mr_warp_bilinear": "PPPP" + "IIIIIII" + "P",
    "mr_warp_bicubic": "PPPP" + "IIIIIII" + "P",
    "mr_sample_bilinear_masked": "PPPPP" + "III" + "P",
    # the schedule's (a_k, b_k) pairs are a host pointer (P) before "IF"
    "mr_hs_sweep": "PPPP" + "PPPP" + "PPPP" + "P" + "IF" + "III" + "P",
    "mr_hs_jacobi_fields": "PPP" + "PP" + "PP" + "IF" + "III" + "P",
    "mr_hs_divide": "PPP" + "I" + "P",
    "mr_roofline_copy": "PP" + "I" + "P",
    "mr_roofline_fma": "PP" + "II" + "P",
    "mr_roofline_tiny": "PP" + "II" + "P",
    "mr_gn_sobel": "PPP" + "III" + "P",
    "mr_gn_walk": "PPPPPPPP" + "PPP" + "I" * 11 + "FFF" + "P",
    "mr_gn_exit": "PP" + "PP" + "IIII" + "P",
    "mr_gn_finish": "PPPPPPPP" + "PPPP" + "PPP" + "I" * 10 + "FFFF" + "P",
    "mr_sweep_proj": "PPPPP" + "PPP" + "IIIII" + "P",
    "mr_sweep_cost": "PPPPP" + "PP" + "IIII" + "P",
    "mr_sweep_best": "PPP" + "PP" + "IIII" + "P",
}


@dataclass
class Library:
    cdll: ctypes.CDLL  # the helpers that are not launches
    ext: ModuleType    # the launch entries (csrc/bind.cpp)
    path: Path
    build_seconds: float  # 0.0 when an existing build was loaded
    build_log: str


def _sources() -> list[Path]:
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh"),
                   *CSRC.glob("*.cpp")])


def _cxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError(
            "g++ not found (PATH): the kernels' Python binding "
            "(csrc/bind.cpp) is built from source on first use")
    return found


def bind_command(obj: Path) -> list[str]:
    """The host compiler's command that builds csrc/bind.cpp into the
    object file ``obj``, against Python's headers alone."""
    return [_cxx(), *CXX_FLAGS, f"-I{sysconfig.get_paths()['include']}",
            "-c", "-o", str(obj), str(BIND_SOURCE)]


def import_binding(path) -> ModuleType:
    """Import the binding linked into the library at ``path`` as the
    extension module :data:`BIND_MODULE`."""
    loader = importlib.machinery.ExtensionFileLoader(BIND_MODULE, str(path))
    spec = importlib.util.spec_from_file_location(BIND_MODULE, str(path),
                                                  loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return module


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
                raise RuntimeError(f"{Path(cmd[0]).name} failed "
                                   f"({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return log


def once(fn):
    """``fn()``, computed once per process: threads that call it together
    wait for one result under a lock (``functools.lru_cache`` alone lets
    each compute). ``cache_clear`` forgets the result."""
    lock = threading.Lock()
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def call():
        with lock:
            return cached()

    call.cache_clear = cached.cache_clear
    return call


def tmp_path(path: Path) -> Path:
    """A temporary name beside ``path``, unique to this process and
    thread, to build into before ``os.replace``."""
    return path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")


@once
def library() -> Library:
    """Build (if needed) and load the kernel library; cached per process."""
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + CXX_FLAGS).encode())
    digest.update(sysconfig.get_paths()["include"].encode())
    digest.update(sysconfig.get_config_var("EXT_SUFFIX").encode())
    path = BUILD_DIR / f"libmeshrecon_torch_{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = tmp_path(path)
        t0 = time.perf_counter()
        # one nvcc per kernel source and g++ for the binding, all started
        # together, then one link
        srcs = [s for s in _sources() if s.suffix == ".cu"]
        objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in srcs]
        bind_obj = tmp.with_name(f"{tmp.name}.bind.o")
        log = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                        for s, o in zip(srcs, objs)]
                       + [bind_command(bind_obj)])
        objs.append(bind_obj)
        log += _run_all([[_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                          "-shared", "-o", str(tmp), *map(str, objs)]])
        seconds = time.perf_counter() - t0
        for obj in objs:
            obj.unlink()
        os.replace(tmp, path)  # atomic: a concurrent build never sees half
    ext = import_binding(path)
    ext.set_launch_hooks(_current_device, _raw_stream, _capturing)
    cdll = ctypes.CDLL(str(path))
    cdll.mr_error_string.argtypes = [ctypes.c_int]
    cdll.mr_error_string.restype = ctypes.c_char_p
    cdll.mr_hs_block_shape.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    cdll.mr_hs_block_shape.restype = ctypes.c_int
    cdll.mr_roofline_fma_shape.argtypes = [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    cdll.mr_roofline_fma_shape.restype = ctypes.c_int
    cdll.mr_warp_bicubic_shape.argtypes = [ctypes.c_void_p]
    cdll.mr_warp_bicubic_shape.restype = ctypes.c_int
    cdll.mr_raster_setup_shape.argtypes = [ctypes.c_void_p]
    cdll.mr_raster_setup_shape.restype = ctypes.c_int
    cdll.mr_warp_bicubic_paths.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    cdll.mr_warp_bicubic_paths.restype = ctypes.c_int
    return Library(cdll, ext, path, seconds, log)


_REGISTRY: list["Kernel"] = []
# guards the launch counts: shards launch from threads of their own
# (sharding/meshes.py), and ``+=`` on an attribute is not atomic
_COUNT_LOCK = threading.Lock()

# The binding's launch hooks, torch's own C functions (a CPU-only build of
# torch lacks the first two, and launches nothing): the index of the
# current CUDA device; the current stream of a device as a raw
# cudaStream_t, the handle that torch.cuda.current_stream(index).cuda_stream
# gives without building a Stream; whether the current stream records into
# a CUDA graph.
_current_device = getattr(torch._C, "_cuda_getDevice", None)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_capturing = torch._C._cuda_isCurrentStreamCapturing


class Kernel:
    """One hand-written kernel: its launch entry and its launch count.

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
        self._fn = None  # the binding's launch of the entry, at first launch
        _REGISTRY.append(self)

    def launch(self, *args) -> None:
        """Launch on the current stream of the first argument's device (a
        CUDA tensor; the wrappers check the rest); the arguments pass as
        they are (tensors, ints, floats, None for a null pointer), the
        stream last."""
        fn = self._fn
        if fn is None:
            ext = library().ext
            fn = self._fn = functools.partial(ext.launch,
                                              getattr(ext, self.entry))
        done = fn(*args)  # (status, capturing) on the current device
        if done is None:  # a CPU tensor, or not the current device
            index = args[0].get_device()
            if index < 0:
                raise ValueError(f"{self.name}: the first argument is not "
                                 "a CUDA tensor")
            with torch.cuda.device(index):
                done = fn(*args)
        code, capturing = done
        if code:
            text = library().cdll.mr_error_string(code).decode()
            raise RuntimeError(f"{self.name} ({self.entry}): CUDA error "
                               f"{code}: {text}")
        if not capturing:
            with _COUNT_LOCK:
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


# The checks run on every eager launch, so each reads a tensor's device,
# type, layout and shape once (dtypes are singletons: ``is`` compares them).

def check_cuda(name: str, *tensors: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype`` on
    the first one's device."""
    ref = tensors[0]
    index = ref.get_device()
    if index < 0 or ref.dtype is not dtype or not ref.is_contiguous():
        _refuse(name, 0, ref, ref.device, dtype)
    for i, t in enumerate(tensors[1:], 1):
        if (t.get_device() != index or t.dtype is not dtype
                or not t.is_contiguous()):
            _refuse(name, i, t, ref.device, dtype)


def check_like(name: str, ref: torch.Tensor, *others: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> None:
    """One pass of :func:`check_cuda` that also holds every tensor to the
    shape of ``ref``."""
    index, shape = ref.get_device(), ref.shape
    if index < 0 or ref.dtype is not dtype or not ref.is_contiguous():
        _refuse(name, 0, ref, ref.device, dtype)
    for i, t in enumerate(others, 1):
        if (t.get_device() != index or t.dtype is not dtype
                or not t.is_contiguous() or t.shape != shape):
            if t.shape != shape:
                raise ValueError(f"{name}: argument {i} has shape "
                                 f"{tuple(t.shape)}, expected "
                                 f"{tuple(shape)}")
            _refuse(name, i, t, ref.device, dtype)
