"""The native host meshing library, built from the reference's C++ source.

``meshrecon/meshing/native/meshing_native.cpp`` (marching tetrahedra, the
density point filter and its greedy suppression) is read from the checkout,
compiled with ``g++`` into ``build/meshrecon_torch/`` beside the package
(git-ignored), named by a hash of the source and flags, and loaded with
ctypes. Nothing is written under ``meshrecon/``. Nothing is built until a
function here is first called. A failed build raises: the port has no
numpy fallback for these stages.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from meshrecon_torch.kernels._build import BUILD_DIR

SOURCE = (Path(__file__).resolve().parent.parent.parent / "meshrecon"
          / "meshing" / "native" / "meshing_native.cpp")
# the reference package's own build flags, so both packages run the same
# machine code on one host
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_SIGNATURES = {
    "mt_extract": ([_P, _I64, ctypes.c_float, _P, _P, _I64, _P, _P],
                   ctypes.c_int),
    "greedy_suppress": ([_P, _I64, _P, _P, _P, _P, _P, ctypes.c_float, _P],
                        _I64),
    "filter_points_native": ([_P, _I64, ctypes.c_float, ctypes.c_float,
                              ctypes.c_int, ctypes.c_int, _P, _P, _P], _I64),
}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the library; cached per process."""
    if not SOURCE.exists():
        raise RuntimeError(f"native meshing source missing: {SOURCE}")
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    path = BUILD_DIR / f"libmeshing_native_{digest.hexdigest()[:16]}.so"
    if not path.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the native meshing library is "
                               "built from source on first use")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent build never sees half
    lib = ctypes.CDLL(str(path))
    for name, (args, res) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def marching_tetrahedra(chi: np.ndarray, iso: float):
    """Iso-surface of a (G, G, G) field: (vertices (V, 3) float32 in grid
    coordinates, faces (F, 3) int32), oriented outward (toward decreasing
    chi)."""
    g = chi.shape[0]
    if chi.shape != (g, g, g):
        raise ValueError(f"chi must be a cube, got {chi.shape}")
    chi = np.ascontiguousarray(chi, dtype=np.float32)
    max_tris = 12 * (g - 1) ** 3  # <= 2 triangles per tet, 6 tets per cell
    verts = np.empty((3 * max_tris, 3), dtype=np.float32)
    faces = np.empty((max_tris, 3), dtype=np.int32)
    nv = ctypes.c_longlong(0)
    nf = ctypes.c_longlong(0)
    rc = library().mt_extract(_ptr(chi), g, float(iso), _ptr(verts),
                              _ptr(faces), max_tris, ctypes.addressof(nv),
                              ctypes.addressof(nf))
    if rc != 0:
        raise RuntimeError(f"mt_extract failed ({rc})")
    return verts[: nv.value].copy(), faces[: nf.value].copy()


def greedy_suppress(order, score, density, nbr_ptr, nbr_idx, nbr_w, limit):
    """Greedy density suppression along ``order``: kept indices, sorted."""
    order = np.ascontiguousarray(order, dtype=np.int64)
    score = np.ascontiguousarray(score, dtype=np.float32)
    density = np.ascontiguousarray(density, dtype=np.float32)
    nbr_ptr = np.ascontiguousarray(nbr_ptr, dtype=np.int64)
    nbr_idx = np.ascontiguousarray(nbr_idx, dtype=np.int64)
    nbr_w = np.ascontiguousarray(nbr_w, dtype=np.float32)
    kept = np.empty(len(order), dtype=np.int64)
    nkept = library().greedy_suppress(
        _ptr(order), len(order), _ptr(score), _ptr(density), _ptr(nbr_ptr),
        _ptr(nbr_idx), _ptr(nbr_w), float(limit), _ptr(kept))
    if nkept < 0:
        raise RuntimeError(f"greedy_suppress failed ({nkept})")
    return kept[:nkept].copy()


def filter_points_full(points3, radius_sq, density_limit, max_neighbors=64,
                       max_iters=60):
    """The whole density filter natively (grid-hash capped neighbour search,
    density iteration, greedy suppression): (kept (M,), density (N,),
    score (N,))."""
    pts = np.ascontiguousarray(points3, dtype=np.float32)
    n = len(pts)
    kept = np.empty(n, dtype=np.int64)
    density = np.empty(n, dtype=np.float32)
    score = np.empty(n, dtype=np.float32)
    nkept = library().filter_points_native(
        _ptr(pts), n, float(radius_sq), float(density_limit),
        int(max_neighbors), int(max_iters), _ptr(kept), _ptr(density),
        _ptr(score))
    if nkept < 0:
        raise RuntimeError(f"filter_points_native failed ({nkept})")
    return kept[:nkept].copy(), density, score
