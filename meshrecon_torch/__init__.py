"""meshrecon_torch: the PyTorch / CUDA port of meshrecon for NVIDIA Hopper.

The JAX package ``meshrecon`` is the reference; this package mirrors its
sub-package and module names so that each module's counterpart is easy to
find. It imports ``torch`` and never ``jax``.

Every Pallas kernel of the ported path is a CUDA C++ kernel for ``sm_90a``
(``meshrecon_torch/csrc``), built on first use by
``meshrecon_torch.kernels._build``. Each kernel's wrapper takes its plain
PyTorch version for a tensor on the CPU and launches the kernel for a tensor
on a CUDA device; it never falls back from one to the other.

Layer map (ported: the reconstruction, track YAML to OBJ, with the flow
update's options):

- ``meshrecon_torch.cli``      -- ``python -m meshrecon_torch.cli``
- ``meshrecon_torch.pipeline`` -- config, the refinement loop
  (``reconstruct``), the camera policy (``heuristic``), checkpoints, and
  the fused flow and plane-sweep updates
- ``meshrecon_torch.raster``   -- clip/project setup, plain z-buffer render,
  occlusion probe, ``Renderer``, tile binning + the binned raster kernels
  (K1; K5, the two-level one), projective texturing (K2)
- ``meshrecon_torch.flow``     -- pyramids, bilinear warp (K3), bicubic
  re-warp (K3b), masked bilinear sample (K3c), Horn-Schunck relaxation
  (K4) and Jacobi sweeps given the fields (K6), variational flow with the
  Chebyshev, Jacobi and multigrid solvers, Farneback flow,
  ``calculate_flow``
- ``meshrecon_torch.depth``    -- plane sweep, Gauss-Newton triangulation,
  normals
- ``meshrecon_torch.points``   -- the density point filter
- ``meshrecon_torch.meshing``  -- alpha shapes, Poisson, components, trim,
  decimation, the native host library
- ``meshrecon_torch.io``       -- track YAML, OBJ, synthetic frames
- ``meshrecon_torch.state``    -- numpy <-> tensor conversion of update inputs
- ``meshrecon_torch.problems`` -- seeded synthetic update problems
- ``meshrecon_torch.tools``    -- the raster sweep (``python -m
  meshrecon_torch.tools.raster_sweep``)
- ``meshrecon_torch.bench``    -- ``python -m meshrecon_torch.bench``, the
  ``dense_depth_throughput`` line of the JAX package's ``bench.py``

Each sub-package exports the names its JAX counterpart's ``__init__``
exports (``from meshrecon_torch.flow import calculate_flow``).
"""

__version__ = "0.1.0"

BACKGROUND_DEPTH = 1.0  # NDC-depth sentinel for empty pixels (recon.hpp:30)


def lazy_exports(package: str, exports: dict):
    """A sub-package's module ``__getattr__`` for its public names (name ->
    the submodule that defines it), each imported on first use. Imported
    eagerly they would close cycles: ``raster.fragment`` imports
    ``flow.tile_warp`` and ``flow.remap`` imports ``raster.fragment``; most
    modules import ``pipeline.config``. A name that is also its
    submodule's gives the submodule, which the import system binds to the
    package's attribute of that name anyway."""
    import importlib

    def __getattr__(name):
        if name not in exports:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        module = importlib.import_module(f"{package}.{exports[name]}")
        return module if exports[name] == name else getattr(module, name)

    return __getattr__
