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
"""

__version__ = "0.1.0"

BACKGROUND_DEPTH = 1.0  # NDC-depth sentinel for empty pixels (recon.hpp:30)
