"""Hand-written CUDA kernels: build, loading and launch bookkeeping."""

from meshrecon_torch.kernels._build import all_kernels, library

__all__ = ["all_kernels", "library"]
