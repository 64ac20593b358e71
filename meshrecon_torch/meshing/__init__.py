"""Surface meshing: alpha shapes (iteration 1), Poisson (later iterations),
component and support trimming, decimation, the native helpers, and the
experimental backends off the pipeline's path (RBF, greedy projection)."""

from meshrecon_torch.meshing.alpha import alpha_shape_faces
from meshrecon_torch.meshing.poisson import poisson_surface
from meshrecon_torch.meshing.rbf import rbf_surface
from meshrecon_torch.meshing.greedy import greedy_projection

__all__ = ["alpha_shape_faces", "poisson_surface", "rbf_surface",
           "greedy_projection"]
