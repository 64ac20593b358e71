"""Depth renders and projective texturing (port of meshrecon.raster)."""

from meshrecon_torch import lazy_exports

_EXPORTS = {
    "clip_triangles_near": "rasterizer",
    "render_depth": "rasterizer",
    "depth_probe": "rasterizer",
    "Renderer": "rasterizer",
    "projected_image": "fragment",
    "mix_background": "fragment",
    "dilate3x3_max": "fragment",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
