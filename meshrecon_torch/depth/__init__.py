"""Triangulation and normals (port of meshrecon.depth)."""

from meshrecon_torch import lazy_exports

_EXPORTS = {
    "triangulate_pixels": "triangulate",
    "estimate_normals": "normals",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
