"""Point-cloud density filtering (port of meshrecon.points)."""

from meshrecon_torch import lazy_exports

_EXPORTS = {
    "filter_points": "filter",
    "density_scores": "filter",
    "build_half_edges": "filter",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
