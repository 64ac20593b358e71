"""Camera geometry (port of meshrecon.geometry)."""

from meshrecon_torch import lazy_exports

_EXPORTS = {
    "dehomogenize": "camera",
    "extract_camera_center": "camera",
    "camera_to_screen": "camera",
    "project_points": "camera",
    "ndc_to_pixel": "camera",
    "pixel_to_ndc": "camera",
    "pixel_grid_ndc": "camera",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
