"""Pyramids, warps and the variational flow (port of meshrecon.flow)."""

from meshrecon_torch import lazy_exports

_EXPORTS = {
    "pyr_down": "pyramid",
    "pyr_up": "pyramid",
    "compare": "pyramid",
    "flow_remap": "remap",
    "bicubic_remap": "remap",
    "calculate_flow": "api",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
