"""Config, camera policy, the refinement loop and the fused dense updates
(port of meshrecon.pipeline)."""

from meshrecon_torch import lazy_exports

_EXPORTS = {
    "Config": "config",
    "Heuristic": "heuristic",
    "reconstruct": "reconstruct",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
