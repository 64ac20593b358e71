"""Device meshes and the sharded dense updates (port of
meshrecon.sharding)."""

from meshrecon_torch import lazy_exports

_EXPORTS = {
    "make_device_mesh": "meshes",
    "make_scene_mesh": "meshes",
    "dense_update_batch": "meshes",
    "sharded_dense_update": "meshes",
    "sharded_fused_update": "meshes",
    "sharded_plane_sweep": "meshes",
    "sharded_multi_scene_fused": "meshes",
    "make_window_mesh": "meshes",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
