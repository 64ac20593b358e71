"""Scene input and mesh output: track YAML, OBJ files, synthetic frames
(port of meshrecon.io)."""

from meshrecon_torch import lazy_exports

_EXPORTS = {
    "TrackFile": "tracks",
    "load_tracks": "tracks",
    "read_mesh": "obj",
    "save_mesh": "obj",
    "Mesh": "obj",
    "save_image": "images",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
