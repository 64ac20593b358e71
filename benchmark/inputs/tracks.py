"""A frozen copy of the program's parser for the OpenCV-FileStorage YAML
that Blender's track exporter writes (``%YAML:1.0`` and
``!!opencv-matrix`` mappings): ``clip``, ``camera`` (a 4x4 projection a
tracked frame) and ``tracks`` (homogeneous bundle points)."""

from __future__ import annotations

import dataclasses
import os

import numpy as np


def _scalar(text: str):
    """One plain YAML scalar or flow sequence: int, float, or string."""
    text = text.strip()
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        return [_scalar(t) for t in inner.split(",")] if inner else []
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    return text


def _logical_lines(text: str) -> list[tuple[int, str]]:
    """(indent, content) per logical line: comments, blank lines and the
    ``%YAML:1.0`` directive dropped, a flow sequence continued over several
    lines joined, and ``- key: value`` split into a ``-`` item marker and
    its first key two columns deeper."""
    out = []
    pending = None
    for raw in text.splitlines():
        line = raw.rstrip()
        body = line.lstrip()
        if pending is not None:
            pending[1] += " " + body
            if pending[1].count("[") <= pending[1].count("]"):
                out.append(tuple(pending))
                pending = None
            continue
        if not body or body.startswith(("#", "%")) or body == "---":
            continue
        indent = len(line) - len(body)
        while body.startswith("- ") or body == "-":
            out.append((indent, "-"))
            body = body[1:].lstrip()
            indent += 2
        if not body:
            continue
        if body.count("[") > body.count("]"):
            pending = [indent, body]
            continue
        out.append((indent, body))
    if pending is not None:
        raise ValueError("unterminated flow sequence in YAML")
    return out


def _opencv_matrix(node: dict) -> np.ndarray:
    rows, cols = int(node["rows"]), int(node["cols"])
    return np.asarray(node["data"], dtype=np.float32).reshape(rows, cols)


def _block(lines, pos: int, indent: int):
    """Parse the block starting at lines[pos] (at ``indent``); returns
    (value, next position)."""
    n = len(lines)
    if lines[pos][1] == "-":
        seq = []
        while pos < n and lines[pos] == (indent, "-"):
            pos += 1
            if pos < n and lines[pos][0] > indent:
                value, pos = _block(lines, pos, lines[pos][0])
            else:
                value = None
            seq.append(value)
        return seq, pos
    mapping = {}
    while pos < n and lines[pos][0] == indent and lines[pos][1] != "-":
        key, sep, rest = lines[pos][1].partition(":")
        if not sep:
            raise ValueError(f"expected 'key: value', got {lines[pos][1]!r}")
        rest = rest.strip()
        tag = None
        if rest.startswith("!"):
            tag, _, rest = rest.partition(" ")
        pos += 1
        if rest:
            value = _scalar(rest)
        elif pos < n and lines[pos][0] > indent:
            value, pos = _block(lines, pos, lines[pos][0])
        else:
            value = None
        if tag in ("!!opencv-matrix", "!opencv-matrix"):
            value = _opencv_matrix(value)
        mapping[key.strip()] = value
    return mapping, pos


def _read_opencv_yaml(path: str) -> dict:
    """The OpenCV FileStorage dialect as the Blender exporter writes it:
    block mappings and sequences, flow sequences of numbers, plain
    scalars, and ``!!opencv-matrix`` mappings ({rows, cols, dt, data}) as
    float32 arrays. PyYAML rejects the ``%YAML:1.0`` directive, and the
    port needs no YAML package, so this reads the subset itself."""
    with open(path, "r") as fh:
        lines = _logical_lines(fh.read())
    if not lines:
        return {}
    doc, pos = _block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise ValueError(f"{path}: unparsed content at {lines[pos]!r}")
    return doc


@dataclasses.dataclass
class TrackFile:
    """In-memory form of one exported scene calibration.

    Arrays are kept exactly as parsed; frame-index remapping for
    ``skip_frames`` happens here (like configuration.cpp:183-218) so all
    downstream indices are 0-based and already subsampled.
    """

    clip_path: str  # resolved relative to the YAML's directory
    width: int
    height: int
    fov: float
    distortion: np.ndarray  # (3,) [k1, k2, k3]
    center_x: float
    center_y: float
    cameras: np.ndarray  # (F, 4, 4) float32 projection per tracked frame
    near: np.ndarray  # (F,)
    far: np.ndarray  # (F,)
    camera_valid: np.ndarray  # (F,) bool: frame had a camera entry
    bundles: np.ndarray  # (N, 4) float32 homogeneous sparse points
    bundles_enabled: list  # list of N sets of 0-based frame indices

    @property
    def frame_count(self) -> int:
        return int(self.cameras.shape[0])


def load_tracks(path: str, skip_frames: int = 1) -> TrackFile:
    """Load and validate a track YAML. Fail-fast like configuration.cpp:134-142."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"Cannot read file {path}")
    doc = _read_opencv_yaml(path)
    if not isinstance(doc, dict) or "clip" not in doc:
        raise ValueError(f"No clip section in configuration YAML {path}")

    clip = doc["clip"]
    width, height = int(clip["width"]), int(clip["height"])
    distortion = np.asarray(clip.get("distortion", [0.0, 0.0, 0.0]), dtype=np.float32)
    clip_path = os.path.join(os.path.dirname(os.path.abspath(path)), clip["path"])

    cam_entries = doc.get("camera", []) or []
    # Largest (1-based) frame index after skip remapping decides array length,
    # mirroring trackedFrameCount in configuration.cpp:204-224.
    tracked = 0
    parsed = []
    for entry in cam_entries:
        fi = int(entry["frame"])
        assert fi > 0, "frame indices are 1-based"
        fi -= 1
        if fi % skip_frames:
            continue
        fi //= skip_frames
        parsed.append((fi, entry))
        tracked = max(tracked, fi + 1)

    cameras = np.zeros((tracked, 4, 4), dtype=np.float32)
    near = np.zeros(tracked, dtype=np.float32)
    far = np.zeros(tracked, dtype=np.float32)
    valid = np.zeros(tracked, dtype=bool)
    for fi, entry in parsed:
        proj = np.asarray(entry["projection"], dtype=np.float32)
        if proj.shape != (4, 4):
            raise ValueError(f"projection for frame {fi} is {proj.shape}, not 4x4")
        cameras[fi] = proj
        near[fi] = float(entry["near"])
        far[fi] = float(entry["far"])
        valid[fi] = True
    if not np.all((near[valid] > 0) & (far[valid] > 0)):
        raise ValueError("near/far values must be positive for tracked frames")

    bundles = []
    enabled = []
    for track in doc.get("tracks", []) or []:
        bundle = np.asarray(track["bundle"], dtype=np.float32).reshape(-1)
        if bundle.shape[0] != 4:
            raise ValueError("bundle must be a 4-vector")
        frames_enabled = track.get("frames-enabled", []) or []
        remapped = set()
        for f in frames_enabled:
            f0 = int(f) - 1
            if f0 % skip_frames == 0:
                remapped.add(f0 // skip_frames)
        bundles.append(bundle)
        enabled.append(remapped)
    bundles_arr = (
        np.stack(bundles).astype(np.float32)
        if bundles
        else np.zeros((0, 4), dtype=np.float32)
    )

    return TrackFile(
        clip_path=clip_path,
        width=width,
        height=height,
        fov=float(clip.get("fov", 0.0)),
        distortion=distortion,
        center_x=float(clip.get("center-x", width / 2.0)),
        center_y=float(clip.get("center-y", height / 2.0)),
        cameras=cameras,
        near=near,
        far=far,
        camera_valid=valid,
        bundles=bundles_arr,
        bundles_enabled=enabled,
    )
