"""meshrecon_torch's clip decode and scene ingestion against meshrecon's
on the CPU (mirrors tests/test_ingest.py).

Both packages decode the same MJPG file with the same cv2, so the frames
must be equal bit for bit: cv2's BGR frames, the skip, the INTER_AREA
resize and the float32 Rec.601 weights are the same operations on the
same bytes. The lazy multi-scene configs, the per-scene output names and
checkpoint directories, and the preset's levers must equal the JAX
package's exactly.
"""

import io as _io
import os

import numpy as np
import pytest
import torch

from meshrecon.io.blender_export_tracks import write_tracks_yaml
from meshrecon.pipeline.config import config_from_args as j_config
from meshrecon.pipeline.config import configs_from_args as j_configs
from meshrecon_torch.pipeline.config import config_from_args as t_config
from meshrecon_torch.pipeline.config import configs_from_args as t_configs

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)

W, H = 64, 48
PROJ = [[1.5, 0, 0, 0], [0, 2.0, 0, 0], [0, 0, -1.2, -3.4], [0, 0, -1, 0]]


def _write_scene(tmp_path, n_cams, width=W, height=H, clip="clip.avi"):
    buf = _io.StringIO()
    write_tracks_yaml(
        buf,
        {"path": clip, "width": width, "height": height, "fov": 1.1,
         "distortion": (0.0, 0.0, 0.0), "center_x": width / 2,
         "center_y": height / 2},
        [{"frame": i + 1, "near": 2.0, "far": 20.0, "projection": PROJ,
          "position": [0.1 * i, 0, 0, 1]} for i in range(n_cams)],
        [{"bundle": [0, 0, 5, 1],
          "frames_enabled": list(range(1, n_cams + 1))}])
    path = tmp_path / "scene.yaml"
    path.write_text(buf.getvalue())
    return str(path)


def _write_clip(path, n_frames, width=W, height=H, seed=0):
    """Textured BGR frames (seeded noise over a per-frame color), MJPG."""
    rng = np.random.default_rng(seed)
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 24,
                         (width, height))
    assert wr.isOpened()
    for i in range(n_frames):
        base = np.array([40 + 20 * i, 60 + 15 * i, 80 + 10 * i], np.float64)
        noise = rng.uniform(-30, 30, size=(height, width, 3))
        wr.write(np.clip(base + noise, 0, 255).astype(np.uint8))
    wr.release()


def _frames(cfg):
    return cfg.frames.numpy() if isinstance(cfg.frames, torch.Tensor) \
        else np.asarray(cfg.frames)


@pytest.mark.parametrize("case,flags,clip_size,n_cams,n_frames,shape", [
    ("rec601", [], (W, H), 3, 3, (3, H, W)),
    ("skip", ["-k", "2"], (W, H), 5, 5, (3, H, W)),
    ("downscale", ["-s", "2"], (W, H), 2, 2, (2, H // 2, W // 2)),
    ("resize", [], (2 * W, 2 * H), 2, 2, (2, H, W))],
    ids=["rec601", "skip", "downscale", "resize"])
def test_decode_equals_jax(tmp_path, case, flags, clip_size, n_cams,
                           n_frames, shape):
    yaml = _write_scene(tmp_path, n_cams=n_cams)
    _write_clip(tmp_path / "clip.avi", n_frames, *clip_size)
    ours = t_config([yaml, "--device", "cpu"] + flags)
    ref = j_config([yaml] + flags)
    assert ours.frames.dtype == torch.float32
    assert ours.frames.device.type == "cpu"
    assert _frames(ours).shape == shape == ref.frames.shape
    np.testing.assert_array_equal(_frames(ours), ref.frames)
    assert (ours.width, ours.height, len(ours.frames)) == (
        ref.width, ref.height, ref.frame_count)


@pytest.mark.parametrize("n_frames,clip,error,match", [
    (3, "clip.avi", RuntimeError, "usable frames"),
    (0, "nope.avi", FileNotFoundError, "nope.avi")], ids=["short", "missing"])
def test_decode_failures_raise(tmp_path, n_frames, clip, error, match):
    yaml = _write_scene(tmp_path, n_cams=6, clip=clip)
    if n_frames:
        _write_clip(tmp_path / "clip.avi", n_frames)
    with pytest.raises(error, match=match):
        t_config([yaml, "--device", "cpu"])
    with pytest.raises(error):
        j_config([yaml])


def _two_scenes(tmp_path):
    dirs = [tmp_path / "a", tmp_path / "b"]
    yamls = []
    for seed, d in enumerate(dirs):
        d.mkdir()
        yamls.append(_write_scene(d, n_cams=3))
        _write_clip(d / "clip.avi", 3, seed=seed)
    return yamls


def test_multi_scene_lazy_decode(tmp_path):
    """Several YAMLs decode lazily: sizes answer from the hint,
    ensure_frames puts the frames on the device equal to the JAX decode,
    release_frames drops them (and only them), a single scene is eager."""
    ya, yb = _two_scenes(tmp_path)
    ours = t_configs([ya, yb, "--device", "cpu"])
    ref = j_configs([ya, yb])
    assert all(c.frames is None and c.frames_loader is not None
               for c in ours)
    for o, r in zip(ours, ref):
        assert o.shape_hint == r.shape_hint == (3, H, W)
        assert (o.height, o.width) == (H, W)
    ours[1].ensure_frames()
    ref[1].ensure_frames()
    assert ours[0].frames is None
    assert isinstance(ours[1].frames, torch.Tensor)
    np.testing.assert_array_equal(_frames(ours[1]), ref[1].frames)
    np.testing.assert_array_equal(ours[1].frame(2).numpy(), ref[1].frame(2))
    loader, track = ours[1].frames_loader, ours[1].track
    ours[1].release_frames()
    assert ours[1].frames is None
    assert ours[1].frames_loader is loader and ours[1].track is track
    assert ours[1].height == H  # the hint again
    # frame() decodes on first use
    np.testing.assert_array_equal(ours[0].frame(0).numpy(), ref[0].frame(0))
    one = t_configs([ya, "--device", "cpu"])
    assert one[0].frames is not None and one[0].frames_loader is None


@pytest.mark.parametrize("flags,names", [
    (["-o", "{out}/scene{{}}.obj"], ["scene0.obj", "scene1.obj"]),
    (["-o", "{out}/out.obj"], ["out0.obj", "out1.obj"]),
    ([], None)], ids=["placeholder", "explicit", "default"])
def test_multi_scene_output_names(tmp_path, flags, names):
    ya, yb = _two_scenes(tmp_path)
    flags = [f.format(out=tmp_path) for f in flags]
    ours = [c.out_file_name for c in t_configs([ya, yb, "--device", "cpu"]
                                               + flags)]
    ref = [c.out_file_name for c in j_configs([ya, yb] + flags)]
    assert ours == ref
    if names is None:
        names = [os.path.splitext(y)[0] + ".obj" for y in (ya, yb)]
    else:
        names = [str(tmp_path / n) for n in names]
    assert ours == names


def test_multi_scene_checkpoint_dirs(tmp_path):
    ya, yb = _two_scenes(tmp_path)
    ck = str(tmp_path / "ck")
    ours = [c.checkpoint_dir for c in t_configs(
        [ya, yb, "--device", "cpu", "--checkpoint-dir", ck])]
    ref = [c.checkpoint_dir for c in j_configs([ya, yb, "--checkpoint-dir",
                                                ck])]
    assert ours == ref == [os.path.join(ck, "scene0"),
                           os.path.join(ck, "scene1")]
    one = t_config([ya, "--device", "cpu", "--checkpoint-dir", ck])
    assert one.checkpoint_dir == ck


def test_exposure_flag_ignored_with_synthetic():
    argv = ["tracks/koule-tr.yaml", "--synthetic", "sphere", "-s", "16",
            "--device", "cpu"]
    with_e = t_config(argv + ["-e"])
    without = t_config(argv)
    assert with_e.exposure is None
    assert torch.equal(with_e.frames, without.frames)


@pytest.mark.parametrize("flags,rounds,seeds", [
    (["--preset", "quality", "--seed", "7"], 3, (7, 17, 27)),
    (["--preset", "quality", "--seed", "7", "--consensus-rounds", "1",
      "--ensemble-seeds", "4,5,6"], 1, (4, 5, 6)),
    (["--ensemble-seeds", "3, 13,"], 0, (3, 13)),
    ([], 0, ())], ids=["preset", "explicit_wins", "seeds", "none"])
def test_preset_and_ensemble_levers(tmp_path, flags, rounds, seeds):
    yaml = _write_scene(tmp_path, n_cams=2)
    _write_clip(tmp_path / "clip.avi", 2)
    ours = t_config([yaml, "--device", "cpu"] + flags)
    ref = j_config([yaml] + flags)
    assert (ours.consensus_rounds, ours.ensemble_seeds) == (rounds, seeds)
    assert (ref.consensus_rounds, ref.ensemble_seeds) == (rounds, seeds)
    assert ours.poisson_trim == ref.poisson_trim == 2.0


@pytest.mark.parametrize("flags,verbosity", [
    ([], 0), (["-v"], 2), (["-V"], 99), (["-v", "-V"], 99)])
def test_verbosity_levels(tmp_path, flags, verbosity):
    yaml = _write_scene(tmp_path, n_cams=2)
    _write_clip(tmp_path / "clip.avi", 2)
    assert t_config([yaml, "--device", "cpu"] + flags).verbosity == \
        j_config([yaml] + flags).verbosity == verbosity
