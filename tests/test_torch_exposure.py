"""meshrecon_torch.pipeline.exposure and the projection it uses against
meshrecon's on the CPU.

Bounds:
- project_points: rtol 1e-6, and 2.5e-7 absolute (two float32 ulps of
  1.0; NDC coordinates are of order 1, and a coordinate near 0 comes out
  of a cancelling sum whose products the two packages round in another
  order).
- sample_box: bit for bit (the same float64 NumPy on the same inputs).
- the solve: the same number of rounds as the JAX package's while-loop on
  every input below, so neither run stops a round apart at the 0.1 exit.
  Per-channel gains rtol 1e-4 where the samples are full rank (three
  independent textures; taken against the largest gain, since the solve
  gives some gains near 0); on JAX's own near-rank-1 case
  (tests/test_pipeline.py::test_exposure_estimation) the per-channel gains
  are ill-conditioned, so only their per-frame sum (rtol 1e-3) and the
  gray frames (0.5 of 255 levels) are held; on exact rank 1 (three equal
  channels, a gray clip stored as BGR) the minimum-norm gains within 1e-4,
  which a full-rank solver such as ``gels`` would not give.
- exposure.tab on the full-rank input: the gains within 1e-5, the
  residual RMS within 1e-5 relative (it is on the intensities' 0..255
  scale; 174 on these frames).
"""

import numpy as np
import pytest
import torch

import jax

from meshrecon.geometry.camera import project_points as j_project
from meshrecon.io.synthetic import synthetic_frames as j_frames
from meshrecon.io.tracks import load_tracks
from meshrecon.pipeline import exposure as jexp
from meshrecon_torch.geometry.camera import project_points as t_project
from meshrecon_torch.pipeline import exposure as texp

torch.set_num_threads(1)


@pytest.fixture
def jax_rounds(monkeypatch):
    """The round counts of the JAX package's exposure while-loops (its
    final carry holds the count, which the function drops)."""
    counts = []
    orig = jax.lax.while_loop

    def counting(cond, body, init):
        out = orig(cond, body, init)
        counts.append(int(out[3]))
        return out

    monkeypatch.setattr(jax.lax, "while_loop", counting)
    return counts


@pytest.fixture
def port_rounds(monkeypatch):
    """The round counts of the port's solves under estimate_exposure."""
    counts = []
    orig = texp._solve_exposure_device

    def counting(*args, **kwargs):
        out = orig(*args, **kwargs)
        counts.append(out[2]["rounds"])
        return out

    monkeypatch.setattr(texp, "_solve_exposure_device", counting)
    return counts


@pytest.mark.parametrize("yaml", ["koule-tr", "zatisi", "koberec"])
def test_project_points_matches_jax(yaml):
    track = load_tracks(f"tracks/{yaml}.yaml")
    aspect = track.height / track.width
    for i in range(0, track.frame_count, max(1, track.frame_count // 5)):
        for dist in (None, track.distortion):
            ours = t_project(track.cameras[i], track.bundles, dist, aspect,
                             device="cpu")
            ref = np.asarray(j_project(track.cameras[i], track.bundles, dist,
                                       aspect))
            assert ours.dtype == torch.float32 and ours.shape == ref.shape
            np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6,
                                       atol=2.5e-7)


def test_sample_box_bitwise():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(40, 50, 3)).astype(np.uint8)
    img[10:20, 10:20] = 255  # clipped texels are left out
    img[30:, :8] = 0
    for x, y in [(0.0, 0.0), (3.3, 7.9), (15.0, 15.0), (49.9, 39.9),
                 (-3.0, 5.0), (60.0, 20.0), (4.0, 35.0), (25.5, 12.25)]:
        for c in range(3):
            ours = texp.sample_box(img, 16.0, x, y, c)
            ref = jexp.sample_box(img, 16.0, x, y, c)
            assert ours == ref or (np.isnan(ours) and np.isnan(ref))


def _samples(kind, f_count=31, n=120, seed=0):
    rng = np.random.default_rng(seed)
    bright = rng.uniform(40, 200, n)
    gains = 1 + 0.2 * np.sin(np.arange(f_count)[:, None]
                             + 2 * np.arange(3)[None, :])
    if kind == "full_rank":  # per-point colors from three textures
        samp = bright[None, :, None] * rng.uniform(0.5, 1.5, (1, n, 3)) \
            * gains[:, None, :]
    else:  # rank 1: equal channels
        samp = np.repeat((bright[None, :] * gains[:, :1])[..., None], 3, 2)
    valid = rng.uniform(size=(f_count, n)) < 0.8
    return np.where(valid[..., None], samp, -1.0), valid


@pytest.mark.parametrize("kind,tol", [("full_rank", 1e-4), ("rank1", 1e-4)])
def test_solve_matches_jax(jax_rounds, kind, tol):
    samp, valid = _samples(kind)
    ref_e, ref_b = jexp._solve_exposure_device(samp, valid)
    ours_e, ours_b, info = texp._solve_exposure_device(samp, valid, "cpu")
    assert info["rounds"] == jax_rounds[-1]
    assert info["device"] == "cpu"
    assert ours_e.shape == ref_e.shape == (3, 31)
    if kind == "full_rank":
        np.testing.assert_allclose(ours_e, ref_e, rtol=0,
                                   atol=tol * np.abs(ref_e).max())
    else:
        # minimum norm: the gain splits evenly over the equal channels
        np.testing.assert_allclose(ours_e, ref_e, atol=tol)
        np.testing.assert_allclose(
            ours_e, np.broadcast_to(ours_e.mean(0), ours_e.shape), atol=tol)
    np.testing.assert_allclose(ours_b, ref_b, rtol=1e-4)


def test_solve_uses_no_lstsq():
    """The minimum-norm SVD solve, not torch's least-squares solver."""
    import inspect

    assert "lstsq" not in inspect.getsource(texp)


@pytest.fixture(scope="module")
def koule():
    track = load_tracks("tracks/koule-tr.yaml")
    return track, j_frames(track, 80, 60, mode="sphere", seed=0)


def _estimate(pkg, bgr, track, **kw):
    return pkg.estimate_exposure(
        bgr, track.cameras, track.bundles, track.bundles_enabled,
        track.distortion, track.center_x / 8, track.center_y / 8, 80, 60,
        dump_tab=True, **kw)


def test_near_rank1_matches_jax(koule, tmp_path, monkeypatch, jax_rounds,
                                port_rounds):
    """JAX's own case: one gray texture in all three channels times a
    per-frame gain, plus noise (tests/test_pipeline.py:335-364)."""
    monkeypatch.chdir(tmp_path)
    track, gray = koule
    rng = np.random.default_rng(0)
    gains = 1.0 + 0.3 * np.sin(np.arange(track.frame_count))
    bgr = [np.clip(np.stack([g * gray[i]] * 3, axis=-1)
                   + rng.normal(scale=1.0, size=gray[i].shape + (3,)),
                   1, 254).astype(np.uint8) for i, g in enumerate(gains)]
    ref_gray, ref_e = _estimate(jexp, bgr, track)
    ours_gray, ours_e = _estimate(texp, bgr, track, device="cpu")
    assert port_rounds == jax_rounds[-1:]
    np.testing.assert_allclose(ours_e.sum(0), ref_e.sum(0), rtol=1e-3)
    assert ours_gray.dtype == np.float32 and ours_gray.shape == gray.shape
    assert np.abs(ours_gray - ref_gray).max() <= 0.5
    total = ours_e.sum(0) * gains
    assert total.std() / total.mean() < 0.15  # JAX's own bound


def test_full_rank_clip_and_tab_match_jax(koule, tmp_path, monkeypatch,
                                          jax_rounds, port_rounds):
    """Three independent surface textures as B, G, R, each times its own
    per-frame gain: the gains, the gray frames and exposure.tab."""
    monkeypatch.chdir(tmp_path)
    track, _ = koule
    planes = [j_frames(track, 80, 60, mode="sphere", seed=s)
              for s in (3, 4, 5)]
    bgr = [np.stack([np.clip(planes[c][f] * (1 + 0.2 * np.sin(f + 2 * c)),
                             1, 254) for c in range(3)],
                    axis=-1).astype(np.uint8)
           for f in range(track.frame_count)]
    ref_gray, ref_e = _estimate(jexp, bgr, track)
    ref_tab = np.loadtxt("exposure.tab")
    ours_gray, ours_e = _estimate(texp, bgr, track, device="cpu")
    ours_tab = np.loadtxt("exposure.tab")
    assert port_rounds == jax_rounds[-1:]
    np.testing.assert_allclose(ours_e, ref_e, rtol=0,
                               atol=1e-4 * np.abs(ref_e).max())
    assert np.abs(ours_gray - ref_gray).max() <= 0.5
    assert ours_tab.shape == ref_tab.shape == (track.frame_count, 4)
    np.testing.assert_allclose(ours_tab[:, :3], ref_tab[:, :3], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ours_tab[:, 3], ref_tab[:, 3], rtol=1e-5)


def test_too_few_samples_raise(koule):
    track, _ = koule
    black = [np.zeros((60, 80, 3), np.uint8)] * track.frame_count
    with pytest.raises(RuntimeError, match="frame 0: too few valid"):
        _estimate(texp, black, track, device="cpu")


def test_decoded_clip_with_exposure_matches_jax(koule, tmp_path,
                                                jax_rounds, port_rounds):
    """-e through the CLI's config on an MJPG clip: the same decoded BGR
    reach both solves, so rounds, gains and gray frames agree."""
    cv2 = pytest.importorskip("cv2")
    from meshrecon.pipeline.config import config_from_args as j_config
    from meshrecon_torch.pipeline.config import config_from_args as t_config

    track, _ = koule
    planes = [j_frames(track, 80, 60, mode="sphere", seed=s)
              for s in (3, 4, 5)]
    wr = cv2.VideoWriter(str(tmp_path / "koule.avi"),
                         cv2.VideoWriter_fourcc(*"MJPG"), 24, (80, 60))
    for f in range(track.frame_count):
        wr.write(np.stack([np.clip(planes[c][f] * (1 + 0.2 * np.sin(
            f + 2 * c)), 1, 254) for c in range(3)], -1).astype(np.uint8))
    wr.release()
    text = open("tracks/koule-tr.yaml").read().replace("koule-perlin.mkv",
                                                      "koule.avi")
    (tmp_path / "k.yaml").write_text(text)
    argv = [str(tmp_path / "k.yaml"), "-e", "-s", "8"]
    ref = j_config(argv)
    ours = t_config(argv + ["--device", "cpu"])
    assert port_rounds == jax_rounds[-1:]
    np.testing.assert_allclose(ours.exposure.sum(0), ref.exposure.sum(0),
                               rtol=1e-3)
    assert np.abs(ours.frames.numpy() - ref.frames).max() <= 0.5
