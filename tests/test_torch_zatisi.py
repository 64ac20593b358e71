"""zatisi at 640x480 in both packages (ROADMAP Queue C): the quality
harness's default config (``-n 2`` flow, min_bundles 4) on one set of
frames, and where the two packages' camera draws part.

Collected: iteration 1's camera policy on zatisi at 640x480 in both
packages on the CPU. Iteration 1 meshes the track's bundle points alone,
so blank frames do. The alpha meshes have the same face count, the probe
shots the same viewers and samples, and the probe depths agree within
1e-6 (absolute, NDC) wherever both packages see the surface; coverage may
flip only at samples on a triangle's edge, at most one in 1,000 in-frame
samples (measured: 6 of 17,667).

As a script (from the repo root), the harness's default at 640x480 at any
seed (the harness's own is 3), on saved frames or (``-``) the package's
own:

    JAX_PLATFORMS=cpu python tests/test_torch_zatisi.py frames F.npy
    python tests/test_torch_zatisi.py draws port F.npy 3      # on the card
    python tests/test_torch_zatisi.py draws port - 3          # on the card
    python tests/test_torch_zatisi.py draws port-cpu F.npy 3
    JAX_PLATFORMS=cpu python tests/test_torch_zatisi.py draws jax F.npy 3

``frames`` saves the JAX package's synthetic frames (seed 0, mode auto).
``draws`` prints each iteration's mesh and bundles and the harness's row,
and writes no file.
Only the ``jax`` and ``frames`` modes import JAX, so ``draws port`` runs
where JAX is not installed.
"""

import contextlib
import importlib
import importlib.util
import sys
from pathlib import Path
from unittest import mock

import numpy as np

W, H = 640, 480
TRACK = "tracks/zatisi.yaml"


def save_frames(path):
    from meshrecon.io.synthetic import synthetic_frames
    from meshrecon.io.tracks import load_tracks

    np.save(path, np.asarray(synthetic_frames(load_tracks(TRACK), W, H,
                                              mode="auto", seed=0),
                             np.float32))


def draws(which, path, seed):
    """The harness's default at 640x480 in one package, at ``seed`` (the
    harness's own is 3), on the frames saved at ``path`` (``-``: the
    package's own frames); prints each iteration's mesh and bundles."""
    patches = []
    if which.startswith("port"):
        import torch

        from meshrecon_torch.pipeline import heuristic
        from meshrecon_torch.pipeline.config import Config
        from meshrecon_torch.tools import quality_harness as tool

        if path != "-":
            frames = np.load(path)
            patches.append(mock.patch(
                "meshrecon_torch.io.synthetic.synthetic_frames",
                lambda *a, device="cuda", **k:
                    torch.from_numpy(frames).to(device)))
        argv = ["--device", "cpu" if which == "port-cpu" else "cuda"]
    else:
        import jax.numpy as jnp

        from meshrecon.pipeline import heuristic
        from meshrecon.pipeline.config import Config

        spec = importlib.util.spec_from_file_location(
            "quality_harness", "tools/quality_harness.py")
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        if path != "-":
            frames = np.load(path)
            patches.append(mock.patch(
                "meshrecon.io.synthetic.synthetic_frames",
                lambda *a, **k: jnp.asarray(frames)))
        argv = []
    inner, init = heuristic.Heuristic.choose_cameras, Config.__init__

    def choose(self, mesh, cameras, renderer):
        count = inner(self, mesh, cameras, renderer)
        print(f"iteration {self.iteration}: mesh {len(mesh.faces)} faces, "
              f"{count} bundles "
              f"{sorted((m, sorted(s)) for m, s in self.chosen)}", flush=True)
        return count

    def seeded(self, *args, **kwargs):
        init(self, *args, **{**kwargs, "seed": seed})

    # the harness reads the mesh reconstruct returns: its OBJ is not kept
    patches += [mock.patch.object(heuristic.Heuristic, "choose_cameras",
                                  choose),
                mock.patch.object(Config, "__init__", seeded),
                mock.patch.object(importlib.import_module(
                    Config.__module__.replace("config", "reconstruct")),
                    "save_mesh", lambda mesh, path: None)]
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        return tool.main(["--scale", "1", "--scenes", "zatisi"] + argv)


def _probe_runs():
    """Iteration 1's camera policy in each package on blank frames:
    {package: (alpha mesh, chosen bundles, probe record)}."""
    import jax.numpy as jnp
    import torch

    from meshrecon.io.tracks import load_tracks as j_load_tracks
    from meshrecon.pipeline.config import Config as JConfig
    from meshrecon.pipeline.heuristic import Heuristic as JHeuristic
    from meshrecon.raster import Renderer as JRenderer
    from meshrecon_torch.io.tracks import load_tracks
    from meshrecon_torch.pipeline.config import Config
    from meshrecon_torch.pipeline.heuristic import Heuristic
    from meshrecon_torch.raster.rasterizer import Renderer

    blank = np.zeros((load_tracks(TRACK).cameras.shape[0], H, W), np.float32)
    runs = {
        "jax": (JConfig(track=j_load_tracks(TRACK), frames=jnp.asarray(blank),
                        seed=3, min_bundles=4), JHeuristic,
                lambda: JRenderer(W, H)),
        "port": (Config(track=load_tracks(TRACK),
                        frames=torch.from_numpy(blank), device="cpu", seed=3,
                        min_bundles=4), Heuristic,
                 lambda: Renderer(W, H, device="cpu"))}
    seen = {}
    for name, (cfg, heuristic_cls, renderer_cls) in runs.items():
        hint = heuristic_cls(cfg)
        points = np.asarray(cfg.reconstructed_points(), np.float32)
        hint.not_happy(points)
        mesh = hint.tessellate(points, np.zeros((len(points), 3), np.float32))
        renderer = renderer_cls()
        renderer.load_mesh(mesh)
        inner, rec = renderer.depth_at, {}

        def depth_at(cams, xy, inner=inner, rec=rec):
            out = inner(cams, xy)
            rec.update(viewers=np.asarray(cams), xy=np.asarray(xy),
                       probe=np.asarray(out.cpu() if hasattr(out, "cpu")
                                        else out))
            return out

        renderer.depth_at = depth_at
        hint.choose_cameras(mesh, cfg.cameras, renderer)
        seen[name] = (mesh, sorted((m, sorted(s)) for m, s in hint.chosen),
                      rec)
    return seen


def _probe64(cameras, xy, soup, valid):
    """The probe in float64 from the JAX package's float32 screen planes:
    the edge functions, depths and coverage evaluated in float64."""
    import jax.numpy as jnp

    from meshrecon.raster.rasterizer import EDGE_TIE_SLOP, clip_project_planes

    out = np.ones(xy.shape[:2])
    for i, camera in enumerate(cameras):
        planes = [np.asarray(p) for p in clip_project_planes(
            jnp.asarray(camera), jnp.asarray(soup), jnp.asarray(valid))]
        ok = planes[10]
        x0, x1, x2, y0, y1, y2, z0, z1, z2, area = (
            p.astype(np.float64) for p in planes[:10])
        inv = np.where(ok & (np.abs(area) > 1e-12),
                       1.0 / np.where(area == 0, 1.0, area), 0.0)
        px, py = (xy[i][None, :, k].astype(np.float64) for k in (0, 1))
        ls = []
        for ax, ay, bx, by in ((x1, y1, x2, y2), (x2, y2, x0, y0),
                               (x0, y0, x1, y1)):
            a, b = (ay - by) * inv, (bx - ax) * inv
            c = ((by - ay) * ax - (bx - ax) * ay) * inv
            c = c + EDGE_TIE_SLOP * np.sqrt(a * a + b * b)
            ls.append(a[:, None] * px + b[:, None] * py + c[:, None])
        ls[0] = np.where(ok[:, None], ls[0], -1.0)
        z = ls[0] * z0[:, None] + ls[1] * z1[:, None] + ls[2] * z2[:, None]
        covered = ((ls[0] >= 0) & (ls[1] >= 0) & (ls[2] >= 0) & (z >= -1.0)
                   & (z <= 1.0))
        zmin = np.where(covered, z, np.inf).min(0)
        out[i] = np.where(np.isfinite(zmin), zmin, 1.0)
    return out


def test_iteration_one_probe_matches_jax(monkeypatch):
    """The same alpha mesh and probe shots; coverage of the background
    flips at no more than one in 1,000 in-frame samples between the
    packages; and held against a float64 evaluation of the same screen
    planes, the port is off by more than 1e-3 (NDC) at no more than 1.1x
    as many in-frame samples as JAX, and its largest error is no more than
    1.1x JAX's. Measured: 6 flips of 17,667 samples; 334 samples off
    against JAX's 362, both at most 0.0446. The packages' probes differ at
    1,263 samples (at near-clipped triangles, whose screen vertices reach
    1e5 in NDC, the edge functions cancel badly: XLA's fused
    multiply-adds and the port's separate ops pick different triangles)."""
    from meshrecon_torch.raster.rasterizer import Renderer

    monkeypatch.chdir(Path(__file__).resolve().parent.parent)
    seen = _probe_runs()
    (j_mesh, j_chosen, a), (mesh, chosen, b) = seen["jax"], seen["port"]
    print(f"bundles: jax {j_chosen}, port {chosen}")
    np.testing.assert_array_equal(mesh.vertices, np.asarray(j_mesh.vertices))
    np.testing.assert_array_equal(mesh.faces, np.asarray(j_mesh.faces))
    np.testing.assert_array_equal(b["viewers"], a["viewers"])
    np.testing.assert_array_equal(b["xy"], a["xy"])
    inb = (np.abs(a["xy"]) <= 1.0).all(-1)
    flips = inb & ((a["probe"] == 1.0) != (b["probe"] == 1.0))
    renderer = Renderer(W, H, device="cpu")
    renderer.load_mesh(mesh)
    truth = _probe64(a["viewers"], a["xy"], renderer._soup.numpy(),
                     renderer._valid.numpy())
    off = {name: np.abs(rec["probe"] - truth)[inb]
           for name, rec in (("jax", a), ("port", b))}
    print(f"in-frame samples {int(inb.sum())}, coverage flips "
          f"{int(flips.sum())}, probes differing "
          f"{int((inb & (a['probe'] != b['probe'])).sum())}; off float64 "
          f"by > 1e-3: jax {int((off['jax'] > 1e-3).sum())}, port "
          f"{int((off['port'] > 1e-3).sum())}; largest: jax "
          f"{off['jax'].max():.4f}, port {off['port'].max():.4f}")
    assert flips.sum() <= 1e-3 * inb.sum()
    assert (off["port"] > 1e-3).sum() <= 1.1 * (off["jax"] > 1e-3).sum()
    assert off["port"].max() <= 1.1 * off["jax"].max()


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    if sys.argv[1] == "frames":
        save_frames(sys.argv[2])
    else:
        print("rc", draws(sys.argv[2], sys.argv[3], int(sys.argv[4])))
