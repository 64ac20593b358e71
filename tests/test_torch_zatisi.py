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

Iteration 1's stages on identical inputs, on the CPU (``stages``):

    JAX_PLATFORMS=cpu python tests/test_torch_zatisi.py stages jax F.npy 4 J.npz
    python tests/test_torch_zatisi.py stages port F.npy 4 P.npz
    python tests/test_torch_zatisi.py compare J.npz P.npz

``stages`` runs the harness's default in one package up to iteration 1's
filter and saves the chosen bundles, each batched update's ten inputs and
its outputs, and the cloud before and after the filter. ``compare`` runs
the port's update on JAX's saved inputs and holds each main camera's
outputs to JAX's by meshrecon_torch/parity.py's metrics, then the port's
filter on JAX's unfiltered cloud against JAX's filtered one, then the
port's own run (its inputs, outputs and cloud) against JAX's.
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


class _StageStop(Exception):
    """Raised after iteration 1's filter: the rest of the run is not
    needed."""


def stages(which, path, seed, out):
    """The harness's default at 640x480 in one package (``jax`` or
    ``port``, the port on the CPU) on the frames saved at ``path``, up to
    iteration 1's filter; saves to ``out`` the bundles, each batched
    update's inputs (``in<b>_<i>``) and outputs (``out<b>_<key>``), and
    the cloud before (``pre_*``) and after (``post_*``) the filter."""
    frames = np.load(path)
    rec, batches = {}, []
    if which == "jax":
        import jax.numpy as jnp

        from meshrecon.io.tracks import load_tracks
        from meshrecon.pipeline.config import Config

        mod = importlib.import_module("meshrecon.pipeline.reconstruct")
        cfg = Config(track=load_tracks(TRACK), frames=jnp.asarray(frames),
                     seed=seed, min_bundles=4, out_file_name="unused.obj")

        def recorded(make):
            def builder(*a, **k):
                step = make(*a, **k)

                def run(*args):
                    o = step(*args)
                    batches.append(([np.asarray(x) for x in args],
                                    {k_: np.asarray(v) for k_, v in
                                     o.items()}))
                    return o
                return run
            return builder

        patches = [mock.patch.object(mod, "_vmapped_step",
                                     recorded(mod._vmapped_step)),
                   mock.patch.object(mod, "_sweep_step",
                                     recorded(mod._sweep_step)),
                   mock.patch.object(mod, "_prewarm_flow_step",
                                     lambda *a, **k: None)]
        filt = mod.filter_points
    else:
        import torch

        from meshrecon_torch.io.tracks import load_tracks
        from meshrecon_torch.pipeline.config import Config

        mod = importlib.import_module("meshrecon_torch.pipeline.reconstruct")
        cfg = Config(track=load_tracks(TRACK), frames=torch.from_numpy(frames),
                     device="cpu", seed=seed, min_bundles=4,
                     out_file_name="unused.obj")

        def recorded(make):
            def builder(config):
                update = make(config)

                def run(*args):
                    o = update(*args)
                    batches.append(([a.cpu().numpy() for a in args],
                                    {k_: v.cpu().numpy() for k_, v in
                                     o.items()}))
                    return o
                return run
            return builder

        patches = [mock.patch.object(mod, "main_update",
                                     recorded(mod.main_update)),
                   mock.patch.object(mod, "sweep_update",
                                     recorded(mod.sweep_update))]
        filt = mod.filter_points

    def stop_after_filter(points, normals, radius_sq, **kwargs):
        kept = filt(points, normals, radius_sq, **kwargs)
        rec.update(pre_points=np.asarray(points),
                   pre_normals=np.asarray(normals),
                   radius_sq=np.float64(radius_sq),
                   post_points=np.asarray(kept[0]),
                   post_normals=np.asarray(kept[1]),
                   post_kept=np.asarray(kept[2]))
        raise _StageStop

    choose = mod.Heuristic.choose_cameras

    def chosen(self, mesh, cameras, renderer):
        count = choose(self, mesh, cameras, renderer)
        rec["bundles"] = np.array([(m, *sorted(s), *[-1] * (16 - len(s)))
                                   for m, s in self.camera_bundles()])
        rec["alpha_faces"] = np.int64(len(mesh.faces))
        print(f"iteration {self.iteration}: mesh {len(mesh.faces)} faces, "
              f"bundles {rec['bundles'].tolist()}", flush=True)
        return count

    patches += [mock.patch.object(mod, "filter_points", stop_after_filter),
                mock.patch.object(mod.Heuristic, "choose_cameras", chosen)]
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        try:
            mod.reconstruct(cfg)
        except _StageStop:
            pass
    for b, (args, outs) in enumerate(batches):
        rec.update({f"in{b}_{i}": a for i, a in enumerate(args)})
        rec.update({f"out{b}_{k}": v for k, v in outs.items()})
    rec["n_batches"] = np.int64(len(batches))
    np.savez(out, **rec)
    print(f"{which}: {len(batches)} batched updates, "
          f"{len(rec['pre_points'])} points before the filter, "
          f"{len(rec['post_points'])} after -> {out}", flush=True)


def _metrics_line(label, metrics):
    from meshrecon_torch import parity

    missed = [k for k, (kind, bound) in parity.SLICE_BOUNDS.items()
              if not (metrics[k] >= bound if kind == "min"
                      else metrics[k] <= bound)]
    print(f"{label}: " + ", ".join(f"{k} {v:.4g}" for k, v in
                                   metrics.items())
          + (f"  MISSED {missed}" if missed else "  within parity.py"),
          flush=True)
    return missed


def _cloud_line(label, a_pts, b_pts):
    """Counts of two clouds and, if equal, their largest point gap."""
    text = f"{label}: {len(a_pts)} against {len(b_pts)} points"
    if len(a_pts) == len(b_pts) and len(a_pts):
        p3a = a_pts[:, :3] / a_pts[:, 3:4]
        p3b = b_pts[:, :3] / b_pts[:, 3:4]
        gap = np.linalg.norm(p3a - p3b, axis=1)
        text += (f", largest gap {gap.max():.3e}, median {np.median(gap):.3e}"
                 f", equal {int((gap == 0).sum())}")
    print(text, flush=True)


def _unit(n):
    length = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.where(length == 0, 1.0, length)


def _normals_split(j, bundles):
    """The normals stage alone: the port's ``estimate_normals_batched`` on
    JAX's point4, pdf and valid of each batch against JAX's normals, and
    both against the same stage evaluated in float64 (torch.float32 read
    as float64 inside the call): the share of valid pixels whose
    orientation (the sign of the camera vote sum) differs."""
    import torch

    from meshrecon_torch.depth import normals

    def flips(a, b):
        return float(np.mean(np.sum(a * b, -1) < 0))

    for b in range(int(j["n_batches"])):
        p4, pdf, valid = (torch.from_numpy(j[f"out{b}_{k}"])
                          for k in ("point4", "pdf", "valid"))
        centers, cvalid, n_side = (torch.from_numpy(j[f"in{b}_{i}"])
                                   for i in (7, 8, 9))
        ours = normals.estimate_normals_batched(p4, valid, pdf, centers,
                                                cvalid, n_side).numpy()
        with mock.patch.object(torch, "float32", torch.float64):
            ref64 = normals.estimate_normals_batched(
                p4.double(), valid, pdf.double(), centers.double(), cvalid,
                n_side).numpy()
        for i in range(len(p4)):
            if 4 * b + i >= len(bundles):
                continue
            v = j[f"out{b}_valid"][i]
            uj, uo, u64 = (_unit(x[i][v]) for x in (j[f"out{b}_normals"],
                                                     ours, ref64))
            print(f"normals stage, main camera {bundles[4 * b + i]}, on "
                  f"JAX's points: flips port/JAX {flips(uo, uj):.5f}; "
                  f"against float64: JAX {flips(uj, u64):.5f}, port "
                  f"{flips(uo, u64):.5f}", flush=True)


def compare(jax_path, port_path):
    """The port's update on JAX's saved inputs against JAX's outputs per
    main camera, the port's filter on JAX's cloud, then the port's own
    run against JAX's."""
    import torch

    from meshrecon_torch import parity, state
    from meshrecon_torch.io.tracks import load_tracks
    from meshrecon_torch.pipeline.config import Config
    from meshrecon_torch.points.filter import filter_points

    mod = importlib.import_module("meshrecon_torch.pipeline.reconstruct")
    j, p = np.load(jax_path), np.load(port_path)
    print(f"bundles equal: {np.array_equal(j['bundles'], p['bundles'])}; "
          f"alpha mesh faces: jax {int(j['alpha_faces'])}, port "
          f"{int(p['alpha_faces'])}", flush=True)
    cfg = Config(track=load_tracks(TRACK), frames=torch.zeros(1, H, W),
                 device="cpu", seed=0, min_bundles=4)
    update = mod.main_update(cfg)
    bundles = [m for m in j["bundles"][:, 0]]
    missed_any = []
    for b in range(int(j["n_batches"])):
        args = [j[f"in{b}_{i}"] for i in range(10)]
        if b < int(p["n_batches"]):
            same = [i for i in range(10)
                    if np.array_equal(args[i], p[f"in{b}_{i}"])]
            print(f"batch {b}: inputs equal to the port's own run: {same}",
                  flush=True)
        with torch.no_grad():
            ours = state.to_numpy(update(*state.from_numpy(args, "cpu")))
        ref = {k: j[f"out{b}_{k}"] for k in ours}
        for i in range(len(args[2])):
            cam = bundles[4 * b + i] if 4 * b + i < len(bundles) else None
            if cam is None:
                continue
            one = {k: v[i] for k, v in ours.items()}
            one_ref = {k: v[i] for k, v in ref.items()}
            missed_any += _metrics_line(
                f"update, main camera {cam}, port on JAX's inputs",
                parity.slice_agreement(one, one_ref))
            if b < int(p["n_batches"]):
                own = {k: p[f"out{b}_{k}"][i] for k in ours}
                _metrics_line(f"update, main camera {cam}, port's own run",
                              parity.slice_agreement(own, one_ref))
    _normals_split(j, bundles)
    pts, nrm, kept = filter_points(j["pre_points"], j["pre_normals"],
                                   float(j["radius_sq"]), device="cpu")
    print(f"filter on JAX's cloud: kept equal "
          f"{np.array_equal(kept, j['post_kept'])}", flush=True)
    _cloud_line("filter on JAX's cloud", pts, j["post_points"])
    _cloud_line("the port's own cloud before the filter", p["pre_points"],
                j["pre_points"])
    _cloud_line("the port's own filtered cloud", p["post_points"],
                j["post_points"])
    print(f"update cameras off parity.py: {sorted(set(missed_any))}",
          flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    if sys.argv[1] == "frames":
        save_frames(sys.argv[2])
    elif sys.argv[1] == "stages":
        stages(sys.argv[2], sys.argv[3], int(sys.argv[4]), sys.argv[5])
    elif sys.argv[1] == "compare":
        compare(sys.argv[2], sys.argv[3])
    else:
        print("rc", draws(sys.argv[2], sys.argv[3], int(sys.argv[4])))
