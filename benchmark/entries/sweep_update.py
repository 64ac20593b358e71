"""The sweep update's cells: the program's plane-sweep update
(``FusedSweepUpdate.forward``, the hybrid default's first iteration) on
batches of a track's bundles.

Set-up makes the configuration's inputs on the card (the track's frames,
the recorded iteration-1 mesh packed as the renderer loads it, ``batches``
batches of ``batch`` bundles padded to the side bucket), builds the update
with the configuration's options, and runs ``warm_updates`` updates. An
update of the window is batch ``i mod batches``; it ends when its
``point4``, ``normals`` and ``valid`` are on the host, as the program's
reconstruction copies them. The updates drawn for the check keep ``pdf``
and ``depth`` as well.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare, work
from benchmark.inputs import scene
from benchmark.inputs.soup import packed_soup
from benchmark.reference.plane_sweep import sample_fields
from benchmark.reference.precision import Arith
from benchmark.reference.raster import BACKGROUND_DEPTH, render_depth
from benchmark.reference.sweep_update import sweep_update, z_ranges

READBACK = ("point4", "normals", "valid")


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 root):
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.root = root
        self.rng = np.random.default_rng(seed)
        self.height, self.width = config["height"], config["width"]
        self.kb = config["side_bucket"]
        self.kept = {}
        self.ran = set()

    # -- set-up ----------------------------------------------------------
    def setup(self) -> None:
        from meshrecon_torch.pipeline.fused import FusedSweepUpdate

        cfg, tr, dev = self.config, self.traffic, self.device
        cameras, bundle_pts = scene.load_track(str(self.root / cfg["track"]))
        center, radius = scene.fit_sphere(bundle_pts)
        self.radius = radius
        tex_seed = int(self.rng.integers(0, 1000))
        frames, _ = scene.sphere_frames(torch.from_numpy(cameras).to(dev),
                                        center, radius, self.height,
                                        self.width, tex_seed)
        soup, soup_valid = packed_soup(self.root / cfg["soup"], dev)
        centers = np.stack([scene.camera_center(c) for c in cameras])
        n_batches, b = tr["batches"], cfg["batch"]
        bundles = scene.draw_bundles(centers, tr["side_counts"],
                                     n_batches * b, cfg["nearest_sides"],
                                     self.rng)
        self.batches = [
            scene.batch_inputs(bundles[i * b:(i + 1) * b], cameras, frames,
                               centers, soup, soup_valid, self.kb)
            for i in range(n_batches)]
        del frames
        self.n_tri = soup.shape[0]
        self.n_tri_valid = int(soup_valid.sum())
        self.update = FusedSweepUpdate(
            self.height, self.width, num_depths=cfg["num_depths"],
            passes=cfg["passes"], shadow_sample=cfg["shadow_sample"])
        self.program = self.update
        # the updates whose outputs the check compares: distinct batches,
        # among the window's first 2 * batches updates
        span = min(tr["check_range"], 2 * n_batches)
        picks = self.rng.choice(span, size=tr["check_updates"],
                                replace=False)
        self.check_at = {int(i) for i in picks}
        t0 = time.perf_counter()
        for i in range(tr["warm_updates"]):
            self._call(i, keep=False)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.warm_s = time.perf_counter() - t0
        self.ran.clear()

    # -- the window ------------------------------------------------------
    def pixels(self) -> int:
        return self.config["batch"] * self.height * self.width

    def _call(self, i: int, keep: bool):
        with torch.no_grad():
            out = self.program(*self.batches[i % len(self.batches)])
        host = {k: out[k].cpu().numpy() for k in READBACK}
        self.ran.add(i % len(self.batches))
        if keep:
            host.update({k: out[k].cpu().numpy() for k in ("pdf", "depth")})
            self.kept[i] = host
        return host

    def step(self, i: int) -> None:
        self._call(i, keep=i in self.check_at)

    def release(self) -> None:
        """Free the program's state; the inputs stay for the check."""
        self.program = self.update = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------
    def reference(self, i: int, precision: str) -> dict:
        out = sweep_update(self.batches[i % len(self.batches)], self.height,
                           self.width,
                           {"num_depths": self.config["num_depths"]},
                           precision)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def readings(self, prog: dict, ref: dict) -> dict:
        return compare.flow_readings(prog, ref, self.radius)

    # -- the yardstick's work --------------------------------------------
    def _shares(self, j: int):
        """What batch ``j`` needs of the sweep, counted over its real
        cameras (its mains and valid sides; a padded side slot needs no
        work): (sides, covered, planes, centers). ``sides`` is the number
        of valid sides; ``covered`` the share of the real cameras' render
        pixels the mesh covers; ``planes`` per depth plane a list over the
        mains of (valid sides, the share of their pixels inside their
        frames: K3c's valid mask); ``centers`` the valid centers."""
        cfg = self.config
        (soup, soup_valid, cam_mains, _, side_cams, _, side_valid, _,
         centers_valid) = self.batches[j][:9]
        b = cam_mains.shape[0]
        h, w = self.height, self.width
        arith = Arith()
        side_valid = side_valid.to(torch.bool)
        with torch.no_grad():
            cams = torch.cat([cam_mains, side_cams[side_valid]])
            depths = render_depth(cams, soup, soup_valid, h, w)
            covered = float((depths < BACKGROUND_DEPTH).to(
                torch.float32).mean())
            z_min, z_max, _ = z_ranges(depths[:b])
            ts = torch.from_numpy(np.linspace(
                0.0, 1.0, cfg["num_depths"]).astype(np.float32)).to(
                    z_min.device)
            zs = z_min[None, :] + ts[:, None] * (z_max - z_min)[None, :]
            planes = [[(int(side_valid[m].sum()), float(sample_fields(
                arith, cam_mains[m], side_cams[m][side_valid[m]], z[m], h,
                w)[2].to(torch.float32).mean()))
                for m in range(b) if bool(side_valid[m].any())]
                for z in zs]
        return (int(side_valid.sum()), covered, planes,
                int(centers_valid.sum()))

    def work(self, trace) -> dict:
        """The least time of an update, averaged over the batches the
        window ran (read only in a traced run: the shares take a render of
        every camera and a pass over every plane). Only the real cameras
        count: the program's renders, K3c and cost ops on padded side
        slots are work the update does not need."""
        if trace is None:
            return {"counters": {}}
        b = self.config["batch"]
        h, w = self.height, self.width
        px = h * w
        plane, mat = px * 4, 64
        update_s = k3c_s = 0.0
        ran = sorted(self.ran)
        for j in ran:
            n, covered, planes, n_centers = self._shares(j)
            ncam = b + n
            # renders (SETUP, BIN, K1): the cameras and the soup read, a
            # depth plane a camera written
            update_s += work.least_s(
                ncam * mat + self.n_tri * 36 + self.n_tri + ncam * plane,
                work.raster_ops(ncam, self.n_tri_valid, covered, h, w))
            # the vote weights (K2): the cameras, the mains' and the sides'
            # depths read, a mask byte a side pixel written; the z range
            # reads the mains' depths
            update_s += work.least_s(
                ncam * mat + (b + n) * plane + n * px + b * plane,
                work.K2_OPS * n * px)
            # the sweep: each plane's K3c (one launch) and cost over each
            # main's valid sides
            for mains in planes:
                k3c = [work.k3c_work(k * px, share) for k, share in mains]
                cost = [work.sweep_plane_work(k, h, w, share)
                        for k, share in mains]
                k3c_s += work.least_s(sum(x for x, _ in k3c),
                                      sum(y for _, y in k3c))
                update_s += work.least_s(sum(x for x, _ in cost),
                                         sum(y for _, y in cost))
            # back-projection, pdf and normals: the sweep's depth, cost
            # and valid and the centers read; point4, pdf, normals and
            # valid written
            update_s += work.least_s(
                10 * b * plane + 2 * b * px + n_centers * 13 + b * 4, 0)
        m = max(len(ran), 1)
        return {
            "update_least_s": update_s / m,
            "kernels": {"k3c": (k3c_s / m,
                                ("sample_bilinear_masked_kernel",))},
            "counters": {},
        }
