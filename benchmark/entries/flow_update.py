"""The flow update's cells: the program's fused flow update
(``FusedMainUpdate.forward``) on batches of a track's bundles.

Set-up makes the configuration's inputs on the card (the track's frames,
the noisy UV-sphere soup, ``batches`` batches of ``batch`` bundles padded
to the side bucket), builds the update with the configuration's options,
and runs ``warm_updates`` updates. An update of the window is batch
``i mod batches``; it ends when its ``point4``, ``normals`` and ``valid``
are on the host, as the program's reconstruction copies them. The updates
drawn for the check keep ``pdf``, ``depth`` and the sweep count as well.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare, work
from benchmark.inputs import scene
from benchmark.reference.update import flow_update

OPTION_KEYS = ("levels", "warps", "fine_warps", "iters", "alpha", "rho",
               "sampling")
READBACK = ("point4", "normals", "valid")


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 root):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.root = root
        self.rng = np.random.default_rng(seed)
        self.height, self.width = config["height"], config["width"]
        self.kb = config["side_bucket"]
        self.options = {k: config[k] for k in OPTION_KEYS}
        self.kept = {}
        self.gn_sweeps = []

    # -- set-up ----------------------------------------------------------
    def setup(self) -> None:
        from meshrecon_torch.pipeline.fused import FusedMainUpdate

        cfg, tr, dev = self.config, self.traffic, self.device
        cameras, bundle_pts = scene.load_track(str(self.root / cfg["track"]))
        center, radius = scene.fit_sphere(bundle_pts)
        self.radius = radius
        tex_seed = int(self.rng.integers(0, 1000))
        cams_t = torch.from_numpy(cameras).to(dev)
        frames, shares = scene.sphere_frames(cams_t, center, radius,
                                             self.height, self.width,
                                             tex_seed)
        self.covered = float(shares.mean())
        soup, soup_valid = scene.noisy_uv_sphere(
            center, radius, cfg["rings"], cfg["segments"],
            cfg["radial_noise"], self.rng, dev)
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
        self.n_centers = int(self.batches[0][7].shape[0]
                             * self.batches[0][7].shape[1])
        self.update = FusedMainUpdate(
            self.height, self.width, levels=cfg["levels"],
            warps=cfg["warps"], iters=cfg["iters"], alpha=cfg["alpha"],
            rho=cfg["rho"], sampling=cfg["sampling"],
            flow_solver=cfg["flow_solver"], fine_warps=cfg["fine_warps"],
            variance=cfg["variance"], variance_taps=cfg["variance_taps"],
            shadow_sample=cfg["shadow_sample"])
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
        self.gn_sweeps.clear()

    # -- the window ------------------------------------------------------
    def pixels(self) -> int:
        return self.config["batch"] * self.height * self.width

    def _call(self, i: int, keep: bool):
        with torch.no_grad():
            out = self.program(*self.batches[i % len(self.batches)])
        host = {k: out[k].cpu().numpy() for k in READBACK}
        self.gn_sweeps.append(int(self.update.last_gn_sweeps))
        if keep:
            host.update({k: out[k].cpu().numpy() for k in ("pdf", "depth")})
            host["gn_sweeps"] = self.gn_sweeps[-1]
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
        out = flow_update(self.batches[i % len(self.batches)], self.height,
                          self.width, self.options, precision)
        return {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                for k, v in out.items()}

    def readings(self, prog: dict, ref: dict) -> dict:
        return compare.flow_readings(prog, ref, self.radius)

    # -- the yardstick's work --------------------------------------------
    def work(self, trace) -> dict:
        cfg = self.config
        b, k = cfg["batch"], self.kb
        stages = work.flow_update_stages(
            b, k, self.height, self.width, self.n_tri, self.n_tri_valid,
            self.n_centers, self.covered, cfg["levels"], cfg["iters"])
        update_s = sum(work.least_s(*w) for w in stages.values())
        k4 = work.k4_work(b * k, self.height, self.width, cfg["levels"],
                          cfg["iters"])
        depth0 = stages["depth0"]
        return {
            "update_least_s": update_s,
            "kernels": {
                "k4": (work.least_s(*k4), ("hs_block_kernel",)),
                "raster": (work.least_s(*depth0),
                           ("raster_setup_kernel", "raster_bin_kernel",
                            "raster_tiles_kernel")),
            },
            "counters": {"gn_sweeps": list(self.gn_sweeps)},
        }
