"""The sliding-window plane sweep's cells: the program's
``plane_sweep_depth`` on a clip, one window after another.

Set-up makes the clip on the card and runs ``warm_updates`` solves. Solve
i of the window takes frame ``i mod slide`` as its main frame and the
next ``sides`` frames as its sides, sweeps ``depths`` planes over the
configuration's NDC range, and ends when its ``depth``, ``cost`` and
``valid`` are on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare, work
from benchmark.inputs import window
from benchmark.reference.plane_sweep import plane_sweep, sample_fields

READBACK = ("depth", "cost", "valid")


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 root):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)
        self.height, self.width = config["height"], config["width"]
        self.k = config["sides"]
        self.kept = {}
        self.mains = set()

    def setup(self) -> None:
        from meshrecon_torch.depth.plane_sweep import plane_sweep_depth

        cfg, tr = self.config, self.traffic
        n_frames = cfg["slide"] + self.k
        self.frames, self.cams = window.clip(self.height, self.width,
                                             n_frames, self.seed,
                                             self.device)
        self.side_valid = torch.ones(self.k, dtype=torch.bool,
                                     device=self.device)
        self.program = plane_sweep_depth
        picks = self.rng.choice(min(tr["check_range"], cfg["slide"]),
                                size=tr["check_updates"], replace=False)
        self.check_at = {int(i) for i in picks}
        t0 = time.perf_counter()
        for i in range(tr["warm_updates"]):
            self._call(i, keep=False)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.warm_s = time.perf_counter() - t0
        self.mains.clear()

    def pixels(self) -> int:
        return self.height * self.width

    def _window(self, i: int):
        m = i % self.config["slide"]
        return (self.frames[m], self.frames[m + 1:m + 1 + self.k],
                self.cams[m], self.cams[m + 1:m + 1 + self.k],
                self.side_valid)

    def _call(self, i: int, keep: bool):
        cfg = self.config
        with torch.no_grad():
            out = self.program(*self._window(i), cfg["z_min"], cfg["z_max"],
                               num_depths=cfg["depths"])
        host = {k: out[k].cpu().numpy() for k in READBACK}
        self.mains.add(i % cfg["slide"])
        if keep:
            self.kept[i] = host
        return host

    def step(self, i: int) -> None:
        self._call(i, keep=i in self.check_at)

    def release(self) -> None:
        self.program = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, i: int, precision: str) -> dict:
        cfg = self.config
        out = plane_sweep(*self._window(i), cfg["z_min"], cfg["z_max"],
                          cfg["depths"], precision)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def readings(self, prog: dict, ref: dict) -> dict:
        return compare.sweep_readings(prog, ref)

    def _valid_shares(self, m: int):
        """Per plane, the share of the sides' pixels inside their frames
        (K3c's valid mask) of the window whose main frame is ``m``."""
        from benchmark.reference.precision import Arith

        cfg = self.config
        zs = np.linspace(0.0, 1.0, cfg["depths"]).astype(np.float32)
        zs = cfg["z_min"] + zs * np.float32(cfg["z_max"] - cfg["z_min"])
        _, _, cam, cams, _ = self._window(m)
        out = []
        with torch.no_grad():
            for z in zs:
                ok = sample_fields(Arith(), cam, cams, torch.tensor(
                    float(z), device=self.device), self.height,
                                   self.width)[2]
                out.append(float(ok.to(torch.float32).mean()))
        return out

    def work(self, trace) -> dict:
        """The least time of a solve, averaged over the main frames the
        window solved (read only in a traced run: the valid shares take a
        pass over every plane)."""
        if trace is None:
            return {"counters": {}}
        k3c_s = solve_s = 0.0
        mains = sorted(self.mains)
        for m in mains:
            for share in self._valid_shares(m):
                px = self.k * self.height * self.width
                k3c_s += work.least_s(*work.k3c_work(px, share))
                solve_s += work.least_s(*work.sweep_plane_work(
                    self.k, self.height, self.width, share))
        n = max(len(mains), 1)
        return {
            "update_least_s": solve_s / n,
            "kernels": {"k3c": (k3c_s / n,
                                ("sample_bilinear_masked_kernel",))},
            "counters": {},
        }
