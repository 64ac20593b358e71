"""Standalone flow driver, the TEST_BUILD main of flow.cpp (flow.cpp:77-135);
port of meshrecon/flow/driver.py.

    python -m meshrecon_torch.flow.driver [IMAGE1 IMAGE2] [KNOB]...
        [--device cuda|cpu]

Knobs, as the reference's test CLI (flow.cpp:88-109): ``l<levels>``,
``i<iters>``, ``w<winsize>``, ``s<sigma>``, ``n<poly_n>``, ``f`` (Farneback)
and ``h`` (variational). With no knob the pipeline's ``calculate_flow``
runs; with one, the library flow with those settings. Writes flow.png,
remap.png and diff.png to the working directory and prints the L1 remap
error ``Diff sum`` (flow.cpp:133). Without images it writes a fixture pair
(a band-limited texture and its copy shifted by (3, -2) px) to test/.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from meshrecon_torch.io.images import read_image, save_image
from meshrecon_torch.pipeline.config import resolve_device


def smooth_image(h: int, w: int, seed: int = 0, octaves: int = 4):
    """Band-limited random texture on a 0..255 scale (float32)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w))
    for o in range(octaves):
        s = 2 ** o
        small = rng.normal(size=(max(2, h // (8 * s)) + 2,
                                 max(2, w // (8 * s)) + 2))
        yy = np.linspace(0, small.shape[0] - 1.001, h)
        xx = np.linspace(0, small.shape[1] - 1.001, w)
        yi, xi = np.floor(yy).astype(int), np.floor(xx).astype(int)
        fy, fx = (yy - yi)[:, None], (xx - xi)[None, :]
        v = (small[yi][:, xi] * (1 - fy) * (1 - fx)
             + small[yi][:, xi + 1] * (1 - fy) * fx
             + small[yi + 1][:, xi] * fy * (1 - fx)
             + small[yi + 1][:, xi + 1] * fy * fx)
        img += v / (o + 1)
    img -= img.min()
    img *= 255.0 / max(img.max(), 1e-6)
    return img.astype(np.float32)


def shift_image(img, dx: int, dy: int):
    """out(r, c) = img(r - dy, c - dx), wrapping around."""
    return np.roll(np.roll(img, dy, axis=0), dx, axis=1)


def make_fixture_pair():
    """test/flow1.png and test/flow2.png: a 240x320 texture and its copy
    shifted by (3, -2) px."""
    os.makedirs("test", exist_ok=True)
    img = smooth_image(240, 320, seed=11)
    save_image(img, "test/flow1.png")
    save_image(shift_image(img, 3, -2), "test/flow2.png")
    return "test/flow1.png", "test/flow2.png"


def _split_device(argv):
    """(argv without ``--device X``, the device name; default cuda)."""
    rest, device = [], "cuda"
    it = iter(argv)
    for a in it:
        if a == "--device":
            device = next(it)
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return rest, device


def main(argv=None):
    from meshrecon_torch.flow.api import calculate_flow
    from meshrecon_torch.flow.pyramid import compare
    from meshrecon_torch.flow.shiftwarp import shift_warp_bicubic
    from meshrecon_torch.flow.tile_warp import tile_warp_flow_batched

    argv, device = _split_device(list(
        argv if argv is not None else sys.argv[1:]))
    dev = resolve_device(device)

    def to_gray(img):
        img = np.asarray(img, np.float32)
        gray = img if img.ndim == 2 else img[..., :3].mean(axis=2)
        return torch.from_numpy(np.ascontiguousarray(gray)).to(dev)

    if len(argv) < 2:
        print("No images given; generating synthetic fixtures in test/")
        argv = list(make_fixture_pair()) + argv
    prev = to_gray(read_image(argv[0]))
    next_ = to_gray(read_image(argv[1]))

    knobs = {"l": None, "i": None, "w": None, "s": None, "n": None}
    use_farneback = False
    for opt in argv[2:]:
        if opt == "f":
            use_farneback = True
        elif opt == "h":
            use_farneback = False
        elif opt and opt[0] in knobs:
            knobs[opt[0]] = float(opt[1:])

    if use_farneback or any(v for v in knobs.values()):
        if use_farneback:
            from meshrecon_torch.flow.farneback import farneback_flow

            kw = {}
            if knobs["l"]:
                kw["levels"] = int(knobs["l"])
            if knobs["i"]:
                kw["iters"] = int(knobs["i"])
            if knobs["w"]:
                # OpenCV's winsize, as the reference CLI's w knob
                kw["winsize"] = int(knobs["w"])
            if knobs["s"]:
                kw["poly_sigma"] = knobs["s"]
            if knobs["n"]:
                kw["poly_n"] = int(knobs["n"])
            f2 = farneback_flow(prev, next_, **kw)
        else:
            from meshrecon_torch.flow.variational import variational_flow

            kw = {"levels": 6}  # arbitrary frame pairs: large displacements
            if knobs["l"]:
                kw["levels"] = int(knobs["l"])
            if knobs["i"]:
                kw["iters"] = int(knobs["i"])
            if knobs["s"]:
                kw["alpha"] = knobs["s"]
            f2 = variational_flow(prev, next_, **kw)
        warped = shift_warp_bicubic(next_, f2[..., 0], f2[..., 1], radius=8)
        var = compare(prev, warped)
        flow = torch.cat([f2, var[..., None],
                          torch.zeros_like(var)[..., None]], dim=-1)
    else:
        flow = calculate_flow(prev, next_, use_farneback)

    save_image(flow[..., :3] * 10 + 127, "flow.png")
    remapped = tile_warp_flow_batched(
        next_[None], flow[None, ..., 0].contiguous(),
        flow[None, ..., 1].contiguous(), taps=4)[0]
    save_image(remapped, "remap.png")
    diff = (prev - remapped).abs()
    save_image(diff * 10, "diff.png")
    print(f"Diff sum: {float(diff.sum(dtype=torch.float64)):g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
