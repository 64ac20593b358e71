"""Command line entry point of the port, compatible with the reference's
``recon`` (configuration.cpp:109-123; see pipeline/config.py for the flags).

    python -m meshrecon_torch.cli SCENE.yaml [SCENE2.yaml ...] -o out.obj \\
        [--device cuda|cpu] [-e] [--ensemble-seeds 3,13] [-V] [-s 8] [-n 2]
    python -m meshrecon_torch.cli tracks/koule-tr.yaml --synthetic sphere

Each YAML's clip is decoded (``--synthetic`` renders fixture frames
instead); several YAMLs reconstruct one after another.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time


@contextlib.contextmanager
def profile_trace(log_dir: str, device: str):
    """torch.profiler trace of the run, written as a Chrome trace to
    ``log_dir/trace.json`` (CPU activity, plus CUDA on a CUDA device), and
    the device's busy share of the profiled wall time (kernels, copies and
    memsets, overlaps merged) to ``log_dir/device_busy.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from meshrecon_torch.utils.profiling import device_busy

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        busy, events = device_busy(json.load(f))
    summary = {"wall_s": wall, "device_busy_s": busy,
               "busy_share": busy / wall, "device_events": events}
    with open(os.path.join(log_dir, "device_busy.json"), "w") as f:
        json.dump(summary, f)
    print(f"profile: device busy {busy:.6f} s of {wall:.6f} s profiled wall "
          f"(share {busy / wall:.6f}; {events} kernels, copies and memsets)")


def main(argv=None, timer=None) -> int:
    """Run the reconstruction of every input YAML; ``timer`` (a StageTimer)
    collects the stage times when given."""
    from meshrecon_torch.pipeline.config import configs_from_args
    from meshrecon_torch.pipeline.reconstruct import (reconstruct,
                                                      reconstruct_scenes)

    configs = configs_from_args(argv)
    first = configs[0]
    first.log(2, " Loaded configuration and video clip")

    def run():
        if len(configs) == 1:
            reconstruct(first, timer=timer)
        else:
            reconstruct_scenes(configs, timer=timer)

    if first.profile_dir:
        with profile_trace(first.profile_dir, first.device):
            run()
    else:
        run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
