"""Measurement tools of the port, each run as ``python -m
meshrecon_torch.tools.<name>``."""


def start(device_name):
    """The micro-benchmark tools' common start: the device (a missing CUDA
    device raises), its line printed first, and on the card the kernels
    built before any row is timed."""
    from meshrecon_torch.pipeline.config import resolve_device
    from meshrecon_torch.utils.profiling import device_line

    device = resolve_device(device_name)
    print(f"# {device_line(device)}", flush=True)
    if device.type == "cuda":
        from meshrecon_torch.kernels import library

        library()
    return device


# the rows that select the TPU package's second engine (``engine="xla"``)
ENGINE_NA = "the TPU package's second engine: the port has one per device"


def size_args(prog: str, reps: int, argv):
    """The micro tools' arguments: the sizes (the JAX tools' fixed
    480x640, K=3 as defaults), the calls a pass and ``--device``."""
    import argparse

    ap = argparse.ArgumentParser(
        prog=f"python -m meshrecon_torch.tools.{prog}")
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--reps", type=int, default=reps)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def fused_frames(h: int, w: int, k: int, device):
    """The main frame (H, W) and side frames (K, H, W) of
    ``problems.fused_problem(b=1, k=K, h=H, w=W, seed=0)`` as tensors."""
    import torch

    from meshrecon_torch import problems

    _, _, _, fm, _, fs, *_ = problems.fused_problem(b=1, k=k, h=h, w=w,
                                                    seed=0)
    return (torch.from_numpy(fm[0]).to(device),
            torch.from_numpy(fs[0]).to(device))
