"""The readings that a cell's limits are set from: the program against the
reference on many seeds, and the control (the reference in TF32, in the
program's place) on some, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,...
        [--control-seeds 1,2,3] [--out FILE]

For each seed it makes the cell's inputs and program as a run does, runs
the updates up to the last one the check draws (the cell's own load), and
compares the drawn updates: the program's outputs against the reference's
(``program``), and the TF32 reference's against the reference's
(``control``). Each reading is a JSON line on standard output (and in
``FILE``); the last line gives, per number, the largest program reading
and the smallest control reading. Without a CUDA device it exits with
code 2.
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(workload: str, seed: int, control: bool, device="cuda",
             overrides=None) -> dict:
    """{"program": numbers, "control": numbers or None} of one seed."""
    import torch

    from benchmark import compare, core

    bench = core.load_benchmark(ROOT)
    cell = core.find_cell(bench, workload)
    config, traffic, _ = core.cell_files(cell, overrides)
    mod = importlib.import_module(
        f"benchmark.entries.{core.module_name(traffic['entry'])}")
    entry = mod.Entry(config, traffic, seed, device, core.HERE)
    entry.setup()
    for i in range(max(entry.check_at) + 1):
        entry.step(i)
    entry.release()
    picks = sorted(entry.kept)
    prog, ctrl = [], []
    for i in picks:
        ref = entry.reference(i, "float32")
        prog.append(entry.readings(entry.kept[i], ref))
        if control:
            ctrl.append(entry.readings(entry.reference(i, "tf32"), ref))
    del entry
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"program": compare.worst(prog),
            "control": compare.worst(ctrl) if control else None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 benchmark/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    high, low = {}, {}
    for seed in sorted(set(seeds) | controls):
        t0 = time.perf_counter()
        r = readings(args.workload, seed & (2**63 - 1), seed in controls)
        line = {"workload": args.workload, "seed": seed,
                "seconds": time.perf_counter() - t0, **r}
        if seed in seeds:
            for k, v in r["program"].items():
                high[k] = max(high.get(k, v), v)
        if r["control"]:
            for k, v in r["control"].items():
                low[k] = min(low.get(k, v), v)
        for f in filter(None, (sys.stdout, out)):
            print(json.dumps(line), file=f, flush=True)
    summary = {"workload": args.workload,
               "device": torch.cuda.get_device_name(0),
               "program_max": high, "control_min": low}
    for f in filter(None, (sys.stdout, out)):
        print(json.dumps(summary), file=f, flush=True)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # import the harness as ``benchmark.*``
    sys.exit(main())
