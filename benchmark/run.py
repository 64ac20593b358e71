"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout of the repository: the cell's
configuration, traffic mix, limits and metrics are found under
``benchmark/`` by the names ``BENCHMARK.json`` gives them, and the program
(``meshrecon_torch``) is imported from the checkout. The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared with its limit); the last lines of
standard error repeat the checks. Without a CUDA device the run exits with
code 2 and prints no result; it never falls back to the CPU.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "benchmark"


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    import torch

    from benchmark import core

    cell = core.find_cell(core.load_benchmark(ROOT), args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA "
              f"device(s), found {have}; no result", file=sys.stderr)
        return 2
    seed = args.seed & (2**63 - 1)
    result, lines = core.run(args.workload, seed, args.seconds,
                             bool(args.trace), t_start=T_START)
    found = core.forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {found}; no result",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    # the checkout's root, not this directory, heads the path: the
    # harness's modules import as ``benchmark.*`` and shadow nothing of
    # the library (``benchmark/trace.py`` against the standard ``trace``)
    sys.path[0] = str(ROOT)
    sys.exit(main())
