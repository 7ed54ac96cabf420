"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for: load, warm the cell's own shapes, measure for ``--seconds``,
check the output against the plain reference, and print one JSON line as
the last line of standard output (the checks' numbers and limits also as
the last lines of standard error).  With no card, or too few, it exits 2
and prints no result; it never falls back to the CPU.
"""

import time

T0 = time.perf_counter()          # process start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from . import bench

    cell = bench.load_cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s), this machine "
              f"has {have}; no result", file=sys.stderr)
        return 2
    bench.cache_dirs()
    run = bench.Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace))
    entry = bench.load_module("entries", cell.workload["entry"])
    entry.run(run, T0)
    line = bench.result_line(run)
    print("set-up phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in run.setup_phases.items()),
          file=sys.stderr)
    bench.print_checks(run)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
