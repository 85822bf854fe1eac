"""Readings for a cell's limits, on the card, in one process: the numbers
the checks compare for the program on each of ``--seeds`` and for the
control (the reference in TF32 in the program's place) on each of
``--control-seeds``, with short windows at the cell's own sizes.  One JSON
line a run on standard output (and appended to ``--out``); the lower
reading of a number is the largest over the program's seeds, the upper
the smallest over the control's.

    python3 bench_port/calibrate.py --workload auAl13.serve \
        --seeds 11 12 13 --control-seeds 21 22 23 --seconds 3
"""
import argparse
import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from bench_port import harness
    from bench_port.backends import Reference
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = harness.benchmark(ROOT)
    runs = [(s, None) for s in args.seeds] + [
        (s, functools.partial(Reference, prec="tf32"))
        for s in args.control_seeds]
    for seed, backend in runs:
        t0 = time.perf_counter()
        counters = {}
        r = harness.run_cell(bench, args.workload, seed, args.seconds,
                             False, "cuda:0", t0, backend=backend,
                             counters=counters)
        line = {"workload": args.workload, "seed": seed,
                "side": "program" if backend is None else "control",
                "values": counters.pop("check_values"),
                "metrics": {k: m["value"] for k, m in r["metrics"].items()},
                "attempted": r["attempted"], "correct": r["correct"],
                "counters": {k: v for k, v in counters.items()
                             if k != "untraced_latencies_s"},
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
