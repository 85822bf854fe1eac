"""One run of one cell of the benchmark of gpr_calculator_tpu_torch.

    python3 bench_port/run.py --workload auAl13.serve --seed 7 \
        --seconds 30 --trace 0

Run from the root of a checkout on a machine with a CUDA card.  The last
line of standard output is the result (one JSON object); the numbers
compared with the reference, each beside its limit, are the last lines
of standard error.  With ``--trace 1`` the metrics are the cell's
per-layer ones.  Exits non-zero, printing no result, without a card, with
fewer cards than the cell asks for, or if JAX or the JAX package was
loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# one process, one host thread for the libraries' own pools: the served
# path is bound by one Python thread launching kernels, and idle pools
# that spin beside it only add noise
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "OPENBLAS_NUM_THREADS": "1"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, value in THREADS.items():
        os.environ[key] = value
    sys.path.insert(0, str(ROOT))
    import torch
    torch.set_num_threads(1)
    from bench_port import harness
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 2
    bench = harness.benchmark(ROOT)
    cell = {c["name"]: c for c in bench["workloads"]}.get(args.workload)
    if cell is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T_START)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
