"""Run one cell of BENCHMARK.json once, on the card, and print its result.

    python3 dcoc_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (JSON); the last lines of standard error are each compared number
beside its limit.  Exits 3 without the card or cards the cell needs, 1 on
any other failure, printing no result either way.
"""
import time

T0 = time.perf_counter()   # set-up counts from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from dcoc_bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(1)   # one process, few threads: steadier runs
    try:
        res = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), t0=T0)
    except harness.NoChip as e:
        print(f"dcoc_bench: {e}", file=sys.stderr)
        return 3
    harness.emit(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
