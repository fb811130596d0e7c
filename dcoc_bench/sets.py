"""Runs of one cell in sets, and the spread of each metric, as its bounds
are set.

    python3 dcoc_bench/sets.py --workload <cell> --seeds 11,12,13,14,15,16 \
        --sets 2 [--seconds 30] [--trace 0] [--out runs.jsonl]

runs ``dcoc_bench/run.py`` once a seed, one process after another (one
process on the card at a time), the same seeds in every set, and prints
each run's result line and then, per metric and set, the median and the
spread: the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) over the median.  ``--seconds``
defaults to ``run_seconds`` of ``BENCHMARK.json``.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    sets = []
    out = open(args.out, "a") if args.out else None
    for k in range(args.sets):
        runs = []
        for seed in seeds:
            cmd = [sys.executable, os.path.join(ROOT, "dcoc_bench", "run.py"),
                   "--workload", args.workload, "--seed", str(seed),
                   "--seconds", str(seconds), "--trace", str(args.trace)]
            t0 = time.perf_counter()
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            lines = p.stdout.strip().splitlines()
            res = json.loads(lines[-1]) if p.returncode == 0 and lines \
                else None
            row = {"set": k, "seed": seed, "rc": p.returncode,
                   "wall_s": wall, "result": res,
                   "stderr_tail": p.stderr[-1500:] if res is None
                   else p.stderr[-400:]}
            print(json.dumps(row), flush=True)
            if out:
                out.write(json.dumps(row) + "\n")
                out.flush()
            runs.append(res)
        sets.append(runs)
    for k, runs in enumerate(sets):
        names = sorted({m for r in runs if r for m in r["metrics"]})
        for m in names:
            vals = [r["metrics"][m]["value"] for r in runs
                    if r and m in r["metrics"]]
            if len(vals) >= 2:
                print(json.dumps({"set": k, "metric": m, "n": len(vals),
                                  "median": statistics.median(vals),
                                  "spread": spread(vals), "values": vals}))
        print(json.dumps({"set": k, "correct": [bool(r and r["correct"])
                                                for r in runs]}))
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
