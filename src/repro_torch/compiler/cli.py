"""Command-line entry point for tuning sessions on the PyTorch port.

    # two ResNet-18 conv tasks, shared GBT, 2-measurement smoke budget, on
    # the CPU (the default device is cuda)
    PYTHONPATH=src python -m repro_torch.compiler.cli tune \\
        --model resnet-18 --max-tasks 2 --budget 2 --device cpu

    # one GEMM with persisted, resumable records (interchangeable with the
    # reference package's record files)
    PYTHONPATH=src python -m repro_torch.compiler.cli tune \\
        --matmul 512x512x512 --budget 64 --records artifacts/gemm.jsonl

A bare flag list still means ``tune``.  The reference's ``--network``,
``netopt`` and baseline ``--algo`` choices come with later slices.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List

from repro_torch.compiler.session import Session
from repro_torch.compiler.task import TuningTask
from repro_torch.core.tuner import TunerConfig


def _tasks_from_args(args) -> List[TuningTask]:
    if bool(args.model) == bool(args.matmul):
        raise SystemExit("pick exactly one of --model / --matmul")
    if args.model:
        tasks = TuningTask.conv_tasks(args.model)
        return tasks[:args.max_tasks] if args.max_tasks else tasks
    tasks = []
    for spec in args.matmul:
        m, n, k = (int(x) for x in spec.lower().split("x"))
        tasks.append(TuningTask.matmul(m, n, k))
    return tasks


def _emit(summary, args) -> None:
    """Full document to --out, compact to stdout."""
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1, default=str)
    for rep in summary.get("reports", {}).values():  # keep stdout compact
        rep.pop("measurements", None)
        rep["history"] = rep["history"][-3:]
    print(json.dumps(summary, indent=1, default=str))


def _run_tune(args) -> int:
    session = Session(_tasks_from_args(args), tuner=TunerConfig.fast(),
                      budget=args.budget, records=args.records,
                      seed=args.seed, device=args.device)
    _emit(session.run().to_dict(), args)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0].startswith("-") and argv[0] not in ("-h", "--help"):
        argv = ["tune"] + argv  # flag-only invocation
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.compiler.cli",
        description="ARCO tuning sessions over conv/GEMM analytical tasks.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    tune = sub.add_parser("tune", help="tuning session over conv/GEMM "
                                       "analytical tasks")
    tune.add_argument("--model", help="CNN model: tune its conv tasks "
                                      "(e.g. resnet-18)")
    tune.add_argument("--max-tasks", type=int, default=0,
                      help="cap the number of network tasks (0 = all)")
    tune.add_argument("--matmul", action="append", default=[],
                      metavar="MxNxK", help="GEMM task (repeatable)")
    tune.add_argument("--budget", type=int, default=None,
                      help="measurements per task")
    tune.add_argument("--seed", type=int, default=0)
    tune.add_argument("--records", default=None,
                      help="JSONL measurement records (persist + warm resume)")
    tune.add_argument("--out", default=None, help="write session JSON here")
    tune.add_argument("--device", default="cuda",
                      help="torch device for the MAPPO nets, rollouts and "
                           "measurements (default cuda; cpu on request)")
    tune.set_defaults(run=_run_tune)
    args = ap.parse_args(argv)
    return args.run(args)


if __name__ == "__main__":
    sys.exit(main())
