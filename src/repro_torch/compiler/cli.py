"""Command-line entry point for tuning sessions on the PyTorch port.

Two subcommands (a bare flag list still means ``tune``):

    # two ResNet-18 conv tasks, shared GBT, 2-measurement smoke budget, on
    # the CPU (the default device is cuda)
    PYTHONPATH=src python -m repro_torch.compiler.cli tune \\
        --model resnet-18 --max-tasks 2 --budget 2 --device cpu

    # one GEMM, AutoTVM baseline, persisted + resumable records
    # (interchangeable with the reference package's record files)
    PYTHONPATH=src python -m repro_torch.compiler.cli tune \\
        --matmul 512x512x512 --algo autotvm --budget 64 \\
        --records artifacts/gemm.jsonl

    # pod-level compile oracle (the cell's dry-run estimate + roofline at
    # 256 placeholder devices, REPRO_DRYRUN_DEVICES to change), fanned
    # across 4 crash-isolated measurement workers with a 300 s timeout
    PYTHONPATH=src python -m repro_torch.compiler.cli tune \
        --arch qwen2-1.5b --shape train_4k --oracle compile --budget 8 \
        --workers 4 --timeout-s 300

    # live /metrics + /status on an ephemeral port, and a span trace of
    # the run (Chrome-trace JSON); --workers/--remote fan executor-backed
    # measurements out (analytical tasks are batched in-process)
    PYTHONPATH=src python -m repro_torch.compiler.cli tune \
        --model resnet-18 --monitor 0 --trace artifacts/run.json

    # network-scope co-optimization: ONE shared accelerator config for the
    # whole network (or K=2..3 in a pipeline), per-layer software mappings
    # under it; --baseline runs the comparison points at equal budget
    PYTHONPATH=src python -m repro_torch.compiler.cli netopt \\
        --model resnet-18 --layer-budget 16 --records artifacts/r18.jsonl
    PYTHONPATH=src python -m repro_torch.compiler.cli netopt \\
        --model resnet-18 --baseline hw-frozen

    # cross-network surrogate transfer over the workload zoo: tune one
    # network saving its GBT training rows, then warm-start another
    PYTHONPATH=src python -m repro_torch.compiler.cli netopt \\
        --network vgg-11 --save-surrogates artifacts/surr.jsonl
    PYTHONPATH=src python -m repro_torch.compiler.cli netopt \\
        --network resnet-18 --warm-from artifacts/surr.jsonl
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List

from repro_torch import resolve_device
from repro_torch.compiler.executor import (add_worker_args,
                                           validate_worker_args)
from repro_torch.compiler.session import ALGOS, Session
from repro_torch.compiler.surrogate_store import (add_surrogate_args,
                                                  store_from_args)
from repro_torch.compiler.task import TuningTask
from repro_torch.compiler.zoo import get_network, network_names
from repro_torch.core.tuner import TunerConfig


def _network_label(args) -> str:
    """The ONE network label for this invocation's task set, shared by
    tune and netopt: surrogate-store rows are keyed (and own-network
    excluded) by it, as in the reference's CLI."""
    return args.network or args.model or ",".join(args.matmul)


def _network_tasks(args) -> List[TuningTask]:
    """Tasks from the network-defining flags shared by both subcommands."""
    if sum(bool(x) for x in (args.model, args.matmul, args.network)) != 1:
        raise SystemExit("pick exactly one of --model / --matmul / "
                         "--network")
    if args.network:
        tasks = list(get_network(args.network).tasks)
    elif args.model:
        tasks = TuningTask.conv_tasks(args.model)
    else:
        tasks = []
        for spec in args.matmul:
            m, n, k = (int(x) for x in spec.lower().split("x"))
            tasks.append(TuningTask.matmul(m, n, k))
        return tasks
    return tasks[:args.max_tasks] if args.max_tasks else tasks


def _tasks_from_args(args) -> List[TuningTask]:
    """tune's tasks: a network's conv/GEMM tasks (analytical oracle) or an
    LM arch's pod-level cells (compile oracle)."""
    picked = [bool(args.model), bool(args.matmul), bool(args.arch),
              bool(args.network)]
    if sum(picked) != 1:
        raise SystemExit("pick exactly one of --model / --matmul / "
                         "--network / --arch")
    if args.oracle == "compile" and not args.arch:
        raise SystemExit("--oracle compile requires --arch/--shape "
                         "(conv/GEMM tasks are measured analytically)")
    if not args.arch:
        return _network_tasks(args)
    if args.oracle != "compile":
        raise SystemExit("--arch/--shape needs --oracle compile")
    return [TuningTask.cell(args.arch, s) for s in args.shape]


def _add_task_args(ap) -> None:
    ap.add_argument("--model", help="CNN model: tune its conv tasks "
                                    "(e.g. resnet-18)")
    ap.add_argument("--network", choices=network_names(), default=None,
                    help="workload-zoo network (repro_torch.compiler.zoo)")
    ap.add_argument("--max-tasks", type=int, default=0,
                    help="cap the number of network tasks (0 = all)")
    ap.add_argument("--matmul", action="append", default=[],
                    metavar="MxNxK", help="GEMM task (repeatable)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device for the MAPPO nets, rollouts, "
                         "baseline searches and measurements (default "
                         "cuda; cpu on request)")


def _emit(summary, args) -> None:
    """Full document to --out, compact to stdout."""
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1, default=str)
    for rep in summary.get("reports", {}).values():  # keep stdout compact
        rep.pop("measurements", None)
        rep["history"] = rep["history"][-3:]
    print(json.dumps(summary, indent=1, default=str))


def _compact(store) -> None:
    stats = store.compact()
    print(f"compacted {store.path}: kept {stats['kept']}, dropped "
          f"{stats['dropped']}", file=sys.stderr)


def _run_tune(args) -> int:
    resolve_device(args.device)     # no CUDA and no --device cpu: raise
    if args.arch and not args.shape:
        args.shape = ["train_4k"]
    tasks = _tasks_from_args(args)
    if args.independent and (args.warm_from or args.save_surrogates):
        # reject before store_from_args touches the filesystem
        raise SystemExit("--warm-from/--save-surrogates need the shared "
                         "cost model (drop --independent)")
    store = store_from_args(args)
    session = Session(tasks, tuner=TunerConfig.fast(), algo=args.algo,
                      budget=args.budget, use_cs=not args.no_cs,
                      share_cost_model=not args.independent,
                      records=args.records, seed=args.seed,
                      workers=args.workers, timeout_s=args.timeout_s,
                      remote=args.remote, trace=args.trace,
                      trace_sample_rate=args.trace_sample_rate,
                      monitor=args.monitor,
                      surrogates=store, network=_network_label(args) or None,
                      device=args.device)
    summary = session.run().to_dict()
    if args.compact and store is not None:
        _compact(store)
    _emit(summary, args)
    return 0


def _run_netopt(args) -> int:
    from repro_torch.compiler.netopt import (NetOptConfig, NetworkCoOptimizer,
                                             network_genetic_hw_tune,
                                             network_hw_frozen_tune,
                                             network_random_hw_tune)
    tasks = _network_tasks(args)
    cfg = NetOptConfig(seed_candidates=args.seed_candidates,
                       hw_rounds=args.hw_rounds,
                       hw_per_round=args.hw_per_round,
                       layer_budget=args.layer_budget,
                       refine_budget=args.refine_budget,
                       tuner=TunerConfig.fast(), seed=args.seed,
                       k_chips=args.k_chips,
                       stop_on_stable_ranking=args.stop_on_stable_ranking)
    store = store_from_args(args)
    kw = dict(records=args.records, workers=args.workers,
              timeout_s=args.timeout_s, remote=args.remote,
              name=_network_label(args), surrogates=store, trace=args.trace,
              trace_sample_rate=args.trace_sample_rate,
              monitor=args.monitor, device=args.device)
    if args.baseline == "hw-frozen":
        rep = network_hw_frozen_tune(tasks, cfg, **kw)
    elif args.baseline == "random-hw":
        rep = network_random_hw_tune(tasks, cfg, **kw)
    elif args.baseline == "genetic":
        rep = network_genetic_hw_tune(tasks, cfg, **kw)
    else:
        rep = NetworkCoOptimizer(tasks, cfg, **kw).run()
    if args.compact and store is not None:
        _compact(store)
    print(rep.summary(), file=sys.stderr)
    _emit(rep.to_dict(), args)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0].startswith("-") and argv[0] not in ("-h", "--help"):
        argv = ["tune"] + argv  # flag-only invocation
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.compiler.cli",
        description="Tuning sessions (tune) and network-scope HW/SW "
                    "co-optimization (netopt).")
    sub = ap.add_subparsers(dest="cmd", required=True)

    tune = sub.add_parser(
        "tune", help="tuning session over conv/GEMM analytical tasks or "
                     "pod-level compile cells")
    _add_task_args(tune)
    tune.add_argument("--arch", help="LM arch for the compile oracle")
    tune.add_argument("--shape", action="append", default=[],
                      help="cell shape(s) for --arch (default train_4k)")
    tune.add_argument("--oracle", choices=("analytical", "compile"),
                      default="analytical")
    tune.add_argument("--algo", choices=ALGOS, default="arco")
    tune.add_argument("--budget", type=int, default=None,
                      help="measurements per task")
    tune.add_argument("--no-cs", action="store_true",
                      help="ablate Confidence Sampling")
    tune.add_argument("--independent", action="store_true",
                      help="per-task GBT instead of the shared cost model")
    tune.add_argument("--records", default=None,
                      help="JSONL measurement records (persist + warm resume)")
    add_surrogate_args(tune)
    add_worker_args(tune)
    tune.add_argument("--out", default=None, help="write session JSON here")
    tune.set_defaults(run=_run_tune)

    net = sub.add_parser(
        "netopt", help="network co-optimization: one shared accelerator "
                       "config (or K in a pipeline), per-layer software "
                       "mappings")
    _add_task_args(net)
    net.add_argument("--baseline",
                     choices=("hw-frozen", "random-hw", "genetic"),
                     default=None,
                     help="run a network-level baseline instead of the "
                          "co-optimizer (equal total budget; genetic = "
                          "DiGamma-style GA over the same partition space)")
    net.add_argument("--k-chips", type=int, default=1,
                     help="heterogeneous pipeline stages (1-3): partition "
                          "the network at contiguous cuts, one accelerator "
                          "config per stage (1 = the single shared chip)")
    net.add_argument("--stop-on-stable-ranking", type=int, default=0,
                     help="end the outer search once the hw surrogate's "
                          "top-k candidate ranking is unchanged for this "
                          "many consecutive refits (0 = off)")
    net.add_argument("--seed-candidates", type=int, default=3,
                     help="round-0 hw candidates (incl. the default chip)")
    net.add_argument("--hw-rounds", type=int, default=2,
                     help="CS-guided outer rounds after seeding")
    net.add_argument("--hw-per-round", type=int, default=2,
                     help="hw candidates measured per CS round")
    net.add_argument("--layer-budget", type=int, default=16,
                     help="software measurements per layer per candidate")
    net.add_argument("--refine-budget", type=int, default=32,
                     help="extra winner budget per layer (warm resume)")
    net.add_argument("--records", default=None,
                     help="JSONL records: per-(hw, layer) warm resume")
    add_surrogate_args(net)
    add_worker_args(net)
    net.add_argument("--out", default=None, help="write NetworkReport JSON")
    net.set_defaults(run=_run_netopt)

    args = ap.parse_args(argv)
    validate_worker_args(ap, args)
    return args.run(args)


if __name__ == "__main__":
    sys.exit(main())
