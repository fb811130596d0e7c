"""Paper end-to-end flow on ResNet-18, on the PyTorch port.

Default mode (Table 6 / Fig. 5 protocol at reduced budget): tune every
conv task, compare ARCO vs the software-only baselines.  One multi-task
tuning session per framework: ARCO interleaves all tasks over a *shared*
GBT cost model, the baselines run the same tasks at the same budget.

``--coopt`` runs the paper's actual headline claim instead — network-scope
co-optimization (``repro_torch.compiler.netopt``): ONE shared accelerator
configuration for the whole network with per-layer software mappings under
it, compared at equal measurement budget against

* the network-level hw-frozen baseline (default chip, all budget on
  software mapping), and
* the per-layer fantasy (classic per-task ARCO, where every conv layer
  gets its own fictional chip and the summed optima are unrealizable on
  any single accelerator).

Every session's agents and GBT run on ``--device`` (default cuda).

    PYTHONPATH=src python -m repro_torch.examples.tune_resnet18 [--budget 256]
    PYTHONPATH=src python -m repro_torch.examples.tune_resnet18 --coopt \\
        [--layer-budget 16]
"""
import argparse
import contextlib

from repro_torch import obs, resolve_device
from repro_torch.compiler import Session, TuningTask
from repro_torch.core import mappo
from repro_torch.core.tuner import TunerConfig


def software_only_comparison(args, cfg, tasks) -> dict:
    totals, walls = {}, {}
    for fw in ("arco", "autotvm", "chameleon"):
        records = args.records and f"{args.records}.{fw}.jsonl"
        sr = Session(tasks, tuner=cfg, algo=fw, budget=args.budget,
                     records=records, workers=args.workers,
                     timeout_s=args.timeout_s, remote=args.remote,
                     monitor=args.monitor_server, device=args.device).run()
        # per-task bests weighted by each task's own layer multiplicity
        totals[fw] = sr.network_latency()
        walls[fw] = sr.wall_time_s
        print(f"{fw:10s} network conv latency "
              f"{totals[fw] * 1e6:10.1f} us   tuning wall {walls[fw]:6.1f}s")

    print(f"\nthroughput vs AutoTVM*: "
          f"ARCO {totals['autotvm'] / totals['arco']:.2f}x  "
          f"(paper Fig.5: ResNet-18 ~1.38x), "
          f"CHAMELEON {totals['autotvm'] / totals['chameleon']:.2f}x")
    return {"network_latency_s": totals, "tuning_wall_s": walls}


def coopt_comparison(args, cfg, tasks) -> dict:
    """Co-optimized vs per-layer-fantasy vs hw-frozen at equal budget."""
    from repro_torch.compiler.netopt import (NetOptConfig,
                                             NetworkCoOptimizer,
                                             network_hw_frozen_tune)
    ncfg = NetOptConfig(seed_candidates=args.seed_candidates,
                        hw_rounds=args.hw_rounds,
                        hw_per_round=args.hw_per_round,
                        layer_budget=args.layer_budget,
                        refine_budget=args.refine_budget, tuner=cfg)
    total = ncfg.total_layer_budget()
    print(f"budget: {ncfg.n_candidates} hw candidates x "
          f"{ncfg.layer_budget} + a {ncfg.layer_budget}+"
          f"{ncfg.refine_budget} refinement session = {total} "
          "measurements/layer (co-opt upper bound; its refinement replays "
          "cached rows) for every method\n")

    from repro_torch.compiler.surrogate_store import store_from_args
    coopt = NetworkCoOptimizer(
        tasks, ncfg, records=args.records and f"{args.records}.netopt.jsonl",
        workers=args.workers, timeout_s=args.timeout_s, remote=args.remote,
        name="resnet-18", surrogates=store_from_args(args),
        monitor=args.monitor_server, device=args.device).run()
    if coopt.surrogates:
        print(f"surrogate transfer: {coopt.surrogates}")
    frozen = network_hw_frozen_tune(
        tasks, ncfg, records=args.records and f"{args.records}.frozen.jsonl",
        workers=args.workers, timeout_s=args.timeout_s, remote=args.remote,
        name="resnet-18", monitor=args.monitor_server, device=args.device)
    fantasy = Session(tasks, tuner=cfg, budget=total,
                      records=args.records and f"{args.records}.fantasy.jsonl",
                      workers=args.workers, timeout_s=args.timeout_s,
                      remote=args.remote, monitor=args.monitor_server,
                      device=args.device).run()

    hw = ", ".join(f"{k}={v}" for k, v in coopt.hw_config.items())
    print(f"co-optimized       {coopt.network_latency * 1e6:10.1f} us   "
          f"shared chip [{hw}]")
    print(f"hw-frozen baseline {frozen.network_latency * 1e6:10.1f} us   "
          "default chip, software-only search")
    print(f"per-layer fantasy  {fantasy.network_latency() * 1e6:10.1f} us   "
          f"{len(tasks)} different chips (unrealizable)")

    shared = coopt.verify_shared_hardware()
    print(f"\nshared hardware config identical across all "
          f"{len(coopt.layers)} layer mappings: {shared}")
    assert shared, "co-optimization must yield ONE hardware config"
    assert coopt.network_latency <= frozen.network_latency, (
        "co-optimization found no chip at least as good as the default "
        f"({coopt.network_latency} vs {frozen.network_latency})")
    ratio = coopt.network_latency / fantasy.network_latency()
    note = ("decomposed search even beats the per-layer joint search at "
            "this budget" if ratio <= 1 else
            "remaining cost of sharing one chip")
    print(f"co-optimized vs frozen: "
          f"{frozen.network_latency / coopt.network_latency:.2f}x faster; "
          f"co-optimized / fantasy = {ratio:.2f} ({note})")
    print("\nhw-candidate progress trace (cum. measurements -> network us):")
    for meas, lat in coopt.progress():
        print(f"  {meas:6d} -> {lat * 1e6:9.1f}")
    return {"coopt": coopt, "frozen": frozen, "fantasy": fantasy}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=int, default=192,
                    help="measurements/task for the software-only comparison")
    ap.add_argument("--coopt", action="store_true",
                    help="network-scope co-optimization comparison "
                         "(repro_torch.compiler.netopt)")
    ap.add_argument("--seed-candidates", type=int, default=3)
    ap.add_argument("--hw-rounds", type=int, default=2)
    ap.add_argument("--hw-per-round", type=int, default=2)
    ap.add_argument("--layer-budget", type=int, default=16)
    ap.add_argument("--refine-budget", type=int, default=32)
    ap.add_argument("--records", default=None,
                    help="JSONL records prefix; one file per method so "
                         "no method warm-starts from another's cache")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the agents and the GBT "
                         "(default cuda; cpu on request)")
    from repro_torch.compiler.executor import (add_worker_args,
                                               validate_worker_args)
    from repro_torch.compiler.surrogate_store import add_surrogate_args
    add_surrogate_args(ap)   # GBT warm start for --coopt (cross-network)
    add_worker_args(ap)
    args = ap.parse_args(argv)
    validate_worker_args(ap, args)
    resolve_device(args.device)     # no CUDA and no --device cpu: raise

    n_iter = max(args.budget // 32, 2)
    cfg = TunerConfig(iteration_opt=n_iter, b_measure=32,
                      episodes_per_iter=3,
                      mappo=mappo.MappoConfig(n_steps=64, n_envs=16),
                      gbt_rounds=20)
    tasks = TuningTask.conv_tasks("resnet-18")
    print(f"ResNet-18: {sum(t.multiplicity for t in tasks)} conv layers, "
          f"{len(tasks)} unique tuning tasks\n")

    # One tracer spanning every method's session: sub-runs without their
    # own trace= inherit the ambient tracer, so the whole comparison lands
    # in a single merged timeline.
    tracer = obs.Tracer(name="tune-resnet18",
                        sample_rate=args.trace_sample_rate) \
        if args.trace else None
    scope = obs.use(tracer) if tracer else contextlib.nullcontext()
    # ... and one monitor server shared (borrowed) by every sub-run: each
    # attaches its own /status source, finalized when that run ends.
    args.monitor_server = None
    if args.monitor is not None:
        args.monitor_server = obs.MonitorServer(port=args.monitor).start()
        print(f"live monitor at {args.monitor_server.url} "
              "(/metrics /status /trace)")
    try:
        with scope:
            if args.coopt:
                return coopt_comparison(args, cfg, tasks)
            if args.warm_from or args.save_surrogates:
                raise SystemExit("--warm-from/--save-surrogates apply to "
                                 "the co-optimizer; add --coopt")
            return software_only_comparison(args, cfg, tasks)
    finally:
        if tracer:
            tracer.save(args.trace)
            print(f"trace written to {args.trace}")
        if args.monitor_server is not None:
            args.monitor_server.stop()


if __name__ == "__main__":
    main()
