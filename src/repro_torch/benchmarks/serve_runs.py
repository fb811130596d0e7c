"""Online tuning-as-a-service benchmark: ``serve --autotune`` under a
synthetic million-request trace, on the PyTorch port.

Plays a Poisson + bursty arrival trace through the virtual-time serving
host (:class:`repro_torch.compiler.serve_tune.SimServeHost`) while a
stock tuning session (its agents on ``--device``, default cuda) measures
candidate decode/prefill geometries on idle decode slots, then compares
the online winners against an unconstrained offline session over the
identical spaces at the same budget and seed.

    PYTHONPATH=src python -m repro_torch.benchmarks.serve_runs \\
        --json-out BENCH_torch_serve.json

Headline claims the artifact must demonstrate (all asserted here before
anything is written):

* the online search converges to within 10% of the offline-tuned
  geometry's step time (``online_offline_min_ratio >= 0.9``);
* p99-SLA violations stay under 3% overall while it does so;
* the post-tuning phase beats the pre-tuning baseline on both p99
  latency and tokens/sec.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Optional

from repro_torch import obs, resolve_device
from repro_torch.compiler.session import Session
from repro_torch.compiler.serve_tune import (ServeModel, ServeSLA,
                                             SimServeHost, TraceConfig,
                                             serve_tasks, serve_tuner_config,
                                             tune_while_serving)


def serve_bench(n_requests: int = 1_000_000, rate_per_s: float = 100.0,
                budget: int = 48, sla_target_s: float = 0.5,
                n_slots: int = 8, measure_cost_s: float = 0.25,
                tune_after_s: float = 120.0, seed: int = 0,
                records: Optional[str] = None, device=None) -> Dict:
    """Run the online-vs-offline serving comparison; returns the flat
    metrics dict for the bench artifact."""
    model = ServeModel()
    sla = ServeSLA(target_s=sla_target_s)
    trace = TraceConfig(n_requests=n_requests, rate_per_s=rate_per_s,
                        seed=seed)
    host = SimServeHost(model, trace, sla=sla, n_slots=n_slots,
                        measure_cost_s=measure_cost_s,
                        tune_after_s=tune_after_s)
    t0 = time.perf_counter()
    tracer = obs.Tracer(name="serve_bench")
    with obs.use(tracer):
        with obs.current().span("online_serve", cat="phase"):
            rep = tune_while_serving(host, budget=budget, seed=seed,
                                     records=records,
                                     offline_compare=False, device=device)
        with obs.current().span("offline_compare", cat="phase"):
            off = Session(serve_tasks(model), tuner=serve_tuner_config(),
                          budget=budget, seed=seed, device=device).run()
    s = rep.serve
    metrics: Dict[str, object] = {
        "phase_times": tracer.phase_times(),
        "served_requests": float(s["served"]),
        "sim_time_s": s["sim_time_s"],
        "sla_violation_pct": s["violation_pct"],
        "p50_latency_s": s["p50_latency_s"],
        "p99_latency_s": s["p99_latency_s"],
        "tokens_per_sec": s["tokens_per_sec"],
        "mean_queue_s": s["mean_queue_s"],
        "mean_prefill_s": s["mean_prefill_s"],
        "tuned_from_s": s["tuned_from_s"],
        "geometry_switches": float(len(s["switches"])),
        "measurements": float(s["measurements"]),
        "measurements_preempted": float(s["preempted"]),
        "measure_idle_s": s["measure_idle_s"],
        "wall_time_s": time.perf_counter() - t0,
    }
    for ph in ("before", "after"):
        for k in ("p50_latency_s", "p99_latency_s", "tokens_per_sec",
                  "violation_pct"):
            name = f"{ph}_sla_{k}" if k == "violation_pct" else f"{ph}_{k}"
            metrics[name] = s[ph][k]
    ratios = []
    for kind in ("decode", "prefill"):
        online_step = rep.online[kind]["step_s"]
        r = off.reports[f"serve:{model.arch}/{kind}"]
        offline_step = model.cost_s(kind, model.settings_of(
            kind, r.best_config))
        ratio = offline_step / max(online_step, 1e-12)
        ratios.append(ratio)
        metrics[f"online_{kind}_step_s"] = online_step
        metrics[f"offline_{kind}_step_s"] = offline_step
        metrics[f"online_offline_{kind}_ratio"] = ratio
    metrics["online_offline_min_ratio"] = min(ratios)
    metrics["throughput_gain_x"] = (
        s["after"]["tokens_per_sec"] / s["before"]["tokens_per_sec"])

    # the headline claims, enforced before the artifact exists
    assert metrics["online_offline_min_ratio"] >= 0.9, \
        f"online search missed offline by >10%: {metrics}"
    assert metrics["sla_violation_pct"] < 3.0, \
        f"SLA violations above 3%: {metrics['sla_violation_pct']}"
    assert metrics["after_p99_latency_s"] < metrics["before_p99_latency_s"]
    assert metrics["after_tokens_per_sec"] > metrics["before_tokens_per_sec"]
    return metrics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=1_000_000)
    ap.add_argument("--rate", type=float, default=100.0)
    ap.add_argument("--budget", type=int, default=48)
    ap.add_argument("--sla-s", type=float, default=0.5)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--measure-cost-s", type=float, default=0.25)
    ap.add_argument("--tune-after-s", type=float, default=120.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--records", default=None, metavar="PATH",
                    help="JSONL measurement records (warm resume)")
    ap.add_argument("--json-out", default=None,
                    metavar="BENCH_torch_serve.json",
                    help="write the standardized bench artifact here")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the agents and the GBT "
                         "(default cuda; cpu on request)")
    args = ap.parse_args(argv)
    resolve_device(args.device)     # no CUDA and no --device cpu: raise

    metrics = serve_bench(n_requests=args.requests, rate_per_s=args.rate,
                          budget=args.budget, sla_target_s=args.sla_s,
                          n_slots=args.slots,
                          measure_cost_s=args.measure_cost_s,
                          tune_after_s=args.tune_after_s, seed=args.seed,
                          records=args.records, device=args.device)
    for k, v in metrics.items():
        if not isinstance(v, dict):
            print(f"  {k:36s} {v:.6g}")
    if args.json_out:
        from repro_torch.benchmarks.tuning_runs import (PACKAGE,
                                                        device_name,
                                                        write_bench_artifact)
        write_bench_artifact(
            args.json_out, "serve_autotune", metrics,
            config={"arch": "qwen2-1.5b", "n_devices": 256,
                    "n_requests": args.requests, "rate_per_s": args.rate,
                    "burst_factor": TraceConfig().burst_factor,
                    "budget": args.budget, "sla_target_s": args.sla_s,
                    "n_slots": args.slots,
                    "measure_cost_s": args.measure_cost_s,
                    "tune_after_s": args.tune_after_s,
                    "seed": args.seed, "package": PACKAGE,
                    "device": device_name(args.device)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
