"""Shared tuning sweep: every unique conv task of the paper's 7 networks
tuned by ARCO / AutoTVM-analog / CHAMELEON-analog at an equal measurement
budget (the paper's equal-compilation-duration protocol), on the PyTorch
port.

Results are cached as JSON under artifacts/tuning_torch/ (``REPRO_ART``
to move it) so table6 / fig5 / fig6 / fig7 all read one sweep; a cache
whose config does not name this package (the reference's, say) is
re-tuned, never read as the port's.  REPRO_PAPER=1 switches to the full
Table-4 budget (1024 measurements/task); the default budget (256)
preserves every paper trend at ~6x less wall time.

``--json-out BENCH_torch_netopt.json`` instead runs the network-scope
co-optimization benchmark (ResNet-18 coopt vs hw-frozen vs per-layer
fantasy at equal budget) and writes the standardized bench-artifact
document (:func:`write_bench_artifact`, schema ``repro-bench/2``: either
package's documents read the same).  ``--bench hetero`` swaps in the
heterogeneous-partitioning benchmark instead: K=2 pipeline netopt vs the
single-chip K=1 netopt vs the DiGamma-style genetic baseline on the mixed
conv-front + GEMM-tail ``resnet-bert`` zoo network, all at equal
measurement budget.  The agents and the GBT run on ``--device`` (default
cuda; the config records the card's name).

    PYTHONPATH=src python -m repro_torch.benchmarks.tuning_runs \\
        --json-out BENCH_torch_netopt.json
    PYTHONPATH=src python -m repro_torch.benchmarks.tuning_runs \\
        --bench hetero --json-out BENCH_torch_hetero.json --device cpu
"""
from __future__ import annotations

import argparse
import json
import math
import numbers
import os
import subprocess
import time
from typing import Dict, Optional

from repro_torch import obs, resolve_device
from repro_torch.compiler import Session, TuningTask
from repro_torch.core import mappo
from repro_torch.core.task import Task, conv_tasks
from repro_torch.core.tuner import TunerConfig
from repro_torch.models import cnn

BENCH_SCHEMA = "repro-bench/2"
# /2 additionally allows ONE nested block — metrics["phase_times"], a
# name -> finite-seconds dict from the run's tracer (repro_torch.obs); /1
# docs (strictly flat) are still accepted by validate_bench_doc.
BENCH_SCHEMAS = ("repro-bench/1", BENCH_SCHEMA)
ART = os.environ.get("REPRO_ART", "artifacts/tuning_torch")
PAPER = os.environ.get("REPRO_PAPER", "0") == "1"
# bump when the per-run row schema changes (2: TuneReport.to_dict rows,
# wall_time_s instead of wall_s) — stale caches are re-tuned, not crashed on
SWEEP_SCHEMA = 2
PACKAGE = "repro_torch"   # a sweep cache must name it to be read back

NETWORKS = list(cnn.MODELS)
FRAMEWORKS = ("autotvm", "chameleon", "arco")


def tuner_config() -> TunerConfig:
    if PAPER:  # Table 4: 16 x 64 ~ 1000 measurements
        return TunerConfig(iteration_opt=16, b_measure=64,
                           episodes_per_iter=8,
                           mappo=mappo.MappoConfig(n_steps=250, n_envs=16),
                           gbt_rounds=40)
    return TunerConfig(iteration_opt=8, b_measure=32, episodes_per_iter=3,
                       mappo=mappo.MappoConfig(n_steps=64, n_envs=16),
                       gbt_rounds=24)


def device_name(device=None) -> str:
    """What a document records as its device: the card's name on cuda,
    else the device type."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        import torch
        return torch.cuda.get_device_name(dev)
    return dev.type


def unique_tasks() -> Dict[str, Task]:
    """Global dedupe across networks (identical conv workloads share one
    tuning run, as TVM task extraction does)."""
    seen: Dict[str, Task] = {}
    for net in NETWORKS:
        for t in conv_tasks(net):
            key = json.dumps(sorted(t.space.workload.items()))
            if key not in seen:
                seen[key] = t
    return seen


def _tune(framework: str, space, cfg: TunerConfig, workers: int = 0,
          timeout_s: Optional[float] = None, remote=None, device=None):
    """One framework on one task via the session API; the typed report is
    JSON-serializable end-to-end (no hand re-packing)."""
    task = TuningTask.from_space("bench", space)
    report = Session(task, tuner=cfg, algo=framework, workers=workers,
                     timeout_s=timeout_s, remote=remote,
                     device=device).run().single
    return report.to_dict()


def run_sweep(force: bool = False, workers: int = 0,
              timeout_s: Optional[float] = None, remote=None,
              device=None) -> Dict:
    os.makedirs(ART, exist_ok=True)
    path = os.path.join(ART, f"sweep_{'paper' if PAPER else 'default'}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            sweep = json.load(f)
        conf = sweep.get("config", {})
        if conf.get("schema") == SWEEP_SCHEMA \
                and conf.get("package") == PACKAGE:
            return sweep
        print(f"sweep cache {path} has an old schema or is not "
              f"{PACKAGE}'s; re-tuning", flush=True)
    cfg = tuner_config()
    tasks = unique_tasks()
    out: Dict[str, Dict] = {"tasks": {}, "config": {
        "budget": cfg.iteration_opt * cfg.b_measure, "paper": PAPER,
        "schema": SWEEP_SCHEMA, "package": PACKAGE,
        "device": device_name(device)}}
    for i, (key, task) in enumerate(tasks.items()):
        wl = task.space.workload
        entry = {"workload": wl}
        for fw in FRAMEWORKS:
            entry[fw] = _tune(fw, task.space, cfg, workers=workers,
                              timeout_s=timeout_s, remote=remote,
                              device=device)
        out["tasks"][key] = entry
        print(f"[{i + 1}/{len(tasks)}] {wl['h']}x{wl['w']}x{wl['ci']}->"
              f"{wl['co']} k{wl['kh']}s{wl['stride']}: " +
              " ".join(f"{fw}={entry[fw]['best_latency']:.2e}"
                       for fw in FRAMEWORKS), flush=True)
        with open(path, "w") as f:   # checkpoint the sweep as it goes
            json.dump(out, f)
    return out


def network_results(sweep: Dict) -> Dict[str, Dict[str, float]]:
    """Per-network mean inference time (conv-dominated) per framework."""
    out: Dict[str, Dict[str, float]] = {}
    for net in NETWORKS:
        res = {fw: 0.0 for fw in FRAMEWORKS}
        wall = {fw: 0.0 for fw in FRAMEWORKS}
        for t in conv_tasks(net):
            key = json.dumps(sorted(t.space.workload.items()))
            entry = sweep["tasks"][key]
            for fw in FRAMEWORKS:
                res[fw] += entry[fw]["best_latency"] * t.multiplicity
        # tuning wall time: each network pays for its unique tasks
        seen = set()
        for t in conv_tasks(net):
            key = json.dumps(sorted(t.space.workload.items()))
            if key in seen:
                continue
            seen.add(key)
            for fw in FRAMEWORKS:
                wall[fw] += sweep["tasks"][key][fw]["wall_time_s"]
        out[net] = {"latency": res, "tuning_wall_s": wall}
    return out


def git_revision() -> str:
    """Short git revision of the checkout this module lies in (``-dirty``
    suffixed when uncommitted changes exist); ``"unknown"`` outside a
    repo."""
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             cwd=here, capture_output=True, text=True,
                             timeout=10)
        if rev.returncode != 0:
            return "unknown"
        dirty = subprocess.run(["git", "status", "--porcelain"], cwd=here,
                               capture_output=True, text=True, timeout=10)
        suffix = "-dirty" if dirty.stdout.strip() else ""
        return rev.stdout.strip() + suffix
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _check_metric(k, v, where: str) -> None:
    if not isinstance(k, str):
        raise ValueError(f"{where} name {k!r} is not a str")
    if isinstance(v, bool) or not isinstance(v, numbers.Real) \
            or not math.isfinite(float(v)):
        raise ValueError(f"{where} {k!r} must be a finite float, "
                         f"got {v!r}")


def validate_bench_doc(doc: Dict) -> Dict:
    """Assert ``doc`` is a well-formed ``repro-bench/1`` or ``/2``
    artifact; returns it.  The contract trajectory tooling diffs across
    commits: flat finite-float metrics (structure goes in metric
    *names*), a JSON-object config, a git revision, a creation
    timestamp.  ``/2`` additionally permits exactly one nested block —
    ``metrics["phase_times"]``, itself a flat name -> finite-seconds
    dict (the run's span-level time attribution)."""
    if not isinstance(doc, dict):
        raise ValueError(f"bench doc must be a dict, got {type(doc)}")
    if doc.get("schema") not in BENCH_SCHEMAS:
        raise ValueError(f"bench schema {doc.get('schema')!r} not in "
                         f"{BENCH_SCHEMAS!r}")
    if not doc.get("bench") or not isinstance(doc["bench"], str):
        raise ValueError("bench doc needs a nonempty str 'bench' name")
    if not isinstance(doc.get("created_unix"), numbers.Real):
        raise ValueError("bench doc needs a numeric 'created_unix'")
    if not doc.get("git_rev") or not isinstance(doc["git_rev"], str):
        raise ValueError("bench doc needs a nonempty str 'git_rev'")
    if not isinstance(doc.get("config"), dict):
        raise ValueError("bench doc needs a dict 'config'")
    metrics = doc.get("metrics")
    if not isinstance(metrics, dict) or not metrics:
        raise ValueError("bench doc needs a nonempty 'metrics' dict")
    for k, v in metrics.items():
        if (k == "phase_times" and doc["schema"] == BENCH_SCHEMA
                and isinstance(v, dict)):
            for pk, pv in v.items():
                _check_metric(pk, pv, "phase_times entry")
            continue
        _check_metric(k, v, "metric")
    return doc


def write_bench_artifact(path: str, bench: str, metrics: Dict[str, float],
                         config: Dict) -> Dict:
    """The standardized ``BENCH_*.json`` artifact: one flat document of

        {"schema": "repro-bench/2", "bench": <name>, "created_unix": <ts>,
         "git_rev": <short rev[-dirty]>, "config": {...what was run...},
         "metrics": {name: float, ..., "phase_times": {name: secs, ...}}}

    ``metrics`` is a flat name->float dict so trajectory tooling can diff
    runs across commits without schema knowledge; put structure in names
    (``coopt_network_latency_s``), not nesting.  The ONE sanctioned
    nested block is ``phase_times`` — span-level wall-clock attribution
    from the run's tracer (:mod:`repro_torch.obs`), itself flat
    name->seconds.  The document is validated (:func:`validate_bench_doc`)
    before anything touches disk — a NaN metric or unsanctioned nesting
    fails the run, not the downstream diff."""
    doc = {"schema": BENCH_SCHEMA, "bench": bench,
           "created_unix": time.time(), "git_rev": git_revision(),
           "config": config,
           "metrics": {k: ({pk: float(pv) for pk, pv in v.items()}
                           if k == "phase_times" and isinstance(v, dict)
                           else float(v))
                       for k, v in metrics.items()}}
    validate_bench_doc(doc)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {path}: " + " ".join(f"{k}={v:.3e}"
                                       for k, v in doc["metrics"].items()
                                       if not isinstance(v, dict)),
          flush=True)
    return doc


def netopt_bench(workers: int = 0, timeout_s: Optional[float] = None,
                 layer_budget: int = 8, refine_budget: int = 8,
                 remote=None, device=None) -> Dict:
    """ResNet-18 network co-optimization vs its equal-budget comparison
    points; returns the flat metrics dict for the bench artifact."""
    from repro_torch.compiler.netopt import (NetOptConfig,
                                             NetworkCoOptimizer,
                                             network_hw_frozen_tune)
    ncfg = NetOptConfig(seed_candidates=2, hw_rounds=1, hw_per_round=1,
                        layer_budget=layer_budget,
                        refine_budget=refine_budget, tuner=tuner_config())
    tasks = TuningTask.conv_tasks("resnet-18")
    t0 = time.perf_counter()
    tracer = obs.Tracer(name="netopt_bench")
    with obs.use(tracer):  # every arm's spans land in one phase_times
        coopt = NetworkCoOptimizer(tasks, ncfg, workers=workers,
                                   timeout_s=timeout_s, remote=remote,
                                   name="resnet-18", device=device).run()
        frozen = network_hw_frozen_tune(tasks, ncfg, workers=workers,
                                        timeout_s=timeout_s, remote=remote,
                                        name="resnet-18", device=device)
        fantasy = Session(tasks, tuner=ncfg.tuner,
                          budget=ncfg.total_layer_budget(), workers=workers,
                          timeout_s=timeout_s, remote=remote,
                          device=device).run()
    return {
        "phase_times": tracer.phase_times(),
        "coopt_network_latency_s": coopt.network_latency,
        "hw_frozen_network_latency_s": frozen.network_latency,
        "fantasy_network_latency_s": fantasy.network_latency(),
        "coopt_speedup_vs_frozen": (frozen.network_latency
                                    / coopt.network_latency),
        "coopt_hw_candidates": coopt.hw_candidates,
        "coopt_measurements": coopt.total_measurements,
        "budget_per_layer": ncfg.total_layer_budget(),
        "wall_time_s": time.perf_counter() - t0,
    }


def hetero_tuner_config() -> TunerConfig:
    """Small deterministic per-layer tuner for the hetero bench: the
    comparison is between *outer* search strategies (K=1 netopt vs K=2
    netopt vs genetic), so the inner software tuner just needs to be
    identical and cheap across all three arms."""
    return TunerConfig(iteration_opt=8, b_measure=8, episodes_per_iter=2,
                       mappo=mappo.MappoConfig(n_steps=16, n_envs=8),
                       gbt_rounds=10)


def hetero_bench(workers: int = 0, timeout_s: Optional[float] = None,
                 layer_budget: int = 16, refine_budget: int = 48,
                 remote=None, device=None) -> Dict:
    """Heterogeneous partitioning on the mixed ``resnet-bert`` network
    (ResNet-18 conv front, BERT GEMM tail): K=2 pipeline co-optimization
    vs single-chip K=1 co-optimization vs the DiGamma-style genetic
    baseline over the same joint (partition, hw) space, every arm at the
    same total measurement budget; returns the flat metrics dict."""
    from repro_torch.compiler.netopt import (NetOptConfig,
                                             NetworkCoOptimizer,
                                             network_genetic_hw_tune)
    from repro_torch.compiler.zoo import get_network
    tasks = list(get_network("resnet-bert").tasks)
    base = dict(seed_candidates=2, hw_rounds=1, hw_per_round=1,
                layer_budget=layer_budget, refine_budget=refine_budget,
                tuner=hetero_tuner_config())
    t0 = time.perf_counter()
    tracer = obs.Tracer(name="hetero_bench")
    with obs.use(tracer):
        k1 = NetworkCoOptimizer(tasks, NetOptConfig(**base), workers=workers,
                                timeout_s=timeout_s, remote=remote,
                                name="resnet-bert", device=device).run()
        k2 = NetworkCoOptimizer(tasks, NetOptConfig(k_chips=2, **base),
                                workers=workers, timeout_s=timeout_s,
                                remote=remote, name="resnet-bert",
                                device=device).run()
        ga = network_genetic_hw_tune(tasks, NetOptConfig(k_chips=2, **base),
                                     workers=workers, timeout_s=timeout_s,
                                     remote=remote, name="resnet-bert",
                                     device=device)
    return {
        "phase_times": tracer.phase_times(),
        "k1_network_latency_s": k1.network_latency,
        "k2_network_latency_s": k2.network_latency,
        "genetic_network_latency_s": ga.network_latency,
        "k2_speedup_vs_k1": k1.network_latency / k2.network_latency,
        "k2_speedup_vs_genetic": ga.network_latency / k2.network_latency,
        "k2_cut": float(k2.partition["cuts"][0]),
        "k1_measurements": k1.total_measurements,
        "k2_measurements": k2.total_measurements,
        "genetic_measurements": ga.total_measurements,
        "budget_per_layer": NetOptConfig(**base).total_layer_budget(),
        "wall_time_s": time.perf_counter() - t0,
    }


def main(argv=None) -> int:
    from repro_torch.compiler.executor import (add_worker_args,
                                               validate_worker_args)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--force", action="store_true",
                    help="re-tune even if a cached sweep exists "
                         "(REPRO_FORCE=1 also works)")
    ap.add_argument("--json-out", default=None,
                    metavar="BENCH_torch_netopt.json",
                    help="run the selected benchmark and write the "
                         "standardized bench artifact here (skips the sweep)")
    ap.add_argument("--bench", choices=("netopt", "hetero"),
                    default="netopt",
                    help="which --json-out benchmark to run: netopt = "
                         "ResNet-18 shared-chip coopt; hetero = K=2 "
                         "pipeline vs K=1 vs genetic on resnet-bert")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the agents, the GBT and the "
                         "measurements (default cuda; cpu on request)")
    add_worker_args(ap)
    args = ap.parse_args(argv)
    validate_worker_args(ap, args)
    resolve_device(args.device)     # no CUDA and no --device cpu: raise
    if args.json_out and args.bench == "hetero":
        metrics = hetero_bench(workers=args.workers,
                               timeout_s=args.timeout_s,
                               remote=args.remote, device=args.device)
        write_bench_artifact(
            args.json_out, "hetero_resnet_bert", metrics,
            config={"paper": PAPER, "networks": ["resnet-bert"],
                    "k_chips": [1, 2], "baseline": "genetic",
                    "budget_per_layer": metrics.pop("budget_per_layer"),
                    "package": PACKAGE, "device": device_name(args.device)})
    elif args.json_out:
        metrics = netopt_bench(workers=args.workers,
                               timeout_s=args.timeout_s,
                               remote=args.remote, device=args.device)
        write_bench_artifact(
            args.json_out, "netopt_resnet18", metrics,
            config={"paper": PAPER, "networks": ["resnet-18"],
                    "budget_per_layer": metrics.pop("budget_per_layer"),
                    "package": PACKAGE, "device": device_name(args.device)})
    else:
        run_sweep(force=args.force
                  or os.environ.get("REPRO_FORCE", "0") == "1",
                  workers=args.workers, timeout_s=args.timeout_s,
                  remote=args.remote, device=args.device)
    return 0


if __name__ == "__main__":
    main()
