"""Benchmark harness — one function per paper table/figure, on the
PyTorch port.

Prints ``name,us_per_call,derived`` CSV rows.  ``us_per_call`` is the
simulated inference latency (the paper's Table-6 metric) where applicable,
wall-clock tuning time for Fig. 6, and the derived column carries the
paper-comparable ratio.  The sweep and Fig. 4 tune on ``--device``
(default cuda).

    PYTHONPATH=src python -m repro_torch.benchmarks.run             # all
    PYTHONPATH=src python -m repro_torch.benchmarks.run table6 fig7 # subset
    REPRO_PAPER=1 ...                                   # full Table-4 budget
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np

from repro_torch import resolve_device
from repro_torch.benchmarks import tuning_runs as TR

ROWS: List[str] = []


def emit(name: str, us_per_call: float, derived: str):
    row = f"{name},{us_per_call:.3f},{derived}"
    ROWS.append(row)
    print(row, flush=True)


# ------------------------------------------------------------------ table 6

def bench_table6(sweep: Dict):
    """Mean inference times per framework on the tunable accelerator
    (Table 6 analog; seconds in the paper, simulated us here)."""
    nets = TR.network_results(sweep)
    for net, r in nets.items():
        for fw in TR.FRAMEWORKS:
            emit(f"table6.{net}.{fw}", r["latency"][fw] * 1e6,
                 "best_simulated_conv_latency_sum")


# ------------------------------------------------------------------- fig 5

def bench_fig5(sweep: Dict):
    """Throughput relative to AutoTVM (Fig. 5 analog)."""
    nets = TR.network_results(sweep)
    ratios = []
    for net, r in nets.items():
        base = r["latency"]["autotvm"]
        for fw in ("chameleon", "arco"):
            ratio = base / r["latency"][fw]
            if fw == "arco":
                ratios.append(ratio)
            emit(f"fig5.{net}.{fw}_over_autotvm",
                 r["latency"][fw] * 1e6, f"throughput_ratio={ratio:.3f}")
    emit("fig5.geomean.arco_over_autotvm", 0.0,
         f"throughput_ratio={float(np.exp(np.mean(np.log(ratios)))):.3f}"
         f" (paper: mean 1.17x, up to 1.38x)")


# ------------------------------------------------------------------- fig 6

def bench_fig6(sweep: Dict):
    """Optimization (tuning) time per framework (Fig. 6 analog)."""
    nets = TR.network_results(sweep)
    for net, r in nets.items():
        base = r["tuning_wall_s"]["autotvm"]
        for fw in TR.FRAMEWORKS:
            w = r["tuning_wall_s"][fw]
            emit(f"fig6.{net}.{fw}", w * 1e6,
                 f"tuning_speedup_vs_autotvm={base / w:.3f}")


# ------------------------------------------------------------------- fig 7

def bench_fig7(sweep: Dict):
    """Convergence: best achieved GFLOPS vs measurement count for the
    heaviest ResNet-18 conv task (Fig. 7 analog)."""
    from repro_torch.core.task import conv_tasks
    from repro_torch.hw.analytical import conv2d_gflops
    tasks = conv_tasks("resnet-18")
    heavy = max(tasks, key=lambda t: t.space.workload["ci"]
                * t.space.workload["co"])
    key = json.dumps(sorted(heavy.space.workload.items()))
    entry = sweep["tasks"][key]
    wl = heavy.space.workload
    for fw in TR.FRAMEWORKS:
        hist = entry[fw]["history"]
        for count, best, _ in hist[:: max(len(hist) // 6, 1)]:
            emit(f"fig7.{fw}.n{count}", best * 1e6,
                 f"gflops={conv2d_gflops(wl, best):.1f}")
        n90 = _measurements_to_reach(entry[fw], 1.10)
        emit(f"fig7.{fw}.to_within_10pct", 0.0, f"measurements={n90}")


def _measurements_to_reach(run: Dict, slack: float) -> int:
    target = run["best_latency"] * slack
    for count, best, _ in run["history"]:
        if best <= target:
            return count
    return run["n_measurements"]


# ------------------------------------------------------------------- fig 4

def bench_fig4(device=None):
    """Measured-configuration quality over time, with vs without CS
    (Fig. 4 analog) — run fresh (needs the CS ablation flag)."""
    from repro_torch.compiler import Session, TuningTask
    from repro_torch.core.design_space import DesignSpace
    wl = dict(b=1, h=14, w=14, ci=256, co=256, kh=3, kw=3, stride=1, pad=1)
    task = TuningTask.from_space("fig4", DesignSpace.for_conv2d(wl))
    cfg = TR.tuner_config()
    r_cs = Session(task, tuner=cfg, use_cs=True, device=device).run().single
    r_nocs = Session(task, tuner=cfg, use_cs=False,
                     device=device).run().single
    for tag, r in (("with_cs", r_cs), ("without_cs", r_nocs)):
        lats = np.asarray([l for _, l in r.measurements])
        lats = lats[np.isfinite(lats) & (lats < 1e6)]
        half = len(lats) // 2
        grav = "yes" if lats[half:].mean() < lats[:half].mean() else "no"
        emit(f"fig4.{tag}.first_half_mean", float(lats[:half].mean()) * 1e6,
             f"n={half}")
        emit(f"fig4.{tag}.second_half_mean",
             float(lats[half:].mean()) * 1e6, f"gravitates={grav}")
        emit(f"fig4.{tag}.best", r.best_latency * 1e6,
             f"n_measured={r.n_measurements}")


# ---------------------------------------------------------------- roofline

def bench_roofline():
    """Roofline terms per dry-run artifact (``python -m
    repro_torch.launch.dryrun --out DIR``; the TPU v5e model, not a time
    of the card)."""
    art_dir = os.environ.get("REPRO_DRYRUN_ART", "artifacts/dryrun")
    if not os.path.isdir(art_dir):
        emit("roofline.skipped", 0.0, f"no artifacts under {art_dir}")
        return
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.hw import roofline as RL
    for fname in sorted(os.listdir(art_dir)):
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(art_dir, fname)) as f:
            art = json.load(f)
        if art.get("status") != "ok" or "weighted" not in art:
            continue
        cfg = get_config(art["arch"])
        cell = SHAPES[art["shape"]]
        mesh = {p.split("=")[0].strip(): int(p.split("=")[1])
                for p in art["mesh_desc"].split(" x ")}
        r = RL.analyze_cell(cfg, cell.kind, cell.seq, cell.global_batch,
                            mesh, art)
        n_dev = int(np.prod(list(mesh.values())))
        frac = RL.roofline_fraction(r, n_dev=n_dev)
        res = RL.hbm_residency(cfg, cell.kind, cell.seq, cell.global_batch,
                               mesh)
        emit(f"roofline.{art['arch']}.{art['shape']}.{art['mesh']}",
             r.step_s * 1e6,
             f"dominant={r.dominant};comp={r.compute_s:.2e};"
             f"mem={r.memory_s:.2e};coll={r.collective_s:.2e};"
             f"useful_ratio={r.usefulness:.2f};roofline_frac={frac:.3f};"
             f"hbm_gib={res / 2**30:.1f}")


BENCHES = {
    "table6": lambda sweep, device: bench_table6(sweep),
    "fig5": lambda sweep, device: bench_fig5(sweep),
    "fig6": lambda sweep, device: bench_fig6(sweep),
    "fig7": lambda sweep, device: bench_fig7(sweep),
    "fig4": lambda sweep, device: bench_fig4(device),
    "roofline": lambda sweep, device: bench_roofline(),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("names", nargs="*", metavar="BENCH",
                    help=f"benchmarks to run (default all: {list(BENCHES)})")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the sweep's and Fig. 4's tuners "
                         "(default cuda; cpu on request)")
    args = ap.parse_args(argv)
    names = args.names or list(BENCHES)
    needs_sweep = any(n in ("table6", "fig5", "fig6", "fig7")
                      for n in names)
    if needs_sweep or "fig4" in names:
        resolve_device(args.device)  # no CUDA and no --device cpu: raise
    sweep = TR.run_sweep(device=args.device) if needs_sweep else None
    print("name,us_per_call,derived", flush=True)
    for n in names:
        if n not in BENCHES:
            print(f"unknown benchmark {n}; have {list(BENCHES)}")
            continue
        BENCHES[n](sweep, args.device)
    return 0


if __name__ == "__main__":
    main()
