"""ARCO over the pod: measurement oracle = dry-run estimate + roofline.

    PYTHONPATH=src python -m repro_torch.launch.autotune \\
        --arch mixtral-8x22b --shape train_4k --budget 14 [--device cpu]

The port of the reference's ``repro.launch.autotune``: the paper's
MAPPO + Confidence Sampling machinery pointed at a 256-chip execution
configuration.  Each "hardware measurement" (``compile_and_analyze``) is the
port's dry-run of the cell under the settings (``repro_torch.hw.
step_analysis``: the step counted on the ``meta`` device, the placements'
collectives modelled) combined with the TPU v5e roofline and its HBM
residency; the reference's is an SPMD compile.  ``search`` is a thin
adapter over ``repro_torch.compiler.Session`` + ``CompileOracle``; the
agents and the GBT run on ``device`` (default ``cuda``).  The pod's device
count is ``REPRO_DRYRUN_DEVICES`` (default 256) or ``--devices``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional

# the reference's HBM budget a chip: the hinge models the TPU v5e target
HBM_BYTES = 16 * 2.0 ** 30


def compile_and_analyze(arch: str, shape_name: str,
                        settings: Dict[str, object],
                        verbose: bool = True,
                        n_devices: Optional[int] = None
                        ) -> Dict[str, object]:
    """One 'hardware measurement': the cell under ``settings`` on a
    (data, model) mesh of ``n_devices``, its roofline and HBM residency.
    ``compile_s`` is the analysis's seconds."""
    from repro_torch.compiler.oracle import default_devices
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.hw import roofline as RL
    from repro_torch.hw import step_analysis
    from repro_torch.launch.mesh import make_host_mesh
    cfg = get_config(arch).with_(
        attn_chunk=int(settings["attn_chunk"]),
        remat=bool(settings["remat"]))
    cell = SHAPES[shape_name]
    n_dev = n_devices or default_devices()
    model_axis = int(settings["model_axis"])
    data_axis = max(n_dev // model_axis, 1)
    mesh = make_host_mesh(data_axis, model_axis)
    rules = ShardingRules(
        fsdp_weights=bool(settings["fsdp"]),
        sequence_parallel=bool(settings.get("sequence_parallel", False)))
    t0 = time.time()
    weighted = step_analysis.analyze(cfg, cell, mesh, rules, settings)
    art = {"weighted": {
        "dot_flops_per_device": weighted["weighted_dot_flops"],
        "wire_bytes_per_device": weighted["wire_bytes_per_device"],
        "collective_bytes_by_op": weighted["collective_bytes_by_op"]}}
    r = RL.analyze_cell(cfg, cell.kind, cell.seq, cell.global_batch,
                        dict(mesh), art)
    # Eq. 4/5 analog: hinge penalty on modelled HBM overflow — an OOM
    # configuration must never win the search.
    res = RL.hbm_residency(
        cfg, cell.kind, cell.seq, cell.global_batch, dict(mesh),
        fsdp=bool(settings["fsdp"]),
        moment_dtype=str(settings["moment_dtype"]),
        remat=bool(settings["remat"]),
        grad_accum=int(settings.get("grad_accum", 1)),
        sequence_parallel=bool(settings.get("sequence_parallel", False)))
    overflow_gib = max(res - HBM_BYTES, 0.0) / 2.0 ** 30
    step_pen = r.step_s * (1.0 + overflow_gib) + overflow_gib
    out = dict(r.as_dict(), compile_s=time.time() - t0,
               settings=dict(settings),
               hbm_residency_gib=res / 2.0 ** 30,
               feasible=res <= HBM_BYTES, step_penalized_s=step_pen)
    if verbose:
        print(f"  measure {settings}: step={r.step_s:.4f}s "
              f"residency={res / 2.0 ** 30:.1f}GiB "
              f"{'ok' if res <= HBM_BYTES else 'OOM'} "
              f"dominant={r.dominant} (analysis {out['compile_s']:.1f}s)",
              flush=True)
    return out


def search(arch: str, shape_name: str, budget: int = 14,
           seed: int = 0, out_path: str = None,
           records_path: str = None,
           workers: int = 0, timeout_s: float = None,
           remote: str = None, trace: str = None,
           monitor=None, trace_sample_rate: float = 1.0,
           device=None, n_devices: Optional[int] = None):
    """Thin adapter over the session API: one compile-oracle cell, measured
    through ``CompileOracle``.  Re-measures from scratch unless the caller
    opts into persistence with ``records_path`` (JSONL), from which a
    re-run resumes warm.  ``workers=N`` fans the measurements across N
    spawned workers, ``timeout_s`` bounds each; ``remote=
    "host:port[,host:port]"`` fans them over TCP worker daemons instead."""
    from repro_torch.compiler import Session, TuningTask
    from repro_torch.core import mappo
    from repro_torch.core.tuner import TunerConfig
    cfg = TunerConfig(
        iteration_opt=max(budget // 4, 2), b_measure=4,
        episodes_per_iter=2,
        mappo=mappo.MappoConfig(n_steps=32, n_envs=8), gbt_rounds=12,
        seed=seed)
    task = TuningTask.cell(arch, shape_name, n_devices=n_devices)
    result = Session(task, tuner=cfg, budget=budget, records=records_path,
                     workers=workers, timeout_s=timeout_s,
                     remote=remote, trace=trace, monitor=monitor,
                     trace_sample_rate=trace_sample_rate,
                     device=device).run().single
    summary = {
        "arch": arch, "shape": shape_name,
        "best_settings": result.best_settings,
        "best_step_s": result.best_latency,
        "n_measurements": result.n_measurements,
        "wall_s": result.wall_time_s,
        "history": [list(r) for r in result.history],
        "oracle": result.oracle_stats,
        "records": records_path,
        "workers": workers,
        "remote": remote,
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


def main(argv=None):
    from repro_torch.compiler.executor import (add_worker_args,
                                               validate_worker_args)
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.autotune")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--budget", type=int, default=14)
    ap.add_argument("--out", default=None)
    ap.add_argument("--records", default=None,
                    help="JSONL measurement records (persist + warm resume)")
    ap.add_argument("--devices", type=int, default=None,
                    help="the pod's device count (default "
                         "REPRO_DRYRUN_DEVICES, else 256)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the agents and the GBT "
                         "(default cuda; cpu on request)")
    add_worker_args(ap)
    args = ap.parse_args(argv)
    validate_worker_args(ap, args)
    s = search(args.arch, args.shape, args.budget, out_path=args.out,
               records_path=args.records, workers=args.workers,
               timeout_s=args.timeout_s, remote=args.remote,
               trace=args.trace, monitor=args.monitor,
               trace_sample_rate=args.trace_sample_rate,
               device=args.device, n_devices=args.devices)
    print(json.dumps(s, indent=1))


if __name__ == "__main__":
    main()
