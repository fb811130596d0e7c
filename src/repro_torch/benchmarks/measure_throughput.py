"""Measurement-throughput micro-bench for ``repro_torch.compiler.executor``.

Runs the same cold-cache measurement batch through a ``SettingsOracle``
backed by the in-process ``SerialExecutor`` and by ``SubprocessExecutor``
pools of 1/2/4 workers, against a deterministic stub oracle that sleeps
``--delay`` seconds per measurement (modelling the tens-of-seconds SPMD
compile at CI-friendly scale).  Reports measurements/sec per backend so
the fan-out speedup is demonstrable without an accelerator (the stub
touches no device, so this driver takes no ``--device``):

    PYTHONPATH=src python -m repro_torch.benchmarks.measure_throughput
    PYTHONPATH=src python -m repro_torch.benchmarks.measure_throughput \\
        --delay 0.5 --n 48 --workers 1,2,4,8 --json artifacts/throughput.json

``--remote N[,M...]`` benchmarks the remote measurement fabric instead:
for each fleet size it spawns that many loopback worker daemons
(``python -m repro_torch.compiler.executor.worker``), drives them through
a ``RemoteExecutor``, and reports meas/sec the same way — the TCP tax at
its worst (localhost round-trips, zero-cost oracle); ``--bench-json
BENCH_torch_remote.json`` additionally emits the standardized bench
artifact:

    PYTHONPATH=src python -m repro_torch.benchmarks.measure_throughput \\
        --remote 1,2,4 --bench-json BENCH_torch_remote.json

Worker pools (and daemons) are pre-spawned outside the timed region (a
session reuses one pool across every Confidence-Sampling batch, so spawn
cost amortizes away; the per-batch measurement rate is the number that
gates optimization time).

NOTE: all heavy imports live inside the functions on purpose.  Spawned
workers re-import this module as ``__mp_main__``, and a module-level
torch/numpy import would make every stub worker pay seconds of
interpreter start-up — exactly the overhead the executor package's
import-light rule exists to avoid.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

STUB = "repro_torch.compiler.executor.stub:make_stub"


def distinct_configs(space, n: int):
    """First ``n`` configs in mixed-radix order — distinct, deterministic,
    and identical for every backend."""
    import numpy as np
    radices = [len(c) for c in space.choices]
    out = np.zeros((n, len(radices)), np.int64)
    for i in range(n):
        rem = i
        for k, r in enumerate(radices):
            out[i, k] = rem % r
            rem //= r
    return out


def run_once(space, configs, executor, label: str, spec=None) -> dict:
    import numpy as np
    from repro_torch.compiler.oracle import SettingsOracle
    oracle = SettingsOracle(space, fn=None, executor=executor,
                            task=f"throughput/{label}", own_executor=True,
                            worker_spec=spec)
    t0 = time.perf_counter()
    lat, _ = oracle.measure(configs)
    wall = time.perf_counter() - t0
    oracle.close()
    assert oracle.stats()["failures"] == 0, oracle.stats()
    return {"backend": label, "wall_s": wall,
            "meas_per_s": len(configs) / wall,
            "mean_latency": float(np.mean(lat))}


def run_remote(space, configs, fleet_sizes, delay_s: float) -> list:
    """meas/sec against N loopback daemons per fleet size: spawn the
    daemons (outside the timed region, like pool pre-spawn), point one
    ``RemoteExecutor`` at all of them, run the same batch."""
    from repro_torch.compiler.executor import (RemoteExecutor, WorkerSpec,
                                               spawn_daemon)

    spec = WorkerSpec(factory=STUB, kwargs={"delay_s": delay_s})
    rows = []
    for n_daemons in fleet_sizes:
        procs, endpoints = [], []
        try:
            for _ in range(n_daemons):
                proc, ep = spawn_daemon(slots=1)
                procs.append(proc)
                endpoints.append(ep)
            ex = RemoteExecutor(endpoints)
            row = run_once(space, configs, ex, f"remote[{n_daemons}]",
                           spec=spec)
            rows.append(row)
        finally:
            for proc in procs:
                proc.terminate()
            for proc in procs:
                proc.wait(timeout=10)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--delay", type=float, default=0.2,
                    help="stub oracle seconds per measurement")
    ap.add_argument("--n", type=int, default=32,
                    help="measurements per batch (cold cache)")
    ap.add_argument("--workers", default="1,2,4",
                    help="comma-separated subprocess pool sizes")
    ap.add_argument("--remote", default=None, metavar="N[,M...]",
                    help="benchmark the remote fabric against these "
                         "loopback daemon fleet sizes instead of local "
                         "subprocess pools")
    ap.add_argument("--json", default=None, help="write results JSON here")
    ap.add_argument("--bench-json", default=None,
                    metavar="BENCH_torch_remote.json",
                    help="with --remote: also write the standardized "
                         "bench artifact (write_bench_artifact)")
    args = ap.parse_args(argv)
    if args.bench_json and not args.remote:
        ap.error("--bench-json is the remote-fabric artifact; it needs "
                 "--remote N[,M...]")

    from repro_torch.compiler.executor import (SerialExecutor,
                                               SubprocessExecutor,
                                               WorkerSpec)
    from repro_torch.compiler.executor.stub import make_stub
    from repro_torch.core.shard_space import ShardSpace

    space = ShardSpace.for_cell("qwen2-1.5b", "train_4k", None, n_devices=256)
    configs = distinct_configs(space, args.n)
    spec = WorkerSpec(factory=STUB, kwargs={"delay_s": args.delay})

    rows = [run_once(space, configs,
                     SerialExecutor(fn=make_stub(delay_s=args.delay)),
                     "serial")]
    if args.remote:
        rows += run_remote(space, configs,
                           [int(x) for x in args.remote.split(",")],
                           args.delay)
    else:
        for w in (int(x) for x in args.workers.split(",")):
            pool = SubprocessExecutor(spec, workers=w)
            pool.start()  # spawn outside the timed region (pool is reused)
            rows.append(run_once(space, configs, pool, f"subprocess[{w}]"))

    base = rows[0]["meas_per_s"]
    print(f"\n{args.n} measurements/batch, {args.delay:.2f}s stub oracle")
    print(f"{'backend':16s} {'wall_s':>8s} {'meas/s':>8s} {'speedup':>8s}")
    for r in rows:
        r["speedup_vs_serial"] = r["meas_per_s"] / base
        print(f"{r['backend']:16s} {r['wall_s']:8.2f} "
              f"{r['meas_per_s']:8.2f} {r['speedup_vs_serial']:7.2f}x")

    # parity: every backend must agree on the (deterministic) stub values
    assert len({round(r["mean_latency"], 12) for r in rows}) == 1, rows

    if args.json:
        d = os.path.dirname(args.json)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"delay_s": args.delay, "n": args.n, "runs": rows},
                      f, indent=1)
    if args.bench_json:
        # standardized bench artifact, same convention as the netopt /
        # hetero documents
        from repro_torch.benchmarks.tuning_runs import (PACKAGE,
                                                        write_bench_artifact)
        metrics = {"serial_meas_per_s": rows[0]["meas_per_s"]}
        for r in rows[1:]:
            n_d = r["backend"].split("[")[1].rstrip("]")
            metrics[f"remote{n_d}_meas_per_s"] = r["meas_per_s"]
            metrics[f"remote{n_d}_speedup_vs_serial"] = \
                r["speedup_vs_serial"]
        write_bench_artifact(
            args.bench_json, "remote_throughput", metrics,
            config={"delay_s": args.delay, "n": args.n,
                    "fleet_sizes": [int(x) for x in args.remote.split(",")],
                    "transport": "tcp-loopback", "slots_per_daemon": 1,
                    "package": PACKAGE})
    return 0


if __name__ == "__main__":
    sys.exit(main())
