"""Runs one cell of ``BENCHMARK.json`` once and builds its result line.

A cell is found by name, and everything that belongs to it by the names
its entry gives:

* ``dcoc_bench/workloads/<cell>.json``: the configuration, the traffic
  mix, the chips, and the limit of each number the correctness check
  compares;
* ``dcoc_bench/configs/<config>.json``: the network's sizes;
* ``dcoc_bench/traffic/<traffic>.json``: the mix's parameters, whose
  ``kind`` names the generator, ``dcoc_bench/traffic/<kind>.py``;
* ``dcoc_bench/metrics/<metric>.py`` (or, for a split name such as
  ``idle_pct.tune``, ``metrics/idle_pct.py``): one reader per metric, whose
  ``read(run)`` returns the number, or None where the run holds nothing
  to read.

Which metrics a cell reports comes from ``BENCHMARK.json`` itself: its
end-to-end metrics with ``--trace 0``, its per-layer ones with ``--trace
1``.  A generator module has ``setup(run)``, ``window(run)``,
``trace(run)`` and ``check(run)``; :func:`run_cell` calls them in that
order, reads the device's peak memory after the window, and only then
the check, which frees the program's state before it runs the
reference.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoChip(RuntimeError):
    """The machine lacks the card or the number of cards a cell needs."""


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def _module(path: str):
    name = "dcoc_bench_" + os.path.relpath(path, BENCH_DIR).replace(
        os.sep, "_").replace(".", "_").replace("-", "_")
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return mod


def reader_path(metric: str) -> str:
    """``metrics/<metric>.py``, else the file of the name's stem before
    its last dot."""
    path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
    if not os.path.exists(path) and "." in metric:
        path = os.path.join(BENCH_DIR, "metrics",
                            metric.rsplit(".", 1)[0] + ".py")
    return path


def reader(metric: str):
    return _module(reader_path(metric))


def generator(kind: str):
    return _module(os.path.join(BENCH_DIR, "traffic", kind + ".py"))


def cell_metrics(bench: dict, cell: str, per_layer: bool) -> List[dict]:
    """The metric entries a cell reports: end-to-end ones that list it
    (or list no cells); per-layer ones that list it, or that list no
    cells and move an end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not per_layer:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads",
                             [cell] if m["moves"] in moved else [])]


@dataclasses.dataclass
class Run:
    """One run of one cell: its inputs, and what the generator observed
    for the readers and the check."""
    cell: str
    seed: int
    seconds: float
    trace: bool
    device: str
    entry: dict                   # the cell's BENCHMARK.json entry
    workload: dict                # workloads/<cell>.json
    config: dict                  # configs/<config>.json
    mix: dict                     # traffic/<traffic>.json
    setup_s: Optional[float] = None
    memory_peak_bytes: int = 0
    attempted: int = 0
    failed: int = 0
    obs: Dict[str, object] = dataclasses.field(default_factory=dict)
    devtrace: object = None       # devtrace.DeviceTrace of --trace 1
    checks: Dict[str, float] = dataclasses.field(default_factory=dict)
    state: Dict[str, object] = dataclasses.field(default_factory=dict)


def make_run(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", mix_overrides: Optional[dict] = None,
             config_overrides: Optional[dict] = None,
             bench: Optional[dict] = None) -> Run:
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
    workload = load_json(BENCH_DIR, "workloads", cell + ".json")
    config = load_json(BENCH_DIR, "configs", workload["config"] + ".json")
    mix = load_json(BENCH_DIR, "traffic", workload["traffic"] + ".json")
    mix.update(mix_overrides or {})
    config.update(config_overrides or {})
    return Run(cell=cell, seed=int(seed), seconds=float(seconds),
               trace=bool(trace), device=device, entry=entry,
               workload=workload, config=config, mix=mix)


def require_chips(n: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoChip("no CUDA device: this benchmark runs on the card only")
    if torch.cuda.device_count() < n:
        raise NoChip(f"the cell needs {n} CUDA devices, the machine has "
                     f"{torch.cuda.device_count()}")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def execute(run: Run, t0: float) -> None:
    """Set-up, window, traced slice (``--trace 1``), peak memory, check."""
    gen = generator(run.mix["kind"])
    gen.setup(run)
    run.setup_s = time.perf_counter() - t0
    gen.window(run)
    if run.trace:
        gen.trace(run)
        if run.devtrace is None:
            raise RuntimeError("the profiler recorded no device activity "
                               "in the traced slice")
    if run.device == "cuda":
        import torch
        torch.cuda.synchronize()
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    gen.check(run)


def judge(run: Run) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit; a number without a limit
    in the workload file is an error."""
    limits = run.workload["limits"]
    missing = set(run.checks) ^ set(limits)
    if missing:
        raise KeyError(f"checks and limits differ: {sorted(missing)}")
    return {k: {"value": float(run.checks[k]), "limit": float(limits[k])}
            for k in sorted(run.checks)}


def is_correct(run: Run, checks: Dict[str, Dict[str, float]]) -> bool:
    # a NaN reading compares False, so it fails
    return run.failed == 0 and all(c["value"] <= c["limit"]
                                   for c in checks.values())


def metric_values(run: Run, bench: dict) -> Dict[str, dict]:
    out = {}
    for m in cell_metrics(bench, run.cell, run.trace):
        if m["name"] == "setup_s":
            value = run.setup_s
        else:
            value = reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_info(run: Run) -> dict:
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(run.entry["chips"]),
            "memory_peak_bytes": run.memory_peak_bytes}
    if run.trace and run.devtrace is not None:
        info["busy_s"] = run.devtrace.busy_s
        info["window_s"] = run.devtrace.window_s
    try:
        info["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return info


def result(run: Run, bench: dict) -> dict:
    checks = judge(run)
    out = {"correct": is_correct(run, checks), "attempted": run.attempted,
           "failed": run.failed, "metrics": metric_values(run, bench),
           "device": device_info(run) if run.device == "cuda" else
           {"platform": "cpu", "kind": "cpu", "count": 0,
            "memory_peak_bytes": 0}}
    if run.trace and run.devtrace is not None:
        out["breakdown"] = run.devtrace.breakdown()
    out["detail"] = run.obs.get("detail", {})
    out["checks"] = checks   # last: each compared number with its limit
    return out


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             t0: Optional[float] = None) -> dict:
    """One run on the card, as the command makes it."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = benchmark()
    run = make_run(cell, seed, seconds, trace, bench=bench)
    require_chips(int(run.entry["chips"]))
    execute(run, t0)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package were loaded: "
                           f"{found}")
    return result(run, bench)


def emit(res: dict) -> None:
    """The compared numbers as the last lines on standard error, the
    result as the last line on standard output."""
    print(f"correct {res['correct']}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)


def run_local(cell: str, seed: int, seconds: float, device: str = "cpu",
              mix_overrides: Optional[dict] = None,
              config_overrides: Optional[dict] = None,
              bench: Optional[dict] = None):
    """A run that skips the look for a chip (the tests'), its mix or
    configuration changed by the overrides (a test's size), of a cell of
    ``bench`` (default ``BENCHMARK.json``): ``(run, result)``."""
    bench = bench or benchmark()
    run = make_run(cell, seed, seconds, False, device=device,
                   mix_overrides=mix_overrides,
                   config_overrides=config_overrides, bench=bench)
    execute(run, time.perf_counter())
    return run, result(run, bench)
