"""The port's bench drivers (``repro_torch.benchmarks``, ``repro_torch.tools.
make_tables``) against the reference's (``benchmarks/*.py``,
``tools/make_tables.py``, loaded by path as ``tests/test_zoo_transfer.py``
loads them).

On one synthetic sweep the two packages print identical figure rows;
they extract the same tasks in the same order and build equal tuner
configs; their roofline rows and tables agree on one set of dry-run
artifacts; their bench documents are interchangeable, carry the same
metric names as the committed reference artifacts, and the stdlib tools
(``bench_compare``, ``trace_summary``, ``trace_diff``) read the port's
files.  Every run here is on the CPU at the smallest budgets."""
import dataclasses
import glob
import importlib.util
import io
import json
import math
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from _torch_support import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.benchmarks import measure_throughput as MT
from repro_torch.benchmarks import run as RUN
from repro_torch.benchmarks import serve_runs as SR
from repro_torch.benchmarks import transfer_runs as XR
from repro_torch.benchmarks import tuning_runs as TR
from repro_torch.tools import make_tables as MK

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    """The reference's drivers and tools, loaded by path (their sibling
    imports resolve through ``benchmarks/`` and the repo root)."""
    added = [p for p in (os.path.join(ROOT, "benchmarks"), ROOT)
             if p not in sys.path]
    sys.path[:0] = added
    try:
        mods = {name: _load(os.path.join(ROOT, "benchmarks", f"{name}.py"),
                            name)
                for name in ("tuning_runs", "transfer_runs", "serve_runs",
                             "measure_throughput")}
        mods["run"] = _load(os.path.join(ROOT, "benchmarks", "run.py"),
                            "reference_bench_run")
        for name in ("bench_compare", "trace_summary", "trace_diff"):
            mods[name] = _load(os.path.join(ROOT, "tools", f"{name}.py"),
                               name)
        yield mods
    finally:
        for p in added:
            sys.path.remove(p)


def _synthetic_sweep(seed: int = 0):
    """A sweep dict over every unique task: per framework a best latency,
    a tuning wall time and a falling history, drawn from the seed."""
    rng = np.random.default_rng(seed)
    tasks = {}
    for key, task in TR.unique_tasks().items():
        entry = {"workload": task.space.workload}
        for fw in TR.FRAMEWORKS:
            n = int(rng.integers(8, 40))
            bests = np.minimum.accumulate(rng.uniform(1e-5, 1e-3, n))
            entry[fw] = {
                "best_latency": float(bests[-1]),
                "wall_time_s": float(rng.uniform(0.5, 20.0)),
                "n_measurements": n + int(rng.integers(0, 4)),
                "history": [[i + 1, float(b), 0.1 * (i + 1)]
                            for i, b in enumerate(bests)]}
        tasks[key] = entry
    return {"tasks": tasks, "config": {"schema": TR.SWEEP_SCHEMA}}


def _rows(module, fn, *args):
    module.ROWS.clear()
    with redirect_stdout(io.StringIO()):
        fn(*args)
    return list(module.ROWS)


def test_unique_tasks_match_reference(ref):
    want = ref["tuning_runs"].unique_tasks()
    got = TR.unique_tasks()
    assert list(got) == list(want)
    for key in want:
        assert got[key].space.workload == want[key].space.workload
        assert got[key].multiplicity == want[key].multiplicity
    assert TR.NETWORKS == ref["tuning_runs"].NETWORKS
    assert TR.FRAMEWORKS == ref["tuning_runs"].FRAMEWORKS


@pytest.mark.parametrize("bench", ["table6", "fig5", "fig6", "fig7"])
def test_figure_rows_match_reference_on_one_sweep(ref, bench):
    sweep = _synthetic_sweep()
    assert (TR.network_results(sweep)
            == ref["tuning_runs"].network_results(sweep))
    fn = f"bench_{bench}"
    want = _rows(ref["run"], getattr(ref["run"], fn), sweep)
    got = _rows(RUN, getattr(RUN, fn), sweep)
    assert want and got == want


@pytest.mark.parametrize("name", ["tuner_config", "hetero_tuner_config"])
def test_tuner_configs_match_reference(ref, name):
    want = dataclasses.asdict(getattr(ref["tuning_runs"], name)())
    got = dataclasses.asdict(getattr(TR, name)())
    assert got == want


def test_transfer_configs_match_reference(ref):
    assert (dataclasses.asdict(XR.bench_tuner())
            == dataclasses.asdict(ref["transfer_runs"].bench_tuner()))
    assert (dataclasses.asdict(XR.bench_netcfg(12, 0))
            == dataclasses.asdict(ref["transfer_runs"].bench_netcfg(12, 0)))
    assert XR.DEFAULT_PAIRS == ref["transfer_runs"].DEFAULT_PAIRS


def test_distinct_configs_match_reference(ref):
    from repro.core.shard_space import ShardSpace as RefSpace
    from repro_torch.core.shard_space import ShardSpace
    want = ref["measure_throughput"].distinct_configs(
        RefSpace.for_cell("qwen2-1.5b", "train_4k", None, n_devices=256), 40)
    got = MT.distinct_configs(
        ShardSpace.for_cell("qwen2-1.5b", "train_4k", None, n_devices=256),
        40)
    np.testing.assert_array_equal(got, want)
    assert len({tuple(r) for r in got}) == 40


def _write_artifacts(d):
    """Dry-run artifacts in the port's layout: two ok pod cells, an ok
    multipod cell and a skipped one."""
    os.makedirs(d, exist_ok=True)
    cells = [("qwen2-1.5b", "train_4k", "pod_16x16", "data=16 x model=16",
              6.04e13, 3.1e9),
             ("smollm-360m", "decode_32k", "pod_16x16",
              "data=16 x model=16", 2.2e10, 4.4e7),
             ("qwen2-1.5b", "train_4k", "multipod_2x16x16",
              "pod=2 x data=16 x model=16", 3.02e13, 2.9e9)]
    for i, (arch, shape, mesh, desc, flops, wire) in enumerate(cells):
        art = {"arch": arch, "shape": shape, "mesh": mesh,
               "mesh_desc": desc, "kind": "train", "status": "ok",
               "weighted": {"dot_flops_per_device": flops,
                            "collective_bytes_by_op": {},
                            "wire_bytes_per_device": wire},
               "param_bytes_global": 3.55e9 * (i + 1),
               "temp_size_in_bytes": 7.5e9 / (i + 1),
               "argument_size_in_bytes": 1.0e9,
               "compile_s": 2.4 * (i + 1)}
        with open(os.path.join(d, f"{arch}__{shape}__{mesh}.json"),
                  "w") as f:
            json.dump(art, f)
    with open(os.path.join(d, "qwen2-1.5b__long_500k__pod_16x16.json"),
              "w") as f:
        json.dump({"arch": "qwen2-1.5b", "shape": "long_500k",
                   "mesh": "pod_16x16", "mesh_desc": "data=16 x model=16",
                   "status": "skipped", "reason": "full attention"}, f)
    return d


def _numbers(row):
    return [float(x) for x in re.findall(r"-?\d+\.\d+(?:e[-+]\d+)?", row)]


def test_roofline_rows_match_reference(ref, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_DRYRUN_ART",
                       _write_artifacts(str(tmp_path / "art")))
    want = _rows(ref["run"], ref["run"].bench_roofline)
    got = _rows(RUN, RUN.bench_roofline)
    assert len(want) == 3 and len(got) == len(want)
    for g, w in zip(got, want):
        assert g.split(",")[0] == w.split(",")[0]
        assert re.sub(r"[-\d.e+]+", "#", g) == re.sub(r"[-\d.e+]+", "#", w)
        for a, b in zip(_numbers(g), _numbers(w)):
            assert abs(a - b) <= 1e-6 * max(abs(b), 1e-30), (g, w)
    monkeypatch.setenv("REPRO_DRYRUN_ART", str(tmp_path / "absent"))
    assert _rows(RUN, RUN.bench_roofline) == [
        f"roofline.skipped,0.000,no artifacts under {tmp_path / 'absent'}"]


def test_make_tables_matches_reference(tmp_path):
    art = _write_artifacts(str(tmp_path / "art"))
    want = subprocess.run(
        [sys.executable, os.path.join("tools", "make_tables.py"), art],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    assert want.returncode == 0, want.stderr
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert MK.main([art]) == 0
    assert buf.getvalue() == want.stdout


def test_make_tables_says_a_field_is_missing(tmp_path):
    art = _write_artifacts(str(tmp_path / "art"))
    path = os.path.join(art, "qwen2-1.5b__train_4k__pod_16x16.json")
    with open(path) as f:
        doc = json.load(f)
    del doc["temp_size_in_bytes"], doc["compile_s"]
    with open(path, "w") as f:
        json.dump(doc, f)
    buf = io.StringIO()
    with redirect_stdout(buf):
        MK.main([art])
    row = [line for line in buf.getvalue().splitlines()
           if line.startswith("| qwen2-1.5b | train_4k | pod_16x16 |")][0]
    assert "missing: temp_size_in_bytes" in row
    assert "missing: compile_s" in row
    assert "6.04e+13" in row


def _doc(tmp_path, name="BENCH_torch_x.json"):
    with redirect_stdout(io.StringIO()):
        return TR.write_bench_artifact(
            str(tmp_path / name), "x",
            {"lat_s": 1.5e-3, "n": 4, "phase_times": {"a": 0.5}},
            config={"package": TR.PACKAGE, "device": "cpu"})


def test_bench_documents_are_interchangeable(ref, tmp_path):
    doc = _doc(tmp_path)
    with open(tmp_path / "BENCH_torch_x.json") as f:
        on_disk = json.load(f)
    assert on_disk == doc and doc["schema"] == "repro-bench/2"
    assert ref["tuning_runs"].validate_bench_doc(on_disk) is on_disk
    assert ref["bench_compare"].validate(on_disk) is on_disk
    committed = sorted(p for p in glob.glob(os.path.join(ROOT, "BENCH_*.json"))
                       if not os.path.basename(p).startswith("BENCH_torch_"))
    assert len(committed) >= 4
    for path in committed:
        with open(path) as f:
            d = json.load(f)
        assert TR.validate_bench_doc(d) is d, path
    # the reference's bench_compare diffs a port document against one
    with redirect_stdout(io.StringIO()):
        rc = ref["bench_compare"].main([str(tmp_path / "BENCH_torch_x.json"),
                                        str(tmp_path / "BENCH_torch_x.json")])
    assert rc == 0


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), "fast",
                                 {"nested": 1.0}])
def test_a_bad_metric_writes_nothing(tmp_path, bad):
    path = str(tmp_path / "BENCH_torch_bad.json")
    with pytest.raises((ValueError, TypeError)):
        TR.write_bench_artifact(path, "x", {"m": bad}, config={})
    assert not os.path.exists(path)


def _committed_metrics(name):
    with open(os.path.join(ROOT, f"BENCH_{name}.json")) as f:
        return json.load(f)["metrics"]


def test_netopt_and_hetero_metric_names_match_reference_artifacts():
    with redirect_stdout(io.StringIO()):
        net = TR.netopt_bench(layer_budget=2, refine_budget=0, device="cpu")
        het = TR.hetero_bench(layer_budget=2, refine_budget=0, device="cpu")
    for got, name in ((net, "netopt"), (het, "hetero")):
        got.pop("budget_per_layer")     # main moves it into the config
        # the committed documents predate the /2 phase_times block
        assert isinstance(got.pop("phase_times"), dict)
        assert set(got) == set(_committed_metrics(name)), name
        assert all(math.isfinite(v) for v in got.values())


def test_transfer_pair_metric_names_and_replay(tmp_path):
    pair = "pod-cells-4b->pod-cells"
    with redirect_stdout(io.StringIO()):
        got = XR.transfer_pair("pod-cells-4b", "pod-cells",
                               XR.bench_netcfg(2, 0), str(tmp_path), 2,
                               device="cpu")
    want = {k.split("/", 1)[1] for k in _committed_metrics("transfer")
            if k.startswith(pair + "/")}
    assert set(got) == want
    assert got["warm_self_new_measurements"] == 0
    assert got["transfer_warm_hw_rows"] > 0


def test_serve_bench_metric_names_and_headlines(tmp_path):
    out = str(tmp_path / "BENCH_torch_serve.json")
    with redirect_stdout(io.StringIO()):
        assert SR.main(["--requests", "20000", "--budget", "8",
                        "--tune-after-s", "20", "--json-out", out,
                        "--device", "cpu"]) == 0
    with open(out) as f:
        doc = json.load(f)
    assert set(doc["metrics"]) == set(_committed_metrics("serve"))
    m = doc["metrics"]
    assert m["served_requests"] == 20000
    assert m["online_offline_min_ratio"] >= 0.9
    assert m["after_p99_latency_s"] < m["before_p99_latency_s"]
    assert doc["config"]["device"] == "cpu"
    assert doc["config"]["package"] == "repro_torch"


def test_sweep_cache_of_another_package_is_retuned(tmp_path, monkeypatch):
    from repro_torch.core import mappo
    from repro_torch.core.tuner import TunerConfig
    key, task = next(iter(TR.unique_tasks().items()))
    monkeypatch.setattr(TR, "ART", str(tmp_path))
    monkeypatch.setattr(TR, "unique_tasks", lambda: {key: task})
    monkeypatch.setattr(TR, "tuner_config", lambda: TunerConfig(
        iteration_opt=2, b_measure=2, episodes_per_iter=1,
        mappo=mappo.MappoConfig(n_steps=4, n_envs=4), gbt_rounds=2))
    path = tmp_path / "sweep_default.json"
    foreign = {"tasks": {key: {"stale": True}},
               "config": {"budget": 256, "paper": False,
                          "schema": TR.SWEEP_SCHEMA}}
    path.write_text(json.dumps(foreign))
    buf = io.StringIO()
    with redirect_stdout(buf):
        sweep = TR.run_sweep(device="cpu")
    assert "re-tuning" in buf.getvalue()
    assert sweep["config"]["package"] == "repro_torch"
    assert sweep["config"]["device"] == "cpu"
    assert set(sweep["tasks"][key]) == {"workload", *TR.FRAMEWORKS}
    assert TR.run_sweep(device="cpu") == json.loads(path.read_text())


@pytest.mark.parametrize("entry,argv", [
    (TR.main, ["--json-out", "never.json"]),
    (XR.main, ["--json-out", "never.json"]),
    (SR.main, ["--requests", "10"]),
    (RUN.main, ["fig4"])])
def test_drivers_default_to_cuda_and_raise_without_it(entry, argv, tmp_path,
                                                      monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(argv)
    assert not os.path.exists(tmp_path / "never.json")


def _measure_throughput(tmp_path, *argv):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.measure_throughput",
         "--delay", "0.01", "--n", "8", *argv],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=SRC),
        capture_output=True, text=True, timeout=180)


def test_measure_throughput_pools_and_remote_fleet(ref, tmp_path):
    out = _measure_throughput(tmp_path, "--workers", "1,2", "--json",
                              str(tmp_path / "t.json"))
    assert out.returncode == 0, out.stderr
    runs = json.loads((tmp_path / "t.json").read_text())["runs"]
    assert [r["backend"] for r in runs] == ["serial", "subprocess[1]",
                                            "subprocess[2]"]
    bench = str(tmp_path / "BENCH_torch_remote.json")
    out = _measure_throughput(tmp_path, "--remote", "1", "--bench-json",
                              bench)
    assert out.returncode == 0, out.stderr
    assert "remote[1]" in out.stdout
    with open(bench) as f:
        doc = json.load(f)
    assert ref["bench_compare"].validate(doc) is doc
    assert set(doc["metrics"]) == {"serial_meas_per_s",
                                   "remote1_meas_per_s",
                                   "remote1_speedup_vs_serial"}
    assert doc["config"]["transport"] == "tcp-loopback"
    bad = _measure_throughput(tmp_path, "--bench-json", bench)
    assert bad.returncode == 2 and "needs" in bad.stderr


def test_trace_tools_read_port_traces(ref, tmp_path):
    from repro_torch.compiler import Session, TuningTask
    from repro_torch.core.tuner import TunerConfig
    tasks = TuningTask.conv_tasks("resnet-18")[:2]
    paths = []
    for i in range(2):
        path = str(tmp_path / f"run{i}.trace.json")
        Session(tasks, tuner=TunerConfig.fast(), budget=2, trace=path,
                device="cpu").run()
        paths.append(path)
    for tool, argv in (("trace_summary", paths[:1]), ("trace_diff", paths)):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert ref[tool].main(argv) == 0, tool
        assert "measure" in buf.getvalue(), tool


def _port_doc(name):
    with open(os.path.join(ROOT, f"BENCH_torch_{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["netopt", "hetero", "transfer", "serve",
                                  "remote"])
def test_committed_port_documents(ref, name):
    """Each committed port document is valid for both packages' validators,
    names the port, came from a git checkout and, but for the stub-only
    remote bench, from a CUDA card; its metric names are the reference
    artifact's (phase_times aside: the reference's older documents predate
    it; a transfer pair's saving fraction exists only where the transfer
    reached the cold best, in either package)."""
    doc = _port_doc(name)
    assert TR.validate_bench_doc(doc) is doc
    assert ref["tuning_runs"].validate_bench_doc(doc) is doc
    assert ref["bench_compare"].validate(doc) is doc
    assert doc["git_rev"] != "unknown"
    assert doc["config"]["package"] == "repro_torch"
    if name != "remote":
        assert doc["config"]["device"].startswith("NVIDIA")
    def names(metrics):
        return {k for k in metrics if k != "phase_times"
                and not k.endswith("/transfer_measurement_saving_frac")}
    assert names(doc["metrics"]) == names(_committed_metrics(name))


def test_committed_port_documents_show_the_headlines():
    """The headline each reference artifact is committed for, on the
    port's own documents from the card."""
    m = _port_doc("netopt")["metrics"]
    assert m["coopt_network_latency_s"] <= m["hw_frozen_network_latency_s"]
    m = _port_doc("hetero")["metrics"]
    assert m["k2_network_latency_s"] < m["k1_network_latency_s"]
    assert m["k2_network_latency_s"] < m["genetic_network_latency_s"]
    assert 0 < m["k2_cut"] < 12
    m = _port_doc("transfer")["metrics"]
    pair = "pod-cells-4b->pod-cells/"
    assert m[pair + "warm_self_new_measurements"] == 0
    assert 0 <= m[pair + "transfer_measurements_to_cold_best"] \
        < m[pair + "cold_measurements_to_best"]
    m = _port_doc("serve")["metrics"]
    assert m["served_requests"] == 1_000_000
    assert m["online_offline_min_ratio"] >= 0.9
    assert m["sla_violation_pct"] < 3.0
    assert m["after_p99_latency_s"] < m["before_p99_latency_s"]
    assert m["after_tokens_per_sec"] > m["before_tokens_per_sec"]
    m = _port_doc("remote")["metrics"]
    assert m["remote4_speedup_vs_serial"] > m["remote1_speedup_vs_serial"]
