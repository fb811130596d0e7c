"""The port's live monitoring service and its riders (``repro_torch.obs``):
the :class:`MonitorServer` endpoints and lifecycle, the Prometheus text
exposition, histograms, ``record_executor_stats`` over all three executor
shapes, span sampling with honest totals, and the final-scrape contract of
a session and a netopt run — the cases of the reference's
``tests/test_monitor.py`` on the port.  Parity with the reference:
``prometheus_text`` gives the same text for the same snapshot, sampling
keeps and drops the same spans for the same seed and call sequence, and
the reference's ``tools/trace_summary.py`` reads the port's sampled traces
with the dropped seconds folded back exactly.

Servers bind ``127.0.0.1:0``; every HTTP request has a timeout.
"""
import importlib.util
import json
import math
import os
import threading
import time
import urllib.error
import urllib.request

import pytest

from _torch_support import one_torch_thread  # noqa: F401  (autouse)
from repro_torch import obs
from repro_torch.compiler.cli import main as cli_main
from repro_torch.compiler.executor import (RemoteExecutor, SerialExecutor,
                                           WorkerDaemon, WorkerSpec)
from repro_torch.compiler.executor.stub import make_stub
from repro_torch.compiler.netopt import NetOptConfig, NetworkCoOptimizer
from repro_torch.compiler.oracle import SettingsOracle
from repro_torch.compiler.session import Session
from repro_torch.compiler.task import TuningTask
from repro_torch.core import mappo
from repro_torch.core.design_space import DesignSpace
from repro_torch.core.tuner import TunerConfig
from repro_torch.obs.metrics import Counter, Histogram, Metrics
from repro_torch.obs.serve import (MonitorServer, coerce_monitor,
                                   prometheus_text)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB_SPEC = WorkerSpec(factory="repro_torch.compiler.executor.stub:make_stub")
WL_BIG = dict(b=1, h=14, w=14, ci=256, co=256, kh=3, kw=3, stride=1, pad=1)
WL_MID = dict(b=1, h=28, w=28, ci=128, co=128, kh=3, kw=3, stride=1, pad=1)
TINY = TunerConfig(iteration_opt=3, b_measure=8, episodes_per_iter=2,
                   mappo=mappo.MappoConfig(n_steps=16, n_envs=8),
                   gbt_rounds=10)


def _load_tool(name):
    path = os.path.join(ROOT, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _get(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


def _get_json(url):
    status, body = _get(url)
    assert status == 200
    return json.loads(body)


def _metric_value(text, name):
    """The sample value for ``name`` in a Prometheus exposition body."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[-1])
    raise KeyError(f"{name} not in:\n{text}")


# ------------------------------------------------------- server lifecycle

def test_monitor_server_endpoints_and_lifecycle():
    srv = MonitorServer(port=0).start()
    try:
        assert srv.port > 0 and srv.running
        assert srv in obs.active_servers()
        srv.metrics.gauge("demo.g").set(3.5)
        srv.attach("demo", lambda: {"kind": "demo", "n": 7})
        status, body = _get(srv.url + "/")
        assert status == 200
        assert set(json.loads(body)["endpoints"]) == {"/metrics", "/status",
                                                      "/trace"}
        st = _get_json(srv.url + "/status")
        assert st["sources"]["demo"] == {"kind": "demo", "n": 7}
        assert st["uptime_s"] >= 0.0
        status, text = _get(srv.url + "/metrics")
        assert status == 200 and _metric_value(text, "repro_demo_g") == 3.5
        assert _get_json(srv.url + "/trace") == {"spans": []}  # no tracer
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv.url + "/nope")
        assert ei.value.code == 404
    finally:
        srv.stop()
    assert not srv.running and srv not in obs.active_servers()
    with pytest.raises(urllib.error.URLError):
        _get(srv.url + "/status", timeout=2.0)


def test_monitor_start_stop_idempotent_and_context_manager():
    with MonitorServer(port=0) as srv:
        assert srv.start() is srv  # a second start is a no-op
        assert _get_json(f"http://127.0.0.1:{srv.port}/status")[
            "sources"] == {}
    assert not srv.running
    srv.stop()  # a second stop is a no-op


def test_attach_collision_suffix_and_finalize_freezes():
    state = {"n": 1}
    collected = []
    srv = MonitorServer(port=0).start()
    try:
        a = srv.attach("run", lambda: dict(state),
                       collector=lambda m: collected.append(1))
        b = srv.attach("run", lambda: {"other": True})
        assert (a, b) == ("run", "run#2")  # a borrowed server, two runs
        state["n"] = 5
        assert srv.status_snapshot()["sources"]["run"] == {"n": 5}
        srv.metrics_text()
        n_live = len(collected)
        assert n_live >= 1  # collectors run at scrape time
        srv.finalize("run")
        state["n"] = 99  # too late: frozen at finalize
        srv.finalize("run")  # idempotent
        assert len(collected) == n_live + 1
        st = srv.status_snapshot()["sources"]
        assert st["run"] == {"n": 5, "final": True}
        assert st["run#2"] == {"other": True}  # still live
        srv.metrics_text()
        assert len(collected) == n_live + 1
    finally:
        srv.stop()


def test_broken_callbacks_never_kill_scrapes():
    def boom():
        raise RuntimeError("kaput")

    srv = MonitorServer(port=0).start()
    try:
        srv.attach("bad", boom, collector=lambda m: boom())
        srv.attach("good", lambda: {"ok": True})
        st = _get_json(srv.url + "/status")
        assert "RuntimeError" in st["sources"]["bad"]["error"]
        assert st["sources"]["good"] == {"ok": True}
        assert _get(srv.url + "/metrics")[0] == 200
    finally:
        srv.stop()


def test_coerce_monitor_owned_vs_borrowed():
    assert coerce_monitor(None) == (None, False)
    srv, owned = coerce_monitor(0)
    assert isinstance(srv, MonitorServer) and owned and not srv.running
    srv2, owned2 = coerce_monitor(srv)
    assert srv2 is srv and not owned2


# -------------------------------------------------- prometheus exposition

def _fill(m):
    m.counter("executor.remote.jobs").inc(60)
    m.counter("session.measurements").value = 17.0
    m.gauge("netopt.best_network_latency_s").set(0.0001665)
    m.gauge("serve.queue-depth").set(-2.0)
    for v in (1.0, 3.0, 2.0, 1e-7, 250.0):
        m.histogram("lat.s").observe(v)
    m.histogram("empty.h")
    return m


def test_prometheus_text_rendering_and_reference_parity():
    from repro.obs.metrics import Metrics as RefMetrics
    from repro.obs.serve import prometheus_text as ref_text
    m = Metrics()
    m.counter("executor.remote.jobs").inc(60)
    m.gauge("netopt.best_network_latency_s").set(0.0001665)
    for v in (1.0, 3.0, 2.0):
        m.histogram("lat.s").observe(v)
    text = prometheus_text(m.snapshot())
    assert "# TYPE repro_executor_remote_jobs counter" in text
    assert _metric_value(text, "repro_executor_remote_jobs") == 60
    assert _metric_value(text, "repro_netopt_best_network_latency_s") \
        == 0.0001665  # exact round-trip
    assert "# TYPE repro_lat_s summary" in text
    assert 'repro_lat_s{quantile="0.5"} 2' in text
    assert 'repro_lat_s{quantile="0.99"} 3' in text
    assert _metric_value(text, "repro_lat_s_count") == 3
    assert _metric_value(text, "repro_lat_s_sum") == 6.0
    assert prometheus_text({}) == ""
    assert prometheus_text(Metrics().snapshot()) == ""
    # the same operations in both packages -> the same snapshot and text
    port, ref = _fill(Metrics()).snapshot(), _fill(RefMetrics()).snapshot()
    assert port == ref
    assert prometheus_text(port) == ref_text(ref) == ref_text(port)


# ------------------------------------------------------ metrics edge cases

def test_histogram_quantiles_and_edge_cases():
    h = Histogram()
    assert h.snapshot() == {"count": 0, "sum": 0.0}
    assert math.isnan(h.quantile(0.5))
    h.observe(5.0)  # a single value: every quantile clamps to it
    assert h.quantile(0.0) == h.quantile(0.5) == h.quantile(1.0) == 5.0
    h2 = Histogram()
    for v in (1.0, 3.0, 2.0):
        h2.observe(v)
    assert (h2.quantile(0.5), h2.quantile(0.9), h2.quantile(0.99)) \
        == (2.0, 3.0, 3.0)
    h3 = Histogram()  # non-positive values share one underflow bucket
    for v in (-5.0, 0.0, 4.0):
        h3.observe(v)
    assert h3.quantile(0.01) == 0.0
    assert h3.quantile(1.0) == 4.0
    assert h3.snapshot()["min"] == -5.0 and h3.snapshot()["max"] == 4.0
    h4 = Histogram()
    h4.observe(-5.0)
    assert h4.quantile(0.5) == -5.0


def test_record_executor_stats_all_three_shapes():
    m = Metrics()
    serial = SerialExecutor(fn=make_stub()).stats()
    assert serial["kind"] == "serial"
    m.record_executor_stats(serial)
    m.record_executor_stats({"kind": "subprocess", "workers_alive": 2,
                             "respawns": 1, "queued": 3, "running": 2,
                             "max_inflight": 4, "jobs": 10, "failures": 2})
    m.record_executor_stats({"kind": "remote", "workers_alive": 1,
                             "respawns": 0, "queued": 0, "running": 1,
                             "max_inflight": 8, "jobs": 60, "failures": 0,
                             "endpoints": {"h:1": {"jobs": 60}}})
    snap = m.snapshot()
    for kind in ("serial", "subprocess", "remote"):
        assert f"executor.{kind}.jobs" in snap["counters"]
        assert f"executor.{kind}.workers_alive" in snap["gauges"]
    assert snap["counters"]["executor.subprocess.jobs"] == 10.0
    assert snap["counters"]["executor.remote.jobs"] == 60.0
    assert snap["gauges"]["executor.remote.max_inflight"] == 8.0
    m.record_executor_stats({"kind": "remote", "jobs": 61})  # overwrites
    assert m.snapshot()["counters"]["executor.remote.jobs"] == 61.0
    obs.NoopMetrics().record_executor_stats(serial)  # the disabled path


def test_counter_concurrent_increments_exact():
    c = Counter()
    n_threads, n_incs = 8, 5_000

    def work():
        for _ in range(n_incs):
            c.inc()

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == float(n_threads * n_incs)


# ----------------------------------------------------------- span sampling

def _sampled(tracer_cls, n=400, rate=0.25):
    tr = tracer_cls(name="s", sample_rate=rate, sample_seed=1)
    with tr.span("phase:seed", cat="phase"):
        for i in range(n):
            cat = ("measure", "dispatch", "mappo")[i % 3]
            tr.add_span_mono(cat, cat=cat, start_mono_s=float(i),
                             dur_s=1.0 + (i % 7) / 8.0)
    return tr


def test_span_sampling_exact_bookkeeping_and_reference_decisions():
    from repro.obs.trace import Tracer as RefTracer
    with pytest.raises(ValueError):
        obs.Tracer(name="bad", sample_rate=1.5)
    tr = _sampled(obs.Tracer)
    spans = tr.spans()
    assert [s for s in spans if s["cat"] == "phase"]  # never sampled
    assert len([s for s in spans if s["cat"] == "mappo"]) == 133  # nor these
    st = tr.sampling_stats()
    assert st["sample_rate"] == 0.25
    ms = st["cats"]["measure"]
    assert ms["kept"] == len([s for s in spans if s["cat"] == "measure"])
    assert ms["kept"] + ms["dropped"] == 134
    assert 0 < ms["kept"] < 134
    assert obs.Tracer(name="full").sampling_stats() == {}
    assert obs.NOOP.sampling_stats() == {}
    # the same seed and call sequence: the same spans kept and dropped
    ref = _sampled(RefTracer)
    assert ref.sampling_stats() == st
    key = lambda s: (s["name"], s["cat"], s["t"], s["dur"])  # noqa: E731
    kept = lambda tr: [key(s) for s in tr.spans()  # noqa: E731
                       if s["cat"] != "phase"]   # (timed by the clock)
    assert kept(ref) == kept(tr)


def test_sampling_honest_totals_through_both_exports(tmp_path):
    """The reference's trace_summary reads the port's sampled traces and
    folds the dropped seconds back in exactly, in both export forms."""
    ts = _load_tool("trace_summary")
    tr = obs.Tracer(name="s", sample_rate=0.25, sample_seed=1)
    with tr.span("phase:seed", cat="phase"):
        for i in range(400):
            tr.add_span_mono("measure", cat="measure",
                             start_mono_s=float(i), dur_s=1.0)
    for suffix in ("run.json", "run.jsonl"):
        path = str(tmp_path / suffix)
        tr.save(path)
        events = ts.load_events(path)
        sampling = ts.sampling_info(events)
        assert sampling["sample_rate"] == 0.25
        cats = ts.category_totals(events, sampling)
        assert cats["measure"] == pytest.approx(400.0, abs=1e-9)
        assert "sampled trace" in ts.summarize(path)
    full = obs.Tracer(name="f")
    full.add_span_mono("measure", cat="measure", start_mono_s=0.0, dur_s=2.0)
    full.event("marker", cat="phase", note=1)
    p = str(tmp_path / "full.jsonl")
    full.save(p)
    ev = ts.load_events(p)
    assert ts.sampling_info(ev) == {}
    assert ts.category_totals(ev)["measure"] == pytest.approx(2.0)


def test_recent_spans_tail_and_remote_spans_are_wall_anchored():
    tr = obs.Tracer(name="tail")
    for _ in range(50):
        with tr.span("measure", cat="measure"):
            pass
    tail = tr.recent_spans(limit=8)
    assert len(tail) == 8
    now = time.time()
    for s in tail:
        assert s["name"] == "measure" and s["dur_s"] >= 0.0
        assert abs(s["wall_s"] - now) < 60.0
    tr.add_span("measure", cat="measure", wall_start_s=now - 1.0,
                dur_s=0.5, tid="remote-h:1")
    last = tr.recent_spans(limit=1)[0]
    assert last["tid"] == "remote-h:1"
    assert last["wall_s"] == pytest.approx(now - 1.0, abs=1e-6)
    assert obs.NOOP.recent_spans() == []


# ----------------------------------------------- session + monitor wiring

def test_session_final_scrape_matches_report_borrowed_server():
    srv = MonitorServer(port=0).start()
    try:
        task = TuningTask.from_space("c", DesignSpace.for_conv2d(WL_MID),
                                     multiplicity=3)
        rep = Session(task, tuner=TINY, budget=8, seed=3, monitor=srv,
                      device="cpu").run()
        assert srv.running  # borrowed: the session must NOT stop it
        st = _get_json(srv.url + "/status")["sources"]["session"]
        assert st["final"] is True and st["kind"] == "session"
        assert st["tasks"]["c"]["best_latency"] == rep.single.best_latency
        assert st["measurements"] == rep.single.n_measurements
        assert st["oracle"]["hits"] + st["oracle"]["misses"] > 0
        _status, text = _get(srv.url + "/metrics")
        assert _metric_value(text, "repro_session_measurements") \
            == rep.single.n_measurements
        assert _metric_value(text, "repro_session_network_latency") \
            == rep.single.best_latency * 3  # exactly the report
    finally:
        srv.stop()


def test_session_owned_monitor_stops_and_reports_identical_on_off():
    before = set(obs.active_servers())
    docs = {}
    for label, monitor in (("off", None), ("on", 0)):
        task = TuningTask.from_space("c", DesignSpace.for_conv2d(WL_MID))
        doc = Session(task, tuner=TINY, budget=8, seed=5, monitor=monitor,
                      device="cpu").run().to_dict()
        doc["wall_time_s"] = 0.0
        for rep in doc["reports"].values():
            rep["wall_time_s"] = 0.0
            rep["history"] = [[n, lat, 0.0] for n, lat, _ in rep["history"]]
        docs[label] = json.dumps(doc, sort_keys=True)
    assert docs["on"] == docs["off"]
    assert set(obs.active_servers()) == before  # the owned server is gone


# -------------------------------------------- netopt acceptance, live run

def _stub_conv_tasks():
    def factory(task, records, workers=0, timeout_s=None, executor=None):
        if executor is not None:
            return SettingsOracle(task.space, fn=None, executor=executor,
                                  task=task.name, records=records,
                                  worker_spec=STUB_SPEC)
        return SettingsOracle(task.space, fn=make_stub(), task=task.name,
                              records=records)
    return [TuningTask(name="c1", space=DesignSpace.for_conv2d(WL_BIG),
                       oracle_factory=factory, multiplicity=2),
            TuningTask(name="c2", space=DesignSpace.for_conv2d(WL_MID),
                       oracle_factory=factory, multiplicity=1)]


def test_netopt_live_monitor_final_scrape_matches_report():
    """A netopt run over a loopback daemon, scraped while running, whose
    final ``/metrics`` equal the NetworkReport exactly and whose
    ``/status`` carries fleet health down to the daemon's load."""
    cfg = NetOptConfig(seed_candidates=2, hw_rounds=1, hw_per_round=1,
                       layer_budget=4, refine_budget=4, tuner=TINY)
    srv = MonitorServer(port=0).start()
    # the port's run takes ~1 s on the CPU: the daemon heartbeats often
    # enough that its load reaches the executor well within it
    daemon = WorkerDaemon(slots=2, heartbeat_s=0.05).start()
    live, stop_polling = [], threading.Event()

    def poll():
        while not stop_polling.is_set():
            try:
                live.append(_get_json(srv.url + "/status"))
            except Exception:
                pass
            time.sleep(0.05)

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    try:
        ex = RemoteExecutor(daemon.endpoint, heartbeat_s=0.1,
                            heartbeat_timeout_s=5.0, timeout_s=30.0)
        try:
            rep = NetworkCoOptimizer(_stub_conv_tasks(), cfg, remote=ex,
                                     name="obs-net", monitor=srv,
                                     device="cpu").run()
        finally:
            ex.close()
    finally:
        stop_polling.set()
        poller.join(timeout=5.0)
        daemon.stop()
    try:
        mid_run = [s["sources"]["netopt:obs-net"] for s in live
                   if "netopt:obs-net" in s.get("sources", {})
                   and not s["sources"]["netopt:obs-net"].get("final")]
        assert mid_run, "no successful /status scrape while running"
        assert all(s["kind"] == "netopt" for s in mid_run)
        _status, text = _get(srv.url + "/metrics")
        assert _metric_value(text, "repro_netopt_best_network_latency_s") \
            == rep.network_latency
        assert _metric_value(text, "repro_netopt_measurements") \
            == rep.total_measurements
        assert _metric_value(text, "repro_executor_remote_jobs") > 0
        st = _get_json(srv.url + "/status")["sources"]["netopt:obs-net"]
        assert st["final"] is True and st["phase"] == "refine"
        assert st["best_network_latency"] == rep.network_latency
        ep = st["executor"]["endpoints"][daemon.endpoint]
        assert ep["jobs"] > 0 and ep["daemon"]["busy"] == 0
    finally:
        srv.stop()


def test_worker_daemon_self_serves_status_and_metrics():
    daemon = WorkerDaemon(slots=2, heartbeat_s=0.2, status_port=0).start()
    try:
        deadline = time.monotonic() + 10.0
        while not daemon.monitor.running and time.monotonic() < deadline:
            time.sleep(0.02)
        assert daemon.monitor.running
        st = _get_json(daemon.monitor.url + "/status")["sources"]["worker"]
        assert st["kind"] == "worker" and st["endpoint"] == daemon.endpoint
        assert st["slots"] == 2 and st["load"]["jobs_done"] == 0
        ex = RemoteExecutor(daemon.endpoint, heartbeat_s=0.1,
                            heartbeat_timeout_s=5.0, timeout_s=30.0)
        try:
            handles = [ex.submit("t", {"model_axis": 1 << i},
                                 spec=STUB_SPEC) for i in range(3)]
            ex.drain(handles)
            assert all(h.result().ok for h in handles)
        finally:
            ex.close()
        _status, text = _get(daemon.monitor.url + "/metrics")
        assert _metric_value(text, "repro_worker_jobs_done") == 3
        assert _metric_value(text, "repro_worker_busy") == 0
        monitor = daemon.monitor
    finally:
        daemon.stop()
    assert not monitor.running  # stopped with the daemon


# --------------------------------------------------------- CLI smoke test

def test_cli_tune_monitor_smoke(capsys):
    """``--monitor 0``: the ephemeral server is discoverable through
    ``active_servers()``, answers a ``/status`` poll mid-run, and is gone
    after a clean exit."""
    before = set(obs.active_servers())
    rc = {}

    def run():
        # ~2 s on one CPU thread: long enough to be polled mid-run (the
        # port's session at budget 4 ends in milliseconds)
        rc["v"] = cli_main(["tune", "--matmul", "256x256x256", "--budget",
                            "192", "--monitor", "0", "--device", "cpu"])

    th = threading.Thread(target=run)
    th.start()
    srv = None
    try:
        deadline = time.monotonic() + 60.0
        while srv is None and time.monotonic() < deadline:
            fresh = [s for s in obs.active_servers() if s not in before]
            if fresh:
                srv = fresh[0]
            elif not th.is_alive():
                break
            else:
                time.sleep(0.01)
        assert srv is not None, "--monitor 0 never started a server"
        st = _get_json(srv.url + "/status")
        assert st["sources"]["session"]["kind"] == "session"
        assert "repro_session_measurements" in _get(srv.url + "/metrics")[1]
    finally:
        th.join(timeout=120.0)
    capsys.readouterr()
    assert rc.get("v") == 0 and not th.is_alive()
    assert set(obs.active_servers()) == before
