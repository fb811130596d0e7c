"""The port's remote measurement fabric: the wire protocol, the worker
daemon and ``RemoteExecutor`` (``repro_torch.compiler.executor.{wire,
worker,remote}``) — the cases of the reference's
``tests/test_remote_executor.py`` on the port, plus the contract that the
two packages share one wire: ``encode_frame`` gives the same bytes for the
same messages, and a port executor served by a reference daemon (and the
reverse) measures the same stub values.

Daemons bind ``127.0.0.1:0``; every executor gets test-speed heartbeats
and reconnect backoffs, and every blocking wait has its own bound.
"""
import dataclasses
import json
import threading
import time

import pytest

from _torch_support import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.compiler.executor import (RemoteExecutor, SerialExecutor,
                                           SubprocessExecutor, WorkerDaemon,
                                           WorkerSpec, parse_endpoints,
                                           spawn_daemon)
from repro_torch.compiler.executor.stub import make_stub, stub_latency
from repro_torch.compiler.executor.wire import (PROTOCOL_VERSION,
                                                FrameBuffer, ProtocolError,
                                                WorkerCapabilities,
                                                device_count_pin,
                                                encode_frame,
                                                spec_compatible, spec_to_wire)
from repro_torch.compiler.oracle import Oracle, SettingsOracle
from repro_torch.compiler.session import Session, SessionReport
from repro_torch.compiler.task import TuningTask
from repro_torch.core import mappo
from repro_torch.core.design_space import DesignSpace
from repro_torch.core.shard_space import ShardSpace
from repro_torch.core.tuner import TunerConfig

STUB = "repro_torch.compiler.executor.stub:make_stub"
REF_STUB = "repro.compiler.executor.stub:make_stub"
STUB_SPEC = WorkerSpec(factory=STUB)
HANG_COND = {"sequence_parallel": True}  # knob 6 -> SP on
TINY = TunerConfig(iteration_opt=2, b_measure=4, episodes_per_iter=2,
                   mappo=mappo.MappoConfig(n_steps=16, n_envs=8),
                   gbt_rounds=8, seed=1)


@pytest.fixture(scope="module")
def space():
    return ShardSpace.for_cell("qwen2-1.5b", "train_4k", None, n_devices=256)


def _fast_executor(endpoints, **kw):
    """RemoteExecutor with test-speed fault knobs."""
    kw.setdefault("heartbeat_s", 0.1)
    kw.setdefault("heartbeat_timeout_s", 1.0)
    kw.setdefault("reconnect_backoff_s", 0.05)
    kw.setdefault("max_backoff_s", 0.2)
    kw.setdefault("startup_grace_s", 5.0)
    kw.setdefault("timeout_s", 30.0)
    return RemoteExecutor(endpoints, **kw)


# ------------------------------------------------------------ wire protocol

MESSAGES = [
    {"type": "hello", "version": 1, "minor": 1},
    {"type": "job", "job_id": 7, "task": "t", "settings": {"a": 1,
                                                           "fsdp": True},
     "spec": {"factory": STUB, "args": [], "kwargs": {"delay_s": 0.1},
              "env": {}}},
    {"type": "started", "job_id": 7},
    {"type": "result", "job_id": 7, "ok": True, "value": 0.25,
     "span": {"name": "measure", "cat": "measure", "t_wall": 1.5,
              "dur_s": 0.1, "task": "t"}},
    {"type": "result", "job_id": 8, "ok": False, "error": "Boom: ünïcode"},
    {"type": "heartbeat", "load": {"busy": 0, "jobs_done": 3,
                                   "mean_measure_s": None}},
    {"type": "shutdown", "scope": "daemon"},
]


def test_frames_byte_equal_to_the_reference():
    from repro.compiler.executor import wire as ref_wire
    from repro.compiler.executor.base import WorkerSpec as RefSpec
    assert ref_wire.PROTOCOL_VERSION == PROTOCOL_VERSION
    for msg in MESSAGES:
        assert encode_frame(msg) == ref_wire.encode_frame(msg)
    caps = WorkerCapabilities(slots=2, backend="cuda", device_count=1,
                              env={"CUDA_VISIBLE_DEVICES": "0"}, pid=4,
                              host="h")
    ref_caps = ref_wire.WorkerCapabilities(**dataclasses.asdict(caps))
    assert encode_frame(caps.to_wire()) == \
        ref_wire.encode_frame(ref_caps.to_wire())
    spec = WorkerSpec(factory=STUB, args=(1,), kwargs={"delay_s": 0.1},
                      env={"A": "1"})
    ref_spec = RefSpec(factory=STUB, args=(1,), kwargs={"delay_s": 0.1},
                       env={"A": "1"})
    assert encode_frame(spec_to_wire(spec)) == \
        ref_wire.encode_frame(ref_wire.spec_to_wire(ref_spec))
    assert spec.cache_key() == ref_spec.cache_key()


def test_frame_roundtrip_survives_arbitrary_chunking():
    blob = b"".join(encode_frame(m) for m in MESSAGES)
    for chunk in (1, 2, 3, len(blob)):  # byte-dribble through re-framing
        buf = FrameBuffer()
        out = []
        for i in range(0, len(blob), chunk):
            out.extend(buf.feed(blob[i:i + chunk]))
        assert out == MESSAGES


def test_frame_buffer_rejects_garbage():
    with pytest.raises(ProtocolError):  # announced length beyond the cap
        FrameBuffer().feed(b"\xff\xff\xff\xff")
    bad = encode_frame({"type": "x"})[:4] + b'{"type": brok'
    with pytest.raises(ProtocolError):
        FrameBuffer().feed(bad[:4] + b"x" * (len(bad) - 4))


def test_parse_endpoints_forms():
    assert parse_endpoints("h1:10,h2:11") == [("h1", 10), ("h2", 11)]
    assert parse_endpoints(["a:1", "b:2"]) == [("a", 1), ("b", 2)]
    assert parse_endpoints(":5000") == [("127.0.0.1", 5000)]
    assert parse_endpoints("[::1]:9") == [("::1", 9)]
    for bad in ("nocolon", ""):
        with pytest.raises(ValueError):
            parse_endpoints(bad)


def test_capabilities_version_mismatch_is_loud():
    caps = WorkerCapabilities(slots=2, backend="cpu", device_count=4)
    wire = caps.to_wire()
    assert WorkerCapabilities.from_wire(wire).device_count == 4
    wire["version"] = PROTOCOL_VERSION + 1
    with pytest.raises(ProtocolError, match="version"):
        WorkerCapabilities.from_wire(wire)


def test_spec_compatibility_routes_on_device_pin():
    pin4 = WorkerSpec(factory=STUB, env={
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    assert device_count_pin(pin4.env) == 4
    assert spec_compatible(pin4, WorkerCapabilities(device_count=4))
    assert not spec_compatible(pin4, WorkerCapabilities(device_count=2))
    assert spec_compatible(pin4, WorkerCapabilities(device_count=None))
    assert spec_compatible(STUB_SPEC, WorkerCapabilities(device_count=8))
    assert spec_compatible(None, WorkerCapabilities(device_count=8))
    cuda0 = WorkerSpec(factory=STUB, env={"CUDA_VISIBLE_DEVICES": "0"})
    assert not spec_compatible(cuda0, WorkerCapabilities(
        env={"CUDA_VISIBLE_DEVICES": "1"}))


# ----------------------------------------------------- daemon round-trips

def test_remote_executor_round_trip_and_stats():
    daemon = WorkerDaemon(slots=2).start()
    try:
        ex = _fast_executor(daemon.endpoint)
        settings = [{"model_axis": 1 << i} for i in range(6)]
        handles = [ex.submit("t", s, spec=STUB_SPEC) for s in settings]
        ex.drain(handles)
        for s, h in zip(settings, handles):
            assert h.result().ok and h.result().value == stub_latency(s)
        st = ex.stats()
        assert st["kind"] == "remote" and st["jobs"] == 6
        assert st["failures"] == 0 and st["workers_alive"] == 2
        (ep,) = st["endpoints"].values()
        assert ep["jobs"] == 6 and ep["reconnects"] == 0
        assert ep["mean_ack_to_result_s"] >= 0.0
        ex.close()
    finally:
        daemon.stop()


def test_measure_fn_exception_and_missing_spec_are_failures():
    daemon = WorkerDaemon().start()
    try:
        ex = _fast_executor(daemon.endpoint)
        bad = ex.submit("t", {"fsdp": True}, spec=WorkerSpec(
            factory=STUB, kwargs={"fail_when": {"fsdp": True}}))
        good = ex.submit("t", {"model_axis": 2}, spec=STUB_SPEC)
        nospec = ex.submit("t", {"x": 1})
        ex.drain([bad, good, nospec])
        assert not bad.result().ok
        assert "stub measurement failed" in bad.result().error
        assert good.result().ok  # the daemon survived the raise
        assert "NoWorkerSpec" in nospec.result().error
        assert ex.stats()["reconnects"] == 0
        ex.close()
    finally:
        daemon.stop()


def test_unreachable_fleet_raises_at_construction():
    with pytest.raises(ConnectionError, match="no worker daemon reachable"):
        RemoteExecutor("127.0.0.1:1", connect_timeout_s=0.5)
    with pytest.raises(ValueError, match="duplicate"):
        RemoteExecutor("h:1,h:1")


def test_heterogeneous_routing_by_device_count():
    d2 = WorkerDaemon(slots=1, device_count=2).start()
    d4 = WorkerDaemon(slots=1, device_count=4).start()
    try:
        ex = _fast_executor([d2.endpoint, d4.endpoint])

        def pin(n):
            return WorkerSpec(factory=STUB, env={
                "XLA_FLAGS": f"--xla_force_host_platform_device_count={n}"})
        h2 = [ex.submit("t", {"i": i, "model_axis": 2}, spec=pin(2))
              for i in range(3)]
        h4 = [ex.submit("t", {"i": i, "model_axis": 4}, spec=pin(4))
              for i in range(3)]
        ex.drain(h2 + h4)
        assert all(h.result().ok for h in h2 + h4)
        st = ex.stats()["endpoints"]
        assert st[d2.endpoint]["jobs"] == 3  # pinned jobs never cross over
        assert st[d4.endpoint]["jobs"] == 3
        h8 = ex.submit("t", {"model_axis": 8}, spec=pin(8))
        assert "NoCompatibleWorker" in h8.result().error
        ex.close()
    finally:
        d2.stop()
        d4.stop()


# --------------------------------------------- the wire across packages

def test_port_executor_on_reference_daemon_and_reverse():
    """A port ``RemoteExecutor`` served by a reference daemon, and a
    reference executor served by a port daemon (spawned through its
    ``python -m`` entry point): the same stub values either way."""
    from repro.compiler.executor import RemoteExecutor as RefRemote
    from repro.compiler.executor import WorkerDaemon as RefDaemon
    from repro.compiler.executor import WorkerSpec as RefSpec
    settings = [{"model_axis": 1 << i, "fsdp": bool(i % 2)}
                for i in range(5)]
    want = [stub_latency(s) for s in settings]
    ref_daemon = RefDaemon(slots=2).start()
    try:
        ex = _fast_executor(ref_daemon.endpoint)
        hs = [ex.submit("t", s, spec=WorkerSpec(factory=REF_STUB))
              for s in settings]
        ex.drain(hs)
        assert [h.result().value for h in hs] == want
        ex.close()
    finally:
        ref_daemon.stop()
    proc, endpoint = spawn_daemon(slots=2, timeout_s=60.0)
    try:
        ref_ex = RefRemote(endpoint, heartbeat_s=0.1,
                           heartbeat_timeout_s=5.0, timeout_s=30.0)
        hs = [ref_ex.submit("t", s, spec=RefSpec(factory=STUB))
              for s in settings]
        ref_ex.drain(hs)
        assert [h.result().value for h in hs] == want
        assert ref_ex.stats()["endpoints"][endpoint]["jobs"] == 5
        ref_ex.close()
    finally:
        proc.terminate()
        proc.wait(timeout=10)


# -------------------------------------------------------- loopback parity

def _remote_task(space, name, endpoint=None, subprocess_workers=0):
    def factory(task, records, workers=0, timeout_s=None):
        if endpoint is not None:
            ex = _fast_executor(endpoint)
        elif subprocess_workers:
            ex = SubprocessExecutor(WorkerSpec(factory=STUB),
                                    workers=subprocess_workers,
                                    timeout_s=30.0)
        else:
            return SettingsOracle(space, fn=make_stub(), task=task.name,
                                  records=records)
        return SettingsOracle(space, fn=None, executor=ex,
                              own_executor=True, task=task.name,
                              records=records, worker_spec=STUB_SPEC)
    return TuningTask(name=name, space=space, oracle_factory=factory)


def test_loopback_parity_with_subprocess_pool(space):
    """One loopback daemon at a fixed seed gives a session report
    identical to ``SubprocessExecutor(workers=1)``'s once wall times and
    transport stats are masked."""
    cfg = TunerConfig(iteration_opt=2, b_measure=6, episodes_per_iter=2,
                      mappo=mappo.MappoConfig(n_steps=16, n_envs=8),
                      gbt_rounds=8, seed=3)
    daemon = WorkerDaemon().start()
    try:
        docs = {}
        for label, task in (
                ("remote", _remote_task(space, "det",
                                        endpoint=daemon.endpoint)),
                ("subprocess", _remote_task(space, "det",
                                            subprocess_workers=1))):
            doc = Session(task, tuner=cfg, budget=12,
                          device="cpu").run().to_dict()
            doc["wall_time_s"] = 0.0
            doc["executor_stats"] = {}
            for rep in doc["reports"].values():
                rep["wall_time_s"] = 0.0
                rep["history"] = [[n, lat, 0.0]
                                  for n, lat, _ in rep["history"]]
            docs[label] = json.dumps(doc, sort_keys=True)
        assert docs["remote"] == docs["subprocess"]
    finally:
        daemon.stop()


def test_session_remote_kwarg_runs_and_records_stats(space):
    daemon = WorkerDaemon(slots=2).start()
    try:
        def factory(task, records, workers=0, timeout_s=None, executor=None):
            return SettingsOracle(space, fn=None, executor=executor,
                                  task=task.name, records=records,
                                  worker_spec=STUB_SPEC)

        task = TuningTask(name="rk", space=space, oracle_factory=factory)
        sr = Session(task, tuner=TINY, budget=8, remote=daemon.endpoint,
                     timeout_s=30.0, device="cpu").run()
        assert sr.executor_stats["kind"] == "remote"
        assert sr.executor_stats["jobs"] >= 8
        assert daemon.endpoint in sr.executor_stats["endpoints"]
        rt = SessionReport.from_dict(json.loads(json.dumps(sr.to_dict())))
        assert rt.executor_stats["jobs"] == sr.executor_stats["jobs"]
    finally:
        daemon.stop()
    with pytest.raises(ValueError, match="mutually exclusive"):
        Session(_remote_task(space, "x"), remote="h:1", workers=2,
                device="cpu")


# --------------------------------------------------------- fault semantics

def test_daemon_killed_mid_batch_fails_inflight_then_fleet_down():
    daemon = WorkerDaemon(slots=2).start()
    ex = _fast_executor(daemon.endpoint, max_reconnects=2, timeout_s=None)
    slow = WorkerSpec(factory=STUB, kwargs={"delay_s": 30.0})
    handles = [ex.submit("t", {"i": i}, spec=slow) for i in range(2)]
    time.sleep(0.3)  # let both jobs start on the daemon
    daemon.stop()  # the connection dies mid-measurement
    extra = ex.submit("t", {"i": 9}, spec=slow)  # queued, never served
    ex.drain(handles + [extra])
    for h in handles:
        assert not h.result().ok and "WorkerCrash" in h.result().error
    assert "FleetDown" in extra.result().error
    assert ex.stats()["failures"] >= 2
    ex.close()


def test_restarted_daemon_rejoins_and_jobs_flow():
    daemon = WorkerDaemon().start()
    port = daemon.address[1]
    ex = _fast_executor(daemon.endpoint, max_reconnects=50)
    assert ex.submit("t", {"model_axis": 2}, spec=STUB_SPEC).result().ok
    daemon.stop()
    deadline = time.monotonic() + 10.0  # wait for the EOF to be noticed
    while ex.stats()["endpoints"][ex._eps[0].label]["connected"]:
        assert time.monotonic() < deadline
        ex.poll()
        time.sleep(0.01)
    daemon2 = WorkerDaemon(port=port).start()  # same endpoint, new daemon
    try:
        assert ex.submit("t", {"model_axis": 4}, spec=STUB_SPEC).result().ok
        st = ex.stats()
        assert st["reconnects"] >= 1
        assert st["endpoints"][ex._eps[0].label]["reconnects"] >= 1
        ex.close()
    finally:
        daemon2.stop()


def test_timeout_counted_from_started_ack_drops_connection():
    daemon = WorkerDaemon().start()
    try:
        ex = _fast_executor(daemon.endpoint, timeout_s=0.4,
                            max_reconnects=50)
        hang = WorkerSpec(factory=STUB, kwargs={"hang_when": HANG_COND})
        t0 = time.monotonic()
        res = ex.submit("t", {"sequence_parallel": True}, spec=hang).result()
        assert not res.ok and "TimeoutError" in res.error
        assert time.monotonic() - t0 < 10.0
        assert ex.submit("t", {"model_axis": 2}, spec=hang).result().ok
        assert ex.stats()["reconnects"] >= 1
        ex.close()
    finally:
        daemon.stop()


def test_session_records_penalties_and_warm_resumes_after_crash(
        space, tmp_path):
    """Kill the only daemon mid-session: failed measurements land as
    penalty rows, the session completes, and a rerun against a healthy
    daemon replays every recorded row."""
    path = str(tmp_path / "crash.jsonl")
    daemon = WorkerDaemon(slots=2).start()
    killer = threading.Timer(0.5, daemon.stop)

    def factory(task, records, workers=0, timeout_s=None):
        ex = _fast_executor(daemon.endpoint, max_reconnects=2)
        return SettingsOracle(space, fn=None, executor=ex,
                              own_executor=True, task=task.name,
                              records=records, worker_spec=WorkerSpec(
                                  factory=STUB, kwargs={"delay_s": 0.2}))

    task = TuningTask(name="crashy", space=space, oracle_factory=factory)
    cfg = dataclasses.replace(TINY, seed=1)
    killer.start()
    try:
        rep = Session(task, tuner=cfg, budget=12, records=path,
                      device="cpu").run().single
    finally:
        killer.cancel()
        daemon.stop()
    assert rep.n_measurements == 12  # completed despite the dead fleet
    assert rep.oracle_stats["failures"] >= 1
    assert any(lat == Oracle.penalty_latency for _, lat in rep.measurements)
    daemon2 = WorkerDaemon(slots=2).start()

    def factory2(task, records, workers=0, timeout_s=None):
        return SettingsOracle(space, fn=None,
                              executor=_fast_executor(daemon2.endpoint),
                              own_executor=True, task=task.name,
                              records=records, worker_spec=STUB_SPEC)

    try:
        rep2 = Session(dataclasses.replace(task, oracle_factory=factory2),
                       tuner=cfg, budget=12, records=path,
                       device="cpu").run().single
    finally:
        daemon2.stop()
    assert rep2.oracle_stats["misses"] == 0  # fully warm, incl. penalties
    assert rep2.n_measurements == rep.n_measurements


# -------------------------------------------- netopt over a daemon fleet

def test_netopt_over_two_daemons_survives_crash_and_restart():
    """A co-optimization over two daemons rides out one dying mid-run
    (penalty rows, a reconnect once it returns) and still emits a valid,
    JSON-round-trippable NetworkReport."""
    from repro_torch.compiler.netopt import NetOptConfig, NetworkCoOptimizer
    from repro_torch.compiler.netopt.report import NetworkReport

    wl_a = dict(b=1, h=14, w=14, ci=256, co=256, kh=3, kw=3, stride=1, pad=1)
    wl_b = dict(b=1, h=28, w=28, ci=128, co=128, kh=3, kw=3, stride=1, pad=1)
    tiny = TunerConfig(iteration_opt=3, b_measure=8, episodes_per_iter=2,
                       mappo=mappo.MappoConfig(n_steps=16, n_envs=8),
                       gbt_rounds=10)
    slow_spec = WorkerSpec(factory=STUB, kwargs={"delay_s": 0.05})

    def factory(task, records, workers=0, timeout_s=None, executor=None):
        return SettingsOracle(task.space, fn=None, executor=executor,
                              task=task.name, records=records,
                              worker_spec=slow_spec)

    tasks = [TuningTask(name=n, space=DesignSpace.for_conv2d(wl),
                        oracle_factory=factory, multiplicity=m)
             for n, wl, m in (("c1", wl_a, 2), ("c2", wl_b, 1))]
    d1, d2 = WorkerDaemon(slots=1).start(), WorkerDaemon(slots=1).start()
    port2 = d2.address[1]
    ex = _fast_executor([d1.endpoint, d2.endpoint], max_reconnects=200)
    restarted = {}

    def chaos():  # kill d2 once it holds work, restart it shortly after
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            st = ex.stats()["endpoints"].get(d2.endpoint)
            if st and st["in_flight"] > 0:
                d2.stop()
                time.sleep(0.3)
                restarted["d2b"] = WorkerDaemon(port=port2).start()
                return
            time.sleep(0.01)

    th = threading.Thread(target=chaos, daemon=True)
    th.start()
    cfg = NetOptConfig(seed_candidates=2, hw_rounds=1, hw_per_round=1,
                       layer_budget=6, refine_budget=6, tuner=tiny)
    try:
        rep = NetworkCoOptimizer(tasks, cfg, remote=ex, name="remote-net",
                                 device="cpu").run()
    finally:
        th.join(timeout=30)
        ex.close()
        d1.stop()
        d2.stop()
        if "d2b" in restarted:
            restarted["d2b"].stop()
    es = rep.executor_stats
    assert es["kind"] == "remote" and es["jobs"] > 0
    assert es["failures"] >= 1          # the crash cost in-flight jobs...
    assert es["reconnects"] >= 1        # ...and the restart rejoined
    assert rep.network_latency > 0 and rep.verify_shared_hardware()
    rt = NetworkReport.from_dict(json.loads(json.dumps(rep.to_dict())))
    assert rt.network_latency == rep.network_latency
    assert rt.executor_stats["reconnects"] == es["reconnects"]


# ----------------------------------------------------- protocol-wide stats

def test_stats_is_uniform_across_executors():
    """All three executors answer the same keys (the card's fabric phase
    checks the same)."""
    keys = {"kind", "workers_alive", "respawns", "queued", "running",
            "max_inflight", "jobs", "failures"}
    serial = SerialExecutor(fn=make_stub())
    assert keys <= set(serial.stats()) and serial.stats()["kind"] == "serial"
    assert all(v == 0 for k, v in serial.stats().items() if k != "kind")
    with SubprocessExecutor(STUB_SPEC, workers=1, timeout_s=30.0) as pool:
        assert pool.submit("t", {"model_axis": 2}).result().ok
        st = pool.stats()
        assert keys <= set(st)
        assert st["kind"] == "subprocess" and st["jobs"] == 1
    daemon = WorkerDaemon().start()
    try:
        ex = _fast_executor(daemon.endpoint)
        assert keys <= set(ex.stats())
        ex.close()
    finally:
        daemon.stop()
