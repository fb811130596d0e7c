"""The port's measurement fabric, local half: ``SerialExecutor``,
``SubprocessExecutor`` and ``SettingsOracle`` (``repro_torch.compiler.
executor`` / ``oracle``) — the cases of the reference's
``tests/test_executor.py`` on the port, plus parity with the reference on
the same inputs: the stub's latencies, the decoded settings, and record
files that each package's oracle resumes from the other's with no new
measurement.

Every job here is the CPU stub (``make_stub``: a CRC of the settings, so
parent and workers agree exactly); values are compared exactly, and every
pool gets a short timeout of its own so no test can hang.
"""
import json
import os

import numpy as np
import pytest

from _torch_support import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.compiler.executor import (MeasureResult, SerialExecutor,
                                           SubprocessExecutor, WorkerSpec)
from repro_torch.compiler.executor.stub import make_stub, stub_latency
from repro_torch.compiler.oracle import SettingsOracle, decode_config
from repro_torch.compiler.records import RecordLog
from repro_torch.compiler.session import Session
from repro_torch.compiler.task import TuningTask
from repro_torch.core import mappo
from repro_torch.core.design_space import N_KNOBS
from repro_torch.core.shard_space import ShardSpace
from repro_torch.core.tuner import TunerConfig

STUB = "repro_torch.compiler.executor.stub:make_stub"
TINY = TunerConfig(iteration_opt=2, b_measure=6, episodes_per_iter=2,
                   mappo=mappo.MappoConfig(n_steps=16, n_envs=8),
                   gbt_rounds=8, seed=3)


@pytest.fixture(scope="module")
def space():
    return ShardSpace.for_cell("qwen2-1.5b", "train_4k", None, n_devices=256)


def _cfg(knob: int = -1, idx: int = 1) -> np.ndarray:
    """All-defaults config, optionally with one knob bumped to ``idx``."""
    c = np.zeros(N_KNOBS, np.int64)
    if knob >= 0:
        c[knob] = idx
    return c


# Settings triggered by single knob bumps (see shard_space knob order):
FAIL_COND = {"fsdp": True}               # knob 2 -> fsdp on
HANG_COND = {"sequence_parallel": True}  # knob 6 -> SP on
EXIT_COND = {"remat": True}              # knob 4 -> remat on
FAIL_CFG, HANG_CFG, EXIT_CFG = _cfg(2), _cfg(6), _cfg(4)


# ------------------------------------------------------ parity with repro

def test_stub_and_decoded_settings_equal_the_reference(space):
    """Same configs -> the same settings dicts and the same stub values in
    both packages (exact: the stub is a CRC of the sorted settings)."""
    from repro.compiler.executor.stub import stub_latency as ref_latency
    from repro.compiler.oracle import decode_config as ref_decode
    from repro.core.shard_space import ShardSpace as RefShardSpace
    ref_space = RefShardSpace.for_cell("qwen2-1.5b", "train_4k", None,
                                       n_devices=256)
    rng = np.random.default_rng(0)
    for _ in range(32):
        cfg = [int(rng.integers(0, len(c))) for c in space.choices]
        got, want = decode_config(space, cfg), ref_decode(ref_space, cfg)
        assert got == want
        assert stub_latency(got) == ref_latency(want)


# ----------------------------------------------------------------- executors

def test_serial_executor_runs_and_reports_errors():
    ex = SerialExecutor(fn=make_stub(fail_when=FAIL_COND))
    ok = ex.submit("t", {"model_axis": 4})
    assert ok.done() and ok.result().ok
    assert ok.result().value == stub_latency({"model_axis": 4})
    bad = ex.submit("t", {"model_axis": 4, "fsdp": True})
    res = bad.result()
    assert not res.ok and "RuntimeError: stub measurement failed" in res.error
    spec = SerialExecutor(spec=WorkerSpec(factory=STUB))  # resolved in-process
    assert spec.submit("t", {"x": 1}).result().value == stub_latency({"x": 1})
    with pytest.raises(ValueError):
        SerialExecutor(fn=make_stub(), spec=WorkerSpec(factory=STUB))


def test_subprocess_pool_matches_serial_values(space):
    spec = WorkerSpec(factory=STUB, kwargs={"delay_s": 0.05})
    settings = [decode_config(space, _cfg(0, i)) for i in range(4)]
    with SubprocessExecutor(spec, workers=2, timeout_s=30.0) as pool:
        handles = [pool.submit("t", s) for s in settings]
        pool.drain(handles)
        for s, h in zip(settings, handles):
            assert h.result().ok
            assert h.result().value == stub_latency(s)
    assert pool.stats()["workers_alive"] == 0  # context exit tore it down


def test_subprocess_bad_factory_fails_jobs_not_pool():
    spec = WorkerSpec(factory="repro_torch.compiler.executor.stub:nope")
    with SubprocessExecutor(spec, workers=1, timeout_s=30.0) as pool:
        res = pool.submit("t", {"x": 1}).result()
        assert not res.ok and "WorkerInitError" in res.error
        assert pool.stats()["respawns"] == 0  # the worker survives


def test_adaptive_inflight_policy():
    from repro_torch.compiler.executor.pool import adaptive_inflight
    assert adaptive_inflight(2, None) == 4          # no data: 2 * workers
    assert adaptive_inflight(2, 60.0) == 4          # long jobs: floor
    assert adaptive_inflight(2, 0.001) == 16        # fast stubs: 8x cap
    assert adaptive_inflight(3, 0.2) == 9           # 1 + ceil(.25/.2) = 3x
    assert adaptive_inflight(1, 0.05) == 6          # 1 + ceil(.25/.05) = 6x


def test_pool_adapts_inflight_from_observed_durations(space):
    spec = WorkerSpec(factory=STUB, kwargs={"delay_s": 0.01})
    with SubprocessExecutor(spec, workers=2, timeout_s=30.0) as pool:
        assert pool.stats()["max_inflight"] == 4  # nothing observed yet
        handles = [pool.submit("t", decode_config(space, _cfg(0, i % 5)))
                   for i in range(8)]
        pool.drain(handles)
        assert all(h.result().ok for h in handles)
        assert pool.stats()["max_inflight"] > 4   # grew for fast jobs
    with SubprocessExecutor(spec, workers=2, max_inflight=3,
                            timeout_s=30.0) as pool:
        handles = [pool.submit("t", decode_config(space, _cfg(0, i % 5)))
                   for i in range(6)]
        pool.drain(handles)
        assert pool.stats()["max_inflight"] == 3  # a pinned bound stays


# -------------------------------------------------- oracle failure paths

def _oracle(space, pool, records=None, **kw):
    return SettingsOracle(space, fn=None, executor=pool, own_executor=True,
                          task="exec", records=records, **kw)


def test_worker_raise_records_penalty_row(space, tmp_path):
    log = RecordLog(str(tmp_path / "raise.jsonl"))
    spec = WorkerSpec(factory=STUB, kwargs={"fail_when": FAIL_COND})
    oracle = _oracle(space, SubprocessExecutor(spec, workers=2,
                                               timeout_s=30.0), records=log)
    lat, feats = oracle.measure(np.stack([FAIL_CFG, _cfg(), _cfg(0, 1)]))
    oracle.close()
    assert lat[0] == oracle.penalty_latency
    assert lat[1] == stub_latency(decode_config(space, _cfg()))
    assert oracle.stats()["failures"] == 1
    assert feats.shape == (3, 18)
    rows = log.load(task="exec")
    errs = [r for r in rows if "error" in r]
    assert len(rows) == 3 and len(errs) == 1
    assert "stub measurement failed" in errs[0]["error"]
    assert errs[0]["latency"] == oracle.penalty_latency
    assert errs[0]["settings"]["fsdp"] is True


def test_worker_timeout_kills_respawns_and_continues(space, tmp_path):
    log = RecordLog(str(tmp_path / "hang.jsonl"))
    spec = WorkerSpec(factory=STUB, kwargs={"hang_when": HANG_COND})
    # the deadline restarts at the worker's started-ack, so start-up is
    # never billed to the measurement
    pool = SubprocessExecutor(spec, workers=2, timeout_s=1.0)
    oracle = _oracle(space, pool, records=log)
    lat, _ = oracle.measure(np.stack([HANG_CFG, _cfg(), _cfg(0, 2)]))
    assert lat[0] == oracle.penalty_latency
    assert oracle.stats()["failures"] == 1
    assert pool.respawns == 1  # the hung worker was killed
    assert any("TimeoutError" in r.get("error", "")
               for r in log.load(task="exec"))
    lat2, _ = oracle.measure(np.stack([_cfg(0, 3), _cfg(0, 4)]))
    assert oracle.stats()["failures"] == 1  # the pool keeps serving
    assert np.all(lat2 < 1.0)
    oracle.close()


def test_worker_crash_is_isolated(space, tmp_path):
    log = RecordLog(str(tmp_path / "crash.jsonl"))
    spec = WorkerSpec(factory=STUB, kwargs={"exit_when": EXIT_COND})
    pool = SubprocessExecutor(spec, workers=2, timeout_s=30.0)
    oracle = _oracle(space, pool, records=log)
    lat, _ = oracle.measure(np.stack([EXIT_CFG, _cfg(), _cfg(0, 1)]))
    assert lat[0] == oracle.penalty_latency
    assert lat[1] < 1.0 and lat[2] < 1.0
    assert oracle.stats()["failures"] == 1
    assert pool.respawns == 1
    assert any("WorkerCrash" in r.get("error", "")
               for r in log.load(task="exec"))
    resumed = SettingsOracle(space, fn=make_stub(), task="exec", records=log)
    lat3, _ = resumed.measure(np.stack([EXIT_CFG, _cfg()]))
    assert resumed.stats()["misses"] == 0  # warm across the failure
    assert lat3[0] == oracle.penalty_latency
    oracle.close()


def test_measure_async_overlaps_with_parent_work(space):
    spec = WorkerSpec(factory=STUB, kwargs={"delay_s": 0.2})
    oracle = _oracle(space, SubprocessExecutor(spec, workers=2,
                                               timeout_s=30.0))
    batch = oracle.measure_async(np.stack([_cfg(), _cfg(0, 1)]))
    overlapped = 0
    while not batch.ready():  # the parent stays free while workers measure
        overlapped += 1
    lat, _ = batch.get()
    assert overlapped > 0
    assert list(lat) == [stub_latency(decode_config(space, _cfg())),
                         stub_latency(decode_config(space, _cfg(0, 1)))]
    assert oracle.stats() == {"hits": 0, "misses": 2, "dedup": 0,
                              "failures": 0, "cached": 2}
    oracle.close()


def test_malformed_result_records_penalty_not_crash(space):
    oracle = SettingsOracle(space, fn=lambda s: {"step_s": 1.0}, task="bad")
    lat, _ = oracle.measure(np.stack([_cfg()]))
    assert lat[0] == oracle.penalty_latency
    assert oracle.stats()["failures"] == 1
    oracle2 = SettingsOracle(space, fn=lambda s: None, task="bad2")
    lat2, _ = oracle2.measure(np.stack([_cfg()]))
    assert lat2[0] == oracle2.penalty_latency
    ok = SettingsOracle(space, fn=lambda s: {"step_penalized_s": 2.5,
                                             "step_s": 2.0, "junk": 1},
                        task="ok")
    assert ok.measure(np.stack([_cfg()]))[0][0] == 2.5
    with pytest.raises(ValueError):
        SettingsOracle(space)


def test_env_conflict_between_specs_fails_loudly():
    a = WorkerSpec(factory=STUB, env={"REPRO_TEST_PIN": "1"})
    b = WorkerSpec(factory=STUB, env={"REPRO_TEST_PIN": "2"})
    with SubprocessExecutor(workers=1, timeout_s=30.0) as pool:
        assert pool.submit("t", {"x": 1}, spec=a).result().ok
        res = pool.submit("t", {"x": 2}, spec=b).result()
        assert not res.ok and "WorkerEnvConflict" in res.error
        assert pool.submit("t", {"x": 3}, spec=a).result().ok
        assert pool.stats()["respawns"] == 0


# ----------------------------------------------------------- determinism

def _stub_task(space, name, subprocess_workers=0, fail=False):
    kwargs = {"fail_when": FAIL_COND} if fail else {}

    def factory(task, records, workers=0, timeout_s=None):
        if subprocess_workers:
            pool = SubprocessExecutor(
                WorkerSpec(factory=STUB, kwargs=kwargs),
                workers=subprocess_workers, timeout_s=30.0)
            return SettingsOracle(space, fn=None, executor=pool,
                                  own_executor=True, task=task.name,
                                  records=records)
        return SettingsOracle(space, fn=make_stub(**kwargs), task=task.name,
                              records=records)
    return TuningTask(name=name, space=space, oracle_factory=factory)


def test_serial_and_subprocess_reports_identical(space):
    runs = {}
    for label, w in (("serial", 0), ("subprocess", 1)):
        runs[label] = Session(_stub_task(space, "det", subprocess_workers=w),
                              tuner=TINY, budget=12,
                              device="cpu").run().single
    a, b = runs["serial"], runs["subprocess"]
    assert a.best_config == b.best_config
    assert a.best_latency == b.best_latency
    assert a.measurements == b.measurements
    assert [(n, lat) for n, lat, _ in a.history] == \
           [(n, lat) for n, lat, _ in b.history]
    assert a.oracle_stats["failures"] == b.oracle_stats["failures"] == 0
    # a shard-space report names its settings as the reference does
    assert set(a.best_settings) == {"model_axis", "moment_dtype", "fsdp",
                                    "grad_accum", "remat", "attn_chunk",
                                    "sequence_parallel"}


def test_session_survives_failures_and_resumes(space, tmp_path):
    path = str(tmp_path / "flaky.jsonl")
    task = _stub_task(space, "flaky", subprocess_workers=2, fail=True)
    cfg = TunerConfig(iteration_opt=2, b_measure=6, episodes_per_iter=2,
                      mappo=mappo.MappoConfig(n_steps=16, n_envs=8),
                      gbt_rounds=8, seed=0)
    r1 = Session(task, tuner=cfg, budget=12, records=path,
                 device="cpu").run().single
    assert r1.oracle_stats["misses"] > 0
    assert r1.best_latency < SettingsOracle.penalty_latency
    r2 = Session(task, tuner=cfg, budget=12, records=path,
                 device="cpu").run().single
    assert r2.oracle_stats["misses"] == 0  # fully warm, incl. failure rows
    assert r2.best_latency == r1.best_latency


def test_session_shares_one_pool_across_tasks(space):
    """Session(workers=N) hands every task the same executor — N worker
    processes in all — tears it down afterwards and reports its stats."""
    seen = []

    def make_task(name):
        def factory(task, records, workers=0, timeout_s=None, executor=None):
            seen.append(executor)
            return SettingsOracle(space, fn=None, executor=executor,
                                  own_executor=False, task=task.name,
                                  worker_spec=WorkerSpec(factory=STUB))
        return TuningTask(name=name, space=space, oracle_factory=factory)

    cfg = TunerConfig(iteration_opt=2, b_measure=4, episodes_per_iter=2,
                      mappo=mappo.MappoConfig(n_steps=16, n_envs=8),
                      gbt_rounds=8, seed=1)
    sr = Session([make_task("cellA"), make_task("cellB")], tuner=cfg,
                 budget=8, workers=2, timeout_s=30.0, device="cpu").run()
    assert len(seen) == 2
    assert seen[0] is seen[1] and seen[0] is not None
    assert seen[0].n_workers == 2
    for rep in sr:
        assert rep.n_measurements == 8
        assert rep.oracle_stats["failures"] == 0
    assert seen[0].stats()["workers_alive"] == 0  # closed with the session
    assert sr.executor_stats["kind"] == "subprocess"
    assert sr.executor_stats["jobs"] == 16
    assert json.loads(json.dumps(sr.to_dict()))["executor_stats"] == \
        sr.executor_stats


# ------------------------------------------- records cross both packages

def test_records_cross_between_packages_both_ways(space, tmp_path):
    """Records written by the port's SettingsOracle resume in the
    reference's with 0 new measurements (same latencies, same settings),
    and the reverse."""
    from repro.compiler.executor.stub import make_stub as ref_stub
    from repro.compiler.oracle import SettingsOracle as RefOracle
    from repro.compiler.records import RecordLog as RefLog
    from repro.core.shard_space import ShardSpace as RefShardSpace
    ref_space = RefShardSpace.for_cell("qwen2-1.5b", "train_4k", None,
                                       n_devices=256)
    cfgs = np.stack([FAIL_CFG, _cfg(), _cfg(0, 1), _cfg(5, 3), HANG_CFG])
    for writer, reader in (("port", "ref"), ("ref", "port")):
        path = str(tmp_path / f"{writer}.jsonl")
        make = {
            "port": lambda fn: SettingsOracle(space, fn=fn, task="x",
                                              records=RecordLog(path)),
            "ref": lambda fn: RefOracle(ref_space, fn=fn, task="x",
                                        records=RefLog(path))}
        stubs = {"port": make_stub, "ref": ref_stub}
        first = make[writer](stubs[writer](fail_when=FAIL_COND))
        lat1, _ = first.measure(cfgs)
        assert first.stats()["misses"] == 5 and first.stats()["failures"] == 1
        second = make[reader](stubs[reader]())
        lat2, _ = second.measure(cfgs)
        assert second.stats()["misses"] == 0 and second.stats()["hits"] == 5
        np.testing.assert_array_equal(lat1, lat2)
        rows = [json.loads(line) for line in open(path)]
        assert [r["settings"] for r in rows] == \
            [decode_config(space, c) for c in cfgs]


# ----------------------------------------------------------------- records

def test_recordlog_drops_corrupt_trailing_line(tmp_path):
    log = RecordLog(str(tmp_path / "rec.jsonl"))
    log.append({"task": "t", "config": [0], "latency": 1.0, "features": []})
    log.append({"task": "t", "config": [1], "latency": 2.0, "features": []})
    with open(log.path, "a") as f:
        f.write('{"task": "t", "config": [2], "lat')  # killed mid-append
    assert [r["latency"] for r in log.load()] == [1.0, 2.0]
    resumed = RecordLog(log.path)
    resumed.append({"task": "t", "config": [3], "latency": 3.0,
                    "features": []})
    assert [r["latency"] for r in resumed.load()] == [1.0, 2.0, 3.0]
    assert os.path.getsize(log.path) > 0


def test_measure_result_defaults():
    res = MeasureResult(ok=False)
    assert res.value is None and res.error == ""
