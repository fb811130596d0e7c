"""Online tuning-as-a-service on the port (``repro_torch.compiler.
serve_tune``) against the reference's ``repro.compiler.serve_tune``: the
same synthetic traces (exact), the same step-time model (1e-12 relative),
the same virtual-time serving simulation for one scripted job sequence
(exact), and the cases of the reference's ``tests/test_serve_tune.py`` —
the idle-slot executor's control inversion, SLA-violation penalties,
online-vs-offline convergence, warm resume, the monitor's ``serve``
source — then ``LiveServeHost`` on the port's ``Server`` (reduced
qwen2-1.5b, fp32, CPU) and the ``launch.serve --rate --autotune`` CLI.
"""
import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from _torch_support import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.compiler.serve_tune import (IdleSlotExecutor, LiveServeHost,
                                             ServeModel, ServeReport,
                                             ServeSLA, SimServeHost,
                                             TraceConfig, synthetic_trace,
                                             tune_while_serving)
from repro_torch.core import mappo
from repro_torch.core.shard_space import knob_values_to_settings
from repro_torch.core.tuner import TunerConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = TunerConfig(iteration_opt=2, b_measure=4, episodes_per_iter=1,
                   mappo=mappo.MappoConfig(n_steps=8, n_envs=4),
                   gbt_rounds=5)


@pytest.fixture(scope="module")
def model():
    return ServeModel()


@pytest.fixture(scope="module")
def ref():
    from repro.compiler import serve_tune as RS
    return RS


# ------------------------------------------------ parity with repro

def test_synthetic_trace_equals_reference(ref):
    for cfg in (TraceConfig(n_requests=20_000, rate_per_s=50.0, seed=9),
                TraceConfig(n_requests=48, rate_per_s=2.0,
                            prompt_len=(4, 512), max_new=(2, 32), seed=0)):
        got = np.asarray(list(synthetic_trace(cfg)))
        want = np.asarray(list(ref.synthetic_trace(ref.TraceConfig(
            **{k: getattr(cfg, k) for k in cfg.__dataclass_fields__}))))
        np.testing.assert_array_equal(got, want)  # exact: same numpy draws


def test_serve_model_cost_equals_reference(model, ref):
    rmodel = ref.ServeModel()
    rng = np.random.default_rng(0)
    for kind in ("decode", "prefill"):
        space = model.spaces[kind]
        assert space.choices == rmodel.spaces[kind].choices
        assert model.default_settings[kind] == rmodel.default_settings[kind]
        for _ in range(40):
            s = knob_values_to_settings(
                [c[int(rng.integers(0, len(c)))] for c in space.choices])
            got, want = model.cost_s(kind, s), rmodel.cost_s(kind, s)
            assert abs(got - want) <= 1e-12 * abs(want), (kind, s)


def _scripted(mod, mdl, decode_settings, prefill_settings):
    trace = mod.TraceConfig(n_requests=400, rate_per_s=40.0, seed=5)
    host = mod.SimServeHost(mdl, trace, sla=mod.ServeSLA(target_s=0.05),
                            n_slots=4, measure_cost_s=0.03,
                            tune_after_s=0.5)
    ex = mod.IdleSlotExecutor(host)
    host.register_task("d", "decode", mdl.measure_fn("decode"))
    host.register_task("p", "prefill", mdl.measure_fn("prefill"))
    hs = ([ex.submit("d", s) for s in decode_settings]
          + [ex.submit("p", s) for s in prefill_settings])
    ex.drain(hs[:2])
    host.apply_best("prefill", prefill_settings[-1])
    host.mark_tuned()
    ex.drain()
    host.finish_serving()
    return host.summary(), [h.result().value for h in hs], ex.stats()


def test_sim_host_summary_equals_reference(model, ref):
    """One scripted job sequence — measurements queued in idle slots,
    a geometry adopted mid-run, the tuned tail — gives the reference's
    summary, values and executor stats exactly."""
    rng = np.random.default_rng(3)

    def draw(kind):
        return [knob_values_to_settings(
            [c[int(rng.integers(0, len(c)))] for c in
             model.spaces[kind].choices]) for _ in range(4)]
    dec, pre = draw("decode"), draw("prefill")
    got = _scripted(sys.modules[SimServeHost.__module__], model, dec, pre)
    want = _scripted(ref, ref.ServeModel(), dec, pre)
    assert got == want
    summary = got[0]
    assert summary["served"] == 400 and summary["measurements"] == 8
    assert summary["before"]["n_requests"] > 0
    assert summary["after"]["n_requests"] > 0


# ------------------------------------------------- preemption + penalty

def test_sla_violations_penalize_inflight_measurement(model):
    sla = ServeSLA(target_s=0.0, measure_penalty_s=10.0)  # all violate
    host = SimServeHost(model, [(0.5, 8, 4), (0.6, 8, 4)], sla=sla,
                        measure_cost_s=5.0)
    ex = IdleSlotExecutor(host)
    host.register_task("t", "decode", model.measure_fn("decode"))
    settings = model.default_settings["decode"]
    handle = ex.submit("t", settings)
    assert not handle.done()  # only queued: no idle time has passed yet
    ex.drain([handle])
    res = handle.result()
    assert res.ok
    raw = model.cost_s("decode", settings)
    assert res.value == pytest.approx(raw + 2 * sla.measure_penalty_s)
    assert host.served == 2 and host.violations == 2
    st = ex.stats()
    assert {"kind", "workers_alive", "respawns", "queued", "running",
            "max_inflight", "jobs", "failures"} <= set(st)
    assert st["kind"] == "idle-slot" and st["jobs"] == 1
    with pytest.raises(KeyError, match="never registered"):
        ex.submit("unknown", settings)


def test_measurements_only_progress_in_idle_windows(model):
    trace = [(0.0, 8, 200)] * 8  # 4 slots, 8 long requests: no idle slot
    host = SimServeHost(model, trace, sla=ServeSLA(target_s=1e9),
                        n_slots=4, measure_cost_s=0.01)
    ex = IdleSlotExecutor(host)
    host.register_task("t", "decode", model.measure_fn("decode"))
    handle = ex.submit("t", model.default_settings["decode"])
    job = host.jobs[0]
    while host.served < 8:
        assert host.pump()
        if host.served < 4:  # both waves still occupy every slot
            assert job.progress_s == 0.0
    ex.drain([handle])
    assert handle.result().ok


# ------------------------------------------------------ end-to-end (sim)

def test_online_converges_to_offline_within_10pct(model):
    """The reference's bar at its seed: the online search within 10% of
    the offline one at the same budget, the SLA held, and tuning visibly
    helping."""
    host = SimServeHost(model, TraceConfig(n_requests=3000, rate_per_s=100.0,
                                           seed=1),
                        sla=ServeSLA(target_s=0.5), measure_cost_s=0.05,
                        tune_after_s=5.0)
    rep = tune_while_serving(host, tuner=TINY, budget=8, seed=0,
                             device="cpu")
    s = rep.serve
    assert s["served"] == 3000
    assert min(rep.convergence.values()) >= 0.9
    assert s["violation_pct"] < 3.0
    assert s["before"]["n_requests"] > 0 and s["after"]["n_requests"] > 0
    assert s["after"]["p99_latency_s"] < s["before"]["p99_latency_s"]
    assert s["switches"] and s["tuned_from_s"] >= 5.0
    assert 0 < s["measurements"] <= 16
    assert s["measure_idle_s"] == pytest.approx(0.05 * s["measurements"])
    assert s["preempted"] >= 0 and s["measure_failures"] == 0
    rt = ServeReport.from_dict(json.loads(json.dumps(rep.to_dict())))
    assert rt.serve["served"] == 3000
    assert rt.convergence == rep.convergence
    assert rt.session.reports.keys() == rep.session.reports.keys()


def test_serve_report_crosses_between_packages(model, ref):
    host = SimServeHost(model, TraceConfig(n_requests=300, rate_per_s=200.0,
                                           seed=2), measure_cost_s=0.02)
    rep = tune_while_serving(host, tuner=TINY, budget=4, seed=0,
                             offline_compare=False, device="cpu")
    doc = json.loads(json.dumps(rep.to_dict()))
    back = ServeReport.from_dict(json.loads(json.dumps(
        ref.ServeReport.from_dict(doc).to_dict())))
    assert json.dumps(back.to_dict(), sort_keys=True) == \
        json.dumps(rep.to_dict(), sort_keys=True)


def test_warm_resume_replays_without_new_measurements(model, tmp_path):
    records = str(tmp_path / "serve_records.jsonl")
    trace = TraceConfig(n_requests=600, rate_per_s=200.0, seed=4)
    rep1 = tune_while_serving(SimServeHost(model, trace, measure_cost_s=0.02),
                              tuner=TINY, budget=8, seed=0, records=records,
                              offline_compare=False, device="cpu")
    assert rep1.serve["measurements"] > 0
    rep2 = tune_while_serving(SimServeHost(model, trace, measure_cost_s=0.02),
                              tuner=TINY, budget=8, seed=0, records=records,
                              offline_compare=False, device="cpu")
    assert rep2.serve["measurements"] == 0  # pure replay
    assert rep2.online == rep1.online
    for name, r1 in rep1.session.reports.items():
        assert rep2.session.reports[name].best_latency == r1.best_latency
    assert rep2.serve["geometry"]["decode"] == \
        rep1.online["decode"]["settings"]
    assert rep2.serve["after"]["n_requests"] > 0


def test_monitor_gains_serve_source(model):
    from repro_torch.obs.serve import MonitorServer
    mon = MonitorServer(port=0).start()
    try:
        host = SimServeHost(model, TraceConfig(n_requests=400,
                                               rate_per_s=200.0, seed=3),
                            measure_cost_s=0.02)
        rep = tune_while_serving(host, tuner=TINY, budget=8, monitor=mon,
                                 offline_compare=False, device="cpu")
        assert mon.running  # borrowed: never stopped by the run
        with urllib.request.urlopen(mon.url + "/status", timeout=10) as r:
            sources = json.loads(r.read())["sources"]
        assert "serve" in sources and "session" in sources
        serve = sources["serve"]
        assert serve["final"] is True
        assert serve["served"] == rep.serve["served"]
        assert serve["measurements"]["done"] == rep.serve["measurements"]
        assert serve["queued"] == 0 and serve["active"] == 0
    finally:
        mon.stop()


# ------------------------------------------------------------- live host

def test_live_host_tunes_on_the_port_server():
    """Reduced qwen2-1.5b in fp32 on the CPU: every request served, the
    measurements ran through the server's best_effort hook in idle
    windows only, and the latency breakdown adds up."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train.server import Server
    cfg = get_config("qwen2-1.5b", reduced=True).with_(
        dtype=torch.float32, param_dtype=torch.float32)
    srv = Server(T.init_params(0, cfg, device="cpu"), cfg, n_slots=2,
                 max_len=32)
    host = LiveServeHost(
        srv, TraceConfig(n_requests=8, rate_per_s=100.0, prompt_len=(4, 8),
                         max_new=(2, 4), seed=2),
        sla=ServeSLA(target_s=60.0), vocab=cfg.vocab, seed=0)
    rep = tune_while_serving(host, tuner=TINY, budget=4,
                             offline_compare=False, device="cpu")
    s = rep.serve
    assert s["served"] == 8 and s["violations"] == 0
    assert s["measurements"] > 0  # ran through best_effort ticks
    assert s["idle_windows"] == s["measurements"]
    assert not srv.abandoned and not srv.rejected
    for r in host.done:
        assert r.ok and r.latency_s == pytest.approx(
            r.queue_s + r.prefill_s + r.decode_s, rel=1e-6)
    assert set(rep.online) == {"decode", "prefill"}
    assert all(0 <= t < cfg.vocab for r in host.done for t in r.output)


# ------------------------------------------------------------------ CLI

def _cli(*args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2-1.5b", "--reduced", "--requests", "16", "--rate", "20",
         *args], env=env, capture_output=True, text=True, timeout=300)


def test_serve_cli_rate_autotune_on_cpu(tmp_path):
    records = str(tmp_path / "r.jsonl")
    res = _cli("--autotune", "--budget", "4", "--records", records,
               "--device", "cpu")
    assert res.returncode == 0, res.stderr
    doc = json.loads(res.stdout)
    assert doc["requests"] == 16 and doc["rejected"] == 0
    assert doc["abandoned"] == 0 and doc["violation_pct"] >= 0.0
    auto = doc["autotune"]
    assert auto["budget"] == 4 and auto["measurements"] == 8
    assert set(auto["online"]) == {"decode", "prefill"}
    assert len(open(records).read().splitlines()) == 8
    bad = _cli("--autotune", "--rate", "0", "--device", "cpu")
    assert bad.returncode == 2 and "--autotune needs --rate" in bad.stderr
    nogpu = _cli("--autotune", env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert nogpu.returncode != 0 and "no CUDA device" in nogpu.stderr
