"""The port's tuning loop end to end: the reference's quality bar, the CLI,
sessions, and record files interchangeable with the reference's."""
import contextlib
import io
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_support import one_torch_thread  # noqa: F401
from repro.compiler.oracle import AnalyticalOracle as JOracle
from repro.compiler.records import RecordLog as JRecordLog
from repro.core.design_space import DesignSpace as JDS
from repro_torch.compiler import cli
from repro_torch.compiler.executor import SerialExecutor
from repro_torch.compiler.oracle import AnalyticalOracle as TOracle
from repro_torch.compiler.records import RecordLog as TRecordLog
from repro_torch.compiler.session import Session, SessionReport
from repro_torch.compiler.task import TuningTask
from repro_torch.core import mappo
from repro_torch.core.design_space import DesignSpace as TDS
from repro_torch.core.tuner import TunerConfig, arco_tune
from repro_torch.kernels import ops, ref

WL = dict(b=1, h=14, w=14, ci=128, co=128, kh=3, kw=3, stride=1, pad=1)
FAST = TunerConfig.fast()


@pytest.fixture(scope="module")
def space():
    return TDS.for_conv2d(WL)


def _short_horizon(seed):
    """The reference's short-horizon setup (tests/test_tuner.py)."""
    return TunerConfig(iteration_opt=5, b_measure=32, episodes_per_iter=3,
                       mappo=mappo.MappoConfig(n_steps=48, n_envs=16),
                       gbt_rounds=20, seed=seed, b_growth=0.6)


def _optimum(space):
    grids = np.meshgrid(*[np.arange(len(c)) for c in space.choices],
                        indexing="ij")
    all_cfg = torch.as_tensor(np.stack([g.reshape(-1) for g in grids], 1))
    return float(space.measure(all_cfg).min())


def test_arco_short_horizon_convergence(space):
    """The reference's tier-1 bar (tests/test_tuner.py): at budget 160 with
    the decayed CS batch schedule, ARCO lands within 25% of the
    exhaustively enumerated optimum.  JAX's threefry streams cannot be
    reproduced in torch, so one seed here is not the reference's seed 1,
    and in both packages the bar holds on about half of the seeds
    (``tests/torch_quality_sweep.py`` compares seeds 0-15); here it is
    held on the median of seeds 0-2, which land at 1.00x, 1.88x and 1.24x
    of the optimum."""
    optimum = _optimum(space)
    ratios = []
    for seed in (0, 1, 2):
        r = arco_tune(space, _short_horizon(seed), budget=160, device="cpu")
        assert r.n_measurements <= 160
        bests = [b for _, b, _ in r.history]
        assert all(b2 <= b1 for b1, b2 in zip(bests, bests[1:]))
        ratios.append(r.best_latency / optimum)
    assert min(ratios) >= 1.0
    assert float(np.median(ratios)) <= 1.25, ratios


def test_results_reproducible_and_deployable(space):
    r1 = arco_tune(space, FAST, device="cpu")
    r2 = arco_tune(space, FAST, device="cpu")
    assert r1.best_latency == r2.best_latency
    assert r1.best_config == r2.best_config
    # the tuned configuration deploys through the GEMM and matches the oracle
    s = r1.best_settings
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 14, 14, 128)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 128, 128)).astype(np.float32))
    out = ops.conv2d_from_knobs(
        x, w, 1, 1, tile_b=s["tile_b"], tile_h=s["tile_h"],
        tile_w=s["tile_w"], tile_ci=s["tile_ci"], tile_co=s["tile_co"],
        h_threading=s["h_threading"], oc_threading=s["oc_threading"])
    np.testing.assert_allclose(out.numpy(), ref.conv2d_ref(x, w, 1, 1).numpy(),
                               rtol=1e-4, atol=1e-4)


def _cli(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(list(argv)) == 0
    return json.loads(buf.getvalue())


def test_cs_ablation_and_independent_cost_models(space):
    """Fig. 4a's ablation (uniform picks from the explored pool) and
    per-task cost models both run within budget."""
    r = arco_tune(space, FAST, budget=40, use_cs=False, device="cpu")
    assert r.n_measurements == 40 and np.isfinite(r.best_latency)
    tasks = TuningTask.conv_tasks("resnet-18")[2:4]
    rep = Session(tasks, tuner=FAST, budget=20, share_cost_model=False,
                  device="cpu").run()
    assert not rep.shared_cost_model
    assert all(t.n_measurements == 20 for t in rep)


def test_cli_smoke_and_records_resume(tmp_path):
    out = _cli("tune", "--model", "resnet-18", "--max-tasks", "2",
               "--budget", "2", "--device", "cpu")
    assert list(out["reports"]) == ["resnet-18:conv1", "resnet-18:conv2a"]
    assert all(r["n_measurements"] == 2 for r in out["reports"].values())
    rec = str(tmp_path / "r.jsonl")
    doc = str(tmp_path / "s.json")
    first = _cli("--model", "resnet-18", "--max-tasks", "2", "--budget", "8",
                 "--records", rec, "--out", doc, "--device", "cpu")
    again = _cli("--model", "resnet-18", "--max-tasks", "2", "--budget", "8",
                 "--records", rec, "--device", "cpu")
    for name, rep in again["reports"].items():
        assert rep["oracle_stats"]["misses"] == 0
        assert rep["best_latency"] == first["reports"][name]["best_latency"]
    with open(doc) as f:
        full = SessionReport.from_dict(json.load(f))
    assert all(len(r.measurements) == 8 for r in full)
    matmul = _cli("--matmul", "64x32x128", "--budget", "3", "--device", "cpu")
    assert list(matmul["reports"]) == ["matmul_64x32x128"]
    with pytest.raises(SystemExit):
        _cli("tune", "--budget", "2", "--device", "cpu")


def test_records_interchange_with_reference(tmp_path):
    """A record file written by the reference replays in the port with no
    new measurement, and a port-written file loads in the reference."""
    jspace, tspace = JDS.for_conv2d(WL), TDS.for_conv2d(WL)
    cfg = np.unique(np.random.default_rng(0).integers(
        0, jspace.n_choices, size=(64, 7)), axis=0)
    name = "resnet-18:conv4b"
    jpath = str(tmp_path / "jax.jsonl")
    jo = JOracle(jspace, task=name, records=JRecordLog(jpath))
    j_lat, j_feat = jo.measure(cfg)
    to = TOracle(tspace, task=name, records=TRecordLog(jpath), device="cpu")
    t_lat, t_feat = to.measure(cfg)
    assert to.stats()["misses"] == 0 and to.stats()["hits"] == len(cfg)
    np.testing.assert_array_equal(t_lat, j_lat)
    # fresh port measurements agree with the reference's recorded ones
    tpath = str(tmp_path / "torch.jsonl")
    fresh = TOracle(tspace, task=name, records=TRecordLog(tpath), device="cpu")
    f_lat, f_feat = fresh.measure(cfg)
    assert fresh.stats()["misses"] == len(cfg)
    np.testing.assert_allclose(f_lat, j_lat, rtol=1e-6)
    np.testing.assert_allclose(f_feat, j_feat, rtol=1e-6)
    rows = JRecordLog(tpath).load(task=name)
    assert len(rows) == len(cfg)
    assert set(rows[0]) == {"task", "config", "latency", "features"}
    back = JOracle(jspace, task=name, records=JRecordLog(tpath))
    back.measure(cfg)
    assert back.stats()["misses"] == 0


def test_session_shared_gbt_trace_and_unported_options(tmp_path):
    tasks = TuningTask.conv_tasks("resnet-18")[:2]
    trace = str(tmp_path / "t.json")
    rep = Session(tasks, tuner=FAST, budget=24, seed=1, device="cpu",
                  trace=trace).run()
    assert set(rep.reports) == {t.name for t in tasks}
    assert all(r.n_measurements == 24 for r in rep)
    assert rep.network_latency() == sum(r.best_latency * r.multiplicity
                                        for r in rep)
    with open(trace) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"session", "mappo-update", "measure", "surrogate-refit"} <= names
    for kw in (dict(workers=2), dict(remote="h:1"), dict(timeout_s=1.0),
               dict(monitor=0), dict(executor=object())):
        with pytest.raises(NotImplementedError, match="slice 3.*item 14"):
            Session(tasks, device="cpu", **kw)
    with pytest.raises(ValueError):
        Session(tasks, algo="bogus", device="cpu")
    with pytest.raises(ValueError):
        Session([tasks[0], tasks[0]], device="cpu")


def test_serial_executor_copy():
    ex = SerialExecutor(lambda s: 1.0 / s["tile_b"])
    ok = ex.submit("t", {"tile_b": 4})
    bad = ex.submit("t", {"tile_b": 0})
    assert ok.done() and ok.result().ok and ok.result().value == 0.25
    assert not bad.result().ok and "ZeroDivisionError" in bad.result().error
    assert ex.stats()["kind"] == "serial"


def test_slice_tune_then_deploy_matches_reference():
    """The slice end to end on the CPU: the port's Session tunes the 8
    ResNet-18 tasks, every layer deploys its task's tuned geometry through
    the GEMM, and the logits match the reference forward on the same
    weights and input."""
    import jax
    from repro.models import cnn as JC
    from repro_torch.core.task import conv_tasks
    from repro_torch.kernels import gemm as TG
    from repro_torch.models import cnn as TC
    tasks = TuningTask.conv_tasks("resnet-18", batch=2)
    rep = Session(tasks, tuner=FAST, budget=20, seed=0, device="cpu").run()
    assert all(r.n_measurements == 20 for r in rep)
    layer_task = {layer: t.name for t in conv_tasks("resnet-18", batch=2)
                  for layer in t.layer_names}
    configs = []
    for s in TC.conv_specs("resnet-18"):
        k = rep[layer_task[s.name]].best_settings
        configs.append(TG.gemm_config_from_knobs(
            k["tile_b"] * k["tile_h"] * k["tile_w"], k["tile_co"],
            k["tile_ci"] * s.kh * s.kw, k["h_threading"], k["oc_threading"]))
    tree = jax.tree.map(np.asarray, JC.init_params(jax.random.PRNGKey(0),
                                                   "resnet-18"))
    x = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(JC.apply(tree, jnp.asarray(x), "resnet-18"))
    net = TC.params_from_jax(tree, "resnet-18", device="cpu")
    got = net(torch.from_numpy(x), configs).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))
