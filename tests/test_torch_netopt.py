"""Port parity for network-scope co-optimization (``compiler/netopt``): the
hardware candidate and partition spaces, the genetic operators and the
analytical netopt helpers draw-for-draw against the reference, its
``NetworkReport`` documents both ways, and the reference's own quality bars
(tests/test_netopt.py, tests/test_partition.py) at their sizes."""
import contextlib
import io
import json

import numpy as np
import pytest

from _torch_support import one_torch_thread  # noqa: F401
from repro.compiler import netopt as JN
from repro.compiler.netopt import genetic as JG
from repro.compiler.task import TuningTask as JT
from repro.core import mappo as JM
from repro.core.design_space import DesignSpace as JDS
from repro.core.tuner import TunerConfig as JTC
from repro.hw import analytical as JA
from repro_torch.compiler import cli
from repro_torch.compiler import netopt as TN
from repro_torch.compiler.netopt import genetic as TG
from repro_torch.compiler.session import Session
from repro_torch.compiler.task import TuningTask as TT
from repro_torch.core import mappo as TM
from repro_torch.core.design_space import DesignSpace as TDS
from repro_torch.core.tuner import TunerConfig as TTC
from repro_torch.hw import analytical as TA

WL_BIG = dict(b=1, h=14, w=14, ci=256, co=256, kh=3, kw=3, stride=1, pad=1)
WL_MID = dict(b=1, h=28, w=28, ci=128, co=128, kh=3, kw=3, stride=1, pad=1)
TINY = TTC(iteration_opt=3, b_measure=8, episodes_per_iter=2,
           mappo=TM.MappoConfig(n_steps=16, n_envs=8), gbt_rounds=10)
JTINY = JTC(iteration_opt=3, b_measure=8, episodes_per_iter=2,
            mappo=JM.MappoConfig(n_steps=16, n_envs=8), gbt_rounds=10)


def _toy(T, DS):
    return [T.from_space("c1", DS.for_conv2d(WL_BIG), multiplicity=2),
            T.from_space("c2", DS.for_conv2d(WL_MID), multiplicity=1)]


@pytest.fixture(scope="module")
def tasks():
    return _toy(TT, TDS)


@pytest.fixture(scope="module")
def jtasks():
    return _toy(JT, JDS)


def _tiny_netcfg(**kw):
    base = dict(seed_candidates=2, hw_rounds=1, hw_per_round=1,
                layer_budget=8, refine_budget=8, tuner=TINY)
    base.update(kw)
    return TN.NetOptConfig(**base)


def _task_lists():
    """(reference, port) ordered task lists: the toy pair and ResNet-18's
    8 conv tasks (cuts at K=2 and K=3 over 7 positions)."""
    return [(_toy(JT, JDS), _toy(TT, TDS)),
            (JT.conv_tasks("resnet-18"), TT.conv_tasks("resnet-18"))]


def _tuples(parts):
    return [(p.cuts, p.hw_values) for p in parts]


# ----------------------------------------------------------- exact parity

def test_hw_candidate_space_and_tag_match_reference():
    for jts, tts in _task_lists():
        jh, th = JN.HwCandidateSpace.from_tasks(jts), \
            TN.HwCandidateSpace.from_tasks(tts)
        assert th.choices == jh.choices and th.agg_wfeat == jh.agg_wfeat
        assert th.size == jh.size
        np.testing.assert_array_equal(th.all_index_configs(),
                                      jh.all_index_configs())
        for v in ((1, 64, 128), (3, 100, 7), (4096, 1, 1)):
            np.testing.assert_array_equal(th.index_config(v),
                                          jh.index_config(v))
            np.testing.assert_array_equal(th.features(v), jh.features(v))
            assert TN.hw_tag(v) == JN.hw_tag(v)
            assert TN.hw_dict(v) == JN.hw_dict(v)
        assert th.default_values(tts) == jh.default_values(jts)
        for seed in (0, 5):
            assert th.seed_values(5, tts, np.random.default_rng(seed)) \
                == jh.seed_values(5, jts, np.random.default_rng(seed))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_partition_space_matches_reference(k):
    for jts, tts in _task_lists():
        jp, tp = JN.PartitionSpace(jts, k), TN.PartitionSpace(tts, k)
        assert tp.k == jp.k and tp.n_features == jp.n_features
        assert tp.all_cuts() == jp.all_cuts()
        assert tp.balanced_cuts() == jp.balanced_cuts()
        np.testing.assert_array_equal(tp.n_choices, jp.n_choices)
        jd, td = jp.default_partition(), tp.default_partition()
        assert (td.cuts, td.hw_values) == (jd.cuts, jd.hw_values)
        assert td.tags() == jd.tags() and td.to_dict() == jd.to_dict()
        for seed in (0, 3):
            jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
            assert _tuples([tp.random_partition(tr) for _ in range(4)]) \
                == _tuples([jp.random_partition(jr) for _ in range(4)])
            assert _tuples(tp.seed_partitions(5, tr)) \
                == _tuples(jp.seed_partitions(5, jr))
            assert _tuples(tp.candidate_pool(seed, limit=24)) \
                == _tuples(jp.candidate_pool(seed, limit=24))
        pool = tp.candidate_pool(0, limit=24)
        jpool = jp.candidate_pool(0, limit=24)
        lat = {t.name: 1e-5 * (i + 1) for i, t in enumerate(tts)}
        for p, q in zip(pool, jpool):
            np.testing.assert_array_equal(tp.features(p), jp.features(q))
            np.testing.assert_array_equal(tp.encode(p), jp.encode(q))
            assert tp.boundary_bytes(p) == jp.boundary_bytes(q)
            assert tp.pipeline_latency(p, lat) == jp.pipeline_latency(q, lat)
            assert tp.area_mm2(p) == jp.area_mm2(q)
        rng = np.random.default_rng(11)
        for _ in range(8):   # decode is total over out-of-range vectors
            vec = rng.integers(-2, 14, size=len(tp.n_choices))
            d, e = tp.decode(vec), jp.decode(vec)
            assert (d.cuts, d.hw_values) == (e.cuts, e.hw_values)
            c, f = tp.canonical(d.cuts, [(3, 100, 7)] * d.k), \
                jp.canonical(e.cuts, [(3, 100, 7)] * e.k)
            assert (c.cuts, c.hw_values) == (f.cuts, f.hw_values)


@pytest.mark.parametrize("k", [1, 2])
def test_genetic_operators_match_reference(k):
    jts, tts = _task_lists()[1]
    jp, tp = JN.PartitionSpace(jts, k), TN.PartitionSpace(tts, k)
    jr, tr = np.random.default_rng(3), np.random.default_rng(3)
    ja, jb = jp.seed_partitions(2, jr)
    ta, tb = tp.seed_partitions(2, tr)
    for _ in range(24):
        jc = JG.mutate(jp, JG.crossover(jp, ja, jb, jr), jr)
        tc = TG.mutate(tp, TG.crossover(tp, ta, tb, tr), tr)
        assert (tc.cuts, tc.hw_values) == (jc.cuts, jc.hw_values)
        assert tp.canonical(tc.cuts, tc.hw_values) == tc
        ja, jb, ta, tb = jb, jc, tb, tc


def test_analytical_netopt_helpers_match_reference():
    for t in TT.conv_tasks("resnet-18", batch=8):
        wl = t.space.workload
        assert TA.activation_out_bytes("conv2d", wl) \
            == JA.activation_out_bytes("conv2d", wl)
    for wl in (dict(m=128, n=768, k=3072), dict(m=7, n=3, k=1)):
        assert TA.activation_out_bytes("matmul", wl) \
            == JA.activation_out_bytes("matmul", wl)
    assert TA.activation_out_bytes("pod", {}) == 0.0
    for nb in (0.0, 1.0, 3.2e6, 1e9):
        assert TA.interchip_transfer_s(nb) == JA.interchip_transfer_s(nb)
    for geom in ((1, 1, 1), (1, 64, 64), (8, 256, 256), (256, 4096, 2048)):
        assert TA.chip_area_mm2(*geom) == JA.chip_area_mm2(*geom)


def test_network_report_documents_cross_both_ways(tasks, jtasks, tmp_path):
    """A document written by a reference run reads in the port and writes
    back the same JSON; a port run's document does the same in the
    reference."""
    jcfg = JN.NetOptConfig(seed_candidates=1, hw_rounds=1, hw_per_round=1,
                           layer_budget=4, refine_budget=4, tuner=JTINY,
                           k_chips=2)
    jdoc = json.loads(json.dumps(JN.NetworkCoOptimizer(
        jtasks, jcfg, name="toy").run().to_dict()))
    back = TN.NetworkReport.from_dict(jdoc)
    assert json.dumps(back.to_dict(), sort_keys=True) \
        == json.dumps(jdoc, sort_keys=True)
    assert back.pareto() == JN.NetworkReport.from_dict(jdoc).pareto()
    assert back.verify_shared_hardware()
    tdoc = json.loads(json.dumps(TN.NetworkCoOptimizer(
        tasks, _tiny_netcfg(), name="toy", device="cpu").run().to_dict()))
    jback = JN.NetworkReport.from_dict(tdoc)
    assert json.dumps(jback.to_dict(), sort_keys=True) \
        == json.dumps(tdoc, sort_keys=True)
    assert jback.hw_config == tdoc["hw_config"]
    assert jback.progress() == TN.NetworkReport.from_dict(tdoc).progress()


# ----------------------------------------------------------- quality bars

def test_coopt_shared_chip_and_equal_budget_win(tasks, tmp_path):
    cfg = _tiny_netcfg()
    rep = TN.NetworkCoOptimizer(tasks, cfg,
                                records=str(tmp_path / "coopt.jsonl"),
                                name="toy", device="cpu").run()
    frozen = TN.network_hw_frozen_tune(
        tasks, cfg, records=str(tmp_path / "frozen.jsonl"), name="toy",
        device="cpu")
    # ONE shared hardware config, identical across all layer mappings
    assert rep.verify_shared_hardware()
    for layer in rep.layers.values():
        assert layer["hardware"] == rep.hw_config
        assert set(layer["mapping"]).isdisjoint(rep.hw_config)
        assert all(layer["hw_utilized"][k] <= rep.hw_config[k]
                   for k in layer["hw_utilized"])
    assert rep.network_latency == pytest.approx(sum(
        l["latency"] * l["multiplicity"] for l in rep.layers.values()))
    assert rep.n_layers == 3
    # the headline: co-optimized <= network hw-frozen at equal budget
    assert frozen.trace[0]["layer_budget"] == cfg.total_layer_budget()
    assert rep.total_measurements <= cfg.total_layer_budget() * len(tasks)
    assert rep.network_latency <= frozen.network_latency
    assert rep.hw_candidates >= cfg.seed_candidates
    assert [r["phase"] for r in rep.trace][0] == "seed"
    assert rep.trace[-1]["phase"] == "refine"
    assert rep.progress()[-1][1] == rep.network_latency
    assert rep.total_measurements == rep.trace[-1]["cum_measurements"]
    front = rep.pareto()
    assert front and front[0][0] == rep.network_latency
    assert all(a[0] < b[0] and a[1] > b[1]
               for a, b in zip(front, front[1:]))
    back = TN.NetworkReport.from_dict(json.loads(json.dumps(rep.to_dict())))
    assert back.network_latency == rep.network_latency
    assert back.hw_config == rep.hw_config
    assert back.progress() == rep.progress()
    assert back.pareto() == rep.pareto()


def test_coopt_warm_resume_replays_from_records(tasks, tmp_path):
    cfg = _tiny_netcfg()
    path = str(tmp_path / "resume.jsonl")
    r1 = TN.NetworkCoOptimizer(tasks, cfg, records=path, name="toy",
                               device="cpu").run()
    assert r1.total_measurements > 0
    with open(path) as f:   # K=1 record tags carry no segment suffix
        assert all("#seg" not in json.loads(ln)["task"] for ln in f
                   if ln.strip())
    r2 = TN.NetworkCoOptimizer(tasks, cfg, records=path, name="toy",
                               device="cpu").run()
    assert r2.total_measurements == 0  # every (hw, layer) row replayed
    assert r2.hw_config == r1.hw_config
    assert r2.network_latency == r1.network_latency


def test_network_random_hw_baseline(tasks):
    cfg = _tiny_netcfg(refine_budget=0)
    rep = TN.network_random_hw_tune(tasks, cfg, n_candidates=2, name="toy",
                                    device="cpu")
    assert rep.algo == "random_hw"
    assert rep.hw_candidates == 2
    assert all(r["phase"] == "random" for r in rep.trace)
    assert rep.verify_shared_hardware()
    assert rep.trace[0]["layer_budget"] == cfg.total_layer_budget() // 2


def test_k2_coopt_pipeline_beats_k1_and_resumes(tasks, tmp_path):
    r1 = TN.NetworkCoOptimizer(tasks, _tiny_netcfg(), name="toy",
                               device="cpu").run()
    cfg2 = _tiny_netcfg(k_chips=2)
    path = str(tmp_path / "k2.jsonl")
    r2 = TN.NetworkCoOptimizer(tasks, cfg2, records=path, name="toy",
                               device="cpu").run()
    assert r2.k_chips == 2 and len(r2.hw_configs) == 2
    assert r2.partition["k"] == 2 and r2.partition["cuts"] == [1]
    assert r2.verify_shared_hardware()
    assert set(r2.partition["assignment"].values()) == {0, 1}
    assert r2.network_latency <= r1.network_latency
    assert all(isinstance(row["hw"], list) and row["cuts"] == [1]
               for row in r2.trace)
    with pytest.raises(ValueError):
        _ = r2.hw_config
    r3 = TN.NetworkCoOptimizer(tasks, cfg2, records=path, name="toy",
                               device="cpu").run()
    assert r3.total_measurements == 0
    assert r3.network_latency == r2.network_latency
    assert r3.hw_configs == r2.hw_configs
    back = TN.NetworkReport.from_dict(json.loads(json.dumps(r2.to_dict())))
    assert back.partition == r2.partition
    assert back.hw_configs == r2.hw_configs
    assert back.pareto() == r2.pareto()


def test_genetic_baseline_equal_budget(tasks):
    cfg = _tiny_netcfg(k_chips=2)
    rep = TN.network_genetic_hw_tune(tasks, cfg, name="toy", device="cpu")
    assert rep.algo == "genetic"
    assert rep.k_chips == 2
    assert all(r["phase"] == "genetic" for r in rep.trace)
    assert rep.verify_shared_hardware()
    n_evals = cfg.n_candidates + 1
    per_layer = max(cfg.total_layer_budget() // n_evals, 1)
    assert rep.trace[0]["layer_budget"] == per_layer
    assert rep.hw_candidates <= n_evals
    assert rep.total_measurements <= cfg.total_layer_budget() * len(tasks)
    rep1 = TN.network_genetic_hw_tune(tasks, _tiny_netcfg(), k_chips=2,
                                      name="toy", device="cpu")
    assert rep1.k_chips == 2


def test_stop_on_stable_ranking_saves_measurements(tasks):
    cfg = _tiny_netcfg(hw_rounds=3, stop_on_stable_ranking=1)
    rep = TN.NetworkCoOptimizer(tasks, cfg, name="toy", device="cpu").run()
    es = rep.early_stop
    assert es, "the toy landscape must trigger the stable-ranking stop"
    assert es["stable_refits"] == 1
    assert es["skipped_candidates"] == 2
    assert es["measurements_saved"] \
        == es["skipped_candidates"] * cfg.layer_budget * len(tasks)
    markers = [r for r in rep.trace if r.get("phase") == "early_stop"]
    assert len(markers) == 1
    assert markers[0]["measurements_saved"] == es["measurements_saved"]
    assert rep.trace[-1]["phase"] == "refine"
    assert rep.progress() and rep.pareto()
    assert rep.hw_candidates < cfg.n_candidates
    rep0 = TN.NetworkCoOptimizer(tasks, _tiny_netcfg(hw_rounds=3),
                                 name="toy", device="cpu").run()
    assert not rep0.early_stop
    assert rep0.hw_candidates == _tiny_netcfg(hw_rounds=3).n_candidates


def test_real_runs_emit_monotone_trajectories(tasks):
    rep = TN.NetworkCoOptimizer(tasks, _tiny_netcfg(), name="toy",
                                device="cpu").run()
    assert any(row.get("trajectory") for row in rep.trace)
    for row in rep.trace:
        traj = row.get("trajectory", [])
        lats = [lat for _, lat in traj]
        assert lats == sorted(lats, reverse=True)
        if traj:
            assert traj[-1][0] <= row["new_measurements"]
            assert traj[-1][1] == row["network_latency"]


def test_pinned_session_and_fabric_options(tasks):
    """A pinned task keys its records per pin and never moves the pinned
    knobs; the measurement fabric's options behave as the reference's: one
    transport a run, a timeout only where measurements can be preempted,
    and a pool's final stats in the report."""
    t = tasks[0].pinned(TN.HW_KNOBS, (1, 64, 128), "hw[b1,ci64,co128]")
    assert t.name == "c1#hw[b1,ci64,co128]"
    np.testing.assert_array_equal(t.descriptor(), tasks[0].descriptor())
    rep = Session(t, tuner=TINY, budget=8, device="cpu").run()
    assert rep.single.best_config[:3] == [0, 0, 0]
    with pytest.raises(ValueError, match="mutually exclusive"):
        TN.NetworkCoOptimizer(tasks, _tiny_netcfg(), device="cpu",
                              workers=2, remote="h:1")
    with pytest.raises(ValueError, match="timeout_s needs workers"):
        Session(t, tuner=TINY, budget=8, device="cpu", timeout_s=5.0)
    pooled = TN.network_hw_frozen_tune(tasks, _tiny_netcfg(), device="cpu",
                                       workers=2)
    plain = TN.network_hw_frozen_tune(tasks, _tiny_netcfg(), device="cpu")
    assert pooled.executor_stats["kind"] == "subprocess"
    assert pooled.executor_stats["jobs"] == 0  # analytical: in-process
    assert pooled.network_latency == plain.network_latency


def _cli(*argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert cli.main(list(argv)) == 0
    return json.loads(out.getvalue()), err.getvalue()


SMOKE = ("netopt", "--model", "resnet-18", "--max-tasks", "2",
         "--seed-candidates", "2", "--hw-rounds", "0", "--layer-budget", "4",
         "--refine-budget", "4", "--device", "cpu")


@pytest.mark.parametrize("extra", [(), ("--k-chips", "2"),
                                   ("--baseline", "hw-frozen"),
                                   ("--baseline", "random-hw"),
                                   ("--baseline", "genetic", "--k-chips", "2")],
                         ids=" ".join)
def test_cli_netopt_smoke(extra, tmp_path):
    """The verify skill's smoke sizes, K=1 and K=2 and each baseline, with
    a records file that replays on a second run."""
    rec = str(tmp_path / "r.jsonl")
    doc, err = _cli(*SMOKE, "--records", rec, *extra)
    rep = TN.NetworkReport.from_dict(doc)
    k = 2 if "--k-chips" in extra else 1
    assert rep.k_chips == k and len(rep.hw_configs) == k
    assert rep.verify_shared_hardware() and rep.trace
    assert ("2-chip pipeline" in err) == (k == 2)
    assert rep.algo == {"hw-frozen": "hw_frozen", "random-hw": "random_hw",
                        "genetic": "genetic"}.get(dict(
                            zip(extra[::2], extra[1::2])).get("--baseline"),
                            "netopt")
    if k == 2:
        assert len(rep.partition["cuts"]) == 1
    again, _ = _cli(*SMOKE, "--records", rec, *extra)
    assert again["total_measurements"] == 0
