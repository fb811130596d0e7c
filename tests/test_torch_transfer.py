"""Port parity for netopt's cross-network surrogate transfer
(tests/test_zoo_transfer.py's run cases): transfer stats and warm seeding,
stores shared with the reference, warm-from-self replay with zero new
measurements, and the co-optimizer's equal-budget win over the hw-frozen
baseline after a transfer, held over seeds."""
import dataclasses
import json

from _torch_support import one_torch_thread  # noqa: F401
from repro.compiler import surrogate_store as JS
from repro.core.cost_model import GBTModel as JGBT
from repro_torch.compiler import surrogate_store as TS
from repro_torch.compiler.netopt import (NetOptConfig, NetworkCoOptimizer,
                                         NetworkReport,
                                         network_hw_frozen_tune)
from repro_torch.compiler.task import TuningTask
from repro_torch.core import mappo
from repro_torch.core.design_space import DesignSpace
from repro_torch.core.tuner import TunerConfig

TINY = TunerConfig(iteration_opt=2, b_measure=6, episodes_per_iter=2,
                   mappo=mappo.MappoConfig(n_steps=12, n_envs=8),
                   gbt_rounds=8)
WL_A1 = dict(b=1, h=14, w=14, ci=256, co=256, kh=3, kw=3, stride=1, pad=1)
WL_A2 = dict(b=1, h=28, w=28, ci=128, co=128, kh=3, kw=3, stride=1, pad=1)
WL_B1 = dict(b=1, h=14, w=14, ci=128, co=256, kh=3, kw=3, stride=1, pad=1)
WL_B2 = dict(b=1, h=28, w=28, ci=128, co=256, kh=3, kw=3, stride=1, pad=1)
# seeds over which the transfer run's equal-budget win is held, and the
# wins required: the reference wins 13 of these 16 (losing seeds 8, 9 and
# 13), the port 13 (losing 0, 2 and 12) — ``python
# tests/torch_quality_sweep.py --bar transfer``
TRANSFER_SEEDS = range(16)
TRANSFER_WINS = 12


def _net(name, *wls):
    return [TuningTask.from_space(f"{name}{i}", DesignSpace.for_conv2d(wl))
            for i, wl in enumerate(wls)]


def _tiny_netcfg(seed=0, **kw):
    base = dict(seed_candidates=2, hw_rounds=1, hw_per_round=1,
                layer_budget=6, refine_budget=4,
                tuner=dataclasses.replace(TINY, seed=seed), seed=seed)
    base.update(kw)
    return NetOptConfig(**base)


def test_netopt_transfer_stats_and_warm_seeding(tmp_path):
    cfg = _tiny_netcfg(seed_candidates=3)
    path = str(tmp_path / "surr.jsonl")
    net_a, net_b = _net("a", WL_A1, WL_A2), _net("b", WL_B1, WL_B2)
    ra = NetworkCoOptimizer(net_a, cfg, name="netA", surrogates=path,
                            device="cpu").run()
    assert ra.surrogates["warm_hw_rows"] == 0
    assert ra.surrogates["warm_sw_rows"] == 0
    assert not ra.surrogates["warm_seeded"]
    assert ra.surrogates["hw_rows_saved"] >= ra.hw_candidates
    counts = TS.SurrogateStore(path).counts()
    assert counts["hw"] == ra.surrogates["hw_rows_saved"]
    assert counts["sw"] > 0
    rb = NetworkCoOptimizer(net_b, cfg, name="netB", surrogates=path,
                            device="cpu").run()
    assert rb.surrogates["warm_hw_rows"] == counts["hw"]
    assert rb.surrogates["warm_sw_rows"] == counts["sw"]
    assert rb.surrogates["warm_seeded"]
    hw = NetworkCoOptimizer(net_b, cfg, name="x", device="cpu").hw
    assert rb.trace[0]["hw"] == dict(zip(
        ("tile_b", "tile_ci", "tile_co"), hw.default_values(net_b)))
    assert rb.trace[1]["hw"] == dict(zip(
        ("tile_b", "tile_ci", "tile_co"), (c[-1] for c in hw.choices)))
    # the frozen baseline shares the store machinery (its win at equal
    # budget is held over seeds below)
    frozen = network_hw_frozen_tune(net_b, cfg, name="netB-frozen",
                                    surrogates=path, device="cpu")
    assert frozen.surrogates["warm_sw_rows"] > 0
    # the reference warm-starts its hardware GBT from the port's rows
    jstore = JS.SurrogateStore(path)
    assert jstore.counts() == TS.SurrogateStore(path).counts()
    assert jstore.warm_start(JGBT(n_rounds=4, n_features=14), "hw",
                             exclude_network="netC") \
        == TS.SurrogateStore(path).counts()["hw"]


def test_netopt_warm_from_self_still_replays_with_zero_measurements(
        tmp_path):
    cfg = _tiny_netcfg(seed_candidates=3)
    store = str(tmp_path / "surr.jsonl")
    records = str(tmp_path / "b.records.jsonl")
    NetworkCoOptimizer(_net("a", WL_A1), cfg, name="netA", surrogates=store,
                       device="cpu").run()
    net_b = _net("b", WL_B1, WL_B2)
    r1 = NetworkCoOptimizer(net_b, cfg, records=records, name="netB",
                            surrogates=store, device="cpu").run()
    assert r1.total_measurements > 0
    r2 = NetworkCoOptimizer(net_b, cfg, records=records, name="netB",
                            surrogates=store, device="cpu").run()
    assert r2.total_measurements == 0
    assert r2.hw_config == r1.hw_config
    assert r2.network_latency == r1.network_latency
    assert r2.surrogates["warm_hw_rows"] == r1.surrogates["warm_hw_rows"]


def test_network_report_roundtrips_surrogate_fields(tmp_path):
    rep = NetworkCoOptimizer(_net("a", WL_A1), _tiny_netcfg(), name="netA",
                             surrogates=str(tmp_path / "s.jsonl"),
                             device="cpu").run()
    assert rep.surrogates["hw_rows_saved"] >= 1
    back = NetworkReport.from_dict(json.loads(json.dumps(rep.to_dict())))
    assert back.surrogates == rep.surrogates
    assert back.measurements_to(rep.network_latency) == \
        rep.measurements_to(rep.network_latency)
    assert rep.measurements_to(0.0) is None
    hit = rep.measurements_to(float("inf"))
    assert 0 < hit <= int(rep.trace[0]["cum_measurements"])
    d = rep.to_dict()
    d.pop("surrogates")
    assert NetworkReport.from_dict(d).surrogates == {}


def test_transfer_coopt_beats_hw_frozen_on_most_seeds(tmp_path):
    """The equal-budget half of the reference's
    ``test_netopt_transfer_stats_and_warm_seeding``: network B,
    warm-started from network A's store, co-optimized at most as slow as
    the hw-frozen baseline at the co-optimizer's upper budget.  The
    reference asserts it at seed 0; at this size each candidate's session
    is one batch of 6 random software configs a layer, so the outcome is a
    property of the seed in both packages (13 wins in 16 seeds each, on
    different seeds: threefry and torch draws differ).  Held here as at
    least TRANSFER_WINS wins over TRANSFER_SEEDS."""
    wins = []
    for seed in TRANSFER_SEEDS:
        cfg = _tiny_netcfg(seed, seed_candidates=3)
        path = str(tmp_path / f"surr{seed}.jsonl")
        NetworkCoOptimizer(_net("a", WL_A1), cfg, name="netA",
                           surrogates=path, device="cpu").run()
        rb = NetworkCoOptimizer(_net("b", WL_B1, WL_B2), cfg, name="netB",
                                surrogates=path, device="cpu").run()
        assert rb.surrogates["warm_seeded"]
        frozen = network_hw_frozen_tune(_net("b", WL_B1, WL_B2), cfg,
                                        name="netB-frozen", surrogates=path,
                                        device="cpu")
        assert frozen.trace[0]["layer_budget"] == cfg.total_layer_budget()
        if rb.network_latency <= frozen.network_latency:
            wins.append(seed)
    assert len(wins) >= TRANSFER_WINS, wins
