"""Port parity for the workload zoo, the pod shard space, the input-shape
cells and the surrogate store: the same networks measure the same, stores
written by either package warm-start the other, and the reference's store
and transfer cases (tests/test_zoo_transfer.py, tests/test_partition.py)
hold in the port (the netopt transfer runs: tests/test_torch_transfer.py)."""
import contextlib
import io
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_support import one_torch_thread  # noqa: F401
from repro.compiler import surrogate_store as JS
from repro.compiler import zoo as JZ
from repro.configs import get_config as jax_get_config
from repro.configs import shapes as JSH
from repro.core.cost_model import GBTModel as JGBT
from repro_torch.compiler import cli
from repro_torch.compiler import surrogate_store as TS
from repro_torch.compiler import zoo as TZ
from repro_torch.compiler.oracle import Oracle
from repro_torch.compiler.session import Session, SessionReport
from repro_torch.compiler.task import TuningTask
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs import shapes as TSH
from repro_torch.core import mappo
from repro_torch.core.cost_model import GBTModel
from repro_torch.core.design_space import DesignSpace
from repro_torch.core.shard_space import ShardSpace, knob_values_to_settings
from repro_torch.core.tuner import TunerConfig

TINY = TunerConfig(iteration_opt=2, b_measure=6, episodes_per_iter=2,
                   mappo=mappo.MappoConfig(n_steps=12, n_envs=8),
                   gbt_rounds=8)
WL_A1 = dict(b=1, h=14, w=14, ci=256, co=256, kh=3, kw=3, stride=1, pad=1)
WL_B1 = dict(b=1, h=14, w=14, ci=128, co=256, kh=3, kw=3, stride=1, pad=1)


# ------------------------------------------------------------------- zoo

def test_zoo_registry_matches_reference():
    assert TZ.network_names() == JZ.network_names()
    assert {TZ.get_network(n).kind for n in TZ.network_names()} \
        == {JZ.get_network(n).kind for n in JZ.network_names()}
    with pytest.raises(KeyError):
        TZ.get_network("no-such-network")


@pytest.mark.parametrize("name", sorted(JZ.ZOO))
def test_zoo_network_tasks_and_measurements_match_reference(name):
    """Same task names, multiplicities, choice tables and descriptors; the
    same configs measure the same (analytical conv/GEMM in float32 as the
    reference computes them; the pod proxy exactly)."""
    jnet, tnet = JZ.get_network(name), TZ.get_network(name)
    assert (tnet.name, tnet.kind, tnet.n_tasks, tnet.n_layers) \
        == (jnet.name, jnet.kind, jnet.n_tasks, jnet.n_layers)
    assert tnet.summary() == jnet.summary()
    rng = np.random.default_rng(len(name))
    for jt, tt in zip(jnet.tasks, tnet.tasks):
        assert (tt.name, tt.multiplicity) == (jt.name, jt.multiplicity)
        assert tt.space.choices == jt.space.choices
        np.testing.assert_array_equal(tt.descriptor(), jt.descriptor())
        cfg = rng.integers(0, jt.space.n_choices, size=(24, 7))
        want = np.asarray(jt.space.measure(jnp.asarray(cfg, jnp.int32)),
                          np.float64)
        got = tt.space.measure(torch.as_tensor(cfg)).numpy().astype(
            np.float64)
        if tnet.kind == "pod":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6)
        lat, feats = tt.make_oracle(device="cpu").measure(cfg)
        jlat, jfeats = jt.make_oracle().measure(cfg)
        np.testing.assert_allclose(lat, jlat, rtol=1e-6)
        np.testing.assert_allclose(feats, jfeats, rtol=1e-6, atol=1e-7)


def test_shapes_and_shard_space_match_reference():
    assert TSH.SHAPE_NAMES == JSH.SHAPE_NAMES
    for name in TSH.SHAPE_NAMES:
        assert TSH.SHAPES[name].__dict__ == JSH.SHAPES[name].__dict__
    for arch in ARCH_NAMES:
        for name in TSH.SHAPE_NAMES:
            assert TSH.cell_supported(get_config(arch), TSH.SHAPES[name]) \
                == JSH.cell_supported(jax_get_config(arch),
                                      JSH.SHAPES[name])
    # input_specs: meta tensors of the reference's ShapeDtypeStructs'
    # shapes and dtypes; a decode cache of the same elements in all (the
    # reference stacks each period position's layers)
    import jax
    for arch in ("qwen2-1.5b", "whisper-base", "internvl2-26b",
                 "xlstm-1.3b"):
        for name in TSH.SHAPE_NAMES:
            got = TSH.input_specs(get_config(arch), TSH.SHAPES[name], 4)
            want = JSH.input_specs(jax_get_config(arch), JSH.SHAPES[name], 4)
            assert set(got) == set(want), (arch, name)
            for k in set(got) - {"cache"}:
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == tuple(want[k].shape)
                assert str(got[k].dtype).split(".")[-1] == \
                    str(want[k].dtype), (arch, name, k)
            if "cache" in got:
                n_got = sum(t.numel() for t in jax.tree.leaves(
                    got["cache"]))
                n_want = sum(int(np.prod(t.shape)) for t in jax.tree.leaves(
                    want["cache"]))
                assert n_got == n_want, (arch, name)
    from repro.core import shard_space as JSS
    for arch, shape, n in (("qwen2-1.5b", "train_4k", 256),
                           ("qwen1.5-4b", "decode_32k", 16)):
        fn = TZ.pod_proxy_measure(28, 1536, 4096, 256, n, train=True)
        ts = ShardSpace.for_cell(arch, shape, fn, n_devices=n)
        js = JSS.ShardSpace.for_cell(arch, shape, fn, n_devices=n)
        assert ts.choices == js.choices and ts.workload == js.workload
        assert ts.cell_features == js.cell_features
        np.testing.assert_array_equal(ts.workload_features(),
                                      js.workload_features())
        for vals in ((4, 1, 1, 1, 1, 256, 1), (256, 2, 2, 8, 2, 4096, 2)):
            assert knob_values_to_settings(vals) \
                == JSS.knob_values_to_settings(np.asarray(vals, float))


def test_pod_proxy_separates_configs():
    space = TZ.get_network("pod-cells").tasks[0].space
    cfgs = np.zeros((len(space.choices[0]), space.n_knobs), np.int64)
    cfgs[:, 0] = np.arange(len(space.choices[0]))
    lats = space.measure(torch.as_tensor(cfgs)).numpy()
    assert len(set(lats.tolist())) > 1 and np.isfinite(lats).all()


# -------------------------------------------------------- surrogate store

def _write_rows(mod, path):
    store = mod.SurrogateStore(path)
    rng = np.random.default_rng(0)
    x = rng.random((6, 18)).astype(np.float32)
    assert store.add_many("sw", x, np.arange(6) / 7.0, network="netA") == 6
    assert store.add_many("sw", x[:3], np.arange(3) / 7.0,
                          network="netA") == 0          # exact duplicates
    assert store.add("sw", x[0], 9.5, network="netB")
    assert store.add("hw", rng.random(14), 0.25, network="netA")
    assert store.add("hw", rng.random(30), 0.5, network="netA", segs=2)
    assert store.add("sw", x[1] + 1, 3.5, network="pod", family="pod")
    return store


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_stores_cross_between_packages(writer, tmp_path):
    """Rows written by either package load in the other with the same
    dedup, filters and warm-start counts."""
    path = str(tmp_path / "s.jsonl")
    _write_rows(JS if writer == "reference" else TS, path)
    js, ts = JS.SurrogateStore(path), TS.SurrogateStore(path)
    assert ts.counts() == js.counts() == {"sw": 8, "hw": 2}
    assert ts.networks() == js.networks()
    for kind, dim, excl, fam in (("sw", 18, None, "core"),
                                 ("sw", 18, "netA", "core"),
                                 ("sw", 18, None, "pod"),
                                 ("hw", 14, None, "core"),
                                 ("hw", 30, "netB", "core")):
        for got, want in zip(ts.rows(kind, dim, excl, fam),
                             js.rows(kind, dim, excl, fam)):
            np.testing.assert_array_equal(got, want)
    tg, jg = GBTModel(n_rounds=4), JGBT(n_rounds=4)
    assert ts.warm_start(tg, "sw", exclude_network="netB") \
        == js.warm_start(jg, "sw", exclude_network="netB") == 6
    np.testing.assert_allclose(tg.predict(np.zeros((2, 18), np.float32)),
                               np.asarray(jg.predict(np.zeros((2, 18)))),
                               rtol=1e-6)
    # a dup appended by the other package is still a dup
    other = TS if writer == "reference" else JS
    x = np.asarray(js.rows("sw", 18, "netB")[0][0])
    assert not other.SurrogateStore(path).add("sw", x, 0.0, network="netA")
    merged = TS.SurrogateStore(str(tmp_path / "m.jsonl"))
    assert merged.merge_from(path) == 10 and merged.merge_from(path) == 0
    assert JS.SurrogateStore(merged.path).counts() == {"sw": 8, "hw": 2}


def test_store_rejects_schema_mismatch(tmp_path):
    path = str(tmp_path / "stale.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"schema": "repro-surrogate/0", "kind": "sw",
                            "dim": 2, "x": [0.0, 1.0], "y": 1.0}) + "\n")
    with pytest.raises(TS.SurrogateSchemaError):
        TS.SurrogateStore(path).counts()
    with open(path, "w") as f:
        f.write(json.dumps({"schema": TS.SCHEMA, "kind": "wat", "dim": 1,
                            "x": [0.0], "y": 1.0}) + "\n")
    with pytest.raises(TS.SurrogateSchemaError):
        TS.SurrogateStore(path).rows("sw", 18)
    assert TS.SCHEMA == JS.SCHEMA == "repro-surrogate/2"
    assert TS.COMPATIBLE_SCHEMAS == JS.COMPATIBLE_SCHEMAS
    with pytest.raises(ValueError):
        TS.SurrogateStore(str(tmp_path / "ok.jsonl")).add("bogus", [0.0], 0)


def test_recording_gbt_tees_updates_but_not_primes(tmp_path):
    store = TS.SurrogateStore(str(tmp_path / "s.jsonl"))
    gbt = TS.RecordingGBT(n_rounds=4, n_features=18, store=store,
                          network="netA")
    rng = np.random.default_rng(0)
    gbt.prime(rng.random((5, 18)), rng.random(5))  # warm start: not recorded
    assert store.counts()["sw"] == 0
    gbt.update(rng.random((3, 18)), rng.random(3))  # training rows: recorded
    assert store.counts()["sw"] == 3 and gbt.n_samples == 8
    g2 = GBTModel(n_rounds=4, n_features=18)
    assert store.warm_start(g2, "sw") == 3 and g2.n_samples == 3
    g3 = TS.RecordingGBT(n_rounds=4, n_features=18, store=store,
                         network="netB")
    assert store.warm_start(g3, "sw", exclude_network="netA") == 0
    # failure-penalty rows train the in-run GBT but are never persisted;
    # the analytical 1e12 infeasibility sentinel is knowledge and is kept
    lats = np.asarray([Oracle.penalty_latency, 1e12, 1e-4])
    gbt.update(rng.random((3, 18)), -np.log(lats))
    assert gbt.n_samples == 11 and store.counts()["sw"] == 5
    assert TS._PENALTY_Y == JS._PENALTY_Y


def test_store_compact_bounds_size_and_keeps_frontier(tmp_path):
    path = str(tmp_path / "s.jsonl")
    store = TS.SurrogateStore(path)
    rng = np.random.default_rng(0)
    ys = rng.permutation(200).astype(float)
    for y in ys:
        store.add("sw", rng.random(18), float(y), network="netA")
    size_before = os.path.getsize(path)
    stats = store.compact(keep_best=32)
    assert stats["kept"] + stats["dropped"] == 200
    assert os.path.getsize(path) < size_before
    _, kept_y = TS.SurrogateStore(path).rows("sw", 18)
    best, frontier = -np.inf, []
    for y in ys:
        if y > best:
            best = y
            frontier.append(float(y))
    assert set(frontier) <= set(kept_y.tolist())
    assert set(np.sort(ys)[-32:].tolist()) <= set(kept_y.tolist())
    assert store.compact(keep_best=32)["dropped"] == 0
    # the reference compacts the port's store to the same rows
    jstore = JS.SurrogateStore(path)
    assert jstore.compact(keep_best=32)["dropped"] == 0
    with pytest.raises(ValueError):
        TS.SurrogateStore(path, readonly=True).compact()


# ------------------------------------------------------------- sessions

def test_session_saves_and_warm_starts_sw_rows(tmp_path):
    path = str(tmp_path / "surr.jsonl")
    t_a = TuningTask.from_space("a", DesignSpace.for_conv2d(WL_A1))
    t_b = TuningTask.from_space("b", DesignSpace.for_conv2d(WL_B1))
    sr_a = Session(t_a, tuner=TINY, budget=6, surrogates=path,
                   device="cpu").run()
    assert sr_a.surrogates["warm_sw_rows"] == 0
    n_rows = TS.SurrogateStore(path).counts()["sw"]
    assert n_rows >= 6
    sr_b = Session(t_b, tuner=TINY, budget=6, surrogates=path,
                   device="cpu").run()
    assert sr_b.surrogates["warm_sw_rows"] == n_rows
    sr_a2 = Session(t_a, tuner=TINY, budget=6, surrogates=path,
                    device="cpu").run()
    assert sr_a2.surrogates["warm_sw_rows"] == \
        TS.SurrogateStore(path).counts()["sw"] - n_rows
    back = SessionReport.from_dict(json.loads(json.dumps(sr_a.to_dict())))
    assert back.surrogates == sr_a.surrogates
    with pytest.raises(ValueError):
        Session(t_a, tuner=TINY, budget=4, surrogates=path,
                gbt=GBTModel(n_rounds=4), device="cpu")
    with pytest.raises(ValueError):
        Session(t_a, tuner=TINY, budget=4, surrogates=path,
                share_cost_model=False, device="cpu")
    pod = TZ.get_network("pod-cells").tasks[0]
    with pytest.raises(ValueError):   # rows carry ONE space family
        Session([t_a, pod], tuner=TINY, surrogates=path, device="cpu")


def _cli(*argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert cli.main(list(argv)) == 0
    return json.loads(out.getvalue()), err.getvalue()


def test_cli_zoo_save_then_warm_from(tmp_path):
    """The verify skill's transfer smoke: a pod network saves its rows,
    another warm-starts from them; a missing store exits loudly."""
    surr = str(tmp_path / "surr.jsonl")
    common = ("--seed-candidates", "3", "--hw-rounds", "1", "--hw-per-round",
              "1", "--layer-budget", "4", "--refine-budget", "0",
              "--device", "cpu")
    first, _ = _cli("netopt", "--network", "pod-cells-4b", *common,
                    "--save-surrogates", surr)
    assert first["surrogates"]["hw_rows_saved"] >= 3
    assert TS.SurrogateStore(surr).counts()["sw"] > 0
    second, _ = _cli("netopt", "--network", "pod-cells", *common,
                     "--warm-from", surr)
    s = second["surrogates"]
    assert s["warm_hw_rows"] > 0 and s["warm_sw_rows"] > 0
    assert s["warm_seeded"] and s["readonly"]
    _, err = _cli("netopt", "--network", "pod-cells", *common,
                  "--save-surrogates", surr, "--compact")
    assert "compacted" in err
    tuned, _ = _cli("tune", "--network", "bert-gemm", "--budget", "3",
                    "--save-surrogates", str(tmp_path / "t.jsonl"),
                    "--device", "cpu")
    assert tuned["surrogates"]["warm_sw_rows"] == 0
    assert len(tuned["reports"]) == 4
    with pytest.raises(SystemExit):
        _cli("netopt", "--network", "pod-cells", *common,
             "--warm-from", str(tmp_path / "missing.jsonl"))
    with pytest.raises(SystemExit):
        _cli("netopt", "--network", "pod-cells", *common, "--compact")
