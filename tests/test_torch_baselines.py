"""Port parity for the paper's baselines (random, AutoTVM, CHAMELEON): the
numpy parts draw-for-draw, the CHAMELEON agent's factored logits on the
reference's parameters, the reference's quality bars, and the baselines
through ``Session`` and the CLI."""
import contextlib
import dataclasses
import io
import json

import numpy as np
import jax
import pytest
import torch

from _torch_support import one_torch_thread  # noqa: F401
from repro.core import baselines as JB
from repro.core.design_space import DesignSpace as JDS
from repro.core.task import conv_tasks as jax_conv_tasks
from repro_torch.compiler import cli
from repro_torch.compiler.session import Session
from repro_torch.compiler.task import TuningTask
from repro_torch.core import baselines as TB
from repro_torch.core import mappo
from repro_torch.core.design_space import DesignSpace as TDS
from repro_torch.core.task import conv_tasks as torch_conv_tasks
from repro_torch.core.tuner import TunerConfig, arco_tune

WL = dict(b=1, h=14, w=14, ci=128, co=128, kh=3, kw=3, stride=1, pad=1)
FAST = TunerConfig.fast()


def _space_pairs():
    """(reference space, port space): ResNet-18's 8 conv tasks at batch 8
    and two GEMMs."""
    pairs = [(j.space, t.space) for j, t in zip(
        jax_conv_tasks("resnet-18", batch=8),
        torch_conv_tasks("resnet-18", batch=8))]
    for m, n, k in ((128, 768, 3072), (64, 32, 128)):
        pairs.append((JDS.for_matmul(m, n, k), TDS.for_matmul(m, n, k)))
    return pairs


def test_default_geometry_pinning_and_frozen_mask_match_reference():
    for jspace, tspace in _space_pairs():
        np.testing.assert_array_equal(TB.default_hardware_config(tspace),
                                      JB.default_hardware_config(jspace))
        np.testing.assert_array_equal(TB.default_hardware_values(tspace),
                                      JB.default_hardware_values(jspace))
        for values in (None, (2, 8, 64)):
            jp = JB.hw_pinned_space(jspace, values)
            tp = TB.hw_pinned_space(tspace, values)
            assert tp.choices == jp.choices and tp.pinned == jp.pinned
            assert tp.size == jp.size
        for got, want in zip(TB.frozen_mask_and_base(tspace),
                             JB.frozen_mask_and_base(jspace)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7])
def test_numpy_draws_match_reference_draw_for_draw(seed):
    """``_random_configs``, ``_seed_configs`` and ``_kmeans`` are numpy in
    both packages: the same Generator seed gives the same arrays."""
    jspace, tspace = JDS.for_conv2d(WL), TDS.for_conv2d(WL)
    frozen, base = JB.frozen_mask_and_base(jspace)
    for fb in ((None, None), (frozen, base)):
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(TB._random_configs(tspace, tr, 40, *fb),
                                      JB._random_configs(jspace, jr, 40, *fb))
        np.testing.assert_array_equal(TB._seed_configs(tspace, tr, 16, *fb),
                                      JB._seed_configs(jspace, jr, 16, *fb))
    X = np.random.default_rng(seed + 1).integers(0, 6, (50, 7)).astype(
        np.float64)
    for k in (1, 5, 16, 80):
        got = TB._kmeans(X, k, np.random.default_rng(seed))
        want = JB._kmeans(X, k, np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)


def test_factored_logits_match_reference_on_its_parameters():
    tree = jax.tree.map(np.asarray,
                        JB._init_single_agent(jax.random.PRNGKey(2)))
    agent = TB.single_agent_from_jax(tree, device="cpu")
    state = np.random.default_rng(0).random((5, 3, 18)).astype(np.float32)
    want = np.asarray(JB._factored_logits(tree, state))
    with torch.no_grad():
        got = TB._factored_logits(agent, torch.from_numpy(state)).numpy()
    assert got.shape == want.shape == (5, 3, 7, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the critic rides along: same value head on the same state
    want_v = np.asarray(JB.A.critic_value(tree["critic"], state))
    with torch.no_grad():
        got_v = agent.critic(torch.from_numpy(state)).numpy()
    np.testing.assert_allclose(got_v, want_v, rtol=1e-6, atol=1e-6)


def test_baselines_respect_frozen_hardware_knobs():
    """The reference's bar (tests/test_tuner.py): every baseline's best
    config keeps the default hardware geometry."""
    space = TDS.for_conv2d(WL)
    hw_default = TB.default_hardware_config(space)
    for tune in (TB.random_tune, TB.autotvm_tune, TB.chameleon_tune):
        r = tune(space, FAST, device="cpu")
        assert r.n_measurements == FAST.iteration_opt * FAST.b_measure
        np.testing.assert_array_equal(r.best_config[:3], hw_default)


def test_arco_beats_autotvm_and_random_on_seed_median():
    """The baseline half of the reference's short-horizon bar
    (``test_arco_short_horizon_convergence_deterministic``): at budget 160
    ARCO beats AutoTVM and random search.  The reference holds it on one
    seed; JAX's threefry draws cannot be reproduced here, and ARCO's
    result moves with the seed (ROADMAP Queue 3), so the bar is held on
    the median of seeds 0-2, as the port's convergence bar is.  The
    hw-frozen baselines reach the frozen space's optimum (1.72x the full
    optimum) on every seed; ARCO lands at 1.00x, 1.88x and 1.24x."""
    space = TDS.for_conv2d(WL)
    best = {"arco": [], "autotvm": [], "random": []}
    for seed in (0, 1, 2):
        cfg = TunerConfig(iteration_opt=5, b_measure=32, episodes_per_iter=3,
                          mappo=mappo.MappoConfig(n_steps=48, n_envs=16),
                          gbt_rounds=20, seed=seed, b_growth=0.6)
        for name, tune in (("arco", arco_tune), ("autotvm", TB.autotvm_tune),
                           ("random", TB.random_tune)):
            r = tune(space, cfg, budget=160, device="cpu")
            assert r.n_measurements <= 160
            best[name].append(r.best_latency)
    med = {k: float(np.median(v)) for k, v in best.items()}
    assert med["arco"] < med["autotvm"], best
    assert med["arco"] < med["random"], best


def test_chameleon_episode_updates_agent_and_stays_in_bounds():
    space = TDS.for_conv2d(WL)
    env = mappo.env_params_from_space(space, device="cpu")
    frozen_np, base_np = TB.frozen_mask_and_base(space)
    frozen, base = torch.as_tensor(frozen_np), torch.as_tensor(base_np)
    from repro_torch.core.cost_model import GBTModel
    gen = torch.Generator().manual_seed(0)
    cfgs = space.random_configs(gen, 64)
    gbt = GBTModel(n_rounds=8)
    gbt.update(space.feature_vector(cfgs).numpy(),
               -np.log(space.measure(cfgs).numpy()))
    agent = TB._init_single_agent(0, "cpu")
    before = [p.detach().clone() for p in agent.parameters()]
    opt = TB.Adam(list(agent.parameters()), lr=7e-4, grad_clip_norm=1.0)
    hp = mappo.MappoConfig(n_steps=6, n_envs=4)
    visited = TB._chameleon_episode(agent, opt, gen, env, gbt.to_forest("cpu"),
                                    frozen, base, hp)
    assert visited.shape == (6 * 4, 7)
    assert (visited[:, :3] == base[:3]).all()       # hardware never moves
    assert (visited >= 0).all() and (visited < env.n_choices).all()
    assert any(not torch.equal(a, b.detach())
               for a, b in zip(before, agent.parameters()))


def _cli(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(list(argv)) == 0
    return json.loads(buf.getvalue())


@pytest.mark.parametrize("algo", ["random", "autotvm", "chameleon"])
def test_baselines_run_through_session_and_cli(algo, tmp_path):
    tasks = TuningTask.conv_tasks("resnet-18")[2:4]
    rep = Session(tasks, tuner=FAST, algo=algo, budget=20, device="cpu").run()
    assert rep.algo == algo
    for task in tasks:
        r = rep[task.name]
        assert r.n_measurements == 20 and np.isfinite(r.best_latency)
        np.testing.assert_array_equal(
            r.best_config[:3], TB.default_hardware_config(task.space))
        assert r.multiplicity == task.multiplicity
    assert rep.total_best_latency() == sum(r.best_latency for r in rep)
    rec = str(tmp_path / "r.jsonl")
    out = _cli("tune", "--model", "resnet-18", "--max-tasks", "2",
               "--budget", "4", "--algo", algo, "--records", rec,
               "--device", "cpu")
    assert out["algo"] == algo
    assert all(r["n_measurements"] == 4 for r in out["reports"].values())
    again = _cli("tune", "--model", "resnet-18", "--max-tasks", "2",
                 "--budget", "4", "--algo", algo, "--records", rec,
                 "--device", "cpu")
    assert all(r["oracle_stats"]["misses"] == 0
               for r in again["reports"].values())


def test_session_independent_and_no_cs_flags():
    out = _cli("tune", "--model", "resnet-18", "--max-tasks", "2",
               "--budget", "6", "--no-cs", "--independent", "--device", "cpu")
    assert out["shared_cost_model"] is False
    with pytest.raises(SystemExit):
        _cli("tune", "--model", "resnet-18", "--independent",
             "--save-surrogates", "x.jsonl", "--device", "cpu")
    cfg = dataclasses.replace(FAST, seed=3)
    rep = Session(TuningTask.conv_tasks("resnet-18")[:1], tuner=cfg,
                  algo="random", budget=8, device="cpu").run()
    assert rep.single.n_measurements == 8
