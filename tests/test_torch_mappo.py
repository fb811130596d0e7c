"""Port parity for the agents, MAPPO, Adam and the GBT cost model, with the
parameters copied from the reference and a fixed numpy trajectory."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_support import one_torch_thread  # noqa: F401
from repro.core import agents as JA
from repro.core import cost_model as JCM
from repro.core import mappo as JM
from repro.core.design_space import DesignSpace as JDS
from repro.optim.adam import Adam as JAdam
from repro_torch.core import agents as TA
from repro_torch.core import cost_model as TCM
from repro_torch.core import mappo as TM
from repro_torch.core.design_space import AGENTS, DesignSpace as TDS
from repro_torch.optim.adam import Adam as TAdam

WL = dict(b=1, h=14, w=14, ci=64, co=64, kh=3, kw=3, stride=1, pad=1)
TOL = dict(rtol=1e-5, atol=1e-6)
T, E = 6, 5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def params():
    return _np(JA.init_marl_params(jax.random.PRNGKey(3)))


def _grads_like_jax(nets):
    """The port's gradients in the reference's layout: {name: {w, b}}."""
    out = {}
    for a in AGENTS:
        p = nets.policies[a]
        out[a] = {"h": p.h, "out": p.out}
    out["critic"] = {n: getattr(nets.critic, n)
                     for n in ("h1", "h2", "h3", "out")}
    return {k: {n: {"w": l.weight.grad.T.numpy(), "b": l.bias.grad.numpy()}
                for n, l in v.items()} for k, v in out.items()}


def _weights_like_jax(nets):
    out = {}
    for a in AGENTS:
        p = nets.policies[a]
        out[a] = {"h": p.h, "out": p.out}
    out["critic"] = {n: getattr(nets.critic, n)
                     for n in ("h1", "h2", "h3", "out")}
    return {k: {n: {"w": l.weight.detach().T.numpy(),
                    "b": l.bias.detach().numpy()}
                for n, l in v.items()} for k, v in out.items()}


def _assert_tree_close(got, want, **tol):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, **tol),
                 got, want)


def _trajectory(pinned_knob=None, seed=0):
    """A fixed trajectory (numpy) in both packages' layouts."""
    space = JDS.for_conv2d(WL)
    tspace = TDS.for_conv2d(WL)
    if pinned_knob is not None:
        space = space.pin((pinned_knob,), (4,))
        tspace = tspace.pin((pinned_knob,), (4,))
    rng = np.random.default_rng(seed)
    cfg = rng.integers(0, space.n_choices, size=(T, E, 7))
    jenv = JM.env_params_from_space(space)
    tenv = TM.env_params_from_space(tspace)
    obs, acts, logps = {}, {}, {}
    for a in AGENTS:
        obs[a] = np.array(JA.local_obs(a, jnp.asarray(cfg), jenv.n_choices,
                                         jenv.wfeat))
        mask = np.asarray(JA.action_mask(a, jenv.pinned))
        choices = np.flatnonzero(mask)
        acts[a] = rng.choice(choices, size=(T, E))
        logps[a] = (-np.log(len(choices))
                    + 0.1 * rng.standard_normal((T, E))).astype(np.float32)
    states = np.array(JA.global_state(jnp.asarray(cfg), jenv.n_choices,
                                        jenv.wfeat))
    num = dict(values=rng.standard_normal((T, E)).astype(np.float32),
               rewards=rng.standard_normal((T, E)).astype(np.float32),
               last=rng.standard_normal(E).astype(np.float32))
    jtraj = JM.Trajectory(
        {a: jnp.asarray(obs[a]) for a in AGENTS},
        {a: jnp.asarray(acts[a], jnp.int32) for a in AGENTS},
        {a: jnp.asarray(logps[a]) for a in AGENTS},
        jnp.asarray(states), jnp.asarray(num["values"]),
        jnp.asarray(num["rewards"]), jnp.asarray(cfg, jnp.int32),
        jnp.asarray(num["last"]))
    ttraj = TM.Trajectory(
        {a: torch.from_numpy(obs[a]) for a in AGENTS},
        {a: torch.from_numpy(acts[a]) for a in AGENTS},
        {a: torch.from_numpy(logps[a]) for a in AGENTS},
        torch.from_numpy(states), torch.from_numpy(num["values"]),
        torch.from_numpy(num["rewards"]), torch.from_numpy(cfg),
        torch.from_numpy(num["last"]))
    return jenv, tenv, jtraj, ttraj, cfg


def test_nets_and_encodings_match(params):
    nets = TA.params_from_jax(params, device="cpu")
    jenv, tenv, _, _, cfg = _trajectory()
    for a in AGENTS:
        o = np.asarray(JA.local_obs(a, jnp.asarray(cfg), jenv.n_choices,
                                    jenv.wfeat))
        to = TA.local_obs(a, torch.from_numpy(cfg), tenv.n_choices,
                          tenv.wfeat)
        np.testing.assert_allclose(to.numpy(), o, **TOL)
        np.testing.assert_allclose(
            nets.policies[a](to).detach().numpy(),
            np.asarray(JA.policy_logits(params[a], jnp.asarray(o))), **TOL)
        np.testing.assert_array_equal(TA.delta_table(a), JA.delta_table(a))
        n = TA.AGENT_N_ACTIONS[a]
        np.testing.assert_array_equal(
            TA.decode_action(a, torch.arange(n)).numpy(),
            np.asarray(JA.decode_action(a, jnp.arange(n))))
    s = TA.global_state(torch.from_numpy(cfg), tenv.n_choices, tenv.wfeat)
    np.testing.assert_allclose(
        nets.critic(s).detach().numpy(),
        np.asarray(JA.critic_value(params["critic"], jnp.asarray(s.numpy()))),
        **TOL)
    np.testing.assert_allclose(
        TM.critic_scores(nets, tenv, torch.from_numpy(cfg[0])).numpy(),
        np.asarray(JM.critic_scores(params, jenv, jnp.asarray(cfg[0]))),
        **TOL)
    acts = {a: torch.from_numpy(cfg[0, :, 0] % TA.AGENT_N_ACTIONS[a])
            for a in AGENTS}
    np.testing.assert_array_equal(
        TA.combined_deltas(acts).numpy(),
        np.asarray(JA.combined_deltas({a: jnp.asarray(v.numpy())
                                       for a, v in acts.items()})))


@pytest.mark.parametrize("pinned", [None, 1, 3])
def test_masks_env_and_surrogate_reward(pinned):
    jenv, tenv, _, _, cfg = _trajectory(pinned)
    for a in AGENTS:
        np.testing.assert_array_equal(
            tenv.masks[a].numpy(), np.asarray(JA.action_mask(a, jenv.pinned)))
    np.testing.assert_allclose(
        TM.vmem_estimate(tenv, torch.from_numpy(cfg)).numpy(),
        np.asarray(JM.vmem_estimate(jenv, jnp.asarray(cfg))), rtol=1e-6)
    space = JDS.for_conv2d(WL)
    X = np.random.default_rng(1).random((64, 18)).astype(np.float32)
    gbt = JCM.GBTModel(n_rounds=6)
    gbt.update(X, X[:, 0] - 2 * X[:, 5])
    jf = gbt.to_forest()
    tf = TCM.Forest(*[np.asarray(x) for x in jf]).to("cpu")
    np.testing.assert_allclose(
        TM.surrogate_reward(tenv, tf, torch.from_numpy(cfg)).numpy(),
        np.asarray(JM.surrogate_reward(jenv, jf, jnp.asarray(cfg))),
        rtol=1e-5, atol=1e-6)
    assert space.n_knobs == 7


def test_gae_matches_reference():
    _, _, jt, tt, _ = _trajectory()
    ja, jr = JM.gae(jt.rewards, jt.values, jt.last_value, 0.9, 0.8)
    ta, tr = TM.gae(tt.rewards, tt.values, tt.last_value, 0.9, 0.8)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)


@pytest.mark.parametrize("pinned", [None, 3])
def test_ppo_loss_gradients_and_adam_step(params, pinned):
    jenv, tenv, jt, tt, _ = _trajectory(pinned, seed=5)
    hp_j, hp_t = JM.MappoConfig(), TM.MappoConfig()
    jadv, jret = JM.gae(jt.rewards, jt.values, jt.last_value, 0.99, 0.95)
    tadv, tret = TM.gae(tt.rewards, tt.values, tt.last_value, 0.99, 0.95)
    (jloss, jstats), jgrads = jax.value_and_grad(JM.ppo_loss, has_aux=True)(
        params, jt, jadv, jret, jenv, hp_j)
    nets = TA.params_from_jax(params, device="cpu")
    tloss, tstats = TM.ppo_loss(nets, tt, tadv, tret, tenv, hp_t)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    for k in ("pg", "vloss", "entropy"):
        np.testing.assert_allclose(tstats[k].item(), float(jstats[k]), **TOL)
    _assert_tree_close(_grads_like_jax(nets), _np(jgrads), **TOL)
    # one clipped Adam step from those gradients
    opt_j = JAdam(lr=hp_j.lr, grad_clip_norm=1.0)
    new_j, _ = opt_j.update(jgrads, opt_j.init(params), params)
    opt_t = TM.make_optimizer(nets, hp_t)
    opt_t.step()
    _assert_tree_close(_weights_like_jax(nets), _np(new_j), **TOL)


def test_adam_matches_reference_over_steps():
    rng = np.random.default_rng(7)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: (3 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    for clip, wd in ((None, 0.0), (1.0, 0.0), (0.5, 0.01)):
        jopt = JAdam(lr=1e-2, grad_clip_norm=clip, weight_decay=wd)
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        state = jopt.init(jp)
        tp = [torch.from_numpy(p0["a"].copy()), torch.from_numpy(p0["b"].copy())]
        topt = TAdam(tp, lr=1e-2, grad_clip_norm=clip, weight_decay=wd)
        for g in grads:
            jp, state = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                    state, jp)
            topt.step([torch.from_numpy(g["a"]), torch.from_numpy(g["b"])])
        np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp["a"]), **TOL)
        np.testing.assert_allclose(tp[1].numpy(), np.asarray(jp["b"]), **TOL)


def test_gbt_forest_identical_and_predict_close():
    js, ts = JDS.for_conv2d(WL), TDS.for_conv2d(WL)
    cfg = np.random.default_rng(4).integers(0, js.n_choices, size=(160, 7))
    X = np.asarray(js.feature_vector(jnp.asarray(cfg, jnp.int32)))
    np.testing.assert_allclose(
        ts.feature_vector(torch.from_numpy(cfg)).numpy(), X, rtol=1e-6)
    y = -np.log(np.asarray(js.measure(jnp.asarray(cfg, jnp.int32))))
    jm, tm = JCM.GBTModel(n_rounds=12), TCM.GBTModel(n_rounds=12)
    jm.update(X[:100], y[:100])
    tm.update(X[:100], y[:100])
    jm.update(X[100:], y[100:])
    tm.update(X[100:], y[100:])
    jf, tf = jm.to_forest(), tm.to_forest("cpu")
    for name in ("feat", "thresh", "leaf", "base", "scale", "lr"):
        np.testing.assert_array_equal(
            getattr(tf, name).numpy(), np.asarray(getattr(jf, name)), name)
    np.testing.assert_allclose(tm.predict(X), jm.predict(X),
                               rtol=1e-6, atol=1e-6)
    empty = TCM.GBTModel(n_rounds=3)
    np.testing.assert_array_equal(empty.predict(X[:4]), np.zeros(4))


def test_mappo_episode_improves_surrogate():
    """Policy should climb the (fixed) surrogate over episodes."""
    space = TDS.for_conv2d(WL)
    hp = TM.MappoConfig(n_steps=24, n_envs=8, epochs=4)
    env = TM.env_params_from_space(space)
    gen = torch.Generator().manual_seed(0)
    cfgs = space.random_configs(gen, 256)
    gbt = TCM.GBTModel(n_rounds=16)
    gbt.update(space.feature_vector(cfgs).numpy(),
               -np.log(space.measure(cfgs).numpy()))
    forest = gbt.to_forest("cpu")
    nets = TA.init_marl_params(1, device="cpu")
    opt = TM.make_optimizer(nets, hp)
    rewards = []
    for _ in range(12):
        visited, stats = TM.train_episode(nets, opt, gen, env, forest, hp)
        assert visited.shape == (hp.n_steps * hp.n_envs, 7)
        rewards.append(float(stats["mean_reward"]))
    assert np.mean(rewards[-3:]) > np.mean(rewards[:3])


def test_rollout_respects_pins_and_bounds():
    space = TDS.for_conv2d(WL).pin((0, 3), (1, 2))
    hp = TM.MappoConfig(n_steps=10, n_envs=6)
    env = TM.env_params_from_space(space)
    nets = TA.init_marl_params(0, device="cpu")
    forest = TCM.GBTModel(n_rounds=2).to_forest("cpu")
    gen = torch.Generator().manual_seed(5)
    config0 = space.random_configs(gen, hp.n_envs)
    traj = TM.rollout(nets, gen, env, forest, config0, hp)
    assert traj.configs.shape == (10, 6, 7)
    assert bool((traj.configs[..., 0] == 0).all())
    assert bool((traj.configs[..., 3] == 0).all())
    hi = torch.as_tensor(space.n_choices)
    assert bool((traj.configs >= 0).all()) and bool((traj.configs < hi).all())
    for a in AGENTS:
        assert bool(env.masks[a][traj.actions[a]].all())
