"""Port parity: DesignSpace maths against the reference on the same inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_support import one_torch_thread  # noqa: F401
from repro.core import design_space as JD
from repro.core.task import conv_tasks as jax_conv_tasks
from repro_torch.core import design_space as TD
from repro_torch.core.task import conv_tasks as torch_conv_tasks

WORKLOADS = [t.space.workload for t in jax_conv_tasks("resnet-18", batch=8)]


def _spaces(wl):
    return JD.DesignSpace.for_conv2d(wl), TD.DesignSpace.for_conv2d(wl)


def _configs(space, n=300, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, space.n_choices, size=(n, space.n_knobs))


def test_task_names_and_choices_match_reference():
    for model in ("resnet-18", "vgg-11", "alexnet"):
        jt, tt = jax_conv_tasks(model, batch=8), torch_conv_tasks(model, 8)
        assert [t.name for t in tt] == [t.name for t in jt]
        assert [t.multiplicity for t in tt] == [t.multiplicity for t in jt]
        for a, b in zip(jt, tt):
            assert b.space.choices == a.space.choices
            assert b.space.workload == a.space.workload
    assert TD.KNOB_NAMES == JD.KNOB_NAMES
    assert TD.AGENT_KNOBS == JD.AGENT_KNOBS
    for m, n, k in [(512, 512, 512), (3, 1000, 70)]:
        a, b = JD.DesignSpace.for_matmul(m, n, k), TD.DesignSpace.for_matmul(m, n, k)
        assert b.choices == a.choices and b.workload == a.workload


@pytest.mark.parametrize("wl", WORKLOADS, ids=lambda w: f"{w['h']}x{w['ci']}x{w['co']}s{w['stride']}")
def test_values_measure_features(wl):
    js, ts = _spaces(wl)
    np.testing.assert_array_equal(ts.choice_table().numpy(),
                                  np.asarray(js.choice_table()))
    cfg = _configs(js)
    j_cfg, t_cfg = jnp.asarray(cfg, jnp.int32), torch.as_tensor(cfg)
    np.testing.assert_array_equal(ts.values(t_cfg).numpy(),
                                  np.asarray(js.values(j_cfg)))
    np.testing.assert_allclose(ts.measure(t_cfg).numpy(),
                               np.asarray(js.measure(j_cfg)), rtol=1e-6)
    np.testing.assert_allclose(ts.fitness(t_cfg).numpy(),
                               np.asarray(js.fitness(j_cfg)), rtol=1e-6)
    np.testing.assert_allclose(ts.feature_vector(t_cfg).numpy(),
                               np.asarray(js.feature_vector(j_cfg)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(ts.workload_features(),
                                  js.workload_features())


def test_clip_apply_deltas_and_matmul_measure():
    js, ts = _spaces(WORKLOADS[1])
    rng = np.random.default_rng(1)
    cfg = rng.integers(-2, 14, size=(200, 7))
    deltas = rng.integers(-1, 2, size=(200, 7))
    np.testing.assert_array_equal(
        ts.clip(torch.as_tensor(cfg)).numpy(),
        np.asarray(js.clip(jnp.asarray(cfg, jnp.int32))))
    base = _configs(js, 200, seed=2)
    np.testing.assert_array_equal(
        ts.apply_deltas(torch.as_tensor(base), torch.as_tensor(deltas)).numpy(),
        np.asarray(js.apply_deltas(jnp.asarray(base, jnp.int32),
                                   jnp.asarray(deltas, jnp.int32))))
    jm, tm = (JD.DesignSpace.for_matmul(384, 512, 768),
              TD.DesignSpace.for_matmul(384, 512, 768))
    cfg = _configs(jm, 200, seed=3)
    np.testing.assert_allclose(
        tm.measure(torch.as_tensor(cfg)).numpy(),
        np.asarray(jm.measure(jnp.asarray(cfg, jnp.int32))), rtol=1e-6)


def test_pin_matches_reference():
    js, ts = _spaces(WORKLOADS[0])
    for knobs, vals in [((0, 1, 2), (8, 64, 48)), ((1,), (1024,)),
                        ((3, 4), (2, 3))]:
        jp, tp = js.pin(knobs, vals), ts.pin(knobs, vals)
        assert tp.choices == jp.choices
        np.testing.assert_array_equal(tp.pinned_mask(), jp.pinned_mask())
        assert tp.size == jp.size
        jp2, tp2 = jp.pin((5,), (4,)), tp.pin((5,), (4,))
        np.testing.assert_array_equal(tp2.pinned_mask(), jp2.pinned_mask())
    for k in range(7):
        for v in (0.5, 3, 7, 100, 1e6):
            assert ts.nearest_choice(k, v) == js.nearest_choice(k, v)


def test_random_configs_and_neighbor_in_range():
    ts = TD.DesignSpace.for_conv2d(WORKLOADS[2])
    gen = torch.Generator().manual_seed(0)
    cfg = ts.random_configs(gen, 4000)
    assert cfg.shape == (4000, 7) and cfg.dtype == torch.long
    hi = torch.as_tensor(ts.n_choices)
    assert bool((cfg >= 0).all()) and bool((cfg < hi).all())
    # every choice of every knob is drawn (uniform over a few thousand)
    for k in range(7):
        assert len(torch.unique(cfg[:, k])) == int(hi[k])
    base = torch.ones(7, dtype=torch.long)
    for _ in range(50):
        nb = ts.neighbor(gen, base)
        assert int((nb - base).abs().sum()) <= 1
        assert bool((nb >= 0).all()) and bool((nb < hi).all())


def test_reward_with_penalty_matches_reference():
    lat = np.asarray([1e-4, 2e-3, 1e12, 1e-12], np.float32)
    vmem = np.asarray([1e6, 300e6, 5e6, 1.3e8], np.float32)
    np.testing.assert_allclose(
        TD.reward_with_penalty(torch.as_tensor(lat), torch.as_tensor(vmem)).numpy(),
        np.asarray(JD.reward_with_penalty(jnp.asarray(lat), jnp.asarray(vmem))),
        rtol=1e-6)
