"""The yardstick against the program on the CPU: the roofline's counts, the
networks' layers, the plain reference forward and the frozen analytical
model.  (These tests import both; the reference imports nothing of the
program.)"""
import json
import math
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from dcoc_bench import roofline  # noqa: E402
from dcoc_bench.reference import analytical, cnn as ref_cnn  # noqa: E402
from dcoc_bench.reference.networks import (conv_layers,  # noqa: E402
                                           network_flops, tasks)

CONFIGS = ("resnet-18", "vgg-16")
FILES = {"vgg-16": "vgg-16-gap"}   # model name -> its deploy configuration


def config(name: str) -> dict:
    path = os.path.join(HERE, "configs", FILES.get(name, name) + ".json")
    with open(path) as f:
        return json.load(f)


@pytest.fixture(autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_gemm_counts_on_a_known_shape():
    m, n, k = 12544, 64, 147           # ResNet-18's conv1 at batch 1
    assert roofline.gemm_flops(m, n, k) == 2.0 * 12544 * 64 * 147
    assert roofline.gemm_bytes(m, n, k, "bfloat16") == \
        2.0 * (12544 * 147 + 147 * 64 + 12544 * 64)
    by_bytes = roofline.gemm_bytes(m, n, k, "bfloat16") / 3.35e12
    assert roofline.gemm_bound_s(m, n, k, "bfloat16") == by_bytes
    big = (8192, 8192, 8192)            # bound by the operations
    assert roofline.gemm_bound_s(*big, "bfloat16") == \
        roofline.gemm_flops(*big) / 989e12


@pytest.mark.parametrize("name,gflop", [("resnet-18", 3.58858752),
                                        ("vgg-16", 30.693261312)])
def test_network_flops(name, gflop):
    cfg = config(name)
    convs = sum(c.flops(1) for c in conv_layers(cfg))
    assert convs == pytest.approx(gflop * 1e9, rel=1e-12)
    feats, classes = 512, 1000
    assert network_flops(cfg, 4) == pytest.approx(
        4 * convs + 2.0 * 4 * feats * classes, rel=1e-12)
    assert roofline.forward_flops(cfg, 1) == network_flops(cfg, 1)


def test_forward_gemm_bounds():
    """VGG-16 at batch 64 and ResNet-18 at batch 1, the deploy cells'."""
    assert roofline.forward_gemm_bound_s(config("vgg-16"), 64) == \
        pytest.approx(3.9136e-3, rel=1e-4)
    assert roofline.forward_gemm_bound_s(config("resnet-18"), 1) == \
        pytest.approx(1.666e-5, rel=1e-3)


@pytest.mark.parametrize("name", CONFIGS)
def test_layers_match_the_program(name):
    from repro_torch.core.task import conv_tasks
    from repro_torch.models.specs import conv_specs
    cfg = config(name)
    ours = [(c.name, c.h, c.ci, c.co, c.k, c.stride, c.pad)
            for c in conv_layers(cfg)]
    theirs = [(s.name, s.h, s.ci, s.co, s.kh, s.stride, s.pad)
              for s in conv_specs(name)]
    assert ours == theirs
    for batch in (1, 64):
        assert [(t[0], t[2], t[3]) for t in tasks(cfg, batch)] == \
            [(t.name, t.multiplicity, list(t.layer_names))
             for t in conv_tasks(name, batch=batch)]


def _weights(cfg, seed=0):
    from dcoc_bench.traffic.closed_loop_forward import make_weights
    return make_weights(cfg, seed, "cpu", torch.float32)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_forward_matches_the_program(name):
    """The plain reference against the program's plain path and its GEMM
    path (the kernel's plain version on the CPU), float32, 32 x 32."""
    from repro_torch.models import cnn
    cfg = config(name)
    w = _weights(cfg)
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    net = cnn.CNN(name, w["conv_w"], w["conv_b"], w["fc_w"],
                  w["fc_b"]).requires_grad_(False)
    with torch.no_grad():
        ref = ref_cnn.forward(cfg, w["conv_w"], w["conv_b"], w["fc_w"],
                              w["fc_b"], x)
        plain = net(x, use_kernel=False)
        kernel_path = net(x)
    scale = float(ref.abs().max())
    assert float((plain - ref).abs().max()) <= 1e-5 * scale
    assert float((kernel_path - ref).abs().max()) <= 1e-5 * scale


def test_fp8_rounding_keeps_three_bits():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(2))
    q = ref_cnn.fp8_round(x)
    big = x.abs() > 0.05 * x.abs().max()
    rel = ((q - x).abs() / x.abs())[big]
    assert float(rel.max()) <= 2 ** -4 + 1e-6   # half an ulp of 3 bits
    assert float(rel.max()) > 2 ** -8           # coarser than bfloat16


@pytest.mark.parametrize("name,batch", [("resnet-18", 1), ("vgg-16", 64)])
def test_frozen_model_matches_the_program(name, batch):
    """The float64 reference against the program's float32 model on
    seeded configurations of every task: within float32's rounding."""
    from repro_torch.core.task import conv_tasks
    cfg = config(name)
    ours = {t[0]: t[1] for t in tasks(cfg, batch)}
    gen = torch.Generator().manual_seed(3)
    for t in conv_tasks(name, batch=batch):
        wl = ours[t.name].workload(batch)
        assert wl == t.space.workload
        assert [list(c) for c in t.space.choices] == analytical.choices(wl)
        configs = t.space.random_configs(gen, 256)
        prog = t.space.measure(configs).double()
        ref = analytical.latency(wl, analytical.decode(wl, configs.tolist()))
        gap = ((prog - ref).abs() / ref).max()
        assert float(gap) < 1e-6
        bf16 = analytical.latency(wl, analytical.decode(wl, configs.tolist()),
                                  torch.bfloat16).double()
        assert float(((bf16 - ref).abs() / ref).max()) > 1e-3


def test_pow2_choices():
    assert analytical._pow2(224) == [1, 2, 4, 8, 16, 32, 64, 128]
    assert analytical._pow2(1) == [1]
    assert analytical._pow2(4096)[-1] == 4096 and \
        len(analytical._pow2(4096)) == analytical.MAX_CHOICES
    assert math.log2(analytical._pow2(64)[-1]) == 6


def _task_rows(name: str, batch: int, n: int, seed: int):
    """``n`` random configurations of each of the network's tasks: the
    program's features and measured latencies, the reference's workloads."""
    from repro_torch.compiler.task import TuningTask
    by_name = {t: conv.workload(batch)
               for t, conv, _, _ in tasks(config(name), batch)}
    out = []
    for task in TuningTask.conv_tasks(name, batch=batch):
        cfgs = task.space.random_configs(
            torch.Generator().manual_seed(seed), n)
        out.append((by_name[task.name], cfgs.tolist(),
                    task.space.feature_vector(cfgs).numpy(),
                    task.space.measure(cfgs).numpy()))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_gbt_matches_the_program_fit(seed):
    import numpy as np
    from repro_torch.core.cost_model import GBTModel
    from dcoc_bench.reference import gbt
    rows = _task_rows("resnet-18", 1, 24, seed)
    x_prog = np.concatenate([r[2] for r in rows])
    x_ref = np.concatenate([gbt.features(r[0], r[1]) for r in rows])
    assert np.abs(x_prog - x_ref).max() < 1e-6
    y = -np.log(np.maximum(np.concatenate([r[3] for r in rows]), 1e-12))
    model = GBTModel(n_rounds=12, seed=seed)
    model.update(x_prog, y)
    ref = gbt.predict(gbt.fit(x_ref, y, 12), x_ref)
    assert np.abs(model.predict(x_prog) - ref).max() < 1e-5 * y.std()
    bf16 = gbt.predict(gbt.fit(x_ref, y, 12, bf16=True), x_ref)
    assert np.abs(bf16 - ref).max() > 1e-3 * y.std()


def test_reference_ppo_follows_a_program_episode():
    """One MAPPO episode of the program, kept as a tune run keeps it, and
    the reference's update from the same state: the same loss and step;
    in TF32 a different one."""
    from repro_torch.core import mappo
    from repro_torch.core.agents import init_marl_params
    from repro_torch.core.cost_model import GBTModel
    from repro_torch.compiler.task import TuningTask
    from dcoc_bench import harness
    tune = harness.generator("tune_sessions")
    cfg = config("resnet-18-tune")
    task = TuningTask.conv_tasks("resnet-18", batch=1)[2]
    shapes = {name: (conv.workload(1), mult)
              for name, conv, mult, _ in tasks(cfg, 1)}
    rows = _task_rows("resnet-18", 1, 16, 3)
    model = GBTModel(n_rounds=8)
    import numpy as np
    model.update(np.concatenate([r[2] for r in rows]),
                 -np.log(np.concatenate([r[3] for r in rows])))
    hp = mappo.MappoConfig(n_steps=6, n_envs=4)
    nets = init_marl_params(5, device="cpu")
    opt = mappo.make_optimizer(nets, hp)
    gen = torch.Generator().manual_seed(5)
    env = mappo.env_params_from_space(task.space, device="cpu")
    forest = model.to_forest("cpu")
    with tune.episode_caught(1) as caught:
        for _ in range(2):   # the second episode starts from moved state
            mappo.train_episode(nets, opt, gen, env, forest, hp)
    run = harness.make_run("resnet18.tune", 1, 1.0, False, device="cpu",
                           config_overrides={"mappo_n_steps": 6,
                                             "mappo_n_envs": 4})
    ep = tune._cpu(caught[0])
    assert ep["step"] == hp.epochs
    loss_gap, step_gap = tune.mappo_gaps(run, ep, shapes)
    assert loss_gap < 1e-5 and step_gap < 1e-3
    tf32 = tune.reference_episode(run, ep, shapes, tf32=True)
    ref = tune.reference_episode(run, ep, shapes)
    assert tf32["moved_wrong"] == ref["moved_wrong"] == 0
    assert abs(tf32["losses"][-1] - ref["losses"][-1]) > \
        1e-6 * abs(ref["losses"][-1])
