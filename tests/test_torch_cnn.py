"""Port parity: the CNN forward pass with weights carried over from the
reference, task extraction (Table 3), and weight loading."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_support import one_torch_thread  # noqa: F401
from repro.kernels.gemm import gemm_config_from_knobs as j_knobs
from repro.models import cnn as JC
from repro_torch.core.task import (conv_tasks, network_flops,
                                   network_latency, total_conv_layers)
from repro_torch.kernels import gemm as TG
from repro_torch.models import cnn as TC


def _jax_params(model, seed=0):
    params = JC.init_params(jax.random.PRNGKey(seed), model)
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("model,hw", [("resnet-18", 32), ("vgg-11", 32),
                                      ("alexnet", 64)])
def test_apply_matches_reference(model, hw):
    tree = _jax_params(model)
    x = np.random.default_rng(0).standard_normal((2, hw, hw, 3)).astype(
        np.float32)
    want = np.asarray(JC.apply(tree, jnp.asarray(x), model, use_pallas=False))
    net = TC.params_from_jax(tree, model, device="cpu")
    launches = TG.gemm.launches
    got = TC.apply(net, torch.from_numpy(x)).detach().numpy()
    assert TG.gemm.launches == launches  # CPU tensors: plain version
    assert got.shape == want.shape == (2, 1000)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    plain = net(torch.from_numpy(x), use_kernel=False).detach().numpy()
    np.testing.assert_allclose(plain, want, rtol=0, atol=1e-4 * scale)


def test_apply_with_knob_configs_matches_reference():
    """Per-layer tuned geometries (as ARCO emits them) change no result."""
    model = "resnet-18"
    tree = _jax_params(model, seed=1)
    specs = TC.conv_specs(model)
    rng = np.random.default_rng(2)
    knobs = _knob_configs(specs, rng)
    j_cfgs = [j_knobs(*k) for k in knobs]
    t_cfgs = [TG.gemm_config_from_knobs(*k) for k in knobs]
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(JC.apply(tree, jnp.asarray(x), model, configs=j_cfgs,
                               use_pallas=False))
    net = TC.params_from_jax(tree, model, device="cpu")
    got = net(torch.from_numpy(x), t_cfgs).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


def _knob_configs(specs, rng):
    """Random ARCO knob settings for each conv layer, as the tuner draws
    them: (tile_m, tile_n, tile_k, h_threading, oc_threading)."""
    return [(int(2 ** rng.integers(0, 6)), int(2 ** rng.integers(0, 9)),
             int(2 ** rng.integers(0, 6)) * s.kh * s.kw,
             int(rng.choice([1, 2, 4])), int(rng.choice([1, 2, 4])))
            for s in specs]


@pytest.mark.parametrize("knobs", [False, True], ids=["default", "knobs"])
def test_apply_bf16_matches_reference(knobs):
    """ResNet-18 deployed in bf16: the reference's ``apply`` on a bf16 tree
    and bf16 input (``use_pallas=False``: XLA's bf16 convolutions) against
    the port's net cast to bf16, every conv through the GEMM's bf16 path
    (on the CPU its plain version: bf16 operands, an fp32 sum over the run
    geometry's K steps and slices, one rounding), with the default and
    with random knob-derived geometries (other BK and split-K cuts).  Both
    round every layer's output to bf16, so the two sums' orders flip a
    rounding now and then and the flips compound over 17 convs: 2e-2 of
    max |logit| (measured 5.0e-3 with either geometry; the reference's own
    bf16 forward lies 5.5e-3 from its fp32 one)."""
    model = "resnet-18"
    tree = _jax_params(model, seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = JC.apply(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                 tree),
                    jnp.asarray(x, jnp.bfloat16), model, use_pallas=False)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    net = TC.params_from_jax(tree, model, device="cpu").to(torch.bfloat16)
    configs = ([TG.gemm_config_from_knobs(*k)
                for k in _knob_configs(TC.conv_specs(model), rng)]
               if knobs else None)
    launches = TG.gemm.launches
    got = net(torch.from_numpy(x).to(torch.bfloat16), configs)
    assert TG.gemm.launches == launches  # CPU tensors: plain version
    assert TG.gemm.last_geometry["run"]["dtype"] == "bfloat16"
    assert got.dtype == torch.bfloat16 and got.shape == (2, 1000)
    got = got.float().detach().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * float(np.abs(want).max()))


def test_params_from_jax_and_init_params():
    tree = _jax_params("resnet-18")
    net = TC.params_from_jax(tree, "resnet-18", device="cpu")
    for i, c in enumerate(tree["convs"]):
        np.testing.assert_array_equal(net.conv_w[i].detach().numpy(), c["w"])
    np.testing.assert_array_equal(net.fc_w.detach().numpy(), tree["fc"]["w"])
    a = TC.init_params(3, "resnet-18", device="cpu")
    b = TC.init_params(3, "resnet-18", device="cpu")
    for pa, pb, c in zip(a.conv_w, b.conv_w, tree["convs"]):
        assert pa.shape == c["w"].shape
        assert torch.equal(pa, pb)
    # He-normal scale, as the reference draws it
    w = a.conv_w[5].detach().numpy()
    assert abs(w.std() / np.sqrt(2.0 / (9 * 64)) - 1) < 0.05


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert TC.init_params(0, "resnet-18").fc_w.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TC.init_params(0, "resnet-18")


def test_task_extraction_matches_table3():
    for model in TC.MODELS:
        assert total_conv_layers(model) == TC.expected_task_count(model)
        tasks = conv_tasks(model)
        assert sum(t.multiplicity for t in tasks) == \
            TC.expected_task_count(model)
        assert TC.conv_specs(model) == [TC.ConvSpec(**vars(s))
                                        for s in JC.conv_specs(model)]
    assert network_flops("resnet-18", 8) == sum(
        s.flops(8) for s in JC.conv_specs("resnet-18"))
    tasks = conv_tasks("resnet-18")
    assert abs(network_latency(tasks, {t.name: 1e-3 for t in tasks})
               - 17e-3) < 1e-9


def _unfused_apply(net, x, use_kernel):
    """The forward as separate passes: each conv, then its bias add, its
    ReLU and ResNet's ``relu(skip + y)``, as ``cnn.apply`` wrote it before
    the GEMM's epilogue took them."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.models.specs import RESNET_BLOCKS, VGG_STAGES
    specs = TC.conv_specs(net.model)
    nchw = lambda f, t, *a, **k: f(t.permute(0, 3, 1, 2), *a,
                                   **k).permute(0, 2, 3, 1)

    def conv(i, t):
        return ops.conv2d(t, net.conv_w[i], specs[i].stride, specs[i].pad,
                          TG.GemmConfig(), use_kernel) + net.conv_b[i]

    if net.model == "alexnet":
        for i in range(len(specs)):
            x = F.relu(conv(i, x))
            if i in (0, 1, 4):
                x = nchw(F.max_pool2d, x, 3, 2)
    elif net.model in VGG_STAGES:
        i = 0
        for reps in VGG_STAGES[net.model]:
            for _ in range(reps):
                x = F.relu(conv(i, x))
                i += 1
            x = nchw(F.max_pool2d, x, 2, 2)
    else:
        x = nchw(F.max_pool2d, F.relu(conv(0, x)), 3, 2, padding=1)
        i = 1
        for reps in RESNET_BLOCKS[net.model]:
            for _ in range(reps):
                y = conv(i + 1, F.relu(conv(i, x)))
                if x.shape != y.shape:
                    s = specs[i].stride
                    x = nchw(F.avg_pool2d, x, s, s)
                    x = F.pad(x, (0, y.shape[-1] - x.shape[-1]))
                x = F.relu(x + y)
                i += 2
    return x.mean(dim=(1, 2)) @ net.fc_w + net.fc_b


@pytest.mark.parametrize("use_kernel", [True, False], ids=["gemm", "ref"])
@pytest.mark.parametrize("model,hw", [("resnet-18", 32), ("vgg-11", 32),
                                      ("alexnet", 64)])
def test_apply_fp32_keeps_the_unfused_bits(model, hw, use_kernel):
    """In fp32 on the CPU the forward with each conv's bias, ReLU and skip
    add in the GEMM's epilogue gives the bits of the unfused passes: the
    same adds in the same order (``relu(x + (acc + b))`` is
    ``relu((acc + b) + x)``) and a cast that is a no-op; on both paths."""
    net = TC.params_from_jax(_jax_params(model, seed=5), model, device="cpu")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, hw, hw, 3)).astype(np.float32))
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for b in net.conv_b:  # the reference's biases are zeros
            b.copy_(torch.randn(b.shape, generator=gen))
        got = net(x, use_kernel=use_kernel)
        want = _unfused_apply(net, x, use_kernel)
    assert torch.equal(got, want)
