"""The bf16 GEMM's implicit mode on the card: a conv whose patches the
kernel gathers from the NHWC activation in its own loads gives the same
bits as im2col + the GEMM at the same ``GemmConfig``, on every conv of
VGG-16 D and ResNet-18 at the geometries their tuning records give, on
ResNet-18's convs at batch 8 under every run geometry a tuning can pick,
and on edge cases (strides, paddings, a 7x7 filter over 8 channels, M
tails, split-K); the convs the rule leaves out take im2col, and the
counters say which path ran.  With an output epilogue (bias, bias +
ReLU, bias + residual + ReLU) the same conv gives, bit for bit, the
epilogue applied in plain PyTorch to the kernel's own fp32 output of the
same geometry and rounded once.  Every test here carries the ``gpu`` marker
and skips where torch sees no CUDA device; the file imports neither jax
nor the reference package:

    python -m pytest -q -m gpu tests/test_torch_conv_gpu.py
"""
import json
import os

import pytest
import torch

from _torch_support import require_cuda
from repro_torch.kernels import gemm as TG
from repro_torch.kernels import ops, ref
from repro_torch.models import cnn
from repro_torch.models.specs import conv_specs

CONFIGS = os.path.join(os.path.dirname(__file__), os.pardir, "dcoc_bench",
                       "configs")


def _tuned_cases():
    """(batch, h, w, ci, co, k, stride, pad, GemmConfig) of every conv of
    VGG-16 D (at batch 2) and ResNet-18 (batch 1), each at the geometry
    its tuning record maps to, as the deployed forward maps it."""
    cases = []
    for record, model, batch in (("vgg-16-gap.tuned-b64.json", "vgg-16", 2),
                                 ("resnet-18.tuned-b1.json", "resnet-18",
                                  1)):
        with open(os.path.join(CONFIGS, record)) as f:
            tasks = json.load(f)["tasks"]
        knobs = {layer: t["knobs"] for t in tasks for layer in t["layers"]}
        for s in conv_specs(model):
            k = knobs[s.name]
            cfg = TG.gemm_config_from_knobs(
                tile_m=k["tile_b"] * k["tile_h"] * k["tile_w"],
                tile_n=k["tile_co"], tile_k=k["tile_ci"] * s.kh * s.kw,
                h_threading=k["h_threading"], oc_threading=k["oc_threading"])
            cases.append(pytest.param(batch, s.h, s.w, s.ci, s.co, s.kh,
                                      s.stride, s.pad, cfg,
                                      id=f"{model}-{s.name}"))
    return cases


def _batch8_cases():
    """ResNet-18's distinct convs at batch 8 under each BM template: every
    run geometry a tuning of them can ask for (the knobs round block_n and
    block_k past every BN and BK template, so tile_m alone picks it)."""
    specs = {}
    for s in conv_specs("resnet-18"):
        specs.setdefault((s.h, s.w, s.ci, s.co, s.kh, s.stride, s.pad),
                         s.name)
    return [pytest.param(8, *shape, TG.GemmConfig(bm),
                         id=f"resnet-18-b8-{name}-bm{bm}")
            for shape, name in specs.items() for bm in TG.BM_TEMPLATES]


# strides, paddings and filters beside the networks': a strided 1x1 on a
# 15 x 17 map, pad 0, a 7x7 over 8 channels at pad 3 (eight taps a bk step,
# a K tail), CI 24 with an M tail (99 rows), deep split-K with a short last
# slice (as ResNet-18's convs from conv2a on, split 2 to 15 at batch 1),
# and CO 36, which the rule sends to im2col
EDGE_CASES = [
    pytest.param(3, 15, 17, 16, 24, 1, 2, 0, TG.GemmConfig(64, 128, 128),
                 id="1x1-stride2-pad0"),
    pytest.param(2, 20, 20, 32, 64, 3, 1, 0, TG.GemmConfig(128, 128, 128),
                 id="3x3-pad0"),
    pytest.param(2, 30, 30, 8, 64, 7, 2, 3, TG.GemmConfig(128, 128, 128),
                 id="7x7-ci8-stride2-pad3"),
    pytest.param(1, 9, 11, 24, 40, 3, 1, 1, TG.GemmConfig(64, 128, 128),
                 id="ci24-m-tail"),
    pytest.param(1, 7, 7, 512, 512, 3, 1, 1, TG.GemmConfig(16, 128, 128),
                 id="split-k"),
    pytest.param(1, 10, 10, 16, 36, 3, 1, 1, TG.GemmConfig(32, 64, 128),
                 id="co36-im2col"),
]


def _operands(b, h, w, ci, co, k, seed, x=None):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if x is None:
        x = torch.randn((b, h, w, ci), generator=gen, device="cuda")
    wt = (torch.randn((k, k, ci, co), generator=gen, device="cuda")
          * (2.0 / (k * k * ci)) ** 0.5)
    return x.bfloat16(), wt.bfloat16()


def _explicit(x, wt, stride, pad, cfg, out_dtype=None):
    """im2col + the GEMM, the path the implicit mode replaces."""
    kh, kw, ci, co = wt.shape
    patches, (oh, ow) = ops.im2col(x, kh, kw, stride, pad)
    return TG.gemm(patches, wt.reshape(kh * kw * ci, co), cfg,
                   out_dtype).reshape(x.shape[0], oh, ow, co)


# the epilogues a conv is checked with: none (the parent's bits), and
# those the forward asks for
EPILOGUES = [None, "bias", "bias-relu", "bias-residual-relu"]


def _epilogue(kind, shape, seed):
    """The conv2d keywords of epilogue ``kind`` for an output of
    ``shape``: bias and residual bf16 normals, about the conv's scale."""
    if kind is None:
        return {}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(bias=torch.randn(shape[-1], generator=gen,
                               device="cuda").bfloat16(),
              relu=kind != "bias")
    if "residual" in kind:
        kw["residual"] = torch.randn(shape, generator=gen,
                                     device="cuda").bfloat16()
    return kw


def _plain_epilogue(v, kw):
    """fp32 ``v`` + bias, + residual, ReLU, in plain PyTorch, unrounded."""
    if "bias" in kw:
        v = v + kw["bias"].float()
    if "residual" in kw:
        v = v + kw["residual"].float()
    return torch.relu(v) if kw.get("relu") else v


def _check(x, wt, stride, pad, cfg, epi=None):
    """conv2d takes the implicit path exactly where the rule holds, counts
    one launch either way, one implicit launch where it holds and one
    epilogue launch where ``epi`` asks for one, and gives, bit for bit,
    the explicit path's bits (no epilogue) or the plain epilogue on the
    kernel's fp32 output of the same geometry rounded once; both within
    bf16's step of the fp32 conv with the same epilogue."""
    taken = TG.implicit_ok(x, wt)
    b, h, w, _ = x.shape
    kh, kw_, _, co = wt.shape
    shape = (b, (h + 2 * pad - kh) // stride + 1,
             (w + 2 * pad - kw_) // stride + 1, co)
    kw = _epilogue(epi, shape, seed=h + co)
    launches, implicit = TG.gemm.launches, TG.gemm.implicit_launches
    fused = TG.gemm.epilogue_launches
    with torch.no_grad():
        got = ops.conv2d(x, wt, stride, pad, cfg, **kw)
        assert TG.gemm.launches == launches + 1
        assert TG.gemm.implicit_launches == implicit + taken
        assert TG.gemm.epilogue_launches == fused + bool(kw)
        if kw:
            want = _plain_epilogue(_explicit(x, wt, stride, pad, cfg,
                                             torch.float32), kw).bfloat16()
        else:
            want = _explicit(x, wt, stride, pad, cfg)
        assert TG.gemm.implicit_launches == implicit + taken
        conv = _plain_epilogue(ref.conv2d_ref(x.float(), wt.float(), stride,
                                              pad), kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape == shape and got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    err = (got.float() - conv).abs().max() / conv.abs().max()
    assert float(err) <= 1e-2
    return taken


@pytest.mark.gpu
@pytest.mark.parametrize("epi", EPILOGUES, ids=str)
@pytest.mark.parametrize("b,h,w,ci,co,k,stride,pad,cfg",
                         _tuned_cases() + _batch8_cases() + EDGE_CASES)
def test_implicit_conv_equals_im2col_on_card(b, h, w, ci, co, k, stride, pad,
                                             cfg, epi):
    """Bit-identical to im2col + the GEMM at the same geometry, with each
    epilogue (on the tile store, split-K's sum, the scalar template of
    the networks' first convs); every conv with CI and CO multiples of 8
    takes the implicit mode (all but those first convs, of 3 channels,
    and CO 36)."""
    require_cuda()
    x, wt = _operands(b, h, w, ci, co, k, seed=h * 31 + ci + co)
    assert _check(x, wt, stride, pad, cfg, epi) == (ci % 8 == 0
                                                    and co % 8 == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["unaligned", "not-contiguous"])
def test_views_of_x_take_im2col_on_card(layout):
    """An x 2 bytes off 16-byte alignment, or an NHWC view of an NCHW
    tensor, goes to im2col + the GEMM with the same bits; ``gemm.conv``
    itself refuses both."""
    require_cuda()
    b, h, w, ci, co = 2, 12, 12, 32, 64
    gen = torch.Generator(device="cuda").manual_seed(5)
    if layout == "unaligned":
        flat = torch.randn(b * h * w * ci + 1, generator=gen,
                           device="cuda").bfloat16()
        x = flat[1:].view(b, h, w, ci)
        assert x.is_contiguous() and x.data_ptr() % 16
    else:
        x = torch.randn((b, ci, h, w), generator=gen,
                        device="cuda").bfloat16().permute(0, 2, 3, 1)
        assert not x.is_contiguous()
    x, wt = _operands(b, h, w, ci, co, 3, seed=6, x=x)
    cfg = TG.GemmConfig(64, 64, 128)
    assert not _check(x, wt, 1, 1, cfg)
    with pytest.raises(ValueError):
        TG.conv(x, wt, 1, 1, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("model,convs", [("vgg-16", 13), ("resnet-18", 17)])
def test_forward_counts_implicit_launches_on_card(model, convs):
    """A bf16 forward on the card counts one GEMM launch a conv, and an
    implicit launch for every conv but the first (CI 3): the pools and the
    skips leave each conv's input contiguous; every conv's bias and ReLU,
    and ResNet's skip adds, ride in its launch's epilogue."""
    require_cuda()
    net = cnn.init_params(0, model, device="cuda").to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((2, 32, 32, 3), generator=gen,
                    device="cuda").bfloat16()
    launches, implicit = TG.gemm.launches, TG.gemm.implicit_launches
    fused = TG.gemm.epilogue_launches
    with torch.no_grad():
        out = net(x)
    torch.cuda.synchronize()
    assert TG.gemm.launches - launches == convs
    assert TG.gemm.implicit_launches - implicit == convs - 1
    assert TG.gemm.epilogue_launches - fused == convs
    assert out.shape == (2, 1000) and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out).all())
