"""Port parity: im2col, conv2d and conv2d_from_knobs against the
reference's ``ops`` (the Pallas GEMM in interpret mode) on the reference's
``test_conv2d`` cases."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_support import one_torch_thread  # noqa: F401
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.kernels.gemm import GemmConfig as JGemmConfig
from repro_torch.kernels import gemm as TG
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR

CASES = [(s, p, kh) for s, p in [(1, 1), (2, 0), (2, 1), (1, 0)]
         for kh in (1, 3)]


def _xw(kh, seed, shape=(2, 13, 13, 5), co=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((kh, kh, shape[-1], co)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("stride,pad,kh", CASES)
def test_im2col_and_conv2d(stride, pad, kh):
    x, w = _xw(kh, seed=stride * 10 + pad * 3 + kh)
    jp, jhw = JO.im2col(jnp.asarray(x), kh, kh, stride, pad)
    tp, thw = TO.im2col(torch.from_numpy(x), kh, kh, stride, pad)
    assert thw == jhw
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    want = np.asarray(JO.conv2d(jnp.asarray(x), jnp.asarray(w), stride, pad,
                                JGemmConfig(32, 32, 64)))
    got = TO.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride, pad,
                    TG.GemmConfig(32, 32, 64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    ref = TO.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride, pad,
                    use_kernel=False)
    np.testing.assert_allclose(
        ref.numpy(), np.asarray(JR.conv2d_ref(jnp.asarray(x), jnp.asarray(w),
                                              stride, pad)),
        rtol=1e-4, atol=1e-4)


def test_conv2d_from_knobs():
    x, w = _xw(3, seed=8, shape=(1, 14, 14, 16), co=32)
    knobs = dict(tile_b=1, tile_h=4, tile_w=4, tile_ci=16, tile_co=32,
                 h_threading=2, oc_threading=2)
    want = np.asarray(JO.conv2d_from_knobs(jnp.asarray(x), jnp.asarray(w),
                                           1, 1, **knobs))
    got = TO.conv2d_from_knobs(torch.from_numpy(x), torch.from_numpy(w),
                               1, 1, **knobs)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert TG.gemm.last_geometry["requested"]["block_m"] == 16
    assert TG.gemm.last_geometry["run"] == {"bm": 16, "bn": 32, "bk": 32,
                                            "split_k": 1, "vec": True,
                                            "dtype": "float32"}


def test_matmul_routes():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((33, 20)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((20, 17)).astype(np.float32))
    for use_kernel in (True, False):
        np.testing.assert_allclose(
            TO.matmul(a, b, use_kernel=use_kernel).numpy(),
            TR.matmul_ref(a, b).numpy(), rtol=1e-5, atol=1e-5)
    assert TR.matmul_ref(a.bfloat16(), b.bfloat16()).dtype == torch.bfloat16
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


class _OnDevice:
    """A tensor as :func:`TG.implicit_ok` sees it, placed on ``device`` at
    address ``ptr`` (the rule reads device, dtype, shape, layout and
    address only), so the CUDA side of the rule is checked on the CPU."""

    def __init__(self, t, device="cuda", ptr=0, contiguous=None):
        self._t, self._ptr, self._contiguous = t, ptr, contiguous
        self.device, self.dtype = torch.device(device), t.dtype
        self.shape, self.ndim = t.shape, t.ndim

    def is_contiguous(self):
        if self._contiguous is None:
            return self._t.is_contiguous()
        return self._contiguous

    def data_ptr(self):
        return self._ptr


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("contiguous", [True, False])
@pytest.mark.parametrize("ci", [3, 8, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_implicit_rule(dtype, ci, contiguous, device):
    """The implicit mode takes a conv only in bf16, on CUDA tensors, with
    CI % 8 == 0 and contiguous operands; all else is im2col + the GEMM."""
    x = torch.zeros((2, 9, 9, ci), dtype=dtype)
    if not contiguous:
        x = x.permute(0, 2, 1, 3)
    w = torch.zeros((3, 3, ci, 16), dtype=dtype)
    want = (device == "cuda" and dtype == torch.bfloat16 and ci % 8 == 0
            and contiguous)
    assert TG.implicit_ok(_OnDevice(x, device, ptr=256),
                          _OnDevice(w, device, ptr=4096)) == want


@pytest.mark.parametrize("case", ["x_unaligned", "w_unaligned", "co_36",
                                  "w_not_contiguous", "w_fp32",
                                  "w_elsewhere"])
def test_implicit_rule_needs_whole_aligned_chunks(case):
    """Each of the VEC copies' conditions alone sends a bf16 CUDA conv with
    CI = 64 back to im2col: 16-byte aligned x and w, CO % 8 == 0, a
    contiguous w of x's dtype on x's device."""
    xt = torch.zeros((1, 8, 8, 64), dtype=torch.bfloat16)
    wt = torch.zeros((3, 3, 64, 32), dtype=torch.bfloat16)
    assert TG.implicit_ok(_OnDevice(xt, ptr=512), _OnDevice(wt, ptr=1024))
    x, w = {
        "x_unaligned": (_OnDevice(xt, ptr=514), _OnDevice(wt, ptr=1024)),
        "w_unaligned": (_OnDevice(xt, ptr=512), _OnDevice(wt, ptr=1026)),
        "co_36": (_OnDevice(xt, ptr=512),
                  _OnDevice(torch.zeros((3, 3, 64, 36), dtype=torch.bfloat16),
                            ptr=1024)),
        "w_not_contiguous": (_OnDevice(xt, ptr=512),
                             _OnDevice(wt, ptr=1024, contiguous=False)),
        "w_fp32": (_OnDevice(xt, ptr=512), _OnDevice(wt.float(), ptr=1024)),
        "w_elsewhere": (_OnDevice(xt, ptr=512),
                        _OnDevice(wt, "cuda:1", ptr=1024)),
    }[case]
    assert not TG.implicit_ok(x, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_cpu_conv_takes_the_explicit_path(dtype):
    """On CPU tensors a conv the rule would take on the card (CI 16, CO 24)
    still runs im2col + the GEMM's plain version: no launch, no implicit
    count; fp32 matches the reference's conv, bf16 the explicit path's
    bits; ``gemm.conv`` itself refuses CPU tensors."""
    x, w = _xw(3, seed=21, shape=(2, 11, 11, 16), co=24)
    tx, tw = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)
    cfg = TG.GemmConfig(32, 32, 64)
    launches, implicit = TG.gemm.launches, TG.gemm.implicit_launches
    got = TO.conv2d(tx, tw, 2, 1, cfg)
    assert (TG.gemm.launches, TG.gemm.implicit_launches) == (launches,
                                                             implicit)
    assert got.dtype == dtype and got.shape == (2, 6, 6, 24)
    patches, (oh, ow) = TO.im2col(tx, 3, 3, 2, 1)
    assert torch.equal(got, TG.gemm(patches, tw.reshape(-1, 24), cfg)
                       .reshape(2, oh, ow, 24))
    if dtype == torch.float32:
        want = np.asarray(JO.conv2d(jnp.asarray(x), jnp.asarray(w), 2, 1,
                                    JGemmConfig(32, 32, 64)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        TG.conv(tx, tw, 2, 1, cfg)


@pytest.mark.parametrize("use_kernel", [True, False], ids=["gemm", "ref"])
@pytest.mark.parametrize("epi", ["bias", "bias-relu", "bias-residual-relu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_conv2d_epilogue(dtype, epi, use_kernel):
    """``conv2d``'s epilogue on both paths.  Through the GEMM (im2col + its
    plain version on CPU tensors): the GEMM's fp32 output of the same
    geometry, then ``+ bias``, ``+ residual``, ReLU and one rounding, bit
    for bit.  The reference path: the plain ops on the reference conv's
    output, bit for bit; in fp32 both paths keep the unfused composition's
    bits."""
    x, w = _xw(3, seed=31, shape=(2, 9, 9, 16), co=24)
    tx, tw = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)
    gen = torch.Generator().manual_seed(32)
    kw = dict(bias=torch.randn(24, generator=gen).to(dtype),
              relu=epi != "bias")
    if "residual" in epi:
        kw["residual"] = torch.randn((2, 5, 5, 24), generator=gen).to(dtype)
    cfg = TG.GemmConfig(32, 32, 64)
    launches = TG.gemm.launches, TG.gemm.epilogue_launches
    got = TO.conv2d(tx, tw, 2, 1, cfg, use_kernel, **kw)
    assert (TG.gemm.launches, TG.gemm.epilogue_launches) == launches
    if use_kernel:
        patches, _ = TO.im2col(tx, 3, 3, 2, 1)
        out = TG.gemm(patches, tw.reshape(-1, 24), cfg,
                      out_dtype=torch.float32).reshape(2, 5, 5, 24)
    else:
        out = TR.conv2d_ref(tx, tw, 2, 1)
    out = out + kw["bias"]
    if "residual" in kw:
        out = out + kw["residual"]
    want = (torch.relu(out) if kw["relu"] else out).to(dtype)
    assert got.dtype == dtype and got.shape == (2, 5, 5, 24)
    assert torch.equal(got, want)
    if dtype == torch.float32:  # the unfused composition: conv, then ops
        plain = TO.conv2d(tx, tw, 2, 1, cfg, use_kernel) + kw["bias"]
        if "residual" in kw:
            plain = kw["residual"] + plain
        assert torch.equal(got, torch.relu(plain) if kw["relu"] else plain)


@pytest.mark.parametrize("use_kernel", [True, False], ids=["gemm", "ref"])
@pytest.mark.parametrize("case", ["residual-flat", "residual-nchw",
                                  "residual-permuted", "bias-dtype"])
def test_conv2d_rejects_a_wrong_epilogue(case, use_kernel):
    """A residual must have the conv's NHWC output shape and be contiguous,
    and bias and residual x's dtype, on either path: no silent reshape or
    copy."""
    x, w = _xw(3, seed=33, shape=(1, 6, 6, 8), co=16)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    kw, err = {
        "residual-flat": (dict(residual=torch.ones(36, 16)), ValueError),
        "residual-nchw": (dict(residual=torch.ones(1, 16, 6, 6)), ValueError),
        "residual-permuted": (
            dict(residual=torch.ones(1, 16, 6, 6).permute(0, 2, 3, 1)),
            ValueError),
        "bias-dtype": (dict(bias=torch.ones(16).bfloat16()), TypeError),
    }[case]
    with pytest.raises(err):
        TO.conv2d(tx, tw, 1, 1, use_kernel=use_kernel, **kw)
