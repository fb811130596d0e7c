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
