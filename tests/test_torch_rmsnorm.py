"""Port parity for RMSNorm: the plain version of the Hopper kernel against
the reference Pallas kernel (interpret mode) at the reference's test shapes
and block_rows, the run geometry, and the wrapper's checks.  The kernel
itself is tested on the card by tests/test_torch_gpu.py."""
import ml_dtypes
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_support import one_torch_thread  # noqa: F401
from repro.kernels import rmsnorm as JR
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as TR

SHAPES = [(4, 64), (2, 100, 96), (1, 7, 33), (129, 256)]


def _operands(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape[-1:]).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("block_rows", [8, 32, 128])
def test_plain_matches_pallas_rmsnorm(shape, block_rows):
    x, w = _operands(shape, seed=len(shape) * 100 + shape[-1])
    want = np.asarray(JR.rmsnorm(jnp.asarray(x), jnp.asarray(w),
                                 block_rows=block_rows, interpret=True))
    launches = TR.rmsnorm.launches
    got = TR.rmsnorm(torch.from_numpy(x), torch.from_numpy(w),
                     block_rows=block_rows)
    assert TR.rmsnorm.launches == launches  # the CPU never launches
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert TR.rmsnorm.last_geometry["requested"] == {"block_rows": block_rows}


def test_plain_matches_pallas_rmsnorm_bf16():
    """bf16 in and out, fp32 math inside, one rounding at the end: the two
    agree to one bf16 ulp (2^-7 relative) of each output."""
    x, w = _operands((9, 96), seed=3)
    xb = x.astype(ml_dtypes.bfloat16)
    wb = w.astype(ml_dtypes.bfloat16)
    want = np.asarray(JR.rmsnorm(jnp.asarray(xb), jnp.asarray(wb),
                                 block_rows=8, interpret=True),
                      np.float32)
    got = TR.rmsnorm(torch.from_numpy(xb.astype(np.float32)).bfloat16(),
                     torch.from_numpy(wb.astype(np.float32)).bfloat16(),
                     block_rows=8)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** -7 * np.abs(want)
    assert np.all(np.abs(got.float().numpy() - want) <= ulp + 1e-30)


def test_plain_follows_the_kernel_not_the_jnp_layer():
    """In fp32 the kernel's function equals the reference's jnp
    ``layers.rmsnorm``; the port's model uses the kernel's."""
    from repro.models.layers import rmsnorm as jnp_rmsnorm
    x, w = _operands((5, 48), seed=5)
    want = np.asarray(jnp_rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    got = ref.rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,vpt", [(33, 1), (256, 1), (257, 2), (1536, 8),
                                   (8192, 32)])
def test_run_geometry(d, vpt):
    geom = TR.legalize(d)
    assert (geom.rows_per_block, geom.threads, geom.vpt) == (1, 256, vpt)
    assert geom.vpt * geom.threads >= d


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.ones(4, 8)
    with pytest.raises(ValueError):
        TR.legalize(TR.MAX_D + 1)
    with pytest.raises(ValueError):
        TR.rmsnorm(x, torch.ones(7))
    with pytest.raises(ValueError):
        TR.rmsnorm(torch.ones(0, 8), torch.ones(8))
    with pytest.raises(TypeError):
        TR.rmsnorm(x.double(), torch.ones(8))
    # the plain path on request gives the same function
    w = torch.arange(8.0)
    torch.testing.assert_close(TR.rmsnorm(x, w, use_kernel=False),
                               ref.rmsnorm_ref(x, w))
