"""Port parity for RMSNorm: the plain version of the Hopper kernel against
the reference Pallas kernel (interpret mode) at the reference's test shapes
and block_rows, the run geometry, and the wrapper's checks.  The kernel
itself is tested on the card by tests/test_torch_gpu.py."""
import itertools

import ml_dtypes
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_support import one_torch_thread  # noqa: F401
from repro.kernels import rmsnorm as JR
from repro_torch.kernels import _build, ref
from repro_torch.kernels import rmsnorm as TR

# the reference's test shapes, then the widest row the kernel takes
SHAPES = [(4, 64), (2, 100, 96), (1, 7, 33), (129, 256), (3, 8192)]


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


@pytest.mark.parametrize("shape", [(9, 96), (8, 1536)], ids=str)
def test_plain_matches_pallas_rmsnorm_bf16(shape):
    """bf16 in and out, fp32 math inside, one rounding at the end: the two
    agree to one bf16 ulp (2^-7 relative) of each output.  (8, 1536) is a
    qwen2-1.5b decode step's norm."""
    x, w = _operands(shape, seed=3)
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


F32, BF16 = torch.float32, torch.bfloat16
# (d, dtype, 16-byte copies, (warps a row, slots a lane) for few rows, the
# same for many rows): d % 4 (fp32) or d % 8 (bf16) != 0 takes the scalar
# template (32 values a lane); up to SPREAD_ROWS rows a row takes the
# warps that give each lane one copy, up to 8; past them the fewest warps
# that hold it in at most 8 copies (32 values) a lane; then the fewest
# slots of (1, 2, 4, 6, 8) that hold it
LAYOUTS = [(33, F32, False, (2, 32), (1, 32)),
           (256, F32, True, (2, 1), (1, 2)),
           (257, F32, False, (8, 32), (1, 32)),
           (1536, F32, True, (8, 2), (2, 6)),
           (8192, F32, True, (8, 8), (8, 8)),
           (33, BF16, False, (2, 32), (1, 32)),
           (96, F32, True, (1, 1), (1, 1)),
           (96, BF16, True, (1, 1), (1, 1)),
           (256, BF16, True, (1, 1), (1, 1)),
           (1536, BF16, True, (6, 1), (1, 6)),
           (8192, BF16, True, (8, 4), (4, 8)),
           (1024, BF16, True, (4, 1), (1, 4)),
           (1280, BF16, True, (5, 1), (1, 6)),
           (2048, F32, True, (8, 2), (2, 8)),
           (2560, F32, True, (8, 4), (3, 8))]
# rows -> warps a row -> (rows a block, grid): one-warp rows go up to 4 to
# a block; wider rows one a block, the grid capped at 132 SMs x the
# blocks resident on one (2048 threads, 32 blocks)
GRIDS = {1: lambda warps: (1, 1),
         8: lambda warps: (4, 2) if warps == 1 else (1, 8),
         1024: lambda warps: (4, 256) if warps == 1 else (1, 1024),
         4096: lambda warps: {1: (4, 1024), 2: (1, 4096), 3: (1, 2772),
                              4: (1, 2112), 8: (1, 1056)}[warps]}


@pytest.mark.parametrize("rows", sorted(GRIDS))
@pytest.mark.parametrize("d,dtype,vec,few,many", LAYOUTS,
                         ids=lambda v: str(v).removeprefix("torch."))
def test_run_geometry(d, dtype, vec, few, many, rows):
    geom = TR.legalize(d, rows, dtype)
    warps, slots = few if rows <= TR.SPREAD_ROWS else many
    assert (geom.warps_per_row, geom.threads, geom.vec, geom.slots) == (
        warps, 32 * warps, vec, slots)
    width = TR.vector_width(dtype) if vec else 1
    assert geom.slots * width * geom.threads >= d
    assert (geom.rows_per_block, geom.grid) == GRIDS[rows](warps)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=str)
def test_row_layout_follows_the_rows(dtype):
    """Up to SPREAD_ROWS rows a row spreads over the warps that give each
    lane one copy (up to 8); past them it takes the fewest warps that hold
    it in at most 8 copies a lane.  Either way the layout holds the row,
    and only one-warp rows share a block."""
    width = TR.vector_width(dtype)
    for d in (32, 96, 256, 1024, 1536, 4096, 8192):
        copies = d // width
        for rows in (1, 8, 131, 132, 133, 263, 264, 265, 377, 384, 1006,
                     1057, 100000):
            g = TR.legalize(d, rows, dtype)
            per_lane = 1 if rows <= TR.SPREAD_ROWS else 8
            want = min(8, -(-copies // (32 * per_lane)))
            assert g.warps_per_row == want, (d, rows, g)
            assert g.slots * width * g.threads >= d
            assert (g.rows_per_block > 1) <= (want == 1)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=str)
def test_copy_width_follows_d_dtype_and_alignment(dtype):
    """16-byte copies exactly where d is a multiple of a copy's values (4
    fp32, 8 bf16) and the operands are aligned; every other case takes the
    scalar template, which holds any d up to MAX_D.  Each geometry names a
    compiled template, with the fewest slots that hold the row."""
    width = TR.vector_width(dtype)
    assert width == {F32: 4, BF16: 8}[dtype]
    for d, rows in itertools.product(
            list(range(1, 70)) + [1535, 1536, 1540, 2056, 4104, 8188, 8190,
                                  8192], (8, 1024)):
        geom = TR.legalize(d, rows, dtype)
        assert geom.vec == (d % width == 0), d
        assert 1 <= geom.warps_per_row <= TR.WARPS_PER_ROW
        if geom.vec:
            assert geom.slots in TR.VEC_SLOTS
            assert geom.slots * width * geom.threads >= d
            # no smaller template of as many warps holds the row
            fewer = [n for n in TR.VEC_SLOTS if n < geom.slots]
            assert not fewer or fewer[-1] * width * geom.threads < d
        scalar = TR.legalize(d, rows, dtype, aligned=False)
        assert not scalar.vec and scalar.slots == TR.SCALAR_SLOTS
        assert scalar.slots * scalar.threads >= d
        assert 1 <= scalar.warps_per_row <= TR.WARPS_PER_ROW
    # the wrapper records the geometry it chose (the CPU never misaligns)
    x = torch.ones(2, 24, dtype=dtype)
    TR.rmsnorm(x, torch.ones(24, dtype=dtype))
    assert TR.rmsnorm.last_geometry["run"]["vec"] == (24 % width == 0)


@pytest.mark.parametrize("d,dtype", [(33, F32), (1536, BF16), (1536, F32),
                                     (4096, BF16), (8192, F32), (96, BF16)],
                         ids=str)
def test_grid_is_capped_and_covers_every_row(d, dtype):
    """Up to ROWS_PER_BLOCK one-warp rows a block, else one; no block is
    idle; the grid stays within SM_COUNT x the blocks resident on an SM,
    and the kernel's grid-stride row loop visits every row exactly once."""
    for rows in (1, 2, 7, 8, 9, 131, 132, 133, 1006, 1024, 4096, 4225,
                 20000):
        g = TR.legalize(d, rows, dtype)
        block = g.rows_per_block * g.threads
        assert block <= 256
        assert g.rows_per_block == (min(TR.ROWS_PER_BLOCK, rows)
                                    if g.warps_per_row == 1 else 1)
        cap = _build.SM_COUNT * min(TR.SM_BLOCKS, TR.SM_THREADS // block)
        assert 1 <= g.grid <= cap
        assert (g.grid - 1) * g.rows_per_block < rows  # no idle block
        step = g.grid * g.rows_per_block
        seen = [r for b in range(g.grid) for y in range(g.rows_per_block)
                for r in range(b * g.rows_per_block + y, rows, step)]
        assert sorted(seen) == list(range(rows)), (rows, g)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.ones(4, 8)
    with pytest.raises(ValueError):
        TR.legalize(TR.MAX_D + 1, 8)
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
