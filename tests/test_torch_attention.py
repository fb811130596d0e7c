"""Port parity for attention: the plain version of the Hopper flash kernel
against the reference Pallas kernel (``repro.kernels.ops.attention``,
interpret mode) in fp32 and, with P rounded as the tensor-core kernel
rounds it, in bf16; the oracle, forward chunked attention, and decode
attention with its cache updates (full, per-slot, ring) against
``repro.models.layers``.  The kernel itself is tested on the card by
tests/test_torch_gpu.py."""
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_support import one_torch_thread  # noqa: F401
from repro.kernels import ops as JO
from repro.kernels import ref as JREF
from repro.models import layers as JL
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import ops as TO
from repro_torch.models import layers as TL


def _qkv(b, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, hq, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 32)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (6, 1)])
def test_plain_flash_matches_pallas(causal, window, hq, hkv):
    q, k, v = _qkv(2, 100, hq, hkv, 16, seed=hq * 10 + hkv)
    want = np.asarray(JO.attention(*_j(q, k, v), causal=causal,
                                   window=window, block_q=32, block_k=32))
    launches = TF.flash_attention.launches
    got = TO.attention(*_t(q, k, v), causal=causal, window=window,
                       block_q=32, block_k=32)
    assert TF.flash_attention.launches == launches  # the CPU never launches
    # 8-12 heads x 4 query tiles is far under a wave: the KV loops split in
    # runs of 2 tiles, but for the window's, 2 tiles long at most
    assert TF.flash_attention.last_geometry["run"] == {
        "bq": 32, "bk": 32, "dp": 32, "dtype": "float32",
        "kv_chunk": 0 if window else 2}
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# every fp32 template legalize can pick, each requested as itself (each is
# a fixed point of legalize), at a head_dim 4 short of its dp and S 70:
# ragged tiles at every bq and bk, a head_dim tail
F32_TEMPLATE_CASES = [(70, bq, bk, (bq + bk + dp) % 3 != 0, dp - 4)
                      for bq, bk, dp in sorted(TF.f32_templates())]


@pytest.mark.parametrize("s,bq,bk,causal,d", [
    (3, 16, 16, True, 8), (17, 32, 16, False, 8), (33, 16, 64, True, 8),
    (45, 32, 64, False, 8), (64, 16, 16, True, 8), (70, 32, 16, True, 8)]
    + F32_TEMPLATE_CASES)
def test_plain_flash_matches_pallas_mixed_blocks(s, bq, bk, causal, d):
    """Block sizes never change the result (online-softmax correctness),
    at the reference's property-test sizes and at every fp32 template's
    run geometry."""
    q, k, v = _qkv(1, s, 2, 2, d, seed=s + d)
    want = np.asarray(JO.attention(*_j(q, k, v), causal=causal,
                                   block_q=bq, block_k=bk))
    got = TF.flash_attention(*_t(q, k, v), causal=causal, block_q=bq,
                             block_k=bk)
    if (s, bq, bk, causal, d) in F32_TEMPLATE_CASES:
        run = TF.flash_attention.last_geometry["run"]
        assert (run["bq"], run["bk"], run["dp"]) == (bq, bk, d + 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,causal,window,bq,bk,chunk", [
    (100, True, None, 32, 32, 1), (100, False, None, 16, 32, 3),
    (150, True, 20, 16, 16, 1), (150, True, 40, 32, 16, 2),
    (97, False, 30, 64, 16, 2)])
def test_plain_flash_split_matches_pallas(s, causal, window, bq, bk, chunk):
    """A KV split (runs of ``chunk`` tiles, each folded from scratch, then
    merged by exp(m_z - max m)) gives the reference's result, and the
    unsplit walk's to 1e-6; windows leave runs whose first tiles mask a
    row entirely."""
    q, k, v = _qkv(2, s, 4, 2, 24, seed=s + chunk)
    want = np.asarray(JO.attention(*_j(q, k, v), causal=causal,
                                   window=window, block_q=bq, block_k=bk))
    geom = TF.RunGeometry(bq, bk, 32, kv_chunk=chunk)
    got = TF.flash_attention_plain(*_t(q, k, v), causal, window, 24 ** -0.5,
                                   geom)
    whole = TF.flash_attention_plain(*_t(q, k, v), causal, window,
                                     24 ** -0.5, TF.RunGeometry(bq, bk, 32))
    assert max(len(TF.kv_runs(*TF.kv_tile_range(t, bq, bk, s, causal,
                                                 window), chunk))
               for t in range(0, s, bq)) >= 2
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_kv_split_rule():
    """fp32 grids under one wave whose longest query tile holds at least
    twice a slot's share of the KV tiles split; runs partition each
    tile's range in order."""
    def split(s, heads, d, causal=True, dtype=torch.float32):
        return TF.kv_split(TF.legalize(128, 128, s, d, dtype), heads, s,
                           causal, None).kv_chunk
    # qwen2's fp32 gate (12 heads, 16 query tiles of up to 31 KV tiles):
    # 192 blocks for 132 x 2 slots, 3,264 KV tiles -> runs of 7
    assert split(973, 12, 128) == 7
    assert split(973, 12, 128, dtype=torch.bfloat16) == 0   # bf16: never
    assert split(1461, 48, 128) == 0      # 1,104 blocks: over a wave
    assert split(1500, 8, 64, causal=False) == 0   # even tiles
    assert split(224, 64, 128) == 0       # 256 blocks, 7 tiles at most
    assert split(201, 8, 64) == TF.MIN_KV_CHUNK
    for lo, hi, chunk in ((0, 30, 7), (3, 9, 2), (5, 5, 3), (0, 13, 0)):
        runs = TF.kv_runs(lo, hi, chunk)
        assert [j for a, b in runs for j in range(a, b + 1)] == list(
            range(lo, hi + 1))
        assert all(b - a + 1 <= (chunk or hi - lo + 1) for a, b in runs)


@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window,bq,bk", [
    (2, 100, 4, 2, 16, True, None, 32, 32),
    (1, 77, 6, 2, 16, True, 32, 64, 64),
    (1, 50, 4, 1, 8, False, None, 16, 64)])
def test_plain_flash_bf16_matches_pallas(b, s, hq, hkv, d, causal, window,
                                         bq, bk):
    """bf16 inputs.  The Pallas kernel keeps P in fp32 for P V; the plain
    version rounds P to bf16 there, as the tensor-core kernel does.  That
    moves an output, a convex combination of V's rows, by at most 2^-9
    (P's relative rounding) x max|v|; each side then rounds the output to
    bf16 once, at most one step apart: 2^-6 at |o| < 4.  The tolerance is
    the sum of the two."""
    q, k, v = _qkv(b, s, hq, hkv, d, seed=s + d)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(JO.attention(jq, jk, jv, causal=causal, window=window,
                                   block_q=bq, block_k=bk)
                      .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .bfloat16() for x in (jq, jk, jv))
    got = TF.flash_attention(tq, tk, tv, causal=causal, window=window,
                             block_q=bq, block_k=bk)
    assert got.dtype == torch.bfloat16
    assert TF.flash_attention.last_geometry["run"]["dtype"] == "bfloat16"
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 ** -6 + 2 ** -9 * np.abs(v).max())
    assert np.abs(want).max() < 4
    # the rounding of P is what the plain version adds in bf16
    unrounded = TF.flash_attention_plain(
        tq.float(), tk.float(), tv.float(), causal, window, d ** -0.5,
        TF.legalize(bq, bk, s, d, torch.bfloat16))
    assert not torch.equal(got, unrounded.bfloat16())


def test_oracle_matches_reference_oracle():
    q, k, v = _qkv(2, 40, 6, 2, 16, seed=1)
    for causal, window in ((True, None), (False, 8), (True, 8)):
        want = np.asarray(JREF.attention_ref(*_j(q, k, v), causal=causal,
                                             window=window))
        got = TO.attention(*_t(q, k, v), causal=causal, window=window,
                           use_kernel=False)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk", [7, 16, 50, 128])
def test_chunked_attention_matches_reference(chunk):
    q, k, v = _qkv(2, 50, 4, 2, 16, seed=chunk)
    for causal, window in ((True, None), (True, 9)):
        want = np.asarray(JL.chunked_attention(*_j(q, k, v), causal, window,
                                               chunk))
        got = TL.chunked_attention(*_t(q, k, v), causal=causal,
                                   window=window, chunk=chunk)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_kv_tile_range_is_the_reference_block_skip():
    """The kernel's KV loop bounds visit exactly the blocks the reference's
    ``pl.when(relevant)`` computes."""
    for s in (1, 5, 64, 100):
        for bq, bk in ((16, 16), (16, 64), (64, 16), (32, 32)):
            for causal in (True, False):
                for window in (None, 1, 7, 32, 200):
                    n_k = -(-s // bk)
                    for q0 in range(0, s, bq):
                        want = [j for j in range(n_k)
                                if (not causal or j * bk <= q0 + bq - 1)
                                and (window is None
                                     or j * bk + bk - 1 >= q0 - window + 1)]
                        lo, hi = TF.kv_tile_range(q0, bq, bk, s, causal,
                                                  window)
                        assert list(range(lo, hi + 1)) == want


def test_legalize_rule():
    # fp32 (flash_f32_kernel): bk halves until an SM holds 8 warps; at the
    # LM's head_dim 128 the 64 x 64 tiles (184 KB) hold 4, 64 x 32 (109
    # KB) two blocks of 4
    g = TF.legalize(128, 128, 1024, 128)
    assert g == TF.RunGeometry(64, 32, 128, "float32")
    assert g.smem_bytes == 4 * (64 * 132 + 2 * 32 * 132 + 2 * 32 * 128
                                + 32 * 68) == 109_056
    assert g.threads == 128 and g.warps_per_sm == 8
    assert TF.RunGeometry(64, 64, 128).warps_per_sm == 4
    assert TF.legalize(128, 128, 1024, 64) == TF.RunGeometry(64, 64, 64,
                                                             "float32")
    # fp32 head_dim pads to 32 at least (8 threads a row, a float4 each)
    assert TF.legalize(32, 16, 100, 16) == TF.RunGeometry(32, 16, 32,
                                                          "float32")
    assert TF.legalize(128, 128, 12, 20) == TF.RunGeometry(16, 16, 32,
                                                           "float32")
    assert TF.legalize(128, 128, 40, 8) == TF.RunGeometry(32, 32, 32,
                                                          "float32")
    # a 16-row tile at head_dim 128 holds 5 warps an SM even at bk 16: bq
    # doubles
    assert TF.RunGeometry(16, 16, 128).warps_per_sm == 5
    assert TF.legalize(128, 128, 12, 128) == TF.RunGeometry(32, 16, 128,
                                                            "float32")
    # the 17 fp32 templates dispatch_f32 compiles, each a fixed point
    assert len(TF.f32_templates()) == 17
    for bq, bk, dp in TF.f32_templates():
        assert TF.legalize(bq, bk, 4096, dp) == TF.RunGeometry(bq, bk, dp)
    # bf16 tiles cost 2 bytes and pad rows by 8: the serving shape keeps
    # bk 64 (Q 17 KB + two K/V stages 68 KB)
    g = TF.legalize(128, 128, 1024, 128, torch.bfloat16)
    assert g == TF.RunGeometry(64, 64, 128, "bfloat16")
    assert g.smem_bytes == (64 + 4 * 64) * 136 * 2 <= TF.SMEM_BUDGET
    assert TF.legalize(128, 128, 40, 8, torch.bfloat16) == TF.RunGeometry(
        32, 32, 16, "bfloat16")
    for dtype in (torch.float32, torch.bfloat16):
        for d in (8, 16, 64, 128):
            for s in (3, 100, 4096):
                g = TF.legalize(128, 128, s, d, dtype)
                if dtype == torch.bfloat16:   # never halved
                    assert g.smem_bytes <= TF.SMEM_BUDGET
                    assert g.bk == min(64, max(16, 1 << (s.bit_length() - 1)))
                else:                         # the fp32 budget
                    assert g.warps_per_sm >= TF.F32_MIN_WARPS
                    assert (g.smem_bytes + TF.BLOCK_SMEM_RESERVED) * (
                        TF.F32_MIN_WARPS * 32 // g.threads
                    ) <= TF.SM_SMEM_BYTES
                    assert (g.bq, g.bk, g.dp) in TF.f32_templates()
                    assert g.dp == max(32, d)
    with pytest.raises(ValueError):
        TF.legalize(128, 128, 64, 256)
    with pytest.raises(TypeError):
        TF.legalize(128, 128, 64, 64, torch.float16)


def test_dispatch_f32_compiles_exactly_the_legal_templates():
    """``dispatch_f32`` in the CUDA source instantiates the fp32 templates
    legalize can pick and no other (nvcc time; no dead template)."""
    src = (Path(TF.__file__).parent / "csrc" / "flash_attention.cu")
    body = src.read_text().split("int dispatch_f32(")[1].split("\n}\n")[0]
    listed = {tuple(map(int, t)) for t in
              re.findall(r"F32\((\d+), (\d+), (\d+)\);", body)}
    assert listed == set(TF.f32_templates())


@pytest.mark.parametrize("dtype,d,offset,vec", [
    (torch.float32, 128, 0, True), (torch.float32, 64, 0, True),
    (torch.float32, 20, 0, True),              # 5 float4s a row
    (torch.float32, 18, 0, False),             # D % 4 != 0
    (torch.float32, 6, 0, False),
    (torch.float32, 128, 1, False),            # one value off 16 bytes
    (torch.float32, 128, 4, True),             # 16 bytes off: aligned
    (torch.bfloat16, 20, 0, False),            # bf16 needs D % 8 == 0
    (torch.bfloat16, 16, 0, True), (torch.bfloat16, 16, 1, False)])
def test_vec_rule(dtype, d, offset, vec):
    """The kernel copies by 16 bytes when head_dim is a whole number of
    16-byte chunks (4 fp32 or 8 bf16 values) and q, k and v start on
    16-byte boundaries; a tensor that starts one value into its storage
    takes the 4-byte (fp32) or scalar (bf16) copies."""
    shape = (1, 5, 2, d)
    n = int(np.prod(shape))
    base = torch.zeros(offset + n + 16, dtype=dtype)
    q = base[offset:offset + n].view(shape)
    k, v = (torch.zeros(shape, dtype=dtype) for _ in range(2))
    assert q.is_contiguous()
    assert TF.vec_copies(q, k, v) is vec
    assert TF.vec_copies(k, q, v) is vec and TF.vec_copies(k, v, q) is vec


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = _t(*_qkv(1, 8, 4, 2, 8, seed=0))
    with pytest.raises(ValueError):
        TF.flash_attention(q, k[:, :4], v[:, :4])         # sequence differs
    with pytest.raises(ValueError):
        TF.flash_attention(q[:, :, :3], k, v)             # 3 % 2 heads
    with pytest.raises(TypeError):
        TF.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        TF.flash_attention(q, k, v, window=0)


# ------------------------------------------------------------------ decode

def _cache(b, smax, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, smax, hkv, d)).astype(np.float32),
            rng.standard_normal((b, smax, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("cache_len,window", [
    (np.int32(9), None), (np.array([3, 12, 16], np.int32), None),
    (np.array([3, 12, 16], np.int32), 5)])
def test_decode_attention_matches_reference(cache_len, window):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((3, 1, 4, 8)).astype(np.float32)
    kc, vc = _cache(3, 16, 2, 8, seed=8)
    want = np.asarray(JL.decode_attention(*_j(q, kc, vc),
                                          jnp.asarray(cache_len), window))
    got = TL.decode_attention(*_t(q, kc, vc), torch.from_numpy(
        np.asarray(cache_len)), window)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("position,ring", [
    (np.int32(5), False), (np.array([0, 7, 15], np.int32), False),
    (np.array([2, 16, 40], np.int32), False),   # past the end: clamped
    (np.array([2, 16, 40], np.int32), True)])   # ring: modulo
def test_update_kv_cache_matches_reference(position, ring):
    kc, vc = _cache(3, 16, 2, 8, seed=9)
    rng = np.random.default_rng(10)
    kn = rng.standard_normal((3, 1, 2, 8)).astype(np.float32)
    vn = rng.standard_normal((3, 1, 2, 8)).astype(np.float32)
    wk, wv = JL.update_kv_cache(*_j(kc, vc, kn, vn), jnp.asarray(position),
                                ring=ring)
    tk, tv = _t(kc.copy(), vc.copy())
    gk, gv = TL.update_kv_cache(tk, tv, *_t(kn, vn),
                                torch.from_numpy(np.asarray(position)),
                                ring=ring)
    assert gk is tk and gv is tv                 # written in place
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_decode_attention_ring_matches_reference():
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 1, 4, 8)).astype(np.float32)
    kc, vc = _cache(2, 16, 2, 8, seed=12)
    for position in (np.array([3, 30], np.int32), np.int32(15)):
        want = np.asarray(JL.decode_attention_ring(
            *_j(q, kc, vc), jnp.asarray(position), 16))
        got = TL.decode_attention_ring(*_t(q, kc, vc), torch.from_numpy(
            np.asarray(position)), 16)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
