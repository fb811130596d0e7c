"""Port parity for the GEMM: the plain version of the Hopper kernel against
the reference Pallas kernel (interpret mode), split-K included, the knob
mapping, the legalizer (tiles, split-K slices, the 16-byte copy variant)
and the wrapper's checks.  The kernel itself is tested on the card by
tests/test_torch_gpu.py."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_support import one_torch_thread  # noqa: F401
from repro.core.task import conv_tasks as jax_conv_tasks
from repro.kernels import gemm as JG
from repro_torch.kernels import _build
from repro_torch.kernels import gemm as TG

# the reference's test_kernels shapes and configs
GEMM_SHAPES = [(8, 8, 8), (100, 70, 90), (128, 128, 128), (1, 256, 33),
               (257, 129, 65)]
GEMM_CONFIGS = [(32, 32, 32, True, True), (128, 128, 128, True, True),
                (16, 64, 128, False, True), (8, 128, 256, True, False)]


def _operands(m, k, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(dtype),
            rng.standard_normal((k, n)).astype(dtype))


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
@pytest.mark.parametrize("cfg", GEMM_CONFIGS, ids=str)
def test_plain_matches_pallas_gemm(m, k, n, cfg):
    a, b = _operands(m, k, n, seed=m * 7 + n)
    want = np.asarray(JG.gemm(jnp.asarray(a), jnp.asarray(b),
                              JG.GemmConfig(*cfg), interpret=True))
    got = TG.gemm(torch.from_numpy(a), torch.from_numpy(b),
                  TG.GemmConfig(*cfg))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_plain_matches_pallas_gemm_bf16():
    a, b = _operands(64, 64, 64, seed=4)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    want = JG.gemm(ja, jb, JG.GemmConfig(32, 32, 32), interpret=True)
    ta = torch.from_numpy(np.array(ja.astype(jnp.float32))).bfloat16()
    tb = torch.from_numpy(np.array(jb.astype(jnp.float32))).bfloat16()
    got = TG.gemm(ta, tb, TG.GemmConfig(32, 32, 32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
@pytest.mark.parametrize("pair", ["float32->bfloat16", "bfloat16->float32"])
def test_plain_out_dtype_matches_pallas_gemm(m, k, n, pair):
    """``out_dtype`` as in the reference: the fp32 accumulator cast once to
    the requested type.  An fp32 product written in bf16 agrees to bf16
    rounding (two fp32 sums in different orders may round apart by one bf16
    step); a bf16 product written in fp32 to fp32 summation order."""
    src, dst = pair.split("->")
    a, b = _operands(m, k, n, seed=m * 3 + k)
    ja, jb = jnp.asarray(a, src), jnp.asarray(b, src)
    for cfg in ((32, 32, 32, True, True), (128, 128, 128, True, True)):
        want = JG.gemm(ja, jb, JG.GemmConfig(*cfg), out_dtype=jnp.dtype(dst),
                       interpret=True)
        ta = torch.from_numpy(np.array(ja.astype(jnp.float32))).to(
            getattr(torch, src))
        tb = torch.from_numpy(np.array(jb.astype(jnp.float32))).to(
            getattr(torch, src))
        got = TG.gemm(ta, tb, TG.GemmConfig(*cfg),
                      out_dtype=getattr(torch, dst))
        assert got.dtype == getattr(torch, dst) and got.shape == (m, n)
        tol = dict(rtol=2 ** -7, atol=2 ** -7) if dst == "bfloat16" \
            else dict(rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **tol)
    # None keeps a's dtype, as the reference's ``out_dtype or a.dtype``
    assert TG.gemm(ta, tb).dtype == ta.dtype
    with pytest.raises(TypeError):
        TG.gemm(ta, tb, out_dtype=torch.float16)


def test_gemm_config_from_knobs_identical():
    for tm in (1, 7, 8, 9, 64, 100, 4096):
        for tn in (1, 64, 100, 128, 129, 512):
            for tk in (3, 60, 128, 147, 576, 4608):
                for th, oc in ((1, 1), (2, 1), (1, 4)):
                    want = JG.gemm_config_from_knobs(tm, tn, tk, th, oc)
                    got = TG.gemm_config_from_knobs(tm, tn, tk, th, oc)
                    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_legalizer_covers_resnet18_knob_configs_within_smem():
    """Every knob-derived config of the 8 ResNet-18 tasks at batch 8 maps
    onto a compiled template in both dtypes, no tile above what the
    problem needs, its K slices cover K, and every template, fp32 and
    bf16 (dynamic shared memory: bf16's three-stage ring), fits the budget
    of two blocks an SM; bf16 leaves out only the 128 x 128 x 64 ring,
    which would not."""
    for bm in TG.BM_TEMPLATES:
        for bn in TG.BN_TEMPLATES:
            assert TG.bk_templates(torch.float32, bm, bn) == TG.BK_TEMPLATES
            for bk in TG.BK_TEMPLATES:
                assert TG.RunGeometry(bm, bn, bk).smem_bytes <= TG.SMEM_BUDGET
            kept = TG.bk_templates(torch.bfloat16, bm, bn)
            assert kept == ((32,) if (bm, bn) == (128, 128) else (32, 64))
            for bk in TG.BF16_BK_TEMPLATES:
                fits = (TG.RunGeometry(bm, bn, bk, dtype="bfloat16").smem_bytes
                        <= TG.SMEM_BUDGET)
                assert fits is (bk in kept)
    seen = set()
    for task in jax_conv_tasks("resnet-18", batch=8):
        sp, wl = task.space, task.space.workload
        oh = (wl["h"] + 2 * wl["pad"] - wl["kh"]) // wl["stride"] + 1
        m, n, k = wl["b"] * oh * oh, wl["co"], wl["ci"] * wl["kh"] * wl["kw"]
        for tb in sp.choices[0]:
            for th in sp.choices[5]:
                for tw in sp.choices[6]:
                    for ci in sp.choices[1]:
                        for co in sp.choices[2]:
                            cfg = TG.gemm_config_from_knobs(
                                tb * th * tw, co, ci * wl["kh"] * wl["kw"],
                                2, 2)
                            for dt in (torch.float32, torch.bfloat16):
                                g = TG.legalize(cfg, m, n, k, dt)
                                assert g.bm in TG.BM_TEMPLATES
                                assert g.bn in TG.BN_TEMPLATES
                                assert g.bk in TG.bk_templates(dt, g.bm,
                                                               g.bn)
                                assert g.smem_bytes <= TG.SMEM_BUDGET
                                assert g.bm <= max(16, min(cfg.block_m, m))
                                assert g.bn <= max(32, min(cfg.block_n, n))
                                assert len(g.k_slices(k)) == g.split_k
                                seen.add((g.bm, g.bn, g.bk, g.dtype))
    # tuning really moves the run geometry: all four M tiles occur
    assert {g[0] for g in seen if g[3] == "float32"} == set(TG.BM_TEMPLATES)
    assert {g[0] for g in seen if g[3] == "bfloat16"} == set(TG.BM_TEMPLATES)


def test_legalize_rule():
    g = TG.legalize(TG.GemmConfig(4096, 512, 4608), 392, 512, 4608)
    assert g == TG.RunGeometry(128, 128, 32, split_k=16, vec=True)
    g = TG.legalize(TG.GemmConfig(8, 128, 128), 100352, 64, 147)
    assert g == TG.RunGeometry(16, 64, 32, split_k=1, vec=False)
    g = TG.legalize(TG.GemmConfig(48, 128, 128), 1, 33, 8)
    assert g == TG.RunGeometry(16, 32, 16, split_k=1, vec=False)
    g = TG.legalize(TG.GemmConfig(100, 96, 20), 1000, 1000, 1000)
    assert g == TG.RunGeometry(64, 64, 16, split_k=1, vec=True)
    # bf16: its own BK (64 but at 128 x 128, whose ring takes 32), cut by
    # the same split-K rule, 16-byte copies at K % 8 == N % 8 == 0
    g = TG.legalize(TG.GemmConfig(4096, 512, 4608), 392, 512, 4608,
                    torch.bfloat16)
    assert g == TG.RunGeometry(128, 128, 32, split_k=16, vec=True,
                               dtype="bfloat16")
    g = TG.legalize(TG.GemmConfig(8, 128, 128), 100352, 64, 147,
                    torch.bfloat16)
    assert g == TG.RunGeometry(16, 64, 64, split_k=1, vec=False,
                               dtype="bfloat16")
    g = TG.legalize(TG.GemmConfig(48, 128, 128), 1, 33, 8, torch.bfloat16)
    assert g == TG.RunGeometry(16, 32, 32, split_k=1, vec=False,
                               dtype="bfloat16")


# ResNet-18 at batch 8 under the default GemmConfig: (M, N, K) -> (tiles,
# split_k).  1568 x 256 at 128 x 128 is 26 tiles: 264 // 26 = 10 slices
# wanted, 72 steps of 32 share out as 8 a slice, so 9 slices.
RESNET18_SPLITS = {
    (100352, 64, 147): (784, 1), (25088, 64, 576): (196, 1),
    (6272, 128, 576): (49, 4), (6272, 128, 1152): (49, 5),
    (1568, 256, 1152): (26, 9), (1568, 256, 2304): (26, 9),
    (392, 512, 2304): (16, 15), (392, 512, 4608): (16, 16)}


def test_split_k_rule():
    """No split at SM_COUNT tiles or more; below, about two blocks an SM,
    no slice under MIN_SLICE_STEPS steps; the slices cover K exactly in
    order, whole bk steps each but the last; the 8 ResNet-18 shapes."""
    assert TG.split_k_for(_build.SM_COUNT, 1000) == 1
    assert TG.split_k_for(_build.SM_COUNT + 40, 1000) == 1
    assert TG.split_k_for(_build.SM_COUNT - 1, 1000) == 2
    assert TG.split_k_for(1, 7) == 1          # 7 steps: no 4-step slices
    for tiles in range(1, 200):
        for steps in (1, 3, 4, 8, 9, 36, 72, 100, 144, 1000):
            split = TG.split_k_for(tiles, steps)
            assert split >= 1
            if tiles >= _build.SM_COUNT:
                assert split == 1
            assert tiles * split <= max(tiles,
                                        TG.BLOCKS_PER_SM * _build.SM_COUNT)
            for bk in TG.BK_TEMPLATES:
                for k in (steps * bk, steps * bk - bk // 2):
                    if k < 1:
                        continue
                    g = TG.RunGeometry(128, 128, bk, split_k=split)
                    sl = g.k_slices(k)
                    assert len(sl) == split
                    assert sl[0][0] == 0 and sl[-1][1] == k
                    assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
                    assert all((hi - lo) == g.slice_width(k)
                               for lo, hi in sl[:-1])
                    assert g.slice_width(k) % bk == 0
                    assert 0 < sl[-1][1] - sl[-1][0] <= g.slice_width(k)
                    if split > 1:
                        assert g.slice_width(k) >= TG.MIN_SLICE_STEPS * bk
    seen = {}
    for task in jax_conv_tasks("resnet-18", batch=8):
        wl = task.space.workload
        oh = (wl["h"] + 2 * wl["pad"] - wl["kh"]) // wl["stride"] + 1
        m, n, k = wl["b"] * oh * oh, wl["co"], wl["ci"] * wl["kh"] * wl["kw"]
        g = TG.legalize(TG.GemmConfig(), m, n, k)
        seen[(m, n, k)] = (-(-m // g.bm) * -(-n // g.bn), g.split_k)
    assert seen == RESNET18_SPLITS


@pytest.mark.parametrize("k,n,vec", [(147, 64, False), (129, 33, False),
                                     (128, 33, False), (129, 32, False),
                                     (576, 64, True), (8, 8, True)])
def test_copy_variant_follows_row_strides(k, n, vec):
    """16-byte copies need K % 4 == 0 (A's rows) and N % 4 == 0 (B's) in
    fp32, K % 8 == 0 and N % 8 == 0 in bf16; conv1's K 147 and the
    reference's K 129 / N 33 take the scalar one."""
    assert TG.legalize(TG.GemmConfig(), 300, n, k).vec is vec
    assert TG.legalize(TG.GemmConfig(), 300, n, k, torch.bfloat16).vec is (
        vec and k % 8 == 0 and n % 8 == 0)


@pytest.mark.parametrize("k,n,vec32,vec16", [
    (36, 64, True, False), (576, 12, True, False), (1152, 256, True, True),
    (20, 20, True, False)])
def test_bf16_copy_variant_needs_8_values(k, n, vec32, vec16):
    """A 16-byte copy holds 4 fp32 values but 8 bf16: rows whose stride is
    a multiple of 4 values and not of 8 take 16 bytes in fp32 only."""
    assert TG.legalize(TG.GemmConfig(), 300, n, k).vec is vec32
    assert TG.legalize(TG.GemmConfig(), 300, n, k, torch.bfloat16).vec is vec16


# ResNet-18 at batch 8 in bf16 under the default GemmConfig: (M, N, K) ->
# (run tile, split_k, vec).  At 128 x 128 the ring takes BK 32 (64 would
# pass the budget), elsewhere 64; conv1's K 147 takes the scalar copies.
RESNET18_BF16 = {
    (100352, 64, 147): ((128, 64, 64), 1, False),
    (25088, 64, 576): ((128, 64, 64), 1, True),
    (6272, 128, 576): ((128, 128, 32), 4, True),
    (6272, 128, 1152): ((128, 128, 32), 5, True),
    (1568, 256, 1152): ((128, 128, 32), 9, True),
    (1568, 256, 2304): ((128, 128, 32), 9, True),
    (392, 512, 2304): ((128, 128, 32), 15, True),
    (392, 512, 4608): ((128, 128, 32), 16, True)}


@pytest.mark.parametrize("mnk", list(RESNET18_BF16), ids=str)
def test_bf16_split_k_for_resnet18(mnk):
    """bf16 takes the fp32 split-K rule: the deep layers' 16-49 tiles are
    cut to about two blocks an SM, whole BK steps a slice."""
    m, n, k = mnk
    g = TG.legalize(TG.GemmConfig(), m, n, k, torch.bfloat16)
    tile, split, vec = RESNET18_BF16[mnk]
    assert ((g.bm, g.bn, g.bk), g.split_k, g.vec) == (tile, split, vec)
    tiles = -(-m // g.bm) * -(-n // g.bn)
    assert g.split_k == TG.split_k_for(tiles, -(-k // g.bk))
    assert len(g.k_slices(k)) == g.split_k
    assert g.smem_bytes <= TG.SMEM_BUDGET


@pytest.mark.parametrize("m,k,n,cfg", [
    (64, 512, 64, (64, 64, 128, True, True)),     # 4 even slices
    (100, 300, 70, (128, 128, 128, True, True)),  # 2 slices, the last short
    (1, 256, 33, (16, 32, 16, True, True))])      # 4 slices of one row
def test_plain_split_k_matches_pallas_gemm(m, k, n, cfg):
    """fp32 at 1e-5 of the largest output: the slices reassociate the K
    sum, whose rounding grows with the sum's magnitude (~sqrt(K) for unit
    normals), not with each output's."""
    a, b = _operands(m, k, n, seed=m + k + n)
    geom = TG.legalize(TG.GemmConfig(*cfg), m, n, k)
    assert geom.split_k > 1
    want = np.asarray(JG.gemm(jnp.asarray(a), jnp.asarray(b),
                              JG.GemmConfig(*cfg), interpret=True))
    got = TG.gemm(torch.from_numpy(a), torch.from_numpy(b),
                  TG.GemmConfig(*cfg))
    assert TG.gemm.last_geometry["run"]["split_k"] == geom.split_k
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("m,k,n,cfg", [
    (64, 512, 64, (64, 64, 128, True, True)),     # 2 even slices
    (100, 600, 70, (128, 128, 128, True, True)),  # 2 slices, the last short
    (1, 512, 33, (16, 32, 32, True, True))])      # 4 slices of one row
def test_plain_split_k_bf16_matches_pallas_gemm(m, k, n, cfg):
    """bf16 split-K against the reference's Pallas kernel on the same bf16
    operands: both sum exact bf16 products in fp32 and round once to bf16,
    the slices only reassociate the sum, so one bf16 step apart at most
    (rtol 2^-7, and atol 2^-7 of the largest output for the sum's own
    rounding)."""
    a, b = _operands(m, k, n, seed=m + 2 * k + n)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    geom = TG.legalize(TG.GemmConfig(*cfg), m, n, k, torch.bfloat16)
    assert geom.split_k > 1
    want = np.asarray(JG.gemm(ja, jb, JG.GemmConfig(*cfg), interpret=True)
                      .astype(jnp.float32))
    ta = torch.from_numpy(np.array(ja.astype(jnp.float32))).bfloat16()
    tb = torch.from_numpy(np.array(jb.astype(jnp.float32))).bfloat16()
    got = TG.gemm(ta, tb, TG.GemmConfig(*cfg))
    assert got.dtype == torch.bfloat16
    assert TG.gemm.last_geometry["run"]["split_k"] == geom.split_k
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(want).max())


def test_plain_version_walks_tails_and_records_geometry():
    a, b = _operands(37, 50, 29, seed=9)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    before = TG.gemm.launches
    out = TG.gemm(ta, tb, TG.GemmConfig(16, 32, 16, parallel_m=False))
    np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-5, atol=1e-5)
    assert TG.gemm.launches == before  # the plain version is no launch
    assert TG.gemm.last_geometry == {
        "requested": {"block_m": 16, "block_n": 32, "block_k": 16,
                      "parallel_m": False, "parallel_n": True},
        "run": {"bm": 16, "bn": 32, "bk": 16, "split_k": 1, "vec": False,
                "dtype": "float32"}}
    geom = TG.RunGeometry(16, 32, 16)
    np.testing.assert_allclose(TG.gemm_plain(ta, tb, geom).numpy(),
                               a @ b, rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = torch.ones(4, 5)
    with pytest.raises(ValueError):
        TG.gemm(a, torch.ones(6, 3))
    with pytest.raises(ValueError):
        TG.gemm(a[None], torch.ones(5, 3))
    with pytest.raises(TypeError):
        TG.gemm(a.double(), torch.ones(5, 3).double())
    with pytest.raises(TypeError):
        TG.gemm(a, torch.ones(5, 3).bfloat16())
    with pytest.raises(ValueError):
        TG.gemm(torch.ones(0, 5), torch.ones(5, 3))
    with pytest.raises(ValueError):  # no kernel and no silent fallback
        TG.gemm(torch.ones(4, 5, device="meta"),
                torch.ones(5, 3, device="meta"))


def _epilogue_operands(case):
    """(a, b, config, epilogue kwargs, what C must equal) of one case of
    :func:`test_plain_epilogue`; a, b fp32 unless the case says."""
    a, b = _operands(37, 50, 29, seed=11)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    cfg = TG.GemmConfig(16, 32, 16)
    plain = TG.gemm(ta, tb, cfg)
    gen = torch.Generator().manual_seed(12)
    bias = torch.randn(29, generator=gen)
    res = torch.randn(37, 29, generator=gen)
    if case == "bias":          # one value a column, broadcast over rows
        return ta, tb, cfg, dict(bias=bias), plain + bias[None, :]
    if case == "residual":      # one value an element
        return ta, tb, cfg, dict(residual=res), plain + res
    if case == "all":           # bias, then residual, then ReLU
        return (ta, tb, cfg, dict(bias=bias, residual=res, relu=True),
                torch.relu((plain + bias) + res))
    if case == "add-order":
        # C = 0.75 everywhere, bias 2^24, residual -2^24: in fp32
        # (0.75 + 2^24) - 2^24 is 0, (0.75 - 2^24) + 2^24 is 1, the exact
        # sum 0.75; the epilogue adds the bias first
        big = torch.full((8,), 2.0 ** 24)
        return (torch.ones(8, 4), torch.full((4, 8), 0.1875), cfg,
                dict(bias=big, residual=-big.expand(8, 8).contiguous()),
                torch.zeros(8, 8))
    if case == "nan-relu":      # a NaN row stays NaN, negatives go to 0
        ta = ta.clone()
        ta[3, 7] = float("nan")
        want = torch.relu(TG.gemm(ta, tb, cfg))
        assert torch.isnan(want[3]).all() and (want >= 0).sum() > 0
        return ta, tb, cfg, dict(relu=True), want
    assert case == "split-k"
    # bf16 C from 4 K slices: the slices' fp32 sum, then the epilogue,
    # then one rounding (not a rounding before the epilogue)
    a, b = _operands(64, 512, 64, seed=13)
    ta, tb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    cfg = TG.GemmConfig(64, 64, 128)
    assert TG.legalize(cfg, 64, 64, 512, torch.bfloat16).split_k > 1
    bias = torch.randn(64, generator=gen).bfloat16()
    res = torch.randn(64, 64, generator=gen).bfloat16()
    f32 = TG.gemm(ta, tb, cfg, out_dtype=torch.float32)
    return (ta, tb, cfg, dict(bias=bias, residual=res, relu=True),
            torch.relu((f32 + bias.float()) + res.float()).bfloat16())


@pytest.mark.parametrize("case", ["bias", "residual", "all", "add-order",
                                  "nan-relu", "split-k"])
def test_plain_epilogue(case):
    """The plain version's epilogue on each tile's fp32 total, before its
    one rounding: bias per column, residual per element, the two adds in
    that order, ReLU keeping NaN, split-K's slices summed first.  Bit for
    bit (NaN in the same places); no launch, so no epilogue launch."""
    a, b, cfg, epi, want = _epilogue_operands(case)
    before = TG.gemm.launches, TG.gemm.epilogue_launches
    got = TG.gemm(a, b, cfg, **epi)
    assert (TG.gemm.launches, TG.gemm.epilogue_launches) == before
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    geom = TG.RunGeometry(**TG.gemm.last_geometry["run"])
    assert torch.equal(TG.gemm_plain(a, b, geom, **epi).nan_to_num(),
                       want.nan_to_num())


@pytest.mark.parametrize("case", [
    "bias-length", "bias-2d", "bias-dtype", "bias-device", "residual-shape",
    "residual-dtype", "residual-device", "residual-not-contiguous",
    "bias-not-contiguous"])
def test_wrapper_rejects_a_wrong_epilogue(case):
    """The wrapper raises on a bias or residual the kernel does not take:
    bias (N,), residual (M, N), both contiguous, of C's dtype (bf16 for a
    bf16 product unless ``out_dtype`` says otherwise) on C's device."""
    a, b = torch.ones(6, 5), torch.ones(5, 4)
    bias, res = torch.ones(4), torch.ones(6, 4)
    kw, err = {
        "bias-length": (dict(bias=torch.ones(5)), ValueError),
        "bias-2d": (dict(bias=torch.ones(1, 4)), ValueError),
        "bias-dtype": (dict(bias=bias.bfloat16()), TypeError),
        "bias-device": (dict(bias=torch.ones(4, device="meta")), ValueError),
        "residual-shape": (dict(residual=torch.ones(4, 6)), ValueError),
        "residual-dtype": (dict(residual=res.double()), TypeError),
        "residual-device": (dict(residual=torch.ones(6, 4, device="meta")),
                            ValueError),
        "residual-not-contiguous": (
            dict(residual=torch.ones(4, 6).t()), ValueError),
        "bias-not-contiguous": (dict(bias=torch.ones(8)[::2]), ValueError),
    }[case]
    with pytest.raises(err):
        TG.gemm(a, b, **kw)
    # the same epilogue is C's: right for an fp32 C, wrong for a bf16 one
    TG.gemm(a, b, bias=bias, residual=res)
    with pytest.raises(TypeError):
        TG.gemm(a.bfloat16(), b.bfloat16(), bias=bias)
    TG.gemm(a.bfloat16(), b.bfloat16(), out_dtype=torch.float32, bias=bias)
