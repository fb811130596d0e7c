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
from repro_torch.kernels import gemm as TG

# the reference's test_kernels shapes and configs
GEMM_SHAPES = [(8, 8, 8), (100, 70, 90), (128, 128, 128), (1, 256, 33),
               (257, 129, 65)]
GEMM_CONFIGS = [(32, 32, 32, True, True), (128, 128, 128, True, True),
                (16, 64, 128, False, True), (8, 128, 256, True, False)]
# a block's static shared memory (the bf16 loop's tiles) is capped at 48 KB
STATIC_SMEM_LIMIT = 48 * 1024


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
    onto a compiled template, no tile above what the problem needs, its K
    slices cover K, every fp32 template (dynamic shared memory) fits the
    budget of two blocks an SM and every bf16 template (static shared
    memory) fits the 48 KB static limit."""
    for bm in TG.BM_TEMPLATES:
        for bn in TG.BN_TEMPLATES:
            for bk in TG.BK_TEMPLATES:
                assert TG.RunGeometry(bm, bn, bk).smem_bytes <= TG.SMEM_BUDGET
                assert (TG.RunGeometry(bm, bn, bk, dtype="bfloat16").smem_bytes
                        <= STATIC_SMEM_LIMIT)
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
                            g = TG.legalize(cfg, m, n, k)
                            assert g.bm in TG.BM_TEMPLATES
                            assert g.bn in TG.BN_TEMPLATES
                            assert g.bk in TG.BK_TEMPLATES
                            assert g.bm <= max(16, min(cfg.block_m, m))
                            assert g.bn <= max(32, min(cfg.block_n, n))
                            assert len(g.k_slices(k)) == g.split_k
                            seen.add((g.bm, g.bn, g.bk))
    # tuning really moves the run geometry: all four M tiles occur
    assert {g[0] for g in seen} == set(TG.BM_TEMPLATES)


def test_legalize_rule():
    g = TG.legalize(TG.GemmConfig(4096, 512, 4608), 392, 512, 4608)
    assert g == TG.RunGeometry(128, 128, 32, split_k=16, vec=True)
    g = TG.legalize(TG.GemmConfig(8, 128, 128), 100352, 64, 147)
    assert g == TG.RunGeometry(16, 64, 32, split_k=1, vec=False)
    g = TG.legalize(TG.GemmConfig(48, 128, 128), 1, 33, 8)
    assert g == TG.RunGeometry(16, 32, 16, split_k=1, vec=False)
    g = TG.legalize(TG.GemmConfig(100, 96, 20), 1000, 1000, 1000)
    assert g == TG.RunGeometry(64, 64, 16, split_k=1, vec=True)
    g = TG.legalize(TG.GemmConfig(4096, 512, 4608), 392, 512, 4608,
                    torch.bfloat16)   # the first port's loop: never cut
    assert g == TG.RunGeometry(128, 128, 32, split_k=1, vec=False,
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
    assert TG.split_k_for(TG.SM_COUNT, 1000) == 1
    assert TG.split_k_for(TG.SM_COUNT + 40, 1000) == 1
    assert TG.split_k_for(TG.SM_COUNT - 1, 1000) == 2
    assert TG.split_k_for(1, 7) == 1          # 7 steps: no 4-step slices
    for tiles in range(1, 200):
        for steps in (1, 3, 4, 8, 9, 36, 72, 100, 144, 1000):
            split = TG.split_k_for(tiles, steps)
            assert split >= 1
            if tiles >= TG.SM_COUNT:
                assert split == 1
            assert tiles * split <= max(tiles, TG.BLOCKS_PER_SM * TG.SM_COUNT)
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
    """16-byte copies need K % 4 == 0 (A's rows) and N % 4 == 0 (B's);
    conv1's K 147 and the reference's K 129 / N 33 take the scalar one."""
    assert TG.legalize(TG.GemmConfig(), 300, n, k).vec is vec
    assert TG.legalize(TG.GemmConfig(), 300, n, k, torch.bfloat16).vec is False


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
