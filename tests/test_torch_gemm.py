"""Port parity for the GEMM: the plain version of the Hopper kernel against
the reference Pallas kernel (interpret mode), the knob mapping, the
legalizer and the wrapper's checks.  The kernel itself is tested on the
card by tests/test_torch_gpu.py."""
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
    onto a compiled template, no tile above what the problem needs, and
    every template fits the kernel's static shared-memory limit."""
    for bm in TG.BM_TEMPLATES:
        for bn in TG.BN_TEMPLATES:
            for bk in TG.BK_TEMPLATES:
                assert TG.RunGeometry(bm, bn, bk).smem_bytes <= TG.SMEM_LIMIT
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
                            seen.add((g.bm, g.bn, g.bk))
    # tuning really moves the run geometry: all four M tiles occur
    assert {g[0] for g in seen} == set(TG.BM_TEMPLATES)


def test_legalize_rule():
    g = TG.legalize(TG.GemmConfig(4096, 512, 4608), 392, 512, 4608)
    assert (g.bm, g.bn, g.bk) == (128, 128, 32)
    g = TG.legalize(TG.GemmConfig(8, 128, 128), 100352, 64, 147)
    assert (g.bm, g.bn, g.bk) == (16, 64, 32)
    g = TG.legalize(TG.GemmConfig(48, 128, 128), 1, 33, 8)
    assert (g.bm, g.bn, g.bk) == (16, 32, 16)
    g = TG.legalize(TG.GemmConfig(100, 96, 20), 1000, 1000, 1000)
    assert (g.bm, g.bn, g.bk) == (64, 64, 16)


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
        "run": {"bm": 16, "bn": 32, "bk": 16}}
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
