"""The port on the card: the Hopper GEMM, RMSNorm and flash-attention
kernels against their plain versions with their launch counters, at the
reference's test shapes and at every layout and template the LM paths of
``chip_smoke.py`` run, the tune -> deploy path, the LM's prefill and
decode launch counts on CUDA tensors, and training on the card (the
RMSNorm Function's backward, a training step's launch counts, the
embedding's NaN fill).  Every test here carries the ``gpu`` marker and
skips where torch sees no CUDA device.  This file imports neither jax
nor the reference package, so it also runs on a GPU machine that has
only the port's dependencies:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import pytest
import torch

from _lm_workloads import (fp32_gate_calls, lm_flash_geometries,
                           lm_rmsnorm_layouts, served_flash_cases,
                           served_norm_shapes)
from _torch_support import require_cuda
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import gemm as TG
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as TR

# (M, K, N): the reference's shapes, then ResNet-18's split-K shapes (conv8b,
# conv6b, conv4a) and misaligned strides (conv1's K 147; K 129 with N 33)
SHAPES = [(8, 8, 8), (100, 70, 90), (128, 128, 128), (1, 256, 33),
          (257, 129, 65), (392, 4608, 512), (1568, 2304, 256),
          (6272, 576, 128), (300, 147, 64), (77, 129, 33)]
CONFIGS = [(32, 32, 32, True, True), (128, 128, 128, True, True),
           (16, 64, 128, False, True), (8, 128, 256, True, False)]
# ResNet-18's 8 conv GEMMs at batch 8, conv1 to conv8b
RESNET18_B8 = [(100352, 147, 64), (25088, 576, 64), (6272, 576, 128),
               (6272, 1152, 128), (1568, 1152, 256), (1568, 2304, 256),
               (392, 2304, 512), (392, 4608, 512)]
# ((M, K, N), GemmConfig args): every shape under every config; ResNet-18
# at batch 8 under each BM template, which spans the run geometries its
# tuning can ask for there (the knobs round block_n and block_k up to
# 128 or more, past every BN and BK template, so tile_m alone picks the
# run tile); tuned tiles at conv1's K 147 and at K 129 and 1029 with N 33
PAIRS = ([(mkn, cfg) for mkn in SHAPES for cfg in CONFIGS]
         + [(mkn, (bm,)) for mkn in RESNET18_B8 for bm in TG.BM_TEMPLATES]
         + [((1568, 147, 64), (128, 64, 128)), ((257, 129, 33), (64, 32, 32)),
            ((257, 1029, 33), (64, 32, 32))])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 1e-2)], ids=str)
def test_kernel_matches_plain_on_card(dtype, tol):
    """Every call counts once, split-K or not; the kernel agrees with its
    plain version (the same slices, summed in the same order) to ``tol`` x
    max |plain| (two fp32 sums in different orders; in bf16 both round the
    fp32 sum once)."""
    require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (m, k, n), cfg in PAIRS:
        a = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
        b = torch.randn(k, n, generator=gen, device="cuda").to(dtype)
        launches = TG.gemm.launches
        got = TG.gemm(a, b, TG.GemmConfig(*cfg))
        assert TG.gemm.launches == launches + 1
        assert got.dtype == dtype and got.shape == (m, n)
        want = TG.gemm(a, b, TG.GemmConfig(*cfg), use_kernel=False)
        assert TG.gemm.launches == launches + 1
        torch.cuda.synchronize()
        assert _rel_err(got, want) <= tol, ((m, k, n), cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("src,dst,tol", [
    (torch.float32, torch.bfloat16, 1e-2),
    (torch.bfloat16, torch.float32, 5e-5)], ids=str)
def test_kernel_out_dtype_matches_plain_on_card(src, dst, tol):
    """``out_dtype`` both ways: an fp32 product written in bf16 (through
    the workspace and the summing kernel, split-K or not) and a bf16
    product written in fp32; one count a call."""
    require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(2)
    for (m, k, n), cfg in PAIRS:
        a = torch.randn(m, k, generator=gen, device="cuda").to(src)
        b = torch.randn(k, n, generator=gen, device="cuda").to(src)
        launches = TG.gemm.launches
        got = TG.gemm(a, b, TG.GemmConfig(*cfg), out_dtype=dst)
        assert TG.gemm.launches == launches + 1
        assert got.dtype == dst and got.shape == (m, n)
        want = TG.gemm(a, b, TG.GemmConfig(*cfg), out_dtype=dst,
                       use_kernel=False)
        torch.cuda.synchronize()
        assert _rel_err(got, want) <= tol, ((m, k, n), cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("src,dst", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)],
    ids=str)
def test_kernel_epilogue_equals_its_fp32_output_on_card(src, dst):
    """The output epilogue in every store of C: both kernels' tile stores
    (fp32 and bf16 C, 16-byte and scalar copies) and the summing kernel's
    (split-K, fp32 -> bf16; one and four sums a thread, N % 4 != 0 among
    them).  Bias, bias + ReLU and bias + residual + ReLU give, bit for
    bit, the kernel's fp32 output of the same geometry with the plain
    epilogue applied and rounded once to C's dtype; one launch and one
    epilogue launch a call.  A NaN in A stays NaN through the ReLU."""
    require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    for (m, k, n), cfg in PAIRS:
        a = torch.randn(m, k, generator=gen, device="cuda").to(src)
        b = torch.randn(k, n, generator=gen, device="cuda").to(src)
        bias = torch.randn(n, generator=gen, device="cuda").to(dst)
        res = torch.randn(m, n, generator=gen, device="cuda").to(dst)
        config = TG.GemmConfig(*cfg)
        f32 = TG.gemm(a, b, config, out_dtype=torch.float32)
        for kw in (dict(bias=bias), dict(bias=bias, relu=True),
                   dict(bias=bias, residual=res, relu=True)):
            launches, fused = TG.gemm.launches, TG.gemm.epilogue_launches
            got = TG.gemm(a, b, config, out_dtype=dst, **kw)
            assert TG.gemm.launches == launches + 1
            assert TG.gemm.epilogue_launches == fused + 1
            v = f32 + bias.float()
            if "residual" in kw:
                v = v + res.float()
            want = (torch.relu(v) if kw.get("relu") else v).to(dst)
            torch.cuda.synchronize()
            assert torch.equal(got, want), ((m, k, n), cfg, sorted(kw))
    a = torch.randn(64, 64, generator=gen, device="cuda").to(src)
    a[5, 9] = float("nan")
    got = TG.gemm(a, torch.randn(64, 40, generator=gen, device="cuda").to(src),
                  out_dtype=dst, relu=True)
    torch.cuda.synchronize()
    assert bool(got[5].isnan().all()) and not bool(got[:5].isnan().any())
    assert bool((got[:5] >= 0).all()) and bool((got[:5] == 0).any())


# bf16 on the tensor-core kernel: the 8 ResNet-18 shapes at batch 8 under
# GemmConfig() (split-K 4-16 on the deep ones; conv1's K 147, the scalar
# copies), bert-gemm's GEMMs (proj and pool, ffn_up, ffn_down), then
# split-K with a short last slice, K % 8 != 0 and N % 8 != 0 under
# split-K, and a tile of one row
BF16_CASES = [(mkn, (128, 128, 128)) for mkn in RESNET18_B8] + [
              ((128, 768, 768), (128, 128, 128)),
              ((128, 768, 3072), (128, 128, 128)),
              ((128, 3072, 768), (128, 128, 128)),
              ((100, 600, 70), (128, 128, 128)),
              ((257, 1029, 40), (64, 32, 64)),
              ((300, 2052, 36), (32, 64, 64)),
              ((1, 512, 33), (16, 32, 32))]


@pytest.mark.gpu
@pytest.mark.parametrize("mkn,cfg", BF16_CASES, ids=str)
def test_bf16_kernel_matches_plain_on_card(mkn, cfg):
    """The bf16 kernel (mma.sync, a cp.async ring, split-K) against its
    plain version on the same bf16 operands, bf16 and fp32 C: both sum
    exact bf16 products in fp32 over the same slices and round once, so
    1e-2 of max |plain| (the bf16 step, 2^-8, with room for the sums'
    orders); one count a call, the summing kernel included."""
    require_cuda()
    m, k, n = mkn
    gen = torch.Generator(device="cuda").manual_seed(m + k + n)
    a = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
    b = torch.randn(k, n, generator=gen, device="cuda").bfloat16()
    config = TG.GemmConfig(*cfg)
    geom = TG.legalize(config, m, n, k, torch.bfloat16)
    for out_dtype in (torch.bfloat16, torch.float32):
        launches = TG.gemm.launches
        got = TG.gemm(a, b, config, out_dtype=out_dtype)
        assert TG.gemm.launches == launches + 1
        assert TG.gemm.last_geometry["run"] == dataclasses.asdict(geom)
        want = TG.gemm(a, b, config, out_dtype=out_dtype, use_kernel=False)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and got.shape == (m, n)
        assert _rel_err(got, want) <= 1e-2
    if mkn in ((392, 4608, 512), (100, 600, 70), (257, 1029, 40)):
        assert geom.split_k > 1
    if k % 8 or n % 8:
        assert not geom.vec


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take():
    require_cuda()
    a = torch.ones(64, 32, device="cuda")
    with pytest.raises(ValueError):
        TG.gemm(a.t(), a)  # non-contiguous
    with pytest.raises(ValueError):
        TG.gemm(a, torch.ones(32, 8))  # operands on two devices


@pytest.mark.gpu
def test_tune_then_deploy_on_card():
    """Two ResNet-18 tasks tuned on the card; their geometries deploy in a
    conv through the kernel, within 1e-4 of cuDNN fp32."""
    require_cuda()
    from repro_torch.compiler.session import Session
    from repro_torch.compiler.task import TuningTask
    from repro_torch.core.tuner import TunerConfig
    from repro_torch.kernels import ref
    tasks = TuningTask.conv_tasks("resnet-18", batch=2)[:2]
    rep = Session(tasks, tuner=TunerConfig.fast(), budget=24).run()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for task in tasks:
        wl, k = task.space.workload, rep[task.name].best_settings
        x = torch.randn((2, 32, 32, wl["ci"]), generator=gen, device="cuda")
        w = torch.randn((wl["kh"], wl["kw"], wl["ci"], wl["co"]),
                        generator=gen, device="cuda")
        launches = TG.gemm.launches
        out = ops.conv2d_from_knobs(
            x, w, wl["stride"], wl["pad"], tile_b=k["tile_b"],
            tile_h=k["tile_h"], tile_w=k["tile_w"], tile_ci=k["tile_ci"],
            tile_co=k["tile_co"], h_threading=k["h_threading"],
            oc_threading=k["oc_threading"])
        assert TG.gemm.launches == launches + 1
        want = ref.conv2d_ref(x, w, wl["stride"], wl["pad"])
        torch.cuda.synchronize()
        err = (out - want).abs().max()
        assert float(err) <= 1e-4 * float(want.abs().max())


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 1e-2)], ids=str)
def test_rmsnorm_kernel_matches_plain_on_card(dtype, tol):
    """The reference's test shapes, the LM's (prompt, 1536) at prompts of
    200, 384, 1000 and 1024 rows, (8, 1536) and (1, 1536), 4096 rows, the
    grid-stride loop of one-warp rows four to a block (9000, 128) and of
    wider rows (5000, 4096), the widest row, and a contiguous x whose
    data_ptr is not 16-byte aligned (the scalar template); fp32 and bf16
    weights.  At d 1536 a row spreads over 8 warps (fp32) or 6 (bf16) up
    to SPREAD_ROWS rows, and takes 2 warps (fp32) or one (bf16) past them.
    Then each layout the LM paths run (``lm_rmsnorm_layouts``) at its
    fewest and its most rows (``served_norm_shapes``)."""
    require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    ran = set()
    for shape in [(4, 64), (2, 100, 96), (1, 7, 33), (129, 256),
                  (200, 1536), (384, 1536), (1000, 1536), (1024, 1536),
                  (8, 1536), (1, 1536), (4096, 1536), (9000, 128),
                  (5000, 4096), (3, TR.MAX_D), (5, 1536, "misaligned"),
                  (3, TR.MAX_D, "misaligned")] + served_norm_shapes(dtype):
        misaligned = shape[-1] == "misaligned"
        if misaligned:
            rows, d = shape[:2]
            buf = torch.randn(rows * d + 1, generator=gen, device="cuda")
            x = buf.to(dtype)[1:].view(rows, d)
            assert x.is_contiguous() and x.data_ptr() % 16
        else:
            d = shape[-1]
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        for w_dtype in (torch.float32, dtype):
            w = torch.randn(d, generator=gen, device="cuda").to(w_dtype)
            launches = TR.rmsnorm.launches
            got = TR.rmsnorm(x, w)
            assert TR.rmsnorm.launches == launches + 1
            run = TR.rmsnorm.last_geometry["run"]
            assert run["vec"] == (not misaligned
                                  and d % TR.vector_width(dtype) == 0)
            rows = x.numel() // d
            if d == 1536 and not misaligned:
                spread = rows <= TR.SPREAD_ROWS
                assert run["threads"] == 32 * {
                    (True, torch.float32): 8, (True, torch.bfloat16): 6,
                    (False, torch.float32): 2,
                    (False, torch.bfloat16): 1}[spread, dtype]
            if d in (128, 4096):
                assert run["rows_per_block"] == (4 if d == 128 else 1)
                assert run["grid"] * run["rows_per_block"] < rows
            ran.add((d, run["vec"], run["threads"] // 32, run["slots"],
                     run["rows_per_block"]))
            want = TR.rmsnorm(x, w, use_kernel=False)
            assert TR.rmsnorm.launches == launches + 1
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == x.shape
            assert _rel_err(got, want) <= tol, (shape, w_dtype, run)
    served = {(d, *layout) for d, dt, *layout
              in lm_rmsnorm_layouts() if dt == dtype}
    assert served <= ran, served - ran


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 1e-2)], ids=str)
def test_flash_kernel_matches_plain_on_card(dtype, tol):
    """The reference's test cases (GQA, causal / full / window 32, mixed
    blocks and tails), the LM's prefill shape, the bf16 tensor-core
    kernel's head_dim templates, windows and ragged tails, every fp32
    template legalize can pick, q, k and v one value off 16 bytes or
    with D % 4 != 0 (the 4-byte / scalar copies), fp32 grids with and
    without the KV split (the split's two kernels count as one launch),
    and a causal window of 4,096 over 4,608 tokens at head_dim 128; then
    each model's prefills at the shortest and the longest S of each
    template the LM paths run (``served_flash_cases`` of
    ``lm_flash_geometries``) and, in fp32, every shape the fp32 gates
    launch (``fp32_gate_calls``).  Each call launches once and agrees with
    the plain version, which walks the same geometry, to ``tol`` x max
    |plain|; in bf16 it is also within 2^-7 x max |v| of the plain version
    with P kept in fp32 (the reference kernel's arithmetic): P rounded to
    bf16 moves a row by at most 2^-8 max |v|, and so does rounding the
    output."""
    require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [(2, 100, hq, hkv, 16, causal, window, 32, 32)
             for hq, hkv in ((4, 4), (4, 2), (6, 1))
             for causal, window in ((True, None), (False, None), (True, 32))]
    cases += [(1, s, 2, 2, 8, causal, None, bq, bk)
              for s, bq, bk, causal in ((3, 16, 16, True), (37, 16, 64, True),
                                        (37, 16, 64, False),
                                        (70, 32, 16, True))]
    cases += [(1, 1000, 12, 2, 128, True, None, 128, 128)]
    # every head_dim template with GQA, window 32 and ragged S; D 20 takes
    # the scalar copies (D % 8 != 0)
    cases += [(2, 77, 6, 2, d, True, 32, 64, 64) for d in (8, 16, 64, 128)]
    cases += [(1, 150, 12, 2, 128, False, None, 128, 128),
              (2, 130, 4, 1, 64, True, None, 32, 64),
              (1, 50, 2, 1, 20, True, None, 64, 64)]
    # every fp32 template, requested as itself (D 4 short of its dp)
    templates = sorted(TF.f32_templates())
    cases += [(1, 70, 4, 2, dp - 4, (bq + bk) % 3 != 0, None, bq, bk)
              for bq, bk, dp in templates]
    # D % 4 != 0 (D 6, 18), then q, k and v one value into their storage
    cases += [(2, 77, 6, 2, 6, True, 32, 64, 64),
              (1, 90, 4, 2, 18, False, None, 32, 32),
              (1, 130, 12, 2, 128, True, None, 128, 128, 1),
              (2, 77, 6, 2, 64, True, 32, 64, 64, 1)]
    # fp32's KV split: qwen2's gate shape and a window (split), and a grid
    # over a wave (not split)
    cases += [(1, 973, 12, 2, 128, True, None, 128, 128),
              (1, 1000, 4, 2, 64, True, 100, 128, 128),
              (2, 600, 16, 4, 64, True, None, 128, 128)]
    # past mixtral's 4,096-token window at its head_dim: whole KV tiles
    # below the band are skipped (fp32 unsplit at 6 heads, split at 2)
    cases += [(1, 4608, 6, 1, 128, True, 4096, 128, 128),
              (1, 4608, 2, 1, 128, True, 4096, 128, 128)]
    name = str(dtype).removeprefix("torch.")
    cases += served_flash_cases(name)
    if dtype == torch.float32:
        cases += [(b, s, hq, hkv, d, causal, window, bq, bk)
                  for (b, s, hq, d), hkv, causal, window, bq, bk
                  in sorted(fp32_gate_calls())]
    ran, split = set(), set()
    for b, s, hq, hkv, d, causal, window, bq, bk, *offset in cases:
        def draw(h):
            n = b * s * h * d + (offset[0] if offset else 0)
            x = torch.randn(n, generator=gen, device="cuda").to(dtype)
            return x[n - b * s * h * d:].view(b, s, h, d)
        q, k, v = draw(hq), draw(hkv), draw(hkv)
        assert TF.vec_copies(q, k, v) == (not offset and d % (
            16 // q.element_size()) == 0)
        launches = TF.flash_attention.launches
        got = TF.flash_attention(q, k, v, causal, window, None, bq, bk)
        assert TF.flash_attention.launches == launches + 1
        run = TF.flash_attention.last_geometry["run"]
        ran.add((run["bq"], run["bk"], run["dp"]))
        split.add(run["kv_chunk"] > 0)
        want = TF.flash_attention(q, k, v, causal, window, None, bq, bk,
                                  use_kernel=False)
        assert TF.flash_attention.launches == launches + 1
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape
        assert _rel_err(got, want) <= tol, (b, s, hq, hkv, d, causal, window,
                                            offset, run)
        if dtype == torch.bfloat16:
            exact = TF.flash_attention_plain(
                q.float(), k.float(), v.float(), causal, window, d ** -0.5,
                TF.RunGeometry(**run))
            gap = float((got.float() - exact).abs().max())
            assert gap <= 2 ** -7 * float(v.float().abs().max()), (
                b, s, hq, hkv, d, causal, window, offset)
    if dtype == torch.float32:
        assert ran >= set(templates) and split == {True, False}
    served = {(bq, bk, dp) for bq, bk, dp, dt
              in lm_flash_geometries() if dt == name}
    assert served <= ran, served - ran


@pytest.mark.gpu
def test_lm_kernels_reject_what_they_do_not_take():
    require_cuda()
    x = torch.ones(8, 64, device="cuda")
    with pytest.raises(ValueError):
        TR.rmsnorm(x.t(), torch.ones(8, device="cuda"))   # non-contiguous
    q = torch.ones(1, 8, 2, 16, device="cuda")
    with pytest.raises(ValueError):
        TF.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                           q.transpose(1, 2))
    with pytest.raises(ValueError):
        TF.flash_attention(q, q.cpu(), q)                  # two devices


@pytest.mark.gpu
def test_lm_prefill_and_decode_launch_counts_on_card():
    """Reduced qwen2-1.5b in fp32 on the card: a prefill launches the flash
    kernel once an attention layer and RMSNorm 2 n_layers + 1 times, a
    decode step RMSNorm 2 n_layers + 1 times and flash never; the kernel
    path is within 1e-4 of max |logit| of the plain path."""
    require_cuda()
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    cfg = get_config("qwen2-1.5b", reduced=True).with_(
        dtype=torch.float32, param_dtype=torch.float32)
    params = TT.init_params(0, cfg)
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (2, 20), generator=gen, device="cuda")
    norms = 2 * cfg.n_layers + 1
    f0, r0 = TF.flash_attention.launches, TR.rmsnorm.launches
    logits, cache = TT.prefill(params, {"tokens": toks[:, :12]}, cfg, 32)
    assert TF.flash_attention.launches - f0 == cfg.n_layers
    assert TR.rmsnorm.launches - r0 == norms
    plain, pcache = TT.prefill(params, {"tokens": toks[:, :12]}, cfg, 32,
                               use_kernel=False)
    assert _rel_err(logits, plain) <= 1e-4
    for i in range(12, 20):
        f0, r0 = TF.flash_attention.launches, TR.rmsnorm.launches
        logits, cache = TT.decode_step(params, cache, toks[:, i:i + 1], cfg)
        assert TF.flash_attention.launches == f0
        assert TR.rmsnorm.launches - r0 == norms
        plain, pcache = TT.decode_step(params, pcache, toks[:, i:i + 1], cfg,
                                       use_kernel=False)
        assert _rel_err(logits, plain) <= 1e-4


def counting_steps(srv):
    """Wrap ``srv.step`` to count prefills (requests admitted) and decode
    steps (steps that ran the batch); returns the live counter dict."""
    counts = {"prefills": 0, "decodes": 0}
    step = srv.step

    def counted():
        queued = len(srv.queue)
        finished = step()
        counts["prefills"] += queued - len(srv.queue)
        counts["decodes"] += int(len(srv.active) + len(finished) > 0)
        return finished

    srv.step = counted
    return counts


@pytest.mark.gpu
def test_live_serve_tune_on_card_launch_counts():
    """Reduced qwen2-1.5b in fp32 on the card served to timed arrivals
    while an online tuning session measures in its idle slots: every
    request served, every measurement in an idle window, and the kernels
    launched exactly as the serving work needs (the measurements are host
    numpy and launch neither kernel)."""
    require_cuda()
    from repro_torch.compiler.serve_tune import (LiveServeHost, ServeSLA,
                                                 TraceConfig,
                                                 tune_while_serving)
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.train.server import Server
    cfg = get_config("qwen2-1.5b", reduced=True).with_(
        dtype=torch.float32, param_dtype=torch.float32)
    srv = Server(TT.init_params(0, cfg), cfg, n_slots=4, max_len=64)
    counts = counting_steps(srv)
    host = LiveServeHost(
        srv, TraceConfig(n_requests=8, rate_per_s=20.0, prompt_len=(4, 16),
                         max_new=(2, 8), seed=2),
        sla=ServeSLA(target_s=60.0), vocab=cfg.vocab, seed=0)
    f0, r0 = TF.flash_attention.launches, TR.rmsnorm.launches
    rep = tune_while_serving(host, budget=4, offline_compare=False)
    s = rep.serve
    assert s["served"] == 8 and s["rejected"] == 0 and s["abandoned"] == 0
    assert s["measurements"] == 8 and s["idle_windows"] == 8
    assert counts["prefills"] == 8
    assert TF.flash_attention.launches - f0 == cfg.n_layers * 8
    assert TR.rmsnorm.launches - r0 == (2 * cfg.n_layers + 1) * (
        counts["prefills"] + counts["decodes"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 1e-2)], ids=str)
def test_rmsnorm_backward_matches_plain_on_card(dtype, tol):
    """The RMSNorm Function on CUDA: its forward is the kernel (one launch,
    counted) and within ``tol`` of max |out| of ``rmsnorm_plain`` on the
    same inputs, its (dx, dw) within ``tol`` of max |grad| of autograd
    through ``rmsnorm_plain`` on the fp32 values of the same inputs, at
    qwen2-1.5b's training shapes (2048 and 8192 rows), a serve shape, and
    the MoE and recurrent families' training steps at d 2048 (in bf16,
    autograd through the bf16 plain version would sum its 128-row tiles'
    dw in bf16)."""
    require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    for shape in ((2048, 1536), (8192, 1536), (8, 1536), (3, 5, 96),
                  (4096, 2048), (1024, 2048)):
        x0 = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        w0 = torch.randn(shape[-1], generator=gen, device="cuda").to(dtype)
        g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        launches = TR.rmsnorm.launches
        out = TR.rmsnorm(x, w)
        assert TR.rmsnorm.launches == launches + 1
        assert out.dtype == dtype
        assert _rel_err(out.detach(), TR.rmsnorm_plain(x0, w0)) <= tol, shape
        dx, dw = torch.autograd.grad(out, (x, w), g)
        x2, w2 = (t.float().clone().requires_grad_(True)
                  for t in (x0, w0))
        px, pw = torch.autograd.grad(TR.rmsnorm_plain(x2, w2), (x2, w2),
                                     g.float())
        assert TR.rmsnorm.launches == launches + 1
        torch.cuda.synchronize()
        assert dx.dtype == dw.dtype == dtype
        assert _rel_err(dx, px) <= tol and _rel_err(dw, pw) <= tol, shape


@pytest.mark.gpu
def test_reduced_training_step_launch_counts_on_card():
    """One ``train_step_fn`` step of reduced qwen2-1.5b (bf16, remat) on
    the card: RMSNorm launches 2 n_layers + 1 in the forward and 2
    n_layers again in the backward's recompute, flash and GEMM never; the
    metrics are finite and the parameters moved."""
    require_cuda()
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import transformer as TT
    from repro_torch.train import steps as TS
    cfg = get_config("qwen2-1.5b", reduced=True)
    params = TT.init_params(0, cfg)
    tc = TS.TrainConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    opt = TS.make_optimizer(tc, params)
    step = TS.train_step_fn(cfg, tc)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                   global_batch=2)).batch_at(0)
    before = params["embed"].detach().clone()
    r0, f0, g0 = (TR.rmsnorm.launches, TF.flash_attention.launches,
                  TG.gemm.launches)
    metrics = step(params, opt, batch)
    assert TR.rmsnorm.launches - r0 == 4 * cfg.n_layers + 1
    assert TF.flash_attention.launches == f0 and TG.gemm.launches == g0
    assert all(bool(torch.isfinite(metrics[k])) for k in
               ("loss", "grad_norm"))
    assert not torch.equal(before, params["embed"].detach())


@pytest.mark.gpu
def test_embedding_fill_on_card():
    """Out-of-range token ids give NaN rows on CUDA, with no device-side
    assert: the context stays usable after."""
    require_cuda()
    from repro_torch.models import transformer as TT
    table = torch.randn(6, 4, device="cuda")
    ids = torch.tensor([[0, 5, -1, -7, 6, -(2 ** 31) + 7]], device="cuda",
                       dtype=torch.int32)
    got = TT.embed(table, ids, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got[0]).all(dim=-1).cpu(),
                       torch.tensor([False, False, False, True, True, True]))
    assert torch.equal(got[0, 2], table[5])
    assert bool(torch.isfinite((table * 2).sum()).cpu())  # context usable
