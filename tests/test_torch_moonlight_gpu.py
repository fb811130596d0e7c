"""Moonlight-16B-A3B's new paths on the card: the flash kernel's bf16
dp=192 template on MLA's prefill shapes against attention in fp32
(values zero-padded from 128), the grouped MoE (``torch._grouped_mm``)
against every expert on every token, the absorbed decode against the
expanded form, the MLA decode kernel against its plain version (and
its refusal of CUDA operands it is not built for), and one
MLA + MoE layer and layer 0 at published widths served through
``Server`` against the plain float32 reference
(``dcoc_bench/reference/deepseek_v3.py``).  Every test carries the
``gpu`` marker and skips where torch sees no CUDA device.  No JAX:

    python -m pytest -q -m gpu tests/test_torch_moonlight_gpu.py
"""
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_support import require_cuda
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as TF
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.train.server import Request, Server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _two_layers(dtype=torch.bfloat16):
    """Layer 0 (dense) and one MLA + MoE layer at published widths, the
    whole vocabulary."""
    return get_config("moonlight-16b-a3b").with_(
        n_layers=2, dtype=dtype, param_dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [100, 4096])
def test_flash_dp192_matches_attention_on_card(s):
    """bf16 q, k (B, S, 16, 192) and v (B, S, 16, 128) zero-padded to
    192: the kernel's first 128 columns against causal softmax attention
    in fp32 on the same bf16 inputs (P and the output rounded to bf16 in
    the kernel: 1e-2 of max), its last 64 zero."""
    require_cuda()
    g = torch.Generator(device="cuda").manual_seed(s)
    q, k = (torch.randn((1, s, 16, 192), generator=g, device="cuda")
            .bfloat16() for _ in range(2))
    v = torch.randn((1, s, 16, 128), generator=g, device="cuda").bfloat16()
    launches = TF.flash_attention.launches
    got = TF.flash_attention(q, k, F.pad(v, (0, 64)))
    torch.cuda.synchronize()
    assert TF.flash_attention.launches == launches + 1
    assert TF.flash_attention.last_geometry["run"]["dp"] == 192
    want = F.scaled_dot_product_attention(
        q.float().transpose(1, 2), k.float().transpose(1, 2),
        v.float().transpose(1, 2), is_causal=True).transpose(1, 2)
    assert _rel(got[..., :128], want) < 1e-2
    assert got[..., 128:].abs().max() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("tokens", [64, 3000])
def test_grouped_moe_matches_dense_on_card(tokens):
    """The published MoE layer, bf16: ``grouped`` (``torch._grouped_mm``)
    against every expert on every token weighted by the same routing."""
    require_cuda()
    cfg = _two_layers()
    params = T.init_params(1, cfg, device="cuda")
    p = params["layers"][1]["ffn"]
    x = torch.randn((1, tokens, cfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2)
                    ).bfloat16()
    got, _ = MOE.moe_block(x, p, cfg)
    if tokens > 1000:   # dense: every expert on every token, in slices
        want = torch.cat([MOE.moe_block(x[:, i:i + 500], p, cfg.with_(
            moe_impl="dense"))[0] for i in range(0, tokens, 500)], 1)
    else:
        want, _ = MOE.moe_block(x, p, cfg.with_(moe_impl="dense"))
    assert _rel(got - x, want - x) < 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)], ids=str)
def test_absorbed_decode_matches_expanded_on_card(dtype, tol):
    """Published widths: a decode step (absorbed, on the latent cache)
    against the prefill of the same tokens (expanded; fp32 on the plain
    attention, as the fp32 flash kernel stops at head_dim 128)."""
    require_cuda()
    cfg = _two_layers(dtype)
    params = T.init_params(3, cfg, device="cuda")
    plain = dtype == torch.float32
    toks = torch.randint(0, cfg.vocab, (2, 300), device="cuda",
                         generator=torch.Generator(device="cuda"
                                                   ).manual_seed(4))
    _, cache = T.prefill(params, {"tokens": toks[:, :-1]}, cfg, 512,
                         use_kernel=not plain)
    got, _ = T.decode_step(params, cache, toks[:, -1:], cfg,
                           use_kernel=not plain)
    want, _ = T.prefill(params, {"tokens": toks}, cfg, 512,
                        use_kernel=not plain)
    assert _rel(got, want) < tol


@pytest.mark.gpu
def test_layers_serve_against_reference_on_card():
    """Layer 0 and one MLA + MoE layer, bf16, published widths, served:
    two slots of 4,000 and 2,500 prompt tokens prefilled, then 8 decode
    steps; every step's logits against the float32 reference's full
    forward over prompt and outputs, the program's expert sets replayed.
    Prints the readings."""
    require_cuda()
    from dcoc_bench.reference import deepseek_v3 as REF
    from dcoc_bench.harness import BENCH_DIR, load_json
    hf = dict(load_json(BENCH_DIR, "configs", "moonlight-16b-a3b.json"),
              num_hidden_layers=2)
    cfg = _two_layers()
    params = T.init_params(5, cfg, device="cuda")
    server = Server(params, cfg, n_slots=2, max_len=8192)
    rng = np.random.default_rng(6)
    reqs = [server.submit(Request(uid=i, prompt=rng.integers(
        0, cfg.vocab, n).astype(np.int32), max_new_tokens=64))
            for i, n in enumerate((4000, 2500))]
    MOE.route_log = []
    try:
        steps, logits = [], []
        for _ in range(9):
            server.step()
            steps.append(list(MOE.route_log))
            MOE.route_log.clear()
            logits.append(server.last_logits.float().cpu())
    finally:
        MOE.route_log = None
    prefill, steps[0] = steps[0][:2], steps[0][2:]
    slot = {r.uid: s for s, r in server.active.items()}
    seqs, at, routes = [], [], []
    for r, req in enumerate(reqs):
        s = slot[r]
        seqs.append(torch.as_tensor(list(req.prompt) + req.output[:9]))
        at.append([len(req.prompt) + j for j in range(9)])
        routes.append([torch.cat([prefill[r]] + [steps[j][0][s:s + 1]
                                                 for j in range(9)])])
    with torch.no_grad():
        ref = REF.forward(hf, params, seqs, at, routes=routes)
    gaps = [_rel(logits[j][slot[r]], ref["logits"][r][j].cpu())
            for r in range(2) for j in range(9)]
    share = ref["route_mismatch"] / ref["route_tokens"]
    print(f"[moonlight layers] logit_gap max {max(gaps):.4e} "
          f"mean {np.mean(gaps):.4e}; route_gap {share:.4e} "
          f"({ref['route_mismatch']} of {ref['route_tokens']})")
    assert max(gaps) < 5e-2 and share < 0.1


@pytest.mark.gpu
@pytest.mark.parametrize("b,kv_len", [(64, 4610), (3, 40), (600, 100)])
def test_mla_decode_kernel_matches_plain_on_card(b, kv_len):
    """The MLA decode kernel (split over the cache where the batch leaves
    the card's blocks idle: 9 splits at 64 x 4,610; none at 600 x 100)
    against its plain version on the same bf16 inputs, sequences of
    lengths 1 to ``kv_len``: 1e-2 of max (P rounded against the running
    max in the kernel, the final one in the plain version)."""
    require_cuda()
    from repro_torch.kernels import mla_decode as MK
    g = torch.Generator(device="cuda").manual_seed(b)
    c = kv_len + 7
    q = torch.randn((b, 16, 576), generator=g, device="cuda").bfloat16()
    ckv = torch.randn((b, c, 512), generator=g, device="cuda").bfloat16()
    kpe = torch.randn((b, c, 64), generator=g, device="cuda").bfloat16()
    lens = torch.randint(1, kv_len + 1, (b,), generator=g, device="cuda",
                         dtype=torch.int32)
    lens[0], lens[-1] = kv_len, 1
    launches = MK.mla_attention.launches
    got = MK.mla_attention(q, ckv, kpe, lens, 192 ** -0.5, kv_len)
    torch.cuda.synchronize()
    assert MK.mla_attention.launches == launches + 1
    want = MK.mla_attention_plain(q, ckv, kpe, lens, 192 ** -0.5, kv_len)
    assert _rel(got, want) < 1e-2
    # a sequence of one position is its own row of ckv
    assert _rel(got[-1], ckv[-1, :1].expand(16, 512)) < 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("case,why", [("float32", "bfloat16"),
                                      ("widths", "built for"),
                                      ("strided", "contiguous")])
def test_mla_decode_kernel_refuses_what_it_cannot_take_on_card(case, why):
    """CUDA operands the kernel is not built for (fp32, other widths, a
    strided cache) raise and name why, launching nothing; with
    ``use_kernel=False`` the plain version runs them."""
    require_cuda()
    from repro_torch.kernels import mla_decode as MK
    b, c = 2, 40
    dt = torch.float32 if case == "float32" else torch.bfloat16
    r = 32 if case == "widths" else 512
    q = torch.randn((b, 16, r + 64), device="cuda", dtype=dt)
    ckv = torch.randn((b, 2 * c, r), device="cuda", dtype=dt)
    ckv = ckv[:, ::2] if case == "strided" else ckv[:, :c].contiguous()
    kpe = torch.randn((b, c, 64), device="cuda", dtype=dt)
    lens = torch.full((b,), c, dtype=torch.int32, device="cuda")
    launches = MK.mla_attention.launches
    with pytest.raises(ValueError, match=why):
        MK.mla_attention(q, ckv, kpe, lens, 0.1, c)
    assert MK.mla_attention.launches == launches
    got = MK.mla_attention(q, ckv, kpe, lens, 0.1, c, use_kernel=False)
    assert got.shape == (b, 16, r) and bool(torch.isfinite(got).all())
