"""Plain float32 causal forward of a Kimi Linear stack, one chip's expert
share: the reference of the ``kimilinear`` cells
(``kimi-linear-48b-a3b``).

Written from the published equations (Kimi Linear, arXiv:2510.26692
section 3, KDA; DeepSeek-V2, arXiv:2405.04434 section 2.1, MLA;
DeepSeek-V3, arXiv:2412.19437 section 2.1.2, sigmoid routing with a
correction bias) and the configuration's ``config.json`` keys, which
:func:`forward` reads as they are (``hidden_size``,
``linear_attn_config``, ``mla_use_nope``, ``num_experts``, ...):

* the mixer of 1-indexed layer i is MLA where i is in
  ``linear_attn_config.full_attn_layers``, else KDA;
* KDA, by its recurrence, a token at a time: q, k, v = SiLU of a causal
  depthwise conv (``short_conv_kernel_size`` taps, no bias, zeros before
  the sequence) of h W_q, h W_k, h W_v; q and k L2-normed per head (1e-6
  under the root); g = -exp(A_log) softplus(h W_fa W_fb + dt_bias), beta
  = sigmoid(h W_b); S = Diag(exp g) S, u = k^T S, S = S + beta k (v -
  u)^T, o = S^T q / sqrt(head_dim), from S = 0; then RMSNorm of o with
  the ``o_ln`` weight, times sigmoid(h W_ga W_gb), and W_o;
* MLA in the expanded form with no rotation at all (``mla_use_nope``):
  q = h W_q split into (nope | rope) per head; [c_kv | k_pe] = h W_kva,
  c_kv normed; [k_nope | v] = c_kv W_kvb; softmax((q_nope k_nope + q_pe
  k_pe) / sqrt(nope + rope)) v, causal; then W_o;
* layers below ``first_k_dense_replace`` a dense SwiGLU of
  ``intermediate_size``; the others the MoE: sigmoid scores of an fp32
  router over ``deployment.num_experts_published`` experts, the top
  ``num_experts_per_token`` of score + correction bias, their scores
  renormalised (+1e-20) times ``routed_scaling_factor``; of the chosen
  experts, those this chip holds (``num_experts`` from
  ``deployment.experts_held_from``) each a SwiGLU of
  ``moe_intermediate_size`` on its own tokens (no capacity, none
  dropped), plus the shared SwiGLU of ``num_shared_experts x
  moe_intermediate_size`` on every token;
* RMSNorm with ``rms_norm_eps`` before each mixer, before the FFN, on
  c_kv, on KDA's output, and at the end; the untied head.

Departures: the expert share (the routed sum holds only the held
experts' part, as the program computes it on this chip: what the other
seven chips would add is left out of both); the weights are drawn from a
seed, ``A_log`` and ``dt_bias`` as the published layer initialises them;
the NoPE MLA keeps its 64 rope columns, unrotated, as the published
model does.

No cache, no batching: one sequence at a time, every position.
:func:`forward` walks the layers in the outer loop and the sequences in
the inner one, so that it holds one layer's weights in float32 at a time.
Matrix products run in float32 with TF32 off.  ``quant`` rounds both
operands of every product (``"bf16"``; ``"fp8"``: float8 e4m3 under a
per-tensor scale), the recurrence's k^T S and S^T q among them, the sums
still in float32: the controls below the precision the configuration
states; at ``"fp8"`` the KDA state is rounded to bfloat16 after each
token, one below its float32.  The router runs in float32 whatever
``quant``.  ``routes`` replays a given routing (per sequence, per MoE
layer, the expert sets (S, k)); the reference's own choice is counted
against it.

Weights come as the program's tree (plain tensors): ``embed`` (V, D),
``final_ln``, ``lm_head`` (D, V), and a list ``layers`` of {"mix": MLA's
{ln, wq, wkv_a, kv_ln, wkv_b, wo} or KDA's {ln, wq, wk, wv, conv_q,
conv_k, conv_v (C, K), wf_a, wf_b, A_log (H,), dt_bias (C,), wb, wg_a,
wg_b, o_ln, wo}, "ffn": {ln, w_gate, w_up, w_down} (dense) or {ln,
router, bias, w_gate, w_up, w_down (held, ...), ws_gate, ws_up, ws_down}
(MoE)}, every weight (in, out).  It imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from dcoc_bench.reference.deepseek_v3 import QUERY_CHUNK, _f32, _Ops, rms

L2_EPS = 1e-6
# the KDA state between tokens one precision below the float32 the
# configuration states for it, where the products' operands are one below
# theirs: the control a precision down
STATE_BELOW = {"fp8": torch.bfloat16}


def mixers(cfg: dict) -> List[str]:
    """Each layer's mixer, from the configuration's explicit lists."""
    full = set(cfg["linear_attn_config"]["full_attn_layers"])
    return ["mla" if i + 1 in full else "kda"
            for i in range(cfg["num_hidden_layers"])]


def _conv(raw: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SiLU of the causal depthwise conv of raw (S, C) with taps w (C,
    K): out_t = sum_i w[:, i] raw_(t - K + 1 + i)."""
    s, taps = raw.shape[0], w.shape[1]
    out = torch.zeros_like(raw)
    for i in range(taps):
        shift = taps - 1 - i
        out[shift:] += w[:, i] * raw[:s - shift]
    return F.silu(out)


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + L2_EPS)


def _kda(ops: _Ops, x: torch.Tensor, p: Dict[str, torch.Tensor],
         keep: Sequence[int] = (), state_dtype=None) -> tuple:
    """x + the mixer's output, and the states (len(keep), H, d, d) after
    the tokens at positions ``keep`` (None without), on the host; the
    state rounded to ``state_dtype`` after each token where given."""
    la = ops.cfg["linear_attn_config"]
    s = x.shape[0]
    hn, d = la["num_heads"], la["head_dim"]
    h = rms(x, p["ln"], ops.eps)
    q, k, v = (_conv(ops.mm(h, p["w" + n]), p["conv_" + n]).view(s, hn, d)
               for n in ("q", "k", "v"))
    q, k = _l2(q), _l2(k)
    f = ops.mm(ops.mm(h, p["wf_a"]), p["wf_b"]).view(s, hn, d)
    g = -torch.exp(p["A_log"])[:, None] * F.softplus(
        f + p["dt_bias"].view(hn, d))
    beta = torch.sigmoid(ops.mm(h, p["wb"]))              # (S, H)
    state = torch.zeros((hn, d, d), device=x.device)
    out = torch.empty((s, hn, d), device=x.device)
    kept = {}
    for t in range(s):
        state = state * torch.exp(g[t])[:, :, None]
        u = torch.einsum("hk,hkv->hv", ops.q(k[t]), ops.q(state))
        state = state + k[t][:, :, None] * (beta[t][:, None]
                                            * (v[t] - u))[:, None, :]
        if state_dtype is not None:
            state = state.to(state_dtype).float()
        out[t] = torch.einsum("hk,hkv->hv", ops.q(q[t]),
                              ops.q(state)) / math.sqrt(d)
        if t in keep:
            kept[t] = state.cpu()
    gate = torch.sigmoid(ops.mm(ops.mm(h, p["wg_a"]), p["wg_b"]))
    o = rms(out, p["o_ln"], ops.eps).reshape(s, hn * d) * gate
    states = torch.stack([kept[t] for t in keep]) if keep else None
    return x + ops.mm(o, p["wo"]), states


def _mla(ops: _Ops, x: torch.Tensor, p: Dict[str, torch.Tensor]
         ) -> torch.Tensor:
    c = ops.cfg
    if not c["mla_use_nope"]:
        raise ValueError("this reference runs the NoPE MLA only")
    s = x.shape[0]
    hn, r = c["num_attention_heads"], c["kv_lora_rank"]
    nope, rp, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                    c["v_head_dim"])
    h = rms(x, p["ln"], ops.eps)
    q = ops.mm(h, p["wq"]).view(s, hn, nope + rp)
    kva = ops.mm(h, p["wkv_a"])
    ckv = rms(kva[:, :r], p["kv_ln"], ops.eps)
    k_pe = kva[:, r:]                                      # unrotated
    kv = ops.mm(ckv, p["wkv_b"]).view(s, hn, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    scale = 1.0 / math.sqrt(nope + rp)
    out = torch.empty((s, hn, vd), device=x.device)
    for i in range(0, s, QUERY_CHUNK):
        rows = slice(i, min(s, i + QUERY_CHUNK))
        sc = (torch.einsum("qhd,khd->hqk", ops.q(q[rows, :, :nope]),
                           ops.q(k_nope))
              + torch.einsum("qhd,kd->hqk", ops.q(q[rows, :, nope:]),
                             ops.q(k_pe))) * scale
        qpos = torch.arange(rows.start, rows.stop, device=x.device)
        future = torch.arange(s, device=x.device)[None, :] > qpos[:, None]
        prob = torch.softmax(sc.masked_fill(future, float("-inf")), dim=-1)
        out[rows] = torch.einsum("hqk,khd->qhd", ops.q(prob), ops.q(v))
    return x + ops.mm(out.reshape(s, hn * vd), p["wo"])


def _moe(ops: _Ops, x: torch.Tensor, p: Dict[str, torch.Tensor],
         route: Optional[torch.Tensor], tally: List[int],
         chosen: List[torch.Tensor]) -> torch.Tensor:
    c = ops.cfg
    k = c["num_experts_per_token"]
    first, held = c["deployment"]["experts_held_from"], c["num_experts"]
    h = rms(x, p["ln"], ops.eps)
    # the router runs in float32 at every precision, as the model's does
    scores = torch.sigmoid(torch.matmul(h, p["router"]))
    own = torch.topk(scores + p["bias"], k, dim=-1).indices
    idx = own
    if route is not None:
        idx = route.to(own.device).long()
        same = (own.sort(dim=-1).values == idx.sort(dim=-1).values).all(-1)
        tally[0] += int((~same).sum())
    tally[1] += own.shape[0]
    chosen.append(own.sort(dim=-1).values.cpu())
    w = scores.gather(-1, idx)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20) \
        * float(c["routed_scaling_factor"])
    y = ops.swiglu(h, p["ws_gate"], p["ws_up"], p["ws_down"])
    for e in torch.unique(idx).tolist():
        if not first <= e < first + held:
            continue                       # another chip's expert
        tok, slot = (idx == e).nonzero(as_tuple=True)
        y.index_add_(0, tok, ops.swiglu(h[tok], p["w_gate"][e - first],
                                        p["w_up"][e - first],
                                        p["w_down"][e - first])
                     * w[tok, slot, None])
    return x + y


def forward(cfg: dict, params: dict, sequences: Sequence[torch.Tensor],
            logits_at: Sequence[Sequence[int]],
            routes: Optional[Sequence[Sequence[torch.Tensor]]] = None,
            quant: Optional[str] = None, device=None,
            states_at: Optional[Sequence[Sequence[int]]] = None) -> dict:
    """The causal forward of each token sequence (S,), every position.

    Returns ``logits``: a list with, per sequence, the float32 logits
    (len(logits_at[i]), V) at its positions ``logits_at[i]``;
    ``route_mismatch`` and ``route_tokens``: the (token, MoE layer) pairs
    whose own expert set differed from the replayed one, and all of them
    (0 and the count without ``routes``); ``own_routes``: per sequence,
    per MoE layer, its own expert sets (S, k), sorted, on the host;
    ``states``: per sequence, per KDA layer, the float32 states (len(
    states_at[i]), H, d, d) after its positions ``states_at[i]``, on the
    host (None without ``states_at``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = device or params["embed"].device
    ops = _Ops(cfg, quant)
    dense = int(cfg["first_k_dense_replace"])
    xs = [params["embed"][torch.as_tensor(t, device=params["embed"].device)
                          .long()].to(device=device, dtype=torch.float32)
          for t in sequences]
    tally = [0, 0]
    chosen = [[] for _ in xs]
    states = [[] for _ in xs]
    for li, (layer, kind) in enumerate(zip(params["layers"], mixers(cfg))):
        mix, ffn = _f32(layer["mix"], device), _f32(layer["ffn"], device)
        for i, x in enumerate(xs):
            if kind == "mla":
                x = _mla(ops, x, mix)
            else:
                x, kept = _kda(ops, x, mix,
                               states_at[i] if states_at else (),
                               STATE_BELOW.get(quant))
                states[i].append(kept)
            if li < dense:
                x = x + ops.swiglu(rms(x, ffn["ln"], ops.eps), ffn["w_gate"],
                                   ffn["w_up"], ffn["w_down"])
            else:
                route = routes[i][li - dense] if routes is not None else None
                x = _moe(ops, x, ffn, route, tally, chosen[i])
            xs[i] = x
        del mix, ffn
    final = params["final_ln"].to(device=device, dtype=torch.float32)
    head = params["lm_head"].to(device=device, dtype=torch.float32)
    out = [ops.mm(rms(x[list(at)], final, ops.eps), head)
           for x, at in zip(xs, logits_at)]
    return {"logits": out, "route_mismatch": tally[0],
            "route_tokens": tally[1], "own_routes": chosen,
            "states": states}
