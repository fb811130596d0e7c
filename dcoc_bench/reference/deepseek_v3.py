"""Plain float32 causal forward of a DeepSeek-V3 block stack: the
reference of the LM cells (``moonlight-16b-a3b``).

Written from the published equations (DeepSeek-V2, arXiv:2405.04434
section 2.1, MLA; DeepSeek-V3, arXiv:2412.19437 sections 2.1.1-2.1.2,
sigmoid routing with a correction bias) and the configuration's
``config.json`` keys, which :func:`forward` reads as they are
(``hidden_size``, ``kv_lora_rank``, ``n_routed_experts``, ...):

* attention in the expanded form: q = h W_q split into (nope | rope)
  per head; [c_kv | k_pe] = h W_kva, c_kv normed; [k_nope | v] = c_kv
  W_kvb per head; rope on q's rope part and on k_pe (one for every head);
  softmax((q_nope k_nope + q_pe k_pe) / sqrt(nope + rope)) v, causal; then
  W_o.  No low-rank query (``q_lora_rank`` null), no rope scaling;
* layers below ``first_k_dense_replace`` a dense SwiGLU of
  ``intermediate_size``; the others the MoE: sigmoid scores of an fp32
  router, the top ``num_experts_per_tok`` of score + correction bias,
  their scores normalised (+1e-20) times ``routed_scaling_factor``, each
  chosen expert a SwiGLU of ``moe_intermediate_size`` on its own tokens
  (no capacity, none dropped), plus the shared SwiGLU of ``n_shared_experts
  x moe_intermediate_size`` on every token;
* RMSNorm with ``rms_norm_eps`` before attention, before the FFN, on
  c_kv, and at the end; the untied head.

Departure: rope rotates the halves of the rope part (the first half with
the second), where DeepSeek's checkpoints interleave pairs; with weights
drawn from a seed that is a fixed permutation of the rope columns of W_q
and W_kva, the same model.

No cache, no batching: one sequence at a time, every position.
:func:`forward` walks the layers in the outer loop and the sequences in
the inner one, so that it holds one layer's weights in float32 at a time
beside the weights it is given (bfloat16 on the card).  Matrix products
run in float32 with TF32 off.  ``quant`` rounds both operands of every
product (``"bf16"``: to bfloat16; ``"fp8"``: to float8 e4m3 under a
per-tensor scale), the products still summed in float32: the controls
below the precision the configuration states.  The router runs in
float32 whatever ``quant``, as the model's does.  ``routes`` replays a
given routing (per sequence, per MoE layer, the expert sets (S, k)); the
reference's own choice is counted against it.

Weights come as the program's tree (plain tensors): ``embed`` (V, D),
``final_ln``, ``lm_head`` (D, V), and a list ``layers`` of {"mix":
{ln, wq, wkv_a, kv_ln, wkv_b, wo}, "ffn": {ln, w_gate, w_up, w_down}
(dense) or {ln, router, bias, w_gate, w_up, w_down (E, ...), ws_gate,
ws_up, ws_down} (MoE)}, every weight (in, out).  It imports nothing of
the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

FP8_MAX = 448.0   # largest finite float8 e4m3fn
QUERY_CHUNK = 1024   # query rows whose scores are held at once


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = float(x.abs().max())
    if amax == 0.0:
        return x
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _rounder(quant: Optional[str]):
    if quant is None:
        return lambda t: t
    if quant == "bf16":
        return lambda t: t.to(torch.bfloat16).float()
    if quant == "fp8":
        return _fp8
    raise ValueError(f"unknown quant {quant!r}")


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, ..., d) at positions 0.. S-1, the halves rotated."""
    s, d = x.shape[0], x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    shape = (s,) + (1,) * (x.ndim - 2) + (half,)
    cos, sin = torch.cos(ang).view(shape), torch.sin(ang).view(shape)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class _Ops:
    """The products and the settings every layer shares."""

    def __init__(self, cfg: dict, quant: Optional[str]):
        self.q = _rounder(quant)
        self.cfg = cfg
        self.eps = float(cfg["rms_norm_eps"])

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.q(a), self.q(b))

    def swiglu(self, h, w_gate, w_up, w_down) -> torch.Tensor:
        return self.mm(F.silu(self.mm(h, w_gate)) * self.mm(h, w_up), w_down)


def _attention(ops: _Ops, x: torch.Tensor, p: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
    c = ops.cfg
    s = x.shape[0]
    hn, r = c["num_attention_heads"], c["kv_lora_rank"]
    nope, rp, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                    c["v_head_dim"])
    theta = float(c["rope_theta"])
    h = rms(x, p["ln"], ops.eps)
    q = ops.mm(h, p["wq"]).view(s, hn, nope + rp)
    kva = ops.mm(h, p["wkv_a"])
    ckv = rms(kva[:, :r], p["kv_ln"], ops.eps)
    k_pe = rope(kva[:, r:], theta)                         # (S, rope)
    q_nope, q_pe = q[..., :nope], rope(q[..., nope:], theta)
    kv = ops.mm(ckv, p["wkv_b"]).view(s, hn, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    scale = 1.0 / math.sqrt(nope + rp)
    out = torch.empty((s, hn, vd), device=x.device)
    for i in range(0, s, QUERY_CHUNK):
        rows = slice(i, min(s, i + QUERY_CHUNK))
        sc = (torch.einsum("qhd,khd->hqk", ops.q(q_nope[rows]),
                           ops.q(k_nope))
              + torch.einsum("qhd,kd->hqk", ops.q(q_pe[rows]),
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
    k = c["num_experts_per_tok"]
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
        tok, slot = (idx == e).nonzero(as_tuple=True)
        y.index_add_(0, tok, ops.swiglu(h[tok], p["w_gate"][e],
                                        p["w_up"][e], p["w_down"][e])
                     * w[tok, slot, None])
    return x + y


def _f32(tree: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {key: t.to(device=device, dtype=torch.float32)
            for key, t in tree.items()}


def forward(cfg: dict, params: dict, sequences: Sequence[torch.Tensor],
            logits_at: Sequence[Sequence[int]],
            routes: Optional[Sequence[Sequence[torch.Tensor]]] = None,
            quant: Optional[str] = None, device=None) -> dict:
    """The causal forward of each token sequence (S,), every position.

    Returns ``logits``: a list with, per sequence, the float32 logits
    (len(logits_at[i]), V) at its positions ``logits_at[i]``;
    ``route_mismatch`` and ``route_tokens``: the (token, MoE layer) pairs
    whose own expert set differed from the replayed one, and all of them
    (0 and the count without ``routes``); ``own_routes``: per sequence,
    per MoE layer, its own expert sets (S, k), sorted, on the host."""
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
    for li, layer in enumerate(params["layers"]):
        mix, ffn = _f32(layer["mix"], device), _f32(layer["ffn"], device)
        for i, x in enumerate(xs):
            x = _attention(ops, x, mix)
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
            "route_tokens": tally[1], "own_routes": chosen}
