"""Block-stack LM: the serving path (prefill + decode) in PyTorch.

The counterpart of the reference's ``repro.models.transformer`` for the
dense attention families.  An architecture is a period pattern of
(mixer, ffn) pairs; the port supports mixers ``attn``/``swa``/``none`` and
FFNs ``mlp``/``gelu``/``none``.  MoE, Mamba, mLSTM, sLSTM, encoder-decoder
and vision-prefix models raise ``NotImplementedError`` naming the ROADMAP
item that ports them.

Where the reference scans over weights stacked (R, ...) per period
position, the port loops over layers in Python: ``params["layers"]`` is a
list of ``n_layers`` per-layer dicts, layer ``r * period + p`` being repeat
r of period position p (:func:`params_from_jax` unstacks a reference
tree that way).  The decode cache is ``{"pos": (B,) int32, "layers":
[per-layer {"k", "v"}]}``, each (B, C, HKV, D); decode writes it in place
(the reference donates it to its jitted step instead).

Every RMSNorm goes through the RMSNorm kernel (2 a layer + the final
norm) and prefill attention through the flash kernel (1 an attention
layer); ``use_kernel=False`` runs the plain path instead (see
:mod:`repro_torch.models.layers`).  Two entry points:
  prefill: tokens -> logits for the last position + a decode cache
  decode:  one token a sequence + cache -> next-token logits
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L

Params = Dict[str, Any]

_MIXERS = ("attn", "swa", "none")
_FFNS = ("mlp", "gelu", "none")
_NOT_PORTED = {
    "moe": "the MoE FFN (ROADMAP Queue 1, item 15c)",
    "mamba": "the Mamba mixer (ROADMAP Queue 1, item 15c)",
    "mlstm": "the mLSTM mixer (ROADMAP Queue 1, item 15c)",
    "slstm": "the sLSTM mixer (ROADMAP Queue 1, item 15c)",
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """The reference's ``ArchConfig`` with torch dtypes.  Fields the
    serving path does not read yet (MoE, SSM, training) are kept so every
    config module holds the same data as the reference's."""
    name: str
    family: str                 # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: Tuple[Tuple[str, str], ...] = (("attn", "mlp"),)
    # attention
    qkv_bias: bool = False
    swa_window: Optional[int] = None
    use_rope: bool = True
    rope_theta: float = 10000.0
    attn_chunk: int = 1024
    # moe
    n_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 2048
    moe_impl: str = "dropping"
    aux_loss_weight: float = 0.01
    # ssm
    ssm_chunk: int = 64
    d_state: int = 16
    # structure
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 0
    vision_prefix: int = 0
    mlp_variant: str = "swiglu"
    # numerics / memory
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16
    remat: bool = True
    loss_chunk: int = 512

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Sequence mixing below O(S^2): an SSM/xLSTM mixer, or sliding
        windows only (``configs.shapes.cell_supported`` reads it)."""
        mixers = {m for m, _ in self.pattern}
        return bool(mixers & {"mamba", "mlstm", "slstm"}) or (
            "attn" not in mixers and "swa" in mixers
            and self.swa_window is not None)

    @property
    def period(self) -> int:
        return len(self.pattern)

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def layer_kinds(self) -> List[Tuple[str, str]]:
        """(mixer, ffn) of every layer, in order."""
        return [self.pattern[i % self.period] for i in range(self.n_layers)]


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    if cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            f"(ROADMAP Queue 1, item 15c)")
    if cfg.vision_prefix:
        raise NotImplementedError(
            f"{cfg.name}: vision-prefix models are not ported yet "
            f"(ROADMAP Queue 1, item 15c)")
    for mixer, ffn in cfg.pattern:
        for part in (mixer, ffn):
            if part in _NOT_PORTED:
                raise NotImplementedError(
                    f"{cfg.name}: {_NOT_PORTED[part]} is not ported yet")
        if mixer not in _MIXERS or ffn not in _FFNS:
            raise ValueError(f"{cfg.name}: unknown block ({mixer}, {ffn})")


# --------------------------------------------------------------------- init

def _init_one_layer(gen: torch.Generator, cfg: ArchConfig, mixer: str,
                    ffn: str, device) -> Params:
    p: Params = {}
    dt = cfg.param_dtype
    if mixer in ("attn", "swa"):
        p["mix"] = L.init_attention(gen, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.head_dim,
                                    cfg.qkv_bias, dt, device)
    if ffn in ("mlp", "gelu"):
        variant = "swiglu" if ffn == "mlp" else "gelu"
        p["ffn"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, variant, dt, device)
    return p


def init_params(seed: int, cfg: ArchConfig, device=None) -> Params:
    """Seeded random weights, drawn on ``device`` (default ``cuda``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.param_dtype
    scale = 1.0 / math.sqrt(cfg.d_model)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    return {
        "embed": (randn(cfg.vocab, cfg.d_model) * scale).to(dt),
        "final_ln": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "lm_head": (randn(cfg.d_model, cfg.vocab) * scale).to(dt),
        "layers": [_init_one_layer(gen, cfg, mixer, ffn, dev)
                   for mixer, ffn in cfg.layer_kinds()],
    }


def params_from_jax(tree: Params, cfg: ArchConfig, device=None) -> Params:
    """The reference's ``init_params`` tree (numpy or jax leaves; layers a
    tuple per period position of leaves stacked (R, ...)) as the port's
    params: each stacked leaf is unstacked along axis 0 into layer
    ``r * period + p``, and every leaf is cast to ``cfg.param_dtype``."""
    check_supported(cfg)
    dev = resolve_device(device)

    def conv(leaf) -> torch.Tensor:
        # via fp32: numpy has no bfloat16, and bf16 -> fp32 is exact
        arr = np.asarray(np.asarray(leaf).astype(np.float32))
        return torch.from_numpy(arr).to(device=dev, dtype=cfg.param_dtype)

    def unstack(tree_p: Params, r: int) -> Params:
        return {k: (unstack(v, r) if isinstance(v, dict) else conv(v[r]))
                for k, v in tree_p.items()}

    layers = [unstack(tree["layers"][i % cfg.period], i // cfg.period)
              for i in range(cfg.n_layers)]
    return {"embed": conv(tree["embed"]), "final_ln": conv(tree["final_ln"]),
            "lm_head": conv(tree["lm_head"]), "layers": layers}


def param_count(params: Params) -> int:
    def count(p) -> int:
        if isinstance(p, dict):
            return sum(count(v) for v in p.values())
        if isinstance(p, list):
            return sum(count(v) for v in p)
        return p.numel()
    return count(params)


# ------------------------------------------------------------------- blocks

def _apply_block(x, p, cfg: ArchConfig, mixer: str, ffn: str, positions,
                 causal: bool, use_kernel: bool):
    """Prefill block. Returns (x, cache entry)."""
    cache: Dict[str, torch.Tensor] = {}
    if mixer in ("attn", "swa"):
        window = cfg.swa_window if mixer == "swa" else None
        x, cache["k"], cache["v"] = L.attention_block(
            x, p["mix"], cfg, positions, causal=causal, window=window,
            use_kernel=use_kernel)
    if ffn in ("mlp", "gelu"):
        x = L.mlp(x, p["ffn"], "swiglu" if ffn == "mlp" else "gelu",
                  use_kernel=use_kernel)
    return x, cache


def embed_inputs(params: Params, batch: Dict[str, torch.Tensor],
                 cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token embedding. Returns (x (B,S,D), positions (B,S))."""
    tokens = batch["tokens"]
    x = params["embed"][tokens.long()].to(cfg.dtype)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    return x, positions


def hidden_states(params: Params, batch: Dict[str, torch.Tensor],
                  cfg: ArchConfig, use_kernel: bool = True
                  ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """Forward to the final normed hidden states. Returns (h, per-layer
    caches {"k", "v"} of the attention layers, {} elsewhere)."""
    check_supported(cfg)
    x, positions = embed_inputs(params, batch, cfg)
    caches = []
    for p, (mixer, ffn) in zip(params["layers"], cfg.layer_kinds()):
        x, cache = _apply_block(x, p, cfg, mixer, ffn, positions,
                                causal=True, use_kernel=use_kernel)
        caches.append(cache)
    return L.rmsnorm(x, params["final_ln"], use_kernel=use_kernel), caches


def logits_last(params: Params, h: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    """Logits for the last position only. h: (B, S, D) -> (B, V) fp32."""
    return torch.matmul(h[:, -1], params["lm_head"].to(h.dtype)).float()


# ------------------------------------------------------------------- decode

def _cache_seq_len(cfg: ArchConfig, mixer: str, max_len: int) -> int:
    """SWA layers keep a ring buffer of ``window`` tokens, never more."""
    if mixer == "swa" and cfg.swa_window is not None:
        return min(max_len, cfg.swa_window)
    return max_len


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> Params:
    """Zero decode cache; per-sequence positions (each batch slot may be
    at a different depth)."""
    check_supported(cfg)
    dev = resolve_device(device)
    layers = []
    for mixer, _ in cfg.layer_kinds():
        entry: Dict[str, torch.Tensor] = {}
        if mixer in ("attn", "swa"):
            shape = (batch, _cache_seq_len(cfg, mixer, max_len),
                     cfg.n_kv_heads, cfg.head_dim)
            entry["k"] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
            entry["v"] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        layers.append(entry)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "layers": layers}


def _decode_block(x, p, cfg: ArchConfig, mixer: str, ffn: str, entry, pos,
                  kv_len: int, use_kernel: bool):
    """One-token block. x: (B,1,D).  Writes the cache entry in place and
    returns x.  ``kv_len``: an upper bound of every slot's cache length
    (decode attention reads no further; the mask hides the rest anyway)."""
    if mixer in ("attn", "swa"):
        b = x.shape[0]
        window = cfg.swa_window if mixer == "swa" else None
        ring = (mixer == "swa" and cfg.swa_window is not None
                and entry["k"].shape[1] <= cfg.swa_window)
        h = L.rmsnorm(x, p["mix"]["ln"], use_kernel=use_kernel)
        q, k, v = L.qkv(h, p["mix"], cfg)
        if cfg.use_rope:
            pp = pos.reshape(-1, 1).expand(b, 1)
            q = L.rope(q, pp, cfg.rope_theta)
            k = L.rope(k, pp, cfg.rope_theta)
        kc, vc = L.update_kv_cache(entry["k"], entry["v"], k, v, pos,
                                   ring=ring)
        if ring:
            out = L.decode_attention_ring(q, kc, vc, pos, cfg.swa_window)
        else:
            out = L.decode_attention(q, kc[:, :kv_len], vc[:, :kv_len],
                                     pos + 1, window=window)
        x = x + L.dense(out.reshape(b, 1, -1), p["mix"]["wo"])
    if ffn in ("mlp", "gelu"):
        x = L.mlp(x, p["ffn"], "swiglu" if ffn == "mlp" else "gelu",
                  use_kernel=use_kernel)
    return x


def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                cfg: ArchConfig, use_kernel: bool = True
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step. tokens: (B, 1) -> (logits (B, V), cache).  The
    cache's layers are updated in place; the returned cache holds them and
    ``pos + 1``."""
    check_supported(cfg)
    pos = cache["pos"]
    x = params["embed"][tokens.long()].to(cfg.dtype)
    kv_len = int(pos.max()) + 1       # one host sync a step
    for p, (mixer, ffn), entry in zip(params["layers"], cfg.layer_kinds(),
                                      cache["layers"]):
        x = _decode_block(x, p, cfg, mixer, ffn, entry, pos, kv_len,
                          use_kernel)
    h = L.rmsnorm(x, params["final_ln"], use_kernel=use_kernel)
    return logits_last(params, h, cfg), {"pos": pos + 1,
                                         "layers": cache["layers"]}


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            max_len: int, use_kernel: bool = True
            ) -> Tuple[torch.Tensor, Params]:
    """Prefill: full forward, build a decode cache padded to ``max_len``."""
    h, caches = hidden_states(params, batch, cfg, use_kernel=use_kernel)
    b, s = h.shape[0], h.shape[1]
    layers = []
    for entry, (mixer, _) in zip(caches, cfg.layer_kinds()):
        if mixer in ("attn", "swa"):
            c = _cache_seq_len(cfg, mixer, max_len)
            k, v = entry["k"], entry["v"]                 # (B, S, KV, Dh)
            if c >= s:
                pad = (b, c, cfg.n_kv_heads, cfg.head_dim)
                kp = torch.zeros(pad, dtype=k.dtype, device=k.device)
                vp = torch.zeros(pad, dtype=v.dtype, device=v.device)
                kp[:, :s], vp[:, :s] = k, v
                entry = {"k": kp, "v": vp}
            else:  # ring: keep the last c tokens, rotated so that
                   # slot (s % c) is the oldest (next write target)
                idx = (torch.arange(c, device=k.device) - s % c) % c
                entry = {"k": k[:, s - c:][:, idx], "v": v[:, s - c:][:, idx]}
        layers.append(entry)
    logits = logits_last(params, h, cfg)
    pos = torch.full((b,), s, dtype=torch.int32, device=h.device)
    return logits, {"pos": pos, "layers": layers}
