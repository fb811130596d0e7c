"""Block-stack LM: the training and serving paths in PyTorch.

The counterpart of the reference's ``repro.models.transformer`` for all
ten architectures.  An architecture is a period pattern of (mixer, ffn)
pairs: mixers ``attn``/``swa``/``mamba``/``mlstm``/``slstm``/``none`` and
FFNs ``mlp``/``moe``/``gelu``/``none`` (``repro_torch.models.moe`` and
``repro_torch.models.ssm``); the port's own ``mla`` mixer (DeepSeek-V3's
multi-head latent attention, ``repro_torch.models.mla``) and ``kda`` mixer
(Kimi Delta Attention, ``repro_torch.models.kda``) run under an
:class:`MLAConfig`, which the reference has no counterpart of.  Two
structures sit around the stack:

  encoder-decoder (``cfg.enc_dec``, whisper): ``batch["frames"]`` (B, F,
      D) plus sinusoidal positions go through a non-causal, rope-free
      encoder stack of (attn, gelu) layers (``params["enc_layers"]``) and
      ``enc_ln``; each decoder layer has a ``cross`` attention part
      between its mixer and its FFN, whose keys and values are projected
      from the encoder's output once and kept in the cache as ``xk``/``xv``
      (B, F, HKV, D).  The decoder itself gets no positional signal
      beyond what the config's rope gives (whisper's: none), as in the
      reference;
  vision prefix (``cfg.vision_prefix`` P, internvl2): ``batch["patches"]``
      (B, P, D) is put ahead of the token embeddings; positions and the
      cache run over P + T, and the loss masks the P prefix positions.

Where the reference scans over weights stacked (R, ...) per period
position, the port loops over layers in Python: ``params["layers"]`` is a
list of ``n_layers`` per-layer dicts, layer ``r * period + p`` being repeat
r of period position p (:func:`params_from_jax` unstacks a reference
tree that way).  The decode cache is ``{"pos": (B,) int32, "layers":
[per-layer entry]}``: an attention layer's entry is {"k", "v"}, each
(B, C, HKV, D); an MLA layer's is its latent cache {"ckv" (B, C,
kv_lora_rank), "kpe" (B, C, qk_rope_head_dim)}; a KDA layer's its state
{"S" (B, H, d, d) fp32, "conv_q"/"conv_k"/"conv_v" (B, 3, H d)}; a
recurrent mixer's is its state's fields (Mamba {"h", "conv"}, mLSTM
{"c", "n", "m"}, sLSTM {"c", "n", "m", "h"}), each with the batch on
axis 0.  Decode writes it in place (the reference donates it to its
jitted step instead).

Every RMSNorm goes through the RMSNorm kernel (one a mixer, one a cross
part and one an FFN that the layer has, the encoder's layers and
``enc_ln`` too, + the final norm; differentiable) and prefill self
attention through the flash kernel (1 an attention layer, the encoder's
non-causal ones included; cross attention is ``L.chunked_attention``);
``use_kernel=False`` runs the plain path instead (see
:mod:`repro_torch.models.layers`).  Three entry points:
  train:   tokens -> chunked-softmax xent loss (:func:`loss_fn`; never
           materializes (B, S, V)); attention through
           ``L.chunked_attention`` with its backward, blocks rematerialized
           under ``cfg.remat``
  prefill: tokens -> logits for the last position + a decode cache
  decode:  one token a sequence + cache -> next-token logits
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch import obs, resolve_device
from repro_torch.dist import sharding as SH
from repro_torch.models import kda as KDA
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

Params = Dict[str, Any]

# The activation constraint (the reference's ``set_batch_axes`` /
# ``constrain_batch``): the step builders name the batch mesh axes, and the
# stack redistributes a DTensor residual stream at every block boundary so
# the batch stays sharded; plain tensors pass through.
set_batch_axes = L.set_batch_axes
constrain_batch = L.constrain_batch

_MIXERS = ("attn", "swa", "mla", "kda", "mamba", "mlstm", "slstm", "none")
_FFNS = ("mlp", "moe", "gelu", "none")
# the recurrent mixers: block function and state type
_RECURRENT = {"mamba": (SSM.mamba_block, SSM.MambaState),
              "mlstm": (SSM.mlstm_block, SSM.LstmState),
              "slstm": (SSM.slstm_block, SSM.SlstmState)}
# a layer part's leaves kept in fp32 whatever the param dtype
_FP32_LEAVES = dict(SSM.FP32_LEAVES, moe=MOE.FP32_LEAVES)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """The reference's ``ArchConfig`` with torch dtypes: every config
    module holds the same data as the reference's."""
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
    enc_seq: int = 0            # audio frames fed by the frontend stub
    vision_prefix: int = 0      # VLM patch embeddings fed by the stub
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

    # Settings the reference's configs leave at one value; properties, so
    # that they stay out of the dataclass's fields (the configs hold the
    # reference's data field by field).  :class:`MLAConfig` makes them
    # fields of its own.
    @property
    def rms_norm_eps(self) -> float:
        """Every RMSNorm's epsilon (the RMSNorm kernel's default)."""
        return 1e-6

    @property
    def moe_scoring(self) -> str:
        """The router's scores: ``softmax`` over the experts."""
        return "softmax"

    def ffn_width(self, ffn: str) -> int:
        """The hidden width of an FFN of kind ``ffn``."""
        return self.d_ff


@dataclasses.dataclass(frozen=True)
class MLAConfig(ArchConfig):
    """A DeepSeek-V3 block (arXiv:2412.19437): multi-head latent attention
    (``mla`` mixer, :mod:`repro_torch.models.mla`) with no query
    low-rank, then a leading ``first_k_dense`` dense SwiGLU layers of
    ``dense_d_ff`` and MoE layers of ``n_experts`` routed experts of
    ``d_ff`` beside ``n_shared_experts`` shared ones (one SwiGLU of
    ``n_shared_experts * d_ff``).  The router scores by ``moe_scoring``
    (``sigmoid``), chooses the top-k on score plus a per-expert correction
    bias (drawn with std ``route_bias_std``), and weighs the chosen scores
    normalised to 1 times ``routed_scaling``.  ``n_kv_heads`` is
    ``n_heads``: every head has its own keys and values, expanded from one
    latent.  Only the port has it; no reference config instantiates it.

    Kimi Linear's fields (arXiv:2510.26692): ``layer_mixers``, where not
    empty, names every layer's mixer in order (``mla`` or ``kda``; a
    stack whose mixers no period of ``pattern`` gives), the FFNs still
    from ``pattern`` and ``first_k_dense``; ``mla_nope`` leaves MLA's
    rope columns unrotated (``mla_use_nope``); ``kda_heads`` heads of
    ``kda_head_dim`` for the ``kda`` mixer, whose short convolutions have
    ``kda_conv`` taps and whose decay and output gates a low rank of
    ``kda_gate_rank``.  The expert share of expert parallelism:
    ``n_experts_held`` experts from ``experts_held_from`` (0: all
    ``n_experts``) have weights here; the router scores all
    ``n_experts``."""
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_shared_experts: int = 2
    first_k_dense: int = 1
    dense_d_ff: int = 11264
    moe_scoring: str = "sigmoid"
    routed_scaling: float = 2.446
    route_bias_std: float = 0.05
    rms_norm_eps: float = 1e-5
    layer_mixers: Tuple[str, ...] = ()
    mla_nope: bool = False
    kda_heads: int = 0
    kda_head_dim: int = 128
    kda_conv: int = 4
    kda_gate_rank: int = 128
    n_experts_held: int = 0
    experts_held_from: int = 0

    def __post_init__(self) -> None:
        if self.layer_mixers and len(self.layer_mixers) != self.n_layers:
            raise ValueError(f"{self.name}: {len(self.layer_mixers)} layer "
                             f"mixers for {self.n_layers} layers")
        if not 0 <= self.experts_held_from <= (
                self.n_experts - self.experts_held):
            raise ValueError(f"{self.name}: experts {self.experts_held_from}"
                             f" + {self.experts_held} past the router's "
                             f"{self.n_experts}")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def experts_held(self) -> int:
        """Routed experts whose weights this model holds."""
        return self.n_experts_held or self.n_experts

    def layer_kinds(self) -> List[Tuple[str, str]]:
        mixers = self.layer_mixers or [self.pattern[i % self.period][0]
                                       for i in range(self.n_layers)]
        return [(m, "mlp" if i < self.first_k_dense
                 else self.pattern[i % self.period][1])
                for i, m in enumerate(mixers)]

    def ffn_width(self, ffn: str) -> int:
        return self.dense_d_ff if ffn == "mlp" else self.d_ff


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a block the port does not know."""
    for mixer, ffn in set(cfg.pattern) | set(cfg.layer_kinds()):
        if mixer not in _MIXERS or ffn not in _FFNS:
            raise ValueError(f"{cfg.name}: unknown block ({mixer}, {ffn})")
        if mixer in ("mla", "kda") and not isinstance(cfg, MLAConfig):
            raise ValueError(f"{cfg.name}: the {mixer} mixer runs under an "
                             f"MLAConfig")


# --------------------------------------------------------------------- init

def encoder_config(cfg: ArchConfig) -> ArchConfig:
    """The encoder stack's config: (attn, gelu) layers, no rope."""
    return cfg.with_(pattern=(("attn", "gelu"),), use_rope=False,
                     n_layers=cfg.n_enc_layers)


def _init_one_layer(gen: torch.Generator, cfg: ArchConfig, mixer: str,
                    ffn: str, device, cross: bool = False) -> Params:
    p: Params = {}
    dt = cfg.param_dtype
    if mixer in ("attn", "swa"):
        p["mix"] = L.init_attention(gen, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.head_dim,
                                    cfg.qkv_bias, dt, device)
    elif mixer == "mla":
        p["mix"] = MLA.init_mla(gen, cfg, dt, device)
    elif mixer == "kda":
        p["mix"] = KDA.init_kda(gen, cfg, dt, device)
    elif mixer == "mamba":
        p["mix"] = SSM.init_mamba(gen, cfg.d_model, cfg.d_state, dtype=dt,
                                  device=device)
    elif mixer == "mlstm":
        p["mix"] = SSM.init_mlstm(gen, cfg.d_model, cfg.n_heads, dt, device)
    elif mixer == "slstm":
        p["mix"] = SSM.init_slstm(gen, cfg.d_model, cfg.n_heads, dt, device)
    if cross:
        p["cross"] = L.init_attention(gen, cfg.d_model, cfg.n_heads,
                                      cfg.n_kv_heads, cfg.head_dim, False,
                                      dt, device)
    if ffn == "moe":
        p["ffn"] = MOE.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                dt, device,
                                n_held=getattr(cfg, "experts_held", None))
        if cfg.moe_scoring == "sigmoid":
            p["ffn"].update(MOE.init_deepseek_extras(gen, cfg, dt, device))
    elif ffn in ("mlp", "gelu"):
        variant = "swiglu" if ffn == "mlp" else "gelu"
        p["ffn"] = L.init_mlp(gen, cfg.d_model, cfg.ffn_width(ffn), variant,
                              dt, device)
    return p


def init_params(seed: int, cfg: ArchConfig, device=None) -> Params:
    """Seeded random weights, drawn on ``device`` (default ``cuda``); the
    leaves the reference keeps in fp32 (the router, Mamba's ``A_log`` and
    ``D``, mLSTM's ``wi``/``wf``, sLSTM's ``b*``) are fp32 here too."""
    check_supported(cfg)
    dev = resolve_device(device)
    # meta tensors draw nothing: any generator will do
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev
                          ).manual_seed(seed)
    dt = cfg.param_dtype
    scale = 1.0 / math.sqrt(cfg.d_model)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    params = {
        "embed": (randn(cfg.vocab, cfg.d_model) * scale).to(dt),
        "final_ln": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "lm_head": (randn(cfg.d_model, cfg.vocab) * scale).to(dt),
        "layers": [_init_one_layer(gen, cfg, mixer, ffn, dev, cfg.enc_dec)
                   for mixer, ffn in cfg.layer_kinds()],
    }
    if cfg.enc_dec:
        params["enc_layers"] = [
            _init_one_layer(gen, cfg, mixer, ffn, dev)
            for mixer, ffn in encoder_config(cfg).layer_kinds()]
        params["enc_ln"] = torch.ones((cfg.d_model,), dtype=dt, device=dev)
    return params


def abstract_params(cfg: ArchConfig) -> Params:
    """The parameter tree on the ``meta`` device: every leaf's shape and
    dtype, no storage (the reference's ``abstract_params``)."""
    return init_params(0, cfg, device="meta")


def params_from_jax(tree: Params, cfg: ArchConfig, device=None) -> Params:
    """The reference's ``init_params`` tree (numpy or jax leaves; layers a
    tuple per period position of leaves stacked (R, ...)) as the port's
    params: each stacked leaf is unstacked along axis 0 into layer
    ``r * period + p`` (the encoder's ``enc_layers`` alike), and cast to
    ``cfg.param_dtype``, except the leaves the reference keeps in fp32
    (see :func:`init_params`), which stay fp32."""
    check_supported(cfg)
    dev = resolve_device(device)

    def conv(leaf, dtype=cfg.param_dtype) -> torch.Tensor:
        # via fp32: numpy has no bfloat16, and bf16 -> fp32 is exact
        arr = np.asarray(np.asarray(leaf).astype(np.float32))
        return torch.from_numpy(arr).to(device=dev, dtype=dtype)

    def unstack(tree_l: Params, r: int, kinds) -> Params:
        out = {}
        for part, leaves in tree_l.items():
            fp32 = _FP32_LEAVES.get(kinds[part], ())
            out[part] = {k: conv(v[r], torch.float32 if k in fp32
                                 else cfg.param_dtype)
                         for k, v in leaves.items()}
        return out

    def stack(stacked, c: ArchConfig) -> List[Params]:
        return [unstack(stacked[i % c.period], i // c.period,
                        {"mix": mixer, "ffn": ffn, "cross": "attn"})
                for i, (mixer, ffn) in enumerate(c.layer_kinds())]

    params = {"embed": conv(tree["embed"]),
              "final_ln": conv(tree["final_ln"]),
              "lm_head": conv(tree["lm_head"]),
              "layers": stack(tree["layers"], cfg)}
    if cfg.enc_dec:
        params["enc_layers"] = stack(tree["enc_layers"], encoder_config(cfg))
        params["enc_ln"] = conv(tree["enc_ln"])
    return params


def param_count(params: Params) -> int:
    def count(p) -> int:
        if isinstance(p, dict):
            return sum(count(v) for v in p.values())
        if isinstance(p, list):
            return sum(count(v) for v in p)
        return p.numel()
    return count(params)


# ------------------------------------------------------------------- blocks

def _ffn(x, p, cfg: ArchConfig, ffn: str, use_kernel: bool
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's FFN. Returns (x, aux: the MoE's load-balance loss, or
    None)."""
    if ffn == "moe":
        return MOE.moe_block(x, p["ffn"], cfg, use_kernel=use_kernel)
    if ffn in ("mlp", "gelu"):
        x = L.mlp(x, p["ffn"], "swiglu" if ffn == "mlp" else "gelu",
                  use_kernel=use_kernel, eps=cfg.rms_norm_eps)
    return x, None


def _apply_block(x, p, cfg: ArchConfig, mixer: str, ffn: str, positions,
                 causal: bool, use_kernel: bool, train: bool = False,
                 enc_kv=None):
    """Prefill or training block. Returns (x, aux or None, cache entry):
    an attention layer's roped keys and values, a recurrent mixer's state
    after the sequence (its fields as keys).  ``enc_kv``: the encoder's
    (keys, values) for this layer's cross part, which runs between the
    mixer and the FFN."""
    cache: Dict[str, torch.Tensor] = {}
    if mixer in ("attn", "swa"):
        window = cfg.swa_window if mixer == "swa" else None
        x, cache["k"], cache["v"] = L.attention_block(
            x, p["mix"], cfg, positions, causal=causal, window=window,
            use_kernel=use_kernel, train=train)
    elif mixer in ("mla", "kda"):
        with MLA.span(mixer):
            if mixer == "mla":
                x, cache["ckv"], cache["kpe"] = MLA.mla_block(
                    x, p["mix"], cfg, positions, use_kernel=use_kernel)
            else:
                x, cache = KDA.kda_block(x, p["mix"], cfg,
                                         use_kernel=use_kernel)
        with MLA.span(ffn):
            x, aux = _ffn(x, p, cfg, ffn, use_kernel)
        return x, aux, cache
    elif mixer in _RECURRENT:
        x, st = _RECURRENT[mixer][0](x, p["mix"], cfg,
                                     use_kernel=use_kernel)
        cache = st._asdict()
    if enc_kv is not None:
        x = L.cross_attention_block(x, p["cross"], cfg, enc_kv, use_kernel)
    x, aux = _ffn(x, p, cfg, ffn, use_kernel)
    return x, aux, cache


def _train_block(x, p, cfg: ArchConfig, mixer: str, ffn: str, positions,
                 causal: bool, use_kernel: bool, enc_kv=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    x, aux, _ = _apply_block(x, p, cfg, mixer, ffn, positions, causal,
                             use_kernel, train=True, enc_kv=enc_kv)
    return x, (aux if aux is not None
               else torch.zeros((), dtype=torch.float32, device=x.device))


def embed(table: torch.Tensor, tokens: torch.Tensor,
          dtype) -> torch.Tensor:
    """``jnp.take(table, tokens, axis=0)`` with its default fill mode, cast
    to ``dtype``: an id in [-V, V) picks its row (a negative one counts
    from the end), any other id gives a row of NaN.  The index is clamped
    before the gather, so an out-of-range id never reaches the device (on
    CUDA it would be a device-side assert that leaves the context
    unusable); the NaN rows are what lets a trainer see the bad batch.
    The rows are taken by ``F.embedding``, which DTensor carries on a
    vocab-sharded table; a table also sharded along its rows' width
    (FSDP) is gathered to its vocab sharding first, as FSDP gathers a
    weight before its use."""
    vocab = table.shape[0]
    if isinstance(table, DTensor):
        table = table.redistribute(table.device_mesh, [
            p if p.is_shard() and p.dim == 0 else L.Replicate()
            for p in table.placements])
    idx = tokens.long()
    valid = (idx >= -vocab) & (idx < vocab)
    idx = torch.where(idx < 0, idx + vocab, idx).clamp(0, vocab - 1)
    return F.embedding(idx, table).to(dtype).masked_fill(~valid[..., None],
                                                         float("nan"))


def embed_inputs(params: Params, batch: Dict[str, torch.Tensor],
                 cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token embedding (:func:`embed`), behind the vision prefix
    ``batch["patches"]`` (B, P, D) cast to ``cfg.dtype`` where the config
    has one. Returns (x (B,S,D), positions (B,S)), S = P + T."""
    x = embed(params["embed"], batch["tokens"], cfg.dtype)
    if cfg.vision_prefix:
        x = torch.cat([batch["patches"].to(cfg.dtype), x], dim=1)
    x = constrain_batch(x)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    return x, positions


def _run_stack(x, layers: List[Params], cfg: ArchConfig, positions,
               causal: bool, use_kernel: bool, train: bool,
               enc_out: Optional[torch.Tensor] = None):
    """The layer stack. Returns (x, aux summed (fp32), per-layer cache
    entries; {} in training).  With ``enc_out`` each layer's cross part
    attends to its keys and values, projected here once a layer and kept
    in the layer's entry as ``xk``/``xv``.  In training with
    ``cfg.remat`` each block runs under ``torch.utils.checkpoint``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for p, (mixer, ffn) in zip(layers, cfg.layer_kinds()):
        enc_kv = (cross_kv(p, enc_out, cfg)
                  if enc_out is not None and "cross" in p else None)
        x = constrain_batch(x)
        if not train:
            x, aux_i, cache = _apply_block(x, p, cfg, mixer, ffn, positions,
                                           causal, use_kernel,
                                           enc_kv=enc_kv)
            x = constrain_batch(x)
            if aux_i is not None:
                aux = aux + aux_i
            if enc_kv is not None:
                cache["xk"], cache["xv"] = enc_kv
            caches.append(cache)
            continue
        block = functools.partial(_train_block, p=p, cfg=cfg, mixer=mixer,
                                  ffn=ffn, positions=positions, causal=causal,
                                  use_kernel=use_kernel, enc_kv=enc_kv)
        # the block draws no random numbers: no RNG state to keep
        x, aux_i = (checkpoint(block, x, use_reentrant=False,
                               preserve_rng_state=False)
                    if cfg.remat and torch.is_grad_enabled() else block(x))
        x = constrain_batch(x)
        aux = aux + aux_i
        caches.append({})
    return x, aux, caches


def cross_kv(p: Params, enc_out: torch.Tensor, cfg: ArchConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decoder layer's cross keys and values from the encoder's output
    (B, F, D): its ``cross`` part's ``wk``/``wv``, no bias, no rope; each
    (B, F, HKV, D)."""
    b, f, _ = enc_out.shape
    return tuple(L.dense(enc_out, p["cross"][w]).reshape(
        b, f, cfg.n_kv_heads, cfg.head_dim) for w in ("wk", "wv"))


def embed_frames(batch: Dict[str, torch.Tensor], cfg: ArchConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder's input: ``batch["frames"]`` (B, F, D) (the frontend
    stub's) cast to ``cfg.dtype`` plus sinusoidal positions in that dtype.
    Returns (x (B,F,D), positions (B,F))."""
    frames = batch["frames"].to(cfg.dtype)
    b, f, _ = frames.shape
    x = frames + L.sinusoidal_positions(f, cfg.d_model, cfg.dtype,
                                        frames.device)
    return x, torch.arange(f, device=x.device).expand(b, f)


def encode(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
           use_kernel: bool = True, train: bool = False) -> torch.Tensor:
    """Whisper-style encoder over precomputed frames (:func:`embed_frames`):
    the non-causal encoder stack (:func:`encoder_config`), then
    ``enc_ln``. Returns (B, F, D)."""
    x, pos = embed_frames(batch, cfg)
    x, _, _ = _run_stack(x, params["enc_layers"], encoder_config(cfg), pos,
                         False, use_kernel, train)
    return L.rmsnorm(x, params["enc_ln"], use_kernel=use_kernel)


def hidden_states(params: Params, batch: Dict[str, torch.Tensor],
                  cfg: ArchConfig, use_kernel: bool = True,
                  train: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             List[Dict[str, torch.Tensor]]]:
    """Forward to the final normed hidden states. Returns (h, aux: the MoE
    layers' load-balance losses summed (fp32, 0 without MoE), per-layer
    cache entries (:func:`_apply_block`, plus ``xk``/``xv`` of an
    encoder-decoder; {} in training)).

    ``train``: the training forward.  Attention goes through
    ``L.chunked_attention`` (the reference's training attention, with its
    custom backward), no cache is kept, and with ``cfg.remat`` each block
    (the encoder's too) runs under ``torch.utils.checkpoint``
    (non-reentrant): the backward recomputes one block at a time, as the
    reference's nested remat does (for a period of one block, its outer
    remat of the period adds nothing).  ``enc_ln`` and the final norm are
    not recomputed."""
    check_supported(cfg)
    x, positions = embed_inputs(params, batch, cfg)
    enc_out = (encode(params, batch, cfg, use_kernel, train)
               if cfg.enc_dec else None)
    x, aux, caches = _run_stack(x, params["layers"], cfg, positions, True,
                                use_kernel, train, enc_out)
    return (L.rmsnorm(x, params["final_ln"], cfg.rms_norm_eps,
                      use_kernel=use_kernel), aux, caches)


def _xent_chunk(h: torch.Tensor, lm_head: torch.Tensor,
                labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    # a vocab-sharded DTensor's logits gathered: each rank's rows whole
    logits = L.whole_rows(torch.matmul(h, lm_head.to(h.dtype)).float())
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long().clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - gold) * mask).sum(), mask.sum()


def chunked_xent(h: torch.Tensor, lm_head: torch.Tensor,
                 labels: torch.Tensor, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross entropy over sequence chunks: never materializes (B, S, V).

    labels < 0 are masked.  Returns (sum_nll, n_tokens), fp32.  Under grad
    mode each chunk runs under ``torch.utils.checkpoint``, so one
    (B, chunk, V) fp32 logits chunk is live at a time in the backward too
    (the reference's ``jax.checkpoint`` of its scan body).  The last chunk
    may be short where the reference pads it with masked labels: the
    padded positions add nothing to either sum."""
    s = h.shape[1]
    chunk = min(chunk, s)
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, chunk):
        args = (constrain_batch(h[:, i:i + chunk]), lm_head,
                labels[:, i:i + chunk])
        n, c = (checkpoint(_xent_chunk, *args, use_reentrant=False,
                           preserve_rng_state=False)
                if torch.is_grad_enabled() else _xent_chunk(*args))
        nll, cnt = nll + n, cnt + c
    return nll, cnt


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            use_kernel: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss: mean next-token NLL over the unmasked labels
    (never the vision prefix's positions) plus the MoE layers' summed
    load-balance loss, weighted by ``cfg.aux_loss_weight / n_layers`` (0
    without MoE).  Returns (total, {"nll", "aux", "tokens"}).

    The reference casts h's cotangent back to h's dtype (``_grad_cast``)
    so that its fp32 loss math does not promote the backward's residual
    stream to fp32; here nothing is needed: the gradient autograd returns
    through ``.to()`` / ``.float()`` is already in the input's dtype.
    ``use_kernel=False`` runs the norms' plain path (the estimator's on
    the ``meta`` device)."""
    h, aux, _ = hidden_states(params, batch, cfg, use_kernel=use_kernel,
                              train=True)
    labels = batch["labels"]
    if cfg.vision_prefix:   # loss only over the text segment
        pad = torch.full((labels.shape[0], cfg.vision_prefix), -1,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    nll, cnt = chunked_xent(h, params["lm_head"], labels, cfg.loss_chunk)
    loss = nll / torch.clamp(cnt, min=1.0)
    total = loss + cfg.aux_loss_weight * aux / max(cfg.n_layers, 1)
    return total, {"nll": loss, "aux": aux, "tokens": cnt}


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
    at a different depth).  A recurrent mixer's entry is its initial
    state (Mamba: zeros, the conv tail in ``cfg.dtype``; mLSTM/sLSTM: the
    stabilizer m at -1e30, sLSTM's n at 1e-6).  An encoder-decoder's
    entries also hold zero ``xk``/``xv`` (B, enc_seq, HKV, D)."""
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
        elif mixer == "mla":
            entry = MLA.init_latent_cache(cfg, batch, max_len, dev)
        elif mixer == "kda":
            entry = KDA.init_state(cfg, batch, dev)
        elif mixer == "mamba":            # d_inner: expand 2
            entry = SSM.init_mamba_state(batch, 2 * cfg.d_model, cfg.d_state,
                                         cfg.dtype, device=dev)._asdict()
        elif mixer == "mlstm":
            entry = SSM.init_mlstm_state(batch, cfg.n_heads, cfg.head_dim,
                                         device=dev)._asdict()
        elif mixer == "slstm":
            entry = SSM.init_slstm_state(batch, cfg.d_model,
                                         device=dev)._asdict()
        if cfg.enc_dec:
            shape = (batch, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim)
            entry["xk"] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
            entry["xv"] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        layers.append(entry)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "layers": layers}


def _decode_block(x, p, cfg: ArchConfig, mixer: str, ffn: str, entry, pos,
                  kv_len: int, use_kernel: bool):
    """One-token block of any mixer but ``mla`` and ``kda``
    (:func:`mla_step_segments` runs those). x: (B,1,D).  Writes the
    cache entry (KV or recurrent state) in place and returns x; an
    encoder-decoder's cross part attends to the entry's ``xk``/``xv``
    over all ``enc_seq``.  ``kv_len``: an
    upper bound of every slot's cache length (decode attention reads no
    further; the mask hides the rest anyway)."""
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
        out = L.cached_attention(q, k, v, entry["k"], entry["v"], pos,
                                 kv_len, cfg, ring=ring, window=window)
        x = x + L.dense(out.reshape(b, 1, -1), p["mix"]["wo"])
    elif mixer in _RECURRENT:
        block, state = _RECURRENT[mixer]
        x, st = block(x, p["mix"], cfg, state(**entry), decode=True,
                      use_kernel=use_kernel)
        for key, t in st._asdict().items():
            entry[key].copy_(t)
    if "cross" in p:
        b = x.shape[0]
        h = L.rmsnorm(x, p["cross"]["ln"], use_kernel=use_kernel)
        q = L.heads(h, p["cross"], "q", cfg.n_heads, cfg.head_dim)
        out = L.decode_attention(q, entry["xk"], entry["xv"], cfg.enc_seq)
        x = x + L.dense(out.reshape(b, 1, -1), p["cross"]["wo"])
    return _ffn(x, p, cfg, ffn, use_kernel)[0]


def mla_step_segments(params: Params, cfg: ArchConfig, cache: Params,
                      io: Dict[str, Any], kv_len: int,
                      use_kernel: bool = True
                      ) -> List[Tuple[Optional[str], Callable[[], None]]]:
    """A decode step of an :class:`MLAConfig` stack as its pieces in
    order: (span name or None, a function of no arguments).  They pass
    the step along in ``io``: ``io["tokens"]`` (B, 1) in, ``io["logits"]``
    (B, V) out.  A prologue (the embedding; :func:`repro_torch.models.
    mla.decode_state` at ``cache["pos"]``: rows, write positions, lengths,
    rope tables), then for each layer its ``mla`` mixer (attention over
    the first ``kv_len`` positions, each slot's up to its own length) or
    ``kda`` mixer (:func:`repro_torch.models.kda.kda_decode` on the
    layer's state) and its FFN, each in a span of its name (another
    mixer runs as :func:`_decode_block`, FFN included, in no span), then
    an epilogue (the final RMSNorm, the head).  The cache's layers are
    written in place; ``cache["pos"]`` is read, never advanced.

    :func:`decode_step` runs them eagerly; a server's
    :class:`repro_torch.models.decode_graphs.DecodeGraphs` captures each
    once as a CUDA graph, at ``kv_len`` the cache's length, and replays
    them in their spans."""
    layers, pos = cache["layers"], cache["pos"]
    cache_len = latent_len(layers)

    def prologue():
        io["x"] = embed(params["embed"], io["tokens"], cfg.dtype)
        io["step"] = MLA.decode_state(pos, cache_len, cfg)

    def mixer(p, entry):
        io["x"] = MLA.mla_decode(io["x"], p["mix"], cfg, entry, io["step"],
                                 kv_len, use_kernel=use_kernel)

    def kda(p, entry):
        io["x"] = KDA.kda_decode(io["x"], p["mix"], cfg, entry,
                                 use_kernel=use_kernel)

    def ffn(p, kind):
        io["x"] = _ffn(io["x"], p, cfg, kind, use_kernel)[0]

    def block(p, kind, entry, ffn_kind):
        io["x"] = _decode_block(io["x"], p, cfg, kind, ffn_kind, entry, pos,
                                kv_len, use_kernel)

    def epilogue():
        h = L.rmsnorm(io["x"], params["final_ln"], cfg.rms_norm_eps,
                      use_kernel=use_kernel)
        io["logits"] = logits_last(params, h, cfg)

    segs: List[Tuple[Optional[str], Callable[[], None]]] = [(None, prologue)]
    for p, (kind, ffn_kind), entry in zip(params["layers"], cfg.layer_kinds(),
                                          layers):
        if kind in ("mla", "kda"):
            segs += [(kind, functools.partial(mixer if kind == "mla" else kda,
                                              p, entry)),
                     (ffn_kind, functools.partial(ffn, p, ffn_kind))]
        else:
            segs.append((None, functools.partial(block, p, kind, entry,
                                                 ffn_kind)))
    return segs + [(None, epilogue)]


def latent_len(layers: List[Params]) -> int:
    """The positions of the first MLA layer's latent cache among a
    cache's ``layers``."""
    return next(e["ckv"].shape[1] for e in layers if "ckv" in e)


def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                cfg: ArchConfig, use_kernel: bool = True,
                kv_len: Optional[int] = None, graphs=None
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step. tokens: (B, 1) -> (logits (B, V), cache).  The
    cache's layers are updated in place; the returned cache holds them and
    ``pos + 1``, a new tensor.  ``kv_len``: the cache positions attention
    reads (default the furthest slot's, one host sync a step; a caller
    without values, as on the ``meta`` device, passes the cache's length).
    An :class:`MLAConfig` stack runs :func:`mla_step_segments` in order.

    ``graphs``: a server's :class:`repro_torch.models.decode_graphs.
    DecodeGraphs` for this cache, or None.  Where it engages (an
    MLAConfig of ``mla``/``kda`` layers on CUDA, ``moe.route_replay``
    off) and the call leaves ``use_kernel`` and ``kv_len`` at their
    defaults, the step replays those segments' CUDA graphs instead, at
    ``kv_len`` the cache's length: then ``pos`` advances in place (the
    returned cache holds the same tensor), and the logits are the graphs'
    static buffer, overwritten by the next step.  With ``graphs`` given,
    the ambient tracer counts ``decode.graph_replays`` or
    ``decode.eager_steps``."""
    check_supported(cfg)
    if graphs is not None:
        counter = obs.current().metrics.counter
        if use_kernel and kv_len is None and graphs.engages(tokens):
            counter("decode.graph_replays").inc()
            return graphs.step(params, cache, tokens)
        counter("decode.eager_steps").inc()
    pos = cache["pos"]
    if kv_len is None:
        kv_len = int(SH.whole(pos).max()) + 1
    if isinstance(cfg, MLAConfig):
        io = {"tokens": tokens}
        for name, fn in mla_step_segments(params, cfg, cache, io, kv_len,
                                          use_kernel):
            with MLA.span(name):
                fn()
        return io["logits"], {"pos": pos + 1, "layers": cache["layers"]}
    x = embed(params["embed"], tokens, cfg.dtype)
    for p, (mixer, ffn), entry in zip(params["layers"], cfg.layer_kinds(),
                                      cache["layers"]):
        x = _decode_block(x, p, cfg, mixer, ffn, entry, pos, kv_len,
                          use_kernel)
    h = L.rmsnorm(x, params["final_ln"], cfg.rms_norm_eps,
                  use_kernel=use_kernel)
    return logits_last(params, h, cfg), {"pos": pos + 1,
                                         "layers": cache["layers"]}


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            max_len: int, use_kernel: bool = True
            ) -> Tuple[torch.Tensor, Params]:
    """Prefill: full forward, build a decode cache padded to ``max_len``.
    Its length and ``pos`` count the vision prefix (P + T); ``xk``/``xv``
    and a recurrent or KDA layer's state pass through as they are."""
    h, _, caches = hidden_states(params, batch, cfg, use_kernel=use_kernel)
    b, s = h.shape[0], h.shape[1]
    layers = []
    for entry, (mixer, _) in zip(caches, cfg.layer_kinds()):
        if mixer in ("attn", "swa"):
            c = _cache_seq_len(cfg, mixer, max_len)
            k, v = entry["k"], entry["v"]                 # (B, S, KV, Dh)
            if c >= s:   # zeros after the prompt, up to max_len
                entry = dict(entry, k=F.pad(k, (0, 0, 0, 0, 0, c - s)),
                             v=F.pad(v, (0, 0, 0, 0, 0, c - s)))
            else:  # ring: keep the last c tokens, rotated so that
                   # slot (s % c) is the oldest (next write target)
                idx = (torch.arange(c, device=k.device) - s % c) % c
                entry = dict(entry, k=k[:, s - c:][:, idx],
                             v=v[:, s - c:][:, idx])
        elif mixer == "mla":   # zeros after the prompt, up to max_len
            entry = {key: F.pad(t, (0, 0, 0, max_len - s))
                     for key, t in entry.items()}
        layers.append(entry)
    logits = logits_last(params, h, cfg)
    pos = torch.full((b,), s, dtype=torch.int32, device=h.device)
    return logits, {"pos": pos, "layers": layers}
