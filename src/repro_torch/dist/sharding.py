"""Sharding rules: ArchConfig + mesh shape + ShardingRules -> placement trees.

The port of the reference's ``repro.dist.sharding``: the single place where
parameter/optimizer/batch/cache placement is decided.  The dry-run
estimator (``repro_torch.launch.dryrun``) and the shard-space autotuner
(``repro_torch.launch.autotune``) consume the functional API here and never
hand-write a spec.

A mesh is data: an ordered mapping from axis name to size
(``{"data": 16, "model": 16}``; ``repro_torch.launch.mesh`` makes them).
A spec is a tuple with one entry a
dim, each ``None``, an axis name or a tuple of names; a
:class:`NamedSharding` pairs it with its mesh.  The trees walked are the
port's own: params ``{"embed", "final_ln", "lm_head", "layers":
[per-layer dict], ...}`` with each layer's leaves unstacked, and the decode
cache ``{"pos", "layers": [entry]}`` (``repro_torch.models.transformer``).
Where the reference's layer leaves carry a leading repeats dim (its
``lax.scan`` axis, never sharded), the port's leaf is one layer's slice of
that stack: its spec is the reference's without that leading ``None``.

Layout policy (Megatron-style TP + optional ZeRO-3 + expert parallelism):

  * **Tensor parallel** (``rules.tp_axis``, default ``"model"``):
      - attention qkv projections are column-parallel (output features
        sharded), the output projection is row-parallel (contraction dim
        sharded) — the pair needs one all-reduce per block;
      - MLPs shard ``w_gate``/``w_up`` column-wise and ``w_down`` row-wise;
      - the embedding shards the *vocab* dim, the LM head its vocab output;
      - MoE FFNs prefer **expert parallelism** (experts split over the model
        axis); when ``n_experts`` does not divide the axis they fall back to
        per-expert tensor parallelism.
  * **Data parallel**: the batch dim of inputs/activations is sharded over
    every non-model mesh axis (``("pod", "data")`` on a multi-pod mesh).
  * **FSDP** (``rules.fsdp_weights``): each large parameter additionally
    shards one remaining unsharded dim over the data axes (ZeRO-3).  The
    size threshold counts the reference's stacked leaf (a layer leaf times
    its stack's repeats), so a layer's leaf shards exactly where the
    reference's stack does.
  * **Sequence parallel** (``rules.sequence_parallel``): the residual
    stream's *sequence* dim is sharded over the model axis between TP
    regions (Megatron-SP).  It changes activation placement only, never
    parameter placement (``repro_torch.hw.step_analysis`` prices it).

Every rule is guarded by a divisibility check (``fit_axes``): a dim that
does not divide the mesh axis is simply left unsharded (e.g. smollm's 15
heads on a 16-way model axis) — the layout degrades, it never errors.

On real devices a placement tree becomes DTensor placements over a
``torch.distributed`` ``DeviceMesh`` whose dim names are the mesh's axes
(:func:`to_placements`, :func:`distribute_tree`; the step builders of
``repro_torch.train.steps``): the counterpart of the reference's
``jax.jit(in_shardings=...)``.  torch is imported there only, so the
rules and the estimator stay importable without it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

Axes = Union[None, str, Tuple[str, ...]]
Mesh = Dict[str, int]
Spec = Tuple[Axes, ...]

# Mesh axes considered data-parallel, in the order batch dims shard over
# them.  Mesh construction (repro_torch.launch.mesh) only ever uses these
# names plus the model axis.
DATA_AXIS_ORDER: Tuple[str, ...] = ("pod", "data")

# Mixers whose state is recurrent (O(1) decode state): sequence parallelism
# interacts badly with their chunked scan (the per-chunk carry would cross
# shard boundaries every step), so the recommended rules disable SP.
_RECURRENT_MIXERS = frozenset({"mamba", "mlstm", "slstm"})
_ATTENTION_MIXERS = frozenset({"attn", "swa"})
_STACKS = ("layers", "enc_layers")


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Declarative knobs the autotuner searches over (``ShardSpace``
    settings map onto exactly these fields)."""

    fsdp_weights: bool = False          # ZeRO-3: shard params over data axes
    sequence_parallel: bool = False     # Megatron-SP residual stream
    tp_axis: str = "model"              # mesh axis used for tensor parallel
    fsdp_min_size: int = 2 ** 16        # leave small params replicated

    @classmethod
    def recommended(cls, cfg) -> "ShardingRules":
        """Default production rules for an ``ArchConfig``.

        Sequence parallelism is ON only for pure-attention stacks: recurrent
        mixers scan over sequence chunks (the carry would cross shard
        boundaries) and MoE FFNs already pay an all-to-all on the token dim.
        FSDP is ON once the parameter body is large enough that replicated
        weights dominate HBM."""
        mixers = {m for m, _ in cfg.pattern}
        ffns = {f for _, f in cfg.pattern}
        pure_attention = mixers <= _ATTENTION_MIXERS
        has_moe = "moe" in ffns or cfg.n_experts > 0
        recurrent = bool(mixers & _RECURRENT_MIXERS)
        sp = pure_attention and not has_moe and not recurrent
        # ~ >1 GiB of bf16 block params: replication stops being free
        big = cfg.n_layers * cfg.d_model * max(
            cfg.d_ff, cfg.d_model) * max(cfg.n_experts, 1) >= 2 ** 29
        return cls(fsdp_weights=big, sequence_parallel=sp)

    def describe(self) -> str:
        return (f"tp={self.tp_axis} fsdp={'on' if self.fsdp_weights else 'off'}"
                f" sp={'on' if self.sequence_parallel else 'off'}")


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh shape (the reference's ``jax.sharding.NamedSharding``
    as data)."""
    mesh: Mesh
    spec: Spec


# ---------------------------------------------------------------------------
# Axis arithmetic
# ---------------------------------------------------------------------------

def axis_size(mesh: Mesh, axes: Axes) -> int:
    """Product of the named mesh axes (missing axes count as 1)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= int(mesh.get(a, 1))
    return n


def data_axes(mesh: Mesh, tp_axis: str = "model") -> Tuple[str, ...]:
    """Mesh axes used for batch/data parallelism, in mesh order."""
    return tuple(a for a in mesh if a != tp_axis and a in DATA_AXIS_ORDER)


def fit_axes(n: int, axes: Axes, mesh: Mesh) -> Axes:
    """Largest dividing subset of ``axes``, kept in axis order — the
    universal divisibility fallback.  Axes absent from ``mesh`` are ignored,
    and an axis that does not divide the remaining factor of ``n`` is
    *skipped*, not a stopping point (n=6 over (pod=4, data=3) -> ("data",)).

    Returns axes in the same general shape they came in: a single name stays
    a name, a sequence comes back as a tuple; ``None`` when nothing fits."""
    if axes is None or n <= 0:
        return None
    single = isinstance(axes, str)
    candidates = (axes,) if single else tuple(axes)
    kept = []
    prod = 1
    for a in candidates:
        size = int(mesh.get(a, 0))
        if size <= 0:
            continue                       # axis absent from this mesh
        if n % (prod * size) == 0:
            kept.append(a)
            prod *= size
    if not kept:
        return None
    if single:
        return kept[0]
    return tuple(kept)


# ---------------------------------------------------------------------------
# Trees (dicts, lists and tuples of tensors or shape-carrying leaves)
# ---------------------------------------------------------------------------

def _is_leaf(x) -> bool:
    return not isinstance(x, (dict, list, tuple))


def _leaves_with_path(tree, path: Tuple[Any, ...] = ()
                      ) -> Iterator[Tuple[Tuple[Any, ...], Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", None)
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (
                fields[i] if fields else i,))
    else:
        yield path, tree


def _map_with_path(fn: Callable, tree, path: Tuple[Any, ...] = ()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", None)
        out = [_map_with_path(fn, v, path + (fields[i] if fields else i,))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if fields else type(tree)(out)
    return fn(path, tree)


def _path_names(path) -> Tuple[str, ...]:
    """A tree path as strings (dict keys, list indices, NamedTuple
    fields)."""
    return tuple(str(p) for p in path)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in leaf.shape)


def _itemsize(leaf) -> int:
    dt = leaf.dtype
    return dt.itemsize if hasattr(dt, "itemsize") else np.dtype(dt).itemsize


def tree_map_with(fn: Callable, tree, other) -> Any:
    """``fn(leaf, other_leaf)`` over two trees of one structure."""
    flat = tree_leaves(other)
    it = iter(flat)
    out = _map_with_path(lambda path, leaf: fn(leaf, next(it)), tree)
    if next(it, None) is not None:
        raise ValueError("tree mismatch: more placements than leaves")
    return out


def tree_leaves(tree) -> List[Any]:
    """Every leaf of a placement or parameter tree, in walk order."""
    return [leaf for _, leaf in _leaves_with_path(tree)]


# ---------------------------------------------------------------------------
# Parameter shardings
# ---------------------------------------------------------------------------

# Column-parallel weights: shard the *output-feature* (last) dim.
_COLUMN = frozenset({
    "wq", "wk", "wv",            # attention qkv
    "w_gate", "w_up", "w_in",    # swiglu / gelu MLP up-projections
    "in_proj", "dt_proj",        # mamba expand + dt
    "wz", "wi", "wf",            # xLSTM input/gate projections
})
# Row-parallel weights: shard the *contraction* (first) dim.
_ROW = frozenset({
    "wo",                        # attention output
    "w_down", "w_out",           # MLP down-projections
    "out_proj",                  # mamba output
    "wo_out",                    # sLSTM output
})
# Biases of column-parallel weights follow their output-feature sharding.
_COLUMN_BIAS = frozenset({"bq", "bk", "bv", "b_in"})
# Mamba per-channel (d_inner-indexed) vectors: aligned with in_proj's output.
_CHANNEL_LAST = frozenset({"conv_w", "conv_b", "dt_bias", "D"})
_CHANNEL_FIRST = frozenset({"A_log"})
# MoE tensors carrying a leading expert dim.
_MOE_EXPERT = frozenset({"w_gate", "w_up", "w_down"})


def _stack_repeats(names: Tuple[str, ...], cfg) -> int:
    """The reference's stack depth for a leaf at ``names``: a decoder
    layer's leaf is one of ``n_layers / period`` repeats, an encoder
    layer's (period 1) one of ``n_enc_layers``; 1 elsewhere."""
    if not names or names[0] not in _STACKS:
        return 1
    if names[0] == "enc_layers":
        return max(int(cfg.n_enc_layers), 1)
    return max(int(cfg.n_layers) // len(cfg.pattern), 1)


def _param_spec(names: Tuple[str, ...], shape: Tuple[int, ...],
                mesh: Mesh, cfg, rules: ShardingRules) -> Spec:
    """Spec for one parameter leaf, identified by its tree path."""
    tp = rules.tp_axis
    ndim = len(shape)
    spec: list = [None] * ndim
    name = names[-1] if names else ""

    if name == "embed" and ndim == 2:
        spec[0] = fit_axes(shape[0], tp, mesh)           # vocab rows
    elif name == "lm_head" and ndim == 2:
        spec[1] = fit_axes(shape[1], tp, mesh)           # vocab cols
    elif name in _MOE_EXPERT and ndim == 3:
        # MoE: (E, d_model, d_ff) / (E, d_ff, d_model)
        if fit_axes(shape[0], tp, mesh) is not None:
            spec[0] = tp                                 # expert parallel
        elif name in ("w_gate", "w_up"):
            spec[2] = fit_axes(shape[2], tp, mesh)
        else:                                            # w_down
            spec[1] = fit_axes(shape[1], tp, mesh)
    elif name in _COLUMN and ndim == 2:
        spec[1] = fit_axes(shape[1], tp, mesh)
    elif name in _ROW and ndim == 2:
        spec[0] = fit_axes(shape[0], tp, mesh)
    elif name in _COLUMN_BIAS and ndim == 1:
        spec[0] = fit_axes(shape[0], tp, mesh)
    elif name in _CHANNEL_LAST and ndim >= 1:
        spec[ndim - 1] = fit_axes(shape[-1], tp, mesh)
    elif name in _CHANNEL_FIRST and ndim == 2:
        spec[0] = fit_axes(shape[0], tp, mesh)
    # everything else (norms, routers, recurrent r-mats): replicated

    stacked = int(np.prod(shape)) * _stack_repeats(names, cfg)
    if rules.fsdp_weights and stacked >= rules.fsdp_min_size:
        dp = data_axes(mesh, tp)
        for d in range(ndim):
            if spec[d] is None:
                ax = fit_axes(shape[d], dp, mesh)
                if ax:
                    spec[d] = ax
                    break
    return tuple(spec)


def param_shardings(params: Any, mesh: Mesh, cfg,
                    rules: Optional[ShardingRules] = None) -> Any:
    """A :class:`NamedSharding` tree matching a parameter tree (real or
    ``meta`` tensors; only shapes are read).  Also the placement of
    gradients and Adam moments, which mirror the params."""
    rules = rules or ShardingRules()
    return _map_with_path(lambda path, leaf: NamedSharding(
        mesh, _param_spec(_path_names(path), _shape(leaf), mesh, cfg,
                          rules)), params)


# ---------------------------------------------------------------------------
# Batch / input shardings
# ---------------------------------------------------------------------------

def batch_sharding(mesh: Mesh, batch: int, seq: int,
                   tp_axis: str = "model") -> NamedSharding:
    """Placement of a single (batch, seq) int token array: the batch over
    the data axes (decode tokens are seq-len 1; seq stays unsharded)."""
    del seq
    return NamedSharding(mesh, (fit_axes(batch, data_axes(mesh, tp_axis),
                                         mesh),))


def batch_specs(batch_tree: Any, mesh: Mesh,
                tp_axis: str = "model") -> Any:
    """Placement tree for a host batch: dim 0 over the data axes.  Leaves
    whose batch does not divide the data axes stay replicated."""
    dp = data_axes(mesh, tp_axis)

    def one(path, leaf):
        shape = _shape(leaf)
        spec = [None] * len(shape)
        if shape:
            spec[0] = fit_axes(shape[0], dp, mesh)
        return NamedSharding(mesh, tuple(spec))

    return _map_with_path(one, batch_tree)


def cache_shardings(cache: Any, mesh: Mesh, cfg,
                    rules: Optional[ShardingRules] = None) -> Any:
    """Placement tree for a decode cache (``transformer.init_cache``).

    The per-sequence batch dim (dim 0 of every entry's leaf) shards over the
    data axes; attention KV caches (B, C, HKV, D) additionally shard the
    kv-head dim over the model axis.  The cache *sequence* dim is never
    sharded: SWA ring-buffer writes land at arbitrary offsets."""
    rules = rules or ShardingRules()
    dp = data_axes(mesh, rules.tp_axis)

    def one(path, leaf):
        names = _path_names(path)
        shape = _shape(leaf)
        spec: list = [None] * len(shape)
        if names and names[0] == "pos":
            spec[0] = fit_axes(shape[0], dp, mesh)
        elif shape:
            spec[0] = fit_axes(shape[0], dp, mesh)
            if len(shape) == 4 and names[-1] in ("k", "v", "xk", "xv"):
                spec[2] = fit_axes(shape[2], rules.tp_axis, mesh)
        return NamedSharding(mesh, tuple(spec))

    return _map_with_path(one, cache)


# ---------------------------------------------------------------------------
# Introspection / validation helpers
# ---------------------------------------------------------------------------

def _paired(abstract: Any, shardings: Any):
    flat_a = list(_leaves_with_path(abstract))
    flat_s = tree_leaves(shardings)
    if len(flat_a) != len(flat_s):
        raise ValueError(
            f"tree mismatch: {len(flat_a)} leaves vs {len(flat_s)} shardings")
    return zip(flat_a, flat_s)


def validate_shardings(abstract: Any, shardings: Any) -> None:
    """Raise unless every spec'd dim divides evenly on its mesh axes (a
    guard for hand-built or deserialized trees)."""
    for (path, leaf), sh in _paired(abstract, shardings):
        if not isinstance(sh, NamedSharding):
            raise TypeError(f"{_path_names(path)}: {type(sh).__name__} "
                            "is not a NamedSharding")
        shape = _shape(leaf)
        for d, axes in enumerate(sh.spec):
            if axes is None:
                continue
            size = axis_size(sh.mesh, axes)
            if shape[d] % size:
                raise ValueError(
                    f"{'/'.join(_path_names(path))}: dim {d} of shape "
                    f"{shape} not divisible by {axes}={size}")


def describe_shardings(abstract: Any, shardings: Any,
                       max_rows: int = 0) -> str:
    """Human-readable placement table (dry-run debugging aid)."""
    rows = []
    for (path, leaf), sh in _paired(abstract, shardings):
        key = "/".join(_path_names(path))
        shape = _shape(leaf)
        spec = tuple(sh.spec) + (None,) * (len(shape) - len(sh.spec))
        rows.append(f"{key:<48} {str(shape):<28} {spec}")
    if max_rows and len(rows) > max_rows:
        rows = rows[:max_rows] + [f"... ({len(rows) - max_rows} more)"]
    return "\n".join(rows)


def shard_factor(sh: NamedSharding) -> int:
    """How many pieces a leaf is cut into: the product of its spec's axis
    sizes."""
    n = 1
    for axes in sh.spec:
        n *= axis_size(sh.mesh, axes)
    return n


def param_bytes_per_device(abstract: Any, shardings: Any) -> int:
    """Per-device resident parameter bytes under a placement tree — the
    number the roofline HBM-residency model cross-checks."""
    total = 0
    for (_, leaf), sh in _paired(abstract, shardings):
        n = int(np.prod(_shape(leaf))) if _shape(leaf) else 1
        total += (n // max(shard_factor(sh), 1)) * _itemsize(leaf)
    return total


# ---------------------------------------------------------------------------
# DTensor placements on a DeviceMesh
# ---------------------------------------------------------------------------

def mesh_shape(device_mesh) -> Mesh:
    """A ``DeviceMesh``'s shape as the mesh these rules read: its dim names
    in order, each with its size."""
    names = device_mesh.mesh_dim_names
    if names is None:
        raise ValueError("the DeviceMesh needs mesh_dim_names (the axes)")
    return {n: int(device_mesh.size(i)) for i, n in enumerate(names)}


def to_placements(named_sharding: NamedSharding, device_mesh) -> tuple:
    """One DTensor placement a mesh dim: ``Shard(d)`` where tensor dim d
    names that axis, ``Replicate()`` elsewhere.  A dim over an axis tuple
    (``("pod", "data")``) takes ``Shard(d)`` on each named mesh dim; the
    tuple must list them in mesh order, JAX's major-to-minor, which is
    DTensor's order of nested shards."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(device_mesh.mesh_dim_names or ())
    shape = mesh_shape(device_mesh)
    for a, n in named_sharding.mesh.items():
        if shape.get(a) != int(n):
            raise ValueError(f"the sharding's mesh {named_sharding.mesh} is "
                             f"not the device mesh's {shape}")
    out = [Replicate()] * len(names)
    for d, axes in enumerate(named_sharding.spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"dim {d} shards over {axes}, not in the mesh's "
                             f"order {tuple(names)}")
        for i in dims:
            out[i] = Shard(d)
    return tuple(out)


def distribute_tree(tree: Any, shardings: Any, device_mesh) -> Any:
    """Every tensor leaf of ``tree`` as a DTensor on ``device_mesh`` placed
    by the matching :class:`NamedSharding` of ``shardings``.  Each rank
    holds the whole tree (the same values: a seeded init, a global batch,
    a checkpoint) and keeps its own shards, moved to the mesh's device;
    a leaf that requires grad stays a leaf that requires grad."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor
    dev = torch.device(device_mesh.device_type, torch.cuda.current_device()
                       if device_mesh.device_type == "cuda" else None)

    def one(leaf, sh):
        if isinstance(leaf, DTensor):
            raise TypeError("distribute_tree takes whole tensors; "
                            "redistribute a DTensor instead")
        t = torch.as_tensor(leaf).detach().to(dev)
        out = distribute_tensor(t, device_mesh,
                                to_placements(sh, device_mesh),
                                src_data_rank=None)
        return out.requires_grad_(True) if getattr(
            leaf, "requires_grad", False) else out

    return tree_map_with(one, tree, shardings)


def whole(t):
    """A DTensor's global value, the same on every rank (a collective: a
    pending partial sum is reduced, shards gathered); a plain tensor as
    it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def copy_whole(dst, src) -> None:
    """Copy the whole tensor ``src`` (any device, cast to ``dst``'s dtype)
    into ``dst`` in place: a plain tensor, or a DTensor's own shards (each
    rank holds all of ``src``, so no collective runs)."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor
    with torch.no_grad():
        if isinstance(dst, DTensor):
            src = distribute_tensor(
                src.detach().to(dst.device), dst.device_mesh,
                dst.placements, src_data_rank=None).to_local()
            dst = dst.to_local()
        dst.copy_(src)
