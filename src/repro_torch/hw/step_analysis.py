"""Per-device dot FLOPs and collective bytes of one step of an LM cell.

The port's counterpart of the reference's ``repro.hw.hlo_analysis``.  The
reference compiles the cell's sharded step and parses the partitioned HLO;
the port has no HLO to parse, so it computes the same per-device numbers
of one step (train, prefill or decode) under a mesh shape, a
``ShardingRules`` and the ShardSpace settings another way.  Two kinds of
number come out:

* **Dot FLOPs are the same program counted another way.**  The port's own
  step (``train_step_fn``: the loss, its backward with remat's recompute,
  Adam; ``prefill``; ``decode_step``) runs on the ``meta`` device under
  ``torch.utils.flop_counter.FlopCounterMode``, on the plain path (no
  kernel runs on ``meta``; the kernels' plain versions do no dot work
  either), at the per-device batch the placement rules give (the batch
  over the data axes).  The model axis splits the program op by op: every
  parameter (and cache leaf) the rules shard over the model axis carries
  that axis's size as its factor, the factor flows through every op to its
  outputs, and each counted op's FLOPs are divided by the largest factor
  among its operands.  A product of a sharded weight (a parameter, or its
  view or cast) with a sharded activation contracts over the sharded dim
  (the row-parallel projection, whose partial sums are all-reduced) and
  has a replicated output, as has a gather from a vocab-sharded table and
  a split of a sharded dim into heads that do not divide the axis (GSPMD
  gathers them); a product of two sharded activations (attention's heads)
  stays sharded, and a write into a view of a buffer shards the buffer.
  This is a model of GSPMD's partitioning only where the model axis
  exceeds 1: a MoE's dispatch and combine einsums, whose operands derive
  from the replicated router, count whole.  With a model axis of 1 the
  count is ``FlopCounterMode``'s of one real step at that batch,
  unchanged.
  Remat's recompute is counted, as the reference's HLO counts it.  Dot
  FLOPs are linear in the number of periods (every layer of a period
  position does the same work), so the program runs at one and two
  periods (and one and two encoder layers) and the count is carried to
  the full depth exactly; a recurrent family's train and prefill steps,
  one Python step a token, run at 2, 3 and 4 tokens and the count is
  carried to ``seq`` by the quadratic through them: a recurrence's dot
  work a token does not depend on its chunk, attention's is quadratic in
  the tokens while it runs one chunk or whole chunks, so this is exact
  (with a MoE's capacity rounding, approximate; ``exact`` says which).
  Gradient accumulation's microbatches are counted as one batch: dot
  FLOPs are linear in the batch (again up to a MoE's capacity).
* **Collective bytes are a model of what XLA would insert** for the
  placement decisions (:func:`collectives`): the tensor-parallel
  all-reduce of each row-parallel projection's output (in the forward and
  again in remat's recompute) and of each column-parallel projection's
  input gradient (in the backward), the gather of q, k and v where the
  heads do not divide the model axis, the vocab-sharded embedding's and
  loss's all-reduces,
  expert-parallel all-to-alls, FSDP's all-gathers of weights (forward,
  backward, recompute) and the gradients' reduce-scatter over the data
  axes (all-reduce without FSDP).  Sequence parallelism replaces each
  activation all-reduce by an all-gather and a reduce-scatter.  Bytes are
  each collective's result bytes a device, as the reference's parser sums
  them, and wire bytes use the reference's ``_WIRE_MULT``.

:func:`analyze` returns ``hlo_analysis.analyze``'s keys
(``weighted_dot_flops``, ``collective_bytes_by_op``,
``collective_counts``, ``wire_bytes_per_device``) so ``roofline.
analyze_cell`` consumes it unchanged; its ``n_computations`` (HLO
computations) has no counterpart and gives way to ``n_ops`` (the aten ops
one counted run dispatched).
"""
from __future__ import annotations

import math
import weakref
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs.shapes import ShapeCell, input_specs
from repro_torch.dist import sharding as SH
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T

_WIRE_MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
              "all-to-all": 1.0, "collective-permute": 1.0}
# ops whose output is replicated whatever their operands' factors: a gather
# from a vocab-sharded table is masked locally and all-reduced
_GATHERS = {torch.ops.aten.index, torch.ops.aten.embedding,
            torch.ops.aten.gather}
_VIEWS = {torch.ops.aten.view, torch.ops.aten._unsafe_view,
          torch.ops.aten.reshape}
_RECURRENT = frozenset({"mamba", "mlstm", "slstm"})


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class ShardedFlopCounter(FlopCounterMode):
    """``FlopCounterMode`` whose count divides each op's FLOPs by the
    largest model-axis factor among its tensor operands (module
    docstring).  ``factors``: (tensor, factor) pairs of the sharded
    leaves; with none, the count is ``FlopCounterMode``'s.  ``record``:
    a dict that, where given, gathers every tensor the run allocates
    (those counted towards ``peak``) by (aten op, dtype, dims at the
    per-device batch, model-axis factor) -> [bytes a device, count]."""

    def __init__(self, factors=(), record: Optional[dict] = None):
        super().__init__(display=False)
        self.factor = WeakIdKeyDictionary()
        self.weight = WeakIdKeyDictionary()    # parameters, views, casts
        for t, f in factors:
            self.weight[t] = True
            if f > 1:
                self.factor[t] = f
        self.n_ops = 0
        self.live = self.peak = 0.0
        self._owned = WeakIdKeyDictionary()
        self.record = record

    def _free(self, nbytes: float) -> None:
        self.live -= nbytes

    def _own(self, t: torch.Tensor, f: int, op=None) -> None:
        """Count a tensor the run allocated (not a view, not an in-place
        result) as live, a device's share of it, until it is freed."""
        if t._base is not None or t in self._owned:
            return
        nbytes = t.numel() * t.element_size() / f
        self._owned[t] = True
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, nbytes)
        if self.record is not None:
            got = self.record.setdefault(
                (str(op), t.dtype, tuple(t.shape), f), [0.0, 0])
            got[0] += nbytes
            got[1] += 1

    def _count_flops(self, func_packet, out, args, kwargs):
        self.n_ops += 1
        ins = list(_tensors((args, kwargs)))
        fs = [self.factor.get(t, 1) for t in ins]
        f = max(fs, default=1)
        weights = [t in self.weight for t in ins]
        dot = func_packet in self.flop_registry
        if dot:
            flops = self.flop_registry[func_packet](*args, **kwargs,
                                                    out_val=out)
            for par in set(self.mod_tracker.parents):
                self.flop_counts[par][func_packet] += (
                    flops if f == 1 else flops / f)
            sharded = [w for w, x in zip(weights, fs) if x > 1]
            if True in sharded and False in sharded:
                f = 1                      # a sharded contraction, reduced
        if func_packet in _GATHERS:
            f = 1
        if (f > 1 and func_packet in _VIEWS and _splits_heads(ins[0], out)
                and out.shape[-2] % f):
            f = 1       # heads that do not divide the axis: gathered whole
        inplace = func_packet.__name__.endswith("_")
        for t in _tensors(out):
            if f > 1:
                self.factor[t] = f
                # a write into a view (``buf[:, cs] = x``) shards its base
                if inplace and t._base is not None:
                    self.factor[t._base] = max(
                        f, self.factor.get(t._base, 1))
            if ins and all(weights) and not dot:
                self.weight[t] = True
            if not inplace:
                self._own(t, f, func_packet)
        return out


def _splits_heads(x: torch.Tensor, out) -> bool:
    """Whether a view cuts x's last dim into (heads > 1, head_dim)."""
    return (isinstance(out, torch.Tensor) and out.dim() == x.dim() + 1
            and out.shape[-2] > 1 and out.shape[:-2] == x.shape[:-1]
            and out.shape[-2] * out.shape[-1] == x.shape[-1])


def _tp_factor(sh: SH.NamedSharding, tp_axis: str) -> int:
    return math.prod(SH.axis_size(sh.mesh, a) for a in sh.spec
                     if a == tp_axis or (isinstance(a, tuple)
                                         and tp_axis in a))


def local_batch(cfg, shape: ShapeCell, mesh: SH.Mesh, rules,
                batch: Optional[int] = None) -> int:
    """The per-device batch: the global batch over the data axes its
    placement (``batch_specs``) gives."""
    b = batch or shape.global_batch
    spec = SH.batch_sharding(mesh, b, shape.seq, rules.tp_axis).spec
    return b // SH.axis_size(mesh, spec[0])


def _train_config(settings: Dict[str, Any]):
    """The counted step's TrainConfig: the settings' moment dtype, and one
    microbatch (dot FLOPs are linear in the batch, so splitting it adds
    none; with a dropping MoE the capacity's rounding makes that
    approximate)."""
    from repro_torch.train import steps as S
    moments = (torch.float32 if settings.get("moment_dtype") == "float32"
               else torch.bfloat16)
    return S.TrainConfig(moment_dtype=moments)


def _count(cfg, shape: ShapeCell, mesh: SH.Mesh, rules, settings,
           b_loc: int, record: Optional[dict] = None,
           tc=None) -> Dict[str, float]:
    """One counted run of the cell's step at per-device batch ``b_loc``
    on ``meta``: its dot FLOPs, the ops it dispatched and the peak bytes
    of the tensors it allocated (a device's share of each).  ``record``
    and ``tc`` (a training step's ``TrainConfig``, default
    :func:`_train_config`'s) pass to :class:`ShardedFlopCounter` and
    the step."""
    from repro_torch.train import steps as S
    params = T.abstract_params(cfg)
    sh = SH.param_shardings(params, mesh, cfg, rules)
    factors = [(t, _tp_factor(s, rules.tp_axis)) for t, s in zip(
        SH.tree_leaves(params), SH.tree_leaves(sh))]
    spec = input_specs(cfg, shape, batch_override=b_loc)
    if shape.kind == "train":
        tc = tc or _train_config(settings)
        opt = S.make_optimizer(tc, params)
        step = S.train_step_fn(cfg, tc, use_kernel=False)
        with ShardedFlopCounter(factors, record) as fc:
            step(params, opt, spec)
    elif shape.kind == "prefill":
        with torch.no_grad(), ShardedFlopCounter(factors, record) as fc:
            T.prefill(params, spec, cfg, shape.seq, use_kernel=False)
    else:
        cache = spec["cache"]
        csh = SH.cache_shardings(cache, mesh, cfg, rules)
        factors += [(t, _tp_factor(s, rules.tp_axis)) for t, s in zip(
            SH.tree_leaves(cache), SH.tree_leaves(csh))]
        with torch.no_grad(), ShardedFlopCounter(factors, record) as fc:
            T.decode_step(params, cache, spec["tokens"], cfg,
                          use_kernel=False, kv_len=shape.seq)
    return {"dot_flops": float(fc.get_total_flops()), "n_ops": fc.n_ops,
            "temp_bytes": fc.peak}


def _by_depth(cfg, count) -> Tuple[Dict[str, float], list]:
    """``count(cfg')`` carried from one and two periods (and encoder
    layers) to ``cfg``'s depth: dot FLOPs and ops are linear in each (the
    peak bytes are carried the same way, an estimate).  Returns (the
    carried numbers, the decoder depths run)."""
    period = len(cfg.pattern)
    repeats = cfg.n_layers // period
    enc = cfg.n_enc_layers
    base = cfg.with_(n_layers=period, n_enc_layers=min(enc, 1))
    c0 = count(base)
    out, runs = dict(c0), [base.n_layers]
    for more, cfg2 in ((repeats - 1, base.with_(n_layers=2 * period)),
                       (enc - 1, base.with_(n_enc_layers=2))):
        if more > 0:
            c1 = count(cfg2)
            for k in out:
                out[k] += more * (c1[k] - c0[k])
            runs += [cfg2.n_layers] if cfg2.n_layers != base.n_layers else []
    return out, runs


def dot_flops(cfg, shape: ShapeCell, mesh: SH.Mesh, rules,
              settings: Dict[str, Any], b_loc: int) -> Dict[str, Any]:
    """The per-device dot FLOPs of one step (module docstring), with how
    they were counted."""
    recurrent = any(m in _RECURRENT for m, _ in cfg.pattern)
    s = shape.seq
    seqs = [s]
    # the quadratic through 2, 3 and 4 tokens holds at s when s runs whole
    # recurrence chunks and whole attention chunks (or one); a single
    # token is special (Mamba's conv tail is then zero-filled)
    if recurrent and shape.kind != "decode" and s > 4 \
            and s % min(cfg.ssm_chunk, s) == 0 \
            and (s <= cfg.attn_chunk or s % cfg.attn_chunk == 0):
        seqs = [2, 3, 4]
    got = [_by_depth(cfg, lambda c, s=s: _count(
        c, ShapeCell(shape.name, shape.kind, s, shape.global_batch), mesh,
        rules, settings, b_loc)) for s in seqs]
    out = dict(got[0][0])
    if len(seqs) == 3:      # Newton's forward differences to seq
        u = float(s - seqs[0])
        c1, c2, c3 = (g[0] for g in got)
        out = {k: c1[k] + u * (c2[k] - c1[k])
               + u * (u - 1.0) / 2.0 * (c3[k] - 2 * c2[k] + c1[k])
               for k in c1}
    out["n_ops"] = int(round(out["n_ops"]))
    moe = any(f == "moe" for _, f in cfg.pattern)
    split = shape.kind == "train" and int(settings.get("grad_accum", 1)) > 1
    return dict(out, counted_seq=seqs, counted_layers=got[0][1],
                exact=not moe or (len(seqs) == 1 and not split))


# ------------------------------------------------------------- collectives

class _Tally:
    def __init__(self):
        self.bytes: Dict[str, float] = {}
        self.counts: Dict[str, float] = {}

    def add(self, op: str, nbytes: float, count: float = 1.0) -> None:
        if count <= 0 or nbytes <= 0:
            return
        self.bytes[op] = self.bytes.get(op, 0.0) + nbytes * count
        self.counts[op] = self.counts.get(op, 0.0) + count


def _sharded_on(sh: SH.NamedSharding, tp_axis: str, dim: int = None) -> bool:
    dims = range(len(sh.spec)) if dim is None else [dim]
    return any(sh.spec[d] == tp_axis for d in dims)


def _tp_features(part: Dict[str, Any], shs: Dict[str, SH.NamedSharding],
                 tp_axis: str) -> Tuple[int, int]:
    """(column, row) features of a layer part's tensor-parallel matrices:
    the input features of its weights sharded on their output dim (each
    input's gradient is all-reduced in the backward) and the output
    features of those sharded on their contraction dim (each output is
    all-reduced)."""
    col = row = 0
    for name, s in shs.items():
        if len(s.spec) >= 2:
            shape = part[name].shape
            col += shape[-2] if s.spec[-1] == tp_axis else 0
            row += shape[-1] if s.spec[-2] == tp_axis else 0
    return col, row


def collectives(cfg, shape: ShapeCell, mesh: SH.Mesh, rules,
                settings: Dict[str, Any], b_loc: int,
                params=None, shardings=None) -> Dict[str, Any]:
    """The modelled collectives of one step a device (module docstring).
    Returns {"bytes_by_op", "counts"}."""
    params = T.abstract_params(cfg) if params is None else params
    sh = (SH.param_shardings(params, mesh, cfg, rules) if shardings is None
          else shardings)
    tp = rules.tp_axis
    m = mesh.get(tp, 1)
    dp = SH.axis_size(mesh, SH.data_axes(mesh, tp))
    train = shape.kind == "train"
    remat = train and cfg.remat
    accum = int(settings.get("grad_accum", 1)) if train else 1
    isz = torch.empty((), dtype=cfg.dtype).element_size()
    seq = 1 if shape.kind == "decode" else shape.seq
    tokens = b_loc * seq / accum                  # a microbatch's, a device
    act = tokens * cfg.d_model * isz
    sp = rules.sequence_parallel and shape.kind != "decode"
    out = _Tally()
    # forward passes a step runs: each microbatch's, and under remat its
    # recompute in the backward
    passes = accum * (2 if remat else 1)

    def activation_reduce(nbytes: float, n: float) -> None:
        if nbytes <= 0:
            return
        if sp:      # Megatron-SP: gather the sequence in, scatter it out
            out.add("all-gather", nbytes, n)
            out.add("reduce-scatter", nbytes / m, n)
        else:
            out.add("all-reduce", nbytes, n)

    if m > 1:
        stacks = [(params["layers"], sh["layers"], cfg.layer_kinds(),
                   tokens)]
        if cfg.enc_dec and shape.kind != "decode":   # decode reads xk/xv
            stacks.append((params["enc_layers"], sh["enc_layers"],
                           T.encoder_config(cfg).layer_kinds(),
                           b_loc * cfg.enc_seq / accum))
        for layers, shs, kinds, n_tok in stacks:
            for p, s, (mixer, ffn) in zip(layers, shs, kinds):
                for part in ("mix", "cross", "ffn"):
                    if part not in s:
                        continue
                    if part == "ffn" and ffn == "moe" and _sharded_on(
                            s["ffn"]["w_down"], tp, 0):
                        n = int(n_tok)
                        g = min(cfg.moe_group_size, max(n, 1))
                        cap = MOE.capacity(g, cfg.moe_top_k, cfg.n_experts,
                                           cfg.moe_capacity_factor)
                        buf = (-(-n // g) * cfg.n_experts * cap
                               * cfg.d_model * isz)
                        # dispatch and combine, each pass and backward
                        out.add("all-to-all", buf,
                                2 * (passes + (accum if train else 0)))
                        continue
                    col, row = _tp_features(p[part], s[part], tp)
                    activation_reduce(n_tok * row * isz, passes)
                    if train:
                        activation_reduce(n_tok * col * isz, accum)
                    if (part == "cross" or mixer in ("attn", "swa")
                            and part == "mix") and col \
                            and cfg.n_heads % m:
                        # q, k, v split into heads the axis cannot hold
                        qkv = n_tok * (cfg.n_heads + 2 * cfg.n_kv_heads) \
                            * cfg.head_dim * isz
                        out.add("all-gather", qkv, passes)
        if _sharded_on(sh["embed"], tp, 0):
            out.add("all-reduce", act, accum)
        if _sharded_on(sh["lm_head"], tp, 1) and train:
            # max, sum and the gold logit over the vocab; dh (serving's
            # logits stay vocab-sharded)
            out.add("all-reduce", tokens * 4, 3 * accum)
            out.add("all-reduce", act, accum)

    for (path, leaf), s in zip(SH._leaves_with_path(params),
                               SH.tree_leaves(sh)):
        local = leaf.numel() * leaf.element_size() / _tp_factor(s, tp)
        fsdp = SH.shard_factor(s) // _tp_factor(s, tp)
        in_layer = path[0] in ("layers", "enc_layers")
        if fsdp > 1:    # gathered before each use, gradients scattered
            uses = (accum * (2 + (1 if remat and in_layer else 0))
                    if train else 1)
            out.add("all-gather", local, uses)
            if train:
                out.add("reduce-scatter", local / fsdp)
                if dp > fsdp:
                    out.add("all-reduce", local / fsdp)
        elif train and dp > 1:
            out.add("all-reduce", local)
    return {"bytes_by_op": out.bytes, "counts": out.counts}


def analyze(cfg, shape: ShapeCell, mesh: SH.Mesh,
            rules: Optional[SH.ShardingRules] = None,
            settings: Optional[Dict[str, Any]] = None,
            batch: Optional[int] = None) -> Dict[str, Any]:
    """Per-device numbers of one step of ``cfg`` at ``shape`` on ``mesh``
    (``hlo_analysis.analyze``'s keys, plus how the FLOPs were counted).
    ``settings``: the ShardSpace knobs the step itself reads
    (``grad_accum``, ``moment_dtype``; ``remat``/``attn_chunk`` arrive
    through ``cfg``); ``batch`` overrides the global batch."""
    rules = rules or SH.ShardingRules()
    settings = settings or {}
    b_loc = local_batch(cfg, shape, mesh, rules, batch)
    flops = dot_flops(cfg, shape, mesh, rules, settings, b_loc)
    coll = collectives(cfg, shape, mesh, rules, settings, b_loc)
    wire = sum(_WIRE_MULT[op] * b for op, b in coll["bytes_by_op"].items())
    return {"weighted_dot_flops": flops["dot_flops"],
            "collective_bytes_by_op": coll["bytes_by_op"],
            "collective_counts": coll["counts"],
            "wire_bytes_per_device": wire,
            "n_ops": flops["n_ops"], "temp_bytes": flops["temp_bytes"],
            "batch_per_device": b_loc,
            "counted_seq": flops["counted_seq"],
            "counted_layers": flops["counted_layers"],
            "exact": flops["exact"]}
