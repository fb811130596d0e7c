"""Step builders: train_step / serve_step / prefill.

The counterpart of the reference's ``repro.train.steps``.  Each builder
takes an ``ArchConfig`` (+ ``TrainConfig``) and returns a plain callable:
PyTorch runs eagerly, so there is nothing to jit.  Where the reference's
train step returns new (params, opt_state), the port's updates the
parameter and moment tensors in place and returns the metrics; the step
reads nothing back to the host, so a loop of steps on the card
synchronizes only where its caller reads a metric.

The sharded builders (``build_sharded_*``) are the reference's jitted
steps with explicit in/out shardings, over a ``DeviceMesh``: their
callables take and return DTensor trees placed by
``repro_torch.dist.sharding`` (``param_shardings``, ``batch_specs``,
``cache_shardings``), set the activations' batch axes as the reference
does, and run the same step functions, DTensor dispatching each op (plain
tensors in the model, such as positions, count as replicated).  Each
returns ``(callable, {"params": ..., "opt" or "cache": ...})``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.dist import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.optim.adam import (Adam, cosine_schedule, global_norm,
                                    placed_like)
from repro_torch.train.checkpoint import flatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    grad_accum: int = 1            # microbatches, gradients summed in fp32
    moment_dtype: Optional[torch.dtype] = None  # torch.bfloat16 halves them
    seed: int = 0


def trainable(params: T.Params) -> List[torch.Tensor]:
    """The parameter tensors in the checkpoint's leaf order
    (:func:`~repro_torch.train.checkpoint.flatten`), each marked as
    requiring grad."""
    return [t.requires_grad_(True) for _, t in flatten(params)]


def make_optimizer(tc: TrainConfig, params: T.Params) -> Adam:
    """The reference's optimizer over ``params`` (marked trainable): Adam
    with the cosine schedule, weight decay, global-norm clipping and
    ``tc.moment_dtype`` moments."""
    return Adam(trainable(params),
                lr=cosine_schedule(tc.lr, tc.warmup_steps, tc.total_steps),
                weight_decay=tc.weight_decay, grad_clip_norm=tc.grad_clip,
                moment_dtype=tc.moment_dtype)


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (``SyntheticLM``) or tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _value_and_grad(params: T.Params, leaves: List[torch.Tensor],
                    batch: Dict[str, torch.Tensor], cfg: T.ArchConfig,
                    use_kernel: bool = True
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                               Tuple[torch.Tensor, ...]]:
    loss, metrics = T.loss_fn(params, batch, cfg, use_kernel)
    grads = torch.autograd.grad(loss, leaves)
    # a DTensor gradient at its parameter's placement (a pending partial
    # sum reduced), so the norm and the update read whole values
    grads = tuple(placed_like(g, p) for g, p in zip(grads, leaves))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def train_step_fn(cfg: T.ArchConfig, tc: TrainConfig,
                  use_kernel: bool = True
                  ) -> Callable[[T.Params, Adam, Dict[str, Any]],
                                Dict[str, torch.Tensor]]:
    """Returns f(params, opt, batch) -> metrics {loss, nll, grad_norm, ...}
    (0-dim tensors on the parameters' device); ``opt`` is
    :func:`make_optimizer`'s over the same params, updated in place with
    them.

    ``grad_accum > 1`` splits the batch into that many microbatches along
    its first axis and sums their gradients into fp32 buffers, as the
    reference's scan sums into fp32 zeros, then divides by ``grad_accum``;
    the loss is the microbatches' mean and ``nll`` equals it.
    ``grad_norm`` is the global norm of the unclipped gradients.
    ``use_kernel=False`` runs the norms' plain path."""

    def step(params: T.Params, opt: Adam,
             batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        leaves = opt.params
        batch = to_device(batch, leaves[0].device)
        if tc.grad_accum > 1:
            n = next(iter(batch.values())).shape[0] // tc.grad_accum
            acc = [torch.zeros_like(p, dtype=torch.float32).detach()
                   for p in leaves]
            total = torch.zeros((), dtype=torch.float32,
                                device=leaves[0].device)
            for i in range(tc.grad_accum):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                loss, _, grads = _value_and_grad(params, leaves, mb, cfg,
                                                 use_kernel)
                for a, g in zip(acc, grads):
                    a.add_(g)
                total = total + loss
                del grads
            grads = [a.div_(tc.grad_accum) for a in acc]
            loss = total / tc.grad_accum
            metrics = {"nll": loss}
        else:
            loss, metrics, grads = _value_and_grad(params, leaves, batch,
                                                   cfg, use_kernel)
        grad_norm = global_norm(grads)
        opt.step(list(grads))
        return dict(metrics, loss=loss, grad_norm=grad_norm)

    return step


def serve_step_fn(cfg: T.ArchConfig) -> Callable:
    """f(params, cache, tokens (B, 1)) -> (logits (B, V), cache), without
    autograd (the flash and GEMM kernels are forward-only)."""

    @torch.no_grad()
    def step(params, cache, tokens):
        return T.decode_step(params, cache, tokens, cfg)

    return step


def prefill_fn(cfg: T.ArchConfig, max_len: int) -> Callable:
    """f(params, batch) -> (last-position logits, decode cache), without
    autograd."""

    @torch.no_grad()
    def step(params, batch):
        return T.prefill(params, batch, cfg, max_len)

    return step


# --------------------------------------------------------------------------
# Sharded builders over a DeviceMesh
# --------------------------------------------------------------------------

def _place_batch(batch: Dict[str, Any], mesh,
                tp_axis: str = "model") -> Dict[str, torch.Tensor]:
    """A global batch (numpy arrays or tensors, the same on every rank) as
    DTensors on ``mesh`` placed by ``batch_specs``: each rank keeps its
    rows."""
    tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
    return SH.distribute_tree(tensors, SH.batch_specs(
        tensors, SH.mesh_shape(mesh), tp_axis), mesh)


def _set_axes(mesh, batch: int, rules: SH.ShardingRules,
              seq: bool = True) -> None:
    shape = SH.mesh_shape(mesh)
    T.set_batch_axes(
        SH.fit_axes(batch, SH.data_axes(shape, rules.tp_axis), shape),
        seq_axis=rules.tp_axis if seq and rules.sequence_parallel else None,
        seq_divisor=SH.axis_size(shape, rules.tp_axis),
        tp_axis=rules.tp_axis)


def build_sharded_train_step(cfg: T.ArchConfig, tc: TrainConfig, mesh,
                             rules: SH.ShardingRules = SH.ShardingRules(),
                             abstract_params=None):
    """:func:`train_step_fn` over a ``DeviceMesh``.  Returns ``(make,
    {"params", "opt"})``: ``make(batch_like)`` sets the batch axes for that
    batch's size (and the sequence axis under ``rules.sequence_parallel``)
    and returns ``step(params, opt, batch) -> metrics``, where params are
    DTensors placed by ``param_shardings`` (:func:`SH.distribute_tree`),
    ``opt`` is :func:`make_optimizer`'s over them (its moments take their
    placements; ``"opt"`` names them as the reference's ``AdamState``) and
    ``batch`` is the global batch, placed here by ``batch_specs`` (or
    already placed).  The metrics are whole tensors, the same on every
    rank."""
    if abstract_params is None:
        abstract_params = T.abstract_params(cfg)
    shape = SH.mesh_shape(mesh)
    p_sh = SH.param_shardings(abstract_params, shape, cfg, rules)
    o_sh = {"step": SH.NamedSharding(shape, ()), "mu": p_sh, "nu": p_sh}
    step = train_step_fn(cfg, tc)

    def make(batch_like: Dict[str, Any]):
        b = next(iter(batch_like.values())).shape[0]

        def sharded(params: T.Params, opt: Adam,
                    batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
            _set_axes(mesh, b, rules)
            if not isinstance(next(iter(batch.values())), DTensor):
                batch = _place_batch(batch, mesh, rules.tp_axis)
            with implicit_replication():
                return {k: SH.whole(v)
                        for k, v in step(params, opt, batch).items()}

        return sharded

    return make, {"params": p_sh, "opt": o_sh}


def build_sharded_serve_step(cfg: T.ArchConfig, mesh,
                             rules: SH.ShardingRules = SH.ShardingRules(),
                             abstract_params=None, abstract_cache=None,
                             batch: int = 1, max_len: int = 1024):
    """:func:`serve_step_fn` over a ``DeviceMesh``.  Returns ``(step,
    {"params", "cache"})``: ``step(params, cache, tokens (B, 1))`` ->
    (logits (B, V), a whole fp32 tensor on every rank; the cache), the
    cache's DTensors (``cache_shardings``; :func:`build_sharded_prefill`
    makes them) written in place; tokens are placed by ``batch_sharding``
    here unless they already are DTensors."""
    if abstract_params is None:
        abstract_params = T.abstract_params(cfg)
    if abstract_cache is None:
        abstract_cache = T.init_cache(cfg, batch, max_len, device="meta")
    shape = SH.mesh_shape(mesh)
    p_sh = SH.param_shardings(abstract_params, shape, cfg, rules)
    c_sh = SH.cache_shardings(abstract_cache, shape, cfg, rules)
    tok_sh = SH.batch_sharding(shape, batch, 1, rules.tp_axis)
    step = serve_step_fn(cfg)

    def sharded(params: T.Params, cache: T.Params, tokens):
        # decode steps are one token long: the sequence axis is unused
        _set_axes(mesh, batch, rules, seq=False)
        if not isinstance(tokens, DTensor):
            tokens = SH.distribute_tree(torch.as_tensor(tokens), tok_sh,
                                        mesh)
        with implicit_replication():
            logits, cache = step(params, cache, tokens)
        return logits.full_tensor(), cache

    return sharded, {"params": p_sh, "cache": c_sh}


def build_sharded_prefill(cfg: T.ArchConfig, mesh, max_len: int,
                          rules: SH.ShardingRules = SH.ShardingRules(),
                          abstract_params=None):
    """:func:`prefill_fn` over a ``DeviceMesh``.  Returns ``(make,
    {"params"})``: ``make(batch_like)`` sets the batch axes and returns
    ``step(params, batch)`` -> (last-position logits, a whole fp32 tensor
    on every rank; the decode cache as DTensors placed by
    ``cache_shardings``, ready for :func:`build_sharded_serve_step`)."""
    if abstract_params is None:
        abstract_params = T.abstract_params(cfg)
    shape = SH.mesh_shape(mesh)
    p_sh = SH.param_shardings(abstract_params, shape, cfg, rules)
    step = prefill_fn(cfg, max_len)

    def make(batch_like: Dict[str, Any]):
        b = next(iter(batch_like.values())).shape[0]

        def sharded(params: T.Params, batch: Dict[str, Any]):
            _set_axes(mesh, b, rules)
            if not isinstance(next(iter(batch.values())), DTensor):
                batch = _place_batch(batch, mesh, rules.tp_axis)
            with implicit_replication():
                logits, cache = step(params, batch)
            c_sh = SH.cache_shardings(cache, shape, cfg, rules)
            return logits.full_tensor(), SH.tree_map_with(
                lambda t, sh: _placed(t, sh, mesh), cache, c_sh)

        return sharded

    return make, {"params": p_sh}


def _placed(t: torch.Tensor, sh: SH.NamedSharding, mesh) -> DTensor:
    """``t`` at ``sh``'s placement on ``mesh``: a DTensor redistributed,
    a plain tensor (the same on every rank) distributed."""
    if isinstance(t, DTensor):
        return t.redistribute(mesh, SH.to_placements(sh, mesh))
    return SH.distribute_tree(t, sh, mesh)
