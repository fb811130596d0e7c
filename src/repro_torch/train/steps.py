"""Step builders: train_step / serve_step / prefill.

The counterpart of the reference's ``repro.train.steps`` on one device.
Each builder takes an ``ArchConfig`` (+ ``TrainConfig``) and returns a
plain callable: PyTorch runs eagerly, so there is nothing to jit.  Where
the reference's train step returns new (params, opt_state), the port's
updates the parameter and moment tensors in place and returns the
metrics; the step reads nothing back to the host, so a loop of steps on
the card synchronizes only where its caller reads a metric.

The mesh-sharded builders (``build_sharded_*``) wait for the device mesh
(ROADMAP Queue 1, item 16).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models import transformer as T
from repro_torch.optim.adam import Adam, cosine_schedule, global_norm
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
            acc = [torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device) for p in leaves]
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
