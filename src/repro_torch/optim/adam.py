"""Adam with global-norm clipping and a cosine schedule, the reference's
update rule (``repro/optim/adam.py``).

``torch.optim.Adam`` plus ``clip_grad_norm_`` would differ from the
reference: the clip there is ``min(1, clip / (norm + 1e-6))``, here it is
``min(1, clip / (norm + 1e-9))`` as in the reference, and the
bias-corrected step divides by ``sqrt(vhat) + eps`` exactly as written
there.  As in the reference:

- the moments are kept in ``moment_dtype`` (default: each parameter's
  dtype) and updated in it, with b1, b2 and their complements rounded to
  it as the reference's weakly typed scalars are;
- the step is formed in fp32 (the moments cast up, ``delta`` in fp32) and
  rounded once to the parameter's dtype;
- a clipped gradient is fp32 (the reference's ``g * scale`` promotes a
  bf16 gradient to its fp32 scale);
- ``lr`` is a number or a callable of the step (:func:`cosine_schedule`).

The update runs in place on the parameters and moments (the reference
returns new pytrees; in place saves a copy a step) and never reads a
value back to the host, so a loop of steps on the card does not
synchronize.  In fp32, which is all the MARL nets use, every line is the
update the port had before the fp32 step and the schedule came in.

Under a device mesh the parameters are DTensors: the moments take their
parameter's placement (``zeros_like``), each gradient is redistributed to
its parameter's placement before the update (autograd returns a
row-parallel weight's gradient as a pending partial sum, a vocab-sharded
embedding's as partial over every axis), :func:`global_norm` sums the
squares over all shards, so the clip is the unsharded step's, and the
elementwise update then runs on each rank's local shards.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Iterable, List, Optional, Union

import torch
from torch.distributed.tensor import DTensor

from repro_torch.dist.sharding import copy_whole, whole


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """The fp32 2-norm of all the tensors together; over DTensors the
    squares of every shard, the same plain scalar on every rank."""
    return torch.sqrt(sum(whole(torch.sum(torch.square(t.float())))
                          for t in tensors))


def placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Gradient ``g`` at parameter ``p``'s placement (a DTensor ``p``);
    plain tensors as they are."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


@functools.lru_cache(maxsize=None)
def _weak(c: float, dtype: torch.dtype) -> float:
    """``c`` as the reference's weakly typed Python scalar meets a tensor
    of ``dtype``: rounded to that dtype (in bf16, b2 = 0.999 becomes 1.0
    and 1 - b2 becomes 0.0010004), then multiplied in the op's fp32 math
    as PyTorch multiplies a Python scalar.  fp32 keeps ``c`` as it is."""
    if dtype == torch.float32:
        return c
    return float(torch.tensor(c, dtype=torch.float32).to(dtype))


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to ``base_lr``, then a cosine decay to ``final_frac``
    of it at ``total_steps``; a function of the step, computed in float32
    as the reference computes it (on the step's device)."""
    def f(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, base_lr * cos)
    return f


@dataclasses.dataclass
class Adam:
    params: List[torch.Tensor]
    lr: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = None
    # dtype of the first/second moments; bf16 moments halve optimizer memory
    moment_dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        self.params = list(self.params)
        self.step_count = 0
        dt = self.moment_dtype
        self.mu = [torch.zeros_like(p, dtype=dt or p.dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=dt or p.dtype)
                   for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _lr(self, step: int):
        """The step's learning rate: the schedule's fp32 value, or the
        number as given (a Python float multiplies an fp32 tensor in
        fp32, as the reference's ``jnp.asarray(lr)`` does)."""
        if callable(self.lr):
            return self.lr(torch.tensor(step, dtype=torch.int32))
        return self.lr

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None) -> None:
        """One update from ``grads`` (default: each parameter's ``.grad``)."""
        grads = [p.grad for p in self.params] if grads is None else grads
        grads = [placed_like(g, p) for g, p in zip(grads, self.params)]
        self.step_count += 1
        scale = None
        if self.grad_clip_norm is not None:
            scale = torch.clamp(
                self.grad_clip_norm / (global_norm(grads) + 1e-9), max=1.0)
        b1, b2 = self.b1, self.b2
        # bias corrections in float32, as the reference computes them
        t = torch.tensor(float(self.step_count), dtype=torch.float32)
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** t)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** t)
        lr = self._lr(self.step_count)
        if isinstance(lr, torch.Tensor):
            lr = lr.to(self.params[0].device)
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            if isinstance(p, DTensor):
                # elementwise from here on, and g, m, v lie at p's
                # placement: each rank updates its own shards in place
                p, g, m, v = (t.to_local() for t in (p, g, m, v))
            if scale is not None:
                g = g.float() * scale
            c1, c2 = _weak(b1, m.dtype), _weak(b2, v.dtype)
            m.mul_(c1).add_(_weak(1 - b1, m.dtype) * g.to(m.dtype))
            v.mul_(c2).add_(_weak(1 - b2, v.dtype)
                            * torch.square(g).to(v.dtype))
            mhat, vhat = m.float() / bc1, v.float() / bc2
            delta = lr * mhat / (torch.sqrt(vhat) + self.eps)
            if self.weight_decay:
                delta = delta + lr * self.weight_decay * p.float()
            if p.dtype == torch.float32:
                p.sub_(delta)
            else:
                p.copy_((p.float() - delta).to(p.dtype))

    def state_dict(self) -> Dict[str, object]:
        """``{"step", "mu", "nu"}``: the step count and the moment tensors
        (the live ones, in parameter order; a checkpoint copies them)."""
        return {"step": self.step_count, "mu": list(self.mu),
                "nu": list(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Copy a :meth:`state_dict`'s moments (whole tensors) into the
        live moment tensors (cast to their dtype and device; a DTensor
        moment takes its own shards) and take its step."""
        for name in ("mu", "nu"):
            live, new = getattr(self, name), state[name]
            if len(new) != len(live):
                raise ValueError(f"{name}: {len(new)} tensors for "
                                 f"{len(live)} parameters")
            for dst, src in zip(live, new):
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"{name}: shape {tuple(src.shape)} for "
                                     f"a parameter of {tuple(dst.shape)}")
                copy_whole(dst, src)
        self.step_count = int(state["step"])
