"""Adam with global-norm clipping, bit-for-bit the reference's update rule.

``torch.optim.Adam`` plus ``clip_grad_norm_`` would differ from the
reference: the clip there is ``min(1, clip / (norm + 1e-6))``, here it is
``min(1, clip / (norm + 1e-9))`` as in ``repro/optim/adam.py``, and the
bias-corrected step divides by ``sqrt(vhat) + eps`` exactly as written
there.  The update runs in place on the parameters (the reference returns
new pytrees; in-place saves a copy per step) and never reads a value back
to the host, so a loop of steps on the card does not synchronize.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

import torch


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


@dataclasses.dataclass
class Adam:
    params: List[torch.Tensor]
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = None

    def __post_init__(self):
        self.params = list(self.params)
        self.step_count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None) -> None:
        """One update from ``grads`` (default: each parameter's ``.grad``)."""
        grads = [p.grad for p in self.params] if grads is None else grads
        self.step_count += 1
        if self.grad_clip_norm is not None:
            scale = torch.clamp(
                self.grad_clip_norm / (global_norm(grads) + 1e-9), max=1.0)
            grads = [g * scale for g in grads]
        b1, b2 = self.b1, self.b2
        # bias corrections in float32, as the reference computes them
        t = torch.tensor(float(self.step_count), dtype=torch.float32)
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** t)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** t)
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            delta = self.lr * (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                delta = delta + self.lr * self.weight_decay * p
            p.sub_(delta)
