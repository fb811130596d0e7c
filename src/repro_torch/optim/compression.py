"""int8 error-feedback gradient compression over the data-parallel axis
(the reference's ``repro.optim.compression``).

Each leaf's gradient, plus the error the last step left, is quantized to
int8 against a scale shared by every rank (the max of |g| over the group,
/127); the quantization error is kept and re-injected next step (error
feedback, Seide et al. / 1-bit Adam lineage); the quantized values are
summed over the group and dequantized to the mean.

Where the reference runs this under ``shard_map`` with ``pmax``/``psum``
over a mesh axis, the port runs it with explicit ``torch.distributed``
collectives over the process group of a ``DeviceMesh`` dim.  The
semantics are the reference's, rounding included (``torch.round`` and
``jnp.round`` both round half to even), and so is its wire format: the
sum travels as int32 (the reference's ``psum`` of ``q.astype(int32)``),
so an all-reduce moves as many bytes as an fp32 one, not the quarter its
docstring claims.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.train.checkpoint import flatten, tree_map, unflatten_like


def init_error_state(params: Any) -> Any:
    """fp32 zeros shaped like each parameter, on its device."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


@torch.no_grad()
def compressed_psum_mean(grads: Any, err: Any, group=None
                         ) -> Tuple[Any, Any]:
    """int8-quantized all-reduce mean with error feedback over ``group``
    (default: the whole process group).  ``grads`` and ``err`` are trees
    of one structure (or lists); returns (the synced mean gradients, fp32;
    the new error state), in that structure.  Per leaf::

        g = g.float() + e
        scale = max(all_reduce(max |g|, MAX), 1e-12) * fp32(1 / 127)
        q = clip(round(g / scale), -127, 127)       (int8)
        new_e = g - q * scale                       (rounded once)
        synced = all_reduce(q as int32, SUM) * scale / n

    The scale and the rounded-once error are the reference's arithmetic
    as XLA compiles it (see the comments below).
    """
    n = dist.get_world_size(group)
    synced, new_err = {}, {}
    for (key, g), (ekey, e) in zip(flatten(grads), flatten(err)):
        g = g.float() + e
        # a shared scale, so every rank dequantizes alike
        amax = torch.max(torch.abs(g))
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        # "/ 127" as the reference's compiled step computes it: XLA
        # rewrites the division by a constant into a product with its
        # fp32 reciprocal (the Python scalar is rounded to fp32 here too)
        scale = torch.clamp(amax, min=1e-12) * (1.0 / 127.0)
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        # g - q * scale rounded once, as XLA's fused multiply-subtract
        # computes it (its scalar loop remainders round twice): an int8
        # times an fp32 is exact in fp64, and so is the difference, so its
        # fp32 rounding is the fused result
        new_err[ekey] = (g.double() - q.double() * scale.double()).float()
        summed = q.to(torch.int32)
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        synced[key] = summed.float() * scale / n
    return unflatten_like(grads, synced), unflatten_like(err, new_err)


def make_ddp_compressed_step(loss_fn: Callable, opt, mesh,
                             data_axis: str = "data") -> Callable:
    """Explicit data-parallel training step with the compressed gradient
    all-reduce over ``mesh``'s ``data_axis``.

    The parameters and ``opt`` (an ``Adam`` over them) are plain tensors,
    replicated: every rank holds the same values and applies the same
    synced update.  ``loss_fn(params, batch) -> (loss, metrics)``.
    Returns ``f(params, opt, err, batch) -> (err, loss)``: ``batch`` is the
    global batch (the same on every rank), of which each rank takes its
    rows along dim 0; the parameters and moments are updated in place,
    ``err`` is the new error state and ``loss`` the mean over the group."""
    group = mesh.get_group(data_axis)
    n = dist.get_world_size(group)
    rank = mesh.get_local_rank(data_axis)

    def step(params, opt, err, batch: Dict[str, Any]):
        local = {}
        for k, v in batch.items():
            v = torch.as_tensor(v)
            rows = v.shape[0] // n
            local[k] = v[rank * rows:(rank + 1) * rows].to(
                opt.params[0].device)
        loss, _ = loss_fn(params, local)
        grads = torch.autograd.grad(loss, opt.params)
        synced, err = compressed_psum_mean(list(grads), err, group)
        loss = loss.detach().clone()
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        opt.step(synced)
        return err, loss / n

    return step
