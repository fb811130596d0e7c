"""PyTorch/CUDA port of the ``repro`` package (ARCO tuning + deployment).

The port mirrors ``repro``'s layout: ``hw`` (the analytical TPU v5e model
the tuner measures against), ``core`` (design space, GBT cost model, the
three MAPPO agents, Confidence Sampling, the ARCO loop), ``compiler``
(oracle, records, session, CLI), ``kernels`` (the hand-written Hopper GEMM
and its plain PyTorch versions), ``models`` (the CNN forward pass that
deploys tuned geometries), ``optim`` and ``obs``.  It imports ``torch``
and ``numpy`` only, never ``jax`` nor any ``repro`` module.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise instead of falling back.

``torch`` is imported lazily, inside :func:`resolve_device`: the
measurement fabric (``compiler.executor``, ``obs``) is stdlib-only, and a
spawned measurement worker or a worker daemon must not pay a torch import
when it loads this package.
"""
from __future__ import annotations


def resolve_device(device=None) -> "torch.device":
    """The device an entry point runs on: ``cuda`` unless the caller named
    another.  Asking for CUDA (explicitly or by default) on a machine
    without it raises rather than silently running on the CPU."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev
