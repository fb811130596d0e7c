"""The KDA decode step on the state: the Hopper kernel and its plain
version.

``kda_recurrence(q, k, v, g, beta, state, scale)`` advances each (slot,
head)'s state S (d x dv, fp32) by one token of Kimi Delta Attention and
returns its output: with q^ and k^ the L2-normed q and k (1e-6 under the
root),

    S   <- Diag(exp g) S
    S   <- S + beta k^ (v - S^T k^)^T
    o    = scale S^T q^

q, k, g (B, H, d), v (B, H, dv) and beta (B, H) in fp32, as the mixer
computes them (after the short conv and SiLU; g the log-decay); the
kernel does the L2 norms.  S (B, H, d, dv) fp32 is updated in place; o
(B, H, dv) fp32.

The TPU package has no such kernel: it was added for the ``kda`` mixer's
decode, where at a serving batch the state is most of a step's bytes
(256 slots x 32 heads x 64 KB a layer).  It is bound by those bytes: S is
read once and written once, and the rest (norms, decay, the delta's dot
products) is a few operations a state element.  CUDA tensors go through
``csrc/kda_decode.cu`` or raise (:func:`kernel_refusal` names what a call
lacks), counting the launch on ``kda_recurrence.launches``; CPU tensors,
and ``use_kernel=False``, run :func:`kda_recurrence_plain`: the same
step in PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

HEAD_DIM = 128        # d = dv, the width the kernel is built for
L2_EPS = 1e-6         # under the root of the L2 norms


def kda_recurrence_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         g: torch.Tensor, beta: torch.Tensor,
                         state: torch.Tensor, scale: float) -> torch.Tensor:
    qn = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + L2_EPS) * scale
    kn = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + L2_EPS)
    state.mul_(torch.exp(g)[..., None])
    u = (kn[..., None, :] @ state).squeeze(-2)              # (B, H, dv)
    state.add_(kn[..., :, None] * (beta[..., None] * (v - u))[..., None, :])
    return (qn[..., None, :] @ state).squeeze(-2)


def kernel_refusal(q, k, v, g, beta, state) -> str:
    """Why the kernel cannot take these operands, or "" where it can."""
    ops = (("q", q), ("k", k), ("v", v), ("g", g), ("beta", beta),
           ("state", state))
    if not all(t.is_cuda for _, t in ops):
        return "q, k, v, g, beta and state must all be CUDA tensors"
    for name, t in ops:
        if t.dtype != torch.float32:
            return f"the kernel takes float32, got {name} {t.dtype}"
    b, h = state.shape[:2]
    want = (b, h, HEAD_DIM)
    if state.shape[2:] != (HEAD_DIM, HEAD_DIM) or any(
            t.shape != want for t in (q, k, v, g)) or beta.shape != (b, h):
        return (f"the kernel is built for heads of {HEAD_DIM}: state (B, H, "
                f"{HEAD_DIM}, {HEAD_DIM}), q, k, v, g (B, H, {HEAD_DIM}), "
                f"beta (B, H); got state {tuple(state.shape)}, q "
                f"{tuple(q.shape)}, beta {tuple(beta.shape)}")
    for name, t in ops:
        if not t.is_contiguous():
            return f"{name} must be contiguous"
        if t.data_ptr() % 16:
            return f"{name} must start on a 16-byte boundary"
    return ""


def kda_recurrence(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   g: torch.Tensor, beta: torch.Tensor, state: torch.Tensor,
                   scale: float, use_kernel: bool = True) -> torch.Tensor:
    """One token of every (slot, head): ``state`` advanced in place, the
    output (B, H, dv) returned (see the module docstring)."""
    if q.device.type == "cpu" or not use_kernel:
        return kda_recurrence_plain(q, k, v, g, beta, state, scale)
    refusal = kernel_refusal(q, k, v, g, beta, state)
    if refusal:
        raise ValueError(f"KDA decode kernel: {refusal} (use_kernel=False "
                         f"runs the plain version)")
    b, h = beta.shape
    out = torch.empty((b, h, HEAD_DIM), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            beta.data_ptr(), state.data_ptr(), out.data_ptr(), b * h,
            float(scale), torch._C._cuda_getCurrentRawStream(q.device.index))
    if q.device.index == torch.cuda.current_device():
        rc = _lib().repro_kda_decode(*args)
    else:
        with torch.cuda.device(q.device):
            rc = _lib().repro_kda_decode(*args)
    if rc != 0:
        raise RuntimeError(f"KDA decode kernel launch failed (code {rc}) for "
                           f"state {tuple(state.shape)}")
    kda_recurrence.launches += 1
    return out


kda_recurrence.launches = 0


def _bind(lib) -> None:
    lib.repro_kda_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]
    lib.repro_kda_decode.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("kda_decode", _bind)
