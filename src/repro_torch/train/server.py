"""Batched serving with continuous-batching slots (PyTorch).

The port of the reference's ``repro.train.server``, same semantics.  A
fixed decode batch of ``n_slots``; requests are prefilled individually
(disaggregated prefill), inserted into free slots of the live batched
cache (per-sequence positions — slots run at different depths), and
decoded together.  Finished slots free immediately and new requests join
without draining the batch.

Latency accounting is end-to-end: ``Request.latency_s`` runs from
``submit()`` to finish, with a ``queue_s`` / ``prefill_s`` / ``decode_s``
breakdown per request.  Idle capacity is a first-class resource: a
``best_effort`` hook runs one small chunk of background work per call,
only when the queue is empty and at least one decode slot is free.

The cache lives on the device of the weights and is updated in place: a
prefill's cache is copied into its slot (every entry with the batch on
axis 0: KV, an MLA layer's latent ``ckv``/``kpe``, recurrent state, an
encoder-decoder's cross ``xk``/``xv``), and each decode step writes one
token per slot (the reference donates the cache to its jitted step).  As in the reference, ``max_len`` counts the
prompt only, never a vision prefix ahead of it (``submit`` and the
``too_long`` rule): a prefix plus prompt past ``max_len`` keeps the last
``max_len`` positions in the cache, and decode writes at a position
clamped into it.  ``last_logits`` holds the last decode step's logits
(one row a slot) until the next step, for a caller that checks them.

An MLAConfig model on CUDA decodes by replaying CUDA graphs
(:mod:`repro_torch.models.decode_graphs`), captured at the server's first
decode step: the step then advances ``cache["pos"]`` in place, so the
cache keeps its tensors, and ``last_logits`` is the graphs' static
buffer, which the next step overwrites.  Every other configuration, and a
step under ``moe.route_replay``, decodes eagerly.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import decode_graphs as DG
from repro_torch.models import transformer as T

# Request.status values, in lifecycle order.
QUEUED, ACTIVE, DONE, REJECTED, ABANDONED = (
    "queued", "active", "done", "rejected", "abandoned")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (L,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the server
    output: Optional[List[int]] = None
    status: str = QUEUED
    error: Optional[str] = None
    # end-to-end latency (submit -> finish) + its breakdown; all None until
    # the request finishes (or forever, for rejected/abandoned requests)
    latency_s: Optional[float] = None
    queue_s: Optional[float] = None
    prefill_s: Optional[float] = None
    decode_s: Optional[float] = None
    # internal timeline stamps (perf_counter): set by submit()/_admit()
    submit_s: Optional[float] = None
    admit_s: Optional[float] = None
    finish_s: Optional[float] = None

    @property
    def ok(self) -> bool:
        return self.status == DONE


def stub_frontend(cfg: T.ArchConfig, device) -> Dict[str, torch.Tensor]:
    """One request's frontend inputs, which are stubs as in the
    reference's server: zero patches (1, P, D) for a vision prefix, zero
    frames (1, enc_seq, D) for an encoder, in ``cfg.dtype``."""
    out = {}
    if cfg.vision_prefix:
        out["patches"] = torch.zeros((1, cfg.vision_prefix, cfg.d_model),
                                     dtype=cfg.dtype, device=device)
    if cfg.enc_dec:
        out["frames"] = torch.zeros((1, cfg.enc_seq, cfg.d_model),
                                    dtype=cfg.dtype, device=device)
    return out


def _insert_slot(cache, req_cache, slot: int) -> None:
    """Copy a single-request cache into batch slot ``slot``, in place."""
    cache["pos"][slot] = req_cache["pos"][0]
    for entry, single in zip(cache["layers"], req_cache["layers"]):
        for key, t in single.items():
            entry[key][slot].copy_(t[0])


class Server:
    """Continuous-batching server; see the module docstring.

    ``best_effort`` is an optional callable ``(server) -> bool`` invoked
    from :meth:`step` whenever there is idle capacity (queue empty AND at
    least one free slot).  It must do at most one *small* chunk of work
    per call and return True if it did any.
    """

    def __init__(self, params, cfg: T.ArchConfig, n_slots: int = 4,
                 max_len: int = 512,
                 best_effort: Optional[Callable[["Server"], bool]] = None):
        self.params, self.cfg = params, cfg
        self.n_slots, self.max_len = n_slots, max_len
        self.device = params["embed"].device
        self.cache = T.init_cache(cfg, n_slots, max_len, device=self.device)
        # the decode step as CUDA graphs where the model allows it
        self.graphs = DG.DecodeGraphs(params, cfg, self.cache)
        self.free = list(range(n_slots))
        self.active: Dict[int, Request] = {}
        self.last_tok = np.zeros((n_slots, 1), np.int32)
        self.new_counts: Dict[int, int] = {}
        self.queue: Deque[Request] = deque()
        self.rejected: List[Request] = []
        self.abandoned: List[Request] = []
        self.best_effort = best_effort
        # the last decode step's logits (n_slots, V), on the device; valid
        # until the next step (the graphs' static buffer where they replay)
        self.last_logits: Optional[torch.Tensor] = None

    # ------------------------------------------------------------- intake
    def submit(self, req: Request) -> Request:
        """Queue ``req`` (stamping its end-to-end latency clock), or fail
        it gracefully: an oversized or empty prompt is rejected here with
        ``status="rejected"`` + an ``error`` instead of corrupting the
        batched cache at admission."""
        req.submit_s = time.perf_counter()
        if len(req.prompt) == 0:
            req.status, req.error = REJECTED, "empty prompt"
        elif len(req.prompt) >= self.max_len:
            req.status, req.error = REJECTED, (
                f"prompt length {len(req.prompt)} >= max_len "
                f"{self.max_len}: no room in the slot cache")
        if req.status == REJECTED:
            req.output = []
            self.rejected.append(req)
            return req
        req.status = QUEUED
        self.queue.append(req)
        return req

    def _admit(self):
        while self.free and self.queue:
            req = self.queue.popleft()
            slot = self.free.pop()
            req.admit_s = time.perf_counter()
            req.queue_s = req.admit_s - req.submit_s
            batch = dict(stub_frontend(self.cfg, self.device),
                         tokens=torch.as_tensor(
                             np.asarray(req.prompt, np.int64)[None],
                             device=self.device))
            logits, rc = T.prefill(self.params, batch, self.cfg,
                                   self.max_len)
            _insert_slot(self.cache, rc, slot)
            first = int(torch.argmax(logits[0]))   # also syncs the prefill
            req.prefill_s = time.perf_counter() - req.admit_s
            req.output = [first]
            req.status = ACTIVE
            self.last_tok[slot, 0] = first
            self.active[slot] = req
            self.new_counts[slot] = 1

    # ---------------------------------------------------------- idle work
    def idle_capacity(self) -> int:
        """Free decode slots available for best-effort work right now —
        zero whenever any request is waiting for admission."""
        return 0 if self.queue else len(self.free)

    def _tick_best_effort(self) -> bool:
        if self.best_effort is None or not self.idle_capacity():
            return False
        return bool(self.best_effort(self))

    # ------------------------------------------------------------- decode
    def _finish(self, slot: int, status: str = DONE) -> Request:
        req = self.active.pop(slot)
        req.finish_s = time.perf_counter()
        req.status = status
        req.latency_s = req.finish_s - req.submit_s
        req.decode_s = req.finish_s - req.admit_s - req.prefill_s
        self.new_counts.pop(slot)
        self.free.append(slot)
        return req

    def step(self) -> List[Request]:
        """One decode step for all active slots; returns finished requests.
        With idle capacity (free slots + empty queue) one chunk of
        best-effort work runs first."""
        self._admit()
        self._tick_best_effort()
        if not self.active:
            return []
        tokens = torch.as_tensor(self.last_tok, device=self.device)
        logits, self.cache = T.decode_step(self.params, self.cache, tokens,
                                           self.cfg, graphs=self.graphs)
        self.last_logits = logits
        toks = torch.argmax(logits, dim=-1).cpu().numpy()
        done: List[Request] = []
        for slot, req in list(self.active.items()):
            t = int(toks[slot])
            req.output.append(t)
            self.last_tok[slot, 0] = t
            self.new_counts[slot] += 1
            ended = (req.eos_id is not None and t == req.eos_id)
            full = (self.new_counts[slot] >= req.max_new_tokens)
            too_long = (len(req.prompt) + self.new_counts[slot]
                        >= self.max_len - 1)
            if ended or full or too_long:
                done.append(self._finish(slot))
        return done

    def run_until_drained(self, max_steps: int = 10000) -> List[Request]:
        """Serve until queue + slots are empty.  Hitting ``max_steps``
        with requests still in flight marks every live request
        ``status="abandoned"`` (latency fields stay None), reclaims the
        slots, and records them on ``abandoned``."""
        out: List[Request] = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.active and not self.queue:
                return out
        for slot in sorted(self.active):
            req = self._finish(slot, status=ABANDONED)
            req.latency_s = req.decode_s = None   # never finished
            self.abandoned.append(req)
        while self.queue:
            req = self.queue.popleft()
            req.status = ABANDONED
            self.abandoned.append(req)
        return out
