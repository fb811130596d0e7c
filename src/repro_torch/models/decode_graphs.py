"""The MLA/KDA decode step replayed as CUDA graphs, one graph a span.

Eagerly, a decode step of an :class:`~repro_torch.models.transformer.
MLAConfig` model launches ~1,900 kernels (Moonlight's 27 layers), and at
64 slots the host takes about twice as long to launch them as the card
takes to run them.  :class:`DecodeGraphs` captures the step's segments
(:func:`repro_torch.models.transformer.mla_step_segments`, which the eager
step runs too) once, a CUDA graph each, and replays them:

  prologue   the token embedding and :func:`repro_torch.models.mla.
             decode_state` (the slots' rows, write positions, lengths and
             rope tables);
  a layer    one graph for its mixer's span (``mla``, or ``kda``: the
             conv tails and the KDA decode kernel on the layer's state)
             and one for its FFN's (``moe``; ``mlp`` on a dense layer),
             each replayed inside that span of the ambient tracer, so
             that a profiler puts the graph's kernels under the span
             (they carry the correlation id of the graph's launch);
  epilogue   the final RMSNorm and the head's logits.

56 graph launches a step for 27 layers.  The graphs read their inputs
where the capture found them: the weights, the cache's layers, the slots'
positions ``cache["pos"]`` (advanced in place after each replay) and a
static token buffer; the logits land in a static buffer, valid until the
next step.  Nothing inside the step reads a value on the host: attention
is called at ``kv_len`` = the cache's length, which sets only the MLA
decode kernel's split (each slot's blocks share its own length, read on
the device), and the MoE's group ends come from a search on the
device.  Admission writes a prefilled
request into the cache and ``pos`` in place, so it needs no new capture.

What the eager step does on the host besides launching is kept:

* the tracer's counters (``moe.experts_touched``, ``moe.tokens_dropped``,
  ``moe.pairs_elsewhere``, ``mla.cache_tokens``): the capture runs under
  a tracer of its own, so the counters' device sums are part of the
  graphs, whatever tracer was on at capture time; after a replay they
  are added to the ambient tracer's, when one is on;
* ``moe.route_log``: the capture logs each router's expert sets into a
  tensor of its graph; after a replay, with the log on, copies are
  appended in layer order;
* the kernels' launch counts (``mla_attention.launches``,
  ``kda_recurrence.launches``, ``rmsnorm.launches``): a replay adds what
  the capture launched (the graphs' kernels, counted by a profiler on
  the card, are the same).

:func:`supports` and :meth:`DecodeGraphs.engages` say which steps replay;
:func:`repro_torch.models.transformer.decode_step` runs the rest eagerly.
The capture is made at the first step that engages, after one warm-up
run of every segment on the capture stream, into one memory pool that the
segments share (they replay in the order they were captured, so a block
one segment frees and a later one reuses holds what the eager step would).
A fault patched into the model's functions before that step is in the
graphs.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.kernels import kda_decode as KK
from repro_torch.kernels import mla_decode as MK
from repro_torch.kernels import rmsnorm as RN
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T

# the kernels' launch counts that a replay adds to
_COUNTED = (MK.mla_attention, KK.kda_recurrence, RN.rmsnorm)


def supports(cfg: T.ArchConfig, device) -> bool:
    """Whether decode steps of ``cfg`` on ``device`` can replay: an
    MLAConfig whose layers are all ``mla`` or ``kda`` mixers with
    ``moe``/``mlp`` FFNs, on CUDA.  Every other stack decodes eagerly:
    attention reads a host ``kv_len``, sliding windows keep ring state."""
    return (isinstance(cfg, T.MLAConfig)
            and torch.device(device).type == "cuda"
            and all(mixer in ("mla", "kda") and ffn in ("moe", "mlp")
                    for mixer, ffn in cfg.layer_kinds()))


class DecodeGraphs:
    """A server's decode step as CUDA graphs, for ``params`` and the
    decode ``cache`` it serves (see the module docstring).  Made for every
    server; captures nothing until a step engages."""

    def __init__(self, params, cfg: T.ArchConfig, cache) -> None:
        self.params, self.cfg = params, cfg
        self.layers = cache["layers"]
        self.pos = cache["pos"]
        self.supported = supports(cfg, params["embed"].device)
        self.captures = 0
        self._graphs: Optional[List[Tuple[Optional[str],
                                          torch.cuda.CUDAGraph]]] = None
        # the segments' tensors: the tokens, what one leaves the next, the
        # logits (the capture's own, which the graphs read and write)
        self._io: dict = {}
        self._routes: List[torch.Tensor] = []
        self._counts: dict = {}
        self._launches: List[int] = []

    def engages(self, tokens: torch.Tensor) -> bool:
        """Whether this step replays: :func:`supports`, the tokens on
        CUDA, and ``moe.route_replay`` off (it pops a Python list a router
        call, which a replay would not run)."""
        return (self.supported and tokens.is_cuda
                and MOE.route_replay is None)

    def _segments(self) -> List[Tuple[Optional[str], Callable[[], None]]]:
        """:func:`repro_torch.models.transformer.mla_step_segments` on the
        cache's tensors at ``kv_len`` the latent cache's length, passing
        the step along in ``self._io``."""
        return T.mla_step_segments(self.params, self.cfg,
                                   {"pos": self.pos, "layers": self.layers},
                                   self._io, T.latent_len(self.layers))

    def _warm(self, segs) -> None:
        """Run each segment once, every KDA layer's state and conv tails
        as they were before it afterwards (segment 1 + 2 l is layer l's
        mixer)."""
        for i, (name, fn) in enumerate(segs):
            entry = self.layers[(i - 1) // 2] if name == "kda" else {}
            kept = {k: t.clone() for k, t in entry.items()}
            fn()
            for k, t in kept.items():
                entry[k].copy_(t)
            del kept

    def _capture(self, tokens: torch.Tensor) -> None:
        """Warm every segment up on the capture stream (cuBLAS's
        workspace for it, the kernels' one-time set-up; the run writes
        the MLA cache rows the replay writes again, with the same values;
        a ``kda`` segment advances its layer's state and conv tails, so
        they are kept aside around its run and put back), then capture
        each into the shared pool.  The ambient tracer, the route log and
        the launch counts see neither."""
        dev = tokens.device
        self._io = {"tokens": tokens.clone()}
        segs = self._segments()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        counts = [f.launches for f in _COUNTED]
        log = MOE.route_log
        tracer = obs.Tracer(name="decode-graphs")
        try:
            MOE.route_log = []
            with torch.no_grad(), torch.cuda.stream(stream), \
                    obs.use(obs.Tracer(name="decode-graphs-warmup")):
                self._warm(segs)
            tokens = self._io["tokens"]
            self._io.clear()                # the segments hold this dict
            self._io["tokens"] = tokens
            MOE.route_log = []
            before = [f.launches for f in _COUNTED]
            pool = torch.cuda.graph_pool_handle()
            graphs = []
            with torch.no_grad(), obs.use(tracer):
                for name, fn in segs:
                    g = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(g, pool=pool, stream=stream):
                        fn()
                    graphs.append((name, g))
            self._launches = [f.launches - n
                              for f, n in zip(_COUNTED, before)]
            self._routes = MOE.route_log
        finally:
            MOE.route_log = log
            for f, n in zip(_COUNTED, counts):
                f.launches = n
        torch.cuda.current_stream(dev).wait_stream(stream)
        # the counters' final tensors, which the graphs write a replay
        self._counts = tracer.metrics.snapshot()["counters"]
        self._graphs = graphs
        self.captures += 1

    def step(self, params, cache, tokens: torch.Tensor
             ) -> Tuple[torch.Tensor, dict]:
        """One decode step by replay: tokens (B, 1) -> (logits (B, V), the
        cache with ``pos`` advanced in place).  The logits are the static
        buffer, overwritten by the next step."""
        if params is not self.params or cache["layers"] is not self.layers:
            raise ValueError("DecodeGraphs replays the weights and cache it "
                             "was made for")
        if cache["pos"] is not self.pos:   # an eager step made a new one
            self.pos.copy_(cache["pos"])
        if self._graphs is None:
            self._capture(tokens)
        else:
            self._io["tokens"].copy_(tokens)
        for name, g in self._graphs:
            if name is None:
                g.replay()
            else:
                with MLA.span(name):
                    g.replay()
        self.pos.add_(1)
        for f, n in zip(_COUNTED, self._launches):
            f.launches += n
        if MOE.route_log is not None:
            MOE.route_log.extend(r.clone() for r in self._routes)
        tr = obs.current()
        if tr.enabled:
            for name, value in self._counts.items():
                tr.metrics.counter(name).inc(value)
        return self._io["logits"], {"pos": self.pos, "layers": self.layers}
