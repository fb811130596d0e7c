"""Online tuning-as-a-service (the port of the reference's
``repro/compiler/serve_tune.py``): a :class:`Session` search measuring
candidate decode/prefill ``ShardSpace`` geometries on a live server's
*idle decode slots* while it keeps serving traffic under a p99 SLA.

The control inversion is the whole trick.  ``Session.run()`` is a blocking
search loop that thinks it owns the world; a serving host owns the clock
and only has capacity to spare when the request queue is empty and a
decode slot is free.  :class:`IdleSlotExecutor` reconciles them: it speaks
the ordinary :class:`~repro_torch.compiler.executor.Executor` protocol (so the
whole Session stack — records, surrogates, warm resume, ``monitor=`` —
drives the search *unchanged*), but ``submit`` only queues a
:class:`MeasureJob` with the host, and ``drain`` pumps the host's serve
loop forward until the requested handles resolve.  Measurement progress
accrues exclusively inside idle windows (queue empty AND >= 1 free slot);
the moment a request arrives the in-flight candidate is preempted — the
admission-aware preemption contract of the Resource-Allocation-RL
exemplar (latency-critical service + best-effort work on one machine).

SLA violations that occur while a candidate is being measured are folded
into its reward as a hard penalty (``ServeSLA.measure_penalty_s`` per
violating request), so the search itself learns not to measure its way
into SLA trouble.

Two hosts share the contract:

* :class:`SimServeHost` — a virtual-time discrete-event model of the
  continuous-batching server (lockstep decode, serialized prefill,
  admission on free slots), with decode/prefill step times supplied by a
  :class:`ServeModel` proxy.  Virtual time means a synthetic
  million-request trace plays in seconds of wall clock.  Host numpy only,
  draw for draw the reference's.
* :class:`LiveServeHost` — the port's :class:`repro_torch.train.server.
  Server` (every prefill and decode step through the hand-written flash
  and RMSNorm kernels on the card), plugged in through its
  ``best_effort`` hook (one measurement chunk per idle tick).  Geometry
  switches are advisory there — the server cannot reshard a live cache —
  but the measurement/preemption/SLA bookkeeping is identical.

The candidate measurements are the zoo's host roofline proxy
(:func:`repro_torch.compiler.zoo.pod_proxy_measure`): they launch nothing
on the card.  The search's MAPPO nets run on ``device`` (default
``cuda``), as every port session does.
"""
from __future__ import annotations

import dataclasses
import math
import time
from array import array
from collections import deque
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple, Union)

import numpy as np

from repro_torch.compiler.executor.base import (Executor, MeasureHandle,
                                                MeasureResult)
from repro_torch.compiler.oracle import SettingsOracle
from repro_torch.compiler.records import RecordLog
from repro_torch.compiler.session import Session, SessionReport
from repro_torch.compiler.task import TuningTask
from repro_torch.core.shard_space import ShardSpace, knob_values_to_settings
from repro_torch.obs import log

# ----------------------------------------------------------------- trace


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Synthetic request trace: Poisson arrivals with a bursty mode.

    The process alternates between a base mode (rate ``rate_per_s``) and
    bursts (rate ``rate_per_s * burst_factor``); mode dwell times are
    exponential with means ``burst_every_s`` / ``burst_len_s``.  Prompt
    and decode lengths are uniform over inclusive ranges.  Fully
    deterministic under ``seed``.
    """

    n_requests: int = 1_000_000
    rate_per_s: float = 60.0
    burst_factor: float = 2.5
    burst_every_s: float = 120.0
    burst_len_s: float = 10.0
    prompt_len: Tuple[int, int] = (8, 48)
    max_new: Tuple[int, int] = (8, 48)
    seed: int = 0


def synthetic_trace(cfg: TraceConfig
                    ) -> Iterator[Tuple[float, int, int]]:
    """Yield ``(arrival_s, prompt_len, max_new)`` tuples, in arrival
    order.  Draws are chunked so a million-request trace costs a handful
    of numpy calls, not a million."""
    rng = np.random.default_rng(cfg.seed)
    bursty = cfg.burst_factor > 1.0 and cfg.burst_every_s > 0.0
    in_burst = False
    mode_until = rng.exponential(cfg.burst_every_s) if bursty else math.inf
    t = 0.0
    remaining = cfg.n_requests
    while remaining > 0:
        k = min(8192, remaining)
        remaining -= k
        gaps = rng.exponential(1.0, size=k)
        plens = rng.integers(cfg.prompt_len[0], cfg.prompt_len[1] + 1,
                             size=k)
        mnews = rng.integers(cfg.max_new[0], cfg.max_new[1] + 1, size=k)
        for i in range(k):
            rate = cfg.rate_per_s * (cfg.burst_factor if in_burst else 1.0)
            t += gaps[i] / rate
            while t >= mode_until:
                in_burst = not in_burst
                mode_until += rng.exponential(
                    cfg.burst_len_s if in_burst else cfg.burst_every_s)
            yield (t, int(plens[i]), int(mnews[i]))


# ------------------------------------------------------------------- SLA


@dataclasses.dataclass(frozen=True)
class ServeSLA:
    """p99 end-to-end latency SLA + how violations shape the reward.

    ``measure_penalty_s`` is added to a candidate's measured step time
    once per request that violated the SLA while that candidate's
    measurement was in flight — a hard penalty (orders of magnitude above
    any real step time), so a candidate that measures at the cost of live
    traffic can never win the search.
    """

    target_s: float = 0.5
    measure_penalty_s: float = 10.0
    max_violation_pct: float = 3.0


# ------------------------------------------------------------ cost model


class ServeModel:
    """Decode/prefill ``ShardSpace`` cells of one arch + their step-time
    model, shared by the online search, the serving simulation, and the
    offline-comparison run (identical spaces and measure functions, so
    "within 10% of offline" compares like with like).

    Step times come from the zoo's deterministic roofline proxy
    (:func:`repro_torch.compiler.zoo.pod_proxy_measure` — interior optimum in
    the model axis), calibrated so the *default* geometry (first choice
    of every knob) decodes one token in ``base_decode_step_s`` and
    prefills a full ``prefill_32k`` sequence in ``base_prefill_s``;
    everything else scales by the proxy's ratio to the default.
    """

    def __init__(self, arch: str = "qwen2-1.5b", n_devices: int = 256,
                 decode_shape: str = "decode_32k",
                 prefill_shape: str = "prefill_32k",
                 base_decode_step_s: float = 2e-3,
                 base_prefill_s: float = 60e-3):
        from repro_torch.compiler.zoo import pod_proxy_measure
        from repro_torch.configs import get_config
        from repro_torch.configs.shapes import SHAPES
        self.arch = arch
        self.n_devices = n_devices
        cfg = get_config(arch)
        self.prefill_seq = SHAPES[prefill_shape].seq
        self.spaces: Dict[str, ShardSpace] = {}
        self.default_settings: Dict[str, Dict[str, object]] = {}
        self._fns: Dict[str, Callable[[Dict[str, object]], float]] = {}
        base = {"decode": base_decode_step_s, "prefill": base_prefill_s}
        for kind, shape in (("decode", decode_shape),
                            ("prefill", prefill_shape)):
            cell = SHAPES[shape]
            proxy = pod_proxy_measure(cfg.n_layers, cfg.d_model, cell.seq,
                                      cell.global_batch, n_devices,
                                      train=False)
            # calibrate against the default geometry, then bake the scale
            # into the fn the space carries: the online oracle, the sim,
            # and the offline AnalyticalOracle all measure the same units
            probe = ShardSpace.for_cell(arch, shape, measure_fn=proxy,
                                        n_devices=n_devices)
            default = knob_values_to_settings(np.asarray(
                [c[0] for c in probe.choices], np.float64))
            scale = base[kind] / proxy(default)
            fn = _scaled(proxy, scale)
            self.spaces[kind] = ShardSpace.for_cell(
                arch, shape, measure_fn=fn, n_devices=n_devices)
            self.default_settings[kind] = default
            self._fns[kind] = fn

    def cost_s(self, kind: str, settings: Dict[str, object]) -> float:
        """Calibrated step time of ``settings`` (decode: one token for
        the whole batch; prefill: one full-length sequence)."""
        return float(self._fns[kind](settings))

    def measure_fn(self, kind: str) -> Callable[[Dict[str, object]], float]:
        return self._fns[kind]

    def settings_of(self, kind: str, best_config) -> Dict[str, object]:
        """Decode a report's per-knob choice indices into settings."""
        space = self.spaces[kind]
        vals = np.asarray([space.choices[k][int(i)]
                           for k, i in enumerate(best_config)], np.float64)
        return knob_values_to_settings(vals)


def _scaled(proxy: Callable[[Dict[str, object]], float],
            scale: float) -> Callable[[Dict[str, object]], float]:
    def fn(settings: Dict[str, object]) -> float:
        return float(proxy(settings)) * scale
    return fn


# ------------------------------------------------------- measurement jobs


class MeasureJob:
    """One queued candidate measurement, executed in idle-slot windows.

    ``cost_s`` is how much idle slot time the measurement needs;
    ``progress_s`` accrues only while the host is idle and resets nothing
    on preemption (a preempted measurement resumes where it stopped — it
    loses the window, not the work).  ``violations`` counts SLA-violating
    requests that finished while this job was in flight; the completion
    folds them into the measured value as a hard penalty.
    """

    __slots__ = ("handle", "kind", "fn", "settings", "cost_s",
                 "progress_s", "violations", "running")

    def __init__(self, handle: MeasureHandle, kind: str,
                 fn: Callable[[Dict[str, object]], float],
                 cost_s: float):
        self.handle = handle
        self.kind = kind
        self.fn = fn
        self.settings = dict(handle.settings)
        self.cost_s = cost_s
        self.progress_s = 0.0
        self.violations = 0
        self.running = False


class _HostBase:
    """Shared measurement bookkeeping: the job queue, the task registry
    (Session task name -> (cell kind, measure fn)), and counters."""

    model: ServeModel
    sla: ServeSLA

    def _init_jobs(self, measure_cost_s: float) -> None:
        self.jobs: deque = deque()
        self.jobs_done = 0
        self.jobs_failed = 0
        self.preemptions = 0
        self.measure_idle_s = 0.0
        self.measure_cost_s = measure_cost_s
        self._task_fns: Dict[str, Tuple[str, Callable]] = {}

    def register_task(self, name: str, kind: str,
                      fn: Callable[[Dict[str, object]], float]) -> None:
        self._task_fns[name] = (kind, fn)

    def make_job(self, handle: MeasureHandle) -> MeasureJob:
        try:
            kind, fn = self._task_fns[handle.task]
        except KeyError:
            raise KeyError(
                f"task {handle.task!r} was never registered with this "
                f"host; have {sorted(self._task_fns)}") from None
        return MeasureJob(handle, kind, fn, self.measure_cost_s)

    def enqueue(self, job: MeasureJob) -> None:
        self.jobs.append(job)

    def _complete(self, job: MeasureJob) -> None:
        job.running = False
        self.jobs_done += 1
        try:
            raw = float(job.fn(job.settings))
        except Exception as e:  # infeasible candidate -> penalty row
            self.jobs_failed += 1
            job.handle._resolve(MeasureResult(
                ok=False, error=f"{type(e).__name__}: {e}"))
            return
        value = raw + self.sla.measure_penalty_s * job.violations
        job.handle._resolve(MeasureResult(ok=True, value=value))
        self._on_measured(job.kind, job.settings, value, raw)

    def _on_measured(self, kind: str, settings: Dict[str, object],
                     value: float, raw: float) -> None:
        """Hook: hosts may switch geometry on an improving measurement."""

    def pump(self) -> bool:
        raise NotImplementedError

    def finish_serving(self) -> None:
        """Serve (and measure) until the trace, the slots, and the job
        queue are all drained."""
        while self.pump():
            pass


# ----------------------------------------------------- virtual-time host


class SimServeHost(_HostBase):
    """Virtual-time model of the continuous-batching server.

    Faithful to :class:`repro_torch.train.server.Server` semantics where they
    matter for scheduling: admission only onto free slots, prefill
    serialized on the host, lockstep batched decode (cost per step is the
    *decode geometry's* step time regardless of occupancy), and
    best-effort measurement progress only while the queue is empty with a
    slot free.  Decode fast-forwards in bursts — to the earliest slot
    completion, capped at the next arrival only when a free slot means
    that arrival could actually be admitted — so a million-request trace
    needs a few million pumps, not billions of per-token steps.

    Geometry: starts at the model's default; every completed measurement
    that beats the current geometry by ``switch_rel_gain`` is adopted
    immediately (a ``reconfig_pause_s`` stall models the reshard), and
    :func:`tune_while_serving` applies the session winner at the end
    regardless (warm-resumed sessions replay from records and submit no
    jobs, so switching cannot ride on job completions alone).
    """

    kind = "sim"

    def __init__(self, model: ServeModel,
                 trace: Union[TraceConfig, Iterable[Tuple[float, int, int]]],
                 sla: Optional[ServeSLA] = None, n_slots: int = 8,
                 measure_cost_s: float = 0.25,
                 reconfig_pause_s: float = 0.05,
                 switch_rel_gain: float = 0.005,
                 tune_after_s: float = 0.0):
        self.model = model
        self.sla = sla or ServeSLA()
        self.n_slots = n_slots
        self.reconfig_pause_s = reconfig_pause_s
        self.switch_rel_gain = switch_rel_gain
        # baseline observation window: measurements don't accrue before
        # this — it is what gives the bench a populated "before" phase
        # (and operators a default-geometry baseline to compare against)
        self.tune_after_s = tune_after_s
        self._init_jobs(measure_cost_s)
        if isinstance(trace, TraceConfig):
            trace = synthetic_trace(trace)
        self._trace_it = iter(trace)
        self._next = next(self._trace_it, None)
        self.t = 0.0
        self.queue: deque = deque()          # (arrival_s, plen, max_new)
        self.slots: List[List[float]] = []   # [remaining_new, arrival, new]
        self.geometry = {k: dict(model.default_settings[k])
                         for k in ("decode", "prefill")}
        self.geom_value = {k: model.cost_s(k, self.geometry[k])
                           for k in ("decode", "prefill")}
        self.switches: List[Tuple[float, str, float]] = []
        self.tuned_from_s: Optional[float] = None
        self.served = 0
        self.violations = 0
        self.sum_queue_s = 0.0
        self.sum_prefill_s = 0.0
        self._fin = array("d")
        self._lat = array("d")
        self._tok = array("d")

    # ------------------------------------------------------------ events
    def _pull_arrivals(self) -> None:
        nxt = self._next
        while nxt is not None and nxt[0] <= self.t:
            self.queue.append(nxt)
            nxt = next(self._trace_it, None)
        self._next = nxt

    def _advance(self, dt: float) -> None:
        """Advance virtual time; accrue measurement progress over the
        prefix of the interval that is genuinely idle (queue empty, free
        slot, no arrival yet)."""
        start = self.t
        self.t = start + dt
        if not self.jobs:
            return
        job = self.jobs[0]
        if self.queue or len(self.slots) >= self.n_slots:
            if job.running:
                job.running = False
                self.preemptions += 1
            return
        arrival = self._next[0] if self._next is not None else math.inf
        w_lo = max(start, self.tune_after_s)
        w_hi = min(self.t, arrival)
        window = w_hi - w_lo
        if window <= 0.0:
            if job.running:
                job.running = False
                self.preemptions += 1
            return
        job.running = True
        used = min(window, job.cost_s - job.progress_s)
        job.progress_s += used
        self.measure_idle_s += used
        if job.progress_s >= job.cost_s - 1e-12:
            self.jobs.popleft()
            self._complete(job)
        elif arrival < self.t:  # an arrival landed inside the interval
            job.running = False
            self.preemptions += 1

    def _finish_request(self, arrival: float, tokens: int) -> None:
        lat = self.t - arrival
        self._fin.append(self.t)
        self._lat.append(lat)
        self._tok.append(float(tokens))
        self.served += 1
        if lat > self.sla.target_s:
            self.violations += 1
            if self.jobs and self.jobs[0].progress_s > 0.0:
                self.jobs[0].violations += 1

    def _admit_one(self) -> None:
        arrival, plen, max_new = self.queue.popleft()
        self.sum_queue_s += self.t - arrival
        prefill = self.geom_value["prefill"] * (plen / self.model.prefill_seq)
        self._advance(prefill)
        self.sum_prefill_s += prefill
        if max_new <= 1:
            self._finish_request(arrival, max(max_new, 1))
        else:
            self.slots.append([float(max_new - 1), arrival, float(max_new)])

    def _decode_burst(self) -> None:
        step = self.geom_value["decode"]
        k = int(min(s[0] for s in self.slots))
        if len(self.slots) < self.n_slots and self._next is not None:
            # a free slot means the next arrival could be admitted: don't
            # decode past it (mirrors the real server's per-step admission)
            gap = self._next[0] - self.t
            if gap > 0.0:
                k = min(k, max(1, int(math.ceil(gap / step - 1e-9))))
        self._advance(k * step)
        keep = []
        for s in self.slots:
            s[0] -= k
            if s[0] <= 0.0:
                self._finish_request(s[1], int(s[2]))
            else:
                keep.append(s)
        self.slots = keep

    def pump(self) -> bool:
        """One scheduling decision; returns False only when everything —
        trace, queue, slots, measurement jobs — is exhausted."""
        self._pull_arrivals()
        if self.queue and len(self.slots) < self.n_slots:
            self._admit_one()
            return True
        if self.slots:
            self._decode_burst()
            return True
        if self.jobs:
            job = self.jobs[0]
            dt = job.cost_s - job.progress_s
            if self.t < self.tune_after_s:  # still in the baseline window
                dt += self.tune_after_s - self.t
            if self._next is not None:
                dt = min(dt, self._next[0] - self.t)
            self._advance(dt)
            return True
        if self._next is not None:
            self.t = self._next[0]
            return True
        return False

    # --------------------------------------------------------- geometry
    def _on_measured(self, kind: str, settings: Dict[str, object],
                     value: float, raw: float) -> None:
        # compare on the penalized value (the search's ordering) but run
        # the adopted geometry at its raw step time
        if value < self.geom_value[kind] * (1.0 - self.switch_rel_gain):
            self._switch(kind, settings, raw)

    def _switch(self, kind: str, settings: Dict[str, object],
                raw: float) -> None:
        self.geometry[kind] = dict(settings)
        self.geom_value[kind] = raw
        self.t += self.reconfig_pause_s  # reshard stall
        self.switches.append((self.t, kind, raw))

    def apply_best(self, kind: str, settings: Dict[str, object]) -> None:
        """Adopt ``settings`` if it beats the current geometry — how the
        session's final winner lands even when every measurement was a
        warm-resume record replay."""
        raw = self.model.cost_s(kind, settings)
        if raw < self.geom_value[kind] * (1.0 - self.switch_rel_gain):
            self._switch(kind, settings, raw)

    def mark_tuned(self) -> None:
        self.tuned_from_s = self.t

    # ------------------------------------------------------------ report
    def _phase(self, lo: float, hi: float) -> Dict[str, Any]:
        fin = np.frombuffer(self._fin, np.float64)
        lat = np.frombuffer(self._lat, np.float64)
        tok = np.frombuffer(self._tok, np.float64)
        mask = (fin >= lo) & (fin < hi)
        n = int(mask.sum())
        if n == 0:
            return {"n_requests": 0, "p50_latency_s": None,
                    "p99_latency_s": None, "mean_latency_s": None,
                    "tokens_per_sec": None, "violation_pct": None}
        lats = lat[mask]
        span = max(float(fin[mask].max()) - lo, 1e-9)
        return {
            "n_requests": n,
            "p50_latency_s": float(np.percentile(lats, 50)),
            "p99_latency_s": float(np.percentile(lats, 99)),
            "mean_latency_s": float(lats.mean()),
            "tokens_per_sec": float(tok[mask].sum() / span),
            "violation_pct": float(100.0 * (lats > self.sla.target_s).mean()),
        }

    def summary(self) -> Dict[str, Any]:
        """Serving + measurement stats, with a before/after split: before
        = finished under the pure default geometry (up to the first
        switch), after = finished once the session's tuning was applied."""
        first_switch = (self.switches[0][0] if self.switches
                        else self.tuned_from_s)
        overall = self._phase(0.0, math.inf)
        out = {
            "kind": self.kind,
            "sim_time_s": self.t,
            "served": self.served,
            "rejected": 0,
            "abandoned": 0,
            "sla_target_s": self.sla.target_s,
            "violations": self.violations,
            "mean_queue_s": self.sum_queue_s / max(self.served, 1),
            "mean_prefill_s": self.sum_prefill_s / max(self.served, 1),
            "before": self._phase(
                0.0, first_switch if first_switch is not None else math.inf),
            "after": (self._phase(self.tuned_from_s, math.inf)
                      if self.tuned_from_s is not None
                      else self._phase(math.inf, math.inf)),
            "geometry_default": {k: dict(v) for k, v in
                                 self.model.default_settings.items()},
            "geometry": {k: dict(v) for k, v in self.geometry.items()},
            "switches": [[float(t), k, float(v)]
                         for t, k, v in self.switches],
            "tuned_from_s": self.tuned_from_s,
            "measurements": self.jobs_done,
            "measure_failures": self.jobs_failed,
            "preempted": self.preemptions,
            "measure_idle_s": self.measure_idle_s,
        }
        out.update(overall)
        return out

    def status(self) -> Dict[str, Any]:
        """Live /status source for :class:`repro_torch.obs.serve.MonitorServer`."""
        return {
            "kind": f"serve-{self.kind}",
            "time_s": self.t,
            "served": self.served,
            "active": len(self.slots),
            "queued": len(self.queue),
            "violations": self.violations,
            "violation_pct": (100.0 * self.violations / self.served
                              if self.served else 0.0),
            "geometry": {k: dict(v) for k, v in self.geometry.items()},
            "measurements": {"pending": len(self.jobs),
                             "done": self.jobs_done,
                             "preempted": self.preemptions},
            "switches": len(self.switches),
        }


# ------------------------------------------------------------- live host


class LiveServeHost(_HostBase):
    """The port's :class:`repro_torch.train.server.Server` as a tuning host.

    Arrivals are replayed against the wall clock (idle gaps between
    requests are skipped by advancing a clock skew, so a sparse trace
    doesn't serve in real time); measurement chunks run through the
    server's ``best_effort`` hook — at most one whole (cheap, proxy-based)
    measurement per idle tick, and only when the server's own bookkeeping
    shows the queue empty and a slot free (``idle_windows`` counts the
    chunks that found it so: it equals ``measurements`` when the
    contract held).
    Geometry switches are recorded but advisory: the server cannot
    reshard a live batched cache, so step times don't change — the sim
    host is where before/after timing is modeled, the live host is where
    the preemption contract meets real decode steps on the card.
    Latencies are the server's host ``perf_counter`` stamps; every step
    reads its tokens back before it stamps.
    """

    kind = "live"

    def __init__(self, server,
                 trace: Union[TraceConfig, Iterable[Tuple[float, int, int]]],
                 sla: Optional[ServeSLA] = None,
                 model: Optional[ServeModel] = None,
                 vocab: int = 1000, seed: int = 0):
        from repro_torch.train.server import Request
        self.server = server
        self.model = model or ServeModel()
        self.sla = sla or ServeSLA()
        self._init_jobs(measure_cost_s=0.0)  # live chunks are atomic
        server.best_effort = self._best_effort
        if isinstance(trace, TraceConfig):
            trace = synthetic_trace(trace)
        self._trace_it = iter(trace)
        self._next = next(self._trace_it, None)
        self._rng = np.random.default_rng(seed)
        self._vocab = vocab
        self._Request = Request
        self._uid = 0
        self._t0 = time.perf_counter()
        self._skew = 0.0
        self._pending_violations = 0
        self.geometry = {k: dict(self.model.default_settings[k])
                         for k in ("decode", "prefill")}
        self.switches: List[Tuple[float, str, float]] = []
        self.tuned_from_s: Optional[float] = None
        self.served = 0
        self.violations = 0
        self.done: List[Any] = []
        self._lat: List[float] = []
        self._tok: List[int] = []
        # the server's own idle bookkeeping at each measurement chunk
        self.idle_windows = 0

    def now(self) -> float:
        return time.perf_counter() - self._t0 + self._skew

    def _submit_due(self) -> None:
        nxt = self._next
        while nxt is not None and nxt[0] <= self.now():
            plen = min(nxt[1], self.server.max_len - 2)
            req = self._Request(
                uid=self._uid,
                prompt=self._rng.integers(0, self._vocab, size=max(plen, 1)
                                          ).astype(np.int32),
                max_new_tokens=nxt[2])
            self._uid += 1
            self.server.submit(req)
            nxt = next(self._trace_it, None)
        self._next = nxt

    def _best_effort(self, server) -> bool:
        """One measurement chunk per idle tick (the server only calls
        this with an empty queue and a free slot)."""
        if not self.jobs:
            return False
        if not server.queue and server.free:
            self.idle_windows += 1
        job = self.jobs.popleft()
        job.progress_s = job.cost_s  # atomic chunk
        # any SLA violation since the last chunk taxes this candidate:
        # coarse, but it is the hard-penalty contract under live traffic
        job.violations = self._pending_violations
        self._pending_violations = 0
        self._complete(job)
        return True

    def _account(self, req) -> None:
        self.done.append(req)
        self.served += 1
        self._lat.append(req.latency_s)
        self._tok.append(len(req.output))
        if req.latency_s > self.sla.target_s:
            self.violations += 1
            self._pending_violations += 1

    def pump(self) -> bool:
        self._submit_due()
        srv = self.server
        if srv.queue or srv.active:
            for req in srv.step():
                self._account(req)
            return True
        if self.jobs:
            self._best_effort(srv)
            return True
        if self._next is not None:
            # fully idle: fast-forward the replay clock to the next arrival
            self._skew += self._next[0] - self.now()
            return True
        return False

    def apply_best(self, kind: str, settings: Dict[str, object]) -> None:
        self.geometry[kind] = dict(settings)
        self.switches.append((self.now(), kind,
                              self.model.cost_s(kind, settings)))

    def mark_tuned(self) -> None:
        self.tuned_from_s = self.now()

    def summary(self) -> Dict[str, Any]:
        lats = np.asarray(self._lat, np.float64)
        toks = np.asarray(self._tok, np.float64)
        wall = max(self.now(), 1e-9)
        srv = self.server
        out = {
            "kind": self.kind,
            "sim_time_s": wall,
            "served": self.served,
            "rejected": len(srv.rejected),
            "abandoned": len(srv.abandoned),
            "sla_target_s": self.sla.target_s,
            "violations": self.violations,
            "mean_queue_s": (float(np.mean([r.queue_s for r in self.done]))
                             if self.done else 0.0),
            "mean_prefill_s": (float(np.mean([r.prefill_s
                                              for r in self.done]))
                               if self.done else 0.0),
            "before": {}, "after": {},
            "geometry_default": {k: dict(v) for k, v in
                                 self.model.default_settings.items()},
            "geometry": {k: dict(v) for k, v in self.geometry.items()},
            "switches": [[float(t), k, float(v)]
                         for t, k, v in self.switches],
            "tuned_from_s": self.tuned_from_s,
            "measurements": self.jobs_done,
            "measure_failures": self.jobs_failed,
            "preempted": self.preemptions,
            "measure_idle_s": self.measure_idle_s,
            "idle_windows": self.idle_windows,
            "n_requests": self.served,
        }
        if self.served:
            out.update({
                "p50_latency_s": float(np.percentile(lats, 50)),
                "p99_latency_s": float(np.percentile(lats, 99)),
                "mean_latency_s": float(lats.mean()),
                "tokens_per_sec": float(toks.sum() / wall),
                "violation_pct": float(
                    100.0 * (lats > self.sla.target_s).mean()),
            })
        else:
            out.update({"p50_latency_s": None, "p99_latency_s": None,
                        "mean_latency_s": None, "tokens_per_sec": None,
                        "violation_pct": None})
        return out

    def status(self) -> Dict[str, Any]:
        srv = self.server
        return {
            "kind": f"serve-{self.kind}",
            "time_s": self.now(),
            "served": self.served,
            "active": len(srv.active),
            "queued": len(srv.queue),
            "violations": self.violations,
            "violation_pct": (100.0 * self.violations / self.served
                              if self.served else 0.0),
            "geometry": {k: dict(v) for k, v in self.geometry.items()},
            "measurements": {"pending": len(self.jobs),
                             "done": self.jobs_done,
                             "preempted": self.preemptions},
            "switches": len(self.switches),
        }


# --------------------------------------------------------------- executor


class IdleSlotExecutor(Executor):
    """Executor whose "worker" is a serving host's idle capacity.

    ``submit`` queues the job with the host and returns immediately;
    ``drain`` pumps the host's serve loop until the requested handles
    resolve — so a blocking ``Session.run()`` transparently becomes the
    thing that drives serving forward, and every measurement it asked for
    happens inside idle-slot windows (or not yet at all)."""

    n_workers = 1

    def __init__(self, host: _HostBase):
        self.host = host
        self._next_id = 0
        self._handles: List[MeasureHandle] = []

    def submit(self, task: str, settings: Dict[str, object],
               spec=None) -> MeasureHandle:
        handle = MeasureHandle(self._next_id, task, dict(settings),
                               executor=self, spec=spec)
        self._next_id += 1
        self.host.enqueue(self.host.make_job(handle))
        self._handles.append(handle)
        return handle

    def poll(self) -> None:
        pass  # completions only happen while the host pumps (drain)

    def drain(self, handles: Optional[List[MeasureHandle]] = None) -> None:
        pending = [h for h in (self._handles if handles is None else handles)
                   if not h.done()]
        while pending:
            if not self.host.pump():
                raise RuntimeError(
                    "serve host ran dry (trace + queue + jobs exhausted) "
                    "with measurements still pending")
            pending = [h for h in pending if not h.done()]

    def stats(self) -> Dict[str, object]:
        host = self.host
        running = bool(host.jobs) and host.jobs[0].progress_s > 0.0
        return {"kind": "idle-slot", "workers_alive": 1, "respawns": 0,
                "queued": len(host.jobs), "running": int(running),
                "max_inflight": 1, "jobs": self._next_id,
                "failures": host.jobs_failed,
                "preempted": host.preemptions,
                "measure_idle_s": host.measure_idle_s}


# ------------------------------------------------------------ entry point


def serve_tuner_config():
    """Small deterministic tuner for online serving searches: each
    measurement spends real idle-slot time, so the search must be
    sample-efficient (arXiv 2507.16249's constraint) — small batches,
    heavy surrogate reuse."""
    from repro_torch.core import mappo
    from repro_torch.core.tuner import TunerConfig
    return TunerConfig(iteration_opt=8, b_measure=8, episodes_per_iter=2,
                       mappo=mappo.MappoConfig(n_steps=16, n_envs=8),
                       gbt_rounds=10)


@dataclasses.dataclass
class ServeReport:
    """Everything ``serve --autotune`` produced: serving stats (with the
    before/after split), the tuning session's report, the chosen online
    geometries, and — when the offline comparison ran — the offline
    winners plus per-cell convergence ratios (offline step time / online
    step time; 1.0 = the online search found the offline optimum)."""

    serve: Dict[str, Any]
    session: SessionReport
    online: Dict[str, Dict[str, Any]]
    offline: Optional[Dict[str, Dict[str, Any]]]
    convergence: Optional[Dict[str, float]]
    budget: int
    wall_s: float

    def to_dict(self) -> Dict[str, Any]:
        return {"serve": self.serve, "session": self.session.to_dict(),
                "online": self.online, "offline": self.offline,
                "convergence": self.convergence, "budget": self.budget,
                "wall_s": self.wall_s}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ServeReport":
        return ServeReport(
            serve=d["serve"],
            session=SessionReport.from_dict(d["session"]),
            online=d["online"], offline=d.get("offline"),
            convergence=d.get("convergence"), budget=int(d["budget"]),
            wall_s=float(d["wall_s"]))


def serve_tasks(model: ServeModel, host: Optional[_HostBase] = None
                ) -> List[TuningTask]:
    """The decode/prefill cells as Session tasks.  With a ``host``, each
    task's oracle routes measurements through the session-shared
    (idle-slot) executor; without one, the factory falls back to an
    in-process serial oracle over the same fn — which is exactly the
    offline-comparison arm."""
    tasks = []
    for kind, mult in (("decode", 4), ("prefill", 1)):
        name = f"serve:{model.arch}/{kind}"
        fn = model.measure_fn(kind)
        if host is not None:
            host.register_task(name, kind, fn)

        def factory(task, records, executor=None, _fn=fn):
            return SettingsOracle(task.space, fn=_fn, task=task.name,
                                  records=records, executor=executor,
                                  own_executor=False)

        tasks.append(TuningTask(name=name, space=model.spaces[kind],
                                multiplicity=mult, oracle_factory=factory))
    return tasks


def tune_while_serving(host: _HostBase, tuner=None, budget: int = 48,
                       records: Union[None, str, RecordLog] = None,
                       surrogates=None, monitor=None, seed: int = 0,
                       offline_compare: bool = True,
                       device=None) -> ServeReport:
    """Run an online tuning session against ``host``'s idle capacity,
    then finish serving the trace under the tuned geometry.

    The session is the stock :class:`~repro_torch.compiler.session.Session` —
    records (warm resume), surrogate transfer, and ``monitor=`` all work
    unchanged; only the executor is the host's idle-slot adapter.  The
    monitor (if any) additionally gains a ``serve`` /status source fed by
    the host.  ``offline_compare=True`` reruns the identical tasks with
    an unconstrained in-process oracle at the same budget and seed — the
    yardstick for "converged to within 10% of offline".  Both sessions run
    their MAPPO nets on ``device`` (default ``cuda``).
    """
    from repro_torch.obs.serve import coerce_monitor
    model = host.model
    t0 = time.perf_counter()
    tasks = serve_tasks(model, host)
    executor = IdleSlotExecutor(host)
    mon, mon_owned = coerce_monitor(monitor)
    serve_src = None
    if mon is not None:
        mon.start()
        serve_src = mon.attach("serve", host.status)
    try:
        session = Session(tasks, tuner=tuner or serve_tuner_config(),
                          budget=budget, records=records,
                          surrogates=surrogates,
                          network=f"serve:{model.arch}",
                          seed=seed, executor=executor, monitor=mon,
                          device=device)
        rep = session.run()
        online: Dict[str, Dict[str, Any]] = {}
        for kind in ("decode", "prefill"):
            r = rep.reports[f"serve:{model.arch}/{kind}"]
            settings = model.settings_of(kind, r.best_config)
            host.apply_best(kind, settings)
            online[kind] = {"settings": settings,
                            "step_s": model.cost_s(kind, settings)}
        host.mark_tuned()
        log.info("online tuning applied; draining the remaining trace",
                 measurements=host.jobs_done, preempted=host.preemptions)
        host.finish_serving()
    finally:
        if mon is not None:
            if serve_src is not None:
                mon.finalize(serve_src)
            if mon_owned:
                mon.stop()
    offline = convergence = None
    if offline_compare:
        off = Session(serve_tasks(model),  # no host: serial in-process
                      tuner=tuner or serve_tuner_config(), budget=budget,
                      seed=seed, device=device).run()
        offline = {}
        convergence = {}
        for kind in ("decode", "prefill"):
            r = off.reports[f"serve:{model.arch}/{kind}"]
            settings = model.settings_of(kind, r.best_config)
            step = model.cost_s(kind, settings)
            offline[kind] = {"settings": settings, "step_s": step}
            convergence[kind] = step / max(online[kind]["step_s"], 1e-12)
    return ServeReport(serve=host.summary(), session=rep, online=online,
                       offline=offline, convergence=convergence,
                       budget=budget, wall_s=time.perf_counter() - t0)
