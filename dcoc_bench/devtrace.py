"""From a ``torch.profiler`` trace to the device's busy time, idle gaps and
top operations.

:func:`profiled` runs a function under the profiler (CPU and CUDA
activity) and reduces the trace to a :class:`DeviceTrace`: every device
activity (kernels, copies, sets) and the host events of the thread that
ran the function, in microseconds on the profiler's one clock.  The
window is the extent of the host annotation named ``window``
(``torch.profiler.record_function``), from its first start to its last
end.

Busy time is the union of the device intervals inside the window, so
activities that overlap are counted once.  An idle gap is a stretch of the
window with no device activity; it is named by what the host was doing at
its middle: the innermost annotation and the innermost host event there.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

Interval = Tuple[float, float, str]   # (start_us, end_us, name)


@dataclasses.dataclass
class DeviceTrace:
    device: List[Interval]
    host: List[Interval]         # the traced thread's events
    annotations: Set[str]        # host event names that label a phase
    window: Tuple[float, float]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def _clipped(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        return sorted((max(s, lo), min(e, hi)) for s, e, _ in self.device
                      if e > lo and s < hi)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device intervals inside the window."""
        out: List[List[float]] = []
        for s, e in self._clipped():
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def gaps(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        out, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out

    def device_seconds(self, keep: Callable[[str], bool]) -> float:
        """Summed durations (not their union) of the device activities
        inside the window whose name ``keep`` accepts."""
        lo, hi = self.window
        return sum(e - s for s, e, n in self.device
                   if s >= lo and e <= hi and keep(n)) / 1e6

    def top_ops(self, top: int = 10) -> List[list]:
        """Device activities by name, their summed seconds, largest
        first."""
        lo, hi = self.window
        by: Dict[str, float] = {}
        for s, e, n in self.device:
            if s >= lo and e <= hi:
                by[n] = by.get(n, 0.0) + (e - s) / 1e6
        return [[n, v] for n, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_by_host(self, top: int = 10) -> List[list]:
        """Idle seconds summed by what the host was doing at each gap's
        middle (``annotation/event``), largest first."""
        gaps = self.gaps()
        mids = sorted(((s + e) / 2.0, e - s) for s, e in gaps)
        events = sorted(self.host, key=lambda t: (t[0], -t[1]))
        stack: List[Interval] = []
        by: Dict[str, float] = {}
        i = 0
        for mid, dur in mids:
            while i < len(events) and events[i][0] <= mid:
                while stack and stack[-1][1] <= events[i][0]:
                    stack.pop()
                stack.append(events[i])
                i += 1
            while stack and stack[-1][1] <= mid:
                stack.pop()
            inner = [ev for ev in stack if ev[0] <= mid < ev[1]]
            note = next((ev[2] for ev in reversed(inner)
                         if ev[2] in self.annotations), "")
            op = inner[-1][2] if inner else "host"
            name = op if not note or note == op else f"{note}/{op}"
            by[name] = by.get(name, 0.0) + dur / 1e6
        return [[n, v] for n, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_by_host()}


def reduce(events: Iterable, window: str,
           annotations: Iterable[str]) -> Optional[DeviceTrace]:
    """A :class:`DeviceTrace` of the profiler's function events, or None
    where the trace holds no ``window`` annotation or no device
    activity.  Device events that mirror a host annotation are left
    out."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    names = set(annotations) | {window}
    dev: List[Interval] = []
    host: List[Tuple[float, float, str, object]] = []
    for e in events:
        tr = e.time_range
        if e.device_type == cuda:
            # an annotation's range mirrored on the device timeline is
            # no device work
            if not (getattr(e, "is_user_annotation", False)
                    or e.name in names):
                dev.append((float(tr.start), float(tr.end), e.name))
        else:
            host.append((float(tr.start), float(tr.end), e.name, e.thread))
    marks = [h for h in host if h[2] == window]
    if not marks or not dev:
        return None
    thread = marks[0][3]
    return DeviceTrace(
        device=dev,
        host=[(s, e, n) for s, e, n, t in host if t == thread],
        annotations=names,
        window=(min(m[0] for m in marks), max(m[1] for m in marks)))


def profiled(fn: Callable[[], object], window: str,
             annotations: Iterable[str] = ()) -> Optional[DeviceTrace]:
    """Run ``fn`` under ``torch.profiler`` and reduce its trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return reduce(prof.events(), window, annotations)
