"""Wire protocol for the remote measurement fabric (a copy of the
reference's: ``PROTOCOL_VERSION`` and every frame are byte-identical, so a
daemon of either package serves an executor of the other).

One framing, both sides: a frame is a 4-byte big-endian payload length
followed by a UTF-8 JSON object.  Every message carries a ``"type"``; the
handshake additionally carries the protocol ``"version"`` so a stale
daemon and a newer executor fail loudly instead of mis-parsing each
other.  Message types:

``hello``          client -> worker: opens a session, names the version.
``capabilities``   worker -> client: the handshake reply — a
                   :class:`WorkerCapabilities` descriptor (device count,
                   backend, env pins, job slots) the executor routes
                   against.
``job``            client -> worker: one measurement — job id, task name,
                   decoded settings, and the serialized
                   :class:`~repro_torch.compiler.executor.base.WorkerSpec`.
``started``        worker -> client: the measure fn is running (factory
                   resolved); the executor re-arms the job's timeout from
                   this ack so daemon-side startup is never billed to the
                   configuration being measured.
``result``         worker -> client: ``{job_id, ok, value | error}``.
                   Since minor 1 it may carry a ``"span"`` object —
                   ``{name, cat, t_wall, dur_s}``, the daemon's own
                   timing of the measure fn — which the executor merges
                   into the session's ambient tracer (``repro_torch.obs``).
``heartbeat``      either direction: liveness; the executor declares a
                   connection dead after ``heartbeat_timeout_s`` without
                   any inbound frame.  Since minor 1 daemon-side
                   heartbeats may carry a ``"load"`` object — ``{busy,
                   jobs_done, mean_measure_s}`` — surfaced per endpoint
                   in ``RemoteExecutor.stats()``.
``shutdown``       client -> worker: close this connection cleanly
                   (``scope: "daemon"`` stops the whole daemon — used by
                   tests and fleet teardown).
``error``          worker -> client: handshake-level rejection.

Everything here is stdlib-only and torch-free (the executor package's
import-light rule).  The protocol is **trusted-network-only**: frames are
neither authenticated nor encrypted, and a job names an importable
factory the worker will call — never expose a daemon beyond a network
where every peer may already run arbitrary code.
"""
from __future__ import annotations

import dataclasses
import json
import re
import socket
import struct
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.compiler.executor.base import WorkerSpec

PROTOCOL_VERSION = 1
# Minor revisions are additive-only: new *optional* keys on existing
# frame types (result ``span``, heartbeat ``load``), which both sides
# already ignore when unknown.  The handshake advertises ``minor`` but
# never rejects on it — an old daemon (no minor field) still speaks to a
# new executor and vice versa; only the major ``version`` gates.
PROTOCOL_MINOR = 1
_LEN = struct.Struct(">I")
# A settings dict plus a spec is tiny; 64 MiB guards against a garbage
# peer making the receiver allocate unbounded memory, not real payloads.
MAX_FRAME_BYTES = 64 << 20


class ProtocolError(RuntimeError):
    """Malformed frame or version/handshake mismatch."""


def encode_frame(msg: Dict[str, object]) -> bytes:
    payload = json.dumps(msg, separators=(",", ":"), default=str).encode()
    if len(payload) > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame of {len(payload)} bytes exceeds "
                            f"{MAX_FRAME_BYTES}")
    return _LEN.pack(len(payload)) + payload


class FrameBuffer:
    """Incremental decoder: feed raw socket bytes, get whole messages."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[Dict[str, object]]:
        self._buf.extend(data)
        out: List[Dict[str, object]] = []
        while True:
            if len(self._buf) < _LEN.size:
                return out
            (n,) = _LEN.unpack_from(self._buf)
            if n > MAX_FRAME_BYTES:
                raise ProtocolError(f"peer announced a {n}-byte frame "
                                    f"(max {MAX_FRAME_BYTES})")
            if len(self._buf) < _LEN.size + n:
                return out
            payload = bytes(self._buf[_LEN.size:_LEN.size + n])
            del self._buf[:_LEN.size + n]
            try:
                msg = json.loads(payload)
            except ValueError as e:
                raise ProtocolError(f"undecodable frame: {e}") from None
            if not isinstance(msg, dict) or "type" not in msg:
                raise ProtocolError(f"frame without a type: {msg!r}")
            out.append(msg)


def send_frame(sock: socket.socket, msg: Dict[str, object]) -> None:
    sock.sendall(encode_frame(msg))


def recv_frame(sock: socket.socket,
               timeout_s: Optional[float] = None) -> Dict[str, object]:
    """Blocking single-frame read (handshakes only — steady-state traffic
    goes through :class:`FrameBuffer` under a selector)."""
    sock.settimeout(timeout_s)
    buf = FrameBuffer()
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while True:
        data = sock.recv(65536)
        if not data:
            raise ProtocolError("connection closed mid-frame")
        msgs = buf.feed(data)
        if msgs:
            if len(msgs) > 1:
                raise ProtocolError("unexpected pipelined handshake frames")
            return msgs[0]
        if deadline is not None and time.monotonic() > deadline:
            raise socket.timeout("frame incomplete within timeout")


# --------------------------------------------------------------- endpoints

def parse_endpoints(remote) -> List[Tuple[str, int]]:
    """``"h1:p1,h2:p2"`` (or a sequence of ``"h:p"``) -> [(host, port)].
    IPv6 literals use ``[addr]:port``."""
    if isinstance(remote, str):
        parts: Sequence[str] = [p for p in remote.split(",") if p.strip()]
    else:
        parts = list(remote)
    if not parts:
        raise ValueError("no remote endpoints given")
    out: List[Tuple[str, int]] = []
    for p in parts:
        p = p.strip()
        m = re.match(r"^\[(.+)\]:(\d+)$", p)  # [v6]:port
        if m:
            out.append((m.group(1), int(m.group(2))))
            continue
        host, sep, port = p.rpartition(":")
        if not sep or not port.isdigit():
            raise ValueError(f"endpoint {p!r} is not HOST:PORT")
        out.append((host or "127.0.0.1", int(port)))
    return out


def endpoint_label(addr: Tuple[str, int]) -> str:
    return f"{addr[0]}:{addr[1]}"


# ------------------------------------------------------------ capabilities

@dataclasses.dataclass(frozen=True)
class WorkerCapabilities:
    """What one daemon advertises at handshake — the WorkerSpec-shaped
    half the executor routes on (``device_count``/``backend``/``env``
    mirror the spec's env pins) plus scheduling facts (``slots``)."""

    slots: int = 1
    backend: str = "cpu"
    device_count: Optional[int] = None  # None = serves any topology
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    pid: int = 0
    host: str = ""

    def to_wire(self) -> Dict[str, object]:
        return {"type": "capabilities", "version": PROTOCOL_VERSION,
                "minor": PROTOCOL_MINOR,
                "slots": self.slots, "backend": self.backend,
                "device_count": self.device_count, "env": dict(self.env),
                "pid": self.pid, "host": self.host}

    @staticmethod
    def from_wire(msg: Dict[str, object]) -> "WorkerCapabilities":
        if msg.get("type") == "error":
            raise ProtocolError(f"daemon rejected handshake: "
                                f"{msg.get('error', 'unknown')}")
        if msg.get("type") != "capabilities":
            raise ProtocolError(f"expected capabilities, got {msg!r}")
        if msg.get("version") != PROTOCOL_VERSION:
            raise ProtocolError(
                f"protocol version mismatch: daemon speaks "
                f"{msg.get('version')}, this executor speaks "
                f"{PROTOCOL_VERSION}")
        dc = msg.get("device_count")
        return WorkerCapabilities(
            slots=max(int(msg.get("slots", 1)), 1),
            backend=str(msg.get("backend", "cpu")),
            device_count=None if dc is None else int(dc),
            env={str(k): str(v) for k, v in (msg.get("env") or {}).items()},
            pid=int(msg.get("pid", 0)), host=str(msg.get("host", "")))


_DEVICE_PIN = re.compile(r"--xla_force_host_platform_device_count=(\d+)")


def device_count_pin(env) -> Optional[int]:
    """The placeholder device count a spec's env pins (via ``XLA_FLAGS``),
    or None when the spec doesn't care about topology.  Part of the wire
    contract shared with the reference (its compile oracle pins this way);
    routing only compares the numbers."""
    m = _DEVICE_PIN.search(str((env or {}).get("XLA_FLAGS", "")))
    return int(m.group(1)) if m else None


def spec_compatible(spec: Optional[WorkerSpec],
                    caps: WorkerCapabilities) -> bool:
    """Can this daemon serve jobs of this spec?  Heterogeneous-pool
    routing: a spec pinning a device count only matches daemons
    advertising that count (or none — a wildcard daemon applies the pin
    itself at factory resolution); any other env pin the daemon
    *advertises* must agree (pins it doesn't advertise are applied
    daemon-side with the worker-pool conflict semantics)."""
    if spec is None:
        return True
    want = device_count_pin(spec.env)
    if (want is not None and caps.device_count is not None
            and caps.device_count != want):
        return False
    for k, v in spec.env.items():
        if k == "XLA_FLAGS":
            continue  # topology handled above; full-string equality is
            #           too strict (flag order, unrelated flags)
        if k in caps.env and caps.env[k] != str(v):
            return False
    return True


# ------------------------------------------------------------ spec on wire

def spec_to_wire(spec: WorkerSpec) -> Dict[str, object]:
    return {"factory": spec.factory, "args": list(spec.args),
            "kwargs": dict(spec.kwargs), "env": dict(spec.env)}


def spec_from_wire(d: Dict[str, object]) -> WorkerSpec:
    return WorkerSpec(factory=str(d["factory"]),
                      args=tuple(d.get("args") or ()),
                      kwargs=dict(d.get("kwargs") or {}),
                      env={str(k): str(v)
                           for k, v in (d.get("env") or {}).items()})
