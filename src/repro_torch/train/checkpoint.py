"""Checkpointing in the reference's format: compressed msgpack, atomic,
async, checked.

Layout:   <dir>/step_<N>/manifest.msgpack       (leaf shapes, dtypes, crc32)
          <dir>/step_<N>/data.msgpack.zst       (compressed leaf bytes)

The files are the reference's (``repro/train/checkpoint.py``), so either
package reads a checkpoint the other wrote (``restore(target=None)``
gives the flat ``{key: array}`` dict in both):

  * atomic publish: written to ``step_<N>.tmp`` then renamed, so a crash
    mid-save never corrupts the latest checkpoint;
  * integrity: a crc32 of each leaf's raw bytes, checked on load;
  * async: one background writer thread, fed a *copy* of the tree taken
    in the caller's thread (``tensor.cpu()`` of a CPU tensor is the same
    storage, which the in-place optimizer would change under the writer);
    ``wait()`` drains it;
  * keep-last-k garbage collection;
  * codec: ``zstd`` where ``zstandard`` imports, else stdlib ``zlib`` (the
    reference's ``DEFAULT_CODEC`` rule); the manifest records it, and a
    ``zstd`` checkpoint without ``zstandard`` raises.

Two things the reference takes from packages the port does without:
msgpack (a stdlib subset here, :func:`packb`/:func:`unpackb`, byte-
identical to ``msgpack.packb`` for everything a checkpoint holds) and
numpy's bfloat16 (a bf16 leaf is written as its raw 2-byte words under the
reference's dtype name ``"bfloat16"``, and read back through
``torch.int16`` viewed as ``torch.bfloat16``).

Leaf keys are the tree's dict keys (sorted, as jax flattens a dict) and
list indices joined by ``/``, as the reference joins its key paths.  The
port's LM tree lists its layers (``params/layers/<i>/...``) where the
reference stacks them, so the two packages' LM checkpoints share the file
format, not the layer layout.

Under a device mesh (DTensor leaves) every rank gathers each leaf whole
(``full_tensor()``) on its calling thread, rank 0 writes, and the others
wait at a barrier (after the write, where a save is async): no collective
runs in the writer thread.  ``restore(shardings=, device_mesh=)`` places
every leaf on a mesh, whatever mesh or package wrote it (elastic
restore); the file format is the same.
"""
from __future__ import annotations

import os
import shutil
import struct
import threading
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

try:                         # optional dep: fall back to stdlib zlib when
    import zstandard as zstd  # zstandard isn't installed; the manifest
except ImportError:           # records which codec wrote each checkpoint.
    zstd = None

DEFAULT_CODEC = "zstd" if zstd is not None else "zlib"


def _compress_fn(codec: str):
    if codec == "zstd":
        return zstd.ZstdCompressor(level=3).compress
    return lambda raw: zlib.compress(raw, 6)


def _decompress_fn(codec: str):
    if codec == "zstd":
        if zstd is None:
            raise ImportError(
                "checkpoint was written with the zstd codec but the "
                "zstandard package is not installed")
        return zstd.ZstdDecompressor().decompress
    return zlib.decompress


# ------------------------------------------------------------- msgpack

def _header(n: int, fix: Optional[Tuple[int, int]], codes: Tuple[int, ...],
            out: List[bytes]) -> None:
    """A length header: the fix form (base, largest n) where it fits,
    else the first of the 8/16/32-bit ``codes`` (0 where a width has no
    code) that holds n."""
    if fix is not None and n <= fix[1]:
        out.append(struct.pack("B", fix[0] | n))
        return
    for code, fmt, top in zip(codes, ("B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= top:
            out.append(struct.pack(">B", code) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack object of length {n} is too large")


_INT_FORMS = (  # (low, high, prefix code or None for fixint, struct format)
    (0, 0x7F, None, "B"), (-0x20, -1, None, "b"),
    (0x80, 0xFF, 0xCC, "B"), (-0x80, -1, 0xD0, "b"),
    (0x100, 0xFFFF, 0xCD, ">H"), (-0x8000, -0x81, 0xD1, ">h"),
    (0x10000, 0xFFFFFFFF, 0xCE, ">I"), (-0x80000000, -0x8001, 0xD2, ">i"),
    (0x100000000, 0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"),
    (-0x8000000000000000, -0x80000001, 0xD3, ">q"))


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        for low, high, code, fmt in _INT_FORMS:
            if low <= obj <= high:
                out.append((b"" if code is None else bytes([code]))
                           + struct.pack(fmt, obj))
                return
        raise OverflowError("Integer value out of range")
    elif isinstance(obj, (bytes, bytearray)):
        _header(len(obj), None, (0xC4, 0xC5, 0xC6), out)
        out.append(bytes(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _header(len(raw), (0xA0, 0x1F), (0xD9, 0xDA, 0xDB), out)
        out.append(raw)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), (0x90, 0x0F), (0, 0xDC, 0xDD), out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _header(len(obj), (0x80, 0x0F), (0, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"Cannot serialize {obj!r}")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj)`` (its defaults: bin type on, floats as
    float64) for None, bool, int, float, str, bytes, list/tuple and dict."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: "B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENGTHS = {0xC4: ("bin", "B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xD9: ("str", "B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("list", ">H"), 0xDD: ("list", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def _unpack(buf: memoryview, pos: int) -> Tuple[Any, int]:
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        kind, n = "map", b & 0x0F
    elif 0x90 <= b <= 0x9F:
        kind, n = "list", b & 0x0F
    elif 0xA0 <= b <= 0xBF:
        kind, n = "str", b & 0x1F
    elif b in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[b], pos
    elif b in _FIXED:
        fmt = _FIXED[b]
        return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)
    elif b in _LENGTHS:
        kind, fmt = _LENGTHS[b]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
    else:
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")
    if kind == "bin":
        return bytes(buf[pos:pos + n]), pos + n
    if kind == "str":
        return str(buf[pos:pos + n], "utf-8"), pos + n
    if kind == "list":
        items = []
        for _ in range(n):
            item, pos = _unpack(buf, pos)
            items.append(item)
        return items, pos
    out = {}
    for _ in range(n):
        key, pos = _unpack(buf, pos)
        out[key], pos = _unpack(buf, pos)
    return out, pos


def unpackb(data: bytes) -> Any:
    """``msgpack.unpackb(data)`` (strings decoded, arrays as lists) for
    what :func:`packb` writes, and float32 too."""
    buf = memoryview(data)
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} bytes left after the msgpack "
                         f"object")
    return obj


# --------------------------------------------------------------- trees

def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) pairs of a tree of dicts, lists and tuples: dict keys in
    sorted order (as jax flattens a dict), sequence items by index, the
    path joined by ``/``."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` applied to every leaf, the structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _host_copy(leaf: torch.Tensor) -> torch.Tensor:
    """A host copy no later in-place update of ``leaf`` can reach (a
    DTensor's whole value, gathered here)."""
    from repro_torch.dist.sharding import whole
    return whole(leaf.detach()).to("cpu", copy=True)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _sharded(tree: Any) -> bool:
    return any(isinstance(leaf, DTensor) for _, leaf in flatten(tree))


def _barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _leaf_bytes(leaf: torch.Tensor) -> Tuple[bytes, List[int], str]:
    """(raw bytes, shape, dtype name) of a tensor leaf."""
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return (t.view(torch.int16).numpy().tobytes(), list(t.shape),
                "bfloat16")
    arr = t.numpy()
    return arr.tobytes(), list(arr.shape), str(arr.dtype)


def _leaf_tensor(raw: bytes, dtype: str, shape: List[int]) -> torch.Tensor:
    if dtype == "bfloat16":
        words = np.frombuffer(raw, dtype=np.int16).copy()
        return torch.from_numpy(words).view(torch.bfloat16).reshape(shape)
    return torch.from_numpy(np.frombuffer(raw, dtype=dtype).copy()
                            ).reshape(shape)


# ---------------------------------------------------------- save / load

def save(path: str, step: int, tree: Any,
         meta: Optional[Dict[str, Any]] = None) -> str:
    """Synchronous atomic checkpoint write of a tree of tensors. Returns
    the final directory.  A tree with DTensor leaves is a collective:
    every rank calls it, the leaves are gathered, rank 0 writes and the
    others wait for it at a barrier."""
    final = os.path.join(path, f"step_{step:08d}")
    if _sharded(tree):
        host = tree_map(_host_copy, tree)
        if _rank() == 0:
            _write(path, step, host, meta)
        _barrier()
        return final
    return _write(path, step, tree, meta)


def _write(path: str, step: int, tree: Any,
           meta: Optional[Dict[str, Any]]) -> str:
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)

    compress = _compress_fn(DEFAULT_CODEC)
    blobs: Dict[str, bytes] = {}
    manifest = {"step": step, "meta": meta or {}, "leaves": {},
                "codec": DEFAULT_CODEC}
    for key, leaf in flatten(tree):
        raw, shape, dtype = _leaf_bytes(leaf)
        blobs[key] = compress(raw)
        manifest["leaves"][key] = {"shape": shape, "dtype": dtype,
                                   "crc": zlib.crc32(raw)}
    with open(os.path.join(tmp, "data.msgpack.zst"), "wb") as f:
        f.write(packb(blobs))
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(packb(manifest))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def available_steps(path: str) -> List[int]:
    if not os.path.isdir(path):
        return []
    steps = []
    for d in os.listdir(path):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                steps.append(int(d[5:]))
            except ValueError:
                pass
    return sorted(steps)


def restore(path: str, step: Optional[int] = None, target: Any = None,
            shardings: Any = None, device_mesh=None
            ) -> Tuple[int, Any, Dict[str, Any]]:
    """Load a checkpoint (the latest where ``step`` is None).

    Without ``target``: returns (step, flat {key: CPU tensor}, meta).
    With ``target`` (a tree of tensors with the checkpoint's keys): copies
    each leaf into the target's tensor in place, cast to its dtype and
    moved to its device (a DTensor takes its own shards), and returns
    (step, target, meta).  With ``shardings`` too (a ``NamedSharding``
    tree of ``repro_torch.dist.sharding`` matching ``target``, which may
    then be ``meta`` tensors) and ``device_mesh``: returns a new tree of
    DTensors in the target's dtypes, each placed on the mesh (the
    reference's elastic re-placement); every rank reads the files."""
    steps = available_steps(path)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {path}")
    step = step if step is not None else steps[-1]
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
        manifest = unpackb(f.read())
    with open(os.path.join(d, "data.msgpack.zst"), "rb") as f:
        blobs = unpackb(f.read())
    # pre-codec checkpoints carry no codec field and are always zstd
    decompress = _decompress_fn(manifest.get("codec", "zstd"))

    arrays: Dict[str, torch.Tensor] = {}
    for key, info in manifest["leaves"].items():
        raw = decompress(blobs[key])
        if zlib.crc32(raw) != info["crc"]:
            raise IOError(f"checkpoint corruption in leaf {key}")
        arrays[key] = _leaf_tensor(raw, info["dtype"], info["shape"])

    if target is None:
        return step, arrays, manifest["meta"]
    if shardings is not None:
        from repro_torch.dist import sharding as SH
        if device_mesh is None:
            raise ValueError("restore(shardings=...) needs device_mesh")
        flat = dict(flatten(target))
        cast = {}
        for key, leaf in flat.items():
            arr = arrays[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{tuple(arr.shape)} vs {tuple(leaf.shape)}")
            cast[key] = arr.to(leaf.dtype)
        tree = unflatten_like(target, cast)
        return step, SH.distribute_tree(tree, shardings, device_mesh), \
            manifest["meta"]
    copy_into(target, arrays)
    return step, target, manifest["meta"]


def unflatten_like(target: Any, leaves: Dict[str, Any],
                   prefix: str = "") -> Any:
    """``target``'s structure with each leaf replaced by ``leaves[key]``
    (keys as :func:`flatten` gives them)."""
    if isinstance(target, dict):
        return {k: unflatten_like(v, leaves, f"{prefix}/{k}" if prefix
                                  else str(k)) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(unflatten_like(v, leaves, f"{prefix}/{i}"
                                           if prefix else str(i))
                            for i, v in enumerate(target))
    return leaves[prefix]


@torch.no_grad()
def copy_into(target: Any, arrays: Dict[str, torch.Tensor]) -> None:
    """Copy each leaf of ``arrays`` (a :func:`restore` without target)
    into the tensor of ``target`` under the same key, in place, cast to its
    dtype and moved to its device (a DTensor leaf takes its own shards)."""
    from repro_torch.dist.sharding import copy_whole
    for key, leaf in flatten(target):
        arr = arrays[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(arr.shape)} vs {tuple(leaf.shape)}")
        copy_whole(leaf, arr)


class CheckpointManager:
    """Async writer + keep-last-k retention."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        os.makedirs(path, exist_ok=True)
        self._lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._unsynced = False   # a sharded async save not yet barriered

    def save_async(self, step: int, tree: Any,
                   meta: Optional[Dict[str, Any]] = None) -> None:
        """Write in the background.  The tree is copied to host memory
        now (training updates the tensors after); DTensor leaves are
        gathered here, on every rank, and only rank 0 starts a writer."""
        sharded = _sharded(tree)
        host_tree = tree_map(_host_copy, tree)
        self.wait()
        self._unsynced = sharded
        if sharded and _rank() != 0:
            return

        def work():
            try:
                _write(self.path, step, host_tree, meta)
                self._gc()
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()

    def save_sync(self, step: int, tree: Any,
                  meta: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        save(self.path, step, tree, meta)
        if _rank() == 0:
            self._gc()
        if _sharded(tree):
            _barrier()

    def wait(self) -> None:
        """Drain the writer; raise what it raised.  After a sharded save
        every rank waits here for rank 0's write to land."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._unsynced:
            self._unsynced = False
            _barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self) -> Optional[int]:
        steps = available_steps(self.path)
        return steps[-1] if steps else None

    def _gc(self) -> None:
        with self._lock:
            steps = available_steps(self.path)
            for s in steps[:-self.keep]:
                shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                              ignore_errors=True)
