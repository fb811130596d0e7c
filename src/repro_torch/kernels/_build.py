"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface.  :func:`build`
compiles it with ``nvcc`` for ``sm_90a`` into a shared library in
``_build/`` next to this file (listed in ``.gitignore``), named by a hash
of the source content, so a source change rebuilds under a new name and an
unchanged source is compiled once.  ``nvcc -Xptxas -v`` reports each
kernel's registers, spills and static shared memory; the report is kept
beside the library and :func:`ptxas_report` reads it.  :func:`load` opens
the library with ``ctypes`` once per process and lets the kernel's module
declare its functions' argument types.  :func:`build_all` starts one
``nvcc`` per source at the same time.

Nothing here runs at import: the kernels are built at first use, on a
machine with the CUDA toolkit.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
# The card every kernel is built for (sm_90a): an H100 SXM, whose SMs the
# launch geometries fill (GEMM split-K, the flash and MLA KV splits, the
# RMSNorm grid)
SM_COUNT = 132

_LIBS: Dict[str, ctypes.CDLL] = {}


def source(name: str) -> str:
    """Path of ``csrc/<name>.cu``."""
    return os.path.join(CSRC, f"{name}.cu")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _library(name: str) -> str:
    with open(source(name), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` for sm_90a into a shared library (once
    per source content) and return its path."""
    path = _library(name)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
           "-o", tmp, source(name)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu ({res.returncode}):"
                               f"\n{res.stdout}{res.stderr}")
        with open(path[:-3] + ".ptxas", "w") as f:
            f.write(res.stderr)
        os.replace(tmp, path)  # atomic: a half-written library never loads
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def build_all(names: Iterable[str]) -> Dict[str, float]:
    """Build every named source, one ``nvcc`` each, all started together;
    returns each build's seconds (a source already built takes ~0)."""

    def timed(name: str) -> float:
        t0 = time.perf_counter()
        build(name)
        return time.perf_counter() - t0

    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(timed, names)))


def _demangle(names: List[str]) -> List[str]:
    """``cu++filt -p`` (beside ``nvcc``) on mangled kernel names: each
    function with its template arguments, without the parameter types, the
    anonymous namespace or the literals' casts, e.g.
    ``flash_mma_kernel<64, 64, 128>``."""
    if not names:
        return []
    filt = os.path.join(os.path.dirname(_nvcc()), "cu++filt")
    res = subprocess.run([filt, "-p", *names], capture_output=True,
                         text=True, check=True)
    out = [re.sub(r"^void |<unnamed>::|\((?:int|bool)\)", "", line.strip())
           for line in res.stdout.splitlines() if line.strip()]
    if len(out) != len(names):
        raise RuntimeError(f"cu++filt gave {len(out)} names for "
                           f"{len(names)}:\n{res.stdout}")
    return out


def ptxas_report(name: str) -> List[dict]:
    """What ``ptxas -v`` said of each kernel of the built ``csrc/<name>.cu``:
    ``kernel`` (the function's name and its template arguments, e.g.
    ``flash_mma_kernel<64, 64, 128>``), ``registers``, ``spill_stores``
    and ``spill_loads`` (bytes) and ``static_smem`` (bytes; dynamic shared
    memory is set at launch and not in the report)."""
    with open(build(name)[:-3] + ".ptxas") as f:
        text = f.read()
    out = []
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            out.append({"kernel": entry.group(1),
                        "registers": 0, "spill_stores": 0, "spill_loads": 0,
                        "static_smem": 0})
            continue
        if not out:
            continue
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
        if spills:
            out[-1]["spill_stores"] = int(spills.group(1))
            out[-1]["spill_loads"] = int(spills.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out[-1]["registers"] = int(regs.group(1))
        smem = re.search(r"(\d+) bytes smem", line)
        if smem:
            out[-1]["static_smem"] = int(smem.group(1))
    for r, name in zip(out, _demangle([r["kernel"] for r in out])):
        r["kernel"] = name
    return out


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if need be and opened once;
    ``bind`` sets its functions' ``argtypes``/``restype`` on first open."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        bind(lib)
        _LIBS[name] = lib
    return lib
