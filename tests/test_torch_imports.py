"""The PyTorch port stands alone: importing it loads neither jax nor any
module of the reference ``repro`` package, and its sources never import
them."""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k in ("jax", "jaxlib", "repro") or k.startswith(
                 ("jax.", "jaxlib.", "repro.")))
print(len(names), bad)
"""

_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\s|\.|$)",
                        re.MULTILINE)


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 30, out.stdout
    assert bad == "[]", bad


def _python_files():
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_sources_never_import_jax_or_repro():
    offenders = []
    for path in _python_files():
        with open(path) as f:
            for m in _FORBIDDEN.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, ROOT)}: "
                                 f"{m.group(0).strip()}")
    assert not offenders, offenders


def test_forbidden_pattern_catches_reference_imports():
    for line in ("import jax", "import jax.numpy as jnp", "from repro import obs",
                 "from repro.core import mappo", "  import repro"):
        assert _FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import mappo",
                 "import jaxtyping"):
        assert not _FORBIDDEN.search(line), line
