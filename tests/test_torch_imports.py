"""The PyTorch port stands alone: importing it loads neither jax nor any
module of the reference ``repro`` package, and its sources never import
them."""
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k in ("jax", "jaxlib", "repro") or k.startswith(
                 ("jax.", "jaxlib.", "repro.")))
print(json.dumps({"names": names, "bad": bad}))
"""

# the modules of the later slices (baselines, netopt, surrogate store and
# zoo; the measurement fabric; LM training; MoE and the recurrent
# mixers; placement, roofline and the dry-run; the mesh): each must be
# among the modules imported above
SLICE_MODULES = (
    "repro_torch.core.baselines", "repro_torch.core.shard_space",
    "repro_torch.configs.shapes", "repro_torch.compiler.surrogate_store",
    "repro_torch.compiler.zoo", "repro_torch.compiler.netopt",
    "repro_torch.compiler.netopt.hwspace",
    "repro_torch.compiler.netopt.partition",
    "repro_torch.compiler.netopt.report", "repro_torch.compiler.netopt.loop",
    "repro_torch.compiler.netopt.genetic",
    # the measurement fabric and online serve tuning
    "repro_torch.compiler.executor", "repro_torch.compiler.executor.base",
    "repro_torch.compiler.executor.stub", "repro_torch.compiler.executor.wire",
    "repro_torch.compiler.executor.pool",
    "repro_torch.compiler.executor.remote",
    "repro_torch.compiler.executor.worker", "repro_torch.obs.serve",
    "repro_torch.compiler.serve_tune",
    # LM training
    "repro_torch.data", "repro_torch.data.pipeline",
    "repro_torch.train.steps", "repro_torch.train.checkpoint",
    "repro_torch.train.trainer", "repro_torch.launch.train",
    # the MoE FFN and the recurrent mixers
    "repro_torch.models.moe", "repro_torch.models.ssm",
    # the single-card half of the XLA-bound layer: placement rules, mesh
    # shapes, roofline, the meta-device estimator, dry-run and autotune
    "repro_torch.dist", "repro_torch.dist.sharding",
    "repro_torch.launch.mesh", "repro_torch.hw.roofline",
    "repro_torch.hw.step_analysis", "repro_torch.launch.dryrun",
    "repro_torch.launch.autotune",
    # training and serving over a device mesh: the compressed all-reduce,
    # and the modules the DTensor placements changed
    "repro_torch.optim.compression", "repro_torch.optim.adam",
    "repro_torch.models.layers", "repro_torch.models.transformer",
    "repro_torch.train.steps", "repro_torch.train.checkpoint",
    "repro_torch.train.trainer", "repro_torch.launch.train",
    "repro_torch.launch.mesh", "repro_torch.dist.sharding",
    # the reference's drivers: examples, benchmarks, make_tables,
    # profile_hlo
    "repro_torch.examples", "repro_torch.examples.quickstart",
    "repro_torch.examples.tune_resnet18", "repro_torch.examples.serve_lm",
    "repro_torch.examples.train_lm",
    "repro_torch.examples.arco_sharding_search",
    "repro_torch.benchmarks", "repro_torch.benchmarks.tuning_runs",
    "repro_torch.benchmarks.transfer_runs",
    "repro_torch.benchmarks.serve_runs",
    "repro_torch.benchmarks.measure_throughput",
    "repro_torch.benchmarks.run", "repro_torch.tools",
    "repro_torch.tools.make_tables", "repro_torch.tools.profile_hlo")

# the fabric's modules: a spawned measurement worker or a worker daemon
# loads them and must not pay a torch (or numpy) import; nor does a worker
# of the throughput bench, which re-imports that driver as __mp_main__
_FABRIC_IMPORT = """
import importlib, json, sys
for name in ("repro_torch.compiler.executor",
             "repro_torch.compiler.executor.base",
             "repro_torch.compiler.executor.stub",
             "repro_torch.compiler.executor.wire",
             "repro_torch.compiler.executor.pool",
             "repro_torch.compiler.executor.remote",
             "repro_torch.compiler.executor.worker",
             "repro_torch.obs", "repro_torch.obs.serve",
             "repro_torch.benchmarks.measure_throughput"):
    importlib.import_module(name)
print(json.dumps(sorted(k for k in ("torch", "numpy", "jax")
                        if k in sys.modules)))
"""

_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\s|\.|$)",
                        re.MULTILINE)
# a module of either named in a string, which a spawned worker or
# importlib would load: "repro.compiler.executor.stub:make_stub" (a
# WorkerSpec factory), "repro.obs", "jax"; the bare word "repro" stays a
# name (the Tracer's default, as the reference's)
_FORBIDDEN_STRING = re.compile(
    r"""(?<![\w.])["'](?:(?:jax|jaxlib|repro)(?:\.\w+)+(?::\w+)?"""
    r"""|(?:jax|jaxlib|repro):\w+|jax|jaxlib)["']""")


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout)
    assert len(got["names"]) >= 40, out.stdout
    assert set(SLICE_MODULES) <= set(got["names"])
    assert got["bad"] == [], got["bad"]


def test_fabric_imports_without_torch():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _FABRIC_IMPORT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == []


def _python_files():
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "tests", "_lm_workloads.py")


def test_sources_never_import_jax_or_repro():
    offenders = []
    for path in _python_files():
        with open(path) as f:
            text = f.read()
        for pat in (_FORBIDDEN, _FORBIDDEN_STRING):
            for m in pat.finditer(text):
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
    for line in ('WorkerSpec(factory="repro.compiler.executor.stub:make_stub")',
                 "importlib.import_module('repro.obs.trace')",
                 'resolve_factory("repro:make")', 'find_spec("jax")',
                 "STUB = 'jax.numpy'"):
        assert _FORBIDDEN_STRING.search(line), line
    for line in ('WorkerSpec(factory="repro_torch.compiler.executor.stub:'
                 'make_stub")', 'Tracer(name="repro")',
                 '"src/repro/kernels/gemm.py:48"', '"reprox.a"',
                 '"the reference\'s repro.obs"'):
        assert not _FORBIDDEN_STRING.search(line), line
