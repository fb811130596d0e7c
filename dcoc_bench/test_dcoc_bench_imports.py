"""No module the harness or the reference loads is JAX's or the JAX
package's, compared by whole top-level names (``repro_torch`` begins with
``repro`` and is not it)."""
import glob
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

PROBE = r"""
import json, os, sys
sys.path[:0] = [{root!r}, os.path.join({root!r}, "src")]
{body}
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps(top))
"""


def loaded(body: str) -> set:
    code = PROBE.format(root=ROOT, body=body)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_program():
    top = loaded("import dcoc_bench.reference.cnn, "
                 "dcoc_bench.reference.analytical, "
                 "dcoc_bench.reference.networks, dcoc_bench.roofline")
    assert not top & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_harness_and_what_it_drives_load_no_jax():
    """Every harness file, generator and reader, and the program's
    modules the generators drive."""
    body = "\n".join([
        "from dcoc_bench import harness, devtrace, spans, roofline",
        "import glob",
        "for p in sorted(glob.glob(os.path.join(harness.BENCH_DIR, "
        "'metrics', '*.py'))):",
        "    harness._module(p)",
        "for k in ('tune_sessions', 'closed_loop_forward'):",
        "    harness.generator(k)",
        "import repro_torch.compiler.session, repro_torch.compiler.task",
        "import repro_torch.core.tuner, repro_torch.core.baselines",
        "import repro_torch.models.cnn, repro_torch.kernels.gemm",
        "import repro_torch.models.specs, repro_torch.core.task",
    ])
    top = loaded(body)
    assert "repro_torch" in top and "torch" in top
    assert not top & set(__import__("dcoc_bench.harness",
                                    fromlist=["FORBIDDEN"]).FORBIDDEN)


def test_sources_name_no_jax_module():
    """No harness file imports ``jax``, ``jaxlib``, ``flax`` or
    ``repro`` (as a whole top-level name)."""
    import re
    bad = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|flax|repro)\b"
                     r"(?!_)", re.M)
    files = glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True)
    assert files
    for path in files:
        with open(path) as f:
            assert not bad.search(f.read()), path
