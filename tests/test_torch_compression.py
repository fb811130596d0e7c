"""The port's int8 error-feedback all-reduce (``repro_torch.optim.
compression``) against the reference's ``compressed_psum_mean`` under
``shard_map``: the same seeded per-rank gradients and error states, 4
ranks, the synced gradients exactly equal, the new errors exactly equal
but where the reference's compiled loop rounds ``q * scale`` before the
subtraction (its scalar remainders; see the test); then the reference's
toy quadratic trained by ``make_ddp_compressed_step`` on 4 CPU ranks over
gloo.  The reference runs in a subprocess with 4 placeholder host
devices, as ``tests/test_distributed.py`` runs it."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from _torch_dist import run_ranks
from _torch_support import one_torch_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
WORLD = 4
# leaf -> per-rank shape; "zero" is all zeros on every rank (its scale is
# the 1e-12 floor), "wide" spans magnitudes, so rounding hits every step
SHAPES = {"a": (8, 3), "b": (5,), "wide": (4, 16), "zero": (3, 2)}

_REFERENCE = """
import sys
import numpy as np
import jax
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_host_mesh
from repro.optim import compression as C

data = np.load(sys.argv[1])
keys = sorted(k[2:] for k in data.files if k.startswith("g_"))
g = {k: data["g_" + k] for k in keys}
e = {k: data["e_" + k] for k in keys}
mesh = make_host_mesh(%d, 1)
f = jax.jit(shard_map(lambda g, e: C.compressed_psum_mean(g, e, "data"),
                      mesh=mesh, in_specs=(P("data"), P("data")),
                      out_specs=(P("data"), P("data")), check_rep=False))
synced, err = f(g, e)
np.savez(sys.argv[2], **{"s_" + k: np.asarray(v) for k, v in synced.items()},
         **{"e_" + k: np.asarray(v) for k, v in err.items()})
""" % WORLD


def _inputs(path) -> None:
    """Seeded per-rank gradients and error states, stacked (WORLD, ...)."""
    rng = np.random.default_rng(7)
    arrays = {}
    for k, shape in SHAPES.items():
        g = rng.normal(size=(WORLD,) + shape).astype(np.float32)
        if k == "wide":
            g *= np.float32(10.0) ** rng.integers(-4, 3, size=g.shape)
        e = (rng.normal(size=g.shape) * 1e-2).astype(np.float32)
        if k == "zero":
            g, e = np.zeros_like(g), np.zeros_like(e)
        arrays["g_" + k], arrays["e_" + k] = g, e
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the reference's outputs, the port's per-rank results)."""
    tmp = tmp_path_factory.mktemp("compression")
    inputs, ref_out = str(tmp / "in.npz"), str(tmp / "ref.npz")
    _inputs(inputs)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                          inputs, ref_out], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    port = run_ranks("compression", WORLD, tmp / "ranks", timeout=240,
                     inputs=inputs)
    ref = dict(np.load(ref_out), inputs=inputs)
    return ref, port


@pytest.mark.parametrize("leaf", sorted(SHAPES))
def test_synced_gradients_equal_the_reference(both, leaf):
    ref, port = both
    for rank, got in enumerate(port):
        np.testing.assert_array_equal(got["synced"][leaf][0],
                                      ref["s_" + leaf][rank],
                                      err_msg=f"rank {rank}")


def _error_forms(tmp_inputs, leaf):
    """The new error ``g - q * scale`` rounded once (fused) and twice, in
    numpy, from the inputs and the scale the reference compiles."""
    data = np.load(tmp_inputs)
    g = data["g_" + leaf] + data["e_" + leaf]
    scale = np.float32(max(np.abs(g).max(), np.float32(1e-12))
                       * np.float32(1 / 127))
    q = np.clip(np.round(g / scale), -127, 127)
    once = (g.astype(np.float64) - q * np.float64(scale)).astype(np.float32)
    twice = g - (q.astype(np.float32) * scale)
    return once, twice


@pytest.mark.parametrize("leaf", sorted(SHAPES))
def test_new_errors_equal_the_reference_up_to_its_unfused_tail(both, leaf):
    """The port rounds ``g - q * scale`` once, as the reference's compiled
    program does in its vectorized loop (a fused multiply-subtract); XLA's
    scalar remainder of a row (here the (8, 3) leaf's third column) rounds
    the product first.  Where the two programs differ, the reference's
    value is exactly the twice-rounded form."""
    ref, port = both
    once, twice = _error_forms(both[0]["inputs"], leaf)
    for rank, got in enumerate(port):
        got, want = got["err"][leaf][0], ref["e_" + leaf][rank]
        np.testing.assert_array_equal(got, once[rank], err_msg=f"rank {rank}")
        apart = got != want
        np.testing.assert_array_equal(want[apart], twice[rank][apart],
                                      err_msg=f"rank {rank}")


def test_compressed_dp_trains_the_toy_quadratic(both):
    _, port = both
    losses = port[0]["losses"]
    assert len(losses) == 150 and all(np.isfinite(losses))
    assert losses[-1] < 1e-2 * losses[0], (losses[0], losses[-1])
    for got in port[1:]:   # the loss is the group's mean on every rank
        assert got["losses"] == losses


def test_compression_imports_without_jax():
    code = ("import sys; import repro_torch.optim.compression; "
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
