"""Port parity for the roofline model (``repro_torch.hw.roofline``)
against ``repro.hw.roofline``: every function on every config (published
and reduced) at every shape cell, on a 1-device, a 16x16 and a 2x16x16
mesh, within 1e-6 relative (float64 arithmetic over the same integers;
the parameter counts exactly).  Both model the TPU v5e target with the
same ``TpuSpec``; nothing here is a speed of the port."""
import dataclasses
import math

import pytest

from _torch_support import one_torch_thread  # noqa: F401
from repro.configs import ARCH_NAMES, get_config as jget
from repro.configs.shapes import SHAPES as JSHAPES
from repro.hw import roofline as JRL
from repro_torch.configs import get_config as tget
from repro_torch.configs.shapes import SHAPES
from repro_torch.hw import roofline as RL
from repro_torch.hw.tpu_spec import DEFAULT

TOL = 1e-6
MESHES = ({"data": 1, "model": 1}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16})
# (fsdp, moment_dtype, remat, grad_accum, sequence_parallel)
RESIDENCY_KNOBS = [(True, "bfloat16", True, 1, False),
                   (False, "float32", False, 4, True),
                   (True, "float32", True, 8, True)]


def _close(got, want):
    assert math.isclose(got, want, rel_tol=TOL, abs_tol=1e-300), (got, want)


def _cfgs(arch):
    return [(jget(arch, reduced=r), tget(arch, reduced=r))
            for r in (False, True)]


def test_shape_table_is_the_reference_table():
    assert list(SHAPES) == list(JSHAPES)
    for k in SHAPES:
        assert dataclasses.astuple(SHAPES[k]) == \
            dataclasses.astuple(JSHAPES[k])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_counts_flops_and_bytes_match_reference(arch):
    for jc, tc in _cfgs(arch):
        jcount, tcount = JRL._param_counts(jc), RL._param_counts(tc)
        assert tcount == jcount
        assert RL._attn_layers(tc) == JRL._attn_layers(jc)
        # the counts' default (None: counted inside) once, then passed in
        # (the reference traces its init for every call that lacks them)
        cell = SHAPES["train_4k"]
        args = (cell.kind, cell.seq, cell.global_batch, MESHES[1])
        _close(RL.memory_traffic(tc, *args), JRL.memory_traffic(jc, *args))
        _close(RL.hbm_residency(tc, *args), JRL.hbm_residency(jc, *args))
        _close(RL.model_flops(tc, *args[:3]), JRL.model_flops(jc, *args[:3]))
        for cell in SHAPES.values():
            args = (cell.kind, cell.seq, cell.global_batch)
            _close(RL.model_flops(tc, *args, tcount),
                   JRL.model_flops(jc, *args, jcount))
            _close(RL.kv_cache_bytes(tc, cell.seq, cell.global_batch),
                   JRL.kv_cache_bytes(jc, cell.seq, cell.global_batch))
            for mesh in MESHES:
                _close(RL.memory_traffic(tc, *args, mesh, tcount),
                       JRL.memory_traffic(jc, *args, mesh, jcount))
                for fsdp, mom, remat, ga, sp in RESIDENCY_KNOBS:
                    kw = dict(fsdp=fsdp, moment_dtype=mom, remat=remat,
                              grad_accum=ga, sequence_parallel=sp)
                    _close(RL.hbm_residency(tc, *args, mesh, **kw,
                                            counts=tcount),
                           JRL.hbm_residency(jc, *args, mesh, **kw,
                                             counts=jcount))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_analyze_cell_and_fraction_match_reference(arch):
    """The same artifact numbers in: the same Roofline out, and the same
    achieved fraction."""
    jc, tc = jget(arch), tget(arch)
    art = {"weighted": {"dot_flops_per_device": 3.7e13,
                        "wire_bytes_per_device": 2.1e10,
                        "collective_bytes_by_op": {}}}
    for cell in SHAPES.values():
        for mesh in MESHES:
            args = (cell.kind, cell.seq, cell.global_batch, mesh, art)
            got, want = RL.analyze_cell(tc, *args), JRL.analyze_cell(jc,
                                                                       *args)
            g, w = got.as_dict(), want.as_dict()
            assert g["dominant"] == w["dominant"]
            for k in w:
                if k != "dominant":
                    _close(g[k], w[k])
            n = 1
            for v in mesh.values():
                n *= v
            _close(RL.roofline_fraction(got, DEFAULT, n),
                   JRL.roofline_fraction(want, n_dev=n))
