"""Port parity for serving: the reference serving-stack behaviours
(``tests/test_server.py``) on the port's continuous-batching ``Server``
over the reduced qwen2-1.5b in fp32 on the CPU; the reference ``Server``
and the port's, started from the same weights, generate the same tokens
(the reduced qwen2-1.5b, xlstm, jamba, moonshot with its dropping MoE,
whisper with its encoder over zero frames and internvl2 behind zero
patches; and internvl2 where the prefix puts decode past ``max_len``);
and the ``repro_torch.launch.serve`` CLI (``--device cpu`` prints its
report, for qwen2-1.5b, xlstm, whisper and internvl2; no device and no
GPU raises)."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import one_torch_thread  # noqa: F401
from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro.train import server as JS
from repro_torch.configs import get_config
from repro_torch.models import transformer as TT
from repro_torch.train.server import (ABANDONED, DONE, QUEUED, REJECTED,
                                      Request, Server)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen2-1.5b", reduced=True).with_(
        dtype=torch.float32, param_dtype=torch.float32)
    return cfg, TT.init_params(0, cfg, device="cpu")


@pytest.fixture(scope="module")
def srv(setup):
    """One shared server — every test drains it before returning."""
    cfg, params = setup
    return Server(params, cfg, n_slots=2, max_len=64)


def _prompt(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, size=n).astype(np.int32)


def test_latency_breakdown_and_slot_reuse(setup, srv):
    cfg, _ = setup
    reqs = [Request(uid=i, prompt=_prompt(cfg, 5 + 2 * i, seed=i),
                    max_new_tokens=4) for i in range(5)]
    for r in reqs:
        srv.submit(r)
        assert r.status == QUEUED and r.submit_s is not None
    done = srv.run_until_drained()
    assert len(done) == 5 and not srv.abandoned
    assert sorted(srv.free) == [0, 1] and not srv.active
    for r in done:
        assert r.status == DONE and r.ok
        assert len(r.output) == r.max_new_tokens
        assert r.queue_s >= 0 and r.prefill_s > 0 and r.decode_s > 0
        assert r.latency_s == pytest.approx(
            r.queue_s + r.prefill_s + r.decode_s, rel=1e-6)
        assert r.latency_s > r.decode_s
    assert done[-1].finish_s > done[0].finish_s


def test_oversized_and_empty_prompts_rejected(setup, srv):
    cfg, _ = setup
    base_rejected = len(srv.rejected)
    too_long = srv.submit(Request(uid=100, prompt=_prompt(cfg, 64),
                                  max_new_tokens=4))
    empty = srv.submit(Request(
        uid=101, prompt=np.zeros(0, np.int32), max_new_tokens=4))
    for r, frag in ((too_long, "max_len"), (empty, "empty")):
        assert r.status == REJECTED and not r.ok
        assert frag in r.error
        assert r.output == [] and r.latency_s is None
    assert len(srv.rejected) == base_rejected + 2
    assert not srv.queue
    ok = srv.submit(Request(uid=102, prompt=_prompt(cfg, 6),
                            max_new_tokens=3))
    assert srv.run_until_drained() == [ok] and ok.status == DONE


def test_eos_and_too_long_termination(setup, srv):
    cfg, _ = setup
    prompt = _prompt(cfg, 8, seed=7)
    ref = srv.submit(Request(uid=110, prompt=prompt, max_new_tokens=6))
    srv.run_until_drained()
    eos = ref.output[2]
    if eos not in ref.output[:2]:
        again = srv.submit(Request(uid=111, prompt=prompt,
                                   max_new_tokens=6, eos_id=int(eos)))
        srv.run_until_drained()
        assert again.output == ref.output[:3]
        assert again.status == DONE
    long = srv.submit(Request(uid=112, prompt=_prompt(cfg, 55),
                              max_new_tokens=100))
    srv.run_until_drained()
    assert long.status == DONE
    assert len(long.output) < 100
    assert 55 + len(long.output) >= srv.max_len - 2


def test_interleaved_vs_sequential_parity(setup, srv):
    cfg, _ = setup
    pa, pb = _prompt(cfg, 9, seed=11), _prompt(cfg, 7, seed=12)
    ra = srv.submit(Request(uid=120, prompt=pa, max_new_tokens=10))
    srv.run_until_drained()
    rb = srv.submit(Request(uid=121, prompt=pb, max_new_tokens=6))
    srv.run_until_drained()
    ia = srv.submit(Request(uid=122, prompt=pa, max_new_tokens=10))
    for _ in range(3):
        srv.step()
    ib = srv.submit(Request(uid=123, prompt=pb, max_new_tokens=6))
    srv.run_until_drained()
    assert ia.output == ra.output
    assert ib.output == rb.output


def test_abandoned_requests_marked_loudly(setup, srv):
    cfg, _ = setup
    base_abandoned = len(srv.abandoned)
    active = [srv.submit(Request(uid=130 + i, prompt=_prompt(cfg, 5, seed=i),
                                 max_new_tokens=500))
              for i in range(2)]
    queued = srv.submit(Request(uid=140, prompt=_prompt(cfg, 5),
                                max_new_tokens=4))
    done = srv.run_until_drained(max_steps=3)
    assert done == []
    assert len(srv.abandoned) == base_abandoned + 3
    for r in active:
        assert r.status == ABANDONED and not r.ok
        assert r.latency_s is None and r.decode_s is None
        assert r.output
    assert queued.status == ABANDONED and queued.output is None
    assert sorted(srv.free) == [0, 1] and not srv.active and not srv.queue
    ok = srv.submit(Request(uid=141, prompt=_prompt(cfg, 5),
                            max_new_tokens=3))
    assert srv.run_until_drained() == [ok] and ok.status == DONE


def _server_pair(arch, n_slots, max_len, **kw):
    """The reference ``Server`` and the port's over the same reduced fp32
    weights."""
    jc = jax_get_config(arch, reduced=True).with_(
        dtype=jnp.float32, param_dtype=jnp.float32, remat=False, **kw)
    tc = get_config(arch, reduced=True).with_(
        dtype=torch.float32, param_dtype=torch.float32, **kw)
    jp = JT.init_params(jax.random.PRNGKey(1), jc)
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return (JS.Server(jp, jc, n_slots=n_slots, max_len=max_len),
            Server(tp, tc, n_slots=n_slots, max_len=max_len), tc)


def _outputs(jsrv, tsrv, requests):
    """Each server's outputs for ``requests`` ((prompt, max_new) pairs)."""
    outs = []
    for srv_ in (jsrv, tsrv):
        make = JS.Request if srv_ is jsrv else Request
        reqs = [srv_.submit(make(uid=i, prompt=p, max_new_tokens=n))
                for i, (p, n) in enumerate(requests)]
        srv_.run_until_drained()
        assert all(r.status == "done" for r in reqs)
        outs.append([r.output for r in reqs])
    return outs


@pytest.mark.parametrize("arch,kw", [
    ("qwen2-1.5b", {}), ("xlstm-1.3b", {}), ("jamba-1.5-large-398b", {}),
    ("moonshot-v1-16b-a3b", {"moe_impl": "dropping"}), ("whisper-base", {}),
    ("internvl2-26b", {})],
    ids=["qwen2-1.5b", "xlstm-1.3b", "jamba-1.5-large-398b",
         "moonshot-v1-16b-a3b-dropping", "whisper-base", "internvl2-26b"])
def test_same_tokens_as_reference_server(arch, kw):
    """Same weights, same requests (more than slots, so slots are reused
    and requests join mid-decode): the reference ``Server`` and the port's
    generate the same greedy tokens.  A recurrent slot's state is replaced
    whole when a request joins; with the dropping MoE every slot's token,
    a free slot's too, competes for an expert's capacity in a decode step,
    so the port feeds free slots what the reference feeds them (the last
    token they held).  whisper's and internvl2's frontends are the
    servers' zero frames and patches."""
    jsrv, tsrv, tc = _server_pair(arch, 2, 48, **kw)
    outs = _outputs(jsrv, tsrv, [(_prompt(tc, 4 + 3 * i, seed=i), 5 + i)
                                 for i in range(4)])
    assert outs[0] == outs[1]


def test_vision_prefix_decodes_past_max_len_as_reference():
    """internvl2 (8 patches) with ``max_len`` 24: prompts of 12 and 10
    tokens fit (8 + 12 = 20 < 24), and ``max_len`` counts the prompt only
    (the reference's ``submit`` and ``too_long`` rules), so 10 new tokens
    run decode to position 28: both servers write at the position clamped
    into the cache (``dynamic_update_slice``'s rule) and attend to the
    whole cache, and give the same tokens."""
    jsrv, tsrv, tc = _server_pair("internvl2-26b", 2, 24)
    assert tc.vision_prefix == 8
    reqs = [(_prompt(tc, 12, seed=3), 10), (_prompt(tc, 10, seed=4), 10)]
    outs = _outputs(jsrv, tsrv, reqs)
    assert [len(o) for o in outs[1]] == [10, 10]
    assert tc.vision_prefix + 12 + 10 - 1 > tsrv.max_len
    assert outs[0] == outs[1]


def _cli(*args, env_extra=None, arch="qwen2-1.5b"):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         arch, "--reduced", "--requests", "4", "--slots", "2",
         "--max-new", "4", *args],
        env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "xlstm-1.3b", "whisper-base",
                                  "internvl2-26b"])
def test_serve_cli_on_cpu_prints_report(tmp_path, arch):
    out = tmp_path / "serve.json"
    res = _cli("--device", "cpu", "--json-out", str(out), arch=arch)
    assert res.returncode == 0, res.stderr
    doc = json.loads(res.stdout)
    assert doc == json.loads(out.read_text())
    assert doc["device"] == "cpu" and doc["requests"] == 4
    assert doc["generated_tokens"] == 16
    assert doc["rejected"] == 0 and doc["abandoned"] == 0
    assert doc["tokens_per_sec"] > 0


def test_serve_cli_without_a_gpu_raises():
    """No ``--device``: the launcher asks for CUDA and, on a machine without
    one, raises instead of falling back to the CPU."""
    res = _cli(env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
