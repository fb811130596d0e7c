"""The LM workloads the card runs, written once for the smoke run and the
card tests: the models ``chip_smoke.py`` serves, gates and trains (their
configs, depth cuts, prompt lengths, batches and seeds) and the configs the
card tests hold at full width without a phase (:data:`HELD_ONLY`).  From
them, the kernel cases those paths reach: every RMSNorm layout
(:func:`lm_rmsnorm_layouts`), every flash template with the prefills that
run it (:func:`lm_flash_geometries`) and the fp32 gates' flash launches
(:func:`fp32_gate_calls`).  ``tests/test_torch_gpu.py`` holds the kernels
at the smallest and largest served case of each layout and template
(:func:`served_norm_shapes`, :func:`served_flash_cases`).  torch and the
port are imported inside the functions, so importing this module needs
neither.
"""
from __future__ import annotations

import collections

SEED = 0
# LM serving path: qwen2-1.5b at its published width and depth, bf16
LM_ARCH = "qwen2-1.5b"
LM_MAX_LEN = 2048
LM_PROMPT = (128, 1024)   # prompt lengths drawn uniformly in this range
LM_GATE_REQUESTS = 2
# [train]: full-width qwen2-1.5b bf16 training steps (8,192 tokens a step,
# two 1,024-key attention chunks)
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_LR = 3e-4
# [serve moe], [serve ssm], [serve hybrid], [serve audio], [serve vlm]: the
# MoE and recurrent families, the encoder-decoder and the vision prefix,
# each served in bf16 at its full width (the hybrid's depth cut), after an
# fp32 gate at a cut depth and a bf16 gate at the served depth
MOE_ARCH, SSM_ARCH, HYBRID_ARCH = ("moonshot-v1-16b-a3b", "xlstm-1.3b",
                                   "jamba-1.5-large-398b")
MOE_GATE_LAYERS = 2       # the fp32 gate's moonshot: its first 2 layers
SSM_GATE_LAYERS = 8       # the fp32 gate's xlstm: its first period (7
                          # mLSTM + 1 sLSTM); the served 16 are measured
                          # beside the model's own noise, ungated
# the served moonshot: its first 16 of 48 layers (whole, its 28 B
# parameters' seeded init, fp32 and bf16 gates and 16 requests took [serve
# moe] to 45 s; the mesh phases needed the seconds back)
MOE_SERVE_LAYERS = 16
# the served xlstm: its first 2 periods.  Whole (48 layers) its prefill,
# one Python step a token and layer, with its fp32 twin took [serve ssm]
# to 150 s and the run past half its time limit (32 layers: 114 s); the
# 8-slot decode step (phase_serve) needs all 8 requests, so the depth is
# what is cut
SSM_SERVE_LAYERS = 16
HYBRID_LAYERS = 5         # jamba's first 5: mamba+mlp, mamba+moe,
                          # mamba+mlp, mamba+moe, attn+mlp
HYBRID_GATE_PATTERN = (("mamba", "mlp"), ("attn", "mlp"))  # fp32 gate
AUDIO_ARCH, VLM_ARCH = "whisper-base", "internvl2-26b"
VLM_GATE_LAYERS = 2       # the fp32 gate's internvl2: its first 2 layers
                          # (48 in fp32 would not fit the card)
# whisper's decoder context is 448 tokens, its prompt context 223
AUDIO_MAX_LEN = 448
# [serve swa]: mixtral-8x22b, the only sliding-window config (window
# 4,096), served past its window: its first 4 of 56 layers at full width
# (10.4 B parameters, 20.8 GB bf16; the cut follows moonshot's and
# jamba's), the fp32 gate its first 2 (5.4 B, 21.6 GB).  Each SWA layer's
# cache is a 4,096-slot ring; prompts of 3,072-6,144 tokens in an
# 8,192-token context
SWA_ARCH = "mixtral-8x22b"
SWA_SERVE_LAYERS, SWA_GATE_LAYERS = 4, 2
SWA_MAX_LEN = 8192
# (arch, requests, prompt lengths drawn in, new tokens each, max_len)
FAMILY_SERVE = {"moe": (MOE_ARCH, 16, (128, 1024), 32, LM_MAX_LEN),
                "ssm": (SSM_ARCH, 8, (64, 256), 32, LM_MAX_LEN),
                "hybrid": (HYBRID_ARCH, 8, (128, 512), 16, LM_MAX_LEN),
                "audio": (AUDIO_ARCH, 16, (4, 223), 64, AUDIO_MAX_LEN),
                "vlm": (VLM_ARCH, 8, (64, 512), 32, LM_MAX_LEN),
                "swa": (SWA_ARCH, 8, (3072, 6144), 32, SWA_MAX_LEN)}
# [train audio]: whisper-base bf16 training steps, 8 x 448 text tokens
# and 8 x 1500 frames a step
AUDIO_TRAIN_BATCH = 8
# [train moe], [train ssm]: the MoE and recurrent families trained in bf16
# at full width, cut in depth (moonshot whole with Adam is 28 B: 2 layers
# are 1.8 B with its 163,840-token vocabulary; xlstm one period of its
# pattern, 7 mLSTM + 1 sLSTM); xlstm's 128 tokens are 2 recurrence chunks,
# so its chunk checkpoint keeps one chunk's steps where autograd alone
# keeps both, and its 8 sequences make those steps' (8, 4, 512, 512) fp32
# states outweigh Adam's temporaries, which set a 2-sequence step's peak
# (PERF.md); its gradient norm starts near 100 and is clipped to 1,
# and at lr 3e-4 its loss moved 0.07 in 6 steps: it takes 1e-3.
# (arch, layers, batch, seq, steps, lr)
FAMILY_TRAIN = {"moe": (MOE_ARCH, 2, 4, 1024, 8, TRAIN_LR),
                "ssm": (SSM_ARCH, 8, 8, 128, 4, 1e-3)}
# [drivers]: serve_lm's longest prompt (its 8 requests of 4-19 tokens on
# qwen2-1.5b's reduced config) and train_lm's step rows (reduced
# smollm-360m, 8 x 128 tokens a step)
DRIVER_PROMPT_MAX = 19
DRIVER_TRAIN_ARCH, DRIVER_TRAIN_ROWS = "smollm-360m", 8 * 128
# the gates' prompt lengths, where not the served ones: xlstm's prefill is
# one Python step a token and layer (~20 ms a token), and its gates run 11
# prefills a prompt; mixtral's past its window, so that the window binds
# and whole KV tiles below it are skipped, and the prefill rotates the ring
GATE_PROMPT = {"ssm": (64, 128), "swa": (4608, 5120)}
# configs whose kernel layouts the card tests hold at their full width but
# which no phase serves (they run qwen2's code path): their flash templates
# and RMSNorm layouts over prompts up to LM_PROMPT[1] tokens
HELD_ONLY = ("minitron-4b", "qwen1.5-4b", "smollm-360m")


def lm_config(dtype):
    from repro_torch.configs import get_config
    return get_config(LM_ARCH).with_(dtype=dtype, param_dtype=dtype)


def family_config(kind: str, dtype, gate: bool = False):
    """The served model of a family phase in ``dtype``, or its fp32 gate's
    cut (``gate``): moonshot at its first MOE_GATE_LAYERS layers, xlstm at
    its first SSM_GATE_LAYERS, internvl2 at its first VLM_GATE_LAYERS,
    jamba's width over HYBRID_GATE_PATTERN; whisper's gate is the whole
    model.  The served jamba is its first HYBRID_LAYERS layers, the
    served xlstm its first SSM_SERVE_LAYERS, the served moonshot its first
    MOE_SERVE_LAYERS, the served mixtral its first SWA_SERVE_LAYERS (its
    gate its first SWA_GATE_LAYERS)."""
    from repro_torch.configs import get_config
    cfg = get_config(FAMILY_SERVE[kind][0]).with_(dtype=dtype,
                                                  param_dtype=dtype)
    if kind == "hybrid":
        pattern = (HYBRID_GATE_PATTERN if gate
                   else cfg.pattern[:HYBRID_LAYERS])
        return cfg.with_(pattern=pattern, n_layers=len(pattern))
    cut = {"moe": MOE_GATE_LAYERS, "ssm": SSM_GATE_LAYERS,
           "vlm": VLM_GATE_LAYERS, "swa": SWA_GATE_LAYERS}
    if gate and kind in cut:
        return cfg.with_(n_layers=cut[kind])
    served = {"ssm": SSM_SERVE_LAYERS, "moe": MOE_SERVE_LAYERS,
              "swa": SWA_SERVE_LAYERS}
    return cfg.with_(n_layers=served[kind]) if kind in served else cfg


def lm_rmsnorm_layouts() -> dict:
    """The RMSNorm layouts the LM paths run at each served model's d_model
    (bf16 serving, the fp32 gates) for 1 row to its longest prefill's (a
    vision prefix + its longest prompt, or an encoder's frames) or its
    training step's (``[train]``, ``[train audio]``'s text and frames and
    the family training phases; the forward and the backward's
    recompute), ``[drivers]``' reduced models (serve_lm's prompts,
    train_lm's step), and the HELD_ONLY configs over LM_PROMPT: (d, dtype,
    16-byte copies, warps a row, slots a lane, rows a block) -> the rows
    that run it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import rmsnorm as RN
    widths = {}

    def reach(d, rows):
        widths[d] = max(widths.get(d, 0), rows)

    reach(lm_config(torch.bfloat16).d_model, TRAIN_BATCH * TRAIN_SEQ)
    for arch in HELD_ONLY:
        reach(get_config(arch).d_model, LM_PROMPT[1])
    for arch, _, prompt, _, _ in FAMILY_SERVE.values():
        cfg = get_config(arch)
        reach(cfg.d_model, max(cfg.vision_prefix + prompt[1], cfg.enc_seq))
    audio = get_config(AUDIO_ARCH)
    reach(audio.d_model, AUDIO_TRAIN_BATCH * max(AUDIO_MAX_LEN,
                                                 audio.enc_seq))
    for arch, _, batch, seq, _, _ in FAMILY_TRAIN.values():
        reach(get_config(arch).d_model, batch * seq)
    for arch, rows in ((LM_ARCH, DRIVER_PROMPT_MAX),
                       (DRIVER_TRAIN_ARCH, DRIVER_TRAIN_ROWS)):
        reach(get_config(arch, reduced=True).d_model, rows)
    out = {}
    for d, max_rows in widths.items():
        for dtype in (torch.bfloat16, torch.float32):
            for rows in range(1, max_rows + 1):
                g = RN.legalize(d, rows, dtype)
                out.setdefault((d, dtype, g.vec, g.warps_per_row, g.slots,
                                g.rows_per_block), []).append(rows)
    return out


def lm_flash_geometries() -> dict:
    """The flash templates the LM paths run (bf16 serving, the fp32 gates)
    in each served attention model's prefills, causal from 1 token to its
    longest (a vision prefix + its longest prompt; within its window
    where it has one) and an encoder's non-causal pass over its frames, at the blocks the model asks for, serve_lm's reduced qwen2 in
    ``[drivers]``, and the HELD_ONLY configs over LM_PROMPT: (bq, bk, dp,
    dtype) -> the prefills that run it, as flash cases (B, S, HQ, HKV, D,
    causal, window, block_q, block_k)."""
    import inspect
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    ask = inspect.signature(ops.attention).parameters
    block_q, block_k = ask["block_q"].default, ask["block_k"].default
    models = [(lm_config(torch.bfloat16), LM_PROMPT[1]),
              (get_config(LM_ARCH, reduced=True), DRIVER_PROMPT_MAX)]
    models += [(get_config(arch), LM_PROMPT[1]) for arch in HELD_ONLY]
    for arch, _, prompt, _, _ in FAMILY_SERVE.values():
        cfg = get_config(arch)
        if cfg.enc_dec or any(m in ("attn", "swa") for m, _ in cfg.pattern):
            models.append((cfg, cfg.vision_prefix + prompt[1]))
    out = {}
    for cfg, max_s in models:
        window = (cfg.swa_window if any(m == "swa" for m, _ in cfg.pattern)
                  else None)
        passes = [(s, True, window) for s in range(1, max_s + 1)]
        if cfg.enc_dec:
            passes.append((cfg.enc_seq, False, None))
        for dtype in (torch.bfloat16, torch.float32):
            for s, causal, win in passes:
                g = FA.legalize(block_q, block_k, s, cfg.head_dim, dtype)
                out.setdefault((g.bq, g.bk, g.dp, g.dtype), []).append(
                    (1, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                     causal, win, block_q, block_k))
    return out


def served_norm_shapes(dtype) -> list:
    """(rows, d) at the fewest and the most rows of each layout of
    :func:`lm_rmsnorm_layouts` in ``dtype``."""
    return sorted({(rows[i], d) for (d, dt, *_), rows
                   in lm_rmsnorm_layouts().items() if dt == dtype
                   for i in (0, -1)})


def served_flash_cases(dtype_name: str) -> list:
    """The prefills of :func:`lm_flash_geometries` in ``dtype_name`` at
    the shortest and the longest S of each template and model: the
    fewest and the most query and KV tiles each runs."""
    ends = {}
    for (_, _, _, dt), cases in lm_flash_geometries().items():
        if dt != dtype_name:
            continue
        by_model = collections.defaultdict(list)
        for case in cases:
            by_model[case[:1] + case[2:]].append(case)
        for runs in by_model.values():
            runs.sort(key=lambda c: c[1])
            ends.update(dict.fromkeys((runs[0], runs[-1])))
    return list(ends)


def fp32_gate_calls() -> collections.Counter:
    """The fp32 flash launches the fp32 gates of ``chip_smoke.py`` make,
    keyed ((B, S, HQ, D), HKV, causal, window, block_q, block_k), from
    their own draws and configs: each gate's prompt lengths (the first
    draw of its seeded generator: the qwen2 gate's, then each family's),
    one prefill a prompt on the kernel path, one launch an attention
    layer (a vision prefix ahead of the prompt; an encoder's layers
    non-causal over its frames)."""
    import inspect
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    ask = inspect.signature(ops.attention).parameters
    blocks = (ask["block_q"].default, ask["block_k"].default)
    calls = collections.Counter()

    def prefills(cfg, lengths):
        def key(s, causal, window):
            return ((1, s, cfg.n_heads, cfg.head_dim), cfg.n_kv_heads,
                    causal, window, *blocks)
        for n in lengths:
            s = cfg.vision_prefix + int(n)
            for mixer, _ in cfg.layer_kinds():
                if mixer in ("attn", "swa"):
                    window = cfg.swa_window if mixer == "swa" else None
                    calls[key(s, True, window)] += 1
            if cfg.enc_dec:
                calls[key(cfg.enc_seq, False, None)] += cfg.n_enc_layers

    rng = np.random.default_rng(SEED + 4)
    prefills(lm_config(torch.float32), rng.integers(
        LM_PROMPT[0], LM_PROMPT[1] + 1, size=LM_GATE_REQUESTS))
    for i, kind in enumerate(FAMILY_SERVE):
        rng = np.random.default_rng(SEED + 10 + i)
        lo, hi = GATE_PROMPT.get(kind, FAMILY_SERVE[kind][2])
        prefills(family_config(kind, torch.float32, gate=True),
                 rng.integers(lo, hi + 1, size=LM_GATE_REQUESTS))
    return calls
# [kimi] and tests/test_torch_kimi_gpu.py: kimi-linear-48b-a3b's KDA decode
# kernel at the cell's 256 slots of 32 heads (the 20 KDA layers' call) and
# at odd batches; (slots, heads)
KIMI_ARCH = "kimi-linear-48b-a3b"
KDA_CASES = ((256, 32), (37, 32), (3, 5))


def kimi_card_config(dtype):
    """kimi-linear-48b-a3b's reduced block (7 layers: KDA x3, MLA, KDA x2,
    MLA; 4 of 8 experts held) at the kernels' widths: KDA heads of 128,
    MLA of 32 heads, latent 512, rope 64."""
    from repro_torch.configs import get_config
    return get_config(KIMI_ARCH, reduced=True).with_(
        d_model=256, d_ff=64, dense_d_ff=512, n_heads=32, n_kv_heads=32,
        kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, kda_head_dim=128, kda_gate_rank=128, dtype=dtype,
        param_dtype=dtype)
