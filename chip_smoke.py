#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --flash-fp32 [--tree DIR]   # [time flash fp32] alone

Drives the port's paths on ``cuda:0``: the paper's own loop at full
ResNet-18 width, its baselines and its network co-optimization with the
co-optimized chip's mappings deployed, the LM server at qwen2-1.5b's full
width and depth, training at that width and depth, the same model trained
and served through the mesh step builders (DTensors over a one-card
NCCL mesh) and trained with the int8 error-feedback all-reduce, the MoE
and recurrent families served at full width (moonshot-v1-16b-a3b cut to
16 of its 48 layers, xlstm-1.3b to 16 of 48, jamba-1.5-large-398b to 5),
and the
encoder-decoder and vision-prefix families served whole at full width
(whisper-base, internvl2-26b), the sliding-window MoE served past its
window (mixtral-8x22b cut to 4 of its 56 layers), whisper-base also
trained, the MoE and
xLSTM families trained at full width (moonshot-v1-16b-a3b cut to 2
layers, xlstm-1.3b to one period), and the pod-level shard-space tuner
(``tune --arch --oracle compile``) with its estimator held against a real
training step, and the reference's examples as the port runs them.

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the three Hopper kernels (GEMM, RMSNorm, flash attention) from
   ``src/repro_torch/kernels/csrc``, one ``nvcc`` each, all at once, and
   prints what ``ptxas -v`` says of the fp32 and bf16 GEMMs', the bf16
   and fp32 flash kernels' (and the fp32 KV split's combine kernel) and
   the RMSNorm kernel's templates (registers, spills, static shared
   memory), and which RMSNorm templates the LM path runs;
3. holds each kernel against its plain PyTorch version on the card, fp32
   and bf16: the reference test shapes and configs, the GEMM's split-K
   shapes and misaligned row strides (fp32 and bf16), the 8 ResNet-18
   im2col shapes at batch 8 under the default and knob-derived configs
   (fp32 and bf16), the GEMM's
   ``out_dtype`` both ways (fp32 -> bf16, bf16 -> fp32), flash at every
   head_dim template with GQA, window 32 and ragged S, and the LM's shapes
   (RMSNorm over prompts of 200, 384 and 1024 rows and (8, 1536), plus
   4096 rows, (9000, 128), (5000, 4096), the widest row and x at an offset
   of one value, which takes the scalar template; it fails unless the
   checks ran every RMSNorm layout the LM path runs and the grid-stride
   loop; causal flash over B=1, S in
   {4, 17, 127, 513, 256, 1000, 2048}, 12 query and 2 KV heads, head_dim
   128; the MoE and recurrent families' shapes: RMSNorm at d 2048 and 8192
   over 8, 200 and 512-1024 rows, flash at 16/16 heads over S 128, 517,
   1024 and 64/8 heads over S 128, 300, 512; whisper's and internvl2's:
   RMSNorm at d 512 over 8, 223 and 1500 rows and the training step's
   3584 and 12000, at d 6144 over 8, 200 and 1536 rows, at d 2048 over the
   family training steps' 4096 and 1024 rows, flash non-causal
   at (1, 1500, 8/8 heads, d 64), causal at 8/8 heads d 64 over S 4, 100,
   223 and at 48/8 heads d 128 over S 1088, 1300, 1536; flash at head_dim
   6 and 18 and with q, k and v one value into their storage, the
   4-byte / scalar copies; fp32 flash with and without its KV split;
   mixtral's window of 4,096 past itself, causal over 4,608 tokens at
   head_dim 128 (6/1 heads, and 2/1, which splits the fp32 KV range);
   the layouts of three configs no phase serves, held only: minitron-4b's
   d 3072, qwen1.5-4b's 2560 and smollm-360m's 960 over 1-1024 rows,
   their flash templates over prompts up to 1024);
   there the bf16 flash kernel is also held against the plain version
   with P kept in fp32 (the reference kernel's arithmetic), within 2^-7 x
   max |v|;
   ``[check] rmsnorm backward``: the RMSNorm autograd Function's (dx, dw)
   against autograd through the plain version at the training shape
   (8192, 1536) and (8, 1536) and the family training shapes (4096, 2048)
   and (1024, 2048), fp32 and bf16, one launch a forward;
4. tunes the 8 ResNet-18 conv tasks (batch 8) with the port's ``Session``;
5. deploys: runs ResNet-18 at 224x224, batch 8, fp32, seeded weights, each
   conv layer through the GEMM with its tuned geometry, and compares the
   logits with the plain path (cuDNN fp32 convolutions, TF32 off); the
   GEMM's launch counter must rise by exactly 17 in that forward; then
   times the forward and profiles it (host wall vs device busy time);
6. times each ResNet-18 GEMM shape (kernel and one ``torch.matmul`` call
   as a yardstick, each through Python calls and as device time in a CUDA
   graph; the plain version; the card's bound) and the forward;
   ``[deploy bf16]``: the same network and input in bf16 with the tuned
   geometries, the GEMM count set to 0 just before (17 launches), logits
   within 2e-2 of max |logit| of the plain path in bf16; the distances to
   the fp32 forward and to cuDNN bf16 convolutions, the forward's ms
   three ways and a profile, ungated; ``[time bf16]``: the bf16 GEMM (the
   tensor-core kernel) at the 8 shapes under the tuned geometries and
   ``GemmConfig()`` and at bert-gemm's four GEMM shapes, each held
   against the plain version, by device time beside ``torch.matmul``
   bf16 and the bytes bound, and the forward's 17 GEMMs both ways;
7. ``[baselines]``: random search, AutoTVM and CHAMELEON tune the same 8
   tasks at ARCO's budget and seed; tuning seconds and network latency
   (the analytical TPU v5e model) beside ARCO's; every task ends with the
   budget's measurements and the default hardware geometry;
8. ``[netopt]``: the network co-optimizer at K=1 (``NetOptConfig()``), the
   hw-frozen baseline at its upper budget, the co-optimizer at K=2;
   seconds, network latency (model), measurements, candidates; gated on
   the shared-hardware invariant, the K=2 partition and the budget;
9. ``[netopt deploy]``: the GEMM count set to 0, ResNet-18 run with each
   layer's mapping under the K=1 chip (17 launches, logits within 1e-4 of
   cuDNN fp32), timed beside phase 5's forward and cuDNN's, profiled, and
   each GEMM shape's device time under these geometries beside phase 6's;
10. qwen2-1.5b with seeded random weights: the kernel path against the
   plain path (prefill + teacher-forced decode, 2 prompts) in fp32, gated
   at 1e-4 of max |logit|, then with the weights cast to bf16, gated at
   5e-2;
11. serves 16 requests (prompts of 128-1024 tokens, 32 new tokens each)
   through ``Server(n_slots=8, max_len=2048)`` in bf16, with the RMSNorm
   and flash launch counts set to 0 just before and checked at every
   step (a prefill: flash 28, RMSNorm 57; a decode step: RMSNorm 57,
   flash 0), and reports tokens/s, prefill ms by prompt length and the
   decode step with 8 active slots;
   ``[fabric]``: 16 stub measurements (0.1 s each) through the
   ``SerialExecutor``, a ``SubprocessExecutor`` of 2 spawned workers and a
   ``RemoteExecutor`` over one ``spawn_daemon`` daemon on 127.0.0.1:0:
   equal values, the pool at least 1.5x faster than serial, a hung job
   killed at its timeout with the pool respawned and the rest served, and
   the same ``stats()`` keys on all three;
   ``[serve live]``: the same server serves 48 requests under Poisson
   arrivals at 2 req/s (prompts 4-512, 2-32 new tokens) while an ARCO
   session (``tune_while_serving``, 24 measurements a cell, p99 SLA 3 s,
   records under ``build/``) measures decode/prefill geometries in its
   idle slots, watched by a ``MonitorServer`` on an ephemeral loopback
   port (scraped during the run and after); gated on 48/48 served, every
   measurement in an idle window, the budget spent, the final scrape
   equal to the report, and the launch identities over the phase (flash
   28 a prefill, RMSNorm 57 a prefill or decode step);
12. profiles one prefill and a few decode steps (``torch.profiler``):
   host wall vs device busy time, kernels launched, the top kernels;
13. times the two LM kernels at the serving run's shapes (kernel and one
   PyTorch call as device time in a CUDA graph, plain version, bound),
   the RMSNorm kernel's floor (a (1, 32) launch) and its wrapper's host
   microseconds a call;
14. ``[train]``: qwen2-1.5b at full width and depth, bf16, seeded weights,
   20 steps of 4 x 2048 synthetic tokens through ``train_step_fn`` and
   the ``Prefetcher`` (cosine lr 3e-4, warmup 4), the launch counts set
   to 0 just before: every step launches RMSNorm 113 times (57 in the
   forward, 56 recomputed under remat) and flash and GEMM never, losses
   and grad norms finite, the last 3 losses below the first 3; step
   seconds, tokens/s, peak memory, one profiled step, and the RMSNorm
   kernel timed at the step's (8192, 1536);
    then, in one process group (NCCL at world size 1, a ``FileStore``
   under a temporary directory, a (data 1, model 1) ``DeviceMesh``):
   ``[train sharded]``: ``build_sharded_train_step``, qwen2-1.5b bf16
   from ``init_params(SEED)`` as DTensors placed by the sharding rules,
   3 steps on ``[train]``'s first batches: losses and grad norms equal to
   ``[train]``'s first 3 within 1e-6 relative, RMSNorm 113 a step, flash
   and GEMM 0, the step time and peak memory beside ``[train]``'s;
   ``[train int8]``: ``make_ddp_compressed_step`` for 3 steps on the
   parameters and moments that phase leaves (their local tensors):
   finite losses and error state, the same launch identities, then one
   gradient through ``compressed_psum_mean`` timed by CUDA events, its
   synced gradient equal to ``q * scale`` exactly, and the bytes one
   all-reduce puts on the wire; ``[serve sharded]``:
   ``build_sharded_prefill`` on 8 prompts of 1,024 tokens and 16
   ``build_sharded_serve_step`` decode steps, logits within 1e-6 relative
   of the unsharded ``prefill`` / ``decode_step``, flash 28 + RMSNorm 57 a
   prefill, RMSNorm 57 a decode step, the decode step's ms beside the
   unsharded one's;
15. ``[train faults]``: the ``Trainer`` on the card at the reference
   trainer test's setup (reduced smollm-360m, 40 steps, checkpoints every
   10, a crash at step 17 and a NaN batch at 26: both roll back, the loss
   ends lower), a restart resuming at step 40, and ``python -m
   repro_torch.launch.train --arch qwen2-1.5b --reduced --steps 20`` as a
   subprocess on the card;
16. ``[serve moe]``, ``[serve ssm]``, ``[serve hybrid]``, each freeing the
   model before it and printing its peak device memory: moonshot-v1-16b-a3b's
   first 16 layers (attention + a dropping MoE of 64 experts top-6; whole,
   its 48 took 45 s), xlstm-1.3b's first 16 layers (14 mLSTM + 2 sLSTM; the
   whole 48's host-bound prefill, fp32 twin included, pushed the run past
   half its time limit) and the first 5
   layers of jamba-1.5-large-398b at its full width (Mamba, MLP, MoE of
   16 experts top-2, one attention layer; 24.0 B parameters).  Each: the
   kernel path against the plain path in fp32 at a cut (moonshot's first
   2 layers, xlstm's first 8, a jamba-width mamba+mlp / attn+mlp pair;
   gate 1e-4; xlstm's 16 also, ungated, beside the plain path's own
   distance under a 1e-7 relative change of the embedding) and in bf16 at
   the served depth (gate 5e-2 with the plain path routed by the kernel
   path's expert sets), with the tokens whose expert sets differ between
   the paths counted; then 16, 8 and 8
   requests (prompts 128-1024, 64-256, 128-512; 32, 32, 16 new tokens)
   through ``Server(n_slots=8, max_len=2048)`` in bf16 with the launch
   identities checked at every step (moonshot: flash 16 and RMSNorm 33 a
   prefill; xlstm: RMSNorm 17, flash 0; jamba: flash 1 and RMSNorm 11),
   tokens/s, prefill ms by length and a prompt token, the decode step
   beside the time to read every weight once, and each kernel timed at
   the run's shapes over its launches;
17. ``[serve audio]``, ``[serve vlm]`` and ``[serve swa]``, the same
   way (``[serve swa]`` below): whisper-base
   whole (6 encoder + 6 decoder layers, 97.2 M parameters; its fp32 gate
   the whole model, the encoder over frames drawn with numpy from the
   seed) and internvl2-26b whole (48 layers, 19.86 B parameters, 39.7 GB
   bf16; its fp32 gate the first 2 layers, the 1024-patch prefix drawn
   from the seed); bf16 gated at 5e-2 free-running and block by block;
   then 16 requests (prompts 4-223, 64 new tokens) through
   ``Server(n_slots=8, max_len=448)`` and 8 (text prompts 64-512 after
   the 1024 zero patches, 32 new) through ``Server(8, 2048)``, with the
   launch identities at every step (whisper: a prefill flash 12 -- 6
   non-causal encoder launches at S 1500 and 6 causal -- and RMSNorm 32,
   a decode step RMSNorm 19; internvl2: flash 48 and RMSNorm 97 a
   prefill, RMSNorm 97 a decode step), each kernel timed at the run's
   shapes (the encoder's flash non-causal); ``[serve swa]``:
   mixtral-8x22b, the sliding-window config, its first 4 of 56 layers at
   full width (10.4 B parameters; the fp32 gate its first 2, prompts of
   4,608-5,120 tokens past the 4,096-token window), then 8 requests
   (prompts 3,072-6,144, the first 4,080; 32 new) through ``Server(8,
   8192)``, whose SWA layers keep 4,096-slot rings: it must serve a prompt
   that never wraps its ring, one whose decode wraps it and one whose
   prefill rotates it; flash 4 and RMSNorm 9 a prefill, RMSNorm 9 a
   decode step; each flash shape timed with its window (a banded SDPA, a
   band-counted bound);
18. ``[train audio]``: whisper-base at full width, bf16, remat on, 10
   steps of 8 x 448 synthetic tokens with 1500 frames a sequence drawn
   with numpy from the seed: RMSNorm 62 launches a step (32 in the
   forward, 30 recomputed), flash and GEMM none, the loss falling;
19. ``[train moe]`` and ``[train ssm]``: moonshot-v1-16b-a3b (2 layers at
   full width: 64 experts top-6, the dropping dispatch, the aux loss in
   the loss; 1.81 B parameters) on 4 x 1024 tokens for 8 steps, and
   xlstm-1.3b (its first period: 7 mLSTM + 1 sLSTM at full width) on 8 x
   128 tokens for 4 steps at lr 1e-3, bf16, remat on: RMSNorm 9 and 17
   launches a
   step, flash and GEMM none, finite losses and grad norms, the loss
   falling; step seconds, tokens/s, each step's peak memory; xlstm then
   one step with the recurrences' chunk checkpoint off, its peak beside
   the checkpointed steps'; the RMSNorm kernel timed at each step's norm
   shape;
20. ``[autotune]``: ``python -m repro_torch.compiler.cli tune --arch
   qwen2-1.5b --shape train_4k --oracle compile --budget 8`` in process
   at 256 placeholder devices (the agents and the GBT on the card): every
   measurement row finite with ``SettingsOracle._RESULT_KEYS``, the best
   setting feasible, the report written under ``build/``; then the
   dry-run estimator's dot FLOPs at ``[train]``'s shape equal to
   ``FlopCounterMode``'s around one real training step on the card
   (within 1e-6), its memory estimate printed beside that step's peak;
21. ``[drivers]``: the reference's examples as the port runs them
   (``repro_torch.examples``), in process on the card, the launch counts
   set to 0 just before: quickstart (ARCO, AutoTVM and random search on
   one conv, then its tuned geometry deployed through the GEMM, one
   launch, within 5e-5 of ``conv2d_ref``'s max), serve_lm at its
   defaults (qwen2-1.5b's reduced config: 8 requests of 4-19 tokens, 12
   new each, all served; flash once an attention layer a prefill, RMSNorm
   a whole number of passes) and train_lm for 20 steps (reduced
   smollm-360m, 8 x 128 tokens: the loss falls, RMSNorm every norm of
   the forward and its recompute, flash and GEMM none); each driver's
   seconds and launches;
then ``[time flash fp32]``: the fp32 flash kernel at every shape the
fp32 gates launched (the wrapper's own record of calls, diffed around
them, which must equal what the gates' draws and configs give), beside
SDPA fp32, the plain version (which holds it at 5e-5) and its fp32
operations bound (a windowed shape: SDPA with the band as a boolean mask,
the pairs inside the band counted), and the CUDA kernels the profiler
sees SDPA fp32 run;
``--flash-fp32`` runs that phase alone at the gates' shapes without the
gates, and with ``--tree DIR`` on another checkout's kernel;
then one JSON line with the three kernels (RMSNorm's with its training
launches; RMSNorm's and flash's with each family phase's launches and
times; every kernel's with the mesh phases' and ``[drivers]``'
launches; the GEMM's with the bf16 forward's launches and times, flash's
with the fp32 gates').

The last line is ``{"ok": true, "device": {...}}``.  Any failed phase
raises, so the script exits non-zero and prints no result; without a GPU,
or without the repository's ``src/repro_torch`` beside it, it exits 2.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 8
TUNE_BUDGET = 48          # measurements per task (TunerConfig.fast schedule)
# H100 SXM datasheet peaks (the bound of each GEMM)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12        # fp32 outside the tensor cores: the kernel has no TF32
FP32_TOL = 5e-5           # max |kernel - plain| / max |plain|: two fp32 sums
BF16_TOL = 1e-2           # ... both rounded once to bf16 (2^-8 relative step)
# bf16 flash vs the plain version with P in fp32: P rounded to bf16 (2^-8
# of each weight, so at most 2^-8 max|v| in a row) and the output rounded
# to bf16 (2^-8 |o| <= 2^-8 max|v|); fp32 reassociation is far below it
FLASH_FP32_P_BOUND = 2 ** -7  # x max |v|
FORWARD_TOL = 1e-4        # max |logit diff| / max |logit|, as the CPU tests
BASELINES = ("random", "autotvm", "chameleon")
NETWORK = "resnet-18"     # the netopt runs' network label
BF16_FLOPS = 989e12       # dense bf16 tensor-core peak (the flash bound)
KERNELS = ("gemm", "rmsnorm", "flash_attention")
REFERENCE_SHAPES = [(8, 8, 8), (100, 70, 90), (128, 128, 128), (1, 256, 33),
                    (257, 129, 65)]
REFERENCE_CONFIGS = [(32, 32, 32, True, True), (128, 128, 128, True, True),
                     (16, 64, 128, False, True), (8, 128, 256, True, False)]
# ((M, K, N), config, dtype): split-K (conv8b, conv6b at their tuned
# tiles) and misaligned row strides (conv1's K 147; K 129 with N 33; K
# 1029, split), fp32; then bf16: split-K (conv8b at a tuned tile, 5
# slices), conv1's K 147 (K % 8 != 0: the scalar copies), K 1029 with N 33
# (both strides misaligned, 7 slices)
GEMM_EXTRA_CHECKS = [
    ((392, 4608, 512), (32, 256, 2304, True, True), "float32"),
    ((1568, 2304, 256), (128, 128, 2304, True, True), "float32"),
    ((392, 4608, 512), (128, 128, 128, True, True), "float32"),
    ((1568, 147, 64), (128, 64, 128, True, True), "float32"),
    ((257, 129, 33), (64, 32, 32, True, True), "float32"),
    ((257, 1029, 33), (64, 32, 32, True, True), "float32"),
    ((392, 4608, 512), (32, 256, 2304, True, True), "bfloat16"),
    ((1568, 147, 64), (128, 64, 128, True, True), "bfloat16"),
    ((257, 1029, 33), (64, 32, 32, True, True), "bfloat16")]
# [deploy bf16]: the kernel path's logits against the plain path's (cuDNN
# fp32 convolutions on the bf16 values, each layer's output rounded to
# bf16), relative to max |logit|.  The CPU test holds the port's bf16
# forward to the reference's at 2e-2 (measured 5.0e-3 at 32 x 32; the
# reference's bf16 forward lies 5.5e-3 from its fp32 one): both paths
# round every layer to bf16 and the two sums' orders flip a rounding now
# and then, compounding over 17 convs; 2e-2 keeps that room, under the LM
# bf16 gate's 5e-2.
DEPLOY_BF16_TOL = 2e-2
# LM serving path: qwen2-1.5b at its published width and depth, bf16
LM_ARCH = "qwen2-1.5b"
LM_SLOTS, LM_MAX_LEN = 8, 2048
LM_REQUESTS, LM_NEW = 16, 32
LM_PROMPT = (128, 1024)   # prompt lengths drawn uniformly in this range
PREFILL_BINS = (64, 128, 256, 512)
LM_GATE_REQUESTS, LM_GATE_STEPS = 2, 4
LM_TOL_FP32 = 1e-4        # max |logit diff| / max |logit|, kernel vs plain
LM_TOL_BF16 = 5e-2        # the same in bf16: both paths round every layer's
                          # output to bf16 (2^-8), 28 layers compound it
FLASH_TIMED_S = (256, 1024, 2048)
NORM_TIMED_ROWS = 1024
NORM_FLOOR_SHAPE = (1, 32)  # the least work of a launch: its floor
NORM_HOST_CALLS = 1000      # wrapper calls timed by the host clock
# (shape, on the serving path, 16-byte aligned): the reference's test
# shapes, the path's (a decode step's 8 rows and a prompt of 200, which
# spread a row over warps; prompts of 384 and 1024, one warp a row in
# bf16), 4096 rows, the grid-stride loop of one-warp rows (9000, 128) and
# of wider ones (5000, 4096), the widest row, and x at an offset of one
# value (the scalar template); the MoE and recurrent families' widths, d
# 2048 (moonshot, xlstm) and 8192 (jamba), at a decode step's 8 rows and
# prompts that spread a row over warps (200) or not (1024, 512)
RMSNORM_CHECKS = [((4, 64), False, True), ((2, 100, 96), False, True),
                  ((1, 7, 33), False, True), ((129, 256), False, True),
                  ((200, 1536), True, True), ((384, 1536), True, True),
                  ((1024, 1536), True, True), ((8, 1536), True, True),
                  ((8, 2048), True, True), ((200, 2048), True, True),
                  ((1024, 2048), True, True), ((8, 8192), True, True),
                  ((200, 8192), True, True), ((512, 8192), True, True),
                  ((4096, 1536), False, True), ((9000, 128), False, True),
                  ((5000, 4096), False, True), ((3, 8192), False, True),
                  ((5, 1536), False, False), ((3, 8192), False, False),
                  # whisper's d 512: a decode step, the longest prompt, the
                  # encoder's 1500 frames, a training step's 8 x 448 text
                  # and 8 x 1500 frame rows; internvl2's d 6144: a decode
                  # step, a prompt that spreads a row over warps, the
                  # longest prefix + prompt
                  ((8, 512), True, True), ((223, 512), True, True),
                  ((1500, 512), True, True), ((3584, 512), True, True),
                  ((12000, 512), True, True), ((8, 6144), True, True),
                  ((200, 6144), True, True), ((1536, 6144), True, True),
                  # [train moe]'s 4 x 1024 rows and [train ssm]'s 8 x 128
                  # at d 2048
                  ((4096, 2048), True, True), ((1024, 2048), True, True),
                  # [drivers]: serve_lm's reduced qwen2 (d 64: a row a
                  # warp, 1-3 rows a block below 4 rows, a prompt of 19)
                  # and train_lm's reduced smollm (d 60, which bf16 runs
                  # on the scalar template: a row spread over warps up to
                  # 264 rows, one warp a row at a step's 1024)
                  ((1, 64), True, True), ((2, 64), True, True),
                  ((3, 64), True, True), ((19, 64), True, True),
                  ((1, 60), True, True), ((2, 60), True, True),
                  ((3, 60), True, True), ((200, 60), True, True),
                  ((1024, 60), True, True),
                  # HELD_ONLY: minitron-4b's d 3072, qwen1.5-4b's 2560 and
                  # smollm-360m's 960 at a decode step's 8 rows (a row
                  # spread over warps) and a prompt of 1024 (fewer warps a
                  # row, or several rows a block)
                  ((8, 3072), False, True), ((1024, 3072), False, True),
                  ((8, 2560), False, True), ((1024, 2560), False, True),
                  ((8, 960), False, True), ((1024, 960), False, True)]
# ((B, S, HQ, HKV, D, causal, window, block_q, block_k), on the path)
_FLASH_CASES = (
    [((2, 100, hq, hkv, 16, causal, window, 32, 32), False)
     for hq, hkv in ((4, 4), (4, 2), (6, 1))
     for causal, window in ((True, None), (False, None), (True, 32))]
    + [((1, s, 2, 2, 8, causal, None, bq, bk), False)
       for s, bq, bk, causal in ((3, 16, 16, True), (37, 16, 64, False),
                                 (70, 32, 16, True))]
    + [((2, 77, 6, 2, d, True, 32, 64, 64), False) for d in (8, 16, 64, 128)]
    + [((1, 150, 12, 2, 128, False, None, 128, 128), False),
       ((2, 130, 4, 1, 64, True, None, 32, 64), False),
       ((1, 50, 2, 1, 20, True, None, 64, 64), False)]
    + [((1, s, 12, 2, 128, True, None, 128, 128), True)
       for s in (4, 17, 48, 127, 513, 256, 1000, 2048)]
    # moonshot's MHA and the jamba cut's GQA at their prompt lengths
    + [((1, s, 16, 16, 128, True, None, 128, 128), True)
       for s in (128, 517, 1024)]
    + [((1, s, 64, 8, 128, True, None, 128, 128), True)
       for s in (128, 300, 512)]
    # whisper's encoder (non-causal over its 1500 frames) and decoder
    # prompts (one in each template's range: below 32, 32-63, 64 up; qwen2's
    # 48 above likewise), internvl2's 1024-patch prefix + prompts;
    # lm_flash_geometries() fails the checks unless every template the LM
    # paths pick is among them
    + [((1, 1500, 8, 8, 64, False, None, 128, 128), True)]
    + [((1, s, 8, 8, 64, True, None, 128, 128), True)
       for s in (4, 48, 100, 223)]
    + [((1, s, 48, 8, 128, True, None, 128, 128), True)
       for s in (1088, 1300, 1536)]
    # [drivers]: serve_lm's reduced qwen2 (4/2 heads, head_dim 16) at its
    # shortest and longest prompts
    + [((1, s, 4, 2, 16, True, None, 128, 128), True) for s in (4, 19)]
    # past a 4,096-token window at mixtral's head_dim and blocks: its
    # queries past 4,096 + a tile skip whole KV tiles below the band; at 6
    # heads no fp32 KV split, at 2 the split's runs start above tile 0
    + [((1, 4608, 6, 1, 128, True, 4096, 128, 128), True),
       ((1, 4608, 2, 1, 128, True, 4096, 128, 128), False)])
# (case, on the path, q/k/v on 16-byte boundaries): the cases above
# aligned, then head_dim 6 and 18 (D % 4 != 0: fp32's 4-byte copies, bf16's
# scalar loads) and q, k and v one value into their storage at D 128 and
# 64 (the same copies on the LM's head_dims)
FLASH_CHECKS = (
    [(case, on_path, True) for case, on_path in _FLASH_CASES]
    + [((2, 77, 6, 2, 6, True, 32, 64, 64), False, True),
       ((1, 90, 4, 2, 18, False, None, 32, 32), False, True),
       ((1, 130, 12, 2, 128, True, None, 128, 128), False, False),
       ((2, 77, 6, 2, 64, True, 32, 64, 64), False, False)])
# [fabric]: the stub oracle through the three executors
FABRIC_N, FABRIC_DELAY_S = 16, 0.1
FABRIC_SPEEDUP = 1.5      # the pool over serial (the reference's gate)
FABRIC_TIMEOUT_S = 1.0    # the hung job's limit, from its started-ack
STUB = "repro_torch.compiler.executor.stub:make_stub"
# [serve live]: timed Poisson arrivals, an ARCO session in the idle slots
LIVE_REQUESTS, LIVE_RATE = 48, 2.0
LIVE_PROMPT, LIVE_NEW = (4, 512), (2, 32)
LIVE_BUDGET = 24          # measurements per cell (decode, prefill)
LIVE_SLA_S = 3.0          # p99 target: a 32-token request is ~2 s of decode
# [train]: full-width qwen2-1.5b bf16 training steps (8,192 tokens a step,
# two 1,024-key attention chunks); the RMSNorm rows of a step
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 20
TRAIN_LR, TRAIN_WARMUP = 3e-4, 4
TRAIN_NORM_SHAPE = (TRAIN_BATCH * TRAIN_SEQ, 1536)
LAUNCH_TIMEOUT_S = 300    # the launcher subprocess of [train faults]
# [train sharded], [serve sharded], [train int8]: the mesh paths at world
# size 1 (one card), a (data 1, model 1) DeviceMesh over NCCL; every op
# runs on the whole tensor, so the values equal the unsharded path's
MESH_STEPS = 3            # [train sharded] and [train int8] steps
MESH_TOL = 1e-6           # relative, against the unsharded path
MESH_SERVE_BATCH, MESH_SERVE_PROMPT, MESH_SERVE_STEPS = 8, 1024, 16
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
# the embedding's relative perturbation that measures a model's own noise:
# the size of one rounding in each dtype
NOISE = {"float32": 1e-7, "bfloat16": 2 ** -8}
# the families whose bf16 gate also holds the free-running paths (with the
# same expert sets); xlstm's own noise at depth exceeds the gate (its
# logits move by O(1) under one bf16 rounding of the input: PERF.md), so
# its bf16 gate is block by block only (:func:`_lockstep`)
FREE_BF16_GATE = ("moe", "hybrid", "audio", "vlm", "swa")
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
# 8,192-token context, the first fixed at 4,080 so that its decode wraps
# the ring mid-request
SWA_ARCH = "mixtral-8x22b"
SWA_SERVE_LAYERS, SWA_GATE_LAYERS = 4, 2
SWA_MAX_LEN = 8192
SWA_FIRST_PROMPT = 4080
# (arch, requests, prompt lengths drawn in, new tokens each, max_len)
FAMILY_SERVE = {"moe": (MOE_ARCH, 16, (128, 1024), 32, LM_MAX_LEN),
                "ssm": (SSM_ARCH, 8, (64, 256), 32, LM_MAX_LEN),
                "hybrid": (HYBRID_ARCH, 8, (128, 512), 16, LM_MAX_LEN),
                "audio": (AUDIO_ARCH, 16, (4, 223), 64, AUDIO_MAX_LEN),
                "vlm": (VLM_ARCH, 8, (64, 512), 32, LM_MAX_LEN),
                "swa": (SWA_ARCH, 8, (3072, 6144), 32, SWA_MAX_LEN)}
# a family's first prompt lengths where they are fixed, not drawn
FIXED_PROMPTS = {"swa": (SWA_FIRST_PROMPT,)}
# [train audio]: whisper-base bf16 training steps, 8 x 448 text tokens
# and 8 x 1500 frames a step
AUDIO_TRAIN_BATCH, AUDIO_TRAIN_STEPS = 8, 10
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
# [autotune]: the CLI's pod-level tune at 256 placeholder devices (the
# reference's default budget 14 cut to 8); records and report under build/
AUTOTUNE_ARCH, AUTOTUNE_SHAPE, AUTOTUNE_BUDGET = "qwen2-1.5b", "train_4k", 8
AUTOTUNE_DEVICES = 256
FLOP_RTOL = 1e-6          # the estimator's dot FLOPs vs FlopCounterMode
# [drivers]: the reference's examples as the port runs them (python -m
# repro_torch.examples.<name>), in process on the card: quickstart and
# serve_lm at their defaults (8 requests of 4-19 tokens, 12 new, on
# qwen2-1.5b's reduced config), train_lm (reduced smollm-360m, 8 x 128
# tokens a step) for DRIVER_TRAIN_STEPS steps
DRIVER_REQUESTS, DRIVER_NEW, DRIVER_PROMPT_MAX = 8, 12, 19
DRIVER_TRAIN_ARCH, DRIVER_TRAIN_ROWS = "smollm-360m", 8 * 128
DRIVER_TRAIN_STEPS = 20
# the gates' prompt lengths, where not the served ones: xlstm's prefill is
# one Python step a token and layer (~20 ms a token), and its gates run 11
# prefills a prompt; mixtral's past its window, so that the window binds
# and whole KV tiles below it are skipped, and the prefill rotates the ring
GATE_PROMPT = {"ssm": (64, 128), "swa": (4608, 5120)}
# configs whose kernel layouts the checks hold at their full width but
# which no phase serves (they run qwen2's code path): their flash templates
# and RMSNorm layouts over prompts up to LM_PROMPT[1] tokens
HELD_ONLY = ("minitron-4b", "qwen1.5-4b", "smollm-360m")
# the port's kernels as the profiler names them
PORT_KERNEL_NAMES = ("gemm_f32_kernel", "splitk_sum_kernel",
                     "gemm_bf16_kernel", "flash_mma_kernel",
                     "flash_f32_kernel", "flash_f32_combine_kernel",
                     "rmsnorm_kernel")
# the templates redesigned for the card, whose ptxas lines are printed
NEW_TEMPLATES = ("gemm_f32_kernel", "gemm_bf16_kernel", "splitk_sum_kernel",
                 "flash_mma_kernel", "flash_f32_kernel",
                 "flash_f32_combine_kernel", "rmsnorm_kernel")


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events),
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got, want) -> tuple:
    diff = float((got.float() - want.float()).abs().max())
    return diff, diff / max(float(want.float().abs().max()), 1e-30)


def gemm_shapes(model: str = "resnet-18", batch: int = BATCH):
    """(task name, M, N, K, layers) of each unique conv GEMM of ``model``."""
    from repro_torch.core.task import conv_tasks
    out = []
    for t in conv_tasks(model, batch=batch):
        wl = t.space.workload
        oh = (wl["h"] + 2 * wl["pad"] - wl["kh"]) // wl["stride"] + 1
        ow = (wl["w"] + 2 * wl["pad"] - wl["kw"]) // wl["stride"] + 1
        out.append((t.name, wl["b"] * oh * ow, wl["co"],
                    wl["ci"] * wl["kh"] * wl["kw"], t.multiplicity))
    return out


def knob_config(settings, spec):
    """A task's tuned knob settings -> the GEMM geometry of one layer."""
    from repro_torch.kernels.gemm import gemm_config_from_knobs
    return gemm_config_from_knobs(
        tile_m=settings["tile_b"] * settings["tile_h"] * settings["tile_w"],
        tile_n=settings["tile_co"],
        tile_k=settings["tile_ci"] * spec.kh * spec.kw,
        h_threading=settings["h_threading"],
        oc_threading=settings["oc_threading"])


# ------------------------------------------------------------------ phases

def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    log(out[0])
    return out[0]


def phase_build() -> float:
    """Builds the three kernels, one nvcc each, all started together, and
    prints ptxas's registers, spills and static shared memory of each new
    template (the dynamic shared memory a launch asks for is printed with
    its run geometry by the checks)."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    per_kernel = _build.build_all(KERNELS)
    dt = time.perf_counter() - t0
    for name, secs in per_kernel.items():
        log(f"[build] {os.path.relpath(_build.build(name), ROOT)} "
            f"in {secs:.1f} s")
    log(f"[build] {len(per_kernel)} kernels in {dt:.1f} s (in parallel)")
    spills, seen = 0, set()
    for name in KERNELS:
        for r in _build.ptxas_report(name):
            base = r["kernel"].partition("<")[0]
            if base not in NEW_TEMPLATES:
                continue
            seen.add(base)
            spills += r["spill_stores"] + r["spill_loads"]
            log(f"[build] ptxas {r['kernel']}: {r['registers']} registers, "
                f"spill stores {r['spill_stores']} B, loads "
                f"{r['spill_loads']} B, static smem {r['static_smem']} B")
    check(seen == set(NEW_TEMPLATES),
          f"ptxas reported {sorted(seen)}, not every one of {NEW_TEMPLATES}")
    log(f"[build] new templates spill {spills} bytes in all")
    log_lm_rmsnorm_templates()
    return dt


def lm_rmsnorm_layouts() -> dict:
    """The RMSNorm layouts the LM paths run at each served model's d_model
    (bf16 serving, the fp32 gates) for 1 row to its longest prefill's (a
    vision prefix + its longest prompt, or an encoder's frames) or the
    family training phases' step (forward and the backward's recompute),
    ``[drivers]``' reduced models (serve_lm's prompts, train_lm's
    step), and the HELD_ONLY configs over LM_PROMPT: (d, dtype, 16-byte
    copies, warps a row, slots a lane, rows a block) -> the rows that run
    it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import rmsnorm as RN
    widths = {lm_config(torch.bfloat16).d_model: LM_PROMPT[1]}
    for arch in HELD_ONLY:
        d = get_config(arch).d_model
        widths[d] = max(widths.get(d, 0), LM_PROMPT[1])
    for arch, _, prompt, _, _ in FAMILY_SERVE.values():
        cfg = get_config(arch)
        rows = max(cfg.vision_prefix + prompt[1], cfg.enc_seq)
        widths[cfg.d_model] = max(widths.get(cfg.d_model, 0), rows)
    for arch, _, batch, seq, _, _ in FAMILY_TRAIN.values():
        d = get_config(arch).d_model     # a training step's rows
        widths[d] = max(widths.get(d, 0), batch * seq)
    # [drivers]: serve_lm's prompts and train_lm's step
    for arch, rows in ((LM_ARCH, DRIVER_PROMPT_MAX),
                       (DRIVER_TRAIN_ARCH, DRIVER_TRAIN_ROWS)):
        d = get_config(arch, reduced=True).d_model
        widths[d] = max(widths.get(d, 0), rows)
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
    in each served attention model's prefills, from 1 token to its longest
    (a vision prefix + its longest prompt, or an encoder's frames), at the
    blocks the model asks for, serve_lm's reduced qwen2 in ``[drivers]``,
    and the HELD_ONLY configs over LM_PROMPT: (bq, bk, dp, dtype) -> the
    (head_dim, S) that run it."""
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
            models.append((cfg, max(cfg.vision_prefix + prompt[1],
                                    cfg.enc_seq)))
    out = {}
    for cfg, max_s in models:
        for dtype in (torch.bfloat16, torch.float32):
            for s in range(1, max_s + 1):
                g = FA.legalize(block_q, block_k, s, cfg.head_dim, dtype)
                out.setdefault((g.bq, g.bk, g.dp, g.dtype), []).append(
                    (cfg.head_dim, s))
    return out


def log_lm_rmsnorm_templates() -> None:
    """The RMSNorm templates the LM path runs, with ptxas's registers and
    spills."""
    import torch
    from repro_torch.kernels import _build
    reports = {r["kernel"]: r for r in _build.ptxas_report("rmsnorm")}
    ctypes = {torch.bfloat16: "__nv_bfloat16", torch.float32: "float"}
    spills = 0
    for (d, dtype, vec, warps, slots, rpb), rows in \
            lm_rmsnorm_layouts().items():
        name = (f"rmsnorm_kernel<{ctypes[dtype]}, {ctypes[dtype]}, "
                f"{int(vec)}, {slots}>")
        check(name in reports, f"ptxas reported no {name}")
        r = reports[name]
        spills += r["spill_stores"] + r["spill_loads"]
        log(f"[build] the LM path's RMSNorm at d {d}, rows {rows[0]}-"
            f"{rows[-1]}: {name}, {warps} warps a row, {rpb} a block: "
            f"{r['registers']} registers, spills "
            f"{r['spill_stores'] + r['spill_loads']} B")
    log(f"[build] the LM path's RMSNorm templates spill {spills} bytes")


def phase_check_kernel(dev) -> float:
    """Kernel vs plain version on the reference test cases and the main
    path's shapes; returns the largest absolute fp32 error at the main
    path's shapes."""
    import torch
    from repro_torch.core.task import conv_tasks
    from repro_torch.kernels import gemm as G
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_checks = 0
    for m, k, n in REFERENCE_SHAPES:
        for cfg in REFERENCE_CONFIGS:
            for dtype, tol in ((torch.float32, FP32_TOL),
                               (torch.bfloat16, BF16_TOL)):
                a = torch.randn(m, k, generator=gen, device=dev).to(dtype)
                b = torch.randn(k, n, generator=gen, device=dev).to(dtype)
                c = G.GemmConfig(*cfg)
                got = G.gemm(a, b, c)
                want = G.gemm(a, b, c, use_kernel=False)
                torch.cuda.synchronize()
                _, rel = rel_err(got, want)
                check(got.dtype == dtype and rel <= tol,
                      f"gemm {(m, k, n)} {cfg} {dtype}: rel err {rel:.3g}")
                n_checks += 1
    # out_dtype both ways; fp32 -> bf16 also through split-K
    pairs = ((torch.float32, torch.bfloat16, BF16_TOL),
             (torch.bfloat16, torch.float32, FP32_TOL))
    cases = [(shape, cfg, pair) for shape in REFERENCE_SHAPES
             for cfg in REFERENCE_CONFIGS for pair in pairs]
    cases += [(shape, cfg, pairs[0])
              for shape, cfg, _ in GEMM_EXTRA_CHECKS[:3]]
    for (m, k, n), cfg, (src, dst, tol) in cases:
        a = torch.randn(m, k, generator=gen, device=dev).to(src)
        b = torch.randn(k, n, generator=gen, device=dev).to(src)
        c = G.GemmConfig(*cfg)
        got = G.gemm(a, b, c, out_dtype=dst)
        run = G.gemm.last_geometry["run"]
        want = G.gemm(a, b, c, out_dtype=dst, use_kernel=False)
        torch.cuda.synchronize()
        diff, rel = rel_err(got, want)
        check(got.dtype == dst and rel <= tol,
              f"gemm {(m, k, n)} {cfg} {src} -> {dst}: rel err {rel:.3g}")
        if run["split_k"] > 1:
            log(f"[check] gemm M={m} K={k} N={n} fp32 -> bf16 run={run} "
                f"max_abs_err={diff:.3g} rel={rel:.3g}")
        n_checks += 1
    log(f"[check] gemm out_dtype fp32 -> bf16 (tol {BF16_TOL}) and bf16 -> "
        f"fp32 (tol {FP32_TOL}): {len(cases)} checks passed")
    for (m, k, n), cfg, dt in GEMM_EXTRA_CHECKS:
        dtype, tol = getattr(torch, dt), (FP32_TOL if dt == "float32"
                                          else BF16_TOL)
        a = torch.randn(m, k, generator=gen, device=dev).to(dtype)
        b = torch.randn(k, n, generator=gen, device=dev).to(dtype)
        c = G.GemmConfig(*cfg)
        got = G.gemm(a, b, c)
        run = G.gemm.last_geometry["run"]
        want = G.gemm(a, b, c, use_kernel=False)
        torch.cuda.synchronize()
        diff, rel = rel_err(got, want)
        check(rel <= tol, f"gemm {(m, k, n)} {run}: rel err {rel:.3g}")
        log(f"[check] gemm M={m} K={k} N={n} run={run} dynamic smem "
            f"{G.RunGeometry(**run).smem_bytes} B max_abs_err={diff:.3g} "
            f"rel={rel:.3g}")
        n_checks += 1
    worst = 0.0
    tasks = conv_tasks("resnet-18", batch=BATCH)
    for (name, m, n, k, _), task in zip(gemm_shapes(), tasks):
        # knob-derived geometries: every M template (16, 32, 64 from small
        # spatial tiles, 128 from the default), the task's extreme Ci/Co
        sp, wl = task.space, task.space.workload
        kk = wl["kh"] * wl["kw"]
        configs = [G.GemmConfig()] + [
            G.gemm_config_from_knobs(tm, sp.choices[2][i],
                                     sp.choices[1][i] * kk, 2, 2)
            for tm, i in ((1, 0), (32, -1), (64, 0))]
        a = torch.randn(m, k, generator=gen, device=dev)
        b = torch.randn(k, n, generator=gen, device=dev)
        for x, y, tol in ((a, b, FP32_TOL),
                          (a.bfloat16(), b.bfloat16(), BF16_TOL)):
            for cfg in configs:
                got = G.gemm(x, y, cfg)
                run = G.gemm.last_geometry["run"]
                want = G.gemm(x, y, cfg, use_kernel=False)
                torch.cuda.synchronize()
                diff, rel = rel_err(got, want)
                check(rel <= tol,
                      f"gemm {name} {(m, n, k)} {run}: rel err {rel:.3g}")
                if x.dtype == torch.float32:
                    worst = max(worst, diff)
                n_checks += 1
                log(f"[check] {name} M={m} N={n} K={k} run={run} dynamic "
                    f"smem {G.RunGeometry(**run).smem_bytes} B "
                    f"max_abs_err={diff:.3g} rel={rel:.3g}")
    log(f"[check] {n_checks} kernel-vs-plain checks passed "
        f"(fp32 tol {FP32_TOL} x max|plain|, bf16 {BF16_TOL})")
    return worst


def phase_tune(dev):
    from repro_torch.compiler.session import Session
    from repro_torch.compiler.task import TuningTask
    from repro_torch.core.tuner import TunerConfig
    import torch
    tasks = TuningTask.conv_tasks("resnet-18", batch=BATCH)
    check(len(tasks) == 8 and sum(t.multiplicity for t in tasks) == 17,
          "ResNet-18 must give 8 tasks over 17 layers")
    t0 = time.perf_counter()
    rep = Session(tasks, tuner=TunerConfig.fast(), budget=TUNE_BUDGET,
                  seed=SEED, device=dev).run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for r in rep:
        check(r.n_measurements == TUNE_BUDGET and math.isfinite(r.best_latency)
              and r.best_settings is not None, f"tuning {r.task} failed")
        log(f"[tune] {r.task} x{r.multiplicity} best {r.best_latency:.4g} s "
            f"(analytical TPU v5e model) {r.best_settings}")
    log(f"[tune] 8 tasks x {TUNE_BUDGET} measurements in {dt:.2f} s")
    return rep, dt


def phase_episode_time(dev) -> float:
    """Device time of one MAPPO episode (TunerConfig.fast) on the card."""
    import torch
    from repro_torch.compiler.task import TuningTask
    from repro_torch.core import mappo
    from repro_torch.core.agents import init_marl_params
    from repro_torch.core.cost_model import GBTModel
    from repro_torch.core.tuner import TunerConfig
    hp = TunerConfig.fast().mappo
    space = TuningTask.conv_tasks("resnet-18", batch=BATCH)[1].space
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfgs = space.random_configs(gen, 64)
    gbt = GBTModel(n_rounds=16)
    gbt.update(space.feature_vector(cfgs).cpu().numpy(),
               -torch.log(space.measure(cfgs)).cpu().numpy())
    env = mappo.env_params_from_space(space, device=dev)
    forest = gbt.to_forest(dev)
    nets = init_marl_params(SEED, device=dev)
    opt = mappo.make_optimizer(nets, hp)
    ms = cuda_ms(lambda: mappo.train_episode(nets, opt, gen, env, forest, hp),
                 reps=5)
    log(f"[tune] one MAPPO episode (n_steps={hp.n_steps}, n_envs="
        f"{hp.n_envs}, {hp.epochs} epochs) {ms:.2f} ms")
    return ms


def resnet_layers() -> tuple:
    """ResNet-18's conv specs and each layer's task name."""
    from repro_torch.core.task import conv_tasks
    from repro_torch.models import cnn
    layer_task = {layer: t.name for t in conv_tasks("resnet-18", batch=BATCH)
                  for layer in t.layer_names}
    return cnn.conv_specs("resnet-18"), layer_task


def tuned_configs(rep) -> tuple:
    """Each ResNet-18 conv layer's GemmConfig from its task's tuned knobs
    (``knob_config``), and each task's (its shape's) config."""
    specs, layer_task = resnet_layers()
    configs = [knob_config(rep[layer_task[s.name]].best_settings, s)
               for s in specs]
    per_shape = {}
    for s, cfg in zip(specs, configs):
        per_shape.setdefault(layer_task[s.name], cfg)
    return configs, per_shape


def resnet_setup(dev):
    """ResNet-18's conv specs, each layer's task name, the seeded weights
    and the 224x224 batch-8 input that every deploy phase runs."""
    import torch
    from repro_torch.models import cnn
    specs, layer_task = resnet_layers()
    net = cnn.init_params(SEED, "resnet-18", device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn((BATCH, 224, 224, 3), generator=gen, device=dev)
    return specs, layer_task, net, x


def phase_deploy(dev, rep):
    """Full-width ResNet-18 forward with tuned per-layer geometries; reads
    the kernel's launch count right after the first forward (the count was
    set to 0 before tuning, where the main path starts)."""
    import torch
    from repro_torch.kernels import gemm as G
    _, _, net, x = resnet_setup(dev)
    configs, per_shape = tuned_configs(rep)
    with torch.no_grad():
        logits = net(x, configs)
        torch.cuda.synchronize()
        launches = G.gemm.launches   # the main path ends here
        check(launches == 17, f"forward launched the kernel {launches} "
                              "times, expected 17")
        plain = net(x, use_kernel=False)
        torch.cuda.synchronize()
    check(tuple(logits.shape) == (BATCH, 1000), f"logits {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    diff, rel = rel_err(logits, plain)
    check(rel <= FORWARD_TOL, f"forward vs plain path: rel err {rel:.3g}")
    log(f"[deploy] ResNet-18 224x224 batch {BATCH}: 17 kernel launches, "
        f"logits max_abs_err {diff:.3g} (rel {rel:.3g}) vs cuDNN fp32")
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: net(x, configs), reps=5)
        plain_fwd_ms = cuda_ms(lambda: net(x, use_kernel=False), reps=5)
    log(f"[deploy] forward {fwd_ms:.3f} ms through the kernel, "
        f"{plain_fwd_ms:.3f} ms through cuDNN fp32 convolutions")
    with torch.no_grad():   # where the forward's time goes
        profile_runs({"forward": (3, lambda: net(x, configs))})
    return launches, diff, fwd_ms, plain_fwd_ms, configs, per_shape


def phase_time_shapes(dev, per_shape):
    """Per-shape kernel / plain / library times and bounds at batch 8.
    ``ms`` and ``library_ms`` are CUDA-event times over Python calls
    (``cuda_ms``), the method of the first port's numbers; ``device_ms``
    and ``library_device_ms`` are the same calls captured in a CUDA graph
    (``device_ms``), without the host's launch overhead."""
    import torch
    from repro_torch.kernels import gemm as G
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows = []
    for name, m, n, k, layers in gemm_shapes():
        cfg = per_shape[name]
        geom = G.legalize(cfg, m, n, k)
        a = torch.randn(m, k, generator=gen, device=dev)
        b = torch.randn(k, n, generator=gen, device=dev)
        ms = cuda_ms(lambda: G.gemm(a, b, cfg), reps=20)
        dev_ms = device_ms(lambda: G.gemm(a, b, cfg))
        lib_ms = cuda_ms(lambda: torch.matmul(a, b), reps=20)
        lib_dev_ms = device_ms(lambda: torch.matmul(a, b))
        plain_ms = cuda_ms(lambda: G.gemm_plain(a, b, geom), reps=1)
        flops = 2.0 * m * n * k
        nbytes = 4.0 * (m * k + k * n + m * n)
        t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        row = {"task": name, "M": m, "N": n, "K": k, "layers": layers,
               "run": [geom.bm, geom.bn, geom.bk], "split_k": geom.split_k,
               "vec": geom.vec,
               "requested": [cfg.block_m, cfg.block_n, cfg.block_k],
               "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "tflops": flops / ms / 1e9,
               "device_tflops": flops / dev_ms / 1e9}
        rows.append(row)
        log(f"[time] {name} M={m} N={n} K={k} x{layers} run={row['run']} "
            f"split_k={geom.split_k} vec={geom.vec} "
            f"kernel {ms:.4f} ms ({row['tflops']:.2f} TFLOP/s, "
            f"{100 * row['bound_ms'] / ms:.1f}% of bound), "
            f"device time {dev_ms:.4f} ms "
            f"({100 * row['bound_ms'] / dev_ms:.1f}% of bound), "
            f"torch.matmul {lib_ms:.4f} ms (device time {lib_dev_ms:.4f}), "
            f"plain {plain_ms:.1f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows


def events_ms(fn) -> tuple:
    """(fn's result, the device ms of that one call by CUDA events)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def bf16_gemm_cases(per_shape) -> list:
    """``[time bf16]``'s cases, (task, M, N, K, layers, geometry label,
    GemmConfig): the 8 ResNet-18 shapes at batch 8 under the tuned
    geometries (``per_shape``) and under ``GemmConfig()``, and bert-gemm's
    four GEMM shapes (the resnet-bert network's tail) under
    ``GemmConfig()``."""
    from repro_torch.compiler.zoo import get_network
    from repro_torch.kernels import gemm as G
    shapes = gemm_shapes()
    cases = [(name, m, n, k, layers, "tuned", per_shape[name])
             for name, m, n, k, layers in shapes]
    cases += [(name, m, n, k, layers, "default", G.GemmConfig())
              for name, m, n, k, layers in shapes]
    for t in get_network("bert-gemm").tasks:
        wl = t.space.workload
        cases.append((t.name, wl["m"], wl["n"], wl["k"], t.multiplicity,
                      "default", G.GemmConfig()))
    return cases


def phase_time_bf16(dev, per_shape) -> dict:
    """``[time bf16]``: the GEMM with bf16 operands and C (fp32
    accumulation, as the TPU kernel's MXU dot) at :func:`bf16_gemm_cases`.
    Each row: the run geometry, the kernel and one ``torch.matmul`` bf16
    call by ``device_ms`` (a CUDA graph), the plain version by CUDA events
    over one call, and the bound: the operands read once and C written
    once at 3.35 TB/s against 2 M N K operations at the bf16 tensor-core
    peak; the kernel's output is held against the plain version's at
    BF16_TOL.  Then the device ms of the forward's 17 GEMMs under the
    tuned geometries and under ``GemmConfig()``.  Returns the rows, those
    totals and the (M, N, K, run geometry) set the checks held."""
    import torch
    from repro_torch.kernels import gemm as G
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    bf = torch.bfloat16
    rows, checked = [], set()
    for name, m, n, k, layers, label, cfg in bf16_gemm_cases(per_shape):
        a = torch.randn(m, k, generator=gen, device=dev).to(bf)
        b = torch.randn(k, n, generator=gen, device=dev).to(bf)
        got = G.gemm(a, b, cfg)
        run = G.gemm.last_geometry["run"]
        want, plain_ms = events_ms(lambda: G.gemm(a, b, cfg,
                                                  use_kernel=False))
        diff, rel = rel_err(got, want)
        check(got.dtype == bf and rel <= BF16_TOL,
              f"gemm bf16 {name} {(m, n, k)} {run}: rel err {rel:.3g}")
        checked.add((m, n, k, tuple(sorted(run.items()))))
        dev_ms = device_ms(lambda: G.gemm(a, b, cfg))
        lib_ms = device_ms(lambda: torch.matmul(a, b))
        flops = 2.0 * m * n * k
        nbytes = 2.0 * (m * k + k * n + m * n)
        row = {"task": name, "M": m, "N": n, "K": k, "layers": layers,
               "geometry": label,
               "requested": [cfg.block_m, cfg.block_n, cfg.block_k],
               "run": [run["bm"], run["bn"], run["bk"]],
               "split_k": run["split_k"], "vec": run["vec"],
               "device_ms": dev_ms, "library_device_ms": lib_ms,
               "plain_ms": plain_ms, "max_abs_err": diff, "rel_err": rel,
               **bound(flops / BF16_FLOPS * 1e3,
                       nbytes / HBM_BYTES_PER_S * 1e3),
               "device_tflops": flops / dev_ms / 1e9}
        rows.append(row)
        log(f"[time bf16] {name} M={m} N={n} K={k} x{layers} {label} "
            f"requested={row['requested']} run={row['run']} "
            f"split_k={row['split_k']} vec={row['vec']}: device time "
            f"{dev_ms:.4f} ms ({row['device_tflops']:.2f} TFLOP/s, "
            f"{100 * row['bound_ms'] / dev_ms:.1f}% of bound), "
            f"torch.matmul bf16 {lib_ms:.4f} ms, plain {plain_ms:.1f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); vs plain "
            f"max_abs_err={diff:.3g} rel={rel:.3g}")
    resnet = {t for t, *_ in gemm_shapes()}
    total = {}
    for label in ("tuned", "default"):
        fwd = [r for r in rows if r["task"] in resnet
               and r["geometry"] == label]
        total[label] = {key: sum(r[key] * r["layers"] for r in fwd)
                        for key in ("device_ms", "library_device_ms",
                                    "plain_ms", "bound_ms")}
        by_ops = sum(r["bound_ms"] * r["layers"] for r in fwd
                     if r["bound_by"] == "operations")
        total[label]["bound_by"] = ("operations" if 2 * by_ops >=
                                    total[label]["bound_ms"] else "bytes")
    log(f"[time bf16] the forward's 17 GEMMs (device_ms): "
        f"{total['tuned']['device_ms']:.4f} ms at the tuned geometries, "
        f"{total['default']['device_ms']:.4f} ms at GemmConfig(); "
        f"torch.matmul bf16 {total['tuned']['library_device_ms']:.4f} ms; "
        f"bound {total['tuned']['bound_ms']:.4f} ms; {len(checked)} "
        f"geometries held against the plain version (tol {BF16_TOL})")
    return {"rows": rows, "forward": total, "checked": checked}


def cudnn_bf16_forward(net, x):
    """ResNet-18's forward as ``cnn.apply`` runs it, each conv one cuDNN
    call in x's dtype (NHWC x, HWIO weights): the yardstick of the bf16
    forward, which the port never calls."""
    import torch.nn.functional as F
    from repro_torch.models import cnn
    specs = cnn.conv_specs(net.model)
    nchw = lambda f, t, *a, **kw: f(t.permute(0, 3, 1, 2), *a,
                                    **kw).permute(0, 2, 3, 1)

    def conv(i, t):
        return nchw(F.conv2d, t, net.conv_w[i].permute(3, 2, 0, 1),
                    stride=specs[i].stride,
                    padding=specs[i].pad) + net.conv_b[i]

    x = nchw(F.max_pool2d, F.relu(conv(0, x)), 3, 2, padding=1)
    for i in range(1, len(specs), 2):   # the basic blocks, as cnn.apply
        y = conv(i + 1, F.relu(conv(i, x)))
        if x.shape != y.shape:
            s = specs[i].stride
            x = F.pad(nchw(F.avg_pool2d, x, s, s),
                      (0, y.shape[-1] - x.shape[-1]))
        x = F.relu(x + y)
    return x.mean(dim=(1, 2)) @ net.fc_w + net.fc_b


def phase_deploy_bf16(dev, configs) -> dict:
    """``[deploy bf16]``: ResNet-18 at 224x224, batch 8, deployed in bf16
    (``net.to(torch.bfloat16)``, bf16 input) with the per-layer geometries
    ``[tune]`` found.  The GEMM's launch count is set to 0 just before the
    forward and must read 17 just after; the logits finite, of shape (8,
    1000) and within DEPLOY_BF16_TOL of the plain path in bf16.  Printed,
    not gated: the distance to the fp32 forward (the plain path, cuDNN
    fp32) and to a forward whose convs are cuDNN bf16 calls
    (:func:`cudnn_bf16_forward`); the forward's ms through the kernel, the
    plain path and cuDNN bf16 (CUDA events over Python calls); a profile
    of the forward.  Returns those numbers and the (M, N, K, run
    geometry) of each GEMM the forward ran."""
    import torch
    from repro_torch.kernels import gemm as G
    specs, layer_task, net, x = resnet_setup(dev)
    with torch.no_grad():
        fp32 = net(x, use_kernel=False)
    net = net.to(torch.bfloat16)
    x = x.to(torch.bfloat16)
    mnk = {t: (m, n, k) for t, m, n, k, _ in gemm_shapes()}
    ran = set()
    for s, cfg in zip(specs, configs):
        shape = mnk[layer_task[s.name]]
        geom = G.legalize(cfg, *shape, torch.bfloat16)
        ran.add((*shape, tuple(sorted(dataclasses.asdict(geom).items()))))
    with torch.no_grad():
        G.gemm.launches = 0   # the bf16 deploy path starts here
        logits = net(x, configs)
        torch.cuda.synchronize()
        launches = G.gemm.launches   # and ends here
        check(launches == 17, f"bf16 forward launched the kernel "
                              f"{launches} times, expected 17")
        plain = net(x, use_kernel=False)
        cudnn = cudnn_bf16_forward(net, x)
        cudnn_ms = cuda_ms(lambda: cudnn_bf16_forward(net, x), reps=5)
        torch.cuda.synchronize()
    check(tuple(logits.shape) == (BATCH, 1000) and logits.dtype ==
          torch.bfloat16, f"bf16 logits {logits.shape} {logits.dtype}")
    check(bool(torch.isfinite(logits).all()), "non-finite bf16 logits")
    diff, rel = rel_err(logits, plain)
    check(rel <= DEPLOY_BF16_TOL, f"bf16 forward vs plain path: rel err "
                                  f"{rel:.3g} > {DEPLOY_BF16_TOL}")
    _, rel32 = rel_err(logits, fp32)
    _, rel_cudnn = rel_err(logits, cudnn)
    log(f"[deploy bf16] ResNet-18 224x224 batch {BATCH} in bf16, tuned "
        f"geometries: 17 kernel launches, logits max_abs_err {diff:.3g} "
        f"(rel {rel:.3g}, gate {DEPLOY_BF16_TOL}) vs the plain path (cuDNN "
        f"fp32 convolutions on the bf16 values, rounded to bf16 a layer); "
        f"rel {rel32:.3g} vs the fp32 forward, {rel_cudnn:.3g} vs cuDNN "
        f"bf16 convolutions (not gated)")
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: net(x, configs), reps=5)
        plain_ms = cuda_ms(lambda: net(x, use_kernel=False), reps=5)
    log(f"[deploy bf16] forward {fwd_ms:.3f} ms through the kernel, "
        f"{plain_ms:.3f} ms through the plain path, {cudnn_ms:.3f} ms "
        f"through cuDNN bf16 convolutions (CUDA events over Python calls)")
    with torch.no_grad():
        profile = profile_runs({"forward bf16": (3, lambda: net(x,
                                                                 configs))})
    return {"launches": launches, "logits_max_abs_err": diff,
            "logits_rel_err": rel, "logits_rel_err_vs_fp32": rel32,
            "logits_rel_err_vs_cudnn_bf16": rel_cudnn, "forward_ms": fwd_ms,
            "forward_plain_ms": plain_ms, "forward_cudnn_bf16_ms": cudnn_ms,
            "profile": profile, "geometries": ran}


@contextlib.contextmanager
def fp32_flash_recorded(calls):
    """While active, records in ``calls`` every fp32 flash launch by
    ((B, S, HQ, D), HKV, causal, window, block_q, block_k): the
    difference, over the block, of the wrapper's own record
    (``flash_attention.calls``, bumped where ``flash_attention.launches``
    is, so only a launch on the card counts)."""
    from repro_torch.kernels import flash_attention as FA
    before = collections.Counter(FA.flash_attention.calls)
    yield calls
    for (*key, dtype), n in (FA.flash_attention.calls - before).items():
        if dtype == "float32":
            calls[tuple(key)] += n


def fp32_gate_calls() -> collections.Counter:
    """The fp32 flash launches the fp32 gates make, in the recorder's keys,
    from their own draws and configs: each gate's prompt lengths (the
    first draw of its seeded generator: phase_lm_gate's, then each
    family's), one prefill a prompt on the kernel path, one launch an
    attention layer (a vision prefix ahead of the prompt; an encoder's
    layers non-causal over its frames).  The full run holds it equal to
    what :func:`fp32_flash_recorded` counted; ``--flash-fp32`` times the
    kernel at these shapes without the gates."""
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


def phase_time_flash_fp32(dev, calls) -> dict:
    """``[time flash fp32]``: the fp32 flash kernel (``flash_f32_kernel``,
    register-tiled FFMA fed by a ``cp.async`` ring) at every shape the
    fp32 gates launched (``calls``, from :func:`fp32_flash_recorded`, or
    :func:`fp32_gate_calls`): the kernel and one SDPA fp32 call by
    ``device_ms``, the plain version by CUDA events over one call (its
    output holds the kernel's at FP32_TOL), and the bound: the fp32
    operations over the 67 TFLOP/s FMA peak against q, k, v read and o
    written once.  A windowed shape's SDPA takes the band as a boolean
    mask and its operations count the pairs inside the band
    (:func:`sdpa_call`, :func:`attention_flops`).  Totals over the
    launches; then the CUDA kernels the profiler sees SDPA fp32 run, one
    call a shape."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    rows, sdpa_calls = [], []
    for (qshape, hkv, causal, window, bq, bk), n in sorted(calls.items()):
        b, s, hq, d = qshape
        q = torch.randn(qshape, generator=gen, device=dev)
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev)
                for _ in range(2))
        got = FA.flash_attention(q, k, v, causal, window, None, bq, bk)
        geom = FA.RunGeometry(**FA.flash_attention.last_geometry["run"])
        want, plain_ms = events_ms(lambda: FA.flash_attention_plain(
            q, k, v, causal, window, d ** -0.5, geom))
        diff, rel = rel_err(got, want)
        check(rel <= FP32_TOL, f"flash fp32 {qshape} {hkv}: rel err "
                               f"{rel:.3g}")
        sdpa = sdpa_call(q, k, v, causal, window)
        sdpa_calls.append(sdpa)
        flops = attention_flops(b, s, hq, d, causal, window)
        row = {"shape": [b, s, hq, hkv, d], "causal": causal,
               "window": window, "launches": n,
               "run": [geom.bq, geom.bk, geom.dp], "kv_chunk": geom.kv_chunk,
               "ms": device_ms(lambda: FA.flash_attention(
                   q, k, v, causal, window, None, bq, bk)),
               "library_ms": device_ms(sdpa),
               "plain_ms": plain_ms, "max_abs_err": diff,
               **bound(flops / FP32_FLOPS * 1e3,
                       4.0 * b * s * d * (2 * hq + 2 * hkv)
                       / HBM_BYTES_PER_S * 1e3)}
        rows.append(row)
        log(f"[time flash fp32] {row['shape']}"
            f"{' causal' if causal else ' non-causal'}"
            f"{'' if window is None else f' window {window}'} x{n} launches "
            f"run={row['run']} kv_chunk={geom.kv_chunk}: kernel "
            f"{row['ms']:.4f} ms, SDPA fp32 "
            f"{row['library_ms']:.4f} ms, plain {plain_ms:.2f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}; the kernel at "
            f"{100 * row['bound_ms'] / row['ms']:.1f}% of it); vs plain "
            f"max_abs_err={diff:.3g} rel={rel:.3g}")
    tot = {key: sum(r[key] * r["launches"] for r in rows)
           for key in ("ms", "library_ms", "plain_ms", "bound_ms")}
    by_ops = sum(r["bound_ms"] * r["launches"] for r in rows
                 if r["bound_by"] == "operations")
    tot["bound_by"] = ("operations" if 2 * by_ops >= tot["bound_ms"]
                       else "bytes")
    tot["launches"] = sum(calls.values())
    tot["max_abs_err"] = max((r["max_abs_err"] for r in rows), default=0.0)
    tot["shapes"] = rows
    log(f"[time flash fp32] over the fp32 gates' {tot['launches']} launches "
        f"({len(rows)} shapes): kernel {tot['ms']:.3f} ms, SDPA fp32 "
        f"{tot['library_ms']:.3f} ms, plain {tot['plain_ms']:.1f} ms, bound "
        f"{tot['bound_ms']:.4f} ms ({tot['bound_by']})")
    tot["library_kernels"] = profiled_kernels(sdpa_calls)
    log("[time flash fp32] SDPA fp32 runs (profiler, one call a shape): "
        + ("; ".join(f"{name} {ms:.4f} ms"
                     for name, ms in tot["library_kernels"])
           or "not measured (the profiler recorded no CUDA kernel)"))
    return tot


def profiled_kernels(fns) -> list:
    """The CUDA kernels one call of each of ``fns`` runs, by
    ``torch.profiler`` after a warm-up: [name, device ms summed], longest
    first; empty where the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            fn()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
    return [[name, ms] for name, ms in by_name.most_common()]


def flash_fp32_main(argv) -> int:
    """``python3 chip_smoke.py --flash-fp32 [--tree DIR]``: ``[time flash
    fp32]`` alone, at the fp32 gates' shapes (:func:`fp32_gate_calls`)
    without running the gates: the card's line, the flash kernel built
    (its fp32 templates' ptxas lines), then the phase, and its result as
    one JSON line.  ``--tree DIR``: DIR's own package and ``chip_smoke.py``
    (another commit, unpacked by ``git archive``) time DIR's kernel at the
    same shapes, so that two kernels compare by one method, in turns, on
    one card."""
    import argparse
    import importlib.util
    import torch
    ap = argparse.ArgumentParser(prog="chip_smoke.py --flash-fp32")
    ap.add_argument("--tree", default=ROOT)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    spec = importlib.util.spec_from_file_location(
        "tree_chip_smoke", os.path.join(tree, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_card()
    log(f"[env] tree {tree}, torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build("flash_attention")
    log(f"[build] flash_attention in {time.perf_counter() - t0:.1f} s")
    for r in _build.ptxas_report("flash_attention"):
        if not r["kernel"].startswith("flash_mma_kernel"):
            log(f"[build] ptxas {r['kernel']}: {r['registers']} registers, "
                f"spill stores {r['spill_stores']} B, loads "
                f"{r['spill_loads']} B")
    calls = fp32_gate_calls()
    tot, secs = timed(lambda: mod.phase_time_flash_fp32(dev, calls))
    log(f"[time flash fp32] phase {secs:.1f} s")
    print(json.dumps({"tree": tree, "flash_fp32_gates": tot}), flush=True)
    return 0


# ------------------------------------------------ baselines and netopt

def timed(fn):
    """(fn's result, host seconds ending in a synchronize)."""
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_baselines(dev, arco_rep, arco_s) -> dict:
    """The paper's comparison: each baseline tunes the 8 ResNet-18 tasks
    at ARCO's budget and seed on the card.  Gated on structure only (one
    seed decides which algorithm wins): every task ends with the budget's
    measurements, a finite best and the default hardware geometry (the
    baselines explore software knobs only)."""
    from repro_torch.compiler.session import Session
    from repro_torch.compiler.task import TuningTask
    from repro_torch.core.baselines import default_hardware_values
    from repro_torch.core.tuner import TunerConfig
    tasks = TuningTask.conv_tasks("resnet-18", batch=BATCH)
    out = {"arco": {"tune_s": arco_s,
                    "network_latency_s": arco_rep.network_latency()}}
    for algo in BASELINES:
        rep, dt = timed(lambda: Session(
            tasks, tuner=TunerConfig.fast(), algo=algo, budget=TUNE_BUDGET,
            seed=SEED, device=dev).run())
        for t in tasks:
            r = rep[t.name]
            check(r.n_measurements == TUNE_BUDGET
                  and math.isfinite(r.best_latency),
                  f"{algo} {t.name}: {r.n_measurements} measurements, best "
                  f"{r.best_latency}")
            hw = [int(t.space.choices[k][i])
                  for k, i in enumerate(r.best_config[:3])]
            check(hw == [int(v) for v in default_hardware_values(t.space)],
                  f"{algo} {t.name} moved the hardware knobs: {hw}")
        out[algo] = {"tune_s": dt,
                     "network_latency_s": rep.network_latency()}
        log(f"[baselines] {algo}: 8 tasks x {TUNE_BUDGET} measurements in "
            f"{dt:.2f} s, network latency {rep.network_latency():.4g} s "
            f"(analytical TPU v5e model, not the H100); every task kept the "
            f"default hardware geometry")
    log("[baselines] tuning s (host clock, ended by a synchronize): "
        + ", ".join(f"{a} {v['tune_s']:.2f}" for a, v in out.items())
        + "; network latency s (analytical TPU v5e model): "
        + ", ".join(f"{a} {v['network_latency_s']:.4g}"
                    for a, v in out.items()))
    return out


def phase_netopt(dev):
    """Network co-optimization of the 8 tasks on the card: the
    co-optimizer at K=1 (``NetOptConfig()``), the hw-frozen baseline at
    the co-optimizer's upper budget, and the co-optimizer at K=2.  Gated on
    structure: every layer's mapping runs on its stage's chip, K=2 has two
    chips and one cut, no run pays more than the upper budget.  Co-opt
    against hw-frozen is printed, not gated: CUDA's reductions can move a
    seeded trajectory (the CPU tests hold that bar)."""
    import dataclasses
    from repro_torch.compiler.netopt import (NetOptConfig, NetworkCoOptimizer,
                                             network_hw_frozen_tune)
    from repro_torch.compiler.task import TuningTask
    tasks = TuningTask.conv_tasks("resnet-18", batch=BATCH)
    cfg = NetOptConfig()
    cap = cfg.total_layer_budget() * len(tasks)
    runs = {}
    runs["k1"] = timed(lambda: NetworkCoOptimizer(
        tasks, cfg, name=NETWORK, device=dev).run())
    runs["hw_frozen"] = timed(lambda: network_hw_frozen_tune(
        tasks, cfg, name=NETWORK, device=dev))
    runs["k2"] = timed(lambda: NetworkCoOptimizer(
        tasks, dataclasses.replace(cfg, k_chips=2), name=NETWORK,
        device=dev).run())
    out = {}
    for label, (rep, dt) in runs.items():
        check(rep.verify_shared_hardware(),
              f"netopt {label}: a layer runs off its stage's chip")
        check(rep.total_measurements <= cap,
              f"netopt {label}: {rep.total_measurements} measurements > "
              f"{cap}")
        check(math.isfinite(rep.network_latency) and rep.n_layers == 17,
              f"netopt {label}: latency {rep.network_latency}, "
              f"{rep.n_layers} layers")
        out[label] = {"s": dt, "network_latency_s": rep.network_latency,
                      "measurements": rep.total_measurements,
                      "candidates": rep.hw_candidates,
                      "hw_configs": rep.hw_configs,
                      "cuts": rep.partition.get("cuts", [])}
        log(f"[netopt] {label} ({rep.algo}): {dt:.2f} s, network latency "
            f"{rep.network_latency:.4g} s (analytical TPU v5e model), "
            f"{rep.total_measurements} measurements paid (cap {cap}), "
            f"{rep.hw_candidates} candidates, chips {rep.hw_configs}")
    k2 = runs["k2"][0]
    check(len(k2.hw_configs) == 2 and len(k2.partition["cuts"]) == 1,
          f"netopt K=2: {k2.hw_configs}, cuts {k2.partition['cuts']}")
    log(f"[netopt] K=2 cut before task {k2.partition['cuts'][0]} of "
        f"{len(tasks)}: stage chips {k2.hw_configs}")
    ratio = (runs["k1"][0].network_latency
             / runs["hw_frozen"][0].network_latency)
    out["k1_over_hw_frozen"] = ratio
    log(f"[netopt] co-opt K=1 / hw-frozen network latency {ratio:.4f} "
        f"(model; not gated here)")
    return runs["k1"][0], out


def phase_netopt_deploy(dev, coopt, fwd_ms, plain_fwd_ms, rows) -> dict:
    """The co-optimized network deployed: every layer's mapping under the
    K=1 winner's chip (``mapping`` with ``hw_utilized``, the chip's tiles
    clamped to the layer) mapped through ``knob_config`` to a GemmConfig,
    ResNet-18 run with phase 5's seeded weights and input.  The GEMM's
    launch count is set to 0 just before and must read 17 just after;
    logits within FORWARD_TOL of cuDNN fp32.  Then where the forward's
    time goes: the profiler over it, and each GEMM shape's device time
    under these geometries beside phase 6's (``rows``, the per-layer
    optima's)."""
    import torch
    from repro_torch.kernels import gemm as G
    specs, layer_task, net, x = resnet_setup(dev)
    G.gemm.launches = 0   # the netopt deploy path starts here
    settings = {name: {**layer["mapping"], **layer["hw_utilized"]}
                for name, layer in coopt.layers.items()}
    configs = [knob_config(settings[layer_task[s.name]], s) for s in specs]
    with torch.no_grad():
        logits = net(x, configs)
        torch.cuda.synchronize()
        launches = G.gemm.launches   # and ends here
        check(launches == 17, f"netopt deploy launched the kernel "
                              f"{launches} times, expected 17")
        plain = net(x, use_kernel=False)
        torch.cuda.synchronize()
    check(tuple(logits.shape) == (BATCH, 1000)
          and bool(torch.isfinite(logits).all()), "netopt deploy logits")
    diff, rel = rel_err(logits, plain)
    check(rel <= FORWARD_TOL, f"netopt deploy vs cuDNN: rel err {rel:.3g}")
    requested = {}
    for s, cfg in zip(specs, configs):
        requested.setdefault(layer_task[s.name], cfg)
    for name, cfg in requested.items():
        log(f"[netopt deploy] {name}: {settings[name]} -> requested "
            f"{[cfg.block_m, cfg.block_n, cfg.block_k]}")
    with torch.no_grad():
        ms = cuda_ms(lambda: net(x, configs), reps=5)
    log(f"[netopt deploy] ResNet-18 224x224 batch {BATCH}: 17 kernel "
        f"launches, logits max_abs_err {diff:.3g} (rel {rel:.3g}) vs cuDNN "
        f"fp32; forward {ms:.3f} ms with the co-optimized chip's mappings, "
        f"{fwd_ms:.3f} ms with the per-layer optima (phase 5), "
        f"{plain_fwd_ms:.3f} ms through cuDNN (phase 5)")
    with torch.no_grad():
        profile = profile_runs({"netopt forward": (3, lambda: net(x,
                                                                   configs))})
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    gemm_ms = {"netopt": 0.0, "per_layer": 0.0}
    for (name, m, n, k, layers), row in zip(gemm_shapes(), rows):
        cfg = requested[name]
        geom = G.legalize(cfg, m, n, k)
        a = torch.randn(m, k, generator=gen, device=dev)
        b = torch.randn(k, n, generator=gen, device=dev)
        dev_ms = device_ms(lambda: G.gemm(a, b, cfg))
        gemm_ms["netopt"] += dev_ms * layers
        gemm_ms["per_layer"] += row["device_ms"] * layers
        log(f"[netopt deploy] {name} M={m} N={n} K={k} x{layers}: run="
            f"{[geom.bm, geom.bn, geom.bk]} split_k={geom.split_k} device "
            f"time {dev_ms:.4f} ms; the per-layer optimum's run={row['run']} "
            f"split_k={row['split_k']} {row['device_ms']:.4f} ms (phase 6)")
    log(f"[netopt deploy] the 17 GEMMs' device time (device_ms): "
        f"{gemm_ms['netopt']:.3f} ms under the co-optimized chip, "
        f"{gemm_ms['per_layer']:.3f} ms under the per-layer optima")
    return {"launches": launches, "logits_max_abs_err": diff,
            "logits_rel_err": rel, "forward_ms": ms,
            "gemm_device_ms": gemm_ms, "profile": profile}


# -------------------------------------------------------- LM serving path

def device_ms(fn, reps: int = 20) -> float:
    """Mean device time of one call of ``fn`` without the host's launch
    overhead: ``reps`` calls captured in one CUDA graph, replayed, timed
    by CUDA events.  For kernels shorter than their Python launch."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def lm_config(dtype):
    from repro_torch.configs import get_config
    return get_config(LM_ARCH).with_(dtype=dtype, param_dtype=dtype)


def phase_check_lm_kernels(dev) -> dict:
    """RMSNorm and flash kernels vs their plain versions on the card: the
    reference's test cases and the serving path's shapes, fp32 and bf16.
    Returns each kernel's largest absolute error at the path's shapes in
    bf16, the dtype the path serves in, and under ``flash_vs_fp32_p`` the
    bf16 flash kernel's largest distance there from fp32-P attention."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    worst = {"rmsnorm": 0.0, "flash_attention": 0.0}
    n_checks = 0
    ran, strided = set(), set()   # layouts and grid-stride runs checked
    for shape, on_path, aligned in RMSNORM_CHECKS:
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            n = math.prod(shape)
            x = torch.randn(n + 1, generator=gen, device=dev).to(dtype)
            x = (x[:n] if aligned else x[1:]).view(shape)
            w = torch.randn(shape[-1], generator=gen, device=dev).to(dtype)
            got = RN.rmsnorm(x, w)
            run = RN.rmsnorm.last_geometry["run"]
            want = RN.rmsnorm(x, w, use_kernel=False)
            torch.cuda.synchronize()
            diff, rel = rel_err(got, want)
            check(got.dtype == dtype and rel <= tol,
                  f"rmsnorm {shape} {dtype} {run}: rel err {rel:.3g}")
            check(run["vec"] == (aligned and shape[-1]
                                 % RN.vector_width(dtype) == 0),
                  f"rmsnorm {shape} {dtype} aligned={aligned}: run {run}")
            log(f"[check] rmsnorm {shape} {dtype}"
                f"{'' if aligned else ' x at an offset of one value'} "
                f"run={run} max_abs_err={diff:.3g} rel={rel:.3g}")
            if on_path and dtype == torch.bfloat16:
                worst["rmsnorm"] = max(worst["rmsnorm"], diff)
            ran.add((shape[-1], dtype, run["vec"], run["threads"] // 32,
                     run["slots"], run["rows_per_block"]))
            if run["grid"] * run["rows_per_block"] < n // shape[-1]:
                strided.add((run["threads"] > 32, dtype))
            n_checks += 1
    missing = set(lm_rmsnorm_layouts()) - ran
    check(not missing, f"no rmsnorm check runs the LM path's {missing}")
    check(len(strided) == 4, f"the rmsnorm grid-stride loop is checked "
          f"only in {sorted(map(str, strided))}")
    flash_ran = set()             # templates checked
    f32_split = set()             # fp32 runs with and without a KV split
    for (b, s, hq, hkv, d, causal, window, bq, bk), on_path, aligned in \
            FLASH_CHECKS:
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            def draw(h):
                n = b * s * h * d
                x = torch.randn(n + 1, generator=gen, device=dev).to(dtype)
                return (x[:n] if aligned else x[1:]).view(b, s, h, d)
            q, k, v = draw(hq), draw(hkv), draw(hkv)
            vec = FA.vec_copies(q, k, v)
            check(vec == (aligned and d % (16 // q.element_size()) == 0),
                  f"flash D={d} {dtype} aligned={aligned}: vec {vec}")
            got = FA.flash_attention(q, k, v, causal, window, None, bq, bk)
            run = FA.flash_attention.last_geometry["run"]
            want = FA.flash_attention(q, k, v, causal, window, None, bq, bk,
                                      use_kernel=False)
            torch.cuda.synchronize()
            diff, rel = rel_err(got, want)
            case = (b, s, hq, hkv, d, causal, window)
            check(got.dtype == dtype and rel <= tol,
                  f"flash {case} {dtype} aligned={aligned}: rel err "
                  f"{rel:.3g}")
            flash_ran.add((run["bq"], run["bk"], run["dp"], run["dtype"]))
            if dtype == torch.float32:
                f32_split.add(run["kv_chunk"] > 0)
            if on_path or not vec:
                log(f"[check] flash B={b} S={s} HQ={hq} HKV={hkv} D={d} "
                    f"{dtype}{'' if aligned else ' q/k/v at an offset of one value'}"
                    f" run={run} vec={int(vec)} dynamic smem "
                    f"{FA.RunGeometry(**run).smem_bytes} B "
                    f"max_abs_err={diff:.3g} rel={rel:.3g}")
            if on_path and dtype == torch.bfloat16:
                worst["flash_attention"] = max(worst["flash_attention"], diff)
                exact = FA.flash_attention_plain(
                    q.float(), k.float(), v.float(), causal, window,
                    d ** -0.5, FA.RunGeometry(**run))
                diff32, rel32 = rel_err(got, exact)
                bound = FLASH_FP32_P_BOUND * float(v.float().abs().max())
                check(diff32 <= bound, f"flash {case} bf16 vs fp32 P: "
                      f"{diff32:.3g} > {bound:.3g}")
                worst["flash_vs_fp32_p"] = max(
                    worst.get("flash_vs_fp32_p", 0.0), diff32)
                log(f"[check] flash B={b} S={s} bf16 vs plain with fp32 P: "
                    f"max_abs_err={diff32:.3g} rel={rel32:.3g} (bound "
                    f"{bound:.3g} = 2^-7 x max|v|)")
            n_checks += 1
    check(f32_split == {True, False}, f"fp32 flash checked only with "
          f"the KV split {f32_split}")
    for geom, runs in lm_flash_geometries().items():
        check(geom in flash_ran, f"no flash check runs the LM path's "
              f"template {geom} (head_dim, S from {runs[0]} to {runs[-1]})")
        log(f"[check] the LM path's flash template <bq {geom[0]}, bk "
            f"{geom[1]}, dp {geom[2]}> {geom[3]} (head_dim, S from "
            f"{runs[0]} to {runs[-1]}) is held by a check")
    log(f"[check] {n_checks} RMSNorm/flash kernel-vs-plain checks passed "
        f"(fp32 tol {FP32_TOL} x max|plain|, bf16 {BF16_TOL})")
    return worst


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def _gate_batch(cfg, toks, frontend, dev) -> tuple:
    """A gate prompt's prefill batch (its tokens but the last
    LM_GATE_STEPS, behind ``frontend``'s patches or frames), the tokens
    that continue it, and a cache length that holds prefix, prompt and
    continuation."""
    import torch
    t = torch.as_tensor(toks[None], device=dev)
    n = t.shape[1] - LM_GATE_STEPS
    batch = dict(frontend or {}, tokens=t[:, :n])
    return batch, t, n, cfg.vision_prefix + n + LM_GATE_STEPS + 1


def gate_frontends(cfg, rng, count, dev) -> list:
    """``count`` stub-frontend inputs for the gates, drawn with numpy from
    ``rng`` (standard normal, as the reference's tests draw them), cast to
    ``cfg.dtype`` on ``dev``: a vision prefix's patches (1, P, D), an
    encoder's frames (1, F, D); empty dicts for a model with neither."""
    import torch
    out = []
    for _ in range(count):
        f = {}
        for key, n in (("patches", cfg.vision_prefix),
                       ("frames", cfg.enc_seq if cfg.enc_dec else 0)):
            if n:
                f[key] = torch.as_tensor(rng.standard_normal(
                    (1, n, cfg.d_model)).astype("float32"),
                    device=dev).to(cfg.dtype)
        out.append(f)
    return out


def _path_vs_plain(params, cfg, prompts, dev, frontends=None) -> dict:
    """Largest logit difference / max |logit| between the kernel path and
    the plain path: prefill, then LM_GATE_STEPS teacher-forced decode
    steps, for each prompt (each continued by its own drawn tokens, behind
    its ``frontends`` entry's patches or frames).

    With MoE layers the plain path runs twice: routed by its own router
    (``rel``), and routed by the kernel path's expert sets, call for call
    (``rel_same_routes``: ``moe.route_replay``), which leaves the kernels'
    arithmetic as the only difference.  ``flipped`` counts the tokens
    whose expert sets differ between the kernel path and the plain path's
    own routing, of ``routed`` (router calls summed; 0 without MoE).
    Without MoE ``rel_same_routes`` is ``rel``."""
    import torch
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    moe = any(ffn == "moe" for _, ffn in cfg.layer_kinds())
    paths = (True, False, False)[:3 if moe else 2]   # use_kernel a path
    worst = [0.0] * len(paths)
    routes = ([], [])                  # the first two paths' router calls
    start = 0                          # path 0's last call's first route

    def run(j, fn):
        """Path j's call: paths 0 and 1 log their routes, path 2 replays
        the ones path 0's same call just logged."""
        nonlocal start
        if j == 0:
            start = len(routes[0])
        MOE.route_log = routes[j] if j < 2 else None
        MOE.route_replay = list(routes[0][start:]) if j == 2 else None
        try:
            return fn()
        finally:
            check(not MOE.route_replay, "routes left unreplayed")
            MOE.route_log = MOE.route_replay = None
    for toks, front in zip(prompts, frontends or [None] * len(prompts)):
        batch, t, n, max_len = _gate_batch(cfg, toks, front, dev)
        caches, logits = [None] * len(paths), [None] * len(paths)
        for j, use_kernel in enumerate(paths):
            logits[j], caches[j] = run(j, lambda: T.prefill(
                params, batch, cfg, max_len, use_kernel=use_kernel))
        for i in range(n, n + LM_GATE_STEPS + 1):
            check(bool(torch.isfinite(logits[0]).all()), "non-finite logits")
            for j in range(1, len(paths)):
                worst[j] = max(worst[j], rel_err(logits[0], logits[j])[1])
            if i == n + LM_GATE_STEPS:
                break
            for j, use_kernel in enumerate(paths):
                logits[j], caches[j] = run(j, lambda: T.decode_step(
                    params, caches[j], t[:, i:i + 1], cfg,
                    use_kernel=use_kernel))
    check(len(routes[0]) == len(routes[1]), "the paths' router calls differ")
    flipped = sum(int((a != b).any(-1).sum()) for a, b in zip(*routes))
    routed = sum(a.shape[0] for a in routes[0])
    return {"rel": worst[1], "rel_same_routes": worst[-1],
            "flipped": flipped, "routed": routed}


def phase_lm_gate(dev):
    """qwen2-1.5b at full width with seeded random weights: the kernel
    path against the plain path on the card, in fp32 (gated at
    LM_TOL_FP32) and then, with the same weights cast, in bf16 (gated at
    LM_TOL_BF16).  Returns the bf16 weights for the serving phase."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    cfg32 = lm_config(torch.float32)
    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(0, cfg32.vocab,
                            size=int(n) + LM_GATE_STEPS).astype(np.int64)
               for n in rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1,
                                     size=LM_GATE_REQUESTS)]
    t0 = time.perf_counter()
    params = T.init_params(SEED, cfg32, device=dev)
    torch.cuda.synchronize()
    log(f"[lm] {LM_ARCH} full width: {cfg32.n_layers} layers, d_model "
        f"{cfg32.d_model}, {cfg32.n_heads}/{cfg32.n_kv_heads} heads, d_ff "
        f"{cfg32.d_ff}, vocab {cfg32.vocab}, {T.param_count(params)/1e9:.3f}"
        f" B params, seeded fp32 init {time.perf_counter() - t0:.1f} s")
    with torch.no_grad():
        rel32 = _path_vs_plain(params, cfg32, prompts, dev)["rel"]
    check(rel32 <= LM_TOL_FP32, f"fp32 kernel path vs plain path: logits "
                                f"rel err {rel32:.3g} > {LM_TOL_FP32}")
    log(f"[lm] fp32 kernel path vs plain path, prompts "
        f"{[len(p) - LM_GATE_STEPS for p in prompts]}, prefill + "
        f"{LM_GATE_STEPS} decode steps: max |logit diff| / max |logit| = "
        f"{rel32:.3g} (gate {LM_TOL_FP32})")
    params = _cast(params, torch.bfloat16)
    torch.cuda.empty_cache()
    cfg16 = lm_config(torch.bfloat16)
    with torch.no_grad():
        rel16 = _path_vs_plain(params, cfg16, prompts, dev)["rel"]
    check(rel16 <= LM_TOL_BF16, f"bf16 kernel path vs plain path: logits "
                                f"rel err {rel16:.3g} > {LM_TOL_BF16}")
    log(f"[lm] bf16 kernel path vs plain path: {rel16:.3g} (gate "
        f"{LM_TOL_BF16})")
    return params, cfg16, rel32, rel16


def norms_per_pass(cfg, prefill: bool = True) -> int:
    """RMSNorm launches of one forward: one a mixer, one a cross part
    (an encoder-decoder's) and one an FFN that a layer has, and the final
    norm; a prefill (or a training forward) of an encoder-decoder also
    runs its encoder, 2 an encoder layer and ``enc_ln``."""
    n = 1 + sum((mixer != "none") + cfg.enc_dec + (ffn != "none")
                for mixer, ffn in cfg.layer_kinds())
    return n + (2 * cfg.n_enc_layers + 1 if prefill and cfg.enc_dec else 0)


def encoder_norms(cfg) -> int:
    """The RMSNorm launches of a prefill that run over the encoder's
    frames (0 without an encoder)."""
    return norms_per_pass(cfg) - norms_per_pass(cfg, prefill=False)


def attention_layers(cfg) -> int:
    """Flash launches of one prefill: one an attention layer, the
    encoder's (non-causal) included."""
    return (sum(mixer in ("attn", "swa") for mixer, _ in cfg.layer_kinds())
            + (cfg.n_enc_layers if cfg.enc_dec else 0))


def phase_serve(dev, params, cfg, tag="[serve]", arch=LM_ARCH,
                n_requests=LM_REQUESTS, prompt=LM_PROMPT, new=LM_NEW,
                seed=SEED + 5, max_len=LM_MAX_LEN, fixed=()):
    """The serving path: ``Server(n_slots=8, max_len)`` in bf16 serves
    ``n_requests`` requests (prompts drawn in ``prompt``, the first ones
    of length ``fixed`` where given, ``new`` new tokens each;
    qwen2-1.5b's: 16, 128-1024, 32, max_len 2048).  The
    RMSNorm and flash launch counts are set to 0 just before and read just
    after, and checked step by step: each prefill launches flash
    :func:`attention_layers` times and RMSNorm :func:`norms_per_pass`
    times, each decode step RMSNorm ``norms_per_pass(prefill=False)``
    times and flash never."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.train.server import DONE, Request, Server
    srv = Server(params, cfg, n_slots=LM_SLOTS, max_len=max_len)
    srv.submit(Request(uid=-1, prompt=np.arange(16, dtype=np.int32),
                       max_new_tokens=2))
    srv.run_until_drained()                     # warm-up, not counted
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt[0], prompt[1] + 1, size=n_requests)
    lens[:len(fixed)] = fixed
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=int(n))
                    .astype(np.int32), max_new_tokens=new)
            for i, n in enumerate(lens)]
    norms, flashes = norms_per_pass(cfg), attention_layers(cfg)
    step_norms = norms_per_pass(cfg, prefill=False)
    FA.flash_attention.launches = 0   # the serving path starts here
    RN.rmsnorm.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        srv.submit(r)
    prefills = decodes = 0
    full_step_ms = []
    while srv.active or srv.queue:
        f0, r0 = FA.flash_attention.launches, RN.rmsnorm.launches
        queued, was_active = len(srv.queue), len(srv.active)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        finished = srv.step()
        end.record()
        admitted = queued - len(srv.queue)
        decoded = int(len(srv.active) + len(finished) > 0)
        check(FA.flash_attention.launches - f0 == flashes * admitted,
              f"flash launched {FA.flash_attention.launches - f0} times for "
              f"{admitted} prefills")
        check(RN.rmsnorm.launches - r0
              == norms * admitted + step_norms * decoded,
              f"rmsnorm launched {RN.rmsnorm.launches - r0} times for "
              f"{admitted} prefills and {decoded} decode steps")
        prefills += admitted
        decodes += decoded
        if admitted == 0 and was_active == LM_SLOTS:
            end.synchronize()
            full_step_ms.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": FA.flash_attention.launches,
                "rmsnorm": RN.rmsnorm.launches}   # the serving path ends here
    check(all(r.status == DONE and len(r.output) == new for r in reqs)
          and not srv.rejected and not srv.abandoned,
          f"served {sum(r.status == DONE for r in reqs)}/{n_requests}, "
          f"rejected {len(srv.rejected)}, abandoned {len(srv.abandoned)}")
    check(all(0 <= t < cfg.vocab for r in reqs for t in r.output),
          "generated token out of the vocabulary")
    check(launches["flash_attention"] == flashes * prefills
          and launches["rmsnorm"] == norms * prefills + step_norms * decodes,
          f"serving launch counts {launches}")
    for name in ("rmsnorm", "flash_attention")[:1 + bool(flashes)]:
        check(launches[name] > 0, f"{tag} launched no {name}")
    tokens = sum(len(r.output) for r in reqs)
    log(f"{tag} {arch} bf16, {LM_SLOTS} slots, max_len {max_len}: "
        f"{n_requests}/{n_requests} done, 0 rejected, 0 abandoned; "
        f"{prefills} prefills, {decodes} decode steps; launches {launches}: "
        f"flash {flashes} and rmsnorm {norms} a prefill, rmsnorm "
        f"{step_norms} and flash 0 a decode step")
    bins = {}
    for r in reqs:
        lo = next((b for b in PREFILL_BINS[::-1] if len(r.prompt) >= b), 1)
        bins.setdefault(lo, []).append(r.prefill_s * 1e3)
    prefill_ms = {f">={lo}": (float(np.mean(v)), len(v))
                  for lo, v in sorted(bins.items())}
    check(bool(full_step_ms), f"{tag} no decode step ran {LM_SLOTS} slots")
    step_ms = float(np.mean(full_step_ms))
    log(f"{tag} {tokens} tokens in {wall:.3f} s: {tokens / wall:.1f} "
        f"generated tokens/s; mean prefill ms by prompt length "
        f"{ {k: round(v[0], 3) for k, v in prefill_ms.items()} } (requests "
        f"{ {k: v[1] for k, v in prefill_ms.items()} }); decode step with "
        f"{LM_SLOTS} active slots {step_ms:.3f} ms (mean of "
        f"{len(full_step_ms)}, CUDA events)")
    return {"launches": launches, "prefills": prefills, "decodes": decodes,
            "prompt_lens": [int(n) for n in lens],
            "prefill_s": [r.prefill_s for r in reqs], "wall_s": wall,
            "tokens": tokens, "tokens_per_s": tokens / wall,
            "prefill_ms_by_len": prefill_ms, "decode_step_ms": step_ms,
            "decode_steps_timed": len(full_step_ms)}


def phase_fabric() -> dict:
    """The measurement fabric on the card's host: FABRIC_N stub
    measurements of FABRIC_DELAY_S each through the in-process
    ``SerialExecutor``, a ``SubprocessExecutor`` of 2 spawned workers
    (spawned and warmed by one job each outside the timed region, as a
    session reuses its pool) and a ``RemoteExecutor`` over one daemon from
    ``spawn_daemon`` on 127.0.0.1:0 (2 slots).  Gates: equal values, the
    pool at least FABRIC_SPEEDUP x faster than serial, a hung job killed
    at FABRIC_TIMEOUT_S with the pool respawned and the other jobs served,
    and the same ``stats()`` keys on all three."""
    from repro_torch.compiler.executor import (RemoteExecutor,
                                               SerialExecutor,
                                               SubprocessExecutor,
                                               WorkerSpec, spawn_daemon)
    from repro_torch.compiler.executor.stub import stub_latency
    spec = WorkerSpec(factory=STUB, kwargs={"delay_s": FABRIC_DELAY_S})
    settings = [{"model_axis": 1 << (i % 7), "grad_accum": 1 << (i // 7),
                 "fsdp": bool(i % 2)} for i in range(FABRIC_N)]
    want = [stub_latency(st) for st in settings]

    def run(ex, label):
        t0 = time.perf_counter()
        handles = [ex.submit("fabric", st, spec=spec) for st in settings]
        ex.drain(handles)
        wall = time.perf_counter() - t0
        got = [h.result().value if h.result().ok else h.result().error
               for h in handles]
        check(got == want, f"[fabric] {label} values differ: {got}")
        return wall, ex.stats()

    walls, stats = {}, {}
    serial = SerialExecutor(spec=spec)
    walls["serial"], stats["serial"] = run(serial, "serial")
    t0 = time.perf_counter()
    pool = SubprocessExecutor(spec, workers=2, timeout_s=30.0)
    warm = [pool.submit("warm-up", {"warm": i}) for i in range(2)]
    pool.drain(warm)   # both workers spawned, imported, factory resolved
    spawn_s = time.perf_counter() - t0
    try:
        walls["subprocess"], stats["subprocess"] = run(pool, "subprocess[2]")
    finally:
        pool.close()
    t0 = time.perf_counter()
    proc, endpoint = spawn_daemon(slots=2, host="127.0.0.1", port=0,
                                  timeout_s=60.0)
    daemon_s = time.perf_counter() - t0
    try:
        remote = RemoteExecutor(endpoint, timeout_s=30.0)
        try:
            walls["remote"], stats["remote"] = run(remote, "remote")
        finally:
            remote.close()
    finally:
        proc.terminate()
        proc.wait(timeout=10)
    keys = [sorted(st) for st in stats.values()]
    base = {"kind", "workers_alive", "respawns", "queued", "running",
            "max_inflight", "jobs", "failures"}
    check(all(base <= set(k) for k in keys),
          f"[fabric] stats() keys differ: {keys}")
    speedup = walls["serial"] / walls["subprocess"]
    check(speedup >= FABRIC_SPEEDUP, f"[fabric] the pool is {speedup:.2f}x "
          f"serial (< {FABRIC_SPEEDUP}x)")
    hang = WorkerSpec(factory=STUB, kwargs={
        "delay_s": FABRIC_DELAY_S, "hang_when": settings[1]})
    pool = SubprocessExecutor(hang, workers=2, timeout_s=FABRIC_TIMEOUT_S)
    t0 = time.perf_counter()
    try:
        handles = [pool.submit("fabric", st) for st in settings[:5]]
        pool.drain(handles)
        hang_s = time.perf_counter() - t0
        res = [h.result() for h in handles]
        check(not res[1].ok and "TimeoutError" in res[1].error
              and all(r.ok and r.value == w for r, w in
                      zip(res[:1] + res[2:], want[:1] + want[2:5]))
              and pool.respawns == 1,
              f"[fabric] timeout path: {[(r.ok, r.error) for r in res]}, "
              f"respawns {pool.respawns}")
    finally:
        pool.close()
    log(f"[fabric] {FABRIC_N} stub measurements of {FABRIC_DELAY_S} s: "
        f"serial {walls['serial']:.3f} s, subprocess[2] "
        f"{walls['subprocess']:.3f} s ({speedup:.2f}x serial; the pool "
        f"spawned and warmed in {spawn_s:.3f} s outside it), remote over "
        f"1 daemon "
        f"(2 slots, {endpoint}) {walls['remote']:.3f} s "
        f"({walls['serial'] / walls['remote']:.2f}x; daemon up in "
        f"{daemon_s:.3f} s); values equal; stats() keys equal")
    log(f"[fabric] timeout: the hung job of 5 killed at {FABRIC_TIMEOUT_S} s "
        f"after its started-ack, {pool.respawns} respawn, the other 4 "
        f"served, {hang_s:.3f} s")
    return {"walls_s": walls, "speedup": speedup, "spawn_s": spawn_s,
            "daemon_s": daemon_s, "timeout_drain_s": hang_s,
            "stats": stats}


def counting_steps(srv) -> dict:
    """Wrap ``srv.step`` to count prefills (requests admitted) and decode
    steps (steps that ran the batch); returns the live counter dict."""
    counts = {"prefills": 0, "decodes": 0}
    step = srv.step

    def counted():
        queued = len(srv.queue)
        finished = step()
        counts["prefills"] += queued - len(srv.queue)
        counts["decodes"] += int(len(srv.active) + len(finished) > 0)
        return finished

    srv.step = counted
    return counts


def _scrape(url: str) -> tuple:
    import urllib.request
    with urllib.request.urlopen(url + "/status", timeout=10) as r:
        status = json.loads(r.read())
    with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
        metrics = r.read().decode()
    return status, metrics


def _metric(text: str, name: str) -> float:
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[-1])
    raise SmokeFailure(f"[serve live] {name} not in the /metrics scrape")


def phase_serve_live(dev, params, cfg) -> dict:
    """qwen2-1.5b in bf16 served to timed Poisson arrivals while an ARCO
    session tunes its decode/prefill geometry in the idle slots
    (``LiveServeHost`` + ``tune_while_serving``), watched by a
    ``MonitorServer`` on an ephemeral loopback port.  The RMSNorm and flash
    counts are set to 0 just before the run and read just after."""
    import threading
    import numpy as np
    import torch
    from repro_torch.compiler.serve_tune import (LiveServeHost, ServeModel,
                                                 ServeSLA, TraceConfig,
                                                 tune_while_serving)
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.obs.serve import MonitorServer
    from repro_torch.train.server import DONE, Request, Server
    srv = Server(params, cfg, n_slots=LM_SLOTS, max_len=LM_MAX_LEN)
    srv.submit(Request(uid=-1, prompt=np.arange(16, dtype=np.int32),
                       max_new_tokens=2))
    srv.run_until_drained()                     # warm-up, not counted
    counts = counting_steps(srv)
    records = os.path.join(ROOT, "build", "serve_live_records.jsonl")
    os.makedirs(os.path.dirname(records), exist_ok=True)
    if os.path.exists(records):
        os.remove(records)                      # a cold session, not a replay
    mon = MonitorServer(port=0, host="127.0.0.1").start()
    scrapes, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            try:
                scrapes.append(_scrape(mon.url))
            except OSError:
                pass          # the run's own check below decides
            stop.wait(0.5)

    host = LiveServeHost(
        srv, TraceConfig(n_requests=LIVE_REQUESTS, rate_per_s=LIVE_RATE,
                         prompt_len=LIVE_PROMPT, max_new=LIVE_NEW,
                         seed=SEED),
        sla=ServeSLA(target_s=LIVE_SLA_S), model=ServeModel(arch=LM_ARCH),
        vocab=cfg.vocab, seed=SEED)
    poller = threading.Thread(target=poll, daemon=True)
    FA.flash_attention.launches = 0   # the live serving path starts here
    RN.rmsnorm.launches = 0
    poller.start()
    try:
        t0 = time.perf_counter()
        rep = tune_while_serving(host, budget=LIVE_BUDGET, records=records,
                                 monitor=mon, seed=SEED,
                                 offline_compare=True, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention": FA.flash_attention.launches,
                    "rmsnorm": RN.rmsnorm.launches}   # ... and ends here
        stop.set()
        poller.join(timeout=15)
        final_status, final_metrics = _scrape(mon.url)
    finally:
        stop.set()
        mon.stop()
    s = rep.serve
    done = host.done
    check(s["served"] == LIVE_REQUESTS and s["rejected"] == 0
          and s["abandoned"] == 0
          and all(r.status == DONE for r in done),
          f"[serve live] served {s['served']}/{LIVE_REQUESTS}, rejected "
          f"{s['rejected']}, abandoned {s['abandoned']}")
    check(all(0 <= t < cfg.vocab for r in done for t in r.output),
          "[serve live] generated token out of the vocabulary")
    check(s["idle_windows"] == s["measurements"],
          f"[serve live] measurements outside idle windows: "
          f"{s['measurements'] - s['idle_windows']} of {s['measurements']}")
    per_task = {n: r.n_measurements for n, r in rep.session.reports.items()}
    n_rows = sum(1 for _ in open(records))
    check(all(v == LIVE_BUDGET for v in per_task.values())
          and s["measurements"] == 2 * LIVE_BUDGET == n_rows,
          f"[serve live] budget not spent: {per_task}, {s['measurements']} "
          f"measured, {n_rows} records")
    norms = 2 * cfg.n_layers + 1
    check(counts["prefills"] == LIVE_REQUESTS
          and launches["flash_attention"] == cfg.n_layers * counts["prefills"]
          and launches["rmsnorm"] == norms * (counts["prefills"]
                                              + counts["decodes"]),
          f"[serve live] launches {launches} for {counts}")
    mid = [st["sources"]["serve"] for st, _ in scrapes
           if "serve" in st.get("sources", {})
           and not st["sources"]["serve"].get("final")]
    check(bool(mid), f"[serve live] no /status scrape during the run "
                     f"({len(scrapes)} scrapes)")
    fin = final_status["sources"]
    net = rep.session.network_latency()
    check(fin["serve"].get("final") is True
          and fin["serve"]["served"] == s["served"]
          and fin["serve"]["measurements"]["done"] == s["measurements"]
          and fin["serve"]["violations"] == s["violations"]
          and fin["session"]["measurements"] == s["measurements"]
          and _metric(final_metrics, "repro_session_measurements")
          == s["measurements"]
          and _metric(final_metrics, "repro_session_network_latency") == net
          and _metric(final_metrics, "repro_executor_idle_slot_jobs")
          == s["measurements"],
          f"[serve live] the final scrape differs from the report: "
          f"{fin} vs serve {s}")
    lats = np.asarray([r.latency_s for r in done])
    tokens = int(sum(len(r.output) for r in done))
    out = {
        "requests": s["served"], "wall_s": wall, "sim_time_s": s["sim_time_s"],
        "p50_latency_s": s["p50_latency_s"],
        "p99_latency_s": s["p99_latency_s"],
        "mean_latency_s": s["mean_latency_s"],
        "violation_pct": s["violation_pct"], "sla_s": LIVE_SLA_S,
        "tokens": tokens, "tokens_per_s": s["tokens_per_sec"],
        "mean_queue_s": s["mean_queue_s"],
        "mean_prefill_s": s["mean_prefill_s"],
        "mean_decode_s": float(np.mean([r.decode_s for r in done])),
        "measurements": s["measurements"], "preempted": s["preempted"],
        "idle_windows": s["idle_windows"], "online": rep.online,
        "offline": rep.offline, "convergence": rep.convergence,
        "prefills": counts["prefills"], "decodes": counts["decodes"],
        "launches": launches, "scrapes_during_run": len(mid),
        "session_wall_s": rep.session.wall_time_s,
        "max_latency_s": float(lats.max())}
    log(f"[serve live] {LM_ARCH} bf16, {LM_SLOTS} slots: {s['served']}/"
        f"{LIVE_REQUESTS} served, 0 rejected, 0 abandoned under Poisson "
        f"arrivals at {LIVE_RATE} req/s; p50 {s['p50_latency_s']:.3f} s, "
        f"p99 {s['p99_latency_s']:.3f} s (SLA {LIVE_SLA_S} s, violations "
        f"{s['violation_pct']:.2f}%), {s['tokens_per_sec']:.1f} generated "
        f"tokens/s over {s['sim_time_s']:.1f} s of replay; mean queue "
        f"{out['mean_queue_s']:.4f} s, prefill {out['mean_prefill_s']:.4f} "
        f"s, decode {out['mean_decode_s']:.4f} s")
    log(f"[serve live] {s['measurements']} measurements, all in idle "
        f"windows ({s['idle_windows']}), {s['preempted']} preempted; "
        f"online geometries: "
        + "; ".join(f"{k} {v['settings']} model step {v['step_s']:.6g} s"
                    for k, v in rep.online.items())
        + f"; convergence (offline/online step, not gated) "
        f"{ {k: round(v, 4) for k, v in rep.convergence.items()} }")
    log(f"[serve live] launches {launches} for {counts['prefills']} "
        f"prefills and {counts['decodes']} decode steps; {len(mid)} "
        f"/status scrapes during the run, the final scrape equals the "
        f"report; phase {wall:.1f} s (session {rep.session.wall_time_s:.1f}"
        f" s)")
    return out


def profile_runs(runs: dict) -> dict:
    """``torch.profiler`` over each named (reps, fn) after one warm-up
    call, the reps ending in a synchronize: host wall ms, device busy ms
    (the CUDA kernels' summed durations), the device's idle share, kernels
    launched, the port's own kernels' device ms, and the top kernels, per
    rep.  If the profiler records no device time the run says "not
    measured" and the smoke run goes on."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, (reps, fn) in runs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps
        if not kernels or busy_ms <= 0:
            log(f"[profile] {name}: device time not measured (the profiler "
                f"recorded no CUDA kernel); host wall {wall_ms:.3f} ms")
            continue
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.elapsed_us() / 1e3 / reps)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        port_ms = sum(v for k, v in by_name.items()
                      if any(p in k for p in PORT_KERNEL_NAMES))
        classes = {}
        for k, v in by_name.items():
            cls = kernel_class(k)
            classes[cls] = classes.get(cls, 0.0) + v
        out[name] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                     "device_idle_share": 1.0 - busy_ms / wall_ms,
                     "kernels": len(kernels) / reps, "port_kernels_ms": port_ms,
                     "top": [(k[:60], v) for k, v in top],
                     "by_class_ms": classes}
        log(f"[profile] {name}: host wall {wall_ms:.3f} ms, device busy "
            f"{busy_ms:.3f} ms (idle {100 * (1 - busy_ms / wall_ms):.1f}%), "
            f"{len(kernels) / reps:.0f} kernels, the port's kernels "
            f"{port_ms:.3f} ms; top by device time: "
            + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top))
        log(f"[profile] {name} by kernel class: " + "; ".join(
            f"{k} {v:.3f} ms" for k, v in sorted(classes.items(),
                                                 key=lambda kv: -kv[1])))
    return out


def kernel_class(name: str) -> str:
    """A profiled CUDA kernel's class, by its name: the port's own
    kernels, cuBLAS/CUTLASS GEMMs by operand type (cuBLAS's Hopper GEMMs,
    ``nvjet_*``, do not name it), elementwise, reduction, softmax-like,
    copy, other."""
    low = name.lower()
    if any(p in name for p in PORT_KERNEL_NAMES):
        return "port"
    if low.startswith("nvjet"):
        return "gemm_nvjet"
    if "gemm" in low or "xmma" in low or "cutlass" in low:
        return ("gemm_bf16" if "bf16" in low or "bfloat" in low
                else "gemm_fp32" if "f32" in low or "sgemm" in low
                else "gemm_other")
    for cls, keys in (("reduce", ("reduce",)),
                      ("softmax", ("softmax", "logsumexp")),
                      ("elementwise", ("elementwise",)),
                      ("copy", ("copy", "cat", "index", "gather",
                                "scatter"))):
        if any(k in low for k in keys):
            return cls
    return "other"


def phase_profile_serve(dev, params, cfg) -> dict:
    """Where a serving step's time goes (:func:`profile_runs`): one
    prefill of the longest prompt, and 4 decode steps of 8 slots at
    position 512."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    toks = torch.as_tensor(np.arange(LM_PROMPT[1]) % cfg.vocab,
                           device=dev)[None]
    cache = T.init_cache(cfg, LM_SLOTS, LM_MAX_LEN, device=dev)
    cache["pos"][:] = 512
    last = torch.zeros((LM_SLOTS, 1), dtype=torch.int64, device=dev)
    runs = {"prefill": (1, lambda: T.prefill(params, {"tokens": toks}, cfg,
                                             LM_MAX_LEN)),
            "decode_step": (4, lambda: T.decode_step(params, cache, last,
                                                     cfg))}
    return profile_runs(runs)


def bound(t_ops, t_bytes) -> dict:
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def attention_flops(b, s, hq, d, causal, window) -> float:
    """The operations attention needs: 2 GEMMs (2 operations a
    multiply-add) over the (query, key) pairs the mask keeps: all S^2, the
    S(S+1)/2 causal ones, or within a window of w keys min(row + 1, w) a
    row."""
    if not causal:
        pairs = s * s
    elif window is None or window >= s:
        pairs = s * (s + 1) // 2
    else:
        pairs = window * (window + 1) // 2 + (s - window) * window
    return 4.0 * b * hq * d * pairs


def sdpa_call(q, k, v, causal, window):
    """One ``scaled_dot_product_attention`` call of the same function on
    (B, S, H, D) operands (transposed here, outside the call): ``is_causal``
    without a window; with one, the band (causal and col > row - window) as
    an explicit boolean ``attn_mask``, since ``is_causal`` cannot carry a
    window."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if window is None:
        return functools.partial(F.scaled_dot_product_attention, qt, kt, vt,
                                 is_causal=causal, enable_gqa=True)
    s = q.shape[1]
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(s, device=q.device)[None]
    band = cols > rows - window
    if causal:
        band &= cols <= rows
    return functools.partial(F.scaled_dot_product_attention, qt, kt, vt,
                             attn_mask=band, enable_gqa=True)


def time_rmsnorm(randn, rows, d) -> dict:
    """The RMSNorm kernel at (rows, d) from ``randn``: kernel and
    ``F.rms_norm`` by device_ms, the plain version by CUDA events, and the
    bound (each input read once, the output written once)."""
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as RN
    x, w = randn(rows, d), randn(d)
    return {"shape": [rows, d],
            "ms": device_ms(lambda: RN.rmsnorm(x, w)),
            "plain_ms": cuda_ms(lambda: RN.rmsnorm_plain(x, w), reps=3),
            "library_ms": device_ms(lambda: F.rms_norm(x, (d,), w, 1e-6)),
            **bound(4.0 * rows * d / FP32_FLOPS * 1e3,
                    2.0 * (2 * rows * d + d) / HBM_BYTES_PER_S * 1e3)}


def log_row(name, r, launches=None) -> None:
    extra = (f" run={r['run']} {r['tflops']:.2f} TFLOP/s,"
             if "run" in r else "")
    times = "" if launches is None else f" x{launches} launches"
    mask = {True: " causal", False: " non-causal"}.get(r.get("causal"), "")
    if r.get("window") is not None:
        mask += f" window {r['window']}"
    log(f"[time] {name} {r['shape']}{mask} bf16{times}:{extra} kernel "
        f"{r['ms']:.4f} ms, library {r['library_ms']:.4f} ms, plain "
        f"{r['plain_ms']:.2f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}; the kernel at "
        f"{100 * r['bound_ms'] / r['ms']:.1f}% of it)")


def time_rmsnorm_floor_and_host(randn, d) -> dict:
    """What a small RMSNorm launch cannot go below, and what its wrapper
    costs the host, in bf16: the kernel and ``F.rms_norm`` at
    NORM_FLOOR_SHAPE by device_ms (a launch with almost no work: the floor
    of a kernel replayed in a CUDA graph), and the host microseconds a
    call at (LM_SLOTS, d), kernel and ``F.rms_norm``: a host clock around
    NORM_HOST_CALLS calls, ended by a synchronize."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as RN
    rows, width = NORM_FLOOR_SHAPE
    x, w = randn(rows, width), randn(width)
    out = {"floor_shape": [rows, width],
           "floor_ms": device_ms(lambda: RN.rmsnorm(x, w)),
           "floor_library_ms": device_ms(
               lambda: F.rms_norm(x, (width,), w, 1e-6))}
    x, w = randn(LM_SLOTS, d), randn(d)

    def host_us(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(NORM_HOST_CALLS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6 / NORM_HOST_CALLS

    out["host_shape"] = [LM_SLOTS, d]
    out["host_us"] = host_us(lambda: RN.rmsnorm(x, w))
    out["library_host_us"] = host_us(lambda: F.rms_norm(x, (d,), w, 1e-6))
    log(f"[time] rmsnorm floor {out['floor_shape']} bf16 (device_ms): "
        f"kernel {out['floor_ms']:.4f} ms, F.rms_norm "
        f"{out['floor_library_ms']:.4f} ms")
    log(f"[time] rmsnorm host cost a call at {out['host_shape']} bf16 "
        f"(host clock over {NORM_HOST_CALLS} calls, ended by a "
        f"synchronize): wrapper {out['host_us']:.2f} us, F.rms_norm "
        f"{out['library_host_us']:.2f} us")
    return out


def time_serve_kernels(dev, cfg, serve, seed=SEED + 6,
                       run="the serving run") -> tuple:
    """Each LM kernel at a serving run's shapes, bf16: kernel and one
    PyTorch call by device_ms, the plain version by CUDA events, and the
    bound.  A kernel's totals are over the serving run's launches: each
    shape's times multiplied by its launches there (every prefill's
    length, a vision prefix included, and an encoder's frames: its norms'
    rows and its non-causal flash; (8, d_model) rows for the decode
    steps' norms).  Returns ([(kernel, totals)] for the kernels the run
    launched, and the shapes' row functions, ``randn``).  A sliding-window
    layer's flash is timed with its window: the kernel, its plain version,
    a banded SDPA and a band-counted bound (:func:`sdpa_call`,
    :func:`attention_flops`)."""
    import collections
    import torch
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt, d = torch.bfloat16, cfg.d_model
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    randn = lambda *shape: torch.randn(shape, generator=gen,
                                       device=dev).to(dt)

    rmsnorm_row = lambda rows: time_rmsnorm(randn, rows, d)

    def flash_row(s, causal=True, window=None) -> dict:
        q, k, v = randn(1, s, hq, hd), randn(1, s, hkv, hd), randn(1, s, hkv,
                                                                   hd)
        geom = FA.legalize(128, 128, s, hd, dt)
        flops = attention_flops(1, s, hq, hd, causal, window)
        row = {"shape": [1, s, hq, hkv, hd], "causal": causal,
               "window": window, "run": [geom.bq, geom.bk, geom.dp],
               "ms": device_ms(lambda: FA.flash_attention(q, k, v, causal,
                                                          window)),
               "plain_ms": cuda_ms(lambda: FA.flash_attention_plain(
                   q, k, v, causal, window, hd ** -0.5, geom), reps=1),
               "library_ms": device_ms(sdpa_call(q, k, v, causal, window)),
               **bound(flops / BF16_FLOPS * 1e3,
                       2.0 * s * hd * (2 * hq + 2 * hkv)
                       / HBM_BYTES_PER_S * 1e3)}
        row["tflops"] = flops / row["ms"] / 1e9
        return row

    # rmsnorm shapes by rows; flash shapes by (S, causal, window)
    step_norms = norms_per_pass(cfg, prefill=False)
    enc_flashes = cfg.n_enc_layers if cfg.enc_dec else 0
    counts = {"rmsnorm": collections.Counter(), "flash_attention":
              collections.Counter()}
    for n in serve["prompt_lens"]:
        s = cfg.vision_prefix + n
        counts["rmsnorm"][s] += step_norms
        for mixer, _ in cfg.layer_kinds():
            if mixer in ("attn", "swa"):
                counts["flash_attention"][(s, True, cfg.swa_window
                                           if mixer == "swa" else None)] += 1
        if cfg.enc_dec:
            counts["rmsnorm"][cfg.enc_seq] += encoder_norms(cfg)
            counts["flash_attention"][(cfg.enc_seq, False, None)] += \
                enc_flashes
    counts["rmsnorm"][LM_SLOTS] += step_norms * serve["decodes"]
    kernels = []
    for name, row_fn in (("rmsnorm", rmsnorm_row),
                         ("flash_attention", lambda key: flash_row(*key))):
        if not serve["launches"][name]:
            continue
        cnt = counts[name]
        check(sum(cnt.values()) == serve["launches"][name],
              f"{name}: timed shapes cover {sum(cnt.values())} launches, "
              f"the run made {serve['launches'][name]}")
        rows = {n: row_fn(n) for n in sorted(cnt) if cnt[n]}
        for n, r in rows.items():
            log_row(name, r, cnt[n])
        tot = {key: sum(rows[n][key] * cnt[n] for n in rows)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        by_ops = sum(rows[n]["bound_ms"] * cnt[n] for n in rows
                     if rows[n]["bound_by"] == "operations")
        tot["bound_by"] = ("operations" if 2 * by_ops >= tot["bound_ms"]
                           else "bytes")
        tot["launches"] = serve["launches"][name]
        tot["shapes"] = [dict(r, launches=cnt[n]) for n, r in rows.items()]
        if enc_flashes and name == "flash_attention":
            tot["non_causal"] = {k: sum(rows[n][k] * cnt[n] for n in rows
                                        if not n[1])
                                 for k in ("ms", "library_ms", "bound_ms")}
        log(f"[time] {name} over {run}'s {tot['launches']} "
            f"launches: kernel {tot['ms']:.3f} ms, library "
            f"{tot['library_ms']:.3f} ms, plain {tot['plain_ms']:.1f} ms, "
            f"bound {tot['bound_ms']:.4f} ms ({tot['bound_by']})")
        kernels.append((name, tot))
    return kernels, (rmsnorm_row, flash_row, randn)


def phase_time_lm_kernels(dev, cfg, serve) -> tuple:
    """:func:`time_serve_kernels` over the qwen2-1.5b serving run; the
    canonical shapes (flash at S 256, 1024, 2048; RMSNorm at 1024 rows)
    are logged too.  Returns the kernels' totals and the RMSNorm floor
    and host cost (:func:`time_rmsnorm_floor_and_host`)."""
    kernels, (rmsnorm_row, flash_row, randn) = time_serve_kernels(
        dev, cfg, serve)
    for s in FLASH_TIMED_S:
        log_row("flash_attention", flash_row(s))
    log_row("rmsnorm", rmsnorm_row(NORM_TIMED_ROWS))
    return kernels, time_rmsnorm_floor_and_host(randn, cfg.d_model)


def phase_check_rmsnorm_backward(dev) -> dict:
    """The RMSNorm autograd Function on the card, at the training shape,
    a serve shape and the family training phases' shapes (d 2048): its
    forward launches the kernel once (counted) and
    its output is held against ``rmsnorm_plain`` on the same inputs, its
    (dx, dw) against autograd through ``rmsnorm_plain``; fp32 within
    FP32_TOL and bf16 within BF16_TOL of max |plain|.  In bf16 the plain
    side runs on the fp32 values of the same bf16 inputs: autograd through
    the bf16 plain version sums its 128-row tiles' dw in bf16 (64
    roundings at 8192 rows, more than BF16_TOL), where the Function sums
    in fp32 and rounds once.  Returns the largest absolute errors of the
    forward and of the gradients in bf16 at the training shape."""
    import torch
    from repro_torch.kernels import rmsnorm as RN
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    worst = {"forward_max_abs_err": 0.0, "backward_max_abs_err": 0.0}
    from repro_torch.configs import get_config
    family = [(batch * seq, get_config(arch).d_model)
              for arch, _, batch, seq, _, _ in FAMILY_TRAIN.values()]
    for shape in [TRAIN_NORM_SHAPE, (LM_SLOTS, TRAIN_NORM_SHAPE[1])] + family:
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            x0, g = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for _ in range(2))
            w0 = torch.randn(shape[-1], generator=gen, device=dev).to(dtype)
            x, w = (t.clone().requires_grad_(True) for t in (x0, w0))
            before = RN.rmsnorm.launches
            out = RN.rmsnorm(x, w)
            check(RN.rmsnorm.launches == before + 1,
                  f"rmsnorm Function {shape} {dtype}: "
                  f"{RN.rmsnorm.launches - before} launches, not 1")
            diff, rel = rel_err(out.detach(), RN.rmsnorm_plain(x0, w0))
            check(out.dtype == dtype and rel <= tol,
                  f"rmsnorm Function forward {shape} {dtype}: rel err "
                  f"{rel:.3g}")
            log(f"[check] rmsnorm Function forward {shape} {dtype} "
                f"max_abs_err={diff:.3g} rel={rel:.3g}")
            if dtype == torch.bfloat16 and shape == TRAIN_NORM_SHAPE:
                worst["forward_max_abs_err"] = diff
            dx, dw = torch.autograd.grad(out, (x, w), g)
            xp, wp = (t.float().clone().requires_grad_(True)
                      for t in (x0, w0))
            px, pw = torch.autograd.grad(RN.rmsnorm_plain(xp, wp), (xp, wp),
                                         g.float())
            torch.cuda.synchronize()
            for name, got, want in (("dx", dx, px), ("dw", dw, pw)):
                diff, rel = rel_err(got, want)
                check(got.dtype == dtype and rel <= tol,
                      f"rmsnorm backward {name} {shape} {dtype}: rel err "
                      f"{rel:.3g}")
                log(f"[check] rmsnorm backward {name} {shape} {dtype} "
                    f"max_abs_err={diff:.3g} rel={rel:.3g}")
                if dtype == torch.bfloat16 and shape == TRAIN_NORM_SHAPE:
                    worst["backward_max_abs_err"] = max(
                        worst["backward_max_abs_err"], diff)
    return worst


def launch_counts() -> dict:
    """The three kernels' launch counts."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import rmsnorm as RN
    return {"gemm": G.gemm.launches, "rmsnorm": RN.rmsnorm.launches,
            "flash_attention": FA.flash_attention.launches}


def zero_counts() -> None:
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import rmsnorm as RN
    RN.rmsnorm.launches = FA.flash_attention.launches = G.gemm.launches = 0


def norm_launches_per_step(cfg, grad_accum: int = 1) -> int:
    """RMSNorm launches of one training step: the forward's
    (:func:`norms_per_pass`), and with remat every block's again when the
    backward recomputes it (all but ``enc_ln`` and the final norm); per
    microbatch."""
    fwd = norms_per_pass(cfg)
    recomputed = fwd - 1 - cfg.enc_dec
    return grad_accum * (fwd + (recomputed if cfg.remat else 0))


def train_steps(tag, step, params, opt, next_batch, per_step: int,
                n_steps: int, falls: bool = True) -> tuple:
    """``n_steps`` training steps (``step(params, opt, next_batch())``),
    the RMSNorm, flash and GEMM counts set to 0 just before: every step
    must launch RMSNorm exactly ``per_step`` times and flash and GEMM
    never; every loss and grad_norm must be finite and (``falls``) the
    last 3 losses' mean below the first 3's.  Returns (losses, grad
    norms, step seconds (host clock, each step ended by a synchronize),
    RMSNorm launches)."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import rmsnorm as RN
    zero_counts()
    losses, norms, secs = [], [], []
    for i in range(n_steps):
        before = RN.rmsnorm.launches
        t0 = time.perf_counter()
        metrics = step(params, opt, next_batch())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        check(RN.rmsnorm.launches - before == per_step,
              f"{tag} step {i}: {RN.rmsnorm.launches - before} "
              f"RMSNorm launches, expected {per_step}")
        check(FA.flash_attention.launches == 0 and G.gemm.launches == 0,
              f"{tag} step {i}: flash {FA.flash_attention.launches}, "
              f"gemm {G.gemm.launches} launches (expected 0)")
        log(f"{tag} step {i}: loss {losses[-1]:.4f} grad_norm "
            f"{norms[-1]:.4f} {secs[-1]:.3f} s, RMSNorm "
            f"{RN.rmsnorm.launches - before} launches")
    check(all(math.isfinite(v) for v in losses + norms),
          f"{tag} non-finite loss or grad_norm: {losses} {norms}")
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    check(not falls or last < first, f"{tag} loss did not fall: first 3 "
          f"{first:.4f}, last 3 {last:.4f}")
    return losses, norms, secs, RN.rmsnorm.launches


def phase_train(dev) -> dict:
    """``[train]``: full-width qwen2-1.5b in bf16 from ``init_params(SEED)``
    takes TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens through the
    port's ``train_step_fn`` fed by the ``Prefetcher``.  The RMSNorm,
    flash and GEMM counts are set to 0 just before the loop; every step
    must launch RMSNorm exactly :func:`norm_launches_per_step` times and
    flash and GEMM never, every loss and grad_norm must be finite, and the
    last 3 losses' mean must be below the first 3's.  No checkpoints here:
    the Trainer's save of 10.7 GB of bf16 weights and moments through zlib
    would take minutes.  Then one more step under the profiler."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.train import steps as S
    cfg = lm_config(torch.bfloat16)
    tc = S.TrainConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                       total_steps=TRAIN_STEPS)
    dc = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                    global_batch=TRAIN_BATCH, structure=64, seed=SEED)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = T.init_params(SEED, cfg, device=dev)
    opt = S.make_optimizer(tc, params)
    step = S.train_step_fn(cfg, tc)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    per_step = norm_launches_per_step(cfg, tc.grad_accum)
    log(f"[train] {LM_ARCH} bf16, {T.param_count(params) / 1e9:.3f} B "
        f"parameters, batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
        f"{TRAIN_STEPS} steps, lr {TRAIN_LR} (cosine, warmup "
        f"{TRAIN_WARMUP}), remat {cfg.remat}; RMSNorm {per_step} launches "
        f"a step expected; setup {setup_s:.1f} s")
    prefetch = Prefetcher(SyntheticLM(dc))
    try:
        losses, norms, secs, launches = train_steps(
            "[train]", step, params, opt, prefetch.next, per_step,
            TRAIN_STEPS)
    finally:
        prefetch.close()
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    peak = torch.cuda.max_memory_allocated(dev)
    steady = secs[1:]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {"arch": LM_ARCH, "dtype": "bfloat16", "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "setup_s": setup_s,
           "first_step_s": secs[0], "step_s_mean": float(np.mean(steady)),
           "step_s_min": min(steady), "step_s_max": max(steady),
           "tokens_per_s": tokens / float(np.mean(steady)),
           "peak_mem_bytes": peak, "loss_first3": first, "loss_last3": last,
           "losses": losses, "grad_norms": norms,
           "rmsnorm_launches": launches, "rmsnorm_per_step": per_step}
    log(f"[train] {TRAIN_STEPS} steps: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (first 3 {first:.4f}, last 3 {last:.4f}); step "
        f"{out['step_s_mean']:.3f} s mean over steps 2-{TRAIN_STEPS} "
        f"(min {out['step_s_min']:.3f}, max {out['step_s_max']:.3f}; the "
        f"first {secs[0]:.3f} s), {out['tokens_per_s']:.0f} tokens/s, peak "
        f"memory {peak / 2 ** 30:.2f} GiB; RMSNorm {launches} launches "
        f"({per_step} a step), flash 0, GEMM 0")
    batch = SyntheticLM(dc).batch_at(TRAIN_STEPS)
    out["profile"] = profile_runs(
        {"train_step": (1, lambda: step(params, opt, batch))})
    # the kernel at a training step's norm shape, over the run's launches
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    row = time_rmsnorm(lambda *shape: torch.randn(
        shape, generator=gen, device=dev).to(torch.bfloat16),
        *TRAIN_NORM_SHAPE)
    log_row("rmsnorm", row, launches)
    out["rmsnorm_time"] = dict(row, launches=launches, **{
        f"total_{k}": row[k] * launches
        for k in ("ms", "plain_ms", "library_ms", "bound_ms")})
    log(f"[time] rmsnorm over the training run's {launches} launches: "
        f"kernel {row['ms'] * launches:.3f} ms, library "
        f"{row['library_ms'] * launches:.3f} ms, bound "
        f"{row['bound_ms'] * launches:.3f} ms ({row['bound_by']})")
    del params, opt
    torch.cuda.empty_cache()
    return out


def phase_train_audio(dev) -> dict:
    """``[train audio]``: whisper-base at full width in bf16 from
    ``init_params(SEED)``, remat on, AUDIO_TRAIN_STEPS steps through the
    port's ``train_step_fn``: 8 x 448 tokens a step drawn as ``[train]``
    draws them (``SyntheticLM``), with 8 x 1500 frames drawn with numpy
    from the seed (each step's drawn before its clock starts).
    :func:`train_steps` holds the launch identities (RMSNorm
    :func:`norm_launches_per_step`: 32 in the forward, 30 recomputed) and
    the falling loss; prints step seconds and peak memory."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.train import steps as S
    cfg = get_config(AUDIO_ARCH).with_(dtype=torch.bfloat16,
                                       param_dtype=torch.bfloat16)
    seq = FAMILY_SERVE["audio"][4]
    tc = S.TrainConfig(lr=TRAIN_LR, warmup_steps=2,
                       total_steps=AUDIO_TRAIN_STEPS)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=AUDIO_TRAIN_BATCH,
                                  structure=64, seed=SEED))
    rng = np.random.default_rng(SEED)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = T.init_params(SEED, cfg, device=dev)
    opt = S.make_optimizer(tc, params)
    step = S.train_step_fn(cfg, tc)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    per_step = norm_launches_per_step(cfg, tc.grad_accum)
    log(f"[train audio] {AUDIO_ARCH} bf16, {T.param_count(params) / 1e6:.3f}"
        f" M parameters, batch {AUDIO_TRAIN_BATCH} x {seq} tokens and "
        f"{cfg.enc_seq} frames, {AUDIO_TRAIN_STEPS} steps, lr {TRAIN_LR} "
        f"(cosine, warmup 2), remat {cfg.remat}; RMSNorm {per_step} "
        f"launches a step expected; setup {setup_s:.1f} s")
    batches = []
    for i in range(AUDIO_TRAIN_STEPS):
        b = data.batch_at(i)
        b["frames"] = rng.standard_normal(
            (AUDIO_TRAIN_BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        batches.append(S.to_device(b, dev))
    losses, norms, secs, launches = train_steps(
        "[train audio]", step, params, opt, lambda: batches.pop(0),
        per_step, AUDIO_TRAIN_STEPS)
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    peak = torch.cuda.max_memory_allocated(dev)
    steady = secs[1:]
    out = {"arch": AUDIO_ARCH, "dtype": "bfloat16",
           "batch": AUDIO_TRAIN_BATCH, "seq": seq, "frames": cfg.enc_seq,
           "steps": AUDIO_TRAIN_STEPS, "setup_s": setup_s,
           "first_step_s": secs[0], "step_s_mean": float(np.mean(steady)),
           "step_s_min": min(steady), "step_s_max": max(steady),
           "tokens_per_s": AUDIO_TRAIN_BATCH * seq / float(np.mean(steady)),
           "peak_mem_bytes": peak, "loss_first3": first, "loss_last3": last,
           "losses": losses, "grad_norms": norms,
           "rmsnorm_launches": launches, "rmsnorm_per_step": per_step}
    log(f"[train audio] {AUDIO_TRAIN_STEPS} steps: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (first 3 {first:.4f}, last 3 {last:.4f}); step "
        f"{out['step_s_mean']:.3f} s mean over steps 2-{AUDIO_TRAIN_STEPS} "
        f"(min {out['step_s_min']:.3f}, max {out['step_s_max']:.3f}; the "
        f"first {secs[0]:.3f} s), {out['tokens_per_s']:.0f} text tokens/s, "
        f"peak memory {peak} bytes ({peak / 2 ** 30:.2f} GiB); RMSNorm "
        f"{launches} launches ({per_step} a step), flash 0, GEMM 0")
    del params, opt, batches
    torch.cuda.empty_cache()
    return out


def phase_train_family(dev, kind: str) -> dict:
    """``[train moe]``, ``[train ssm]``: a family's model at full width in
    bf16 from ``init_params(SEED)``, cut to FAMILY_TRAIN's depth, remat
    on, trained through the port's ``train_step_fn`` (``loss_fn``: the
    dropping MoE's aux loss in the total; the recurrences' chunks under
    their checkpoint) on ``SyntheticLM`` batches drawn before the clock.
    :func:`train_steps` holds the launch identities (RMSNorm
    :func:`norm_launches_per_step`, flash and GEMM none), finite metrics
    and the falling loss; each step's peak memory is read.  ``[train
    ssm]`` then takes one more step with the chunk checkpoint off (the
    same launches held), whose peak is printed beside the checkpointed
    steps': the repair's effect on the card.  The kernel is timed at the
    step's norm shape over the phase's launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as T
    from repro_torch.train import steps as S
    tag = f"[train {kind}]"
    arch, layers, batch, seq, n_steps, lr = FAMILY_TRAIN[kind]
    cfg = get_config(arch).with_(n_layers=layers, dtype=torch.bfloat16,
                                 param_dtype=torch.bfloat16)
    tc = S.TrainConfig(lr=lr, warmup_steps=2, total_steps=n_steps)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, structure=64,
                                  seed=SEED))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = T.init_params(SEED, cfg, device=dev)
    opt = S.make_optimizer(tc, params)
    step = S.train_step_fn(cfg, tc)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    per_step = norm_launches_per_step(cfg, tc.grad_accum)
    log(f"{tag} {arch} bf16 cut to {layers} layers "
        f"{[f'{m}+{f}' for m, f in cfg.pattern[:layers]]} at full width "
        f"(d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
        f"d_ff {cfg.d_ff}, {cfg.n_experts} experts top-{cfg.moe_top_k}, "
        f"vocab {cfg.vocab}), {T.param_count(params) / 1e9:.3f} B "
        f"parameters; batch {batch} x {seq} tokens, {n_steps} steps, lr "
        f"{lr} (cosine, warmup 2), remat {cfg.remat}, MoE "
        f"{cfg.moe_impl}, recurrence chunk {cfg.ssm_chunk}; RMSNorm "
        f"{per_step} launches a step expected; setup {setup_s:.1f} s")
    batches = [S.to_device(data.batch_at(i), dev) for i in range(n_steps + 1)]
    peaks, nll, aux = [], [], []

    def peaked(params, opt, b):
        torch.cuda.reset_peak_memory_stats(dev)
        metrics = step(params, opt, b)
        peaks.append(torch.cuda.max_memory_allocated(dev))
        nll.append(metrics["nll"])
        aux.append(metrics.get("aux"))
        return metrics

    losses, norms, secs, launches = train_steps(
        tag, peaked, params, opt, lambda: batches.pop(0), per_step, n_steps)
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    steady = secs[1:]
    tokens = batch * seq
    out = {"arch": arch, "layers": layers, "dtype": "bfloat16",
           "batch": batch, "seq": seq, "steps": n_steps,
           "params": T.param_count(params), "setup_s": setup_s,
           "first_step_s": secs[0], "step_s_mean": float(np.mean(steady)),
           "step_s_min": min(steady), "step_s_max": max(steady),
           "tokens_per_s": tokens / float(np.mean(steady)),
           "peak_mem_bytes": max(peaks), "loss_first3": first,
           "loss_last3": last, "losses": losses, "grad_norms": norms,
           "nll": [float(v) for v in nll],
           "rmsnorm_launches": launches, "rmsnorm_per_step": per_step}
    if kind == "moe":
        out["aux"] = [float(v) for v in aux]
    log(f"{tag} {n_steps} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(first 3 {first:.4f}, last 3 {last:.4f}; nll {out['nll'][0]:.4f}"
        f" -> {out['nll'][-1]:.4f}"
        + (f", aux {out['aux'][0]:.4f} -> {out['aux'][-1]:.4f}"
           if kind == "moe" else "")
        + f"); step {out['step_s_mean']:.3f} s mean over steps 2-{n_steps} "
        f"(min {out['step_s_min']:.3f}, max {out['step_s_max']:.3f}; the "
        f"first {secs[0]:.3f} s), {out['tokens_per_s']:.0f} tokens/s, peak "
        f"{out['peak_mem_bytes']} bytes ({out['peak_mem_bytes'] / 2 ** 30:.2f}"
        f" GiB); RMSNorm {launches} launches ({per_step} a step), flash 0, "
        f"GEMM 0")
    if kind == "ssm":
        # one step more with the recurrences' chunk checkpoint off
        before = RN.rmsnorm.launches
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with SSM.chunk_checkpoint(False):
            metrics = step(params, opt, batches.pop(0))
            peak_off = torch.cuda.max_memory_allocated(dev)
            torch.cuda.synchronize()
        off_s = time.perf_counter() - t0
        check(RN.rmsnorm.launches - before == per_step
              and FA.flash_attention.launches == 0 and G.gemm.launches == 0,
              f"{tag} step without the chunk checkpoint: RMSNorm "
              f"{RN.rmsnorm.launches - before}, flash "
              f"{FA.flash_attention.launches}, gemm {G.gemm.launches}")
        check(math.isfinite(float(metrics["loss"])),
              f"{tag} step without the chunk checkpoint: loss "
              f"{float(metrics['loss'])}")
        launches = RN.rmsnorm.launches
        out.update(peak_no_ckpt_bytes=peak_off, step_no_ckpt_s=off_s,
                   rmsnorm_launches=launches,
                   chunks=-(-seq // cfg.ssm_chunk))
        log(f"{tag} the recurrences' chunk checkpoint ({out['chunks']} "
            f"chunks of {cfg.ssm_chunk} steps a layer): a step's peak "
            f"{out['peak_mem_bytes']} bytes with it, {peak_off} bytes "
            f"without ({peak_off / out['peak_mem_bytes']:.2f}x; "
            f"{(peak_off - out['peak_mem_bytes']) / 2 ** 30:.2f} GiB more); "
            f"the step without it {off_s:.3f} s, loss "
            f"{float(metrics['loss']):.4f}, RMSNorm {per_step} launches")
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    row = time_rmsnorm(lambda *shape: torch.randn(
        shape, generator=gen, device=dev).to(torch.bfloat16),
        tokens, cfg.d_model)
    log_row("rmsnorm", row, launches)
    out["rmsnorm_time"] = dict(row, launches=launches, **{
        f"total_{k}": row[k] * launches
        for k in ("ms", "plain_ms", "library_ms", "bound_ms")})
    log(f"[time] rmsnorm over {tag}'s {launches} launches: kernel "
        f"{row['ms'] * launches:.3f} ms, library "
        f"{row['library_ms'] * launches:.3f} ms, bound "
        f"{row['bound_ms'] * launches:.3f} ms ({row['bound_by']})")
    del params, opt, batches, step
    torch.cuda.empty_cache()
    return out


def phase_autotune(dev, train_peak: int) -> dict:
    """``[autotune]``: the CLI's ``tune --arch qwen2-1.5b --shape train_4k
    --oracle compile`` in process at AUTOTUNE_DEVICES placeholder devices
    and budget AUTOTUNE_BUDGET, the agents and the GBT on the card, its
    records and report under ``build/`` (its stdout there too).  Gates:
    every measurement row finite, carrying ``SettingsOracle._RESULT_KEYS``;
    the best setting ``feasible``; the report written.  Then the
    estimator against the card: at ``[train]``'s shape (qwen2-1.5b bf16,
    TRAIN_BATCH x TRAIN_SEQ, remat, a 1-device mesh) the dry-run's
    ``weighted_dot_flops`` must equal ``FlopCounterMode``'s count around
    one real training step on the card within FLOP_RTOL; the estimator's
    memory (``hbm_residency``, the TPU model, and the dry-run's argument
    and temp bytes) is printed beside that step's measured peak and
    ``[train]``'s (``train_peak``), ungated.
    The launch counts are set to 0 just before."""
    import contextlib
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.compiler import cli
    from repro_torch.compiler.oracle import SettingsOracle
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.hw import roofline as RL
    from repro_torch.hw import step_analysis as SA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.launch import dryrun as DR
    from repro_torch.models import transformer as T
    from repro_torch.train import steps as S
    RN.rmsnorm.launches = FA.flash_attention.launches = G.gemm.launches = 0
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    records = os.path.join(build, "autotune_records.jsonl")
    report = os.path.join(build, "autotune_report.json")
    for f in (records, report):
        if os.path.exists(f):
            os.remove(f)
    argv = ["tune", "--arch", AUTOTUNE_ARCH, "--shape", AUTOTUNE_SHAPE,
            "--oracle", "compile", "--budget", str(AUTOTUNE_BUDGET),
            "--device", "cuda", "--records", records, "--out", report]
    pinned = os.environ.get("REPRO_DRYRUN_DEVICES")
    os.environ["REPRO_DRYRUN_DEVICES"] = str(AUTOTUNE_DEVICES)
    t0 = time.perf_counter()
    try:
        with open(os.path.join(build, "autotune_stdout.txt"), "w") as f, \
                contextlib.redirect_stdout(f):
            rc = cli.main(argv)
    finally:
        if pinned is None:
            del os.environ["REPRO_DRYRUN_DEVICES"]
        else:
            os.environ["REPRO_DRYRUN_DEVICES"] = pinned
    tune_s = time.perf_counter() - t0
    check(rc == 0, f"[autotune] tune exited {rc}")
    check(os.path.exists(report), f"[autotune] no report at {report}")
    with open(report) as f:
        rep = json.load(f)["reports"][f"{AUTOTUNE_ARCH}/{AUTOTUNE_SHAPE}"]
    with open(records) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    check(len(rows) == rep["n_measurements"] == AUTOTUNE_BUDGET,
          f"[autotune] {len(rows)} records, {rep['n_measurements']} "
          f"measurements, budget {AUTOTUNE_BUDGET}")
    for row in rows:
        res = row.get("result", {})
        check(set(SettingsOracle._RESULT_KEYS) <= set(res)
              and math.isfinite(row["latency"])
              and all(math.isfinite(float(res[k])) for k in
                      ("step_s", "compile_s", "hbm_residency_gib")),
              f"[autotune] a measurement row lacks a result key or is not "
              f"finite: {row}")
        log(f"[autotune] measured {row['settings']}: step "
            f"{res['step_s']:.4f} s (model), penalized "
            f"{row['latency']:.4f}, residency "
            f"{res['hbm_residency_gib']:.2f} GiB, feasible "
            f"{res['feasible']}, dominant {res['dominant']}, analysis "
            f"{res['compile_s']:.2f} s")
    best = [r for r in rows if r["settings"] == rep["best_settings"]]
    check(best and best[0]["result"]["feasible"],
          f"[autotune] the best setting {rep['best_settings']} is not "
          f"feasible")
    log(f"[autotune] tune --arch {AUTOTUNE_ARCH} --shape {AUTOTUNE_SHAPE} "
        f"--oracle compile at {AUTOTUNE_DEVICES} placeholder devices, "
        f"budget {AUTOTUNE_BUDGET}: {tune_s:.1f} s, best "
        f"{rep['best_settings']} at {rep['best_latency']:.4f} s a step "
        f"(TPU v5e roofline model, not a time of the card), feasible; "
        f"every row carries {SettingsOracle._RESULT_KEYS}; report "
        f"{os.path.relpath(report, ROOT)}")
    # the estimator against one real step on the card
    cfg = lm_config(torch.bfloat16)
    cell = ShapeCell("train", "train", TRAIN_SEQ, TRAIN_BATCH)
    mesh = {"data": 1, "model": 1}
    t0 = time.perf_counter()
    est = SA.analyze(cfg, cell, mesh, ShardingRules(),
                     {"grad_accum": 1, "moment_dtype": "bfloat16"})
    mem = DR.memory_estimate(cfg, cell, mesh, ShardingRules(), TRAIN_BATCH)
    est_s = time.perf_counter() - t0
    residency = RL.hbm_residency(cfg, "train", TRAIN_SEQ, TRAIN_BATCH, mesh,
                                 fsdp=False, moment_dtype="bfloat16",
                                 remat=cfg.remat)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tc = S.TrainConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                       total_steps=TRAIN_STEPS)
    params = T.init_params(SEED, cfg, device=dev)
    opt = S.make_optimizer(tc, params)
    step = S.train_step_fn(cfg, tc)
    batch = S.to_device(SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        structure=64, seed=SEED)).batch_at(0), dev)
    with FlopCounterMode(display=False) as fc:
        metrics = step(params, opt, batch)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    card = float(fc.get_total_flops())
    rel = abs(est["weighted_dot_flops"] - card) / card
    check(math.isfinite(float(metrics["loss"])) and rel <= FLOP_RTOL,
          f"[autotune] estimator dot FLOPs {est['weighted_dot_flops']:.6e} "
          f"vs FlopCounterMode on the card {card:.6e}: rel {rel:.3g}")
    launches = {"rmsnorm": RN.rmsnorm.launches,
                "flash_attention": FA.flash_attention.launches,
                "gemm": G.gemm.launches}
    log(f"[autotune] dot FLOPs of one {LM_ARCH} training step "
        f"({TRAIN_BATCH} x {TRAIN_SEQ}, bf16, remat, 1-device mesh): "
        f"estimator (meta device, counted at layers "
        f"{est['counted_layers']} and carried to {cfg.n_layers}; {est_s:.1f}"
        f" s) {est['weighted_dot_flops']:.0f}, FlopCounterMode around the "
        f"real step on the card {card:.0f}: rel {rel:.3g} (gate "
        f"{FLOP_RTOL}); launches {launches}")
    log(f"[autotune] memory of that step: measured peak {peak} bytes on the "
        f"card ([train]'s: {train_peak}); the dry-run's "
        f"argument {mem['argument_size_in_bytes']} + temp "
        f"{int(est['temp_bytes'])} = "
        f"{mem['argument_size_in_bytes'] + int(est['temp_bytes'])} bytes; "
        f"the roofline's hbm_residency (TPU v5e model) {residency:.0f} "
        f"bytes (printed, not gated)")
    out = {"arch": AUTOTUNE_ARCH, "shape": AUTOTUNE_SHAPE,
           "devices": AUTOTUNE_DEVICES, "budget": AUTOTUNE_BUDGET,
           "tune_s": tune_s, "best_settings": rep["best_settings"],
           "best_step_s_model": rep["best_latency"],
           "rows": [dict(r["result"], settings=r["settings"],
                         latency=r["latency"]) for r in rows],
           "flops_estimator": est["weighted_dot_flops"],
           "flops_card": card, "flops_rel": rel, "estimator_s": est_s,
           "peak_mem_bytes": peak, "hbm_residency_bytes": residency,
           "argument_size_in_bytes": mem["argument_size_in_bytes"],
           "temp_size_in_bytes": int(est["temp_bytes"]),
           "launches": launches}
    del params, opt, step
    torch.cuda.empty_cache()
    return out


def phase_drivers(dev) -> dict:
    """``[drivers]``: the reference's examples as the port runs them, in
    process on the card (``python -m repro_torch.examples.<name>`` calls
    the same ``main``), the launch counts set to 0 just before.  Gates:
    quickstart's deployed conv (the Hopper GEMM at the tuned geometry)
    within FP32_TOL of ``conv2d_ref``'s max, one GEMM launch, every
    tuner's latency at or above the roofline bound; serve_lm's 8 requests
    all served with 12 tokens each, flash once an attention layer a
    prefill and RMSNorm a whole number of passes (8 prefills and the
    decode steps); train_lm's loss falling over DRIVER_TRAIN_STEPS steps,
    RMSNorm ``norm_launches_per_step`` a step, flash and GEMM none."""
    import contextlib
    import io
    from repro_torch.configs import get_config
    from repro_torch.examples import quickstart, serve_lm, train_lm
    zero_counts()
    marks, secs = [launch_counts()], {}

    def run(name, fn):
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn()
        secs[name] = time.perf_counter() - t0
        marks.append(launch_counts())
        for line in buf.getvalue().splitlines():
            log(f"[drivers] {name}: {line}")
        return out

    qs = run("quickstart", lambda: quickstart.main(["--device", "cuda"]))
    sv = run("serve_lm", lambda: serve_lm.main(["--device", "cuda"]))
    tr = run("train_lm", lambda: train_lm.main(
        ["--steps", str(DRIVER_TRAIN_STEPS), "--device", "cuda"]))
    per = {name: {k: marks[i + 1][k] - marks[i][k] for k in KERNELS}
           for i, name in enumerate(("quickstart", "serve_lm", "train_lm"))}
    # quickstart: the deployed conv against the plain oracle
    rel = qs["deploy_max_abs_err"] / qs["oracle_max_abs"]
    check(rel <= FP32_TOL and per["quickstart"] == {
        "gemm": 1, "rmsnorm": 0, "flash_attention": 0},
          f"[drivers] quickstart: deploy rel err {rel:.3g} (gate "
          f"{FP32_TOL}), launches {per['quickstart']}")
    check(all(qs[f"{k}_latency_s"] >= qs["min_latency_s"]
              for k in ("arco", "autotvm", "random")),
          f"[drivers] quickstart: a latency under the roofline bound {qs}")
    # serve_lm: every request, the launch identities
    cfg = get_config(LM_ARCH, reduced=True)
    npp, done = norms_per_pass(cfg), sv["done"]
    served = [r for r in done if r.ok and len(r.output) == DRIVER_NEW]
    launches = per["serve_lm"]
    steps = launches["rmsnorm"] // npp - len(done)
    check(len(served) == len(done) == DRIVER_REQUESTS
          and sv["rejected"] == sv["abandoned"] == 0
          and launches["flash_attention"] == attention_layers(cfg)
          * DRIVER_REQUESTS and launches["rmsnorm"] % npp == 0
          and steps > 0 and launches["gemm"] == 0,
          f"[drivers] serve_lm: {len(served)}/{len(done)} served with "
          f"{DRIVER_NEW} tokens, launches {launches} ({npp} norms a pass)")
    # train_lm: the loss falls, RMSNorm every step
    tcfg = get_config(DRIVER_TRAIN_ARCH, reduced=True)
    per_step = norm_launches_per_step(tcfg)
    check(tr["steps"] == DRIVER_TRAIN_STEPS
          and tr["last_loss"] < tr["first_loss"]
          and per["train_lm"] == {"gemm": 0, "flash_attention": 0,
                                  "rmsnorm": per_step * DRIVER_TRAIN_STEPS},
          f"[drivers] train_lm: {tr}, launches {per['train_lm']} "
          f"({per_step} RMSNorm a step)")
    total = {k: marks[-1][k] - marks[0][k] for k in KERNELS}
    log(f"[drivers] quickstart {secs['quickstart']:.1f} s: deployed conv "
        f"max |err| {qs['deploy_max_abs_err']:.3g} against max |oracle| "
        f"{qs['oracle_max_abs']:.3g} (rel {rel:.3g}, gate {FP32_TOL}); "
        f"launches {per['quickstart']}")
    log(f"[drivers] serve_lm {secs['serve_lm']:.1f} s: {len(served)}/"
        f"{len(done)} requests served, {sv['tokens']} tokens, "
        f"{sv['tokens'] / sv['wall_s']:.1f} tokens/s; launches "
        f"{launches} ({DRIVER_REQUESTS} prefills + {steps} decode steps "
        f"x {npp} norms)")
    log(f"[drivers] train_lm {secs['train_lm']:.1f} s: loss "
        f"{tr['first_loss']} -> {tr['last_loss']} over {tr['steps']} steps, "
        f"{tr['tokens_per_s']} tokens/s; launches {per['train_lm']}")
    log(f"[drivers] launches in the phase {total}")
    return {"quickstart": qs,
            "serve_lm": {"served": len(served), "requests": len(done),
                         "tokens": sv["tokens"], "wall_s": sv["wall_s"],
                         "decode_steps": steps},
            "train_lm": tr, "seconds": secs, "per_driver": per,
            "launches": total}


def mesh_group():
    """The mesh phases' process group: NCCL at world size 1, rendezvous
    through a ``FileStore`` under a temporary directory of the run; and
    the (data 1, model 1) ``DeviceMesh`` over it.  Returns (mesh, the
    store's directory)."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import backend_for, make_device_mesh
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    store = dist.FileStore(os.path.join(tmp, "store"), 1)
    dist.init_process_group(backend_for("cuda"), store=store, rank=0,
                            world_size=1)
    return make_device_mesh({"data": 1, "model": 1}, "cuda"), tmp


def _rel_gap(got, want) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def phase_train_sharded(dev, mesh, train: dict) -> tuple:
    """``[train sharded]``: ``build_sharded_train_step`` over the (1, 1)
    mesh, full-width qwen2-1.5b in bf16 from ``init_params(SEED)`` placed
    by ``param_shardings`` (DTensors), MESH_STEPS steps on ``[train]``'s
    first batches (the same ``SyntheticLM`` steps) at ``[train]``'s
    ``TrainConfig``.  :func:`train_steps` holds the launch identities
    (RMSNorm :func:`norm_launches_per_step` a step, flash and GEMM 0); the
    losses and grad norms must equal ``[train]``'s first MESH_STEPS within
    MESH_TOL relative (every op runs on the whole tensor).  Prints the
    step time and peak memory beside ``[train]``'s.  Returns (the phase's
    numbers, then the params, the optimizer, the config, the train config
    and the dataset, which ``[train int8]`` continues from)."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.dist import sharding as SH
    from repro_torch.models import transformer as T
    from repro_torch.train import steps as S
    cfg = lm_config(torch.bfloat16)
    tc = S.TrainConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                       total_steps=TRAIN_STEPS)
    dc = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                    global_batch=TRAIN_BATCH, structure=64, seed=SEED)
    ds = SyntheticLM(dc)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    make, sh = S.build_sharded_train_step(cfg, tc, mesh)
    params = SH.distribute_tree(T.init_params(SEED, cfg, device=dev),
                                sh["params"], mesh)
    opt = S.make_optimizer(tc, params)
    step = make(ds.batch_at(0))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    per_step = norm_launches_per_step(cfg, tc.grad_accum)
    log(f"[train sharded] {LM_ARCH} bf16 on the mesh "
        f"{SH.mesh_shape(mesh)} over NCCL (world size 1), parameters as "
        f"DTensors ({len(opt.params)} leaves), {MESH_STEPS} steps of "
        f"[train]'s batches; setup {setup_s:.1f} s")
    batches = iter([ds.batch_at(i) for i in range(MESH_STEPS)])
    losses, norms, secs, launches = train_steps(
        "[train sharded]", step, params, opt, lambda: next(batches),
        per_step, MESH_STEPS, falls=False)
    peak = torch.cuda.max_memory_allocated(dev)
    gap = max(_rel_gap(losses, train["losses"][:MESH_STEPS]),
              _rel_gap(norms, train["grad_norms"][:MESH_STEPS]))
    log(f"[train sharded] losses {losses} against [train]'s "
        f"{train['losses'][:MESH_STEPS]}, grad norms {norms} against "
        f"{train['grad_norms'][:MESH_STEPS]}: largest relative gap "
        f"{gap:.3g} (gate {MESH_TOL})")
    check(gap <= MESH_TOL, f"[train sharded] differs from [train] by "
          f"{gap:.3g} > {MESH_TOL}")
    steady = float(np.mean(secs[1:]))
    log(f"[train sharded] step {steady:.3f} s (steps 2-{MESH_STEPS}; the "
        f"first {secs[0]:.3f} s) beside [train]'s "
        f"{train['step_s_mean']:.3f} s: DTensor's host dispatch "
        f"{steady - train['step_s_mean']:+.3f} s a step; peak memory "
        f"{peak} bytes beside [train]'s {train['peak_mem_bytes']}; RMSNorm "
        f"{launches} launches ({per_step} a step), flash 0, GEMM 0")
    out = {"mesh": SH.mesh_shape(mesh), "steps": MESH_STEPS,
           "setup_s": setup_s, "losses": losses, "grad_norms": norms,
           "rel_gap": gap, "first_step_s": secs[0], "step_s_mean": steady,
           "train_step_s_mean": train["step_s_mean"],
           "peak_mem_bytes": peak,
           "train_peak_mem_bytes": train["peak_mem_bytes"],
           "launches": launch_counts()}
    return out, params, opt, cfg, tc, ds


def phase_train_int8(dev, mesh, params, opt, cfg, tc, ds) -> dict:
    """``[train int8]``: ``make_ddp_compressed_step`` over the mesh's data
    axis (world size 1) for MESH_STEPS steps on the parameters and
    optimizer ``[train sharded]`` leaves: their local tensors (at world
    size 1 a DTensor's local tensor is all of it; the same storage) are
    the replicated plain tensors the step takes.  Gates: every loss and
    error state finite; RMSNorm :func:`norm_launches_per_step` a step,
    flash and GEMM 0 (counts set to 0 just before); then one more
    gradient through ``compressed_psum_mean`` directly, timed by CUDA
    events, whose synced gradient must equal ``q * scale`` exactly (the
    sum over one rank).  Prints the bytes one all-reduce puts on the
    wire: int32, as the reference's ``psum`` sends them."""
    import copy
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.optim import compression as C
    from repro_torch.train import checkpoint as CKPT
    local = CKPT.tree_map(lambda p: p.to_local().detach().requires_grad_(),
                          params)
    lopt = copy.copy(opt)
    lopt.params = [p for _, p in CKPT.flatten(local)]
    lopt.mu = [m.to_local() for m in opt.mu]
    lopt.nu = [v.to_local() for v in opt.nu]

    def loss_fn(p, b):
        return T.loss_fn(p, b, cfg)

    step = C.make_ddp_compressed_step(loss_fn, lopt, mesh)
    err = C.init_error_state(local)
    per_step = norm_launches_per_step(cfg, tc.grad_accum)
    zero_counts()
    losses, secs = [], []
    for i in range(MESH_STEPS):
        before = launch_counts()["rmsnorm"]
        t0 = time.perf_counter()
        err, loss = step(local, lopt, err, ds.batch_at(MESH_STEPS + i))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        n = launch_counts()
        check(n["rmsnorm"] - before == per_step and n["gemm"] == 0
              and n["flash_attention"] == 0,
              f"[train int8] step {i}: launches {n}, RMSNorm "
              f"{n['rmsnorm'] - before} (expected {per_step})")
        log(f"[train int8] step {i}: loss {losses[-1]:.4f} "
            f"{secs[-1]:.3f} s, RMSNorm {n['rmsnorm'] - before} launches")
    launches = launch_counts()
    check(all(math.isfinite(v) for v in losses) and all(
        bool(torch.isfinite(e).all()) for _, e in CKPT.flatten(err)),
        f"[train int8] non-finite loss or error state: {losses}")
    # one more gradient, compressed here: the pass's time and q * scale
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in ds.batch_at(2 * MESH_STEPS).items()}
    loss, _ = loss_fn(local, batch)
    grads = list(torch.autograd.grad(loss, lopt.params))
    del loss
    e_leaves = [e for _, e in CKPT.flatten(err)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    synced, _ = C.compressed_psum_mean(grads, e_leaves,
                                       mesh.get_group("data"))
    end.record()
    end.synchronize()
    pass_ms = start.elapsed_time(end)
    exact = True
    for g, e, got in zip(grads, e_leaves, synced):
        g = g.float() + e
        scale = torch.clamp(g.abs().max(), min=1e-12) * (1.0 / 127.0)
        q = torch.clamp(torch.round(g / scale), -127, 127)
        exact &= bool(torch.isfinite(got).all()) and torch.equal(
            got, q * scale)
    check(exact, "[train int8] a synced gradient is not q * scale at "
                 "world size 1")
    # one all-reduce's wire: each leaf's int32 sum and its fp32 scale
    values = sum(p.numel() for p in lopt.params)
    wire = {"int32": 4 * values + 4 * len(lopt.params),
            "int8": values + 4 * len(lopt.params)}
    log(f"[train int8] {MESH_STEPS} steps: losses {losses}, step "
        f"{sum(secs[1:]) / max(len(secs) - 1, 1):.3f} s; the compression "
        f"pass {pass_ms:.3f} ms a step (CUDA events, {len(grads)} "
        f"leaves); synced gradients == q * scale exactly; one all-reduce "
        f"puts {wire['int32']} bytes on the wire (int32 sums and fp32 "
        f"scales, as the reference's psum; int8 values would be "
        f"{wire['int8']})")
    return {"steps": MESH_STEPS, "losses": losses, "step_s": secs,
            "compress_ms": pass_ms, "wire_bytes": wire, "exact": exact,
            "launches": launches}


def phase_serve_sharded(dev, mesh) -> dict:
    """``[serve sharded]``: ``build_sharded_prefill`` and
    ``build_sharded_serve_step`` over the (1, 1) mesh, full-width
    qwen2-1.5b in bf16 from ``init_params(SEED)`` placed by
    ``param_shardings``: a batch of MESH_SERVE_BATCH prompts of
    MESH_SERVE_PROMPT tokens drawn from the seed, then MESH_SERVE_STEPS
    decode steps fed the unsharded path's greedy tokens, each beside the
    unsharded ``prefill`` / ``decode_step`` on the same weights: logits
    within MESH_TOL relative; flash :func:`attention_layers` and RMSNorm
    :func:`norms_per_pass` a prefill, RMSNorm a decode step, GEMM never
    (counts set to 0 before each sharded call).  Prints the decode step's
    ms beside the unsharded step's."""
    import numpy as np
    import torch
    from repro_torch.dist import sharding as SH
    from repro_torch.models import transformer as T
    from repro_torch.train import steps as S
    cfg = lm_config(torch.bfloat16)
    params = T.init_params(SEED, cfg, device=dev)
    make, sh = S.build_sharded_prefill(cfg, mesh, LM_MAX_LEN)
    sparams = SH.distribute_tree(params, sh["params"], mesh)
    serve, _ = S.build_sharded_serve_step(cfg, mesh, batch=MESH_SERVE_BATCH,
                                          max_len=LM_MAX_LEN)
    rng = np.random.default_rng(SEED + 30)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab, size=(MESH_SERVE_BATCH, MESH_SERVE_PROMPT)),
        device=dev)}
    flashes, norms = attention_layers(cfg), norms_per_pass(cfg)
    step_norms = norms_per_pass(cfg, prefill=False)
    zero_counts()
    logits_s, cache_s = make(batch)(sparams, batch)
    n = launch_counts()
    check(n == {"gemm": 0, "rmsnorm": norms, "flash_attention": flashes},
          f"[serve sharded] prefill launches {n}, expected flash "
          f"{flashes}, RMSNorm {norms}")
    totals = dict(n)
    with torch.no_grad():
        logits_u, cache_u = T.prefill(params, batch, cfg, LM_MAX_LEN)
    gaps = [rel_err(logits_s, logits_u)[1]]
    ms_s, ms_u = [], []
    tok = logits_u.argmax(-1, keepdim=True)
    for i in range(MESH_SERVE_STEPS):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, cache_s = serve(sparams, cache_s, tok)
        torch.cuda.synchronize()
        ms_s.append(1e3 * (time.perf_counter() - t0))
        n = launch_counts()
        check(n == {"gemm": 0, "rmsnorm": step_norms, "flash_attention": 0},
              f"[serve sharded] decode step {i} launches {n}, expected "
              f"RMSNorm {step_norms}")
        totals = {k: totals[k] + v for k, v in n.items()}
        t0 = time.perf_counter()
        with torch.no_grad():
            want, cache_u = T.decode_step(params, cache_u, tok, cfg)
        torch.cuda.synchronize()
        ms_u.append(1e3 * (time.perf_counter() - t0))
        gaps.append(rel_err(got, want)[1])
        tok = want.argmax(-1, keepdim=True)
    gap = max(gaps)
    log(f"[serve sharded] {LM_ARCH} bf16 on the mesh {SH.mesh_shape(mesh)}: "
        f"a prefill of {MESH_SERVE_BATCH} x {MESH_SERVE_PROMPT} tokens, then "
        f"{MESH_SERVE_STEPS} decode steps: largest max |logit diff| / max "
        f"|logit| against the unsharded path {gap:.3g} (gate {MESH_TOL}); "
        f"a prefill flash {flashes} + RMSNorm {norms}, a decode step "
        f"RMSNorm {step_norms}; decode step {float(np.mean(ms_s[1:])):.3f} "
        f"ms beside the unsharded {float(np.mean(ms_u[1:])):.3f} ms (steps "
        f"2-{MESH_SERVE_STEPS}, host clock ending in a synchronize)")
    check(gap <= MESH_TOL, f"[serve sharded] logits differ from the "
          f"unsharded path by {gap:.3g} > {MESH_TOL}")
    del params, sparams, cache_s, cache_u
    torch.cuda.empty_cache()
    return {"batch": MESH_SERVE_BATCH, "prompt": MESH_SERVE_PROMPT,
            "decode_steps": MESH_SERVE_STEPS, "rel_gap": gap,
            "decode_step_ms": float(np.mean(ms_s[1:])),
            "unsharded_decode_step_ms": float(np.mean(ms_u[1:])),
            "launches": totals}


def phase_train_faults(dev) -> dict:
    """``[train faults]``: the port's ``Trainer`` on the card at the
    reference trainer test's setup (reduced smollm-360m, 40 steps,
    checkpoints every 10, a crash injected at step 17 and a NaN batch at
    26): both faults fire and roll back (the NaN through the embedding's
    fill, with no device-side assert), step 40 is reached and the loss
    ends lower.  A new Trainer on the same directory resumes at step 40
    and runs to 46.  Then the launcher runs as a subprocess on the card
    (its default device) and prints its JSON."""
    import shutil
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.steps import TrainConfig
    from repro_torch.train.trainer import (FailureInjector, Trainer,
                                           TrainerConfig)
    ckpt = os.path.join(ROOT, "build", "train_faults_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    cfg = get_config("smollm-360m", reduced=True)
    tc = TrainConfig(lr=1e-3, warmup_steps=5, total_steps=60)
    dc = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4,
                    structure=16)
    injector = FailureInjector(crash_at=17, nan_at=26)
    t0 = time.perf_counter()
    tr = Trainer(cfg, tc, TrainerConfig(steps=40, ckpt_dir=ckpt,
                                        ckpt_every=10, log_every=5),
                 device=dev, data_cfg=dc, injector=injector)
    log_ = tr.run()
    run_s = time.perf_counter() - t0
    rollbacks = [e for e in log_ if "event" in e]
    losses = [e["loss"] for e in log_ if "loss" in e]
    first, last = float(np.mean(losses[:2])), float(np.mean(losses[-2:]))
    check(injector.fired == ["crash@17", "nan@26"],
          f"[train faults] fired {injector.fired}")
    check([e["step"] for e in rollbacks] == [10, 20],
          f"[train faults] rollbacks {rollbacks}")
    check(tr.step == 40 and last < first,
          f"[train faults] step {tr.step}, loss {first:.4f} -> {last:.4f}")
    log(f"[train faults] {tr.step} steps in {run_s:.1f} s on {dev}: fired "
        f"{injector.fired}, rolled back to steps "
        f"{[e['step'] for e in rollbacks]} ({rollbacks[1]['event']}); "
        f"loss first 2 logged {first:.4f}, last 2 {last:.4f}")
    tr2 = Trainer(cfg, tc, TrainerConfig(steps=46, ckpt_dir=ckpt,
                                         ckpt_every=10), device=dev,
                  data_cfg=dc)
    resumed = tr2.step
    check(resumed == 40 and tr2.opt.step_count == 40,
          f"[train faults] restart resumed at {resumed} "
          f"(opt step {tr2.opt.step_count}), not 40")
    tr2.run()
    check(tr2.step == 46, f"[train faults] restart ended at {tr2.step}")
    log(f"[train faults] restart resumed at step {resumed}, ran to "
        f"{tr2.step}")
    launch_ckpt = os.path.join(ROOT, "build", "train_launch_ckpt")
    shutil.rmtree(launch_ckpt, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         LM_ARCH, "--reduced", "--steps", "20", "--ckpt", launch_ckpt],
        env=env, capture_output=True, text=True, timeout=LAUNCH_TIMEOUT_S,
        cwd=ROOT)
    launch_s = time.perf_counter() - t0
    check(res.returncode == 0, f"[train faults] launcher exited "
          f"{res.returncode}: {res.stderr[-2000:]}")
    head, _, body = res.stdout.partition("\n")
    report = json.loads(body)
    check(report["steps"] == 20 and "device=cuda" in head
          and math.isfinite(report["last_loss"]),
          f"[train faults] launcher printed {res.stdout[-800:]}")
    log(f"[train faults] launcher ({launch_s:.1f} s): {head}; "
        f"{json.dumps(report)}")
    return {"steps": tr.step, "fired": injector.fired,
            "rollback_steps": [e["step"] for e in rollbacks],
            "loss_first2": first, "loss_last2": last, "run_s": run_s,
            "resumed_at": resumed, "launcher": report, "launcher_s": launch_s}


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


def _noise(params, cfg, prompts, dev, eps: float, frontends=None) -> float:
    """The plain path's own logit distance (prefill, then LM_GATE_STEPS
    teacher-forced decode steps, / max |logit|) when the embedding table
    is multiplied by (1 + eps N(0, 1)): how far a rounding-size change of
    the input moves this model's logits."""
    import torch
    from repro_torch.models import transformer as T
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    emb = params["embed"]
    moved = dict(params, embed=emb * (1 + eps * torch.randn(
        emb.shape, generator=gen, device=dev, dtype=emb.dtype)))
    worst = 0.0
    for toks, front in zip(prompts, frontends or [None] * len(prompts)):
        batch, t, n, max_len = _gate_batch(cfg, toks, front, dev)
        out = [T.prefill(p, batch, cfg, max_len, use_kernel=False)
               for p in (params, moved)]
        for i in range(n, n + LM_GATE_STEPS + 1):
            worst = max(worst, rel_err(out[1][0], out[0][0])[1])
            if i == n + LM_GATE_STEPS:
                break
            out = [T.decode_step(p, c, t[:, i:i + 1], cfg, use_kernel=False)
                   for p, (_, c) in zip((params, moved), out)]
    return worst


def _lockstep(params, cfg, prompts, dev, frontends=None) -> float:
    """The kernel path against the plain path block by block: each block
    of the plain path takes the kernel path's input (in a decode step, a
    copy of its cache entry too, and the kernel block's expert sets), and
    the logits take the kernel path's last hidden state.  An encoder's
    blocks and ``enc_ln`` are paired the same way, and both paths' cross
    parts attend to the kernel encoder's output.  Returns the largest
    distance of a block's output or of the logits / its max |value|, over
    the prefill and LM_GATE_STEPS teacher-forced decode steps of each
    prompt: the kernels' rounding with no compounding through the
    model."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    worst = 0.0
    kinds = cfg.layer_kinds()

    def pair(kernel, plain):
        """(kernel block's output, plain block's routed as it was)."""
        MOE.route_log = routes = []
        try:
            yk = kernel()
            MOE.route_log, MOE.route_replay = None, routes
            yp = plain()
            check(not MOE.route_replay, "routes left unreplayed")
        finally:
            MOE.route_log = MOE.route_replay = None
        return yk, yp

    def last(x):
        h = [L.rmsnorm(x, params["final_ln"], use_kernel=k)
             for k in (True, False)]
        return rel_err(*(T.logits_last(params, hi, cfg) for hi in h))[1]

    for toks, front in zip(prompts, frontends or [None] * len(prompts)):
        batch, t, n, max_len = _gate_batch(cfg, toks, front, dev)
        enc_kv = [None] * len(kinds)
        if cfg.enc_dec:
            ecfg = T.encoder_config(cfg)
            e, epos = T.embed_frames(batch, cfg)
            for p, (mixer, ffn) in zip(params["enc_layers"],
                                       ecfg.layer_kinds()):
                y = [T._apply_block(e, p, ecfg, mixer, ffn, epos, False,
                                    k)[0] for k in (True, False)]
                worst, e = max(worst, rel_err(*y)[1]), y[0]
            y = [L.rmsnorm(e, params["enc_ln"], use_kernel=k)
                 for k in (True, False)]
            worst = max(worst, rel_err(*y)[1])
            enc_kv = [T.cross_kv(p, y[0], cfg) for p in params["layers"]]
        x, pos = T.embed_inputs(params, batch, cfg)
        for p, (mixer, ffn), kv in zip(params["layers"], kinds, enc_kv):
            y = pair(*(lambda k=k: T._apply_block(
                x, p, cfg, mixer, ffn, pos, True, k, enc_kv=kv)[0]
                for k in (True, False)))
            worst, x = max(worst, rel_err(*y)[1]), y[0]
        worst = max(worst, last(x))
        _, cache = T.prefill(params, batch, cfg, max_len)
        for i in range(n, n + LM_GATE_STEPS):
            pos = cache["pos"]
            x = T.embed(params["embed"], t[:, i:i + 1], cfg.dtype)
            kv_len = int(pos.max()) + 1
            for p, (mixer, ffn), entry in zip(params["layers"], kinds,
                                              cache["layers"]):
                copy = {k: v.clone() for k, v in entry.items()}
                yk, yp = pair(
                    lambda: T._decode_block(x, p, cfg, mixer, ffn, entry,
                                            pos, kv_len, True),
                    lambda: T._decode_block(x, p, cfg, mixer, ffn, copy,
                                            pos, kv_len, False))
                worst, x = max(worst, rel_err(yk, yp)[1]), yk
            worst = max(worst, last(x))
            cache["pos"] = pos + 1
    return worst


def phase_serve_family(dev, kind: str) -> dict:
    """``[serve moe]``, ``[serve ssm]``, ``[serve hybrid]``, ``[serve
    audio]``, ``[serve vlm]``: a family's model with seeded weights.
    First the kernel path against the plain path (:func:`_path_vs_plain`,
    2 prompts drawn in the phase's prompt range, behind patches or frames
    drawn with numpy from the phase's seed) in fp32 at the gate's cut
    (LM_TOL_FP32, the plain path routed by its own router and by the
    kernel path's expert sets); for xlstm also
    in fp32 at all 48 layers, ungated, beside the model's own noise
    (:func:`_noise`); then the served model in bf16: LM_TOL_BF16 block by
    block (:func:`_lockstep`) and, for FREE_BF16_GATE, on the free-running
    plain path routed by the kernel path's expert sets (its own routing's
    distance and the tokens whose expert sets differ are printed: in bf16
    a near-tie among the experts flips with the kernels' rounding; xlstm's
    free-running distance is printed beside its bf16 noise); then
    :func:`phase_serve` (launch counts set to 0 just before, the
    identities checked at every step), a profile of a prefill and of
    decode steps, and :func:`time_serve_kernels` at the run's shapes.  The
    model is freed at the end; the phase's peak device memory is
    printed."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.train.server import stub_frontend
    tag = f"[serve {kind}]"
    arch, n_requests, prompt, new, max_len = FAMILY_SERVE[kind]
    seed = SEED + 10 + list(FAMILY_SERVE).index(kind)
    rng = np.random.default_rng(seed)
    torch.cuda.reset_peak_memory_stats(dev)
    gates = {}
    runs = [(torch.float32, True, LM_TOL_FP32)]
    if kind == "ssm":     # the served xlstm in fp32: measured, not gated
        runs.append((torch.float32, False, None))
    runs.append((torch.bfloat16, False, LM_TOL_BF16))
    for dtype, gate, tol in runs:
        cfg = family_config(kind, dtype, gate)
        lo, hi = GATE_PROMPT.get(kind, prompt)
        prompts = [rng.integers(0, cfg.vocab, size=int(n) + LM_GATE_STEPS)
                   .astype(np.int64) for n in rng.integers(
                       lo, hi + 1, size=LM_GATE_REQUESTS)]
        fronts = gate_frontends(cfg, rng, LM_GATE_REQUESTS, dev)
        t0 = time.perf_counter()
        params = T.init_params(SEED, cfg, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = T.param_count(params)
        name = str(dtype).split(".")[-1]
        log(f"{tag} {arch} {name}: {cfg.n_layers} layers "
            f"{[f'{m}+{f}' for m, f in cfg.pattern]}, d_model {cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, "
            + (f"{cfg.n_experts} experts top-{cfg.moe_top_k} "
               f"({cfg.moe_impl}), " if cfg.n_experts else "")
            + (f"{cfg.n_enc_layers} encoder layers over {cfg.enc_seq} "
               f"frames, " if cfg.enc_dec else "")
            + (f"a {cfg.vision_prefix}-patch prefix, "
               if cfg.vision_prefix else "")
            + f"vocab {cfg.vocab}: {n_params / 1e9:.3f} B "
            f"parameters, seeded init {init_s:.1f} s")
        free = tol is not None and (gate or kind in FREE_BF16_GATE)
        with torch.no_grad():
            g = _path_vs_plain(params, cfg, prompts, dev, fronts)
            noise = (None if free else
                     _noise(params, cfg, prompts, dev, NOISE[name], fronts))
            step = (_lockstep(params, cfg, prompts, dev, fronts)
                    if dtype == torch.bfloat16 else None)
        gated = max(g["rel"], g["rel_same_routes"]) if gate else \
            g["rel_same_routes"]
        rule = (f"gate {tol} on {'both' if gate else 'the second'}" if free
                else f"not gated: the plain path moves {noise:.3g} itself "
                     f"when the embedding moves by {NOISE[name]:.3g} "
                     f"relative")
        log(f"{tag} {name} kernel path vs plain path, prompts "
            f"{[len(p) - LM_GATE_STEPS for p in prompts]}, prefill + "
            f"{LM_GATE_STEPS} decode steps: max |logit diff| / max |logit| "
            f"= {g['rel']:.3g} routed by each path's router, "
            f"{g['rel_same_routes']:.3g} by the kernel path's expert sets "
            f"({rule}); tokens whose expert sets differ between the paths: "
            f"{g['flipped']} of {g['routed']} routed")
        check(not free or gated <= tol, f"{tag} {name} kernel path vs "
              f"plain path: logits rel err {gated:.3g} > {tol}")
        if step is not None:
            log(f"{tag} {name} block by block (each plain block fed the "
                f"kernel path's input and cache): max |diff| / max |value| "
                f"of a block's output or the logits = {step:.3g} (gate "
                f"{tol})")
            check(step <= tol, f"{tag} {name} block by block: {step:.3g} > "
                               f"{tol}")
        key = name if gate or dtype != torch.float32 else f"{name}_served"
        gates[key] = {"layers": cfg.n_layers, "params": n_params,
                      "logits_rel_err": g["rel"],
                      "logits_rel_err_same_routes": g["rel_same_routes"],
                      "route_flips": g["flipped"],
                      "routed_tokens": g["routed"], "noise": noise,
                      "block_by_block": step, "free_gated": free}
        if dtype == torch.float32:
            del params
            torch.cuda.empty_cache()
    serve = phase_serve(dev, params, cfg, tag, arch, n_requests, prompt, new,
                        seed, max_len, FIXED_PROMPTS.get(kind, ()))
    if cfg.swa_window is not None:
        serve["ring_cases"] = ring_cases(cfg, serve["prompt_lens"], new,
                                         max_len)
        log(f"{tag} the {min(max_len, cfg.swa_window)}-slot ring caches "
            f"over the served prompts {serve['prompt_lens']}: "
            f"{serve['ring_cases']}")
        check(all(serve["ring_cases"].values()), f"{tag} the traffic missed "
              f"a ring case: {serve['ring_cases']}")
    # a prefilled position: a prompt token, or a vision prefix's patch
    per_tok = [1e3 * t / (cfg.vision_prefix + n)
               for t, n in zip(serve["prefill_s"], serve["prompt_lens"])]
    # a decode step reads every weight at least once (the dropping MoE
    # runs every expert on its capacity slots)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in _leaves(params))
    floor_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    log(f"{tag} prefill {float(np.mean(per_tok)):.3f} ms a prefilled "
        f"position (vision prefix + prompt tokens) "
        f"(mean over requests; min {min(per_tok):.3f}, max "
        f"{max(per_tok):.3f}); decode step {serve['decode_step_ms']:.3f} ms "
        f"beside its yardstick, the {weight_bytes / 1e9:.1f} GB of weights "
        f"read once at {HBM_BYTES_PER_S / 1e12:.2f} TB/s: "
        f"{floor_ms:.2f} ms")
    # where a step's time goes: the shortest prompt's prefill (behind the
    # server's zero patches or frames), and 4 decode steps of every slot
    # at that depth
    cache = T.init_cache(cfg, LM_SLOTS, max_len, device=dev)
    cache["pos"][:] = cfg.vision_prefix + prompt[0]
    toks = torch.as_tensor(np.arange(prompt[0]) % cfg.vocab,
                           device=dev)[None]
    batch = dict(stub_frontend(cfg, dev), tokens=toks)
    last = torch.zeros((LM_SLOTS, 1), dtype=torch.int64, device=dev)
    with torch.no_grad():
        profile = profile_runs({
            f"{kind} prefill {prompt[0]}": (1, lambda: T.prefill(
                params, batch, cfg, max_len)),
            f"{kind} decode_step": (4, lambda: T.decode_step(
                params, cache, last, cfg))})
    del cache, batch
    kernels, _ = time_serve_kernels(dev, cfg, serve, seed + 100, tag)
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"{tag} peak device memory {peak} bytes "
        f"({peak / 2 ** 30:.2f} GiB)")
    del params
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": cfg.n_layers,
            "pattern": [list(b) for b in cfg.pattern], "gates": gates,
            **{k: v for k, v in serve.items() if k != "prefill_s"},
            "prefill_ms_per_token": float(np.mean(per_tok)),
            "decode_floor_ms": floor_ms, "weight_bytes": weight_bytes,
            "peak_mem_bytes": peak, "profile": profile,
            "kernels": dict(kernels)}


def ring_cases(cfg, lens, new: int, max_len: int) -> dict:
    """How the served prompts meet a sliding-window model's ring caches
    (``min(max_len, window)`` slots a layer): a prompt whose decode steps
    (positions n to n + new - 2) stay inside it never wraps it, one that
    fits but whose decode passes it wraps it mid-request, and one longer
    than it makes the prefill keep its last tokens rotated."""
    c = min(max_len, cfg.swa_window)
    out = {"no_wrap": 0, "wrap_in_decode": 0, "prefill_rotates": 0}
    for n in lens:
        out["prefill_rotates" if n > c else "wrap_in_decode"
            if n + new - 2 >= c else "no_wrap"] += 1
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch next to {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    import repro_torch  # noqa: F401  (fails here, before any result)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    card = phase_card()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    build_s = phase_build()
    check_err = phase_check_kernel(dev)
    lm_check_err = phase_check_lm_kernels(dev)
    norm_bwd = phase_check_rmsnorm_backward(dev)
    from repro_torch.kernels import gemm as G
    G.gemm.launches = 0  # the main path (tune -> deploy) starts here
    rep, tune_s = phase_tune(dev)
    (launches, fwd_err, fwd_ms, plain_fwd_ms, configs,
     per_shape) = phase_deploy(dev, rep)
    episode_ms = phase_episode_time(dev)
    rows = phase_time_shapes(dev, per_shape)
    deploy16, deploy16_s = timed(lambda: phase_deploy_bf16(dev, configs))
    log(f"[deploy bf16] phase {deploy16_s:.1f} s")
    gemm16, time16_s = timed(lambda: phase_time_bf16(dev, per_shape))
    unchecked = deploy16.pop("geometries") - gemm16.pop("checked")
    check(not unchecked, f"[deploy bf16] ran geometries no check held: "
                         f"{sorted(unchecked)}")
    log(f"[time bf16] every geometry [deploy bf16] ran is among them; "
        f"phase {time16_s:.1f} s")
    baselines, base_s = timed(lambda: phase_baselines(dev, rep, tune_s))
    log(f"[baselines] phase {base_s:.1f} s")
    (coopt, netopt), net_s = timed(lambda: phase_netopt(dev))
    log(f"[netopt] phase {net_s:.1f} s")
    netopt_deploy, dep_s = timed(lambda: phase_netopt_deploy(
        dev, coopt, fwd_ms, plain_fwd_ms, rows))
    log(f"[netopt deploy] phase {dep_s:.1f} s")
    flash32 = collections.Counter()   # the fp32 gates' flash launches
    with fp32_flash_recorded(flash32):
        lm_params, lm_cfg, lm_rel32, lm_rel16 = phase_lm_gate(dev)
    serve = phase_serve(dev, lm_params, lm_cfg)   # resets the LM counts
    fabric, fab_s = timed(phase_fabric)
    log(f"[fabric] phase {fab_s:.1f} s")
    live, live_s = timed(lambda: phase_serve_live(dev, lm_params, lm_cfg))
    log(f"[serve live] phase {live_s:.1f} s")
    profile = phase_profile_serve(dev, lm_params, lm_cfg)
    lm_kernels, norm_floor = phase_time_lm_kernels(dev, lm_cfg, serve)
    del lm_params
    torch.cuda.empty_cache()
    train, train_s = timed(lambda: phase_train(dev))
    log(f"[train] phase {train_s:.1f} s")
    import torch.distributed as dist
    mesh, mesh_tmp = mesh_group()
    try:
        (sharded, *state), sharded_s = timed(
            lambda: phase_train_sharded(dev, mesh, train))
        log(f"[train sharded] phase {sharded_s:.1f} s")
        int8, int8_s = timed(lambda: phase_train_int8(dev, mesh, *state))
        log(f"[train int8] phase {int8_s:.1f} s")
        del state
        torch.cuda.empty_cache()
        serve_sh, serve_sh_s = timed(lambda: phase_serve_sharded(dev, mesh))
        log(f"[serve sharded] phase {serve_sh_s:.1f} s")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(mesh_tmp, ignore_errors=True)
    mesh_phases = {"train_sharded": sharded, "train_int8": int8,
                   "serve_sharded": serve_sh}
    faults, faults_s = timed(lambda: phase_train_faults(dev))
    log(f"[train faults] phase {faults_s:.1f} s")
    families, family_s = {}, {}
    for kind in FAMILY_SERVE:
        with fp32_flash_recorded(flash32):
            families[kind], family_s[kind] = timed(
                lambda: phase_serve_family(dev, kind))
        log(f"[serve {kind}] phase {family_s[kind]:.1f} s")
    train_audio, train_audio_s = timed(lambda: phase_train_audio(dev))
    log(f"[train audio] phase {train_audio_s:.1f} s")
    train_fam, train_fam_s = {}, {}
    for kind in FAMILY_TRAIN:
        train_fam[kind], train_fam_s[kind] = timed(
            lambda: phase_train_family(dev, kind))
        log(f"[train {kind}] phase {train_fam_s[kind]:.1f} s")
    autotune, autotune_s = timed(
        lambda: phase_autotune(dev, train["peak_mem_bytes"]))
    log(f"[autotune] phase {autotune_s:.1f} s")
    drivers, drivers_s = timed(lambda: phase_drivers(dev))
    log(f"[drivers] phase {drivers_s:.1f} s")
    check(flash32 == fp32_gate_calls(), f"the fp32 gates launched "
          f"{dict(flash32)}, not the {dict(fp32_gate_calls())} their draws "
          f"and configs give")
    flash_fp32, flash32_s = timed(lambda: phase_time_flash_fp32(dev,
                                                                flash32))
    log(f"[time flash fp32] phase {flash32_s:.1f} s")

    # one forward's GEMM work: every shape times the layers that run it
    total = lambda key: sum(r[key] * r["layers"] for r in rows)
    t_ops = sum(2.0 * r["M"] * r["N"] * r["K"] * r["layers"]
                for r in rows) / FP32_FLOPS * 1e3
    t_bytes = sum(4.0 * (r["M"] * r["K"] + r["K"] * r["N"] + r["M"] * r["N"])
                  * r["layers"] for r in rows) / HBM_BYTES_PER_S * 1e3
    log(json.dumps({"card": card, "build_s": build_s, "tune_s": tune_s,
                    "mappo_episode_ms": episode_ms, "forward_ms": fwd_ms,
                    "forward_plain_ms": plain_fwd_ms,
                    "forward_logits_max_abs_err": fwd_err,
                    "gemm_shapes": rows,
                    "baselines": baselines, "netopt": netopt,
                    "netopt_deploy": netopt_deploy,
                    "deploy_bf16": deploy16, "gemm_bf16": gemm16,
                    "flash_fp32_gates": flash_fp32,
                    "phase_s": {"deploy_bf16": deploy16_s,
                                "time_bf16": time16_s,
                                "time_flash_fp32": flash32_s,
                                "baselines": base_s, "netopt": net_s,
                                "netopt_deploy": dep_s, "fabric": fab_s,
                                "serve_live": live_s, "train": train_s,
                                "train_sharded": sharded_s,
                                "train_int8": int8_s,
                                "serve_sharded": serve_sh_s,
                                "train_faults": faults_s,
                                **{f"serve_{k}": v
                                   for k, v in family_s.items()},
                                "train_audio": train_audio_s,
                                **{f"train_{k}": v
                                   for k, v in train_fam_s.items()},
                                "autotune": autotune_s,
                                "drivers": drivers_s},
                    "train": train, "train_faults": faults,
                    **{k: {key: v for key, v in ph.items()
                           if key != "launches"}
                       for k, ph in mesh_phases.items()},
                    "train_audio": train_audio,
                    "train_families": {k: {key: v for key, v in f.items()
                                           if key != "rmsnorm_time"}
                                       for k, f in train_fam.items()},
                    "autotune": autotune,
                    "drivers": drivers,
                    "families": {k: {key: v for key, v in f.items()
                                     if key != "kernels"}
                                 for k, f in families.items()},
                    "fabric": {k: v for k, v in fabric.items()
                               if k != "stats"},
                    "serve_live": live,
                    "lm": {"arch": LM_ARCH, "dtype": "bfloat16",
                           "logits_rel_err_fp32": lm_rel32,
                           "logits_rel_err_bf16": lm_rel16,
                           "flash_vs_fp32_p_max_abs_err":
                               lm_check_err["flash_vs_fp32_p"],
                           **{k: v for k, v in serve.items()
                              if k != "launches"},
                           "profile": profile,
                           "kernels": dict(lm_kernels),
                           "rmsnorm_floor_and_host": norm_floor}}))
    sources = {"rmsnorm": "src/repro/kernels/rmsnorm.py:21",
               "flash_attention": "src/repro/kernels/flash_attention.py:29"}
    log(json.dumps({"kernels": [{
        "name": "gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gemm.cu",
        "replaces": "src/repro/kernels/gemm.py:48",
        "launches": launches,
        "max_abs_err": check_err,
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": total("library_ms"),
        "device_ms": total("device_ms"),
        "library_device_ms": total("library_device_ms"),
        "netopt_deploy_launches": netopt_deploy["launches"],
        "deploy_bf16_launches": deploy16["launches"],
        # bf16 operands (the tensor-core kernel): the forward's 17 GEMMs
        # at the tuned geometries, device time in CUDA graphs
        "bf16": {"ms": gemm16["forward"]["tuned"]["device_ms"],
                 "default_ms": gemm16["forward"]["default"]["device_ms"],
                 "plain_ms": gemm16["forward"]["tuned"]["plain_ms"],
                 "bound_ms": gemm16["forward"]["tuned"]["bound_ms"],
                 "bound_by": gemm16["forward"]["tuned"]["bound_by"],
                 "library_ms":
                     gemm16["forward"]["tuned"]["library_device_ms"],
                 "max_abs_err": max(r["max_abs_err"]
                                    for r in gemm16["rows"])},
        "drivers_launches": drivers["launches"]["gemm"],
        **{f"{k}_launches": ph["launches"]["gemm"]
           for k, ph in mesh_phases.items()},
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": sources[name],
        "launches": tot["launches"],
        "max_abs_err": lm_check_err[name],
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": tot["bound_by"],
        "library_ms": tot["library_ms"],
        "serve_live_launches": live["launches"][name],
        **{f"serve_{kind}_launches": f["launches"][name]
           for kind, f in families.items()},
        **{f"serve_{kind}": f["kernels"][name]
           for kind, f in families.items() if name in f["kernels"]},
        **({"train_launches": train["rmsnorm_launches"],
            "train_audio_launches": train_audio["rmsnorm_launches"],
            "train": dict(train["rmsnorm_time"], max_abs_err=norm_bwd[
                "forward_max_abs_err"]),
            "backward_max_abs_err": norm_bwd["backward_max_abs_err"],
            **{f"train_{k}_launches": f["rmsnorm_launches"]
               for k, f in train_fam.items()},
            **{f"train_{k}": f["rmsnorm_time"]
               for k, f in train_fam.items()}}
           if name == "rmsnorm" else {}),
        **({"fp32_gates_launches": flash_fp32["launches"],
            "fp32_gates": {k: v for k, v in flash_fp32.items()
                           if k != "shapes"}}
           if name == "flash_attention" else {}),
        "autotune_launches": autotune["launches"][name],
        "drivers_launches": drivers["launches"][name],
        **{f"{k}_launches": ph["launches"][name]
           for k, ph in mesh_phases.items()},
    } for name, tot in lm_kernels]}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(flash_fp32_main(sys.argv[2:]) if sys.argv[1:2] == ["--flash-fp32"]
             else main())
