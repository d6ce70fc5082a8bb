#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Fourteen phases; any failure exits non-zero and prints no result line.

1. Card and build: requires CUDA, prints the card's name and power limit
   (``nvidia-smi``), builds every kernel source in ``paddle_tpu_torch/csrc``
   (one ``nvcc`` each, all at once).
2. Kernels against their plain PyTorch versions on the card, bf16, at the
   Llama-2-7B main-path shapes and again at the 70B head geometry
   (Hq=64, Hkv=8, D=128): the serving shapes for the forward kernels, the
   training shapes (B=4, T=2048) for the backward kernels, AdamW and the
   flash forward once more. AdamW (elementwise fp32) is held tighter, each
   output at its own scale, and a step that writes nothing and one without
   bias corrections must fail that check. Each
   kernel's median time (CUDA events after warm-up), its plain version's
   time, its bound (bytes over 3.35 TB/s or operations over 989 TFLOP/s,
   H100 SXM data sheet) and, where one torch call computes the same
   function, that call's time (``library_ms``).
3. Serving path: Llama-2-7B (full width and depth, bf16, random weights from
   a seed) built on the card; ``generate`` of 32 new tokens for 4 prompts
   of 128 tokens, greedy. Every launch counter must have moved by exactly
   what the path implies. A decode step is timed on the host's clock and,
   replayed as a CUDA graph, on the device's. Then prefill and 8
   teacher-forced decode steps run again with the kernels and under
   ``force_reference()`` (the plain versions on the card): their logits
   must agree within limits that a control run with bf16 attention
   numerics must fail.
4. Training path: Llama-2-7B at full width, depth cut to 8 of 32 layers
   (bf16, dense head, per-block recompute, random weights from a seed),
   ``build_train_step`` with AdamW on ``warmup_cosine(3e-4, 100, 10000)``
   and ``ClipGradByGlobalNorm(1.0)``, B=4 × T=2048 of seeded ids with
   labels equal to the ids: one warm-up step and 3 timed steps (CUDA
   events), exact launch counts, peak memory. The same steps from the
   same weights run again under ``force_reference()``; loss, grad_norm,
   the first step's gradients and every parameter after the last step
   must agree within limits that a control run (the plain run with
   attention scores and probabilities rounded to bf16) must fail.
5. ``bench.py``'s training configuration at full width and depth: the
   ~0.95 B Llama (V=32000, E=2048, F=5632, 16 layers, 16 heads), bf16,
   fused LM head, ``save_mlp_dots_attn`` recompute, B=4 × T=2048 of ids
   from ``np.random.RandomState(0)`` with labels equal to the ids; AdamW
   as in phase 4; one warm-up and 3 timed steps, exact launch counts,
   peak memory, bench.py's FLOPs share, a profiled step; the same steps
   under ``force_reference()`` within limits that phase 4's
   bf16-attention control must fail, and a second control (the head's
   logits rounded to bf16, the JAX dense head's numerics) recorded.
6. GPT-3 6.7B ``generate`` (full width and depth, bf16, random weights
   from a seed), as phase 3: B=4 prompts of 128 tokens, 32 new tokens,
   greedy; exact launch counts (LayerNorm 2L + 1 per forward, flash in the
   prefill, decode attention in each later step); a decode step on the
   host's clock and as a CUDA graph; teacher-forced logits against the
   plain-version run within limits the bf16-attention control must fail.
7. GPT-3 1.3B training at full width and depth (24 layers, dense head,
   ``nothing_saveable`` recompute), B=4 × T=2048, as phase 4: exact launch
   counts, step time, tokens/s, peak memory, bench.py's FLOPs share, the
   same steps under ``force_reference()`` and the bf16-attention control.
8. ERNIE-base pretraining at full width and depth (12 layers, D=64
   non-causal attention, dropout 0.1 drawn from the training step's
   per-step generator, the same masks in every run), B=32 × T=512 packed
   sequences without ``attention_mask``, 15% of positions labelled for
   the MLM loss, seeded sentence-order labels; as phase 7.
9. mamba-0.2B ``generate`` (V=50304, E=1024, 24 layers, bf16), B=8, as
   phase 3, with ``scan_probe`` and the bf16-state control.
10. mamba-0.2B training with recompute, B=8 × T=2048, as phase 4.
11. Llama-2-7B ``generate`` with the int8 KV cache on phase 3's model and
   prompt, with the int8 decode probe.
12. Llama-2-7B served through the ``GenerationEngine``, contiguous mode:
   8 slots of 1024 positions, 16 greedy requests of 16-400 prompt tokens
   and 16-64 new tokens arriving 50 ms apart, one cancelled mid-stream;
   exact launch counts (the batched step a replayed CUDA graph that books
   its captured launches: B9 L a step), tokens/s, time to first token per
   request, peak memory, the step replayed at 8 slots; greedy tokens
   against solo ``generate``; teacher-forced logits of the batched step
   against solo forwards, within limits the bf16-attention control fails.
13. The same model through the paged engine: pages of 16 tokens, the pool
   8 × 64 pages, prefill in chunks of 256; 4 requests share a 256-token
   prefix, one prompt has 900 tokens. Exact launch counts (B10 L a step,
   B9 none), prefix hits, the pool balanced after the drain, the step as
   a graph, B10's step against ``paged_gather`` + B9's; teacher-forced
   logits against the contiguous step, the control failing.
14. The dense loss at V <= 2048: ``LlamaConfig.tiny()`` (V=256, fp32)
   training steps through ``build_train_step``: one B14 and one B15 a
   step, against the plain run, with the loss's logits rounded to bf16 as
   the control.

Phase 2 also holds the fused head's three kernels (B11-B13) against their
plain versions at the bench shape (N=8192, E=2048, V=32000), the 7B head
(E=4096) and a ragged case, and against the same bf16-logits control at
the bench shape: the forward's per-row losses and dH must tell the
kernels from the control there, since in phase 5 attention's own bf16
differences hide it (see ``PERF.md``). Planted faults (the label logit,
the one-hot term or the softmax term taken out) must fail the same
checks, and the backward as training runs it (dH and dW in one walk) is
timed and must equal the two run alone. LayerNorm (B6, B7) is checked
at GPT-3 1.3B's and ERNIE-base's training rows, GPT-3 6.7B's decode step
and a ragged shape, each output at its own scale, and planted faults (the
bias, x̂ in dw, db, the mean(w·g) term of dx taken out) must fail; flash
attention at ERNIE's D=64 non-causal shape, where the plain version with
a causal mask must fail. Each new case has its time, bound and library
time (``F.layer_norm`` and its autograd backward, SDPA), and decode
attention's row gets SDPA over the cache prefix plus the new k/v. The
selective scan (B17/B18) and the int8 decode (B9-int8) have their cases
and planted faults; B14/B15 at the dense loss's shape, at N=8192 with
V=1024 and 2048 in fp32 and bf16 and a ragged N through
``F.softmax_with_cross_entropy`` (faults: the running maximum not
rescaled, the last vocabulary block skipped, the one-hot term left out);
B10 and per-slot B9 at the engine's step (8 slots, pages of 16, mixed
positions; faults: the position pos unmasked, the page id off by one, the
fresh token dropped).

The last two lines of standard output are a JSON line of per-kernel
numbers and ``{"ok": true, "device": {...}}``. A fuller report goes to
``chiprun_out/chip_smoke_report.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

SEED = 1234
B, T0, NEW = 4, 128, 32
TEACHER_STEPS = 8
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_OPS_PER_S = 989e12          # H100 SXM data sheet, dense
FP32_OPS_PER_S = 67e12           # H100 SXM data sheet, fp32 off the tensor cores
# bf16 kernel against its plain version: output rounding (2^-8 relative)
# plus another fp32 summation order.
KERNEL_ATOL = KERNEL_RTOL = 2e-2
# Logits of the whole 7B model, kernels against plain versions. Both runs
# round every activation to bf16, at slightly different points inside the
# kernels, and 32 layers of random weights amplify those one-ulp
# differences. A control run sets the limits' upper side: the plain run
# with attention in the JAX package's einsum arms' bf16 numerics (its
# plain arms, ``paddle_tpu/nn/functional.py:599-611`` and
# ``paddle_tpu/models/_common.py:124-137``, round scores and probabilities
# to bf16; its Pallas kernels keep them in fp32 as the port's kernels and
# plain versions do). On the H100 the kernel run read max 0.326, mean
# 0.0435, min cosine 0.99866 and the control 0.602, 0.0732, 0.99452; with
# the training slice's kernel cases drawing from the generator first, the
# prompt differs and the readings are 0.352, 0.0438, 0.99854 and 0.594,
# 0.0723, 0.99577. The limits sit between the two, and the control must
# fail them, so the check tells the kernels from attention computed in
# lower precision.
LOGIT_LIMITS = (0.45, 0.06, 0.997)        # max abs, mean abs, least cosine
# Training phase: Llama-2-7B widths, depth cut to fit one 80 GB card with
# fp32 AdamW moments (32 layers need ~81 GB before any activation).
TRAIN_LAYERS, TRAIN_B, TRAIN_T, TRAIN_STEPS = 8, 4, 2048, 3
# Kernel run against the plain-version run, and a control run (the plain
# run with bf16 attention scores and probabilities, the JAX einsum arm's
# numerics) against the same. On the H100 (NVIDIA H100 80GB HBM3, 700 W)
# the kernel run read: max |Δloss| over the 4 steps 4.26e-4, step-0
# gradients' relative L2 error 0.0265 and least per-tensor cosine 0.99892,
# 0.837% of the parameters different after the last step; the control
# read 1.21e-3, 0.0568, 0.99541 and 1.285%. Each limit sits between the
# two readings, and the control must fail every one of them. Both runs
# also read the same grad_norm (5.3e-5 relative) and the same largest
# parameter difference (4.2e-5, one bf16 step of the largest weights):
# those tell nothing apart and are sanity limits the kernel run must meet.
TRAIN_LIMITS = {"loss_abs": ("<=", 8.5e-4), "grad_rel_l2": ("<=", 0.04),
                "grad_min_cosine": (">=", 0.998),
                "param_diff_share": ("<=", 0.0105)}
TRAIN_SANITY = {"grad_norm_rel": ("<=", 1e-3),
                "param_max_abs": ("<=", 2e-4)}

REPLACES = {
    "rms_norm": "paddle_tpu/ops/pallas/norm.py:78",
    "rms_norm_bwd": "paddle_tpu/ops/pallas/norm.py:102",
    "layer_norm": "paddle_tpu/ops/pallas/norm.py:212",
    "layer_norm_bwd": "paddle_tpu/ops/pallas/norm.py:256",
    "rope": "paddle_tpu/ops/pallas/rope.py:48",
    "flash_attention": "paddle_tpu/ops/pallas/flash_attention.py:128",
    "flash_attention_bwd_dq": "paddle_tpu/ops/pallas/flash_attention.py:261",
    "flash_attention_bwd_dkdv":
        "paddle_tpu/ops/pallas/flash_attention.py:261",
    "decode_attention": "paddle_tpu/ops/pallas/decode_attention.py:211",
    "adamw": "paddle_tpu/ops/pallas/adamw.py:39",
    "linear_xent_fwd": "paddle_tpu/ops/pallas/linear_xent.py:187",
    "linear_xent_dh": "paddle_tpu/ops/pallas/linear_xent.py:221",
    "linear_xent_dw": "paddle_tpu/ops/pallas/linear_xent.py:247",
    "selective_scan": "paddle_tpu/ops/pallas/selective_scan.py:112",
    "selective_scan_bwd": "paddle_tpu/ops/pallas/selective_scan.py:210",
    "decode_attention_int8": "paddle_tpu/ops/pallas/decode_attention.py:211",
    "softmax_xent_lse": "paddle_tpu/ops/pallas/softmax_xent.py:89",
    "softmax_xent_dx": "paddle_tpu/ops/pallas/softmax_xent.py:111",
    "paged_decode_attention":
        "paddle_tpu/ops/pallas/paged_decode_attention.py:175",
}
# the path whose launches the JSON line reports for each kernel: decode
# attention the serving path's, the fused head the bench path's,
# LayerNorm GPT-3 1.3B training's, the scan Mamba training's, softmax
# cross-entropy the dense loss's, paged decode attention the paged
# engine's, the rest the Llama training path's
TRAIN_KERNELS = ("rms_norm", "rms_norm_bwd", "rope", "flash_attention",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkdv",
                 "adamw")
HEAD_KERNELS = ("linear_xent_fwd", "linear_xent_dh", "linear_xent_dw")
LN_KERNELS = ("layer_norm", "layer_norm_bwd")
SCAN_KERNELS = ("selective_scan", "selective_scan_bwd")
XENT_KERNELS = ("softmax_xent_lse", "softmax_xent_dx")
# Fused head against its plain versions. Both take the same fp32 logits
# up to summation order, so the forward's fp32 lse and label logit agree
# to ~1e-5: held at 1e-3 + 1e-4·|ref|. dH and dW round dlogits and the
# result to bf16 at the same points, so an element differs by at most
# about one bf16 ulp: held at 2^-7·|ref| + 1e-3·max|ref|. Over a whole
# tensor, relative L2 error is held at HEAD_REL_L2. On the H100 (NVIDIA
# H100 80GB HBM3, 700 W) the kernels read at most 4.5e-6 (forward),
# 1.65e-4 (dH) and 2.22e-4 (dW) over the three shapes; the bf16-logits
# control at the bench shape 1.65e-3, 3.42e-4 and 2.35e-4 (and the
# forward's element check 6.5 against the kernel's 0.007). The forward's
# and dH's limits sit between, and the control must fail them: that check
# tells the kernels from bf16 head logits, which the whole step of phase 5
# cannot (below). dW's rounding differences are as large as the
# control's, so its limit is a bound on the kernel only.
HEAD_FWD_TOL = (1e-3, 1e-4, False)       # atol, rtol, atol scaled by max
HEAD_BWD_TOL = (1e-3, 2.0 ** -7, True)
HEAD_REL_L2 = {"linear_xent_fwd": 1e-4, "linear_xent_dh": 2.5e-4,
               "linear_xent_dw": 3e-4}
HEAD_CONTROL_FAILS = ("linear_xent_fwd", "linear_xent_dh")
# Phase 5: bench.py's configuration (bench.py:116-121), full depth. On the
# H100 (NVIDIA H100 80GB HBM3, 700 W) the kernel run against the plain run
# read |Δloss| 4.39e-5, gradients 0.0307 relative L2 and 0.99922 least
# cosine, 1.27% of parameters different after the last step, the same in
# every run; phase 4's bf16-attention control read 1.56e-4, 0.0385,
# 0.99874 and 1.41%. Each limit sits between the two, and that control
# must fail every one. The bf16-head-logits control (8.30e-5, 0.0129,
# 0.99987, 1.04%) passes them, as attention's own differences hide it:
# phase 2 holds the head against it.
BENCH_LAYERS, BENCH_B, BENCH_T = 16, 4, 2048
BENCH_LIMITS = {"loss_abs": ("<=", 1e-4), "grad_rel_l2": ("<=", 0.0345),
                "grad_min_cosine": (">=", 0.999),
                "param_diff_share": ("<=", 0.0134)}
# Phases 6-8 (GPT-3 6.7B generate, GPT-3 1.3B training, ERNIE-base
# pretraining). In these models the whole run cannot tell the kernels from
# bf16 attention: on the H100 (NVIDIA H100 80GB HBM3, 700 W) the
# bf16-attention control read as close to the plain run as the kernel run
# did, or closer (GPT-3 6.7B logits: kernels max 0.109, mean 0.0163,
# cosine 0.99984, control 0.133, 0.0183, 0.99981; GPT-3 1.3B gradients:
# kernels 0.0143 relative L2, cosine 0.99984, control 0.0147, 0.99983;
# ERNIE-base: kernels 0.0115, 0.99937, control 0.0113, 0.99945). Every
# bf16-level difference, a rounding flipped in a LayerNorm or in a flash
# output as much as attention's own bf16 scores, grows to the same floor
# over the layers and the backward. So the whole run is held to sanity
# limits at about twice that floor, which a wrong kernel would miss by
# far, and the control is held where it shows: ``attention_probe`` on the
# first layer's own attention inputs (PROBE_LIMITS).
GPT_LOGIT_LIMITS = (0.25, 0.035, 0.9995)
GPT_B, GPT_T = 4, 2048
GPT_TRAIN_SANITY = {"loss_abs": ("<=", 1e-3), "grad_norm_rel": ("<=", 3e-3),
                    "grad_rel_l2": ("<=", 0.03),
                    "grad_min_cosine": (">=", 0.999),
                    "param_diff_share": ("<=", 0.03),
                    "param_max_abs": ("<=", 2e-4)}
ERNIE_B, ERNIE_T = 32, 512
ERNIE_SANITY = GPT_TRAIN_SANITY
# Attention on the path's own inputs, relative L2 error against the plain
# version: the kernels' outputs differ from the plain versions' only where
# another fp32 summation order flips a bf16 rounding; the bf16-attention
# control rounds every score and probability. On the H100 the kernels
# read at most 4.8e-5 (flash o), 1.2e-4 (dq, dk, dv) and 1.6e-6 (decode o)
# over phases 6-8, the control at least 7.9e-4 (ERNIE's flash o), 2.0e-3
# (ERNIE's dv) and 8.5e-3 (decode o). Each limit sits at least twice away
# from both.
PROBE_LIMITS = {"flash o": 3e-4, "flash dq": 1e-3, "flash dk": 1e-3,
                "flash dv": 1e-3, "decode o": 3e-4, "decode int8 o": 3e-4}
# Phases 9-10 (Mamba-0.2B, bench_extra.py:78-85 and :355-364: V=50304,
# E=1024, 24 layers, bf16; Ei=2048, N=16). The whole run's differences
# from the plain run are bf16 rounding flips in the GEMMs and norms. On
# the H100 (NVIDIA H100 80GB HBM3, 700 W) the kernel run read: logits max
# 0.0879, mean 0.00621, cosine 0.99956; training |Δloss| 1.30e-4,
# grad-norm 3.44e-5 relative, gradients 0.0269 relative L2 and 0.99924
# least cosine, parameters 4.0e-5 max and 0.70% different. The
# bf16-state control (the plain scan with its state rounded to bf16
# after every step) read 0.133, 0.0172, 0.99908; 3.49e-4, 8.54e-5,
# 0.0507, 0.99708, 4.2e-5 and 0.80%. Where the control reads at least
# 1.6× the kernels (all but the logits' max and the parameters), the
# limit is the geometric mean of the two readings (1.37-1.96× the
# kernels'; the training control must fail these); elsewhere it is twice
# the kernels' reading. The scan kernels are held where they show best, by
# ``scan_probe`` on the first layer's own scan inputs and output
# gradient: the kernels and plain versions run the same fp32 recurrence
# (another exp, other summation orders) and read 1.7e-8-8.2e-7 relative
# L2, the control 3.2e-4-3.1e-3; the limit lies between.
MAMBA_SERVE_B, MAMBA_B, MAMBA_T = 8, 8, 2048
MAMBA_LOGIT_LIMITS = (0.176, 0.0104, 0.99937)
MAMBA_TRAIN_LIMITS = {"loss_abs": ("<=", 2.1e-4),
                      "grad_norm_rel": ("<=", 5.4e-5),
                      "grad_rel_l2": ("<=", 0.037),
                      "grad_min_cosine": (">=", 0.9985)}
MAMBA_TRAIN_SANITY = {"param_max_abs": ("<=", 8e-5),
                      "param_diff_share": ("<=", 0.014)}
SCAN_PROBE_LIMIT = 1e-4
# Phase 11 (Llama-2-7B with the int8 KV cache): the int8 decode kernel and
# its plain version round the same probabilities to bf16 (csrc/
# decode_attention.cu), so the whole run is held to phase 3's limits as a
# bound on the kernel, and the probe ("decode int8 o") against the JAX
# einsum arm's numerics (k and v dequantized to bf16) tells them apart.
INT8_LOGIT_LIMITS = LOGIT_LIMITS
# Phases 12-13 (Llama-2-7B served through the GenerationEngine): 8 slots of
# 1024 positions, 16 greedy requests of 16-400 prompt tokens and 16-64 new
# tokens from np.random.RandomState(0), arriving ENGINE_GAP_S apart, one
# cancelled mid-stream; the paged engine on pages of 16 tokens, a pool of
# slots × ceil(max_len / 16) pages, prefill in chunks of 256, with 4
# requests sharing a 256-token prefix and one 900-token prompt. Teacher-
# forced logits of the engine's batched step (8 slots, prefill and
# TEACHER_STEPS steps) are held against solo forwards (contiguous) and
# against the contiguous step (paged) within ENGINE_LOGIT_LIMITS, which
# the bf16-attention control must fail.
ENGINE_SLOTS, ENGINE_MAX_LEN, ENGINE_PAGE, ENGINE_CHUNK = 8, 1024, 16, 256
ENGINE_REQUESTS, ENGINE_GAP_S = 16, 0.05
ENGINE_LOGIT_LIMITS = LOGIT_LIMITS
# Phase 2's B10 and per-slot B9 cases: the engine's decode step at 8 slots
# with mixed fill positions (0, a partial last page, full pages, the
# table's end), Llama-2-7B heads, a walk over ENGINE_CASE_LAYERS layers
# of the pool so that the timed reads come from HBM.
ENGINE_POS = (0, 5, 16, 17, 250, 511, 800, 1023)
ENGINE_CASE_LAYERS = 8
# B14/B15 against their plain versions: both compute in fp32 from the same
# inputs (bf16 logits are exact in fp32), so lse and the fp32 gradient
# agree to fp32 summation order (1e-5 of the largest value plus 1e-5 of
# each), and a bf16 gradient to its own rounding (2^-8 of each value plus
# 1e-3 of the largest). Planted faults must fail the same checks.
XENT_TOL = {"lse": (1e-5, 1e-5), "dx float32": (1e-5, 1e-5),
            "dx bfloat16": (1e-3, 2.0 ** -8)}
# Phase 14: the dense loss at V <= 2048 (B14/B15) on LlamaConfig.tiny()
# at head_dim 64 (V = 256, fp32), B × T = DENSE_B × DENSE_T, TRAIN_STEPS
# steps of build_train_step. Kernel run against the plain run; the control
# is the plain run with the loss's logits rounded to bf16 before B14/B15's
# plain versions (a lower-precision loss; the bf16-attention control does
# not apply at fp32, where its einsum arm computes in fp32). On the H100
# (NVIDIA H100 80GB HBM3, 700 W) the kernel run read |Δloss| 0, gradients
# 5.45e-7 relative L2, parameters 1.08e-7 max; the control 1.9e-6,
# 1.15e-4 and 7.4e-6. Each limit sits between the two (the geometric mean
# where the kernels read above 0), and the control must fail every one.
DENSE_B, DENSE_T = 8, 128
DENSE_LIMITS = {"loss_abs": ("<=", 4e-7), "grad_rel_l2": ("<=", 8e-6),
                "param_max_abs": ("<=", 9e-7)}
DENSE_SANITY = {"grad_min_cosine": (">=", 0.99999),
                "grad_norm_rel": ("<=", 1e-5)}


LOG_PATH = os.path.join("chiprun_out", "chip_smoke.log")


def log(*a):
    """Print, and keep the line in chiprun_out/chip_smoke.log (the whole
    run's log, which the end of standard output may not hold)."""
    print(*a, flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(LOG_PATH, "a") as f:
        print(*a, file=f)


def time_ms(fn, reps: int = 7, inner: int = 20) -> float:
    """Device time of one call: ``inner`` calls captured into a CUDA graph,
    the median over ``reps`` replays timed with CUDA events, divided by
    ``inner``. The graph takes the host's launch cost out, so a small
    kernel's time is its own and not Python's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                     # warm-up
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def time_ms_eager(fn, reps: int = 5, inner: int = 3) -> float:
    """Device time of one call without a CUDA graph (for calls that run
    autograd or allocate per call, and whose kernels take long enough
    that the host's launch cost stays hidden): CUDA events around
    ``inner`` calls, median over ``reps``, divided by ``inner``."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def device_profile(fn) -> dict:
    """``fn()`` under ``torch.profiler``: the wall time, the device time
    summed over kernels, their ratio, and the 12 kernels that took the
    most device time (name, µs)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    totals: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            totals[e.name] = totals.get(e.name, 0.0) + us
    device_us = sum(totals.values())
    by_kernel = sorted(totals.items(), key=lambda kv: -kv[1])
    return {"wall_us": wall_us, "device_us": device_us,
            "device_busy_share": device_us / wall_us if device_us else None,
            "top": [[k[:60], us] for k, us in by_kernel[:12]]}


def bound(nbytes: float, ops: float, ops_rate: float = BF16_OPS_PER_S):
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the operations over ``ops_rate`` (the peak
    for their type), and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def einsum_arm_attention(q, k, v, *, causal=True, scale=None,
                         return_lse=False):
    """The JAX plain arm's bf16 numerics (nn/functional.py:594-611). Its
    lse is a placeholder (zeros): the controls' backward recomputes from
    q, k and v and does not read it."""
    B_, Tq, H_, _ = q.shape
    G = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        Tk = k.shape[1]
        mask = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril(
            Tk - Tq)
        s = s.masked_fill(~mask, torch.finfo(s.dtype).min)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    if return_lse:
        return o, torch.zeros(B_, H_, Tq, device=q.device)
    return o


def einsum_arm_decode(q, k_new, v_new, cache, layer, index, *, scale=None):
    """The JAX einsum decode arm's bf16 numerics (_common.py:122-137), at
    one index for the batch or at a per-row [B] index (the positions from
    each row's index on masked)."""
    Bq, T, Hq, D = q.shape
    Hkv = k_new.shape[1]
    per_row = isinstance(index, torch.Tensor)
    stop = None if per_row else index
    kc = cache[0][layer, :, :, :stop]
    vc = cache[1][layer, :, :, :stop]
    S = kc.shape[2]
    qh = q.permute(0, 2, 1, 3).reshape(Bq, Hkv, Hq // Hkv, T, D)
    s_c = (torch.einsum("bkgtd,bksd->bkgts", qh, kc) * scale).float()
    if per_row:
        keep = (torch.arange(S, device=q.device)[None]
                < index.long()[:, None])
        s_c = s_c.masked_fill(~keep[:, None, None, None], -math.inf)
    s_n = (torch.einsum("bkgtd,bkud->bkgtu", qh, k_new) * scale).float()
    p = torch.softmax(torch.cat([s_c, s_n], dim=-1), dim=-1).to(q.dtype)
    out = (torch.einsum("bkgts,bksd->bkgtd", p[..., :S], vc)
           + torch.einsum("bkgtu,bkud->bkgtd", p[..., S:], v_new))
    return out.reshape(Bq, Hq, T, D).permute(0, 2, 1, 3)


def einsum_arm_decode_int8(q, k_new, v_new, cache, layer, index, *,
                           scale=None):
    """The JAX einsum decode arm on the int8 cache (_common.py:121-137): k
    and v dequantized to q's type (the scales rounded to it too), then the
    float arm's bf16 numerics."""
    k_q, v_q, k_s, v_s = cache
    dt = q.dtype
    stop = None if isinstance(index, torch.Tensor) else index
    kc = k_q[layer, :, :, :stop].to(dt) * k_s[layer, :, :, :stop].to(
        dt)[..., None]
    vc = v_q[layer, :, :, :stop].to(dt) * v_s[layer, :, :, :stop].to(
        dt)[..., None]
    return einsum_arm_decode(q, k_new, v_new, (kc[None], vc[None]), 0, index,
                             scale=scale)


def control_attention_bwd(q, k, v, o, lse, do, *, causal=True, scale=None):
    """Autograd of the bf16 einsum arm, recomputed from q, k, v."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = einsum_arm_attention(*leaves, causal=causal, scale=scale)
        return torch.autograd.grad(out, leaves, do)


@contextlib.contextmanager
def bf16_attention(decode: bool = False):
    """The control: the plain versions of attention (and, with ``decode``,
    of decode attention, float and int8 caches) replaced by the JAX einsum
    arms' bf16 numerics."""
    from paddle_tpu_torch.kernels import decode_attention as DA
    from paddle_tpu_torch.kernels import flash_attention as FA
    saved = (FA.flash_attention_reference, FA.flash_attention_bwd_reference,
             DA.decode_attention_reference,
             DA.decode_attention_int8_reference)
    FA.flash_attention_reference = einsum_arm_attention
    FA.flash_attention_bwd_reference = control_attention_bwd
    if decode:
        DA.decode_attention_reference = einsum_arm_decode
        DA.decode_attention_int8_reference = einsum_arm_decode_int8
    try:
        yield
    finally:
        (FA.flash_attention_reference, FA.flash_attention_bwd_reference,
         DA.decode_attention_reference,
         DA.decode_attention_int8_reference) = saved


def _bf16_steps(h, dA, dBu):
    """The states after each step of a chunk from ``h`` before it, each
    rounded to bf16: [B, k, Ei, N]."""
    hs = []
    for i in range(dA.shape[1]):
        h = (dA[:, i] * h + dBu[:, i]).bfloat16().float()
        hs.append(h)
    return torch.stack(hs, 1)


def bf16_state_scan(u, delta, A, B, C, D, initial_state=None):
    """The scan control's forward: ``SS.selective_scan_reference`` (the
    same chunks and operations) with the state rounded to bf16 after
    every step. Returns ``(y, h_T)``."""
    from paddle_tpu_torch.kernels import selective_scan as SS
    nb, T, Ei = u.shape
    h = (torch.zeros(nb, Ei, A.shape[1], device=u.device)
         if initial_state is None else initial_state)
    ys = []
    for t0 in range(0, T, SS.PLAIN_CHUNK):
        sl = slice(t0, t0 + SS.PLAIN_CHUNK)
        hs = _bf16_steps(h, *SS._chunk_coeffs(u, delta, A, B, sl))
        h = hs[:, -1]
        ys.append(torch.einsum("btin,btn->bti", hs, C[:, sl]))
    return torch.cat(ys, 1) + u * D, h


def bf16_state_scan_bwd(u, delta, A, B, C, dy, initial_state=None,
                        dh_last=None):
    """The scan control's backward: the reverse adjoint of
    ``SS.selective_scan_bwd_reference`` (the same chunks and operations)
    with the recomputed state and the adjoint g rounded to bf16 after
    every step. Returns ``(du, dΔ, dA_part, dB, dC, dh0)``."""
    from paddle_tpu_torch.kernels import selective_scan as SS
    nb, T, Ei = u.shape
    k = SS.PLAIN_CHUNK
    zero = torch.zeros(nb, Ei, A.shape[1], device=u.device)
    h = zero if initial_state is None else initial_state
    m = zero if dh_last is None else dh_last
    bounds = []
    for t0 in range(0, T, k):
        bounds.append((t0, h))
        h = _bf16_steps(h, *SS._chunk_coeffs(u, delta, A, B,
                                             slice(t0, t0 + k)))[:, -1]
    du, ddt = torch.empty_like(u), torch.empty_like(u)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA_part = zero.clone()
    for t0, hb in reversed(bounds):
        sl = slice(t0, t0 + k)
        dA, dBu = SS._chunk_coeffs(u, delta, A, B, sl)
        hpost = _bf16_steps(hb, dA, dBu)
        hprev = torch.cat([hb[:, None], hpost[:, :-1]], 1)
        dl, uu, dyc, Bc, Cc = (x[:, sl] for x in (delta, u, dy, B, C))
        gs = [None] * dl.shape[1]
        for i in reversed(range(dl.shape[1])):
            gs[i] = (Cc[:, i, None, :] * dyc[:, i, :, None]
                     + m).bfloat16().float()
            m = dA[:, i] * gs[i]
        gs = torch.stack(gs, 1)
        s1 = (gs * Bc[:, :, None, :]).sum(-1)
        du[:, sl] = dl * s1
        gdh = gs * dA * hprev
        ddt[:, sl] = (gdh * A).sum(-1) + uu * s1
        dB[:, sl] = (gs * (dl * uu)[..., None]).sum(2)
        dC[:, sl] = (hpost * dyc[..., None]).sum(2)
        dA_part += (gdh * dl[..., None]).sum(1)
    return du, ddt, dA_part, dB, dC, m


@contextlib.contextmanager
def bf16_state():
    """The scan's whole-run control: the plain versions replaced by
    ``bf16_state_scan`` and ``bf16_state_scan_bwd``."""
    from paddle_tpu_torch.kernels import selective_scan as SS
    saved = SS.selective_scan_reference, SS.selective_scan_bwd_reference
    SS.selective_scan_reference = bf16_state_scan
    SS.selective_scan_bwd_reference = bf16_state_scan_bwd
    try:
        yield
    finally:
        SS.selective_scan_reference, SS.selective_scan_bwd_reference = saved


def compare_logits(got, want):
    diff = (got - want).abs()
    return {"max_abs": diff.max().item(), "mean_abs": diff.mean().item(),
            "min_cosine": torch.nn.functional.cosine_similarity(
                got.flatten(0, 1), want.flatten(0, 1), dim=-1
            ).min().item(),
            "finite": bool(torch.isfinite(got).all())}


def logits_within(r, limits):
    """``limits`` = (max_abs, mean_abs, min_cosine)."""
    return (r["finite"] and r["max_abs"] <= limits[0]
            and r["mean_abs"] <= limits[1] and r["min_cosine"] >= limits[2])


def compare_runs(a, r):
    """Training run ``a`` against the plain-version run ``r``."""
    gd = gr = 0.0
    cos, pmax, pdiff, total = 1.0, 0.0, 0, 0
    for n, g in r["grads"].items():
        ga, gf = a["grads"][n].float(), g.float()
        gd += (ga - gf).square().sum().item()
        gr += gf.square().sum().item()
        if gf.norm().item() > 0:       # e.g. the pooler without an SOP loss
            cos = min(cos, torch.nn.functional.cosine_similarity(
                ga.flatten(), gf.flatten(), dim=0).item())
        pa, pr = a["params"][n], r["params"][n]
        pmax = max(pmax, (pa.float() - pr.float()).abs().max().item())
        pdiff += (pa != pr).sum().item()
        total += pr.numel()
    return {"loss_abs": max(abs(x - y) for x, y in zip(a["loss"], r["loss"])),
            "grad_norm_rel": max(abs(x - y) / y for x, y in
                                 zip(a["grad_norm"], r["grad_norm"])),
            "grad_rel_l2": math.sqrt(gd / gr), "grad_min_cosine": cos,
            "param_max_abs": pmax, "param_diff_share": pdiff / total}


def passed(reading, limits):
    """The names of the ``limits`` that ``reading`` meets."""
    return [k for k, (op, lim) in limits.items()
            if (reading[k] <= lim if op == "<=" else reading[k] >= lim)]


def _rel_l2(got, want):
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


@contextlib.contextmanager
def recording_attention(seen):
    """Record into ``seen`` the first flash call's inputs (``q``, ``k``,
    ``v``, ``causal``, ``scale``) and the gradient that reaches its output
    (``do``), and the first decode call's inputs (``decode``), on the
    path's own activations."""
    from paddle_tpu_torch.kernels import decode_attention as DA
    from paddle_tpu_torch.kernels import flash_attention as FA
    flash, decode = FA.flash_attention, DA.decode_attention

    def flash_rec(q, k, v, *, causal=True, scale=None, return_lse=False):
        out = flash(q, k, v, causal=causal, scale=scale,
                    return_lse=return_lse)
        if "q" not in seen:
            seen.update(q=q.detach(), k=k.detach(), v=v.detach(),
                        causal=causal, scale=scale)
            o = out[0] if return_lse else out
            if o.requires_grad:
                o.register_hook(lambda g: seen.setdefault("do", g.detach()))
        return out

    def decode_rec(q, k_new, v_new, cache, layer, index, *, scale=None):
        seen.setdefault("decode", (q, k_new, v_new, cache, layer, index,
                                   scale))
        return decode(q, k_new, v_new, cache, layer, index, scale=scale)

    FA.flash_attention, DA.decode_attention = flash_rec, decode_rec
    try:
        yield seen
    finally:
        FA.flash_attention, DA.decode_attention = flash, decode


def attention_probe(key, seen, run):
    """The attention kernels on the inputs ``recording_attention`` saw
    (the first layer's q, k, v and output gradient; the first decode
    step's query, new k/v and cache), each output's relative L2 error
    against the plain version's, beside the bf16-attention control's
    (the JAX einsum arms' numerics). Every kernel reading must stay within
    PROBE_LIMITS and every control reading must exceed them. Launches
    made here are not counted: the path's counts were read before."""
    from paddle_tpu_torch.kernels import decode_attention as DA
    from paddle_tpu_torch.kernels import flash_attention as FA
    readings = {}
    if "q" in seen:
        q, k, v = seen["q"], seen["k"], seen["v"]
        kw = dict(causal=seen["causal"], scale=seen["scale"])
        o, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
        want = FA.flash_attention_reference(q, k, v, **kw)
        ctrl = einsum_arm_attention(q, k, v, **kw)
        readings["flash o"] = (_rel_l2(o, want), _rel_l2(ctrl, want))
        if "do" in seen:
            do = seen["do"].contiguous()
            got = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            want = FA.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                    **kw)
            ctrl = control_attention_bwd(q, k, v, o, lse, do, **kw)
            for name, a, b, c in zip(("dq", "dk", "dv"), got, want, ctrl):
                readings[f"flash {name}"] = (_rel_l2(a, b), _rel_l2(c, b))
    if "decode" in seen:
        q, kn, vn, cache, layer, index, scale = seen["decode"]
        scale = scale or 1.0 / math.sqrt(q.shape[-1])
        int8 = len(cache) == 4
        plain, ctrl_fn = ((DA.decode_attention_int8_reference,
                           einsum_arm_decode_int8) if int8 else
                          (DA.decode_attention_reference, einsum_arm_decode))
        want = plain(q, kn, vn, cache, layer, index, scale=scale)
        readings["decode int8 o" if int8 else "decode o"] = (
            _rel_l2(DA.decode_attention(q, kn, vn, cache, layer, index,
                                        scale=scale), want),
            _rel_l2(ctrl_fn(q, kn, vn, cache, layer, index, scale=scale),
                    want))
    torch.cuda.synchronize()
    out = {name: {"kernel": kr, "control": cr, "limit": PROBE_LIMITS[name]}
           for name, (kr, cr) in readings.items()}
    log(f"{key} attention probe (relative L2 against the plain version; "
        f"kernel, bf16-attention control, limit): {out}")
    for name, r in out.items():
        if not r["kernel"] <= r["limit"]:
            run.failures.append(f"{key} probe {name}: kernel {r['kernel']} "
                                f"> {r['limit']}")
        if r["control"] <= r["limit"]:
            run.failures.append(f"{key} probe {name}: the bf16-attention "
                                f"control {r['control']} passes "
                                f"{r['limit']}")
    return out


def attention_serve_probe(key, model, prompt, seq, cache_dtype, run):
    """``attention_probe`` on the prefill's and the first decode step's own
    attention inputs."""
    seen = {}
    with recording_attention(seen):
        cache = model.init_cache(prompt.shape[0], T0 + NEW, dtype=cache_dtype)
        _, cache = model.forward_with_cache(prompt, cache, 0)
        model.forward_with_cache(seq[:, T0:T0 + 1], cache, T0)
    return attention_probe(key, seen, run)


@contextlib.contextmanager
def recording_scan(seen):
    """Record into ``seen`` the first selective scan's inputs (``args``:
    u, delta, A, B, C, D; ``h0``) and the gradient that reaches its output
    (``dy``), on the path's own activations."""
    from paddle_tpu_torch.kernels import selective_scan as SS
    scan = SS.selective_scan

    def rec(u, delta, A, B, C, D, *, initial_state=None, return_state=False):
        out = scan(u, delta, A, B, C, D, initial_state=initial_state,
                   return_state=return_state)
        if "args" not in seen:
            seen["args"] = tuple(t.detach() for t in (u, delta, A, B, C, D))
            seen["h0"] = (None if initial_state is None
                          else initial_state.detach())
            y = out[0] if return_state else out
            if y.requires_grad:
                y.register_hook(lambda g: seen.setdefault("dy", g.detach()))
        return out

    SS.selective_scan = rec
    try:
        yield seen
    finally:
        SS.selective_scan = scan


def scan_probe(key, seen, run, backward=True):
    """The scan kernels on the inputs ``recording_scan`` saw (the first
    layer's u, Δ, A, B, C, D and state; with ``backward``, its output
    gradient ``dy`` too, which must have been seen), each output's
    relative L2 error against the plain version's, beside the bf16-state
    control's. Every kernel reading must stay within SCAN_PROBE_LIMIT and
    every control reading must exceed it. Launches made here are not
    counted: the path's counts were read before."""
    from paddle_tpu_torch.kernels import selective_scan as SS
    args, h0 = seen["args"], seen["h0"]
    readings = {}
    got = SS.selective_scan(*args, initial_state=h0, return_state=True)
    want = SS.selective_scan_reference(*args, h0)
    ctrl = bf16_state_scan(*args, h0)
    for name, a, b, c in zip(("y", "h_T"), got, want, ctrl):
        readings[f"scan {name}"] = (_rel_l2(a, b), _rel_l2(c, b))
    if backward and "dy" not in seen:
        run.failures.append(f"{key} probe: the first layer's scan saw no "
                            "output gradient; the backward went unprobed")
    elif backward:
        dy = seen["dy"].float().contiguous()
        hsave = SS._fwd_kernel(*args, h0, save=True)[1]
        got = SS._bwd_kernel(*args[:5], hsave, dy)
        want = SS.selective_scan_bwd_reference(*args[:5], dy, h0)
        ctrl = bf16_state_scan_bwd(*args[:5], dy, h0)
        for name, a, b, c in zip(("du", "ddelta", "dA", "dB", "dC"), got,
                                 want, ctrl):
            readings[f"scan {name}"] = (_rel_l2(a, b), _rel_l2(c, b))
    torch.cuda.synchronize()
    out = {name: {"kernel": kr, "control": cr, "limit": SCAN_PROBE_LIMIT}
           for name, (kr, cr) in readings.items()}
    log(f"{key} scan probe (relative L2 against the plain version; kernel, "
        f"bf16-state control, limit): {out}")
    for name, r in out.items():
        if not r["kernel"] <= r["limit"]:
            run.failures.append(f"{key} probe {name}: kernel {r['kernel']} "
                                f"> {r['limit']}")
        if r["control"] <= r["limit"]:
            run.failures.append(f"{key} probe {name}: the bf16-state control "
                                f"{r['control']} passes {r['limit']}")
    return out


def scan_serve_probe(key, model, prompt, seq, cache_dtype, run):
    """``scan_probe`` on the prefill's first scan."""
    seen = {}
    with recording_scan(seen):
        model.forward_with_cache(prompt, model.init_cache(prompt.shape[0]),
                                 0)
    return scan_probe(key, seen, run, backward=False)


def serve_phase(key, title, model, prompt, expected, limits, run, *,
                probe=None, control=None, cache_dtype=None, state_bytes=0):
    """``generate`` of NEW tokens after ``prompt`` [B, T0] on ``model``
    with the launch counters at 0 just before: every counter must end at
    ``expected`` (0 where not named) and the output must be well formed.
    Then prefill and decode times on the host's clock, a decode step
    replayed as a CUDA graph, a profile of 4 decode steps, and the
    teacher-forced logits (prefill and TEACHER_STEPS decode steps) of the
    kernels against the plain versions on the card, within ``limits``
    (max abs, mean abs, least cosine) that the bf16-attention control
    must fail. With ``probe`` (``probe(key, model, prompt, seq,
    cache_dtype, run)``: ``attention_serve_probe``, ``scan_serve_probe``)
    the limits bound the kernel run only, and the control must fail the
    probe on the path's own inputs instead. ``control`` (a context
    manager factory) defaults to the bf16-attention control;
    ``cache_dtype`` goes to ``generate`` and ``init_cache``;
    ``state_bytes`` (a decode step's state read and written besides the
    weights) joins the decode bound. Returns the launch counts and the
    generated tokens."""
    from paddle_tpu_torch.kernels import _support
    failures, report = run.failures, run.report
    B = prompt.shape[0]
    V = model.config.vocab_size
    control_ctx = control or (lambda: bf16_attention(decode=True))
    model.generate(prompt[:, :16], 2, cache_dtype=cache_dtype)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _support.reset_launches()
    t = time.perf_counter()
    seq = model.generate(prompt, NEW, cache_dtype=cache_dtype)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    launches = dict(_support.LAUNCHES)
    want_counts = dict.fromkeys(_support.KERNELS, 0)
    want_counts.update(expected)
    log(f"{key} launches {launches} expected {want_counts}")
    if launches != want_counts:
        failures.append(f"{key} launch counts {launches} != {want_counts}")
    if tuple(seq.shape) != (B, T0 + NEW) or not torch.equal(
            seq[:, :T0], prompt) or not bool(((seq >= 0) & (seq < V)).all()):
        failures.append(f"{key}: generate output malformed: "
                        f"{tuple(seq.shape)}")

    # step times, on the warmed model
    cache = model.init_cache(B, T0 + NEW, dtype=cache_dtype)
    torch.cuda.synchronize()
    t = time.perf_counter()
    model.forward_with_cache(prompt, cache, 0)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    for i in range(NEW - 1):
        model.forward_with_cache(seq[:, T0 + i:T0 + i + 1], cache, T0 + i)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3 / (NEW - 1)
    # the same step on the device's clock: 4 steps at index T0 captured
    # into a CUDA graph and replayed, so the host's launch cost is out and
    # the number does not move with the host's load as the one above does
    step_tok = seq[:, T0:T0 + 1]
    decode_graph_ms = time_ms(
        lambda: model.forward_with_cache(step_tok, cache, T0), inner=4)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    out = report[key] = {
        "model": f"{title} (random weights, seed {SEED})",
        "batch": B, "prompt": T0, "new_tokens": NEW,
        "generate_s": gen_s, "tokens_per_s": B * NEW / gen_s,
        "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "decode_graph_ms_per_step": decode_graph_ms,
        "decode_bound_ms": (weight_bytes + state_bytes) / HBM_BYTES_PER_S
        * 1e3, "cache_dtype": str(cache_dtype),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "card": run.card}
    log(f"{key} ({title}) on {run.card}: generate {gen_s * 1e3:.1f} ms "
        f"({B * NEW / gen_s:.1f} tokens/s), prefill {prefill_ms:.2f} ms, "
        f"decode {decode_ms:.3f} ms/step on the host's clock, "
        f"{decode_graph_ms:.3f} ms/step replayed as a CUDA graph "
        f"(weights{' and state' if state_bytes else ''} bound "
        f"{out['decode_bound_ms']:.3f} ms)")

    # where a decode step's time goes: torch.profiler over 4 steps
    def four_steps():
        for i in range(4):
            model.forward_with_cache(seq[:, T0 + i:T0 + i + 1], cache, T0 + i)
    prof = out["decode_profile"] = {"steps": 4, **device_profile(four_steps)}
    log(f"{key} decode profile (4 steps): wall {prof['wall_us']:.0f} us, "
        f"device {prof['device_us']:.0f} us, top {prof['top'][:6]}")
    del cache

    # teacher-forced logits, kernels against plain versions
    def teacher(reference: bool):
        ctx = (_support.force_reference() if reference
               else contextlib.nullcontext())
        with ctx:
            cache = model.init_cache(B, T0 + NEW, dtype=cache_dtype)
            logits, cache = model.forward_with_cache(prompt, cache, 0)
            outs = [logits.float()]
            for i in range(TEACHER_STEPS):
                logits, cache = model.forward_with_cache(
                    seq[:, T0 + i:T0 + i + 1], cache, T0 + i)
                outs.append(logits.float())
        return torch.cat(outs, dim=1)

    want = teacher(True)
    got = teacher(False)
    with control_ctx():
        control = compare_logits(teacher(True), want)
    res = compare_logits(got, want)
    out["logits"] = {"kernels_vs_plain": res, "control": control,
                     "limits": dict(zip(("max_abs", "mean_abs",
                                         "min_cosine"), limits)),
                     "ref_max_abs": want.abs().max().item(),
                     "shape": list(got.shape)}
    log(f"{key} logits kernels vs plain: {res}; control (the plain run "
        f"in lower precision): {control}; limits "
        f"max_abs <= {limits[0]}, mean_abs <= {limits[1]}, cosine >= "
        f"{limits[2]}")
    if not (torch.isfinite(want).all() and logits_within(res, limits)):
        failures.append(f"{key}: logits disagree: {out['logits']}")
    if probe is not None:
        out["probe"] = probe(key, model, prompt, seq, cache_dtype, run)
    elif logits_within(control, limits):
        failures.append(f"{key}: logits check cannot tell the kernels from "
                        f"bf16 attention: the control passes it {control}")
    return launches, seq


def train(make_model, batch, kernels: bool):
    """A warm-up step and TRAIN_STEPS timed steps of ``make_model()`` on
    ``batch`` from its seeded weights; the kernels, or (``kernels=False``)
    the plain versions. The training step seeds each step's dropout
    stream the same in every run. The kernel run then profiles one more
    step, after everything it reports was read."""
    from paddle_tpu_torch import optimizer as optim
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.kernels import _support
    from paddle_tpu_torch.optimizer.lr import warmup_cosine
    ctx = (contextlib.nullcontext() if kernels
           else _support.force_reference())
    with ctx:
        model = make_model()
        step = fleet.build_train_step(model, optim.AdamW(
            warmup_cosine(3e-4, 100, 10000),
            grad_clip=optim.ClipGradByGlobalNorm(1.0)))
        state = step.init_state(model)
        out = {"loss": [], "grad_norm": [], "step_ms": [], "host_ms": [],
               "n_tensors": len(list(model.parameters())),
               "n_params": sum(p.numel() for p in model.parameters())}
        for i in range(1 + TRAIN_STEPS):
            if i == 1:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _support.reset_launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            state, metrics = step(state, batch)
            end.record()
            end.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            out["loss"].append(metrics["loss"].item())
            out["grad_norm"].append(metrics["grad_norm"].item())
            if i == 0:
                # the schedule's first learning rate is 0, so every run
                # takes these (clipped) gradients at the same weights
                out["grads"] = {n: p.grad.detach().clone()
                                for n, p in model.named_parameters()}
            else:
                out["step_ms"].append(start.elapsed_time(end))
                out["host_ms"].append(host_ms)
        out["launches"] = dict(_support.LAUNCHES)
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["params"] = {n: p.detach().clone()
                         for n, p in model.named_parameters()}
        if kernels:
            out["profile"] = device_profile(lambda: step(state, batch))
    del state, step, model, metrics
    torch.cuda.empty_cache()
    return out


def train_phase(key, title, make_model, batch, per_step, limits, run, *,
                expected_loss, n_params, hidden, n_layers, extra_controls=(),
                sanity=None, probe=None,
                control=("attention control", bf16_attention)):
    """TRAIN_STEPS timed steps with the kernels (counters at 0 just
    before; every one must end at TRAIN_STEPS × ``per_step``, 0 where not
    named), the same steps under ``force_reference()`` and under
    ``control`` (name, context manager factory; default the
    bf16-attention control). The kernel run must meet ``limits`` and
    ``sanity`` (default TRAIN_SANITY) against the plain run, and the
    control must fail every one of ``limits``; ``extra_controls`` (name →
    context manager factory) are recorded only. With ``probe`` (a
    recorder and its probe: ``recording_attention`` and
    ``attention_probe``, or ``recording_scan`` and ``scan_probe``), one
    more kernel-run step records the first layer's inputs and output
    gradient, where the control must fail the probe. Losses must lie
    near ``expected_loss`` (random weights). Reports step ms, tokens/s,
    peak GB, bench.py's FLOPs share
    (``n_params`` None: the model's parameter count) and a profiled step.
    Returns the launch counts."""
    failures = run.failures
    sanity = TRAIN_SANITY if sanity is None else sanity
    ids = batch["input_ids"]
    tokens = ids.numel()
    t = time.perf_counter()
    kern = train(make_model, batch, True)
    launches = kern["launches"]
    # a count of None is one launch per parameter tensor of the model
    per_step = {k: kern["n_tensors"] if v is None else v
                for k, v in per_step.items()}
    expected = dict.fromkeys(launches, 0)
    expected.update({k: TRAIN_STEPS * v for k, v in per_step.items()})
    log(f"{key} launches {launches} expected {expected}")
    if launches != expected:
        failures.append(f"{key} launch counts {launches} != {expected}")
    if not (all(expected_loss - 1 < x < expected_loss + 3
                for x in kern["loss"])
            and all(math.isfinite(x) for x in kern["grad_norm"])):
        failures.append(f"{key} losses {kern['loss']} not near "
                        f"{expected_loss:.3f} (random weights) or grad norms "
                        f"{kern['grad_norm']} not finite")
    ref_run = train(make_model, batch, False)
    res = compare_runs(kern, ref_run)
    del kern["grads"], kern["params"]
    runs = {"kernels": kern, "plain": ref_run}
    readings = {}
    controls = {control[0]: control[1], **dict(extra_controls)}
    for name, patch in controls.items():
        with patch():
            ctrl = train(make_model, batch, False)
        readings[name] = compare_runs(ctrl, ref_run)
        del ctrl["grads"], ctrl["params"]
        runs[name] = ctrl
    del ref_run["grads"], ref_run["params"]
    torch.cuda.empty_cache()
    for name, r in runs.items():
        if name != "kernels" and any(r["launches"].values()):
            failures.append(f"{key}: {name} run launched kernels "
                            f"{r['launches']}")
    step_ms = statistics.median(kern["step_ms"])
    tokens_per_s = tokens / step_ms * 1e3
    n_params = kern["n_params"] if n_params is None else n_params
    # bench.py:212-214: 6 N weight FLOPs + 12 L E T attention per token
    flops_share = tokens_per_s * (6 * n_params + 12 * n_layers * hidden
                                  * ids.shape[1]) / BF16_OPS_PER_S
    run.report[key] = {
        "model": f"{title} (random weights, seed {SEED})",
        "batch": list(ids.shape), "timed_steps": TRAIN_STEPS,
        "step_ms": kern["step_ms"], "step_ms_median": step_ms,
        "host_ms": kern["host_ms"], "tokens_per_s": tokens_per_s,
        "flops_share": flops_share, "n_params": n_params,
        "n_param_tensors": kern["n_tensors"],
        "peak_mem_gb": kern["peak_gb"], "launches": launches,
        "expected_launches": expected, "step_profile": kern["profile"],
        "runs": {name: {k: r[k] for k in ("loss", "grad_norm", "step_ms",
                                          "peak_gb")}
                 for name, r in runs.items()},
        "kernels_vs_plain": res,
        **{f"{name.replace(' ', '_')}_vs_plain": r
           for name, r in readings.items()},
        "limits": limits, "sanity_limits": sanity,
        "phase_s": time.perf_counter() - t, "card": run.card}
    log(f"{key} ({title}) on {run.card}: B×T={list(ids.shape)}, step "
        f"{step_ms:.1f} ms (median of {kern['step_ms']}), "
        f"{tokens_per_s:.0f} tokens/s, peak {kern['peak_gb']:.2f} GB, "
        f"FLOPs share (bench.py's count over 989 TFLOP/s) "
        f"{flops_share:.4f}; losses {kern['loss']} grad_norms "
        f"{kern['grad_norm']}")
    log(f"{key} step profile: wall {kern['profile']['wall_us']:.0f} us, "
        f"device {kern['profile']['device_us']:.0f} us, top "
        f"{kern['profile']['top']}")
    log(f"{key} kernels vs plain: {res}; controls vs plain: {readings}; "
        f"limits {limits}, sanity {sanity}")
    both = {**limits, **sanity}
    if len(passed(res, both)) != len(both):
        failures.append(f"{key} run disagrees with the plain run: {res}, "
                        f"limits {both}")
    if passed(readings[control[0]], limits):
        failures.append(f"{key} check cannot tell the kernels from the "
                        f"{control[0]}: it passes "
                        f"{passed(readings[control[0]], limits)} "
                        f"({readings[control[0]]})")
    if probe is not None:
        recorder, prober = probe
        seen = {}
        with recorder(seen):
            model = make_model()
            rest = {k: v for k, v in batch.items()
                    if k not in ("input_ids", "labels")}
            model.loss(ids, batch["labels"], **rest,
                       generator=torch.Generator(device=ids.device)
                       .manual_seed(SEED)).backward()
        run.report[key]["probe"] = prober(key, seen, run)
        del seen, model
        torch.cuda.empty_cache()
    return launches


def scan_faults(args, dy, dh_last):
    """The plain selective scan with one piece taken out: forward (y, h_T)
    with the carried state reset at each of the kernel's save intervals,
    and without the D·u term; backward (du, dΔ, dA_part, dB, dC, dh0)
    without the message across intervals, and with dB and dC from the
    first channel block only."""
    from paddle_tpu_torch.kernels import selective_scan as SS
    u, delta, A, B_, C, D, h0 = args
    T = u.shape[1]
    k = SS.save_interval(A.shape[1])
    chunks = [slice(t, min(t + k, T)) for t in range(0, T, k)]

    def part(x, sl):
        return x[:, sl]
    ys, h = [], h0
    for i, sl in enumerate(chunks):
        y, h = SS.selective_scan_reference(
            part(u, sl), part(delta, sl), A, part(B_, sl), part(C, sl), D,
            h0 if i == 0 else None)
        ys.append(y)
    fwd = {"state reset per chunk": (torch.cat(ys, 1), h),
           "D·u dropped": SS.selective_scan_reference(u, delta, A, B_, C,
                                                      0 * D, h0)}
    want = SS.selective_scan_bwd_reference(u, delta, A, B_, C, dy, h0,
                                           dh_last)
    parts, h = [], h0
    for i, sl in enumerate(chunks):
        parts.append(SS.selective_scan_bwd_reference(
            part(u, sl), part(delta, sl), A, part(B_, sl), part(C, sl),
            part(dy, sl), h, dh_last if i == len(chunks) - 1 else None))
        _, h = SS.selective_scan_reference(part(u, sl), part(delta, sl), A,
                                           part(B_, sl), part(C, sl), D, h)
    cut = SS.CHANNEL_BLOCK
    one = SS.selective_scan_bwd_reference(
        u[..., :cut], delta[..., :cut], A[:cut], B_, C, dy[..., :cut],
        None if h0 is None else h0[:, :cut],
        None if dh_last is None else dh_last[:, :cut])
    bwd = {"message not carried": (
               torch.cat([q[0] for q in parts], 1),
               torch.cat([q[1] for q in parts], 1), sum(q[2] for q in parts),
               torch.cat([q[3] for q in parts], 1),
               torch.cat([q[4] for q in parts], 1), parts[0][5]),
           "dB/dC of one channel block": (*want[:3], one[3], one[4],
                                          want[5])}
    return fwd, bwd


def int8_faults(cache):
    """The int8 cache read wrongly: the v scale not applied; each scale
    taken per head (its largest over positions), not per position."""
    kq, vq, ks, vs = cache
    per_head = [s.amax(-1, keepdim=True).expand_as(s).contiguous()
                for s in (ks, vs)]
    return {"v scale not applied": (kq, vq, ks, torch.ones_like(vs)),
            "scale per head": (kq, vq, *per_head)}


def xent_mismatch(name):
    """The check of B14 (``"lse"``) or of the loss's gradient (``"dx
    float32"``, ``"dx bfloat16"``): the largest ratio of a difference to
    ``XENT_TOL[name]`` = (share of the largest value, share of each value)
    over each tensor; 1 or less means agreement."""
    frac, rtol = XENT_TOL[name]

    def check(got, want):
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        worst = 0.0
        for a, b in zip(got, want, strict=True):
            wf = b.float()
            tol = (frac * wf.abs().max() + rtol * wf.abs()).clamp_min(
                torch.finfo(torch.float32).tiny)
            r = ((a.float() - wf).abs() / tol).max().item()
            worst = max(worst, r if math.isfinite(r) else math.inf)
        return worst
    return check


def xent_grad(x, labels, g):
    """dlogits of the per-row softmax cross-entropy (B14 forward, B15
    backward and the one-hot term outside it) for the output gradient
    ``g``: the kernels on CUDA tensors, the plain versions inside
    ``force_reference()``."""
    from paddle_tpu_torch.kernels import softmax_xent as SX
    leaf = x.detach().requires_grad_()
    with torch.enable_grad():
        loss = SX.softmax_cross_entropy(leaf, labels)
        return torch.autograd.grad(loss, leaf, g)[0]


def xent_faults(x, labels, g):
    """B14/B15's plain versions with one piece wrong: the log-sum-exp with
    the running maximum not rescaled (each 256-wide vocabulary block's
    sum added against the maximum so far, the earlier sum never scaled
    down) and with the last vocabulary block skipped; the loss's gradient
    without the −g one-hot term. Returns ``(lse faults, dlogits
    faults)``."""
    from paddle_tpu_torch.kernels import softmax_xent as SX
    xf = x.float()
    m = torch.full((x.shape[0],), -math.inf, device=x.device)
    l = torch.zeros(x.shape[0], device=x.device)
    for off in range(0, x.shape[1], SX.BLOCK_V):
        blk = xf[:, off:off + SX.BLOCK_V]
        m = torch.maximum(m, blk.amax(1))
        l = l + torch.exp(blk - m[:, None]).sum(1)
    lse = SX.lse_reference(x)
    return ({"running maximum not rescaled": m + torch.log(l),
             "last vocabulary block skipped":
                 SX.lse_reference(x[:, :-SX.BLOCK_V])},
            {"one-hot term left out": SX.dx_reference(x, lse, g)})


def paged_faults(q, kn, vn, pool, table, pos, layer):
    """B10's plain version with one piece wrong: position ``pos[b]`` read
    too (the mask one position late), every page id one higher, the
    fresh token left out of the softmax."""
    from paddle_tpu_torch.kernels import paged_decode_attention as PDA
    plain = PDA.paged_decode_attention_reference
    B, _, Hq, D = q.shape
    kc, vc = PDA.gather_layer(pool, table, layer)       # [1, B, Hkv, S, D]
    Hkv, S = kc.shape[2], kc.shape[3]
    qh = q.float().reshape(B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bkgd,bksd->bkgs", qh, kc[0].float()) / math.sqrt(D)
    keep = torch.arange(S, device=q.device)[None] < pos.long()[:, None]
    s = s.masked_fill(~keep[:, None, None], -math.inf)
    no_fresh = torch.einsum("bkgs,bksd->bkgd", torch.softmax(s, -1),
                            vc[0].float()).reshape(B, 1, Hq, D).to(q.dtype)
    N = pool[0].shape[0] - 1
    return {"position pos unmasked": plain(q, kn, vn, pool, table, pos + 1,
                                           layer),
            "page id off by one": plain(q, kn, vn, pool,
                                        (table + 1).clamp(max=N), pos,
                                        layer),
            "fresh token dropped": no_fresh}


def engine_requests(vocab: int):
    """Phase 12's traffic: ENGINE_REQUESTS prompts of 16-400 tokens and
    16-64 new tokens each, from ``np.random.RandomState(0)``."""
    rs = np.random.RandomState(0)
    return [(rs.randint(0, vocab, (int(rs.randint(16, 401)),)).astype(
        np.int32), int(rs.randint(16, 65))) for _ in range(ENGINE_REQUESTS)]


def paged_requests(vocab: int):
    """Phase 13's traffic: 4 requests sharing a 256-token prefix (tails of
    8-40 tokens), a 900-token prompt and 3 more of 16-200 tokens, 16-64
    new tokens each (16 for the long one), from
    ``np.random.RandomState(13)``; the sharers interleaved with the
    others, so that the first one's prefill ends before the next
    arrives."""
    rs = np.random.RandomState(13)
    prefix = rs.randint(0, vocab, (256,)).astype(np.int32)
    shared = [np.concatenate([prefix, rs.randint(
        0, vocab, (int(rs.randint(8, 41)),)).astype(np.int32)])
        for _ in range(4)]
    others = [rs.randint(0, vocab, (900,)).astype(np.int32)] + [
        rs.randint(0, vocab, (int(rs.randint(16, 201)),)).astype(np.int32)
        for _ in range(3)]
    prompts = [p for pair in zip(shared, others) for p in pair]
    return [(p, 16 if len(p) == 900 else int(rs.randint(16, 65)))
            for p in prompts]


def serve_engine(engine, requests, cancel: int | None = None):
    """Drive ``engine`` with ``requests`` [(prompt, new tokens)]: each
    started ENGINE_GAP_S after the one before by one thread and consumed
    by a thread of its own (polls of 0.5 s at most; every wait bounded);
    request ``cancel`` is cancelled once it has streamed 8 tokens.
    Returns per request its tokens, error, time to first token and
    end time (s), and the wall time of the whole run."""
    import threading
    out = [None] * len(requests)
    t0 = time.perf_counter()

    def client(i, prompt, n):
        ts = time.perf_counter()
        gid = engine.start(prompt, n)
        toks, first, err = [], None, None
        deadline = ts + 600
        while time.perf_counter() < deadline:
            doc = engine.poll(gid, start=len(toks), wait_s=0.5)
            toks += doc["tokens"]
            if toks and first is None:
                first = time.perf_counter() - ts
            if i == cancel and len(toks) >= 8 and not doc["done"]:
                engine.cancel(gid)
                err = "cancelled"
                break
            if doc["done"]:
                err = doc["error"]
                break
        else:
            err = "timed out"
        out[i] = {"tokens": toks, "error": err, "ttft_s": first,
                  "end_s": time.perf_counter() - t0, "prompt": len(prompt),
                  "new_tokens": n}

    threads = []
    for i, (prompt, n) in enumerate(requests):
        th = threading.Thread(target=client, args=(i, prompt, n))
        th.start()
        threads.append(th)
        time.sleep(ENGINE_GAP_S)
    for th in threads:
        th.join(timeout=660)
    return out, time.perf_counter() - t0


def engine_expected(engine, L: int, paged: bool) -> dict:
    """The launches an engine's run implies: per prefill forward RMSNorm
    2L + 1 and RoPE 2L, flash L where it ran at index 0; per batched step
    (each replay, and the warm-up before the capture) RMSNorm 2L + 1,
    RoPE 2L and L of the step's attention kernel (B10 paged, B9 else)."""
    st = engine.stats()
    fwd = st["prefill_calls"] + st["decode_steps"] + 1
    return {"rms_norm": (2 * L + 1) * fwd, "rope": 2 * L * fwd,
            "flash_attention": L * st["prefill_calls_fresh"],
            ("paged_decode_attention" if paged else "decode_attention"):
                L * (st["decode_steps"] + 1)}


def time_replay(engine, reps: int = 7, inner: int = 10) -> float:
    """Device time of one replay of the engine's captured decode step
    (CUDA events over ``inner`` replays, median of ``reps``)."""
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            engine.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def set_step_state(engine, pos, tables=None):
    """The engine's static step buffers at 8 active slots: positions
    ``pos``, tokens 1, and (paged) page ``tables`` [slots, M]."""
    engine._pos_buf.copy_(torch.tensor(pos, dtype=torch.int32))
    engine._tok_buf.fill_(1)
    engine._active_buf.fill_(True)
    if tables is not None:
        engine._pt_buf.copy_(torch.as_tensor(tables, dtype=torch.int32))


@torch.no_grad()
def engine_teacher(model, seqs, mode: str, steps: int = TEACHER_STEPS,
                   chunk: int | None = None):
    """Teacher-forced logits [len(seqs), steps + 1, V] (fp32) of sequences
    ``seqs`` [(prompt, continuation)] run as the engine runs them:
    ``"solo"`` one sequence at a time as ``generate`` does (B = 1, int
    index); ``"contiguous"`` the slots' prefills right-padded to their
    buckets into the stacked cache, then ``steps`` batched steps at the
    slots' own positions; ``"paged"`` the prefills through the pool, then
    the batched steps over ``PagedKV``. ``chunk`` (the paged engine's
    ``prefill_chunk``; None: the whole prompt) cuts the prefills of both
    batched modes into chunks, each after the first at its index through
    the chunk arm. Step i feeds each sequence's continuation token i."""
    from paddle_tpu_torch.models._common import PagedKV
    from paddle_tpu_torch.models.generation import (init_paged_cache,
                                                    paged_gather,
                                                    paged_scatter)
    dev = model.device
    S = len(seqs)
    out = [[] for _ in range(S)]

    def ids(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)[None]

    def bucket(n, cap):
        b = 8
        while b < n:
            b *= 2
        return min(b, cap)

    if mode == "solo":
        for s, (p, c) in enumerate(seqs):
            cache = model.init_cache(1, len(p) + steps)
            logits, _ = model.forward_with_cache(ids(p), cache, 0)
            out[s].append(logits[0, -1].float())
            for i in range(steps):
                logits, _ = model.forward_with_cache(ids(c[i:i + 1]), cache,
                                                     len(p) + i)
                out[s].append(logits[0, -1].float())
        return torch.stack([torch.stack(o) for o in out])
    P, M = ENGINE_PAGE, ENGINE_MAX_LEN // ENGINE_PAGE
    paged = mode == "paged"
    if paged:
        cache = init_paged_cache(model.init_cache(1, ENGINE_MAX_LEN), S * M, P)
        table = torch.arange(1, S * M + 1, dtype=torch.int32,
                             device=dev).reshape(S, M)
    else:
        cache = model.init_cache(S, ENGINE_MAX_LEN)
    for s, (p, _) in enumerate(seqs):
        step = chunk or len(p)
        for a in range(0, len(p), step):
            b = min(len(p), a + step)
            padded = np.zeros(min(bucket(b - a, ENGINE_MAX_LEN),
                                  ENGINE_MAX_LEN - a), np.int64)
            padded[:b - a] = p[a:b]
            if paged:
                view = paged_gather(cache, table[s])
                logits, view = model.forward_with_cache(ids(padded), view, a)
                paged_scatter(cache, table[s], tuple(
                    c[:, :, :, a:a + len(padded)] for c in view), a, P,
                    length=b - a)
                del view
            else:
                logits, _ = model.forward_with_cache(
                    ids(padded), tuple(c[:, s:s + 1] for c in cache), a)
        out[s].append(logits[0, len(p) - a - 1].float())
    if paged:
        cache = PagedKV(cache, table,
                        torch.ones(S, dtype=torch.bool, device=dev))
    pos = torch.tensor([len(p) for p, _ in seqs], dtype=torch.int32,
                       device=dev)
    for i in range(steps):
        tok = torch.tensor([c[i] for _, c in seqs], device=dev)[:, None]
        logits, _ = model.forward_with_cache(tok, cache, pos)
        for s in range(S):
            out[s].append(logits[s, -1].float())
        pos += 1
    return torch.stack([torch.stack(o) for o in out])


def greedy_agreement(engine_out, solo):
    """Share of a run's greedy tokens equal to solo ``generate``'s, and the
    first position where each stream diverges (None: never)."""
    equal = total = 0
    first = []
    for o, ref in zip(engine_out, solo):
        toks = o["tokens"]
        same = [int(a == b) for a, b in zip(toks, ref)]
        equal += sum(same)
        total += len(same)
        first.append(next((i for i, x in enumerate(same) if not x), None))
    return {"equal_share": equal / max(total, 1), "first_divergence": first}


def engine_report(key, title, engine, out, wall_s, launches, expected,
                  run):
    """Check and log one engine run: exact launch counts, every request
    finished as asked (the cancelled one cancelled), tokens in range."""
    failures = run.failures
    tokens = sum(len(o["tokens"]) for o in out)
    log(f"{key} launches {launches} expected {expected}")
    if launches != expected:
        failures.append(f"{key} launch counts {launches} != {expected}")
    for i, o in enumerate(out):
        ok = (o["error"] is None and len(o["tokens"]) == o["new_tokens"]) \
            or (o["error"] == "cancelled" and len(o["tokens"]) >= 8)
        if not ok or not all(0 <= t < run.vocab for t in o["tokens"]):
            failures.append(f"{key}: request {i} ended {o['error']} with "
                            f"{len(o['tokens'])} of {o['new_tokens']} "
                            "tokens")
    st = engine.stats()
    rep = run.report[key] = {
        "model": f"{title} (random weights, seed {SEED})",
        "requests": [{k: o[k] for k in ("prompt", "new_tokens", "error",
                                        "ttft_s", "end_s")} for o in out],
        "tokens": tokens, "wall_s": wall_s, "tokens_per_s": tokens / wall_s,
        "ttft_s": [o["ttft_s"] for o in out], "stats": st,
        "launches": launches, "expected_launches": expected,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": run.card}
    log(f"{key} ({title}) on {run.card}: {len(out)} requests, {tokens} "
        f"tokens in {wall_s:.2f} s ({tokens / wall_s:.1f} tokens/s), "
        f"{st['decode_steps']} batched steps, {st['prefill_calls']} prefill "
        f"forwards, TTFT {[round(o['ttft_s'] or -1, 3) for o in out]} s, "
        f"peak {rep['peak_mem_gb']:.2f} GB")
    return rep


def engine_logits_check(key, rep, got, want, control, limits, run):
    """Teacher-forced logits ``got`` against ``want`` within ``limits``,
    which ``control`` (the bf16-attention run against ``want``) must
    fail."""
    res, ctrl = compare_logits(got, want), compare_logits(control, want)
    rep["logits"] = {"engine_vs_reference": res, "control": ctrl,
                     "limits": dict(zip(("max_abs", "mean_abs",
                                         "min_cosine"), limits))}
    log(f"{key} teacher-forced logits: {res}; bf16-attention control: "
        f"{ctrl}; limits {limits}")
    if not logits_within(res, limits):
        run.failures.append(f"{key}: logits disagree: {rep['logits']}")
    if logits_within(ctrl, limits):
        run.failures.append(f"{key}: the logits check cannot tell the "
                            f"engine from bf16 attention: {ctrl}")


@contextlib.contextmanager
def bf16_xent():
    """The dense-loss control: the loss's logits rounded to bf16 before
    B14/B15's plain versions (a lower-precision loss)."""
    from paddle_tpu_torch.kernels import softmax_xent as SX
    saved = SX.lse_reference, SX.dx_reference
    SX.lse_reference = lambda x: saved[0](x.to(torch.bfloat16))
    SX.dx_reference = lambda x, l, g: saved[1](
        x.to(torch.bfloat16), l, g).to(x.dtype)
    try:
        yield
    finally:
        SX.lse_reference, SX.dx_reference = saved


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    if os.path.exists(LOG_PATH):
        os.remove(LOG_PATH)
    log(f"card: {card}")

    from paddle_tpu_torch.core.monitor import get_stat
    from paddle_tpu_torch.device import make_generator
    from paddle_tpu_torch.kernels import _support
    from paddle_tpu_torch.kernels import adamw as A
    from paddle_tpu_torch.kernels import decode_attention as DA
    from paddle_tpu_torch.kernels import flash_attention as FA
    from paddle_tpu_torch.kernels import linear_xent as LX
    from paddle_tpu_torch.kernels import norm as N
    from paddle_tpu_torch.kernels import rope as R
    from paddle_tpu_torch.kernels import selective_scan as SS
    from paddle_tpu_torch.models import (ErnieConfig, ErnieForPretraining,
                                         GPTConfig, GPTForCausalLM,
                                         LlamaConfig, LlamaForCausalLM,
                                         MambaConfig, MambaForCausalLM)
    from paddle_tpu_torch.models._common import _quant_chunk
    from paddle_tpu_torch.nn.functional import rotary_embedding

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures: list[str] = []
    report: dict = {"card": card, "device": torch.cuda.get_device_name(0)}
    run = types.SimpleNamespace(card=card, failures=failures, report=report)

    # ---------------------------------------------------------- 1. build
    t = time.perf_counter()
    _support.build()
    report["build_s"] = time.perf_counter() - t
    log(f"build: {len(_support.KERNELS)} kernels from "
        f"{len(set(_support.SOURCES.values()))} sources in "
        f"{report['build_s']:.1f} s")

    # ------------------------------------- 2. kernels vs plain versions
    dev = torch.device("cuda")
    gen = make_generator(SEED, dev)
    bf16 = torch.bfloat16

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf16)

    rows = []      # every checked case
    main_case = {}  # kernel -> the case timed for the JSON line

    def case(kernel, geometry, shape, fn, ref, nbytes, ops, library=None,
             timed=False, timer=time_ms, kernel_only=None, mismatch=None,
             tol=f"{KERNEL_ATOL}+{KERNEL_RTOL}*|ref|", library_timer=None,
             ops_rate=BF16_OPS_PER_S, plain_only=None):
        """``fn`` (the kernel's wrapper) and ``ref`` (its plain version)
        return a tensor or a tuple of them, compared pairwise within
        ``KERNEL_ATOL + KERNEL_RTOL·|ref|``, or by ``mismatch(got, want)``
        (agreement at 1 or less) where given. ``kernel_only``, where
        given, is what is timed as the kernel instead of ``fn``, and
        ``plain_only`` as the plain version instead of ``ref``;
        ``library_timer`` (default ``timer``) times ``library``; the
        operations' bound is taken at ``ops_rate``."""
        got, want = fn(), ref()
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        err, ok = 0.0, True
        for a, b in zip(got, want):
            diff = (a.float() - b.float()).abs()
            err = max(err, diff.max().item())
            if mismatch is None:
                ok &= bool((diff <= KERNEL_ATOL + KERNEL_RTOL
                            * b.float().abs()).all())
            del diff
        row = {"kernel": kernel, "geometry": geometry, "shape": shape,
               "max_abs_err": err}
        if mismatch is not None:
            row["mismatch"] = mismatch(got, want)
            ok = row["mismatch"] <= 1.0
        row["ok"] = ok
        del got, want
        if timed:
            b_ms, b_by = bound(nbytes, ops, ops_rate)
            row.update(ms=timer(kernel_only or fn),
                       plain_ms=timer(plain_only or ref),
                       bound_ms=b_ms, bound_by=b_by,
                       library_ms=None if library is None
                       else (library_timer or timer)(library))
            main_case.setdefault(kernel, row)
        rows.append(row)
        extra = ""
        if timed:
            lib = row["library_ms"]
            extra = (f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                     f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
                     f"library_ms={'null' if lib is None else f'{lib:.4f}'}")
        if mismatch is not None:
            extra = f" mismatch={row['mismatch']:.3g}" + extra
        log(f"  {kernel:17s} {geometry:4s} {shape:34s} max_abs_err={err:.3e}"
            f" tol={tol} {'ok' if ok else 'FAIL'}{extra}")
        if not ok:
            failures.append(f"{kernel} {geometry} {shape}: err {err}")

    def layer_walk(fn, n_layers):
        """Each call reads the next layer of the stacked cache, as the
        decode step does: a timed run of calls then streams from HBM
        instead of re-reading one layer from L2."""
        state = {"layer": 0}

        def call():
            state["layer"] = (state["layer"] + 1) % n_layers
            return fn(state["layer"])
        return call

    torch_rms = getattr(torch.nn.functional, "rms_norm", None)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    log("kernels vs plain versions (bf16):")
    for geo, E, Hq, Hkv in (("7B", 4096, 32, 32), ("70B", 8192, 64, 8)):
        D = 128
        for n in (B, B * T0):                    # decode, prefill rows
            x, w = rn(n, E), rn(E)
            lib = (None if torch_rms is None else
                   (lambda x=x, w=w, E=E: torch_rms(x, (E,), w, 1e-5)))
            case("rms_norm", geo, f"[{n},{E}]",
                 lambda x=x, w=w: N.rms_norm(x, w, 1e-5),
                 lambda x=x, w=w: N.rms_norm_reference(x, w, 1e-5),
                 2 * n * E * 2 + E * 2, 4 * n * E, lib,
                 timed=geo == "7B" and n == B)
        for T, heads in ((T0, Hq), (T0, Hkv), (1, Hq)):
            pos = torch.arange(T, device=dev) + (0 if T > 1 else T0)
            cos, sin = rotary_embedding(pos, D)
            x = rn(B, T, heads, D)
            case("rope", geo, f"[{B},{T},{heads},{D}]",
                 lambda x=x, c=cos, s=sin: R.apply_rotary(x, c, s),
                 lambda x=x, c=cos, s=sin: R.apply_rotary_reference(x, c, s),
                 2 * x.numel() * 2 + 2 * T * (D // 2) * 4, 6 * x.numel() // 2,
                 timed=geo == "7B" and T == 1)
        q, k, v = rn(B, T0, Hq, D), rn(B, T0, Hkv, D), rn(B, T0, Hkv, D)
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        gqa = {"enable_gqa": True} if Hq != Hkv else {}
        pairs = T0 * (T0 + 1) // 2
        case("flash_attention", geo, f"q[{B},{T0},{Hq},{D}] kv{Hkv}",
             lambda: FA.flash_attention(q, k, v, causal=True),
             lambda: FA.flash_attention_reference(q, k, v, causal=True),
             (2 * q.numel() + 2 * k.numel()) * 2, 4 * D * pairs * B * Hq,
             lambda: sdpa(qt, kt, vt, is_causal=True, **gqa),
             timed=geo == "7B")
        L = 32 if geo == "7B" else 2
        S = T0 + NEW
        cache = (rn(L, B, Hkv, S, D), rn(L, B, Hkv, S, D))
        qd, kn, vn = rn(B, 1, Hq, D), rn(B, Hkv, 1, D), rn(B, Hkv, 1, D)
        mean_fill = T0 + (NEW - 2) // 2       # mean index of the decode steps
        for idx in (1, 77, T0, mean_fill, S - 1):
            timed = geo == "7B" and idx == mean_fill
            lib = None
            if timed:
                # SDPA of the one-token query over each layer's cache
                # prefix plus the new k/v, concatenated outside the timed
                # region (the decode step's function in one torch call)
                qs = qd.transpose(1, 2)
                kv = [(torch.cat([cache[0][lay, :, :, :idx], kn], 2),
                       torch.cat([cache[1][lay, :, :, :idx], vn], 2))
                      for lay in range(L)]
                lib = layer_walk(lambda lay: sdpa(qs, *kv[lay]), L)
            case("decode_attention", geo,
                 f"cache[{L},{B},{Hkv},{S},{D}] Hq{Hq} index {idx}",
                 layer_walk(lambda lay, i=idx: DA.decode_attention(
                     qd, kn, vn, cache, lay, i), L),
                 layer_walk(lambda lay, i=idx: DA.decode_attention_reference(
                     qd, kn, vn, cache, lay, i), L),
                 (2 * B * Hkv * idx * D + 2 * qd.numel() + 2 * kn.numel())
                 * 2, 4 * B * Hq * D * (idx + 1), lib, timed=timed)
            if timed:
                del kv, lib
        del cache
    # the training path's kernels at its shapes (B=4, T=2048; the 70B head
    # geometry at B=1), timed without a graph: they run for long enough
    bt = TRAIN_B * TRAIN_T
    for geo, E, F_, Hq, Hkv in (("7B", 4096, 11008, 32, 32),
                                ("70B", 8192, 28672, 64, 8)):
        D, timed = 128, geo == "7B"
        x, w, g = rn(bt, E), rn(E), rn(bt, E)
        _, rstd = N.rms_norm_reference(x, w, 1e-5, return_rstd=True)
        lib = None
        if torch_rms is not None:
            xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
            yl = torch_rms(xl, (E,), wl, 1e-5)
            lib = (lambda yl=yl, xl=xl, wl=wl, g=g: torch.autograd.grad(
                yl, (xl, wl), g, retain_graph=True))
        case("rms_norm_bwd", geo, f"[{bt},{E}]",
             lambda: N.rms_norm_bwd(x, w, rstd, g),
             lambda: N.rms_norm_bwd_reference(x, w, rstd, g),
             3 * bt * E * 2 + E * 2 + bt * 4 + E * 4, 8 * bt * E, lib,
             timed=timed, timer=time_ms_eager)
        del x, w, g, rstd, lib

        Bq = TRAIN_B if geo == "7B" else 1
        q, k, v = (rn(Bq, TRAIN_T, Hq, D), rn(Bq, TRAIN_T, Hkv, D),
                   rn(Bq, TRAIN_T, Hkv, D))
        do = rn(Bq, TRAIN_T, Hq, D)
        o, lse = FA.flash_attention_reference(q, k, v, causal=True,
                                              return_lse=True)
        delta = torch.einsum("bthd,bthd->bht", do.float(),
                             o.float()).contiguous()
        kw = dict(causal=True, scale=1.0 / math.sqrt(D))
        lib = None
        if timed:
            # SDPA's backward computes dq, dk and dv in one call: the
            # yardstick of both backward kernels
            qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_()
                          for a in (q, k, v))
            ot = sdpa(qt, kt, vt, is_causal=True)
            dot = do.transpose(1, 2).contiguous()
            lib = (lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                               retain_graph=True))
        product = 2 * D * Bq * Hq * TRAIN_T * (TRAIN_T + 1) // 2  # causal
        rows_io = 2 * Bq * Hq * TRAIN_T * 4                      # lse, delta
        shape = f"q[{Bq},{TRAIN_T},{Hq},{D}] kv{Hkv}"
        # the forward at the training shape (the JSON line keeps the
        # serving shape's row, timed first)
        case("flash_attention", geo, shape,
             lambda: FA.flash_attention(q, k, v, causal=True,
                                        return_lse=True),
             lambda: FA.flash_attention_reference(q, k, v, causal=True,
                                                  return_lse=True),
             (2 * q.numel() + 2 * k.numel()) * 2 + rows_io // 2,
             2 * product,
             None if lib is None else (lambda: sdpa(qt, kt, vt,
                                                    is_causal=True)),
             timed=timed, timer=time_ms_eager)
        # checked through the wrapper the path calls (delta, then both
        # kernels); each kernel timed on its own
        case("flash_attention_bwd_dq", geo, shape,
             lambda: FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)[0],
             lambda: FA.flash_attention_bwd_reference(
                 q, k, v, o, lse, do, **kw)[0],
             (3 * q.numel() + 2 * k.numel()) * 2 + rows_io, 3 * product,
             lib, timed=timed, timer=time_ms_eager,
             kernel_only=lambda: FA._dq_kernel(q, k, v, do, lse, delta,
                                               **kw))
        case("flash_attention_bwd_dkdv", geo, shape,
             lambda: FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)[1:],
             lambda: FA.flash_attention_bwd_reference(
                 q, k, v, o, lse, do, **kw)[1:],
             (2 * q.numel() + 4 * k.numel()) * 2 + rows_io, 4 * product,
             lib, timed=timed, timer=time_ms_eager,
             kernel_only=lambda: FA._dkdv_kernel(q, k, v, do, lse, delta,
                                                 **kw))
        del q, k, v, do, o, lse, delta, lib
        if timed:
            del qt, kt, vt, ot, dot
        torch.cuda.empty_cache()

        # AdamW on one MLP weight, from the same state both ways, bf16 p
        # (the path's) and fp32 p. p at Llama's init scale (0.02), g at
        # 1e-3, the moments as 9 earlier steps of such gradients leave
        # them: step 10 then moves p by a few bf16 ulps. Each output is
        # held at its own scale (``update_mismatch``), and two controls
        # must fail that check: a step that writes nothing, and the plain
        # step without bias corrections.
        kw = dict(lr=3e-4, step=10)
        p_n, g = rn(E, F_), rn(E, F_) * 1e-3
        m0 = torch.randn(E, F_, generator=gen, device=dev) * (
            (1 - 0.9 ** 9) * 1e-3)
        v0 = torch.rand(E, F_, generator=gen, device=dev) * (
            2 * (1 - 0.999 ** 9) * 1e-6)
        for p_dtype in (bf16, torch.float32):
            before = ((0.02 * p_n.float()).to(p_dtype), m0, v0)
            gp = g.to(p_dtype)
            kern_state = [t.clone() for t in before]
            ref_state = [t.clone() for t in before]
            timed_here = timed and p_dtype == bf16
            lib = None
            if timed_here:
                lib_p = torch.nn.Parameter(before[0].clone())
                lib_p.grad = gp
                lib_opt = torch.optim.AdamW([lib_p], lr=3e-4, fused=True)
                lib = lib_opt.step

            def mismatch(got, want, before=before, gp=gp):
                return A.update_mismatch(before, gp, got, want, **kw)
            # p read and written, g read, m and v fp32 read and written
            nbytes = (2 * before[0].element_size() + gp.element_size()
                      + 16) * p_n.numel()
            case("adamw", geo, f"[{E},{F_}] p {str(p_dtype)[6:]}",
                 lambda: A.adamw_update(*kern_state, gp, **kw),
                 lambda: A.adamw_update_reference(*ref_state, gp, **kw),
                 nbytes, 15 * p_n.numel(), lib, timed=timed_here,
                 timer=time_ms_eager, mismatch=mismatch,
                 tol="update_mismatch<=1")
            del kern_state, ref_state, lib
            if timed_here:
                del lib_p, lib_opt
            want = A.adamw_update_reference(*(t.clone() for t in before), gp,
                                            **kw)
            corrections = A._bias_corrections
            A._bias_corrections = lambda b1, b2, step: (1.0, 1.0)
            try:
                no_bias = A.adamw_update_reference(
                    *(t.clone() for t in before), gp, **kw)
            finally:
                A._bias_corrections = corrections
            ulps = ((want[0].float() - before[0].float()).abs()
                    / (torch.finfo(p_dtype).eps
                       * before[0].float().abs())).median().item()
            controls = {"no-op": mismatch(before, want),
                        "no bias correction": mismatch(no_bias, want)}
            rows[-1].update(controls=controls, median_step_ulps=ulps)
            log(f"    adamw controls (must exceed 1): {controls}; median "
                f"step {ulps:.2f} ulps of p")
            for name, r in controls.items():
                if r <= 1.0:
                    failures.append(f"adamw {geo} p {p_dtype}: the control "
                                    f"'{name}' passes the check ({r})")
            del before, gp, want, no_bias, mismatch
        del p_n, g, m0, v0
        torch.cuda.empty_cache()

    # the fused head (B11-B13): the bench shape (timed, and against the
    # bf16-logits control), the 7B head and a ragged case (N, E and V off
    # every tile, V odd so W is read element by element, label V - 1 in
    # the partial vocab tile). Hidden at RMSNorm scale, W at init scale
    # (0.02), every 97th row at -100, g the mean's cotangent.
    def head_mismatch(atol, rtol, scaled):
        return lambda got, want: LX.mismatch(got, want, atol, rtol, scaled)

    def rel_l2(got, want):
        return max(((a.float() - b.float()).norm() / b.float().norm()).item()
                   for a, b in zip(got, want))

    rounded_logits = (lambda h, w, ct: (h.to(ct) @ w.to(ct))
                      .to(torch.bfloat16).to(ct))
    for geo, n, E, V in (("bench", BENCH_B * BENCH_T, 2048, 32000),
                         ("7B", BENCH_B * BENCH_T, 4096, 32000),
                         ("ragged", 1000, 2056, 32003)):
        timed = geo == "bench"
        h, w = rn(n, E), (rn(E, V).float() * 0.02).to(bf16)
        lab = torch.randint(0, V, (n,), generator=gen, device=dev)
        lab[::97] = -100
        lab[1::389] = V - 1
        valid = lab != -100
        g = valid.float() / valid.sum()
        lse, _ = LX.linear_xent_fwd_reference(h, w, lab)
        lib_fwd = lib_bwd = None
        if timed:
            hl, wl = h.detach().requires_grad_(), w.detach().requires_grad_()
            per = torch.nn.functional.cross_entropy(
                (hl @ wl).float(), lab, reduction="none")
            lib_fwd = lambda: h @ w                       # noqa: E731
            lib_bwd = (lambda: torch.autograd.grad(       # noqa: E731
                per, (hl, wl), g, retain_graph=True))
        in_bytes = (n * E + E * V) * 2 + n * 8
        shape = f"h[{n},{E}] W[{E},{V}]"
        cases = (("linear_xent_fwd", LX.linear_xent_fwd,
                  LX.linear_xent_fwd_reference, (), HEAD_FWD_TOL,
                  in_bytes + 2 * n * 4, 2 * n * E * V, lib_fwd),
                 ("linear_xent_dh", LX.linear_xent_dh,
                  LX.linear_xent_dh_reference, (lse, g), HEAD_BWD_TOL,
                  in_bytes + 2 * n * 4 + n * E * 2, 4 * n * E * V, lib_bwd),
                 ("linear_xent_dw", LX.linear_xent_dw,
                  LX.linear_xent_dw_reference, (lse, g), HEAD_BWD_TOL,
                  in_bytes + 2 * n * 4 + E * V * 2, 4 * n * E * V, lib_bwd))
        for name, kern, plain, extra, tol, nbytes, ops, lib in cases:
            case(name, geo, shape,
                 lambda kern=kern, extra=extra: kern(h, w, lab, *extra),
                 lambda plain=plain, extra=extra: plain(h, w, lab, *extra),
                 nbytes, ops, lib, timed=timed, timer=time_ms_eager,
                 mismatch=head_mismatch(*tol),
                 tol=f"{tol[0]}{'·max|ref|' if tol[2] else ''}"
                     f"+{tol[1]:.3g}*|ref|")
            got = kern(h, w, lab, *extra)
            want = plain(h, w, lab, *extra)
            if isinstance(got, torch.Tensor):
                got, want = (got,), (want,)
            rows[-1]["rel_l2"] = rel_l2(got, want)
            if rows[-1]["rel_l2"] > HEAD_REL_L2[name]:
                failures.append(f"{name} {geo}: relative L2 error "
                                f"{rows[-1]['rel_l2']} > {HEAD_REL_L2[name]}")
            if timed:
                # the bf16-logits control: the plain version with the
                # logits rounded before the softmax must fail the checks
                saved_logits = LX._tile_logits
                LX._tile_logits = rounded_logits
                try:
                    ctrl = plain(h, w, lab, *extra)
                finally:
                    LX._tile_logits = saved_logits
                if isinstance(ctrl, torch.Tensor):
                    ctrl = (ctrl,)
                control = {"mismatch": head_mismatch(*tol)(ctrl, want),
                           "rel_l2": rel_l2(ctrl, want)}
                rows[-1]["control"] = control
                log(f"    {name} rel_l2 {rows[-1]['rel_l2']:.3g}; control "
                    f"(bf16 logits) {control}")
                if name in HEAD_CONTROL_FAILS and control["mismatch"] <= 1.0 \
                        and control["rel_l2"] <= HEAD_REL_L2[name]:
                    failures.append(f"{name}: the bf16-logits control "
                                    f"passes the check ({control})")
                del ctrl
                # planted faults the check must catch: the forward without
                # its label logit, dH and dW without the one-hot term and
                # without the softmax term (lse at +inf)
                no_labels = torch.full_like(lab, -100)
                faults = {"label dropped" if not extra else "one-hot dropped":
                          plain(h, w, no_labels, *extra)}
                if extra:
                    faults["softmax dropped"] = plain(
                        h, w, lab, torch.full_like(lse, float("inf")), g)
                readings = {}
                for fault, bad in faults.items():
                    if isinstance(bad, torch.Tensor):
                        bad = (bad,)
                    readings[fault] = {"mismatch": head_mismatch(*tol)(
                        bad, want), "rel_l2": rel_l2(bad, want)}
                    if readings[fault]["mismatch"] <= 1.0 and \
                            readings[fault]["rel_l2"] <= HEAD_REL_L2[name]:
                        failures.append(f"{name}: the planted fault "
                                        f"'{fault}' passes the check "
                                        f"({readings[fault]})")
                rows[-1]["faults"] = readings
                log(f"    {name} planted faults (must fail): {readings}")
                del faults, bad
            del got, want
        if timed:
            # the backward as training runs it: dH and dW in one walk over
            # the vocabulary, each chunk's dlogits computed once
            both = LX._bwd_kernel(h, w, lab, lse, g, True, True)
            alone = (LX.linear_xent_dh(h, w, lab, lse, g),
                     LX.linear_xent_dw(h, w, lab, lse, g))
            same = all(torch.equal(a, b) for a, b in zip(both, alone))
            if not same:
                failures.append("linear_xent: the shared backward's dH and "
                                "dW differ from dH and dW run alone")
            b_ms, b_by = bound(in_bytes + 2 * n * 4 + n * E * 2 + E * V * 2,
                               6 * n * E * V)
            report["head_bwd_shared"] = {
                "ms": time_ms_eager(lambda: LX._bwd_kernel(
                    h, w, lab, lse, g, True, True)),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": time_ms_eager(lib_bwd),
                "equal_to_alone": same, "shape": shape}
            log(f"  linear_xent dH+dW shared walk {shape}: "
                f"{report['head_bwd_shared']}")
            del both, alone
        del h, w, lab, valid, g, lse, lib_fwd, lib_bwd, cases
        if timed:
            del hl, wl, per
        torch.cuda.empty_cache()
    # LayerNorm (B6, B7) at GPT-3 1.3B's training rows, ERNIE-base's, GPT-3
    # 6.7B's decode step and a ragged shape. These cases and phases 6-8
    # draw from generators of their own, so that the earlier phases keep
    # their inputs (phase 3's prompt and phase 4's batch come from
    # ``gen``, after the cases above). Each output is held at its
    # own scale (norm.layer_norm_mismatch, layer_norm_bwd_mismatch), as
    # AdamW is, and planted faults must fail the same checks: the forward
    # without its bias; the backward's dw without x̂, db left out, dx
    # without its mean(w·g) term.
    torch_ln = torch.nn.functional.layer_norm
    gen_new = make_generator(SEED + 2, dev)

    def rn_new(*shape):
        return torch.randn(*shape, generator=gen_new, device=dev).to(bf16)
    for geo, n, h in (("1.3B", GPT_B * GPT_T, 2048),
                      ("ERNI", ERNIE_B * ERNIE_T, 768),
                      ("6.7B", B, 4096), ("rag", 1000, 776)):
        x, w, b, g = rn_new(n, h), rn_new(h), rn_new(h), rn_new(n, h)
        shape = f"[{n},{h}]"

        def ln_mismatch(got, want, x=x, w=w, b=b):
            return N.layer_norm_mismatch(x, w, b, got[0], want[0])
        case("layer_norm", geo, shape,
             lambda: N.layer_norm(x, w, b, 1e-5),
             lambda: N.layer_norm_reference(x, w, b, 1e-5),
             (2 * n * h + 2 * h) * 2 + 2 * n * 4, 8 * n * h,
             lambda: torch_ln(x, (h,), w, b, 1e-5), timed=geo != "rag",
             mismatch=ln_mismatch, tol="layer_norm_mismatch<=1",
             ops_rate=FP32_OPS_PER_S)
        no_bias = N.layer_norm_reference(x, w, torch.zeros_like(b), 1e-5)
        faults = {"bias dropped": ln_mismatch((no_bias,), (
            N.layer_norm_reference(x, w, b, 1e-5),))}

        _, mean, rstd = N.layer_norm_reference(x, w, b, 1e-5,
                                               return_stats=True)
        timed = geo in ("1.3B", "ERNI")     # the training shapes
        lib = None
        if timed:
            xl, wl, bl = (t.detach().requires_grad_() for t in (x, w, b))
            yl = torch_ln(xl, (h,), wl, bl, 1e-5)
            lib = (lambda yl=yl, xl=xl, wl=wl, bl=bl, g=g:
                   torch.autograd.grad(yl, (xl, wl, bl), g,
                                       retain_graph=True))

        def bwd_mismatch(got, want, x=x, w=w, mean=mean, rstd=rstd, g=g):
            return N.layer_norm_bwd_mismatch(x, w, mean, rstd, g, got, want)
        case("layer_norm_bwd", geo, shape,
             lambda: N.layer_norm_bwd(x, w, mean, rstd, g),
             lambda: N.layer_norm_bwd_reference(x, w, mean, rstd, g),
             3 * n * h * 2 + h * 2 + 2 * n * 4 + 2 * h * 4, 14 * n * h,
             lib, timed=timed, library_timer=time_ms_eager,
             mismatch=bwd_mismatch, tol="layer_norm_bwd_mismatch<=1",
             ops_rate=FP32_OPS_PER_S)
        want = N.layer_norm_bwd_reference(x, w, mean, rstd, g)
        r = rstd[:, None]
        xhat = (x.float() - mean[:, None]) * r
        wg = g.float() * w.float()
        c2 = (wg * xhat).mean(-1, keepdim=True)
        for fault, bad in (
                ("dw without xhat", (want[0], g.float().sum(0), want[2])),
                ("db dropped", (want[0], want[1], torch.zeros_like(want[2]))),
                ("dx without mean(wg)", ((r * (wg - xhat * c2)).to(bf16),
                                         want[1], want[2]))):
            faults[fault] = bwd_mismatch(bad, want)
        rows[-1]["faults"] = faults
        log(f"    layer_norm planted faults (must exceed 1): {faults}")
        for fault, reading in faults.items():
            if reading <= 1.0:
                failures.append(f"layer_norm {geo}: the planted fault "
                                f"'{fault}' passes the check ({reading})")
        del x, w, b, g, mean, rstd, want, xhat, wg, c2, r, lib, no_bias
        if timed:
            del xl, wl, bl, yl
    torch.cuda.empty_cache()

    # flash attention at ERNIE-base's shape: D = 64, non-causal (the
    # kernels' D = 64 and non-causal instantiations). The plain version
    # with a causal mask is a planted fault the checks must catch.
    Be, Te, He, De = ERNIE_B, ERNIE_T, 12, 64
    q, k, v, do = (rn_new(Be, Te, He, De) for _ in range(4))
    kw = dict(causal=False, scale=1.0 / math.sqrt(De))
    o, lse = FA.flash_attention_reference(q, k, v, return_lse=True, **kw)
    delta = torch.einsum("bthd,bthd->bht", do.float(),
                         o.float()).contiguous()
    qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_()
                  for a in (q, k, v))
    ot = sdpa(qt, kt, vt)
    dot = do.transpose(1, 2).contiguous()
    lib_bwd = (lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                           retain_graph=True))
    product = 2 * De * Be * He * Te * Te             # non-causal: all pairs
    rows_io = 2 * Be * He * Te * 4                   # lse, delta
    shape = f"q[{Be},{Te},{He},{De}] non-causal"
    case("flash_attention", "ERNI", shape,
         lambda: FA.flash_attention(q, k, v, return_lse=True, **kw),
         lambda: FA.flash_attention_reference(q, k, v, return_lse=True,
                                              **kw),
         4 * q.numel() * 2 + rows_io // 2, 2 * product,
         lambda: sdpa(qt, kt, vt), timed=True, timer=time_ms_eager)
    case("flash_attention_bwd_dq", "ERNI", shape,
         lambda: FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)[0],
         lambda: FA.flash_attention_bwd_reference(
             q, k, v, o, lse, do, **kw)[0],
         5 * q.numel() * 2 + rows_io, 3 * product, lib_bwd, timed=True,
         timer=time_ms_eager,
         kernel_only=lambda: FA._dq_kernel(q, k, v, do, lse, delta, **kw))
    case("flash_attention_bwd_dkdv", "ERNI", shape,
         lambda: FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)[1:],
         lambda: FA.flash_attention_bwd_reference(
             q, k, v, o, lse, do, **kw)[1:],
         6 * q.numel() * 2 + rows_io, 4 * product, lib_bwd, timed=True,
         timer=time_ms_eager,
         kernel_only=lambda: FA._dkdv_kernel(q, k, v, do, lse, delta, **kw))
    kc = dict(causal=True, scale=kw["scale"])
    o_c, lse_c = FA.flash_attention_reference(q, k, v, return_lse=True, **kc)
    faults = {
        "flash_attention": (
            FA.flash_attention_reference(q, k, v, **kc),
            FA.flash_attention_reference(q, k, v, **kw)),
        "flash_attention_bwd": (
            FA.flash_attention_bwd_reference(q, k, v, o_c, lse_c, do, **kc),
            FA.flash_attention_bwd_reference(q, k, v, o, lse, do, **kw))}
    for name, (bad, want) in faults.items():
        if isinstance(bad, torch.Tensor):
            bad, want = (bad,), (want,)
        caught = not all(bool((a.float() - w.float()).abs().le(
            KERNEL_ATOL + KERNEL_RTOL * w.float().abs()).all())
            for a, w in zip(bad, want))
        log(f"    {name} D=64 non-causal: the causal-mask fault "
            f"{'fails the check' if caught else 'PASSES the check'}")
        if not caught:
            failures.append(f"{name} D=64: the causal-mask fault passes "
                            "the check")
    del q, k, v, do, o, lse, delta, qt, kt, vt, ot, dot, lib_bwd, faults
    del o_c, lse_c, bad, want
    torch.cuda.empty_cache()

    # the selective scan (B17, B18), fp32: Mamba-0.2B's training shape
    # (B=8, T=2048, Ei=2048, N=16; timed, the forward saving its states as
    # the training step runs it), its prefill shape with a carried state,
    # and a ragged one (T off every tile, Ei over seven channel blocks).
    # Held by ``SS.mismatch`` (1e-4 of each output's largest value plus
    # 1e-4 of itself); at the prefill and ragged shapes planted faults must
    # fail the same check. No one torch call computes either function:
    # library_ms is null.
    gen9 = make_generator(SEED + 9, dev)

    def rnf(*shape):
        return torch.randn(*shape, generator=gen9, device=dev)
    for geo, (nb, T, Ei, N), with_h0 in (
            ("train", (MAMBA_B, MAMBA_T, 2048, 16), False),
            ("pref", (MAMBA_SERVE_B, T0, 2048, 16), True),
            ("rag", (3, 300, 200, 16), True)):
        A_ = -(torch.arange(1, N + 1, device=dev).float()
               * (1 + 0.1 * rnf(Ei, N)))
        args = (rnf(nb, T, Ei), torch.nn.functional.softplus(rnf(nb, T, Ei)),
                A_, rnf(nb, T, N), rnf(nb, T, N), rnf(Ei),
                rnf(nb, Ei, N) if with_h0 else None)
        h0 = args[6]
        dy, dh_last = rnf(nb, T, Ei), rnf(nb, Ei, N) if with_h0 else None
        timed = geo == "train"
        el, st, bn = nb * T * Ei * 4, nb * Ei * N * 4, nb * T * N * 4
        # The bounds count what the function needs, not the kernels'
        # design: boundary states for the backward at the Pallas kernel's
        # 128-step chunk (the kernels save one every 16 steps at N=16, 8×
        # the bytes), dB, dC and dA fully reduced (the kernels write
        # per-channel-block and per-batch-row partials).
        bounds = nb * -(-T // 128) * Ei * N * 4
        small = Ei * N * 4 + 2 * bn          # A, B, C; or dA, dB, dC
        h_io = st * (2 if with_h0 else 1)    # h_T written, h0 read
        shape = f"[{nb},{T},{Ei}] N{N}{' h0' if with_h0 else ''}"
        scan_tol = "scan mismatch<=1"
        # u, Δ, A, B, C, D read, y written, the boundary states written
        case("selective_scan", geo, shape,
             lambda: SS.selective_scan(*args[:6], initial_state=h0,
                                       return_state=True),
             lambda: SS.selective_scan_reference(*args),
             3 * el + small + Ei * 4 + h_io + bounds,
             6 * nb * T * Ei * N, timed=timed, timer=time_ms_eager,
             kernel_only=lambda: SS._fwd_kernel(*args[:6], h0, save=True),
             mismatch=SS.mismatch, tol=scan_tol, ops_rate=FP32_OPS_PER_S)
        hsave = SS._fwd_kernel(*args[:6], h0, save=True)[1]
        # u, Δ, dy, A, B, C and the boundary states read, du, dΔ, dA, dB,
        # dC written; with h0, dh_T read and dh0 written
        case("selective_scan_bwd", geo, shape,
             lambda: SS._bwd_kernel(*args[:5], hsave, dy, dh_last),
             lambda: SS.selective_scan_bwd_reference(*args[:5], dy, h0,
                                                     dh_last),
             5 * el + 2 * small + (2 * st if with_h0 else 0) + bounds,
             20 * nb * T * Ei * N, timed=timed, timer=time_ms_eager,
             mismatch=SS.mismatch, tol=scan_tol, ops_rate=FP32_OPS_PER_S)
        if not timed:
            fwd_bad, bwd_bad = scan_faults(args, dy, dh_last)
            readings = {}
            for kern, bad_set, want in (
                    ("selective_scan", fwd_bad,
                     SS.selective_scan_reference(*args)),
                    ("selective_scan_bwd", bwd_bad,
                     SS.selective_scan_bwd_reference(*args[:5], dy, h0,
                                                     dh_last))):
                for fault, bad in bad_set.items():
                    readings[f"{kern}: {fault}"] = SS.mismatch(bad, want)
            rows[-1]["faults"] = readings
            log(f"    selective_scan {geo} planted faults (must exceed 1): "
                f"{readings}")
            for fault, r in readings.items():
                if r <= 1.0:
                    failures.append(f"{fault} {geo}: the planted fault "
                                    f"passes the check ({r})")
            del fwd_bad, bwd_bad
        del args, dy, dh_last, hsave, A_, h0
        torch.cuda.empty_cache()

    # decode attention on the int8 cache (B9-int8) at phase 3's cache
    # (Llama-2-7B, B=4, S=160), quantized from random bf16 k and v whose
    # per-position magnitudes spread over 0.3-3; bf16, held at
    # KERNEL_ATOL + KERNEL_RTOL·|ref|. SDPA over the dequantized bf16
    # prefix plus the new k/v is recorded beside it as a yardstick (it
    # reads bf16, not the int8 cache: not the same function, so
    # library_ms is null); planted faults must fail the check.
    L8, S8, H8, D8 = 32, T0 + NEW, 32, 128
    raw = [(rnf(L8 * B, H8, S8, D8) * (0.3 + 2.7 * torch.rand(
        L8 * B, H8, S8, 1, generator=gen9, device=dev))).to(bf16)
        for _ in range(2)]
    (kq, ks), (vq, vs) = (_quant_chunk(r) for r in raw)
    del raw
    cache8 = tuple(t.reshape(L8, B, *t.shape[1:]) for t in (kq, vq, ks, vs))
    del kq, vq, ks, vs
    qd, kn, vn = (rnf(*s_).to(bf16) for s_ in ((B, 1, H8, D8),
                                               (B, H8, 1, D8),
                                               (B, H8, 1, D8)))
    mean_fill = T0 + (NEW - 2) // 2
    for idx in (1, 77, T0, mean_fill, S8 - 1):
        timed = idx == mean_fill
        case("decode_attention_int8", "7B",
             f"cache int8[{L8},{B},{H8},{S8},{D8}] Hq{H8} index {idx}",
             layer_walk(lambda lay, i=idx: DA.decode_attention(
                 qd, kn, vn, cache8, lay, i), L8),
             layer_walk(lambda lay, i=idx: DA.decode_attention_int8_reference(
                 qd, kn, vn, cache8, lay, i), L8),
             2 * B * H8 * idx * (D8 + 4) + 2 * (2 * qd.numel()
                                                 + 2 * kn.numel()),
             4 * B * H8 * D8 * (idx + 1), timed=timed)
        if timed:
            qs = qd.transpose(1, 2)
            kv = [tuple(torch.cat([(c[lay, :, :, :idx].to(bf16)
                                    * s_[lay, :, :, :idx].to(bf16)[..., None]),
                                   new], 2)
                        for c, s_, new in ((cache8[0], cache8[2], kn),
                                           (cache8[1], cache8[3], vn)))
                  for lay in range(L8)]
            rows[-1]["sdpa_dequantized_bf16_ms"] = time_ms(layer_walk(
                lambda lay: sdpa(qs, *kv[lay]), L8))
            want = DA.decode_attention_int8_reference(qd, kn, vn, cache8, 0,
                                                      idx)
            faults = {}
            for fault, bad_cache in int8_faults(cache8).items():
                bad = DA.decode_attention_int8_reference(qd, kn, vn,
                                                         bad_cache, 0, idx)
                faults[fault] = (bad.float() - want.float()).abs().max().item()
                if bool(((bad.float() - want.float()).abs() <= KERNEL_ATOL
                         + KERNEL_RTOL * want.float().abs()).all()):
                    failures.append(f"decode_attention_int8: the planted "
                                    f"fault '{fault}' passes the check")
            rows[-1]["faults_max_abs"] = faults
            log(f"    decode_attention_int8 SDPA over the dequantized bf16 "
                f"prefix {rows[-1]['sdpa_dequantized_bf16_ms']:.4f} ms "
                f"(yardstick); planted faults' max abs error (must fail "
                f"the check): {faults}")
            del kv, want, bad
    del cache8, qd, kn, vn
    torch.cuda.empty_cache()
    # softmax cross-entropy (B14, B15): the dense loss's shape in phase 14
    # (fp32, V = 256, DENSE_B·(DENSE_T - 1) rows padded to the row block,
    # timed first: the JSON line's row), the JAX source's dispatch shapes
    # (softmax_xent.py:34-37: N = 8192, V = 1024 and 2048, fp32 and bf16)
    # and, through F.softmax_with_cross_entropy, a ragged N whose rows are
    # padded. B14 is held by xent_mismatch("lse"), the loss's gradient
    # (B15 and the one-hot term outside it) by xent_mismatch("dx ...");
    # at N = 8192, V = 2048, fp32 the planted faults must fail the same
    # checks. Yardsticks: torch.logsumexp (B14) and softmax·g (B15).
    from paddle_tpu_torch.kernels import softmax_xent as SX
    from paddle_tpu_torch.nn import functional as TF
    gen14 = make_generator(SEED + 14, dev)

    def plain(fn):
        def run_plain():
            with _support.force_reference():
                return fn()
        return run_plain

    n_dense = DENSE_B * (DENSE_T - 1)
    n_dense += SX.row_pad(n_dense)
    for n, v, dt in ((n_dense, 256, torch.float32),
                     (8192, 1024, torch.float32), (8192, 2048, torch.float32),
                     (8192, 1024, bf16), (8192, 2048, bf16)):
        x = (torch.randn(n, v, generator=gen14, device=dev) * 3).to(dt)
        lab = torch.randint(0, v, (n,), generator=gen14, device=dev)
        g = torch.full((n,), 1.0 / n, device=dev)   # the mean's cotangent
        lse = SX.lse_reference(x)
        esz = x.element_size()
        shape = f"[{n},{v}] {str(dt).split('.')[-1]}"
        case("softmax_xent_lse", "xent", shape, lambda x=x: SX.lse(x),
             lambda x=x: SX.lse_reference(x), n * v * esz + 4 * n,
             2 * n * v, lambda x=x: torch.logsumexp(x, dim=1), timed=True,
             mismatch=xent_mismatch("lse"), tol="xent lse",
             ops_rate=FP32_OPS_PER_S)
        name = f"dx {str(dt).split('.')[-1]}"
        case("softmax_xent_dx", "xent", shape,
             lambda x=x, lab=lab, g=g: xent_grad(x, lab, g),
             plain(lambda x=x, lab=lab, g=g: xent_grad(x, lab, g)),
             2 * n * v * esz + 8 * n, 3 * n * v,
             lambda x=x, g=g: torch.softmax(x, dim=1) * g[:, None],
             timed=True, mismatch=xent_mismatch(name), tol=f"xent {name}",
             kernel_only=lambda x=x, l=lse, g=g: SX.dx(x, l, g),
             plain_only=lambda x=x, l=lse, g=g: SX.dx_reference(x, l, g),
             ops_rate=FP32_OPS_PER_S)
        if n == 8192 and v == 2048 and dt == torch.float32:
            lse_f, dx_f = xent_faults(x, lab, g)
            want_dx = plain(lambda: xent_grad(x, lab, g))()
            faults = {}
            for fault, bad in lse_f.items():
                faults[fault] = xent_mismatch("lse")(bad, lse)
            for fault, bad in dx_f.items():
                faults[fault] = xent_mismatch(name)(bad, want_dx)
            rows[-1]["faults_mismatch"] = faults
            log(f"    softmax_xent planted faults' mismatch (must exceed "
                f"1): {faults}")
            for fault, m in faults.items():
                if not m > 1.0:
                    failures.append(f"softmax_xent: the planted fault "
                                    f"'{fault}' passes the check ({m})")
            del want_dx
        del x, lab, g, lse
    # the ragged N: rows padded to the row block, loss and gradient
    # through F.softmax_with_cross_entropy (ignore_index rows too)
    for v, dt in ((1024, bf16), (2048, torch.float32)):
        n = 8190
        x = (torch.randn(n, v, generator=gen14, device=dev) * 3).to(dt)
        lab = torch.randint(0, v, (n,), generator=gen14, device=dev)
        lab[::97] = -100

        def loss_and_grad(x=x, lab=lab):
            leaf = x.detach().requires_grad_()
            with torch.enable_grad():
                loss = TF.softmax_with_cross_entropy(leaf, lab)
                return loss, torch.autograd.grad(loss.float().mean(),
                                                 leaf)[0]
        name = f"dx {str(dt).split('.')[-1]}"

        def both(got, want, name=name):
            return max(xent_mismatch(name)(got[1], want[1]),
                       (got[0].float() - want[0].float()).abs().max().item()
                       / (1e-4 + (2.0 ** -7 if got[0].dtype == bf16
                                  else 1e-5) * want[0].float().abs().max()
                          .item()))
        case("softmax_xent_dx", "xent",
             f"F.softmax_with_cross_entropy [{n},{v}] "
             f"{str(dt).split('.')[-1]}", loss_and_grad,
             plain(loss_and_grad), 0, 0, mismatch=both,
             tol=f"xent {name}, loss 1e-4+rel")
        del x, lab
    torch.cuda.empty_cache()

    # decode attention over the paged pool (B10) and per slot over the
    # stacked cache (per-slot B9, float and int8) at the engine's decode
    # step: 8 slots at ENGINE_POS (0, a partial last page, full pages, the
    # table's end), Llama-2-7B heads, pages of 16 tokens, the pool
    # slots × 64 pages with each slot's table a run of a random
    # permutation of them (pages recycled across slots in no order), a
    # walk over ENGINE_CASE_LAYERS layers. B10 against its plain version
    # (paged_gather, then the stacked decode's plain version), held at
    # KERNEL_ATOL + KERNEL_RTOL·|ref|, with planted faults that must fail
    # the check, and timed beside SDPA over the gathered prefix plus the
    # new k/v (gathered outside the timed region, one call with a mask)
    # and beside the gather + B9 it replaces. Per-slot B9 against the
    # scalar form run slot by slot (bit-equal expected: the same kernel
    # arithmetic at another batch offset) and its plain version.
    from paddle_tpu_torch.kernels import paged_decode_attention as PDA
    from paddle_tpu_torch.models.generation import paged_gather
    gen10 = make_generator(SEED + 10, dev)
    SL, P, Lw, H, D = ENGINE_SLOTS, ENGINE_PAGE, ENGINE_CASE_LAYERS, 32, 128
    M = ENGINE_MAX_LEN // P
    pool = tuple(torch.randn(SL * M + 1, Lw, H, P, D, generator=gen10,
                             device=dev).to(bf16) for _ in range(2))
    perm = torch.randperm(SL * M, generator=gen10, device=dev) + 1
    table = perm.reshape(SL, M).to(torch.int32).contiguous()
    pos = torch.tensor(ENGINE_POS, dtype=torch.int32, device=dev)
    qd = torch.randn(SL, 1, H, D, generator=gen10, device=dev).to(bf16)
    kn, vn = (torch.randn(SL, H, 1, D, generator=gen10, device=dev).to(bf16)
              for _ in range(2))
    fill = sum(ENGINE_POS)
    shape = f"pool[{SL * M + 1},{Lw},{H},{P},{D}] {SL} slots pos {fill}"
    keep = (torch.arange(M * P + 1, device=dev)[None]
            < pos.long()[:, None] + 1)
    keep[:, -1] = True                             # the fresh token
    kv = []
    for lay in range(Lw):
        kc, vc = PDA.gather_layer(pool, table, lay)
        kv.append((torch.cat([kc[0], kn], 2), torch.cat([vc[0], vn], 2)))
    qs = qd.transpose(1, 2)
    mask = keep[:, None, None]
    case("paged_decode_attention", "7B", shape,
         layer_walk(lambda lay: PDA.paged_decode_attention(
             qd, kn, vn, pool, table, pos, lay), Lw),
         layer_walk(lambda lay: PDA.paged_decode_attention_reference(
             qd, kn, vn, pool, table, pos, lay), Lw),
         (2 * H * fill * D + 2 * qd.numel() + 2 * kn.numel()) * 2
         + table.numel() * 4 + SL * 4, 4 * H * D * (fill + SL),
         layer_walk(lambda lay: sdpa(qs, *kv[lay], attn_mask=mask), Lw),
         timed=True)
    del kv
    want = PDA.paged_decode_attention_reference(qd, kn, vn, pool, table,
                                                pos, 0)
    faults = {}
    for fault, bad in paged_faults(qd, kn, vn, pool, table, pos, 0).items():
        diff = (bad.float() - want.float()).abs()
        faults[fault] = diff.max().item()
        if bool((diff <= KERNEL_ATOL + KERNEL_RTOL
                 * want.float().abs()).all()):
            failures.append(f"paged_decode_attention: the planted fault "
                            f"'{fault}' passes the check")
    rows[-1]["faults_max_abs"] = faults
    # the step as the JAX engine runs it: the slots' pages gathered into a
    # stacked cache, then the per-slot decode kernel
    def gather_then_b9(lay):
        view = PDA.gather_layer(pool, table, lay)
        return DA.decode_attention(qd, kn, vn, view, 0, pos)
    got_b10 = PDA.paged_decode_attention(qd, kn, vn, pool, table, pos, 0)
    rows[-1]["gather_b9_ms"] = time_ms(layer_walk(gather_then_b9, Lw))
    rows[-1]["gather_b9_max_abs_diff"] = (
        gather_then_b9(0).float() - got_b10.float()).abs().max().item()
    log(f"    paged_decode_attention planted faults' max abs error (must "
        f"fail the check): {faults}; paged_gather + per-slot B9 "
        f"{rows[-1]['gather_b9_ms']:.4f} ms, max abs difference from B10 "
        f"{rows[-1]['gather_b9_max_abs_diff']:.3e}")
    del want, got_b10
    # per-slot B9 over the stacked cache of the same positions (S = 1024),
    # float and int8
    kc = torch.randn(Lw, SL, H, ENGINE_MAX_LEN, D, generator=gen10,
                     device=dev).to(bf16)
    vc = torch.randn(Lw, SL, H, ENGINE_MAX_LEN, D, generator=gen10,
                     device=dev).to(bf16)
    (kq, ks), (vq, vs) = (_quant_chunk(c.reshape(Lw * SL, H, -1, D))
                          for c in (kc, vc))
    caches = {"decode_attention": (kc, vc),
              "decode_attention_int8": (
                  kq.reshape(Lw, SL, H, -1, D), vq.reshape(Lw, SL, H, -1, D),
                  ks.reshape(Lw, SL, H, -1), vs.reshape(Lw, SL, H, -1))}
    del kq, vq, ks, vs
    for name, cache in caches.items():
        plain_fn = (DA.decode_attention_int8_reference if len(cache) == 4
                    else DA.decode_attention_reference)

        def slot_by_slot(lay, cache=cache):
            return torch.cat([DA.decode_attention(
                qd[b:b + 1], kn[b:b + 1], vn[b:b + 1],
                tuple(c[:, b:b + 1].contiguous() for c in cache), lay,
                int(ENGINE_POS[b])) for b in range(SL)])
        got = DA.decode_attention(qd, kn, vn, cache, 1, pos)
        per_row = slot_by_slot(1)
        same = bool(torch.equal(got, per_row))
        case(name, "7B", f"per slot, {SL} slots pos {fill} "
             f"S {ENGINE_MAX_LEN}",
             layer_walk(lambda lay, cache=cache: DA.decode_attention(
                 qd, kn, vn, cache, lay, pos), Lw),
             layer_walk(lambda lay, cache=cache, plain_fn=plain_fn:
                        plain_fn(qd, kn, vn, cache, lay, pos), Lw), 0, 0)
        rows[-1].update(equal_to_scalar_form_slot_by_slot=same,
                        per_slot_ms=time_ms(layer_walk(
                            lambda lay, cache=cache: DA.decode_attention(
                                qd, kn, vn, cache, lay, pos), Lw)))
        log(f"    {name} per slot: equal to the scalar form slot by slot: "
            f"{same}; {rows[-1]['per_slot_ms']:.4f} ms")
        if not same:
            failures.append(f"{name}: the per-slot index differs from the "
                            "scalar form run slot by slot")
        del got, per_row
    del caches, kc, vc, pool, table, qd, kn, vn
    torch.cuda.empty_cache()
    report["kernel_cases"] = rows
    torch.cuda.empty_cache()

    # ---------------------------------------------------- 3. serving path
    cfg = LlamaConfig.llama2_7b()
    L = cfg.num_layers
    t = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, generator=make_generator(
        SEED, dev))
    torch.cuda.synchronize()
    report["model_build_s"] = time.perf_counter() - t
    prompt = torch.randint(0, cfg.vocab_size, (B, T0), generator=gen,
                           device=dev)
    launches, seq3 = serve_phase(
        "main_path", "Llama-2-7B", model, prompt,
        {"rms_norm": NEW * (2 * L + 1), "rope": NEW * 2 * L,
         "flash_attention": L, "decode_attention": (NEW - 1) * L},
        LOGIT_LIMITS, run)

    # ----------------------- 11. Llama-2-7B generate with the int8 cache
    # on phase 3's model and prompt (no second 13.5 GB build; nothing
    # drawn from ``gen``, so phase 4's batch stays where it was)
    int8_launches, seq11 = serve_phase(
        "int8_serving", "Llama-2-7B, int8 KV cache", model, prompt,
        {"rms_norm": NEW * (2 * L + 1), "rope": NEW * 2 * L,
         "flash_attention": L, "decode_attention_int8": (NEW - 1) * L},
        INT8_LOGIT_LIMITS, run, probe=attention_serve_probe,
        cache_dtype=torch.int8)
    same = (seq11[:, T0:] == seq3[:, T0:]).float().mean().item()
    report["int8_serving"]["greedy_tokens_equal_to_float_cache"] = same
    log(f"int8_serving: {same:.4f} of the greedy tokens equal phase 3's "
        "float-cache tokens (recorded)")
    # ------------------- 12. Llama-2-7B through the GenerationEngine
    # phase 3's model, contiguous mode: 8 slots of 1024 positions, 16
    # greedy requests arriving ENGINE_GAP_S apart, one cancelled mid-stream;
    # the batched decode step a replayed CUDA graph
    from paddle_tpu_torch.serving import GenerationEngine
    run.vocab = cfg.vocab_size
    requests = engine_requests(cfg.vocab_size)
    t = time.perf_counter()
    with GenerationEngine(model, slots=ENGINE_SLOTS,
                          max_len=ENGINE_MAX_LEN, queue_max=0,
                          ttl_s=0) as eng:
        # warm the engine's prefill buckets and capture its step
        warm = serve_engine(eng, [(p[:16], 2) for p, _ in requests[:2]])[0]
        torch.cuda.synchronize()
        steps0 = eng.stats()
        torch.cuda.reset_peak_memory_stats()
        _support.reset_launches()
        eng.decode_steps = eng.prefill_calls = eng.prefill_calls_fresh = 0
        out12, wall = serve_engine(eng, requests, cancel=5)
        torch.cuda.synchronize()
        launches12 = dict(_support.LAUNCHES)
        expected = dict.fromkeys(launches12, 0)
        expected.update(engine_expected(eng, L, paged=False))
        expected["decode_attention"] -= L          # captured during warm-up
        expected["rms_norm"] -= 2 * L + 1
        expected["rope"] -= 2 * L
        rep = engine_report("engine", "Llama-2-7B, contiguous engine",
                            eng, out12, wall, launches12, expected, run)
        rep["warmup"] = {"requests": len(warm), "stats": steps0}
        # the decode step as a replayed graph at 8 active slots, each at the
        # traffic's mean context
        ctx = int(np.mean([len(p) + n // 2 for p, n in requests]))
        set_step_state(eng, [ctx] * ENGINE_SLOTS)
        rep["decode_graph_ms"] = time_replay(eng)
        rep["decode_graph_ctx"] = ctx
        weight_bytes = sum(p.numel() * p.element_size()
                           for p in model.parameters())
        rep["decode_bound_ms"] = (weight_bytes + 2 * ENGINE_SLOTS * ctx * L
                                  * cfg.num_kv_heads * cfg.head_dim * 2
                                  ) / HBM_BYTES_PER_S * 1e3
        log(f"engine decode step replayed as a CUDA graph at "
            f"{ENGINE_SLOTS} slots of {ctx} positions: "
            f"{rep['decode_graph_ms']:.3f} ms (weights and cache bound "
            f"{rep['decode_bound_ms']:.3f} ms)")
    del eng, warm              # the engine's cache and graph pool
    torch.cuda.empty_cache()
    # greedy streams against solo generate, and teacher-forced logits of
    # the batched step against solo forwards (kernels), the bf16-attention
    # control (solo, plain versions in the JAX einsum arms' numerics)
    solo = []
    for (p, n), o in zip(requests, out12):
        ids = torch.as_tensor(p, dtype=torch.long, device=dev)[None]
        solo.append(model.generate(ids, len(o["tokens"]))[0, len(p):]
                    .tolist())
    rep["greedy_vs_solo"] = greedy_agreement(out12, solo)
    log(f"engine greedy tokens equal to solo generate: "
        f"{rep['greedy_vs_solo']}")
    seqs = [(p, o["tokens"]) for (p, _), o in zip(requests, out12)
            if o["error"] is None][:ENGINE_SLOTS]
    want = engine_teacher(model, seqs, "solo")
    got = engine_teacher(model, seqs, "contiguous")
    with _support.force_reference(), bf16_attention(decode=True):
        ctrl = engine_teacher(model, seqs, "solo")
    engine_logits_check("engine", rep, got, want, ctrl, ENGINE_LOGIT_LIMITS,
                        run)
    rep["phase_s"] = time.perf_counter() - t
    del want, ctrl
    torch.cuda.empty_cache()

    # ------------------------------- 13. the paged engine, same model
    # pages of 16 tokens, the pool slots × 64 pages, prefill in chunks of
    # 256; 4 requests share a 256-token prefix, one prompt has 900 tokens
    t = time.perf_counter()
    requests13 = paged_requests(cfg.vocab_size)
    with GenerationEngine(model, slots=ENGINE_SLOTS,
                          max_len=ENGINE_MAX_LEN, queue_max=0, ttl_s=0,
                          paged=True, page_tokens=ENGINE_PAGE,
                          prefill_chunk=ENGINE_CHUNK) as eng:
        serve_engine(eng, [(p[:16], 2) for p, _ in requests13[4:6]])
        eng.clear_prefix_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _support.reset_launches()
        eng.decode_steps = eng.prefill_calls = eng.prefill_calls_fresh = 0
        hits0 = get_stat("gen/prefix_hits")
        out13, wall = serve_engine(eng, requests13)
        torch.cuda.synchronize()
        launches13 = dict(_support.LAUNCHES)
        expected = dict.fromkeys(launches13, 0)
        expected.update(engine_expected(eng, L, paged=True))
        expected["paged_decode_attention"] -= L     # captured in warm-up
        expected["rms_norm"] -= 2 * L + 1
        expected["rope"] -= 2 * L
        rep = engine_report("paged_engine", "Llama-2-7B, paged engine", eng,
                            out13, wall, launches13, expected, run)
        st = eng.stats()
        rep["prefix_hits"] = get_stat("gen/prefix_hits") - hits0
        rep["pages_balanced"] = (st["pages_free"] + st["prefix_entries"]
                                 == st["pages"])
        log(f"paged_engine: {rep['prefix_hits']} prefix hits; pages_free "
            f"{st['pages_free']} + prefix_entries {st['prefix_entries']} "
            f"== pages {st['pages']}: {rep['pages_balanced']}")
        if rep["prefix_hits"] < 1 or not rep["pages_balanced"]:
            failures.append(f"paged_engine: no prefix hit "
                            f"({rep['prefix_hits']}) or the pool does not "
                            f"balance: {st}")
        M = ENGINE_MAX_LEN // ENGINE_PAGE
        ctx = int(np.mean([len(p) + n // 2 for p, n in requests13]))
        tables = torch.arange(1, ENGINE_SLOTS * M + 1).reshape(
            ENGINE_SLOTS, M)
        set_step_state(eng, [ctx] * ENGINE_SLOTS, tables)
        rep["decode_graph_ms"] = time_replay(eng)
        rep["decode_graph_ctx"] = ctx
        # the same step as the JAX engine runs it: the slots' pages
        # gathered into a stacked cache, then per-slot B9 (a graph too)
        def gather_step():
            view = tuple(torch.stack([paged_gather(eng._cache, r)[i][:, 0]
                                      for r in eng._pt_buf], 1)
                         for i in range(2))
            return model.forward_with_cache(eng._tok_buf, view,
                                            eng._pos_buf)[0][:, -1]
        b10_logits = eng._step_logits().float()
        gb9_logits = gather_step().float()
        rep["b10_vs_gather_b9"] = compare_logits(b10_logits[:, None],
                                                 gb9_logits[:, None])
        rep["gather_b9_step_ms"] = time_ms(gather_step, reps=5, inner=2)
        log(f"paged_engine decode step replayed as a CUDA graph at "
            f"{ENGINE_SLOTS} slots of {ctx} positions: "
            f"{rep['decode_graph_ms']:.3f} ms; the step with paged_gather + "
            f"per-slot B9 instead of B10 {rep['gather_b9_step_ms']:.3f} ms, "
            f"its logits against B10's {rep['b10_vs_gather_b9']}")
        if not logits_within(rep["b10_vs_gather_b9"], ENGINE_LOGIT_LIMITS):
            failures.append(f"paged_engine: B10's step disagrees with "
                            f"paged_gather + B9: {rep['b10_vs_gather_b9']}")
        del b10_logits, gb9_logits
    del eng                    # the pool and the graph's memory
    torch.cuda.empty_cache()
    solo13 = []
    for (p, n), o in zip(requests13, out13):
        ids = torch.as_tensor(p, dtype=torch.long, device=dev)[None]
        solo13.append(model.generate(ids, len(o["tokens"]))[0, len(p):]
                      .tolist())
    rep["greedy_vs_solo"] = greedy_agreement(out13, solo13)
    log(f"paged_engine greedy tokens equal to solo generate: "
        f"{rep['greedy_vs_solo']}")
    # teacher-forced logits of the paged step against the contiguous one,
    # both prefilling in the engine's chunks (a chunk after the first
    # through the chunk arm, as the JAX engine runs it, in both); the
    # control: the contiguous run with the plain versions in the JAX
    # einsum arms' bf16 numerics
    seqs = [(p, o["tokens"]) for (p, _), o in zip(requests13, out13)
            if o["error"] is None][:ENGINE_SLOTS]
    _support.reset_launches()
    got = engine_teacher(model, seqs, "paged", chunk=ENGINE_CHUNK)
    want = engine_teacher(model, seqs, "contiguous", chunk=ENGINE_CHUNK)
    with _support.force_reference(), bf16_attention(decode=True):
        ctrl = engine_teacher(model, seqs, "contiguous", chunk=ENGINE_CHUNK)
    engine_logits_check("paged_engine", rep, got, want, ctrl,
                        ENGINE_LOGIT_LIMITS, run)
    rep["phase_s"] = time.perf_counter() - t
    del got, want, ctrl
    torch.cuda.empty_cache()
    del model, seq3, seq11
    torch.cuda.empty_cache()

    # --------------------------------------------------- 4. training path
    tcfg = dataclasses.replace(LlamaConfig.llama2_7b(),
                               num_layers=TRAIN_LAYERS)
    TL = tcfg.num_layers
    ids = torch.randint(0, tcfg.vocab_size, (TRAIN_B, TRAIN_T),
                        generator=gen, device=dev)

    def llama(cfg):
        return lambda: LlamaForCausalLM(cfg, device=dev,
                                        generator=make_generator(SEED, dev))

    train_launches = train_phase(
        "training", f"Llama-2-7B widths, {TL} of 32 layers", llama(tcfg),
        {"input_ids": ids, "labels": ids},
        {"rms_norm": 4 * TL + 1, "rms_norm_bwd": 2 * TL + 1, "rope": 6 * TL,
         "flash_attention": 2 * TL, "flash_attention_bwd_dq": TL,
         "flash_attention_bwd_dkdv": TL, "adamw": 9 * TL + 3},
        TRAIN_LIMITS, run, expected_loss=math.log(tcfg.vocab_size),
        n_params=tcfg.num_params(), hidden=tcfg.hidden_size, n_layers=TL)

    # ----------------------------------- 5. bench.py's training config
    bcfg = LlamaConfig(
        vocab_size=32000, hidden_size=2048, intermediate_size=5632,
        num_layers=BENCH_LAYERS, num_heads=16, num_kv_heads=16,
        max_seq_len=BENCH_T, dtype="bfloat16", remat=True,
        remat_policy="save_mlp_dots_attn", lm_head_mode="fused")
    BL = bcfg.num_layers
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, bcfg.vocab_size, (BENCH_B, BENCH_T))).to(dev)

    @contextlib.contextmanager
    def bf16_head_logits():
        # the head's logits rounded to bf16 (the JAX dense head's
        # numerics), which attention's own differences hide in the whole
        # step: recorded; phase 2 holds the head against it
        saved = LX._tile_logits
        LX._tile_logits = rounded_logits
        try:
            yield
        finally:
            LX._tile_logits = saved

    # the flash forward runs twice a layer under save_mlp_dots_attn too:
    # the saved wo output does not spare wo's input (nn/scan.py)
    bench_launches = train_phase(
        "bench", f"bench.py's Llama (~{bcfg.num_params() / 1e9:.2f} B "
        f"parameters, {BL} layers)", llama(bcfg),
        {"input_ids": ids, "labels": ids},
        {"rms_norm": 4 * BL + 1, "rms_norm_bwd": 2 * BL + 1, "rope": 6 * BL,
         "flash_attention": 2 * BL, "flash_attention_bwd_dq": BL,
         "flash_attention_bwd_dkdv": BL, "adamw": 9 * BL + 3,
         "linear_xent_fwd": 1, "linear_xent_dh": 1, "linear_xent_dw": 1},
        BENCH_LIMITS, run, expected_loss=math.log(bcfg.vocab_size),
        n_params=bcfg.num_params(), hidden=bcfg.hidden_size, n_layers=BL,
        extra_controls={"head control": bf16_head_logits})
    report["bench"]["config"] = dataclasses.asdict(bcfg)

    # ------------------------------------------ 6. GPT-3 6.7B generate
    gcfg = GPTConfig.gpt3_6_7b()
    GL = gcfg.num_layers
    t = time.perf_counter()
    model = GPTForCausalLM(gcfg, device=dev,
                           generator=make_generator(SEED, dev))
    torch.cuda.synchronize()
    report["gpt_model_build_s"] = time.perf_counter() - t
    prompt = torch.randint(0, gcfg.vocab_size, (B, T0),
                           generator=make_generator(SEED + 6, dev),
                           device=dev)
    gpt_serve_launches, _ = serve_phase(
        "gpt_serving", f"GPT-3 6.7B (~{gcfg.num_params() / 1e9:.2f} B "
        "parameters)", model, prompt,
        {"layer_norm": NEW * (2 * GL + 1), "flash_attention": GL,
         "decode_attention": (NEW - 1) * GL},
        GPT_LOGIT_LIMITS, run, probe=attention_serve_probe)
    del model
    torch.cuda.empty_cache()

    # --------------------------------------- 7. GPT-3 1.3B training
    g13 = GPTConfig.gpt3_1_3b()
    GL = g13.num_layers
    ids = torch.randint(0, g13.vocab_size, (GPT_B, GPT_T),
                        generator=make_generator(SEED + 7, dev), device=dev)
    gpt_train_launches = train_phase(
        "gpt_training", f"GPT-3 1.3B (~{g13.num_params() / 1e9:.2f} B "
        f"parameters, {GL} layers)",
        lambda: GPTForCausalLM(g13, device=dev,
                               generator=make_generator(SEED, dev)),
        {"input_ids": ids, "labels": ids},
        {"layer_norm": 4 * GL + 1, "layer_norm_bwd": 2 * GL + 1,
         "flash_attention": 2 * GL, "flash_attention_bwd_dq": GL,
         "flash_attention_bwd_dkdv": GL, "adamw": 12 * GL + 5},
        {}, run, expected_loss=math.log(g13.vocab_size),
        n_params=g13.num_params(), hidden=g13.hidden_size, n_layers=GL,
        sanity=GPT_TRAIN_SANITY,
        probe=(recording_attention, attention_probe))

    # -------------------------------------- 8. ERNIE-base pretraining
    ecfg = ErnieConfig.base()
    EL = ecfg.num_layers
    gen8 = make_generator(SEED + 8, dev)
    ids = torch.randint(0, ecfg.vocab_size, (ERNIE_B, ERNIE_T),
                        generator=gen8, device=dev)
    masked = torch.rand(ids.shape, generator=gen8, device=dev) < 0.15
    labels = torch.where(masked, ids, torch.full_like(ids, -100))
    sop = torch.randint(0, 2, (ERNIE_B,), generator=gen8, device=dev)
    ernie_launches = train_phase(
        "ernie", f"ERNIE-base ({EL} layers, E {ecfg.hidden_size}, dropout "
        f"{ecfg.dropout})",
        lambda: ErnieForPretraining(ecfg, device=dev,
                                    generator=make_generator(SEED, dev)),
        {"input_ids": ids, "labels": labels, "sop_labels": sop},
        {"layer_norm": 2 * EL + 2, "layer_norm_bwd": 2 * EL + 2,
         "flash_attention": EL, "flash_attention_bwd_dq": EL,
         "flash_attention_bwd_dkdv": EL, "adamw": None},
        {}, run, expected_loss=math.log(ecfg.vocab_size) + math.log(2),
        n_params=None, hidden=ecfg.hidden_size, n_layers=EL,
        sanity=ERNIE_SANITY,
        probe=(recording_attention, attention_probe))
    report["ernie"]["mlm_share"] = masked.float().mean().item()

    # ------------------------------------------- 9. Mamba-0.2B generate
    mcfg = MambaConfig(vocab_size=50304, hidden_size=1024, num_layers=24,
                       dtype="bfloat16")
    ML = mcfg.num_layers
    model = MambaForCausalLM(mcfg, device=dev,
                             generator=make_generator(SEED, dev))
    prompt = torch.randint(0, mcfg.vocab_size, (MAMBA_SERVE_B, T0),
                           generator=make_generator(SEED + 10, dev),
                           device=dev)
    # a decode step reads and writes every layer's conv tail and state
    state_bytes = 2 * sum(t.numel() * t.element_size()
                          for t in model.init_cache(MAMBA_SERVE_B))
    mamba_serve_launches, _ = serve_phase(
        "mamba_serving", f"Mamba ({mcfg.num_params() / 1e6:.1f} M "
        f"parameters, {ML} layers)", model, prompt,
        {"selective_scan": ML, "rms_norm": NEW * (ML + 1)},
        MAMBA_LOGIT_LIMITS, run, probe=scan_serve_probe, control=bf16_state,
        state_bytes=state_bytes)
    report["mamba_serving"]["config"] = dataclasses.asdict(mcfg)
    del model
    torch.cuda.empty_cache()

    # -------------------------------------- 10. Mamba-0.2B training
    mtcfg = dataclasses.replace(mcfg, remat=True)
    ids = torch.randint(0, mtcfg.vocab_size, (MAMBA_B, MAMBA_T),
                        generator=make_generator(SEED + 11, dev), device=dev)
    # FLOPs share: 6·N per token (n_layers=0 drops the attention term)
    mamba_train_launches = train_phase(
        "mamba_training", f"Mamba ({mtcfg.num_params() / 1e6:.1f} M "
        f"parameters, {ML} layers, recompute)",
        lambda: MambaForCausalLM(mtcfg, device=dev,
                                 generator=make_generator(SEED, dev)),
        {"input_ids": ids, "labels": ids},
        {"selective_scan": 2 * ML, "selective_scan_bwd": ML,
         "rms_norm": 2 * ML + 1, "rms_norm_bwd": ML + 1, "adamw": None},
        MAMBA_TRAIN_LIMITS, run, expected_loss=math.log(mtcfg.vocab_size),
        n_params=mtcfg.num_params(), hidden=mtcfg.hidden_size, n_layers=0,
        sanity=MAMBA_TRAIN_SANITY, control=("state control", bf16_state),
        probe=(recording_scan, scan_probe))
    report["mamba_training"]["config"] = dataclasses.asdict(mtcfg)

    # ---------------------------- 14. the dense loss at V <= 2048 (B14/B15)
    # LlamaConfig.tiny() at head_dim 64, the flash kernel's smallest
    # (E = 256, 4 heads, 2 kv heads, 2 layers, V = 256, fp32, dense head)
    # through build_train_step on the card: one B14 and one B15 a step
    dcfg = LlamaConfig.tiny(hidden_size=256, num_heads=4)   # head_dim 64
    DL = dcfg.num_layers
    ids = torch.randint(0, dcfg.vocab_size, (DENSE_B, DENSE_T),
                        generator=make_generator(SEED + 14, dev), device=dev)
    dense_launches = train_phase(
        "dense_loss", f"LlamaConfig.tiny(E=256) ({DL} layers, V "
        f"{dcfg.vocab_size}, fp32, dense head)",
        lambda: LlamaForCausalLM(dcfg, device=dev,
                                 generator=make_generator(SEED, dev)),
        {"input_ids": ids, "labels": ids},
        {"rms_norm": 2 * DL + 1, "rms_norm_bwd": 2 * DL + 1, "rope": 4 * DL,
         "flash_attention": DL, "flash_attention_bwd_dq": DL,
         "flash_attention_bwd_dkdv": DL, "adamw": 9 * DL + 3,
         "softmax_xent_lse": 1, "softmax_xent_dx": 1},
        DENSE_LIMITS, run, expected_loss=math.log(dcfg.vocab_size),
        n_params=dcfg.num_params(), hidden=dcfg.hidden_size, n_layers=DL,
        sanity=DENSE_SANITY, control=("loss control", bf16_xent))

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_report.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    if failures:
        for msg in failures:
            print("FAIL:", msg, file=sys.stderr)
        return 1

    kernels = []
    for name in _support.KERNELS:
        row = main_case[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{_support.SOURCES[name]}.cu",
            "replaces": REPLACES[name],
            "launches": (bench_launches if name in HEAD_KERNELS
                         else gpt_train_launches if name in LN_KERNELS
                         else mamba_train_launches if name in SCAN_KERNELS
                         else int8_launches if name == "decode_attention_int8"
                         else dense_launches if name in XENT_KERNELS
                         else launches13 if name == "paged_decode_attention"
                         else train_launches if name in TRAIN_KERNELS
                         else launches)[name],
            "launches_by_path": {"serving": launches[name],
                                 "training": train_launches[name],
                                 "bench": bench_launches[name],
                                 "gpt_serving": gpt_serve_launches[name],
                                 "gpt_training": gpt_train_launches[name],
                                 "ernie": ernie_launches[name],
                                 "mamba_serving": mamba_serve_launches[name],
                                 "mamba_training":
                                     mamba_train_launches[name],
                                 "int8_serving": int8_launches[name],
                                 "engine": launches12[name],
                                 "paged_engine": launches13[name],
                                 "dense_loss": dense_launches[name]},
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["kernel"] == name),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"]})
    print(f"{card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
