#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Three phases; any failure exits non-zero and prints no result line.

1. Card and build: requires CUDA, prints the card's name and power limit
   (``nvidia-smi``), builds the four kernels from ``paddle_tpu_torch/csrc``.
2. Kernels against their plain PyTorch versions on the card, bf16, at the
   Llama-2-7B main-path shapes and again at the 70B head geometry
   (Hq=64, Hkv=8, D=128). Each kernel's median time (CUDA events after
   warm-up), its plain version's time, its bound (bytes over 3.35 TB/s or
   operations over 989 TFLOP/s, H100 SXM data sheet) and, where one torch
   call computes the same function, that call's time (``library_ms``).
3. Main path: Llama-2-7B (full width and depth, bf16, random weights from
   a seed) built on the card; ``generate`` of 32 new tokens for 4 prompts
   of 128 tokens, greedy. Every launch counter must have moved by exactly
   what the path implies. A decode step is timed on the host's clock and,
   replayed as a CUDA graph, on the device's. Then prefill and 8
   teacher-forced decode steps run again with the kernels and under
   ``force_reference()`` (the plain versions on the card): their logits
   must agree within limits that a control run with bf16 attention
   numerics must fail.

The last two lines of standard output are a JSON line of per-kernel
numbers and ``{"ok": true, "device": {...}}``. A fuller report goes to
``chiprun_out/chip_smoke_report.json``.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import torch

SEED = 1234
B, T0, NEW = 4, 128, 32
TEACHER_STEPS = 8
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_OPS_PER_S = 989e12          # H100 SXM data sheet, dense
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
# 0.0435, min cosine 0.99866 and the control 0.602, 0.0732, 0.99452: the
# limits sit between the two, and the control must fail them, so the check
# tells the kernels from attention computed in lower precision.
LOGIT_MAX_ABS = 0.45
LOGIT_MEAN_ABS = 0.06
LOGIT_MIN_COSINE = 0.997

REPLACES = {
    "rms_norm": "paddle_tpu/ops/pallas/norm.py:78",
    "rope": "paddle_tpu/ops/pallas/rope.py:48",
    "flash_attention": "paddle_tpu/ops/pallas/flash_attention.py:128",
    "decode_attention": "paddle_tpu/ops/pallas/decode_attention.py:211",
}


def log(*a):
    print(*a, flush=True)


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


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")

    from paddle_tpu_torch.device import make_generator
    from paddle_tpu_torch.kernels import _support
    from paddle_tpu_torch.kernels import decode_attention as DA
    from paddle_tpu_torch.kernels import flash_attention as FA
    from paddle_tpu_torch.kernels import norm as N
    from paddle_tpu_torch.kernels import rope as R
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn.functional import rotary_embedding

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures: list[str] = []
    report: dict = {"card": card, "device": torch.cuda.get_device_name(0)}

    # ---------------------------------------------------------- 1. build
    t = time.perf_counter()
    _support.build()
    report["build_s"] = time.perf_counter() - t
    log(f"build: {len(_support.KERNELS)} kernels in "
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
             timed=False):
        got, want = fn(), ref()
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        ok = bool((diff <= KERNEL_ATOL + KERNEL_RTOL * want.float().abs())
                  .all())
        row = {"kernel": kernel, "geometry": geometry, "shape": shape,
               "max_abs_err": err, "ok": ok}
        if timed:
            b_ms, b_by = bound(nbytes, ops)
            row.update(ms=time_ms(fn), plain_ms=time_ms(ref),
                       bound_ms=b_ms, bound_by=b_by,
                       library_ms=None if library is None
                       else time_ms(library))
            main_case.setdefault(kernel, row)
        rows.append(row)
        extra = ""
        if timed:
            lib = row["library_ms"]
            extra = (f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                     f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
                     f"library_ms={'null' if lib is None else f'{lib:.4f}'}")
        log(f"  {kernel:17s} {geometry:4s} {shape:34s} max_abs_err={err:.3e}"
            f" tol={KERNEL_ATOL}+{KERNEL_RTOL}*|ref| "
            f"{'ok' if ok else 'FAIL'}{extra}")
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
            case("decode_attention", geo,
                 f"cache[{L},{B},{Hkv},{S},{D}] Hq{Hq} index {idx}",
                 layer_walk(lambda lay, i=idx: DA.decode_attention(
                     qd, kn, vn, cache, lay, i), L),
                 layer_walk(lambda lay, i=idx: DA.decode_attention_reference(
                     qd, kn, vn, cache, lay, i), L),
                 (2 * B * Hkv * idx * D + 2 * qd.numel() + 2 * kn.numel())
                 * 2, 4 * B * Hq * D * (idx + 1),
                 timed=geo == "7B" and idx == mean_fill)
        del cache
    report["kernel_cases"] = rows
    torch.cuda.empty_cache()

    # ------------------------------------------------------ 3. main path
    cfg = LlamaConfig.llama2_7b()
    L = cfg.num_layers
    t = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, generator=make_generator(
        SEED, dev))
    torch.cuda.synchronize()
    report["model_build_s"] = time.perf_counter() - t
    prompt = torch.randint(0, cfg.vocab_size, (B, T0), generator=gen,
                           device=dev)
    model.generate(prompt[:, :16], 2)             # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _support.reset_launches()
    t = time.perf_counter()
    seq = model.generate(prompt, NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    launches = dict(_support.LAUNCHES)
    forwards = NEW                                # 1 prefill + NEW-1 steps
    expected = {"rms_norm": forwards * (2 * L + 1),
                "rope": forwards * 2 * L,
                "flash_attention": L,
                "decode_attention": (NEW - 1) * L}
    log(f"main path launches {launches} expected {expected}")
    if launches != expected:
        failures.append(f"launch counts {launches} != {expected}")
    if tuple(seq.shape) != (B, T0 + NEW) or not torch.equal(
            seq[:, :T0], prompt) or not bool(
            ((seq >= 0) & (seq < cfg.vocab_size)).all()):
        failures.append(f"generate output malformed: {tuple(seq.shape)}")

    # step times, on the warmed model
    cache = model.init_cache(B, T0 + NEW)
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
    report["main_path"] = {
        "model": "Llama-2-7B (random weights, seed %d)" % SEED,
        "batch": B, "prompt": T0, "new_tokens": NEW,
        "generate_s": gen_s, "tokens_per_s": B * NEW / gen_s,
        "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "decode_graph_ms_per_step": decode_graph_ms,
        "decode_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "card": card}
    log(f"main path on {card}: generate {gen_s * 1e3:.1f} ms "
        f"({B * NEW / gen_s:.1f} tokens/s), prefill {prefill_ms:.2f} ms, "
        f"decode {decode_ms:.3f} ms/step on the host's clock, "
        f"{decode_graph_ms:.3f} ms/step replayed as a CUDA graph "
        f"(weights-read bound "
        f"{report['main_path']['decode_bound_ms']:.3f} ms)")

    # where a decode step's time goes: torch.profiler over 4 steps
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(4):
            model.forward_with_cache(seq[:, T0 + i:T0 + i + 1], cache, T0 + i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    totals: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            totals[e.name] = totals.get(e.name, 0.0) + e.time_range.elapsed_us()
    device_us = sum(totals.values())
    by_kernel = sorted(totals.items(), key=lambda kv: -kv[1])
    report["decode_profile"] = {
        "steps": 4, "wall_us": wall_us, "device_us": device_us,
        "device_busy_share": device_us / wall_us if device_us else None,
        "top": [[k[:60], us] for k, us in by_kernel[:12]]}
    log(f"decode profile (4 steps): wall {wall_us:.0f} us, device "
        f"{device_us:.0f} us, top {report['decode_profile']['top'][:6]}")

    # teacher-forced logits, kernels against plain versions
    def teacher(reference: bool):
        ctx = (_support.force_reference() if reference
               else contextlib.nullcontext())
        with ctx:
            cache = model.init_cache(B, T0 + NEW)
            logits, cache = model.forward_with_cache(prompt, cache, 0)
            out = [logits.float()]
            for i in range(TEACHER_STEPS):
                logits, cache = model.forward_with_cache(
                    seq[:, T0 + i:T0 + i + 1], cache, T0 + i)
                out.append(logits.float())
        return torch.cat(out, dim=1)

    def einsum_arm_attention(q, k, v, *, causal=True, scale=None,
                             return_lse=False):
        """The JAX plain arm's bf16 numerics (nn/functional.py:594-611)."""
        G = q.shape[2] // k.shape[2]
        k, v = k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        Tq, Tk = q.shape[1], k.shape[1]
        mask = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril(
            Tk - Tq)
        s = s.masked_fill(~mask, torch.finfo(s.dtype).min)
        p = torch.softmax(s.float(), dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", p, v)

    def einsum_arm_decode(q, k_new, v_new, cache, layer, index, *,
                          scale=None):
        """The JAX einsum decode arm's bf16 numerics (_common.py:122-137)."""
        Bq, T, Hq, D = q.shape
        Hkv = k_new.shape[1]
        kc = cache[0][layer, :, :, :index]
        vc = cache[1][layer, :, :, :index]
        qh = q.permute(0, 2, 1, 3).reshape(Bq, Hkv, Hq // Hkv, T, D)
        s_c = (torch.einsum("bkgtd,bksd->bkgts", qh, kc) * scale).float()
        s_n = (torch.einsum("bkgtd,bkud->bkgtu", qh, k_new) * scale).float()
        p = torch.softmax(torch.cat([s_c, s_n], dim=-1), dim=-1).to(q.dtype)
        out = (torch.einsum("bkgts,bksd->bkgtd", p[..., :index], vc)
               + torch.einsum("bkgtu,bkud->bkgtd", p[..., index:], v_new))
        return out.reshape(Bq, Hq, T, D).permute(0, 2, 1, 3)

    def compare(got, want):
        diff = (got - want).abs()
        return {"max_abs": diff.max().item(), "mean_abs": diff.mean().item(),
                "min_cosine": torch.nn.functional.cosine_similarity(
                    got.flatten(0, 1), want.flatten(0, 1), dim=-1
                ).min().item(),
                "finite": bool(torch.isfinite(got).all())}

    def within_limits(r):
        return (r["finite"] and r["max_abs"] <= LOGIT_MAX_ABS
                and r["mean_abs"] <= LOGIT_MEAN_ABS
                and r["min_cosine"] >= LOGIT_MIN_COSINE)

    want = teacher(True)
    got = teacher(False)
    plain = (FA.flash_attention_reference, DA.decode_attention_reference)
    FA.flash_attention_reference = einsum_arm_attention
    DA.decode_attention_reference = einsum_arm_decode
    try:
        control = compare(teacher(True), want)
    finally:
        FA.flash_attention_reference, DA.decode_attention_reference = plain
    res = compare(got, want)
    report["logits"] = {"kernels_vs_plain": res, "control": control,
                        "limits": {"max_abs": LOGIT_MAX_ABS,
                                   "mean_abs": LOGIT_MEAN_ABS,
                                   "min_cosine": LOGIT_MIN_COSINE},
                        "ref_max_abs": want.abs().max().item(),
                        "shape": list(got.shape)}
    log(f"logits kernels vs plain: {res}; control (plain vs plain with "
        f"the JAX einsum arms' bf16 attention): {control}; limits max_abs "
        f"<= {LOGIT_MAX_ABS}, mean_abs <= {LOGIT_MEAN_ABS}, cosine >= "
        f"{LOGIT_MIN_COSINE}")
    if not (torch.isfinite(want).all() and within_limits(res)):
        failures.append(f"logits disagree: {report['logits']}")
    if within_limits(control):
        failures.append("logits check cannot tell the kernels from bf16 "
                        f"attention: the control passes it {control}")

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
            "source": f"paddle_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
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
