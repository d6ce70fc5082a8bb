"""The port's CUDA kernels against their plain versions, on the card.

This module imports neither ``jax`` nor the JAX package, so it runs on a
host with a GPU and no JAX. The repository's ``tests/conftest.py`` imports
JAX, so on such a host run it without the conftest:

    python -m pytest --noconftest tests/test_torch_card.py -q

Every test skips without a CUDA device (the CPU run holds the plain
versions against the JAX package in the other ``test_torch_*`` files).
Each check comes with planted faults that must fail it, so a check too
loose to see a wrong kernel fails too; the selective scan's and the int8
cache's are ``chip_smoke.py``'s own.
"""

import math

import pytest
import torch

from chip_smoke import (int8_faults, paged_faults, scan_faults,
                        xent_faults, xent_grad, xent_mismatch)

from paddle_tpu_torch.kernels import _support
from paddle_tpu_torch.kernels import adamw as A
from paddle_tpu_torch.kernels import decode_attention as DA
from paddle_tpu_torch.kernels import flash_attention as FA
from paddle_tpu_torch.kernels import norm as N
from paddle_tpu_torch.kernels import rope as R
from paddle_tpu_torch.kernels import selective_scan as SS

pytestmark = pytest.mark.port

ADAMW_STEP = dict(lr=3e-4, step=10)
HEAD_TOL = {"linear_xent_fwd": (1e-3, 1e-4, False),
            "linear_xent_dh": (1e-3, 2.0 ** -7, True),
            "linear_xent_dw": (1e-3, 2.0 ** -7, True)}
# bf16 kernel against its plain version: output rounding (2^-8 relative)
# plus another fp32 summation order
ATOL = RTOL = 2e-2


def _adamw_state(shape, p_dtype, gen, device):
    """``((p0, m0, v0), g)``: p at Llama's init scale (0.02), g at 1e-3 in
    p's type, and fp32 moments as ``step - 1`` earlier gradients of that
    scale leave them, so that one step moves p by a few ulps even in
    bf16."""
    def rn():
        return torch.randn(*shape, generator=gen, device=device)
    s, gs = ADAMW_STEP["step"], 1e-3
    p0 = (0.02 * rn()).to(p_dtype)
    m0 = (1 - 0.9 ** (s - 1)) * gs * rn()
    v0 = (1 - 0.999 ** (s - 1)) * (gs * rn()) ** 2
    return (p0, m0, v0), (gs * rn()).to(p_dtype)


def _head_faults(plain, h, w, lab, extra):
    """The plain head with one term taken out: no label logit (forward);
    no one-hot term, and no softmax term (lse at +inf), for dH and dW."""
    no_labels = torch.full_like(lab, -100)
    if not extra:
        return [plain(h, w, no_labels)]
    lse, g = extra
    return [plain(h, w, no_labels, lse, g),
            plain(h, w, lab, torch.full_like(lse, float("inf")), g)]


def _generator():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100; the CPU run "
                    "covers the plain versions)")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    return all(torch.allclose(a.float(), b.float(), rtol=rtol, atol=atol)
               for a, b in zip(got, want, strict=True))


def _layer_norm_cases(g):
    """``(x, w, b, gr)`` in bf16 at a ragged shape and GPT's decode row
    count."""
    for n, h in ((300, 776), (4, 4096)):
        yield tuple(torch.randn(*s, generator=g, device="cuda")
                    .to(torch.bfloat16) for s in ((n, h), (h,), (h,), (n, h)))


def _ln_bwd_faults(x, w, mean, rstd, gr, want):
    """The plain backward with one term taken out: dw without x̂ (Σ g),
    db left out, dx without its mean(w·g) term."""
    r = rstd[:, None]
    xhat = (x.float() - mean[:, None]) * r
    wg = gr.float() * w.float()
    c2 = (wg * xhat).mean(-1, keepdim=True)
    return {"dw without xhat": (want[0], gr.float().sum(0), want[2]),
            "db left out": (want[0], want[1], torch.zeros_like(want[2])),
            "dx without mean(wg)": ((r * (wg - xhat * c2)).to(x.dtype),
                                    want[1], want[2])}


def _scan_inputs(g, nb, T, Ei, N, h0=True):
    """fp32 ``(u, delta, A, B, C, D, h0)`` at Mamba's scales: delta a
    softplus, A = -(1..N) jittered, the initial state random or None."""
    def rn(*s):
        return torch.randn(*s, generator=g, device="cuda")
    A = -(torch.arange(1, N + 1, device="cuda").float()
          * (1 + 0.1 * rn(Ei, N)))
    return (rn(nb, T, Ei), torch.nn.functional.softplus(rn(nb, T, Ei)), A,
            rn(nb, T, N), rn(nb, T, N), rn(Ei), rn(nb, Ei, N) if h0 else None)


def _int8_cache(g, L, nb, hkv, S, D):
    """A quantized cache (int8 k/v and per-position fp32 scales) of random
    bf16 k/v, per-position magnitudes spread over 0.3-3."""
    from paddle_tpu_torch.models._common import _quant_chunk
    raw = [torch.randn(L * nb, hkv, S, D, generator=g, device="cuda")
           * (0.3 + 2.7 * torch.rand(L * nb, hkv, S, 1, generator=g,
                                     device="cuda")) for _ in range(2)]
    (kq, ks), (vq, vs) = (_quant_chunk(r.bfloat16()) for r in raw)
    return tuple(t.reshape(L, nb, *t.shape[1:]) for t in (kq, vq, ks, vs))


@pytest.mark.parametrize("name", _support.KERNELS)
def test_kernel_on_card(name):
    """Each CUDA kernel against its plain version on the card, bf16.
    Tolerance 2e-2 abs + rel: bf16 output rounding (2^-8 relative) plus
    another fp32 summation order; AdamW, elementwise fp32, LayerNorm, the
    fused head and the fp32 selective scan are held tighter
    (``update_mismatch``, ``norm.layer_norm_mismatch`` /
    ``layer_norm_bwd_mismatch``, ``linear_xent.mismatch``,
    ``selective_scan.mismatch``), and planted faults must fail their
    checks."""
    g = _generator()

    def rn(*s):
        return torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)

    if name == "rms_norm":
        x, w = rn(5, 4096), rn(4096)
        got, want = N.rms_norm(x, w, 1e-5), N.rms_norm_reference(x, w, 1e-5)
    elif name == "rope":
        x = rn(2, 3, 8, 128)
        cos = torch.rand(3, 64, generator=g, device="cuda")
        sin = torch.rand(3, 64, generator=g, device="cuda")
        got = R.apply_rotary(x, cos, sin)
        want = R.apply_rotary_reference(x, cos, sin)
    elif name == "rms_norm_bwd":
        x, w, gr = rn(700, 4096), rn(4096), rn(700, 4096)
        _, rstd = N.rms_norm_reference(x, w, 1e-5, return_rstd=True)
        got = N.rms_norm_bwd(x, w, rstd, gr)
        want = N.rms_norm_bwd_reference(x, w, rstd, gr)
    elif name == "layer_norm":
        for x, w, b, _ in _layer_norm_cases(g):
            y = N.layer_norm(x, w, b, 1e-5)
            want = N.layer_norm_reference(x, w, b, 1e-5)
            torch.cuda.synchronize()
            assert N.layer_norm_mismatch(x, w, b, y, want) <= 1
            # planted fault: the bias left out
            bad = N.layer_norm_reference(x, w, torch.zeros_like(b), 1e-5)
            assert N.layer_norm_mismatch(x, w, b, bad, want) > 1
        return
    elif name == "layer_norm_bwd":
        for x, w, b, gr in _layer_norm_cases(g):
            _, mean, rstd = N.layer_norm_reference(x, w, b, 1e-5,
                                                   return_stats=True)
            got = N.layer_norm_bwd(x, w, mean, rstd, gr)
            want = N.layer_norm_bwd_reference(x, w, mean, rstd, gr)
            torch.cuda.synchronize()
            assert N.layer_norm_bwd_mismatch(x, w, mean, rstd, gr, got,
                                             want) <= 1
            for fault, bad in _ln_bwd_faults(x, w, mean, rstd, gr,
                                             want).items():
                assert N.layer_norm_bwd_mismatch(x, w, mean, rstd, gr, bad,
                                                 want) > 1, fault
        return
    elif name == "flash_attention":
        q, k, v = rn(2, 77, 8, 128), rn(2, 77, 2, 128), rn(2, 77, 2, 128)
        got = FA.flash_attention(q, k, v, causal=True)
        want = FA.flash_attention_reference(q, k, v, causal=True)
    elif name.startswith("flash_attention_bwd"):
        q, k, v = rn(2, 77, 8, 128), rn(2, 77, 2, 128), rn(2, 77, 2, 128)
        do = rn(2, 77, 8, 128)
        o, lse = FA.flash_attention(q, k, v, causal=True, return_lse=True)
        got = FA.flash_attention_bwd(q, k, v, o, lse, do)
        want = FA.flash_attention_bwd_reference(q, k, v, o, lse, do)
        pick = slice(0, 1) if name.endswith("_dq") else slice(1, 3)
        got, want = got[pick], want[pick]
    elif name == "adamw":
        # each output at its own scale (update_mismatch), bf16 and fp32 p;
        # a kernel that writes nothing must fail the same check
        for p_dtype in (torch.bfloat16, torch.float32):
            before, gr = _adamw_state((3, 1000), p_dtype, g, "cuda")
            got = A.adamw_update(*(t.clone() for t in before), gr,
                                 **ADAMW_STEP)
            want = A.adamw_update_reference(*(t.clone() for t in before), gr,
                                            **ADAMW_STEP)
            assert A.update_mismatch(before, gr, got, want, **ADAMW_STEP) <= 1
            assert A.update_mismatch(before, gr, before, want,
                                     **ADAMW_STEP) > 1
        return
    elif name.startswith("linear_xent"):
        # ragged: N, E and V off every tile, rows at -100, V - 1 picked;
        # held as chip_smoke holds them (``LX.mismatch``), and planted
        # faults must fail the same check
        from paddle_tpu_torch.kernels import linear_xent as LX
        h, w = rn(300, 136), (rn(136, 1003).float() * 0.05).bfloat16()
        lab = torch.randint(0, 1003, (300,), generator=g, device="cuda")
        lab[::7], lab[1] = -100, 1002
        lse, _ = LX.linear_xent_fwd_reference(h, w, lab)
        gr = torch.rand(300, generator=g, device="cuda")
        kern, plain, extra = {
            "linear_xent_fwd": (LX.linear_xent_fwd,
                                LX.linear_xent_fwd_reference, ()),
            "linear_xent_dh": (LX.linear_xent_dh,
                               LX.linear_xent_dh_reference, (lse, gr)),
            "linear_xent_dw": (LX.linear_xent_dw,
                               LX.linear_xent_dw_reference, (lse, gr))}[name]
        want = plain(h, w, lab, *extra)
        assert LX.mismatch(kern(h, w, lab, *extra), want,
                           *HEAD_TOL[name]) <= 1
        for bad in _head_faults(plain, h, w, lab, extra):
            assert LX.mismatch(bad, want, *HEAD_TOL[name]) > 1
        return
    elif name.startswith("selective_scan"):
        # fp32, held per output at 1e-4 of its largest value plus 1e-4 of
        # itself (``SS.mismatch``); T off every tile and Ei over three
        # channel blocks (the last ragged), with and without an initial
        # state; the planted faults must fail the same check
        for shape, with_h0 in (((2, 77, 80, 16), True),
                               ((1, 130, 64, 8), False)):
            args = _scan_inputs(g, *shape, h0=with_h0)
            u, h0 = args[0], args[6]
            dy = torch.randn(u.shape, generator=g, device="cuda")
            dh_last = (None if h0 is None else
                       torch.randn(h0.shape, generator=g, device="cuda"))
            fwd_bad, bwd_bad = scan_faults(args, dy, dh_last)
            if name == "selective_scan":
                got = SS.selective_scan(*args[:6], initial_state=h0,
                                        return_state=True)
                want = SS.selective_scan_reference(*args)
                bad = fwd_bad
            else:
                hsave = SS._fwd_kernel(*args[:6], h0, save=True)[1]
                got = SS._bwd_kernel(*args[:5], hsave, dy, dh_last)
                want = SS.selective_scan_bwd_reference(*args[:5], dy, h0,
                                                       dh_last)
                bad = bwd_bad
            torch.cuda.synchronize()
            assert SS.mismatch(got, want) <= 1, shape
            for fault, b in bad.items():
                assert SS.mismatch(b, want) > 1, (shape, fault)
        return
    elif name.startswith("softmax_xent"):
        # fp32 and bf16 logits, N inside the loss's gate (the dense loss
        # pads N to it; chip_smoke holds a ragged N that way); B14 held by
        # chip_smoke.xent_mismatch("lse"), the loss's gradient (B15 and the
        # one-hot term outside it) by xent_mismatch("dx <type>"); the
        # planted faults must fail the same checks
        from paddle_tpu_torch.kernels import softmax_xent as SX
        for n, v, dt in ((256, 512, torch.float32),
                         (64, 1024, torch.bfloat16)):
            x = (torch.randn(n, v, generator=g, device="cuda") * 3).to(dt)
            lab = torch.randint(0, v, (n,), generator=g, device="cuda")
            gr = torch.rand(n, generator=g, device="cuda")
            lse_faults, dx_faults = xent_faults(x, lab, gr)
            if name == "softmax_xent_lse":
                check = xent_mismatch("lse")
                got, want, bad = SX.lse(x), SX.lse_reference(x), lse_faults
            else:
                check = xent_mismatch(f"dx {str(dt).split('.')[-1]}")
                got = xent_grad(x, lab, gr)
                with _support.force_reference():
                    want = xent_grad(x, lab, gr)
                bad = dx_faults
            torch.cuda.synchronize()
            assert check(got, want) <= 1, (n, v, dt)
            for fault, b in bad.items():
                assert check(b, want) > 1, (n, v, dt, fault)
        return
    elif name == "paged_decode_attention":
        # fp32 and bf16 pools of 8-token pages, 4 slots at positions 0, a
        # partial page, full pages and the table's end, tables scattered
        # over the pool; planted faults must fail the same check
        from paddle_tpu_torch.kernels import paged_decode_attention as PDA
        for dt in (torch.float32, torch.bfloat16):
            pool = tuple(torch.randn(41, 3, 2, 8, 128, generator=g,
                                     device="cuda").to(dt)
                         for _ in range(2))
            table = (torch.randperm(40, generator=g, device="cuda")[:40]
                     .reshape(4, 10) + 1).to(torch.int32)
            pos = torch.tensor([0, 5, 24, 80], dtype=torch.int32,
                               device="cuda")
            q = torch.randn(4, 1, 8, 128, generator=g, device="cuda").to(dt)
            kn, vn = (torch.randn(4, 2, 1, 128, generator=g,
                                  device="cuda").to(dt) for _ in range(2))
            got = PDA.paged_decode_attention(q, kn, vn, pool, table, pos, 2)
            want = PDA.paged_decode_attention_reference(q, kn, vn, pool,
                                                        table, pos, 2)
            torch.cuda.synchronize()
            assert _close(got, want), dt
            for fault, bad in paged_faults(q, kn, vn, pool, table, pos,
                                           2).items():
                assert not _close(bad, want), (dt, fault)
        return
    elif name == "paged_decode_attention_int8":
        # the int8 pool of 8-token pages (int8 k/v, fp32 scales), q in fp32
        # and bf16, 4 slots at positions 0, a partial page, full pages and
        # the table's end, tables scattered over the pool; planted faults
        # (the paged ones and the int8 scales') must fail the same check
        from paddle_tpu_torch.kernels import paged_decode_attention as PDA
        raw = _int8_cache(g, 41, 3, 2, 8, 128)          # [41, 3, 2, 8, ...]
        table = (torch.randperm(40, generator=g, device="cuda")
                 .reshape(4, 10) + 1).to(torch.int32)
        pos = torch.tensor([0, 5, 24, 80], dtype=torch.int32, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(4, 1, 8, 128, generator=g, device="cuda").to(dt)
            kn, vn = (torch.randn(4, 2, 1, 128, generator=g,
                                  device="cuda").to(dt) for _ in range(2))
            got = PDA.paged_decode_attention(q, kn, vn, raw, table, pos, 2)
            want = PDA.paged_decode_attention_reference(q, kn, vn, raw,
                                                        table, pos, 2)
            torch.cuda.synchronize()
            assert _close(got, want), dt
            for fault, bad in paged_faults(q, kn, vn, raw, table, pos,
                                           2).items():
                assert not _close(bad, want), (dt, fault)
        return
    elif name == "decode_attention_int8":
        cache = _int8_cache(g, 3, 2, 2, 90, 128)
        q, kn, vn = rn(2, 1, 8, 128), rn(2, 2, 1, 128), rn(2, 2, 1, 128)
        got = DA.decode_attention(q, kn, vn, cache, 2, 41)
        want = DA.decode_attention_int8_reference(q, kn, vn, cache, 2, 41)
        torch.cuda.synchronize()
        assert _close(got, want)
        for fault, bad_cache in int8_faults(cache).items():
            bad = DA.decode_attention_int8_reference(q, kn, vn, bad_cache, 2,
                                                     41)
            assert not _close(bad, want), fault
        return
    else:
        q, kn, vn = rn(2, 1, 8, 128), rn(2, 2, 1, 128), rn(2, 2, 1, 128)
        cache = (rn(3, 2, 2, 90, 128), rn(3, 2, 2, 90, 128))
        got = DA.decode_attention(q, kn, vn, cache, 2, 41)
        want = DA.decode_attention_reference(q, kn, vn, cache, 2, 41)
    torch.cuda.synchronize()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("part", ["fwd", "dq", "dkdv"])
def test_flash_head_dim_64_non_causal_on_card(part):
    """ERNIE's attention (D=64, non-causal; a ragged T and grouped heads
    besides) through the forward, dq and dk/dv kernels against their
    plain versions, bf16 at 2e-2 abs + rel. The planted fault, the plain
    version with a causal mask, must fail the same check."""
    g = _generator()

    def rn(*s):
        return torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)

    q, k, v, do = rn(2, 93, 8, 64), rn(2, 93, 4, 64), rn(2, 93, 4, 64), \
        rn(2, 93, 8, 64)
    kw = dict(causal=False, scale=1.0 / math.sqrt(64))
    if part == "fwd":
        got = FA.flash_attention(q, k, v, **kw)
        want = FA.flash_attention_reference(q, k, v, **kw)
        bad = FA.flash_attention_reference(q, k, v, causal=True,
                                           scale=kw["scale"])
    else:
        o, lse = FA.flash_attention_reference(q, k, v, return_lse=True, **kw)
        pick = slice(0, 1) if part == "dq" else slice(1, 3)
        got = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)[pick]
        want = FA.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                **kw)[pick]
        o_c, lse_c = FA.flash_attention_reference(
            q, k, v, causal=True, scale=kw["scale"], return_lse=True)
        bad = FA.flash_attention_bwd_reference(
            q, k, v, o_c, lse_c, do, causal=True, scale=kw["scale"])[pick]
    torch.cuda.synchronize()
    assert _close(got, want)
    assert not _close(bad, want)


@pytest.mark.parametrize("quant", [False, True])
def test_per_slot_decode_on_card(quant):
    """Decode attention at a per-slot int32 index read from device memory,
    float and int8 caches: equal to the scalar form run slot by slot (the
    same kernel arithmetic), and within 2e-2 of the plain version."""
    g = _generator()
    if quant:
        cache = _int8_cache(g, 2, 4, 2, 96, 128)
        plain = DA.decode_attention_int8_reference
    else:
        cache = tuple(torch.randn(2, 4, 2, 96, 128, generator=g,
                                  device="cuda").to(torch.bfloat16)
                      for _ in range(2))
        plain = DA.decode_attention_reference
    q = torch.randn(4, 1, 8, 128, generator=g, device="cuda").bfloat16()
    kn, vn = (torch.randn(4, 2, 1, 128, generator=g, device="cuda")
              .bfloat16() for _ in range(2))
    index = [0, 7, 64, 96]
    idx = torch.tensor(index, dtype=torch.int32, device="cuda")
    got = DA.decode_attention(q, kn, vn, cache, 1, idx)
    rows = torch.cat([DA.decode_attention(
        q[b:b + 1], kn[b:b + 1], vn[b:b + 1],
        tuple(c[:, b:b + 1].contiguous() for c in cache), 1, index[b])
        for b in range(4)])
    torch.cuda.synchronize()
    assert torch.equal(got, rows)
    assert _close(got, plain(q, kn, vn, cache, 1, idx))


def test_rope_per_row_tables_on_card():
    """RoPE with [B, T, D/2] tables (each row at its own positions)
    against its plain version and against the shared-table form row by
    row."""
    g = _generator()
    from paddle_tpu_torch.nn.functional import rotary_embedding
    x = torch.randn(4, 1, 8, 128, generator=g, device="cuda").bfloat16()
    pos = torch.tensor([0, 9, 300, 1023], device="cuda")
    cos, sin = rotary_embedding(pos[:, None], 128)
    got = R.apply_rotary(x, cos, sin)
    assert _close(got, R.apply_rotary_reference(x, cos, sin))
    for b in range(4):
        assert torch.equal(got[b:b + 1], R.apply_rotary(
            x[b:b + 1], cos[b], sin[b]))


@pytest.mark.parametrize("paged", [False, True])
def test_engine_on_card(paged):
    """The GenerationEngine on the card with a small fp32 Llama: greedy
    streams (co-tenants, buckets, in paged mode shared prefix pages and
    chunked prefill) equal solo generate, the decode step runs as a
    captured CUDA graph, and the step's attention kernel is the
    contiguous cache's per-slot decode (B9) or the pool's (B10)."""
    import numpy as np

    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import GenerationEngine
    _generator()
    cfg = LlamaConfig.tiny(vocab_size=512, hidden_size=256, num_heads=2,
                           num_kv_heads=2, max_seq_len=128)
    model = LlamaForCausalLM(cfg, device="cuda")
    rs = np.random.RandomState(0)
    prefix = rs.randint(0, 512, (20,))
    prompts = [np.concatenate([prefix, rs.randint(0, 512, (n,))])
               for n in (3, 9)] + [rs.randint(0, 512, (n,))
                                   for n in (5, 40, 17)]
    _support.reset_launches()
    with GenerationEngine(model, slots=3, max_len=96, queue_max=0,
                          paged=paged, page_tokens=8,
                          prefill_chunk=16) as eng:
        gids = [eng.start(p, 12) for p in prompts]
        outs = []
        for gid in gids:
            toks = []
            for _ in range(600):
                doc = eng.poll(gid, start=len(toks), wait_s=0.1)
                toks += doc["tokens"]
                if doc["done"]:
                    break
            assert doc["done"] and doc["error"] is None
            outs.append(toks)
        st = eng.stats()
    assert st["cuda_graph"] is True
    step = "paged_decode_attention" if paged else "decode_attention"
    other = "decode_attention" if paged else "paged_decode_attention"
    assert _support.LAUNCHES[step] == cfg.num_layers * (st["decode_steps"]
                                                        + 1)
    assert _support.LAUNCHES[other] == 0
    for p, toks in zip(prompts, outs):
        ids = torch.as_tensor(p, device="cuda")[None]
        assert toks == model.generate(ids, 12)[0, len(p):].tolist()


def test_paged_int8_engine_on_card():
    """The paged engine on the int8 pool: its captured step quantizes
    each layer's fresh k/v and scatters the four leaves, B10-int8 runs L a
    step (no other decode kernel), greedy streams equal solo int8
    ``generate`` (fp32, so the int8 arithmetic is the only rounding), and
    the step's logits equal the same step through ``paged_gather`` and
    per-slot B9-int8 bit for bit."""
    import numpy as np

    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.generation import paged_gather
    from paddle_tpu_torch.serving import GenerationEngine
    _generator()
    cfg = LlamaConfig.tiny(vocab_size=512, hidden_size=256, num_heads=2,
                           num_kv_heads=2, max_seq_len=128)
    model = LlamaForCausalLM(cfg, device="cuda")
    rs = np.random.RandomState(1)
    prefix = rs.randint(0, 512, (20,))
    prompts = [np.concatenate([prefix, rs.randint(0, 512, (n,))])
               for n in (3, 9)] + [rs.randint(0, 512, (n,))
                                   for n in (5, 40, 17)]
    _support.reset_launches()
    with GenerationEngine(model, slots=3, max_len=96, queue_max=0,
                          paged=True, page_tokens=8, prefill_chunk=16,
                          cache_dtype=torch.int8) as eng:
        assert len(eng._cache) == 4 and eng._cache[0].dtype == torch.int8
        gids = [eng.start(p, 12) for p in prompts]
        outs = []
        for gid in gids:
            toks = []
            for _ in range(600):
                doc = eng.poll(gid, start=len(toks), wait_s=0.1)
                toks += doc["tokens"]
                if doc["done"]:
                    break
            assert doc["done"] and doc["error"] is None
            outs.append(toks)
        st = eng.stats()
        assert st["cuda_graph"] is True
        L = cfg.num_layers
        assert _support.LAUNCHES["paged_decode_attention_int8"] == L * (
            st["decode_steps"] + 1)
        for other in ("paged_decode_attention", "decode_attention",
                      "decode_attention_int8"):
            assert _support.LAUNCHES[other] == 0, other
        # the step at three slots' positions against gather + B9-int8
        eng._pos_buf.copy_(torch.tensor([7, 30, 61], dtype=torch.int32))
        eng._tok_buf.fill_(1)
        eng._active_buf.fill_(True)
        eng._pt_buf.copy_(torch.arange(1, 3 * 12 + 1).reshape(3, 12))
        b10 = eng._step_logits()
        view = tuple(torch.stack([paged_gather(eng._cache, r)[i][:, 0]
                                  for r in eng._pt_buf], 1)
                     for i in range(4))
        gb9 = model.forward_with_cache(eng._tok_buf, view,
                                       eng._pos_buf)[0][:, -1]
        assert torch.equal(b10, gb9)
    for p, toks in zip(prompts, outs):
        ids = torch.as_tensor(p, device="cuda")[None]
        assert toks == model.generate(ids, 12, cache_dtype=torch.int8)[
            0, len(p):].tolist()
