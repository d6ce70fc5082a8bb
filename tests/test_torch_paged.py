"""The paged KV cache, per-slot decode and the chunk arm: the port against
the JAX package on the CPU.

- ``init_paged_cache``, ``paged_gather`` and ``paged_scatter`` against
  the JAX functions on the same numpy arrays, float and int8 leaves:
  bit-exact (they move values, they compute nothing).
- B10's plain version (``paged_decode_attention_reference``: the gather,
  then the stacked decode's plain version per slot) against the JAX
  ``paged_decode_attention`` in interpret mode (``force_dispatch``) and
  its ``paged_reference``, as ``tests/test_paged_decode_attention.py``
  runs them; fp32 within 2e-5 abs/rel (another summation order).
- Per-slot B9 (an int32 ``[B]`` index, float and int8) against the
  scalar form run slot by slot: bit-exact on the CPU up to the summation
  order of a longer masked row (2e-6).
- Llama's ``forward_with_cache`` at per-slot positions (per-slot RoPE
  tables, per-slot decode, per-slot cache writes), over the stacked cache
  and over ``PagedKV``, against ``jax.vmap`` of the JAX model's
  ``forward_with_cache`` over the slots (``serving/engine.py:860-888``
  and ``:923-968``): logits and cache within 2e-5.
- The multi-token chunk at ``index > 0`` against the JAX package's
  einsum arm (``models/_common.py:118-141``), fp32 (2e-5), bf16 (one
  bf16 step of the output) and int8.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.io.checkpoint import state_dict
from paddle_tpu.models import _common as jax_common
from paddle_tpu.models import generation as jax_gen
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops.pallas import _support as jax_support

from paddle_tpu_torch import bridge
from paddle_tpu_torch.kernels import _support
from paddle_tpu_torch.kernels import decode_attention as DA
from paddle_tpu_torch.kernels import paged_decode_attention as PDA
from paddle_tpu_torch.kernels import rope as R
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models import _common as port_common
from paddle_tpu_torch.models import generation as port_gen
from paddle_tpu_torch.nn import functional as TF

pytestmark = pytest.mark.port

jax_pdk = importlib.import_module(
    "paddle_tpu.ops.pallas.paged_decode_attention")
TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pool_np(N=16, L=2, Hkv=2, P=8, D=64, quant=False, seed=0):
    rs = np.random.RandomState(seed)
    if quant:
        return (rs.randint(-127, 128, (N + 1, L, Hkv, P, D)).astype(np.int8),
                rs.randint(-127, 128, (N + 1, L, Hkv, P, D)).astype(np.int8),
                (rs.rand(N + 1, L, Hkv, P) * 0.05 + 0.001).astype(np.float32),
                (rs.rand(N + 1, L, Hkv, P) * 0.05 + 0.001).astype(np.float32))
    return (rs.randn(N + 1, L, Hkv, P, D).astype(np.float32),
            rs.randn(N + 1, L, Hkv, P, D).astype(np.float32))


def _table(B, M, N=16, seed=1):
    """Distinct live pages per slot, never the null page."""
    ids = np.random.RandomState(seed).permutation(np.arange(1, N + 1))
    return ids[:B * M].reshape(B, M).astype(np.int32)


# ------------------------------------------------ pool and page table

@pytest.mark.parametrize("quant", [False, True])
def test_init_paged_cache_matches_jax(quant):
    jm = JaxLlama(JaxConfig.tiny(), key=jax.random.PRNGKey(0))
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    jp = jax_gen.init_paged_cache(
        jm.init_cache(1, 32, dtype=jnp.int8 if quant else None), 5, 8)
    tp = port_gen.init_paged_cache(
        tm.init_cache(1, 32, dtype=torch.int8 if quant else None), 5, 8)
    assert len(tp) == len(jp) == (4 if quant else 2)
    for a, b in zip(tp, jp):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        assert not a.any()
    with pytest.raises(ValueError, match="layout"):
        port_gen.init_paged_cache(tm.init_cache(2, 32), 5, 8)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_gather_matches_jax(quant):
    pool = _pool_np(quant=quant)
    table = _table(1, 4)[0]
    want = jax_gen.paged_gather(tuple(map(jnp.asarray, pool)),
                                jnp.asarray(table))
    got = port_gen.paged_gather(tuple(map(_t, pool)), _t(table))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("index,length", [(0, None), (5, None), (13, 6)])
def test_paged_scatter_matches_jax(quant, index, length):
    """A chunk at ``index`` (page- and offset-misaligned) written through
    the table, padding past ``length`` sent to the null page: the whole
    pool equals the JAX package's after the write."""
    pool = _pool_np(quant=quant)
    table = _table(1, 4)[0]
    T = 9
    rs = np.random.RandomState(2)
    chunk = [(rs.randn(2, 1, 2, T, 64) * 50).astype(np.int8 if quant and
                                                     i < 2 else np.float32)
             if i < 2 else rs.rand(2, 1, 2, T).astype(np.float32)
             for i in range(len(pool))]
    want = jax_gen.paged_scatter(tuple(map(jnp.asarray, pool)),
                                 jnp.asarray(table),
                                 tuple(map(jnp.asarray, chunk)), index, 8,
                                 length=length)
    tpool = tuple(map(_t, pool))
    got = port_gen.paged_scatter(tpool, _t(table), tuple(map(_t, chunk)),
                                 index, 8, length=length)
    assert got is tpool                          # in place
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_paged_gather_scatter_round_trip():
    """A scatter then a gather of positions [0, index + T) reproduces the
    chunk (``tests/test_paged_cache.py:126``)."""
    pool = tuple(map(_t, _pool_np()))
    table = _t(_table(1, 4)[0])
    chunk = tuple(torch.randn(2, 1, 2, 11, 64) for _ in range(2))
    port_gen.paged_scatter(pool, table, chunk, 3, 8)
    view = port_gen.paged_gather(pool, table)
    for v, c in zip(view, chunk):
        assert torch.equal(v[:, :, :, 3:14], c)


# ------------------------------------------------------------------ B10

def _b10_inputs(B=3, Hq=4, Hkv=2, P=8, M=4, D=64, L=2, N=16, quant=False,
                seed=0):
    rs = np.random.RandomState(seed + 5)
    q = rs.randn(B, 1, Hq, D).astype(np.float32)
    kn = rs.randn(B, Hkv, 1, D).astype(np.float32)
    vn = rs.randn(B, Hkv, 1, D).astype(np.float32)
    return q, kn, vn, _pool_np(N, L, Hkv, P, D, quant, seed), \
        _table(B, M, N, seed + 1)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("pos", [(1, 1, 1), (7, 17, 32), (0, 8, 25)])
def test_paged_plain_matches_pallas_interpret(quant, pos):
    q, kn, vn, pool, table = _b10_inputs(quant=quant)
    pos = np.asarray(pos, np.int32)
    jargs = (jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
             tuple(map(jnp.asarray, pool)), jnp.asarray(table))
    with jax_support.force_dispatch():
        want = jax_pdk.paged_decode_attention(*jargs, jnp.int32(1),
                                              jnp.asarray(pos), scale=0.125)
    ref = jax_pdk.paged_reference(*jargs, 1, jnp.asarray(pos), scale=0.125)
    got = PDA.paged_decode_attention(_t(q), _t(kn), _t(vn),
                                     tuple(map(_t, pool)), _t(table),
                                     _t(pos), 1, scale=0.125)
    assert got.shape == (3, 1, 4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_paged_plain_selects_layer_and_honors_indirection(layer):
    """The same logical sequence on other physical pages gives the same
    output; each layer reads its own plane."""
    q, kn, vn, pool, table = _b10_inputs(L=3, seed=3)
    pos = _t(np.asarray([20, 9, 31], np.int32))
    args = (_t(q), _t(kn), _t(vn))
    got = PDA.paged_decode_attention(*args, tuple(map(_t, pool)), _t(table),
                                     pos, layer)
    # move every live page to another physical id
    perm = np.random.RandomState(9).permutation(np.arange(1, 17))
    moved = [np.zeros_like(p) for p in pool]
    for old, new in enumerate(perm, start=1):
        for m, p in zip(moved, pool):
            m[new] = p[old]
    table2 = perm[table - 1].astype(np.int32)
    got2 = PDA.paged_decode_attention(*args, tuple(map(_t, moved)),
                                      _t(table2), pos, layer)
    assert torch.equal(got, got2)
    with jax_support.force_dispatch():
        want = jax_pdk.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
            tuple(map(jnp.asarray, pool)), jnp.asarray(table),
            jnp.int32(layer), jnp.asarray(pos.numpy()), scale=0.125)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pos", [(1, 40, 100), (0, 33, 127)])
def test_paged_int8_bf16_matches_pallas_interpret(pos):
    """B10-int8 in bf16: the probabilities times the v scale are rounded
    to bf16 before the product with v, in the port's plain version and in
    the Pallas kernel (interpret mode). Held at two bf16 ulps of the
    output (2^-7 relative plus 2^-7 of the largest value), as
    ``test_int8_decode_bf16_matches_pallas`` holds B9-int8: the fp32 sums
    run in another order, the Pallas kernel takes each page's
    probabilities against that page's running maximum, and the output is
    rounded to bf16."""
    q, kn, vn, pool, table = _b10_inputs(P=32, quant=True, seed=6)
    pos = np.asarray(pos, np.int32)
    qb, knb, vnb = (_t(a).bfloat16() for a in (q, kn, vn))
    got = PDA.paged_decode_attention(qb, knb, vnb, tuple(map(_t, pool)),
                                     _t(table), _t(pos), 1,
                                     scale=0.125).float().numpy()
    with jax_support.force_dispatch():
        want = jax_pdk.paged_decode_attention(
            *(jnp.asarray(a.float().numpy(), jnp.bfloat16)
              for a in (qb, knb, vnb)), tuple(map(jnp.asarray, pool)),
            jnp.asarray(table), jnp.int32(1), jnp.asarray(pos), scale=0.125)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(want).max())


def _fake_launch(monkeypatch):
    """Kernels 'launch' on CPU tensors: ``use_kernel`` True, the int8
    entry a recorder (returns 0, cudaSuccess), the stream 0."""
    calls = []
    monkeypatch.setattr(_support, "use_kernel", lambda x: True)
    monkeypatch.setattr(_support, "stream_of", lambda t: 0)
    monkeypatch.setattr(PDA, "_int8_entry",
                        lambda: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(PDA, "_entry", lambda: pytest.fail(
        "the int8 pool launched the float kernel"))
    return calls


def test_paged_int8_pool_launches_its_kernel(monkeypatch):
    """On a tensor that takes the kernel, the int8 pool goes to
    ``ptt_paged_decode_attention_int8``: q, the fresh k/v, the int8 k/v
    and the two fp32 scale leaves read in place, the table and positions,
    then the sizes, layer, scale, type code and stream; its own counter
    counts it, the float one does not."""
    calls = _fake_launch(monkeypatch)
    q, kn, vn, pool, table = _b10_inputs(quant=True)
    tpool, ttable = tuple(map(_t, pool)), _t(table)
    pos = _t(np.asarray([3, 4, 5], np.int32))
    _support.reset_launches()
    out = PDA.paged_decode_attention(_t(q), _t(kn), _t(vn), tpool, ttable,
                                     pos, 1, scale=0.125)
    assert out.shape == (3, 1, 4, 64) and out.dtype == torch.float32
    (args,) = calls
    assert args[3:7] == tuple(t.data_ptr() for t in tpool)
    assert args[7:9] == (ttable.data_ptr(), pos.data_ptr())
    assert args[9] == out.data_ptr()
    # B, Hq, Hkv, L, P, M, D, layer, scale, dtype code, stream
    assert args[10:] == (3, 4, 2, 2, 8, 4, 64, 1, 0.125, 0, 0)
    assert _support.LAUNCHES["paged_decode_attention_int8"] == 1
    assert _support.LAUNCHES["paged_decode_attention"] == 0


@pytest.mark.parametrize("fault,err", [
    ("fresh k/v bf16", TypeError), ("table int64", TypeError),
    ("pos int64", TypeError), ("scales not contiguous", ValueError),
    ("k pool not contiguous", ValueError), ("scales fp64", ValueError),
    ("scales per page", ValueError)])
def test_paged_int8_wrapper_refuses_bad_arguments(monkeypatch, fault, err):
    """The int8 launch's type and contiguity checks (the kernel reads the
    pool and its scales in place): nothing launches."""
    calls = _fake_launch(monkeypatch)
    q, kn, vn, pool, table = _b10_inputs(quant=True)
    q, kn, vn, table = _t(q), _t(kn), _t(vn), _t(table)
    pool = list(map(_t, pool))
    pos = _t(np.asarray([3, 4, 5], np.int32))
    if fault == "fresh k/v bf16":
        kn = kn.bfloat16()
    elif fault == "table int64":
        table = table.long()
    elif fault == "pos int64":
        pos = pos.long()
    elif fault == "scales not contiguous":
        pool[2] = pool[2].transpose(2, 3).contiguous().transpose(2, 3)
    elif fault == "k pool not contiguous":
        pool[0] = pool[0].transpose(3, 4).contiguous().transpose(3, 4)
    elif fault == "scales fp64":
        pool[3] = pool[3].double()
    else:
        pool[2] = pool[2][..., :1]
    with pytest.raises(err):
        PDA.paged_decode_attention(q, kn, vn, tuple(pool), table, pos, 0)
    assert not calls


# ------------------------------------------------------- per-slot B9

@pytest.mark.parametrize("quant", [False, True])
def test_per_slot_decode_matches_scalar_form_slot_by_slot(quant):
    rs = np.random.RandomState(4)
    B, L, Hkv, S, D, Hq = 4, 2, 2, 40, 64, 4
    q = _t(rs.randn(B, 1, Hq, D).astype(np.float32))
    kn = _t(rs.randn(B, Hkv, 1, D).astype(np.float32))
    vn = _t(rs.randn(B, Hkv, 1, D).astype(np.float32))
    k, v = (_t(rs.randn(L, B, Hkv, S, D).astype(np.float32))
            for _ in range(2))
    if quant:
        (kq, ks), (vq, vs) = (port_common._quant_chunk(
            c.reshape(L * B, Hkv, S, D)) for c in (k, v))
        cache = (kq.reshape(L, B, Hkv, S, D), vq.reshape(L, B, Hkv, S, D),
                 ks.reshape(L, B, Hkv, S), vs.reshape(L, B, Hkv, S))
    else:
        cache = (k, v)
    index = np.asarray([0, 1, 23, S], np.int32)
    got = DA.decode_attention(q, kn, vn, cache, 1, _t(index))
    for b, i in enumerate(index):
        one = tuple(c[:, b:b + 1] for c in cache)
        want = DA.decode_attention(q[b:b + 1], kn[b:b + 1], vn[b:b + 1],
                                   one, 1, int(i))
        np.testing.assert_allclose(got[b:b + 1].numpy(), want.numpy(),
                                   rtol=2e-6, atol=2e-6, err_msg=f"slot {b}")
    with pytest.raises(ValueError, match="int32"):
        DA.decode_attention(q, kn, vn, cache, 1, _t(index).long())


def test_per_row_rope_tables_match_shared_tables_row_by_row():
    rs = np.random.RandomState(6)
    x = _t(rs.randn(3, 1, 4, 16).astype(np.float32))
    pos = torch.tensor([0, 7, 30])
    cos, sin = TF.rotary_embedding(pos[:, None], 16)          # [B, 1, 8]
    got = R.apply_rotary(x, cos, sin)
    for b in range(3):
        c1, s1 = TF.rotary_embedding(pos[b:b + 1], 16)         # [1, 8]
        assert torch.equal(got[b:b + 1], R.apply_rotary(x[b:b + 1], c1, s1))
    with pytest.raises(ValueError, match="tables"):
        R.apply_rotary(x, cos[:2], sin[:2])


# ------------------------------------ the model at per-slot positions

@pytest.fixture(scope="module")
def pair():
    jm = JaxLlama(JaxConfig.tiny(), key=jax.random.PRNGKey(5))
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    bridge.load_jax_state_dict(tm, state_dict(jm))
    return jm, tm


def _prefilled(jm, tm, lens, S, quant=False):
    """A stacked port cache [L, B, ...] and a JAX slot cache [B, L, 1, ...]
    each slot prefilled with its own prompt of ``lens[b]`` tokens (the
    int8 layout with ``quant``)."""
    rs = np.random.RandomState(7)
    tc = tm.init_cache(len(lens), S, dtype=torch.int8 if quant else None)
    jslots = []
    for b, n in enumerate(lens):
        ids = rs.randint(0, 256, (1, n)).astype(np.int32)
        tm.forward_with_cache(_t(ids).long(), tuple(c[:, b:b + 1]
                                                    for c in tc), 0)
        _, jc = jm.forward_with_cache(
            jnp.asarray(ids), jm.init_cache(1, S, dtype=jnp.int8 if quant
                                            else None), 0)
        jslots.append(jc)
    jcache = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jslots)
    return tc, jcache


def test_batched_step_at_per_slot_positions_matches_vmapped_jax(pair):
    """One token a slot at positions (3, 9, 14): the contiguous engine
    step against ``jax.vmap`` of the JAX ``forward_with_cache``."""
    jm, tm = pair
    lens, S = (3, 9, 14), 24
    tc, jcache = _prefilled(jm, tm, lens, S)
    tok = np.asarray([5, 77, 200], np.int32)
    pos = np.asarray(lens, np.int32)

    def one(cache, t, i):
        logits, cache = jm.forward_with_cache(t[None, None], cache, i)
        return logits[0, -1], cache

    want, jcache = jax.vmap(one)(jcache, jnp.asarray(tok), jnp.asarray(pos))
    _support.reset_launches()
    logits, tc = tm.forward_with_cache(_t(tok)[:, None].long(), tc, _t(pos))
    np.testing.assert_allclose(logits[:, -1].numpy(), np.asarray(want),
                               **TOL)
    for a, b in zip(tc, jcache):                 # [L, B, ...] / [B, L, 1, ...]
        np.testing.assert_allclose(a.transpose(0, 1).numpy(),
                                   np.asarray(b)[:, :, 0], **TOL)


def test_paged_step_matches_vmapped_gather_forward_scatter(pair):
    """The paged engine step (``PagedKV``: the paged decode's plain
    version, then the scatter to ``table[pos // P]`` with the inactive
    slot on the null page) against the JAX engine's paged step:
    ``paged_gather`` → ``forward_with_cache`` per slot under ``vmap``, the
    new position scattered back outside it (``engine.py:939-966``)."""
    _paged_step_vs_jax(*pair, quant=False)


def test_paged_int8_step_matches_vmapped_gather_forward_scatter(pair):
    """The same step on the int8 pool (four leaves): B10-int8's plain
    version, each layer's fresh k/v quantized (``_quant_chunk``) and the
    int8 k/v and both scale leaves scattered to ``table[pos // P]`` at
    ``pos % P``, the inactive slot's to the null page only."""
    before, after = _paged_step_vs_jax(*pair, quant=True)
    # the write: exactly the active slots' positions (slot 0 at 3 on page
    # 4, slot 2 at 14 on page 1 at offset 6), on every leaf
    for a, b in zip(after, before):
        diff = (a != b).movedim(3, 1).reshape(a.shape[0], a.shape[3], -1)
        pages = {tuple(x) for x in torch.nonzero(diff.any(-1)).tolist()}
        assert {(p, o) for p, o in pages if p} == {(4, 3), (1, 6)}


def _paged_step_vs_jax(jm, tm, quant):
    P, M, S = 8, 3, 24
    lens = (3, 9, 14)
    tc, _ = _prefilled(jm, tm, lens, S, quant)
    # the prefilled slots' positions written into pages of a pool
    table = np.asarray([[4, 0, 0], [2, 7, 0], [9, 1, 5]], np.int32)
    proto = tm.init_cache(1, S, dtype=torch.int8 if quant else None)
    tpool = port_gen.init_paged_cache(proto, 10, P)
    for b, n in enumerate(lens):
        chunk = tuple(c[:, b:b + 1, :, :n] for c in tc)
        port_gen.paged_scatter(tpool, _t(table[b]), chunk, 0, P)
    jpool = tuple(jnp.asarray(p.numpy()) for p in tpool)
    tok = np.asarray([5, 77, 200], np.int32)
    pos = np.asarray(lens, np.int32)
    active = np.asarray([True, False, True])

    def one(row, t, i, pool):
        cache = jax_gen.paged_gather(pool, row)
        logits, cache = jm.forward_with_cache(t[None, None], cache, i)
        new = tuple(jax.lax.dynamic_slice_in_dim(c, i, 1, axis=3)[:, 0, :, 0]
                    for c in cache)
        return logits[0, -1], new

    want, new = jax.vmap(one, in_axes=(0, 0, 0, None))(
        jnp.asarray(table), jnp.asarray(tok), jnp.asarray(pos), jpool)
    pages = jnp.where(jnp.asarray(active),
                      jnp.asarray(table)[jnp.arange(3), pos // P], 0)
    jpool = tuple(buf.at[pages, :, :, pos % P].set(n)
                  for buf, n in zip(jpool, new))
    before = tuple(p.clone() for p in tpool)
    kv = port_common.PagedKV(tpool, _t(table), _t(active))
    logits, _ = tm.forward_with_cache(_t(tok)[:, None].long(), kv, _t(pos))
    np.testing.assert_allclose(logits[:, -1].numpy(), np.asarray(want),
                               **TOL)
    for a, b in zip(tpool, jpool):
        live = [p for p in range(1, 11)]         # the null page is garbage
        np.testing.assert_allclose(a[live].numpy(), np.asarray(b)[live],
                                   **TOL)
    return before, tpool


# ------------------------------------------- the chunk arm at index > 0

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_chunk_arm_matches_jax_einsum_arm(dtype):
    rs = np.random.RandomState(8)
    B, T, Hq, Hkv, D, L, S = 2, 5, 4, 2, 64, 2, 40
    q, k, v = (rs.randn(B, T, h, D).astype(np.float32)
               for h in (Hq, Hkv, Hkv))
    kc, vc = (rs.randn(L, B, Hkv, S, D).astype(np.float32)
              for _ in range(2))
    if dtype == "int8":
        (kq, ks), (vq, vs) = (port_common._quant_chunk(
            _t(c).reshape(L * B, Hkv, S, D)) for c in (kc, vc))
        cache = [kq.reshape(L, B, Hkv, S, D), vq.reshape(L, B, Hkv, S, D),
                 ks.reshape(L, B, Hkv, S), vs.reshape(L, B, Hkv, S)]
        tq, tk, tv = map(_t, (q, k, v))
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        jcache = tuple(jnp.asarray(c.numpy()) for c in cache)
    elif dtype == "bfloat16":
        tq, tk, tv = (_t(a).to(torch.bfloat16) for a in (q, k, v))
        cache = [_t(c).to(torch.bfloat16) for c in (kc, vc)]
        jq, jk, jv = (jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
                      for a in (tq, tk, tv))
        jcache = tuple(jnp.asarray(c.float().numpy()).astype(jnp.bfloat16)
                       for c in cache)
    else:
        tq, tk, tv = map(_t, (q, k, v))
        cache = [_t(kc), _t(vc)]
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        jcache = tuple(map(jnp.asarray, (kc, vc)))
    _support.reset_launches()
    got, _ = port_common.cached_attention(tq, tk, tv, tuple(cache), 17,
                                          layer=1)
    want, _ = jax_common.cached_attention(jq, jk, jv, jcache, 17, layer=1)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=2.0 ** -7, atol=2e-2)
    else:
        np.testing.assert_allclose(got.numpy(), want, **TOL)
