"""The int8-KV and int8×int8 modes of the port's cached attention (plain
versions of K2 / K3 / K6 / K7 on the CPU) against the JAX package's
Pallas kernels (interpret mode on the CPU) on the same inputs.

Tolerances:

* int8-KV outputs at 2e-5 in fp32: both sides dequantize the same
  payloads with the same scales (the JAX kernels on the score and
  probability tiles, the plain versions on the cache) and differ only in
  fp32 rounding.
* Fused-write payloads bitwise the JAX kernel's; scales bitwise the JAX
  kernels' arithmetic as written (``max|x| / 127.0`` with IEEE division,
  round half to even, the SAFE scale stored: 1.0 for an all-zero row),
  which the port follows.  The Pallas kernel itself runs compiled, and
  XLA rewrites the division by the constant 127 into a multiply by its
  fp32 reciprocal, so against the kernel's output the scales agree to
  1 ulp (eagerly, the JAX functions divide: ``_quant_rows`` is bitwise).
  The registry's ``_quant_rows`` (every other write) stores the raw scale
  (0.0 for that row), bitwise as JAX.
* int8×int8 against JAX ``int8_matmuls=True`` at ``block_k=32``: max|err|
  ≤ 1e-2 · max|out| (integer products are exact on both sides; one exp
  ulp can flip one rounding of P), and within JAX's own 0.015
  mean-relative bar against the exact dequantized result.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.transformer import decode_attention as jax_decode
from deepspeed_tpu.ops.transformer import paged_attention as jax_paged
from deepspeed_tpu.ops.transformer import registry as jax_registry
from deepspeed_tpu_torch.ops.transformer import decode_attention as pt_decode
from deepspeed_tpu_torch.ops.transformer import paged_attention as pt_paged
from deepspeed_tpu_torch.ops.transformer import registry as pt_registry

TOL = dict(rtol=2e-5, atol=2e-5)
H, D = 8, 16


def _t(x):
    return torch.from_numpy(np.array(x))


def quantize_smajor(cache, kvh):
    """[.., S, KVH*D] float → (int8 payload, [.., S, KVH] raw scales): the
    JAX tests' fixture quantizer."""
    *lead, S, KVHD = cache.shape
    r = np.asarray(cache).reshape(*lead, S, kvh, KVHD // kvh)
    s = np.max(np.abs(r), axis=-1) / 127.0
    safe = np.where(s == 0.0, 1.0, s)
    pay = np.clip(np.round(r / safe[..., None]), -127, 127)
    return (pay.reshape(*lead, S, KVHD).astype(np.int8),
            s.astype(np.float32))


def _int8_cache(rng, lead, kvh, S):
    """An int8-KV cache pair from seeded normals (k at 3x, as JAX's
    fixtures), as numpy: (k, v, k_scale, v_scale)."""
    k = (rng.standard_normal((*lead, S, kvh * D)) * 3.0).astype(np.float32)
    v = rng.standard_normal((*lead, S, kvh * D)).astype(np.float32)
    (kq, ks), (vq, vs) = quantize_smajor(k, kvh), quantize_smajor(v, kvh)
    return kq, vq, ks, vs


def _fresh_rows_ieee(new):
    """The JAX fused kernel's quantization of fresh rows [B, KVH, D] as its
    source writes it, in numpy fp32: IEEE division, the safe scale."""
    s = np.abs(new).max(axis=-1) / np.float32(127.0)
    safe = np.where(s == 0.0, np.float32(1.0), s)
    pay = np.clip(np.round(new / safe[..., None]), -127, 127)
    return pay.reshape(new.shape[0], -1).astype(np.int8), safe


def _check_fused_rows(bufs, want_bufs, before, nk, nv, positions, li):
    """After a fused write: payloads bitwise the JAX kernel's; scales
    bitwise the IEEE reference and within 1 ulp of the JAX kernel's; every
    other row untouched.  ``positions`` [B] are the written rows
    (``lengths - 1``), ``li`` the layer index tuple."""
    rows = np.arange(len(positions))
    at = li + (rows, np.asarray(positions) - 1)
    for i, new in ((0, nk), (1, nv)):
        pay, safe = _fresh_rows_ieee(new)
        np.testing.assert_array_equal(bufs[i].numpy()[at], pay)
        np.testing.assert_array_equal(bufs[i].numpy(),
                                      np.asarray(want_bufs[i]))
        np.testing.assert_array_equal(bufs[i + 2].numpy()[at], safe)
        np.testing.assert_array_max_ulp(bufs[i + 2].numpy(),
                                        np.asarray(want_bufs[i + 2]), 1)
        for t, orig in ((bufs[i], before[i]), (bufs[i + 2], before[i + 2])):
            rest = t.numpy().copy()
            rest[at] = orig[at]
            np.testing.assert_array_equal(rest, orig)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
@pytest.mark.parametrize("kvh", [8, 2])
def test_decode_int8_matches_jax(kvh, stacked, fused):
    """K2's int8-KV mode: outputs at 2e-5; the fused write's payload and
    scales bitwise the JAX kernel's, an all-zero fresh row's scale 1.0."""
    rng = np.random.default_rng(kvh + 10 * stacked + 100 * fused)
    B, S_max, L = 3, 96, 2
    lead = (L, B) if stacked else (B,)
    kq, vq, ks, vs = _int8_cache(rng, lead, kvh, S_max)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    lengths = np.asarray([70, 31, 96], np.int32)
    layer = 1 if stacked else None
    kw_j, kw_t = {}, {}
    if fused:
        nk = (rng.standard_normal((B, kvh, D)) * 3.0).astype(np.float32)
        nv = rng.standard_normal((B, kvh, D)).astype(np.float32)
        nk[1, 0] = 0.0                       # an all-zero fresh k row
        kw_j = dict(new_k=jnp.asarray(nk), new_v=jnp.asarray(nv))
        kw_t = dict(new_k=_t(nk), new_v=_t(nv))
    want = jax_decode.decode_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(lengths), block_k=32, layer=layer,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), **kw_j)
    bufs = [_t(x) for x in (kq, vq, ks, vs)]
    got = pt_decode.decode_attention(_t(q), bufs[0], bufs[1], _t(lengths),
                                     layer=layer, k_scale=bufs[2],
                                     v_scale=bufs[3], **kw_t)
    if fused:
        assert all(a is b for a, b in zip(got[1:], bufs))
        got, want, want_bufs = got[0], want[0], want[1:]
        _check_fused_rows(bufs, want_bufs, (kq, vq, ks, vs), nk, nv,
                          lengths, (layer,) if stacked else ())
        li = (layer,) if stacked else ()
        assert bufs[2].numpy()[li + (1, 30, 0)] == 1.0
        assert not bufs[0].numpy()[li + (1, 30)][:D].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
@pytest.mark.parametrize("kvh", [8, 2])
def test_chunk_prefill_int8_matches_jax(kvh, stacked):
    rng = np.random.default_rng(20 + kvh + stacked)
    B, S_max, C, L = 2, 96, 16, 2
    lead = (L, B) if stacked else (B,)
    kq, vq, ks, vs = _int8_cache(rng, lead, kvh, S_max)
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    starts = np.asarray([32, 5], np.int32)
    layer = 0 if stacked else None
    want = jax_decode.chunk_prefill_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(starts), block_k=32, layer=layer,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got = pt_decode.chunk_prefill_attention(
        _t(q), _t(kq), _t(vq), _t(starts), layer=layer, k_scale=_t(ks),
        v_scale=_t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _exact(q, kq, vq, ks, vs, lengths):
    """Attention over the explicitly dequantized cache, in numpy fp64."""
    B, S, KVHD = kq.shape
    kvh = KVHD // D
    k = (kq.reshape(B, S, kvh, D) * ks[..., None]).repeat(H // kvh, 2)
    v = (vq.reshape(B, S, kvh, D) * vs[..., None]).repeat(H // kvh, 2)
    s = np.einsum("bhd,bthd->bht", q.astype(np.float64), k) / np.sqrt(D)
    live = np.arange(S)[None] < lengths[:, None]
    s = np.where(live[:, None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bht,bthd->bhd", p, v)


@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
@pytest.mark.parametrize("kvh", [8, 2])
def test_decode_i8mm_matches_jax(kvh, stacked):
    """K2's int8×int8 mode against JAX ``int8_matmuls=True`` (same KV
    blocks of 32), and both within JAX's 0.015 mean-relative bar of the
    exact dequantized attention."""
    rng = np.random.default_rng(40 + kvh + stacked)
    B, S_max, L = 3, 96, 2
    lead = (L, B) if stacked else (B,)
    kq, vq, ks, vs = _int8_cache(rng, lead, kvh, S_max)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    q[2, 3] = 0.0                            # a head quantized at scale 1
    lengths = np.asarray([70, 31, 96], np.int32)
    layer = 1 if stacked else None
    want = np.asarray(jax_decode.decode_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(lengths), block_k=32, layer=layer,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), int8_matmuls=True))
    got = pt_decode.decode_attention(
        _t(q), _t(kq), _t(vq), _t(lengths), layer=layer, k_scale=_t(ks),
        v_scale=_t(vs), int8_matmuls=True, block_k=32).numpy()
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    li = (layer,) if stacked else ()
    exact = _exact(q, kq[li], vq[li], ks[li], vs[li], lengths)
    for out in (got, want):
        err = np.abs(out - exact).mean() / np.abs(exact).mean()
        assert err < 0.015, err


def _pool(rng, page, kvh, nvirt=4, L=2):
    """An int8 pool with a shuffled table (rows 0, 1 live, row 2 a dead
    lane on the trash page 0), as numpy."""
    n_pages = 2 * nvirt + 1
    kq, vq, ks, vs = _int8_cache(rng, (L, n_pages), kvh, page)
    perm = 1 + rng.permutation(n_pages - 1)
    pages = np.zeros((3, nvirt), np.int32)
    pages[:2] = perm.reshape(2, nvirt)
    lengths = np.asarray([2 * page + 5, nvirt * page, 0], np.int32)
    return kq, vq, ks, vs, pages, lengths


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("kvh", [8, 2])
@pytest.mark.parametrize("page", [8, 16, 64])
def test_paged_decode_int8_matches_jax(page, kvh, fused):
    """K6's int8-KV mode: live rows at 2e-5, the fused write's payloads and
    scales bitwise the JAX kernel's outside the trash page."""
    rng = np.random.default_rng(page + kvh + fused)
    kq, vq, ks, vs, pages, lengths = _pool(rng, page, kvh)
    q = rng.standard_normal((3, H, D)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if fused:
        nk = rng.standard_normal((3, kvh, D)).astype(np.float32)
        nv = rng.standard_normal((3, kvh, D)).astype(np.float32)
        kw_j = dict(new_k=jnp.asarray(nk), new_v=jnp.asarray(nv))
        kw_t = dict(new_k=_t(nk), new_v=_t(nv))
    want = jax_paged.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(lengths), jnp.asarray(pages), layer=1,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), **kw_j)
    bufs = [_t(x) for x in (kq, vq, ks, vs)]
    got = pt_paged.paged_decode_attention(
        _t(q), bufs[0], bufs[1], _t(lengths), _t(pages), layer=1,
        k_scale=bufs[2], v_scale=bufs[3], **kw_t)
    if fused:
        assert all(a is b for a, b in zip(got[1:], bufs))
        got, want, want_bufs = got[0], want[0], want[1:]
        # the live rows' written (page, row); outside the trash page the
        # pools are the JAX kernel's (payloads bitwise, scales to 1 ulp)
        w = lengths[:2] - 1
        phys, off = pages[np.arange(2), w // page], w % page
        for i, new in ((0, nk), (1, nv)):
            pay, safe = _fresh_rows_ieee(new[:2])
            np.testing.assert_array_equal(bufs[i].numpy()[1, phys, off], pay)
            np.testing.assert_array_equal(bufs[i + 2].numpy()[1, phys, off],
                                          safe)
            np.testing.assert_array_equal(bufs[i].numpy()[:, 1:],
                                          np.asarray(want_bufs[i])[:, 1:])
            np.testing.assert_array_max_ulp(
                bufs[i + 2].numpy()[:, 1:],
                np.asarray(want_bufs[i + 2])[:, 1:], 1)
    np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2], **TOL)
    assert not got[2].any()


@pytest.mark.parametrize("kvh", [8, 2])
@pytest.mark.parametrize("page", [8, 16, 64])
def test_paged_chunk_prefill_int8_matches_jax(page, kvh):
    rng = np.random.default_rng(3 * page + kvh)
    kq, vq, ks, vs, pages, _ = _pool(rng, page, kvh)
    C = 10
    q = rng.standard_normal((2, C, H, D)).astype(np.float32)
    starts = np.asarray([page + 3, 0], np.int32)
    want = jax_paged.paged_chunk_prefill_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(starts), jnp.asarray(pages[:2]), layer=1,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got = pt_paged.paged_chunk_prefill_attention(
        _t(q), _t(kq), _t(vq), _t(starts), _t(pages[:2]), layer=1,
        k_scale=_t(ks), v_scale=_t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kvh", [8, 2])
@pytest.mark.parametrize("page", [16, 32])
def test_paged_decode_i8mm_matches_jax(page, kvh):
    """K6's int8×int8 mode (P quantized per page) against JAX's."""
    rng = np.random.default_rng(5 * page + kvh)
    kq, vq, ks, vs, pages, lengths = _pool(rng, page, kvh)
    q = rng.standard_normal((3, H, D)).astype(np.float32)
    want = np.asarray(jax_paged.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(lengths), jnp.asarray(pages), layer=1,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        int8_matmuls=True))[:2]
    got = pt_paged.paged_decode_attention(
        _t(q), _t(kq), _t(vq), _t(lengths), _t(pages), layer=1,
        k_scale=_t(ks), v_scale=_t(vs), int8_matmuls=True).numpy()
    assert np.abs(got[:2] - want).max() <= 1e-2 * np.abs(want).max()
    assert not got[2].any()


@pytest.mark.parametrize("page", [8, 16])
def test_plain_paged_int8_bitwise_equals_monolithic(page):
    """The plain paged int8 modes are the plain monolithic ones over the
    gathered views (payloads and scales), bitwise: fused decode (pools
    compared through the view after the write), int8×int8 at block_k =
    page, and the chunk."""
    rng = np.random.default_rng(60 + page)
    kq, vq, ks, vs, pages, lengths = _pool(rng, page, 2)
    q, tab, lt = _t(rng.standard_normal((3, H, D)).astype(np.float32)), \
        _t(pages), _t(lengths)
    bufs = [_t(x) for x in (kq, vq, ks, vs)]
    views = [pt_paged.gather_pages(b[1], tab) for b in bufs]
    got = pt_paged.paged_decode_attention(q, *bufs[:2], lt, tab, layer=1,
                                          k_scale=bufs[2], v_scale=bufs[3],
                                          int8_matmuls=True)
    want = pt_decode.decode_attention(q, *views[:2], lt, k_scale=views[2],
                                      v_scale=views[3], int8_matmuls=True,
                                      block_k=page)
    assert torch.equal(got, want)
    nk = _t(rng.standard_normal((3, 2, D)).astype(np.float32))
    nv = _t(rng.standard_normal((3, 2, D)).astype(np.float32))
    got = pt_paged.paged_decode_attention(q, *bufs[:2], lt, tab, layer=1,
                                          k_scale=bufs[2], v_scale=bufs[3],
                                          new_k=nk, new_v=nv)[0]
    want = pt_decode.decode_attention(q, *views[:2], lt, k_scale=views[2],
                                      v_scale=views[3], new_k=nk,
                                      new_v=nv)[0]
    assert torch.equal(got, want)
    for b, view in zip(bufs, views):
        assert torch.equal(pt_paged.gather_pages(b[1], tab)[:2], view[:2])
    qc = _t(rng.standard_normal((2, 10, H, D)).astype(np.float32))
    starts = torch.tensor([0, page + 2], dtype=torch.int32)
    got = pt_paged.paged_chunk_prefill_attention(
        qc, *bufs[:2], starts, tab[:2], layer=1, k_scale=bufs[2],
        v_scale=bufs[3])
    views = [pt_paged.gather_pages(b[1], tab[:2]) for b in bufs]
    want = pt_decode.chunk_prefill_attention(qc, *views[:2], starts,
                                             k_scale=views[2],
                                             v_scale=views[3])
    assert torch.equal(got, want)


def test_quant_rows_bitwise_matches_jax():
    """The registry's out-of-kernel row quantizer: payloads and RAW scales
    bitwise JAX's ``_quant_rows`` — an all-zero row stores scale 0.0 (the
    fused kernels store 1.0; the payload is 0 either way)."""
    rng = np.random.default_rng(7)
    rows = (rng.standard_normal((3, 5, 4 * D)) * 2.0).astype(np.float32)
    rows[1, 2, D:2 * D] = 0.0
    rows[0, 0, :3] = 0.5 * 127.0 / 3.0       # ties to even at scale 1/2
    jp, js = jax_registry._quant_rows(jnp.asarray(rows), 4)
    tp, ts = pt_registry._quant_rows(_t(rows), 4)
    assert tp.dtype == torch.int8
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp).astype(np.int8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[1, 2, 1] == 0.0 and not tp[1, 2, D:2 * D].any()
    fp, fs = pt_decode.quantize_rows(_t(rows), 4)
    assert torch.equal(fp, tp) and fs[1, 2, 1] == 1.0
    assert torch.equal(fs[ts != 0], ts[ts != 0])


def _mode_errors(call):
    """The JAX wrappers' four ValueErrors through ``call(**kwargs)``."""
    z = torch.zeros(2, 32, 2)
    with pytest.raises(ValueError, match="together"):
        call(k_scale=z)
    with pytest.raises(ValueError, match="int8_matmuls requires"):
        call(int8_matmuls=True)
    n = torch.zeros(2, 2, D)
    with pytest.raises(ValueError, match="together"):
        call(k_scale=z, v_scale=z, new_k=n)
    with pytest.raises(ValueError, match="unsupported with the fused"):
        call(k_scale=z, v_scale=z, int8_matmuls=True, new_k=n, new_v=n)


def test_int8_mode_errors_match_jax():
    q = torch.zeros(2, 4, D)
    cache = torch.zeros(2, 32, 2 * D, dtype=torch.int8)
    lengths = torch.tensor([3, 5])
    _mode_errors(lambda **kw: pt_decode.decode_attention(
        q, cache, cache, lengths, **kw))
    pool = torch.zeros(1, 4, 8, 2 * D, dtype=torch.int8)
    pages = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    _mode_errors(lambda **kw: pt_paged.paged_decode_attention(
        q, pool, pool, lengths, pages, layer=0, **kw))
    with pytest.raises(ValueError, match="together"):
        pt_decode.chunk_prefill_attention(torch.zeros(2, 3, 4, D), cache,
                                          cache, lengths,
                                          k_scale=torch.zeros(2, 32, 2))
    # the JAX wrappers raise the same errors
    jq, jc = jnp.zeros((2, 4, D)), jnp.zeros((2, 32, 2 * D), jnp.int8)
    with pytest.raises(ValueError, match="int8_matmuls requires"):
        jax_decode.decode_attention(jq, jc, jc, jnp.asarray([3, 5]),
                                    int8_matmuls=True)


def test_cpu_int8_wrappers_do_not_count_launches():
    fns = (pt_decode.decode_attention, pt_decode.chunk_prefill_attention,
           pt_paged.paged_decode_attention,
           pt_paged.paged_chunk_prefill_attention)
    before = [(f.launches, f.int8_launches, getattr(f, "i8mm_launches", 0))
              for f in fns]
    cache = torch.zeros(1, 16, 64, dtype=torch.int8)
    sc = torch.ones(1, 16, 4)
    q, lengths = torch.zeros(1, 4, 16), torch.tensor([3])
    pt_decode.decode_attention(q, cache, cache, lengths, k_scale=sc,
                               v_scale=sc)
    pt_decode.decode_attention(q, cache, cache, lengths, k_scale=sc,
                               v_scale=sc, int8_matmuls=True)
    pt_decode.chunk_prefill_attention(torch.zeros(1, 2, 4, 16), cache, cache,
                                      lengths, k_scale=sc, v_scale=sc)
    pool, psc = torch.zeros(1, 3, 8, 64, dtype=torch.int8), torch.ones(1, 3,
                                                                       8, 4)
    pages = torch.tensor([[1, 2]], dtype=torch.int32)
    pt_paged.paged_decode_attention(q, pool, pool, lengths, pages, layer=0,
                                    k_scale=psc, v_scale=psc,
                                    int8_matmuls=True)
    pt_paged.paged_chunk_prefill_attention(torch.zeros(1, 2, 4, 16), pool,
                                           pool, lengths, pages, layer=0,
                                           k_scale=psc, v_scale=psc)
    assert before == [(f.launches, f.int8_launches,
                       getattr(f, "i8mm_launches", 0)) for f in fns]


def test_dense_fallback_int8_matches_jax(monkeypatch):
    """The registry's reference_fallback (blocks longer than 512) on an
    int8 cache dequantizes to q's dtype as the JAX dense path does; the
    JAX side is forced onto its einsum path."""
    from deepspeed_tpu.models import transformer as jt
    from deepspeed_tpu_torch.models import transformer as pt
    rng = np.random.default_rng(77)
    B, S_max, S, kvh = 1, 640, 520, 2
    kq, vq, ks, vs = _int8_cache(rng, (2, B), kvh, S_max)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    pos = (np.arange(S)[None] + 100).astype(np.int32)
    monkeypatch.setenv("DSTPU_DISABLE_FLASH", "1")
    want = jt.cached_attention(jnp.asarray(q), jnp.asarray(kq),
                               jnp.asarray(vq), jnp.asarray(pos),
                               layer=jnp.asarray(1), k_scale=jnp.asarray(ks),
                               v_scale=jnp.asarray(vs))
    assert pt_registry.select_kernel(s=S) == "reference_fallback"
    got = pt.cached_attention(_t(q), _t(kq), _t(vq), _t(pos).long(),
                              layer=1, k_scale=_t(ks), v_scale=_t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
