"""The sliding-window mode of the port's decode attention (the plain
versions of K2-window and K6-window on the CPU) against the JAX package's
Pallas ``decode_attention(..., window=)`` (interpret mode on the CPU) on
the same numpy inputs.

Tolerances: fp32 outputs at 2e-5 (summation order); fused writes of a
float cache bitwise; int8-KV fused writes' payloads bitwise and scales
within 1 ulp of the compiled JAX kernel (it multiplies by the fp32
reciprocal of 127, the source divides — see ``test_torch_int8_kv.py``);
int8×int8 at max|err| <= 1e-2 · max|out| (integer products exact on both
sides, one exp ulp can flip one rounding of P).  K6-window's plain
version is held BITWISE to K2-window's over the gathered view.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.transformer import decode_attention as jax_decode
from deepspeed_tpu.ops.transformer import registry as jax_registry
from deepspeed_tpu_torch.ops.transformer import decode_attention as pt_decode
from deepspeed_tpu_torch.ops.transformer import paged_attention as pt_paged
from deepspeed_tpu_torch.ops.transformer import registry as pt_registry

TOL = dict(rtol=2e-5, atol=2e-5)
H, D, S_MAX, BLOCK = 4, 16, 128, 32
# lengths below, at and past the windows (8 / 40 / 200) and the 32-row
# block edges, a full cache, and the shortest live row
LENGTHS = [1, 5, 8, 9, 32, 40, 41, 64, 97, 128]
I8MM_REL = 1e-2


def _t(x):
    return torch.from_numpy(np.array(x))


def _quantize(cache, kvh):
    """[.., S, KVH*D] float → (int8 payload, [.., S, KVH] raw scales)."""
    *lead, S, KVHD = cache.shape
    r = cache.reshape(*lead, S, kvh, KVHD // kvh)
    s = np.max(np.abs(r), axis=-1) / np.float32(127.0)
    safe = np.where(s == 0.0, np.float32(1.0), s)
    pay = np.clip(np.round(r / safe[..., None]), -127, 127)
    return pay.reshape(*lead, S, KVHD).astype(np.int8), s.astype(np.float32)


def _inputs(seed, kvh, lead=None, int8=False):
    rng = np.random.default_rng(seed)
    B = len(LENGTHS)
    lead = lead or (B,)
    k = (rng.standard_normal((*lead, S_MAX, kvh * D)) * 3.0).astype(np.float32)
    v = rng.standard_normal((*lead, S_MAX, kvh * D)).astype(np.float32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    nk = (rng.standard_normal((B, kvh, D)) * 3.0).astype(np.float32)
    nv = rng.standard_normal((B, kvh, D)).astype(np.float32)
    if not int8:
        return q, (k, v), nk, nv
    (kq, ks), (vq, vs) = _quantize(k, kvh), _quantize(v, kvh)
    return q, (kq, vq, ks, vs), nk, nv


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("window", [8, 40, 200])
@pytest.mark.parametrize("kvh", [4, 2])
def test_decode_window_matches_jax(kvh, window, fused):
    """K2-window over a float cache: outputs at 2e-5; with the fused write
    the caches come back bitwise JAX's (the fresh row at lengths-1)."""
    q, (k, v), nk, nv = _inputs(window + kvh + 7 * fused, kvh)
    lengths = np.asarray(LENGTHS, np.int32)
    kw_j, kw_t = {}, {}
    if fused:
        kw_j = dict(new_k=jnp.asarray(nk), new_v=jnp.asarray(nv))
        kw_t = dict(new_k=_t(nk), new_v=_t(nv))
    want = jax_decode.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        block_k=BLOCK, window=window, **kw_j)
    kc, vc = _t(k), _t(v)
    got = pt_decode.decode_attention(_t(q), kc, vc, _t(lengths),
                                     window=window, **kw_t)
    if fused:
        got, want = got[0], want
        np.testing.assert_array_equal(kc.numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(vc.numpy(), np.asarray(want[2]))
        want = want[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_window_is_the_band():
    """The plain K2-window equals full attention over the window's slice
    of each row, and a window past the live length is no window."""
    q, (k, v), _, _ = _inputs(3, 4)
    lengths = _t(np.asarray(LENGTHS, np.int32))
    got = pt_decode.decode_attention_plain(_t(q), _t(k), _t(v), lengths,
                                           window=40)
    for b, n in enumerate(LENGTHS):
        lo = max(n - 40, 0)
        want = pt_decode.decode_attention_plain(
            _t(q[b:b + 1]), _t(k[b:b + 1, lo:n]), _t(v[b:b + 1, lo:n]),
            torch.tensor([n - lo]))
        np.testing.assert_allclose(got[b:b + 1].numpy(), want.numpy(), **TOL)
    full = pt_decode.decode_attention_plain(_t(q), _t(k), _t(v), lengths)
    wide = pt_decode.decode_attention_plain(_t(q), _t(k), _t(v), lengths,
                                            window=S_MAX)
    np.testing.assert_array_equal(wide.numpy(), full.numpy())
    with pytest.raises(ValueError, match="window"):
        pt_decode.decode_attention_plain(_t(q), _t(k), _t(v), lengths,
                                         window=0)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_decode_window_stacked_matches_jax(fused):
    """Layer-stacked caches [L, B, S, KVH*D] with ``layer``."""
    L, layer, window = 3, 1, 40
    q, (k, v), nk, nv = _inputs(11 + fused, 2, lead=(L, len(LENGTHS)))
    lengths = np.asarray(LENGTHS, np.int32)
    kw_j, kw_t = {}, {}
    if fused:
        kw_j = dict(new_k=jnp.asarray(nk), new_v=jnp.asarray(nv))
        kw_t = dict(new_k=_t(nk), new_v=_t(nv))
    want = jax_decode.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        block_k=BLOCK, layer=layer, window=window, **kw_j)
    kc, vc = _t(k), _t(v)
    got = pt_decode.decode_attention(_t(q), kc, vc, _t(lengths), layer=layer,
                                     window=window, **kw_t)
    if fused:
        np.testing.assert_array_equal(kc.numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(vc.numpy(), np.asarray(want[2]))
        got, want = got[0], want[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("window", [8, 40])
def test_decode_window_int8_matches_jax(window, fused):
    """K2-window over an int8-KV cache: outputs at 2e-5; a fused write's
    payloads bitwise JAX's and its scales within 1 ulp (an all-zero fresh
    row stores the safe scale 1.0 on both sides)."""
    q, (kq, vq, ks, vs), nk, nv = _inputs(20 + window + fused, 2, int8=True)
    nk[3] = 0.0                               # an all-zero fresh k row
    lengths = np.asarray(LENGTHS, np.int32)
    kw_j, kw_t = {}, {}
    if fused:
        kw_j = dict(new_k=jnp.asarray(nk), new_v=jnp.asarray(nv))
        kw_t = dict(new_k=_t(nk), new_v=_t(nv))
    want = jax_decode.decode_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(lengths), block_k=BLOCK, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), window=window, **kw_j)
    bufs = [_t(x) for x in (kq, vq, ks, vs)]
    got = pt_decode.decode_attention(_t(q), bufs[0], bufs[1], _t(lengths),
                                     k_scale=bufs[2], v_scale=bufs[3],
                                     window=window, **kw_t)
    if fused:
        got, want_bufs, want = got[0], want[1:], want[0]
        for i in (0, 1):
            np.testing.assert_array_equal(bufs[i].numpy(),
                                          np.asarray(want_bufs[i]))
            np.testing.assert_array_max_ulp(bufs[i + 2].numpy(),
                                            np.asarray(want_bufs[i + 2]), 1)
        assert bufs[2].numpy()[3, LENGTHS[3] - 1, 0] == 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [8, 40, 200])
def test_decode_window_i8mm_matches_jax(window):
    """K2-i8mm-window: the blocks below the window are skipped as JAX
    skips them, so P is quantized in the same blocks; max|err| <= 1e-2 ·
    max|out| on layer-stacked caches."""
    L, layer = 2, 1
    q, (kq, vq, ks, vs), _, _ = _inputs(30 + window, 2,
                                        lead=(L, len(LENGTHS)), int8=True)
    lengths = np.asarray(LENGTHS, np.int32)
    want = np.asarray(jax_decode.decode_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(lengths), block_k=BLOCK, layer=layer,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), window=window,
        int8_matmuls=True))
    got = pt_decode.decode_attention(
        _t(q), _t(kq), _t(vq), _t(lengths), layer=layer, k_scale=_t(ks),
        v_scale=_t(vs), window=window, int8_matmuls=True,
        block_k=BLOCK).numpy()
    assert np.abs(got - want).max() <= I8MM_REL * np.abs(want).max()


def test_decode_window_zero_length_row():
    """A zero-length row (invalid input, clamped in-kernel): the fused write
    lands at position 0, as JAX's, and the row attends to nothing."""
    B, window = 2, 8
    q, (k, v), nk, nv = _inputs(40, 4)
    q, nk, nv = q[:B], nk[:B], nv[:B]
    k, v = k[:B], v[:B]
    lengths = np.asarray([0, 20], np.int32)
    want = jax_decode.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        block_k=BLOCK, window=window, new_k=jnp.asarray(nk),
        new_v=jnp.asarray(nv))
    kc, vc = _t(k), _t(v)
    got = pt_decode.decode_attention(_t(q), kc, vc, _t(lengths),
                                     window=window, new_k=_t(nk),
                                     new_v=_t(nv))
    np.testing.assert_array_equal(kc.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(kc.numpy()[0, 0], nk[0].reshape(-1))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    assert not got[0][0].any()


def _paged(seed, page, kvh, int8):
    """A pool [L, pages, page, KVH*D] over a shuffled table whose virtual
    view holds ``_inputs``' cache rows: (pool tensors, pages, virtual
    view as numpy, q, nk, nv)."""
    q, bufs, nk, nv = _inputs(seed, kvh, int8=int8)
    B = len(LENGTHS)
    n_virt = S_MAX // page
    rng = np.random.default_rng(seed + 1)
    perm = 1 + rng.permutation(B * n_virt)
    pages = perm.reshape(B, n_virt).astype(np.int32)
    pools = []
    for buf in bufs:
        pool = np.zeros((2, 1 + B * n_virt, page) + buf.shape[2:],
                        buf.dtype)
        pool[1][pages] = buf.reshape(B, n_virt, page, *buf.shape[2:])
        pools.append(_t(pool))
    return pools, _t(pages), q, nk, nv


@pytest.mark.parametrize("mode", ["float", "float_fused", "int8",
                                  "int8_fused", "i8mm"])
@pytest.mark.parametrize("page", [8, 16])
def test_paged_decode_window_is_k2_over_gathered_view(page, mode):
    """K6-window (plain) over a shuffled table is BITWISE K2-window over
    the gathered virtual view, in every mode: the output, and a fused
    write's rows through the table (int8×int8 in the gathered view's KV
    blocks, the JAX gather route's)."""
    window, layer = 40, 1
    int8 = mode != "float" and mode != "float_fused"
    pools, pages, q, nk, nv = _paged(50 + page, page, 2, int8)
    lengths = _t(np.asarray(LENGTHS, np.int32))
    fused = mode.endswith("fused")
    kw = dict(new_k=_t(nk), new_v=_t(nv)) if fused else {}
    views = [pt_paged.gather_pages(p[layer], pages) for p in pools]
    scales = dict(k_scale=views[2], v_scale=views[3]) if int8 else {}
    pscales = dict(k_scale=pools[2], v_scale=pools[3]) if int8 else {}
    if mode == "i8mm":
        block = min(512, S_MAX)
        want = pt_decode.decode_attention(
            _t(q), views[0], views[1], lengths, window=window,
            int8_matmuls=True, block_k=block, **scales)
        got = pt_paged.paged_decode_attention(
            _t(q), pools[0], pools[1], lengths, pages, layer=layer,
            window=window, int8_matmuls=True, block_k=block, **pscales)
    else:
        want = pt_decode.decode_attention(_t(q), views[0], views[1], lengths,
                                          window=window, **scales, **kw)
        got = pt_paged.paged_decode_attention(
            _t(q), pools[0], pools[1], lengths, pages, layer=layer,
            window=window, **pscales, **kw)
    if fused:
        got, want = got[0], want[0]
        for pool, view in zip(pools, views):
            np.testing.assert_array_equal(
                pt_paged.gather_pages(pool[layer], pages).numpy(),
                view.numpy())
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_registry_window_probes_match_jax():
    """``select_kernel`` / ``kernel_modes`` with ``has_window`` take the
    JAX table's decisions (``pallas_`` read as ``cuda_``) but one: a
    windowed decode on a pool runs K6's window mode, where JAX reports
    ``reference_fallback`` and gathers for B4's window mode."""
    for paged in (False, True):
        for s in (1, 2, 128, 512, 513):
            for win in (False, True):
                want = jax_registry.select_kernel(s=s, paged=paged,
                                                  has_window=win)
                got = pt_registry.select_kernel(s=s, paged=paged,
                                                has_window=win)
                if paged and win and s == 1:
                    assert (want, got) == ("reference_fallback",
                                           "cuda_paged_decode")
                else:
                    assert got == want.replace("pallas_", "cuda_"), \
                        (s, paged, win)
    assert pt_registry.kernel_modes(has_window=True) == {
        "decode": "cuda_decode", "prefill_chunk": "reference_fallback"}
