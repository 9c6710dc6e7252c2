"""The port's paged attention (plain versions of K6 and K7 on the CPU)
against the JAX package's Pallas paged kernels (interpret mode on the
CPU) on the same inputs, and against the port's own monolithic functions
over the gathered view.

Tolerance: fp32 at 2e-5, as for the monolithic kernels — both sides
compute the same softmax in fp32 and differ only in summation order.
The fused write must leave the pools bitwise equal to the JAX kernel's
outside the trash page (the JAX kernel writes an 8-row stripe there for
the dead lane).  The port's plain paged functions gather each row's
virtual view and run the monolithic plain functions on it, so they are
bitwise equal to those over the gathered view.  The CUDA kernels run only
on a card (``test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.transformer import paged_attention as jax_paged
from deepspeed_tpu_torch.ops.transformer import decode_attention as pt_decode
from deepspeed_tpu_torch.ops.transformer import paged_attention as pt_paged

TOL = dict(rtol=2e-5, atol=2e-5)
L, B, H, D, NVIRT, LAYER = 2, 3, 4, 16, 4, 1


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pool(page, kvh, seed):
    """Pools with a shuffled block table: rows 0 and 1 own scattered,
    non-monotone pages, row 2 is a dead lane (length 0, all trash page 0);
    live lengths are unaligned to the page."""
    rng = np.random.default_rng(seed)
    n_pages = 2 * NVIRT + 1
    k = _normal(rng, (L, n_pages, page, kvh * D))
    v = _normal(rng, (L, n_pages, page, kvh * D))
    perm = 1 + rng.permutation(n_pages - 1)
    pages = np.zeros((B, NVIRT), np.int32)
    pages[:2] = perm.reshape(2, NVIRT)
    lengths = np.asarray([2 * page + 5, NVIRT * page, 0], np.int32)
    q = _normal(rng, (B, H, D))
    return rng, q, k, v, pages, lengths


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("kvh", [4, 2])
@pytest.mark.parametrize("page", [8, 16, 64])
def test_paged_decode_matches_jax(page, kvh, fused):
    rng, q, k, v, pages, lengths = _pool(page, kvh, page + kvh)
    kw_j, kw_t = {}, {}
    if fused:
        nk, nv = _normal(rng, (B, kvh, D)), _normal(rng, (B, kvh, D))
        kw_j = dict(new_k=jnp.asarray(nk), new_v=jnp.asarray(nv))
        kw_t = dict(new_k=_t(nk), new_v=_t(nv))
    want = jax_paged.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        jnp.asarray(pages), layer=LAYER, **kw_j)
    kt, vt = _t(k), _t(v)
    got = pt_paged.paged_decode_attention(_t(q), kt, vt, _t(lengths),
                                          _t(pages), layer=LAYER, **kw_t)
    if fused:
        want, want_k, want_v = want
        got, got_k, got_v = got
        assert got_k is kt and got_v is vt           # written in place
        # outside the trash page the pools are bitwise the JAX kernel's
        np.testing.assert_array_equal(kt.numpy()[:, 1:],
                                      np.asarray(want_k)[:, 1:])
        np.testing.assert_array_equal(vt.numpy()[:, 1:],
                                      np.asarray(want_v)[:, 1:])
        assert not np.array_equal(kt.numpy()[:, 1:], k[:, 1:])
    else:
        np.testing.assert_array_equal(kt.numpy(), k)   # untouched
    # live rows (the dead lane's output is garbage in the JAX kernel)
    np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2], **TOL)
    assert not got[2].any()                         # length 0 attends nothing


@pytest.mark.parametrize("kvh", [4, 2])
@pytest.mark.parametrize("page", [8, 16, 64])
def test_paged_chunk_prefill_matches_jax(page, kvh):
    """Chunks that start inside a page and run across page boundaries."""
    _, _, k, v, pages, _ = _pool(page, kvh, 3 * page + kvh)
    C = 12
    rng = np.random.default_rng(page)
    q = _normal(rng, (2, C, H, D))
    starts = np.asarray([page - 3, 2 * page + 1], np.int32)
    want = jax_paged.paged_chunk_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(starts),
        jnp.asarray(pages[:2]), layer=LAYER)
    got = pt_paged.paged_chunk_prefill_attention(
        _t(q), _t(k), _t(v), _t(starts), _t(pages[:2]), layer=LAYER)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("page", [8, 16, 64])
def test_plain_paged_bitwise_equals_monolithic_over_gathered_view(page):
    """The plain paged functions are the plain monolithic ones over the
    gathered view pool[layer][pages], bitwise — decode unfused and fused
    (pools compared through the view after the write) and the chunk."""
    rng, q, k, v, pages, lengths = _pool(page, 2, 7 * page)
    qt, pt_, lt = _t(q), _t(pages), _t(lengths)
    kp, vp = _t(k), _t(v)
    gk = pt_paged.gather_pages(kp[LAYER], pt_)
    gv = pt_paged.gather_pages(vp[LAYER], pt_)
    assert torch.equal(pt_paged.paged_decode_attention(qt, kp, vp, lt, pt_,
                                                       layer=LAYER),
                       pt_decode.decode_attention(qt, gk, gv, lt))
    nk, nv = _t(_normal(rng, (B, 2, D))), _t(_normal(rng, (B, 2, D)))
    got, _, _ = pt_paged.paged_decode_attention(qt, kp, vp, lt, pt_,
                                                layer=LAYER, new_k=nk,
                                                new_v=nv)
    want, gk, gv = pt_decode.decode_attention(qt, gk, gv, lt, new_k=nk,
                                              new_v=nv)
    assert torch.equal(got, want)
    live = slice(0, 2)                   # the dead lane's view repeats trash
    assert torch.equal(pt_paged.gather_pages(kp[LAYER], pt_)[live], gk[live])
    assert torch.equal(pt_paged.gather_pages(vp[LAYER], pt_)[live], gv[live])
    C = 10
    qc = _t(_normal(rng, (2, C, H, D)))
    starts = torch.tensor([0, page + 2], dtype=torch.int32)
    got = pt_paged.paged_chunk_prefill_attention(qc, kp, vp, starts,
                                                 pt_[:2], layer=LAYER)
    want = pt_decode.chunk_prefill_attention(
        qc, pt_paged.gather_pages(kp[LAYER], pt_[:2]),
        pt_paged.gather_pages(vp[LAYER], pt_[:2]), starts)
    assert torch.equal(got, want)


def test_paged_write_crosses_pages_through_the_table():
    """``write_pages`` puts a chunk that spans page boundaries where the
    table maps each position, and nowhere else."""
    page, n = 8, 3
    pool = torch.zeros(7, page, 2)
    pages = torch.tensor([[5, 2, 6]], dtype=torch.int32)
    pos = torch.arange(6, 18)[None]                     # pages 0, 1, 2
    rows = torch.arange(12, dtype=torch.float32)[None, :, None].repeat(1, 1, 2)
    pt_paged.write_pages(pool, pages, pos, rows)
    view = pt_paged.gather_pages(pool, pages)[0, :, 0]
    assert torch.equal(view[6:18], torch.arange(12, dtype=torch.float32))
    assert view[:6].abs().sum() == 0 and view[18:].abs().sum() == 0
    assert pool[[0, 1, 3, 4]].abs().sum() == 0
    assert n * page == view.shape[0]


def test_cpu_paged_wrappers_do_not_count_launches():
    before = (pt_paged.paged_decode_attention.launches,
              pt_paged.paged_chunk_prefill_attention.launches)
    pool = torch.zeros(1, 3, 8, 64)
    pages = torch.tensor([[1, 2]], dtype=torch.int32)
    pt_paged.paged_decode_attention(torch.zeros(1, 4, 16), pool, pool,
                                    torch.tensor([3]), pages, layer=0)
    pt_paged.paged_chunk_prefill_attention(torch.zeros(1, 4, 4, 16), pool,
                                           pool, torch.tensor([0]), pages,
                                           layer=0)
    assert before == (pt_paged.paged_decode_attention.launches,
                      pt_paged.paged_chunk_prefill_attention.launches)


def test_paged_pools_must_be_layer_stacked():
    pool = torch.zeros(3, 8, 64)
    with pytest.raises(ValueError, match="layer-stacked"):
        pt_paged.paged_decode_attention(torch.zeros(1, 4, 16), pool, pool,
                                        torch.tensor([3]),
                                        torch.tensor([[1]]), layer=0)
    with pytest.raises(ValueError, match="layer="):
        pt_paged.paged_chunk_prefill_attention(
            torch.zeros(1, 2, 4, 16), pool[None], pool[None],
            torch.tensor([0]), torch.tensor([[1]]))


def test_registry_dispatch_table_matches_jax():
    """The port's select_kernel / kernel_modes take the JAX table's
    decisions (mode names mapped pallas_* -> cuda_*) for every cache layout
    and block size with the paged kernels on (the port has no switch to
    turn them off)."""
    from deepspeed_tpu.ops.transformer import registry as jreg
    from deepspeed_tpu_torch.ops.transformer import registry as treg
    for paged in (False, True):
        for s in (1, 2, 128, 512, 513):
            want = jreg.select_kernel(s=s, paged=paged)
            got = treg.select_kernel(s=s, paged=paged)
            assert got == want.replace("pallas_", "cuda_"), (s, paged)
        want = jreg.kernel_modes(paged=paged)
        got = treg.kernel_modes(paged=paged)
        assert got == {k: v.replace("pallas_", "cuda_")
                       for k, v in want.items()}


@pytest.mark.parametrize("s, prefill", [(4, True), (513, False)],
                         ids=["prefill", "long_block"])
def test_registry_refuses_what_the_paged_kernels_cannot_take(s, prefill):
    """A page pool goes only through K6 / K7: a one-pass prefill or a block
    longer than the chunk kernel's 512 rows raises instead of falling back
    to plain attention."""
    from deepspeed_tpu_torch.models.transformer import TransformerConfig
    from deepspeed_tpu_torch.ops.transformer import registry as treg
    page, kvh = 8, 2
    pool = torch.zeros(1, 3, page, kvh * D)
    cache = {"k": pool, "v": pool.clone(),
             "pages": torch.zeros(1, -(-s // page), dtype=torch.int32)}
    q = torch.zeros(1, s, H, D)
    kv = torch.zeros(1, s, kvh, D)
    with pytest.raises(ValueError, match="page pool"):
        treg.write_and_attend(TransformerConfig(), q, kv, kv,
                              torch.arange(s)[None], cache, 0, start=0,
                              prefill=prefill)
