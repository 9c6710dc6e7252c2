"""K2 / K6's int8×int8 template (``ops/csrc/decode_attention.cu``
``decode_i8mm_kernel``) on the CPU: a torch model of its schedule against
the plain versions and the JAX package's Pallas B4 / B6 with
``int8_matmuls=True`` (interpret mode on the CPU), and the host side of
its launches.

The model walks each (batch row, group of ``hpb`` kv heads) as the kernel
does: the JAX kernel's KV blocks of ``block_k`` positions from the block
holding ``length - window`` (or 0), each block's live positions cut into
tiles of ``tp = 8192 / (hpb * D)`` positions, warp ``w`` of 4 owning
positions ``[w * tp / 4, (w + 1) * tp / 4)`` of every tile; per block the
integer scores times ``qs * scale`` times the k-scale, the block max over
the warps, ``p = exp(s - m)``, each warp's sum of p as its lanes take it
(lane ``e % 32`` of item ``e``, in order, then the warp's xor tree), the 4
warps merged in order, P times the v-scale quantized with the whole
block's ``rmax``, the integer P·V (exact) times ``rmax`` joining ``acc *
corr``.

Tolerances: against the plain version fp32 2e-5 everywhere (the same
exp, the same P bits; only the order of each block's sum of p differs);
against JAX 2e-5 on heads where no rounding of q or P lies within 2.5e-4
of a tie, 1e-2 · max|out| on every head.  (XLA may divide by 127 as a
multiply by its reciprocal and its exp may differ by an ulp: that moves
q / qs or pv / rsafe by about 1e-4 at most, so only a rounding that close
to a tie can flip.)  The CUDA kernel itself runs only on a card
(``tests/test_torch_cuda_kernels.py -k i8mm``, ``chip_smoke.py``).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.transformer import decode_attention as jax_decode
from deepspeed_tpu.ops.transformer import paged_attention as jax_paged
from deepspeed_tpu_torch.ops.quantizer.kernels import true_div
from deepspeed_tpu_torch.ops.transformer import decode_attention as pt_decode
from deepspeed_tpu_torch.ops.transformer import paged_attention as pt_paged
# the launch path on CPU tensors with a recording library, and the int8
# cache maker, as K2 / K6's float and int8-KV template tests use them
from test_torch_decode_split import (  # noqa: F401  (host_launch: fixture)
    _int8, _refuse_host_reads, host_launch)

TOL = dict(rtol=2e-5, atol=2e-5)
I8MM_REL = 1e-2
TIE_MARGIN = 2.5e-4
NEG = -1e30
WARPS = 4
L, LAYER = 2, 1


def _t(x):
    return torch.from_numpy(np.array(x))


def _scale(D):
    return 1.0 / math.sqrt(D)          # the wrappers' default


def tile_positions(D, hpb):
    """Positions of one tile of the kernel: K (or V) rows of hpb heads in
    8 KB."""
    return 8192 // (hpb * D)


def _quant(x, safe):
    return torch.clamp(torch.round(x / safe), -127, 127)


def _margin_ok(x, safe):
    """No rounding of x / safe lies within TIE_MARGIN of a tie."""
    f = (x / safe).abs()
    return bool(((f - f.floor() - 0.5).abs() > TIE_MARGIN).all())


def _warp_sum(vals):
    """The xor-tree warp sum of 32 fp32 lane values (lane 0's result)."""
    idx = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        vals = vals + vals[idx ^ off]
    return vals[0]


def i8mm_model(q, kc, vc, ks, vs, lengths, scale, block_k, window, hpb):
    """The kernel's arithmetic in fp32: q [B, H, D]; one layer's int8
    caches [B, S_max, KVH*D] and fp32 scales [B, S_max, KVH].  Returns the
    output [B, H, D] and a [B, H] mask of heads whose q and P roundings are
    all at least TIE_MARGIN from a tie."""
    B, H, D = q.shape
    S_max, KVH = kc.shape[1], kc.shape[2] // D
    G = H // KVH
    tp = tile_positions(D, hpb)
    pw = tp // WARPS
    out = torch.zeros(B, H, D)
    margin = torch.ones(B, H, dtype=torch.bool)
    k = kc.view(B, S_max, KVH, D).float()
    v = vc.view(B, S_max, KVH, D).float()
    for b in range(B):
        n = min(max(int(lengths[b]), 0), S_max)
        start = max(n - window, 0) if window else 0
        first = start // block_k * block_k
        for h0 in range(0, KVH, hpb):
            heads = [(h, g) for h in range(h0, h0 + hpb) for g in range(G)]
            qh = torch.stack([q[b, h * G + g].float() for h, g in heads])
            qs = true_div(qh.abs().amax(-1, keepdim=True), 127.0)
            qs = torch.where(qs == 0, torch.ones_like(qs), qs)
            q8 = _quant(qh, qs)
            ok = [_margin_ok(qh[i], qs[i]) for i in range(len(heads))]
            qsc = qs[:, 0] * scale
            m = torch.full((len(heads),), NEG)
            l = torch.zeros(len(heads))
            acc = torch.zeros(len(heads), D)
            for t0 in range(first, n, block_k):
                a, e = max(start, t0), min(t0 + block_k, n)
                nl = e - a
                u = torch.arange(nl)
                warp_of = u % tp // pw
                pos = a + u
                kr = torch.stack([k[b, pos, h] for h, _ in heads])  # [HG, nl, D]
                vr = torch.stack([v[b, pos, h] for h, _ in heads])
                ksr = torch.stack([ks[b, pos, h] for h, _ in heads])
                vsr = torch.stack([vs[b, pos, h] for h, _ in heads])
                s = torch.einsum("xd,xud->xu", q8, kr) * qsc[:, None] * ksr
                wmax = torch.stack([s[:, warp_of == w].amax(-1) if
                                    (warp_of == w).any() else
                                    torch.full((len(heads),), NEG)
                                    for w in range(WARPS)])
                m_new = torch.maximum(m, wmax.amax(0))
                p = torch.exp(s - m_new[:, None])
                pv = p * vsr
                psum = torch.zeros(len(heads))
                for w in range(WARPS):
                    # item e of the warp: tile e // pw, position e % pw
                    mine = u[warp_of == w]
                    items = (mine // tp) * pw + mine % pw
                    lanes = torch.zeros(len(heads), 32)
                    for kk in range(0, int(items.max()) + 1 if len(items)
                                    else 0, 32):
                        sel = (items >= kk) & (items < kk + 32)
                        lane = items[sel] - kk
                        add = torch.zeros(len(heads), 32)
                        add[:, lane] = p[:, mine[sel]]
                        lanes = lanes + add
                    psum = psum + torch.stack([_warp_sum(lanes[i])
                                               for i in range(len(heads))])
                rmax = true_div(pv.amax(-1).clamp_min(0.0), 127.0)
                rsafe = torch.where(rmax == 0, torch.ones_like(rmax), rmax)
                pq = _quant(pv, rsafe[:, None])
                ok = [ok[i] and _margin_ok(pv[i], rsafe[i])
                      for i in range(len(heads))]
                o = torch.einsum("xu,xud->xd", pq.double(),
                                 vr.double()).float() * rmax[:, None]
                corr = torch.exp(m - m_new)
                acc = acc * corr[:, None] + o
                l = l * corr + psum
                m = m_new
            safe = torch.where(l == 0, torch.ones_like(l), l)
            for i, (h, g) in enumerate(heads):
                out[b, h * G + g] = acc[i] / safe[i]
                margin[b, h * G + g] = ok[i]
    return out, margin


def _check(model, margin, got, want_j, live):
    """The model equals the plain version everywhere at 2e-5, JAX at 2e-5
    on the live heads with no rounding near a tie and at 1e-2 · max|out|
    on every live head."""
    np.testing.assert_allclose(model.numpy(), got.numpy(), **TOL)
    mj = model.numpy()[live]
    wj = np.asarray(want_j)[live]
    assert np.abs(mj - wj).max() <= I8MM_REL * np.abs(wj).max()
    tight = margin.numpy()[live]
    assert tight.any()
    np.testing.assert_allclose(mj[tight], wj[tight], **TOL)


# --------------------------------------------------------------------- #
# K2: lengths 0 and 1, on and one off the block and tile edges
# --------------------------------------------------------------------- #
def _lengths(S_max, block_k, tp):
    ls = {0, 1, tp - 1, tp, tp + 1, block_k - 1, block_k, block_k + 1,
          2 * tp + 3, S_max}
    return sorted(min(n, S_max) for n in ls)


K2_CASES = [  # D, G, hpb, S_max, block_k, window
    (64, 1, 1, 320, 320, None),      # K2's main shape: one block of 320
    (64, 1, 2, 320, 320, None),
    (128, 1, 1, 384, 384, 256),      # run (i)'s windowed block of 384
    (64, 4, 1, 512, 512, 200),
    (128, 4, 1, 320, 64, 100),       # several blocks, a window across them
    (64, 1, 2, 387, 129, 150),       # blocks of tile + 1
]
# (JAX's blocks tile S_max here: where they do not, its Pallas kernel
# reads the last block padded, and in interpret mode the padding's
# v-scales are NaN, which reach the rows that run into that block)


@pytest.mark.parametrize("case", K2_CASES,
                         ids=[f"D{c[0]}-G{c[1]}-hpb{c[2]}-bk{c[4]}-w{c[5]}"
                              for c in K2_CASES])
def test_model_matches_plain_and_jax_b4(case):
    """The model over one layer of a stacked int8 cache equals
    ``decode_attention_i8mm_plain`` and JAX B4 ``int8_matmuls=True`` in
    the same KV blocks; zero-length rows give 0."""
    D, G, hpb, S_max, block_k, window = case
    rng = np.random.default_rng(sum(case[:5]) + (window or 0))
    kvh = 2
    H = kvh * G
    lengths = np.asarray(_lengths(S_max, block_k,
                                  tile_positions(D, hpb)), np.int32)
    B = len(lengths)
    shape = (L, B, S_max, kvh * D)
    (kq, ks), (vq, vs) = _int8(rng, shape, kvh), _int8(rng, shape, kvh)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    q[1, 0] = 0.0                          # a head quantized at scale 1
    want_j = jax_decode.decode_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(lengths), layer=LAYER, block_k=block_k,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), window=window,
        int8_matmuls=True)
    t = [_t(x) for x in (kq, vq, ks, vs)]
    got = pt_decode.decode_attention(_t(q), t[0], t[1], _t(lengths),
                                     layer=LAYER, k_scale=t[2], v_scale=t[3],
                                     int8_matmuls=True, block_k=block_k,
                                     window=window)
    model, margin = i8mm_model(_t(q), *(x[LAYER] for x in t), lengths,
                               _scale(D), min(block_k, S_max), window, hpb)
    _check(model, margin, got, want_j, lengths > 0)
    assert not model[torch.from_numpy(lengths == 0)].any()


# --------------------------------------------------------------------- #
# K6: pages of 5, 13 and 64 rows, P quantized per page
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("D,G,hpb", [(64, 1, 2), (128, 1, 1), (64, 4, 1)])
@pytest.mark.parametrize("page", [5, 13, 64])
def test_model_matches_plain_and_jax_b6_over_the_pool(page, D, G, hpb):
    """K6's schedule is K2's over the gathered view with block_k = page:
    the model there equals the plain paged version and JAX B6
    ``int8_matmuls=True``; a dead lane on the trash page gives 0."""
    rng = np.random.default_rng(7 * page + D + G)
    kvh = 2
    H = kvh * G
    tp = tile_positions(D, hpb)
    n_virt = max(3, -(-(tp + 2) // page))
    lengths = np.asarray([0, 1, 2 * page + 3, tp - 1, tp + 1,
                          n_virt * page], np.int32)
    lengths = np.minimum(lengths, n_virt * page)
    B = len(lengths)
    n_pages = 1 + (B - 1) * n_virt
    shape = (L, n_pages, page, kvh * D)
    (kq, ks), (vq, vs) = _int8(rng, shape, kvh), _int8(rng, shape, kvh)
    pages = np.zeros((B, n_virt), np.int32)
    pages[1:] = (1 + rng.permutation(n_pages - 1)).reshape(B - 1, n_virt)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    want_j = jax_paged.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(lengths), jnp.asarray(pages), layer=LAYER,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), int8_matmuls=True)
    t = [_t(x) for x in (kq, vq, ks, vs)]
    got = pt_paged.paged_decode_attention(_t(q), t[0], t[1], _t(lengths),
                                          _t(pages), layer=LAYER,
                                          k_scale=t[2], v_scale=t[3],
                                          int8_matmuls=True)
    views = [pt_paged.gather_pages(x[LAYER], _t(pages)) for x in t]
    model, margin = i8mm_model(_t(q), *views, lengths, _scale(D), page,
                               None, hpb)
    _check(model, margin, got, want_j, lengths > 0)
    assert not model[0].any()                       # the dead lane


@pytest.mark.parametrize("page", [13, 64])
def test_model_windowed_pool_matches_plain(page):
    """K6 with a window (GPT-Neo's route: the gathered view's blocks of
    min(512, virtual positions)), the window's first block partly below
    it: the model equals the plain paged version."""
    rng = np.random.default_rng(90 + page)
    kvh, D, G, window = 2, 128, 1, 40
    n_virt = max(4, -(-(window + 2 * page) // page))
    S = n_virt * page
    lengths = np.asarray([0, 1, window - 1, window, window + page,
                          window + page + 1, 2 * page + 3, S], np.int32)
    B = len(lengths)
    n_pages = 1 + (B - 1) * n_virt
    shape = (L, n_pages, page, kvh * D)
    (kq, ks), (vq, vs) = _int8(rng, shape, kvh), _int8(rng, shape, kvh)
    pages = np.zeros((B, n_virt), np.int32)
    pages[1:] = (1 + rng.permutation(n_pages - 1)).reshape(B - 1, n_virt)
    q = rng.standard_normal((B, kvh * G, D)).astype(np.float32)
    t = [_t(x) for x in (kq, vq, ks, vs)]
    bk = min(512, S)
    got = pt_paged.paged_decode_attention(_t(q), t[0], t[1], _t(lengths),
                                          _t(pages), layer=LAYER,
                                          k_scale=t[2], v_scale=t[3],
                                          int8_matmuls=True, block_k=bk,
                                          window=window)
    views = [pt_paged.gather_pages(x[LAYER], _t(pages)) for x in t]
    model, _ = i8mm_model(_t(q), *views, lengths, _scale(D), bk, window, 1)
    np.testing.assert_allclose(model.numpy(), got.numpy(), **TOL)
    assert not model[0].any()


def test_model_long_row_one_head_a_block_and_two():
    """A 4,096-position row at B = 1 in blocks of 512: the model under one
    and two kv heads a block (other warp partitions, other sums of p)
    equals the plain version."""
    rng = np.random.default_rng(4096)
    kvh, D, S_max = 2, 64, 4096
    (kq, ks), (vq, vs) = (_int8(rng, (1, S_max, kvh * D), kvh)
                          for _ in range(2))
    q = rng.standard_normal((1, kvh, D)).astype(np.float32)
    lengths = np.asarray([S_max - 95], np.int32)
    t = [_t(x) for x in (kq, vq, ks, vs)]
    got = pt_decode.decode_attention_i8mm_plain(_t(q), t[0], t[1],
                                                _t(lengths), t[2], t[3])
    for hpb in (1, 2):
        model, _ = i8mm_model(_t(q), *t, lengths, _scale(D), 512, None, hpb)
        np.testing.assert_allclose(model.numpy(), got.numpy(), **TOL)


# --------------------------------------------------------------------- #
# The host side of the launches
# --------------------------------------------------------------------- #
# (B, KVH, G) -> kv heads a block on a 132-SM card: K6-i8mm's run (h-i8mm)
# shape takes 2, K2-i8mm's run (g-i8mm) and the window shapes one, GQA one
LAUNCHES = [((96, 32, 1), 2), ((16, 32, 1), 1), ((16, 16, 1), 1),
            ((96, 8, 4), 1), ((96, 16, 2), 1)]


@pytest.mark.parametrize("shape,hpb", LAUNCHES,
                         ids=[f"B{s[0]}-KVH{s[1]}-G{s[2]}" for s, _ in LAUNCHES])
@pytest.mark.parametrize("window", [None, 24])
def test_launch_reads_nothing_back_and_k6_gets_k2_plan(host_launch,
                                                       monkeypatch, shape,
                                                       hpb, window):
    """K6-i8mm on its pool and K2-i8mm on the gathered view launch with no
    tensor read on the host, the same KV block (page) and the same kv
    heads a block, chosen from shapes alone (the arguments before
    ``scale``: block_k, window, hpb)."""
    B, KVH, G = shape
    D, page, n_virt = 64, 16, 2
    rng = np.random.default_rng(B + KVH + G)
    n_pages = 1 + B * n_virt
    pay, sc = _int8(rng, (L, n_pages, page, KVH * D), KVH)
    pools = [_t(pay), _t(pay.copy()), _t(sc), _t(sc.copy())]
    pages = _t((1 + np.arange(B * n_virt, dtype=np.int32)).reshape(
        B, n_virt))
    q = _t(rng.standard_normal((B, KVH * G, D)).astype(np.float32))
    lengths = _t(np.asarray([(7 * i) % (n_virt * page + 1)
                             for i in range(B)], np.int32))
    views = [pt_paged.gather_pages(t[LAYER], pages) for t in pools]
    _refuse_host_reads(monkeypatch)
    pt_paged._launch_paged_decode(q, pools[0][LAYER], pools[1][LAYER],
                                  pools[2][LAYER], pools[3][LAYER], lengths,
                                  pages, 0.125, None, None, window,
                                  i8mm_block=page)
    pt_decode._launch_decode_i8mm(q, views[0], views[1], views[2], views[3],
                                  lengths, 0.125, page, window)
    monkeypatch.undo()
    (k6, a6), (k2, a2) = host_launch.calls
    assert (k6, k2) == ("dstt_paged_decode_attention_i8mm",
                        "dstt_decode_attention_i8mm")
    # ..., block_k, window, hpb, scale, stream
    assert a6[-5:-2] == a2[-5:-2] == (page, window or 0, hpb)
    assert hpb == pt_decode.heads_per_block(B, KVH, G, 132)


def test_launch_takes_one_head_a_block_for_scales_at_4_bytes(host_launch):
    """A block's int8 scales of 2 kv heads are one 8-byte copy: scales
    aligned to 4 bytes only keep one head a block."""
    B, KVH, D, S = 96, 32, 64, 8
    kc = torch.zeros(B, S, KVH * D, dtype=torch.int8)
    flat = torch.zeros(B * S * KVH + 4)
    aligned = flat[:-4].view(B, S, KVH)
    shifted = flat[1:-3].view(B, S, KVH)
    q = torch.zeros(B, KVH, D)
    lengths = torch.full((B,), S, dtype=torch.int32)
    for scales, hpb in ((aligned, 2), (shifted, 1)):
        pt_decode._launch_decode_i8mm(q, kc, kc, scales, scales, lengths,
                                      0.125, S)
        assert host_launch.calls[-1][1][-3] == hpb
