"""K2 / K6's decode template (``ops/csrc/decode_attention.cu``
``decode_kernel``) on the CPU: its launch choice (kv heads a block), the
host side of its launches, and a torch model of its arithmetic against
the plain versions and the JAX package's Pallas B4 / B6 (interpret mode on
the CPU).

The model walks each (batch row, kv head) as the kernel does: the live
positions ``[lo, len)`` in tiles of ``tp`` positions from ``lo``, each
tile's rows split over the lane groups of the kernel's warps (``wph``
warps of ``slots`` lane groups a head, ``tp / (wph * slots)`` rows each),
one online softmax per lane group over its rows in the exp2 domain (q
carries ``scale * log2 e``; the k-scale on the score, the v-scale on the
probability, the running sum on the raw probability), the states merged
at the end, a state with no row as ``(m = -1e30, l = 0)``.  Tolerance:
fp32 at 2e-5 (summation order).  The CUDA kernel itself runs only on a
card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.transformer import decode_attention as jax_decode
from deepspeed_tpu.ops.transformer import paged_attention as jax_paged
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.transformer import decode_attention as pt_decode
from deepspeed_tpu_torch.ops.transformer import paged_attention as pt_paged

TOL = dict(rtol=2e-5, atol=2e-5)
LOG2E = 1.4426950408889634
NEG = -1e30
L, LAYER, H = 2, 1, 4


def _t(x):
    return torch.from_numpy(np.array(x))


def lane_map(D, es, G, hpb=1):
    """``(tp, wph, slots)`` of the kernel at head dim ``D``, cache element
    size ``es``, ``G`` query heads a kv head and ``hpb`` kv heads a block:
    a tile's K and V rows fill 8 KB, 4 warps share the block's heads, and a
    row spans 16-byte lane slices (at most 32 / G elements)."""
    tp = 8192 // (2 * hpb * D * es)
    lanes_per_row = D // min(16 // es, 32 // G)
    return tp, 4 // hpb, 32 // lanes_per_row


def tile_model(q, kc, vc, lengths, scale, window, tp, wph, slots,
               k_scale=None, v_scale=None):
    """The kernel's tile-and-merge arithmetic in fp32: q [B, H, D]; one
    layer's caches [B, S_max, KVH*D] (int8 payloads with scales [B, S_max,
    KVH]); ``tp`` positions a tile, row ``r`` of a tile in lane group
    ``r % slots`` of warp ``r // slots // (tp / (wph * slots))``."""
    B, Hq, D = q.shape
    S_max, KVH = kc.shape[1], kc.shape[2] // D
    G = Hq // KVH
    qs = q.float() * (scale * LOG2E)
    rows_per_lane = tp // (wph * slots)
    owner = torch.tensor([r // slots // rows_per_lane * slots + r % slots
                          for r in range(tp)])
    out = torch.zeros(B, Hq, D)
    for b in range(B):
        n = min(max(int(lengths[b]), 0), S_max)
        lo = max(n - window, 0) if window else 0
        for h in range(KVH):
            qh = qs[b, h * G:(h + 1) * G]
            kk = kc[b, :, h * D:(h + 1) * D].float()
            vv = vc[b, :, h * D:(h + 1) * D].float()
            states = []
            for lane_group in range(wph * slots):
                m = torch.full((G,), NEG)
                l = torch.zeros(G)
                acc = torch.zeros(G, D)
                for t0 in range(lo, n, tp):
                    t = t0 + torch.nonzero(owner == lane_group)[:, 0]
                    t = t[t < n]
                    if not len(t):
                        continue
                    sc = qh @ kk[t].T                        # [G, rows]
                    if k_scale is not None:
                        sc = sc * k_scale[b, t, h]
                    mx = torch.maximum(m, sc.amax(-1))
                    corr = torch.exp2(m - mx)
                    p = torch.exp2(sc - mx[:, None])
                    l = l * corr + p.sum(-1)
                    pv = p if v_scale is None else p * v_scale[b, t, h]
                    acc = acc * corr[:, None] + pv @ vv[t]
                    m = mx
                states.append((m, l, acc))
            mx = torch.stack([st[0] for st in states]).amax(0)
            lsum = torch.zeros(G)
            o = torch.zeros(G, D)
            for m, l, acc in states:
                c = torch.exp2(m - mx)
                lsum = lsum + l * c
                o = o + acc * c[:, None]
            lsum = torch.where(lsum == 0, torch.ones_like(lsum), lsum)
            out[b, h * G:(h + 1) * G] = o / lsum[:, None]
    return out


def _int8(rng, shape, kvh):
    """Seeded int8 payloads [.., S, KVH*D] and positive fp32 scales."""
    pay = rng.integers(-127, 128, shape).astype(np.int8)
    scales = (0.001 + 0.02 * rng.random((*shape[:-1], kvh))).astype(
        np.float32)
    return pay, scales


# --------------------------------------------------------------------- #
# The launch choice: kv heads a block
# --------------------------------------------------------------------- #
# (B, KVH, G, SMs, int8 scales' alignment) -> kv heads a block:
# chip_smoke.py's K2 (run (a)) and K2-window (run (i)) shapes keep one,
# K6 (run (d)) takes 2 on a 132-SM card; GQA, an odd KVH, a launch with
# fewer than 4 blocks an SM and scales aligned to 4 bytes keep one
PLANS = [((16, 32, 1, 132, 8), 1),
         ((96, 32, 1, 132, 8), 2),
         ((96, 8, 4, 132, 8), 1),
         ((96, 32, 2, 132, 8), 1),
         ((16, 16, 1, 132, 8), 1),
         ((1, 2, 1, 132, 8), 1),
         ((96, 7, 1, 132, 8), 1),
         ((32, 32, 1, 132, 8), 1),
         ((32, 32, 1, 128, 8), 2),
         ((96, 32, 1, 132, 4), 1),
         ((96, 32, 1, 132, 16), 2),
         ((4, 2, 1, 1, 8), 2)]


@pytest.mark.parametrize("shape,hpb", PLANS)
def test_heads_per_block_from_host_shapes(shape, hpb):
    """2 kv heads a block need G = 1, an even KVH, B * KVH / 2 >= 4
    blocks an SM and int8 scales aligned to 8 bytes."""
    B, KVH, G, sms, align = shape
    assert pt_decode.heads_per_block(B, KVH, G, sms, align) == hpb
    assert KVH % hpb == 0


def test_launch_heads_per_block_by_scale_alignment(monkeypatch):
    """A block's int8 scales are one copy of 4 * hpb bytes: scales aligned
    to 8 bytes allow 2 kv heads a block, scales at 4 bytes one."""
    monkeypatch.setattr(pt_decode, "_sm_count", lambda index: 132)
    q = torch.zeros(96, 32, 64)
    scales = torch.zeros(8 * 64 * 32 + 4)
    aligned = scales[:-4]
    shifted = scales[1:-3]
    assert aligned.data_ptr() % 16 == 0
    assert pt_decode.launch_heads_per_block(q, 32) == 2
    assert pt_decode.launch_heads_per_block(q, 32, (aligned, aligned)) == 2
    assert pt_decode.launch_heads_per_block(q, 32, (aligned, shifted)) == 1


class _FakeLib:
    """Records the arguments of the C entry points instead of launching."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def record(*args):
            self.calls.append((name, args))
            return 0
        return record


@pytest.fixture
def host_launch(monkeypatch):
    """The launch path on CPU tensors: the library recorded, the CUDA
    checks and stream stubbed, a 132-SM card."""
    lib = _FakeLib()
    monkeypatch.setattr(op_builder.DECODE, "load", lambda: lib)
    monkeypatch.setattr(pt_decode, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(pt_paged, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(pt_decode, "_sm_count", lambda index: 132)

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    return lib


def _refuse_host_reads(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a host read of a tensor")

    for name in ("item", "tolist", "numpy", "__int__", "__bool__",
                 "__index__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_launch_reads_nothing_back_and_k6_gets_k2_plan(host_launch,
                                                       monkeypatch, int8,
                                                       window, fused):
    """K2 on a gathered view and K6 on its pool launch with no tensor read
    on the host and the same kv heads a block (the argument before
    ``scale``)."""
    rng = np.random.default_rng(3 + 2 * int8 + fused)
    B, KVH, D, page, n_virt, n_pages = 2, 2, 64, 16, 4, 9
    if int8:
        pay, sc = _int8(rng, (L, n_pages, page, KVH * D), KVH)
        pools = [_t(pay), _t(pay.copy()), _t(sc), _t(sc.copy())]
    else:
        pools = [_t(rng.standard_normal((L, n_pages, page, KVH * D))
                    .astype(np.float32)) for _ in range(2)]
    pages = _t(np.arange(1, 9, dtype=np.int32).reshape(B, n_virt))
    q = _t(rng.standard_normal((B, H, D)).astype(np.float32))
    lengths = _t(np.asarray([5, 64], np.int32))
    new = [_t(rng.standard_normal((B, KVH, D)).astype(np.float32))
           for _ in range(2)] if fused else [None, None]
    views = [pt_paged.gather_pages(t[LAYER], pages) for t in pools]
    ks, vs = (pools[2][LAYER], pools[3][LAYER]) if int8 else (None, None)
    gks, gvs = (views[2], views[3]) if int8 else (None, None)
    _refuse_host_reads(monkeypatch)
    pt_paged._launch_paged_decode(q, pools[0][LAYER], pools[1][LAYER], ks,
                                  vs, lengths, pages, 0.125, *new, window)
    pt_decode._launch_decode(q, views[0], views[1], gks, gvs, lengths,
                             0.125, *new, window)
    monkeypatch.undo()
    (k6, a6), (k2, a2) = host_launch.calls
    assert (k6, k2) == ("dstt_paged_decode_attention",
                        "dstt_decode_attention")
    # ..., window, hpb, scale, stream
    assert a6[-4:-2] == a2[-4:-2] == (
        window or 0, pt_decode.heads_per_block(B, KVH, H // KVH, 132))


# --------------------------------------------------------------------- #
# The tile-and-merge arithmetic against the plain versions and JAX
# --------------------------------------------------------------------- #
# lengths 0 and 1, a full row, and rows that end one short of, on and one
# past a tile (8) and the ring (3 tiles of 8 from the window's start)
LENGTHS = [0, 1, 23, 24, 25, 47, 48, 49, 63, 64]
S_MAX = 64


def _cache(rng, kvh, D, int8):
    shape = (L, len(LENGTHS), S_MAX, kvh * D)
    if int8:
        (kq, ks), (vq, vs) = _int8(rng, shape, kvh), _int8(rng, shape, kvh)
        return kq, vq, ks, vs
    return tuple((rng.standard_normal(shape) * s).astype(np.float32)
                 for s in (3.0, 1.0))


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_tile_model_matches_plain_and_jax_b4(int8, window, fused):
    """The model (tiles of 8 over 2 warps of 2 lane groups) over one layer
    of a stacked cache
    equals ``decode_attention_plain`` on every row and JAX B4 on every
    live row; with the fused write both see the written cache."""
    rng = np.random.default_rng(11 + 2 * int8 + 5 * fused + (window or 0))
    kvh, D = 2, 16
    bufs = _cache(rng, kvh, D, int8)
    q = rng.standard_normal((len(LENGTHS), H, D)).astype(np.float32)
    lengths = np.asarray(LENGTHS, np.int32)
    kw_j, kw_t = {}, {}
    if int8:
        kw_j = dict(k_scale=jnp.asarray(bufs[2]), v_scale=jnp.asarray(bufs[3]))
    if fused:
        nk, nv = (rng.standard_normal((len(LENGTHS), kvh, D))
                  .astype(np.float32) for _ in range(2))
        kw_j.update(new_k=jnp.asarray(nk), new_v=jnp.asarray(nv))
        kw_t = dict(new_k=_t(nk), new_v=_t(nv))
    live = lengths > 0
    want_j = jax_decode.decode_attention(
        jnp.asarray(q), jnp.asarray(bufs[0]), jnp.asarray(bufs[1]),
        jnp.asarray(lengths), layer=LAYER, block_k=16,
        window=window, **kw_j)
    if fused:
        want_j = want_j[0]
    t = [_t(x) for x in bufs]
    sc = dict(k_scale=t[2], v_scale=t[3]) if int8 else {}
    got = pt_decode.decode_attention(_t(q), t[0], t[1], _t(lengths),
                                     layer=LAYER, window=window, **sc,
                                     **kw_t)
    if fused:
        got = got[0]
    ls = (t[2][LAYER], t[3][LAYER]) if int8 else (None, None)
    model = tile_model(_t(q), t[0][LAYER], t[1][LAYER], lengths, D ** -0.5,
                       window, tp=8, wph=2, slots=2, k_scale=ls[0],
                       v_scale=ls[1])
    np.testing.assert_allclose(model.numpy(), got.numpy(), **TOL)
    np.testing.assert_allclose(model.numpy()[live],
                               np.asarray(want_j)[live], **TOL)
    assert not model[~torch.from_numpy(live)].any()     # length 0: zeros


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("page", [5, 16])
def test_tile_model_matches_jax_b6_over_the_pool(int8, page):
    """K6's arithmetic: the model over the gathered view (the kernel's
    lane map at D 64: tiles of 16 fp32 / 64 int8 positions) equals the
    plain paged version and JAX B6 on the live rows; pages of 5 and 16
    rows."""
    rng = np.random.default_rng(31 + page + int8)
    kvh, D, n_virt = 2, 64, -(-S_MAX // page)
    B = 4
    n_pages = 1 + (B - 1) * n_virt
    shape = (L, n_pages, page, kvh * D)
    if int8:
        (kq, ks), (vq, vs) = _int8(rng, shape, kvh), _int8(rng, shape, kvh)
        bufs = (kq, vq, ks, vs)
    else:
        bufs = tuple(rng.standard_normal(shape).astype(np.float32)
                     for _ in range(2))
    pages = np.zeros((B, n_virt), np.int32)
    pages[1:] = (1 + rng.permutation(n_pages - 1)).reshape(B - 1, n_virt)
    lengths = np.asarray([0, 1, 33, n_virt * page], np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kw_j = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)) \
        if int8 else {}
    want_j = np.asarray(jax_paged.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(bufs[0]), jnp.asarray(bufs[1]),
        jnp.asarray(lengths), jnp.asarray(pages), layer=LAYER, **kw_j))
    t = [_t(x) for x in bufs]
    sc = dict(k_scale=t[2], v_scale=t[3]) if int8 else {}
    got = pt_paged.paged_decode_attention(_t(q), t[0], t[1], _t(lengths),
                                          _t(pages), layer=LAYER, **sc)
    views = [pt_paged.gather_pages(x[LAYER], _t(pages)) for x in t]
    es = 1 if int8 else 4
    hpb = pt_decode.heads_per_block(B, kvh, H // kvh, 132)
    model = tile_model(_t(q), views[0], views[1], lengths, D ** -0.5, None,
                       *lane_map(D, es, H // kvh, hpb),
                       *(views[2:] if int8 else ()))
    np.testing.assert_allclose(model.numpy(), got.numpy(), **TOL)
    np.testing.assert_allclose(model.numpy()[1:], want_j[1:], **TOL)
    assert not model[0].any()                           # the dead lane
