"""The CUDA kernels against their plain versions on the card, at small
shapes with ragged edges (K1: ragged S, GQA, D = 128, both causal modes;
K2: GQA, zero-length rows, fused and unfused; K3: ragged chunks; K4 / K5:
ragged S, GQA, D = 128, both causal modes, a strided dO, and for the
16-bit (wgmma / TMA) kernels S below one tile, S = 2048 through the tile
ring, fp16, bitwise repeatability, the fp32 route on the FMA kernels and
a refused TMA stride; the 16-bit K1 / K3 / K7 (wgmma / TMA): GQA,
ragged and unequal Sq / Sk, non-causal, a non-power-of-two scale, D =
128, fp16, the LSE at the fp32 bar, routing by dtype, refused TMA
strides, rows past the causal limit poisoned with NaN, and the 16-bit
autograd path against the CPU; K6 / K7: page
sizes 8 to 128 over a shuffled block table, G = 1 to 8, a zero-length
lane on the trash page, and bitwise against K2 / K3 over the gathered
view; K8: blocks 16 to 128, head dims 64 / 128, causal or with a
key-padding bias, one layout or one per head, empty rows, the LSE at the
fp32 bar, ragged S against the 16-bit kernel's 64-row tiles, a padded
batch, repeat launches bitwise, routing by dtype, refused TMA strides),
the autograd
flash and block-sparse attention on the card against the CPU's
gradients, plus the port's model (dense and block-sparse) on the card
against the same model on the CPU.

These tests need a CUDA device and skip without one.  They import no JAX,
so they run on the card's machine without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_kernels.py

Tolerances: fp32 1e-4 (summation order), bf16 / fp16 2e-2 (output
rounding); written cache rows bitwise.
"""

import pytest
import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.transformer import decode_attention as da
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
from deepspeed_tpu_torch.ops.transformer import paged_attention as pa

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _randn(gen, *shape, dtype, device):
    return torch.randn(*shape, generator=gen, device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kvh", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda, dtype, D, kvh, causal):
    g = torch.Generator(device=cuda).manual_seed(D + kvh)
    B, S, H = 2, 100, 4                      # S ragged against 64-row tiles
    q = _randn(g, B, S, H, D, dtype=dtype, device=cuda)
    k = _randn(g, B, S, kvh, D, dtype=dtype, device=cuda)
    v = _randn(g, B, S, kvh, D, dtype=dtype, device=cuda)
    before = fa.flash_attention.launches
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    assert fa.flash_attention.launches == before + 1
    want, want_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                              scale=D ** -0.5)
    _close(out, want, dtype)
    _close(lse, want_lse, dtype)


@pytest.fixture(params=["h100", "one_sm"])
def card(request, cuda, monkeypatch):
    """The launch choices of this card, or of a one-SM card: 2 kv heads a
    block wherever KVH and G allow."""
    if request.param == "one_sm":
        monkeypatch.setattr(da, "_sm_count", lambda index: 1)
    return request.param


def _tile(B, KVH, D, cache_bytes, G=1):
    """Positions of one tile of a K2 / K6 launch on this card (or the
    `card` fixture's), from the kernel library."""
    hpb = da.heads_per_block(B, KVH, G, da._sm_count(0))
    return op_builder.DECODE.load().dstt_decode_tile_positions(
        cache_bytes, D, hpb)


def _decode_lengths(case, B, KVH, G, S_max, D, cache_bytes):
    """Lengths of the decode kernel cases: "ragged" (0, 1, a tile of 64
    and one past it, a full row), "edges" (0, 1 and one short of, on and
    one past a tile and the 3-tile ring, a full row), "long" (one row of
    4096 positions at B = 1)."""
    if case == "ragged":
        return [0, 1, 64, 65, 136][:B]
    if case == "long":
        return [S_max - 95]
    tp = _tile(B, KVH, D, cache_bytes, G)
    return [min(n, S_max) for n in [0, 1, tp - 1, tp, tp + 1, 2 * tp,
                                     3 * tp - 1, 3 * tp, 3 * tp + 1,
                                     S_max][:B]]


DECODE_CASES = {"ragged": (5, 136), "edges": (10, 200), "long": (1, 4096)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_kernel_matches_plain(card, cuda, dtype, D, fused, case):
    """K2 against its plain version at ragged lengths, at the tile and
    ring edges (+-1) and on one long row at B = 1; the fused write
    bitwise the plain write, zero-length rows 0,
    and a second launch bitwise the first."""
    g = torch.Generator(device=cuda).manual_seed(D)
    B, S_max = DECODE_CASES[case]
    L, H, KVH, layer = 2, 8, 2, 1
    es = torch.tensor([], dtype=dtype).element_size()
    lengths = torch.tensor(_decode_lengths(case, B, KVH, H // KVH, S_max, D,
                                           es),
                           dtype=torch.int32, device=cuda)
    kc = _randn(g, L, B, S_max, KVH * D, dtype=dtype, device=cuda)
    vc = _randn(g, L, B, S_max, KVH * D, dtype=dtype, device=cuda)
    q = _randn(g, B, H, D, dtype=dtype, device=cuda)
    nk = _randn(g, B, KVH, D, dtype=dtype, device=cuda)
    nv = _randn(g, B, KVH, D, dtype=dtype, device=cuda)
    kw = dict(new_k=nk, new_v=nv) if fused else {}
    k1, v1 = kc.clone(), vc.clone()
    got = da.decode_attention(q, k1, v1, lengths, layer=layer, **kw)
    k2, v2 = kc.clone(), vc.clone()
    want = da.decode_attention_plain(q, k2[layer], v2[layer], lengths, **kw)
    if fused:
        got, ko, vo = got
        assert ko is k1 and vo is v1
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    _close(got, want, dtype)
    empty = lengths == 0
    assert not got[empty].any()                            # empty rows
    k3, v3 = kc.clone(), vc.clone()
    again = da.decode_attention(q, k3, v3, lengths, layer=layer, **kw)
    assert torch.equal(again[0] if fused else again, got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [64, 128])
def test_chunk_kernel_matches_plain(cuda, dtype, D):
    g = torch.Generator(device=cuda).manual_seed(D + 1)
    L, B, C, H, KVH, S_max, layer = 2, 3, 40, 4, 2, 200, 0
    kc = _randn(g, L, B, S_max, KVH * D, dtype=dtype, device=cuda)
    vc = _randn(g, L, B, S_max, KVH * D, dtype=dtype, device=cuda)
    q = _randn(g, B, C, H, D, dtype=dtype, device=cuda)
    starts = torch.tensor([0, 57, 160], dtype=torch.int32, device=cuda)
    got = da.chunk_prefill_attention(q, kc, vc, starts, layer=layer)
    want = da.chunk_prefill_attention_plain(q, kc[layer], vc[layer], starts)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kvh", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_kernels_match_plain(cuda, dtype, D, kvh, causal):
    """K4 (dq) and K5 (dk / dv) against the plain backward on the same
    residuals; the in-kernel scale is D^-0.5 (the dS scale path), and a
    strided dO (a slice of a wider tensor) is read through its strides."""
    g = torch.Generator(device=cuda).manual_seed(3 * D + kvh)
    B, S, H = 2, 100, 4
    q = _randn(g, B, S, H, D, dtype=dtype, device=cuda)
    k = _randn(g, B, S, kvh, D, dtype=dtype, device=cuda)
    v = _randn(g, B, S, kvh, D, dtype=dtype, device=cuda)
    dout = _randn(g, B, S, 2 * H, D, dtype=dtype, device=cuda)[:, :, ::2]
    scale = D ** -0.5
    out, lse = fa.launch_attention_kernel(q, k, v, causal, scale, None, True)
    before = (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal, scale)
    assert (fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == (before[0] + 1, before[1] + 1)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal,
                                        scale)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        _close(a, b, dtype)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kvh", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_autograd_on_card_matches_cpu(cuda, D, kvh, causal):
    """The autograd Function (K1 with LSE, then K4 / K5) on the card gives
    the CPU's gradients (plain forward and backward), fp32: D = 64 folds
    its scale into q, D = 128 keeps it in the kernels."""
    gen = torch.Generator().manual_seed(D + kvh)
    B, S, H = 2, 77, 4
    cpu = [torch.randn(B, S, n, D, generator=gen) for n in (H, kvh, kvh, H)]
    grads = []
    for dev in ("cpu", cuda):
        q, k, v = (t.to(dev).requires_grad_(True) for t in cpu[:3])
        out = fa.flash_attention(q, k, v, causal=causal)
        grads.append(torch.autograd.grad(out, (q, k, v), cpu[3].to(dev)))
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)


# the 16-bit K4 / K5 (wgmma + TMA) against the fp32 plain backward of the
# same 16-bit inputs: max |err| <= 2^-7 * max |grad| (chip_smoke.py's
# BWD_BF16_REL: both sum in fp32; the kernels round P, dS and the outputs
# to the input type, as JAX does)
BWD_16_REL = 2.0 ** -7
WGMMA_CASES = [  # B, S, H, KVH, D, causal
    (2, 17, 4, 4, 64, True),        # S below one 64-row tile
    (1, 2048, 2, 2, 64, True),      # 32 tiles through the 2-stage ring
    (1, 2048, 2, 1, 128, False),    # the ring at D = 128, GQA
    (2, 100, 8, 2, 128, True),      # D = 128 with GQA, ragged
    (2, 77, 4, 2, 64, False),       # non-causal, ragged
    (2, 130, 4, 4, 128, False),     # non-causal, ragged, D = 128
]


def _bwd_inputs(g, dtype, device, B, S, H, KVH, D):
    q = _randn(g, B, S, H, D, dtype=dtype, device=device)
    k = _randn(g, B, S, KVH, D, dtype=dtype, device=device)
    v = _randn(g, B, S, KVH, D, dtype=dtype, device=device)
    dout = _randn(g, B, S, H, D, dtype=dtype, device=device)
    return q, k, v, dout


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", WGMMA_CASES,
                         ids=[f"B{c[0]}-S{c[1]}-H{c[2]}-kvh{c[3]}-D{c[4]}-"
                              f"{'causal' if c[5] else 'full'}"
                              for c in WGMMA_CASES])
def test_flash_backward_wgmma_matches_fp32_plain(cuda, dtype, case):
    """The tensor-core K4 / K5 at ragged, one-tile, many-tile, D = 128 and
    GQA shapes, causal and not, both in-kernel scales (1 and D^-0.5),
    against the fp32 plain backward of the same 16-bit inputs."""
    B, S, H, KVH, D, causal = case
    g = torch.Generator(device=cuda).manual_seed(S + D + H)
    q, k, v, dout = _bwd_inputs(g, dtype, cuda, B, S, H, KVH, D)
    for scale in (1.0, D ** -0.5):
        out, lse = fa.launch_attention_kernel(q, k, v, causal, scale, None,
                                              True)
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal, scale)
        want = fa.flash_attention_bwd_plain(
            *(t.float() for t in (q, k, v, out)), lse, dout.float(), causal,
            scale)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            assert a.dtype == dtype and a.shape == b.shape
            err = float((a.float() - b).abs().max())
            top = float(b.abs().max())
            assert bool(torch.isfinite(a).all()) and err <= BWD_16_REL * top, \
                (name, scale, err, top)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_backward_is_bitwise_repeatable(cuda, dtype):
    """Every output tile is written by one block, with no atomics: two
    launches on the same inputs give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v, dout = _bwd_inputs(g, dtype, cuda, 2, 300, 8, 2, 64)
    out, lse = fa.launch_attention_kernel(q, k, v, True, 0.125, None, True)
    first = fa.flash_attention_bwd(q, k, v, out, lse, dout, True, 0.125)
    second = fa.flash_attention_bwd(q, k, v, out, lse, dout, True, 0.125)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_backward_routes_by_dtype(cuda, dtype, tmp_path):
    """fp32 runs the FMA kernels (``flash_bwd_dq_kernel`` /
    ``flash_bwd_dkv_kernel``, and stays at the fp32 bar of 1e-4 against the
    plain backward); bf16 / fp16 run the wgmma kernels."""
    from deepspeed_tpu_torch.profiling.trace import kernel_events
    g = torch.Generator(device=cuda).manual_seed(12)
    q, k, v, dout = _bwd_inputs(g, dtype, cuda, 2, 100, 4, 2, 128)
    scale = 128 ** -0.5
    out, lse = fa.launch_attention_kernel(q, k, v, True, scale, None, True)
    got = {}

    def run():
        got["g"] = fa.flash_attention_bwd(q, k, v, out, lse, dout, True,
                                          scale)

    names = {e["name"] for e in kernel_events(run, tmp_path / "route.json")}
    wgmma = {n for n in names if "wgmma_flash_bwd" in n}
    fma = {n for n in names if "flash_bwd" in n and n not in wgmma}
    if dtype == torch.float32:
        assert not wgmma and len(fma) == 2, names
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, True,
                                            scale)
        for a, b in zip(got["g"], want):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    else:
        assert not fma and len(wgmma) == 2, names


def test_flash_backward_refuses_strides_tma_cannot_take(cuda):
    """A 16-bit tensor whose (b, s, h) strides are not whole 16-byte units,
    or whose address is not 16-byte aligned, raises: no fallback."""
    g = torch.Generator(device=cuda).manual_seed(13)
    B, S, H, D = 1, 64, 2, 64
    q, k, v, dout = _bwd_inputs(g, torch.bfloat16, cuda, B, S, H, H, D)
    out, lse = fa.launch_attention_kernel(q, k, v, True, 0.125, None, True)
    wide = _randn(g, B, S, H, D + 4, dtype=torch.bfloat16, device=cuda)
    odd = wide[..., :D]                       # h stride 136 bytes
    flat = _randn(g, B * S * H * D + 1, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:].view(B, S, H, D)       # address 2 bytes past 16
    before = (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches)
    for name, bad in (("dout", odd), ("k", odd), ("q", shifted)):
        args = dict(q=q, k=k, v=v, dout=dout)
        args[name] = bad
        with pytest.raises(ValueError, match="TMA"):
            fa.flash_attention_bwd(args["q"], args["k"], args["v"], out, lse,
                                   args["dout"], True, 0.125)
    assert (fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == before


# the 16-bit forward (wgmma + TMA): B, Sq, Sk, H, KVH, D, causal, scale
# (None: D^-0.5, folded into q at D = 64; 0.1: a non-power-of-two scale
# in the kernel)
FWD16_CASES = [
    (2, 17, 17, 4, 4, 64, True, None),       # below one 64-row tile
    (2, 100, 100, 8, 2, 64, True, 0.1),      # ragged, GQA
    (1, 300, 300, 4, 1, 128, True, None),    # D = 128, MQA, 5 tiles
    (2, 77, 130, 4, 2, 64, False, None),     # non-causal, Sq != Sk
    (2, 130, 77, 4, 4, 128, False, 0.1),     # non-causal, Sk < Sq
    (1, 64, 200, 8, 8, 64, True, None),      # Sq < Sk, causal
    (1, 2048, 2048, 2, 2, 64, True, None),   # 32 tiles through the ring
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", FWD16_CASES,
                         ids=[f"B{c[0]}-Sq{c[1]}-Sk{c[2]}-H{c[3]}-kvh{c[4]}-"
                              f"D{c[5]}-{'causal' if c[6] else 'full'}-"
                              f"{'pow2' if c[7] is None else 'scale'}"
                              for c in FWD16_CASES])
def test_flash_forward_16bit_matches_plain(cuda, dtype, case):
    """K1's tensor-core forward against the plain version of the same
    16-bit inputs: the output at the 16-bit bar (the kernel rounds P to
    the input type before P.V, as JAX does), the LSE at the fp32 bar."""
    B, Sq, Sk, H, KVH, D, causal, scale = case
    g = torch.Generator(device=cuda).manual_seed(Sq + Sk + D)
    q = _randn(g, B, Sq, H, D, dtype=dtype, device=cuda)
    k = _randn(g, B, Sk, KVH, D, dtype=dtype, device=cuda)
    v = _randn(g, B, Sk, KVH, D, dtype=dtype, device=cuda)
    before = fa.flash_attention.launches
    out, lse = fa.flash_attention(q, k, v, causal=causal, scale=scale,
                                  return_lse=True)
    assert fa.flash_attention.launches == before + 1
    # a power-of-two scale folded into q is exact: the plain version
    # takes the scale itself
    want, want_lse = fa.flash_attention_plain(
        q, k, v, causal=causal, scale=D ** -0.5 if scale is None else scale)
    _close(out, want, dtype)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_forward_routes_by_dtype(cuda, dtype, tmp_path):
    """fp32 runs the FMA ``flash_fwd_kernel``; bf16 / fp16 run
    ``wgmma_flash_fwd_kernel`` -- for K1, K3 and K7 alike."""
    from deepspeed_tpu_torch.profiling.trace import kernel_events
    g = torch.Generator(device=cuda).manual_seed(14)
    q = _randn(g, 2, 100, 4, 64, dtype=dtype, device=cuda)
    k = _randn(g, 2, 100, 2, 64, dtype=dtype, device=cuda)
    kp, vp, pages = _paged_pool(g, dtype, cuda, 64, 2, 16, 4, 2)
    cache = _randn(g, 2, 64, 128, dtype=dtype, device=cuda)
    starts = torch.tensor([3, 20], dtype=torch.int32, device=cuda)

    def run():
        fa.flash_attention(q, k, k, causal=True)
        da.chunk_prefill_attention(q[:, :40], cache, cache, starts)
        pa.paged_chunk_prefill_attention(q[:, :40], kp, vp, starts, pages,
                                         layer=0)

    names = [e["name"] for e in kernel_events(run, tmp_path / "fwd.json")]
    fwd = [n for n in names if "flash_fwd_kernel" in n]
    wgmma = [n for n in fwd if "wgmma_flash_fwd_kernel" in n]
    assert len(fwd) == 3, names
    assert len(wgmma) == (0 if dtype == torch.float32 else 3), names


def test_flash_forward_refuses_strides_tma_cannot_take(cuda):
    """A 16-bit q / k / v (K1), q (K3, K3-int8, K7) or pool (K7) that TMA
    cannot take raises before any launch: no fallback."""
    g = torch.Generator(device=cuda).manual_seed(15)
    B, S, H, D = 1, 64, 2, 64
    dt = torch.bfloat16
    q, k, v = (_randn(g, B, S, H, D, dtype=dt, device=cuda) for _ in range(3))
    odd = _randn(g, B, S, H, D + 4, dtype=dt, device=cuda)[..., :D]
    flat = _randn(g, B * S * H * D + 1, dtype=dt, device=cuda)
    shifted = flat[1:].view(B, S, H, D)        # address 2 bytes past 16
    counts = (fa.flash_attention.launches,
              da.chunk_prefill_attention.launches,
              da.chunk_prefill_attention.int8_launches,
              pa.paged_chunk_prefill_attention.launches)
    for name, bad in (("q", odd), ("k", shifted), ("v", odd)):
        args = dict(q=q, k=k, v=v)
        args[name] = bad
        with pytest.raises(ValueError, match="TMA"):
            fa.flash_attention(args["q"], args["k"], args["v"], scale=0.1)
    starts = torch.tensor([0], dtype=torch.int32, device=cuda)
    cache = _randn(g, B, 128, H * D, dtype=dt, device=cuda)
    with pytest.raises(ValueError, match="TMA"):
        da.chunk_prefill_attention(odd, cache, cache, starts)
    kc, vc, ks, vs = _int8_pair(g, cuda, B, 128, KVH=H, D=D)
    with pytest.raises(ValueError, match="TMA"):
        da.chunk_prefill_attention(shifted, kc, vc, starts, k_scale=ks,
                                   v_scale=vs)
    kp, vp, pages = _paged_pool(g, dt, cuda, D, H, 16, 4, 2)
    with pytest.raises(ValueError, match="TMA"):
        pa.paged_chunk_prefill_attention(odd, kp, vp, starts, pages[1:],
                                         layer=0)
    assert counts == (fa.flash_attention.launches,
                      da.chunk_prefill_attention.launches,
                      da.chunk_prefill_attention.int8_launches,
                      pa.paged_chunk_prefill_attention.launches)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("int8", [False, True])
def test_chunk_kernels_ignore_rows_past_the_limit(cuda, dtype, D, int8):
    """K3 and K7, float and int8-KV: cache / pool rows past every query's
    causal limit (and, for K7, every page the chunk does not reach) set
    to NaN give finite outputs bitwise equal to the zero-filled run."""
    g = torch.Generator(device=cuda).manual_seed(16 + D)
    H, KVH, C, page, n_virt = 8, 4, 40, 24, 6
    B, S_max = 3, page * n_virt
    starts = torch.tensor([0, 37, 80], dtype=torch.int32, device=cuda)
    live = (torch.arange(S_max, device=cuda)[None]
            < (starts[:, None] + C))                       # [B, S_max]
    q = _randn(g, B, C, H, D, dtype=dtype, device=cuda)
    if int8:
        kc, vc, ks, vs = _int8_pair(g, cuda, B, S_max, KVH=KVH, D=D)
    else:
        kc, vc = (_randn(g, B, S_max, KVH * D, dtype=dtype, device=cuda)
                  for _ in range(2))
        ks = vs = None

    def tails(fill_payload, fill_scale):
        out = []
        for t, fill in ((kc, fill_payload), (vc, fill_payload),
                        (ks, fill_scale), (vs, fill_scale)):
            out.append(None if t is None else
                       torch.where(live[..., None], t,
                                   torch.full_like(t, fill)))
        return out

    nan_fill = 127 if int8 else float("nan")
    poisoned, zeroed = tails(nan_fill, float("nan")), tails(0, 0.0)
    got = [da.chunk_prefill_attention(q, *t[:2], starts, k_scale=t[2],
                                      v_scale=t[3])
           for t in (poisoned, zeroed)]
    assert bool(torch.isfinite(got[0]).all())
    assert torch.equal(got[0], got[1])
    # the same views as one layer of a pool: rows scattered over shuffled
    # pages, every unmapped page and the trash page poisoned too
    n_pages = 1 + B * n_virt
    perm = 1 + torch.randperm(n_pages - 1, generator=torch.Generator()
                              .manual_seed(D))
    pages = perm.view(B, n_virt).to(device=cuda, dtype=torch.int32)
    outs = []
    for views, fill in ((poisoned, (nan_fill, float("nan"))),
                        (zeroed, (0, 0.0))):
        pools = []
        for i, t in enumerate(views):
            if t is None:
                pools.append(None)
                continue
            pool = torch.full((1, n_pages, page, t.shape[-1]),
                              fill[i >= 2], dtype=t.dtype, device=cuda)
            pool[0][pages.long()] = t.view(B, n_virt, page, t.shape[-1])
            pools.append(pool)
        outs.append(pa.paged_chunk_prefill_attention(
            q, pools[0], pools[1], starts, pages, layer=0, k_scale=pools[2],
            v_scale=pools[3]))
    assert bool(torch.isfinite(outs[0]).all())
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], got[0])           # K7 == K3 on the view


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_autograd_16bit_on_card_matches_cpu(cuda, dtype, D):
    """The 16-bit autograd path on the card -- K1's LSE feeding K4 / K5 --
    against the CPU's (plain forward, plain backward) on the same 16-bit
    inputs: max |err| <= 2^-7 * max |grad| (``BWD_16_REL``)."""
    gen = torch.Generator().manual_seed(3 * D)
    B, S, H, KVH = 2, 150, 4, 2
    cpu = [torch.randn(B, S, n, D, generator=gen).to(dtype)
           for n in (H, KVH, KVH, H)]
    grads = []
    for dev in ("cpu", cuda):
        q, k, v = (t.to(dev).requires_grad_(True) for t in cpu[:3])
        out = fa.flash_attention(q, k, v, causal=True)
        grads.append(torch.autograd.grad(out, (q, k, v), cpu[3].to(dev)))
    for a, b in zip(grads[1], grads[0]):
        err = float((a.cpu().float() - b.float()).abs().max())
        assert bool(torch.isfinite(a).all())
        assert err <= BWD_16_REL * float(b.float().abs().max()), err


def test_unsupported_head_dim_raises(cuda):
    x = torch.zeros(1, 8, 4, 16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(x, x, x)
    lse = torch.zeros(1, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_bwd(x, x, x, x, lse, x, True, 0.25)


def test_model_on_card_matches_cpu(cuda):
    """Prefill + cached decode through K1 and K2 on the card equal the
    plain path on the CPU, fp32, same weights (matrices normal with std
    0.5, as in the CPU parity tests).  Tolerance 1e-3: the projections'
    fp32 GEMMs sum in another order in cuBLAS than in the CPU BLAS, and
    two layers carry that into the logits.  On an H100 the prefill logits'
    largest gap was 4.7e-4 (abs) and 3.5e-4 (rel), the one logit of 3,104
    past a 2e-4 bar."""
    from deepspeed_tpu_torch.models.transformer import (Transformer,
                                                        TransformerConfig)
    cfg = TransformerConfig(vocab_size=97, hidden_size=256, num_layers=2,
                            num_heads=4, max_seq_len=64, dtype="float32",
                            tie_word_embeddings=True)
    cpu = Transformer(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():                  # init_weights' layout, std 0.5
        for mod in cpu.modules():
            if isinstance(mod, torch.nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, (torch.nn.Linear, torch.nn.Embedding)):
                mod.weight.normal_(0.0, 0.5, generator=gen)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
    gpu = Transformer(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.randint(0, 97, (2, 20), generator=torch.Generator()
                        .manual_seed(1))
    caches = [m.init_cache(2, 24, dtype=torch.float32) for m in (cpu, gpu)]
    with torch.no_grad():
        want, _ = cpu.decode(ids[:, :16], caches[0], 0, prefill=True)
        got, _ = gpu.decode(ids[:, :16].cuda(), caches[1], 0, prefill=True)
        torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-3)
        for t in range(16, 20):
            want, _ = cpu.decode(ids[:, t:t + 1], caches[0], t)
            got, _ = gpu.decode(ids[:, t:t + 1].cuda(), caches[1], t)
            torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("over", [{}, dict(remat=True, loss_seq_chunks=4)],
                         ids=["plain", "remat-chunked"])
def test_model_training_on_card_matches_cpu(cuda, over):
    """The loss and every gradient of the port's model, through K1 / K4 /
    K5 on the card, against the same model on the CPU (plain attention
    forward and backward), fp32, same weights and a ragged S = 40.
    Gradients at rtol 1e-4 / atol 1e-6 (the largest gradients are ~1e-1):
    the GEMMs sum in another order in cuBLAS than in the CPU BLAS.  The key biases are left out: their true
    gradient is 0 (a key bias shifts a row's scores alike), so both sides
    give roundoff."""
    from deepspeed_tpu_torch.models.transformer import (Transformer,
                                                        TransformerConfig)
    cfg = TransformerConfig(vocab_size=97, hidden_size=256, num_layers=2,
                            num_heads=4, max_seq_len=64, dtype="float32",
                            tie_word_embeddings=True,
                            **{"remat": False, **over})
    cpu = Transformer(cfg, device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(0))
    gpu = Transformer(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.randint(0, 97, (2, 40), generator=torch.Generator()
                        .manual_seed(1))
    counters = (fa.flash_attention, fa.flash_attention_dq,
                fa.flash_attention_dkv)
    losses = []
    for m, dev in ((cpu, "cpu"), (gpu, cuda)):
        before = [c.launches for c in counters]
        loss = m({"input_ids": ids.to(dev)})
        loss.backward()
        losses.append(loss.detach().cpu())
    # remat runs each block's forward again in the backward
    k1 = 4 if cfg.remat else 2
    assert [c.launches - b for c, b in zip(counters, before)] == [k1, 2, 2]
    torch.testing.assert_close(losses[1], losses[0], atol=1e-5, rtol=1e-5)
    for (name, p), (_, g) in zip(cpu.named_parameters(),
                                 gpu.named_parameters()):
        if name.endswith("attn.k_proj.bias"):
            continue
        torch.testing.assert_close(g.grad.cpu(), p.grad, atol=1e-6,
                                   rtol=1e-4, msg=name)


def _paged_pool(g, dtype, device, D, KVH, page, n_virt, B, L=2):
    """A pool with a shuffled block table: row 0 is a dead lane (all trash
    page 0), the others own n_virt distinct pages each, in random order."""
    n_pages = 1 + (B - 1) * n_virt
    kp = _randn(g, L, n_pages, page, KVH * D, dtype=dtype, device=device)
    vp = _randn(g, L, n_pages, page, KVH * D, dtype=dtype, device=device)
    perm = 1 + torch.randperm(n_pages - 1, generator=torch.Generator()
                              .manual_seed(page + D))
    pages = torch.zeros(B, n_virt, dtype=torch.int32)
    pages[1:] = perm.view(B - 1, n_virt).to(torch.int32)
    return kp, vp, pages.to(device)


def _paged_lengths(B, KVH, G, page, n_virt, D, cache_bytes):
    """K6 lengths: a dead lane (0), 1, a row two pages and 3 in, one short
    of and one past a tile and the 3-tile ring, and a full row; ``B`` of
    them."""
    S_max = page * n_virt
    tp = _tile(B, KVH, D, cache_bytes, G)
    ls = [0, 1, 2 * page + 3, tp - 1, tp + 1, 3 * tp - 1, 3 * tp + 1, S_max]
    return [min(n, S_max) for n in (ls + [tp] * B)[:B]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("page", [5, 8, 13, 16, 24, 64, 128])
@pytest.mark.parametrize("fused", [True, False])
def test_paged_decode_kernel_matches_plain_and_k2(card, cuda, dtype, D, G,
                                                  page, fused):
    """K6 against its plain version, and bitwise against K2 over the
    gathered view pool[pages] (same schedule, other addresses), at pages
    that are and are not a multiple of 8 and lengths at the tile and
    ring edges; the fused write lands bitwise where the plain write
    puts it, and a second launch is bitwise the first."""
    g = torch.Generator(device=cuda).manual_seed(D + G + page)
    H, B, layer = 8, 8, 1
    n_virt = max(3, -(-256 // page))
    KVH = H // G
    kp, vp, pages = _paged_pool(g, dtype, cuda, D, KVH, page, n_virt, B)
    q = _randn(g, B, H, D, dtype=dtype, device=cuda)
    nk = _randn(g, B, KVH, D, dtype=dtype, device=cuda)
    nv = _randn(g, B, KVH, D, dtype=dtype, device=cuda)
    es = torch.tensor([], dtype=dtype).element_size()
    lengths = torch.tensor(_paged_lengths(B, KVH, G, page, n_virt, D, es),
                           dtype=torch.int32, device=cuda)
    kw = dict(new_k=nk, new_v=nv) if fused else {}
    k1, v1 = kp.clone(), vp.clone()
    before = pa.paged_decode_attention.launches
    got = pa.paged_decode_attention(q, k1, v1, lengths, pages, layer=layer,
                                    **kw)
    assert pa.paged_decode_attention.launches == before + 1
    if fused:
        got, ko, vo = got
        assert ko is k1 and vo is v1
    again = pa.paged_decode_attention(q, kp.clone(), vp.clone(), lengths,
                                      pages, layer=layer, **kw)
    assert torch.equal(again[0] if fused else again, got)
    k2, v2 = kp.clone(), vp.clone()
    want = pa.paged_decode_attention_plain(q, k2[layer], v2[layer], lengths,
                                           pages, **kw)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    _close(got, want, dtype)
    assert torch.equal(got[0], torch.zeros_like(got[0]))   # the dead lane
    # K2 over the gathered view, written the same way
    gk = pa.gather_pages(kp[layer], pages)
    gv = pa.gather_pages(vp[layer], pages)
    mono = da.decode_attention(q, gk, gv, lengths, **kw)
    if fused:
        mono = mono[0]
        live = slice(1, B)
        assert torch.equal(pa.gather_pages(k1[layer], pages)[live], gk[live])
        assert torch.equal(pa.gather_pages(v1[layer], pages)[live], gv[live])
    assert torch.equal(got, mono)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("page", [8, 16, 24, 64, 128])
def test_paged_chunk_kernel_matches_plain_and_k3(cuda, dtype, D, G, page):
    """K7 against its plain version, and bitwise against K3 over the
    gathered view, with chunks that start inside a page and cross page
    boundaries (a 24-row page does not divide the 64-row k tile)."""
    g = torch.Generator(device=cuda).manual_seed(2 * D + G + page)
    H, B, C, layer = 8, 3, 40, 0
    KVH = H // G
    n_virt = -(-(2 * page + 3 + C) // page)
    kp, vp, pages = _paged_pool(g, dtype, cuda, D, KVH, page, n_virt, B + 1)
    pages = pages[1:].contiguous()                  # live rows only
    q = _randn(g, B, C, H, D, dtype=dtype, device=cuda)
    starts = torch.tensor([0, page - 3, 2 * page + 3], dtype=torch.int32,
                          device=cuda)
    before = pa.paged_chunk_prefill_attention.launches
    got = pa.paged_chunk_prefill_attention(q, kp, vp, starts, pages,
                                           layer=layer)
    assert pa.paged_chunk_prefill_attention.launches == before + 1
    want = pa.paged_chunk_prefill_attention_plain(q, kp[layer], vp[layer],
                                                  starts, pages)
    _close(got, want, dtype)
    mono = da.chunk_prefill_attention(q, pa.gather_pages(kp[layer], pages),
                                      pa.gather_pages(vp[layer], pages),
                                      starts)
    assert torch.equal(got, mono)


def test_paged_kernels_refuse_bad_inputs(cuda):
    """A block table on another device, a wrong table shape, a 3-D pool and
    an unsupported head dim raise before any launch."""
    g = torch.Generator(device=cuda).manual_seed(0)
    kp, vp, pages = _paged_pool(g, torch.float32, cuda, 64, 2, 16, 2, 3)
    q = _randn(g, 3, 4, 64, dtype=torch.float32, device=cuda)
    lengths = torch.tensor([0, 5, 20], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="device|cpu"):
        pa.paged_decode_attention(q, kp, vp, lengths, pages.cpu(), layer=0)
    with pytest.raises(ValueError, match="block table"):
        pa.paged_decode_attention(q, kp, vp, lengths, pages[:2], layer=0)
    with pytest.raises(ValueError, match="layer-stacked"):
        pa.paged_decode_attention(q, kp[0], vp[0], lengths, pages, layer=0)
    qc = _randn(g, 3, 8, 4, 64, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="device|cpu"):
        pa.paged_chunk_prefill_attention(qc, kp, vp, lengths, pages.cpu(),
                                         layer=0)
    x = torch.zeros(3, 4, 16, device=cuda)
    small = torch.zeros(1, 7, 16, 32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_decode_attention(x, small, small, lengths, pages, layer=0)


@pytest.mark.parametrize("page", [16, 24])
def test_serving_on_card_paged_equals_monolithic(cuda, page):
    """The serving engine on the card, fp32: 10 mixed requests on 3 slots
    through K7 / K6 over a paged pool give every request the tokens of the
    monolithic lanes (K3 / K2), with one K6 launch per layer and decode
    step and one K7 launch per layer and prefill chunk; after the drain
    every page is back (the prefix index keeps its own)."""
    import numpy as np
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.transformer import (Transformer,
                                                        TransformerConfig)
    cfg = TransformerConfig(vocab_size=97, hidden_size=256, num_layers=2,
                            num_heads=4, max_seq_len=128, dtype="float32",
                            tie_word_embeddings=True)
    eng = init_inference(Transformer(cfg), dtype="float32", device=cuda,
                         prefill_chunk_size=16)
    eng.init_params(seed=0)
    rng = np.random.default_rng(page)
    reqs = [(rng.integers(0, 97, int(p)).astype(np.int32), int(n))
            for p, n in zip(rng.integers(5, 60, 10), rng.integers(2, 30, 10))]
    kw = dict(num_slots=3, max_cache_len=96, prefill_chunk=16,
              prefill_token_budget=32, decode_block=3, page_size=page)
    outs, counts = {}, {}
    for paged in (True, False):
        before = (pa.paged_decode_attention.launches,
                  pa.paged_chunk_prefill_attention.launches,
                  da.decode_attention.launches,
                  da.chunk_prefill_attention.launches)
        srv = eng.serve(paged=paged, **kw)
        rids = [srv.submit(p, max_new_tokens=n) for p, n in reqs]
        res = srv.drain()
        outs[paged] = [res[r] for r in rids]
        after = (pa.paged_decode_attention.launches,
                 pa.paged_chunk_prefill_attention.launches,
                 da.decode_attention.launches,
                 da.chunk_prefill_attention.launches)
        counts[paged] = [a - b for a, b in zip(after, before)]
        L, st = cfg.num_layers, srv.stats
        decode = L * srv.block * st["decode_calls"]
        chunks = L * st["prefill_tokens"] // srv.chunk
        want = [decode, chunks, 0, 0] if paged else [0, 0, decode, chunks]
        assert counts[paged] == want
        assert st["completed"] == len(reqs)
        if paged:
            assert not srv._slot_pages and (srv._page_table == 0).all()
            assert srv._pool.in_use == len(srv._prefix)
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------- #
# K8: block-sparse attention forward
# --------------------------------------------------------------------- #
def _sparse_layout(kind, H, block, S):
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    if kind == "bigbird":           # one layout broadcast over heads
        cfg = sa.BigBirdSparsityConfig(num_heads=H, block=block,
                                       num_random_blocks=2, seed=block)
    else:                           # a layout per head
        cfg = sa.FixedSparsityConfig(num_heads=H, block=block,
                                     num_local_blocks=2,
                                     different_layout_per_head=True,
                                     num_different_global_patterns=2)
    return cfg.make_layout(S)


def _sparse_check(q, k, v, tables, block, causal, bias, dtype):
    """K8 with its LSE against the plain version (the output at the
    dtype's bar, the LSE at the fp32 bar), launched twice: bitwise the
    same, one count each."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
    D = q.shape[-1]
    before = bs.block_sparse_attention_fwd.launches
    got, lse = bs.block_sparse_attention_fwd(q, k, v, tables, D ** -0.5,
                                             causal, block, bias,
                                             with_lse=True)
    again, lse_again = bs.block_sparse_attention_fwd(
        q, k, v, tables, D ** -0.5, causal, block, bias, with_lse=True)
    assert bs.block_sparse_attention_fwd.launches == before + 2
    assert torch.equal(got, again) and torch.equal(lse, lse_again)
    want, want_lse = bs.block_sparse_attention_plain(
        q, k, v, tables.idx, tables.counts, D ** -0.5, causal, block, bias,
        return_lse=True)
    assert got.dtype == dtype and lse.dtype == torch.float32
    _close(got, want, dtype)
    _close(lse, want_lse, torch.float32)
    return got, lse


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_block_sparse_kernel_matches_plain(cuda, dtype, block, D, causal):
    """K8 and its LSE against its plain version: blocks 16-128, head dims
    64 / 128, causal and not, one layout broadcast and a layout per head;
    without causality a key-padding bias whose row 1 has its tail block
    fully padded; q, k and v are strided views of one projection; each
    case launched twice, bitwise the same."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
    g = torch.Generator(device=cuda).manual_seed(block + D)
    B, H, S = 2, 4, 8 * block
    qkv = _randn(g, B, S, 3, H, D, dtype=dtype, device=cuda)
    q, k, v = qkv.unbind(2)
    bias = None
    if not causal:
        keep = torch.ones(B, S, device=cuda)
        keep[0, S - 37:] = 0
        keep[1, S - block:] = 0
        bias = bs.padding_bias(keep, dtype, cuda)
    for kind in ("bigbird", "fixed"):
        lay = _sparse_layout(kind, H, block, S)
        tables = bs.device_tables(lay, H, causal, cuda, block)
        _sparse_check(q, k, v, tables, block, causal, bias, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block,S", [(16, 1040), (32, 288)])
@pytest.mark.parametrize("causal", [True, False])
def test_block_sparse_kernel_ragged_seq(cuda, dtype, block, S, causal):
    """S divisible by the block but not by the 16-bit kernel's 64-row
    tiles: the last q and key tiles are ragged (TMA's zero fill, cells
    past S never live, no row past S written)."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
    g = torch.Generator(device=cuda).manual_seed(S + causal)
    B, H, D = 2, 4, 64
    q, k, v = (_randn(g, B, S, H, D, dtype=dtype, device=cuda)
               for _ in range(3))
    for kind in ("bigbird", "fixed"):
        lay = _sparse_layout(kind, H, block, S)
        tables = bs.device_tables(lay, H, causal, cuda, block)
        got, lse = _sparse_check(q, k, v, tables, block, causal, None, dtype)
        # the same launch into buffers with rows past S: none is written
        out = torch.full((B, S + 64, H, D), 7.0, dtype=dtype, device=cuda)
        lse_out = torch.full((B, H, S + 64), 7.0, device=cuda)
        err = op_builder.SPARSE.load().dstt_block_sparse_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse_out.data_ptr(), *(t.data_ptr() for t in tables), None,
            op_builder.dtype_code(dtype), B, S, H, D,
            tables.idx.shape[-1], tables.tiles.shape[-1], block,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(causal), D ** -0.5,
            torch.cuda.current_stream().cuda_stream)
        op_builder.check(err, "block-sparse attention kernel")
        torch.cuda.synchronize()
        assert (out[:, S:] == 7.0).all() and torch.equal(out[:, :S], got)
        # the LSE rows are S apart in lse_out's [B, H, S] reading
        flat = lse_out.flatten()[:B * H * S].view(B, H, S)
        assert torch.equal(flat, lse)
        assert (lse_out.flatten()[B * H * S:] == 7.0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_block_sparse_kernel_padded_batch(cuda, dtype, causal):
    """A key-padding bias over a batch: a row padded from a ragged point,
    one whose tail block is fully padded, one fully padded (its queries
    attend to finite, padded scores, as in JAX), at block 32."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
    g = torch.Generator(device=cuda).manual_seed(11 + causal)
    B, H, S, D, block = 3, 4, 256, 64, 32
    q, k, v = (_randn(g, B, S, H, D, dtype=dtype, device=cuda)
               for _ in range(3))
    keep = torch.ones(B, S, device=cuda)
    keep[0, 173:] = 0
    keep[1, S - block:] = 0
    keep[2] = 0
    bias = bs.padding_bias(keep, dtype, cuda)
    lay = _sparse_layout("bigbird", H, block, S)
    tables = bs.device_tables(lay, H, causal, cuda, block)
    got, _ = _sparse_check(q, k, v, tables, block, causal, bias, dtype)
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("dtype", DTYPES)
def test_block_sparse_kernel_empty_rows_are_zero(cuda, dtype):
    """A block-row with no active block gives exactly 0 and LSE -1e30;
    padded table slots are never read (idx and tiles are garbage past
    counts and tile_counts)."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
    g = torch.Generator(device=cuda).manual_seed(7)
    B, H, S, D, block = 2, 2, 256, 64, 64
    q, k, v = (_randn(g, B, S, H, D, dtype=dtype, device=cuda)
               for _ in range(3))
    lay = torch.ones(H, 4, 4, dtype=torch.int64)
    lay[:, 2] = 0
    lay[1, 0] = 0
    t = bs.device_tables(lay.numpy(), H, False, cuda, block)
    idx = torch.where(torch.arange(t.idx.shape[-1], device=cuda)
                      < t.counts[..., None], t.idx, 10 ** 6).to(torch.int32)
    tiles = torch.where(torch.arange(t.tiles.shape[-1], device=cuda)
                        < t.tile_counts[..., None], t.tiles,
                        (0x7FFF << 16) | 0xFFFF).to(torch.int32)
    poisoned = bs.SparseTables(idx.contiguous(), t.counts,
                               tiles.contiguous(), t.tile_counts)
    got, lse = bs.block_sparse_attention_fwd(q, k, v, poisoned, D ** -0.5,
                                             False, block, with_lse=True)
    assert (got[:, 128:192] == 0).all() and (got[:, :64, 1] == 0).all()
    assert (lse[:, :, 128:192] == -1e30).all()
    assert (lse[:, 1, :64] == -1e30).all()
    want, want_lse = bs.block_sparse_attention_plain(
        q, k, v, t.idx, t.counts, D ** -0.5, False, block, return_lse=True)
    _close(got, want, dtype)
    _close(lse, want_lse, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_block_sparse_routes_by_dtype(cuda, dtype, tmp_path):
    """bf16 / fp16 launch ``wgmma_sparse_fwd_kernel``, fp32 the FMA
    ``block_sparse_fwd_kernel`` (fp32's bar of 1e-4 is beyond TF32's
    products), by the profiler's kernel names."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
    from deepspeed_tpu_torch.profiling.trace import kernel_events
    g = torch.Generator(device=cuda).manual_seed(5)
    B, H, S, D, block = 1, 2, 256, 64, 32
    q, k, v = (_randn(g, B, S, H, D, dtype=dtype, device=cuda)
               for _ in range(3))
    tables = bs.device_tables(_sparse_layout("bigbird", H, block, S), H,
                              True, cuda, block)

    def run():
        bs.block_sparse_attention_fwd(q, k, v, tables, D ** -0.5, True,
                                      block)

    names = [e["name"] for e in kernel_events(run, tmp_path / "k8.json")]
    wgmma = [n for n in names if "wgmma_sparse_fwd_kernel" in n]
    fma = [n for n in names if "block_sparse_fwd_kernel" in n]
    if dtype == torch.float32:
        assert not wgmma and len(fma) == 1, names
    else:
        assert not fma and len(wgmma) == 1, names


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_block_sparse_refuses_what_tma_cannot_load(cuda, dtype):
    """A 16-bit q / k / v whose (b, s, h) strides are not whole 16-byte
    units raises before a launch (no fallback)."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
    B, H, S, D, block = 1, 2, 64, 64, 64
    x = torch.zeros(B, S, H, D + 4, dtype=dtype, device=cuda)[..., 2:D + 2]
    tables = bs.device_tables(torch.ones(H, 1, 1).numpy(), H, False, cuda,
                              block)
    before = bs.block_sparse_attention_fwd.launches
    with pytest.raises(ValueError, match="TMA"):
        bs.block_sparse_attention_fwd(x, x, x, tables, 0.125, False, block)
    assert bs.block_sparse_attention_fwd.launches == before


@pytest.mark.parametrize("masked", [False, True])
def test_block_sparse_autograd_on_card_matches_cpu(cuda, masked):
    """K8 forward plus the gather backward on the card give the CPU's
    output and gradients (the plain forward and the same backward), fp32,
    through the public entry with the key-padding fold."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    gen = torch.Generator().manual_seed(3)
    B, S, H, D, block = 2, 256, 4, 64, 32
    cpu = [torch.randn(B, S, H, D, generator=gen) for _ in range(4)]
    lay = sa.BigBirdSparsityConfig(num_heads=H, block=block).make_layout(S)
    keep = torch.ones(B, S)
    keep[1, 200:] = 0
    res = []
    for dev in ("cpu", cuda):
        q, k, v = (t.to(dev).requires_grad_(True) for t in cpu[:3])
        out = sa.block_sparse_attention(
            q, k, v, lay, block, causal=not masked,
            key_padding_mask=keep.to(dev) if masked else None)
        res.append([out] + list(torch.autograd.grad(out, (q, k, v),
                                                    cpu[3].to(dev))))
    for a, b in zip(res[1], res[0]):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), atol=1e-4,
                                   rtol=1e-4)


def test_block_sparse_refuses_what_the_kernel_does_not_take(cuda):
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    lay = sa.DenseSparsityConfig(num_heads=2, block=48).make_layout(96)
    x = torch.zeros(1, 96, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="blocks"):
        sa.block_sparse_attention(x, x, x, lay, 48)
    lay = sa.DenseSparsityConfig(num_heads=2, block=16).make_layout(32)
    x = torch.zeros(1, 32, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        sa.block_sparse_attention(x, x, x, lay, 16)


def test_sparse_model_training_on_card_matches_cpu(cuda):
    """A block-sparse model's loss and gradients through K8 and the gather
    backward on the card against the same model on the CPU, fp32, remat
    on (each block's K8 runs twice: 2 launches per layer)."""
    from deepspeed_tpu_torch.models.transformer import (Transformer,
                                                        TransformerConfig)
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs

    def cfg():
        return TransformerConfig(
            vocab_size=97, hidden_size=256, num_layers=2, num_heads=4,
            max_seq_len=256, dtype="float32", tie_word_embeddings=True,
            remat=True, sparse_attention=sa.BigBirdSparsityConfig(
                num_heads=4, block=32, num_random_blocks=2))
    cpu = Transformer(cfg(), device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(0))
    gpu = Transformer(cfg(), device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.randint(0, 97, (2, 256), generator=torch.Generator()
                        .manual_seed(1))
    losses = []
    for m, dev in ((cpu, "cpu"), (gpu, cuda)):
        before = bs.block_sparse_attention_fwd.launches
        loss = m({"input_ids": ids.to(dev)})
        loss.backward()
        losses.append(loss.detach().cpu())
    assert bs.block_sparse_attention_fwd.launches - before == 4
    torch.testing.assert_close(losses[1], losses[0], atol=1e-5, rtol=1e-5)
    for (name, p), (_, g) in zip(cpu.named_parameters(),
                                 gpu.named_parameters()):
        if name.endswith("attn.k_proj.bias"):
            continue
        torch.testing.assert_close(g.grad.cpu(), p.grad, atol=1e-6,
                                   rtol=1e-4, msg=name)


# --------------------------------------------------------------------- #
# int8-KV modes of K2 / K3 / K6 / K7 and the int8 x int8 mode of K2 / K6
# --------------------------------------------------------------------- #
def _int8_cache(g, device, *lead, KVH, D):
    """int8 payloads [*lead, KVH*D] and positive fp32 scales [*lead, KVH]
    (dequantized values of a few units)."""
    pay = torch.randint(-127, 128, (*lead, KVH * D), generator=g,
                        device=device, dtype=torch.int8)
    scales = 0.001 + 0.02 * torch.rand(*lead, KVH, generator=g, device=device)
    return pay, scales


def _int8_pair(g, device, *lead, KVH, D):
    k, ks = _int8_cache(g, device, *lead, KVH=KVH, D=D)
    v, vs = _int8_cache(g, device, *lead, KVH=KVH, D=D)
    return k, v, ks, vs


def _clones(*ts):
    return [t.clone() for t in ts]


def _rel_close(got, want, rel):
    """max |got - want| <= rel * max |want|: the int8 x int8 bar (a flip
    of one rounding of P moves a row by about rmax * |v|)."""
    err = float((got.float() - want.float()).abs().max())
    assert bool(torch.isfinite(got).all())
    assert err <= rel * float(want.float().abs().max()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_int8_kernel_matches_plain(card, cuda, dtype, D, G, fused,
                                          case):
    """K2 on an int8-KV cache against its plain version at ragged lengths,
    at the tile and ring edges and on one long row at B = 1; the
    fused write quantizes the fresh row bitwise as the plain write does
    (an all-zero row stores payload 0 and scale 1.0); a second launch is
    bitwise the first."""
    g = torch.Generator(device=cuda).manual_seed(3 * D + G)
    B, S_max = DECODE_CASES[case]
    L, H, layer = 2, 8, 1
    KVH = H // G
    kc, vc, ks, vs = _int8_pair(g, cuda, L, B, S_max, KVH=KVH, D=D)
    q = _randn(g, B, H, D, dtype=dtype, device=cuda)
    nk = _randn(g, B, KVH, D, dtype=dtype, device=cuda)
    nv = _randn(g, B, KVH, D, dtype=dtype, device=cuda)
    zero = min(2, B - 1)                 # its fresh k row is all zero
    nk[zero] = 0
    lengths = torch.tensor(_decode_lengths(case, B, KVH, G, S_max, D, 1),
                           dtype=torch.int32, device=cuda)
    kw = dict(new_k=nk, new_v=nv) if fused else {}
    a = _clones(kc, vc, ks, vs)
    before = da.decode_attention.int8_launches
    got = da.decode_attention(q, a[0], a[1], lengths, layer=layer,
                              k_scale=a[2], v_scale=a[3], **kw)
    assert da.decode_attention.int8_launches == before + 1
    if fused:
        assert all(x is y for x, y in zip(got[1:], a))
        got = got[0]
    b = _clones(kc, vc, ks, vs)
    want = da.decode_attention_plain(q, b[0][layer], b[1][layer], lengths,
                                     k_scale=b[2][layer],
                                     v_scale=b[3][layer], **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    if fused:
        w = max(int(lengths[zero]) - 1, 0)
        assert float(a[2][layer, zero, w].min()) == 1.0
        assert not a[0][layer, zero, w].any()
    _close(got, want, dtype)
    assert not got[lengths == 0].any()
    c = _clones(kc, vc, ks, vs)
    again = da.decode_attention(q, c[0], c[1], lengths, layer=layer,
                                k_scale=c[2], v_scale=c[3], **kw)
    assert torch.equal(again[0] if fused else again, got)


def _i8mm_tile(B, KVH, D, G):
    """Positions of one decode_i8mm_kernel tile on this card (or the
    `card` fixture's): the K (or V) rows of its kv heads a block fill 8 KB."""
    return 8192 // (da.heads_per_block(B, KVH, G, da._sm_count(0)) * D)


# B, S_max, block_k of the int8 x int8 decode cases: "ragged" lengths at
# blocks of 32 / 136 / 512 over 136 positions, "edges" (0, 1 and one short
# of, on and one past a tile and a 512-position block), "block320" (one
# block of 320 over a 320-position cache, run (g-i8mm)'s), "long" (one row
# of 4096 positions at B = 1)
I8MM_CASES = {"ragged32": (5, 136, 32), "ragged136": (5, 136, 136),
              "ragged512": (5, 136, 512), "edges": (10, 600, 512),
              "block320": (7, 320, 320), "long": (1, 4096, 512)}


def _i8mm_lengths(case, B, KVH, D, G, S_max, block_k):
    if case.startswith("ragged"):
        return [0, 1, 33, 100, 136]
    if case == "long":
        return [S_max - 95]
    tp = _i8mm_tile(B, KVH, D, G)
    bk = min(block_k, S_max)
    ls = [0, 1, tp - 1, tp, tp + 1, bk - 1, bk, bk + 1, 2 * tp + 3, S_max]
    return [min(n, S_max) for n in ls][:B]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("case", list(I8MM_CASES))
def test_decode_i8mm_kernel_matches_plain(card, cuda, dtype, D, G, case):
    """K2's int8 x int8 mode against its plain version (the same blocks)
    at ragged lengths, at the tile and block edges (+-1), in one block of
    320 and on a 4096-position row, under the card's kv heads a block and
    a one-SM card's (2 at G = 1): integer products are exact on both
    sides, so only exp and the order of each block's probability sum
    differ.  G = 8 at D = 128 in blocks of 512 takes more than 48 KB of
    shared memory (the launch raises the kernel's limit).  Zero-length
    rows give 0; a second launch is bitwise the first."""
    B, S_max, block_k = I8MM_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(5 * D + G + S_max + block_k)
    L, H, layer = 2, 8, 0
    KVH = H // G
    kc, vc, ks, vs = _int8_pair(g, cuda, L, B, S_max, KVH=KVH, D=D)
    q = _randn(g, B, H, D, dtype=dtype, device=cuda)
    q[B // 2] = 0
    lengths = torch.tensor(_i8mm_lengths(case, B, KVH, D, G, S_max, block_k),
                           dtype=torch.int32, device=cuda)
    before = da.decode_attention.i8mm_launches
    got = da.decode_attention(q, kc, vc, lengths, layer=layer, k_scale=ks,
                              v_scale=vs, int8_matmuls=True, block_k=block_k)
    assert da.decode_attention.i8mm_launches == before + 1
    want = da.decode_attention_i8mm_plain(q, kc[layer], vc[layer], lengths,
                                          ks[layer], vs[layer],
                                          block_k=block_k)
    _rel_close(got, want, 1e-2)
    assert not got[lengths == 0].any()
    again = da.decode_attention(q, kc, vc, lengths, layer=layer, k_scale=ks,
                                v_scale=vs, int8_matmuls=True,
                                block_k=block_k)
    assert torch.equal(again, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4])
def test_chunk_int8_kernel_matches_plain(cuda, dtype, D, G):
    g = torch.Generator(device=cuda).manual_seed(7 * D + G)
    L, B, C, H, S_max, layer = 2, 3, 40, 8, 200, 1
    KVH = H // G
    kc, vc, ks, vs = _int8_pair(g, cuda, L, B, S_max, KVH=KVH, D=D)
    q = _randn(g, B, C, H, D, dtype=dtype, device=cuda)
    starts = torch.tensor([0, 57, 160], dtype=torch.int32, device=cuda)
    before = da.chunk_prefill_attention.int8_launches
    got = da.chunk_prefill_attention(q, kc, vc, starts, layer=layer,
                                     k_scale=ks, v_scale=vs)
    assert da.chunk_prefill_attention.int8_launches == before + 1
    want = da.chunk_prefill_attention_plain(q, kc[layer], vc[layer], starts,
                                            k_scale=ks[layer],
                                            v_scale=vs[layer])
    _close(got, want, dtype)


def _int8_pool(g, device, D, KVH, page, n_virt, B, L=2):
    """An int8 pool, its scales and a shuffled block table (row 0 a dead
    lane on the trash page, as in ``_paged_pool``)."""
    n_pages = 1 + (B - 1) * n_virt
    kp, vp, ks, vs = _int8_pair(g, device, L, n_pages, page, KVH=KVH, D=D)
    perm = 1 + torch.randperm(n_pages - 1, generator=torch.Generator()
                              .manual_seed(page + D))
    pages = torch.zeros(B, n_virt, dtype=torch.int32)
    pages[1:] = perm.view(B - 1, n_virt).to(torch.int32)
    return kp, vp, ks, vs, pages.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("page", [5, 16, 24, 64])
@pytest.mark.parametrize("fused", [True, False])
def test_paged_decode_int8_kernel_matches_plain_and_k2(card, cuda, dtype, D,
                                                       G, page, fused):
    """K6 on an int8 pool against its plain version, and bitwise against
    K2 on the gathered int8 view, at lengths on the tile and ring
    edges; the fused write puts payload and scale bitwise where the plain
    write does; a second launch is bitwise the first."""
    g = torch.Generator(device=cuda).manual_seed(11 * D + G + page)
    H, B, layer = 8, 8, 1
    n_virt = max(3, -(-256 // page))
    KVH = H // G
    kp, vp, ks, vs, pages = _int8_pool(g, cuda, D, KVH, page, n_virt, B)
    q = _randn(g, B, H, D, dtype=dtype, device=cuda)
    nk = _randn(g, B, KVH, D, dtype=dtype, device=cuda)
    nv = _randn(g, B, KVH, D, dtype=dtype, device=cuda)
    lengths = torch.tensor(_paged_lengths(B, KVH, G, page, n_virt, D, 1),
                           dtype=torch.int32, device=cuda)
    kw = dict(new_k=nk, new_v=nv) if fused else {}
    gathered = [pa.gather_pages(t[layer], pages) for t in (kp, vp, ks, vs)]
    a = _clones(kp, vp, ks, vs)
    before = pa.paged_decode_attention.int8_launches
    got = pa.paged_decode_attention(q, a[0], a[1], lengths, pages,
                                    layer=layer, k_scale=a[2], v_scale=a[3],
                                    **kw)
    assert pa.paged_decode_attention.int8_launches == before + 1
    if fused:
        got = got[0]
    c = _clones(kp, vp, ks, vs)
    again = pa.paged_decode_attention(q, c[0], c[1], lengths, pages,
                                      layer=layer, k_scale=c[2],
                                      v_scale=c[3], **kw)
    assert torch.equal(again[0] if fused else again, got)
    b = _clones(kp, vp, ks, vs)
    want = pa.paged_decode_attention_plain(q, b[0][layer], b[1][layer],
                                           lengths, pages, k_scale=b[2][layer],
                                           v_scale=b[3][layer], **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    _close(got, want, dtype)
    assert torch.equal(got[0], torch.zeros_like(got[0]))   # the dead lane
    mono = da.decode_attention(q, gathered[0], gathered[1], lengths,
                               k_scale=gathered[2], v_scale=gathered[3], **kw)
    if fused:
        mono = mono[0]
        for x, y in zip(a, gathered):
            assert torch.equal(pa.gather_pages(x[layer], pages)[1:], y[1:])
    assert torch.equal(got, mono)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("page", [5, 13, 16, 24, 64])
@pytest.mark.parametrize("window", [None, 40])
def test_paged_decode_i8mm_kernel_matches_plain_and_k2(card, cuda, dtype, D,
                                                       G, page, window):
    """K6's int8 x int8 mode against its plain version, and bitwise against
    K2's int8 x int8 mode on the gathered view with block_k = page (with a
    window: the view's blocks of min(512, virtual positions), GPT-Neo's
    route), at pages of 5 to 64 rows, lengths at the tile edges and a dead
    lane on the trash page, under the card's kv heads a block and a one-SM
    card's; a second launch is bitwise the first."""
    g = torch.Generator(device=cuda).manual_seed(13 * D + G + page)
    H, B, layer = 8, 8, 0
    KVH = H // G
    tp = _i8mm_tile(B, KVH, D, G)
    n_virt = max(3, -(-(tp + 2) // page))
    S = n_virt * page
    kp, vp, ks, vs, pages = _int8_pool(g, cuda, D, KVH, page, n_virt, B)
    q = _randn(g, B, H, D, dtype=dtype, device=cuda)
    lengths = torch.tensor([min(n, S) for n in (0, 1, 2 * page + 3, tp - 1,
                                                tp, tp + 1, 39, S)],
                           dtype=torch.int32, device=cuda)
    block_k = page if window is None else min(512, S)
    before = pa.paged_decode_attention.i8mm_launches + \
        pa.paged_decode_attention.window_i8mm_launches
    got = pa.paged_decode_attention(q, kp, vp, lengths, pages, layer=layer,
                                    k_scale=ks, v_scale=vs, int8_matmuls=True,
                                    block_k=block_k, window=window)
    assert pa.paged_decode_attention.i8mm_launches + \
        pa.paged_decode_attention.window_i8mm_launches == before + 1
    want = pa.paged_decode_attention_i8mm_plain(q, kp[layer], vp[layer],
                                                lengths, pages, ks[layer],
                                                vs[layer], block_k=block_k,
                                                window=window)
    _rel_close(got, want, 1e-2)
    assert torch.equal(got[0], torch.zeros_like(got[0]))   # the dead lane
    again = pa.paged_decode_attention(q, kp, vp, lengths, pages, layer=layer,
                                      k_scale=ks, v_scale=vs,
                                      int8_matmuls=True, block_k=block_k,
                                      window=window)
    assert torch.equal(again, got)
    gathered = [pa.gather_pages(t[layer], pages) for t in (kp, vp, ks, vs)]
    mono = da.decode_attention(q, gathered[0], gathered[1], lengths,
                               k_scale=gathered[2], v_scale=gathered[3],
                               int8_matmuls=True, block_k=block_k,
                               window=window)
    assert torch.equal(got, mono)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("page", [8, 16, 24, 64])
def test_paged_chunk_int8_kernel_matches_plain_and_k3(cuda, dtype, D, G,
                                                      page):
    g = torch.Generator(device=cuda).manual_seed(17 * D + G + page)
    H, B, C, layer = 8, 3, 40, 0
    KVH = H // G
    n_virt = -(-(2 * page + 3 + C) // page)
    kp, vp, ks, vs, pages = _int8_pool(g, cuda, D, KVH, page, n_virt, B + 1)
    pages = pages[1:].contiguous()
    q = _randn(g, B, C, H, D, dtype=dtype, device=cuda)
    starts = torch.tensor([0, page - 3, 2 * page + 3], dtype=torch.int32,
                          device=cuda)
    before = pa.paged_chunk_prefill_attention.int8_launches
    got = pa.paged_chunk_prefill_attention(q, kp, vp, starts, pages,
                                           layer=layer, k_scale=ks,
                                           v_scale=vs)
    assert pa.paged_chunk_prefill_attention.int8_launches == before + 1
    want = pa.paged_chunk_prefill_attention_plain(
        q, kp[layer], vp[layer], starts, pages, k_scale=ks[layer],
        v_scale=vs[layer])
    _close(got, want, dtype)
    gathered = [pa.gather_pages(t[layer], pages) for t in (kp, vp, ks, vs)]
    mono = da.chunk_prefill_attention(q, gathered[0], gathered[1], starts,
                                      k_scale=gathered[2],
                                      v_scale=gathered[3])
    assert torch.equal(got, mono)


def test_int8_kernels_refuse_bad_inputs(cuda):
    """Scales of the wrong dtype or shape, and float caches with scales,
    raise before any launch."""
    g = torch.Generator(device=cuda).manual_seed(1)
    kc, vc, ks, vs = _int8_pair(g, cuda, 2, 3, 32, KVH=2, D=64)
    q = _randn(g, 3, 4, 64, dtype=torch.float32, device=cuda)
    lengths = torch.tensor([1, 5, 20], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="scales"):
        da.decode_attention(q, kc, vc, lengths, layer=0, k_scale=ks.half(),
                            v_scale=vs)
    with pytest.raises(ValueError, match="scales"):
        da.decode_attention(q, kc, vc, lengths, layer=0, k_scale=ks[..., :1],
                            v_scale=vs, int8_matmuls=True)
    with pytest.raises(ValueError, match="payloads"):
        da.decode_attention(q, kc.float(), vc.float(), lengths, layer=0,
                            k_scale=ks, v_scale=vs)


def test_int8_serving_on_card_paged_equals_monolithic(cuda):
    """int8 serving on the card (per-channel int8 weights, int8-KV, fp32):
    10 mixed requests on 3 slots through K7-int8 / K6-int8 over a paged
    pool give every request the tokens of the monolithic lanes (K3-int8 /
    K2-int8), with one launch per layer and decode step or prefill chunk
    and no float-cache launch."""
    import numpy as np
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.transformer import (Transformer,
                                                        TransformerConfig)
    cfg = TransformerConfig(vocab_size=97, hidden_size=256, num_layers=2,
                            num_heads=4, max_seq_len=128, dtype="float32",
                            tie_word_embeddings=True)
    eng = init_inference(Transformer(cfg), dtype="float32", device=cuda,
                         prefill_chunk_size=16,
                         quant={"enabled": True, "bits": 8,
                                "per_channel": True, "kv_cache": True})
    eng.init_params(seed=0)
    assert eng.module.config.kv_cache_quant
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, 97, int(p)).astype(np.int32), int(n))
            for p, n in zip(rng.integers(5, 60, 10), rng.integers(2, 30, 10))]
    kw = dict(num_slots=3, max_cache_len=96, prefill_chunk=16,
              prefill_token_budget=32, decode_block=3, page_size=16)
    fns = (pa.paged_decode_attention, pa.paged_chunk_prefill_attention,
           da.decode_attention, da.chunk_prefill_attention)
    outs = {}
    for paged in (True, False):
        before = [(f.launches, f.int8_launches) for f in fns]
        srv = eng.serve(paged=paged, **kw)
        rids = [srv.submit(p, max_new_tokens=n) for p, n in reqs]
        res = srv.drain()
        outs[paged] = [res[r] for r in rids]
        got = [(f.launches - a, f.int8_launches - b)
               for f, (a, b) in zip(fns, before)]
        L, st = cfg.num_layers, srv.stats
        decode = L * srv.block * st["decode_calls"]
        chunks = L * st["prefill_tokens"] // srv.chunk
        want = [(0, decode), (0, chunks), (0, 0), (0, 0)] if paged else \
            [(0, 0), (0, 0), (0, decode), (0, chunks)]
        assert got == want
        assert st["completed"] == len(reqs)
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_weight_quantization_on_card_matches_cpu(cuda, dtype):
    """An int8 engine's quantization (IEEE division, round half to even)
    and its per-channel dequantization (one mixed int8 x dtype multiply)
    on the card are bitwise the CPU's."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.transformer import (Transformer,
                                                        TransformerConfig)
    from deepspeed_tpu_torch.runtime.weight_quantizer import QuantizedLinear
    cfg = TransformerConfig(vocab_size=97, hidden_size=256, num_layers=2,
                            num_heads=4, max_seq_len=64, dtype=dtype,
                            tie_word_embeddings=True)
    ref = Transformer(cfg, device="cpu")
    ref.init_weights(torch.Generator().manual_seed(0))
    sd = ref.state_dict()
    mods = []
    for dev in ("cpu", cuda):
        eng = init_inference(Transformer(cfg), dtype=dtype, device=dev,
                             quant={"enabled": True, "per_channel": True})
        eng.set_params(sd)
        mods.append(dict(eng.module.named_modules()))
    n = 0
    for name, mod in mods[0].items():
        if not isinstance(mod, QuantizedLinear):
            continue
        n += 1
        card = mods[1][name]
        for a, b in ((mod.weight, card.weight), (mod.bias, card.bias),
                     (mod.weight_q, card.weight_q),
                     (mod.weight_scale, card.weight_scale)):
            assert torch.equal(a, b.cpu()), name
    assert n == cfg.num_layers * 6


# --------------------------------------------------------------------- #
# The sliding-window mode of K2 / K6 (GPT-Neo's local layers)
# --------------------------------------------------------------------- #
WINDOW_MODES = ["float", "float_fused", "int8", "int8_fused", "i8mm"]


def _window_counter(mode):
    return {"float": "window_launches", "int8": "window_int8_launches",
            "i8mm": "window_i8mm_launches"}[mode.split("_")[0]]


def _window_lengths(window, S_max, tp):
    """Lengths below, at and past a window, with ``length - window`` one
    short of, on and one past a tile of ``tp`` positions, a zero-length
    row and a full row."""
    ls = [0, 1, window - 1, window, window + 1, window + tp - 1,
          window + tp, window + tp + 1, 97, S_max]
    return [min(n, S_max) for n in ls]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("mode", WINDOW_MODES)
@pytest.mark.parametrize("window", [8, 40, 100])
def test_decode_window_kernel_matches_plain(card, cuda, dtype, D, G, mode,
                                            window):
    """K2-window against its plain version in every mode, with lengths
    below, at and past the window, the window's start on a tile edge, a
    zero-length row and (window 100) a window of several tiles; a
    fused write lands bitwise where the plain write puts it; only the
    window counter of the mode moves; a second launch is bitwise the
    first."""
    g = torch.Generator(device=cuda).manual_seed(17 * D + G + window)
    L, B, H, S_max, layer = 2, 10, 8, 136, 1
    KVH = H // G
    int8 = mode != "float" and mode != "float_fused"
    if int8:
        bufs = list(_int8_pair(g, cuda, L, B, S_max, KVH=KVH, D=D))
        scales = dict(k_scale=bufs[2], v_scale=bufs[3])
    else:
        bufs = [_randn(g, L, B, S_max, KVH * D, dtype=dtype, device=cuda)
                for _ in range(2)]
        scales = {}
    q = _randn(g, B, H, D, dtype=dtype, device=cuda)
    nk = _randn(g, B, KVH, D, dtype=dtype, device=cuda)
    nv = _randn(g, B, KVH, D, dtype=dtype, device=cuda)
    es = 1 if int8 else torch.tensor([], dtype=dtype).element_size()
    tp = _tile(B, KVH, D, es, G)
    lengths = torch.tensor(_window_lengths(window, S_max, tp),
                           dtype=torch.int32, device=cuda)
    kw = dict(new_k=nk, new_v=nv) if mode.endswith("fused") else {}
    if mode == "i8mm":
        kw = dict(int8_matmuls=True, block_k=32)
    counter = _window_counter(mode)
    before = {n: getattr(da.decode_attention, n) for n in
                     ("launches", "int8_launches", "i8mm_launches",
                      "window_launches", "window_int8_launches",
                      "window_i8mm_launches")}
    a = _clones(*bufs)
    sa = dict(k_scale=a[2], v_scale=a[3]) if int8 else {}
    got = da.decode_attention(q, a[0], a[1], lengths, layer=layer,
                              window=window, **sa, **kw)
    read = {n: getattr(da.decode_attention, n) - v for n, v in before.items()}
    assert read == {n: int(n == counter) for n in read}
    if "new_k" in kw:
        got = got[0]
    b = _clones(*bufs)
    sb = dict(k_scale=b[2][layer], v_scale=b[3][layer]) if int8 else {}
    if mode == "i8mm":
        want = da.decode_attention_i8mm_plain(
            q, b[0][layer], b[1][layer], lengths, sb["k_scale"],
            sb["v_scale"], block_k=32, window=window)
        _rel_close(got, want, 1e-2)
    else:
        want = da.decode_attention_plain(q, b[0][layer], b[1][layer],
                                         lengths, window=window, **sb, **kw)
        _close(got, want, dtype)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    c = _clones(*bufs)
    sc = dict(k_scale=c[2], v_scale=c[3]) if int8 else {}
    again = da.decode_attention(q, c[0], c[1], lengths, layer=layer,
                                window=window, **sc, **kw)
    assert torch.equal(again[0] if "new_k" in kw else again, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("page", [13, 16, 64])
@pytest.mark.parametrize("mode", WINDOW_MODES)
def test_paged_decode_window_kernel_is_k2_over_gathered_view(card, cuda,
                                                             dtype, D, G,
                                                             page, mode):
    """K6-window (and K6-i8mm-window, in the gathered view's KV blocks of
    min(512, virtual positions)) against its plain version, and bitwise
    against K2-window over the gathered view, at lengths below and at the
    window and with ``length - window`` on a page edge (pages of 13 rows
    too); a dead lane on the trash page gives 0."""
    g = torch.Generator(device=cuda).manual_seed(19 * D + G + page)
    H, B, layer, window = 8, 8, 1, 40
    n_virt = max(4, -(-(window + 2 * page) // page))
    KVH = H // G
    int8 = mode != "float" and mode != "float_fused"
    if int8:
        kp, vp, ks, vs, pages = _int8_pool(g, cuda, D, KVH, page, n_virt, B)
        bufs = [kp, vp, ks, vs]
    else:
        kp, vp, pages = _paged_pool(g, dtype, cuda, D, KVH, page, n_virt, B)
        bufs = [kp, vp]
    q = _randn(g, B, H, D, dtype=dtype, device=cuda)
    nk = _randn(g, B, KVH, D, dtype=dtype, device=cuda)
    nv = _randn(g, B, KVH, D, dtype=dtype, device=cuda)
    lengths = torch.tensor([0, 1, window - 1, window, window + page,
                            window + page + 1, 2 * page + 3, n_virt * page],
                           dtype=torch.int32, device=cuda)
    kw = dict(new_k=nk, new_v=nv) if mode.endswith("fused") else {}
    if mode == "i8mm":
        kw = dict(int8_matmuls=True, block_k=min(512, n_virt * page))
    gathered = [pa.gather_pages(t[layer], pages) for t in bufs]
    counter = _window_counter(mode)
    before = getattr(pa.paged_decode_attention, counter)
    a = _clones(*bufs)
    sa = dict(k_scale=a[2], v_scale=a[3]) if int8 else {}
    got = pa.paged_decode_attention(q, a[0], a[1], lengths, pages,
                                    layer=layer, window=window, **sa, **kw)
    assert getattr(pa.paged_decode_attention, counter) == before + 1
    b = _clones(*bufs)
    sb = dict(k_scale=b[2][layer], v_scale=b[3][layer]) if int8 else {}
    if mode == "i8mm":
        want = pa.paged_decode_attention_i8mm_plain(
            q, b[0][layer], b[1][layer], lengths, pages, sb["k_scale"],
            sb["v_scale"], block_k=kw["block_k"], window=window)
        _rel_close(got, want, 1e-2)
    else:
        if kw:
            got = got[0]
        want = pa.paged_decode_attention_plain(
            q, b[0][layer], b[1][layer], lengths, pages, window=window,
            **sb, **kw)
        _close(got, want, dtype)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(got[0], torch.zeros_like(got[0]))   # the dead lane
    sg = dict(k_scale=gathered[2], v_scale=gathered[3]) if int8 else {}
    mono = da.decode_attention(q, gathered[0], gathered[1], lengths,
                               window=window, **sg, **kw)
    if "new_k" in kw:
        mono = mono[0]
        for x, y in zip(a, gathered):
            assert torch.equal(pa.gather_pages(x[layer], pages)[1:], y[1:])
    assert torch.equal(got, mono)


def _gpt_neo_tiny(**over):
    from deepspeed_tpu_torch.models.transformer import (Transformer,
                                                        TransformerConfig)
    cfg = TransformerConfig(vocab_size=97, hidden_size=256, num_layers=2,
                            num_heads=2, max_seq_len=128, dtype="float32",
                            tie_word_embeddings=True, activation="gelu",
                            attention_bias=False, attention_out_bias=True,
                            attention_softmax_scale=1.0,
                            attention_layers=("global", "local"),
                            window_size=8, scan_layers=False, **over)
    return Transformer(cfg)


@pytest.mark.parametrize("chunk", [None, 16])
def test_gpt_neo_on_card_matches_cpu(cuda, chunk):
    """A tiny GPT-Neo (head dim 128, window 8, fp32, matrices std 0.2):
    a 32-token prefill (one pass: K1 and the dense band; or 16-token
    chunks: K3 and the dense band) and 12 decode steps (K2 and K2-window)
    on the card give the CPU's logits at 1e-3 (cuBLAS sums the fp32
    projections in another order, see test_model_on_card_matches_cpu)."""
    cpu = _gpt_neo_tiny().to_empty(device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if "norm" in name:
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen))
            else:
                p.copy_(0.2 * torch.randn(p.shape, generator=gen))
    gpu = _gpt_neo_tiny().to_empty(device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.randint(0, 97, (2, 44), generator=torch.Generator()
                        .manual_seed(1))
    caches = [m.init_cache(2, 48, dtype=torch.float32) for m in (cpu, gpu)]
    with torch.no_grad():
        for m, cache, dev in ((cpu, caches[0], "cpu"),
                              (gpu, caches[1], cuda)):
            x = ids.to(dev)
            if chunk is None:
                out, _ = m.decode(x[:, :32], cache, 0, prefill=True)
            else:
                out = torch.cat([m.decode(x[:, c:c + chunk], cache, c)[0]
                                 for c in range(0, 32, chunk)], 1)
            before = (da.decode_attention.launches,
                      da.decode_attention.window_launches)
            steps = [m.decode(x[:, t:t + 1], cache, t)[0]
                     for t in range(32, 44)]
            after = (da.decode_attention.launches,
                     da.decode_attention.window_launches)
            if dev != "cpu":
                assert [a - b for a, b in zip(after, before)] == [12, 12]
                got = torch.cat([out] + steps, 1).cpu()
            else:
                want = torch.cat([out] + steps, 1)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("kv", ["int8", "i8mm"])
def test_gpt_neo_int8_generate_launches_on_card(cuda, kv):
    """GPT-Neo generation on the card with an int8 KV cache: K2-int8 on
    the global layer and K2-int8-window (or, with decode_int8_matmuls,
    K2-i8mm and K2-i8mm-window) on the local one, once per decode step;
    tokens in the vocabulary."""
    from deepspeed_tpu_torch import init_inference
    over = dict(kv_cache_quant=True, decode_int8_matmuls=kv == "i8mm")
    eng = init_inference(_gpt_neo_tiny(**over), dtype="float32", device=cuda)
    eng.init_params(seed=0)
    ids = torch.randint(0, 97, (3, 40), device=cuda)
    mode = "int8_" if kv == "int8" else "i8mm_"
    names = (mode + "launches", "window_" + mode + "launches")
    before = [getattr(da.decode_attention, n) for n in names]
    out = eng.generate(ids, max_new_tokens=12)
    assert [getattr(da.decode_attention, n) - b
            for n, b in zip(names, before)] == [11, 11]
    assert out.shape == (3, 52) and int(out.min()) >= 0 \
        and int(out.max()) < 97


def test_gpt_neo_serving_on_card_paged_equals_monolithic(cuda):
    """GPT-Neo serving on the card, fp32: 10 mixed requests on 3 slots give
    every request the same tokens on a page pool (K7 and K6 on the global
    layer, the gather route and K6-window on the local one) and on
    monolithic lanes (K3 and K2; K2-window), with exact launch counts."""
    import numpy as np
    from deepspeed_tpu_torch import init_inference
    eng = init_inference(_gpt_neo_tiny(), dtype="float32", device=cuda,
                         prefill_chunk_size=16)
    eng.init_params(seed=0)
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, 97, int(p)).astype(np.int32), int(n))
            for p, n in zip(rng.integers(5, 60, 10), rng.integers(2, 30, 10))]
    kw = dict(num_slots=3, max_cache_len=96, prefill_chunk=16,
              prefill_token_budget=32, decode_block=3, page_size=16)
    names = [(pa.paged_decode_attention, "launches"),
             (pa.paged_decode_attention, "window_launches"),
             (pa.paged_chunk_prefill_attention, "launches"),
             (da.decode_attention, "launches"),
             (da.decode_attention, "window_launches"),
             (da.chunk_prefill_attention, "launches")]
    outs = {}
    for paged in (True, False):
        before = [getattr(f, n) for f, n in names]
        srv = eng.serve(paged=paged, **kw)
        rids = [srv.submit(p, max_new_tokens=n) for p, n in reqs]
        res = srv.drain()
        outs[paged] = [res[r] for r in rids]
        got = [getattr(f, n) - b for (f, n), b in zip(names, before)]
        st = srv.stats
        decode = srv.block * st["decode_calls"]      # one layer of each kind
        chunks = st["prefill_tokens"] // srv.chunk
        want = [decode, decode, chunks, 0, 0, 0] if paged else \
            [0, 0, 0, decode, decode, chunks]
        assert got == want
        assert st["completed"] == len(reqs)
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_array_equal(a, b)
