"""K8's 16-bit template (``ops/csrc/block_sparse_attention.cu``
``wgmma_sparse_fwd_kernel``) on the CPU: its tile walk, a torch model of
its arithmetic against the plain version and the JAX package's Pallas B8
(interpret mode on the CPU), the plain version's LSE, and the host side of
its launches.

The walk (``block_sparse.tile_tables``): for each 64-row q tile, every
64-key tile one of its layout rows reaches, with a 16-bit mask of the
16 x 16 cells that hold a live pair.  The model runs those tiles in that
order as the kernel does: S = q.k^T in fp32, the key bias added, dead
cells, keys past the query (causal) and cells past S set to -1e30, an
online softmax in the exp2 domain (the scale times log2 e on each score,
the running max in log2 units), P into the running sum unrounded and into
P.V split as the kernel splits it (P_hi = P rounded to the input type,
P_lo = (P - P_hi) rounded again; both exact for fp32).  Tolerances: fp32
rtol 2e-4 / atol 2e-5 (``test_torch_sparse_attention.FWD_TOL``); bf16
inputs 2e-2 (the card's bf16 bar, ``chip_smoke.TOL``).  The CUDA kernel
itself runs only on a card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from deepspeed_tpu.ops.sparse_attention import block_sparse as jbs
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops import sparse_attention as psa
from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as pbs

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG = -1e30
# a padded slot the kernel would fault on: key tile 32767, every cell live
POISON = (0x7FFF << 16) | 0xFFFF

# every sparsity config class of the port, at any block
CONFIGS = {
    "dense": lambda b: psa.DenseSparsityConfig(num_heads=2, block=b),
    "fixed": lambda b: psa.FixedSparsityConfig(num_heads=2, block=b,
                                               num_local_blocks=4),
    "fixed_per_head": lambda b: psa.FixedSparsityConfig(
        num_heads=2, block=b, num_local_blocks=2,
        different_layout_per_head=True, num_different_global_patterns=2),
    "variable": lambda b: psa.VariableSparsityConfig(
        num_heads=2, block=b, num_random_blocks=1,
        local_window_blocks=[1, 2], global_block_indices=[0],
        different_layout_per_head=True, seed=3),
    "bigbird": lambda b: psa.BigBirdSparsityConfig(
        num_heads=2, block=b, num_random_blocks=1,
        num_sliding_window_blocks=3, seed=1),
    "longformer": lambda b: psa.BSLongformerSparsityConfig(
        num_heads=2, block=b, global_block_indices=[0, 2],
        global_block_end_indices=[1, 3]),
    "sliding": lambda b: psa.LocalSlidingWindowSparsityConfig(
        num_heads=2, block=b, num_sliding_window_blocks=3,
        attention="bidirectional"),
}


def _tables(layout, block, causal):
    lay = np.tril(layout) if causal else np.asarray(layout)
    idx, counts = pbs.layout_tables(lay)
    return lay, idx, counts, *pbs.tile_tables(idx, counts, block, causal)


def _walk_pairs(tiles, tile_counts, S, causal):
    """The (query, key) pairs the walk visits, as a [H, S, S] bool."""
    H, nt, _ = tiles.shape
    live = np.zeros((H, nt * 64, nt * 64), bool)
    for h in range(H):
        for qt in range(nt):
            for e in tiles[h, qt, :tile_counts[h, qt]]:
                kt, cells = int(e) >> 16, int(e) & 0xFFFF
                for bit in range(16):
                    if cells >> bit & 1:
                        r = 64 * qt + 16 * (bit // 4)
                        c = 64 * kt + 16 * (bit % 4)
                        live[h, r:r + 16, c:c + 16] = True
    if causal:
        live &= np.tril(np.ones((nt * 64, nt * 64), bool))
    return live[:, :S, :S]


# ------------------------------- the walk ------------------------------- #
WALK_CASES = [(name, block, causal) for name in sorted(CONFIGS)
              for block in (16, 32, 64, 128) for causal in (False, True)]


@pytest.mark.parametrize("case", WALK_CASES,
                         ids=[f"{n}-{b}-{'causal' if c else 'full'}"
                              for n, b, c in WALK_CASES])
def test_tile_walk_covers_exactly_the_live_pairs(case):
    """As a set of pairs on a small S (ragged against 64-row tiles where
    the block allows it), and as a count against ``chip_smoke.live_pairs``
    at S 512 and 1024 (1040 at block 16); no tile past a q tile's causal
    limit, every listed cell live, the padding 0."""
    name, block, causal = case
    small = 4 * block + (16 if block == 16 else 0)
    for S in (small, 512, 1040 if block == 16 else 1024):
        lay, idx, counts, tiles, tile_counts = _tables(
            CONFIGS[name](block).make_layout(S), block, causal)
        nt = -(-S // 64)
        assert tiles.dtype == tile_counts.dtype == np.int32
        assert tiles.shape[:2] == tile_counts.shape == (2, nt)
        assert tiles.shape[2] == max(1, tile_counts.max())
        kt = tiles >> 16
        qt_of = np.broadcast_to(np.arange(nt)[None, :, None], tiles.shape)
        listed = np.arange(tiles.shape[2]) < tile_counts[..., None]
        assert (tiles[~listed] == 0).all()
        assert ((tiles & 0xFFFF)[listed] != 0).all()
        if causal:                   # no key tile past the q tile's rows
            assert (kt[listed] <= qt_of[listed]).all()
        for h in range(2):                   # ascending, no repeat
            for qt in range(nt):
                row = kt[h, qt, :tile_counts[h, qt]]
                assert (np.diff(row) > 0).all()
        if S == small:
            want = np.kron(lay, np.ones((block, block), bool)) > 0
            if causal:
                want &= np.tril(np.ones((S, S), bool))
            np.testing.assert_array_equal(
                _walk_pairs(tiles, tile_counts, S, causal), want)
        # count: each listed cell holds 256 pairs, 136 on the causal
        # diagonal (16 * 17 / 2)
        n_pairs = 0
        for e, qt in zip(tiles[listed], qt_of[listed]):
            for bit in range(16):
                if int(e) >> bit & 1:
                    R, C = 4 * qt + bit // 4, 4 * (int(e) >> 16) + bit % 4
                    n_pairs += 136 if causal and R == C else 256
        assert n_pairs == chip_smoke.live_pairs(lay, block, causal)


def test_tile_tables_at_run_f_shape_list_the_layout_rows():
    """At block 64 the walk is the layout row itself: run (f)'s causal
    BigBird layout (32 heads, seq 8192) gives 4.375 tiles a row, 6 at
    most, every tile off the diagonal wholly live."""
    cfg = psa.BigBirdSparsityConfig(num_heads=32, block=64,
                                    num_random_blocks=3,
                                    num_sliding_window_blocks=3,
                                    num_global_blocks=1)
    lay, idx, counts, tiles, tile_counts = _tables(
        pbs.cached_layout(cfg, 8192, causal=True), 64, True)
    np.testing.assert_array_equal(tile_counts, counts)
    listed = np.arange(tiles.shape[2]) < tile_counts[..., None]
    np.testing.assert_array_equal((tiles >> 16)[listed], idx[listed])
    diag = (tiles >> 16) == np.arange(128)[None, :, None]
    cells = tiles & 0xFFFF
    assert (cells[listed & ~diag] == 0xFFFF).all()
    assert (cells[listed & diag] == 0xF731).all()   # cc <= rc
    assert tiles.shape[2] == 6 and tile_counts.mean() == 4.375


def test_tile_tables_refuse_a_sequence_past_the_table():
    idx = np.zeros((1, 1 << 16, 1), np.int32)
    counts = np.ones((1, 1 << 16), np.int32)
    with pytest.raises(ValueError, match="tile table"):
        pbs.tile_tables(idx, counts, 64, False)


# ---------------------- the kernel's arithmetic ------------------------- #
def schedule_model(q, k, v, tiles, tile_counts, scale, causal, bias=None):
    """The 16-bit kernel's walk and arithmetic: q, k, v [B, S, H, D] (P
    split in q's dtype), the tile tables, an fp32 ``bias`` [B, S].
    Returns (O [B, S, H, D] fp32, lse [B, H, S]); rows past S are the
    TMA's zero fill, never written."""
    B, S, H, D = q.shape
    nt = tile_counts.shape[1]
    Sp = 64 * nt
    qf, kf, vf = (torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, Sp - S))
                  for x in (q, k, v))
    bf = torch.zeros(B, Sp)
    if bias is not None:
        bf[:, :S] = bias
    sc2 = scale * LOG2E
    rows, cols = torch.arange(64)[:, None], torch.arange(64)[None, :]
    cell = (rows // 16) * 4 + cols // 16                 # [64, 64] bit
    out = torch.zeros(B, S, H, D)
    lse = torch.full((B, H, S), NEG)
    for h in range(H):
        for qt in range(nt):
            q0 = 64 * qt
            m = torch.full((B, 64), NEG)
            l = torch.zeros(B, 64)
            acc = torch.zeros(B, 64, D)
            qh = qf[:, q0:q0 + 64, h]
            for j in range(int(tile_counts[h, qt])):
                e = int(tiles[h, qt, j])
                k0, cells = 64 * (e >> 16), e & 0xFFFF
                s = qh @ kf[:, k0:k0 + 64, h].transpose(1, 2)
                s = s + bf[:, None, k0:k0 + 64]
                live = (cells >> cell) & 1 == 1
                if causal:
                    live &= k0 + cols <= q0 + rows
                s = torch.where(live, s, NEG)
                m_new = torch.maximum(m, s.amax(-1) * sc2)
                corr = torch.exp2(m - m_new)
                p = torch.where(live, torch.exp2(s * sc2 - m_new[..., None]),
                                0.0)
                l = l * corr + p.sum(-1)
                hi = p.to(q.dtype).float()
                lo = (p - hi).to(q.dtype).float()
                vt = vf[:, k0:k0 + 64, h]
                acc = acc * corr[..., None] + hi @ vt + lo @ vt
                m = m_new
            n = min(64, S - q0)
            inv = torch.where(l > 0, 1.0 / l, 0.0)
            out[:, q0:q0 + n, h] = (acc * inv[..., None])[:, :n]
            lse[:, h, q0:q0 + n] = torch.where(
                l > 0, m * LN2 + torch.log(l), NEG)[:, :n]
    return out, lse


def _inputs(B, S, H, D, seed, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, S, H, D))
                             .astype(np.float32)).to(dtype)
            for _ in range(3)]


def _layout(kind, S, block, H):
    if kind == "empty_row":                  # block-row 2 attends nothing
        lay = np.ones((H, S // block, S // block), np.int64)
        lay[:, 2] = 0
        lay[1, 1] = 0
        return lay
    if kind == "per_head":
        return CONFIGS["fixed_per_head"](block).make_layout(S)
    return psa.BigBirdSparsityConfig(num_heads=H, block=block,
                                     num_random_blocks=2, seed=block
                                     ).make_layout(S)


# (layout, S, block, D, causal, key padding)
MODEL_CASES = [
    ("bigbird", 256, 64, 64, True, False),
    ("bigbird", 1040, 16, 64, True, False),       # ragged S at block 16
    ("per_head", 256, 32, 64, False, False),
    ("bigbird", 256, 16, 64, False, True),        # a fully padded block
    ("empty_row", 256, 64, 64, False, False),
    ("bigbird", 512, 128, 128, True, False),      # D 128
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", MODEL_CASES,
                         ids=[f"{k}-S{s}-b{b}-D{d}-{'causal' if c else 'full'}"
                              f"{'-padded' if p else ''}"
                              for k, s, b, d, c, p in MODEL_CASES])
def test_schedule_model_matches_plain_and_jax_b8(case, dtype):
    kind, S, block, D, causal, padded = case
    B, H = 2, 2
    q, k, v = _inputs(B, S, H, D, seed=S + block + D, dtype=dtype)
    lay = _layout(kind, S, block, H)
    tables = pbs.device_tables(lay, H, causal, "cpu", block)
    keep = None
    if padded:
        keep = np.ones((B, S), np.int32)
        keep[0, S - 37:] = 0
        keep[1, S - block:] = 0                  # its tail block: all padded
    bias = None if keep is None else pbs.padding_bias(
        torch.from_numpy(keep), dtype, "cpu")
    tiles = tables.tiles.clone()                 # padded slots: poison
    listed = torch.arange(tiles.shape[2]) < tables.tile_counts[..., None]
    tiles[~listed] = POISON
    got, got_lse = schedule_model(q, k, v, tiles, tables.tile_counts,
                                  D ** -0.5, causal, bias)
    want, want_lse = pbs.block_sparse_attention_plain(
        q.float(), k.float(), v.float(), tables.idx, tables.counts,
        D ** -0.5, causal, block, bias, return_lse=True)
    tol = FWD_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), **FWD_TOL)
    if dtype == torch.bfloat16:
        # P split keeps about 16 bits: far closer to the fp32 P than the
        # bf16 output's own rounding (2^-9 relative)
        assert float((got - want).abs().max()) < 2 ** -12
    if kind == "empty_row":
        assert (got[:, 2 * block:3 * block] == 0).all()
        assert (got[:, block:2 * block, 1] == 0).all()
        assert (got_lse[:, :, 2 * block:3 * block] == NEG).all()
    j = jbs.block_sparse_attention(
        *(jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
          for x in (q, k, v)), lay, block, causal=causal,
        key_padding_mask=None if keep is None else jnp.asarray(keep))
    np.testing.assert_allclose(got.numpy(), np.asarray(j, np.float32), **tol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("padded", [False, True])
def test_plain_lse_matches_float64_logsumexp(causal, padded):
    """``return_lse``: the logsumexp of each row's masked scores against a
    float64 numpy one over the dense layout-masked scores; -1e30 for an
    empty row."""
    B, S, H, D, block = 2, 128, 2, 16, 16
    q, k, v = _inputs(B, S, H, D, seed=3 + causal + 2 * padded,
                      dtype=torch.float32)
    lay = _layout("empty_row", S, block, H)
    lay[0, 5, 7] = 0
    keep = np.ones((B, S), np.int32)
    if padded:
        keep[1, 40:64] = 0
    bias = pbs.padding_bias(torch.from_numpy(keep), torch.float32, "cpu") \
        if padded else None
    tables = pbs.device_tables(lay, H, causal, "cpu", block)
    _, lse = pbs.block_sparse_attention_plain(
        q, k, v, tables.idx, tables.counts, D ** -0.5, causal, block, bias,
        return_lse=True)
    s = np.einsum("bihd,bjhd->bhij", q.double().numpy(), k.double().numpy())
    if padded:
        s = s + np.where(keep > 0, 0.0, -1e4)[:, None, None, :]
    s = s * D ** -0.5
    mask = np.kron(lay, np.ones((block, block))) > 0
    if causal:
        mask &= np.tril(np.ones((S, S), bool))
    s = np.where(mask[None], s, -np.inf)
    mx = s.max(-1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):   # empty rows
        want = (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]
    want = np.where(mask.any(-1)[None], want, NEG)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=2e-5)
    assert (lse[:, :, 2 * block:3 * block] == NEG).all()


# ------------------------- the launch path ----------------------------- #
class _FakeLib:
    """Records the arguments of the C entry point instead of launching."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def record(*args):
            self.calls.append((name, args))
            return 0
        return record


@pytest.fixture
def host_launch(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(op_builder.SPARSE, "load", lambda: lib)

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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("with_lse", [False, True])
def test_launch_reads_nothing_back(host_launch, monkeypatch, dtype,
                                   with_lse):
    """One launch on CPU tensors: no tensor read on the host, the tables'
    and outputs' addresses, the dtype, the tables' widths and the
    strides as the entry point takes them; the count goes up by one."""
    B, S, H, D, block = 2, 1040, 2, 64, 16
    qkv = torch.zeros(B, S, 3, H, D, dtype=dtype)
    q, k, v = qkv.unbind(2)
    lay = _layout("bigbird", S, block, H)
    tables = pbs.device_tables(lay, H, True, "cpu", block)
    bias = pbs.padding_bias(torch.ones(B, S), dtype, "cpu")
    before = pbs.block_sparse_attention_fwd.launches
    _refuse_host_reads(monkeypatch)
    res = pbs.block_sparse_attention_fwd(q, k, v, tables, 0.125, True,
                                         block, bias, with_lse=with_lse)
    monkeypatch.undo()
    assert pbs.block_sparse_attention_fwd.launches == before + 1
    out, lse = res if with_lse else (res, None)
    assert out.shape == q.shape and out.dtype == dtype
    assert lse is None or (lse.shape == (B, H, S)
                           and lse.dtype == torch.float32)
    (name, args), = host_launch.calls
    assert name == "dstt_block_sparse_attention_fwd"
    assert args[:10] == (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), tables.idx.data_ptr(),
        tables.counts.data_ptr(), tables.tiles.data_ptr(),
        tables.tile_counts.data_ptr(), bias.data_ptr())
    assert args[10:18] == (op_builder.dtype_code(dtype), B, S, H, D,
                           tables.idx.shape[-1], tables.tiles.shape[-1],
                           block)
    assert args[18:30] == (*q.stride()[:3], *k.stride()[:3],
                           *v.stride()[:3], *out.stride()[:3])
    assert args[30:32] == (1, 0.125)


def test_tables_are_built_once_per_device(monkeypatch):
    """``cached_tables`` builds a config's four tables once per (seq,
    causal, heads, device) and never again; the tiles are the host's
    ``tile_tables`` of its ``layout_tables``."""
    cfg = CONFIGS["bigbird"](32)
    built = []
    make = pbs.tile_tables

    def counting(*args):
        built.append(args[2:])
        return make(*args)

    monkeypatch.setattr(pbs, "tile_tables", counting)
    a = pbs.cached_tables(cfg, 256, 2, torch.device("cpu"), causal=True)
    _refuse_host_reads(monkeypatch)
    b = pbs.cached_tables(cfg, 256, 2, torch.device("cpu"), causal=True)
    monkeypatch.undo()
    assert built == [(32, True)]
    assert isinstance(a, pbs.SparseTables)
    assert all(x is y for x, y in zip(a, b))
    idx, counts = pbs.layout_tables(np.tril(pbs.cached_layout(cfg, 256,
                                                              True)))
    tiles, tile_counts = pbs.tile_tables(idx, counts, 32, True)
    for got, want in zip(a, (idx, counts, tiles, tile_counts)):
        assert got.dtype == torch.int32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_16bit_launch_refuses_what_tma_cannot_load(host_launch, dtype):
    """The 16-bit kernel loads q, k, v and the bias by TMA: a (b, s, h)
    stride that is not a whole 16-byte unit raises ValueError, nothing
    launched; fp32 (the FMA kernel) takes the same strides."""
    B, S, H, D, block = 1, 64, 2, 64, 64
    x = torch.zeros(B, S, H, D + 4, dtype=dtype)[..., 2:D + 2]
    lay = np.ones((H, 1, 1), np.int64)
    tables = pbs.device_tables(lay, H, False, "cpu", block)
    with pytest.raises(ValueError, match="TMA"):
        pbs.block_sparse_attention_fwd(x, x, x, tables, 0.125, False, block)
    assert not host_launch.calls
    x32 = torch.zeros(B, S, H, D + 4)[..., 2:D + 2]
    pbs.block_sparse_attention_fwd(x32, x32, x32, tables, 0.125, False,
                                   block)
    assert len(host_launch.calls) == 1
