"""Block-sparse attention — kernel K8 and its plain version.

Port of ``deepspeed_tpu/ops/sparse_attention/block_sparse.py``.  A
layout from ``sparsity_config.py`` (``[heads, nb, nb]`` 0/1, numpy)
becomes per-row index tables (:func:`layout_tables`): ``idx [H, nb, A]``,
the active kv blocks of each query block-row padded with 0, and
``counts [H, nb]``.

* **K8** (``ops/csrc/block_sparse_attention.cu``) replaces the Pallas
  ``_sparse_fwd_pallas`` / ``_sparse_fwd_kernel``: one thread block per
  (q tile, head, batch row) walks only the kv tiles its rows attend to,
  reads q/k/v in the model's ``[B, S, H, D]`` layout through strides, runs
  the online softmax in fp32 (causal mask inside diagonal blocks,
  ``-1e30`` for masked scores) and writes O in the input dtype, 0 for a
  row with no active block, and optionally the fp32 LSE ``[B, H, S]``.
  bf16 / fp16 run both products on the tensor cores over 64-row tiles
  walked through :func:`tile_tables` (P·V on P split in two 16-bit parts,
  so P keeps about 16 bits, as B8 keeps P in fp32); fp32 runs FMAs on the
  CUDA cores over the layout rows (``idx`` / ``counts``).
  :func:`block_sparse_attention_fwd` is its wrapper; it launches the
  kernel for CUDA tensors and raises for a block size, head dim or tensor
  the kernel does not take.
* **The plain version**, :func:`block_sparse_attention_plain`, is the
  JAX gather formulation ``_sparse_attn_gather``: each query block-row's
  active k/v blocks are gathered into a packed ``[bq, A*bk]`` slab and
  attended in fp32.  It is the CPU forward and the tests' oracle.
* **The backward** (:class:`_BlockSparseAttention`, the JAX
  ``custom_vjp``) recomputes the gather formulation under autograd and
  returns its gradient, on every device, exactly as the JAX ``_core_bwd``
  runs ``jax.vjp`` of ``_sparse_attn_gather``.  The JAX package has no
  backward Pallas kernel for B8: its backward is plain jnp that XLA
  compiles, so here it is plain tensor ops (gathers and batched
  ``torch.matmul``), not the plain version of K8 standing in for a kernel.

One deliberate difference: a query row with no active block gives 0 in
the Pallas kernel, but the JAX gather formulation gives it the mean of
the padding slots' values (every score is ``-1e30``, so the softmax is
uniform).  The plain version zeroes such rows, so the CPU forward equals
the kernel's and the backward is the gradient of the forward (0 for such
rows, where JAX's ``jax.vjp`` of the gather sends their gradient into the
values of block 0).  No sparsity config makes such a row: every layout
keeps the diagonal block.

The key-padding mask is folded as in JAX, where a constant-1 feature is
appended to q and a ``0 / -1e4`` feature in k's dtype to k: the kernel
and the plain version add that bias, rounded to k's dtype (``-9984`` in
bf16), to each score before the scale, so a query row whose active keys
are all padded attends to them (finite scores), as in JAX.

Layout tables (:class:`SparseTables`: the layout rows' ``idx`` /
``counts`` and the 64-row tiles' ``tiles`` / ``tile_counts``) go to the
device once per (config, sequence length, causal, heads, device):
:func:`cached_tables` keeps them beside the config's layout cache
(:func:`cached_layout`), so no forward or backward copies a table from
the host, and no launch reads one back.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.op_builder import check_tma

NEG_INF = -1e30
# the key-padding bias (the value JAX appends to k as an extra feature)
PAD_BIAS = -1e4
# what K8 is instantiated for
KERNEL_BLOCKS = (16, 32, 64, 128)
KERNEL_HEAD_DIMS = (64, 128)
# the 16-bit kernel's q and key tiles, and the cells of their live-pair
# masks (bit 4 * row cell + column cell of a tile table entry)
TILE = 64
CELL = 16


# --------------------------------------------------------------------- #
# Layouts and their index tables (host)
# --------------------------------------------------------------------- #
def layout_tables(layout):
    """Compress a [H, nb, nb] 0/1 layout into per-row index tables.

    Returns (idx, counts): idx [H, nb, A] int32 — the active kv-block
    indices per query block-row, ascending, padded with 0; counts [H, nb]
    int32.  A = max active blocks over all rows/heads (at least 1).
    """
    layout = np.asarray(layout)
    H, nb, _ = layout.shape
    counts = layout.sum(-1).astype(np.int32)            # [H, nb]
    A = max(1, int(counts.max()))
    idx = np.zeros((H, nb, A), np.int32)
    for h in range(H):
        for r in range(nb):
            cols = np.nonzero(layout[h, r])[0]
            idx[h, r, :len(cols)] = cols
    return idx, counts


def _expand_heads(layout, num_heads):
    layout = np.asarray(layout)
    if layout.shape[0] == 1 and num_heads > 1:
        layout = np.broadcast_to(layout, (num_heads,) + layout.shape[1:])
    if layout.shape[0] != num_heads:
        raise ValueError(f"layout heads {layout.shape[0]} != attention heads "
                         f"{num_heads}")
    return layout


def cached_layout(sparsity_config, seq_len, causal=False):
    """Per-config-instance layout cache, keyed by ``(seq_len, causal)``.
    Caching is essential for configs that draw random blocks (Variable,
    BigBird): each ``make_layout`` draws anew, so a recompute (remat) must
    find the layout its forward used.  When ``causal``, strictly-upper
    blocks are dropped up front so they never count into A."""
    cache = getattr(sparsity_config, "_layout_cache", None)
    if cache is None:
        cache = {}
        sparsity_config._layout_cache = cache
    key = (seq_len, causal)
    if key not in cache:
        lay = np.asarray(sparsity_config.make_layout(seq_len))
        if causal:
            lay = np.tril(lay)
        cache[key] = lay
    return cache[key]


def tile_tables(idx, counts, block, causal):
    """The 16-bit kernel's walk, from the layout rows' tables (idx [H, nb,
    A], counts [H, nb]) at ``block``: for each 64-row q tile, every 64-key
    tile that one of its layout rows reaches, ascending, as ``key tile <<
    16 | cells``, where bit ``4 * rc + cc`` of ``cells`` marks the 16 x 16
    cell (q rows ``16 rc ..``, keys ``16 cc ..`` of the tiles) that holds a
    live (query, key) pair.  With ``causal``, cells wholly above the
    diagonal are dropped, so no tile past a q tile's last row is listed.

    Returns (tiles [H, nt, T] int32 padded with 0, tile_counts [H, nt]
    int32), nt = ceil(S / 64), T the most tiles of a q tile (at least 1).
    Only the first ``tile_counts`` entries of a row are ever read."""
    idx, counts = np.asarray(idx), np.asarray(counts)
    H, nb, A = idx.shape
    nt = -(-nb * block // TILE)
    if nt > 1 << 15:
        raise ValueError(f"sequence {nb * block} has {nt} key tiles; the "
                         f"tile table holds at most {1 << 15}")
    h, r, a = np.nonzero(np.arange(A) < counts[..., None])
    kb = idx[h, r, a].astype(np.int64)
    c = block // CELL                      # cells along a block's side
    off = np.arange(c)
    R = (r[:, None, None] * c + off[None, :, None]).repeat(c, 2).ravel()
    C = (kb[:, None, None] * c + off[None, None, :]).repeat(c, 1).ravel()
    hh = h.repeat(c * c)
    if causal:                             # the cells with a pair k <= q
        keep = C <= R
        R, C, hh = R[keep], C[keep], hh[keep]
    per = TILE // CELL
    key = (hh * nt + R // per) * nt + C // per
    bit = (R % per) * per + C % per
    order = np.argsort(key, kind="stable")
    key, bit = key[order], bit[order]
    uniq, first = np.unique(key, return_index=True)
    cells = np.bitwise_or.reduceat(1 << bit, first) if len(key) else \
        np.zeros(0, np.int64)
    row, kt = uniq // nt, uniq % nt        # row = h * nt + q tile
    tile_counts = np.bincount(row, minlength=H * nt).astype(np.int32)
    slot = np.arange(len(uniq)) - np.searchsorted(row, row)
    tiles = np.zeros((H * nt, max(1, int(tile_counts.max(initial=0)))),
                     np.int32)
    tiles[row, slot] = (kt << 16) | cells
    return tiles.reshape(H, nt, -1), tile_counts.reshape(H, nt)


class SparseTables(NamedTuple):
    """One layout's tables on one device (int32, contiguous): the layout
    rows' ``idx`` [H, nb, A] / ``counts`` [H, nb] (the plain version, the
    backward, the fp32 kernel) and the 64-row tiles' ``tiles`` [H, nt, T]
    / ``tile_counts`` [H, nt] (the 16-bit kernel; :func:`tile_tables`)."""
    idx: torch.Tensor
    counts: torch.Tensor
    tiles: torch.Tensor
    tile_counts: torch.Tensor


def device_tables(layout, num_heads, causal, device, block):
    """``layout`` [heads, nb, nb] (1 head broadcasts) at ``block`` → the
    kernel's :class:`SparseTables` on ``device``; upper blocks are dropped
    when ``causal``."""
    layout = _expand_heads(layout, num_heads)
    if causal:
        layout = np.tril(layout)   # upper blocks are fully masked anyway
    idx, counts = layout_tables(layout)
    tiles, tile_counts = tile_tables(idx, counts, block, causal)
    return SparseTables(*(torch.from_numpy(t).to(device)
                          for t in (idx, counts, tiles, tile_counts)))


def cached_tables(sparsity_config, seq_len, num_heads, device, causal=False,
                  layout_causal=None):
    """The kernel's :class:`SparseTables` for ``sparsity_config`` at
    ``seq_len``, on ``device``, made once and kept beside the config's
    layout cache.
    ``layout_causal`` picks the :func:`cached_layout` entry (default:
    ``causal``); ``causal`` drops the upper blocks of the tables."""
    layout_causal = causal if layout_causal is None else layout_causal
    cache = getattr(sparsity_config, "_table_cache", None)
    if cache is None:
        cache = {}
        sparsity_config._table_cache = cache
    key = (seq_len, layout_causal, causal, num_heads, str(device))
    if key not in cache:
        layout = cached_layout(sparsity_config, seq_len, layout_causal)
        cache[key] = device_tables(layout, num_heads, causal, device,
                                   sparsity_config.block)
    return cache[key]


def padding_bias(key_padding_mask, dtype, device):
    """[B, S] key-padding mask (1 = attend) → the fp32 bias K8 adds to
    each score before the scale: 0, or ``-1e4`` rounded to ``dtype`` (the
    JAX wrapper appends it to k as a feature in k's dtype)."""
    keep = torch.as_tensor(key_padding_mask, device=device).to(torch.bool)
    return torch.where(keep, 0.0, PAD_BIAS).to(dtype).float().contiguous()


# --------------------------------------------------------------------- #
# The plain version: the gather formulation
# --------------------------------------------------------------------- #
def block_sparse_attention_plain(q, k, v, idx, counts, scale, causal, block,
                                 bias=None, return_lse=False):
    """The JAX ``_sparse_attn_gather`` on [B, S, H, D] tensors: q, k, v;
    idx [H, nb, A], counts [H, nb]; ``bias`` an optional fp32 [B, S] added
    to every score of that key before the scale.  fp32 scores times
    ``scale``, ``-1e30`` for inactive slots and (``causal``) keys past the
    query inside diagonal blocks, softmax over the packed ``[bq, A*bk]``
    row; rows with no active block give 0.  Returns [B, S, H, D] in q's
    dtype, and with ``return_lse`` also the fp32 logsumexp of each row's
    masked scores [B, H, S] (``-1e30`` for a row with no active block).
    Differentiable (the backward of :class:`_BlockSparseAttention` is
    autograd through this function)."""
    B, S, H, D = q.shape
    Dv = v.shape[-1]
    nb = S // block
    A = idx.shape[-1]
    dev = q.device
    idx = idx.to(dev).long()
    counts = counts.to(dev)
    heads = torch.arange(H, device=dev)[:, None, None]

    def blocks(x):                                   # [B, H, nb, block, d]
        return x.transpose(1, 2).reshape(B, H, nb, block, x.shape[-1])

    qb = blocks(q)
    k_sel = blocks(k)[:, heads, idx]                 # [B, H, nq, A, bk, D]
    v_sel = blocks(v)[:, heads, idx]
    scores = torch.einsum("bhqid,bhqajd->bhqiaj", qb.float(), k_sel.float())
    if bias is not None:                             # [B, H, nq, 1, A, bk]
        scores = scores + bias.view(B, nb, block)[:, idx][:, :, :, None]
    scores = scores * scale
    active = torch.arange(A, device=dev) < counts[..., None]    # [H, nq, A]
    mask = active[None, :, :, None, :, None]
    if causal:
        pos = torch.arange(block, device=dev)
        qpos = torch.arange(nb, device=dev)[:, None] * block + pos  # [nq, bq]
        kvpos = idx[..., None] * block + pos                 # [H, nq, A, bk]
        cmask = kvpos[:, :, None] <= qpos[None, :, :, None, None]
        mask = mask & cmask[None]
    scores = scores.masked_fill(~mask, NEG_INF)
    flat = scores.reshape(B, H, nb, block, A * block)
    m = flat.amax(-1, keepdim=True).detach()   # shift only: no gradient
    e = torch.exp(flat - m)
    denom = e.sum(-1, keepdim=True)
    probs = e / denom.clamp_min(1e-30)
    probs = probs.reshape(B, H, nb, block, A, block)
    out = torch.einsum("bhqiaj,bhqajd->bhqid", probs, v_sel.float())
    live = (counts > 0)[None, :, :, None]            # [1, H, nq, 1]
    out = out * live[..., None]
    out = out.reshape(B, H, S, Dv).transpose(1, 2).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(live, (m + denom.log())[..., 0], NEG_INF)
    return out, lse.reshape(B, H, S)


# --------------------------------------------------------------------- #
# K8
# --------------------------------------------------------------------- #
def _check_args(q, k, v, tables, block, bias):
    B, S, H, D = q.shape
    if block not in KERNEL_BLOCKS:
        raise ValueError(f"the block-sparse kernel takes blocks "
                         f"{KERNEL_BLOCKS}, got {block}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the block-sparse kernel takes head_dim "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    if tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"q, k and v must share [B, S, H, D] (expand GQA "
                         f"heads first): {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if S % block:
        raise ValueError(f"seq {S} not divisible by block {block}")
    nb, nt = S // block, -(-S // TILE)
    for t in (q, k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("q, k and v must share device and dtype")
        if t.stride(-1) != 1:
            raise ValueError("the last dim of q, k and v must be contiguous")
    if not isinstance(tables, SparseTables):
        raise ValueError("tables must be SparseTables (device_tables / "
                         "cached_tables)")
    idx, counts, tiles, tile_counts = tables
    if tuple(idx.shape[:2]) != (H, nb) or tuple(counts.shape) != (H, nb) \
            or tuple(tiles.shape[:2]) != (H, nt) \
            or tuple(tile_counts.shape) != (H, nt):
        raise ValueError(f"tables idx {tuple(idx.shape)} / counts "
                         f"{tuple(counts.shape)} / tiles "
                         f"{tuple(tiles.shape)} / tile_counts "
                         f"{tuple(tile_counts.shape)} do not fit H {H}, "
                         f"nb {nb}, nt {nt}")
    for t in tables:
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError("the tables must be contiguous int32 on q's "
                             "device")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (B, S)
                             or not bias.is_contiguous()
                             or bias.device != q.device):
        raise ValueError("bias must be a contiguous fp32 [B, S] on q's "
                         "device")
    if q.dtype != torch.float32:    # the 16-bit kernel loads by TMA
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_tma("block-sparse attention", name, t)
        if bias is not None and bias.data_ptr() % 16:
            raise ValueError(f"block-sparse attention: bias (address "
                             f"{bias.data_ptr():#x}) breaks TMA's 16-byte "
                             f"alignment")


def block_sparse_attention_fwd(q, k, v, tables, scale, causal, block,
                               bias=None, with_lse=False):
    """K8 on CUDA tensors: q, k, v [B, S, H, D] (any strides with a unit
    stride on D; 16-bit: 16-byte aligned for TMA), the layout's
    :class:`SparseTables` on the card, optional fp32 ``bias`` [B, S].
    Returns O [B, S, H, D] in q's dtype, or (O, lse) with ``with_lse``:
    the fp32 logsumexp [B, H, S] of each row's scaled scores, ``-1e30``
    for a row with no live key."""
    _check_args(q, k, v, tables, block, bias)
    B, S, H, D = q.shape
    out = torch.empty(B, S, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device) \
        if with_lse else None
    idx, counts, tiles, tile_counts = tables
    err = op_builder.SPARSE.load().dstt_block_sparse_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        idx.data_ptr(), counts.data_ptr(), tiles.data_ptr(),
        tile_counts.data_ptr(), None if bias is None else bias.data_ptr(),
        op_builder.dtype_code(q.dtype), B, S, H, D, idx.shape[-1],
        tiles.shape[-1], block,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(bool(causal)), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check(err, "block-sparse attention kernel")
    block_sparse_attention_fwd.launches += 1
    return (out, lse) if with_lse else out


op_builder.launch_counters(block_sparse_attention_fwd, "launches")


def _forward(q, k, v, tables, bias, scale, causal, block):
    """One K8 launch for CUDA tensors (counted), the plain version for
    CPU tensors."""
    if not q.is_cuda:
        return block_sparse_attention_plain(q, k, v, tables.idx,
                                            tables.counts, scale, causal,
                                            block, bias)
    return block_sparse_attention_fwd(q, k, v, tables, scale, causal,
                                      block, bias)


class _BlockSparseAttention(torch.autograd.Function):
    """The JAX ``_sparse_attention_core`` custom_vjp: the forward runs K8
    (the plain version on the CPU) and saves q, k, v; the backward
    recomputes the gather formulation and returns its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, tables, bias, scale, causal, block):
        ctx.save_for_backward(q, k, v, tables.idx, tables.counts, bias)
        ctx.scale, ctx.causal, ctx.block = scale, causal, block
        return _forward(q, k, v, tables, bias, scale, causal, block)

    @staticmethod
    def backward(ctx, g):
        q, k, v, idx, counts, bias = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = block_sparse_attention_plain(*leaves, idx, counts,
                                               ctx.scale, ctx.causal,
                                               ctx.block, bias)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None, None, None, None, None


def block_sparse_attention_tables(q, k, v, tables, block, scale=None,
                                  causal=False, key_padding_mask=None):
    """Block-sparse attention over prepared :class:`SparseTables`
    (:func:`cached_tables` or :func:`device_tables`): q, k, v [B, S, H, D];
    ``key_padding_mask`` optional [B, S] (1 = attend).  Returns [B, S, H,
    D].  Differentiable when grad mode is on and an input requires a
    gradient."""
    B, S, H, D = q.shape
    if S % block:
        raise ValueError(f"seq {S} not divisible by block {block}")
    if tables.idx.shape[1] != S // block:
        raise ValueError(f"layout built for {tables.idx.shape[1]} blocks, "
                         f"seq has {S // block}")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    bias = None if key_padding_mask is None else \
        padding_bias(key_padding_mask, k.dtype, q.device)
    args = (tables, bias, float(scale), bool(causal), int(block))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _BlockSparseAttention.apply(q, k, v, *args)
    return _forward(q, k, v, *args)


def block_sparse_attention(q, k, v, layout, block, scale=None, causal=False,
                           key_padding_mask=None):
    """Block-sparse attention over a static layout (the JAX entry point).

    Args:
      q, k, v: [B, S, H, D] (model-native layout, matching flash_attention).
      layout: [num_layout_heads, nb, nb] 0/1 array (numpy; static).
      block: block size in tokens; S must be divisible.
      causal: additionally mask within diagonal blocks.
      key_padding_mask: optional [B, S] (1 = attend, 0 = pad), folded in
        as a ``-1e4`` bias on padded keys' scores.
    Returns [B, S, H, D].  The tables go to the device on every call;
    callers with a config use :func:`cached_tables`."""
    tables = device_tables(layout, q.shape[2], causal, q.device, block)
    return block_sparse_attention_tables(q, k, v, tables, block, scale,
                                         causal, key_padding_mask)


def sparse_attention_reference(q, k, v, layout, block, scale=None,
                               causal=False):
    """Dense O(S²) reference with the layout as an explicit mask — for
    tests (the JAX ``sparse_attention_reference``)."""
    B, S, H, D = q.shape
    layout = _expand_heads(layout, H)
    if scale is None:
        scale = 1.0 / float(np.sqrt(D))
    mask = np.kron(layout, np.ones((block, block)))      # [H, S, S]
    if causal:
        mask = np.tril(np.ones((S, S)))[None] * mask
    mask = torch.from_numpy(mask > 0).to(q.device)
    s = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * scale
    s = s.masked_fill(~mask[None], NEG_INF)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhij,bjhd->bihd", e / denom, v.float())
    return out.to(q.dtype)
