"""Paged-pool attention — kernels K6 (decode with fused write) and K7
(chunked prefill), each with its plain version.

Port of ``deepspeed_tpu/ops/transformer/paged_attention.py`` for bf16 /
fp16 / fp32 pools and int8-KV pools, with the int8×int8 decode mode and
K2's sliding window.
The KV cache is one page pool per K and V, layer-stacked ``[L,
num_pages, page_size, KVH*D]`` (``Transformer.init_paged_cache``) — int8
with fp32 scales ``[L, num_pages, page_size, KVH]`` in the int8-KV mode,
in the same page layout — and
each batch row owns a block table ``pages[b, virtual_page] ->
physical_page``; virtual position ``pos`` of row ``b`` lives at pool page
``pages[b, pos // page_size]``, in-page row ``pos % page_size``.  Dead or
unmapped table entries point at the reserved trash page 0.

* K6 (``ops/csrc/decode_attention.cu``, entry
  ``dstt_paged_decode_attention``) replaces ``paged_decode_attention``:
  K2's body with the block table as its row map (its tiles and lane
  schedule depend only on virtual positions, so it is bitwise K2 over
  the gathered view).  With ``new_k`` /
  ``new_v`` it first writes this step's row IN PLACE through the table at
  virtual position ``max(lengths[b]-1, 0)``, quantized on an int8 pool.
  Its int8×int8 mode (entry ``dstt_paged_decode_attention_i8mm``, unfused)
  quantizes P per page, the JAX kernel's block, or per ``block_k``
  virtual positions when asked.  ``window`` comes through K2's template:
  the JAX paged kernel has no window (``window=None`` there), and a
  windowed layer's decode on a pool takes JAX's gather route — write,
  gather the virtual view, run B4 with the window over it — which K6
  reproduces bitwise without the gather (``registry``).
* K7 (``ops/csrc/flash_attention.cu``, entry
  ``dstt_paged_chunk_prefill``) replaces ``paged_chunk_prefill_attention``:
  K3's body with the block table as its key-row map.  On a 16-bit float
  pool each 64-row key tile arrives as ``64 / r`` TMA boxes of ``r =``
  :func:`paged_box_rows` rows, read through the table from the pool
  layer viewed as :func:`pool_tma_view`.

The plain versions gather each row's virtual view ``pool[layer][pages[b]]``
(and its scales) and run the monolithic plain functions on it, so they are
bitwise equal to ``decode_attention_plain`` / ``chunk_prefill_attention_
plain`` over the gathered view; the kernels keep K2's / K3's schedules and
are bitwise equal to K2 / K3 over that view on the card (the int8×int8
mode at ``block_k`` = page).

Each wrapper launches its kernel for CUDA tensors and runs the plain
version only for CPU tensors; it never falls back.  Launches are counted
per mode, as in ``decode_attention``.
"""

import math

import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.op_builder import check_tma
from deepspeed_tpu_torch.ops.transformer.decode_attention import (
    _ptr, check_int8_cache, check_kernel_shapes, check_modes, check_window,
    chunk_prefill_attention_plain, count_launch, decode_attention_i8mm_plain,
    decode_attention_plain, launch_heads_per_block, quantize_rows)
from deepspeed_tpu_torch.ops.transformer.flash_attention import _check_cuda

# the key tile of K7's tensor-core kernel, in positions
KEY_TILE = 64


def pool_layer(pool, layer):
    """One layer ``[num_pages, page, KVH*D]`` of a layer-stacked pool."""
    if pool.dim() != 4:
        raise ValueError(f"paged attention expects a layer-stacked pool "
                         f"[L, num_pages, page_size, KVH*D]; got shape "
                         f"{tuple(pool.shape)}")
    if layer is None:
        raise ValueError("layer-stacked pools require layer=")
    return pool[int(layer)]


def gather_pages(pool, pages):
    """The virtual view of one pool layer ``[num_pages, page, F]`` through
    ``pages [B, n_virt]``: ``[B, n_virt * page, F]`` (a copy)."""
    B, n = pages.shape
    g = pool[pages.to(pool.device).long()]             # [B, n, page, F]
    return g.reshape(B, n * pool.shape[1], pool.shape[2])


def write_pages(pool, pages, positions, rows):
    """Write ``rows [B, S, F]`` at virtual ``positions [B, S]`` of one pool
    layer through ``pages`` (in place).  Positions past a row's table are
    an error of the caller."""
    page = pool.shape[1]
    positions = positions.to(pool.device).long()
    phys = torch.gather(pages.to(pool.device).long(), 1, positions // page)
    pool[phys, positions % page] = rows.to(pool.dtype)


def _gathered(pool, scales, pages):
    """The virtual views of a pool layer and of its scales (None for a
    float pool)."""
    return (gather_pages(pool, pages),
            None if scales is None else gather_pages(scales, pages))


def paged_decode_attention_plain(q, k_pool, v_pool, lengths, pages,
                                 scale=None, new_k=None, new_v=None,
                                 k_scale=None, v_scale=None, window=None):
    """Write-then-attend over one pool layer in plain PyTorch.  q
    [B, H, D]; pools ``[num_pages, page, KVH*D]`` (written in place through
    ``pages`` when ``new_k`` / ``new_v`` are given, quantized on an int8
    pool with ``k_scale`` / ``v_scale`` ``[num_pages, page, KVH]``);
    lengths [B]; pages [B, n_virt]; ``window`` as for
    ``decode_attention``.  Returns [B, H, D]."""
    B, H, D = q.shape
    n_virt, page = pages.shape[1], k_pool.shape[1]
    if new_k is not None:
        w = (lengths.to(q.device).long() - 1).clamp(0, n_virt * page - 1)
        KVHD = k_pool.shape[-1]
        for pool, scales, new in ((k_pool, k_scale, new_k),
                                  (v_pool, v_scale, new_v)):
            rows = new.reshape(B, 1, KVHD)
            if scales is not None:
                rows, safe = quantize_rows(rows, KVHD // D)
                write_pages(scales, pages, w[:, None], safe)
            write_pages(pool, pages, w[:, None], rows)
    gk, gks = _gathered(k_pool, k_scale, pages)
    gv, gvs = _gathered(v_pool, v_scale, pages)
    return decode_attention_plain(q, gk, gv, lengths, scale, k_scale=gks,
                                  v_scale=gvs, window=window)


def paged_decode_attention_i8mm_plain(q, k_pool, v_pool, lengths, pages,
                                      k_scale, v_scale, scale=None,
                                      block_k=None, window=None):
    """The int8×int8 decode over one int8 pool layer in plain PyTorch: the
    monolithic plain version over the gathered views with KV blocks of
    ``block_k`` virtual positions (one page when None)."""
    gk, gks = _gathered(k_pool, k_scale, pages)
    gv, gvs = _gathered(v_pool, v_scale, pages)
    return decode_attention_i8mm_plain(q, gk, gv, lengths, gks, gvs, scale,
                                       block_k=block_k or k_pool.shape[1],
                                       window=window)


def paged_decode_attention(q, k_pool, v_pool, lengths, pages, scale=None,
                           layer=None, k_scale=None, v_scale=None,
                           int8_matmuls=False, new_k=None, new_v=None,
                           window=None, block_k=None):
    """Single-token decode attention over a paged pool.  q: [B, H, D];
    pools ``[L, num_pages, page_size, KVH*D]`` with ``layer``, int8 with
    ``k_scale`` / ``v_scale`` ``[L, num_pages, page_size, KVH]``; lengths
    [B] int32, counting this step's token; pages [B, n_virt] int32.
    ``int8_matmuls`` (int8 pools, unfused) runs both products int8×int8
    with P quantized per ``block_k`` virtual positions (one page when
    None).  ``window``: sliding-window decode, as in ``decode_attention``.
    With ``new_k`` / ``new_v`` ([B, KVH, D]) the row is written in place
    through the table first and ``(out, k_pool, v_pool[, k_scale,
    v_scale])`` is returned; otherwise ``out``.  Launches count per mode,
    as in ``decode_attention``."""
    check_modes(k_scale, v_scale, int8_matmuls, new_k, new_v)
    window = check_window(window)
    kp, vp = pool_layer(k_pool, layer), pool_layer(v_pool, layer)
    ks = None if k_scale is None else pool_layer(k_scale, layer)
    vs = None if v_scale is None else pool_layer(v_scale, layer)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if int8_matmuls:
        block_k = block_k or kp.shape[1]
        if q.is_cuda:
            out = _launch_paged_decode(q, kp, vp, ks, vs, lengths, pages,
                                       scale, None, None, window,
                                       i8mm_block=block_k)
            count_launch(paged_decode_attention, "i8mm", window)
        else:
            out = paged_decode_attention_i8mm_plain(q, kp, vp, lengths, pages,
                                                    ks, vs, scale, block_k,
                                                    window=window)
        return out
    if q.is_cuda:
        out = _launch_paged_decode(q, kp, vp, ks, vs, lengths, pages, scale,
                                   new_k, new_v, window)
        count_launch(paged_decode_attention, "" if ks is None else "int8",
                     window)
    else:
        out = paged_decode_attention_plain(q, kp, vp, lengths, pages, scale,
                                           new_k, new_v, k_scale=ks,
                                           v_scale=vs, window=window)
    if new_k is None:
        return out
    if k_scale is None:
        return out, k_pool, v_pool
    return out, k_pool, v_pool, k_scale, v_scale


paged_decode_attention.launches = 0
paged_decode_attention.int8_launches = 0
paged_decode_attention.i8mm_launches = 0
paged_decode_attention.window_launches = 0
paged_decode_attention.window_int8_launches = 0
paged_decode_attention.window_i8mm_launches = 0


def _table(pages, B, device):
    if pages.dim() != 2 or pages.shape[0] != B:
        raise ValueError(f"block table must be [{B}, n_virt], got "
                         f"{tuple(pages.shape)}")
    if pages.device != device:
        raise ValueError(f"block table on {pages.device}, the pool on "
                         f"{device}")
    return pages.to(torch.int32).contiguous()


def _check_pool(q, kp, vp, ks, vs, what):
    """KVH of a pool layer for a kernel launch; float pools in q's dtype,
    int8 pools with their scales (``check_int8_cache``)."""
    D = q.shape[-1]
    KVHD = kp.shape[-1]
    KVH = KVHD // D
    if KVH * D != KVHD or q.shape[-2] % KVH:
        raise ValueError(f"pool width {KVHD} does not fit {q.shape[-2]} "
                         f"heads of {D}")
    if D not in (64, 128):
        raise ValueError(f"CUDA attention kernels take head_dim 64 or 128, "
                         f"got {D}")
    if ks is not None:
        check_int8_cache(q, kp, vp, ks, vs, KVH, what)
    else:
        _check_cuda(what, q, kp, vp)
        if not (kp.is_contiguous() and vp.is_contiguous()):
            raise ValueError(f"{what} needs contiguous [num_pages, page, "
                             f"KVH*D] pool layers")
    return KVH


def _launch_paged_decode(q, kp, vp, ks, vs, lengths, pages, scale, new_k,
                         new_v, window=None, i8mm_block=None):
    B, H, D = q.shape
    KVH = check_kernel_shapes(q, kp.shape[-1], "paged decode kernel")
    q = q.contiguous()
    _check_pool(q, kp, vp, ks, vs, "paged decode kernel")
    fresh = []
    if new_k is not None:
        # the fresh rows stay in q's dtype: the kernel quantizes them on an
        # int8 pool
        new_k = new_k.to(q.dtype).contiguous()
        new_v = new_v.to(q.dtype).contiguous()
        fresh = [new_k, new_v]
    _check_cuda("paged decode attention", q, *fresh)
    if any(t.data_ptr() % 16 for t in [q, kp, vp, *fresh]):
        raise ValueError("paged decode kernel needs 16-byte aligned tensors")
    table = _table(pages, B, q.device)
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = op_builder.DECODE.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    hpb = launch_heads_per_block(q, KVH, () if ks is None else (ks, vs))
    if i8mm_block is not None:
        if not 0 < i8mm_block <= 512:
            raise ValueError(f"int8_matmuls takes KV blocks of 1 to 512 "
                             f"positions, got {i8mm_block}")
        err = lib.dstt_paged_decode_attention_i8mm(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(),
            vs.data_ptr(), lengths.data_ptr(), table.data_ptr(),
            out.data_ptr(), op_builder.dtype_code(q.dtype), B, H, KVH, D,
            kp.shape[1], table.shape[1], int(i8mm_block), window or 0, hpb,
            float(scale), stream)
    else:
        err = lib.dstt_paged_decode_attention(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), _ptr(ks), _ptr(vs),
            lengths.data_ptr(), table.data_ptr(), _ptr(new_k), _ptr(new_v),
            out.data_ptr(), op_builder.dtype_code(q.dtype), B, H, KVH, D,
            kp.shape[1], table.shape[1], window or 0, hpb, float(scale),
            stream)
    op_builder.check(err, "paged decode attention kernel")
    return out


def paged_chunk_prefill_attention_plain(q, k_pool, v_pool, starts, pages,
                                        scale=None, k_scale=None,
                                        v_scale=None):
    """Dense fp32 chunk attention over the gathered views of one pool
    layer ``[num_pages, page, KVH*D]`` (int8 with ``k_scale`` /
    ``v_scale``): row i of batch row b (virtual position ``starts[b] +
    i``) sees positions ``<= starts[b] + i``."""
    gk, gks = _gathered(k_pool, k_scale, pages)
    gv, gvs = _gathered(v_pool, v_scale, pages)
    return chunk_prefill_attention_plain(q, gk, gv, starts, scale, gks, gvs)


def paged_chunk_prefill_attention(q, k_pool, v_pool, starts, pages,
                                  scale=None, layer=None, k_scale=None,
                                  v_scale=None):
    """Chunked-prefill attention over a paged pool: a block of C query
    tokens, already written through the table at virtual positions
    ``starts[b] .. starts[b]+C-1``, attends causally over each row's
    pages.  q: [B, C, H, D]; pools / scales / pages / layer as in
    :func:`paged_decode_attention`; starts: [B] int32.  Returns
    [B, C, H, D]."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    kp, vp = pool_layer(k_pool, layer), pool_layer(v_pool, layer)
    ks = None if k_scale is None else pool_layer(k_scale, layer)
    vs = None if v_scale is None else pool_layer(v_scale, layer)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return paged_chunk_prefill_attention_plain(q, kp, vp, starts, pages,
                                                   scale, k_scale=ks,
                                                   v_scale=vs)
    out = _launch_paged_chunk(q, kp, vp, ks, vs, starts, pages, scale)
    if ks is None:
        paged_chunk_prefill_attention.launches += 1
    else:
        paged_chunk_prefill_attention.int8_launches += 1
    return out


paged_chunk_prefill_attention.launches = 0
paged_chunk_prefill_attention.int8_launches = 0


def paged_box_rows(page):
    """Rows of one TMA box of K7's key tiles on a 16-bit float pool: the
    largest multiple of 8 dividing both the page and the 64-row tile
    (``gcd(page, 64)``), so a box never crosses a page and starts on the
    swizzle's 1024-byte period inside the tile; a tile takes
    ``64 // rows`` boxes.  Pages must be a multiple of 8 positions, as the
    serving engine rounds them."""
    page = int(page)
    if page <= 0 or page % 8:
        raise ValueError(f"paged chunk kernel: page size {page} is not a "
                         f"positive multiple of 8")
    return math.gcd(page, KEY_TILE)


def pool_tma_view(pool, D):
    """One pool layer ``[num_pages, page, KVH*D]`` as the ``[num_pages,
    page, KVH, D]`` tensor K7's TMA map reads (box ``j`` of a key tile at
    (page ``pages[b, v // page]``, row ``v % page``, kv head, 0) for
    virtual row ``v``)."""
    num_pages, page, KVHD = pool.shape
    return pool.view(num_pages, page, KVHD // D, D)


def _launch_paged_chunk(q, kp, vp, ks, vs, starts, pages, scale):
    B, C, H, D = q.shape
    KVH = _check_pool(q, kp, vp, ks, vs, "paged chunk kernel")
    _check_cuda("paged chunk prefill attention", q)
    box_rows = 0
    if q.dtype != torch.float32:
        check_tma("paged chunk kernel", "q", q)
        if ks is None:
            box_rows = paged_box_rows(kp.shape[1])
            for name, t in (("k_pool", kp), ("v_pool", vp)):
                check_tma("paged chunk kernel", name, pool_tma_view(t, D))
    table = _table(pages, B, q.device)
    starts = starts.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty(B, C, H, D, dtype=q.dtype, device=q.device)
    err = op_builder.FLASH.load().dstt_paged_chunk_prefill(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), _ptr(ks), _ptr(vs),
        out.data_ptr(), starts.data_ptr(), table.data_ptr(),
        op_builder.dtype_code(q.dtype), B, C, H, KVH, D, kp.shape[0],
        kp.shape[1], table.shape[1], box_rows, *q.stride()[:3],
        *out.stride()[:3], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check(err, "paged chunk prefill kernel")
    return out
