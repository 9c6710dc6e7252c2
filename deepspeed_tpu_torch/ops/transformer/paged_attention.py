"""Paged-pool attention — kernels K6 (decode with fused write) and K7
(chunked prefill), each with its plain version.

Port of ``deepspeed_tpu/ops/transformer/paged_attention.py`` for bf16 /
fp16 / fp32 pools (its int8-KV and int8-matmul modes are still to port).
The KV cache is one page pool per K and V, layer-stacked ``[L,
num_pages, page_size, KVH*D]`` (``Transformer.init_paged_cache``), and
each batch row owns a block table ``pages[b, virtual_page] ->
physical_page``; virtual position ``pos`` of row ``b`` lives at pool page
``pages[b, pos // page_size]``, in-page row ``pos % page_size``.  Dead or
unmapped table entries point at the reserved trash page 0.

* K6 (``ops/csrc/decode_attention.cu``, entry
  ``dstt_paged_decode_attention``) replaces ``paged_decode_attention``:
  K2's body with the block table as its row map.  With ``new_k`` /
  ``new_v`` it first writes this step's row IN PLACE through the table at
  virtual position ``max(lengths[b]-1, 0)``.
* K7 (``ops/csrc/flash_attention.cu``, entry
  ``dstt_paged_chunk_prefill``) replaces ``paged_chunk_prefill_attention``:
  K3's body with the block table as its key-row map.

The plain versions gather each row's virtual view ``pool[layer][pages[b]]``
and run the monolithic plain functions on it, so they are bitwise equal to
``decode_attention_plain`` / ``chunk_prefill_attention_plain`` over the
gathered view; the kernels keep K2's / K3's schedules and are bitwise
equal to K2 / K3 over that view on the card.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version only for CPU tensors; it never falls back.
"""

import math

import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.transformer.decode_attention import (
    chunk_prefill_attention_plain, decode_attention_plain)
from deepspeed_tpu_torch.ops.transformer.flash_attention import _check_cuda


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


def paged_decode_attention_plain(q, k_pool, v_pool, lengths, pages,
                                 scale=None, new_k=None, new_v=None):
    """Write-then-attend over one pool layer in plain PyTorch.  q
    [B, H, D]; pools ``[num_pages, page, KVH*D]`` (written in place through
    ``pages`` when ``new_k`` / ``new_v`` are given); lengths [B]; pages
    [B, n_virt].  Returns [B, H, D]."""
    B, H, D = q.shape
    n_virt, page = pages.shape[1], k_pool.shape[1]
    if new_k is not None:
        w = (lengths.to(q.device).long() - 1).clamp(0, n_virt * page - 1)
        KVHD = k_pool.shape[-1]
        write_pages(k_pool, pages, w[:, None], new_k.reshape(B, 1, KVHD))
        write_pages(v_pool, pages, w[:, None], new_v.reshape(B, 1, KVHD))
    return decode_attention_plain(q, gather_pages(k_pool, pages),
                                  gather_pages(v_pool, pages), lengths,
                                  scale)


def paged_decode_attention(q, k_pool, v_pool, lengths, pages, scale=None,
                           layer=None, new_k=None, new_v=None):
    """Single-token decode attention over a paged pool.  q: [B, H, D];
    pools ``[L, num_pages, page_size, KVH*D]`` with ``layer``; lengths
    [B] int32, counting this step's token; pages [B, n_virt] int32.  With
    ``new_k`` / ``new_v`` ([B, KVH, D]) the row is written in place
    through the table first and ``(out, k_pool, v_pool)`` is returned;
    otherwise ``out``."""
    if (new_k is None) != (new_v is None):
        raise ValueError("new_k and new_v must be given together")
    kp, vp = pool_layer(k_pool, layer), pool_layer(v_pool, layer)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        out = _launch_paged_decode(q, kp, vp, lengths, pages, scale, new_k,
                                   new_v)
        paged_decode_attention.launches += 1
    else:
        out = paged_decode_attention_plain(q, kp, vp, lengths, pages, scale,
                                           new_k, new_v)
    return out if new_k is None else (out, k_pool, v_pool)


paged_decode_attention.launches = 0


def _table(pages, B, device):
    if pages.dim() != 2 or pages.shape[0] != B:
        raise ValueError(f"block table must be [{B}, n_virt], got "
                         f"{tuple(pages.shape)}")
    if pages.device != device:
        raise ValueError(f"block table on {pages.device}, the pool on "
                         f"{device}")
    return pages.to(torch.int32).contiguous()


def _check_pool(q, kp, vp, what):
    D = q.shape[-1]
    KVHD = kp.shape[-1]
    KVH = KVHD // D
    if KVH * D != KVHD or q.shape[-2] % KVH:
        raise ValueError(f"pool width {KVHD} does not fit {q.shape[-2]} "
                         f"heads of {D}")
    if D not in (64, 128):
        raise ValueError(f"CUDA attention kernels take head_dim 64 or 128, "
                         f"got {D}")
    if not (kp.is_contiguous() and vp.is_contiguous()):
        raise ValueError(f"{what} needs contiguous [num_pages, page, KVH*D] "
                         f"pool layers")
    return KVH


def _launch_paged_decode(q, kp, vp, lengths, pages, scale, new_k, new_v):
    B, H, D = q.shape
    KVH = _check_pool(q, kp, vp, "paged decode kernel")
    if H // KVH not in (1, 2, 4, 8):
        raise ValueError(f"decode kernel serves 1, 2, 4 or 8 query heads "
                         f"per kv head, got {H // KVH}")
    q = q.contiguous()
    tensors = [q, kp, vp]
    if new_k is not None:
        new_k = new_k.to(kp.dtype).contiguous()
        new_v = new_v.to(vp.dtype).contiguous()
        tensors += [new_k, new_v]
    _check_cuda("paged decode attention", *tensors)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("paged decode kernel needs 16-byte aligned tensors")
    table = _table(pages, B, q.device)
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = op_builder.DECODE.load()
    err = lib.dstt_paged_decode_attention(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), lengths.data_ptr(),
        table.data_ptr(), None if new_k is None else new_k.data_ptr(),
        None if new_v is None else new_v.data_ptr(), out.data_ptr(),
        op_builder.dtype_code(q.dtype), B, H, KVH, D, kp.shape[1],
        table.shape[1], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check(err, "paged decode attention kernel")
    return out


def paged_chunk_prefill_attention_plain(q, k_pool, v_pool, starts, pages,
                                        scale=None):
    """Dense fp32 chunk attention over the gathered views of one pool
    layer ``[num_pages, page, KVH*D]``: row i of batch row b (virtual
    position ``starts[b] + i``) sees positions ``<= starts[b] + i``."""
    return chunk_prefill_attention_plain(q, gather_pages(k_pool, pages),
                                         gather_pages(v_pool, pages), starts,
                                         scale)


def paged_chunk_prefill_attention(q, k_pool, v_pool, starts, pages,
                                  scale=None, layer=None):
    """Chunked-prefill attention over a paged pool: a block of C query
    tokens, already written through the table at virtual positions
    ``starts[b] .. starts[b]+C-1``, attends causally over each row's
    pages.  q: [B, C, H, D]; pools / pages / layer as in
    :func:`paged_decode_attention`; starts: [B] int32.  Returns
    [B, C, H, D]."""
    kp, vp = pool_layer(k_pool, layer), pool_layer(v_pool, layer)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        out = _launch_paged_chunk(q, kp, vp, starts, pages, scale)
        paged_chunk_prefill_attention.launches += 1
        return out
    return paged_chunk_prefill_attention_plain(q, kp, vp, starts, pages,
                                               scale)


paged_chunk_prefill_attention.launches = 0


def _launch_paged_chunk(q, kp, vp, starts, pages, scale):
    B, C, H, D = q.shape
    KVH = _check_pool(q, kp, vp, "paged chunk kernel")
    _check_cuda("paged chunk prefill attention", q, kp, vp)
    table = _table(pages, B, q.device)
    starts = starts.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty(B, C, H, D, dtype=q.dtype, device=q.device)
    err = op_builder.FLASH.load().dstt_paged_chunk_prefill(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(),
        starts.data_ptr(), table.data_ptr(), op_builder.dtype_code(q.dtype),
        B, C, H, KVH, D, kp.shape[1], table.shape[1], *q.stride()[:3],
        *out.stride()[:3], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check(err, "paged chunk prefill kernel")
    return out
