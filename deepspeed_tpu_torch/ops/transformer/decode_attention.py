"""KV-cache attention — kernels K2 (decode with fused write) and K3
(chunked prefill), each with its plain version.

Port of ``deepspeed_tpu/ops/transformer/decode_attention.py`` for bf16 /
fp16 / fp32 caches (the int8-KV, sliding-window and int8-matmul modes are
still to port).  Caches keep the JAX package's layout: S-major with heads
flattened, ``[B, S_max, KVH*D]``, or layer-stacked ``[L, B, S_max,
KVH*D]`` with a ``layer`` index — the wrappers then hand the kernels the
contiguous view ``cache[layer]``.

* K2 (``ops/csrc/decode_attention.cu``) replaces ``_decode_kernel``: one
  query row per head over positions ``< lengths[b]``; with ``new_k`` /
  ``new_v`` it first writes this step's row IN PLACE at
  ``max(lengths[b]-1, 0)`` (the JAX kernel returns aliased caches; here
  the caller's tensors are updated and returned).
* K3 (the chunk entry of ``ops/csrc/flash_attention.cu``) replaces
  ``_chunk_prefill_kernel``: C rows at positions ``starts[b] + i`` attend
  causally over the cache.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version only for CPU tensors; it never falls back.
"""

import math

import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.transformer.flash_attention import (
    _check_cuda, flash_attention_plain, launch_attention_kernel)


def _layer_view(cache, layer):
    if cache.dim() == 4:
        if layer is None:
            raise ValueError("stacked [L, ...] caches require layer=")
        return cache[int(layer)]
    return cache


def decode_attention_plain(q, k_cache, v_cache, lengths, scale=None,
                           new_k=None, new_v=None):
    """Write-then-attend in plain PyTorch (the unfused JAX order).  q:
    [B, H, D]; caches: one layer's [B, S_max, KVH*D] (updated in place
    when ``new_k``/``new_v`` are given); lengths [B].  Returns [B, H, D]."""
    B, H, D = q.shape
    S_max, KVHD = k_cache.shape[-2], k_cache.shape[-1]
    KVH = KVHD // D
    lengths = lengths.to(q.device).long()
    if new_k is not None:
        rows = torch.arange(B, device=q.device)
        w = (lengths - 1).clamp(0, S_max - 1)
        k_cache[rows, w] = new_k.reshape(B, KVHD).to(k_cache.dtype)
        v_cache[rows, w] = new_v.reshape(B, KVHD).to(v_cache.dtype)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    k = k_cache.reshape(B, S_max, KVH, D).float()
    v = v_cache.reshape(B, S_max, KVH, D).float()
    k = k.repeat_interleave(H // KVH, dim=2)
    v = v.repeat_interleave(H // KVH, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.float(), k) * scale
    live = torch.arange(S_max, device=q.device)[None] < lengths[:, None]
    s = s.masked_fill(~live[:, None], -1e30)
    p = torch.softmax(s, dim=-1) * live[:, None]
    return torch.einsum("bht,bthd->bhd", p, v).to(q.dtype)


def decode_attention(q, k_cache, v_cache, lengths, scale=None, layer=None,
                     new_k=None, new_v=None):
    """Single-token decode attention.  q: [B, H, D]; caches [B, S_max,
    KVH*D] or stacked [L, B, S_max, KVH*D] with ``layer``; lengths: [B]
    int32, counting this step's token.  With ``new_k``/``new_v``
    ([B, KVH, D]) the row is written in place first and
    ``(out, k_cache, v_cache)`` is returned; otherwise ``out``."""
    if (new_k is None) != (new_v is None):
        raise ValueError("new_k and new_v must be given together")
    B, H, D = q.shape
    kc, vc = _layer_view(k_cache, layer), _layer_view(v_cache, layer)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.is_cuda:
        out = _launch_decode(q, kc, vc, lengths, scale, new_k, new_v)
        decode_attention.launches += 1
    else:
        out = decode_attention_plain(q, kc, vc, lengths, scale, new_k, new_v)
    return out if new_k is None else (out, k_cache, v_cache)


decode_attention.launches = 0


def _launch_decode(q, kc, vc, lengths, scale, new_k, new_v):
    B, H, D = q.shape
    S_max, KVHD = kc.shape[-2], kc.shape[-1]
    KVH = KVHD // D
    if KVH * D != KVHD or H % KVH:
        raise ValueError(f"cache width {KVHD} does not fit {H} heads of {D}")
    if D not in (64, 128):
        raise ValueError(f"CUDA attention kernels take head_dim 64 or 128, "
                         f"got {D}")
    if H // KVH not in (1, 2, 4, 8):
        raise ValueError(f"decode kernel serves 1, 2, 4 or 8 query heads "
                         f"per kv head, got {H // KVH}")
    q = q.contiguous()
    tensors = [q, kc, vc]
    if new_k is not None:
        new_k = new_k.to(kc.dtype).contiguous()
        new_v = new_v.to(vc.dtype).contiguous()
        tensors += [new_k, new_v]
    _check_cuda("decode attention", *tensors)
    if not (kc.is_contiguous() and vc.is_contiguous()):
        raise ValueError("decode kernel needs contiguous [B, S_max, KVH*D] "
                         "caches")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("decode kernel needs 16-byte aligned tensors")
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = op_builder.DECODE.load()
    err = lib.dstt_decode_attention(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), lengths.data_ptr(),
        None if new_k is None else new_k.data_ptr(),
        None if new_v is None else new_v.data_ptr(),
        out.data_ptr(), op_builder.dtype_code(q.dtype), B, H, KVH, D, S_max,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check(err, "decode attention kernel")
    return out


def _cache_heads(cache, D):
    """[B, S_max, KVH*D] -> the [B, S_max, KVH, D] view (no copy)."""
    B, S_max, KVHD = cache.shape
    return cache.view(B, S_max, KVHD // D, D)


def chunk_prefill_attention_plain(q, k_cache, v_cache, starts, scale=None):
    """Dense fp32 chunk attention: row i of batch row b (position
    ``starts[b] + i``) sees cache positions ``<= starts[b] + i``.  q:
    [B, C, H, D]; caches: one layer's [B, S_max, KVH*D]."""
    D = q.shape[-1]
    out, _ = flash_attention_plain(q, _cache_heads(k_cache, D),
                                   _cache_heads(v_cache, D), causal=True,
                                   scale=scale, q_offsets=starts)
    return out


def chunk_prefill_attention(q, k_cache, v_cache, starts, scale=None,
                            layer=None):
    """Chunked-prefill attention: a block of C query tokens, already
    written to the cache at ``starts[b] .. starts[b]+C-1``, attends
    causally over the cache.  q: [B, C, H, D]; caches as in
    :func:`decode_attention`; starts: [B] int32.  Returns [B, C, H, D]."""
    D = q.shape[-1]
    kc, vc = _layer_view(k_cache, layer), _layer_view(v_cache, layer)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.is_cuda:
        out, _ = launch_attention_kernel(q, _cache_heads(kc, D),
                                         _cache_heads(vc, D), True,
                                         float(scale), starts, False)
        chunk_prefill_attention.launches += 1
        return out
    return chunk_prefill_attention_plain(q, kc, vc, starts, scale)


chunk_prefill_attention.launches = 0
