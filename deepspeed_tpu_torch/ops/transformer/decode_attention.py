"""KV-cache attention — kernels K2 (decode with fused write) and K3
(chunked prefill), each with its plain version.

Port of ``deepspeed_tpu/ops/transformer/decode_attention.py`` for bf16 /
fp16 / fp32 caches and int8-KV caches, with the int8×int8 decode mode
and the sliding-window mode of decode.  Caches keep the JAX
package's layout: S-major with heads flattened, ``[B, S_max, KVH*D]``, or
layer-stacked ``[L, B, S_max, KVH*D]`` with a ``layer`` index — the
wrappers then hand the kernels the contiguous view ``cache[layer]``.  An
int8-KV cache comes with fp32 scales ``k_scale`` / ``v_scale`` ``[..,
S_max, KVH]``, one per (position, kv head), stacked the same way.

* K2 (``ops/csrc/decode_attention.cu``) replaces ``_decode_kernel``: one
  query row per head over positions ``< lengths[b]``; with ``new_k`` /
  ``new_v`` it first writes this step's row IN PLACE at
  ``max(lengths[b]-1, 0)`` (the JAX kernel returns aliased caches; here
  the caller's tensors are updated and returned), quantizing it on an
  int8 cache (:func:`quantize_rows`, which stores the safe scale).  With
  ``int8_matmuls`` (unfused only) both products run int8×int8 in the
  JAX kernel's KV blocks of ``min(block_k, S_max)`` positions.  With
  ``window`` (GPT-Neo's local layers) the query at position ``length-1``
  sees only ``[length - window, length)``: the kernel starts its position
  loop there, so it reads O(window) rows, as the JAX kernel's index maps
  pin the blocks below the window; the int8×int8 mode starts at the
  block holding ``length - window`` and skips every block wholly below
  it, as JAX does.
* K3 (the chunk entries of ``ops/csrc/flash_attention.cu``) replaces
  ``_chunk_prefill_kernel``: C rows at positions ``starts[b] + i`` attend
  causally over the cache.  For bf16 / fp16 q it runs K1's tensor-core
  kernel (float caches by TMA, int8 payloads converted into the same
  tiles), so q (and a 16-bit cache) must meet TMA's 16-byte rules.

K2's kernels (float / int8-KV, and int8×int8) walk a row's live
positions in tiles held in a shared-memory ring; with one query head per
kv head they serve 2 kv heads a block where the launch still fills the
card.  :func:`heads_per_block` picks that on the host from shapes alone,
so a launch reads nothing back from the device (and K6 over a pool gets
the choice of K2 over its gathered view).

Each wrapper launches its kernel for CUDA tensors and runs the plain
version only for CPU tensors; it never falls back.  Launches are counted
per mode: ``launches`` on float caches, ``int8_launches`` on int8-KV
caches and, for decode, ``i8mm_launches`` in the int8×int8 mode, and a
windowed decode apart from a full one (``window_launches``,
``window_int8_launches``, ``window_i8mm_launches``).  A launch inside a
captured CUDA graph is counted once per replay
(``model_implementations/features/cuda_graph.py``): every launch reads
its stream, tensors and shapes when it is called, so a capture records
it like any other kernel.
"""

import functools
import math

import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.op_builder import check_tma
from deepspeed_tpu_torch.ops.quantizer.kernels import true_div
from deepspeed_tpu_torch.ops.transformer.flash_attention import (
    _check_cuda, flash_attention_plain, launch_attention_kernel)

# the JAX decode kernel's KV block (its DSTPU_DECODE_BLOCK_K default): the
# blocks in which the int8×int8 mode quantizes P
DEFAULT_BLOCK_K_DECODE = 512

# K2 / K6 (ops/csrc/decode_attention.cu decode_kernel, and
# decode_i8mm_kernel in the int8×int8 mode) run at least 4 blocks an SM;
# a block serves 2 kv heads (G = 1 only) where the launch still has that
# many blocks for every SM of the card
DECODE_BLOCKS_PER_SM = 4


def _layer_view(cache, layer):
    if cache.dim() == 4:
        if layer is None:
            raise ValueError("stacked [L, ...] caches require layer=")
        return cache[int(layer)]
    return cache


def _scale_view(scale, layer):
    """One layer of stacked ``[L, .., S, KVH]`` scales, or the scales."""
    if scale is None or scale.dim() == 3:
        return scale
    return _layer_view(scale, layer)


def check_window(window):
    """``window`` as an int, or None for full attention."""
    if window is None:
        return None
    if int(window) < 1:
        raise ValueError(f"window must be a positive number of positions, "
                         f"got {window}")
    return int(window)


def live_positions(lengths, t0, t1, window):
    """``[B, t1 - t0]``: which positions ``t0 .. t1-1`` a decode query at
    ``lengths[b] - 1`` sees — those below ``lengths[b]`` and, with
    ``window``, at or above ``lengths[b] - window``."""
    pos = torch.arange(t0, t1, device=lengths.device)[None]
    live = pos < lengths[:, None]
    if window is not None:
        live = live & (pos >= lengths[:, None] - window)
    return live


def check_modes(k_scale, v_scale, int8_matmuls, new_k, new_v):
    """The JAX wrappers' argument errors, shared by K2 / K6."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    if int8_matmuls and k_scale is None:
        raise ValueError("int8_matmuls requires quantized caches "
                         "(k_scale/v_scale)")
    if (new_k is None) != (new_v is None):
        raise ValueError("new_k and new_v must be given together")
    if int8_matmuls and new_k is not None:
        raise ValueError("int8_matmuls is unsupported with the fused cache "
                         "write (new_k/new_v)")


def quantize_rows(x, kvh):
    """Per-(row, kv-head) symmetric int8 of ``x [..., KVH*D]`` as the fused
    kernels quantize a fresh row: ``s = max|x| / 127``, ``safe = s == 0 ?
    1 : s``, payload ``round(x / safe)`` (half to even) clamped to ±127.
    Returns the int8 payload and the SAFE scale ``[..., KVH]`` (1.0 for an
    all-zero row; the registry's ``_quant_rows`` stores the raw 0.0)."""
    r = x.float().reshape(*x.shape[:-1], kvh, x.shape[-1] // kvh)
    s = true_div(r.abs().amax(dim=-1), 127.0)
    safe = torch.where(s == 0.0, torch.ones_like(s), s)
    pay = torch.clamp(torch.round(r / safe[..., None]), -127, 127)
    return pay.to(torch.int8).reshape(x.shape), safe


def dequantize_cache(cache, scale, D):
    """An int8-KV cache ``[B, S, KVH*D]`` with its scales ``[B, S, KVH]``
    as fp32 ``[B, S, KVH, D]``."""
    B, S, KVHD = cache.shape
    return cache.view(B, S, KVHD // D, D).float() * scale[..., None]


def _cache_heads(cache, D, scale=None):
    """[B, S_max, KVH*D] -> the [B, S_max, KVH, D] view (no copy), or the
    dequantized fp32 copy of an int8-KV cache."""
    if scale is not None:
        return dequantize_cache(cache, scale, D)
    B, S_max, KVHD = cache.shape
    return cache.view(B, S_max, KVHD // D, D)


def _write_fresh_rows(k_cache, v_cache, k_scale, v_scale, rows, w, new_k,
                      new_v):
    """The fused write of this step's rows ``new_k / new_v [B, KVH, D]``
    at positions ``w [B]`` of batch rows ``rows``, quantized on an int8
    cache (in place)."""
    B, KVH, D = new_k.shape
    if k_scale is None:
        k_cache[rows, w] = new_k.reshape(B, KVH * D).to(k_cache.dtype)
        v_cache[rows, w] = new_v.reshape(B, KVH * D).to(v_cache.dtype)
        return
    for cache, scales, new in ((k_cache, k_scale, new_k),
                               (v_cache, v_scale, new_v)):
        pay, safe = quantize_rows(new.reshape(B, KVH * D), KVH)
        cache[rows, w] = pay
        scales[rows, w] = safe


def decode_attention_plain(q, k_cache, v_cache, lengths, scale=None,
                           new_k=None, new_v=None, k_scale=None,
                           v_scale=None, window=None):
    """Write-then-attend in plain PyTorch (the unfused JAX order).  q:
    [B, H, D]; caches: one layer's [B, S_max, KVH*D] (updated in place
    when ``new_k``/``new_v`` are given), int8 with ``k_scale`` /
    ``v_scale`` [B, S_max, KVH] (the scores take the k-scale, the
    probabilities the v-scale: attention over the fp32 dequantized cache);
    lengths [B]; ``window``: only the last ``window`` positions are live.
    Returns [B, H, D]."""
    B, H, D = q.shape
    S_max, KVHD = k_cache.shape[-2], k_cache.shape[-1]
    KVH = KVHD // D
    window = check_window(window)
    lengths = lengths.to(q.device).long()
    if new_k is not None:
        rows = torch.arange(B, device=q.device)
        w = (lengths - 1).clamp(0, S_max - 1)
        _write_fresh_rows(k_cache, v_cache, k_scale, v_scale, rows, w,
                          new_k, new_v)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    k = _cache_heads(k_cache, D, k_scale).float()
    v = _cache_heads(v_cache, D, v_scale).float()
    k = k.repeat_interleave(H // KVH, dim=2)
    v = v.repeat_interleave(H // KVH, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.float(), k) * scale
    live = live_positions(lengths, 0, S_max, window)
    s = s.masked_fill(~live[:, None], -1e30)
    p = torch.softmax(s, dim=-1) * live[:, None]
    return torch.einsum("bht,bthd->bhd", p, v).to(q.dtype)


def _quant_int8(x, dim):
    """Symmetric int8 of ``x`` along ``dim`` with the safe scale (the JAX
    kernel's q and P quantization): ``(payload as fp32, safe scale)``."""
    s = true_div(x.abs().amax(dim=dim, keepdim=True), 127.0)
    safe = torch.where(s == 0.0, torch.ones_like(s), s)
    return torch.clamp(torch.round(x / safe), -127, 127), safe


def decode_attention_i8mm_plain(q, k_cache, v_cache, lengths, k_scale,
                                v_scale, scale=None, block_k=None,
                                window=None):
    """The int8×int8 decode (JAX ``int8_matmuls=True``) in plain PyTorch,
    block for block: q quantized per head; per KV block of ``block_k``
    positions (``min(512, S_max)`` when None) the integer scores times
    ``qs * scale`` times the k-scale update the running max, and P times
    the v-scale is quantized per head with ``rmax = max / 127`` before the
    integer PV product (times ``rmax``).  Integer products are exact in
    fp32 (every sum stays below 2^24).  With ``window`` a block runs only
    where it reaches ``[length - window, length)`` and its positions below
    the window are masked, as the JAX kernel skips and masks them.  q:
    [B, H, D]; one layer's int8 caches [B, S_max, KVH*D] and scales
    [B, S_max, KVH]; lengths [B]."""
    B, H, D = q.shape
    S_max, KVHD = k_cache.shape[-2], k_cache.shape[-1]
    KVH = KVHD // D
    G = H // KVH
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    window = check_window(window)
    block_k = min(block_k or DEFAULT_BLOCK_K_DECODE, S_max)
    lengths = lengths.to(q.device).long()
    q8, qs = _quant_int8(q.float(), -1)                  # [B, H, D], [B, H, 1]
    qsc = qs[..., 0] * scale                             # [B, H]
    k = k_cache.view(B, S_max, KVH, D).float().repeat_interleave(G, dim=2)
    v = v_cache.view(B, S_max, KVH, D).float().repeat_interleave(G, dim=2)
    ks = k_scale.float().repeat_interleave(G, dim=2)     # [B, S_max, H]
    vs = v_scale.float().repeat_interleave(G, dim=2)
    m = torch.full((B, H), -1e30, device=q.device)
    l = torch.zeros(B, H, device=q.device)
    acc = torch.zeros(B, H, D, device=q.device)
    for t0 in range(0, S_max, block_k):
        t1 = min(t0 + block_k, S_max)
        run = t0 < lengths
        if window is not None:
            run = run & (t0 + block_k > lengths - window)
        run = run[:, None]                               # [B, 1]
        s = torch.einsum("bhd,bthd->bht", q8, k[:, t0:t1])
        s = s * qsc[..., None] * ks[:, t0:t1].transpose(1, 2)
        live = live_positions(lengths, t0, t1, window)[:, None]  # [B, 1, bk]
        s = s.masked_fill(~live, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(live, torch.exp(s - m_new[..., None]),
                        torch.zeros((), device=q.device))
        corr = torch.exp(m - m_new)
        pv = p * vs[:, t0:t1].transpose(1, 2)
        rmax = true_div(pv.amax(-1, keepdim=True), 127.0)
        rsafe = torch.where(rmax == 0.0, torch.ones_like(rmax), rmax)
        pq = torch.clamp(torch.round(pv / rsafe), -127, 127)
        o = torch.einsum("bht,bthd->bhd", pq, v[:, t0:t1]) * rmax
        acc = torch.where(run[..., None], acc * corr[..., None] + o, acc)
        l = torch.where(run, l * corr + p.sum(-1), l)
        m = torch.where(run, m_new, m)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / safe_l[..., None]).to(q.dtype)


def decode_attention(q, k_cache, v_cache, lengths, scale=None, layer=None,
                     k_scale=None, v_scale=None, int8_matmuls=False,
                     new_k=None, new_v=None,
                     block_k=DEFAULT_BLOCK_K_DECODE, window=None):
    """Single-token decode attention.  q: [B, H, D]; caches [B, S_max,
    KVH*D] or stacked [L, B, S_max, KVH*D] with ``layer``; lengths: [B]
    int32, counting this step's token.  ``k_scale`` / ``v_scale`` ([..,
    S_max, KVH] fp32) mark int8-KV caches; ``int8_matmuls`` runs both
    products int8×int8 in KV blocks of ``min(block_k, S_max)`` positions
    (unfused only).  ``window``: sliding-window decode, only positions
    ``[lengths[b] - window, lengths[b])`` are live (composes with every
    other mode).  With ``new_k``/``new_v`` ([B, KVH, D]) the row is
    written in place first (quantized on an int8 cache) and ``(out,
    k_cache, v_cache[, k_scale, v_scale])`` is returned; otherwise
    ``out``.  Launches count per mode, and in ``window_launches`` /
    ``window_int8_launches`` / ``window_i8mm_launches`` with a window."""
    check_modes(k_scale, v_scale, int8_matmuls, new_k, new_v)
    window = check_window(window)
    B, H, D = q.shape
    kc, vc = _layer_view(k_cache, layer), _layer_view(v_cache, layer)
    ks, vs = _scale_view(k_scale, layer), _scale_view(v_scale, layer)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if int8_matmuls:
        if q.is_cuda:
            out = _launch_decode_i8mm(q, kc, vc, ks, vs, lengths, scale,
                                      min(block_k, kc.shape[-2]), window)
            count_launch(decode_attention, "i8mm", window)
        else:
            out = decode_attention_i8mm_plain(q, kc, vc, lengths, ks, vs,
                                              scale, block_k, window=window)
        return out
    if q.is_cuda:
        out = _launch_decode(q, kc, vc, ks, vs, lengths, scale, new_k, new_v,
                             window)
        count_launch(decode_attention, "" if ks is None else "int8", window)
    else:
        out = decode_attention_plain(q, kc, vc, lengths, scale, new_k, new_v,
                                     k_scale=ks, v_scale=vs, window=window)
    if new_k is None:
        return out
    if k_scale is None:
        return out, k_cache, v_cache
    return out, k_cache, v_cache, k_scale, v_scale


def count_launch(wrapper, mode, window):
    """One launch of ``wrapper``'s kernel in ``mode`` ("" for float
    caches, "int8", "i8mm"), counted apart with a window."""
    name = "_".join(x for x in ("window" if window else "", mode,
                                "launches") if x)
    setattr(wrapper, name, getattr(wrapper, name) + 1)


DECODE_COUNTERS = ("launches", "int8_launches", "i8mm_launches",
                   "window_launches", "window_int8_launches",
                   "window_i8mm_launches")
op_builder.launch_counters(decode_attention, *DECODE_COUNTERS)


def check_kernel_shapes(q, KVHD, what):
    """KVH for a kernel launch of q [B, H, D] over rows of KVH*D."""
    B, H, D = q.shape
    KVH = KVHD // D
    if KVH * D != KVHD or H % KVH:
        raise ValueError(f"{what}: cache width {KVHD} does not fit {H} heads "
                         f"of {D}")
    if D not in (64, 128):
        raise ValueError(f"CUDA attention kernels take head_dim 64 or 128, "
                         f"got {D}")
    if H // KVH not in (1, 2, 4, 8):
        raise ValueError(f"decode kernel serves 1, 2, 4 or 8 query heads "
                         f"per kv head, got {H // KVH}")
    return KVH


def check_int8_cache(q, kc, vc, ks, vs, KVH, what):
    """An int8-KV cache layer for a kernel: contiguous int8 payloads on
    q's device, and contiguous fp32 scales ``kc.shape[:-1] + [KVH]``."""
    lead = tuple(kc.shape[:-1])
    for t in (kc, vc):
        if t.dtype != torch.int8 or t.device != q.device \
                or not t.is_contiguous() or tuple(t.shape[:-1]) != lead:
            raise ValueError(f"{what}: int8-KV payloads must be contiguous "
                             f"int8 on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    for t in (ks, vs):
        if (t.dtype != torch.float32 or tuple(t.shape) != (*lead, KVH)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{what}: int8-KV scales must be contiguous "
                             f"fp32 {(*lead, KVH)} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if any(t.data_ptr() % 16 for t in (kc, vc)):
        raise ValueError(f"{what} needs 16-byte aligned caches")


def _ptr(t):
    return None if t is None else t.data_ptr()


def heads_per_block(B, KVH, G, sm_count, scale_align=8):
    """The kv heads of one block of a K2 / K6 launch, 1 or 2: 2 where G is
    1, KVH is even, the ``B * KVH / 2`` blocks still give every one of the
    card's ``sm_count`` SMs ``DECODE_BLOCKS_PER_SM`` of them, and the int8
    scales (if any) let one 8-byte copy take a position's two
    (``scale_align``: their base address's alignment in bytes).  A
    function of shapes the host knows, never of ``lengths``."""
    return 2 if (G == 1 and KVH % 2 == 0 and scale_align % 8 == 0
                 and B * KVH // 2 >= DECODE_BLOCKS_PER_SM * sm_count) else 1


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_heads_per_block(q, KVH, scales=()):
    """:func:`heads_per_block` of a K2 / K6 launch of ``q [B, H, D]`` on
    q's card, over int8 ``scales`` (none for a float cache)."""
    B, H, _ = q.shape
    align = min((t.data_ptr() & -t.data_ptr() for t in scales), default=8)
    return heads_per_block(B, KVH, H // KVH, _sm_count(q.device.index),
                           align)


def _launch_decode(q, kc, vc, ks, vs, lengths, scale, new_k, new_v,
                   window=None):
    B, H, D = q.shape
    S_max, KVHD = kc.shape[-2], kc.shape[-1]
    KVH = check_kernel_shapes(q, KVHD, "decode kernel")
    q = q.contiguous()
    if ks is None:
        tensors = [q, kc, vc]
    else:
        check_int8_cache(q, kc, vc, ks, vs, KVH, "decode kernel")
        tensors = [q]
    fresh = []
    if new_k is not None:
        # the fresh rows stay in q's dtype: the kernel quantizes them on an
        # int8 cache
        new_k = new_k.to(q.dtype).contiguous()
        new_v = new_v.to(q.dtype).contiguous()
        fresh = [new_k, new_v]
    _check_cuda("decode attention", *tensors, *fresh)
    if not (kc.is_contiguous() and vc.is_contiguous()):
        raise ValueError("decode kernel needs contiguous [B, S_max, KVH*D] "
                         "caches")
    if any(t.data_ptr() % 16 for t in [*tensors, *fresh]):
        raise ValueError("decode kernel needs 16-byte aligned tensors")
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    hpb = launch_heads_per_block(q, KVH, () if ks is None else (ks, vs))
    out = torch.empty_like(q)
    lib = op_builder.DECODE.load()
    err = lib.dstt_decode_attention(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), _ptr(ks), _ptr(vs),
        lengths.data_ptr(), _ptr(new_k), _ptr(new_v), out.data_ptr(),
        op_builder.dtype_code(q.dtype), B, H, KVH, D, S_max, window or 0,
        hpb, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check(err, "decode attention kernel")
    return out


def _launch_decode_i8mm(q, kc, vc, ks, vs, lengths, scale, block_k,
                        window=None):
    B, H, D = q.shape
    S_max, KVHD = kc.shape[-2], kc.shape[-1]
    KVH = check_kernel_shapes(q, KVHD, "int8 x int8 decode kernel")
    if not 0 < block_k <= 512:
        raise ValueError(f"int8_matmuls takes KV blocks of 1 to 512 "
                         f"positions, got {block_k}")
    q = q.contiguous()
    check_int8_cache(q, kc, vc, ks, vs, KVH, "int8 x int8 decode kernel")
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    hpb = launch_heads_per_block(q, KVH, (ks, vs))
    out = torch.empty_like(q)
    err = op_builder.DECODE.load().dstt_decode_attention_i8mm(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        op_builder.dtype_code(q.dtype), B, H, KVH, D, S_max, int(block_k),
        window or 0, hpb, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check(err, "int8 x int8 decode attention kernel")
    return out


def chunk_prefill_attention_plain(q, k_cache, v_cache, starts, scale=None,
                                  k_scale=None, v_scale=None):
    """Dense fp32 chunk attention: row i of batch row b (position
    ``starts[b] + i``) sees cache positions ``<= starts[b] + i``.  q:
    [B, C, H, D]; caches: one layer's [B, S_max, KVH*D], int8 with
    ``k_scale`` / ``v_scale`` [B, S_max, KVH] (attention over the fp32
    dequantized cache)."""
    D = q.shape[-1]
    out, _ = flash_attention_plain(q, _cache_heads(k_cache, D, k_scale),
                                   _cache_heads(v_cache, D, v_scale),
                                   causal=True, scale=scale, q_offsets=starts)
    return out


def chunk_prefill_attention(q, k_cache, v_cache, starts, scale=None,
                            layer=None, k_scale=None, v_scale=None):
    """Chunked-prefill attention: a block of C query tokens, already
    written to the cache at ``starts[b] .. starts[b]+C-1``, attends
    causally over the cache.  q: [B, C, H, D]; caches (and int8-KV scales)
    as in :func:`decode_attention`; starts: [B] int32.  Returns
    [B, C, H, D]."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    D = q.shape[-1]
    kc, vc = _layer_view(k_cache, layer), _layer_view(v_cache, layer)
    ks, vs = _scale_view(k_scale, layer), _scale_view(v_scale, layer)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if not q.is_cuda:
        return chunk_prefill_attention_plain(q, kc, vc, starts, scale,
                                             k_scale=ks, v_scale=vs)
    if ks is None:
        out, _ = launch_attention_kernel(q, _cache_heads(kc, D),
                                         _cache_heads(vc, D), True,
                                         float(scale), starts, False)
        chunk_prefill_attention.launches += 1
        return out
    out = _launch_chunk_int8(q, kc, vc, ks, vs, starts, scale)
    chunk_prefill_attention.int8_launches += 1
    return out


op_builder.launch_counters(chunk_prefill_attention, "launches",
                           "int8_launches")


def _launch_chunk_int8(q, kc, vc, ks, vs, starts, scale):
    B, C, H, D = q.shape
    S_max, KVHD = kc.shape[-2], kc.shape[-1]
    KVH = KVHD // D
    if KVH * D != KVHD or H % KVH:
        raise ValueError(f"cache width {KVHD} does not fit {H} heads of {D}")
    if D not in (64, 128):
        raise ValueError(f"CUDA attention kernels take head_dim 64 or 128, "
                         f"got {D}")
    _check_cuda("chunk prefill attention", q)
    check_int8_cache(q, kc, vc, ks, vs, KVH, "int8-KV chunk kernel")
    if q.dtype != torch.float32:
        check_tma("int8-KV chunk kernel", "q", q)
    starts = starts.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty(B, C, H, D, dtype=q.dtype, device=q.device)
    err = op_builder.FLASH.load().dstt_chunk_prefill_int8(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), out.data_ptr(), starts.data_ptr(),
        op_builder.dtype_code(q.dtype), B, C, H, KVH, D, S_max,
        *q.stride()[:3], *out.stride()[:3], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check(err, "int8-KV chunk prefill kernel")
    return out
