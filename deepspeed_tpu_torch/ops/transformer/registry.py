"""Attention-kernel registry — the one dispatch point for cached attention
(port of ``deepspeed_tpu/ops/transformer/registry.py``, monolithic caches
and paged pools).

* :func:`select_kernel` — the dispatch table.  Its probes read only
  shapes and config, so ``InferenceEngine.prefill_plan`` and the serving
  engine's ``kernel_modes`` report what the model will run.
* :func:`write_and_attend` — behind ``models.transformer.Attention``:
  writes this step's K/V rows into the layer-stacked cache (or through
  the block table into the page pool) and attends through the selected
  kernel.

Modes, probed in order:

==========================  ==============================================
``cuda_paged_decode``       single-token decode over the page pool through
                            the block table (kernel K6, fused write)
``cuda_decode``             single-token decode over a monolithic cache
                            (kernel K2, fused write)
``cuda_chunked_prefill``    multi-token block vs the cache, S <= 512: K3
                            on a monolithic cache, K7 on a page pool
``reference_fallback``      dense masked attention in plain PyTorch over a
                            monolithic cache (blocks longer than 512, and a
                            sliding-window layer's blocks of 2 to 512
                            tokens; on a pool, over the layer's gathered
                            virtual view)
==========================  ==============================================

A sliding-window layer (GPT-Neo's "local" layers, ``window``) takes the
JAX routes: its single-token decode runs K2's window mode (fused write;
write then int8×int8 under ``decode_int8_matmuls``); its blocks of 2 to
512 tokens write, then attend dense with the band, as JAX's
``reference_fallback`` does — on a pool over this layer's
``gather_pages`` view, JAX's own gather route, used only there.  Its
decode on a pool writes unfused (``_quant_rows``' scales, as JAX's
write) and runs K6's window mode over the table: JAX gathers the view
and runs B4 with the window, and K6 computes the same without the
gather.  Global layers keep every route above.

Every mode takes bf16 / fp16 / fp32 caches and int8 caches
(``kv_cache_quant``: int8 payloads plus fp32 per-(position, kv-head)
scales ``k_scale`` / ``v_scale`` in the cache dict).  On an int8 cache the
decode kernels quantize the fresh row themselves in the fused write;
every other write quantizes its rows outside a kernel
(:func:`_quant_rows`).  With ``decode_int8_matmuls`` decode returns to
write-then-attend, as in JAX, and K2 / K6 run their int8×int8 mode.

A paged pool runs K6 / K7 (and the windowed chunks' gather): the serving
engine caps its chunks at 512 tokens, and a block the kernels cannot take
raises.

The kernels exist for every device the port runs on: CUDA tensors launch
them, CPU tensors run their plain versions.  This mirrors the JAX package,
whose ``pallas_supported()`` is true on the CPU (interpret mode), so the
dispatch decisions and the ``"auto"`` chunk policy agree between the two
packages.
"""

import functools

import torch

from deepspeed_tpu_torch.ops.quantizer.kernels import true_div

# the chunk kernel's longest block, as in the JAX package
MAX_CHUNK_S = 512

KERNEL_MODES = ("cuda_paged_decode", "cuda_decode", "cuda_chunked_prefill",
                "reference_fallback")


def select_kernel(*, s, paged=False, has_window=False):
    """The attention-kernel decision for one cached-attention call of
    ``s`` tokens; ``paged``: a block-table pool, not monolithic lanes;
    ``has_window``: a sliding-window layer.  Returns a
    :data:`KERNEL_MODES` name, JAX's decision with ``pallas_`` read as
    ``cuda_`` but in one case: a windowed decode on a pool reports
    ``cuda_paged_decode`` (K6's window mode), where JAX reports
    ``reference_fallback`` — its paged kernel has no window — and gets
    the same numbers from B4's window mode over the gathered view.  (The
    JAX table also probes alibi biases and its ``paged_kernel=False`` A/B
    marker; alibi is not ported and raises when a model is built, and the
    port has no gather path to switch to.)"""
    if s == 1:
        return "cuda_paged_decode" if paged else "cuda_decode"
    if 1 < s <= MAX_CHUNK_S and not has_window:
        return "cuda_chunked_prefill"
    return "reference_fallback"


def kernel_modes(*, paged=False, has_window=False):
    """Which mode each program class takes (what ``prefill_plan`` and the
    serving engine report)."""
    return {"decode": select_kernel(s=1, paged=paged, has_window=has_window),
            "prefill_chunk": select_kernel(s=2, paged=paged,
                                           has_window=has_window)}


def _quant_rows(new, kvh):
    """Per-(position, kv-head) symmetric int8 of rows ``[B, S, KVH*D]``
    (the JAX ``_quant_rows``): the payload and the RAW scale
    ``max|x| / 127`` ``[B, S, KVH]`` — 0.0 for an all-zero row, where the
    fused kernels store 1.0 (payload 0 either way)."""
    B, S, KVHD = new.shape
    r = new.reshape(B, S, kvh, KVHD // kvh).float()
    s = true_div(r.abs().amax(dim=-1), 127.0)
    safe = torch.where(s == 0.0, torch.ones_like(s), s)
    pay = torch.clamp(torch.round(r / safe[..., None]), -127, 127)
    return pay.to(torch.int8).reshape(B, S, KVHD), s


def _write_cache(cache, layer, rows, positions, start):
    """This step's rows into layer ``layer`` of the stacked cache, in
    place: ``rows`` maps cache keys (``"k"``, ``"v"`` and, for an int8
    cache, ``"k_scale"`` / ``"v_scale"``) to ``[B, S, ...]``.  A
    row-uniform block (``start`` an int, checked by the caller) writes
    positions ``start .. start+S-1``; per-row positions (``start`` None:
    padded-prompt decode, serving lanes) scatter each row to its own
    positions, which the callers keep inside the cache from what the host
    already knows — ``generate`` sizes its cache from the prompt lengths
    and ``required_cache_len``, the serving engine clamps its lanes'
    positions below ``max_pos`` and a dead lane's speculative window
    below ``max_pos - spec_k`` (JAX drops a scatter past the lane;
    PyTorch faults on the card).  Nothing here reads the device back."""
    for key, new in rows.items():
        buf = cache[key][layer]
        if start is None:
            B, S = new.shape[0], new.shape[1]
            idx = torch.arange(B, device=buf.device)[:, None].expand(B, S)
            buf[idx, positions] = new.to(buf.dtype)
        else:
            buf[:, start:start + new.shape[1]] = new.to(buf.dtype)


def _new_rows(cfg, k, v):
    """The rows a write stores: ``{"k", "v"}`` ``[B, S, KVH*D]``, quantized
    outside a kernel with their scales for an int8 cache."""
    B, S, KVH, D = k.shape
    k, v = k.reshape(B, S, KVH * D), v.reshape(B, S, KVH * D)
    if not cfg.kv_cache_quant:
        return {"k": k, "v": v}
    (kq, ks), (vq, vs) = _quant_rows(k, KVH), _quant_rows(v, KVH)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def _scales(cache):
    return dict(k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))


def _decode(cfg, q, k, v, positions, cache, layer, paged, start, window):
    """Single-token decode: K2 / K6 write this step's row (quantizing it
    on an int8 cache) and attend in one launch; with
    ``decode_int8_matmuls`` the row is quantized and written first (at
    ``start`` when every row shares it) and the kernel attends int8×int8
    (the JAX order: that mode has no fused write).  A windowed layer on a
    pool also writes first (JAX's gather route writes unfused) and attends
    over the table with the window — int8×int8 in the gathered view's KV
    blocks of ``min(512, virtual positions)``.  Returns
    ``out [B, 1, H, D]``."""
    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa
    from deepspeed_tpu_torch.ops.transformer.decode_attention import (
        DEFAULT_BLOCK_K_DECODE, decode_attention)
    lengths = (positions[:, 0] + 1).to(torch.int32)
    if paged:
        attend = functools.partial(pa.paged_decode_attention,
                                   pages=cache["pages"])
    else:
        attend = decode_attention
    kw = dict(layer=layer, window=window, **_scales(cache))
    if cfg.decode_int8_matmuls or (paged and window is not None):
        rows = _new_rows(cfg, k, v)
        if paged:
            _paged_rows_write(cache, layer, rows, positions, start)
        else:
            _write_cache(cache, layer, rows, positions, start)
        if cfg.decode_int8_matmuls:
            kw["int8_matmuls"] = True
            if paged and window is not None:
                kw["block_k"] = min(DEFAULT_BLOCK_K_DECODE,
                                    cache["pages"].shape[1]
                                    * cache["k"].shape[-2])
        out = attend(q[:, 0], cache["k"], cache["v"], lengths, **kw)
    else:
        out = attend(q[:, 0], cache["k"], cache["v"], lengths,
                     new_k=k[:, 0], new_v=v[:, 0], **kw)[0]
    return out[:, None]


def _paged_rows_write(cache, layer, rows, positions, start):
    from deepspeed_tpu_torch.models.transformer import _paged_write
    _paged_write(cache, layer, rows["k"], rows["v"], positions, start,
                 rows.get("k_scale"), rows.get("v_scale"))


def _gathered_attention(q, cache, layer, positions, window):
    """Dense windowed attention over layer ``layer``'s virtual view of the
    pool (JAX's gather route for a windowed chunk: ``_paged_gather``, then
    ``cached_attention`` with the window)."""
    from deepspeed_tpu_torch.models.transformer import cached_attention
    from deepspeed_tpu_torch.ops.transformer.paged_attention import (
        gather_pages)
    view = {key: gather_pages(cache[key][layer], cache["pages"])
            for key in ("k", "v", "k_scale", "v_scale") if key in cache}
    return cached_attention(q, view["k"], view["v"], positions,
                            window=window, **_scales(view))


def _paged_write_and_attend(cfg, q, k, v, positions, cache, layer, start,
                            prefill, window):
    """The paged half of :func:`write_and_attend`: decode through K6, or
    the table-resolved write then K7 (a windowed chunk: then dense over the
    gathered view)."""
    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa
    S = k.shape[1]
    if prefill or not 1 <= S <= MAX_CHUNK_S:
        raise ValueError(
            f"a page pool takes single-token decode and chunks of 2 to "
            f"{MAX_CHUNK_S} tokens (got {S} tokens, prefill={prefill}); "
            f"serve it through ServingEngine")
    if S == 1:
        return _decode(cfg, q, k, v, positions, cache, layer, True, start,
                       window)
    _paged_rows_write(cache, layer, _new_rows(cfg, k, v), positions, start)
    if window is not None:
        return _gathered_attention(q, cache, layer, positions, window)
    return pa.paged_chunk_prefill_attention(
        q, cache["k"], cache["v"], positions[:, 0].to(torch.int32),
        cache["pages"], layer=layer, **_scales(cache))


def write_and_attend(cfg, q, k, v, positions, cache, layer, *,
                     start=None, prefill=False, window=None):
    """Write this step's K/V rows into ``cache`` and attend.  ``cache`` is
    ``{"k", "v"}`` stacked ``[L, B, S_max, KVH*D]``, or a page pool
    ``{"k", "v"}`` ``[L, num_pages, page, KVH*D]`` with its block table
    ``"pages"`` ``[B, n_virt]``; either may carry int8 scales
    ``"k_scale"`` / ``"v_scale"``, and is updated in place.
    q [B, S, H, D], k/v [B, S, KVH, D], positions [B, S]; ``start`` is the
    block's first position when every row shares it (an int), else None.
    ``window``: this layer's sliding window, or None.  Returns
    ``out [B, S, H, D]``.

    ``prefill``: this block is a from-zero prompt, so it attends only
    within itself — causal flash over the fresh q/k/v (not the quantized
    rows of an int8 cache), as in JAX — after the write.  The caller sets
    it explicitly: chunked prefill passes False for every chunk, its first
    included, so chunk 0 attends through the chunk kernel as it does in
    the JAX package."""
    from deepspeed_tpu_torch.models.transformer import (_prefill_attention,
                                                        cached_attention)
    S = k.shape[1]
    if "pages" in cache:
        return _paged_write_and_attend(cfg, q, k, v, positions, cache, layer,
                                       start, prefill, window)
    S_max = cache["k"].shape[-2]
    if start is not None and not 0 <= start <= S_max - S:
        raise ValueError(f"cache write [{start}, {start + S}) past the cache "
                         f"({S_max} positions); size it with "
                         f"required_cache_len")
    mode = select_kernel(s=S, has_window=window is not None)
    if mode == "cuda_decode":
        return _decode(cfg, q, k, v, positions, cache, layer, False, start,
                       window)
    _write_cache(cache, layer, _new_rows(cfg, k, v), positions, start)
    if prefill:
        return _prefill_attention(q, k, v, cfg, window)
    if mode == "cuda_chunked_prefill":
        # each row's positions are contiguous and ascending, so the kernel
        # needs only the first
        from deepspeed_tpu_torch.ops.transformer.decode_attention import (
            chunk_prefill_attention)
        return chunk_prefill_attention(q, cache["k"], cache["v"],
                                       positions[:, 0].to(torch.int32),
                                       layer=layer, **_scales(cache))
    return cached_attention(q, cache["k"], cache["v"], positions, layer=layer,
                            window=window, **_scales(cache))
