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
                            monolithic cache (blocks longer than 512)
==========================  ==============================================

A paged pool always runs K6 / K7: the serving engine caps its chunks at
512 tokens, and a block the kernels cannot take raises.

The kernels exist for every device the port runs on: CUDA tensors launch
them, CPU tensors run their plain versions.  This mirrors the JAX package,
whose ``pallas_supported()`` is true on the CPU (interpret mode), so the
dispatch decisions and the ``"auto"`` chunk policy agree between the two
packages.
"""

import torch

# the chunk kernel's longest block, as in the JAX package
MAX_CHUNK_S = 512

KERNEL_MODES = ("cuda_paged_decode", "cuda_decode", "cuda_chunked_prefill",
                "reference_fallback")


def select_kernel(*, s, paged=False):
    """The attention-kernel decision for one cached-attention call of
    ``s`` tokens; ``paged``: a block-table pool, not monolithic lanes.
    Returns a :data:`KERNEL_MODES` name.  (The JAX table also probes alibi
    biases, sliding windows and its ``paged_kernel=False`` A/B marker; the
    model features that bring the first two are not ported and raise when
    a model is built, and the port has no gather path to switch to.)"""
    if s == 1:
        return "cuda_paged_decode" if paged else "cuda_decode"
    if 1 < s <= MAX_CHUNK_S:
        return "cuda_chunked_prefill"
    return "reference_fallback"


def kernel_modes(*, paged=False):
    """Which mode each program class takes (what ``prefill_plan`` and the
    serving engine report)."""
    return {"decode": select_kernel(s=1, paged=paged),
            "prefill_chunk": select_kernel(s=2, paged=paged)}


def _write_cache(cache, layer, k_new, v_new, positions, start):
    """This step's K/V rows ``[B, S, KVH*D]`` into layer ``layer`` of the
    stacked cache, in place: a row-uniform block (``start`` an int) writes
    positions ``start .. start+S-1``; per-row positions (``start`` None:
    padded-prompt decode) scatter each row to its own positions."""
    B, S = k_new.shape[0], k_new.shape[1]
    kc, vc = cache["k"][layer], cache["v"][layer]
    S_max = kc.shape[1]
    if start is None:
        if int(positions.max()) >= S_max or int(positions.min()) < 0:
            raise ValueError(f"cache write past the cache ({S_max} "
                             f"positions); size it with required_cache_len")
        rows = torch.arange(B, device=kc.device)[:, None].expand(B, S)
        kc[rows, positions] = k_new.to(kc.dtype)
        vc[rows, positions] = v_new.to(vc.dtype)
        return
    kc[:, start:start + S] = k_new.to(kc.dtype)
    vc[:, start:start + S] = v_new.to(vc.dtype)


def _fused_decode(q, k, v, positions, cache, layer):
    """Single-token decode through K2's fused write: the kernel writes this
    step's row and attends in one launch.  Returns ``out [B, 1, H, D]``.
    (The JAX package also needs the cache length to be a multiple of 8 for
    its 8-row write stripes; this kernel writes one row and has no such
    condition.)"""
    from deepspeed_tpu_torch.ops.transformer.decode_attention import (
        decode_attention)
    lengths = (positions[:, 0] + 1).to(torch.int32)
    out, _, _ = decode_attention(q[:, 0], cache["k"], cache["v"], lengths,
                                 layer=layer, new_k=k[:, 0], new_v=v[:, 0])
    return out[:, None]


def _paged_write_and_attend(q, k, v, positions, cache, layer, start,
                            prefill):
    """The paged half of :func:`write_and_attend`: decode through K6's
    fused write, or the table-resolved write then K7."""
    from deepspeed_tpu_torch.models.transformer import _paged_write
    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa
    B, S = k.shape[0], k.shape[1]
    mode = select_kernel(s=S, paged=True)
    if prefill or mode == "reference_fallback":
        raise ValueError(
            f"a page pool takes single-token decode and chunks of 2 to "
            f"{MAX_CHUNK_S} tokens (got {S} tokens, prefill={prefill}); "
            f"serve it through ServingEngine")
    pages = cache["pages"]
    if mode == "cuda_paged_decode":
        lengths = (positions[:, 0] + 1).to(torch.int32)
        out, _, _ = pa.paged_decode_attention(
            q[:, 0], cache["k"], cache["v"], lengths, pages, layer=layer,
            new_k=k[:, 0], new_v=v[:, 0])
        return out[:, None]
    _paged_write(cache, layer, k.reshape(B, S, -1), v.reshape(B, S, -1),
                 positions, start)
    return pa.paged_chunk_prefill_attention(
        q, cache["k"], cache["v"], positions[:, 0].to(torch.int32), pages,
        layer=layer)


def write_and_attend(cfg, q, k, v, positions, cache, layer, *,
                     start=None, prefill=False):
    """Write this step's K/V rows into ``cache`` and attend.  ``cache`` is
    ``{"k", "v"}`` stacked ``[L, B, S_max, KVH*D]``, or a page pool
    ``{"k", "v"}`` ``[L, num_pages, page, KVH*D]`` with its block table
    ``"pages"`` ``[B, n_virt]``; either is updated in place.
    q [B, S, H, D], k/v [B, S, KVH, D], positions [B, S]; ``start`` is the
    block's first position when every row shares it (an int), else None.
    Returns ``out [B, S, H, D]``.

    ``prefill``: this block is a from-zero prompt, so it attends only
    within itself — causal flash over the fresh q/k/v — after the write.
    The caller sets it explicitly: chunked prefill passes False for every
    chunk, its first included, so chunk 0 attends through the chunk kernel
    as it does in the JAX package."""
    from deepspeed_tpu_torch.models.transformer import (_prefill_attention,
                                                        cached_attention)
    B, S = k.shape[0], k.shape[1]
    if "pages" in cache:
        return _paged_write_and_attend(q, k, v, positions, cache, layer,
                                       start, prefill)
    KVHD = k.shape[-2] * k.shape[-1]
    S_max = cache["k"].shape[-2]
    if start is not None and not 0 <= start <= S_max - S:
        raise ValueError(f"cache write [{start}, {start + S}) past the cache "
                         f"({S_max} positions); size it with "
                         f"required_cache_len")
    mode = select_kernel(s=S)
    if mode == "cuda_decode":
        return _fused_decode(q, k, v, positions, cache, layer)
    _write_cache(cache, layer, k.reshape(B, S, KVHD), v.reshape(B, S, KVHD),
                 positions, start)
    if prefill:
        return _prefill_attention(q, k, v, cfg)
    if mode == "cuda_chunked_prefill":
        # each row's positions are contiguous and ascending, so the kernel
        # needs only the first
        from deepspeed_tpu_torch.ops.transformer.decode_attention import (
            chunk_prefill_attention)
        return chunk_prefill_attention(q, cache["k"], cache["v"],
                                       positions[:, 0].to(torch.int32),
                                       layer=layer)
    return cached_attention(q, cache["k"], cache["v"], positions, layer=layer)
