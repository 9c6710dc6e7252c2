"""Attention-kernel registry — the one dispatch point for cached attention
(port of ``deepspeed_tpu/ops/transformer/registry.py``, monolithic caches).

* :func:`select_kernel` — the dispatch table.  Its probes read only
  shapes and config, so ``InferenceEngine.prefill_plan`` reports what the
  model will run.
* :func:`write_and_attend` — behind ``models.transformer.Attention``:
  writes this step's K/V rows into the layer-stacked cache and attends
  through the selected kernel.

Modes, probed in order:

==========================  ==============================================
``cuda_decode``             single-token decode (kernel K2, fused write)
``cuda_chunked_prefill``    multi-token block vs the cache, S <= 512 (K3)
``reference_fallback``      dense masked attention in plain PyTorch
==========================  ==============================================

The kernels exist for every device the port runs on: CUDA tensors launch
them, CPU tensors run their plain versions.  This mirrors the JAX package,
whose ``pallas_supported()`` is true on the CPU (interpret mode), so the
dispatch decisions and the ``"auto"`` chunk policy agree between the two
packages.  Paged caches are a later slice and raise.
"""

import torch

# the chunk kernel's longest block, as in the JAX package
MAX_CHUNK_S = 512

KERNEL_MODES = ("cuda_decode", "cuda_chunked_prefill", "reference_fallback")


def select_kernel(*, s, paged=False):
    """The attention-kernel decision for one cached-attention call of
    ``s`` tokens.  Returns a :data:`KERNEL_MODES` name.  (The JAX table
    also probes alibi biases and sliding windows; the model features that
    bring them are not ported and raise when a model is built.)"""
    if paged:
        raise NotImplementedError("paged KV caches are not ported to "
                                  "deepspeed_tpu_torch yet (serving slice)")
    if s == 1:
        return "cuda_decode"
    if 1 < s <= MAX_CHUNK_S:
        return "cuda_chunked_prefill"
    return "reference_fallback"


def kernel_modes(*, paged=False):
    """Which mode each program class takes (what ``prefill_plan``
    reports)."""
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


def write_and_attend(cfg, q, k, v, positions, cache, layer, *,
                     start=None, prefill=False):
    """Write this step's K/V rows into ``cache`` (``{"k", "v"}`` stacked
    ``[L, B, S_max, KVH*D]``, updated in place) and attend.  q [B, S, H, D],
    k/v [B, S, KVH, D], positions [B, S]; ``start`` is the block's first
    position when every row shares it (an int), else None.  Returns
    ``out [B, S, H, D]``.

    ``prefill``: this block is a from-zero prompt, so it attends only
    within itself — causal flash over the fresh q/k/v — after the write.
    The caller sets it explicitly: chunked prefill passes False for every
    chunk, its first included, so chunk 0 attends through the chunk kernel
    as it does in the JAX package."""
    from deepspeed_tpu_torch.models.transformer import (_attention,
                                                        cached_attention)
    B, S = k.shape[0], k.shape[1]
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
        return _attention(q, k, v, cfg)
    if mode == "cuda_chunked_prefill":
        # each row's positions are contiguous and ascending, so the kernel
        # needs only the first
        from deepspeed_tpu_torch.ops.transformer.decode_attention import (
            chunk_prefill_attention)
        return chunk_prefill_attention(q, cache["k"], cache["v"],
                                       positions[:, 0].to(torch.int32),
                                       layer=layer)
    return cached_attention(q, cache["k"], cache["v"], positions, layer=layer)
