"""Decoder-only transformer — the OPT, GPT-Neo and Llama paths of the
flagship model family (port of ``deepspeed_tpu/models/transformer.py``).

PyTorch idiom around the JAX package's layouts: ``nn.Module`` layers, the
flax ``nn.scan`` over layers as a loop over an ``nn.ModuleList``, and the
KV cache kept layer-stacked ``[L, B, S_max, KVH*D]`` exactly as
``init_cache`` builds it in JAX — or, for paged serving, a page pool
``[L, num_pages, page_size, KVH*D]`` (``init_paged_cache``) that a cache
dict carrying a block table ``"pages"`` addresses.  With
``kv_cache_quant`` either holds int8 payloads plus fp32 per-(position,
kv-head) scales ``k_scale`` / ``v_scale`` ``[L, B | num_pages, S_max |
page, KVH]``, as in JAX; ``decode_int8_matmuls`` also runs decode's two
products int8×int8.  Unlike JAX, the cache
is updated IN PLACE (layer ``i`` writes through ``cache["k"][i]``):
PyTorch has no donation, and a functional update would copy the whole
cache per layer.  The layer index travels as an argument, not as the JAX
cache dict's ``"layer"`` key.

A module is built on the ``meta`` device by default — it then holds the
architecture and no storage, like a flax module before ``init``; an
inference engine places it on its device and initialises or loads its
parameters.  Weights from the JAX package convert with
:func:`params_from_flax`.

``forward(batch)`` returns the causal-LM loss, as the JAX
``Transformer.__call__`` does; :meth:`Transformer.logits` gives logits.
With ``remat=True`` each block is a remat region under ``remat_policy``
(:func:`resolve_remat_policy`: the JAX names, the flash policies keeping
K1's output and LSE), and ``loss_seq_chunks`` computes the head and the
loss one sequence chunk at a time.

OPT-350m's published layout runs as in JAX: ``pre_layer_norm=False``
puts each norm after its residual add and drops the final norm, and
``embed_proj_dim`` makes the embedding that wide, with bias-less
``project_in`` / ``project_out`` around the trunk (the head chains
``project_out`` before the tied embedding; the two are never folded into
one [hidden, vocab] weight).

GPT-Neo's alternating global / local layers (``attention_layers``, band
``window_size``) run as in JAX: a local layer attends to the trailing
``window`` positions, dense in the uncached forward and in prefill, and
through the decode kernels' window mode once cached.

The Llama layout (``models/opt.py`` ``llama_model``) runs as in JAX:
rotary positions (:func:`_rope`: the half-split layout, the gptj
``rope_interleaved`` layout and a partial ``rope_dim``) applied to q and k
after their projections, so every cache and pool holds rotated keys; RMS
norms (:func:`_rms_norm`, flax's numerics); the gated MLP
``down(act(gate(x)) * up(x))``; fewer kv heads than query heads (GQA),
query head ``h`` reading kv head ``h // G``.  The rotation's cos / sin
come from the ``positions`` tensor on every forward, never from a table
built once, so a captured CUDA graph recomputes them on each replay.

Config features that these models do not use raise
``NotImplementedError`` when a model is built (alibi,
``parallel_residual``, ``embedding_norm``, ``fused_qkv``, MoE,
``sequence_parallel_impl``); ROADMAP.md lists them.  Inference engines
quantize the weights (:meth:`Transformer.quantize_weights_`, the JAX
``WeightQuantization`` on the flax layout of each weight).
"""

import contextlib
import contextvars
import functools
import math
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.utils import remat as ckpt
from deepspeed_tpu_torch.utils.logging import logger, warning_once


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None       # GQA; None → MHA
    ffn_hidden_size: Optional[int] = None    # None → 4*hidden
    max_seq_len: int = 2048
    activation: str = "relu"                 # relu (OPT) | gelu tanh (GPT2) | gelu_exact (neox) | silu (llama gated)
    gated_mlp: bool = False                  # llama-style SwiGLU
    position_embedding: str = "learned"      # learned (OPT/GPT) | rope (llama/neox) | alibi (bloom)
    rope_theta: float = 10000.0
    rope_dim: Optional[int] = None
    rope_interleaved: bool = False
    layernorm_epsilon: float = 1e-5
    rms_norm: bool = False                   # llama
    parallel_residual: bool = False
    shared_attn_mlp_norm: bool = False
    embedding_norm: bool = False
    attention_bias: Optional[bool] = None    # None → not rms_norm
    attention_out_bias: Optional[bool] = None
    mlp_bias: Optional[bool] = None          # None → not rms_norm
    # gpt-neo: per-layer "global" / "local" pattern and the local band;
    # requires scan_layers=False
    attention_layers: Optional[tuple] = None
    window_size: int = 256
    # None → 1/sqrt(head_dim); gpt-neo uses 1.0 (unscaled logits)
    attention_softmax_scale: Optional[float] = None
    moe_num_experts: int = 0
    moe_every: int = 2
    moe_layer_offset: int = -1
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_eval_capacity_factor: float = 1.0
    moe_ep_size: int = 1
    moe_aux_coef: float = 0.01
    moe_expert_bias: bool = False
    lm_head_bias: bool = False
    embed_proj_dim: Optional[int] = None
    pre_layer_norm: bool = True
    dropout: float = 0.0
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"
    use_flash_attention: bool = True
    fused_qkv: bool = False
    loss_seq_chunks: int = 0
    sparse_attention: Optional[object] = None
    kv_cache_quant: bool = False
    decode_int8_matmuls: bool = False
    sequence_parallel_impl: Optional[str] = None
    remat: bool = True
    remat_policy: str = "nothing_saveable"
    scan_layers: bool = True

    def __post_init__(self):
        if self.decode_int8_matmuls and not self.kv_cache_quant:
            raise ValueError("decode_int8_matmuls requires "
                             "kv_cache_quant=True (its products consume "
                             "int8 KV payloads)")
        if self.attention_layers is not None:
            if len(self.attention_layers) != self.num_layers:
                raise ValueError(
                    f"attention_layers has {len(self.attention_layers)} "
                    f"entries for {self.num_layers} layers")
            if self.scan_layers:
                raise ValueError("attention_layers (per-layer local/global "
                                 "patterns) requires scan_layers=False")

    @property
    def kv_heads(self):
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def ffn_size(self):
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def attn_bias_enabled(self):
        return self.attention_bias if self.attention_bias is not None \
            else not self.rms_norm

    @property
    def attn_out_bias_enabled(self):
        return self.attention_out_bias if self.attention_out_bias is not None \
            else self.attn_bias_enabled

    def window_for_layer(self, layer_idx):
        """Band width for this layer, or None for full (global) attention."""
        if self.attention_layers is None or layer_idx is None:
            return None
        return self.window_size \
            if self.attention_layers[layer_idx] == "local" else None

    @property
    def mlp_bias_enabled(self):
        return self.mlp_bias if self.mlp_bias is not None else not self.rms_norm

    @property
    def torch_dtype(self):
        return {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16}[self.dtype]

    def num_params(self):
        """Analytic parameter count (embeddings + blocks + final norm)."""
        h, v, l = self.hidden_size, self.vocab_size, self.num_layers
        f = self.ffn_size
        kvh = self.kv_heads * self.head_dim
        attn = h * h + h * kvh * 2 + h * h
        mlp = h * f * (3 if self.gated_mlp else 2)
        norm_size = h if self.rms_norm else 2 * h
        norms_per_layer = 1 if (self.parallel_residual
                                and self.shared_attn_mlp_norm) else 2
        per_layer = attn + mlp + norms_per_layer * norm_size
        emb = v * h + (self.max_seq_len * h
                       if self.position_embedding == "learned" else 0)
        head = 0 if self.tie_word_embeddings else v * h
        return emb + l * per_layer + norm_size + head


# config features of the JAX model that this port does not have yet:
# (predicate, what to say)
_NOT_PORTED = (
    (lambda c: c.position_embedding not in ("learned", "rope"),
     "position_embedding other than 'learned' or 'rope' (alibi)"),
    (lambda c: c.moe_num_experts > 0, "MoE (moe_num_experts > 0)"),
    (lambda c: c.parallel_residual, "parallel_residual"),
    (lambda c: c.embedding_norm, "embedding_norm"),
    (lambda c: c.fused_qkv, "fused_qkv"),
    (lambda c: c.sequence_parallel_impl is not None,
     "sequence_parallel_impl"),
)

_ACTIVATIONS = {"relu": F.relu,
                "gelu": lambda x: F.gelu(x, approximate="tanh"),
                "gelu_exact": F.gelu,
                "silu": F.silu,
                "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x)}


def resolve_remat_policy(name):
    """The op names whose outputs a remat'd block keeps under policy
    ``name`` (the JAX names and meanings):

    * the stock ``jax.checkpoint_policies`` names
      (``utils.remat.CHECKPOINT_POLICIES``): ``nothing_saveable``,
      ``everything_saveable``, ``dots_saveable`` / ``checkpoint_dots``
      (every matrix product), ``dots_with_no_batch_dims_saveable`` (the
      weight GEMMs only);
    * ``flash_only_saveable``: K1's output and LSE only (its call site
      ``FORWARD_OP``), so the backward never launches K1 again while
      every projection and MLP product is recomputed;
    * ``dots_and_attn_saveable`` = ``attn_residuals_saveable``: both the
      weight GEMMs and K1's output and LSE.

    An unknown name keeps nothing, as JAX's ``getattr`` gives None."""
    from deepspeed_tpu_torch.ops.transformer.flash_attention import (
        FORWARD_OP)
    flash = frozenset({FORWARD_OP})
    if name in ("dots_and_attn_saveable", "attn_residuals_saveable"):
        return ckpt.DOTS_NO_BATCH | flash
    if name == "flash_only_saveable":
        return flash
    return ckpt.CHECKPOINT_POLICIES.get(name, ckpt.NOTHING)


def check_supported(cfg):
    for bad, what in _NOT_PORTED:
        if bad(cfg):
            raise NotImplementedError(
                f"{what} is not ported to deepspeed_tpu_torch yet "
                f"(see ROADMAP.md)")
    if cfg.activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {cfg.activation!r}")


def _linear(x, layer, dtype):
    """``nn.Linear`` computed in ``dtype`` (flax's ``Dense(dtype=...)``:
    input, weight and bias are cast to the compute dtype)."""
    b = layer.bias
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    None if b is None else b.to(dtype))


def _col_linear(x, layer, dtype, t, lo, n, w_whole=False):
    """A column-parallel linear at tp layout ``t``: output features ``[lo,
    lo + n)`` of ``layer`` (its weight this rank's slice, or held whole
    with ``w_whole``; its bias whole with ``t.in_bias_whole``, sliced)."""
    from deepspeed_tpu_torch.parallel.tensor_parallel import slice_of_whole
    w, b = layer.weight, layer.bias
    if w_whole:
        w = slice_of_whole(w, t.tp, 0, lo, n)
    if b is not None and (w_whole or t.in_bias_whole):
        b = slice_of_whole(b, t.tp, 0, lo, n)
    return F.linear(x.to(dtype), w.to(dtype),
                    None if b is None else b.to(dtype))


def _out_linear(x, layer, dtype, t):
    """The linear closing a branch at tp layout ``t``: row-parallel (its
    weight this rank's input features; the partial products all-reduced)
    when ``t.sharded``, and its bias added once after that — gathered
    first where the rules shard it (JAX's "row" rule on a 1-D bias)."""
    from deepspeed_tpu_torch.parallel.tensor_parallel import (
        gather_from_tp, reduce_from_tp)
    if t is None:
        return _linear(x, layer, dtype)
    out = F.linear(x.to(dtype), layer.weight.to(dtype))
    if t.sharded:
        out = reduce_from_tp(out, t.tp)
    b = layer.bias
    if b is None:
        return out
    if t.out_bias_sharded:
        b = gather_from_tp(b, t.tp, 0)
    return out + b.to(dtype)


def _layer_norm(x, norm, eps):
    """LayerNorm in the activation dtype; PyTorch's kernels keep the
    statistics in fp32 for bf16 / fp16 inputs, as flax's LayerNorm does."""
    return F.layer_norm(x, x.shape[-1:], norm.weight.to(x.dtype),
                        norm.bias.to(x.dtype), eps)


def _rms_norm(x, norm, eps):
    """RMSNorm in flax's numerics (``nn.RMSNorm``, ``_normalize``): the
    mean square of ``x`` in fp32, ``rsqrt(ms + eps) * scale`` and ``x`` in
    fp32 times that; the result stays fp32 (the caller rounds it once to
    the model dtype, as the JAX block does)."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return xf * (torch.rsqrt(ms + eps) * norm.weight.float())


def _norm(x, norm, config):
    """The block's and the final norm: RMSNorm rounded to the model dtype
    for ``rms_norm`` configs, else LayerNorm."""
    if config.rms_norm:
        return _rms_norm(x, norm, config.layernorm_epsilon).to(
            config.torch_dtype)
    return _layer_norm(x, norm, config.layernorm_epsilon)


class RMSNorm(nn.Module):
    """An RMS norm's scale (flax ``nn.RMSNorm``: no bias)."""

    def __init__(self, size, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(size, device=device,
                                              dtype=torch.float32))


def _make_norm(config, device):
    if config.rms_norm:
        return RMSNorm(config.hidden_size, device=device)
    return nn.LayerNorm(config.hidden_size, eps=config.layernorm_epsilon,
                        device=device, dtype=torch.float32)


def rope_tables(positions, head_dim, theta, rope_dim=None):
    """cos / sin of the rotary angles ``[B, S, 1, rope_dim // 2]`` (fp32)
    for absolute ``positions`` [B, S], as the JAX ``_rope`` computes them:
    ``freqs = 1 / theta ** (arange(half) / half)``, angles ``positions *
    freqs`` in fp32.  Computed from the tensor on every call, so a CUDA
    graph recomputes them on each replay from the positions it reads."""
    half = (rope_dim or head_dim) // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half))
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x, cos, sin, interleaved=False):
    """Rotate the first ``2 * cos.shape[-1]`` features of each head of
    ``x`` [B, S, heads, D] (the rest pass through): the half-split layout
    (neox / llama), or with ``interleaved`` the gptj rotate-every-two one.
    Each term is computed on ``x`` promoted to fp32 and the result rounded
    once to ``x``'s dtype, as in JAX."""
    half = cos.shape[-1]
    d = 2 * half
    rx = x[..., :d].float()
    if interleaved:
        x1, x2 = rx[..., 0::2], rx[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(rx.shape)
    else:
        x1, x2 = rx[..., :half], rx[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    out = out.to(x.dtype)
    if x.shape[-1] > d:
        out = torch.cat([out, x[..., d:]], dim=-1)
    return out


def _rope(q, k, positions, head_dim, theta, rope_dim=None,
          interleaved=False):
    """Rotary position embeddings of q and k (the JAX ``_rope``, same
    signature): the half-split layout by default, ``interleaved`` the gptj
    layout, ``rope_dim`` a partial rotation (neox ``rotary_pct`` / gptj
    ``rotary_dim``)."""
    cos, sin = rope_tables(positions, head_dim, theta, rope_dim)
    return (apply_rope(q, cos, sin, interleaved),
            apply_rope(k, cos, sin, interleaved))


def reference_attention(q, k, v, causal=True, mask=None, window=None):
    """Dense attention: the CPU path and the golden reference.  q: [B, S,
    H, D], k/v: [B, T, KVH, D]; ``mask``: optional [B, T] key-padding
    mask (1 = keep); ``window``: optional band width (GPT-Neo's local
    attention: each row sees its trailing ``window`` positions only)."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    if KVH != H:
        k = k.repeat_interleave(H // KVH, dim=2)
        v = v.repeat_interleave(H // KVH, dim=2)
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
    if causal:
        rows = torch.arange(S, device=q.device)[:, None]
        cols = torch.arange(k.shape[1], device=q.device)[None, :]
        keep = cols <= rows
        if window is not None:
            keep = keep & (cols > rows - window)
        logits = logits.masked_fill(~keep[None, None], -1e30)
    if mask is not None:
        keep = mask.to(torch.bool)[:, None, None, :]
        logits = logits.masked_fill(~keep, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _prefill_attention(q, k, v, config, window=None):
    """Causal self-attention for a from-zero generation prefill: ONLY the
    flash kernel (K1) or the dense causal reference, never ``_attention``'s
    block-sparse branch.  Decode attends densely over the same cache, so
    a sparse prefill would diverge from its own decode (the JAX
    ``_prefill_attention``).  A windowed layer goes dense with its band."""
    if window is None and config.use_flash_attention and q.shape[1] > 1:
        from deepspeed_tpu_torch.ops.transformer.flash_attention import (
            flash_attention)
        return flash_attention(q, k, v, causal=True)
    return reference_attention(q, k, v, causal=True, window=window)


def _attention(q, k, v, config, mask=None, window=None):
    """Causal self-attention within q/k/v, the uncached forward: a windowed
    (GPT-Neo local) layer goes dense with its band, bypassing the kernels
    as in JAX; else block-sparse attention (K8) when the config has
    ``sparse_attention``, a 2-D key-padding ``mask`` folded in; else the
    flash kernel (K1), or the dense reference for a single token or a
    key-padding ``mask``."""
    if window is not None:
        return reference_attention(q, k, v, causal=True, mask=mask,
                                   window=window)
    sc = config.sparse_attention
    if sc is not None and q.shape[1] > 1:
        if mask is not None and mask.dim() != 2:
            # the JAX model warns and goes dense, where such a mask fails too
            raise ValueError(f"sparse_attention folds [B, S] key-padding "
                             f"masks only; got a {mask.dim()}-D mask")
        from deepspeed_tpu_torch.ops.sparse_attention.block_sparse import (
            block_sparse_attention_tables, cached_tables)
        tables = cached_tables(sc, q.shape[1], q.shape[2], q.device,
                               causal=True)
        return block_sparse_attention_tables(q, k, v, tables, sc.block,
                                             causal=True,
                                             key_padding_mask=mask)
    if config.use_flash_attention and q.shape[1] > 1 and mask is None:
        from deepspeed_tpu_torch.ops.transformer.flash_attention import (
            flash_attention)
        return flash_attention(q, k, v, causal=True)
    return reference_attention(q, k, v, causal=True, mask=mask)


def cached_attention(q, k_cache, v_cache, q_positions, layer=None,
                     k_scale=None, v_scale=None, window=None):
    """Dense attention of q [B, S, H, D] at absolute positions q_positions
    [B, S] against a cache ``[B, S_max, KVH*D]`` or, with ``layer``, the
    stacked ``[L, B, S_max, KVH*D]`` cache; KV entries at positions past a
    query's own position are masked, and with ``window`` those at or below
    its position minus ``window``.  An int8 cache (``k_scale`` /
    ``v_scale`` ``[.., S_max, KVH]``) is dequantized to q's dtype first, as
    the JAX dense path does.  The ``reference_fallback`` mode of
    ``ops.transformer.registry``, which sends single tokens to the decode
    kernel (K2) and blocks of up to 512 tokens to the chunk kernel (K3)."""
    B, S, H, D = q.shape
    if layer is not None:
        k_cache, v_cache = k_cache[layer], v_cache[layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer], v_scale[layer]
    S_max, KVH = k_cache.shape[-2], k_cache.shape[-1] // D
    k = k_cache.reshape(B, S_max, KVH, D)
    v = v_cache.reshape(B, S_max, KVH, D)
    if k_scale is not None:
        k = (k.float() * k_scale[..., None]).to(q.dtype)
        v = (v.float() * v_scale[..., None]).to(q.dtype)
    k = k.repeat_interleave(H // KVH, dim=2)
    v = v.repeat_interleave(H // KVH, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q, k).float() / math.sqrt(D)
    kv_pos = torch.arange(S_max, device=q.device)
    ok = q_positions[:, None, :, None] >= kv_pos[None, None, None, :]
    if window is not None:
        ok = ok & (kv_pos[None, None, None, :]
                   > q_positions[:, None, :, None] - window)
    logits = logits.masked_fill(~ok, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _paged_write(cache, layer, k_new, v_new, positions, start=None,
                 ks_new=None, vs_new=None):
    """Write this step's K/V rows ``[B, S, KVH*D]`` (and, for an int8
    pool, their scales ``[B, S, KVH]``) into layer ``layer`` of a PAGED
    pool through its block table ``cache["pages"] [B, n_virt]``, in place:
    virtual position ``pos`` of row ``b`` lands at pool page
    ``pages[b, pos // page]``, in-page row ``pos % page``.  ``positions``
    [B, S]: a row-uniform chunk (``start`` an int, checked against the
    table here) may span page boundaries; per-row decode positions
    (``start`` None) are the caller's to keep inside the table.  Unmapped
    virtual pages alias the reserved trash page 0, so retired lanes'
    masked writes land there (JAX ``models/transformer.py _paged_write``)."""
    from deepspeed_tpu_torch.ops.transformer.paged_attention import (
        write_pages)
    pages = cache["pages"]
    virt = pages.shape[1] * cache["k"].shape[-2]
    S = k_new.shape[1]
    if start is not None and not 0 <= start <= virt - S:
        raise ValueError(f"paged write [{start}, {start + S}) past the "
                         f"block table ({virt} virtual positions)")
    for key, rows in (("k", k_new), ("v", v_new), ("k_scale", ks_new),
                      ("v_scale", vs_new)):
        if rows is not None:
            write_pages(cache[key][layer], pages, positions, rows)


class Attention(nn.Module):
    """Self-attention of layer ``layer_idx`` (JAX ``Attention.layer_idx``),
    which picks its window (``window_for_layer``)."""

    # tensor parallelism's TPLayout of this layer (None at tp 1)
    tp = None

    def __init__(self, config, device=None, layer_idx=None):
        super().__init__()
        self.config = cfg = config
        self.layer_idx = layer_idx
        h, H, D, KVH = cfg.hidden_size, cfg.num_heads, cfg.head_dim, \
            cfg.kv_heads
        kw = dict(device=device, dtype=torch.float32)
        bias = cfg.attn_bias_enabled
        self.q_proj = nn.Linear(h, H * D, bias=bias, **kw)
        self.k_proj = nn.Linear(h, KVH * D, bias=bias, **kw)
        self.v_proj = nn.Linear(h, KVH * D, bias=bias, **kw)
        self.o_proj = nn.Linear(H * D, h, bias=cfg.attn_out_bias_enabled,
                                **kw)

    def forward(self, x, positions, mask=None, cache=None, layer=None,
                start=None, prefill=False, rope=None):
        """``rope``: the (cos, sin) of :func:`rope_tables` at
        ``positions`` for a rotary config (computed once per forward by
        the model), else None."""
        cfg = self.config
        dt = cfg.torch_dtype
        B, S, _ = x.shape
        H, D, KVH = cfg.num_heads, cfg.head_dim, cfg.kv_heads
        window = cfg.window_for_layer(self.layer_idx)
        t = self.tp
        if t is not None and t.sharded:
            # this rank's query heads [lo, lo + n) and the kv heads they
            # read, the input's gradient summed over the tp ranks
            from deepspeed_tpu_torch.parallel.tensor_parallel import (
                copy_to_tp)
            x = copy_to_tp(x, t.tp)
            H, KVH = t.n, t.kv_n
            q = _col_linear(x, self.q_proj, dt, t, t.lo * D, H * D)
            kv = (t.kv_lo * D, KVH * D, t.kv_whole)
            k = _col_linear(x, self.k_proj, dt, t, *kv)
            v = _col_linear(x, self.v_proj, dt, t, *kv)
            q, k, v = (q.view(B, S, H, D), k.view(B, S, KVH, D),
                       v.view(B, S, KVH, D))
        else:
            q = _linear(x, self.q_proj, dt).view(B, S, H, D)
            k = _linear(x, self.k_proj, dt).view(B, S, KVH, D)
            v = _linear(x, self.v_proj, dt).view(B, S, KVH, D)
        if rope is not None:
            # before the scale fold and before any cache write: every cache
            # and pool holds rotated keys (JAX Attention.__call__)
            q = apply_rope(q, *rope, cfg.rope_interleaved)
            k = apply_rope(k, *rope, cfg.rope_interleaved)
        if cfg.attention_softmax_scale is not None:
            # every attention path divides by sqrt(D): fold any other scale
            # into q up front, as the JAX model does
            q = q * torch.tensor(cfg.attention_softmax_scale * math.sqrt(D),
                                 dtype=q.dtype)
        if cache is not None:
            if cfg.sparse_attention is not None:
                # cached prefill and decode attend densely; a model trained
                # block-sparse sees another pattern at generation time
                warning_once("sparse_attention model decoding with dense "
                             "KV-cache attention — train/decode attention "
                             "patterns differ")
            from deepspeed_tpu_torch.ops.transformer.registry import (
                write_and_attend)
            out = write_and_attend(cfg, q, k, v, positions, cache, layer,
                                   start=start, prefill=prefill,
                                   window=window)
        else:
            out = _attention(q, k, v, cfg, mask=mask, window=window)
        return _out_linear(out.reshape(B, S, H * D), self.o_proj, dt, t)


class MLP(nn.Module):
    """``down(act(up(x)))``, or with ``gated_mlp`` (Llama's SwiGLU)
    ``down(act(gate(x)) * up(x))``."""

    # tensor parallelism's TPLayout of this layer (None at tp 1)
    tp = None

    def __init__(self, config, device=None):
        super().__init__()
        self.config = cfg = config
        kw = dict(device=device, dtype=torch.float32)
        if cfg.gated_mlp:
            self.gate_proj = nn.Linear(cfg.hidden_size, cfg.ffn_size,
                                       bias=cfg.mlp_bias_enabled, **kw)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.ffn_size,
                                 bias=cfg.mlp_bias_enabled, **kw)
        self.down_proj = nn.Linear(cfg.ffn_size, cfg.hidden_size,
                                   bias=cfg.mlp_bias_enabled, **kw)

    def forward(self, x):
        dt = self.config.torch_dtype
        act = _ACTIVATIONS[self.config.activation]
        t = self.tp
        lin = _linear
        if t is not None and t.sharded:
            # this rank's ffn columns [lo, lo + n)
            from deepspeed_tpu_torch.parallel.tensor_parallel import (
                copy_to_tp)
            x = copy_to_tp(x, t.tp)

            def lin(x, layer, dtype):
                return _col_linear(x, layer, dtype, t, t.lo, t.n)
        if self.config.gated_mlp:
            h = act(lin(x, self.gate_proj, dt)) * lin(x, self.up_proj, dt)
        else:
            h = act(lin(x, self.up_proj, dt))
        return _out_linear(h, self.down_proj, dt, t)


class Block(nn.Module):
    """Decoder block, layer ``layer_idx`` of the trunk: pre-norm
    (OPT-1.3B's, GPT-Neo's and Llama's layout) or, with
    ``pre_layer_norm=False``, post-norm (OPT-350m's: each norm after its
    residual add)."""

    def __init__(self, config, device=None, layer_idx=None):
        super().__init__()
        self.config = cfg = config
        self.input_norm = _make_norm(cfg, device)
        self.attn = Attention(cfg, device=device, layer_idx=layer_idx)
        self.post_attn_norm = _make_norm(cfg, device)
        self.mlp = MLP(cfg, device=device)

    def forward(self, x, positions, mask=None, cache=None, layer=None,
                start=None, prefill=False, rope=None):
        cfg = self.config
        if not cfg.pre_layer_norm:
            x = _norm(x + self.attn(x, positions, mask, cache, layer, start,
                                    prefill, rope), self.input_norm, cfg)
            return _norm(x + self.mlp(x), self.post_attn_norm, cfg)
        x = x + self.attn(_norm(x, self.input_norm, cfg), positions, mask,
                          cache, layer, start, prefill, rope)
        return x + self.mlp(_norm(x, self.post_attn_norm, cfg))


class Transformer(nn.Module):
    """Decoder-only LM.  ``forward(batch)`` returns the causal-LM loss
    (the JAX ``__call__``); ``logits(input_ids, mask=None)`` the logits."""

    def __init__(self, config, device="meta"):
        super().__init__()
        check_supported(config)
        self.config = cfg = config
        kw = dict(device=device, dtype=torch.float32)
        embed_dim = cfg.embed_proj_dim or cfg.hidden_size
        self.embed_tokens = nn.Embedding(cfg.vocab_size, embed_dim, **kw)
        # opt-350m: a narrower embedding, projected in and out of the trunk
        self.project_in = self.project_out = None
        if cfg.embed_proj_dim is not None:
            self.project_in = nn.Linear(embed_dim, cfg.hidden_size,
                                        bias=False, **kw)
            self.project_out = nn.Linear(cfg.hidden_size, embed_dim,
                                         bias=False, **kw)
        # rotary configs have no position table: positions enter as rope
        self.embed_positions = nn.Embedding(
            cfg.max_seq_len, cfg.hidden_size, **kw) \
            if cfg.position_embedding == "learned" else None
        self.layers = nn.ModuleList(Block(cfg, device=device, layer_idx=i)
                                    for i in range(cfg.num_layers))
        # post-LN blocks end in a norm: no final norm
        self.final_norm = _make_norm(cfg, device) if cfg.pre_layer_norm \
            else None
        self.lm_head = None if cfg.tie_word_embeddings else nn.Linear(
            embed_dim, cfg.vocab_size, bias=cfg.lm_head_bias, **kw)

    @property
    def device(self):
        return self.embed_tokens.weight.device

    # tensor parallelism (``parallel/tensor_parallel.py``): the group, the
    # placement of each leaf and the model's TPLayout; None at tp 1
    _tp = None
    _tp_plan = None
    _tp_layout = None
    _tp_embed = None

    def set_tensor_parallel_(self, tp, plan, layouts):
        """Take ``shard_module_``'s placement: each attention and MLP its
        layout, the model its own (the head's vocabulary, the position
        table's rows) and the input embedding's."""
        self._tp, self._tp_plan = tp, plan
        self._tp_layout, self._tp_embed = layouts[self], layouts["embed"]
        for blk in self.layers:
            blk.attn.tp, blk.mlp.tp = layouts[blk.attn], layouts[blk.mlp]
        return self

    def flax_paths(self):
        """``{parameter name: the JAX model's leaf path}`` in the unrolled
        (``scan_layers=False``) tree, ``params/`` prefix included: what
        the TP rules match, as on the JAX engine's tree."""
        out = {}
        for name, _ in self.named_parameters():
            parts = name.split(".")
            leaf = {"weight": "kernel", "bias": "bias"}[parts[-1]]
            if parts[0] == "layers":
                mod = "/".join(parts[2:-1])
                if "norm" in parts[2]:
                    leaf = "scale" if parts[-1] == "weight" else "bias"
                path = f"layers_{parts[1]}/{mod}/{leaf}"
            elif parts[0] in ("embed_tokens", "embed_positions"):
                path = f"{parts[0]}/embedding"
            elif parts[0] == "final_norm":
                path = "final_norm/" + ("scale" if parts[-1] == "weight"
                                        else "bias")
            else:
                path = f"{parts[0]}/{leaf}"
            out[name] = "params/" + path
        return out

    def replace_config_(self, config):
        """Swap in ``config`` (same architecture; e.g. ``kv_cache_quant``
        flipped) on this model and every layer, in place: the weights stay
        where they are."""
        check_supported(config)
        for mod in self.modules():
            if hasattr(mod, "config"):
                mod.config = config
        return self

    @torch.no_grad()
    def init_weights(self, generator, module=None):
        """Random init from ``generator`` (a ``torch.Generator`` on the
        parameters' device): normal(0, 0.02) matrices and embeddings, zero
        biases, unit norm scales (an RMS norm has no bias).  The draws run
        a submodule at a time in ``modules()`` order, so ``module`` (one
        submodule) takes the values the whole init gives it when every
        submodule before it was drawn first (ZeRO-3's init at birth)."""
        std = 0.02
        for mod in self.modules() if module is None else (module,):
            if isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=generator)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()

    # ZeRO-3's parameter coordinator (``runtime/zero/stage3.py``), set by a
    # stage-3 engine; None runs every unit as plain code
    _zero3 = None

    def _unit(self, name, fn, *args):
        """``fn(*args)``, the part of the model that reads the parameters of
        ZeRO-3's unit ``name`` outside a block: under a stage-3 engine its
        parameters are whole inside, and again for its backward."""
        z = self._zero3
        return fn(*args) if z is None else z.run(name, fn, *args)

    def zero3_units(self):
        """ZeRO-3's gather units in forward order: ``(name, module, owned,
        used)``, ``owned`` the parameter names whose gradients the unit
        completes, ``used`` those it reads (the tied head reads the input
        embedding).  A block is a module (its hooks gather); the input
        embeddings (``embed``), the final norm (``norm``) and the head
        (``head``) run through :meth:`_unit`."""
        def names(*mods):
            out = []
            for prefix in mods:
                mod = self.get_submodule(prefix) if prefix else None
                if mod is not None:
                    out += [f"{prefix}.{n}" for n, _ in
                            mod.named_parameters()]
            return out

        embed = names("embed_tokens",
                      *(["embed_positions"] if self.embed_positions
                        is not None else []),
                      *(["project_in"] if self.project_in is not None
                        else []))
        units = [("embed", None, embed, embed)]
        for i in range(len(self.layers)):
            own = names(f"layers.{i}")
            units.append((f"layers.{i}", self.layers[i], own, own))
        if self.final_norm is not None:
            own = names("final_norm")
            units.append(("norm", None, own, own))
        head = names(*(["project_out"] if self.project_out is not None
                       else []),
                     *(["lm_head"] if self.lm_head is not None else []))
        used = head + ([] if self.lm_head is not None
                       else ["embed_tokens.weight"])
        units.append(("head", None, head, used))
        return units

    def zero3_own_dtype_params(self):
        """The parameters the model reads in their own dtype: the embedding
        tables (an fp32 lookup whose gradient sums in fp32) and the RMS
        norms' fp32 scales.  ZeRO-3 gathers these in the module's dtype and
        every other one in the compute dtype its use casts it to."""
        return {f"{n}.weight" for n, m in self.named_modules()
                if isinstance(m, (nn.Embedding, RMSNorm))}

    def _embed(self, input_ids, positions):
        cfg = self.config
        dt = cfg.torch_dtype
        te, t = self._tp_embed, self._tp_layout
        if te is not None and te.sharded:
            from deepspeed_tpu_torch.parallel.tensor_parallel import (
                vocab_parallel_embedding)
            x = vocab_parallel_embedding(input_ids, self.embed_tokens.weight,
                                         te.lo, te.tp, dt)
        else:
            x = F.embedding(input_ids, self.embed_tokens.weight).to(dt)
        if self.project_in is not None:
            x = _linear(x, self.project_in, dt)
        if self.embed_positions is not None:
            if t is not None and t.pos_sharded:
                from deepspeed_tpu_torch.parallel.tensor_parallel import (
                    vocab_parallel_embedding)
                x = x + vocab_parallel_embedding(
                    positions, self.embed_positions.weight, t.pos_lo, t.tp,
                    dt)
            else:
                x = x + F.embedding(positions,
                                    self.embed_positions.weight).to(dt)
        return x

    def hidden_states(self, input_ids, mask=None, cache=None, start_pos=0,
                      prefill=False):
        """Final-norm hidden states [B, S, h] (the last block's output
        for a post-LN model, which has no final norm).  With ``cache`` (the
        stacked ``{"k", "v"}`` of :meth:`init_cache`, or a pool of
        :meth:`init_paged_cache` plus its block table ``"pages"``), each
        layer writes its K/V rows at positions ``start_pos + arange(S)`` in
        place and attends over the cache.  ``start_pos``: an int, or a [B] tensor of
        per-row offsets (padded-prompt decode, serving lanes, and every
        captured decode step: an int becomes a constant of a CUDA graph,
        a tensor is read on each replay; both routes write and attend the
        same bits).  ``prefill``: this block is a from-zero prompt (start
        0) that attends only within itself."""
        cfg = self.config
        B, S = input_ids.shape
        dev = input_ids.device
        steps = torch.arange(S, device=dev)
        if isinstance(start_pos, torch.Tensor) and start_pos.dim() >= 1:
            start = None
            positions = start_pos.to(dev).long()[:, None] + steps[None]
        else:
            start = int(start_pos)
            positions = (start + steps)[None].expand(B, S)
        if prefill and start != 0:
            raise ValueError("prefill=True needs start_pos == 0")
        x = self._unit("embed", self._embed, input_ids, positions)
        rope = None
        if self.embed_positions is None:
            # the rotary angles once for every layer, from the positions
            rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                               cfg.rope_dim)
        # remat (JAX nn.remat with the config's policy): each block keeps
        # its input and what the policy names, and recomputes the rest in
        # the backward
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        keep = resolve_remat_policy(cfg.remat_policy) if remat else None
        for i, blk in enumerate(self.layers):
            if remat:
                x = ckpt.remat(functools.partial(
                    blk, positions=positions, mask=mask, rope=rope), keep, x)
            else:
                x = blk(x, positions, mask, cache, i, start, prefill, rope)
        return x if self.final_norm is None else \
            self._unit("norm", _norm, x, self.final_norm, cfg)

    def _head_fn(self):
        """The LM head as a closure over weights cast once to the model
        dtype (the JAX ``_head_pure``), so a chunked loss does not cast the
        [V, h] table per chunk.  With ``embed_proj_dim``, ``project_out``
        comes first as a matmul of its own: folding it into the vocab
        weight would materialize a [hidden, vocab] matrix."""
        dt = self.config.torch_dtype
        chain = (lambda x: x)
        if self.project_out is not None:
            pw = self.project_out.weight.to(dt)
            chain = (lambda x: F.linear(x.to(dt), pw))
        t = self._tp_layout
        if t is not None and t.sharded:
            # this rank's vocabulary columns [lo, lo + n): the input's
            # gradient summed over the tp ranks
            from deepspeed_tpu_torch.parallel.tensor_parallel import (
                copy_to_tp, slice_of_whole)
            inner = chain
            chain = (lambda x: copy_to_tp(inner(x), t.tp))
        if self.lm_head is None:
            w = self.embed_tokens.weight.to(dt)
            return lambda x: chain(x) @ w.T
        w = self.lm_head.weight.to(dt)
        b = self.lm_head.bias
        if b is not None and t is not None and t.sharded:
            b = slice_of_whole(b, t.tp, 0, t.lo, t.n)
        b = None if b is None else b.to(dt)
        return lambda x: F.linear(chain(x).to(dt), w, b)

    def _head(self, x):
        """The whole vocabulary's logits (gathered over the tp ranks where
        the head is vocab-parallel)."""
        out = self._head_fn()(x)
        t = self._tp_layout
        if t is not None and t.sharded:
            from deepspeed_tpu_torch.parallel.tensor_parallel import (
                gather_from_tp)
            out = gather_from_tp(out, t.tp, -1)
        return out

    def jax_layouts(self):
        """``{parameter name: (view, unview, shape)}`` for every parameter
        the JAX model stores in another layout (``params_from_flax``):
        ``view(t)`` is that layout as a view of the port's tensor (q / k / v
        kernels ``[h, heads, D]``, o ``[heads, D, h]``, q / k / v biases
        ``[heads, D]``, dense kernels ``[in, out]``), ``unview`` the
        inverse.  ZeRO's rule runs on these layouts, so a data-parallel
        rank holds the elements of the JAX engine's shard (per-layer trees,
        ``scan_layers=False``)."""
        cfg = self.config
        h, D = cfg.hidden_size, cfg.head_dim
        out = {}
        for name, p in self.named_parameters():
            parts = name.split(".")
            if len(parts) >= 2 and parts[-3:-2] == ["attn"]:
                # a tp rank holds its own heads (the views take any count)
                proj, kind = parts[-2], parts[-1]
                t = self.get_submodule(".".join(parts[:-2])).tp
                kv = proj in ("k_proj", "v_proj")
                heads = cfg.kv_heads if kv else cfg.num_heads
                if t is not None and t.sharded and (kind == "weight" or
                                                    not t.in_bias_whole):
                    heads = heads if kv and t.kv_whole else (
                        t.kv_n if kv else t.n)
                if proj == "o_proj" and kind == "weight":
                    out[name] = (lambda w: w.t().view(-1, D, h),
                                 lambda x: x.reshape(-1, h).t(),
                                 (heads, D, h))
                elif proj != "o_proj" and kind == "weight":
                    out[name] = (lambda w: w.t().view(h, -1, D),
                                 lambda x: x.reshape(h, -1).t(),
                                 (h, heads, D))
                elif proj != "o_proj" and kind == "bias":
                    out[name] = (lambda b: b.view(-1, D),
                                 lambda x: x.reshape(-1), (heads, D))
            elif parts[-1] == "weight" and p.dim() == 2 and (
                    "mlp" in parts or parts[0] in ("lm_head", "project_in",
                                                   "project_out")):
                out[name] = (lambda w: w.t(), lambda x: x.t(),
                             tuple(reversed(p.shape)))
        return out

    def logits(self, input_ids, mask=None):
        return self._unit("head", self._head,
                          self.hidden_states(input_ids, mask))

    def forward(self, batch):
        """Causal-LM loss of ``batch``: a dict with ``input_ids`` and
        optional ``labels`` / ``attention_mask``, or a bare id tensor.
        Labels default to :func:`derive_causal_labels`."""
        if isinstance(batch, dict):
            input_ids = batch["input_ids"]
            labels = batch.get("labels")
            mask = batch.get("attention_mask")
        else:
            input_ids, labels, mask = batch, None, None
        if labels is None:
            labels = derive_causal_labels(input_ids, mask)
        C = self.config.loss_seq_chunks
        if C > 1 and input_ids.shape[1] % C != 0:
            logger.warning(
                f"loss_seq_chunks={C} does not divide seq_len="
                f"{input_ids.shape[1]} — falling back to full-logits loss "
                f"(materializes the [B,S,V] tensor)")
            C = 0
        h = self.hidden_states(input_ids, mask)
        return self._unit("head", self._loss, h, labels, C)

    def _loss(self, h, labels, C):
        t = self._tp_layout
        nll = None
        if t is not None and t.sharded:
            # vocab-parallel: each rank's logits columns, the softmax's sums
            # all-reduced
            from deepspeed_tpu_torch.parallel.tensor_parallel import (
                vocab_parallel_nll_sum)
            nll = functools.partial(vocab_parallel_nll_sum, lo=t.lo,
                                    tp=t.tp)
        if C > 1:
            return chunked_cross_entropy_loss(h, labels, self._head_fn(), C,
                                              nll_sum=nll)
        if nll is not None:
            return cross_entropy_loss(self._head_fn()(h), labels,
                                      nll_sum=nll)
        return cross_entropy_loss(self._head(h), labels)

    def decode(self, input_ids, cache, start_pos, logits_at=None,
               prefill=False):
        """KV-cached decode/prefill step: returns ``(logits, cache)`` (the
        cache is updated in place and returned for symmetry with the JAX
        API).  ``logits_at`` ([B] ints, optional) projects only those
        per-row positions through the vocab head, giving [B, 1, V]."""
        h = self.hidden_states(input_ids, cache=cache, start_pos=start_pos,
                               prefill=prefill)
        if logits_at is not None:
            rows = torch.arange(h.shape[0], device=h.device)
            h = h[rows, logits_at.to(h.device).long()][:, None]
        return self._unit("head", self._head, h), cache

    def init_cache(self, batch_size, max_len, dtype=None, device=None):
        """Zero KV cache: ``{"k", "v"}`` each [L, B, max_len, KVH*D]
        (layer-stacked, S-major with flattened heads — the JAX layout);
        with ``kv_cache_quant`` int8 payloads plus fp32 ``k_scale`` /
        ``v_scale`` [L, B, max_len, KVH]."""
        cfg = self.config
        return self._zero_cache((cfg.num_layers, batch_size, max_len),
                                dtype, device)

    def init_paged_cache(self, num_pages, page_size, dtype=None,
                         device=None):
        """Zero PAGED KV pool: ``{"k", "v"}`` each ``[L, num_pages,
        page_size, KVH*D]`` (the JAX layout; int8 plus scales ``[L,
        num_pages, page_size, KVH]`` with ``kv_cache_quant``).  Physical
        pages hold no position order: a consumer adds the block table
        ``"pages"`` ``[B, n_virt]`` (virtual page ``pos // page_size`` →
        pool page) to the dict it passes to :meth:`decode`; page 0 is the
        trash page."""
        return self._zero_cache((self.config.num_layers, int(num_pages),
                                 int(page_size)), dtype, device)

    def kv_heads_local(self):
        """The kv heads a cache of this rank holds: the config's, or the
        tp rank's where the heads are sharded."""
        t = self.layers[0].attn.tp if len(self.layers) else None
        return t.kv_n if t is not None and t.sharded else \
            self.config.kv_heads

    def _zero_cache(self, lead, dtype, device):
        cfg = self.config
        KVH = self.kv_heads_local()
        shape = lead + (KVH * cfg.head_dim,)
        device = device or self.device
        if cfg.kv_cache_quant:
            sshape = lead + (KVH,)
            kw = dict(dtype=torch.float32, device=device)
            return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=device),
                    "k_scale": torch.zeros(sshape, **kw),
                    "v_scale": torch.zeros(sshape, **kw)}
        kw = dict(dtype=dtype or cfg.torch_dtype, device=device)
        return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}

    def _flax_linears(self):
        """Each linear layer as the JAX model holds it: ``(module name,
        (kernel path, bias path), (kernel shape, bias shape))`` in the
        unrolled (``scan_layers=False``) flax tree."""
        cfg = self.config
        h, H, D, KVH = cfg.hidden_size, cfg.num_heads, cfg.head_dim, \
            cfg.kv_heads
        f = cfg.ffn_size
        per_layer = {"attn.q_proj": ((h, H, D), (H, D)),
                     "attn.k_proj": ((h, KVH, D), (KVH, D)),
                     "attn.v_proj": ((h, KVH, D), (KVH, D)),
                     "attn.o_proj": ((H, D, h), (h,)),
                     **({"mlp.gate_proj": ((h, f), (f,))}
                        if cfg.gated_mlp else {}),
                     "mlp.up_proj": ((h, f), (f,)),
                     "mlp.down_proj": ((f, h), (h,))}
        for i in range(cfg.num_layers):
            for name, shapes in per_layer.items():
                path = f"layers_{i}/" + name.replace(".", "/")
                yield (f"layers.{i}.{name}", (path + "/kernel",
                                              path + "/bias"), shapes)
        if self.project_in is not None:
            e = cfg.embed_proj_dim
            yield ("project_in", ("project_in/kernel", "project_in/bias"),
                   ((e, h), (h,)))
            yield ("project_out", ("project_out/kernel", "project_out/bias"),
                   ((h, e), (e,)))
        if self.lm_head is not None:
            e = cfg.embed_proj_dim or h
            yield ("lm_head", ("lm_head/kernel", "lm_head/bias"),
                   ((e, cfg.vocab_size), (cfg.vocab_size,)))

    @torch.no_grad()
    def quantize_weights_(self, quantizer, dtype):
        """Quantize this model's fp32 weights in place, as the JAX engine's
        ``quantize_tree`` treats the unrolled flax tree: every linear layer
        the quantizer takes becomes a
        :class:`~deepspeed_tpu_torch.runtime.weight_quantizer.
        QuantizedLinear`; every other floating tensor is cast to
        ``dtype``."""
        from deepspeed_tpu_torch.runtime.weight_quantizer import (
            QuantizedLinear)
        for name, paths, shapes in self._flax_linears():
            parent, attr = self._parent(name)
            ql = QuantizedLinear.from_linear(getattr(parent, attr), quantizer,
                                             paths, shapes, dtype)
            if ql is not None:
                setattr(parent, attr, ql)
        for p in self.parameters():
            p.data = p.data.to(dtype)

    @torch.no_grad()
    def float_weights_(self):
        """Undo :meth:`quantize_weights_`'s layout: empty fp32 linear layers
        in place of the quantized ones and every parameter in fp32, ready
        for a float ``state_dict``."""
        from deepspeed_tpu_torch.runtime.weight_quantizer import (
            QuantizedLinear)
        for name, _, _ in self._flax_linears():
            parent, attr = self._parent(name)
            mod = getattr(parent, attr)
            if isinstance(mod, QuantizedLinear):
                setattr(parent, attr, mod.float_linear())
        for p in self.parameters():
            p.data = p.data.float()

    def quantized_leaves(self):
        """``{flax path: QuantizedWeight}`` of every weight this model holds
        quantized (the unrolled flax tree's paths)."""
        from deepspeed_tpu_torch.runtime.weight_quantizer import (
            QuantizedLinear)
        out = {}
        for mod in self.modules():
            if isinstance(mod, QuantizedLinear):
                out.update(mod.quantized())
        return out

    def _parent(self, name):
        path, attr = name.rsplit(".", 1) if "." in name else ("", name)
        return self.get_submodule(path), attr


def derive_causal_labels(input_ids, attention_mask=None, ignore_index=-100):
    """Next-token labels from inputs; padded positions (mask == 0) are
    excluded so pad ids are never trained as targets."""
    labels = F.pad(input_ids[..., 1:], (0, 1), value=ignore_index)
    if attention_mask is not None:
        next_mask = F.pad(attention_mask[..., 1:], (0, 1), value=0)
        labels = torch.where(next_mask.bool(), labels,
                             torch.full_like(labels, ignore_index))
    return labels


def _nll_sum(logits, labels, ignore_index):
    """(sum of token NLLs, number of counted tokens, per-token logZ) in
    fp32."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    return ((logz - gold) * valid).sum(), valid.sum(), logz * valid


# set by the data-parallel engine around a micro step's forward: how to
# sum the valid-token count over the ranks, and their number
_TOKEN_COUNT = contextvars.ContextVar("global_token_count", default=None)


@contextlib.contextmanager
def global_token_count(reduce_fn, world):
    """Within this context the causal-LM loss is normalised by the valid
    tokens of the whole global batch, as the JAX loss is
    (``models/transformer.py``: the summed NLL over the global count):
    ``reduce_fn(count)`` sums the rank's count over the data-parallel
    group (on the device, before the backward), and each rank's loss is its
    share of the global mean times ``world`` — so the ranks' average is
    the global mean, and so is the average of their gradients, however
    unequally padding splits the tokens."""
    token = _TOKEN_COUNT.set((reduce_fn, world))
    try:
        yield
    finally:
        _TOKEN_COUNT.reset(token)


def _mean_nll(total, count):
    """``total / count``, the count summed over the data-parallel group
    under :func:`global_token_count`."""
    ctx = _TOKEN_COUNT.get()
    if ctx is None:
        return total / count.clamp(min=1)
    reduce_fn, world = ctx
    return total / reduce_fn(count).clamp(min=1) * world


def cross_entropy_loss(logits, labels, ignore_index=-100, z_loss=0.0,
                       nll_sum=None):
    """Causal-LM loss with ignore-index masking, computed in fp32.
    ``nll_sum``: the vocab-parallel ``_nll_sum`` of a tp rank's logits."""
    total, count, logz = (nll_sum or _nll_sum)(logits, labels,
                                               ignore_index=ignore_index)
    loss = _mean_nll(total, count)
    if z_loss > 0.0:
        loss = loss + z_loss * (logz ** 2).mean()
    return loss


def chunked_cross_entropy_loss(h, labels, head_fn, n_chunks,
                               ignore_index=-100, nll_sum=None):
    """Sequence-chunked causal-LM loss: the head matmul and the loss run
    per chunk under ``torch.utils.checkpoint``, so only one chunk's
    [B, S/C, V] logits is live (forward or backward); the backward
    recomputes each chunk's logits.  Equals :func:`cross_entropy_loss`
    (sum of NLLs over the count)."""
    S = h.shape[1]
    if S % n_chunks:
        raise ValueError(f"seq_len {S} not divisible by n_chunks {n_chunks}")
    csz = S // n_chunks

    nll_sum = nll_sum or _nll_sum

    def one(hb, lb):
        total, count, _ = nll_sum(head_fn(hb), lb, ignore_index=ignore_index)
        return total, count

    sums, counts = zip(*(checkpoint(one, h[:, i * csz:(i + 1) * csz],
                                    labels[:, i * csz:(i + 1) * csz],
                                    use_reentrant=False)
                         for i in range(n_chunks)))
    return _mean_nll(torch.stack(sums).sum(), torch.stack(counts).sum())


# --------------------------------------------------------------------- #
# Weight carry-over from the JAX package
# --------------------------------------------------------------------- #
def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict) or hasattr(val, "items"):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def params_from_flax(tree, cfg, unused="raise"):
    """The JAX model's parameter tree (numpy leaves) → this port's
    ``state_dict`` (float32 tensors).  Accepts the scanned layout
    (``params/layers/...`` stacked on axis 0, ``scan_layers=True``) and the
    unrolled one (``params/layers_{i}/...``).  Flax kernels are
    ``[in, out]`` and become ``nn.Linear`` weights ``[out, in]``.  Every
    leaf of the tree must be used exactly once; with ``unused="warn"`` (an
    HF conversion, as the JAX ``_materialize``) a leaf no parameter takes
    only warns."""
    check_supported(cfg)
    if "params" in tree:
        tree = tree["params"]
    flat = _flatten(tree)
    used = set()

    def take(path):
        if path not in flat:
            raise KeyError(f"params_from_flax: missing {path!r}")
        if path in used:
            raise ValueError(f"params_from_flax: {path!r} used twice")
        used.add(path)
        return flat[path]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))

    L, h = cfg.num_layers, cfg.hidden_size
    stacked = any(k.startswith("layers/") for k in flat)

    stacked_leaves = {}

    def layer_leaf(i, name):
        if not stacked:
            return take(f"layers_{i}/{name}")
        if name not in stacked_leaves:     # one leaf, sliced L times
            stacked_leaves[name] = take(f"layers/{name}")
        return stacked_leaves[name][i]

    rms = cfg.rms_norm                   # RMS norms: a scale, no bias
    sd = {"embed_tokens.weight": t(take("embed_tokens/embedding"))}
    if cfg.pre_layer_norm:               # post-LN has no final norm
        sd["final_norm.weight"] = t(take("final_norm/scale"))
        if not rms:
            sd["final_norm.bias"] = t(take("final_norm/bias"))
    if cfg.embed_proj_dim is not None:
        for proj in ("project_in", "project_out"):
            sd[f"{proj}.weight"] = t(take(f"{proj}/kernel").T)
    if cfg.position_embedding == "learned":
        sd["embed_positions.weight"] = t(take("embed_positions/embedding"))
    for i in range(L):
        p = f"layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj"):
            kern = layer_leaf(i, f"attn/{proj}/kernel")       # [h, H, D]
            sd[p + f"attn.{proj}.weight"] = t(kern.reshape(h, -1).T)
            if cfg.attn_bias_enabled:
                sd[p + f"attn.{proj}.bias"] = t(
                    layer_leaf(i, f"attn/{proj}/bias").reshape(-1))
        kern = layer_leaf(i, "attn/o_proj/kernel")            # [H, D, h]
        sd[p + "attn.o_proj.weight"] = t(kern.reshape(-1, h).T)
        if cfg.attn_out_bias_enabled:
            sd[p + "attn.o_proj.bias"] = t(layer_leaf(i, "attn/o_proj/bias"))
        for proj in ("gate_proj",) * cfg.gated_mlp + ("up_proj",
                                                      "down_proj"):
            sd[p + f"mlp.{proj}.weight"] = t(
                layer_leaf(i, f"mlp/{proj}/kernel").T)
            if cfg.mlp_bias_enabled:
                sd[p + f"mlp.{proj}.bias"] = t(
                    layer_leaf(i, f"mlp/{proj}/bias"))
        for norm in ("input_norm", "post_attn_norm"):
            sd[p + f"{norm}.weight"] = t(layer_leaf(i, f"{norm}/scale"))
            if not rms:
                sd[p + f"{norm}.bias"] = t(layer_leaf(i, f"{norm}/bias"))
    if not cfg.tie_word_embeddings:
        sd["lm_head.weight"] = t(take("lm_head/kernel").T)
        if cfg.lm_head_bias:
            sd["lm_head.bias"] = t(take("lm_head/bias"))
    left = sorted(set(flat) - used)
    if left and unused == "warn":
        logger.warning(f"conversion produced unused tensors: {left}")
    elif left:
        raise ValueError(f"params_from_flax: leaves not used: {left}")
    if stacked:
        bad = [k for k, v in flat.items()
               if k.startswith("layers/") and v.shape[0] != L]
        if bad:
            raise ValueError(f"params_from_flax: stacked leaves without "
                             f"{L} layers: {bad}")
    logger.debug(f"params_from_flax: {len(sd)} tensors from {len(flat)} "
                 f"leaves")
    return sd


@torch.no_grad()
def params_to_flax(state_dict, cfg, dtype=None):
    """The inverse of :func:`params_from_flax`: this port's ``state_dict``
    → ``{flax path: CPU tensor}`` with the JAX model's keys (without the
    ``params/`` collection prefix, as the JAX ``save_16bit_model`` writes
    them) and layouts — stacked ``layers/...`` leaves with
    ``cfg.scan_layers``, ``layers_{i}/...`` otherwise; ``nn.Linear``
    weights ``[out, in]`` become flax kernels ``[in, ...]``.  Floating
    tensors are cast to ``dtype`` when it is given."""
    check_supported(cfg)
    L, h, H, KVH = cfg.num_layers, cfg.hidden_size, cfg.num_heads, \
        cfg.kv_heads
    D = cfg.head_dim
    used = set()

    def get(name):
        if name not in state_dict:
            raise KeyError(f"params_to_flax: missing {name!r}")
        used.add(name)
        t = state_dict[name].detach().to("cpu")
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t

    out = {"embed_tokens/embedding": get("embed_tokens.weight")}
    if cfg.pre_layer_norm:
        out["final_norm/scale"] = get("final_norm.weight")
        if not cfg.rms_norm:
            out["final_norm/bias"] = get("final_norm.bias")
    if cfg.embed_proj_dim is not None:
        for proj in ("project_in", "project_out"):
            out[f"{proj}/kernel"] = get(f"{proj}.weight").T.contiguous()
    if cfg.position_embedding == "learned":
        out["embed_positions/embedding"] = get("embed_positions.weight")
    layer = {}                  # flax leaf name -> [one tensor per layer]

    def put(name, t):
        layer.setdefault(name, []).append(t)

    for i in range(L):
        p = f"layers.{i}."
        for proj, heads in (("q_proj", H), ("k_proj", KVH), ("v_proj", KVH)):
            put(f"attn/{proj}/kernel",
                get(p + f"attn.{proj}.weight").T.reshape(h, heads, D))
            if cfg.attn_bias_enabled:
                put(f"attn/{proj}/bias",
                    get(p + f"attn.{proj}.bias").reshape(heads, D))
        put("attn/o_proj/kernel", get(p + "attn.o_proj.weight").T.reshape(
            H, D, h))
        if cfg.attn_out_bias_enabled:
            put("attn/o_proj/bias", get(p + "attn.o_proj.bias"))
        for proj in ("gate_proj",) * cfg.gated_mlp + ("up_proj",
                                                      "down_proj"):
            put(f"mlp/{proj}/kernel", get(p + f"mlp.{proj}.weight").T)
            if cfg.mlp_bias_enabled:
                put(f"mlp/{proj}/bias", get(p + f"mlp.{proj}.bias"))
        for norm in ("input_norm", "post_attn_norm"):
            put(f"{norm}/scale", get(p + f"{norm}.weight"))
            if not cfg.rms_norm:
                put(f"{norm}/bias", get(p + f"{norm}.bias"))
    for name, ts in layer.items():
        if cfg.scan_layers:
            out[f"layers/{name}"] = torch.stack(ts)
        else:
            out.update({f"layers_{i}/{name}": t.contiguous()
                        for i, t in enumerate(ts)})
    if not cfg.tie_word_embeddings:
        out["lm_head/kernel"] = get("lm_head.weight").T.contiguous()
        if cfg.lm_head_bias:
            out["lm_head/bias"] = get("lm_head.bias")
    unused = sorted(set(state_dict) - used)
    if unused:
        raise ValueError(f"params_to_flax: tensors not used: {unused}")
    return out


def opt_state_from_flax(opt_state, module):
    """The JAX optimizer's state (a NamedTuple such as ``AdamState``, or
    the dict an Orbax restore gives for one, whose fields are parameter
    trees of numpy arrays or ``None``) → ``{field: [tensor, ...]}`` with
    each list in ``engine.params`` order (the module's trainable
    ``named_parameters``): what the port's engine holds under the same
    field names.  Moment trees map through :func:`params_from_flax`: the
    layout change is linear."""
    fields = dict(opt_state) if isinstance(opt_state, Mapping) \
        else opt_state._asdict()
    names = [n for n, p in module.named_parameters() if p.requires_grad]

    def field(tree):
        if tree is None:
            return None
        sd = params_from_flax(tree, module.config)
        return [sd[n] for n in names]

    return {name: field(tree) for name, tree in fields.items()}


def offload_state_from_flax(state, module):
    """The JAX ``HostOffloadedAdam``'s host state with its per-leaf lists
    put back into parameter trees (``{"step", "masters", "exp_avg",
    "exp_avg_sq"}``, trees of numpy arrays) → the port's
    ``HostOffloadedAdam.state_dict()`` form: flat fp32 tensors in
    ``engine.params`` order.  The layout change is linear, so the moments
    map like the masters."""
    names = [n for n, p in module.named_parameters() if p.requires_grad]
    out = {"step": int(state["step"])}
    for key in ("masters", "exp_avg", "exp_avg_sq"):
        sd = params_from_flax(state[key], module.config)
        out[key] = [sd[n].reshape(-1) for n in names]
    return out


def engine_state_from_flax(arrays, meta, module):
    """A JAX engine tag's restored ``arrays`` (``module`` / ``optimizer``
    / ``loss_scaler``, numpy leaves; ``host_optimizer``, an offload
    engine's host state as trees, see :func:`offload_state_from_flax`) and
    ``meta`` → the port's array groups and metadata for
    :meth:`DeepSpeedEngine.load_state`: the module's ``state_dict``, its
    optimizer state lists, the host state, the ``LossScalerState`` and the
    step counters / LR schedule /
    ``client_state`` (``rng_key_data`` is dropped: the port's engine draws
    no random numbers after init)."""
    from deepspeed_tpu_torch.runtime.fp16.loss_scaler import LossScalerState
    sc = arrays.get("loss_scaler")
    if sc is not None:
        sc = sc if isinstance(sc, Mapping) else sc._asdict()
        sc = LossScalerState(
            scale=torch.tensor(np.asarray(sc["scale"]), dtype=torch.float32),
            good_steps=torch.tensor(np.asarray(sc["good_steps"]),
                                    dtype=torch.int32),
            hysteresis=torch.tensor(np.asarray(sc["hysteresis"]),
                                    dtype=torch.int32))
    opt = arrays.get("optimizer")
    host = arrays.get("host_optimizer")
    out = {"module": params_from_flax(arrays["module"], module.config),
           "optimizer": None if opt is None
           else opt_state_from_flax(opt, module),
           "loss_scaler": sc}
    if host is not None:
        out["host_optimizer"] = offload_state_from_flax(host, module)
    keys = ("global_steps", "global_samples", "micro_steps",
            "skipped_steps", "lr_scheduler", "ds_config", "client_state")
    return out, {k: meta[k] for k in keys if k in meta}
