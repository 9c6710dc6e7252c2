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
With ``remat=True`` each block runs under ``torch.utils.checkpoint``
(the JAX ``nothing_saveable`` policy), and ``loss_seq_chunks`` computes
the head and the loss one sequence chunk at a time.

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
``NotImplementedError`` when a model is built (alibi, post-LN,
``embed_proj_dim``, ``parallel_residual``, ``embedding_norm``,
``fused_qkv``, MoE, ``sequence_parallel_impl``, remat policies other than
``nothing_saveable``); ROADMAP.md lists them.  Inference engines
quantize the weights (:meth:`Transformer.quantize_weights_`, the JAX
``WeightQuantization`` on the flax layout of each weight).
"""

import math
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
    (lambda c: not c.pre_layer_norm, "post-LN (pre_layer_norm=False)"),
    (lambda c: c.embed_proj_dim is not None, "embed_proj_dim"),
    (lambda c: c.moe_num_experts > 0, "MoE (moe_num_experts > 0)"),
    (lambda c: c.parallel_residual, "parallel_residual"),
    (lambda c: c.embedding_norm, "embedding_norm"),
    (lambda c: c.fused_qkv, "fused_qkv"),
    (lambda c: c.sequence_parallel_impl is not None,
     "sequence_parallel_impl"),
    (lambda c: c.remat and c.remat_policy != "nothing_saveable",
     "remat_policy other than 'nothing_saveable'"),
)

_ACTIVATIONS = {"relu": F.relu,
                "gelu": lambda x: F.gelu(x, approximate="tanh"),
                "gelu_exact": F.gelu,
                "silu": F.silu,
                "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x)}


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
        return _linear(out.reshape(B, S, H * D), self.o_proj, dt)


class MLP(nn.Module):
    """``down(act(up(x)))``, or with ``gated_mlp`` (Llama's SwiGLU)
    ``down(act(gate(x)) * up(x))``."""

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
        if self.config.gated_mlp:
            h = act(_linear(x, self.gate_proj, dt)) * _linear(x, self.up_proj,
                                                             dt)
        else:
            h = act(_linear(x, self.up_proj, dt))
        return _linear(h, self.down_proj, dt)


class Block(nn.Module):
    """Pre-norm decoder block (OPT-1.3B's, GPT-Neo's and Llama's layout),
    layer ``layer_idx`` of the trunk."""

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
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        # rotary configs have no position table: positions enter as rope
        self.embed_positions = nn.Embedding(
            cfg.max_seq_len, cfg.hidden_size, **kw) \
            if cfg.position_embedding == "learned" else None
        self.layers = nn.ModuleList(Block(cfg, device=device, layer_idx=i)
                                    for i in range(cfg.num_layers))
        self.final_norm = _make_norm(cfg, device)
        self.lm_head = None if cfg.tie_word_embeddings else nn.Linear(
            cfg.hidden_size, cfg.vocab_size, bias=cfg.lm_head_bias, **kw)

    @property
    def device(self):
        return self.embed_tokens.weight.device

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
    def init_weights(self, generator):
        """Random init from ``generator`` (a ``torch.Generator`` on the
        parameters' device): normal(0, 0.02) matrices and embeddings, zero
        biases, unit norm scales (an RMS norm has no bias)."""
        std = 0.02
        for mod in self.modules():
            if isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=generator)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()

    def hidden_states(self, input_ids, mask=None, cache=None, start_pos=0,
                      prefill=False):
        """Final-norm hidden states [B, S, h].  With ``cache`` (the
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
        x = F.embedding(input_ids, self.embed_tokens.weight).to(cfg.torch_dtype)
        rope = None
        if self.embed_positions is not None:
            x = x + F.embedding(positions, self.embed_positions.weight).to(
                cfg.torch_dtype)
        else:
            # the rotary angles once for every layer, from the positions
            rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                               cfg.rope_dim)
        # remat (JAX nn.remat with nothing_saveable): each block keeps only
        # its input and recomputes itself in the backward
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for i, blk in enumerate(self.layers):
            if remat:
                x = checkpoint(blk, x, positions, mask, rope=rope,
                               use_reentrant=False)
            else:
                x = blk(x, positions, mask, cache, i, start, prefill, rope)
        return _norm(x, self.final_norm, cfg)

    def _head_fn(self):
        """The LM head as a closure over weights cast once to the model
        dtype (the JAX ``_head_pure``), so a chunked loss does not cast the
        [V, h] table per chunk."""
        dt = self.config.torch_dtype
        if self.lm_head is None:
            w = self.embed_tokens.weight.to(dt)
            return lambda x: x @ w.T
        w = self.lm_head.weight.to(dt)
        b = None if self.lm_head.bias is None else self.lm_head.bias.to(dt)
        return lambda x: F.linear(x.to(dt), w, b)

    def _head(self, x):
        return self._head_fn()(x)

    def logits(self, input_ids, mask=None):
        return self._head(self.hidden_states(input_ids, mask))

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
        if C > 1:
            return chunked_cross_entropy_loss(h, labels, self._head_fn(), C)
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
        return self._head(h), cache

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

    def _zero_cache(self, lead, dtype, device):
        cfg = self.config
        shape = lead + (cfg.kv_heads * cfg.head_dim,)
        device = device or self.device
        if cfg.kv_cache_quant:
            sshape = lead + (cfg.kv_heads,)
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
        if self.lm_head is not None:
            yield ("lm_head", ("lm_head/kernel", "lm_head/bias"),
                   ((h, cfg.vocab_size), (cfg.vocab_size,)))

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


def cross_entropy_loss(logits, labels, ignore_index=-100, z_loss=0.0):
    """Causal-LM loss with ignore-index masking, computed in fp32."""
    total, count, logz = _nll_sum(logits, labels, ignore_index)
    loss = total / count.clamp(min=1)
    if z_loss > 0.0:
        loss = loss + z_loss * (logz ** 2).mean()
    return loss


def chunked_cross_entropy_loss(h, labels, head_fn, n_chunks,
                               ignore_index=-100):
    """Sequence-chunked causal-LM loss: the head matmul and the loss run
    per chunk under ``torch.utils.checkpoint``, so only one chunk's
    [B, S/C, V] logits is live (forward or backward); the backward
    recomputes each chunk's logits.  Equals :func:`cross_entropy_loss`
    (sum of NLLs over the count)."""
    S = h.shape[1]
    if S % n_chunks:
        raise ValueError(f"seq_len {S} not divisible by n_chunks {n_chunks}")
    csz = S // n_chunks

    def one(hb, lb):
        total, count, _ = _nll_sum(head_fn(hb), lb, ignore_index)
        return total, count

    sums, counts = zip(*(checkpoint(one, h[:, i * csz:(i + 1) * csz],
                                    labels[:, i * csz:(i + 1) * csz],
                                    use_reentrant=False)
                         for i in range(n_chunks)))
    return torch.stack(sums).sum() / torch.stack(counts).sum().clamp(min=1)


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


def params_from_flax(tree, cfg):
    """The JAX model's parameter tree (numpy leaves) → this port's
    ``state_dict`` (float32 tensors).  Accepts the scanned layout
    (``params/layers/...`` stacked on axis 0, ``scan_layers=True``) and the
    unrolled one (``params/layers_{i}/...``).  Flax kernels are
    ``[in, out]`` and become ``nn.Linear`` weights ``[out, in]``.  Every
    leaf of the tree must be used exactly once."""
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
    sd = {"embed_tokens.weight": t(take("embed_tokens/embedding")),
          "final_norm.weight": t(take("final_norm/scale"))}
    if cfg.position_embedding == "learned":
        sd["embed_positions.weight"] = t(take("embed_positions/embedding"))
    if not rms:
        sd["final_norm.bias"] = t(take("final_norm/bias"))
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
    unused = sorted(set(flat) - used)
    if unused:
        raise ValueError(f"params_from_flax: leaves not used: {unused}")
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

    out = {"embed_tokens/embedding": get("embed_tokens.weight"),
           "final_norm/scale": get("final_norm.weight")}
    if cfg.position_embedding == "learned":
        out["embed_positions/embedding"] = get("embed_positions.weight")
    if not cfg.rms_norm:
        out["final_norm/bias"] = get("final_norm.bias")
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


def engine_state_from_flax(arrays, meta, module):
    """A JAX engine tag's restored ``arrays`` (``module`` / ``optimizer``
    / ``loss_scaler``, numpy leaves) and ``meta`` → the port's array
    groups and metadata for :meth:`DeepSpeedEngine.load_state`: the
    module's ``state_dict``, its optimizer state lists, the
    ``LossScalerState`` and the step counters / LR schedule /
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
    out = {"module": params_from_flax(arrays["module"], module.config),
           "optimizer": None if opt is None
           else opt_state_from_flax(opt, module),
           "loss_scaler": sc}
    keys = ("global_steps", "global_samples", "micro_steps",
            "skipped_steps", "lr_scheduler", "ds_config", "client_state")
    return out, {k: meta[k] for k in keys if k in meta}
