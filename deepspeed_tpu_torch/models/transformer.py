"""Decoder-only transformer — the OPT path of the flagship model family
(port of ``deepspeed_tpu/models/transformer.py``).

PyTorch idiom around the JAX package's layouts: ``nn.Module`` layers, the
flax ``nn.scan`` over layers as a loop over an ``nn.ModuleList``, and the
KV cache kept layer-stacked ``[L, B, S_max, KVH*D]`` exactly as
``init_cache`` builds it in JAX.  Unlike JAX, the cache is updated IN
PLACE (layer ``i`` writes through ``cache["k"][i]``): PyTorch has no
donation, and a functional update would copy the whole cache per layer.

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

Config features that OPT-1.3B does not use raise ``NotImplementedError``
when a model is built (rope, alibi, GQA, post-LN, gated MLP,
``embed_proj_dim``, windows, MoE, int8 KV, remat policies other than
``nothing_saveable``, ...); ROADMAP.md lists them.
"""

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.utils.logging import logger


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
    (lambda c: c.position_embedding != "learned",
     "position_embedding other than 'learned' (rope / alibi)"),
    (lambda c: c.kv_heads != c.num_heads, "GQA (num_kv_heads != num_heads)"),
    (lambda c: not c.pre_layer_norm, "post-LN (pre_layer_norm=False)"),
    (lambda c: c.gated_mlp, "gated_mlp"),
    (lambda c: c.embed_proj_dim is not None, "embed_proj_dim"),
    (lambda c: c.attention_layers is not None,
     "attention_layers (local windows)"),
    (lambda c: c.moe_num_experts > 0, "MoE (moe_num_experts > 0)"),
    (lambda c: c.kv_cache_quant or c.decode_int8_matmuls,
     "kv_cache_quant / decode_int8_matmuls (int8 KV)"),
    (lambda c: c.rms_norm, "rms_norm"),
    (lambda c: c.parallel_residual, "parallel_residual"),
    (lambda c: c.embedding_norm, "embedding_norm"),
    (lambda c: c.fused_qkv, "fused_qkv"),
    (lambda c: c.sparse_attention is not None, "sparse_attention"),
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


def reference_attention(q, k, v, causal=True, mask=None):
    """Dense attention: the CPU path and the golden reference.  q: [B, S,
    H, D], k/v: [B, T, KVH, D]; ``mask``: optional [B, T] key-padding
    mask (1 = keep)."""
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
        logits = logits.masked_fill(~(cols <= rows)[None, None], -1e30)
    if mask is not None:
        keep = mask.to(torch.bool)[:, None, None, :]
        logits = logits.masked_fill(~keep, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _attention(q, k, v, config, mask=None):
    """Causal self-attention within q/k/v: the uncached forward, and a
    from-zero generation prefill (the JAX package's ``_prefill_attention``).
    The flash kernel (K1), or the dense reference for a single token or a
    key-padding ``mask``."""
    if config.use_flash_attention and q.shape[1] > 1 and mask is None:
        from deepspeed_tpu_torch.ops.transformer.flash_attention import (
            flash_attention)
        return flash_attention(q, k, v, causal=True)
    return reference_attention(q, k, v, causal=True, mask=mask)


def cached_attention(q, k_cache, v_cache, q_positions, layer=None):
    """Dense attention of q [B, S, H, D] at absolute positions q_positions
    [B, S] against a cache ``[B, S_max, KVH*D]`` or, with ``layer``, the
    stacked ``[L, B, S_max, KVH*D]`` cache; KV entries at positions past a
    query's own position are masked.  The ``reference_fallback`` mode of
    ``ops.transformer.registry``, which sends single tokens to the decode
    kernel (K2) and blocks of up to 512 tokens to the chunk kernel (K3)."""
    B, S, H, D = q.shape
    if layer is not None:
        k_cache, v_cache = k_cache[layer], v_cache[layer]
    S_max, KVH = k_cache.shape[-2], k_cache.shape[-1] // D
    k = k_cache.reshape(B, S_max, KVH, D).repeat_interleave(H // KVH, dim=2)
    v = v_cache.reshape(B, S_max, KVH, D).repeat_interleave(H // KVH, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q, k).float() / math.sqrt(D)
    kv_pos = torch.arange(S_max, device=q.device)
    ok = q_positions[:, None, :, None] >= kv_pos[None, None, None, :]
    logits = logits.masked_fill(~ok, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


class Attention(nn.Module):

    def __init__(self, config, device=None):
        super().__init__()
        self.config = cfg = config
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
                start=None, prefill=False):
        cfg = self.config
        dt = cfg.torch_dtype
        B, S, _ = x.shape
        H, D, KVH = cfg.num_heads, cfg.head_dim, cfg.kv_heads
        q = _linear(x, self.q_proj, dt).view(B, S, H, D)
        k = _linear(x, self.k_proj, dt).view(B, S, KVH, D)
        v = _linear(x, self.v_proj, dt).view(B, S, KVH, D)
        if cfg.attention_softmax_scale is not None:
            # every attention path divides by sqrt(D): fold any other scale
            # into q up front, as the JAX model does
            q = q * torch.tensor(cfg.attention_softmax_scale * math.sqrt(D),
                                 dtype=q.dtype)
        if cache is not None:
            from deepspeed_tpu_torch.ops.transformer.registry import (
                write_and_attend)
            out = write_and_attend(cfg, q, k, v, positions, cache, layer,
                                   start=start, prefill=prefill)
        else:
            out = _attention(q, k, v, cfg, mask=mask)
        return _linear(out.reshape(B, S, H * D), self.o_proj, dt)


class MLP(nn.Module):

    def __init__(self, config, device=None):
        super().__init__()
        self.config = cfg = config
        kw = dict(device=device, dtype=torch.float32)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.ffn_size,
                                 bias=cfg.mlp_bias_enabled, **kw)
        self.down_proj = nn.Linear(cfg.ffn_size, cfg.hidden_size,
                                   bias=cfg.mlp_bias_enabled, **kw)

    def forward(self, x):
        dt = self.config.torch_dtype
        act = _ACTIVATIONS[self.config.activation]
        return _linear(act(_linear(x, self.up_proj, dt)), self.down_proj, dt)


class Block(nn.Module):
    """Pre-LN decoder block (OPT-1.3B's layout)."""

    def __init__(self, config, device=None):
        super().__init__()
        self.config = cfg = config
        kw = dict(device=device, dtype=torch.float32)
        self.input_norm = nn.LayerNorm(cfg.hidden_size,
                                       eps=cfg.layernorm_epsilon, **kw)
        self.attn = Attention(cfg, device=device)
        self.post_attn_norm = nn.LayerNorm(cfg.hidden_size,
                                           eps=cfg.layernorm_epsilon, **kw)
        self.mlp = MLP(cfg, device=device)

    def forward(self, x, positions, mask=None, cache=None, layer=None,
                start=None, prefill=False):
        cfg = self.config
        eps = cfg.layernorm_epsilon
        normed = _layer_norm(x, self.input_norm, eps)
        x = x + self.attn(normed, positions, mask, cache, layer, start,
                          prefill)
        return x + self.mlp(_layer_norm(x, self.post_attn_norm, eps))


class Transformer(nn.Module):
    """Decoder-only LM.  ``forward(batch)`` returns the causal-LM loss
    (the JAX ``__call__``); ``logits(input_ids, mask=None)`` the logits."""

    def __init__(self, config, device="meta"):
        super().__init__()
        check_supported(config)
        self.config = cfg = config
        kw = dict(device=device, dtype=torch.float32)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.embed_positions = nn.Embedding(cfg.max_seq_len, cfg.hidden_size,
                                            **kw)
        self.layers = nn.ModuleList(Block(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = nn.LayerNorm(cfg.hidden_size,
                                       eps=cfg.layernorm_epsilon, **kw)
        self.lm_head = None if cfg.tie_word_embeddings else nn.Linear(
            cfg.hidden_size, cfg.vocab_size, bias=cfg.lm_head_bias, **kw)

    @property
    def device(self):
        return self.embed_tokens.weight.device

    @torch.no_grad()
    def init_weights(self, generator):
        """Random init from ``generator`` (a ``torch.Generator`` on the
        parameters' device): normal(0, 0.02) matrices and embeddings, zero
        biases, unit norm scales."""
        std = 0.02
        for mod in self.modules():
            if isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=generator)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()

    def hidden_states(self, input_ids, mask=None, cache=None, start_pos=0,
                      prefill=False):
        """Final-norm hidden states [B, S, h].  With ``cache`` (the
        stacked ``{"k", "v"}`` of :meth:`init_cache`), each layer writes
        its K/V rows at positions ``start_pos + arange(S)`` in place and
        attends over the cache.  ``start_pos``: an int, or a [B] tensor of
        per-row offsets (padded-prompt decode).  ``prefill``: this block is
        a from-zero prompt (start 0) that attends only within itself."""
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
        x = x + F.embedding(positions, self.embed_positions.weight).to(
            cfg.torch_dtype)
        # remat (JAX nn.remat with nothing_saveable): each block keeps only
        # its input and recomputes itself in the backward
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for i, blk in enumerate(self.layers):
            if remat:
                x = checkpoint(blk, x, positions, mask, use_reentrant=False)
            else:
                x = blk(x, positions, mask, cache, i, start, prefill)
        return _layer_norm(x, self.final_norm, cfg.layernorm_epsilon)

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
        (layer-stacked, S-major with flattened heads — the JAX layout)."""
        cfg = self.config
        shape = (cfg.num_layers, batch_size, max_len,
                 cfg.kv_heads * cfg.head_dim)
        kw = dict(dtype=dtype or cfg.torch_dtype, device=device or self.device)
        return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}


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

    sd = {"embed_tokens.weight": t(take("embed_tokens/embedding")),
          "embed_positions.weight": t(take("embed_positions/embedding")),
          "final_norm.weight": t(take("final_norm/scale")),
          "final_norm.bias": t(take("final_norm/bias"))}
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
        for proj in ("up_proj", "down_proj"):
            sd[p + f"mlp.{proj}.weight"] = t(
                layer_leaf(i, f"mlp/{proj}/kernel").T)
            if cfg.mlp_bias_enabled:
                sd[p + f"mlp.{proj}.bias"] = t(
                    layer_leaf(i, f"mlp/{proj}/bias"))
        for norm in ("input_norm", "post_attn_norm"):
            sd[p + f"{norm}.weight"] = t(layer_leaf(i, f"{norm}/scale"))
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
