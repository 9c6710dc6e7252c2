"""SparseSelfAttention module (port of
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``).

Applies block-sparse attention under a ``SparsityConfig``: a functional
core (:class:`SparseAttentionFn`) and an ``nn.Module`` that projects
hidden → q, k, v, attends and projects back, as the JAX flax module does.
Weights of the flax module convert with :func:`params_from_flax`.
"""

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.models.transformer import _linear
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse import (
    block_sparse_attention_tables, cached_layout, cached_tables)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    SparsityConfig, FixedSparsityConfig)


class SparseAttentionFn:
    """Callable holding a config; its layouts (and their device tables)
    are cached per sequence length on the config."""

    def __init__(self, sparsity_config=None, key_padding_mask_mode="add",
                 attn_mask_mode="mul"):
        self.sparsity_config = sparsity_config or FixedSparsityConfig(num_heads=4)
        if not isinstance(self.sparsity_config, SparsityConfig):
            raise TypeError(f"sparsity_config must be a SparsityConfig, got "
                            f"{type(self.sparsity_config).__name__}")
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode

    def get_layout(self, seq_len):
        return cached_layout(self.sparsity_config, seq_len)

    def __call__(self, query, key, value, key_padding_mask=None,
                 attn_mask=None):
        """query/key/value: [B, S, H, D].  ``key_padding_mask`` [B, S]
        (1 = attend) is folded in as a key bias — see
        ``block_sparse.block_sparse_attention``."""
        B, S, H, D = query.shape
        sc = self.sparsity_config
        causal = getattr(sc, "attention", "bidirectional") == "unidirectional"
        # the layout is the one JAX caches (causal=False); the causal
        # tables drop its upper blocks
        tables = cached_tables(sc, S, H, query.device, causal=causal,
                               layout_causal=False)
        return block_sparse_attention_tables(
            query, key, value, tables, sc.block, causal=causal,
            key_padding_mask=key_padding_mask)


class SparseSelfAttention(nn.Module):
    """Projects hidden → q, k, v (``qkv``: Linear(h, 3h)), applies
    block-sparse attention, projects back (``out``: Linear(h, h)).
    Parameters are fp32; the projections compute in ``dtype``."""

    def __init__(self, hidden_size, num_heads, sparsity_config=None,
                 dtype="float32", device=None):
        super().__init__()
        self.hidden_size, self.num_heads = hidden_size, num_heads
        self.dtype = getattr(torch, dtype)
        kw = dict(device=device, dtype=torch.float32)
        self.qkv = nn.Linear(hidden_size, 3 * hidden_size, **kw)
        self.out = nn.Linear(hidden_size, hidden_size, **kw)
        self.fn = SparseAttentionFn(sparsity_config
                                    or FixedSparsityConfig(num_heads=num_heads))

    def forward(self, hidden, key_padding_mask=None):
        B, S, _ = hidden.shape
        H = self.num_heads
        D = self.hidden_size // H
        q, k, v = _linear(hidden, self.qkv, self.dtype).split(
            self.hidden_size, dim=-1)
        out = self.fn(q.reshape(B, S, H, D), k.reshape(B, S, H, D),
                      v.reshape(B, S, H, D),
                      key_padding_mask=key_padding_mask)
        return _linear(out.reshape(B, S, self.hidden_size), self.out,
                       self.dtype)


def params_from_flax(tree):
    """The flax module's params (``{"params": {"qkv": {"kernel", "bias"},
    "out": {...}}}``, numpy leaves) → :class:`SparseSelfAttention`'s
    ``state_dict``: kernels ``[in, out]`` become weights ``[out, in]``."""
    if "params" in tree:
        tree = tree["params"]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))

    return {f"{name}.{leaf}": t(np.asarray(tree[name][src]).T
                                if src == "kernel" else tree[name][src])
            for name in ("qkv", "out")
            for leaf, src in (("weight", "kernel"), ("bias", "bias"))}
