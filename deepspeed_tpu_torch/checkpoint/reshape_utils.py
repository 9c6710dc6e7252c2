"""File-level shard surgery for per-rank (Megatron-style) checkpoint sets
(port of ``deepspeed_tpu/checkpoint/reshape_utils.py``; reference
``deepspeed/checkpoint/reshape_utils.py`` + ``reshape_meg_2d.py``):
merging and re-splitting tensor-parallel shard files when the target TP
degree differs from the source.

The port's own tags are global (``runtime/engine.py`` gathers every
sharded tensor on save), so they never need this; importing a TP-sharded
foreign checkpoint, or exporting one, does.  The split dim comes from the
same rules the live placement uses (``runtime/zero/partition.py``
``DEFAULT_TP_RULES``): column-parallel leaves split on their output dim,
row-parallel and vocabulary leaves on dim 0, on the JAX model's layouts
(flax paths).

Every function takes numpy arrays or torch tensors and returns the type
it was given.
"""

import numpy as np
import torch


def partition_data(data, num_partitions):
    """Split a list into contiguous near-equal chunks (reference
    ``reshape_utils.py partition_data``)."""
    parts = []
    base, rem = divmod(len(data), num_partitions)
    start = 0
    for i in range(num_partitions):
        size = base + (1 if i < rem else 0)
        parts.append(data[start:start + size])
        start += size
    return parts


def merge_tp_shards(shards, dim):
    """Concatenate per-TP-rank arrays back into the full tensor."""
    if torch.is_tensor(shards[0]):
        return shards[0] if len(shards) == 1 else torch.cat(list(shards),
                                                            dim=dim)
    if len(shards) == 1:
        return np.asarray(shards[0])
    return np.concatenate([np.asarray(s) for s in shards], axis=dim)


def split_tp_shards(array, degree, dim):
    """Split a full tensor into ``degree`` equal TP shards along ``dim``
    (each a compact copy)."""
    if not torch.is_tensor(array):
        array = np.asarray(array)
    if array.shape[dim] % degree != 0:
        raise ValueError(f"dim {dim} of shape {tuple(array.shape)} not "
                         f"divisible by tp degree {degree}")
    if torch.is_tensor(array):
        return [s.contiguous().clone()
                for s in torch.chunk(array, degree, dim=dim)]
    return [np.ascontiguousarray(s) for s in np.split(array, degree, axis=dim)]


def reshape_tp(shards, target_degree, dim):
    """source-degree shards → target-degree shards along the same dim."""
    return split_tp_shards(merge_tp_shards(shards, dim), target_degree, dim)


def infer_tp_dim(param_name, ndim, rules=None):
    """Which dim a parameter splits on for TP, or None if replicated — the
    dim the live placement (``partition.tp_spec_for``) shards for a leaf
    of ``param_name`` (a flax path) and rank ``ndim``: column-parallel →
    the output dim (the last of a 2-D kernel, the head dim ndim-2 of a
    >= 3-D one), row-parallel → the input dim 0, embeddings → the vocab
    dim 0.  Splitting on any other dim corrupts resharded weights."""
    if ndim < 2:
        return None
    from deepspeed_tpu_torch.runtime.zero.partition import (
        is_expert_stacked, tp_dim_for, tp_rule_kind)
    kind = tp_rule_kind(param_name.lower(), rules)
    if kind is None:
        return None
    dim = tp_dim_for(kind, ndim,
                     expert_stacked=is_expert_stacked(param_name, ndim))
    return dim if dim is not None and dim >= 0 else None


def _equal(a, b):
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return np.array_equal(np.asarray(a), np.asarray(b))


def reshape_flat_state_dict(flat, source_degree, target_degree, rules=None):
    """Reshape a ``{name: [shard_0 .. shard_{src-1}]}`` dict of TP shard
    lists into target-degree shard lists under the same names.  ``rules``
    overrides the name rules (``DEFAULT_TP_RULES``' format) for foreign
    naming schemes.  A leaf no rule shards must be equal on every source
    rank, or it raises: a sharded leaf the rules miss would lose data."""
    out = {}
    for name, shards in flat.items():
        if len(shards) != source_degree:
            raise ValueError(f"{name}: expected {source_degree} shards, got "
                             f"{len(shards)}")
        first = shards[0] if torch.is_tensor(shards[0]) \
            else np.asarray(shards[0])
        dim = infer_tp_dim(name, first.ndim, rules=rules)
        if dim is None:
            for i, s in enumerate(shards[1:], start=1):
                if not _equal(s, first):
                    raise ValueError(
                        f"{name}: shards 0 and {i} differ but no TP rule "
                        f"classifies this parameter; pass rules= with a "
                        f"pattern for it")
            out[name] = [first] * target_degree
        else:
            out[name] = reshape_tp(shards, target_degree, dim)
    return out
