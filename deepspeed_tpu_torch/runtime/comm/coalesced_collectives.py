"""Coalesced collectives (port of
``deepspeed_tpu/runtime/comm/coalesced_collectives.py``, reference
``runtime/comm/coalesced_collectives.py:29``).

One collective for a list of tensors, in the JAX functions' padded flat
layout: each tensor is flattened (in its own element order — pass a
``movedim`` view to choose it) and padded to a multiple of the group's
size W, then laid out ``[W, sum(padded_i / W)]`` so that rank r's row
holds the r-th piece of every tensor.  The ZeRO engine moves its
gradient and parameter bytes through these functions a bucket at a time.
"""

import functools

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.comm import ReduceOp


def _widest(tensors):
    return functools.reduce(torch.promote_types,
                            [t.dtype for t in tensors])


def reduce_scatter_coalesced(tensors, group=None, op=ReduceOp.SUM):
    """Reduce-scatter a list of tensors in ONE collective.

    Each input is this rank's full copy.  Returns a list of 1-D shards:
    this rank's piece of each tensor (flattened, padded to the group
    size), in the tensor's dtype — the JAX function's output contract.
    The reduction runs in the widest participating dtype."""
    W = comm.get_world_size(group)
    acc = _widest(tensors)
    parts, widths = [], []
    for t in tensors:
        flat = t.reshape(-1)
        n = flat.numel()
        p = -(-n // W) * W
        if flat.dtype != acc:
            flat = flat.to(acc)
        if p != n:
            flat = torch.cat([flat, flat.new_zeros(p - n)])
        parts.append(flat.view(W, p // W))
        widths.append(p // W)
    stacked = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    stacked = stacked.contiguous()
    out = stacked.new_empty(sum(widths))
    comm.reduce_scatter_tensor(out, stacked.view(-1), op=op, group=group,
                               log_name="reduce_scatter_coalesced")
    shards, off = [], 0
    for t, w in zip(tensors, widths):
        piece = out[off:off + w]
        shards.append(piece if piece.dtype == t.dtype else piece.to(t.dtype))
        off += w
    return shards


def all_gather_coalesced(shards, group=None):
    """Inverse companion: one all-gather for a list of per-rank 1-D
    shards; returns each tensor's full flat (padded) buffer, rank r's
    piece at ``[r * w, (r + 1) * w)``.  ``gathered_views`` gives the same
    without the final copies."""
    W, views = gathered_views(shards, group)
    return [v.reshape(-1) for v in views]


def gathered_views(shards, group=None):
    """``(W, views)``: one all-gather of the 1-D ``shards`` (one dtype);
    ``views[i]`` is ``[W, len(shards[i])]``, row r rank r's shard i (a view
    of the gathered buffer, so a caller copies each tensor out once)."""
    W = comm.get_world_size(group)
    flat = shards[0] if len(shards) == 1 else torch.cat(list(shards))
    gathered = flat.new_empty(W * flat.numel())
    comm.all_gather_into_tensor(gathered, flat.contiguous(), group=group,
                                log_name="all_gather_coalesced")
    rows = gathered.view(W, flat.numel())
    views, off = [], 0
    for s in shards:
        views.append(rows[:, off:off + s.numel()])
        off += s.numel()
    return W, views


def all_reduce_coalesced(tensors, group=None, op=ReduceOp.SUM):
    """All-reduce a list of tensors (one dtype) in ONE collective over a
    flat copy, written back into each tensor in place; returns the
    list."""
    flat = torch.cat([t.reshape(-1) for t in tensors]) if len(tensors) > 1 \
        else tensors[0].reshape(-1).clone()
    comm.all_reduce(flat, op=op, group=group,
                    log_name="all_reduce_coalesced")
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view(t.shape))
        off += n
    return tensors
