"""Coalesced collectives (port of
``deepspeed_tpu/runtime/comm/coalesced_collectives.py``, reference
``runtime/comm/coalesced_collectives.py:29``).

One collective for a list of tensors, in the JAX functions' padded flat
layout: each tensor is flattened (in its own element order — pass a
``movedim`` view to choose it) and padded to a multiple of the group's
size W, then laid out ``[W, sum(padded_i / W)]`` so that rank r's row
holds the r-th piece of every tensor.  The ZeRO engine moves its
gradient and parameter bytes through these functions a bucket at a time,
and ZeRO-3 a layer at a time: :func:`gather_params` makes a layer's
parameters whole from their shards in one all-gather, and
:func:`reduce_scatter_two_hop` reduces MiCS's gradients within the shard
group, then across the replica groups.
"""

import functools

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.comm import ReduceOp


def _widest(tensors):
    return functools.reduce(torch.promote_types,
                            [t.dtype for t in tensors])


def reduce_scatter_coalesced(tensors, group=None, op=ReduceOp.SUM,
                             reduce_dtype=None, out_dtype=None):
    """Reduce-scatter a list of tensors in ONE collective.

    Each input is this rank's full copy.  Returns a list of 1-D shards:
    this rank's piece of each tensor (flattened, padded to the group
    size), in the tensor's dtype — the JAX function's output contract —
    or in ``out_dtype``.  The reduction runs in the widest participating
    dtype, or in ``reduce_dtype``."""
    W = comm.get_world_size(group)
    acc = reduce_dtype or _widest(tensors)
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
    out = reduce_scatter_stacked(stacked, group, op)
    shards, off = [], 0
    for t, w in zip(tensors, widths):
        piece = out[off:off + w]
        want = out_dtype or t.dtype
        shards.append(piece if piece.dtype == want else piece.to(want))
        off += w
    return shards


def reduce_scatter_stacked(stacked, group=None, op=ReduceOp.SUM,
                           replica_group=None):
    """The collective of :func:`reduce_scatter_coalesced` on its layout
    given whole: ``stacked`` is ``[W, n]``, row r the pieces rank r keeps;
    returns this rank's reduced row ``[n]``.  With ``replica_group``
    (MiCS's replica group: the ranks holding the same shard) the row is
    then all-reduced across it, so ``AVG`` averages over both hops — the
    reference ``runtime/zero/mics.py``'s two-hop reduction."""
    out = stacked.new_empty(stacked.shape[1])
    comm.reduce_scatter_tensor(out, stacked.contiguous().view(-1), op=op,
                               group=group,
                               log_name="reduce_scatter_coalesced")
    if replica_group is not None and \
            comm.get_world_size(replica_group) > 1:
        comm.all_reduce(out, op=op, group=replica_group,
                        log_name="all_reduce_coalesced")
    return out


def reduce_scatter_two_hop(tensors, shard_group, replica_group=None,
                           op=ReduceOp.SUM, reduce_dtype=None,
                           out_dtype=None):
    """:func:`reduce_scatter_coalesced` within the shard group, then one
    all-reduce of the shards across MiCS's replica group (none: the
    reduce-scatter alone)."""
    shards = reduce_scatter_coalesced(tensors, shard_group, op, reduce_dtype,
                                      out_dtype)
    if replica_group is not None and \
            comm.get_world_size(replica_group) > 1:
        all_reduce_coalesced(shards, replica_group, op)
    return shards


def gather_params(shards, leaves, group=None, dtype=None, flat=None):
    """The whole tensors of ``shards`` (this rank's moved-layout shards,
    placed by ``leaves``, ``runtime/zero/partition.py``) in ``dtype``, in
    one all-gather: the shards are flattened into one buffer (``flat``
    when the caller holds them there already) and cast once, so the
    collective moves ``dtype``'s bytes.  Each whole tensor is in its own
    layout, contiguous, a view of one buffer; only the write of the
    gathered rows into it is strided (over one rank, where each leaf is
    its own shard in its own layout, the gathered buffer is the whole
    tensors and nothing is copied)."""
    if flat is None:
        flat = shards[0].reshape(-1) if len(shards) == 1 else torch.cat(
            [s.reshape(-1) for s in shards])
    if dtype is not None and flat.dtype != dtype:
        flat = flat.to(dtype)
    W, (rows,) = gathered_views([flat], group)
    sizes = [s.numel() for s in shards]
    if W == 1 and all(leaf.dim == 0 and leaf.view is None
                      for leaf in leaves):
        out, off = [], 0
        for n, leaf in zip(sizes, leaves):
            out.append(rows[0, off:off + n].view(leaf.full_shape))
            off += n
        return out
    whole = rows.new_empty(rows.numel())
    out, off = [], 0
    for n, leaf in zip(sizes, leaves):
        full = whole[W * off:W * (off + n)].view(leaf.full_shape)
        moved = leaf.moved(full).unflatten(0, (W, leaf.rows))
        moved.copy_(rows[:, off:off + n].view(W, *leaf.shard_shape))
        out.append(full)
        off += n
    return out


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
