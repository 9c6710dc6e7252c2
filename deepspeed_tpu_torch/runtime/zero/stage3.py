"""ZeRO-3's parameter coordinator: the parameters live as shards and are
made whole a unit at a time, where the model reads them (the port's
``partitioned_param_coordinator``; the JAX package lets XLA insert these
gathers, ``deepspeed_tpu/runtime/zero/partition.py:17-20``).

A *unit* is a part of the model that reads a set of parameters: a block
(an ``nn.Module``, gathered by forward hooks), or the input embeddings,
the final norm and the head, which the model runs through its ``_unit``
call (``models.transformer.Transformer.zero3_units``).  Between uses a
sharded parameter holds no storage (``p.data`` is an empty tensor) and
its rank's shard (the master, in the moved layout of
``runtime/zero/partition.py``) lives in the engine.

- **Forward.**  Before a unit runs, its sharded parameters are gathered in
  one all-gather a dtype (:func:`gather_params`) and written into
  ``p.data``; after it, they are released.  Each output that needs a
  gradient passes through an identity whose backward gathers the unit
  again before the unit's own backward.
- **Gather dtype.**  A leaf the model casts to the compute dtype where it
  reads it is gathered in the compute dtype, so the cast is a no-op and
  what autograd saves is the parameter itself, whose storage the hooks
  swap: a gathered weight never stays alive as a saved cast.  A leaf the
  model reads in its own dtype (an embedding table, whose lookup and
  gradient sum run in fp32; an RMS norm's fp32 scale) is gathered in the
  master dtype, so the numerics are the engine's without a group.
- **Backward.**  When every parameter a unit owns has its gradient
  (``register_post_accumulate_grad_hook``), the unit's parameters are
  released and its gradients reduce-scattered, in one collective, into
  the unit's flat gradient shard (summed over the window in the
  accumulation dtype); the whole gradients are freed.  Units are reduced
  in one fixed order (the reverse of the forward), whatever order
  autograd's hooks fire in, so every rank issues the same collectives.  A
  recompute inside the backward (a remat region) gathers through the same
  hooks and releases nothing until the unit's gradients are in.
- **Buffers.**  Each unit's master shards are one flat buffer (the
  entries of ``masters`` become views of it), grouped by gather dtype: a
  gather casts a slice of it once and sends it, and the gathered rows are
  written into one buffer the unit's whole parameters view.  Over one
  rank each leaf is its own shard in its own layout: the gathered buffer
  is the parameters, and nothing is copied.
- **The tied embedding** is owned by the input unit and read again by the
  head: it is gathered once for each use in the forward.  The head's
  backward gathers it only when the compute dtype is its gather dtype
  (then autograd saved the parameter itself); under bf16 the head saved
  its bf16 copy, and the table is gathered again only for the input
  embedding's backward.
"""

import functools
import weakref

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.runtime.comm.coalesced_collectives import (
    gather_params, reduce_scatter_stacked)


def in_backward():
    """Whether autograd is running a backward on this thread (a remat
    region's recompute runs inside one)."""
    return torch._C._current_graph_task_id() != -1


class _GatherForBackward(torch.autograd.Function):
    """Identity on a unit's outputs; its backward gathers the unit before
    the unit's own backward runs."""

    @staticmethod
    def forward(ctx, coord, unit, *outs):
        ctx.coord, ctx.unit = coord, unit
        return tuple(o.view_as(o) for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.coord.fetch(ctx.unit, backward=True)
        return (None, None, *grads)


def _weak_hook(ref, name, *args):
    """A tensor hook that calls ``ref()``'s method ``name`` while the object
    lives: a strong reference from a parameter's hook back to its owner
    would be a cycle that Python's collector cannot see (the hook is held
    in C++), and the owner would never be freed."""
    obj = ref()
    if obj is not None:
        getattr(obj, name)(*args)


class ZeroParamCoordinator:
    """The gathers, releases and reductions of a stage-3 engine's module.

    ``params``: the module's trained parameters, in the engine's order,
    with their ``names``; ``leaves``: their stage-3 placements;
    ``masters``: each sharded leaf's shard (None where the leaf stays
    whole; repacked into each unit's flat buffer, the list's entries
    becoming views of it); ``gather_dtypes``: the dtype each sharded leaf
    is gathered in; ``group`` / ``replica_group``: the shard group and
    MiCS's replica group; ``reduce_dtype`` / ``accum_dtype``: the dtypes a
    gradient is reduced in and summed over a window in; ``whole_fn(idx)``:
    the engine's all-reduce of whole leaves' ``.grad``; ``shard_fn(i,
    t)``: hands the engine parameter ``i``'s window gradient shard."""

    def __init__(self, model, names, params, leaves, masters, gather_dtypes,
                 compute_dtype, group, whole_fn, shard_fn, reduce_dtype,
                 accum_dtype, replica_group=None):
        self.model = model
        self.params = params
        self.leaves = leaves
        self.masters = masters
        self.gather_dtypes = gather_dtypes
        self.compute_dtype = compute_dtype
        self.group = group
        self.replica_group = replica_group
        self.world = comm.get_world_size(group)
        self.whole_fn = whole_fn
        self.shard_fn = shard_fn
        self.reduce_dtype = reduce_dtype
        self.accum_dtype = accum_dtype
        index = {n: i for i, n in enumerate(names)}
        units = model.zero3_units()
        self.names = [u[0] for u in units]
        self.unit_of = {name: k for k, name in enumerate(self.names)}
        self.owned = [[index[n] for n in u[2] if n in index] for u in units]
        self.used = [[index[n] for n in u[3] if n in index] for u in units]
        self.owner = {i: k for k, own in enumerate(self.owned) for i in own}
        missing = [n for n in names if index[n] not in self.owner]
        if missing:
            raise ValueError(f"ZeRO-3: parameters in no unit of "
                             f"{type(model).__name__}: {missing}")
        # the order units are reduced in: the reverse of the forward's
        self.order = list(reversed(range(len(units))))
        self.sharded = [leaf.sharded for leaf in leaves]
        self.full = [not s for s in self.sharded]
        self.pinned = [False] * len(params)   # held by GatheredParameters
        self._empty = [None if not s else torch.empty(
            0, dtype=gather_dtypes[i], device=masters[i].device)
            for i, s in enumerate(self.sharded)]
        self._pack()
        self.grad_flat = [None] * len(units)
        self.active = False
        self.stats = {"units_gathered_forward": 0,
                      "units_gathered_backward": 0, "gathers": 0,
                      "gathered_bytes": 0, "units_reduced": 0}
        self._hooks = []
        for k, (name, mod, _, _) in enumerate(units):
            if mod is not None:
                self._hooks.append(mod.register_forward_pre_hook(
                    functools.partial(self._pre_hook, k)))
                self._hooks.append(mod.register_forward_hook(
                    functools.partial(self._post_hook, k)))
        me = weakref.ref(self)
        for i, p in enumerate(params):
            self._hooks.append(p.register_post_accumulate_grad_hook(
                functools.partial(_weak_hook, me, "_grad_ready", i)))
        for i in range(len(params)):
            if self.sharded[i]:
                self._release(i)
        # every module that runs units of its own (its ``_unit`` call)
        self._owners = [m for m in model.modules()
                        if hasattr(type(m), "_zero3")]
        for m in self._owners:
            m._zero3 = self

    @torch.no_grad()
    def _pack(self):
        """Each unit's sharded masters into one flat buffer, grouped by
        gather dtype; ``split[k]`` is that order, which the unit's
        gradient shards follow too."""
        self.split = []
        self.where = {}             # i -> (unit, offset, numel)
        self._flat = []
        for k, own in enumerate(self.owned):
            idx = [i for i in own if self.sharded[i]]
            rank = {}
            for i in idx:
                rank.setdefault(self.gather_dtypes[i], len(rank))
            idx.sort(key=lambda i: rank[self.gather_dtypes[i]])
            self.split.append(idx)
            if not idx:
                self._flat.append(None)
                continue
            n = sum(self.masters[i].numel() for i in idx)
            m0 = self.masters[idx[0]]
            flat = torch.empty(n, dtype=m0.dtype, device=m0.device)
            off = 0
            for i in idx:
                m = self.masters[i]
                view = flat[off:off + m.numel()]
                view.copy_(m.reshape(-1))
                self.masters[i] = view.view(m.shape)
                self.where[i] = (k, off, m.numel())
                off += m.numel()
            self._flat.append(flat)

    def _flat_of(self, idx):
        """The masters of ``idx`` as one flat tensor: a slice of their
        unit's buffer when they lie there in this order, else None."""
        k, start, _ = self.where[idx[0]]
        end = start
        for i in idx:
            ki, oi, ni = self.where[i]
            if ki != k or oi != end:
                return None
            end += ni
        return self._flat[k][start:end]

    # ------------------------------------------------------------------ #
    # gather / release
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def fetch(self, k, backward=False):
        """Make unit ``k``'s sharded parameters whole: one all-gather for
        each gather dtype among them.  For a backward, a parameter another
        unit owns is gathered only if the unit reads it in the compute
        dtype (autograd then saved the parameter itself)."""
        todo = [i for i in self.used[k] if not self.full[i]]
        if backward:
            todo = [i for i in todo if self.owner[i] == k or
                    self.gather_dtypes[i] == self.compute_dtype]
        if not todo:
            return
        by_dtype = {}
        for i in todo:
            by_dtype.setdefault(self.gather_dtypes[i], []).append(i)
        for dtype, idx in by_dtype.items():
            idx.sort(key=lambda i: self.where[i])
            fulls = gather_params([self.masters[i] for i in idx],
                                  [self.leaves[i] for i in idx], self.group,
                                  dtype, flat=self._flat_of(idx))
            for i, f in zip(idx, fulls):
                self.params[i].data = f
                self.full[i] = True
                self.stats["gathered_bytes"] += f.numel() * f.element_size()
            self.stats["gathers"] += 1
        self.stats["units_gathered_backward" if backward or in_backward()
                   else "units_gathered_forward"] += 1

    def _release(self, i):
        if self.sharded[i] and self.full[i] and not self.pinned[i]:
            self.params[i].data = self._empty[i]
            self.full[i] = False

    def release(self, k):
        for i in self.used[k]:
            self._release(i)

    def _wrap(self, k, out):
        """``out`` with each tensor that needs a gradient passed through
        :class:`_GatherForBackward` of unit ``k``."""
        tensors = out if isinstance(out, tuple) else (out,)
        pos = [j for j, t in enumerate(tensors)
               if torch.is_tensor(t) and t.requires_grad]
        if not pos:
            return out
        wrapped = _GatherForBackward.apply(self, k,
                                           *[tensors[j] for j in pos])
        new = list(tensors)
        for j, w in zip(pos, wrapped):
            new[j] = w
        return tuple(new) if isinstance(out, tuple) else new[0]

    def run(self, name, fn, *args):
        """``fn(*args)`` as unit ``name`` (the model's ``_unit`` call)."""
        k = self.unit_of[name]
        self.fetch(k)
        try:
            out = fn(*args)
        finally:
            if not in_backward():
                self.release(k)
        return out if in_backward() else self._wrap(k, out)

    def _pre_hook(self, k, module, args):
        self.fetch(k)

    def _post_hook(self, k, module, args, out):
        if in_backward():
            # a recompute: the unit's backward reads these parameters
            return None
        self.release(k)
        return self._wrap(k, out)

    # ------------------------------------------------------------------ #
    # the backward's reductions, in a fixed unit order
    # ------------------------------------------------------------------ #
    def begin_backward(self):
        self.active = True
        self._missing = [sum(self.params[i].requires_grad for i in own)
                         for own in self.owned]
        self._done = [m == 0 for m in self._missing]
        self._next = 0

    def _grad_ready(self, i, p):
        if not self.active:
            return
        k = self.owner[i]
        self._missing[k] -= 1
        if self._missing[k] == 0:
            self._complete(k)

    def _complete(self, k):
        self._done[k] = True
        for i in self.owned[k]:
            self._release(i)
        self._drain()

    def _drain(self):
        while self._next < len(self.order) and \
                self._done[self.order[self._next]]:
            self._reduce(self.order[self._next])
            self._next += 1

    @torch.no_grad()
    def _reduce(self, k):
        """Unit ``k``'s gradients into the window's shards: the sharded
        ones in one reduce-scatter (averaging; within MiCS's shard group,
        then across its replica group) of a ``[W, n]`` buffer each whole
        gradient is cast and copied into once, in the moved layout; the
        whole ones through the engine's all-reduce.  The full ``.grad``s
        are freed."""
        idx = self.split[k]
        if idx:
            W = self.world
            n = sum(self.masters[i].numel() for i in idx)
            stacked = torch.empty(W, n, dtype=self.reduce_dtype,
                                  device=self.masters[idx[0]].device)
            off = 0
            for i in idx:
                leaf, p = self.leaves[i], self.params[i]
                m = self.masters[i].numel()
                dst = stacked[:, off:off + m].view(W, *leaf.shard_shape)
                if p.grad is None:
                    dst.zero_()
                else:
                    dst.copy_(leaf.moved(p.grad).unflatten(0, (W, leaf.rows)))
                    p.grad = None
                off += m
            out = reduce_scatter_stacked(stacked, self.group,
                                         comm.ReduceOp.AVG,
                                         self.replica_group)
            del stacked
            out = out if out.dtype == self.accum_dtype else \
                out.to(self.accum_dtype)
            if self.grad_flat[k] is None:
                self.grad_flat[k] = out
                for i in idx:
                    _, o, m = self.where[i]
                    self.shard_fn(i, out[o:o + m].view(
                        self.masters[i].shape))
            else:
                self.grad_flat[k].add_(out)
        whole = [i for i in self.owned[k] if not self.sharded[i]]
        if whole:
            self.whole_fn(whole)
        self.stats["units_reduced"] += 1

    def end_backward(self):
        """After the backward: reduce the units not reduced yet (a
        parameter that got no gradient contributes zeros) and release
        every gathered parameter."""
        for k in range(len(self.owned)):
            if not self._done[k]:
                self._done[k] = True
                for i in self.owned[k]:
                    self._release(i)
        self._drain()
        for i in range(len(self.params)):
            self._release(i)
        self.active = False

    def zero_grad(self):
        self.grad_flat = [None] * len(self.owned)

    # ------------------------------------------------------------------ #
    # whole masters for inspection or surgery (GatheredParameters)
    # ------------------------------------------------------------------ #
    def partitioned(self, i):
        """Parameter ``i``'s master shard as a ``Partitioned``."""
        from deepspeed_tpu_torch.runtime.zero import Partitioned
        return Partitioned(self.masters[i], self.leaves[i], self.group)

    @torch.no_grad()
    def hold_master(self, i):
        """``p.data`` = the whole master (its own dtype) until
        :meth:`write_back`."""
        self.params[i].data = self.partitioned(i).gather()
        self.full[i] = True
        self.pinned[i] = True

    @torch.no_grad()
    def write_back(self, i):
        """Take this rank's shard of the held whole master into the master
        shard, and release it."""
        self.partitioned(i).scatter_from(self.params[i].data)
        self.pinned[i] = False
        self._release(i)

    def remove(self):
        for h in self._hooks:
            h.remove()
        self._hooks = []
        for m in self._owners:
            m._zero3 = None
