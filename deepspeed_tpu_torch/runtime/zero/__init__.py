"""Public ZeRO API (port of ``deepspeed_tpu/runtime/zero/__init__.py``,
reference ``deepspeed.zero``).

* :class:`GatheredParameters` (reference ``partition_parameters.py:1553``):
  full tensors of partitioned state on entry, for inspection or surgery;
  on exit every rank takes rank ``modifier_rank``'s edit (a broadcast) and
  a partitioned tensor keeps its own shard of it.
* :class:`Init` (reference ``partition_parameters.py:603``): parameters
  partitioned at birth are ZeRO-3's, which waits (ROADMAP.md, queue A):
  at data-parallel size > 1 it raises; at size 1 there is nothing to
  partition and it is a pass-through.
* :class:`Partitioned`: a shard with its placement (``partition.py``), the
  form in which the engine's ZeRO state enters ``GatheredParameters``.

The offloaded optimizer (ZeRO-Offload at world size 1) is ``offload.py``.
"""

from collections.abc import Mapping

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.runtime.zero.partition import (  # noqa: F401
    LeafShard, ZeroShardingPlan, apply_zero_to_spec, build_sharding_plan,
    choose_zero_dim)

_ACTIVE_INIT = []


class Partitioned:
    """This rank's ``shard`` (moved layout, see ``partition.py``) of a
    tensor placed by ``leaf`` over ``group``."""

    def __init__(self, shard, leaf, group=None):
        self.shard = shard
        self.leaf = leaf
        self.group = group

    @property
    def shape(self):
        """The whole tensor's shape in its own layout."""
        return self.leaf.full_shape

    @torch.no_grad()
    def gather(self):
        """The full tensor on every rank (one all-gather)."""
        if not self.leaf.sharded:
            return self.shard.clone()
        from deepspeed_tpu_torch.runtime.comm.coalesced_collectives import \
            gathered_views
        shard = self.shard.contiguous().reshape(-1)
        W, (rows,) = gathered_views([shard], self.group)
        moved = rows.reshape(W * self.leaf.rows,
                             *self.leaf.shard_shape[1:])
        return self.leaf.from_moved(moved).contiguous()

    @torch.no_grad()
    def scatter_from(self, full):
        """Take this rank's shard of ``full`` (no communication)."""
        self.shard.copy_(self.leaf.take(full))


def _leaves(params):
    if isinstance(params, Mapping):
        return list(params.items())
    if isinstance(params, (list, tuple)):
        return list(enumerate(params))
    return [(None, params)]


class GatheredParameters:
    """Full tensors of (partitioned) state, re-partitioned on exit::

        with zero.GatheredParameters(dict(engine.module.named_parameters()),
                                     modifier_rank=0) as g:
            if dist.get_rank() == 0:
                g.full["embed_tokens.weight"][:vocab] = new_rows

    ``params``: a tensor, a :class:`Partitioned`, or a list / dict of them.
    ``full`` has the same structure of full tensors: a plain (replicated)
    tensor is given as itself, so surgery edits it in place; a partitioned
    one is all-gathered.  On exit each full tensor is broadcast from the
    data-parallel rank ``modifier_rank`` (None: no one modified anything,
    nothing moves) and each partitioned tensor takes its shard of the
    result.  ``enabled=False`` is a pass-through (``full`` is ``params``).
    ``params`` is available after exit (the same tensors)."""

    def __init__(self, params, modifier_rank=0, fwd_module=None, enabled=True,
                 group=None):
        self.enabled = enabled
        self.modifier_rank = modifier_rank
        self.group = group
        self._src = params
        self.full = None
        self.params = None

    def __enter__(self):
        if not self.enabled:
            self.full = self._src
            return self
        items = [(k, v.gather() if isinstance(v, Partitioned) else v)
                 for k, v in _leaves(self._src)]
        if isinstance(self._src, Mapping):
            self.full = dict(items)
        elif isinstance(self._src, (list, tuple)):
            self.full = [v for _, v in items]
        else:
            self.full = items[0][1]
        return self

    @torch.no_grad()
    def __exit__(self, exc_type, *exc):
        self.params = self._src
        if exc_type is not None or not self.enabled:
            return False
        full = dict(_leaves(self.full))
        live = comm.is_initialized() and \
            comm.get_world_size(self.group) > 1
        src = None if self.modifier_rank is None or not live else \
            comm.get_global_rank(self.group, self.modifier_rank)
        for key, orig in _leaves(self._src):
            value = full[key]
            if src is not None:
                comm.broadcast(value, src=src, group=self.group,
                               log_name="gathered_parameters")
            if isinstance(orig, Partitioned):
                orig.scatter_from(value)
        return False


class Init:
    """Partitioned-at-birth parameters (ZeRO-3's ``zero.Init``): raises at
    data-parallel size > 1 until ZeRO-3 is ported; at size 1 a
    pass-through context whose ``materialize(init_fn, *args)`` returns
    ``init_fn(*args)`` (floating tensors of a returned dict cast to
    ``dtype`` when given)."""

    def __init__(self, module=None, config=None, config_dict_or_path=None,
                 mesh=None, dtype=None, enabled=True, **_compat_ignored):
        self.enabled = enabled
        self.dtype = dtype
        if enabled and comm.is_initialized() and comm.get_world_size() > 1:
            raise NotImplementedError(
                "zero.Init (parameters partitioned at birth, ZeRO-3) is not "
                "ported to deepspeed_tpu_torch yet (see ROADMAP.md, queue A)")

    def __enter__(self):
        if self.enabled:
            _ACTIVE_INIT.append(self)
        return self

    def __exit__(self, *exc):
        if self.enabled and _ACTIVE_INIT and _ACTIVE_INIT[-1] is self:
            _ACTIVE_INIT.pop()
        return False

    @staticmethod
    def is_active():
        return bool(_ACTIVE_INIT)

    def materialize(self, init_fn, *args, **kwargs):
        out = init_fn(*args, **kwargs)
        if self.dtype is None or not isinstance(out, Mapping):
            return out
        return {k: v.to(self.dtype) if torch.is_tensor(v)
                and v.is_floating_point() else v for k, v in out.items()}
