"""Public ZeRO API (port of ``deepspeed_tpu/runtime/zero/__init__.py``,
reference ``deepspeed.zero``).

* :class:`GatheredParameters` (reference ``partition_parameters.py:1553``):
  full tensors of partitioned state on entry, for inspection or surgery;
  on exit every rank takes rank ``modifier_rank``'s edit (a broadcast) and
  a partitioned tensor keeps its own shard of it.  A stage-3 engine's
  module parameters are partitioned: inside, each is whole (``p.data``,
  the master's dtype); on exit the edit is written back into the master
  shards.
* :class:`Init` (reference ``partition_parameters.py:603``): parameters
  partitioned at birth (ZeRO-3).  ``materialize(module)`` takes a module
  built on ``meta`` (``utils.init_on_device.OnDevice``) and returns each
  rank's :class:`Partitioned` shards of the model's init, run a submodule
  at a time from the seeded generator on the device, so no rank holds
  more than one submodule's whole tensors; the module then enters
  ``initialize`` with its shards.  ``materialize(init_fn, *args)``
  partitions what ``init_fn`` returns.  Without a group (or over one
  rank) there is nothing to partition: the whole tensors come back.
* :class:`Partitioned`: a shard with its placement (``partition.py``), the
  form in which the engine's ZeRO state enters ``GatheredParameters``.

The offloaded optimizer (ZeRO-Offload) is ``offload.py``; the stage-3
gathers are ``stage3.py``.
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
            gather_params
        return gather_params([self.shard], [self.leaf], self.group)[0]

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
        items = []
        for k, v in _leaves(self._src):
            if isinstance(v, Partitioned):
                v = v.gather()
            elif getattr(v, "_zero3", None) is not None:
                coord, i = v._zero3
                coord().hold_master(i)
            items.append((k, v))
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
        if exc_type is not None and self.enabled:
            # release what the entry gathered, unedited
            for _, orig in _leaves(self._src):
                if getattr(orig, "_zero3", None) is not None:
                    coord, i = orig._zero3
                    coord().pinned[i] = False
                    coord()._release(i)
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
            elif getattr(orig, "_zero3", None) is not None:
                coord, i = orig._zero3
                coord().write_back(i)
        return False


def _resolve_config(cfg):
    """A config dict / JSON path / ``DeepSpeedConfig`` → ``(zero_config,
    seed)``; none means stage 3 (the reference's ``zero.Init``
    partitions unconditionally)."""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    if cfg is None:
        cfg = {"zero_optimization": {"stage": 3}}
    if isinstance(cfg, str):
        import json
        with open(cfg) as f:
            cfg = json.load(f)
    if isinstance(cfg, dict):
        full = dict(cfg)
        full.setdefault("train_micro_batch_size_per_gpu", 1)
        cfg = DeepSpeedConfig(full)
    return getattr(cfg, "zero_config", cfg), getattr(cfg, "seed", 42)


def _shard_group(mics):
    """``(group, world, rank)`` ZeRO shards over on the live topology
    (built with MiCS's split ``mics``), or ``(None, 1, 0)`` without a
    process group."""
    if not comm.is_initialized():
        return None, 1, 0
    from deepspeed_tpu_torch.parallel import topology as topo_mod
    topo = topo_mod._TOPOLOGY
    mics = int(mics or 0)
    mdp = comm.get_world_size() // mics if mics > 0 else 1
    if topo is None or topo.groups is None or topo.mdp != mdp or \
            topo.world_size != comm.get_world_size():
        topo = topo_mod.initialize_topology(mics=mics)
    return (topo.get_zero_shard_group(), topo.get_zero_shard_world_size(),
            topo.get_zero_shard_rank(comm.get_rank()))


@torch.no_grad()
def partition_at_birth(module, names, leaves, device, dtype, generator,
                       values=None):
    """The model's init run a submodule at a time on ``device`` (each
    ``meta`` submodule given storage, drawn by ``module.init_weights(
    generator, module=sub)`` in ``modules()`` order: the whole init's
    values), keeping of each parameter ``names[i]``, placed by
    ``leaves[i]``, its rank shard (moved layout, contiguous, ``dtype``)
    and dropping the whole tensor; a leaf that stays whole keeps its
    storage on the module.  With ``values`` (``{name: whole tensor}``)
    each submodule takes those instead of the init.  Returns the shards,
    None for the whole leaves (``to_empty`` makes new ``Parameter``
    objects: read them from the module afterwards)."""
    index = {n: i for i, n in enumerate(names)}
    shards = [None] * len(names)
    for prefix, mod in module.named_modules():
        if not list(mod.parameters(recurse=False)) and \
                not list(mod.buffers(recurse=False)):
            continue
        mod.to_empty(device=device, recurse=False)
        if values is None:
            module.init_weights(generator, module=mod)
        for n, p in mod.named_parameters(recurse=False):
            name = f"{prefix}.{n}" if prefix else n
            if values is not None:
                p.data.copy_(values[name])
            i = index.get(name)
            if i is None or not leaves[i].sharded:
                continue
            shards[i] = torch.empty(leaves[i].shard_shape, dtype=dtype,
                                    device=device)
            shards[i].copy_(leaves[i].take(p.data))
            p.data = torch.empty(0, dtype=p.dtype, device=device)
    return shards


class Init:
    """Partitioned-at-birth parameters (ZeRO-3's ``zero.Init``)::

        with OnDevice(dtype=torch.float32, device="meta"):
            model = Transformer(cfg)
        with zero.Init(config=ds_config, device="cuda") as zinit:
            shards = zinit.materialize(model)

    ``config``: the DeepSpeed config (its ``zero_optimization`` stage and
    ``mics_shard_size`` place the shards, its ``seed`` seeds the init, as
    the engine's); none means stage 3.  ``dtype``: the shards' dtype
    (default fp32).  ``plan`` holds the placements after
    ``materialize``."""

    def __init__(self, module=None, config=None, config_dict_or_path=None,
                 mesh=None, dtype=None, enabled=True, device=None, seed=None,
                 **_compat_ignored):
        self.enabled = enabled
        self.dtype = dtype
        self.device = device
        self.plan = None
        cfg = config if config is not None else config_dict_or_path
        self._zero_config, cfg_seed = _resolve_config(cfg)
        self.seed = cfg_seed if seed is None else seed
        if module is not None and enabled:
            self.materialize(module)

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

    def _plan_for(self, shapes, layouts=None):
        group, world, rank = _shard_group(self._zero_config.mics_shard_size)
        self.plan = build_sharding_plan(shapes, world, rank,
                                        self._zero_config.stage, layouts)
        return group, world

    def materialize(self, init_fn, *args, **kwargs):
        """A module: its parameters' rank shards at birth, ``{name:
        Partitioned}`` (a tensor where a leaf stays whole), also kept on
        the module for ``initialize``.  A callable: ``init_fn(*args,
        **kwargs)`` (a dict of whole tensors; floating ones cast to
        ``dtype``), each tensor's rank shard taken.  Over one rank, or
        disabled, the whole tensors."""
        from torch import nn
        if isinstance(init_fn, nn.Module):
            return self._materialize_module(init_fn)
        out = init_fn(*args, **kwargs)
        if not isinstance(out, Mapping):
            return out
        if self.dtype is not None:
            out = {k: v.to(self.dtype) if torch.is_tensor(v)
                   and v.is_floating_point() else v for k, v in out.items()}
        if not self.enabled:
            return out
        group, world = self._plan_for([tuple(v.shape)
                                       for v in out.values()])
        if world == 1 or not comm.is_initialized():
            return out
        return {k: Partitioned(leaf.take(v).contiguous().clone(), leaf, group)
                if leaf.sharded else v
                for (k, v), leaf in zip(out.items(), self.plan.param)}

    def _materialize_module(self, module):
        from deepspeed_tpu_torch.accelerator import (get_accelerator,
                                                     resolve_device)
        device = resolve_device(self.device)
        gen = get_accelerator(device).manual_seed(self.seed, device)
        names = [n for n, _ in module.named_parameters()]
        params = list(module.parameters())
        lay = getattr(module, "jax_layouts", dict)()
        group, world = self._plan_for([p.shape for p in params],
                                      [lay.get(n) for n in names])
        if not self.enabled or not comm.is_initialized() or world == 1:
            module.to_empty(device=device)
            module.init_weights(gen)
            if self.dtype is not None:
                module.to(self.dtype)
            return dict(module.named_parameters())
        shards = partition_at_birth(module, names, self.plan.param, device,
                                    self.dtype or torch.float32, gen)
        params = dict(module.named_parameters())
        out = {n: Partitioned(s, leaf, group) if s is not None else params[n]
               for n, s, leaf in zip(names, shards, self.plan.param)}
        module._zero_init_shards = out
        return out
