"""Whole views of a training engine's partitioned state (port of
``deepspeed_tpu/utils/tensor_fragment.py``, reference
``deepspeed/utils/tensor_fragment.py``: ``safe_get_full_fp32_param`` and
its siblings, for debugging and checkpoint tools).

Under ZeRO each rank holds a shard of a leaf's master, moments or
gradient (``runtime/zero/partition.py``); each function here takes one
all-gather of the rank's shards over the engine's shard group and returns
the whole tensor in the parameter's own layout, on every rank.  A
parameter is named by its ``named_parameters()`` name (``"layers.0.attn.
q_proj.weight"``) or given as the ``nn.Parameter`` itself.  The JAX
package's shards are a sharded ``jax.Array``'s; the names and the module
path are the same.
"""

import torch


def _index(engine, param):
    names = getattr(engine, "_names", None) or [
        n for n, p in engine.module.named_parameters() if p.requires_grad]
    if isinstance(param, str):
        if param not in names:
            raise KeyError(f"no trained parameter {param!r}")
        return names.index(param)
    for i, p in enumerate(engine.params):
        if p is param:
            return i
    raise KeyError("the tensor is not one of the engine's parameters")


def _whole(engine, tensor, leaf):
    """``tensor`` (this rank's shard placed by ``leaf``, or a whole
    tensor) as the whole tensor in its own layout."""
    if leaf is None or not leaf.sharded:
        return tensor
    from deepspeed_tpu_torch.runtime.zero import Partitioned
    return Partitioned(tensor, leaf, engine.shard_group).gather()


@torch.no_grad()
def safe_get_full_fp32_param(engine, param):
    """The whole fp32 master of one parameter (a copy); under offload the
    host master."""
    i = _index(engine, param)
    host = getattr(engine, "_host_opt", None)
    if host is not None:
        shard = host.master_params()[i].to(engine.device)
        leaf = engine._plan.opt[i] if engine._plan is not None else None
        if engine._masters is not None:
            leaf = engine._plan.param[i]
        return _whole(engine, shard, leaf).float().clone()
    if engine._masters is not None and engine._masters[i] is not None:
        return _whole(engine, engine._masters[i],
                      engine._plan.param[i]).float().clone()
    return engine.params[i].detach().float().clone()


@torch.no_grad()
def safe_set_full_fp32_param(engine, param, value):
    """Overwrite one parameter's master with the whole ``value``; each
    rank keeps its shard of it (every rank passes the same value)."""
    i = _index(engine, param)
    value = torch.as_tensor(value)
    if engine._masters is not None and engine._masters[i] is not None:
        m = engine._masters[i]
        m.copy_(engine._plan.param[i].take(value.to(m.device, m.dtype)))
    else:
        p = engine.params[i]
        p.data.copy_(value.to(p.device, p.dtype))
    host = getattr(engine, "_host_opt", None)
    if host is not None:
        host.reseed_masters(engine._host_views())


@torch.no_grad()
def safe_get_full_optimizer_state(engine, param, optim_state_key):
    """The whole optimizer state ``optim_state_key`` (``"exp_avg"``,
    ``"exp_avg_sq"``) of one parameter, or None where the optimizer has
    no such state."""
    i = _index(engine, param)
    state = engine._opt_state
    host = getattr(engine, "_host_opt", None)
    if state is None and host is not None:
        field = host.state_dict().get(optim_state_key)
        if field is None:
            return None
        leaf = engine._plan.opt[i] if engine._plan is not None else None
        t = field[i].to(engine.device)
        shape = leaf.shard_shape if leaf is not None else \
            engine._plan.param[i].full_shape if engine._plan is not None \
            else engine.params[i].shape
        return _whole(engine, t.view(shape), leaf).clone()
    if state is None:
        return None
    field = getattr(state, optim_state_key, None)
    if field is None:
        return None
    leaf = engine._plan.opt[i] if engine._plan is not None else None
    return _whole(engine, field[i], leaf).clone()


@torch.no_grad()
def safe_get_full_grad(engine, param):
    """The whole gradient accumulated since the last step, unscaled by
    the loss scale (the gradient the step will apply before clipping);
    None outside an accumulation window."""
    if not getattr(engine, "_window_open", False):
        return None
    i = _index(engine, param)
    grads = engine._grads()
    leaf = engine._plan.grad[i] if engine._plan is not None else None
    g = grads[i]
    if engine._plan is not None and not engine._stage2 and engine._dp:
        # stages 0 / 1 average at the step: this rank's gradient, averaged
        from deepspeed_tpu_torch import comm
        g = g.clone()
        comm.all_reduce(g, op=comm.ReduceOp.AVG, group=engine.dp_group)
    g = _whole(engine, g, leaf)
    return (g.float() / engine._scaler_state.scale).clone()


def get_local_fragment(engine, param=None):
    """This rank's fragments: ``[(index, tensor)]``, ``index`` a tuple of
    slices into the parameter in the partition rule's layout (the JAX
    model's where it differs), ``tensor`` the shard in that layout —
    JAX's ``addressable_shards`` of the master.  ``engine`` may also be a
    ``zero.Partitioned`` (``param`` then unused)."""
    from deepspeed_tpu_torch.runtime.zero import Partitioned
    if isinstance(engine, Partitioned):
        shard, leaf = engine.shard, engine.leaf
    else:
        i = _index(engine, param)
        if engine._masters is not None and engine._masters[i] is not None:
            shard, leaf = engine._masters[i], engine._plan.param[i]
        else:
            t = engine.params[i].detach()
            return [(tuple(slice(0, s) for s in t.shape), t)]
    if not leaf.sharded:
        return [(tuple(slice(0, s) for s in leaf.full_shape), shard)]
    index = [slice(0, s) for s in leaf.shape]
    r = leaf.rank
    index[leaf.dim] = slice(r * leaf.rows, (r + 1) * leaf.rows)
    return [(tuple(index), leaf.to_natural(shard))]
