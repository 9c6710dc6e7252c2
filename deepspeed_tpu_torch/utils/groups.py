"""Process-group registry (port of ``deepspeed_tpu/utils/groups.py``,
reference ``deepspeed/utils/groups.py``).

The getters answer from the live :class:`ParallelTopology`: each returns
the ``torch.distributed`` ``ProcessGroup`` of its axes (JAX returns the
axis names).  MiCS's two groups are the shard group (``edp``: the ranks
that split a parameter) and the replica group (``mdp``: the ranks that
hold the same shard).  The model-parallel getters answer over the ``tp``
group; :func:`topology_from_mpu` adopts a Megatron model-parallel unit's
sizes (both its naming schemes, as JAX's ``initialize`` reads them).  The
``_create_*`` builders raise for an expert size above 1.
"""

from deepspeed_tpu_torch.parallel import topology as _topo


def _require_topo():
    t = _topo.get_topology()
    if t is None:
        raise RuntimeError("topology not initialized; call "
                           "deepspeed_tpu_torch.initialize or "
                           "initialize_topology")
    return t


def _create_expert_and_data_parallel(expert_parallel_size):
    """Reference ``groups.py:108``: a topology rebuild."""
    return _topo.initialize_topology(ep=expert_parallel_size)


def _create_expert_data_and_model_parallel(expert_parallel_size, mpu=None,
                                           tensor_parallel_size=1):
    """Reference ``groups.py:202``."""
    return _topo.initialize_topology(ep=expert_parallel_size,
                                     tp=tensor_parallel_size)


# cached getters (reference groups.py:280-392)
def _get_data_parallel_group():
    return _require_topo().group_for(_topo.DP_AXES)


def _get_model_parallel_group():
    return _require_topo().group_for((_topo.TP_AXIS,))


def _get_expert_parallel_group(name=None):
    return _require_topo().group_for((_topo.EP_AXIS,))


def _get_expert_data_parallel_group(name=None):
    return _require_topo().group_for(
        _require_topo().get_expert_data_parallel_axes())


def _get_sequence_parallel_group():
    return _require_topo().group_for((_topo.SP_AXIS,))


def _get_data_parallel_world_size():
    return _require_topo().get_data_parallel_world_size()


def _get_model_parallel_world_size():
    return _require_topo().get_model_parallel_world_size()


def _get_model_parallel_rank():
    return _require_topo().get_model_parallel_rank()


# Megatron-Core's names for the same groups
_get_tensor_model_parallel_group = _get_model_parallel_group
_get_tensor_model_parallel_world_size = _get_model_parallel_world_size
_get_tensor_model_parallel_rank = _get_model_parallel_rank


def _mpu_size(mpu, *names):
    for n in names:
        fn = getattr(mpu, n, None)
        if callable(fn):
            return int(fn())
    return 1


def topology_from_mpu(mpu):
    """The topology of a Megatron-style model-parallel unit: its tensor
    and pipeline sizes, read through the legacy names
    (``get_model_parallel_world_size``, ``get_pipe_parallel_world_size``)
    or Megatron-Core's (``get_tensor_model_parallel_world_size``,
    ``get_pipeline_model_parallel_world_size``), data parallelism over the
    rest of the live world (JAX ``initialize``)."""
    tp = _mpu_size(mpu, "get_model_parallel_world_size",
                   "get_tensor_model_parallel_world_size")
    pp = _mpu_size(mpu, "get_pipe_parallel_world_size",
                   "get_pipeline_model_parallel_world_size")
    return _topo.initialize_topology(tp=tp, pp=pp)


def _get_expert_parallel_world_size(name=None):
    return _require_topo().get_expert_parallel_world_size()


def _get_data_parallel_rank():
    return _require_topo().get_data_parallel_rank()


def _get_expert_model_parallel_world_size():
    t = _require_topo()
    return t.get_expert_parallel_world_size() * \
        t.get_model_parallel_world_size()


def _get_zero_shard_group():
    """The group ZeRO shards over: MiCS's shard group (``edp``), or the
    data-parallel group without MiCS."""
    return _require_topo().get_zero_shard_group()


def _get_zero_replica_group():
    """MiCS's replica group (``mdp``); None without MiCS."""
    return _require_topo().get_zero_replica_group()


def _get_mics_shard_world_size():
    return _require_topo().get_zero_shard_world_size()
