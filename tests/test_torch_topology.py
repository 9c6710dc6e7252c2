"""The port's rank topology (``deepspeed_tpu_torch.parallel.topology``)
against the JAX package's device mesh — the scenarios of
``tests/unit/test_topology.py:20-64`` for the axes this slice accepts.

The port lays the world's ranks out in JAX's grid, ``AXIS_ORDER = (pp,
mdp, edp, ep, sp, tp)``; every rank's coordinate, every axis group and the
rows of a global batch a rank holds must be the JAX mesh's for its device
of the same index (the 8 virtual CPU devices, ids 0-7).  The rank algebra
covers every axis (checked on ``ParallelTopology`` with tp, pp, ep, sp);
``initialize_topology`` accepts data parallelism only and refuses the rest
with ``NotImplementedError``.
"""

import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding

from deepspeed_tpu.parallel import topology as jtopo

from deepspeed_tpu_torch.parallel import topology as ptopo
from deepspeed_tpu_torch.utils import groups


def _jax_grid(**axes):
    topo = jtopo.ParallelTopology(**axes, devices=jax.devices())
    return topo, np.vectorize(lambda d: d.id)(topo.mesh.devices)


def _jax_groups(grid, axes):
    """JAX's groups along ``axes``: device ids, in C order over the axes."""
    names = jtopo.AXIS_ORDER
    keep = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in keep]
    moved = np.transpose(grid, rest + keep)
    n = int(np.prod([grid.shape[i] for i in keep]))
    return sorted(map(list, moved.reshape(-1, n).tolist()))


LAYOUTS = [dict(dp=8), dict(dp=4), dict(dp=2), dict(dp=4, tp=2),
           dict(dp=2, tp=2, pp=2), dict(dp=8, ep=4), dict(dp=2, sp=2, tp=2),
           dict(dp=4, mdp=2)]


def test_axis_order_matches_jax():
    assert ptopo.AXIS_ORDER == jtopo.AXIS_ORDER
    assert ptopo.DP_AXES == jtopo.DP_AXES
    assert ptopo.DENSE_GRAD_AXES == jtopo.DENSE_GRAD_AXES
    assert ptopo.EXPERT_GRAD_AXES == jtopo.EXPERT_GRAD_AXES


@pytest.mark.parametrize("axes", LAYOUTS, ids=lambda a: "-".join(
    f"{k}{v}" for k, v in a.items()))
def test_rank_algebra_matches_the_jax_mesh(axes):
    jt, grid = _jax_grid(**axes)
    t = ptopo.ParallelTopology(**axes)
    assert t.shape == tuple(jt.mesh.devices.shape)
    assert t.world_size == jt.world_size and t.edp == jt.edp
    np.testing.assert_array_equal(t.grid, grid)
    for axes_ in ptopo.GROUP_AXES:
        assert sorted(t.group_ranks(axes_)) == _jax_groups(grid, axes_)
    for rank in t.ranks:
        c = t.coord_of(rank)
        assert t.rank_of(c) == rank
        assert tuple(c[a] for a in ptopo.AXIS_ORDER) == tuple(
            int(i) for i in np.argwhere(grid == rank)[0])
    assert t.get_data_parallel_world_size() == jt.get_data_parallel_world_size()
    assert t.get_model_parallel_world_size() == jt.get_model_parallel_world_size()
    assert t.get_data_parallel_axes() == jt.get_data_parallel_axes()
    assert t.get_expert_data_parallel_axes() == \
        jt.get_expert_data_parallel_axes()


def test_default_topology_is_all_dp():
    t = ptopo.initialize_topology(world_size=8)
    try:
        assert (t.dp, t.world_size) == (8, 8)
        assert t.tp == t.pp == t.sp == t.ep == 1
        assert ptopo.get_topology() is t
    finally:
        ptopo.reset_topology()


@pytest.mark.parametrize("dp", (2, 4, 8))
def test_rank_rows_match_jax_data_sharding(dp):
    """The rows of a global batch each rank holds: the JAX data spec's
    shard on the device of the same dp index."""
    jt, grid = _jax_grid(dp=dp)
    t = ptopo.ParallelTopology(dp=dp)
    rows = 4 * dp
    x = jax.device_put(np.arange(rows), NamedSharding(jt.mesh, jt.data_spec()))
    by_id = {s.device.id: s.index[0] for s in x.addressable_shards}
    for rank in t.ranks:
        want = by_id[rank]
        got = t.data_spec(rows, rank)
        assert (got.start, got.stop) == (want.start, want.stop)
        assert t.get_data_parallel_rank(rank) == rank
    with pytest.raises(ValueError):
        t.data_spec(rows + 1, 0)


def test_invalid_topologies_raise():
    with pytest.raises(ValueError):
        ptopo.ParallelTopology(dp=16, tp=2, ranks=list(range(8)))
    with pytest.raises(ValueError):
        ptopo.ParallelTopology(dp=4, ep=3)


@pytest.mark.parametrize("knob", [dict(tp=2), dict(pp=2), dict(sp=2),
                                  dict(ep=2), dict(mics=2)],
                         ids=lambda k: next(iter(k)))
def test_only_data_parallelism_is_accepted(knob):
    if "mics" in knob:
        # MiCS splits data parallelism (ported with ZeRO-3): replica
        # groups of mics sharding ranks
        try:
            t = ptopo.initialize_topology(dp=4, world_size=8, **knob)
            assert (t.mdp, t.edp, t.dp) == (2, 2, 4)
        finally:
            ptopo.reset_topology()
        return
    if "tp" in knob:
        # tensor parallelism is ported (the TP slice): tp 2 over 8 ranks
        # leaves dp 4, the tp pairs adjacent as in JAX's mesh
        try:
            t = ptopo.initialize_topology(world_size=8, **knob)
            assert (t.dp, t.tp) == (4, 2)
            assert t.group_ranks(("tp",)) == [[0, 1], [2, 3], [4, 5], [6, 7]]
            assert [t.data_spec(8, r) for r in (0, 1)] == [slice(0, 2)] * 2
        finally:
            ptopo.reset_topology()
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ptopo.initialize_topology(dp=4, world_size=8, **knob)


def test_groups_need_a_live_topology():
    ptopo.set_topology(ptopo.ParallelTopology(dp=2))
    try:
        with pytest.raises(RuntimeError, match="build_groups"):
            groups._get_data_parallel_group()
        assert groups._get_data_parallel_world_size() == 2
        assert groups._get_model_parallel_world_size() == 1
        assert groups._get_expert_model_parallel_world_size() == 1
    finally:
        ptopo.reset_topology()


@pytest.mark.parametrize("dp", (2, 4, 8))
def test_zero_rule_matches_jax(dp):
    """``choose_zero_dim`` / ``apply_zero_to_spec``: the port's rule on a
    shape gives the dim JAX's gives on its mesh (largest divisible, the
    last of equal sizes, none when nothing divides)."""
    from jax.sharding import PartitionSpec as P
    from deepspeed_tpu.runtime.zero import partition as jpart
    from deepspeed_tpu_torch.runtime.zero import partition as ppart
    jt, _ = _jax_grid(dp=dp)
    shapes = [(64, 64), (97, 64), (64, 4, 16), (4, 16, 64), (128, 64),
              (64,), (3, 5), (8, 8, 8), (2, 6)]
    for shape in shapes:
        want = jpart.apply_zero_to_spec(shape, P(), jt.mesh, jtopo.DP_AXES)
        got = ppart.apply_zero_to_spec(shape, (), dp)
        want_dim = [i for i, e in enumerate(tuple(want) + (None,) * len(shape))
                    if e is not None]
        got_dim = [i for i, e in enumerate(got) if e is not None]
        assert got_dim == want_dim, (shape, got, want)
        assert ppart.choose_zero_dim(shape, [None] * len(shape), dp) == \
            (want_dim[0] if want_dim else None)
