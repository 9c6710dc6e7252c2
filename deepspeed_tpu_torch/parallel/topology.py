"""Process-group topology (port of ``deepspeed_tpu/parallel/topology.py``).

The JAX package arranges the devices in one ``Mesh`` whose named axes are
the groups.  The port arranges the world's ranks — one process a GPU — in
the same grid with the same axis order, outermost → innermost::

    AXIS_ORDER = (pp, mdp, edp, ep, sp, tp)

so a rank's coordinate is its index in a C-order array of that shape, as
a device's is in the JAX mesh, and the group of an axis (or a tuple of
axes) is every rank that differs from this one only along those axes.
Each group becomes a ``torch.distributed`` ``ProcessGroup`` (the world's
group when it spans the world).  The data-parallel group is the compound
``DP_AXES = (mdp, edp, ep)``, as in JAX.  At ``tp`` > 1 each tp group
also gets a gloo twin for host messages between its ranks (the serving
plans of ``inference/serving/tp_schedule.py``), beside the model's
collectives and never interleaved with them.

The port accepts data parallelism, split by MiCS (``mics`` > 0) into
``mdp`` replica groups of ``mics`` sharding ranks each, as JAX's
``initialize_topology(..., mics=)`` splits its mesh: ZeRO shards within a
group (``edp``) and replicates across groups (``mdp``); and tensor
parallelism (``tp``, the innermost axis, so a tp group's ranks are
adjacent, as a JAX mesh's tp devices are; ``parallel/tensor_parallel.py``).
Every tp rank of one data-parallel index takes the same batch rows.
``pp``, ``sp`` and ``ep`` > 1 raise ``NotImplementedError`` (ROADMAP.md,
queue A).  The rank algebra covers every axis already.
"""

import datetime
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

# Canonical axis names.
PP_AXIS = "pp"      # pipeline stages
MDP_AXIS = "mdp"    # MiCS replica groups
EDP_AXIS = "edp"    # expert-data-parallel (DP within an expert group)
EP_AXIS = "ep"      # expert parallel
SP_AXIS = "sp"      # sequence/context parallel
TP_AXIS = "tp"      # tensor/model parallel

AXIS_ORDER = (PP_AXIS, MDP_AXIS, EDP_AXIS, EP_AXIS, SP_AXIS, TP_AXIS)

# Compound groups, named for parity with the reference group getters.
DP_AXES = (MDP_AXIS, EDP_AXIS, EP_AXIS)    # dense data-parallel group
DENSE_GRAD_AXES = (MDP_AXIS, EDP_AXIS, EP_AXIS, SP_AXIS)
EXPERT_GRAD_AXES = (MDP_AXIS, EDP_AXIS, SP_AXIS)

# the groups a topology builds: every single axis, the compound groups
GROUP_AXES = tuple((a,) for a in AXIS_ORDER) + (
    DP_AXES, DENSE_GRAD_AXES, EXPERT_GRAD_AXES, (MDP_AXIS, EDP_AXIS))

# a receive on the tp groups' gloo twins waits this long (an idle server
# sends its followers nothing) before it times out
CPU_GROUP_TIMEOUT = datetime.timedelta(hours=24)


def _not_ported(what):
    raise NotImplementedError(
        f"{what} is not ported to deepspeed_tpu_torch yet: the port runs "
        f"data and tensor parallelism (see ROADMAP.md, queue A)")


@dataclass
class ParallelTopology:
    """The rank grid plus the group algebra DeepSpeed exposes (analog of
    ``PipeModelDataParallelTopology``, reference
    ``runtime/pipe/topology.py:244``).  ``ranks`` (default ``0 ..
    world_size - 1``) are the world ranks laid out in the grid;
    ``groups`` holds the ``ProcessGroup`` of each axis tuple in
    ``GROUP_AXES`` for this rank once :meth:`build_groups` ran, and
    ``tp_cpu_group`` the gloo twin of its tp group (None at tp 1)."""

    dp: int = 1
    tp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    mdp: int = 1
    ranks: Optional[list] = field(default=None, repr=False)
    groups: dict = field(default=None, repr=False)
    tp_cpu_group: object = field(default=None, repr=False)

    def __post_init__(self):
        if self.dp % (self.ep * self.mdp) != 0:
            raise ValueError(
                f"expert parallel size {self.ep} x MiCS replica groups "
                f"{self.mdp} must divide data parallel size {self.dp}")
        self.edp = self.dp // (self.ep * self.mdp)
        need = self.world_size
        ranks = list(range(need)) if self.ranks is None else list(self.ranks)
        if len(ranks) < need:
            raise ValueError(
                f"topology dp={self.dp} tp={self.tp} pp={self.pp} "
                f"sp={self.sp} needs {need} ranks, have {len(ranks)}")
        self.ranks = ranks[:need]
        self.grid = np.asarray(self.ranks).reshape(self.shape)

    # ------------------------------------------------------------------ #
    @property
    def shape(self):
        return (self.pp, self.mdp, self.edp, self.ep, self.sp, self.tp)

    @property
    def world_size(self):
        return self.pp * self.mdp * self.edp * self.ep * self.sp * self.tp

    def axis_sizes(self):
        """``{axis: size}`` of the grid (all six canonical axes)."""
        return dict(zip(AXIS_ORDER, self.shape))

    def axis_size(self, name):
        return self.axis_sizes()[name]

    # rank <-> coordinate algebra (C order over AXIS_ORDER)
    def coord_of(self, rank):
        """``{axis: index}`` of world rank ``rank``."""
        where = np.argwhere(self.grid == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not in this topology")
        return dict(zip(AXIS_ORDER, (int(i) for i in where[0])))

    def rank_of(self, coord=None, **axes):
        """The world rank at ``coord`` (missing axes: 0)."""
        coord = {**(coord or {}), **axes}
        return int(self.grid[tuple(coord.get(a, 0) for a in AXIS_ORDER)])

    def group_ranks(self, axes):
        """Every group along ``axes``: lists of world ranks, each list in
        the group's rank order (C order over ``axes``)."""
        axes = tuple(axes)
        keep = [i for i, a in enumerate(AXIS_ORDER) if a in axes]
        rest = [i for i in range(len(AXIS_ORDER)) if i not in keep]
        moved = np.transpose(self.grid, rest + keep)
        n = int(np.prod([self.grid.shape[i] for i in keep]))
        return [list(map(int, row)) for row in moved.reshape(-1, n)]

    def ranks_of_group(self, axes, rank):
        """The world ranks of ``rank``'s group along ``axes``."""
        for ranks in self.group_ranks(axes):
            if rank in ranks:
                return ranks
        raise ValueError(f"rank {rank} is not in this topology")

    def index_in(self, axes, rank):
        """``rank``'s index in its group along ``axes`` (the in-group rank,
        JAX's ``axis_index``)."""
        return self.ranks_of_group(axes, rank).index(rank)

    # ------------------------------------------------------------------ #
    def build_groups(self):
        """Create the ``ProcessGroup`` of every axis tuple of
        ``GROUP_AXES`` (every rank of the world calls this, as torch's
        ``new_group`` requires); a group spanning the world is the world's
        group; at tp > 1 also the tp groups' gloo twins.  Returns
        ``self``."""
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("build_groups needs a live process group "
                               "(comm.init_distributed)")
        if dist.get_world_size() != self.world_size:
            raise ValueError(f"topology of {self.world_size} ranks on a "
                             f"world of {dist.get_world_size()}")
        me = dist.get_rank()
        groups, made = {}, {}
        for axes in GROUP_AXES:
            lists = self.group_ranks(axes)
            key = tuple(map(tuple, lists))
            if key not in made:
                if len(lists) == 1:
                    made[key] = dist.group.WORLD
                else:
                    mine, _ = dist.new_subgroups_by_enumeration(lists)
                    made[key] = mine
            groups[axes] = made[key]
        self.groups = groups
        if self.tp > 1:
            self.tp_cpu_group, _ = dist.new_subgroups_by_enumeration(
                self.group_ranks((TP_AXIS,)), timeout=CPU_GROUP_TIMEOUT,
                backend="gloo")
        self.rank = me
        return self

    def group_for(self, axes):
        axes = tuple(axes)
        if self.groups is None:
            raise RuntimeError("the topology has no process groups: "
                               "build_groups() after init_distributed")
        if axes not in self.groups:
            raise ValueError(f"no group for axes {axes}; known: "
                             f"{sorted(self.groups)}")
        return self.groups[axes]

    # Group getters — parity with reference ``utils/groups.py:280-392``.
    def get_data_parallel_axes(self):
        return DP_AXES

    def get_model_parallel_axes(self):
        return (TP_AXIS,)

    def get_pipe_parallel_axes(self):
        return (PP_AXIS,)

    def get_expert_parallel_axes(self):
        return (EP_AXIS,)

    def get_expert_data_parallel_axes(self):
        return (MDP_AXIS, EDP_AXIS)

    def get_sequence_parallel_axes(self):
        return (SP_AXIS,)

    def get_data_parallel_group(self):
        return self.group_for(DP_AXES)

    def get_data_parallel_world_size(self):
        return self.dp

    def get_data_parallel_rank(self, rank=None):
        return self.index_in(DP_AXES, self._me(rank))

    def get_zero_shard_axes(self):
        """The axes ZeRO shards over: ``edp`` alone with MiCS (each
        replica group holds the whole state), else the data-parallel
        group."""
        return (EDP_AXIS,) if self.mdp > 1 else DP_AXES

    def get_zero_shard_group(self):
        return self.group_for(self.get_zero_shard_axes())

    def get_zero_shard_world_size(self):
        return self.edp if self.mdp > 1 else self.dp

    def get_zero_shard_rank(self, rank=None):
        return self.index_in(self.get_zero_shard_axes(), self._me(rank))

    def get_zero_replica_group(self):
        """MiCS's replica group (``mdp``: the ranks holding the same
        shard), None without MiCS."""
        return self.group_for((MDP_AXIS,)) if self.mdp > 1 else None

    def get_model_parallel_world_size(self):
        return self.tp

    def get_model_parallel_group(self):
        return self.group_for((TP_AXIS,))

    def get_model_parallel_cpu_group(self):
        """The gloo twin of this rank's tp group (host messages; tp > 1)."""
        if self.tp_cpu_group is None:
            raise RuntimeError("the topology has no tp gloo group: it is "
                               "built at tp > 1 by build_groups()")
        return self.tp_cpu_group

    def get_model_parallel_rank(self, rank=None):
        return self.index_in((TP_AXIS,), self._me(rank))

    def get_pipe_parallel_world_size(self):
        return self.pp

    def get_sequence_parallel_world_size(self):
        return self.sp

    def get_expert_parallel_world_size(self):
        return self.ep

    def _me(self, rank):
        if rank is not None:
            return rank
        return getattr(self, "rank", 0)

    # ------------------------------------------------------------------ #
    def data_spec(self, global_rows, rank=None):
        """The rows of a global batch of ``global_rows`` this rank holds:
        the data-parallel index r takes ``[r * rows / dp, (r + 1) * rows /
        dp)``, as JAX's ``NamedSharding`` places dim 0 over ``DP_AXES``."""
        if global_rows % self.dp:
            raise ValueError(f"a global batch of {global_rows} rows does not "
                             f"split over dp={self.dp}")
        n = global_rows // self.dp
        r = self.get_data_parallel_rank(rank)
        return slice(r * n, (r + 1) * n)

    batch_spec = data_spec


# --------------------------------------------------------------------- #
# Global topology registry — analog of the module-level group cache in
# reference ``utils/groups.py``.
# --------------------------------------------------------------------- #
_TOPOLOGY = None


def initialize_topology(dp=None, tp=1, pp=1, ep=1, sp=1, mics=0,
                        world_size=None):
    """The topology of the live world (``world_size``: the process group's
    size, 1 without one).  ``dp`` defaults to the whole world.  ``mics`` >
    0 sizes the ZeRO shard group (the JAX ``mics_shard_size``): the
    data-parallel world splits into ``mdp`` replica groups of ``mics``
    ranks each.  With a live process group the groups are built.  Only
    ``dp`` (and its MiCS split) and ``tp`` may exceed 1."""
    global _TOPOLOGY
    for name, size in (("pipeline parallelism (pp)", pp),
                       ("expert parallelism (ep)", ep),
                       ("sequence parallelism (sp)", sp)):
        if size != 1:
            _not_ported(f"{name} = {size}")
    from deepspeed_tpu_torch import comm
    live = comm.is_initialized()
    if world_size is None:
        world_size = comm.get_world_size() if live else 1
    if dp is None:
        denom = tp * pp * ep * sp
        if world_size % denom != 0:
            raise ValueError(f"world size {world_size} not divisible by "
                             f"tp*pp*ep*sp={denom}")
        dp = (world_size // denom) * ep
    mdp = 1
    if mics and mics > 0:
        edp_world = dp // ep
        if edp_world % mics != 0:
            raise ValueError(
                f"mics_shard_size={mics} must divide the expert-data-"
                f"parallel world {edp_world} (dp={dp} / ep={ep})")
        mdp = edp_world // mics
    topo = ParallelTopology(dp=dp, tp=tp, pp=pp, ep=ep, sp=sp, mdp=mdp,
                            ranks=list(range(world_size)))
    if live:
        topo.build_groups()
    _TOPOLOGY = topo
    return _TOPOLOGY


def get_topology():
    """The live topology (built over the live world on first use)."""
    global _TOPOLOGY
    if _TOPOLOGY is None:
        _TOPOLOGY = initialize_topology()
    return _TOPOLOGY


def set_topology(topo):
    global _TOPOLOGY
    _TOPOLOGY = topo
    return _TOPOLOGY


def reset_topology():
    global _TOPOLOGY
    _TOPOLOGY = None
