"""ZeRO's partition plan (port of ``deepspeed_tpu/runtime/zero/partition.py``).

The JAX package expresses ZeRO as ``PartitionSpec`` trees and lets GSPMD
place each leaf.  The port keeps the same rule and makes the placement
explicit: for each parameter leaf, which dim (if any) is sharded over the
data-parallel group —

* stage >= 1: the optimizer state (moments, and the master slice the step
  updates);
* stage >= 2: the gradient (reduce-scattered into the rank's shard);
* stage >= 3: the parameter itself (the master shard, gathered a layer at
  a time where the model uses it: ``runtime/zero/stage3.py``).

The dim is JAX's ``choose_zero_dim``: the largest dim divisible by dp (the
last of equal sizes); a leaf with no such dim stays replicated (JAX's
persisted leaves).  Rank r holds the r-th contiguous chunk of that dim, as
``NamedSharding`` places it, so each rank's state is JAX's addressable
shard at dp index r.  With MiCS the group is the shard group (``edp``) and
r the rank in it (the JAX plan's ``zero_axes = (EDP_AXIS,)``): the state
is replicated across the replica groups.  At stage 3 over a group of one
rank every leaf is its own whole shard (dim 0 of its own layout), so the
gathers and releases run, as identities, where nothing is split.

The shard is kept in the **moved layout**: the chosen dim first
(``movedim(d, 0)``), rows ``[r * c, (r + 1) * c)``, contiguous.  Flattened,
that is the r-th of ``dp`` equal pieces of the leaf's moved flat buffer,
which is what the coalesced collectives (``runtime/comm``) hand rank r, so
the per-leaf plan and the bucket layouts agree.  ``to_natural`` gives the
shard in the rule's layout's dim order (JAX's shard).
"""

from dataclasses import dataclass
from typing import Callable, List, Optional

from deepspeed_tpu_torch.utils.logging import logger

ZERO_AXIS = "dp"


def choose_zero_dim(shape, spec, n):
    """The dim to shard over a zero group of ``n`` ranks: the largest dim
    divisible by ``n`` that isn't already sharded (``spec[d]`` None), the
    last of equal sizes.  None if nothing fits (the leaf stays replicated
    — the analog of the reference's persisted params) or ``n`` is 1."""
    if n == 1:
        return None
    candidates = []
    for d, size in enumerate(shape):
        if spec[d] is None and size % n == 0 and size >= n:
            candidates.append((size, d))
    if not candidates:
        return None
    return max(candidates)[1]


def apply_zero_to_spec(shape, spec, n, zero_axis=ZERO_AXIS):
    """Extend a spec (a tuple of axis names / None per dim) with ZeRO
    sharding over a group of ``n`` ranks named ``zero_axis``."""
    spec = list(spec) + [None] * (len(shape) - len(spec))
    if n == 1 or zero_axis in spec:
        return tuple(spec)
    d = choose_zero_dim(shape, spec, n)
    if d is not None:
        spec[d] = zero_axis
    return tuple(spec)


@dataclass(frozen=True)
class LeafShard:
    """One leaf's placement: ``dim`` None means replicated.  ``shape`` is
    the leaf's shape in the layout the rule runs on: its own, or — with
    ``view`` — the JAX model's (``view(tensor)`` is that layout as a view
    of the tensor, ``unview`` the inverse), so that the shard holds the
    elements of JAX's shard whatever the two packages' layouts."""
    shape: tuple
    dim: Optional[int]
    dp: int
    rank: int
    view: Optional[Callable] = None
    unview: Optional[Callable] = None
    base_shape: Optional[tuple] = None

    @property
    def full_shape(self):
        """The whole tensor's shape in its own layout."""
        return self.shape if self.base_shape is None else self.base_shape

    @property
    def sharded(self):
        return self.dim is not None

    @property
    def rows(self):
        """Rows of the moved layout this rank holds."""
        return self.shape[self.dim] // self.dp if self.sharded else None

    @property
    def shard_shape(self):
        """The shard's shape in the moved layout (the whole shape when
        replicated)."""
        if not self.sharded:
            return tuple(self.full_shape)
        rest = [s for i, s in enumerate(self.shape) if i != self.dim]
        return (self.rows, *rest)

    def moved(self, full):
        """``full`` (the leaf's own layout) in the rule's layout with the
        sharded dim first — a view, so writes land in ``full``."""
        laid = full if self.view is None else self.view(full)
        return laid.movedim(self.dim, 0)

    def take(self, full, rank=None):
        """Rank ``rank``'s (default: this rank's) shard of ``full``, a
        view in the moved layout (``full`` itself when replicated)."""
        if not self.sharded:
            return full
        r = self.rank if rank is None else rank
        return self.moved(full).narrow(0, r * self.rows, self.rows)

    def from_moved(self, moved):
        """A whole moved-layout tensor back in the leaf's own layout."""
        laid = moved.movedim(0, self.dim)
        return laid if self.unview is None else self.unview(laid)

    def to_natural(self, shard):
        """A moved-layout shard in the rule's layout's dim order (a view):
        JAX's addressable shard."""
        return shard.movedim(0, self.dim) if self.sharded else shard


class ZeroShardingPlan:
    """Per-leaf placements of the three state classes, in parameter
    order: ``param`` (stage >= 3), ``grad`` (stage >= 2), ``opt``
    (stage >= 1)."""

    def __init__(self, param, grad, opt, dp, rank, stage):
        self.param: List[LeafShard] = param
        self.grad: List[LeafShard] = grad
        self.opt: List[LeafShard] = opt
        self.dp = dp
        self.rank = rank
        self.stage = stage



def build_sharding_plan(shapes, dp, rank, stage, layouts=None):
    """The ZeRO partitioner: parameter shapes (in order) → placements for
    params / grads / optimizer state at ``stage`` over a group of ``dp``
    ranks, this one ``rank``.  ``layouts[i]``, when given and not None, is
    ``(view, unview, shape)``: the rule runs on that layout of leaf i (the
    JAX model's, see ``models.transformer.Transformer.jax_layouts``)."""
    layouts = layouts or [None] * len(shapes)

    def plan(shard):
        out = []
        for own, lay in zip(shapes, layouts):
            own = tuple(int(s) for s in own)
            if shard and stage >= 3 and dp == 1 and own:
                # one rank: the whole leaf is the shard, in its own layout
                out.append(LeafShard(own, 0, 1, 0))
                continue
            view, unview, shape = (None, None, own) if lay is None else lay
            shape = tuple(int(s) for s in shape)
            d = choose_zero_dim(shape, [None] * len(shape), dp) \
                if shard else None
            if d is None:
                out.append(LeafShard(own, None, dp, rank))
            else:
                out.append(LeafShard(shape, d, dp, rank, view, unview, own))
        return out

    result = ZeroShardingPlan(plan(stage >= 3), plan(stage >= 2),
                              plan(stage >= 1), dp, rank, stage)
    n_sharded = sum(s.sharded for s in result.opt)
    logger.info(f"ZeRO stage {stage}: plan over dp={dp} for {len(shapes)} "
                f"param tensors ({n_sharded} with sharded optimizer state)")
    return result
