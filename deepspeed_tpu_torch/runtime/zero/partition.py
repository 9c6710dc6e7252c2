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

Tensor parallelism places leaves by the JAX module's rules, copied here
(``DEFAULT_TP_RULES``, ``tp_spec_for``, run on the per-layer flax paths and
JAX layouts by ``parallel/tensor_parallel.py``); ``build_sharding_plan``'s
``tp_dims`` keep ZeRO off the dim a leaf's tp rank slice was cut on.

The shard is kept in the **moved layout**: the chosen dim first
(``movedim(d, 0)``), rows ``[r * c, (r + 1) * c)``, contiguous.  Flattened,
that is the r-th of ``dp`` equal pieces of the leaf's moved flat buffer,
which is what the coalesced collectives (``runtime/comm``) hand rank r, so
the per-leaf plan and the bucket layouts agree.  ``to_natural`` gives the
shard in the rule's layout's dim order (JAX's shard).
"""

import re
from dataclasses import dataclass
from typing import Callable, List, Optional

from deepspeed_tpu_torch.utils.logging import logger

ZERO_AXIS = "dp"
TP_AXIS = "tp"


# --------------------------------------------------------------------- #
# Tensor-parallel sharding rules — the JAX module's, byte for byte: a
# ``(regex over the flax path, kind)`` list, first match wins.  "col" shards
# the output features (the last dim of a 2-D kernel, the head dim ndim-2 of
# a >= 3-D one), "row" the first input dim (dim 0), "vocab" dim 0 of an
# embedding; "replicate" and no match keep the leaf whole.  A stacked
# expert parameter (a path component ``experts`` / ``experts_*``) shards
# its per-expert shape.
# --------------------------------------------------------------------- #
EXPERT_PARAM_PATTERN = r"(^|/)experts(_[a-z0-9_]+)?(/|$)"

DEFAULT_TP_RULES = [
    (r"(q_proj|k_proj|v_proj|qkv|query|key|value|gate_proj|up_proj|wi|fc1|fc_in|c_fc|dense_h_to_4h).*(kernel|weight)$", "col"),
    (r"(o_proj|out_proj|down_proj|wo|fc2|fc_out|c_proj|dense_4h_to_h|attention_output|dense$).*", "row"),
    (r"(embed|wte|word_embeddings|embed_tokens).*(embedding|kernel|weight)$", "vocab"),
    (r"(lm_head|output_projection).*(kernel|weight)$", "col"),
    (r".*(norm|ln_|layernorm|layer_norm|bias|scale).*", "replicate"),
]


def tp_dim_for(kind, ndim, expert_stacked=False):
    """The dim a rule kind shards (None: whole): col → the output dim (the
    last of a 2-D kernel, the head dim ndim-2 of a >= 3-D one), row and
    vocab → dim 0; ``expert_stacked`` skips the leading expert dim."""
    if expert_stacked:
        inner = tp_dim_for(kind, ndim - 1)
        return None if inner is None or inner < 0 else inner + 1
    col_dim = ndim - 1 if ndim == 2 else ndim - 2
    dim = {"col": col_dim, "row": 0, "vocab": 0}.get(kind)
    return None if dim is not None and dim < 0 else dim


def is_expert_stacked(path_str, ndim):
    """Does the leaf carry a leading stacked-expert dim?"""
    return re.search(EXPERT_PARAM_PATTERN, path_str.lower()) is not None \
        and ndim >= 2


def tp_rule_kind(path_str, rules=None):
    """The kind of the first rule whose regex matches ``path_str``
    (lower-cased), None when none does."""
    rules = rules if rules is not None else DEFAULT_TP_RULES
    low = path_str.lower()
    for pattern, kind in rules:
        if re.search(pattern, low):
            return kind
    return None


def tp_spec_for(path_str, shape, tp_size, rules=None, expert_stacked=False):
    """The leaf's tensor-parallel spec (a tuple of ``"tp"`` / None per
    dim), as JAX's ``tp_spec_for`` gives it on a mesh whose tp axis has
    ``tp_size`` devices: a rule applies only when its dim divides by the
    tp size (an odd vocabulary stays whole)."""
    ndim = len(shape)
    spec = [None] * ndim
    if tp_size == 1:
        return tuple(spec)
    kind = tp_rule_kind(path_str, rules)
    if kind is not None:
        dim = tp_dim_for(kind, ndim, expert_stacked=expert_stacked)
        if dim is not None and dim >= 0 and shape[dim] % tp_size == 0:
            spec[dim] = TP_AXIS
    return tuple(spec)


def tp_dim_of(path_str, shape, tp_size, rules=None):
    """The dim :func:`tp_spec_for` shards over tp, None when whole."""
    spec = tp_spec_for(path_str, shape, tp_size, rules,
                       expert_stacked=is_expert_stacked(path_str, len(shape)))
    return spec.index(TP_AXIS) if TP_AXIS in spec else None


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



def build_sharding_plan(shapes, dp, rank, stage, layouts=None,
                        tp_dims=None):
    """The ZeRO partitioner: parameter shapes (in order) → placements for
    params / grads / optimizer state at ``stage`` over a group of ``dp``
    ranks, this one ``rank``.  ``layouts[i]``, when given and not None, is
    ``(view, unview, shape)``: the rule runs on that layout of leaf i (the
    JAX model's, see ``models.transformer.Transformer.jax_layouts``).
    ``tp_dims[i]``: the dim of that layout tensor parallelism shards (the
    shapes are then this tp rank's slices), never ZeRO's, as JAX's
    ``apply_zero_to_spec`` skips a dim its TP spec took; the other dims
    are the global leaf's, so the choice is the global shape's."""
    layouts = layouts or [None] * len(shapes)
    tp_dims = tp_dims or [None] * len(shapes)

    def plan(shard):
        out = []
        for own, lay, tpd in zip(shapes, layouts, tp_dims):
            own = tuple(int(s) for s in own)
            if shard and stage >= 3 and dp == 1 and own:
                # one rank: the whole leaf is the shard, in its own layout
                out.append(LeafShard(own, 0, 1, 0))
                continue
            view, unview, shape = (None, None, own) if lay is None else lay
            shape = tuple(int(s) for s in shape)
            spec = [TP_AXIS if i == tpd else None for i in range(len(shape))]
            d = choose_zero_dim(shape, spec, dp) if shard else None
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
