"""Tensor parallelism: the collectives GSPMD inserts in the JAX package,
written out (a port-only module).

In JAX tensor parallelism is an annotation: ``runtime/zero/partition.py``
gives each parameter leaf a ``PartitionSpec`` from ``DEFAULT_TP_RULES``
and XLA inserts the collectives the sharded program needs.  Here each
rank of the ``tp`` group holds its slice of every leaf the same rules
shard (the elements of JAX's addressable shard) and the model calls the
collectives itself, Megatron's way:

- :func:`copy_to_tp` — identity forward, all-reduce backward: in front of
  a column-parallel linear, so the gradient of its (replicated) input sums
  every rank's heads or ffn columns;
- :func:`reduce_from_tp` — all-reduce forward, identity backward: after a
  row-parallel linear, a vocab-parallel lookup and the vocab-parallel
  softmax sums;
- :func:`gather_from_tp` — all-gather forward, own slice backward: a bias
  sharded on the features a row-parallel linear outputs (JAX's "row" rule
  takes ``o_proj`` / ``down_proj`` biases), added once after the
  all-reduce, and the logits of generation;
- :func:`slice_of_whole` — a slice of a leaf every rank holds whole (the
  q / k / v / up biases the rules replicate; k / v kernels whose kv heads
  do not divide by tp), all-reduce of the padded gradient backward, so
  every rank holds the whole leaf's gradient, as JAX's replicated
  gradient;
- :func:`vocab_parallel_embedding` and :func:`vocab_parallel_nll_sum` (the
  max, the sum of exponentials and the target logit all-reduced).

Every collective goes through ``comm`` (the comms logger sees it).  At tp
1 no module holds a :class:`TPLayout` and none of this runs.

:func:`tp_plan` places each leaf (:class:`TPLeaf`, the dim of its JAX
layout, per-layer flax paths as the ZeRO plan uses) and
:func:`shard_module_` slices a model in place — a ``meta`` model a
submodule at a time, each drawn whole by the model's init (or copied from
given values) and cut, so every rank holds the chunks of the world-size-1
init.
"""

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch import comm


@dataclass(frozen=True)
class TensorParallel:
    """This rank's place in its tensor-parallel group."""
    size: int
    rank: int
    group: object = None

    @classmethod
    def from_topology(cls, topo, rank=None):
        """The tp group of ``topo`` (built), for world rank ``rank``."""
        from deepspeed_tpu_torch.parallel.topology import TP_AXIS
        me = comm.get_rank() if rank is None else rank
        return cls(topo.tp, topo.index_in((TP_AXIS,), me),
                   topo.group_for((TP_AXIS,)))


# --------------------------------------------------------------------- #
# Region operators
# --------------------------------------------------------------------- #
def _all_reduce(x, tp, name):
    comm.all_reduce(x, group=tp.group, log_name=name)
    return x


class _CopyToTP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.tp, "tp_copy_bwd"), \
            None


class _ReduceFromTP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x.contiguous().clone(), tp, "tp_reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather(x, tp, dim, name):
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    comm.all_gather(parts, x.contiguous(), group=tp.group, log_name=name)
    return torch.cat(parts, dim=dim)


class _GatherFromTP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim, ctx.n = tp, dim, x.shape[dim]
        return _gather(x, tp, dim, "tp_gather")

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.tp.rank * ctx.n, ctx.n), None, None


class _SliceOfWhole(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, tp, dim, lo, n):
        ctx.tp, ctx.dim, ctx.lo, ctx.shape = tp, dim, lo, t.shape
        return t.narrow(dim, lo, n)

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full.narrow(ctx.dim, ctx.lo, g.shape[ctx.dim]).copy_(g)
        return _all_reduce(full, ctx.tp, "tp_slice_bwd"), None, None, None, \
            None


def copy_to_tp(x, tp):
    return _CopyToTP.apply(x, tp)


def reduce_from_tp(x, tp):
    return _ReduceFromTP.apply(x, tp)


def gather_from_tp(x, tp, dim=-1):
    return _GatherFromTP.apply(x, tp, dim % x.dim())


def slice_of_whole(t, tp, dim, lo, n):
    """``t.narrow(dim, lo, n)`` of a leaf every tp rank holds whole; the
    backward sums the ranks' (zero-padded) gradients, so each holds the
    whole leaf's."""
    if lo == 0 and n == t.shape[dim]:
        return t
    return _SliceOfWhole.apply(t, tp, dim, lo, n)


# --------------------------------------------------------------------- #
# Vocab-parallel embedding and loss
# --------------------------------------------------------------------- #
def vocab_parallel_embedding(ids, weight, lo, tp, dtype):
    """Rows ``ids`` of a table whose rows ``[lo, lo + n)`` this rank holds
    (``weight`` [n, h]): ids outside the range look up row 0 and are
    zeroed, then the ranks' lookups are summed (one rank holds each row, so
    the sum is that row's bits)."""
    n = weight.shape[0]
    inside = (ids >= lo) & (ids < lo + n)
    x = F.embedding(torch.where(inside, ids - lo, torch.zeros_like(ids)),
                    weight).to(dtype)
    return reduce_from_tp(x.masked_fill(~inside[..., None], 0), tp)


def vocab_parallel_nll_sum(logits, labels, lo, tp, ignore_index):
    """``models.transformer._nll_sum`` of logits sharded on the vocabulary
    (this rank's columns ``[lo, lo + n)``): the row max all-reduced (MAX,
    no gradient), the sum of exponentials and the target logit all-reduced
    (SUM) — (sum of NLLs, counted tokens, per-token logZ) in fp32, equal on
    every rank."""
    logits = logits.float()
    n = logits.shape[-1]
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    m = logits.detach().amax(dim=-1)
    comm.all_reduce(m, op=comm.ReduceOp.MAX, group=tp.group,
                    log_name="tp_logits_max")
    sumexp = reduce_from_tp((logits - m[..., None]).exp().sum(dim=-1), tp)
    logz = sumexp.log() + m
    inside = (safe >= lo) & (safe < lo + n)
    local = torch.where(inside, safe - lo, torch.zeros_like(safe))
    gold = torch.gather(logits, -1, local[..., None])[..., 0]
    gold = reduce_from_tp(gold * inside, tp)
    return ((logz - gold) * valid).sum(), valid.sum(), logz * valid


# --------------------------------------------------------------------- #
# Placement of a model's leaves
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class TPLeaf:
    """One leaf's tensor-parallel placement: ``dim`` of its JAX layout
    (``view`` of the port tensor, ``unview`` back; None: the same layout),
    ``shape`` that layout's global shape, ``full_shape`` the port tensor's
    global shape."""
    dim: int
    size: int
    rank: int
    shape: tuple
    full_shape: tuple
    view: Optional[Callable] = None
    unview: Optional[Callable] = None

    @property
    def rows(self):
        return self.shape[self.dim] // self.size

    def _laid(self, t):
        return t if self.view is None else self.view(t)

    def _back(self, laid):
        return laid if self.unview is None else self.unview(laid)

    def take(self, full):
        """This rank's slice of the global ``full`` (port layout): a
        compact copy — a view would keep the whole tensor's storage
        alive."""
        part = self._laid(full).narrow(self.dim, self.rank * self.rows,
                                       self.rows)
        return self._back(part).clone(memory_format=torch.contiguous_format)

    def local_shape(self):
        return tuple(self.take(torch.empty(self.full_shape,
                                           device="meta")).shape)

    def gather(self, local, tp):
        """The global tensor (port layout) from every rank's ``local``
        slice (a collective of the tp group)."""
        laid = self._laid(local).contiguous()
        return self._back(_gather(laid, tp, self.dim, "tp_gather_leaf"))


def tp_plan(module, tp, rules=None):
    """``{parameter name: TPLeaf or None}`` for ``module`` (global shapes)
    under the rules (default ``DEFAULT_TP_RULES``) on its per-layer flax
    paths and JAX layouts."""
    from deepspeed_tpu_torch.runtime.zero.partition import tp_dim_of
    paths = module.flax_paths()
    lay = module.jax_layouts()
    out = {}
    for name, p in module.named_parameters():
        view, unview, shape = lay.get(name, (None, None, tuple(p.shape)))
        shape = tuple(int(s) for s in shape)
        d = tp_dim_of(paths[name], shape, tp.size, rules)
        out[name] = None if d is None else TPLeaf(
            d, tp.size, tp.rank, shape, tuple(int(s) for s in p.shape),
            view, unview)
    return out


@dataclass(frozen=True)
class TPLayout:
    """What one attention / MLP / model computes at its tp rank, from the
    plan: the local heads (q heads ``[q_lo, q_lo + heads)``, kv heads
    ``[kv_lo, kv_lo + kv_heads)``), ffn columns, vocabulary rows, and how
    each bias and whole leaf is used."""
    tp: TensorParallel
    sharded: bool = False          # heads / ffn / vocab split over tp
    lo: int = 0                    # first local head / column / row
    n: int = 0                     # local heads / columns / rows
    kv_lo: int = 0
    kv_n: int = 0
    kv_whole: bool = False         # k / v kernels held whole, sliced at use
    in_bias_whole: bool = False    # q/k/v (up/gate) biases whole
    out_bias_sharded: bool = False  # o / down bias sharded: gathered
    pos_lo: int = 0                # embed_positions' rows (model layout)
    pos_sharded: bool = False


def _not_supported(what):
    raise NotImplementedError(
        f"tensor parallelism: {what} is not a placement the port computes "
        f"(its model shards heads, ffn columns and the vocabulary as "
        f"DEFAULT_TP_RULES do)")


def layouts_for(module, plan, tp):
    """``{submodule: TPLayout}`` of a port ``Transformer`` under ``plan``
    (raises for a placement the model does not compute)."""
    cfg = module.config
    out = {}

    def dim(name):
        leaf = plan.get(name)
        return None if leaf is None else leaf.dim

    for name, _ in module.named_parameters():
        if dim(name) is not None and ("norm" in name or "project_" in name):
            _not_supported(f"{name} sharded")
    for i, blk in enumerate(module.layers):
        pre = f"layers.{i}."
        a = pre + "attn."
        q, o = dim(a + "q_proj.weight"), dim(a + "o_proj.weight")
        k, v = dim(a + "k_proj.weight"), dim(a + "v_proj.weight")
        bias = cfg.attn_bias_enabled
        if (q, o) == (1, 0):
            H, KVH = cfg.num_heads, cfg.kv_heads
            n = H // tp.size
            lo = tp.rank * n
            G = H // KVH
            if (k, v) == (1, 1):
                kv_n, kv_lo, whole = KVH // tp.size, tp.rank * KVH // tp.size, \
                    False
            elif (k, v) == (None, None):
                if n % G and G % n:
                    _not_supported(f"{n} local query heads over groups of "
                                   f"{G} (layer {i})")
                kv_lo, whole = lo // G, True
                kv_n = (lo + n - 1) // G - kv_lo + 1
            else:
                _not_supported(f"k_proj / v_proj placed {k} / {v}")
            if bias and dim(a + "q_proj.bias") is not None:
                _not_supported("a sharded q / k / v bias")
            out[blk.attn] = TPLayout(
                tp, True, lo, n, kv_lo, kv_n, whole, bias,
                dim(a + "o_proj.bias") == 0)
        elif (q, o, k, v) == (None,) * 4:
            out[blk.attn] = TPLayout(tp, out_bias_sharded=dim(
                a + "o_proj.bias") == 0)
        else:
            _not_supported(f"attention placed q {q} / o {o} (layer {i})")
        m = pre + "mlp."
        ups = [m + "up_proj.weight"] + (
            [m + "gate_proj.weight"] if cfg.gated_mlp else [])
        dims = {dim(u) for u in ups}
        down = dim(m + "down_proj.weight")
        mbias = cfg.mlp_bias_enabled
        if dims == {1} and down == 0:
            n = cfg.ffn_size // tp.size
            out[blk.mlp] = TPLayout(tp, True, tp.rank * n, n,
                                    in_bias_whole=mbias, out_bias_sharded=dim(
                                        m + "down_proj.bias") == 0)
            if mbias and dim(m + "up_proj.bias") is not None:
                _not_supported("a sharded up / gate bias")
        elif dims == {None} and down is None:
            out[blk.mlp] = TPLayout(tp, out_bias_sharded=dim(
                m + "down_proj.bias") == 0)
        else:
            _not_supported(f"the MLP placed up {dims} / down {down}")
    emb = dim("embed_tokens.weight")
    if emb not in (None, 0):
        _not_supported("embed_tokens sharded on its features")
    head = emb if module.lm_head is None else dim("lm_head.weight")
    if head not in (None, 0, 1) or (module.lm_head is not None
                                    and head == 0):
        _not_supported("the LM head sharded on its features")
    if module.lm_head is not None and module.lm_head.bias is not None and \
            dim("lm_head.bias") is not None:
        _not_supported("a sharded lm_head bias")
    V = cfg.vocab_size
    vn = V // tp.size
    pos = dim("embed_positions.weight") if module.embed_positions is not None \
        else None
    pn = cfg.max_seq_len // tp.size
    out[module] = TPLayout(tp, head is not None, tp.rank * vn, vn,
                           pos_lo=tp.rank * pn, pos_sharded=pos == 0)
    out["embed"] = TPLayout(tp, emb == 0, tp.rank * vn, vn)
    return out


@torch.no_grad()
def shard_module_(module, tp, rules=None, device=None, values=None,
                  generator=None):
    """Slice ``module`` (a port ``Transformer`` at its global shapes) for
    tp rank ``tp.rank`` in place and give its layers their
    :class:`TPLayout`; returns the plan.  A ``meta`` module is materialized
    on ``device``: with ``values`` (``{name: global tensor}``) a submodule
    at a time, copied and cut; with ``generator`` by :func:`init_sharded_`
    (the world-size-1 init's values); without either it stays on ``meta``
    at the local shapes.  A module with storage is cut where it is:
    ``values`` copied in first, else the first tp rank's values broadcast
    over the group, so the slices come from one model whatever each rank
    drew.  A module cut for ``tp`` already keeps its slices."""
    if module._tp_plan is not None:
        if module._tp != tp:
            raise ValueError(f"the module is split over {module._tp}, not "
                             f"{tp}")
        return module._tp_plan
    plan = tp_plan(module, tp, rules)
    lay = layouts_for(module, plan, tp)
    on_meta = any(p.is_meta for p in module.parameters())
    if not on_meta and values is None and tp.group is not None:
        _agree_(module, tp)
    for prefix, mod in module.named_modules():
        if not list(mod.parameters(recurse=False)):
            continue
        if on_meta and values is not None:
            mod.to_empty(device=device, recurse=False)
        # to_empty made new Parameter objects: read them after it
        for n, p in list(mod.named_parameters(recurse=False)):
            name = f"{prefix}.{n}" if prefix else n
            if values is not None:
                p.data.copy_(torch.as_tensor(values[name]).to(p.dtype))
            leaf = plan[name]
            if leaf is None:
                continue
            new = leaf.take(p.data) if not p.is_meta else torch.empty(
                leaf.local_shape(), dtype=p.dtype, device="meta")
            setattr(mod, n, torch.nn.Parameter(
                new, requires_grad=p.requires_grad))
    module.set_tensor_parallel_(tp, plan, lay)
    if on_meta and values is None and generator is not None:
        module.to_empty(device=device)
        init_sharded_(module, plan, generator)
    return plan


def _agree_(module, tp):
    """Every tp rank takes the first tp rank's parameters (through the
    group's device where a parameter lies elsewhere)."""
    src = comm.get_global_rank(tp.group, 0)
    dev = comm.get_device()
    for p in module.parameters():
        t = p.data if dev is None or p.device == dev else p.data.to(dev)
        comm.broadcast(t, src=src, group=tp.group,
                       log_name="tp_broadcast_params")
        if t is not p.data:
            p.data.copy_(t)


@torch.no_grad()
def init_sharded_(module, plan, generator):
    """The model's random init on a module :func:`shard_module_` cut: a
    submodule at a time in ``modules()`` order, each sharded parameter
    drawn whole (its dtype, its device) by ``module.init_weights(generator,
    module=sub)`` and cut to this rank's slice — the world-size-1 init's
    values."""
    for prefix, mod in module.named_modules():
        own = list(mod.named_parameters(recurse=False))
        if not own:
            continue
        for n, p in own:
            leaf = plan.get(f"{prefix}.{n}" if prefix else n)
            if leaf is not None:
                p.data = torch.empty(leaf.full_shape, dtype=p.dtype,
                                     device=p.device)
        module.init_weights(generator, module=mod)
        for n, p in own:
            leaf = plan.get(f"{prefix}.{n}" if prefix else n)
            if leaf is not None:
                p.data = leaf.take(p.data)


def slice_state_dict(sd, plan):
    """A global ``state_dict`` → this rank's (each sharded tensor its
    slice)."""
    return {k: v if plan.get(k) is None else plan[k].take(v)
            for k, v in sd.items()}
