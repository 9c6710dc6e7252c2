"""Rematerialisation: the port's ``jax.checkpoint`` with its policies and
``checkpoint_name`` call sites, which the model, the kernels' wrappers
and ``runtime/activation_checkpointing`` build on.

A remat region is one ``autograd.Function`` (:func:`remat`): its forward
runs ``fn`` and saves, through ``ctx.save_for_backward``, the region's
tensor arguments plus the outputs its policy keeps; its backward runs
``fn`` again on those arguments, each kept output handed back in place of
computing it again, and back-propagates through that recompute.  A policy
is the set of names whose outputs a region keeps (the JAX
``jax.checkpoint_policies``): aten ops, seen by a ``TorchDispatchMode``
that a region enters only when its policy names one, or call sites that
run through :func:`kept`:

* ``nothing_saveable`` keeps nothing and recomputes the whole region;
* ``everything_saveable`` keeps everything: the region runs unrematerialised;
* ``dots_saveable`` / ``checkpoint_dots`` keep every matrix product
  (``mm``, ``addmm``, ``bmm``, ``baddbmm``);
* ``dots_with_no_batch_dims_saveable`` /
  ``checkpoint_dots_with_no_batch_dims`` keep the weight GEMMs only
  (``mm``, ``addmm``; never a batched attention product).

The model adds the flash-attention policies (``models.transformer.
resolve_remat_policy``), which keep the output and LSE of K1's forward,
the call site ``ops.transformer.flash_attention.FORWARD_OP``, so that the
recompute never launches K1 and runs no op through Python dispatch.  What
a region keeps goes through ``save_for_backward``, so
``torch.autograd.graph.saved_tensors_hooks`` see exactly the bytes a
policy holds for the backward.  The gradient arrives as in the
reference's ``CheckpointFunction``: the backward runs
``torch.autograd.backward`` on the recompute (gradients of tensors the
region closes over, such as a module's parameters, accumulate into their
``.grad``), so a region needs ``.backward()``, not
``torch.autograd.grad``.  A region whose arguments need no gradient
(frozen embeddings before the first block, a data input) still reaches
the tensors it closes over: an empty anchor that requires a gradient
keeps it in the graph, and an output that needs no gradient leaves it
marked non-differentiable.  CPU and CUDA RNG states are restored for the
recompute, as the reference does.
"""

import contextlib
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

DOTS = frozenset({"aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm"})
DOTS_NO_BATCH = frozenset({"aten::mm", "aten::addmm"})
NOTHING = frozenset()
EVERYTHING = frozenset({"*"})

# the stock policies (``jax.checkpoint_policies``' names): the op names
# whose outputs a region keeps
CHECKPOINT_POLICIES = {
    "nothing_saveable": NOTHING,
    "everything_saveable": EVERYTHING,
    "dots_saveable": DOTS,
    "checkpoint_dots": DOTS,
    "dots_with_no_batch_dims_saveable": DOTS_NO_BATCH,
    "checkpoint_dots_with_no_batch_dims": DOTS_NO_BATCH,
}


class _Region:
    """What one remat region keeps: the outputs named in ``keep``, in the
    order its forward computed them; a region built with ``kept`` (the
    recompute) hands those back in that order instead of computing
    them."""

    def __init__(self, keep, kept=None):
        self.keep = keep
        self.replay = None if kept is None else iter(kept)
        self.kept = [] if kept is None else None

    def call(self, name, fn, args, kwargs=None):
        if name not in self.keep:
            return fn(*args, **(kwargs or {}))
        if self.replay is None:
            out = fn(*args, **(kwargs or {}))
            self.kept.append((name, _detached(out)))
            return out
        want, out = next(self.replay, (None, None))
        if want != name:
            raise RuntimeError(
                f"remat: the recompute ran {name} where the forward kept "
                f"{want}; the region must run the same ops both times")
        return _detached(out)

    @contextlib.contextmanager
    def active(self):
        """Within: :func:`kept` call sites and, if the policy names aten
        ops, every aten op go through this region."""
        stack = _regions()
        stack.append(self)
        ops = _AtenOps(self) if any(n.startswith("aten::")
                                    for n in self.keep) \
            else contextlib.nullcontext()
        try:
            with ops:
                yield
        finally:
            stack.pop()


class _AtenOps(TorchDispatchMode):
    """Every aten op through its region: a policy that keeps matrix
    products sees each one (at a Python call per op)."""

    def __init__(self, region):
        super().__init__()
        self.region = region

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return self.region.call(func._schema.name, func, args, kwargs)


_STACK = threading.local()


def _regions():
    """This thread's active regions, innermost last (a CUDA backward runs
    on the autograd engine's device thread)."""
    if not hasattr(_STACK, "regions"):
        _STACK.regions = []
    return _STACK.regions


def kept(name, fn, *args):
    """``fn(*args)`` at a call site named ``name``: inside a remat region
    whose policy keeps ``name``, the forward keeps its outputs and the
    recompute hands them back without calling ``fn``."""
    stack = _regions()
    if not stack:
        return fn(*args)
    return stack[-1].call(name, fn, args)


def _detached(out):
    if isinstance(out, tuple):
        return tuple(None if t is None else t.detach() for t in out)
    return out.detach()


def _pack(kept_outs):
    """A region's kept outputs as (tensors to save, how to rebuild)."""
    tensors, meta = [], []
    for name, out in kept_outs:
        items = out if isinstance(out, tuple) else (out,)
        meta.append((name, isinstance(out, tuple),
                     [t is not None for t in items]))
        tensors += [t for t in items if t is not None]
    return tensors, meta


def _unpack(tensors, meta):
    it = iter(tensors)
    out = []
    for name, is_tuple, present in meta:
        items = tuple(next(it) if p else None for p in present)
        out.append((name, items if is_tuple else items[0]))
    return out


def _local_graph():
    """Saved-tensor hooks that keep the region's own graph off any outer
    hooks (``save_on_cpu``, byte accounting): it lives only while the
    region runs.  They keep a detached alias: a hook that kept the tensor
    itself would make each saved output and its node a reference cycle,
    and the graph would outlive the region until a garbage collection."""
    return torch.autograd.graph.saved_tensors_hooks(lambda t: t.detach(),
                                                    lambda t: t)


def _cuda_devices(tensors):
    return sorted({t.device.index for t in tensors if t.is_cuda})


def _fresh_inputs(args, tensors, needs_grad):
    """``args`` with each tensor detached, requiring a gradient where the
    original did."""
    fresh = iter([t.detach().requires_grad_(g)
                  for t, g in zip(tensors, needs_grad)])
    return [next(fresh) if a is _TENSOR else a for a in args]


_TENSOR = object()          # a tensor argument's place in ctx.args


class _Remat(torch.autograd.Function):

    @staticmethod
    def forward(ctx, fn, keep, anchor, *args):
        tensors = [a for a in args if torch.is_tensor(a)]
        ctx.fn, ctx.keep = fn, keep
        ctx.args = [_TENSOR if torch.is_tensor(a) else a for a in args]
        ctx.needs_grad = [t.requires_grad for t in tensors]
        ctx.devices = _cuda_devices(tensors)
        ctx.cpu_rng = torch.get_rng_state()
        ctx.cuda_rng = [torch.cuda.get_rng_state(d) for d in ctx.devices]
        region = _Region(keep)
        # the region runs with grad on, exactly as its recompute will (a
        # kernel's autograd Function takes its saving path under grad)
        with torch.enable_grad(), _local_graph(), region.active():
            out = fn(*_fresh_inputs(ctx.args, tensors, ctx.needs_grad))
        kept_tensors, ctx.kept_meta = _pack(region.kept)
        ctx.n_in = len(tensors)
        ctx.save_for_backward(*tensors, *kept_tensors)
        ctx.is_tuple = isinstance(out, tuple)
        outs = out if ctx.is_tuple else (out,)
        detached = tuple(t.detach() for t in outs)
        # an output that reaches no tensor needing a gradient needs none
        ctx.mark_non_differentiable(*[d for d, t in zip(detached, outs)
                                      if not t.requires_grad])
        return detached if ctx.is_tuple else detached[0]

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        tensors = saved[:ctx.n_in]
        region = _Region(ctx.keep, _unpack(saved[ctx.n_in:], ctx.kept_meta))
        inputs = _fresh_inputs(ctx.args, tensors, ctx.needs_grad)
        with torch.random.fork_rng(devices=ctx.devices):
            torch.set_rng_state(ctx.cpu_rng)
            for d, state in zip(ctx.devices, ctx.cuda_rng):
                torch.cuda.set_rng_state(state, d)
            with torch.enable_grad(), _local_graph(), region.active():
                out = ctx.fn(*inputs)
        outs = out if ctx.is_tuple else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        if pairs:
            torch.autograd.backward([o for o, _ in pairs],
                                    [g for _, g in pairs])
        fresh = iter(t for t in inputs if torch.is_tensor(t))
        return (None, None, None,
                *[next(fresh).grad if a is _TENSOR else None
                  for a in ctx.args])


def remat(fn, keep, *args):
    """``fn(*args)`` as a remat region that keeps the outputs of the ops
    named in ``keep`` (a policy of :data:`CHECKPOINT_POLICIES` or the
    model's) and recomputes the rest in the backward.  ``EVERYTHING``, or
    grad mode off, runs ``fn`` as it is."""
    if keep == EVERYTHING or not torch.is_grad_enabled():
        return fn(*args)
    tensors = [a for a in args if torch.is_tensor(a)]
    anchor = None
    if not any(t.requires_grad for t in tensors):
        # no argument needs a gradient, but what fn closes over may
        anchor = torch.empty(0, device=tensors[0].device if tensors
                             else None, requires_grad=True)
    return _Remat.apply(fn, keep, anchor, *args)
