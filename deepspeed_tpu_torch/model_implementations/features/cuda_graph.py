"""CompiledGraphModule — the CUDA-graph feature mixin (port of
``deepspeed_tpu/model_implementations/features/cuda_graph.py``).

The JAX mixin wraps an ``apply`` callable in the reference's capture /
replay contract: ``jax.jit`` compiles one executable per input signature
on the first call and replays it after, ``enable_cuda_graph=False`` calls
``apply`` directly, ``iter_count`` counts calls.  On the card the
counterpart of "one executable per signature, replayed" is a CUDA graph,
captured once per signature.  What the card needs on top:

* **The first call of a signature** runs ``apply`` eagerly on a side
  stream (the warm-up pass: lazy initialisation, cuBLAS plans, the
  call's own result), then captures it into a graph.  Later calls replay.
* **Static buffers.**  A donated argument (``donate_argnums``: a KV
  cache, a slot state) is used in place, and its buffers are part of the
  signature: a graph only ever replays onto the tensors it was captured
  on, which it holds, so they cannot be freed under it.  Other tensor
  arguments are copied into buffers the module owns before each replay.
  The outputs are the graph's own buffers: a caller copies them out
  before the next replay overwrites them.
* **One graph memory pool per module**, shared by its signatures (they
  replay in stream order, never at once); :meth:`reset` drops every
  graph and the pool.
* **Random draws.**  Every ``torch.Generator`` argument is registered
  with the graph (PyTorch's graph-safe generator state): each replay
  draws the numbers an eager call would, reseeding the generator in
  place reseeds the graph, and two replays never repeat their draws.
  A generator is part of the signature, so rebind none: reseed it.
* **Launch accounting.**  Kernel wrappers count launches in Python
  (``op_builder.launch_counters``), which a replay does not run.  The
  counts a capture adds are taken back (a capture launches nothing) and
  added again on every replay, so a run's counts are the eager launches
  plus the captured launches times the replays.

A capture that fails raises: the module never falls back to running
``apply`` eagerly on a card.  On the CPU there is no graph, so ``apply``
runs directly, as with ``enable_cuda_graph=False``.
"""

import torch

from deepspeed_tpu_torch.ops import op_builder


def _flat(x):
    """The leaves of a nested argument (dicts, lists, tuples)."""
    if isinstance(x, dict):
        return [leaf for key in sorted(x) for leaf in _flat(x[key])]
    if isinstance(x, (list, tuple)):
        return [leaf for item in x for leaf in _flat(item)]
    return [x]


def _map(x, fn):
    if isinstance(x, dict):
        return {key: _map(val, fn) for key, val in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_map(item, fn) for item in x)
    return fn(x)


def _leaf_signature(x, donated):
    if isinstance(x, torch.Tensor):
        sig = (tuple(x.shape), x.dtype, x.device, x.stride())
        return sig + (x.data_ptr(),) if donated else sig
    if isinstance(x, torch.Generator):
        return ("generator", id(x))
    return ("value", x)


def _generator_states(args):
    """The CUDA generators a capture draws from — the current device's
    default generator and every generator among ``args`` — each with a
    copy of its state."""
    gens = [torch.cuda.default_generators[torch.cuda.current_device()]]
    gens += [g for g in _flat(args) if isinstance(g, torch.Generator)
             and g.device.type == "cuda"]
    return [(g, g.clone_state()) for g in gens]


def _on_cuda(args):
    return any(isinstance(leaf, torch.Tensor) and leaf.is_cuda
               for leaf in _flat(args))


class _Captured:
    """One signature's graph, its static inputs and outputs, and the
    launch counts one replay adds."""

    def __init__(self, graph, static_args, outputs, launches):
        self.graph = graph
        self.static_args = static_args
        self.outputs = outputs
        self.launches = launches

    def replay(self, args):
        for static, given in zip(_flat(self.static_args), _flat(args)):
            if isinstance(static, torch.Tensor) \
                    and static.data_ptr() != given.data_ptr():
                static.copy_(given)
        self.graph.replay()
        op_builder.add_launch_counts(self.launches)
        return self.outputs


class CompiledGraphModule:
    """Wraps ``apply_fn(*args)`` in the capture / replay contract of the
    reference mixin: captured on the first call per signature (shapes,
    dtypes and devices of the tensor arguments, the donated arguments'
    buffers, the generators and every other argument's value), replayed
    after.  ``enable_cuda_graph=False``, or arguments on the CPU, call
    ``apply_fn`` directly.  ``donate_argnums``: arguments ``apply_fn``
    updates in place (see the module docstring)."""

    def __init__(self, apply_fn, enable_cuda_graph=True, donate_argnums=()):
        self._apply_fn = apply_fn
        self.enable_cuda_graph = enable_cuda_graph
        self._donate = frozenset(donate_argnums)
        self.iter_count = 0
        # graphs captured over this module's life (reset() keeps the count)
        self.captures = 0
        self._graphs = {}
        self._pool = None

    def _signature(self, args):
        return tuple(tuple(_leaf_signature(leaf, i in self._donate)
                           for leaf in _flat(arg))
                     for i, arg in enumerate(args))

    def has_graph(self, *args):
        """True when a call with ``args`` would replay a captured graph."""
        return self._signature(args) in self._graphs

    @property
    def num_graphs(self):
        return len(self._graphs)

    def pool_bytes(self):
        """Device bytes of this module's graph memory pool (what its
        captures allocated: intermediates, outputs, a quantized layer's
        dequantized weights), from the allocator's snapshot; 0 before a
        capture."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def reset(self):
        """Drop every captured graph, its buffers and the memory pool; the
        next call of each signature captures anew."""
        self._graphs.clear()
        self._pool = None

    def __call__(self, *args):
        self.iter_count += 1
        if not (self.enable_cuda_graph and _on_cuda(args)):
            return self._apply_fn(*args)
        key = self._signature(args)
        entry = self._graphs.get(key)
        if entry is not None:
            return entry.replay(args)
        return self._capture(key, args)

    def _capture(self, key, args):
        # static inputs: donated arguments as they are, other tensors copied
        static = tuple(arg if i in self._donate else _map(
            arg, lambda t: t.clone() if isinstance(t, torch.Tensor) else t)
            for i, arg in enumerate(args))
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self._apply_fn(*args)         # the warm-up pass
        current.wait_stream(side)
        for leaf in _flat(out):
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                leaf.record_stream(current)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = op_builder.launch_counts()
        saved = _generator_states(args)
        try:
            graph = torch.cuda.CUDAGraph()
            for gen, _ in saved[1:]:
                graph.register_generator_state(gen)
            with torch.cuda.graph(graph, pool=self._pool):
                outputs = self._apply_fn(*static)
        except Exception as err:
            # a failed capture ends without its epilogue and leaves every
            # generator it drew from in capture mode: put their states back
            torch.cuda.set_stream(current)
            for gen, state in saved:
                gen.graphsafe_set_state(state)
            name = getattr(self._apply_fn, "__name__", repr(self._apply_fn))
            raise RuntimeError(f"CUDA graph capture of {name} failed (no "
                               f"eager fallback): {err}") from err
        finally:
            # the capture launched nothing: take its counts back
            after = op_builder.launch_counts()
            launches = [a - b for a, b in zip(after, before)] \
                + after[len(before):]
            op_builder.add_launch_counts([-n for n in launches])
        self._graphs[key] = _Captured(graph, static, outputs, launches)
        self.captures += 1
        return out
