"""Activation checkpointing (rematerialisation) — port of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``, with
its public names: ``configure`` / ``is_configured`` / ``get_config``,
``checkpoint(fn, *args)`` and ``checkpoint_wrapper``, the RNG tracker and
``reset``.

The remat'd call is the port's ``jax.checkpoint``,
:func:`deepspeed_tpu_torch.utils.remat.remat`, under the configured
policy (a name of ``CHECKPOINT_POLICIES`` or an alias); CPU
checkpointing is ``torch.autograd.graph.save_on_cpu(pin_memory=True)``
around the region.

* ``partition_activations`` shards saved activations over tensor-parallel
  ranks: it means something only at tp > 1, which the port does not have
  (ROADMAP.md), so asking for it raises.
* ``contiguous_memory_optimization`` is accepted and logged as a no-op
  (the caching allocator's job), as in JAX.

Usage matches the JAX package::

    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing
    checkpointing.configure(None, deepspeed_config=cfg)
    y = checkpointing.checkpoint(fn, *args)          # remat'd call
    ckpt_fn = checkpointing.checkpoint_wrapper(fn)   # decorator form
"""

import contextlib
import functools

import torch

from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.remat import (  # noqa: F401
    CHECKPOINT_POLICIES, NOTHING, remat)


# ---------------------------------------------------------------------------
# The configured module (the JAX package's module-level state)
# ---------------------------------------------------------------------------
def _defaults():
    return {"partition_activations": False,
            "contiguous_memory_optimization": False,
            "cpu_checkpointing": False,
            "number_checkpoints": None,
            "synchronize_checkpoint_boundary": False,
            "profile": False,
            "policy": "nothing_saveable"}


_config = _defaults()
_configured = False

# reference-vocabulary aliases of the stock policies
_POLICY_ALIASES = {
    "full": "everything_saveable",          # no recompute (checkpointing off)
    "none": "nothing_saveable",             # recompute everything
    "dots": "dots_saveable",
    "dots_no_batch": "dots_with_no_batch_dims_saveable",
}


def _resolve_policy(name):
    name = _POLICY_ALIASES.get(name, name)
    keep = CHECKPOINT_POLICIES.get(name)
    if keep is None:
        logger.warning(f"unknown remat policy {name!r}; using "
                       f"nothing_saveable")
        keep = NOTHING
    return keep


def _check_partition(flag):
    if flag:
        raise NotImplementedError(
            "partition_activations shards saved activations over "
            "tensor-parallel ranks; tensor parallelism (tp > 1) is not "
            "ported to deepspeed_tpu_torch yet (see ROADMAP.md)")


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None,
              policy=None):
    """Configure the subsystem (reference ``configure() :789``) from a
    config with an ``activation_checkpointing`` block (a dict, or an
    object with ``activation_checkpointing_config``) and explicit
    keyword overrides."""
    global _configured
    block = {}
    if deepspeed_config is not None:
        getter = getattr(deepspeed_config, "activation_checkpointing_config",
                         None)
        if getter is not None:
            block = dict(getter) if isinstance(getter, dict) else {
                k: getattr(getter, k) for k in _config if hasattr(getter, k)}
        elif isinstance(deepspeed_config, dict):
            block = deepspeed_config.get("activation_checkpointing", {})
    new = dict(_config)
    new.update({k: v for k, v in block.items()
                if k in new and v is not None})
    overrides = {
        "partition_activations": partition_activations,
        "contiguous_memory_optimization": contiguous_checkpointing,
        "number_checkpoints": num_checkpoints,
        "cpu_checkpointing": checkpoint_in_cpu,
        "synchronize_checkpoint_boundary": synchronize,
        "profile": profile,
        "policy": policy,
    }
    new.update({k: v for k, v in overrides.items() if v is not None})
    _check_partition(new["partition_activations"])
    _config.update(new)
    if _config["contiguous_memory_optimization"]:
        logger.info("contiguous_memory_optimization: the caching "
                    "allocator's job on the GPU; accepted as a no-op")
    _configured = True
    logger.info(f"activation checkpointing configured: {_config}")


def is_configured():
    """Reference ``is_configured() :871``."""
    return _configured


def get_config():
    return dict(_config)


def checkpoint(function, *args, **kwargs):
    """Remat'd call of ``function(*args, **kwargs)`` under the configured
    policy (reference ``checkpoint() :708``); with ``cpu_checkpointing``
    the region's saved tensors wait in pinned host memory."""
    if kwargs:
        function = functools.partial(function, **kwargs)
    offload = torch.autograd.graph.save_on_cpu(pin_memory=True) \
        if _config["cpu_checkpointing"] else contextlib.nullcontext()
    with offload:
        return remat(function, _resolve_policy(_config["policy"]), *args)


def checkpoint_wrapper(function):
    """Decorator form: returns a remat'd version of ``function``."""
    return functools.wraps(function)(
        lambda *args, **kwargs: checkpoint(function, *args, **kwargs))


# ---------------------------------------------------------------------------
# RNG tracker (reference ``CudaRNGStatesTracker :121``) on explicit
# torch.Generators: ``fork`` yields the named generator, whose state the
# draws inside advance, so a second fork continues the stream
# ---------------------------------------------------------------------------
class RNGStatesTracker:
    """Named ``torch.Generator`` states; ``fork(name)`` yields the
    generator to draw from (``torch.randn(..., generator=g)``)."""

    def __init__(self):
        self.states_ = {}

    def reset(self):
        self.states_ = {}

    def get_states(self):
        return {name: g.get_state() for name, g in self.states_.items()}

    def set_states(self, states):
        for name, state in states.items():
            self.states_[name].set_state(state)

    def add(self, name, seed, device=None):
        """A generator seeded with ``seed`` on ``device`` (None: the
        card; pass ``"cpu"`` for the CPU)."""
        if name in self.states_:
            raise Exception(f"rng state {name} already exists")
        g = torch.Generator(device=device or "cuda")
        g.manual_seed(seed)
        self.states_[name] = g

    @contextlib.contextmanager
    def fork(self, name="model-parallel-rng"):
        if name not in self.states_:
            raise Exception(f"rng state {name} not added")
        yield self.states_[name]


_RNG_TRACKER = RNGStatesTracker()


def get_cuda_rng_tracker():
    """Name kept for call-site parity (reference ``:193``)."""
    return _RNG_TRACKER


def model_parallel_cuda_manual_seed(seed, device=None):
    """Reference ``:198``: seed a default state plus a tp-offset state so
    dropout differs across tp ranks where it should."""
    _RNG_TRACKER.reset()
    _RNG_TRACKER.add("model-parallel-rng", seed + 2718, device)
    _RNG_TRACKER.add("data-parallel-rng", seed, device)
    return _RNG_TRACKER


def reset():
    """Test helper: restore defaults."""
    global _configured
    _configured = False
    _config.update(_defaults())
