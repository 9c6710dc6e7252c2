"""DeepSpeedEngine — the training engine (port of
``deepspeed_tpu/runtime/engine.py``).

The imperative 3-call API and the whole-batch call of the JAX engine::

    loss = engine(batch)        # forward: the loss, graph kept
    engine.backward(loss)       # (loss * scale / gas).backward()
    engine.step()               # optimizer update at the accumulation boundary

    loss = engine.train_batch(batch=stacked)   # [gas, micro, ...] at once

The JAX engine jits each phase into an XLA program over sharded pytrees;
the port runs eagerly on one device.  fp32 master parameters stay on the
module (the model casts each weight to its compute dtype at use, which is
the JAX ``_apply_model`` cast), gradients accumulate in their fp32
``.grad``, and the optimizer updates the parameter list in place with
``torch._foreach_*`` ops, a group of ``SKIP_GROUP_NUMEL`` parameter
elements at a time (every optimizer is elementwise, so the groups give one
call's bits while its temporaries stay one group's).

**The single-device memory levers** (the JAX engine's):

- ``bf16.master_weights_in_bf16`` (with ``bf16.enabled``): the module's
  parameters are cast to bf16 after the init and are the masters; the
  optimizer computes in fp32 and stores its moments in ``state_dtype``.
- ``data_types.grad_accum_dtype``: the accumulation dtype (fp32 by
  default).  Where a parameter's dtype differs from it, each micro step's
  ``.grad`` is cast and added into an accumulator of that dtype and
  cleared (JAX casts every micro step's gradients before the sum);
  otherwise autograd accumulates in ``.grad``.
- ``zero_optimization.grad_partition_groups`` N > 1: each micro step runs
  N forward + backward sweeps inside ``forward()``, each with only its
  group of parameters (contiguous, of about equal bytes) requiring grad.
- ``zero_optimization.offload_optimizer``: the fp32 masters and Adam
  moments move to the host (``runtime/zero/offload.py``), the module's
  parameters are cast to the compute dtype, and the step brings each
  accumulated gradient down into a host buffer (freeing it on the card),
  unscales, takes the norm and clips on the host in fp32, runs the C++
  Adam and uploads the new parameters in one pass.  The tag of a
  checkpoint holds the host state under ``host_optimizer/``.

``step`` unscales by the loss scale, computes the global gradient norm and
clips (the JAX ``_unscale_and_clip``, ``1e-6`` included), updates, and
steps the LR schedule.  With a loss scale that can overflow (fp16), a
non-finite gradient skips the update branch-free — parameters and
optimizer state are selected back with ``torch.where`` on the device flag,
a group of ``SKIP_GROUP_NUMEL`` parameter elements at a time, so the copy
kept for the selection is one group's, not the model's —
and the dynamic scaler updates from the same flag, so no step waits for
the host.  With the static unit scale of bf16 / fp32 the overflow
machinery is compiled out, as in the JAX engine's ``train_batch``.

**Checkpoints.**  ``save_checkpoint`` / ``load_checkpoint`` write and
restore the fp32 master parameters, the optimizer state, the loss scaler,
the LR schedule and the step counters in the port's tag format
(``runtime/checkpoint_engine``), under the JAX engine's tag layout,
``latest`` pointer and, with ``fault.enabled``, its crash-atomic protocol
(``MANIFEST.json``, verified walk-back, retries, retention).  A load copies
into the live tensors in place.  ``save_16bit_model`` exports the weights
under the JAX export's flax-path keys.

**Monitor.**  With a ``tensorboard`` / ``wandb`` / ``csv_monitor`` block
enabled, ``step`` writes the JAX engine's ``Train/Samples/lr`` and
``Train/Samples/train_loss`` events (and, on a card, the device-memory
watermark ``Train/Samples/hbm_*``) every ``steps_per_print`` steps, at
``global_samples``; the loss read waits for the device only then.

**Data parallelism** (ZeRO stages 0, 1, 2).  With a live process group
(``comm.init_distributed``, one process a GPU, started by ``python -m
deepspeed_tpu_torch.launcher.runner``) the engine is one rank of the
topology's data-parallel group and trains one global batch across it, as
the JAX engine does across its mesh: a micro step's batch is the *global*
micro batch (``micro × dp`` rows) and rank r computes on rows ``[r ·
micro, (r + 1) · micro)``; the causal-LM loss divides by the valid
tokens of the whole global batch (``models.transformer.
global_token_count``: the count is all-reduced on the device before the
backward).  The parameters (the fp32, or lean bf16, masters) stay whole
on every rank; ``runtime/zero/partition.py`` places the rest:

- stage 0 and 1: the accumulated gradients are averaged over the group at
  the boundary (all-reduce, a ``reduce_bucket_size`` bucket at a time);
- stage 1: each rank holds its shard of the optimizer state and steps its
  shard of the masters (copied out, contiguous), then the updated shards
  are all-gathered into every rank's parameters (a ``SKIP_GROUP_NUMEL``
  group at a time) — elementwise, so stage 1 is bitwise stage 0;
- stage 2: in addition, the backward reduce-scatters (averaging) each
  gradient bucket into the rank's shard from
  ``register_post_accumulate_grad_hook`` and frees the full ``.grad`` at
  once; over a window the shards accumulate in ``grad_accum_dtype``.
  Buckets are fixed in reverse parameter order, each reduced once all its
  gradients are in, so every rank issues the same collectives whatever
  order autograd produces the gradients in.

A leaf with no dim divisible by dp stays whole (and is averaged whole).
The global gradient norm sums each shard's squared norm over the group
(one all-reduce), counting a whole leaf once; the fp16 overflow flag is
all-reduced with MAX, so every rank skips together; the loss the engine
reports (``_last_loss``, ``Train/Samples/*``) is the global loss.  A
checkpoint tag holds global tensors, as Orbax's do: rank 0 writes, the
sharded optimizer state gathered one tensor at a time, and a load takes
each rank's shard, so a tag moves between world sizes.  At world size 1
every collective is an identity and each stage gives the bits of the
engine without a group.

The partitioned backward (``grad_partition_groups``) runs in a group at
stages 0 - 2 (stage 2 reduce-scatters each micro step's buckets once its
sweeps are done); an offloaded optimizer's tag holds its host state
gathered into global tensors, and each rank takes its piece on load; the
asynchronous (nebula) writer writes the synchronous save's tag, the
gathers done on every rank before its thread starts.

**Tensor parallelism.**  With ``tensor_parallel.tp_size`` > 1 (or a
``topology`` / Megatron ``mpu`` given to ``initialize``) the module is cut
over the tp group by the JAX engine's ``DEFAULT_TP_RULES``
(``parallel/tensor_parallel.py``): each rank holds its heads, ffn columns
and vocabulary rows — a ``meta`` model is drawn whole a submodule at a
time from the seeded init and cut, so every rank holds the chunks of the
world-size-1 init.  The data-parallel group is world / tp; gradients are
reduced over it only.  ZeRO shards each rank's slices (the dim chosen on
the global layout, the tp dim excluded, as JAX's ``apply_zero_to_spec``).
The global norm sums the squares of tp-sharded leaves over the tp group
and counts a leaf every tp rank holds whole once.  A tag holds global
tensors (gathered over the ZeRO shard group, then the tp group; tp rank 0
of dp rank 0 writes), and a load takes each rank's slice, so a tag moves
between any ``tp × dp``.

Not in this slice (ROADMAP.md, queue A): the compile cache, the profiler,
parameter offload, ``zero.Init`` at tp > 1, the partitioned backward under
ZeRO-3 in a group.
"""

import dataclasses
import functools
import os
import shutil
import time
import weakref
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.accelerator import get_accelerator, resolve_device
from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
    NebulaCheckpointEngine, TorchCheckpointEngine, copy_groups,
    flatten_groups)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, load_param_dict
from deepspeed_tpu_torch.runtime.fault import inject
from deepspeed_tpu_torch.runtime.fault.atomic import (atomic_publish_dir,
                                                      atomic_write_text)
from deepspeed_tpu_torch.runtime.fault.manifest import (
    CheckpointCorrupt, build_manifest, gc_checkpoints, is_reserved_tag,
    list_tags, newest_valid_tag, read_latest, read_manifest,
    verify_manifest, write_manifest)
from deepspeed_tpu_torch.runtime.fault.retry import (retry_call,
                                                     retry_policy_from_config)
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (StaticLossScaler,
                                                          create_loss_scaler)
from deepspeed_tpu_torch.monitor.monitor import MonitorMaster
from deepspeed_tpu_torch.runtime.lr_schedules import build_lr_scheduler
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.timer import (BACKWARD_GLOBAL_TIMER,
                                             FORWARD_GLOBAL_TIMER,
                                             STEP_GLOBAL_TIMER,
                                             SynchronizedWallClockTimer,
                                             ThroughputTimer)

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16"}


# the attribute that marks a batch tensor as this rank's rows already
_RANK_ROWS = "_dstt_rank_rows"

# parameter elements per group of the device step: only one group's fp32
# temporaries of the update (and, for the fp16 overflow skip, one group's
# parameters and optimizer state held twice) exist at a time
SKIP_GROUP_NUMEL = 1 << 26


def _state_tensors(state):
    """The tensors of an optimizer state (a NamedTuple of lists / None)."""
    out = []
    for field in state:
        if field is not None:
            out.extend(field)
    return out


def _state_slice(state, sl):
    """The optimizer state of the parameters ``sl`` (the same tensors)."""
    return type(state)(*(None if f is None else f[sl] for f in state))


def _accum_dtype(name):
    """``data_types.grad_accum_dtype`` → a torch dtype (the JAX
    ``_accum_dtype`` table; None means fp32)."""
    table = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
             "fp16": torch.float16, "float16": torch.float16,
             "fp32": torch.float32, "float32": torch.float32}
    want = name or "fp32"
    if want not in table:
        raise ValueError(f"data_types.grad_accum_dtype={want!r}: expected "
                         f"one of {sorted(table)} (or null = fp32)")
    return table[want]


def _skip_groups(params):
    """Consecutive slices of ``params``, each ending where its element
    count reaches ``SKIP_GROUP_NUMEL``."""
    groups, lo, n = [], 0, 0
    for i, p in enumerate(params):
        n += p.numel()
        if n >= SKIP_GROUP_NUMEL:
            groups.append(slice(lo, i + 1))
            lo, n = i + 1, 0
    if lo < len(params):
        groups.append(slice(lo, len(params)))
    return groups


def _buckets(idx, tensors, size):
    """Consecutive runs of ``idx``, each closed when its element count
    reaches ``size``."""
    out, cur, n = [], [], 0
    for i in idx:
        cur.append(i)
        n += tensors[i].numel()
        if n >= size:
            out.append(cur)
            cur, n = [], 0
    if cur:
        out.append(cur)
    return out


def _map_leaves(fn, tree, is_leaf):
    """``tree`` (dicts, lists, tuples, NamedTuples) with each leaf for
    which ``is_leaf`` holds replaced by ``fn(leaf)``."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _map_leaves(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, v, is_leaf) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v, is_leaf) for v in tree)
    return tree


def _map(fn, batch):
    if isinstance(batch, Mapping):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, v) for v in batch)
    return fn(batch)


class _Accumulated:
    """The pending forward of a grouped micro step: its gradients are in
    the running sum already; ``backward`` only closes the micro step."""

    def __init__(self, loss):
        self.loss = loss


class _GlobalLeaf:
    """A sharded optimizer tensor as the checkpoint writer sees it: the
    global tensor, all-gathered when the writer reaches it (``to``) or
    when a rank that writes nothing walks past it (``drain``) — every rank
    gathers each tensor once, in the same order."""

    ckpt_leaf = True

    def __init__(self, part):
        self.part = part
        self.shape = torch.Size(part.leaf.full_shape)
        self.dtype = part.shard.dtype
        self.done = False

    def detach(self):
        return self

    def to(self, device, copy=False):
        if self.done:
            raise RuntimeError("a sharded tensor is gathered once a save: a "
                               "save at data-parallel size > 1 is not "
                               "retried")
        self.done = True
        return self.part.gather().to(device)

    def drain(self):
        if not self.done:
            self.to("cpu")


class _TPPart:
    """A tensor-parallel leaf's slice (a tensor, or a ZeRO ``Partitioned``
    shard of it) as :class:`_GlobalLeaf` / :class:`_ShardTarget` see it:
    ``gather`` makes the global tensor (the ZeRO gather over the shard
    group, then the tp gather), ``scatter_from`` takes this rank's piece
    of it."""

    def __init__(self, inner, tpleaf, tp):
        from types import SimpleNamespace
        self.inner, self.tpleaf, self.tp = inner, tpleaf, tp
        self.shard = getattr(inner, "shard", inner)
        self.leaf = SimpleNamespace(full_shape=tpleaf.full_shape)

    def gather(self):
        local = self.inner.gather() if hasattr(self.inner, "scatter_from") \
            else self.inner.detach()
        return self.tpleaf.gather(local, self.tp)

    @torch.no_grad()
    def scatter_from(self, full):
        local = self.tpleaf.take(full)
        if hasattr(self.inner, "scatter_from"):
            self.inner.scatter_from(local)
        else:
            self.inner.copy_(local)


class _ShardTarget:
    """A sharded optimizer tensor as a load's target: it takes its shard
    of the global tensor read from the tag."""

    ckpt_leaf = True

    def __init__(self, part):
        self.part = part
        self.shape = torch.Size(part.leaf.full_shape)
        self.is_cuda = part.shard.is_cuda
        self.device = part.shard.device

    def copy_(self, full):
        self.part.scatter_from(full.to(self.part.shard.device))
        return self


class DeepSpeedEngine:
    """Training engine: one device, or one rank of a data- and
    tensor-parallel group."""

    def __init__(self, model=None, optimizer=None, model_parameters=None,
                 training_data=None, lr_scheduler=None, collate_fn=None,
                 config=None, loss_fn=None, device=None, topology=None):
        if model is None:
            raise NotImplementedError(
                "the port's engine takes an nn.Module whose forward(batch) "
                "returns the loss; functional models (model=None with "
                "loss_fn) are not ported yet (see ROADMAP.md)")
        if not isinstance(model, nn.Module):
            raise ValueError(f"model must be an nn.Module, got "
                             f"{type(model).__name__}")
        self.device = resolve_device(device)
        self.accelerator = get_accelerator(self.device)
        # the topology first (JAX's order): the config's batch triple
        # counts its data-parallel world, world / tp
        raw = config._param_dict if isinstance(config, DeepSpeedConfig) \
            else {} if config is None else load_param_dict(config)
        tp = topology.tp if topology is not None else int(
            (raw.get("tensor_parallel") or {}).get("tp_size", 1) or 1)
        self._init_data_parallel(
            (raw.get("zero_optimization") or {}).get("mics_shard_size", 0),
            tp, topology)
        self._config = config if isinstance(config, DeepSpeedConfig) \
            else DeepSpeedConfig(raw, mesh_world_size=self.dp_world)
        comm.configure(self._config)
        self.timers = SynchronizedWallClockTimer(self.device)
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_batch_size(),
            steps_per_output=self.steps_per_print())
        self.module = model
        self.loss_fn = loss_fn
        self.training_dataloader = None

        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self._skipped_steps = 0
        self._pending_inf_flags = []   # device overflow flags, read lazily
        self._pending = None           # loss of a forward awaiting backward
        self._window_open = False      # gradients accumulated since the step
        self._found_inf = None
        self._last_loss = None
        self._last_global_grad_norm = None
        self.training = True

        if self._config.fp16.enabled:
            self.compute_dtype = torch.float16
        elif self._config.bf16.enabled:
            self.compute_dtype = torch.bfloat16
        else:
            self.compute_dtype = torch.float32
        model_dtype = getattr(getattr(model, "config", None), "dtype", None)
        if model_dtype is not None and \
                str(model_dtype) != _DTYPE_NAMES[self.compute_dtype]:
            raise ValueError(
                f"the model computes in {model_dtype} but the config asks "
                f"for {_DTYPE_NAMES[self.compute_dtype]} (fp16 / bf16 "
                f"blocks); build the model with "
                f"dtype={_DTYPE_NAMES[self.compute_dtype]!r}")

        # the persistent master parameters' dtype: fp32 unless the
        # memory-lean bf16 masters are on (the optimizer computes in fp32
        # either way)
        bf16 = self._config.bf16
        self._master_dtype = torch.bfloat16 \
            if bf16.enabled and bf16.master_weights_in_bf16 else torch.float32
        if bf16.master_weights_in_bf16 and not bf16.enabled:
            logger.warning(
                "bf16.master_weights_in_bf16 is set but bf16.enabled is "
                "false — masters stay fp32; the memory-lean mode requires "
                "bf16 compute")
        self._accum_dtype = _accum_dtype(
            self._config.gradient_accumulation_dtype)
        off = self._config.zero_config.offload_optimizer
        self._offload_cfg = off if off is not None and off.device != "none" \
            else None
        self._host_opt = None
        self._grad_acc = None      # accumulators where .grad cannot be one

        stage = self.zero_optimization_stage()
        self._stage3 = self._dp and stage >= 3
        # the dtype of the module's parameters without a group (what
        # autograd's .grad has): the compute dtype under offload, else the
        # masters'
        self._module_dtype = self.compute_dtype if self._offload_cfg \
            is not None else self._master_dtype
        self._tp_plan = None
        if self._tp is not None:
            # the weights are in once the module is cut
            self._shard_tensor_parallel(model_parameters)
            model_parameters = None
        on_meta = self._place_module(model_parameters)
        self._params = [p for p in self.module.parameters()
                        if p.requires_grad]
        bad = [p.dtype for p in self._params if p.dtype != torch.float32]
        if bad:
            raise ValueError(f"master parameters must be float32, got {bad}")
        n_params = sum(p.numel() for p in self._params)
        self._plan = None
        self._stage2 = False
        self._masters = None        # stage 3: each sharded leaf's shard
        self._coord = None
        self._grad_shards = None
        if self._dp:
            self._init_zero(model_parameters, on_meta)

        self.optimizer = optimizer or build_optimizer(self._config.optimizer)
        if self._offload_cfg is not None and \
                "adam" not in type(self.optimizer).__name__.lower():
            # the host kernel is Adam / AdamW only: replacing another
            # optimizer would change the training trajectory
            raise ValueError(
                "zero_optimization.offload_optimizer requires an Adam-family "
                f"optimizer, got {type(self.optimizer).__name__}")
        if self._offload_cfg is not None:
            self._init_host_optimizer()
            self._opt_state = None
        else:
            self._cast_params(self._master_dtype)
            self._opt_state = self.optimizer.init(self._opt_templates())
        if self._stage3:
            self._init_coordinator()
        self.lr_scheduler = lr_scheduler or build_lr_scheduler(
            self._config.scheduler, self.optimizer)
        self.loss_scaler = create_loss_scaler(self._config.fp16)
        self._scaler_state = self.loss_scaler.init(self.device)
        self.monitor = MonitorMaster(self._config.monitor_config)
        # a static unit scale cannot overflow: no flag, no skip
        self._static_unit = isinstance(self.loss_scaler, StaticLossScaler) \
            and self.loss_scaler.scale_value == 1.0
        # the nebula block selects the asynchronous writer, as in JAX
        self.checkpoint_engine = NebulaCheckpointEngine(
            self._config.nebula_config) \
            if self._config.nebula_config.enabled else TorchCheckpointEngine()
        # the last save's and load's bytes, files and seconds by phase
        self.checkpoint_stats = {}

        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(
                training_data, collate_fn=collate_fn)
        if self._stage2 and not self._stage3:
            self._register_reduce_hooks()
        log_dist(f"DeepSpeedEngine configured: device={self.device} "
                 f"dtype={_DTYPE_NAMES[self.compute_dtype]} "
                 f"params={n_params / 1e6:.2f}M dp={self.dp_world} "
                 f"zero_stage={self.zero_optimization_stage()} "
                 f"micro_bs={self.train_micro_batch_size_per_gpu()} "
                 f"gas={self.gradient_accumulation_steps()}", ranks=[0])

    # ------------------------------------------------------------------ #
    # Placement
    # ------------------------------------------------------------------ #
    def _place_module(self, model_parameters):
        """Put the module on the device.  A ``meta``-built module gets
        storage there and, unless ``model_parameters`` are given, a random
        init from ``config["seed"]`` through an explicit generator; under
        ZeRO-3 in a group it stays on ``meta`` here and each rank takes its
        shards at birth (:meth:`_partition_params`).  Returns whether the
        module was built on ``meta``."""
        m = self.module
        on_meta = any(t.is_meta for t in
                      list(m.parameters()) + list(m.buffers()))
        if on_meta and self._stage3:
            return True
        if on_meta:
            m.to_empty(device=self.device)
        else:
            m.to(self.device)
        if isinstance(model_parameters, Mapping):
            self.load_params(model_parameters)
        elif on_meta:
            if not hasattr(m, "init_weights"):
                raise ValueError("a meta-built module needs init_weights("
                                 "generator) or model_parameters")
            m.init_weights(self.accelerator.manual_seed(self._config.seed,
                                                        self.device))
        return on_meta

    def _init_data_parallel(self, mics=0, tp=1, topology=None):
        """With a live process group this engine is one rank of the
        topology's data-parallel group (``topology`` when given, else the
        live one if it has groups, ``tp`` and MiCS's split ``mics`` > 0,
        else one built over the live world); without one it is the
        single-device engine (``dp_world`` 1, no collectives).  ZeRO
        shards over ``shard_group`` (MiCS's shard group, else the
        data-parallel group) and, with MiCS, reduces across
        ``replica_group``; at tp > 1 the model is split over ``tp_group``
        (``_tp``)."""
        self._dp = comm.is_initialized()
        self.topology, self.dp_group = None, None
        self.dp_world, self.dp_rank = 1, 0
        self.shard_group, self.replica_group = None, None
        self.shard_world, self.shard_rank = 1, 0
        self.tp_world, self.tp_rank, self.tp_group = 1, 0, None
        self._tp = None
        if not self._dp:
            if tp > 1:
                raise ValueError(
                    f"tensor parallelism (tp {tp}) needs a process group of "
                    f"tp ranks or more: start the ranks with python -m "
                    f"deepspeed_tpu_torch.launcher.runner and call "
                    f"init_distributed() first")
            return
        want = "nccl" if self.device.type == "cuda" else "gloo"
        backend = comm.get_backend()
        if backend is None:
            import torch.distributed as dist
            backend = dist.get_backend()
        if backend != want:
            raise ValueError(
                f"the process group runs {backend} but the engine's device "
                f"is {self.device}: the port trains over nccl on CUDA and "
                f"gloo on the CPU, never one for the other")
        if self.device.type == "cuda" and comm.get_device() is not None \
                and self.device != comm.get_device():
            raise ValueError(f"rank {comm.get_rank()} owns "
                             f"{comm.get_device()}, not {self.device}")
        from deepspeed_tpu_torch.parallel import topology as topo_mod
        mics = int(mics or 0)
        if topology is not None:
            topo = topo_mod.set_topology(topology)
            if topo.groups is None:
                topo.build_groups()
        else:
            topo = topo_mod._TOPOLOGY
            mdp = comm.get_world_size() // tp // mics if mics > 0 else 1
            if topo is None or topo.groups is None or \
                    topo.world_size != comm.get_world_size() or \
                    topo.mdp != mdp or topo.tp != tp:
                topo = topo_mod.initialize_topology(tp=tp, mics=mics)
        self.topology = topo
        if topo.tp > 1:
            from deepspeed_tpu_torch.parallel.tensor_parallel import (
                TensorParallel)
            self._tp = TensorParallel.from_topology(topo)
            self.tp_world, self.tp_rank = self._tp.size, self._tp.rank
            self.tp_group = self._tp.group
        self.dp_group = topo.get_data_parallel_group()
        self.dp_world = topo.get_data_parallel_world_size()
        self.dp_rank = topo.get_data_parallel_rank(comm.get_rank())
        self._dp_src = comm.get_global_rank(self.dp_group, 0)
        self.shard_group = topo.get_zero_shard_group()
        self.replica_group = topo.get_zero_replica_group()
        self.shard_world = topo.get_zero_shard_world_size()
        self.shard_rank = topo.get_zero_shard_rank(comm.get_rank())

    def _shard_tensor_parallel(self, model_parameters):
        """Split the module over the tp group (``shard_module_``, the JAX
        engine's ``DEFAULT_TP_RULES``): a ``meta`` module is materialized
        a submodule at a time from ``model_parameters`` or the seeded init
        (the world-size-1 init's values) and cut; a module with weights is
        cut where it is."""
        from deepspeed_tpu_torch.parallel.tensor_parallel import (
            shard_module_)
        m = self.module
        if getattr(m, "_zero_init_shards", None) is not None:
            raise NotImplementedError(
                "zero.Init at tensor-parallel size > 1 is not ported to "
                "deepspeed_tpu_torch yet: build the model on meta and let "
                "the engine materialize it (see ROADMAP.md, queue A)")
        if not hasattr(m, "flax_paths"):
            raise NotImplementedError(
                f"tensor parallelism places a model by its flax parameter "
                f"paths: {type(m).__name__} has none (flax_paths)")
        values = None
        if isinstance(model_parameters, Mapping):
            values = model_parameters
            if any(isinstance(v, Mapping) for v in values.values()):
                from deepspeed_tpu_torch.models.transformer import (
                    params_from_flax)
                values = params_from_flax(values, m.config)
            values = {k: v if torch.is_tensor(v) else torch.as_tensor(
                np.asarray(v)) for k, v in values.items()}
        on_meta = any(t.is_meta for t in m.parameters())
        gen = None
        if on_meta and values is None:
            if not hasattr(m, "init_weights"):
                raise ValueError("a meta-built module needs init_weights("
                                 "generator) or model_parameters")
            gen = self.accelerator.manual_seed(self._config.seed, self.device)
        self._tp_plan = shard_module_(m, self._tp, device=self.device,
                                      values=values, generator=gen)

    def _tp_leaves(self):
        """Each trainable parameter's ``TPLeaf`` (None: whole over tp), in
        ``engine.params`` order."""
        if self._tp_plan is None:
            return [None] * len(self._params)
        names = [n for n, p in self.module.named_parameters()
                 if p.requires_grad]
        return [self._tp_plan.get(n) for n in names]

    @torch.no_grad()
    def _init_zero(self, model_parameters=None, on_meta=False):
        """Every rank starts from dp rank 0's parameters (a broadcast, an
        identity when they are equal already), then the ZeRO plan of the
        configured stage over the shard group; at stage 3 the parameters
        are partitioned (:meth:`_partition_params`)."""
        from deepspeed_tpu_torch.runtime.zero.partition import \
            build_sharding_plan
        if not on_meta:
            for p in self._params:
                comm.broadcast(p.data, src=self._dp_src, group=self.dp_group,
                               log_name="broadcast_params")
        stage = self.zero_optimization_stage()
        # the JAX model's layouts where the module gives them, so the
        # shards hold the JAX engine's elements
        lay = getattr(self.module, "jax_layouts", dict)()
        self._names = [n for n, p in self.module.named_parameters()
                       if p.requires_grad]
        # a module zero.Init partitioned holds its whole shapes there
        given = getattr(self.module, "_zero_init_shards", None) or {}
        shapes = [given[n].shape if n in given else p.shape
                  for n, p in zip(self._names, self._params)]
        layouts = [lay.get(n) for n in self._names]
        for k, n in enumerate(self._names):
            leaf = getattr(given.get(n), "leaf", None)
            if leaf is not None:
                layouts[k] = None if leaf.view is None else (
                    leaf.view, leaf.unview, leaf.shape)
        tp_dims = [None if t is None else t.dim for t in self._tp_leaves()]
        self._plan = build_sharding_plan(
            shapes, self.shard_world, self.shard_rank, stage, layouts,
            tp_dims)
        self._stage2 = stage >= 2
        if self._stage3:
            self._partition_params(model_parameters, on_meta)

    @torch.no_grad()
    def _partition_params(self, model_parameters, on_meta):
        """ZeRO-3's parameters at birth: each sharded leaf's rank shard
        becomes its master (moved layout, contiguous, master dtype) and
        the whole tensor is dropped; a leaf with no divisible dim stays
        whole on the module.  The whole tensors come from
        ``model_parameters``, from the module's own (after the broadcast),
        or, for a ``meta`` module, from the model's init run a submodule
        at a time from ``config["seed"]`` on the device — the values the
        whole init gives, while no rank holds more than one submodule's
        whole tensors (``zero.partition_at_birth``).  A module that
        ``zero.Init`` materialized brings its shards."""
        from deepspeed_tpu_torch.runtime.zero import (Partitioned,
                                                      partition_at_birth)
        leaves = self._plan.param
        index = {id(p): i for i, p in enumerate(self._params)}
        self._masters = [None] * len(self._params)

        def keep(p, full):
            i = index.get(id(p))
            if i is None:
                p.data = full
                return
            leaf = leaves[i]
            if not leaf.sharded:
                p.data = full
                return
            shard = torch.empty(leaf.shard_shape, dtype=self._master_dtype,
                                device=self.device)
            shard.copy_(leaf.take(full))
            self._masters[i] = shard
            p.data = torch.empty(0, dtype=full.dtype, device=self.device)

        if isinstance(model_parameters, Mapping):
            tree = model_parameters
            if any(isinstance(v, Mapping) for v in tree.values()):
                from deepspeed_tpu_torch.models.transformer import (
                    params_from_flax)
                tree = params_from_flax(tree, self.module.config)
            tree = {k: v if torch.is_tensor(v) else torch.as_tensor(
                np.asarray(v)) for k, v in tree.items()}
            if on_meta:
                self._masters = partition_at_birth(
                    self.module, self._names, leaves, self.device,
                    self._master_dtype, None, values=tree)
            else:
                for name, p in self.module.named_parameters():
                    keep(p, tree[name].to(self.device, torch.float32))
        elif getattr(self.module, "_zero_init_shards", None) is not None:
            given = self.module.__dict__.pop("_zero_init_shards")
            for i, name in enumerate(self._names):
                v, leaf = given[name], leaves[i]
                if isinstance(v, Partitioned) != leaf.sharded or (
                        leaf.sharded and tuple(v.shard.shape) !=
                        tuple(leaf.shard_shape)):
                    raise ValueError(
                        f"zero.Init placed {name} otherwise than this "
                        f"engine's stage-3 plan: build both from the same "
                        f"config")
                if leaf.sharded:
                    self._masters[i] = v.shard.to(self.device,
                                                  self._master_dtype)
                else:
                    self._params[i].data = v.data.to(self.device)
        elif on_meta:
            m = self.module
            if not hasattr(m, "init_weights"):
                raise ValueError("a meta-built module needs init_weights("
                                 "generator) or model_parameters")
            gen = self.accelerator.manual_seed(self._config.seed,
                                               self.device)
            self._masters = partition_at_birth(
                m, self._names, leaves, self.device, self._master_dtype, gen)
        else:
            for p in self._params:
                keep(p, p.data)
        # a meta module's storage came with new Parameter objects
        self._params = [p for p in self.module.parameters()
                        if p.requires_grad]

    def _init_coordinator(self):
        """ZeRO-3's hooks on the module (``runtime/zero/stage3.py``): each
        sharded leaf is gathered in the compute dtype where the model
        casts it to that dtype at use, else in the module's dtype."""
        from deepspeed_tpu_torch.runtime.zero.stage3 import \
            ZeroParamCoordinator
        if not hasattr(self.module, "zero3_units"):
            raise NotImplementedError(
                f"ZeRO-3 at data-parallel size > 1 gathers a unit at a time "
                f"and needs the model's units (zero3_units): "
                f"{type(self.module).__name__} has none")
        own = getattr(self.module, "zero3_own_dtype_params", set)()
        dtypes = [None if m is None else
                  (self._module_dtype if name in own else self.compute_dtype)
                  for name, m in zip(self._names, self._masters)]
        self._coord = ZeroParamCoordinator(
            self.module, self._names, self._params, self._plan.param,
            self._masters, dtypes, self.compute_dtype, self.shard_group,
            self._reduce_indices, self._set_grad_shard,
            torch.promote_types(self._module_dtype, self._accum_dtype),
            self._accum_dtype, self.replica_group)
        # weakly, as the hooks: GatheredParameters finds the coordinator
        me = weakref.ref(self._coord)
        for i, p in enumerate(self._params):
            if self._masters[i] is not None:
                p._zero3 = (me, i)

    def _opt_templates(self):
        """The tensors the optimizer state is made like: each parameter,
        or its shard's shape (moved layout) where the plan shards the
        optimizer state."""
        if self._plan is None:
            return self._params
        if self._stage3:
            return self._step_targets()
        return [p if not leaf.sharded else
                torch.empty(leaf.shard_shape, dtype=p.dtype, device=p.device)
                for p, leaf in zip(self._params, self._plan.opt)]

    def _global_loss(self, loss):
        """The group's average of a detached per-rank loss (each rank's
        loss is its share of the global mean times dp)."""
        if not self._dp:
            return loss
        out = loss.detach().clone()
        return comm.all_reduce(out, op=comm.ReduceOp.AVG,
                               group=self.dp_group, log_name="loss")

    def _sum_over_dp(self, count):
        out = count.clone()
        return comm.all_reduce(out, group=self.dp_group,
                               log_name="token_count")

    @torch.no_grad()
    def _cast_params(self, dtype):
        """Cast the module's floating parameters to ``dtype`` one at a
        time (each fp32 storage is freed as its cast lands)."""
        for p in self.module.parameters():
            if p.is_floating_point() and p.dtype != dtype:
                p.data = p.data.to(dtype)

    def _host_views(self):
        """The device tensors the host optimizer steps, one a parameter:
        each parameter, or in a group this rank's shard of it where the
        optimizer state is sharded (the master shard at stage 3, a view of
        the whole parameter at stages 1 and 2)."""
        if self._plan is None or self._stage3:
            return self._step_targets()
        return [leaf.take(p.data) if leaf.sharded else p
                for p, leaf in zip(self._params, self._plan.opt)]

    def _init_host_optimizer(self):
        """ZeRO-Offload's init (the JAX ``_init_opt_state``): seed the host
        fp32 masters from the fp32 parameters — in a group, from this
        rank's shards, so a rank's host state is its shard's — then cast
        the module's parameters (at stage 3, the master shards) to the
        compute dtype, the card's saving."""
        from deepspeed_tpu_torch.runtime.zero.offload import \
            HostOffloadedAdam
        if self.dp_world > 1 and self.device.type == "cuda":
            # the ranks on this host split its cores for the host Adam (on
            # the CPU the ranks' own torch threads share that OpenMP)
            from deepspeed_tpu_torch.ops.adam import cpu_adam
            cores = len(os.sched_getaffinity(0))
            cpu_adam.set_threads(cores // comm.get_world_size())
        opt = self.optimizer
        # page-locked host buffers only with a card to copy to
        pin = bool(self._offload_cfg.pin_memory) and self.device.type == "cuda"
        views = self._host_views()
        self._host_opt = HostOffloadedAdam(
            views, self._offload_cfg, lr=getattr(opt, "lr", 1e-3),
            betas=(getattr(opt, "beta1", 0.9), getattr(opt, "beta2", 0.999)),
            eps=getattr(opt, "eps", 1e-8),
            weight_decay=getattr(opt, "weight_decay", 0.0),
            adamw_mode=getattr(opt, "adam_w_mode", True),
            bias_correction=getattr(opt, "bias_correction", True), pin=pin)
        self._host_opt.init_from_params(views)
        self._cast_params(self.compute_dtype)
        if self._masters is not None:
            self._masters = [None if m is None else m.to(self.compute_dtype)
                             for m in self._masters]
        # the step's host buffers, made once: fp32 gradients and the bf16
        # bits of the upload (page-locked with pin_memory)
        self._host_grads = [torch.empty(v.numel(), dtype=torch.float32,
                                        pin_memory=pin) for v in views]
        self._upload = None if self.compute_dtype != torch.bfloat16 else [
            torch.empty(v.numel(), dtype=torch.uint16, pin_memory=pin)
            for v in views]
        self.offload_stats = {}

    @torch.no_grad()
    def load_params(self, tree):
        """Replace the master parameters: a ``state_dict``-like mapping of
        this module, or a JAX parameter tree (nested dicts, converted with
        the model's ``params_from_flax``).  Each value is cast to its
        parameter's dtype; under offload the host masters are re-seeded
        from the result (values only: the moments and the step count
        stay)."""
        if any(isinstance(v, Mapping) for v in tree.values()):
            from deepspeed_tpu_torch.models.transformer import (
                params_from_flax)
            tree = params_from_flax(tree, self.module.config)
        sd = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                 else v).to(torch.float32)
              for k, v in tree.items()}
        if getattr(self, "_tp_plan", None) is not None:
            # global tensors: this tp rank's slices
            from deepspeed_tpu_torch.parallel.tensor_parallel import (
                slice_state_dict)
            sd = slice_state_dict(sd, self._tp_plan)
        if getattr(self, "_masters", None) is not None:
            # stage 3: each rank takes its shards
            index = {n: i for i, n in enumerate(self._names)}
            for name, v in sd.items():
                i = index.get(name)
                m = None if i is None else self._masters[i]
                if m is None:
                    self.module.get_parameter(name).data.copy_(v)
                else:
                    m.copy_(self._plan.param[i].take(v.to(self.device)))
        else:
            self.module.load_state_dict(sd)
        if getattr(self, "_host_opt", None) is not None:
            self._host_opt.reseed_masters(self._host_views())

    def put_batch(self, batch, rank_rows=False):
        """``batch`` (tensors or arrays, nested in dicts / lists) on the
        engine's device.  A batch is global: at data-parallel size dp each
        leaf's dim 0 splits into dp equal parts and this rank keeps part
        ``dp_rank`` (JAX's data sharding), unless ``rank_rows`` says the
        batch holds this rank's rows already (the loader's batches, which
        stay marked so a second ``put_batch`` keeps them whole)."""
        def put(x):
            if torch.is_tensor(x) and getattr(x, _RANK_ROWS, False):
                return x
            if not torch.is_tensor(x):
                x = np.asarray(x)
            if self.dp_world > 1 and not rank_rows and x.ndim > 0:
                n = x.shape[0]
                if n % self.dp_world:
                    raise ValueError(
                        f"a global batch of {n} rows does not split over "
                        f"{self.dp_world} data-parallel ranks")
                m = n // self.dp_world
                x = x[self.dp_rank * m:(self.dp_rank + 1) * m]
            given = x
            if not torch.is_tensor(x):
                x = torch.as_tensor(np.ascontiguousarray(x))
            x = x.to(self.device, non_blocking=True)
            if rank_rows and self.dp_world > 1:
                if x is given:          # mark an alias, not the caller's
                    x = x.view_as(x)
                setattr(x, _RANK_ROWS, True)
            return x
        return _map(put, batch)

    def deepspeed_io(self, dataset, batch_size=None, collate_fn=None):
        """The training loader: global batches of ``batch_size`` samples
        (default ``micro × dp``), of which this rank collates and places
        its rows."""
        from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
        return DeepSpeedDataLoader(
            dataset,
            batch_size=batch_size or
            self.train_micro_batch_size_per_gpu() * self.dp_world,
            collate_fn=collate_fn, engine=self)

    # ------------------------------------------------------------------ #
    # Config accessors
    # ------------------------------------------------------------------ #
    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def zero_optimization_stage(self):
        return self._config.zero_config.stage

    def gradient_clipping(self):
        return self._config.gradient_clipping

    def steps_per_print(self):
        return self._config.steps_per_print

    def fp16_enabled(self):
        return self._config.fp16.enabled

    def bfloat16_enabled(self):
        return self._config.bf16.enabled

    def get_global_grad_norm(self):
        return self._last_global_grad_norm

    def get_lr(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler.get_last_lr()
        return [getattr(self.optimizer, "lr", 0.0)]

    def train(self, mode=True):
        self.training = mode
        self.module.train(mode)
        return self

    def eval(self):
        return self.train(False)

    # ------------------------------------------------------------------ #
    # forward / backward / step
    # ------------------------------------------------------------------ #
    def _loss_of(self, args, kwargs):
        args = tuple(self.put_batch(a) for a in args)
        kwargs = {k: self.put_batch(v) for k, v in kwargs.items()}
        if self._dp:
            from deepspeed_tpu_torch.models.transformer import \
                global_token_count
            with global_token_count(self._sum_over_dp, self.dp_world):
                out = self.module(*args, **kwargs)
        else:
            out = self.module(*args, **kwargs)
        return out[0] if isinstance(out, tuple) else out

    def wall_clock_breakdown(self):
        return self._config.wall_clock_breakdown

    def forward(self, *args, **kwargs):
        """The loss of a micro batch; in training mode its graph is kept
        for :meth:`backward`.  With ``wall_clock_breakdown`` the forward
        timer spans it (synced on the card)."""
        timed = self.wall_clock_breakdown()
        if timed:
            self.timers(FORWARD_GLOBAL_TIMER).start()
        try:
            return self._forward(args, kwargs)
        finally:
            if timed:
                self.timers(FORWARD_GLOBAL_TIMER).stop()

    def _forward(self, args, kwargs):
        if not self.training:
            with torch.no_grad():
                return self._global_loss(self._loss_of(args, kwargs))
        self.tput_timer.start()
        if self._pending is not None and self._window_open:
            # this window's gradients would be computed on the wrong sum
            raise RuntimeError(
                "forward() called twice without backward() inside an "
                "accumulation window — call backward(loss) after each "
                "forward")
        n_groups = int(self._config.zero_config.grad_partition_groups or 1)
        if n_groups > 1:
            if self._pending is not None:
                # the grouped passes add into the running sum on the
                # first micro step too
                raise RuntimeError(
                    "forward() called twice without backward() (grouped "
                    "accumulation adds into the running buffer)")
            loss = self._forward_grouped(n_groups, args, kwargs)
            self._pending = _Accumulated(loss)
            self._last_loss = loss
            return loss
        loss = self._loss_of(args, kwargs)
        self._pending = loss
        # the global loss (the group's average of the ranks' shares)
        self._last_loss = self._global_loss(loss.detach())
        return loss

    def _group_bounds(self, n_groups):
        """Contiguous ``engine.params`` index ranges of about equal bytes
        for the partitioned backward (the JAX ``_group_bounds``' rule)."""
        sizes = [p.numel() * p.element_size() for p in self._params]
        total = sum(sizes)
        bounds, lo, acc = [], 0, 0
        for i, s in enumerate(sizes):
            acc += s
            if acc >= total * (len(bounds) + 1) / n_groups \
                    and len(bounds) < n_groups - 1:
                bounds.append((lo, i + 1))
                lo = i + 1
        bounds.append((lo, len(sizes)))
        return [b for b in bounds if b[0] < b[1]]

    def _forward_grouped(self, n_groups, args, kwargs):
        """One micro step of the partitioned backward: a forward and
        backward sweep a group, each with only that group's parameters
        requiring grad, so autograd makes the others' gradients in none of
        them (FLOPs for memory, as in JAX).  In a group the gradients are
        reduced as the stage reduces them: at stages 0 and 1 at the step
        (all-reduce), at stage 2 once the micro step's sweeps are done
        (every bucket reduce-scattered, in bucket order: each parameter's
        ``.grad`` holds this micro step's gradient alone).  Returns the last
        sweep's loss, detached."""
        if self._stage3:
            raise NotImplementedError(
                "zero_optimization.grad_partition_groups under ZeRO-3 in a "
                "group is not ported to deepspeed_tpu_torch yet (ZeRO-3's "
                "unit gathers are its memory lever; see ROADMAP.md, queue A)")
        gas = self.gradient_accumulation_steps()
        try:
            for lo, hi in self._group_bounds(n_groups):
                for i, p in enumerate(self._params):
                    p.requires_grad_(lo <= i < hi)
                loss = self._loss_of(args, kwargs)
                (loss.float() * self._scaler_state.scale / gas).backward()
                if not self._stage2:
                    self._fold_grads()
        finally:
            for p in self._params:
                p.requires_grad_(True)
        if self._stage2:
            self._flush_buckets()
        # the global loss (the group's average of the ranks' shares)
        return self._global_loss(loss.detach())

    __call__ = forward

    def backward(self, loss, retain_graph=False):
        """Accumulate the pending forward's gradients, scaled by the loss
        scale and ``1 / gradient_accumulation_steps``, into the fp32
        ``.grad``s; with a loss scale that can overflow, fold this micro
        step's overflow flag into the window's."""
        if not self.training:
            raise RuntimeError("backward called in eval mode")
        if self._pending is None:
            raise RuntimeError("backward called without a prior forward")
        timed = self.wall_clock_breakdown()
        if timed:
            self.timers(BACKWARD_GLOBAL_TIMER).start()
        try:
            return self._backward(loss, retain_graph)
        finally:
            if timed:
                self.timers(BACKWARD_GLOBAL_TIMER).stop()

    def _backward(self, loss, retain_graph):
        pending, self._pending = self._pending, None
        if not isinstance(pending, _Accumulated):
            gas = self.gradient_accumulation_steps()
            scaled = pending.float() * self._scaler_state.scale / gas
            if self._stage3:
                # the hooks gather each unit for its backward and reduce-
                # scatter its gradients once they are in, in unit order
                self._coord.begin_backward()
                try:
                    scaled.backward(retain_graph=retain_graph)
                finally:
                    self._coord.end_backward()
            elif self._stage2:
                # the hooks reduce-scatter each bucket as its gradients land
                self._reducing = True
                try:
                    scaled.backward(retain_graph=retain_graph)
                finally:
                    self._reducing = False
                self._flush_buckets()
            else:
                scaled.backward(retain_graph=retain_graph)
                self._fold_grads()
        if not self._static_unit:
            # non-finite values are sticky under addition, so the running
            # sum is non-finite iff some micro step's gradients were
            flag = ~torch.isfinite(self._grad_norm(self._grads()))
            self._found_inf = flag if self._found_inf is None \
                else self._found_inf | flag
        self._window_open = True
        self.micro_steps += 1
        return loss

    def is_gradient_accumulation_boundary(self):
        return self.micro_steps % self.gradient_accumulation_steps() == 0

    def zero_grad(self):
        for p in self._params:
            p.grad = None
        self._grad_acc = None
        self._grad_shards = None
        if self._coord is not None:
            self._coord.zero_grad()
        self._window_open = False
        self._found_inf = None

    @torch.no_grad()
    def _fold_grads(self):
        """Add this backward's ``.grad`` of every parameter whose dtype is
        not the accumulation dtype into its accumulator of that dtype (cast
        first, as JAX casts each micro step's gradients), and clear it."""
        acc_dt = self._accum_dtype
        for i, p in enumerate(self._params):
            g = p.grad
            if g is None or p.dtype == acc_dt:
                continue
            if self._grad_acc is None:
                self._grad_acc = [None] * len(self._params)
            if self._grad_acc[i] is None:
                self._grad_acc[i] = g.to(acc_dt)
            else:
                self._grad_acc[i].add_(g.to(acc_dt))
            p.grad = None

    # ------------------------------------------------------------------ #
    # ZeRO-2: the backward's bucketed reduce-scatter
    # ------------------------------------------------------------------ #
    def _register_reduce_hooks(self):
        """Fixed buckets, in reverse parameter order (the order the
        backward produces most gradients in), of about
        ``reduce_bucket_size`` elements; a hook on each parameter marks its
        gradient in and reduces every complete bucket, in bucket order."""
        size = int(self._config.zero_config.reduce_bucket_size)
        buckets, cur, n = [], [], 0
        for i in reversed(range(len(self._params))):
            cur.append(i)
            n += self._params[i].numel()
            if n >= size:
                buckets.append(cur)
                cur, n = [], 0
        if cur:
            buckets.append(cur)
        self._buckets = buckets
        self._bucket_of = {i: b for b, idx in enumerate(buckets)
                           for i in idx}
        self._reducing = False
        self._grad_shards = None
        self._reset_buckets()
        from deepspeed_tpu_torch.runtime.zero.stage3 import _weak_hook
        # weakly: a parameter's hook that held the engine would keep it
        # alive forever (the hook lives in C++, out of the collector's view)
        me = weakref.ref(self)
        self._hooks = [p.register_post_accumulate_grad_hook(
            functools.partial(_weak_hook, me, "_grad_ready", i))
            for i, p in enumerate(self._params)]

    def _reset_buckets(self):
        self._bucket_missing = [len(b) for b in self._buckets]
        self._next_bucket = 0

    def _grad_ready(self, i, p):
        if not self._reducing:
            return
        self._bucket_missing[self._bucket_of[i]] -= 1
        while self._next_bucket < len(self._buckets) and \
                self._bucket_missing[self._next_bucket] == 0:
            self._reduce_bucket(self._next_bucket)
            self._next_bucket += 1

    def _flush_buckets(self):
        """After the backward: reduce the buckets not reduced yet (a
        parameter that got no gradient contributes zeros)."""
        while self._next_bucket < len(self._buckets):
            self._reduce_bucket(self._next_bucket)
            self._next_bucket += 1
        self._reset_buckets()

    def _reduce_bucket(self, b):
        self._reduce_indices(self._buckets[b])

    def _set_grad_shard(self, i, g):
        """Take parameter ``i``'s gradient shard of the window (ZeRO-3's
        coordinator reduces into its own flat buffers)."""
        if self._grad_shards is None:
            self._grad_shards = [None] * len(self._params)
        self._grad_shards[i] = g

    @torch.no_grad()
    def _reduce_indices(self, idx):
        """Average the ``.grad`` of the parameters ``idx`` over the group
        into the window's sums: a sharded gradient reduce-scattered into
        the rank's shard (within MiCS's shard group, then across its
        replica group), in the wider of the module's and the accumulation
        dtype (a stage-3 gradient of a leaf gathered in the compute dtype
        is cast first, as autograd casts it without a group); a whole one
        all-reduced.  The full
        ``.grad`` is freed."""
        from deepspeed_tpu_torch.runtime.comm.coalesced_collectives import (
            all_reduce_coalesced, reduce_scatter_two_hop)
        if not idx:
            return
        if self._grad_shards is None:
            self._grad_shards = [None] * len(self._params)
        plan = self._plan.grad
        grads = {}
        for i in idx:
            p = self._params[i]
            grads[i] = p.grad if p.grad is not None else torch.zeros(
                plan[i].full_shape, dtype=self._module_dtype,
                device=self.device)
            p.grad = None
        split = [i for i in idx if plan[i].sharded]
        whole = [i for i in idx if not plan[i].sharded]
        avg = comm.ReduceOp.AVG
        if split:
            wide = torch.promote_types(self._module_dtype,
                                       self._accum_dtype)
            outs = reduce_scatter_two_hop(
                [plan[i].moved(grads[i]) for i in split], self.shard_group,
                self.replica_group, avg, reduce_dtype=wide, out_dtype=wide)
            for i, o in zip(split, outs):
                self._accumulate(i, o.view(plan[i].shard_shape))
        if whole:
            all_reduce_coalesced([grads[i] for i in whole], self.dp_group,
                                 avg)
            for i in whole:
                self._accumulate(i, grads[i])

    def _accumulate(self, i, g):
        """Add a reduced gradient (shard) into the window's sum, in the
        accumulation dtype (cast first, as ``_fold_grads``)."""
        g = g if g.dtype == self._accum_dtype else g.to(self._accum_dtype)
        cur = self._grad_shards[i]
        if cur is None:
            self._grad_shards[i] = g
        else:
            cur.add_(g)

    def _grads(self):
        """The accumulated gradient of every parameter (zeros where it got
        none); under ZeRO-2 each rank's reduced shard."""
        if self._stage2:
            shards = self._grad_shards or [None] * len(self._params)
            return [g if g is not None else torch.zeros(
                leaf.shard_shape, dtype=self._accum_dtype, device=self.device)
                for g, leaf in zip(shards, self._plan.grad)]
        acc = self._grad_acc or [None] * len(self._params)
        out = []
        for p, a in zip(self._params, acc):
            g = a if a is not None else p.grad
            out.append(g if g is not None
                       else torch.zeros_like(p, dtype=self._accum_dtype))
        return out

    @staticmethod
    def _grad_norm(grads):
        # in fp32 whatever the gradients' dtype (JAX squares fp32 casts)
        return torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads, 2, dtype=torch.float32)))

    def _norm_counted(self, zero_sharded):
        """Which leaves this rank's squares count toward the global norm:
        every logical element once — a leaf whole over the ZeRO shard group
        (``zero_sharded`` False) on shard rank 0 only, a leaf whole over the
        tp group on tp rank 0 only.  None: every leaf."""
        keep = None
        if self._stage2 and self.shard_rank != 0:
            keep = list(zero_sharded)
        if self.tp_world > 1 and self.tp_rank != 0:
            tp = [t is not None for t in self._tp_leaves()]
            keep = tp if keep is None else [a and b for a, b in
                                            zip(keep, tp)]
        return keep

    def _global_norm(self, grads):
        """The global gradient norm.  Stage 0 / 1: the averaged gradients
        are whole and equal on every rank.  Stage 2: each leaf's squared
        shard norms summed over the group (one all-reduce; a whole leaf on
        shard rank 0 only), the root of each, then the norm of those — at
        world size 1 the single-device formula's bits, as sqrt(x * x) is x
        in IEEE arithmetic.  At tp > 1 the squares are also summed over the
        tp group, a leaf every tp rank holds whole counted once."""
        if not self._stage2 and self.tp_world == 1:
            return self._grad_norm(grads)
        norms = torch.stack(torch._foreach_norm(grads, 2,
                                                dtype=torch.float32))
        keep = self._norm_counted(
            [leaf.sharded for leaf in self._plan.grad] if self._stage2
            else [])
        if keep is not None:
            keep = torch.tensor(keep, device=norms.device)
            norms = torch.where(keep, norms, torch.zeros_like(norms))
        sq = norms * norms
        if self._stage2:
            comm.all_reduce(sq, group=self.shard_group, log_name="grad_norm")
        if self.tp_world > 1:
            comm.all_reduce(sq, group=self.tp_group, log_name="grad_norm_tp")
        return torch.linalg.vector_norm(torch.sqrt(sq))

    def _unscale_and_clip(self, grads):
        """Unscale by the loss scale and take the global grad norm (the
        JAX ``_unscale_and_clip``); returns ``(gnorm, factor)``, the clip
        factor (a device scalar, None without clipping) that
        :meth:`_clipped` applies a group at a time."""
        if not self._static_unit:
            torch._foreach_mul_(grads, 1.0 / self._scaler_state.scale)
        gnorm = self._global_norm(grads)
        clip = float(self.gradient_clipping() or 0.0)
        factor = torch.clamp(clip / (gnorm + 1e-6), max=1.0) \
            if clip > 0.0 else None
        return gnorm, factor

    @staticmethod
    def _clipped(grads, factor):
        """``grads`` times the clip factor, in fp32: 16-bit gradients get
        fp32 copies first (JAX's 16-bit gradient times an fp32 factor is
        fp32), fp32 ones are scaled in place."""
        out = [g if g.dtype == torch.float32 else g.float() for g in grads]
        if factor is not None:
            torch._foreach_mul_(out, factor)
        return out

    @torch.no_grad()
    def step(self, lr_kwargs=None):
        """Optimizer step at the accumulation boundary.  With
        ``wall_clock_breakdown`` the step timer spans it, and every
        ``steps_per_print`` steps the forward / backward / step timers are
        logged (ms summed since the last log); without it the step waits
        for nothing."""
        if not self.is_gradient_accumulation_boundary():
            return
        if not self._window_open:
            raise RuntimeError("step called with no accumulated gradients")
        timed = self.wall_clock_breakdown()
        if timed:
            self.timers(STEP_GLOBAL_TIMER).start()
        self._step(lr_kwargs)
        self.tput_timer.stop(global_step=True)
        if timed:
            self.timers(STEP_GLOBAL_TIMER).stop()
            if self.global_steps % self.steps_per_print() == 0:
                self.timers.log([FORWARD_GLOBAL_TIMER, BACKWARD_GLOBAL_TIMER,
                                 STEP_GLOBAL_TIMER])

    def _step(self, lr_kwargs):
        if self._host_opt is not None:
            self._offload_step()
        else:
            self._device_step()
        self.zero_grad()
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        if self.lr_scheduler is not None:
            self.lr_scheduler.step(**(lr_kwargs or {}))
        if self.fp16_enabled() and \
                self.global_steps % self.steps_per_print() == 0:
            before = self._skipped_steps
            skipped = self.skipped_steps        # print-gated flag read
            if skipped > before:
                log_dist(f"overflow: skipped {skipped - before} recent "
                         f"step(s), loss scale "
                         f"{float(self._scaler_state.scale)}", ranks=[0])
        if self.monitor.enabled and self.dp_rank == 0 and \
                self.global_steps % self.steps_per_print() == 0:
            events = [("Train/Samples/lr", self.get_lr()[0],
                       self.global_samples)]
            if self._last_loss is not None:
                # print-gated: the one read of the loss on the host
                events.append(("Train/Samples/train_loss",
                               float(self._last_loss), self.global_samples))
            self.monitor.write_events(events + self._hbm_events())

    def _hbm_events(self):
        """The device-memory watermark events, print-gated like the loss
        read; none where the device reports no memory (the CPU)."""
        from deepspeed_tpu_torch.monitor.memwatch import device_memory_record
        wm = device_memory_record(self.device)
        if not wm.get("peak_bytes_in_use"):
            return []
        return [("Train/Samples/hbm_bytes_in_use", wm["bytes_in_use"],
                 self.global_samples),
                ("Train/Samples/hbm_peak_bytes", wm["peak_bytes_in_use"],
                 self.global_samples)]

    @torch.no_grad()
    def _allreduce_grads(self, grads):
        """Stage 0 / 1: average the accumulated gradients over the group in
        place, a ``reduce_bucket_size`` bucket at a time."""
        from deepspeed_tpu_torch.runtime.comm.coalesced_collectives import \
            all_reduce_coalesced
        size = int(self._config.zero_config.reduce_bucket_size)
        for bucket in _buckets(range(len(grads)), grads, size):
            all_reduce_coalesced([grads[i] for i in bucket], self.dp_group,
                                 comm.ReduceOp.AVG)

    def _any_rank(self, flag):
        """A device flag raised on any rank of the group (MAX)."""
        f = flag.to(torch.uint8)
        comm.all_reduce(f, op=comm.ReduceOp.MAX, group=self.dp_group,
                        log_name="overflow")
        return f.bool()

    def _step_targets(self):
        """What the optimizer updates: the module's parameters, or at stage
        3 each sharded leaf's master shard (whole leaves stay on the
        module)."""
        if self._masters is None:
            return self._params
        return [p if m is None else m
                for p, m in zip(self._params, self._masters)]

    def _step_views(self, sl, grads):
        """The step's targets and gradients for the parameters ``sl``:
        whole parameters and gradients where the optimizer state is whole;
        where it is sharded, contiguous copies of this rank's master shard
        (written back by :meth:`_gather_masters`) and its gradient shard
        (stage 1 takes it from the averaged whole gradient; stage 2 holds
        it already); at stage 3 the master shards themselves, which no
        gather follows."""
        if self._plan is None or self._stage3:
            return self._step_targets()[sl], grads[sl]
        targets, gs = [], []
        for i in range(sl.start, sl.stop):
            leaf, p, g = self._plan.opt[i], self._params[i], grads[i]
            if not leaf.sharded:
                targets.append(p)
                gs.append(g)
                continue
            targets.append(leaf.take(p.data).contiguous())
            gs.append(g if self._stage2 else leaf.take(g).contiguous())
        return targets, gs

    @torch.no_grad()
    def _gather_masters(self, sl, targets):
        """All-gather the updated master shards of ``sl`` into every rank's
        parameters (one collective for the group)."""
        from deepspeed_tpu_torch.runtime.comm.coalesced_collectives import \
            gathered_views
        idx = [i for i in range(sl.start, sl.stop)
               if self._plan.opt[i].sharded]
        if not idx:
            return
        W, views = gathered_views(
            [targets[i - sl.start].reshape(-1) for i in idx],
            self.shard_group)
        for i, rows in zip(idx, views):
            leaf = self._plan.opt[i]
            full = leaf.moved(self._params[i].data).unflatten(
                0, (W, leaf.rows))
            full.copy_(rows.view(W, *leaf.shard_shape))

    def _device_step(self):
        """The optimizer on the card, a group of ``SKIP_GROUP_NUMEL``
        parameter elements at a time: every optimizer of the port updates
        each tensor on its own, so the groups give one call's bits while
        the update's fp32 temporaries stay one group's.  Under ZeRO each
        rank steps its shards, then the group's master shards are
        all-gathered."""
        grads = self._grads()
        if self._dp and not self._stage2:
            self._allreduce_grads(grads)
        lr, step_no = self.get_lr()[0], self.global_steps + 1
        found = None if self._static_unit else self._found_inf
        if found is not None and self._dp:
            found = self._any_rank(found)
        gnorm, factor = self._unscale_and_clip(grads)
        sharded = self._plan is not None and not self._stage3 and any(
            leaf.sharded for leaf in self._plan.opt)
        for sl in _skip_groups(self._step_targets()):
            state = _state_slice(self._opt_state, sl)
            targets, gs = self._step_views(sl, grads)
            gs = self._clipped(gs, factor)
            if found is None:
                self.optimizer.update(gs, state, targets, lr=lr,
                                      step=step_no)
            else:
                # branch-free overflow skip: the group's old values are
                # kept and selected back on the device flag
                live = list(targets) + _state_tensors(state)
                old = [t.clone() for t in live]
                self.optimizer.update(gs, state, targets, lr=lr,
                                      step=step_no)
                for o, n in zip(old, live):
                    torch.where(found, o, n, out=n)
                del old
            if sharded:
                self._gather_masters(sl, targets)
            del targets, gs
        if found is not None:
            self._scaler_state = self.loss_scaler.update(self._scaler_state,
                                                         found)
            self._pending_inf_flags.append(found)
        self._last_global_grad_norm = gnorm

    @torch.no_grad()
    def _offload_step(self):
        """ZeRO-Offload's step (the JAX ``_offload_step``): each
        accumulated gradient comes down into its host buffer and is freed
        on the card as it is queued; on the host, in fp32, the unscale, the
        global norm and the clip; the C++ Adam; one upload of the new
        parameters (bf16 bits, or the fp32 masters when the compute is not
        bf16) into the module's.  An overflow skips the update (norm
        ``inf``).  Two syncs a step: after the downloads, after the
        uploads.  ``offload_stats`` holds the step's seconds and bytes."""
        sync = self.accelerator.synchronize
        t0 = time.perf_counter()
        found = self._found_inf
        if found is not None and self._dp:
            found = self._any_rank(found)
        found = bool(found) if found is not None else False
        grads = self._grads()
        if self._dp and not self._stage2:
            self._allreduce_grads(grads)
        if self._plan is not None and not self._stage2:
            # stage 1: this rank steps the shard of the averaged gradient
            grads = [leaf.take(g) if leaf.sharded else g
                     for g, leaf in zip(grads, self._plan.opt)]
        acc = self._grad_acc
        self._grad_acc = None
        stats = {"found_inf": found}
        if found:
            self.skipped_steps += 1
            # the skipped step's norm is the honest value for telemetry
            self._last_global_grad_norm = float("inf")
        else:
            host = self._host_grads
            nbytes = 0
            for i, p in enumerate(self._params):
                g = grads[i]
                g = g if g.dtype == torch.float32 else g.float()
                host[i].copy_(g.reshape(-1), non_blocking=True)
                nbytes += g.numel() * g.element_size()
                # freed as queued: the card never holds the accumulated
                # gradients and a second copy of them
                grads[i] = g = None
                p.grad = None
                if acc is not None:
                    acc[i] = None
            sync(self.device)
            t1 = time.perf_counter()
            inv = 1.0 / float(self._scaler_state.scale)
            sq = sum(float(np.dot(h.numpy(), h.numpy())) for h in
                     self._norm_leaves(host))
            if self._plan is not None:
                # each shard's square over the shard group (a whole leaf
                # counted on shard rank 0) and the tp group (a leaf whole
                # over tp counted on tp rank 0)
                t = torch.tensor(sq, dtype=torch.float64, device=self.device)
                comm.all_reduce(t, group=self.shard_group,
                                log_name="grad_norm")
                if self.tp_world > 1:
                    comm.all_reduce(t, group=self.tp_group,
                                    log_name="grad_norm_tp")
                sq = float(t)
            gnorm = float(np.sqrt(sq)) * inv
            clip = float(self.gradient_clipping() or 0.0)
            factor = inv * (min(1.0, clip / (gnorm + 1e-6)) if clip > 0.0
                            else 1.0)
            if factor != 1.0:
                for h in host:
                    np.multiply(h.numpy(), np.float32(factor), out=h.numpy())
            self._last_global_grad_norm = gnorm
            t2 = time.perf_counter()
            fp32_out = self.compute_dtype != torch.bfloat16
            outs = self._host_opt.step(host, lr=self.get_lr()[0],
                                       fp32_out=fp32_out, outs=self._upload)
            t3 = time.perf_counter()
            up = 0
            views = self._host_views()
            gather = self._plan is not None and not self._stage3 and any(
                leaf.sharded for leaf in self._plan.opt)
            targets = []
            for v, o in zip(views, outs):
                src = o if fp32_out else o.view(torch.bfloat16)
                if gather and not v.is_contiguous():
                    # a shard of a whole parameter: a contiguous upload,
                    # all-gathered into every rank's parameters below
                    v = torch.empty(v.shape, dtype=v.dtype,
                                    device=self.device)
                v.copy_(src.view(v.shape), non_blocking=True)
                targets.append(v)
                up += src.numel() * src.element_size()
            if gather:
                self._gather_masters(slice(0, len(targets)), targets)
            sync(self.device)
            t4 = time.perf_counter()
            stats.update(d2h_s=t1 - t0, d2h_bytes=nbytes, norm_clip_s=t2 - t1,
                         host_adam_s=t3 - t2, h2d_s=t4 - t3, h2d_bytes=up)
        del grads, acc
        self._scaler_state = self.loss_scaler.update(
            self._scaler_state, torch.tensor(found, device=self.device))
        stats["step_s"] = time.perf_counter() - t0
        self.offload_stats = stats

    def _norm_leaves(self, host):
        """The host gradients the global norm counts on this rank: every
        one, but a leaf whole over the shard group only on shard rank 0
        and one whole over the tp group only on tp rank 0 (each rank holds
        it)."""
        if self._plan is None:
            return host
        keep = [leaf.sharded or self.shard_rank == 0 for leaf in
                self._plan.opt]
        if self.tp_world > 1 and self.tp_rank != 0:
            keep = [k and t is not None for k, t in
                    zip(keep, self._tp_leaves())]
        return [h for h, k in zip(host, keep) if k]

    def train_batch(self, data_iter=None, batch=None):
        """One global batch: ``batch`` stacked ``[gas, micro, ...]`` (or
        ``gas`` micro batches from ``data_iter``) through forward /
        backward per micro batch, then one step; returns the mean of the
        micro losses, as the 3-call sequence gives."""
        gas = self.gradient_accumulation_steps()
        if batch is None:
            micro = [next(data_iter) for _ in range(gas)]
        else:
            micro = [_map(lambda x, i=i: x[i], batch) for i in range(gas)]
        losses = []
        for mb in micro:
            loss = self.forward(mb)
            self.backward(loss)
            # the micro step's global loss (this rank's own without a group)
            losses.append(self._last_loss)
        # set before step() so the step logs this batch's loss
        self._last_loss = torch.stack(losses).float().mean()
        self.step()
        return self._last_loss

    def eval_batch(self, batch):
        prev = self.training
        self.eval()
        out = self.forward(batch)
        self.train(prev)
        return out

    @property
    def skipped_steps(self):
        """Overflow-skipped steps; reading it syncs the queued device
        flags once (the per-step flag is never read on the hot path)."""
        if self._pending_inf_flags:
            flags, self._pending_inf_flags = self._pending_inf_flags, []
            self._skipped_steps += int(torch.stack(flags).sum())
        return self._skipped_steps

    @skipped_steps.setter
    def skipped_steps(self, value):
        self._pending_inf_flags = []
        self._skipped_steps = int(value)

    # ------------------------------------------------------------------ #
    @property
    def params(self):
        return self._params

    def module_state_dict(self):
        """The module's state dict; at stage 3 with each sharded master
        gathered whole (every rank of the shard group takes part, one
        tensor at a time), at tp > 1 each tp slice gathered into the global
        tensor (every rank of the tp group takes part)."""
        sd = self.module.state_dict()
        if self._masters is not None:
            from deepspeed_tpu_torch.runtime.zero import Partitioned
            for name, m, leaf in zip(self._names, self._masters,
                                     self._plan.param):
                if m is not None:
                    sd[name] = Partitioned(m, leaf, self.shard_group).gather()
        if self._tp_plan is not None:
            for name, leaf in self._tp_plan.items():
                if leaf is not None:
                    sd[name] = leaf.gather(sd[name], self._tp)
        return sd

    def max_memory_allocated(self):
        return self.accelerator.max_memory_allocated(self.device)

    # ------------------------------------------------------------------ #
    # Checkpointing (the JAX engine's save_checkpoint / load_checkpoint)
    # ------------------------------------------------------------------ #
    def _fault_config(self):
        fcfg = self._config.fault
        return fcfg if fcfg.enabled else None

    def _checkpoint_arrays(self, sharded_as=None):
        """The tag's array groups, as the live tensors: ``module`` (the
        master ``state_dict``, detached views of the parameters; the
        compute-dtype parameters under offload), ``optimizer`` (its state
        NamedTuple of per-parameter lists, in ``engine.params`` order; None
        under offload, whose host state goes to ``host_optimizer/``) and
        ``loss_scaler``.  A tag holds global tensors: ``sharded_as``
        (``_GlobalLeaf`` for a save, ``_ShardTarget`` for a load) stands in
        for each sharded optimizer tensor at data-parallel size > 1."""
        from deepspeed_tpu_torch.runtime.zero import Partitioned
        state = self._opt_state
        split = sharded_as is not None and self._plan is not None and \
            self.shard_world > 1
        tps = self._tp_leaves() if sharded_as is not None else \
            [None] * len(self._params)

        def part(t, leaf, tpleaf):
            # the global tensor behind this rank's piece: the ZeRO shard
            # over the shard group, then the tp slice over the tp group
            inner = Partitioned(t, leaf, self.shard_group) \
                if split and leaf is not None and leaf.sharded else None
            if tpleaf is not None:
                return sharded_as(_TPPart(
                    inner if inner is not None else t, tpleaf, self._tp))
            return t if inner is None else sharded_as(inner)

        if (split or self.tp_world > 1) and state is not None:
            state = type(state)(*(
                None if field is None else
                [part(t, leaf, tpl) for t, leaf, tpl in
                 zip(field, self._plan.opt, tps)]
                for field in state))
        module = self.module.state_dict()
        if self.tp_world > 1 and sharded_as is not None:
            names = [n for n, p in self.module.named_parameters()
                     if p.requires_grad]
            for name, tpl in zip(names, tps):
                if tpl is not None and (self._masters is None or
                                        self._masters[names.index(name)]
                                        is None):
                    module[name] = part(module[name], None, tpl)
        if self._masters is not None:
            # stage 3: the masters (over one rank, a view of the whole)
            for name, m, leaf, tpl in zip(self._names, self._masters,
                                          self._plan.param, tps):
                if m is not None:
                    module[name] = part(m, leaf, tpl) if split or \
                        tpl is not None else leaf.from_moved(m)
        return {"module": module,
                "optimizer": state,
                "loss_scaler": self._scaler_state}

    def _checkpoint_meta(self, client_state):
        """The JAX engine's ``meta.pkl`` keys.  There is no
        ``rng_key_data``: the port's engine draws no random numbers after
        its init (dropout is not ported), so a resumed run needs no RNG
        state to be bitwise the uninterrupted one; loading a tag that has
        the key ignores it."""
        cfg = getattr(self.module, "config", None)
        return {
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "micro_steps": self.micro_steps,
            "skipped_steps": self.skipped_steps,
            "lr_scheduler": self.lr_scheduler.state_dict()
            if self.lr_scheduler else None,
            "ds_config": self._config._param_dict,
            "client_state": client_state or {},
            # the port's own key: the model's config, for offline tools
            # that rename the weights to flax paths (zero_to_fp32)
            "model_config": dataclasses.asdict(cfg)
            if dataclasses.is_dataclass(cfg) else None,
        }

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True, exclude_frozen_parameters=False):
        """Write the engine's state under ``<save_dir>/<tag>/state`` (tag
        ``global_step<N>`` by default) and point ``latest`` at it; with
        ``fault.enabled`` through the crash-atomic protocol.
        ``exclude_frozen_parameters`` is accepted for the JAX signature and,
        as there, changes nothing: every module tensor is saved."""
        save_dir = str(save_dir)
        if tag is None:
            tag = f"global_step{self.global_steps}"
        tag = str(tag)
        if self._grouped_save():
            return self._save_checkpoint_dp(save_dir, tag, client_state,
                                            save_latest)
        return self._save_checkpoint_arrays(save_dir, tag,
                                            self._checkpoint_arrays(),
                                            client_state, save_latest)

    def _grouped_save(self):
        """A save or load that every rank of the group takes part in: at
        data- or tensor-parallel size > 1."""
        return self._dp and (self.dp_world > 1 or self.tp_world > 1)

    def _writer(self):
        """Whether this rank writes a tag: data-parallel rank 0 of tp
        rank 0 (world rank 0 of the topology)."""
        return self.dp_rank == 0 and self.tp_rank == 0

    def _save_checkpoint_dp(self, save_dir, tag, client_state, save_latest):
        """A save at data- or tensor-parallel size > 1: one rank writes the
        tag (its own protocol, no retries) while every rank gathers each
        sharded tensor (over the ZeRO shard group, then the tp group) in
        the same order — under offload each rank's host state too; then
        the writer's outcome is broadcast, so every rank returns or raises
        alike."""
        arrays = self._checkpoint_arrays(sharded_as=_GlobalLeaf)
        host = self._host_state_global() if self._host_opt is not None \
            else None
        if getattr(self.checkpoint_engine, "use_async", False):
            # the asynchronous writer's thread takes no part in the
            # gathers: every rank gathers here, the writer keeps host copies
            arrays = _map_leaves(
                lambda t: t.to("cpu") if self._writer() else t.drain(),
                arrays, lambda t: isinstance(t, _GlobalLeaf))
        lazy = [t for _, t in flatten_groups(arrays)
                if isinstance(t, _GlobalLeaf)]
        ok = torch.ones((), dtype=torch.int32, device=self.device)
        error = None
        try:
            if self._writer():
                try:
                    self._save_checkpoint_arrays(save_dir, tag, arrays,
                                                 client_state, save_latest,
                                                 host=host)
                except Exception as e:      # raised after the others know
                    error = e
                    ok.zero_()
        finally:
            for t in lazy:
                t.drain()
        if self.tp_world > 1:
            comm.broadcast(ok, src=self.topology.ranks[0],
                           log_name="checkpoint_status")
        else:
            comm.broadcast(ok, src=self._dp_src, group=self.dp_group,
                           log_name="checkpoint_status")
        if error is not None:
            raise error
        if not int(ok):
            raise RuntimeError(f"checkpoint {tag}: the save failed on data-"
                               f"parallel rank 0")
        return True

    @torch.no_grad()
    def _host_state_global(self):
        """The offloaded optimizer's host state as global tensors (flat
        fp32, ``engine.params`` order): each rank's shards gathered over
        the shard group, then the tp group, one leaf at a time, on every
        rank; the writer keeps them, the others None."""
        from deepspeed_tpu_torch.runtime.zero import Partitioned
        sd = self._host_opt.state_dict()
        tps = self._tp_leaves()
        out = {"step": sd["step"]}
        for key in ("masters", "exp_avg", "exp_avg_sq"):
            full = []
            for i, flat in enumerate(sd[key]):
                leaf = self._plan.opt[i] if self._plan is not None else None
                t = flat.to(self.device)
                if leaf is not None and leaf.sharded:
                    t = Partitioned(t.view(leaf.shard_shape), leaf,
                                    self.shard_group).gather()
                if tps[i] is not None:
                    t = tps[i].gather(t.view(tps[i].local_shape()), self._tp)
                full.append(t.reshape(-1).cpu() if self._writer() else None)
            out[key] = full
        return out

    def _host_slicer(self):
        """``cut(i, flat global tensor)`` → this rank's flat host piece of
        leaf ``i`` (the tp slice, then the ZeRO shard); None in a world of
        one rank."""
        if not self._grouped_save():
            return None
        tps = self._tp_leaves()
        plan = self._plan

        def cut(i, flat):
            tpl = tps[i]
            t = flat.view(tpl.full_shape) if tpl is not None else flat
            if tpl is not None:
                t = tpl.take(t)
            leaf = plan.opt[i] if plan is not None else None
            if leaf is not None and leaf.sharded:
                t = leaf.take(t.view(leaf.full_shape))
            return t.contiguous().reshape(-1)
        return cut

    def _save_host(self, path, host):
        """The offloaded optimizer's host state under ``path``: this
        engine's own, or ``host`` (a state dict of global tensors)."""
        if host is None:
            self._host_opt.save(path)
        else:
            from deepspeed_tpu_torch.runtime.zero.offload import \
                save_host_state
            save_host_state(path, host)

    def _save_checkpoint_arrays(self, save_dir, tag, arrays, client_state,
                                save_latest, host=None):
        fcfg = self._fault_config()
        if fcfg is not None:
            return self._save_checkpoint_atomic(save_dir, tag, arrays,
                                                client_state, save_latest,
                                                fcfg, host=host)
        t0 = time.monotonic()
        ckpt_dir = os.path.join(save_dir, tag)
        os.makedirs(ckpt_dir, exist_ok=True)
        self.checkpoint_engine.create(tag)
        if self._host_opt is not None:
            # one .npy file a tensor, never one pickle of the whole state
            self._save_host(os.path.join(ckpt_dir, "host_optimizer"), host)
        self.checkpoint_engine.save(arrays, self._checkpoint_meta(
            client_state), os.path.join(ckpt_dir, "state"))
        # commit (the async engine: the arrays are on disk) BEFORE moving
        # 'latest' — a crash mid-save leaves it on the previous checkpoint
        self.checkpoint_engine.commit(tag)
        if save_latest:
            atomic_write_text(os.path.join(save_dir, "latest"), tag)
        self.checkpoint_stats = {
            "save": {**self.checkpoint_engine.stats.get("save", {}),
                     "total_s": time.monotonic() - t0}}
        log_dist(f"saved checkpoint {tag} to {save_dir}", ranks=[0])
        return True

    def _save_checkpoint_atomic(self, save_dir, tag, arrays, client_state,
                                save_latest, fcfg, host=None):
        """Crash-atomic checkpoint protocol (``fault.enabled``): stage into
        ``<tag>.tmp/``, emit ``MANIFEST.json`` (sizes, checksums,
        fingerprint, step metadata), fsync, rename to ``<tag>/``, swap
        ``latest`` atomically, then GC per the retention policy.  A kill
        at any instruction leaves the previous consistent state or the new
        one, never a loadable partial.  Transient I/O during the write
        stage retries with backoff."""
        if is_reserved_tag(tag):
            # '<x>.tmp' / '<x>.old.<pid>' are the protocol's staging
            # namespace — the next GC pass would destroy such a tag
            raise ValueError(
                f"checkpoint tag {tag!r} collides with the crash-atomic "
                "staging namespace ('*.tmp' / '*.old.<pid>'); pick "
                "another tag")
        t0 = time.monotonic()
        os.makedirs(save_dir, exist_ok=True)
        final_dir = os.path.join(save_dir, tag)
        tmp_dir = final_dir + ".tmp"
        meta = self._checkpoint_meta(client_state)

        def write_stage():
            if os.path.isdir(tmp_dir):      # stale orphan / failed attempt
                shutil.rmtree(tmp_dir)
            os.makedirs(tmp_dir)
            inject.fire("ckpt.save_io", path=tmp_dir)
            self.checkpoint_engine.create(tag)
            if self._host_opt is not None:
                self._save_host(os.path.join(tmp_dir, "host_optimizer"),
                                host)
            self.checkpoint_engine.save(arrays, meta,
                                        os.path.join(tmp_dir, "state"))
            # the async engine's arrays and deferred metadata must be on
            # disk before the manifest walks the staging dir
            self.checkpoint_engine.commit(tag)

        # the gathers of a data-parallel save happen once: no retry there
        policy = retry_policy_from_config(fcfg) \
            if not self._grouped_save() else retry_policy_from_config(None)
        retry_call(write_stage, label=f"checkpoint write ({tag})", **policy)
        t1 = time.monotonic()
        inject.fire("ckpt.before_manifest", path=tmp_dir)
        manifest = build_manifest(
            tmp_dir, tag,
            step_meta={"global_steps": self.global_steps,
                       "global_samples": self.global_samples,
                       "micro_steps": self.micro_steps},
            checksum=fcfg.checksum, advance_latest=bool(save_latest))
        write_manifest(tmp_dir, manifest)
        t2 = time.monotonic()
        inject.fire("ckpt.corrupt_shard", path=os.path.join(tmp_dir, "state"))
        inject.fire("ckpt.before_commit_rename", path=tmp_dir)
        atomic_publish_dir(tmp_dir, final_dir)
        inject.fire("ckpt.before_latest_swap", path=save_dir)
        if save_latest:
            atomic_write_text(os.path.join(save_dir, "latest"), tag)
        # retention never deletes this tag nor 'latest''s target (they
        # differ under save_latest=False)
        protect = {tag}
        latest = read_latest(save_dir)
        if latest:
            protect.add(latest)
        gc_checkpoints(save_dir, fcfg.keep_last_n, protect=tuple(protect))
        t3 = time.monotonic()
        self.checkpoint_stats = {"save": {
            **self.checkpoint_engine.stats.get("save", {}),
            "write_stage_s": t1 - t0, "manifest_s": t2 - t1,
            "publish_s": t3 - t2, "total_s": t3 - t0}}
        log_dist(f"saved checkpoint {tag} to {save_dir} "
                 f"(manifest {len(manifest['files'])} files, "
                 f"checksum {t2 - t1:.2f}s)", ranks=[0])
        return True

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True,
                        load_module_only=False):
        """Restore a tag written by :meth:`save_checkpoint` into this
        engine, in place.  Returns ``(path, client_state)``, or
        ``(None, {})`` when there is nothing to load.  With
        ``fault.enabled`` and ``tag=None`` the newest valid resume-eligible
        tag is taken (verified against its manifest; a corrupt or partial
        tag is walked past, a transient I/O error retries the same tag);
        an explicitly requested tag that fails raises."""
        load_dir = str(load_dir)
        fcfg = self._fault_config()
        requested = tag
        knobs = (load_module_strict, load_optimizer_states,
                 load_lr_scheduler_states, load_module_only)
        if tag is None:
            tag = read_latest(load_dir)
            if tag is None and fcfg is None:
                logger.warning(f"no 'latest' file at {load_dir}; "
                               "nothing loaded")
                return None, {}
        if fcfg is None:
            return self._load_checkpoint_tag(load_dir, tag, *knobs)
        # fault-tolerant load: the manifest step order, not 'latest', is
        # authoritative for resume-eligible tags (the pointer lags one tag
        # when a crash lands between the tag rename and the pointer swap)
        if requested is None:
            tag = None
        tried = []
        t0 = time.monotonic()
        verify_s = 0.0
        pre_verified = False
        while True:
            if tag is None:
                tv = time.monotonic()
                tag = newest_valid_tag(load_dir,
                                       checksum_verify=fcfg.verify_on_load,
                                       skip=tried, for_resume=True)
                verify_s += time.monotonic() - tv
                # newest_valid_tag checksummed it already
                pre_verified = fcfg.verify_on_load
            if tag is None:
                remaining = [t for t in list_tags(load_dir)
                             if t not in tried]
                # tags that should have been candidates but were rejected,
                # apart from side checkpoints (advance_latest=false)
                eligible = [t for t in remaining
                            if (read_manifest(os.path.join(load_dir, t))
                                or {}).get("advance_latest") is not False]
                if tried or eligible:
                    raise RuntimeError(
                        f"no valid checkpoint in {load_dir}: every "
                        "resume-eligible tag failed verification or load "
                        f"(tried={tried or eligible})")
                if remaining:
                    logger.warning(
                        f"{load_dir} holds only side checkpoints "
                        f"(save_latest=False: {remaining}); nothing "
                        "loaded — starting fresh")
                else:
                    logger.warning(f"no checkpoint found at {load_dir}; "
                                   "nothing loaded")
                return None, {}
            ckpt_dir = os.path.join(load_dir, str(tag))
            if fcfg.verify_on_load and not pre_verified \
                    and read_manifest(ckpt_dir) is not None:
                tv = time.monotonic()
                problems = verify_manifest(ckpt_dir, deep=True)
                verify_s += time.monotonic() - tv
                if problems:
                    if requested is not None:
                        # an explicitly requested tag fails loudly: older
                        # weights in its place would poison evals/exports
                        raise CheckpointCorrupt(
                            f"requested checkpoint {tag!r} in {load_dir} "
                            f"failed verification: {problems[:5]}")
                    logger.warning(
                        f"[fault] checkpoint {tag} failed verification "
                        f"({problems[:3]}) — walking back to the previous "
                        "valid tag")
                    tried.append(str(tag))
                    tag = None
                    continue
            try:
                # a transient I/O error retries the SAME tag first —
                # walking back on a flake would discard committed steps
                result = retry_call(self._load_checkpoint_tag, load_dir,
                                    tag, *knobs,
                                    label=f"checkpoint load ({tag})",
                                    **retry_policy_from_config(fcfg))
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                if requested is not None:
                    raise
                logger.warning(f"[fault] tag {tag} failed to load "
                               f"({type(e).__name__}: {e}); walking back")
                tried.append(str(tag))
                tag = None
                continue
            latest = read_latest(load_dir)
            if requested is None and latest and latest != str(tag):
                logger.warning(
                    f"[fault] resuming from {tag} although 'latest' "
                    f"points at {latest} (newest valid resume-eligible "
                    "tag wins; for a manual rollback load an explicit tag "
                    "or remove the newer tags)")
            self.checkpoint_stats.setdefault("load", {}).update(
                verify_s=verify_s, total_s=time.monotonic() - t0)
            return result

    def _restore_targets(self, load_optimizer_states, load_module_only):
        """The live tensors a load writes into: the module always, the
        optimizer state unless told not to, the loss scaler unless only
        the module is loaded."""
        live = self._checkpoint_arrays(sharded_as=_ShardTarget)
        targets = {"module": live["module"]}
        if not load_module_only:
            if load_optimizer_states and live["optimizer"] is not None:
                targets["optimizer"] = live["optimizer"]
            targets["loss_scaler"] = live["loss_scaler"]
        return targets

    def _restore_meta(self, meta, load_lr_scheduler_states,
                      load_module_only):
        # the loaded state is a step boundary: no half-done window
        self.zero_grad()
        self._pending = None
        if load_module_only:
            return
        self.global_steps = meta.get("global_steps", 0)
        self.global_samples = meta.get("global_samples", 0)
        self.micro_steps = meta.get("micro_steps", 0)
        self.skipped_steps = meta.get("skipped_steps", 0)
        if load_lr_scheduler_states and self.lr_scheduler \
                and meta.get("lr_scheduler"):
            self.lr_scheduler.load_state_dict(meta["lr_scheduler"])

    def _load_checkpoint_tag(self, load_dir, tag, load_module_strict=True,
                             load_optimizer_states=True,
                             load_lr_scheduler_states=True,
                             load_module_only=False):
        """Copy one tag into the live tensors.  At world size 1 the JAX
        engine's fresh-engine and metadata restore-target paths (which
        reshard onto another mesh) reduce to this in-place ``copy_``: the
        parameters and optimizer lists keep their identity."""
        t0 = time.monotonic()
        path = os.path.join(load_dir, str(tag), "state")
        arrays, meta = self.checkpoint_engine.load(
            path, targets=self._restore_targets(load_optimizer_states,
                                                load_module_only),
            strict=load_module_strict)
        if arrays is None:
            # permanent (not an OSError, which the retry policy would
            # treat as transient); fault-enabled loads walk back past it
            raise CheckpointCorrupt(
                f"checkpoint {tag!r} at {path} has no loadable 'arrays' "
                "payload (partial or corrupt save?) — cannot restore "
                "module weights")
        host_dir = os.path.join(load_dir, str(tag), "host_optimizer")
        self._restore_host_optimizer(
            load_optimizer_states and not load_module_only
            and os.path.isdir(host_dir), lambda: self._host_opt.load(
                host_dir, cut=self._host_slicer()))
        self._restore_meta(meta, load_lr_scheduler_states, load_module_only)
        self.checkpoint_stats = {"load": {
            **self.checkpoint_engine.stats.get("load", {}),
            "tag_s": time.monotonic() - t0}}
        log_dist(f"loaded checkpoint {tag} from {load_dir}", ranks=[0])
        return path, meta.get("client_state", {})

    def load_state(self, arrays, meta=None, load_module_strict=True,
                   load_optimizer_states=True, load_lr_scheduler_states=True,
                   load_module_only=False):
        """Copy array groups held in memory (``module`` / ``optimizer`` /
        ``loss_scaler``, e.g. from ``models.transformer.
        engine_state_from_flax``) and a tag's ``meta`` into this engine in
        place, with :meth:`load_checkpoint`'s knobs.  Returns the
        ``client_state``."""
        meta = meta or {}
        host = arrays.get("host_optimizer")
        copy_groups(self._restore_targets(load_optimizer_states,
                                          load_module_only),
                    {k: v for k, v in arrays.items()
                     if v is not None and k != "host_optimizer"},
                    strict=load_module_strict)
        self._restore_host_optimizer(
            load_optimizer_states and not load_module_only
            and host is not None,
            lambda: self._host_opt.load_state_dict(
                host, cut=self._host_slicer()))
        self._restore_meta(meta, load_lr_scheduler_states, load_module_only)
        return meta.get("client_state", {})

    def _restore_host_optimizer(self, have_state, load):
        """Under offload, after the module is restored: the saved host
        state when ``have_state`` (``load()``); otherwise fresh masters from
        the loaded parameters with zero moments — stale masters would
        overwrite the loaded weights at the next step."""
        if self._host_opt is None:
            return
        if have_state:
            load()
        else:
            self._host_opt.init_from_params(self._host_views())

    @torch.no_grad()
    def save_16bit_model(self, save_dir, save_filename="pytorch_model.bin",
                         hf_policy=None):
        """The weights in 16 bits for serving, under the JAX export's
        flax-path keys and layouts (``params_to_flax``; the compute dtype,
        bf16 for an fp32 engine): a ``.safetensors`` file for that suffix,
        a ``torch.save`` state dict otherwise.  Both load through either
        package's ``InferenceEngine.load_checkpoint``.  ``hf_policy``: an
        injection policy instance or an HF ``model_type`` string (``"opt"``)
        whose ``export_convert`` renames the weights to that family's HF
        checkpoint keys instead (``module_inject.convert_hf_model`` reads
        them back)."""
        if self._grouped_save():
            # the parameters are whole on every rank (at stage 3 and over
            # tp, gathered on every rank): one rank writes
            sd = self.module_state_dict()
            if self._writer():
                self._save_16bit_model(save_dir, save_filename, hf_policy,
                                       sd)
            del sd
            comm.barrier()
            return True
        return self._save_16bit_model(save_dir, save_filename, hf_policy)

    @torch.no_grad()
    def _save_16bit_model(self, save_dir, save_filename, hf_policy,
                          sd=None):
        from deepspeed_tpu_torch.checkpoint.safetensors_io import save_file
        from deepspeed_tpu_torch.models.transformer import params_to_flax
        sd = self.module_state_dict() if sd is None else sd
        save_dir = str(save_dir)
        os.makedirs(save_dir, exist_ok=True)
        dtype = self.compute_dtype if self.compute_dtype != torch.float32 \
            else torch.bfloat16
        cfg = self.module.config
        if hf_policy is None:
            flat = params_to_flax(sd, cfg, dtype=dtype)
        else:
            if isinstance(hf_policy, str):
                from types import SimpleNamespace
                from deepspeed_tpu_torch.module_inject import policy_for
                hf_policy = policy_for(SimpleNamespace(model_type=hf_policy))
            # rename in fp32 (numpy has no bf16; the renames only move
            # elements), then round each tensor once to the 16-bit dtype
            flat = hf_policy.export_convert(
                {k: v.numpy() for k, v in params_to_flax(
                    sd, cfg).items()}, cfg)
            flat = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dtype)
                    for k, v in flat.items()}
        path = os.path.join(save_dir, save_filename)
        if save_filename.endswith(".safetensors"):
            save_file(flat, path)
        else:
            torch.save(flat, path)
        log_dist(f"saved 16-bit model ({len(flat)} tensors, {dtype}) to "
                 f"{path}", ranks=[0])
        return True
