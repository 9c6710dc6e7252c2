"""Training config (port of ``deepspeed_tpu/runtime/config.py``).

The same JSON/dict keys as the JAX package's ``DeepSpeedConfig`` drive the
port's training engine: the batch triple (completed and validated against
the data-parallel world, ``mesh_world_size``, with the JAX package's
errors), ``fp16`` (dynamic or static loss
scale), ``bf16``, ``optimizer``, ``scheduler``, ``gradient_clipping``,
``steps_per_print``, ``seed``, the monitor blocks (``tensorboard``,
``wandb``, ``csv_monitor``: ``Train/Samples/*`` events every
``steps_per_print`` steps), the ``fault`` block (crash-atomic
checkpoints, retries, the supervisor), ``nebula`` (the asynchronous
checkpoint writer) and the single-device memory levers:
``zero_optimization.offload_optimizer`` (ZeRO-Offload to ``cpu`` or
``nvme``), ``zero_optimization.grad_partition_groups`` (the partitioned
backward), ``bf16.master_weights_in_bf16`` and
``data_types.grad_accum_dtype``, ``comms_logger`` (the collectives'
log) and ``wall_clock_breakdown`` (the engine's forward / backward / step
timers).  ``zero_optimization.stage`` 0-3 is accepted; at world size 1
stages 0-2 are the single-device layout, at data-parallel size > 1 every
stage partitions as the JAX package does (``runtime/zero/partition.py``),
within groups of ``mics_shard_size`` ranks with MiCS, and
``offload_optimizer`` offloads each rank's shard; ``grad_partition_groups``
runs at every data-parallel size at stages 0-2 (under ZeRO-3 in a group it
raises ``NotImplementedError``).  ``tensor_parallel.tp_size`` > 1 splits
the model over tp ranks (``parallel/tensor_parallel.py``) and the batch
triple counts the data-parallel world, world / tp, as JAX's mesh does
(the engine passes it).  The ``stage3_*`` knobs are parsed and, as in
the JAX package, change nothing: a leaf with no dim divisible by the
group stays whole whatever ``stage3_param_persistence_threshold`` says.
The blocks are plain dataclasses: the card's machine has no pydantic.

Knobs that change behaviour but belong to later slices raise
``NotImplementedError`` when set (``offload_param``, which no JAX engine
path reads either, pipeline / sequence / expert parallelism,
curriculum, compression, and the profiler, compile cache and hybrid
blocks), so a config never silently does nothing.
"""

import dataclasses
import json
import os
from dataclasses import field
from typing import Any, Dict, Optional

from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel
from deepspeed_tpu_torch.runtime.fault.config import FaultConfig
from deepspeed_tpu_torch.utils.logging import log_dist, logger


@dataclasses.dataclass(init=False)
class FP16Config(DeepSpeedConfigModel):
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0          # 0 → dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0


@dataclasses.dataclass(init=False)
class BF16Config(DeepSpeedConfigModel):
    enabled: bool = False
    master_weights_in_bf16: bool = False


@dataclasses.dataclass(init=False)
class OffloadOptimizerConfig(DeepSpeedConfigModel):
    """``zero_optimization.offload_optimizer`` (the JAX
    ``DeepSpeedZeroOffloadOptimizerConfig``): ``device`` ``none`` / ``cpu``
    / ``nvme``; the swap directory's base, staging buffers and pipelining
    of the disk tier; page-locked host state."""
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False


@dataclasses.dataclass(init=False)
class ZeroConfig(DeepSpeedConfigModel):
    """The keys of the JAX ``ZeroConfig`` the port reads; the others are
    kept as attributes.  The ``stage3_*`` knobs are parsed as in JAX and,
    as there, change no placement."""
    stage: int = 0
    offload_param: Optional[Dict[str, Any]] = None
    offload_optimizer: Optional[OffloadOptimizerConfig] = None
    zero_hpz_partition_size: int = 1
    # MiCS: the size of the group a parameter is sharded within (the
    # JAX ``mics_shard_size``; -1 or 0 shards over the whole group)
    mics_shard_size: int = -1
    grad_partition_groups: int = 1
    # elements a gradient bucket holds before its collective (stage 0 / 1:
    # the boundary's all-reduce; stage 2: the backward's reduce-scatter)
    reduce_bucket_size: int = 500_000_000
    stage3_max_live_parameters: int = 1_000_000_000
    stage3_max_reuse_distance: int = 1_000_000_000
    stage3_prefetch_bucket_size: int = 50_000_000
    stage3_param_persistence_threshold: int = 100_000
    stage3_gather_16bit_weights_on_model_save: bool = False

    def validate(self):
        if isinstance(self.offload_optimizer, dict):
            self.offload_optimizer = OffloadOptimizerConfig(
                **self.offload_optimizer)


@dataclasses.dataclass(init=False)
class OptimizerConfig(DeepSpeedConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)


@dataclasses.dataclass(init=False)
class SchedulerConfig(DeepSpeedConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)


@dataclasses.dataclass(init=False)
class CommsLoggerConfig(DeepSpeedConfigModel):
    """The ``comms_logger`` block (the JAX ``CommsLoggerConfig``)."""
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: list = field(default_factory=list)


@dataclasses.dataclass(init=False)
class TensorBoardConfig(DeepSpeedConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclasses.dataclass(init=False)
class WandbConfig(DeepSpeedConfigModel):
    enabled: bool = False
    group: Optional[str] = None
    team: Optional[str] = None
    project: str = "deepspeed_tpu"


@dataclasses.dataclass(init=False)
class CSVConfig(DeepSpeedConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclasses.dataclass(init=False)
class MonitorConfig(DeepSpeedConfigModel):
    """The three monitor blocks (the JAX ``MonitorConfig``)."""
    tensorboard: TensorBoardConfig = field(default_factory=TensorBoardConfig)
    wandb: WandbConfig = field(default_factory=WandbConfig)
    csv_monitor: CSVConfig = field(default_factory=CSVConfig)

    @property
    def enabled(self):
        return (self.tensorboard.enabled or self.wandb.enabled
                or self.csv_monitor.enabled)


@dataclasses.dataclass(init=False)
class NebulaConfig(DeepSpeedConfigModel):
    """The ``nebula`` block: ``enabled`` selects the asynchronous
    checkpoint writer (``NebulaCheckpointEngine``).  Its tiered-storage
    keys are kept as given and, as in the JAX package, change nothing."""
    enabled: bool = False


def _offloaded(block):
    return isinstance(block, dict) and block.get("device", "none") not in (
        None, "none")


def _enabled(pd, key):
    block = pd.get(key)
    return isinstance(block, dict) and bool(block.get("enabled", False))


def _size(pd, key, sub):
    block = pd.get(key)
    return block.get(sub, 1) if isinstance(block, dict) else 1


# knobs of later slices: (predicate on the raw dict, what to say)
_NOT_PORTED = (
    (lambda pd: _offloaded(pd.get(C.ZERO_OPTIMIZATION, {}).get(
        "offload_param")), "zero_optimization.offload_param (no JAX engine "
     "path reads it either)"),
    (lambda pd: _size(pd, C.PIPELINE_PARALLEL, "stages") > 1,
     "pipeline parallelism (pipeline.stages > 1)"),
    (lambda pd: _size(pd, C.SEQUENCE_PARALLEL, "sp_size") > 1,
     "sequence parallelism (sp_size > 1)"),
    (lambda pd: _size(pd, "moe", "ep_size") > 1,
     "expert parallelism (moe.ep_size > 1)"),
    (lambda pd: _enabled(pd, C.CURRICULUM_LEARNING_LEGACY),
     "curriculum_learning"),
    (lambda pd: any(pd.get(C.COMPRESSION_TRAINING, {}) or {}),
     "compression_training"),
    (lambda pd: _enabled(pd, C.FLOPS_PROFILER), "the flops profiler"),
    (lambda pd: _enabled(pd, "compile_cache"), "the compile cache"),
    (lambda pd: _enabled(pd, "hybrid_engine"), "the hybrid engine"),
)


@dataclasses.dataclass(init=False)
class TensorParallelConfig(DeepSpeedConfigModel):
    """The tp axis's size (the rules come from the flax parameter names;
    the JAX block's ``autotp``, which nothing reads there either, parses
    as an extra)."""
    tp_size: int = 1


def load_param_dict(config):
    """The config's dict: a copy of a dict, or a JSON path's contents."""
    if isinstance(config, str):
        if not os.path.exists(config):
            raise FileNotFoundError(
                f"DeepSpeed config path does not exist: {config}")
        with open(config) as f:
            return json.load(f)
    if isinstance(config, dict):
        return dict(config)
    raise ValueError(f"config must be a dict or path, got {type(config)}")


class DeepSpeedConfig:
    """Parse and validate the training config dict (or JSON path) for a
    data-parallel world of ``mesh_world_size`` ranks (default 1)."""

    def __init__(self, config, mesh_world_size=None):
        self._param_dict = load_param_dict(config)
        pd = self._param_dict
        for bad, what in _NOT_PORTED:
            if bad(pd):
                raise NotImplementedError(
                    f"training config: {what} is not ported to "
                    f"deepspeed_tpu_torch yet (see ROADMAP.md, queue A)")

        self.fp16 = FP16Config(**pd.get(C.FP16, {}))
        self.bf16 = BF16Config(**pd.get(C.BF16, pd.get("bfloat16", {})))
        self.zero_config = ZeroConfig(**pd.get(C.ZERO_OPTIMIZATION, {}))
        if self.zero_config.zero_hpz_partition_size not in (0, 1):
            raise ValueError(
                "zero_hpz_partition_size is not supported — use "
                "zero_optimization.mics_shard_size instead")
        if self.zero_config.stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_optimization.stage must be 0-3, got "
                             f"{self.zero_config.stage}")
        self._mesh_world_size = mesh_world_size
        self.tensor_parallel = TensorParallelConfig(
            **pd.get(C.TENSOR_PARALLEL, {}))
        dp = mesh_world_size or 1
        if dp > 1 and self.zero_config.stage >= 3 and \
                int(self.zero_config.grad_partition_groups or 1) > 1:
            raise NotImplementedError(
                "training config: zero_optimization.grad_partition_groups "
                "under ZeRO-3 at data-parallel size > 1 is not ported to "
                "deepspeed_tpu_torch yet: ZeRO-3's unit gathers are its "
                "memory lever (see ROADMAP.md, queue A)")
        if dp == 1 and self.zero_config.stage > 0:
            log_dist(f"zero_optimization.stage {self.zero_config.stage} at "
                     f"world size 1: there is nothing to partition, every "
                     f"stage is the single-device layout", ranks=[0])
        self.optimizer = OptimizerConfig(**pd[C.OPTIMIZER]) \
            if C.OPTIMIZER in pd else None
        self.scheduler = SchedulerConfig(**pd[C.SCHEDULER]) \
            if C.SCHEDULER in pd else None

        self.gradient_clipping = pd.get(C.GRADIENT_CLIPPING,
                                        C.GRADIENT_CLIPPING_DEFAULT)
        self.steps_per_print = pd.get(C.STEPS_PER_PRINT,
                                      C.STEPS_PER_PRINT_DEFAULT)
        self.wall_clock_breakdown = bool(pd.get(C.WALL_CLOCK_BREAKDOWN,
                                                False))
        self.seed = pd.get("seed", 42)
        self.gradient_accumulation_dtype = pd.get("data_types", {}).get(
            "grad_accum_dtype", None)
        self.nebula_config = NebulaConfig(**pd.get("nebula", {}))
        self.monitor_config = MonitorConfig(
            tensorboard=TensorBoardConfig(**pd.get(C.MONITOR_TENSORBOARD, {})),
            wandb=WandbConfig(**pd.get(C.MONITOR_WANDB, {})),
            csv_monitor=CSVConfig(**pd.get(C.MONITOR_CSV, {})))
        self.fault = FaultConfig(**pd.get("fault", {}))
        self.comms_config = CommsLoggerConfig(**pd.get(C.COMMS_LOGGER, {}))

        self.train_batch_size = pd.get(C.TRAIN_BATCH_SIZE)
        self.train_micro_batch_size_per_gpu = pd.get(
            C.TRAIN_MICRO_BATCH_SIZE_PER_GPU)
        self.gradient_accumulation_steps = pd.get(
            C.GRADIENT_ACCUMULATION_STEPS)
        self._configure_train_batch_size()

    @property
    def zero_optimization_stage(self):
        return self.zero_config.stage

    def _configure_train_batch_size(self):
        """Complete / validate the triple against the data-parallel world
        (the JAX package's checks, with its error messages)."""
        dp_world = self._mesh_world_size or 1
        tbs, mbs, gas = (self.train_batch_size,
                         self.train_micro_batch_size_per_gpu,
                         self.gradient_accumulation_steps)
        if tbs is not None and mbs is not None and gas is not None:
            if tbs != mbs * gas * dp_world:
                raise ValueError(
                    f"train_batch_size ({tbs}) != micro_batch ({mbs}) * "
                    f"grad_accum ({gas}) * dp_world ({dp_world})")
        elif tbs is not None and mbs is not None:
            gas = tbs // (mbs * dp_world)
            if gas * mbs * dp_world != tbs:
                raise ValueError(
                    f"train_batch_size {tbs} not divisible by "
                    f"micro_batch*world {mbs * dp_world}")
        elif tbs is not None and gas is not None:
            mbs = tbs // (gas * dp_world)
            if mbs * gas * dp_world != tbs:
                raise ValueError("batch triple inconsistent")
        elif mbs is not None:
            gas = gas or 1
            tbs = mbs * gas * dp_world
        elif tbs is not None:
            mbs = tbs // dp_world
            gas = 1
            if mbs * dp_world != tbs:
                raise ValueError(f"train_batch_size {tbs} not divisible by "
                                 f"dp world {dp_world}")
        else:
            mbs, gas = 1, 1
            tbs = dp_world
            logger.warning("no batch config given; defaulting to "
                           "micro_batch=1, grad_accum=1")
        self.train_batch_size = tbs
        self.train_micro_batch_size_per_gpu = mbs
        self.gradient_accumulation_steps = gas
