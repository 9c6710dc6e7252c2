"""Training config (port of ``deepspeed_tpu/runtime/config.py``).

The same JSON/dict keys as the JAX package's ``DeepSpeedConfig`` drive the
port's training engine at world size 1: the batch triple (completed and
validated with the JAX package's errors), ``fp16`` (dynamic or static loss
scale), ``bf16``, ``optimizer``, ``scheduler``, ``gradient_clipping``,
``steps_per_print``, ``seed``, the ``fault`` block (crash-atomic
checkpoints, retries, the supervisor) and ``nebula`` (the asynchronous
checkpoint writer).  ``zero_optimization.stage`` 0-3 is
accepted and trivially satisfied at world size 1 (there is nothing to
partition).  The blocks are plain dataclasses: the card's machine has no
pydantic.

Knobs that change behaviour but belong to later slices raise
``NotImplementedError`` when set (offload, MiCS, tensor / pipeline /
sequence / expert parallelism, curriculum, compression, partitioned
backward, bf16 master weights, a non-fp32 gradient accumulator, and the
monitor, profiler, compile cache and hybrid blocks), so a config never
silently does nothing.
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
class ZeroConfig(DeepSpeedConfigModel):
    """The keys of the JAX ``ZeroConfig`` this slice reads; the others are
    kept as attributes."""
    stage: int = 0
    offload_param: Optional[Dict[str, Any]] = None
    offload_optimizer: Optional[Dict[str, Any]] = None
    zero_hpz_partition_size: int = 1
    mics_shard_size: int = -1
    grad_partition_groups: int = 1


@dataclasses.dataclass(init=False)
class OptimizerConfig(DeepSpeedConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)


@dataclasses.dataclass(init=False)
class SchedulerConfig(DeepSpeedConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)


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
        "offload_param")) or _offloaded(pd.get(C.ZERO_OPTIMIZATION, {}).get(
            "offload_optimizer")), "ZeRO offload (offload_param / "
     "offload_optimizer)"),
    (lambda pd: (pd.get(C.ZERO_OPTIMIZATION, {}).get("mics_shard_size") or 0)
     > 0, "zero_optimization.mics_shard_size (MiCS)"),
    (lambda pd: (pd.get(C.ZERO_OPTIMIZATION, {}).get("grad_partition_groups")
                 or 1) > 1, "zero_optimization.grad_partition_groups > 1"),
    (lambda pd: _size(pd, C.TENSOR_PARALLEL, "tp_size") > 1,
     "tensor parallelism (tp_size > 1)"),
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
    (lambda pd: pd.get(C.BF16, {}).get("master_weights_in_bf16", False),
     "bf16.master_weights_in_bf16"),
    (lambda pd: (pd.get("data_types", {}).get("grad_accum_dtype")
                 or "fp32") not in ("fp32", "float32"),
     "data_types.grad_accum_dtype other than fp32"),
    (lambda pd: any(_enabled(pd, k) for k in (
        C.MONITOR_TENSORBOARD, C.MONITOR_WANDB, C.MONITOR_CSV)),
     "the monitor (tensorboard / wandb / csv_monitor)"),
    (lambda pd: _enabled(pd, C.FLOPS_PROFILER), "the flops profiler"),
    (lambda pd: _enabled(pd, "compile_cache"), "the compile cache"),
    (lambda pd: _enabled(pd, "hybrid_engine"), "the hybrid engine"),
)


class DeepSpeedConfig:
    """Parse and validate the training config dict (or JSON path) at
    world size 1."""

    def __init__(self, config):
        if isinstance(config, str):
            if not os.path.exists(config):
                raise FileNotFoundError(
                    f"DeepSpeed config path does not exist: {config}")
            with open(config) as f:
                self._param_dict = json.load(f)
        elif isinstance(config, dict):
            self._param_dict = dict(config)
        else:
            raise ValueError(f"config must be a dict or path, got "
                             f"{type(config)}")
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
        if self.zero_config.stage > 0:
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
        self.seed = pd.get("seed", 42)
        self.nebula_config = NebulaConfig(**pd.get("nebula", {}))
        self.fault = FaultConfig(**pd.get("fault", {}))

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
        """Complete / validate the triple (the JAX package's checks, with
        its error messages) at data-parallel world size 1."""
        dp_world = 1
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
        else:
            mbs, gas = 1, 1
            tbs = dp_world
            logger.warning("no batch config given; defaulting to "
                           "micro_batch=1, grad_accum=1")
        self.train_batch_size = tbs
        self.train_micro_batch_size_per_gpu = mbs
        self.gradient_accumulation_steps = gas
