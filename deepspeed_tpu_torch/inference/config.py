"""Inference config (port of ``deepspeed_tpu/inference/config.py``).

Same keys and aliases as the JAX package's ``DeepSpeedInferenceConfig``
(``replace_with_kernel_inject``, ``tp``, ``max_tokens``).  ``quant``
carries over: ``enabled`` quantizes the weights when they are loaded
(``bits`` 4 / 8, ``group_size``, ``per_channel``), ``kv_cache`` makes the
KV cache int8 (``init_inference`` sets the model's ``kv_cache_quant``).
``enable_cuda_graph`` (default True) selects the captured decode
programs of ``inference/engine.py`` and the serving engine.
``tensor_parallel.tp_size`` (or the legacy ``mp_size``) > 1 splits the
model over the ranks of a tp group (``parallel/tensor_parallel.py``).
Knobs whose
feature this port does not have yet raise
``NotImplementedError`` when set away from their default, so a config
never silently does nothing: expert parallelism, the
memory guard's ``strict_memory``, the fault block's ``bucket_downshift``
(it needs ``strict_memory``) and the persistent compile cache.
``checkpoint`` (a training tag's directory or a ``save_16bit_model``
file) is loaded when the engine is built.  The
``serving`` block parses into :class:`~deepspeed_tpu_torch.inference.
serving.config.ServingConfig`, which raises for its own unported knobs.
"""

import dataclasses
from dataclasses import field
from typing import Any, Dict, Optional

from deepspeed_tpu_torch.inference.serving.config import ServingConfig
from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel

_DTYPE_ALIASES = {"float16": "float16", "fp16": "float16", "half": "float16",
                  "bfloat16": "bfloat16", "bf16": "bfloat16",
                  "float32": "float32", "fp32": "float32",
                  "float": "float32"}


def normalize_dtype_str(dtype) -> str:
    key = str(dtype).replace("torch.", "")
    if key not in _DTYPE_ALIASES:
        raise ValueError(f"unsupported dtype {dtype!r}; one of "
                         f"{sorted(set(_DTYPE_ALIASES))}")
    return _DTYPE_ALIASES[key]


def _not_ported(knob):
    raise NotImplementedError(
        f"inference config: {knob} is not ported to deepspeed_tpu_torch yet "
        f"(see ROADMAP.md, queue A)")


@dataclasses.dataclass(init=False)
class DeepSpeedTPConfig(DeepSpeedConfigModel):
    enabled: bool = True
    tp_size: int = 1
    mpu: Any = None
    tp_group: Any = None


@dataclasses.dataclass(init=False)
class QuantizationConfig(DeepSpeedConfigModel):
    enabled: bool = False
    bits: int = 8
    group_size: int = 64
    per_channel: bool = False
    kv_cache: bool = False


@dataclasses.dataclass(init=False)
class DeepSpeedInferenceConfig(DeepSpeedConfigModel):
    _aliases = {"replace_with_kernel_inject": "kernel_inject",
                "tp": "tensor_parallel",
                "max_tokens": "max_out_tokens"}

    kernel_inject: bool = True
    dtype: str = "bfloat16"
    tensor_parallel: DeepSpeedTPConfig = field(
        default_factory=DeepSpeedTPConfig)
    mp_size: Optional[int] = None          # legacy alias for tp_size
    max_out_tokens: int = 1024
    min_out_tokens: int = 1
    max_batch_size: int = 8
    replace_method: str = "auto"
    # captured decode programs (as JAX's "jitted decode step, always
    # on"): generate() replays CUDA graphs of DECODE_STEPS_PER_GRAPH
    # decode steps and the serving engine a graph of its decode block;
    # False runs the eager per-step loop and block
    enable_cuda_graph: bool = True
    checkpoint: Optional[Any] = None
    base_dir: str = ""
    quant: QuantizationConfig = field(default_factory=QuantizationConfig)
    moe: Dict[str, Any] = field(default_factory=dict)
    ep_size: int = 1
    injection_policy: Optional[Dict] = None
    return_tuple: bool = True
    triangular_masking: bool = True
    memory_guard_fraction: float = 0.85
    strict_memory: bool = False
    # chunked prefill ("auto" | int chunk | None), as in the JAX package
    prefill_chunk_size: Optional[Any] = "auto"
    compile_cache: Dict[str, Any] = field(default_factory=dict)
    fault: Dict[str, Any] = field(default_factory=dict)
    serving: ServingConfig = field(default_factory=ServingConfig)
    # stop the decode loop once every row has emitted eos (tokens are
    # identical either way)
    decode_early_exit: bool = True

    def validate(self):
        if self.mp_size is not None and self.tensor_parallel.tp_size == 1:
            self.tensor_parallel.tp_size = self.mp_size
        normalize_dtype_str(self.dtype)
        if self.ep_size != 1 or self.moe:
            _not_ported("moe / ep_size (expert parallelism)")
        if self.strict_memory:
            _not_ported("strict_memory (the compiled-program memory guard)")
        if self.fault.get("bucket_downshift"):
            _not_ported("fault.bucket_downshift")
        if self.compile_cache.get("enabled"):
            _not_ported("compile_cache.enabled")
