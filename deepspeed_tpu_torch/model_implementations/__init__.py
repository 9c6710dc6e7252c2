"""Model implementations (port of ``deepspeed_tpu/model_implementations``):
the CUDA-graph feature mixin."""

from deepspeed_tpu_torch.model_implementations.features.cuda_graph import (
    CompiledGraphModule)

__all__ = ["CompiledGraphModule"]
