"""Continuous-batching serving (port of ``deepspeed_tpu/inference/serving``):
``InferenceEngine.serve()`` returns a :class:`ServingEngine`."""

from deepspeed_tpu_torch.inference.serving.config import ServingConfig  # noqa: F401
from deepspeed_tpu_torch.inference.serving.engine import ServingEngine  # noqa: F401
