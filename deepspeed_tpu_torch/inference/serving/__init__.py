"""Continuous-batching serving (port of ``deepspeed_tpu/inference/serving``):
``InferenceEngine.serve()`` returns a :class:`ServingEngine`;
:func:`serve_http` puts the asyncio HTTP front end on it."""

from deepspeed_tpu_torch.inference.serving.config import ServingConfig  # noqa: F401
from deepspeed_tpu_torch.inference.serving.engine import ServingEngine  # noqa: F401
from deepspeed_tpu_torch.inference.serving.frontend import (  # noqa: F401
    FairnessTracker, ServingHTTPFrontend, serve_http)
