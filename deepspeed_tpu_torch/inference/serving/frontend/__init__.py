"""The serving engine's network front end (port of
``deepspeed_tpu/inference/serving/frontend``): the asyncio HTTP transport
with per-token streaming (:mod:`.transport`) and per-client fairness
(:mod:`.fairness`).  Host orchestration only: it adds no CUDA graph and
no kernel."""

from deepspeed_tpu_torch.inference.serving.frontend.fairness import \
    FairnessTracker
from deepspeed_tpu_torch.inference.serving.frontend.transport import (
    ServingHTTPFrontend, serve_http)

__all__ = ["FairnessTracker", "ServingHTTPFrontend", "serve_http"]
