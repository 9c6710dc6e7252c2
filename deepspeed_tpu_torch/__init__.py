"""deepspeed_tpu_torch — the PyTorch / CUDA port of ``deepspeed_tpu``.

The JAX package stays the reference; this package mirrors its module paths
and runs on an NVIDIA H100 with hand-written CUDA kernels (see PERF.md).
It imports nothing of JAX and nothing of ``deepspeed_tpu``.

This slice ports the serving path: :func:`init_inference` →
``InferenceEngine.generate`` for the OPT family.
"""

__version__ = "0.1.0"

from deepspeed_tpu_torch.accelerator import get_accelerator  # noqa: F401
from deepspeed_tpu_torch.utils.logging import logger, log_dist  # noqa: F401


def init_inference(model=None, config=None, device=None, **kwargs):
    """Initialize the inference engine (the JAX package's
    ``init_inference``).  ``model`` is a port ``Transformer`` (e.g.
    ``models.opt.opt_model("opt-1.3b")``); ``config`` a dict or
    ``DeepSpeedInferenceConfig``, with ``kwargs`` merged in.  ``device``:
    ``None`` means ``"cuda"`` (a ``RuntimeError`` without a card); pass
    ``"cpu"`` for the plain PyTorch path."""
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.models.transformer import Transformer
    if isinstance(config, dict):
        config = DeepSpeedInferenceConfig(**config, **kwargs)
    elif config is None:
        config = DeepSpeedInferenceConfig(**kwargs)
    elif kwargs:
        raise TypeError("pass keyword overrides with a dict config, not "
                        "with a DeepSpeedInferenceConfig instance")
    if isinstance(model, str) or not isinstance(model, Transformer):
        raise NotImplementedError(
            f"init_inference takes a deepspeed_tpu_torch Transformer; HF "
            f"models and model names ({type(model).__name__}) come with the "
            f"later module_inject slice")
    return InferenceEngine(model, config, device=device)
