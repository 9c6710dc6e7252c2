"""deepspeed_tpu_torch — the PyTorch / CUDA port of ``deepspeed_tpu``.

The JAX package stays the reference; this package mirrors its module paths
and runs on an NVIDIA H100 with hand-written CUDA kernels (see PERF.md).
It imports nothing of JAX and nothing of ``deepspeed_tpu``.

Ported so far, for the OPT family: generation (:func:`init_inference` →
``InferenceEngine.generate``), continuous-batching serving
(``InferenceEngine.serve`` → :class:`ServingEngine` ``submit`` / ``drain``,
on slot lanes or a paged KV pool), both with int8 weights and an int8 KV
cache when the config's ``quant`` block asks for them, and single-device
training (:func:`initialize` → ``engine.train_batch`` or ``engine(batch)``
/ ``engine.backward(loss)`` / ``engine.step()``), dense or block-sparse.
"""

__version__ = "0.1.0"

from deepspeed_tpu_torch.accelerator import get_accelerator  # noqa: F401
from deepspeed_tpu_torch.inference.serving import (  # noqa: F401
    ServingConfig, ServingEngine)
from deepspeed_tpu_torch.utils.logging import logger, log_dist  # noqa: F401


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, collate_fn=None,
               config=None, config_params=None, loss_fn=None, device=None):
    """Initialize the training engine (the JAX package's ``initialize``).

    ``model`` is an ``nn.Module`` whose ``forward(batch)`` returns the loss
    (e.g. ``models.opt.opt_model("opt-1.3b")``); a module built on ``meta``
    is allocated on the device and initialised from ``config["seed"]``
    unless ``model_parameters`` (a state dict, or a JAX parameter tree)
    are given.  ``config`` is a dict or a JSON path.  ``device``: ``None``
    means ``"cuda"`` (a ``RuntimeError`` without a card); pass ``"cpu"``
    for the plain PyTorch path.  Returns ``(engine, optimizer,
    training_dataloader, lr_scheduler)``."""
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    if config is None and config_params is not None:
        config = config_params
    if config is None and args is not None and \
            hasattr(args, "deepspeed_config"):
        config = args.deepspeed_config
    if config is None:
        raise ValueError("DeepSpeed requires --deepspeed_config or config=")
    engine = DeepSpeedEngine(model=model, optimizer=optimizer,
                             model_parameters=model_parameters,
                             training_data=training_data,
                             lr_scheduler=lr_scheduler,
                             collate_fn=collate_fn, config=config,
                             loss_fn=loss_fn, device=device)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


def init_inference(model=None, config=None, device=None, **kwargs):
    """Initialize the inference engine (the JAX package's
    ``init_inference``).  ``model`` is a port ``Transformer`` (e.g.
    ``models.opt.opt_model("opt-1.3b")``); ``config`` a dict or
    ``DeepSpeedInferenceConfig``, with ``kwargs`` merged in.
    ``quant.kv_cache=True`` sets the model's ``kv_cache_quant`` (on the
    module itself, which keeps its weights), as the JAX package clones
    its model with it.  ``device``: ``None`` means ``"cuda"`` (a
    ``RuntimeError`` without a card); pass ``"cpu"`` for the plain PyTorch
    path."""
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
    if config.quant.kv_cache and not model.config.kv_cache_quant:
        import dataclasses
        model.replace_config_(
            dataclasses.replace(model.config, kv_cache_quant=True))
    return InferenceEngine(model, config, device=device)
