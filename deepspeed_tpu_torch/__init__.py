"""deepspeed_tpu_torch — the PyTorch / CUDA port of ``deepspeed_tpu``.

The JAX package stays the reference; this package mirrors its module paths
and runs on an NVIDIA H100 with hand-written CUDA kernels (see PERF.md).
It imports nothing of JAX and nothing of ``deepspeed_tpu``.

Ported so far, for the OPT family: generation (:func:`init_inference` →
``InferenceEngine.generate``), continuous-batching serving
(``InferenceEngine.serve`` → :class:`ServingEngine` ``submit`` / ``drain``,
on slot lanes or a paged KV pool, thread-safe, behind the HTTP front end
:func:`serve_http`, with priority lanes, fairness, span tracing, the
flight recorder and device-memory telemetry), both with int8 weights and an int8 KV
cache when the config's ``quant`` block asks for them, and single-device
training (:func:`initialize` → ``engine.train_batch`` or ``engine(batch)``
/ ``engine.backward(loss)`` / ``engine.step()``), dense or block-sparse,
with the JAX remat policies and ``checkpointing`` (activation
checkpointing); HF OPT / GPT-2 / Llama / Mistral / GPT-Neo models come in
through ``module_inject``.  Data-parallel training across GPUs (ZeRO
stages 0, 1, 2): start one process a GPU with ``python -m
deepspeed_tpu_torch.launcher.runner --num_gpus N script.py``, call
:func:`init_distributed` in the script, then :func:`initialize` as
usual — the engine trains one global batch across the group (``comm``:
the collectives over ``torch.distributed``, NCCL or gloo), ZeRO stages 0
to 3 and MiCS.  Tensor parallelism splits the model's heads, ffn columns
and vocabulary over the ranks of a ``tp`` group (the JAX package's
``DEFAULT_TP_RULES``; ``parallel/tensor_parallel.py``): the config's
``tensor_parallel.tp_size``, ``initialize(topology=initialize_topology(
tp=2))`` or a Megatron ``mpu``, in training and in ``init_inference``.
"""

__version__ = "0.1.0"

from deepspeed_tpu_torch import comm  # noqa: F401
from deepspeed_tpu_torch.accelerator import get_accelerator  # noqa: F401
from deepspeed_tpu_torch.comm import init_distributed  # noqa: F401
from deepspeed_tpu_torch.inference.serving import (  # noqa: F401
    ServingConfig, ServingEngine, ServingHTTPFrontend, serve_http)
from deepspeed_tpu_torch.parallel import topology  # noqa: F401
from deepspeed_tpu_torch.parallel.topology import (  # noqa: F401
    ParallelTopology, initialize_topology)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig  # noqa: F401
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine  # noqa: F401
from deepspeed_tpu_torch.runtime import zero  # noqa: F401
from deepspeed_tpu_torch.runtime.activation_checkpointing import (  # noqa: F401
    checkpointing)
from deepspeed_tpu_torch.ops.adam.fused_adam import (  # noqa: F401
    FusedAdam, FusedAdamW)
from deepspeed_tpu_torch.utils.logging import logger, log_dist  # noqa: F401


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None,
               dist_init_required=None, collate_fn=None, config=None,
               config_params=None, loss_fn=None, topology=None, device=None):
    """Initialize the training engine (the JAX package's ``initialize``).

    ``model`` is an ``nn.Module`` whose ``forward(batch)`` returns the loss
    (e.g. ``models.opt.opt_model("opt-1.3b")``); a module built on ``meta``
    is allocated on the device and initialised from ``config["seed"]``
    unless ``model_parameters`` (a state dict, or a JAX parameter tree)
    are given.  ``config`` is a dict or a JSON path.  ``device``: ``None``
    means ``"cuda"`` (a ``RuntimeError`` without a card; on a rank of a
    CUDA group, ``cuda:LOCAL_RANK``); pass ``"cpu"`` for the plain PyTorch
    path (over gloo in a group).  With a live process group
    (:func:`init_distributed`) the engine is one rank of a topology
    (``parallel.topology``), chosen as JAX's ``initialize`` chooses it: an
    explicit ``topology`` wins, else one built from ``mpu`` (a Megatron
    model-parallel unit: its legacy ``get_model_parallel_world_size`` /
    ``get_pipe_parallel_world_size`` or Megatron-Core's tensor / pipeline
    names), else one from the config (``tensor_parallel.tp_size``).
    ``dist_init_required`` True joins the process group first
    (:func:`init_distributed` from the launcher's environment).  Returns
    ``(engine, optimizer, training_dataloader, lr_scheduler)``."""
    if config is None and config_params is not None:
        config = config_params
    if config is None and args is not None and \
            hasattr(args, "deepspeed_config"):
        config = args.deepspeed_config
    if config is None:
        raise ValueError("DeepSpeed requires --deepspeed_config or config=")
    if dist_init_required and not comm.is_initialized():
        init_distributed(device="cpu" if str(device).startswith("cpu")
                         else None)
    if topology is None and mpu is not None:
        from deepspeed_tpu_torch.utils.groups import topology_from_mpu
        topology = topology_from_mpu(mpu)
    engine = DeepSpeedEngine(model=model, optimizer=optimizer,
                             model_parameters=model_parameters,
                             training_data=training_data,
                             lr_scheduler=lr_scheduler,
                             collate_fn=collate_fn, config=config,
                             loss_fn=loss_fn, device=device,
                             topology=topology)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


def init_inference(model=None, config=None, device=None, **kwargs):
    """Initialize the inference engine (the JAX package's
    ``init_inference``).  ``model`` is a port ``Transformer`` (e.g.
    ``models.opt.opt_model("opt-1.3b")``), an HF model (anything with
    ``.config`` and ``.state_dict()``) or an HF model name, which are
    converted in the config's dtype through ``module_inject``
    (``convert_hf_model``); ``config`` a dict or
    ``DeepSpeedInferenceConfig``, with ``kwargs`` merged in.
    ``quant.kv_cache=True`` sets the model's ``kv_cache_quant`` (on the
    module itself, which keeps its weights), as the JAX package clones
    its model with it.  ``device``: ``None`` means ``"cuda"`` (a
    ``RuntimeError`` without a card); pass ``"cpu"`` for the plain PyTorch
    path."""
    from deepspeed_tpu_torch.inference.config import (
        DeepSpeedInferenceConfig, normalize_dtype_str)
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.models.transformer import Transformer
    if isinstance(config, dict):
        config = DeepSpeedInferenceConfig(**config, **kwargs)
    elif config is None:
        config = DeepSpeedInferenceConfig(**kwargs)
    elif kwargs:
        raise TypeError("pass keyword overrides with a dict config, not "
                        "with a DeepSpeedInferenceConfig instance")
    if isinstance(model, str) or (not isinstance(model, Transformer)
                                  and hasattr(model, "config")
                                  and hasattr(model, "state_dict")):
        from deepspeed_tpu_torch.module_inject import convert_hf_model
        model = convert_hf_model(model,
                                 dtype=normalize_dtype_str(config.dtype))
    elif not isinstance(model, Transformer):
        raise TypeError(
            f"init_inference takes a deepspeed_tpu_torch Transformer, an HF "
            f"model (with .config and .state_dict()) or an HF model name; "
            f"got {type(model).__name__}")
    if config.quant.kv_cache and not model.config.kv_cache_quant:
        import dataclasses
        model.replace_config_(
            dataclasses.replace(model.config, kv_cache_quant=True))
    return InferenceEngine(model, config, device=device)


def add_config_arguments(parser):
    """Add the ``--deepspeed`` / ``--deepspeed_config`` arguments (the JAX
    package's ``add_config_arguments``)."""
    group = parser.add_argument_group("DeepSpeed", "DeepSpeed configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed (helper flag to launcher)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="Path to DeepSpeed json configuration")
    group.add_argument("--deepscale", default=False, action="store_true",
                       help="Deprecated alias of --deepspeed")
    group.add_argument("--local_rank", type=int, default=-1,
                       help="local rank passed by the launcher")
    return parser
