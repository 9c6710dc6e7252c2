"""Model conversion from Hugging Face checkpoints (port of
``deepspeed_tpu/module_inject/``): a policy per HF decoder family maps an
HF model's config and ``state_dict`` onto the port's ``Transformer``,
whose hand-written kernels are the "injected" implementation; ``AutoTP``
/ ``get_tp_rules`` derive tensor-parallel rules from an HF model's
structure; :func:`load_megatron_model` reads Megatron-LM GPT
checkpoints."""

from deepspeed_tpu_torch.module_inject.replace_module import (  # noqa: F401
    convert_hf_model, load_megatron_model, policy_for)
from deepspeed_tpu_torch.module_inject.policy import HFPolicy  # noqa: F401
from deepspeed_tpu_torch.module_inject.containers import (  # noqa: F401
    OPTPolicy, GPT2Policy, LlamaPolicy, GPTNeoPolicy, MegatronGPTPolicy,
    ALL_POLICIES,
    UNPORTED_FAMILIES)
from deepspeed_tpu_torch.module_inject.auto_tp import (  # noqa: F401
    AutoTP, get_tp_rules)
