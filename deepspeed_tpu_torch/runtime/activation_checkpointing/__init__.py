from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing  # noqa: F401
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import (  # noqa: F401
    checkpoint, checkpoint_wrapper, configure, is_configured)
