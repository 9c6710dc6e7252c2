from deepspeed_tpu_torch.accelerator.real_accelerator import (  # noqa: F401
    get_accelerator, resolve_device)
