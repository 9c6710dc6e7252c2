"""The launcher: ``python -m deepspeed_tpu_torch.launcher.runner``."""
