"""Offline checkpoint tools (port of ``deepspeed_tpu/checkpoint/``): the
:class:`DeepSpeedCheckpoint` reader over the port's tags and the
safetensors format.  ``universal_checkpoint`` and ``reshape_utils``
reshard across world sizes and wait for multi-GPU parallelism."""

from deepspeed_tpu_torch.checkpoint.deepspeed_checkpoint import (  # noqa: F401
    DeepSpeedCheckpoint)
