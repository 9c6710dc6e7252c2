"""Accelerator selection (port of ``deepspeed_tpu/accelerator/
real_accelerator.py``).

The JAX package picks its accelerator from the runtime platform and the
``DSTPU_ACCELERATOR`` environment variable.  The port does neither: the
accelerator follows the device the caller names, and no environment
variable changes it.  On a rank of a CUDA process group (``comm.
init_distributed``) the default is that rank's own card,
``cuda:LOCAL_RANK``.
"""

import torch

from deepspeed_tpu_torch.accelerator.cpu_accelerator import CPU_Accelerator
from deepspeed_tpu_torch.accelerator.cuda_accelerator import CUDA_Accelerator


def resolve_device(device=None):
    """The device an entry point runs on: ``None`` means ``"cuda"`` — on a
    rank of a CUDA process group, ``cuda:LOCAL_RANK`` (so is an unindexed
    ``"cuda"`` there).  A CUDA device without a card raises — the port
    never falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        from deepspeed_tpu_torch import comm
        own = comm.get_device()
        if own is not None and own.type == "cuda":
            dev = own
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deepspeed_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def get_accelerator(device):
    """The accelerator for ``device`` (a ``torch.device`` or string)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return CUDA_Accelerator()
    if dev.type == "cpu":
        return CPU_Accelerator()
    raise ValueError(f"unsupported device {dev}")
