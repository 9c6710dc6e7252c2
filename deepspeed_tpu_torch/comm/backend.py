"""Communication backend (port of ``deepspeed_tpu/comm/backend.py``).

``Backend`` is the JAX package's base class; :class:`TorchBackend` takes
the place of its ``XlaBackend``: one ``torch.distributed`` process group,
NCCL when the ranks run on CUDA devices and gloo when they run on the CPU.
Neither falls back to the other: NCCL without a card, or gloo asked for
with a CUDA device, raises.
"""

import datetime

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.utils.logging import logger


class Backend:

    def __init__(self, name="backend", rank=0, size=1):
        self.name = name
        self.initialized = False

    def is_initialized(self):
        return self.initialized

    def init_process_group(self):
        self.initialized = True

    def destroy_process_group(self):
        self.initialized = False


def backend_for(device, dist_backend=None):
    """The process-group backend for ranks on ``device``: ``nccl`` for
    CUDA, ``gloo`` for the CPU.  A backend given explicitly must agree."""
    device = torch.device(device)
    want = "nccl" if device.type == "cuda" else "gloo"
    name = (dist_backend or want).lower()
    if name not in ("nccl", "gloo"):
        raise ValueError(f"dist_backend {dist_backend!r}: the port runs on "
                         f"'nccl' (CUDA) or 'gloo' (CPU)")
    if name == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("dist_backend 'nccl' needs a CUDA device and none "
                           "is available; pass device='cpu' for gloo")
    if name != want:
        raise ValueError(f"dist_backend {name!r} with a {device.type} device: "
                         f"the port uses nccl on CUDA and gloo on the CPU, "
                         f"never one for the other")
    return name


class TorchBackend(Backend):
    """One ``torch.distributed`` process group over ``init_method`` (a
    ``tcp://MASTER_ADDR:MASTER_PORT`` rendezvous).  For NCCL the rank's
    device is made current before the group exists (NCCL refuses two ranks
    on one card)."""

    def __init__(self, backend, rank, world_size, init_method, device,
                 timeout=None):
        super().__init__(name=backend, rank=rank, size=world_size)
        self.backend = backend
        self.rank = rank
        self.world_size = world_size
        self.init_method = init_method
        self.device = torch.device(device)
        self.timeout = timeout

    def init_process_group(self):
        if self.initialized:
            return
        kwargs = {}
        if self.timeout is not None:
            kwargs["timeout"] = self.timeout if isinstance(
                self.timeout, datetime.timedelta) else datetime.timedelta(
                    seconds=float(self.timeout))
        if self.backend == "nccl":
            torch.cuda.set_device(self.device)
            kwargs["device_id"] = self.device
        dist.init_process_group(self.backend, init_method=self.init_method,
                                rank=self.rank, world_size=self.world_size,
                                **kwargs)
        self.initialized = True
        logger.info(f"torch.distributed initialized: rank {self.rank}/"
                    f"{self.world_size} ({self.backend}, {self.device}) via "
                    f"{self.init_method}")

    def destroy_process_group(self):
        if self.initialized and dist.is_initialized():
            dist.destroy_process_group()
        self.initialized = False

    def get_rank(self):
        return dist.get_rank()

    def get_world_size(self):
        return dist.get_world_size()
