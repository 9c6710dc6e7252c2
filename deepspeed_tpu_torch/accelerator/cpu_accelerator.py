"""CPU accelerator: what the port's tests run on when they pass
``device="cpu"``.  It reports no device memory."""

import os

import torch

from deepspeed_tpu_torch.accelerator.abstract_accelerator import Accelerator


class CPU_Accelerator(Accelerator):
    _name = "cpu"

    def is_available(self):
        return True

    def device_count(self):
        return 1

    def device_name(self, device):
        return f"cpu ({os.cpu_count()} cores)"

    def synchronize(self, device):
        return None

    def manual_seed(self, seed, device):
        return torch.Generator(device="cpu").manual_seed(int(seed))

    def memory_snapshot(self, device):
        return {"device": str(device), "bytes_in_use": 0,
                "peak_bytes_in_use": 0, "bytes_limit": 0, "bytes_free": 0}

    def max_memory_allocated(self, device):
        return 0
