"""CUDA accelerator: ``torch.cuda`` behind the accelerator surface."""

import torch

from deepspeed_tpu_torch.accelerator.abstract_accelerator import Accelerator


class CUDA_Accelerator(Accelerator):
    _name = "cuda"

    def is_available(self):
        return torch.cuda.is_available()

    def device_count(self):
        return torch.cuda.device_count()

    def device_name(self, device):
        return torch.cuda.get_device_name(device)

    def synchronize(self, device):
        torch.cuda.synchronize(device)

    def manual_seed(self, seed, device):
        return torch.Generator(device=device).manual_seed(int(seed))

    def memory_snapshot(self, device):
        free, total = torch.cuda.mem_get_info(device)
        return {"device": str(device),
                "bytes_in_use": torch.cuda.memory_allocated(device),
                "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
                "bytes_limit": total,
                "bytes_free": free}
