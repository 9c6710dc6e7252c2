"""DeepSpeedCPUAdagrad — the host Adagrad of the offload tier (port of
``deepspeed_tpu/ops/adagrad/cpu_adagrad.py``), over ``ds_adagrad_step`` of
the shared ``csrc/adam/cpu_adam.cpp`` library."""

from deepspeed_tpu_torch.ops.adam.cpu_adam import (adagrad_step,
                                                   host_buffer, host_copy)


class DeepSpeedCPUAdagrad:
    """Stateful host Adagrad over flat fp32 CPU tensors (the API of
    ``DeepSpeedCPUAdam``: an in-place step a tensor, with an optional bf16
    copy-out for the upload)."""

    def __init__(self, params, lr=1e-2, eps=1e-10, weight_decay=0.0,
                 pin_memory=False):
        self.pin_memory = bool(pin_memory)
        self.params = [host_copy(p, self.pin_memory) for p in params]
        self.exp_avg_sq = [host_buffer(p.numel(), pin=self.pin_memory)
                           for p in self.params]
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay
        self.step_count = 0

    def step(self, grads, bf16_outs=None, lr=None):
        self.step_count += 1
        lr = self.lr if lr is None else lr
        for i, (p, g) in enumerate(zip(self.params, grads)):
            adagrad_step(p, self.exp_avg_sq[i], g.reshape(-1), lr, self.eps,
                         self.weight_decay,
                         bf16_out=None if bf16_outs is None else bf16_outs[i])

    def state_dict(self):
        return {"step": self.step_count, "exp_avg_sq": self.exp_avg_sq}

    def load_state_dict(self, sd):
        self.step_count = int(sd["step"])
        self.exp_avg_sq = [host_copy(a, self.pin_memory)
                           for a in sd["exp_avg_sq"]]
