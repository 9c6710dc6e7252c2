"""BF16_Optimizer — bf16 working weights over fp32 masters, no loss
scaling (port of ``deepspeed_tpu/runtime/bf16_optimizer.py``).

fp32 master copies of the bf16 parameters, fp32 gradient accumulation
across ``backward`` calls, global-norm clipping and a unit loss scale.  As
in the JAX package, the training engine does not route through it (its
step is this optimizer); the class is for users of the reference API and
for tests.  The JAX class's master sharding over a data-parallel mesh waits
for multi-GPU (ROADMAP.md); at world size 1 there is nothing to shard.
"""

import torch


class BF16_Optimizer:

    def __init__(self, init_optimizer, params=None, mpu=None, clip_grad=0.0,
                 norm_type=2, allgather_bucket_size=None,
                 dp_process_group=None, timers=None, shard_masters=True):
        if norm_type != 2:
            raise NotImplementedError("only L2 grad-norm clipping")
        self.optimizer = init_optimizer
        self.clip_grad = float(clip_grad or 0.0)
        self.shard_masters = shard_masters
        self.fp32_groups_flat = None
        self.opt_state = None
        self.step_count = 0
        self.overflow = False          # unit scale; kept for the API
        self._accum_grads = None
        self._last_norm = None
        if params is not None:
            self.initialize_masters(params)

    @torch.no_grad()
    def initialize_masters(self, bf16_params):
        """fp32 masters of ``bf16_params`` (a list of tensors) and fresh
        optimizer state over them."""
        self.fp32_groups_flat = [p.detach().to(torch.float32).clone()
                                 for p in bf16_params]
        self.opt_state = self.optimizer.init(self.fp32_groups_flat)

    @property
    def cur_scale(self):
        return 1.0

    def scale_loss(self, loss):
        return loss                    # unit scale

    @torch.no_grad()
    def backward(self, grads):
        """Stage ``grads`` (a list of tensors, one a master); repeated calls
        accumulate in fp32."""
        grads = [g.to(torch.float32) for g in grads]
        if self._accum_grads is None:
            self._accum_grads = grads
        else:
            torch._foreach_add_(self._accum_grads, grads)

    @torch.no_grad()
    def step(self, closure=None):
        assert self._accum_grads is not None, "backward() not called"
        assert self.fp32_groups_flat is not None, \
            "initialize_masters() not called"
        self.step_count += 1
        grads = self._accum_grads
        gnorm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        if self.clip_grad > 0:
            factor = torch.clamp(self.clip_grad / (gnorm + 1e-6), max=1.0)
            torch._foreach_mul_(grads, factor)
        self.optimizer.update(grads, self.opt_state, self.fp32_groups_flat,
                              step=self.step_count)
        self._last_norm = gnorm
        self._accum_grads = None
        return False                   # never overflows (unit scale)

    @torch.no_grad()
    def get_bf16_params(self):
        """The working bf16 weights, rounded from the masters."""
        return [p.to(torch.bfloat16) for p in self.fp32_groups_flat]

    def state_dict(self):
        return {"step": self.step_count,
                "fp32_groups_flat": self.fp32_groups_flat,
                "optimizer_state": self.opt_state}

    @torch.no_grad()
    def load_state_dict(self, sd, load_optimizer_states=True):
        self.step_count = sd["step"]
        self.fp32_groups_flat = [torch.as_tensor(t).to(torch.float32).clone()
                                 for t in sd["fp32_groups_flat"]]
        if self.opt_state is None:
            self.opt_state = self.optimizer.init(self.fp32_groups_flat)
        if load_optimizer_states and sd.get("optimizer_state") is not None:
            self.opt_state = type(self.opt_state)(*(
                None if f is None else [torch.as_tensor(t).clone()
                                        for t in f]
                for f in sd["optimizer_state"]))
