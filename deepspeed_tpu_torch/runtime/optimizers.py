"""Optimizer factory and the simpler optimizers (port of
``deepspeed_tpu/runtime/optimizers.py``).

``build_optimizer`` maps the config's ``optimizer.type`` to an instance.
Every optimizer shares the in-place protocol of :mod:`ops.adam.fused_adam`
(``init(params)`` / ``update(grads, state, params, lr, step)`` over lists
of tensors, ``torch._foreach_*`` ops) and the JAX package's formulas.
Lamb and the 1-bit optimizers belong to later slices and raise.
"""

from typing import Any, NamedTuple

import torch

from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam, FusedAdamW
from deepspeed_tpu_torch.runtime import constants as C


def _zeros(params, fill=0.0):
    return [torch.full_like(p, fill, dtype=torch.float32) for p in params]


class SGDState(NamedTuple):
    momentum: Any


class SGD:

    def __init__(self, lr=1e-3, momentum=0.0, weight_decay=0.0,
                 nesterov=False):
        self.lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov

    def init(self, params):
        return SGDState(momentum=None if self.momentum == 0.0
                        else _zeros(params))

    @torch.no_grad()
    def update(self, grads, state, params, lr=None, step=1):
        lr = self.lr if lr is None else lr
        wd, mu = self.weight_decay, self.momentum
        g = torch._foreach_add(list(grads), params, alpha=wd)
        if mu == 0.0:
            d = g
        else:
            buf = state.momentum
            torch._foreach_mul_(buf, mu)
            torch._foreach_add_(buf, g)
            d = torch._foreach_add(g, torch._foreach_mul(buf, mu)) \
                if self.nesterov else buf
        torch._foreach_sub_(params, torch._foreach_mul(d, lr))
        return params, state


class AdagradState(NamedTuple):
    accum: Any


class Adagrad:

    def __init__(self, lr=1e-2, eps=1e-10, weight_decay=0.0,
                 initial_accumulator_value=0.0):
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay
        self.init_acc = initial_accumulator_value

    def init(self, params):
        return AdagradState(accum=_zeros(params, self.init_acc))

    @torch.no_grad()
    def update(self, grads, state, params, lr=None, step=1):
        lr = self.lr if lr is None else lr
        g = torch._foreach_add(list(grads), params, alpha=self.weight_decay)
        torch._foreach_add_(state.accum, torch._foreach_mul(g, g))
        denom = torch._foreach_sqrt(state.accum)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_mul(g, lr)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(params, upd)
        return params, state


class LionState(NamedTuple):
    momentum: Any


class Lion:

    def __init__(self, lr=1e-4, betas=(0.9, 0.99), weight_decay=0.0):
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.weight_decay = weight_decay

    def init(self, params):
        return LionState(momentum=_zeros(params))

    @torch.no_grad()
    def update(self, grads, state, params, lr=None, step=1):
        lr = self.lr if lr is None else lr
        b1, b2, wd = self.beta1, self.beta2, self.weight_decay
        g = list(grads)
        m = state.momentum
        upd = torch._foreach_mul(m, b1)
        torch._foreach_add_(upd, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_sign_(upd)
        torch._foreach_add_(upd, torch._foreach_mul(params, wd))
        torch._foreach_mul_(m, b2)
        torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - b2))
        torch._foreach_sub_(params, torch._foreach_mul(upd, lr))
        return params, state


def build_optimizer(opt_config):
    """Map the config's ``optimizer`` block to an instance (AdamW when
    there is none)."""
    if opt_config is None or opt_config.type is None:
        return FusedAdamW()
    name = opt_config.type.lower()
    params = dict(opt_config.params)
    params.pop("torch_adam", None)
    if name == C.ADAMW_OPTIMIZER:
        params.pop("adam_w_mode", None)
    if name in (C.ADAM_OPTIMIZER, C.FUSED_ADAM_OPTIMIZER,
                C.CPU_ADAM_OPTIMIZER):
        # "Adam" means decoupled weight decay unless adam_w_mode=false
        adam_w = params.pop("adam_w_mode", True)
        return FusedAdam(adam_w_mode=adam_w, **params)
    if name == C.ADAMW_OPTIMIZER:
        return FusedAdamW(**params)
    if name in (C.LAMB_OPTIMIZER, C.ONEBIT_LAMB_OPTIMIZER,
                C.ONEBIT_ADAM_OPTIMIZER, C.ZERO_ONE_ADAM_OPTIMIZER):
        raise NotImplementedError(
            f"optimizer {opt_config.type!r} is not ported to "
            f"deepspeed_tpu_torch yet (see ROADMAP.md, queue A)")
    if name == C.SGD_OPTIMIZER:
        return SGD(**params)
    if name == C.ADAGRAD_OPTIMIZER:
        return Adagrad(**params)
    if name == C.LION_OPTIMIZER:
        return Lion(**params)
    raise ValueError(f"unknown optimizer type: {opt_config.type}")
