"""Adam / AdamW (port of ``deepspeed_tpu/ops/adam/fused_adam.py``).

The JAX package writes no kernel for its optimizer: the update is plain
array code that XLA fuses.  The port keeps it plain tensor code too, with
``torch._foreach_*`` over the whole parameter list so one step is a few
dozen launches, not a few per parameter.  The update is the JAX one:
``m = b1*m + (1-b1)*g``, ``v = b2*v + (1-b2)*g*g``,
``p -= lr * ((m/bc1) / (sqrt(v/bc2) + eps) [+ wd*p])`` with decoupled
(``adam_w_mode``) or L2 weight decay.  As in JAX, parameters, gradients
and moments are cast to ``master_dtype`` (the arithmetic's dtype, fp32 by
default), updated, and cast back to their own dtypes: bf16 parameters
(``bf16.master_weights_in_bf16``) and ``state_dtype`` moments are stored
narrow and computed in fp32.  Every step is elementwise, so updating the
parameters a group at a time gives the same bits as one call.

The protocol mirrors the JAX one, in place: ``init(params) -> state`` and
``update(grads, state, params, lr, step)`` updates ``params`` and
``state`` (lists of tensors) in place.
"""

from typing import Any, NamedTuple

import torch


class AdamState(NamedTuple):
    exp_avg: Any       # first moments, one tensor per parameter
    exp_avg_sq: Any    # second moments


_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16}


def to_dtype(dtype):
    """A torch dtype from a torch dtype or its name (``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    key = str(dtype).replace("torch.", "")
    if key not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _DTYPES[key]


class FusedAdam:
    """Adam / AdamW with bias correction; ``adam_w_mode`` selects decoupled
    weight decay."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 adam_w_mode=True, bias_correction=True, amsgrad=False,
                 master_dtype=torch.float32, state_dtype=None):
        if amsgrad:
            raise ValueError("FusedAdam does not support amsgrad (parity "
                             "with reference)")
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.bias_correction = bias_correction
        # the arithmetic's dtype
        self.master_dtype = to_dtype(master_dtype)
        # moment STORAGE dtype; arithmetic stays master_dtype
        self.state_dtype = to_dtype(state_dtype) if state_dtype is not None \
            else self.master_dtype

    def init(self, params):
        def zeros():
            return [torch.zeros_like(p, dtype=self.state_dtype)
                    for p in params]
        return AdamState(exp_avg=zeros(), exp_avg_sq=zeros())

    @torch.no_grad()
    def update(self, grads, state, params, lr=None, step=1):
        lr = self.lr if lr is None else lr
        b1, b2, eps, wd = self.beta1, self.beta2, self.eps, self.weight_decay
        if self.bias_correction:
            bc1 = 1.0 - b1 ** step
            bc2 = 1.0 - b2 ** step
        else:
            bc1 = bc2 = 1.0
        math = self.master_dtype

        def cast(xs):        # the tensors themselves when already in math
            return [x if x.dtype == math else x.to(math) for x in xs]

        p, m, v, g = (cast(xs) for xs in (params, state.exp_avg,
                                          state.exp_avg_sq, grads))
        if wd != 0.0 and not self.adam_w_mode:
            g = torch._foreach_add(g, p, alpha=wd)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g),
                                                  1.0 - b2))
        del g
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(m, bc1)
        torch._foreach_div_(upd, denom)
        del denom
        if wd != 0.0 and self.adam_w_mode:
            torch._foreach_add_(upd, torch._foreach_mul(p, wd))
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(p, upd)
        del upd
        for dst, src in ((params, p), (state.exp_avg, m),
                         (state.exp_avg_sq, v)):
            narrow = [(d, s) for d, s in zip(dst, src) if d is not s]
            if narrow:
                torch._foreach_copy_([d for d, _ in narrow],
                                     [s for _, s in narrow])
        return params, state


class FusedAdamW(FusedAdam):

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.01, **kw):
        super().__init__(lr=lr, betas=betas, eps=eps,
                         weight_decay=weight_decay, adam_w_mode=True, **kw)
