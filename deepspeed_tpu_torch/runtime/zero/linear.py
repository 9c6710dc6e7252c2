"""ZeRO-3's linear (port of ``deepspeed_tpu/runtime/zero/linear.py``,
reference ``runtime/zero/linear.py``: ``LinearFunctionForZeroStage3`` and
``LinearModuleForZeroStage3``).

``zero3_linear_wrap`` is a ``torch.autograd.Function`` that saves the
weight it is given, never a copy of it: under ZeRO-3 that is the gathered
parameter, whose storage the hooks release after the forward and gather
again for the backward.  It computes ``x @ W^T + b`` with fp32
accumulation, the bias added in fp32 and the result rounded once to
``x``'s dtype (the JAX function's ``preferred_element_type=float32``),
and its backward likewise accumulates in fp32 and rounds each gradient
to its input's dtype.
"""

import math

import torch
from torch import nn


class LinearFunctionForZeroStage3(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias=None):
        ctx.save_for_backward(x, weight, bias)
        y = torch.nn.functional.linear(x.float(), weight.float())
        if bias is not None:
            y = y + bias.float()
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        x, weight, bias = ctx.saved_tensors
        g = grad.float()
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = (g @ weight.float()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = (g.reshape(-1, g.shape[-1]).t()
                  @ x.float().reshape(-1, x.shape[-1])).to(weight.dtype)
        if bias is not None and ctx.needs_input_grad[2]:
            gb = g.reshape(-1, g.shape[-1]).sum(0).to(bias.dtype)
        return gx, gw, gb


def zero3_linear_wrap(x, weight, bias=None):
    """``x @ weight^T + bias`` (``weight`` ``[out, in]``) with fp32
    accumulation, in ``x``'s dtype (reference
    ``LinearFunctionForZeroStage3.apply``)."""
    return LinearFunctionForZeroStage3.apply(x, weight, bias)


class LinearModuleForZeroStage3(nn.Module):
    """A linear layer in torch's ``[out, in]`` layout, so injected or
    converted checkpoints map one to one; its weight is cast to the
    input's dtype (a no-op for a weight ZeRO-3 gathered in that dtype)
    and its fp32 bias added in fp32.  Initialized as flax's
    ``lecun_normal`` and zero bias, from ``generator``."""

    def __init__(self, in_features, out_features, bias=True, device=None,
                 generator=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device)) \
            if bias else None
        if not self.weight.is_meta:
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        # flax lecun_normal: a normal of std sqrt(1 / fan_in) / .8796
        # truncated at two standard deviations
        std = math.sqrt(1.0 / self.in_features) / .87962566103423978
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        return zero3_linear_wrap(x, self.weight.to(x.dtype), self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"bias={self.bias is not None}")
