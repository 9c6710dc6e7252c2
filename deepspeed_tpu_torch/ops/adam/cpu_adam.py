"""Host Adam / Adagrad for offloaded optimizer state (port of
``deepspeed_tpu/ops/adam/cpu_adam.py``).

ZeRO-Offload's optimizer: the fp32 masters and moments live in host RAM as
contiguous fp32 CPU tensors (pinned when ``offload_optimizer.pin_memory``
is set), and the update is the shared C++ OpenMP kernel
``csrc/adam/cpu_adam.cpp`` (``ds_adam_step`` / ``ds_adagrad_step``), built
by :mod:`ops.native_build` at first use and bound with ``ctypes``.  The
updated parameters can be narrowed to bfloat16 in the same pass, into a
``uint16`` (or ``bfloat16``) tensor that the engine uploads to the card.

There is no fallback: a failed build raises.  :func:`adam_step_plain` and
:func:`adagrad_step_plain` are the same arithmetic in plain PyTorch, for
the tests; nothing on the training path calls them.
"""

import ctypes

import numpy as np
import torch

_lib = None


def load():
    """Build (if needed) and load the host optimizer library."""
    global _lib
    if _lib is None:
        from deepspeed_tpu_torch.ops.native_build import (csrc_path,
                                                          load_library)
        lib = load_library("ds_cpu_adam", [csrc_path("adam", "cpu_adam.cpp")])
        P = ctypes.c_void_p
        lib.ds_adam_step.restype = None
        lib.ds_adam_step.argtypes = [
            P, P, P, P, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, P]
        lib.ds_adagrad_step.restype = None
        lib.ds_adagrad_step.argtypes = [
            P, P, P, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, P]
        _lib = lib
    return _lib


def set_threads(n):
    """Run the host kernels on ``n`` OpenMP threads (``omp_set_num_threads``
    of the OpenMP the library links, for the calling thread).  Ranks that
    share a host split its cores: left at OpenMP's default each would start
    a thread a core and they would spin against one another at every
    parallel region's barrier.  Returns False when the library was built
    without OpenMP."""
    try:
        fn = load().omp_set_num_threads
    except AttributeError:
        return False
    fn.argtypes = [ctypes.c_int]
    fn(max(1, int(n)))
    return True


def _f32(name, t, n=None):
    if not (torch.is_tensor(t) and t.device.type == "cpu"
            and t.dtype == torch.float32 and t.is_contiguous()):
        raise TypeError(f"host Adam: {name} must be a contiguous float32 CPU "
                        f"tensor, got {getattr(t, 'dtype', type(t))} on "
                        f"{getattr(t, 'device', '?')}")
    if n is not None and t.numel() != n:
        raise ValueError(f"host Adam: {name} has {t.numel()} elements, "
                         f"params {n}")
    return t.data_ptr()


def _out16(t, n):
    if t is None:
        return None
    if not (torch.is_tensor(t) and t.device.type == "cpu"
            and t.dtype in (torch.uint16, torch.bfloat16)
            and t.is_contiguous() and t.numel() == n):
        raise TypeError("host Adam: bf16_out must be a contiguous CPU "
                        "uint16 / bfloat16 tensor with one element a "
                        "parameter")
    return t.data_ptr()


def adam_step(params, exp_avg, exp_avg_sq, grads, lr, beta1, beta2, eps,
              weight_decay, adamw_mode, bias_correction, step,
              bf16_out=None):
    """One fused Adam / AdamW step of the C++ kernel over contiguous fp32
    CPU tensors, in place; ``bf16_out`` (optional) receives the updated
    parameters rounded to bfloat16."""
    n = params.numel()
    args = (_f32("params", params), _f32("exp_avg", exp_avg, n),
            _f32("exp_avg_sq", exp_avg_sq, n), _f32("grads", grads, n))
    load().ds_adam_step(*args, n, lr, beta1, beta2, eps, weight_decay,
                        int(adamw_mode), int(bias_correction), int(step),
                        _out16(bf16_out, n))
    adam_step.launches += 1


def adagrad_step(params, exp_avg_sq, grads, lr, eps, weight_decay,
                 bf16_out=None):
    """One fused Adagrad step of the C++ kernel, in place."""
    n = params.numel()
    args = (_f32("params", params), _f32("exp_avg_sq", exp_avg_sq, n),
            _f32("grads", grads, n))
    load().ds_adagrad_step(*args, n, lr, eps, weight_decay,
                           _out16(bf16_out, n))
    adagrad_step.launches += 1


adam_step.launches = 0
adagrad_step.launches = 0


def _s(x):
    return np.float32(x)


def bf16_bits(x):
    """fp32 → bfloat16 by round-to-nearest-even, as ``uint16`` bits (the
    kernel's ``float_to_bf16``)."""
    return x.to(torch.bfloat16).view(torch.uint16)


@torch.no_grad()
def adam_step_plain(params, exp_avg, exp_avg_sq, grads, lr, beta1, beta2,
                    eps, weight_decay, adamw_mode, bias_correction, step,
                    bf16_out=None):
    """:func:`adam_step`'s arithmetic in plain PyTorch (fp32 scalars as the
    kernel computes them); equal to it up to the FMA contractions that
    ``-march=native`` lets the compiler make."""
    b1, b2 = _s(beta1), _s(beta2)
    bc1 = bc2 = _s(1.0)
    if bias_correction:
        bc1 = _s(1.0) - np.power(b1, _s(step))
        bc2 = _s(1.0) - np.power(b2, _s(step))
    step_size = _s(lr) / bc1
    bc2_sqrt = np.sqrt(bc2)
    w_decay = _s(1.0) - _s(lr) * _s(weight_decay) \
        if adamw_mode and weight_decay > 0.0 else _s(1.0)
    g = grads
    if not adamw_mode and weight_decay > 0.0:
        g = g + float(_s(weight_decay)) * params
    exp_avg.mul_(float(b1)).add_(g * float(_s(1.0) - b1))
    exp_avg_sq.mul_(float(b2)).add_(g * g * float(_s(1.0) - b2))
    denom = exp_avg_sq.sqrt().div_(float(bc2_sqrt)).add_(float(_s(eps)))
    params.mul_(float(w_decay)).sub_(exp_avg / denom * float(step_size))
    if bf16_out is not None:
        bf16_out.copy_(bf16_bits(params).view(bf16_out.dtype))


@torch.no_grad()
def adagrad_step_plain(params, exp_avg_sq, grads, lr, eps, weight_decay,
                       bf16_out=None):
    """:func:`adagrad_step`'s arithmetic in plain PyTorch."""
    g = grads
    if weight_decay > 0.0:
        g = g + float(_s(weight_decay)) * params
    exp_avg_sq.add_(g * g)
    params.sub_(g * float(_s(lr)) / (exp_avg_sq.sqrt() + float(_s(eps))))
    if bf16_out is not None:
        bf16_out.copy_(bf16_bits(params).view(bf16_out.dtype))


def host_buffer(n, dtype=torch.float32, pin=False):
    """A zeroed contiguous CPU tensor of ``n`` elements, page-locked when
    ``pin`` (the card's copy engines read and write it directly)."""
    return torch.zeros(n, dtype=dtype, pin_memory=bool(pin))


def host_copy(t, pin=False):
    """A fresh flat fp32 host tensor holding ``t``'s values (from any
    device), page-locked when ``pin``."""
    t = torch.as_tensor(t).detach().reshape(-1)
    out = torch.empty(t.numel(), dtype=torch.float32, pin_memory=bool(pin))
    out.copy_(t)
    return out


class DeepSpeedCPUAdam:
    """Stateful host Adam over a list of flat fp32 CPU tensors (the JAX
    package's ``DeepSpeedCPUAdam``): ``step(grads, bf16_outs)`` updates the
    masters and moments in place, one C++ call a tensor."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, bias_correction=True, adamw_mode=True,
                 pin_memory=False):
        self.pin_memory = bool(pin_memory)
        self.params = [host_copy(p, self.pin_memory) for p in params]
        self.exp_avg = [host_buffer(p.numel(), pin=self.pin_memory)
                        for p in self.params]
        self.exp_avg_sq = [host_buffer(p.numel(), pin=self.pin_memory)
                           for p in self.params]
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.adamw_mode = adamw_mode
        self.step_count = 0

    def step(self, grads, bf16_outs=None, lr=None):
        self.step_count += 1
        lr = self.lr if lr is None else lr
        for i, (p, g) in enumerate(zip(self.params, grads)):
            adam_step(p, self.exp_avg[i], self.exp_avg_sq[i],
                      g.reshape(-1), lr, self.beta1, self.beta2, self.eps,
                      self.weight_decay, self.adamw_mode,
                      self.bias_correction, self.step_count,
                      bf16_out=None if bf16_outs is None else bf16_outs[i])

    def state_dict(self):
        return {"step": self.step_count, "exp_avg": self.exp_avg,
                "exp_avg_sq": self.exp_avg_sq}

    def load_state_dict(self, sd):
        self.step_count = int(sd["step"])
        self.exp_avg = [host_copy(a, self.pin_memory) for a in sd["exp_avg"]]
        self.exp_avg_sq = [host_copy(a, self.pin_memory)
                           for a in sd["exp_avg_sq"]]
