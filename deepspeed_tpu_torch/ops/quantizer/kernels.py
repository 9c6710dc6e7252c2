"""Groupwise quantization (port of ``deepspeed_tpu/ops/quantizer/kernels.py``
as plain PyTorch).

The JAX package writes these as plain ``jnp`` programs, not Pallas
kernels: groupwise symmetric / asymmetric INT8 / INT4 quantize and
dequantize, and nibble packing so that 4-bit payloads really take 4 bits.
The arithmetic follows the JAX functions step by step in fp32 (IEEE
division, ``torch.round`` rounds half to even as ``jnp.round`` does), so
payloads and scales come out bitwise equal.
"""

import torch


def true_div(x, c):
    """``x / c`` for a constant ``c`` by IEEE division on every device.
    PyTorch's CUDA kernels multiply by the reciprocal of a Python-number
    divisor (as XLA does inside ``jit``), which can differ in the last bit
    from the division the JAX source writes and the port's CUDA kernels
    compute; a divisor tensor on ``x``'s device is divided exactly."""
    return x / torch.full_like(x, c)


def _grouped(x, num_groups):
    n = x.numel()
    if n % num_groups:
        raise ValueError(f"size {n} not divisible into {num_groups} groups")
    return x.reshape(num_groups, n // num_groups)


def quantize(x, num_groups, num_bits=8, symmetric=True):
    """Groupwise quantize.  Returns ``(q, scale, zero)``: ``q`` int8 (for
    4-bit, values in [-8, 7] before packing), ``scale`` / ``zero`` fp32
    ``[num_groups, 1]``."""
    g = _grouped(x.float(), num_groups)
    qmax = 2.0 ** (num_bits - 1) - 1.0
    if symmetric:
        absmax = g.abs().amax(dim=1, keepdim=True)
        scale = torch.where(absmax > 0, true_div(absmax, qmax),
                            torch.ones_like(absmax))
        q = torch.clamp(torch.round(g / scale), -qmax - 1, qmax)
        zero = torch.zeros_like(scale)
    else:
        gmin = g.amin(dim=1, keepdim=True)
        gmax = g.amax(dim=1, keepdim=True)
        span = torch.clamp(gmax - gmin, min=1e-8)
        scale = true_div(span, 2.0 ** num_bits - 1.0)
        zero = gmin
        q = torch.clamp(torch.round((g - zero) / scale), 0,
                        2.0 ** num_bits - 1.0)
        q = q - 2.0 ** (num_bits - 1)
    return q.to(torch.int8), scale, zero


def dequantize(q, scale, zero, num_bits=8, symmetric=True, shape=None):
    """fp32 values of a groupwise payload ``q [G, n]``."""
    g = q.float()
    if symmetric:
        out = g * scale
    else:
        out = (g + 2.0 ** (num_bits - 1)) * scale + zero
    return out.reshape(shape) if shape is not None else out


def pack_int4(q):
    """Pack int8-held 4-bit values [-8, 7] two per byte (low nibble
    first) into uint8."""
    flat = q.reshape(q.shape[0], -1)
    if flat.shape[1] % 2:
        raise ValueError("int4 packing needs an even number of values per "
                         "row")
    lo = (flat[:, 0::2] & 0xF).to(torch.uint8)
    hi = (flat[:, 1::2] & 0xF).to(torch.uint8)
    return lo | (hi << 4)


def unpack_int4(packed):
    """Inverse of :func:`pack_int4`: int8 values in [-8, 7]."""
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo > 7, lo - 16, lo)   # sign-extend the nibbles
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], -1)
