"""Weight quantization for inference (port of
``deepspeed_tpu/runtime/weight_quantizer.py``).

:class:`WeightQuantization` quantizes model weights to INT8 or packed
INT4 when they are loaded — groupwise, or per output channel (symmetric
int8) — and leaves embeddings and the LM head float by name.  It works
on tensors in the JAX package's (flax) layout, so it picks the same
leaves, the same scale axes and the same group boundaries as the JAX
quantizer and gives bitwise the same payloads and scales.

:class:`QuantizedLinear` holds a quantized ``nn.Linear``: the payload and
scales are buffers (the weights stay resident as int8), and its
``weight`` / ``bias`` dequantize to the compute dtype where the forward
reads them, so the matrix product after them stays ``F.linear``.  The
JAX package dequantizes outside any Pallas kernel too (XLA fuses the
dequant into each weight's consumer); here every forward materialises
the compute-dtype weight for the length of one product.
"""

import re

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.ops.quantizer.kernels import (dequantize, pack_int4,
                                                       quantize, true_div,
                                                       unpack_int4)
from deepspeed_tpu_torch.utils.logging import logger


class QuantizedWeight:
    """One quantized tensor: payload ``q`` (int8 ``[G, group]``, or
    nibble-packed uint8 for 4 bits; int8 in the tensor's own shape per
    channel), ``scale`` / ``zero`` (``zero`` None per channel), and the
    original ``shape`` (flax layout), ``bits``, ``symmetric`` and
    ``per_channel``."""

    def __init__(self, q, scale, zero, shape, bits, symmetric=True,
                 per_channel=False):
        self.q = q
        self.scale = scale
        self.zero = zero
        self.shape = tuple(shape)
        self.bits = int(bits)
        self.symmetric = bool(symmetric)
        self.per_channel = bool(per_channel)

    def tensors(self):
        """``{"q", "scale"[, "zero"]}``."""
        out = {"q": self.q, "scale": self.scale}
        if self.zero is not None:
            out["zero"] = self.zero
        return out


# matrices whose name matches one of these stay float (the JAX package's
# list: embeddings and the LM head), matched token-anchored
DEFAULT_SKIP_PATTERNS = ("embed", "embedding", "embeddings", "wte", "wpe",
                         "lm_head")


class WeightQuantization:
    """Groupwise or per-channel weight quantizer (the JAX package's
    ``WeightQuantization``).  :meth:`quantize_tree` turns every floating
    tensor with ``ndim >= min_ndim`` of a flat ``{path: tensor}`` dict
    (flax paths and layouts) into a :class:`QuantizedWeight`, unless its
    path matches ``skip_patterns``."""

    def __init__(self, bits=8, group_size=64, symmetric=True, min_ndim=2,
                 mlp_extra_grouping=False, mp_size=1,
                 skip_patterns=DEFAULT_SKIP_PATTERNS, per_channel=False):
        if bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {bits}")
        if per_channel and (bits != 8 or not symmetric):
            raise ValueError("per_channel quantization supports symmetric "
                             "int8 only")
        self.per_channel = bool(per_channel)
        if group_size < 2:
            raise ValueError(f"group_size must be >= 2, got {group_size}")
        if group_size % 2:
            logger.warning(
                f"WeightQuantization: odd group_size {group_size} rounded up "
                f"to {group_size + 1} (int4 nibble-packing needs even groups)")
            group_size += 1
        if mlp_extra_grouping or mp_size != 1:
            logger.warning(
                "WeightQuantization: mlp_extra_grouping/mp_size are accepted "
                "for reference-API compatibility but have no effect here")
        self.bits = bits
        self.group_size = group_size
        self.symmetric = symmetric
        self.min_ndim = min_ndim
        self.skip_patterns = tuple(p.lower() for p in skip_patterns)
        self._skip_re = re.compile(
            "|".join(rf"(?:^|[^a-z0-9]){re.escape(p)}(?:[^a-z0-9]|$)"
                     for p in self.skip_patterns)) if self.skip_patterns \
            else None

    def should_quantize(self, t):
        return t.dim() >= self.min_ndim and t.is_floating_point()

    def name_skipped(self, name):
        return self._skip_re is not None and \
            self._skip_re.search(name.lower()) is not None

    def quantize_leaf(self, x):
        """One tensor (flax layout) → :class:`QuantizedWeight`, computed in
        fp32 from ``x`` as given."""
        xf = x.float()
        if self.per_channel:
            # symmetric int8, one scale per output channel: reduced over the
            # leading (contraction) axis only
            absmax = xf.abs().amax(dim=0, keepdim=True)
            scale = torch.where(absmax > 0, true_div(absmax, 127.0),
                                torch.ones_like(absmax))
            q = torch.clamp(torch.round(xf / scale), -128, 127)
            return QuantizedWeight(q.to(torch.int8), scale, None, x.shape, 8,
                                   symmetric=True, per_channel=True)
        # the flat vector (flax element order) padded to whole groups
        pad = (-xf.numel()) % self.group_size
        flat = F.pad(xf.reshape(-1), (0, pad))
        q, scale, zero = quantize(flat, flat.numel() // self.group_size,
                                  num_bits=self.bits,
                                  symmetric=self.symmetric)
        if self.bits == 4:
            q = pack_int4(q)
        return QuantizedWeight(q, scale, zero, x.shape, self.bits,
                               self.symmetric)

    @staticmethod
    def dequantize_leaf(qw, dtype=torch.bfloat16):
        """The weight in ``dtype`` and its flax shape.  Per channel the
        product is ``q.astype(dtype) * scale.astype(dtype)``, as in the JAX
        package: here one mixed int8 × ``dtype`` multiply, whose promotion
        casts the payload exactly (|q| <= 128) and rounds the fp32 product
        to ``dtype`` once, the same bits without a ``dtype`` copy of the
        payload.  Groupwise it runs in fp32 and is cast after."""
        if qw.per_channel:
            return qw.q * qw.scale.to(dtype)
        q = unpack_int4(qw.q) if qw.bits == 4 else qw.q
        groups = qw.scale.shape[0]
        flat = dequantize(q.reshape(groups, -1), qw.scale, qw.zero,
                          num_bits=qw.bits, symmetric=qw.symmetric)
        numel = 1
        for n in qw.shape:
            numel *= n
        return flat.reshape(-1)[:numel].reshape(qw.shape).to(dtype)

    def quantize_tree(self, flat):
        """``{path: tensor}`` → the same dict with every quantized leaf a
        :class:`QuantizedWeight`."""
        out, n_q, n_skip = {}, 0, 0
        for path, leaf in flat.items():
            if self.should_quantize(leaf) and self.name_skipped(path):
                n_skip += 1
            elif self.should_quantize(leaf):
                leaf = self.quantize_leaf(leaf)
                n_q += 1
            out[path] = leaf
        logger.info(f"weight-quantized {n_q} tensors to int{self.bits} "
                    f"(group {self.group_size}); {n_skip} matrices kept float "
                    f"by name filter {self.skip_patterns}")
        return out

    def dequantize_tree(self, flat, dtype=torch.bfloat16):
        return {k: self.dequantize_leaf(v, dtype)
                if isinstance(v, QuantizedWeight) else v
                for k, v in flat.items()}


class QuantizedLinear(nn.Module):
    """A linear layer whose weight — and bias, where the quantizer took it
    — is a :class:`QuantizedWeight` in the flax layout of the JAX model:
    kernel ``[in, ...out dims]``, bias ``[...out dims]``.  ``weight`` /
    ``bias`` dequantize to ``dtype`` and view the result in ``nn.Linear``'s
    layout (``[out, in]``, ``[out]``); a bias the quantizer left float is
    held in ``dtype``."""

    def __init__(self, weight, bias, in_features, out_features, dtype,
                 paths=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype
        # the flax paths of the kernel and bias (quantized_leaves() keys)
        self.paths = dict(zip(("weight", "bias"), paths or ()))
        self._meta = {}
        for name, val in (("weight", weight), ("bias", bias)):
            if isinstance(val, QuantizedWeight):
                self._meta[name] = (val.shape, val.bits, val.symmetric,
                                    val.per_channel)
                for part, t in val.tensors().items():
                    self.register_buffer(f"{name}_{part}", t)
                if val.per_channel:
                    # the scale in the compute dtype, cast once: the
                    # per-call dequant is then one multiply
                    self.register_buffer(f"{name}_scale_c",
                                         val.scale.to(dtype))
            elif val is not None:
                self.register_buffer(f"{name}_float", val.to(dtype))
        self.has_bias = bias is not None

    def quantized(self):
        """``{flax path: QuantizedWeight}`` of what this layer holds
        quantized."""
        return {self.paths[name]: self._quantized(name)
                for name in self._meta}

    def _quantized(self, name):
        if name not in self._meta:
            return None
        shape, bits, symmetric, per_channel = self._meta[name]
        return QuantizedWeight(getattr(self, f"{name}_q"),
                               getattr(self, f"{name}_scale"),
                               getattr(self, f"{name}_zero", None), shape,
                               bits, symmetric, per_channel)

    def _value(self, name):
        qw = self._quantized(name)
        if qw is None:
            return getattr(self, f"{name}_float", None)
        if qw.per_channel:       # dequantize_leaf's product, scale cast once
            return qw.q * getattr(self, f"{name}_scale_c")
        return WeightQuantization.dequantize_leaf(qw, self.dtype)

    @property
    def weight(self):
        w = self._value("weight")
        return w if "weight" not in self._meta else \
            w.reshape(self.in_features, self.out_features).T

    @property
    def bias(self):
        b = self._value("bias")
        return b if b is None else b.reshape(-1)

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight, self.bias)

    def float_linear(self):
        """An empty fp32 ``nn.Linear`` of this layer's shape on its device
        (for loading new float weights)."""
        return nn.Linear(self.in_features, self.out_features,
                         bias=self.has_bias, device=self.weight_q.device,
                         dtype=torch.float32)

    @classmethod
    def from_linear(cls, linear, quantizer, names, shapes, dtype):
        """Quantize ``linear`` (its fp32 weights) the way the JAX quantizer
        treats the flax leaves it came from: ``names`` the flax paths of
        its kernel and bias, ``shapes`` their flax shapes.  Returns None
        when the quantizer keeps both float (the layer stays a Linear)."""
        leaves = {names[0]: linear.weight.detach().float().T
                  .reshape(shapes[0])}
        if linear.bias is not None:
            leaves[names[1]] = linear.bias.detach().float().reshape(shapes[1])
        out = [leaves.get(n) for n in names]
        for i, (path, t) in enumerate(zip(names, out)):
            if t is not None and quantizer.should_quantize(t) \
                    and not quantizer.name_skipped(path):
                out[i] = quantizer.quantize_leaf(t)
        if not any(isinstance(t, QuantizedWeight) for t in out):
            return None
        if not isinstance(out[0], QuantizedWeight):
            raise NotImplementedError(f"{names[0]} kept float with its bias "
                                      f"quantized")
        return cls(out[0], out[1], linear.in_features, linear.out_features,
                   dtype, names)


def holds_quantized(module):
    """Whether ``module`` holds any :class:`QuantizedLinear`."""
    return any(isinstance(m, QuantizedLinear) for m in module.modules())
