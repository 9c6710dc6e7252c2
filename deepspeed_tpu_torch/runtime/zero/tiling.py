"""TiledLinear (port of ``deepspeed_tpu/runtime/zero/tiling.py``, reference
``runtime/zero/tiling.py``): a large linear split into ``in_splits`` ×
``out_splits`` tiles, so that ZeRO-3 gathers one tile's weight at a time.

Tile ``(o, i)`` is an ``nn.Linear`` (no bias) from input columns ``i`` to
output columns ``o`` (``tile_{o}_{i}``, torch's ``[out, in]`` layout, the
JAX tile's kernel transposed); ``bias_{o}`` is output split ``o``'s fp32
bias.  Each output split sums its tiles' products in the tiles' dtype,
then adds its bias (``TiledLinearReturnBias`` returns the bias instead).
Under a stage-3 engine each tile is a unit of its own
(:meth:`TiledLinear.zero3_units`): its pre-forward hook gathers that
tile, its post-forward hook releases it.
"""

import torch
import torch.nn.functional as F
from torch import nn


class _Tile(nn.Linear):
    """One tile: its weight cast to the input's dtype (flax's
    ``Dense(dtype=...)``)."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype))


class TiledLinear(nn.Module):

    def __init__(self, in_features, out_features, in_splits=1, out_splits=1,
                 bias=True, input_is_already_split=False,
                 dtype=torch.float32, device=None):
        super().__init__()
        assert in_features % in_splits == 0, \
            f"in_features {in_features} % in_splits {in_splits}"
        assert out_features % out_splits == 0, \
            f"out_features {out_features} % out_splits {out_splits}"
        self.in_features, self.out_features = in_features, out_features
        self.in_splits, self.out_splits = in_splits, out_splits
        self.input_is_already_split = input_is_already_split
        self.dtype = dtype
        self.use_bias = bias
        in_tile = in_features // in_splits
        out_tile = out_features // out_splits
        for o in range(out_splits):
            for i in range(in_splits):
                self.add_module(f"tile_{o}_{i}", _Tile(
                    in_tile, out_tile, bias=False, device=device))
            if bias:
                self.register_parameter(f"bias_{o}", nn.Parameter(
                    torch.zeros(out_tile, device=device)))

    # ZeRO-3's coordinator, set by a stage-3 engine (``runtime/zero/
    # stage3.py``)
    _zero3 = None

    def zero3_units(self):
        """Each tile a unit of its own (a module: its hooks gather it), then
        the biases (``bias``)."""
        units = []
        for o in range(self.out_splits):
            for i in range(self.in_splits):
                name = f"tile_{o}_{i}"
                units.append((name, getattr(self, name), [f"{name}.weight"],
                              [f"{name}.weight"]))
        biases = [f"bias_{o}" for o in range(self.out_splits)] \
            if self.use_bias else []
        units.append(("bias", None, biases, biases))
        return units

    def _split_input(self, x):
        if self.input_is_already_split:
            assert len(x) == self.in_splits
            return list(x)
        in_tile = self.in_features // self.in_splits
        return [x[..., i * in_tile:(i + 1) * in_tile]
                for i in range(self.in_splits)]

    def _tile_matmuls(self, xs):
        outs = []
        for o in range(self.out_splits):
            acc = None
            for i in range(self.in_splits):
                tile = getattr(self, f"tile_{o}_{i}")
                y = tile(xs[i].to(self.dtype))
                acc = y if acc is None else acc + y
            outs.append(acc)
        return outs

    def _biases(self):
        return [getattr(self, f"bias_{o}") for o in range(self.out_splits)]

    def _add_biases(self, outs):
        return torch.cat([acc + b.to(acc.dtype)
                          for acc, b in zip(outs, self._biases())], dim=-1)

    def _unit(self, name, fn, *args):
        z = self._zero3
        return fn(*args) if z is None else z.run(name, fn, *args)

    def forward(self, x):
        outs = self._tile_matmuls(self._split_input(x))
        if not self.use_bias:
            return torch.cat(outs, dim=-1)
        return self._unit("bias", self._add_biases, outs)

    @staticmethod
    def full_weight(params, in_splits, out_splits):
        """The logical ``[in, out]`` kernel (the JAX layout) from the
        tiles' weights: ``params`` a state dict (``tile_{o}_{i}.weight``)
        or the module."""
        if isinstance(params, nn.Module):
            params = params.state_dict()
        rows = []
        for i in range(in_splits):
            cols = [params[f"tile_{o}_{i}.weight"].t()
                    for o in range(out_splits)]
            rows.append(torch.cat(cols, dim=-1))
        return torch.cat(rows, dim=0)


class TiledLinearReturnBias(TiledLinear):
    """Returns ``(out, bias)`` unsummed, so a caller can add the bias
    later (reference ``TiledLinearReturnBias``)."""

    def _concat_biases(self, y):
        return torch.cat(self._biases(), dim=0).to(y.dtype)

    def forward(self, x):
        y = torch.cat(self._tile_matmuls(self._split_input(x)), dim=-1)
        if not self.use_bias:
            return y, None
        return y, self._unit("bias", self._concat_biases, y)
