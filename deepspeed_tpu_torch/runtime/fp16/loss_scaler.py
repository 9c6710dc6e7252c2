"""Loss scaling (port of ``deepspeed_tpu/runtime/fp16/loss_scaler.py``).

bf16 and fp32 need no scaling (a static scale of 1); fp16 keeps the
reference semantics: the dynamic scale doubles every ``scale_window`` good
steps and halves on overflow once hysteresis is spent, never below
``min_scale``.  The state is three 0-dim tensors on the training device,
updated with ``torch.where`` from the device overflow flag: the update is
branch-free, as the JAX one is, so no step waits for the host.
"""

from typing import NamedTuple

import torch


class LossScalerState(NamedTuple):
    scale: torch.Tensor         # f32 scalar
    good_steps: torch.Tensor    # i32 scalar
    hysteresis: torch.Tensor    # i32 scalar


def _state(scale, good_steps, hysteresis, device):
    return LossScalerState(
        scale=torch.tensor(scale, dtype=torch.float32, device=device),
        good_steps=torch.tensor(good_steps, dtype=torch.int32, device=device),
        hysteresis=torch.tensor(hysteresis, dtype=torch.int32, device=device))


class DynamicLossScaler:

    def __init__(self, init_scale=2**16, scale_factor=2.0, scale_window=1000,
                 min_scale=1.0, delayed_shift=1, consecutive_hysteresis=False,
                 raise_error_at_min_scale=False):
        self.init_scale = float(init_scale)
        self.scale_factor = float(scale_factor)
        self.scale_window = int(scale_window)
        self.min_scale = float(min_scale)
        self.delayed_shift = int(delayed_shift)
        self.consecutive_hysteresis = consecutive_hysteresis

    def init(self, device=None):
        return _state(self.init_scale, 0, self.delayed_shift, device)

    def update(self, state, found_inf):
        """Branch-free dynamic-scale update given the overflow flag (a
        0-dim bool tensor).  Every overflow decrements hysteresis; the scale
        halves only once hysteresis is exhausted, then hysteresis resets.
        With ``consecutive_hysteresis`` a good step restores hysteresis;
        without it, good steps leave it depleted."""
        found_inf = found_inf.to(torch.bool)
        hysteresis = torch.where(found_inf,
                                 (state.hysteresis - 1).clamp(min=0),
                                 state.hysteresis)
        drop = found_inf & (hysteresis <= 0)
        new_scale = torch.where(
            drop, (state.scale / self.scale_factor).clamp(min=self.min_scale),
            state.scale)
        window_hit = (state.good_steps + 1) >= self.scale_window
        grow = (~found_inf) & window_hit
        new_scale = torch.where(grow, new_scale * self.scale_factor,
                                new_scale)
        new_good = torch.where(found_inf | grow,
                               torch.zeros_like(state.good_steps),
                               state.good_steps + 1)
        restore = drop | ((~found_inf) & self.consecutive_hysteresis)
        new_hyst = torch.where(restore,
                               torch.full_like(hysteresis, self.delayed_shift),
                               hysteresis)
        return LossScalerState(new_scale, new_good.to(torch.int32),
                               new_hyst.to(torch.int32))


class StaticLossScaler:

    def __init__(self, scale=1.0):
        self.scale_value = float(scale)

    def init(self, device=None):
        return _state(self.scale_value, 0, 1, device)

    def update(self, state, found_inf):
        return state


def create_loss_scaler(fp16_config):
    """``loss_scale == 0`` → dynamic, else static (1.0 without fp16)."""
    if not fp16_config.enabled:
        return StaticLossScaler(1.0)
    if fp16_config.loss_scale == 0:
        return DynamicLossScaler(
            init_scale=2.0 ** fp16_config.initial_scale_power,
            scale_window=fp16_config.loss_scale_window,
            min_scale=fp16_config.min_loss_scale,
            delayed_shift=fp16_config.hysteresis)
    return StaticLossScaler(fp16_config.loss_scale)
