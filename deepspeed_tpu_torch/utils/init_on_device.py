"""``OnDevice``: build a model without allocating it (port of
``deepspeed_tpu/utils/init_on_device.py``, reference
``deepspeed/utils/init_on_device.py``).

Inside ``with OnDevice(dtype=torch.float32, device="meta"):`` every tensor
factory call (``torch.empty``, ``zeros``, ``ones``, ``full``, ``rand*``,
``arange``, ...) lands on ``device`` and makes its floating tensors in
``dtype``, whatever device and dtype the caller named: a module built there
holds shapes and dtypes and no storage (JAX's ``jax.eval_shape``).  The
engine gives such a module its storage: whole at world size 1, or, under
ZeRO-3, each rank's shard of each leaf at birth (``runtime/zero``
``Init``), a module at a time, so no rank holds the whole model.
"""

import contextlib

import torch
from torch.overrides import TorchFunctionMode

_FACTORIES = {
    torch.empty, torch.zeros, torch.ones, torch.full, torch.rand,
    torch.randn, torch.randint, torch.arange, torch.eye, torch.tensor,
    torch.empty_strided, torch.linspace,
}
# factories whose default dtype follows their arguments (integers stay so)
_ARG_TYPED = {torch.randint, torch.arange, torch.tensor, torch.full}


class _Placed(TorchFunctionMode):

    def __init__(self, ctx):
        super().__init__()
        self.ctx = ctx

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func in _FACTORIES:
            kwargs["device"] = self.ctx.device
            want, have = self.ctx.dtype, kwargs.get("dtype")
            # a floating tensor takes the context's dtype; a factory
            # whose dtype follows its arguments keeps it unless named
            if want is not None and (
                    have.is_floating_point if have is not None
                    else func not in _ARG_TYPED):
                kwargs["dtype"] = want
        return func(*args, **kwargs)


class OnDevice(contextlib.AbstractContextManager):
    """``with OnDevice(dtype=torch.bfloat16, device="meta"): model = ...``

    ``device``: where the tensors made inside land (``"meta"``: nowhere);
    ``dtype`` (optional): the dtype of their floating tensors;
    ``enabled=False`` changes nothing."""

    _current = None

    def __init__(self, dtype=None, device="meta", enabled=True):
        self.dtype = dtype
        self.device = torch.device(device)
        self.enabled = enabled
        self._prev = None
        self._mode = None

    def __enter__(self):
        self._prev = OnDevice._current
        if self.enabled:
            OnDevice._current = self
            self._mode = _Placed(self)
            self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        if self._mode is not None:
            self._mode.__exit__(*exc)
            self._mode = None
        OnDevice._current = self._prev
        return False

    def abstract_init(self, init_fn, *args, **kwargs):
        """``init_fn(*args, **kwargs)`` with its tensors made on this
        context's device and dtype (on ``meta``: shapes only)."""
        if OnDevice._current is self:
            return init_fn(*args, **kwargs)
        with self:
            return init_fn(*args, **kwargs)


def abstract_init(init_fn, *args, **kwargs):
    """``init_fn(*args, **kwargs)`` under the active ``OnDevice`` context,
    or under a ``meta`` one when none is active."""
    ctx = OnDevice._current or OnDevice()
    return ctx.abstract_init(init_fn, *args, **kwargs)
