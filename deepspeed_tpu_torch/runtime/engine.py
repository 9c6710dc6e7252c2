"""DeepSpeedEngine — the training engine at world size 1 (port of
``deepspeed_tpu/runtime/engine.py``).

The imperative 3-call API and the whole-batch call of the JAX engine::

    loss = engine(batch)        # forward: the loss, graph kept
    engine.backward(loss)       # (loss * scale / gas).backward()
    engine.step()               # optimizer update at the accumulation boundary

    loss = engine.train_batch(batch=stacked)   # [gas, micro, ...] at once

The JAX engine jits each phase into an XLA program over sharded pytrees;
the port runs eagerly on one device.  fp32 master parameters stay on the
module (the model casts each weight to its compute dtype at use, which is
the JAX ``_apply_model`` cast), gradients accumulate in their fp32
``.grad``, and the optimizer updates the parameter list in place with
``torch._foreach_*`` ops.

``step`` unscales by the loss scale, computes the global gradient norm and
clips (the JAX ``_unscale_and_clip``, ``1e-6`` included), updates, and
steps the LR schedule.  With a loss scale that can overflow (fp16), a
non-finite gradient skips the update branch-free — parameters and
optimizer state are selected back with ``torch.where`` on the device flag,
a group of ``SKIP_GROUP_NUMEL`` parameter elements at a time, so the copy
kept for the selection is one group's, not the model's —
and the dynamic scaler updates from the same flag, so no step waits for
the host.  With the static unit scale of bf16 / fp32 the overflow
machinery is compiled out, as in the JAX engine's ``train_batch``.

Not in this slice (ROADMAP.md, queue A): checkpoint save / load, the
compile cache, the profiler, the monitor, offload, multi-GPU.
"""

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.accelerator import get_accelerator, resolve_device
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (StaticLossScaler,
                                                          create_loss_scaler)
from deepspeed_tpu_torch.runtime.lr_schedules import build_lr_scheduler
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer
from deepspeed_tpu_torch.utils.logging import log_dist

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16"}


# parameter elements per group of the fp16 overflow skip: only one group's
# parameters and optimizer state are held twice at a time
SKIP_GROUP_NUMEL = 1 << 26


def _state_tensors(state):
    """The tensors of an optimizer state (a NamedTuple of lists / None)."""
    out = []
    for field in state:
        if field is not None:
            out.extend(field)
    return out


def _state_slice(state, sl):
    """The optimizer state of the parameters ``sl`` (the same tensors)."""
    return type(state)(*(None if f is None else f[sl] for f in state))


def _skip_groups(params):
    """Consecutive slices of ``params``, each ending where its element
    count reaches ``SKIP_GROUP_NUMEL``."""
    groups, lo, n = [], 0, 0
    for i, p in enumerate(params):
        n += p.numel()
        if n >= SKIP_GROUP_NUMEL:
            groups.append(slice(lo, i + 1))
            lo, n = i + 1, 0
    if lo < len(params):
        groups.append(slice(lo, len(params)))
    return groups


def _map(fn, batch):
    if isinstance(batch, Mapping):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, v) for v in batch)
    return fn(batch)


class DeepSpeedEngine:
    """Training engine at world size 1."""

    def __init__(self, model=None, optimizer=None, model_parameters=None,
                 training_data=None, lr_scheduler=None, collate_fn=None,
                 config=None, loss_fn=None, device=None):
        if model is None:
            raise NotImplementedError(
                "the port's engine takes an nn.Module whose forward(batch) "
                "returns the loss; functional models (model=None with "
                "loss_fn) are not ported yet (see ROADMAP.md)")
        if not isinstance(model, nn.Module):
            raise ValueError(f"model must be an nn.Module, got "
                             f"{type(model).__name__}")
        self.device = resolve_device(device)
        self.accelerator = get_accelerator(self.device)
        self._config = config if isinstance(config, DeepSpeedConfig) \
            else DeepSpeedConfig(config if config is not None else {})
        self.module = model
        self.loss_fn = loss_fn
        self.training_dataloader = None

        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self._skipped_steps = 0
        self._pending_inf_flags = []   # device overflow flags, read lazily
        self._pending = None           # loss of a forward awaiting backward
        self._window_open = False      # gradients accumulated since the step
        self._found_inf = None
        self._last_loss = None
        self._last_global_grad_norm = None
        self.training = True

        if self._config.fp16.enabled:
            self.compute_dtype = torch.float16
        elif self._config.bf16.enabled:
            self.compute_dtype = torch.bfloat16
        else:
            self.compute_dtype = torch.float32
        model_dtype = getattr(getattr(model, "config", None), "dtype", None)
        if model_dtype is not None and \
                str(model_dtype) != _DTYPE_NAMES[self.compute_dtype]:
            raise ValueError(
                f"the model computes in {model_dtype} but the config asks "
                f"for {_DTYPE_NAMES[self.compute_dtype]} (fp16 / bf16 "
                f"blocks); build the model with "
                f"dtype={_DTYPE_NAMES[self.compute_dtype]!r}")

        self._place_module(model_parameters)
        self._params = [p for p in self.module.parameters()
                        if p.requires_grad]
        bad = [p.dtype for p in self._params if p.dtype != torch.float32]
        if bad:
            raise ValueError(f"master parameters must be float32, got {bad}")

        self.optimizer = optimizer or build_optimizer(self._config.optimizer)
        self._opt_state = self.optimizer.init(self._params)
        self.lr_scheduler = lr_scheduler or build_lr_scheduler(
            self._config.scheduler, self.optimizer)
        self.loss_scaler = create_loss_scaler(self._config.fp16)
        self._scaler_state = self.loss_scaler.init(self.device)
        # a static unit scale cannot overflow: no flag, no skip
        self._static_unit = isinstance(self.loss_scaler, StaticLossScaler) \
            and self.loss_scaler.scale_value == 1.0

        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(
                training_data, collate_fn=collate_fn)
        n = sum(p.numel() for p in self._params)
        log_dist(f"DeepSpeedEngine configured: device={self.device} "
                 f"dtype={_DTYPE_NAMES[self.compute_dtype]} "
                 f"params={n / 1e6:.2f}M "
                 f"zero_stage={self.zero_optimization_stage()} "
                 f"micro_bs={self.train_micro_batch_size_per_gpu()} "
                 f"gas={self.gradient_accumulation_steps()}", ranks=[0])

    # ------------------------------------------------------------------ #
    # Placement
    # ------------------------------------------------------------------ #
    def _place_module(self, model_parameters):
        """Put the module on the device.  A ``meta``-built module gets
        storage there and, unless ``model_parameters`` are given, a random
        init from ``config["seed"]`` through an explicit generator."""
        m = self.module
        on_meta = any(t.is_meta for t in
                      list(m.parameters()) + list(m.buffers()))
        if on_meta:
            m.to_empty(device=self.device)
        else:
            m.to(self.device)
        if isinstance(model_parameters, Mapping):
            self.load_params(model_parameters)
        elif on_meta:
            if not hasattr(m, "init_weights"):
                raise ValueError("a meta-built module needs init_weights("
                                 "generator) or model_parameters")
            m.init_weights(self.accelerator.manual_seed(self._config.seed,
                                                        self.device))

    @torch.no_grad()
    def load_params(self, tree):
        """Replace the master parameters: a ``state_dict``-like mapping of
        this module, or a JAX parameter tree (nested dicts, converted with
        the model's ``params_from_flax``)."""
        if any(isinstance(v, Mapping) for v in tree.values()):
            from deepspeed_tpu_torch.models.transformer import (
                params_from_flax)
            tree = params_from_flax(tree, self.module.config)
        sd = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                 else v).to(torch.float32)
              for k, v in tree.items()}
        self.module.load_state_dict(sd)

    def put_batch(self, batch):
        """``batch`` (tensors or arrays, nested in dicts / lists) on the
        engine's device."""
        def put(x):
            if not torch.is_tensor(x):
                x = torch.as_tensor(np.asarray(x))
            return x.to(self.device, non_blocking=True)
        return _map(put, batch)

    def deepspeed_io(self, dataset, batch_size=None, collate_fn=None):
        """The training loader (micro batches, placed on the device)."""
        from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
        return DeepSpeedDataLoader(
            dataset,
            batch_size=batch_size or self.train_micro_batch_size_per_gpu(),
            collate_fn=collate_fn, engine=self)

    # ------------------------------------------------------------------ #
    # Config accessors
    # ------------------------------------------------------------------ #
    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def zero_optimization_stage(self):
        return self._config.zero_config.stage

    def gradient_clipping(self):
        return self._config.gradient_clipping

    def steps_per_print(self):
        return self._config.steps_per_print

    def fp16_enabled(self):
        return self._config.fp16.enabled

    def bfloat16_enabled(self):
        return self._config.bf16.enabled

    def get_global_grad_norm(self):
        return self._last_global_grad_norm

    def get_lr(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler.get_last_lr()
        return [getattr(self.optimizer, "lr", 0.0)]

    def train(self, mode=True):
        self.training = mode
        self.module.train(mode)
        return self

    def eval(self):
        return self.train(False)

    # ------------------------------------------------------------------ #
    # forward / backward / step
    # ------------------------------------------------------------------ #
    def _loss_of(self, args, kwargs):
        args = tuple(self.put_batch(a) for a in args)
        kwargs = {k: self.put_batch(v) for k, v in kwargs.items()}
        out = self.module(*args, **kwargs)
        return out[0] if isinstance(out, tuple) else out

    def forward(self, *args, **kwargs):
        """The loss of a micro batch; in training mode its graph is kept
        for :meth:`backward`."""
        if not self.training:
            with torch.no_grad():
                return self._loss_of(args, kwargs)
        if self._pending is not None and self._window_open:
            # this window's gradients would be computed on the wrong sum
            raise RuntimeError(
                "forward() called twice without backward() inside an "
                "accumulation window — call backward(loss) after each "
                "forward")
        loss = self._loss_of(args, kwargs)
        self._pending = loss
        self._last_loss = loss.detach()
        return loss

    __call__ = forward

    def backward(self, loss, retain_graph=False):
        """Accumulate the pending forward's gradients, scaled by the loss
        scale and ``1 / gradient_accumulation_steps``, into the fp32
        ``.grad``s; with a loss scale that can overflow, fold this micro
        step's overflow flag into the window's."""
        if not self.training:
            raise RuntimeError("backward called in eval mode")
        if self._pending is None:
            raise RuntimeError("backward called without a prior forward")
        pending, self._pending = self._pending, None
        gas = self.gradient_accumulation_steps()
        scaled = pending.float() * self._scaler_state.scale / gas
        scaled.backward(retain_graph=retain_graph)
        if not self._static_unit:
            # non-finite values are sticky under addition, so the running
            # sum is non-finite iff some micro step's gradients were
            flag = ~torch.isfinite(self._grad_norm(self._grads()))
            self._found_inf = flag if self._found_inf is None \
                else self._found_inf | flag
        self._window_open = True
        self.micro_steps += 1
        return loss

    def is_gradient_accumulation_boundary(self):
        return self.micro_steps % self.gradient_accumulation_steps() == 0

    def zero_grad(self):
        for p in self._params:
            p.grad = None
        self._window_open = False
        self._found_inf = None

    def _grads(self):
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self._params]

    @staticmethod
    def _grad_norm(grads):
        return torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))

    def _unscale_and_clip(self, grads):
        """Unscale by the loss scale, take the global grad norm and clip
        (the JAX ``_unscale_and_clip``)."""
        if not self._static_unit:
            torch._foreach_mul_(grads, 1.0 / self._scaler_state.scale)
        gnorm = self._grad_norm(grads)
        clip = float(self.gradient_clipping() or 0.0)
        if clip > 0.0:
            factor = torch.clamp(clip / (gnorm + 1e-6), max=1.0)
            torch._foreach_mul_(grads, factor)
        return gnorm

    @torch.no_grad()
    def step(self, lr_kwargs=None):
        """Optimizer step at the accumulation boundary."""
        if not self.is_gradient_accumulation_boundary():
            return
        if not self._window_open:
            raise RuntimeError("step called with no accumulated gradients")
        grads = self._grads()
        lr, step_no = self.get_lr()[0], self.global_steps + 1
        gnorm = self._unscale_and_clip(grads)
        if self._static_unit:
            self.optimizer.update(grads, self._opt_state, self._params,
                                  lr=lr, step=step_no)
        else:
            # branch-free overflow skip, one group at a time: every
            # optimizer of the port updates each tensor on its own
            found = self._found_inf
            for sl in _skip_groups(self._params):
                state = _state_slice(self._opt_state, sl)
                live = self._params[sl] + _state_tensors(state)
                old = torch._foreach_clone(live)
                self.optimizer.update(grads[sl], state, self._params[sl],
                                      lr=lr, step=step_no)
                for o, n in zip(old, live):
                    torch.where(found, o, n, out=n)
                del old
            self._scaler_state = self.loss_scaler.update(self._scaler_state,
                                                         found)
            self._pending_inf_flags.append(found)
        self._last_global_grad_norm = gnorm
        self.zero_grad()
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        if self.lr_scheduler is not None:
            self.lr_scheduler.step(**(lr_kwargs or {}))
        if self.fp16_enabled() and \
                self.global_steps % self.steps_per_print() == 0:
            before = self._skipped_steps
            skipped = self.skipped_steps        # print-gated flag read
            if skipped > before:
                log_dist(f"overflow: skipped {skipped - before} recent "
                         f"step(s), loss scale "
                         f"{float(self._scaler_state.scale)}", ranks=[0])

    def train_batch(self, data_iter=None, batch=None):
        """One global batch: ``batch`` stacked ``[gas, micro, ...]`` (or
        ``gas`` micro batches from ``data_iter``) through forward /
        backward per micro batch, then one step; returns the mean of the
        micro losses, as the 3-call sequence gives."""
        gas = self.gradient_accumulation_steps()
        if batch is None:
            micro = [next(data_iter) for _ in range(gas)]
        else:
            micro = [_map(lambda x, i=i: x[i], batch) for i in range(gas)]
        losses = []
        for mb in micro:
            loss = self.forward(mb)
            self.backward(loss)
            losses.append(loss.detach())
        # set before step() so the step logs this batch's loss
        self._last_loss = torch.stack(losses).float().mean()
        self.step()
        return self._last_loss

    def eval_batch(self, batch):
        prev = self.training
        self.eval()
        out = self.forward(batch)
        self.train(prev)
        return out

    @property
    def skipped_steps(self):
        """Overflow-skipped steps; reading it syncs the queued device
        flags once (the per-step flag is never read on the hot path)."""
        if self._pending_inf_flags:
            flags, self._pending_inf_flags = self._pending_inf_flags, []
            self._skipped_steps += int(torch.stack(flags).sum())
        return self._skipped_steps

    @skipped_steps.setter
    def skipped_steps(self, value):
        self._pending_inf_flags = []
        self._skipped_steps = int(value)

    # ------------------------------------------------------------------ #
    @property
    def params(self):
        return self._params

    def module_state_dict(self):
        return self.module.state_dict()

    def max_memory_allocated(self):
        return self.accelerator.max_memory_allocated(self.device)

    def save_checkpoint(self, *args, **kwargs):
        raise NotImplementedError("checkpointing is not ported yet "
                                  "(ROADMAP.md, queue A item 5)")

    load_checkpoint = save_checkpoint
