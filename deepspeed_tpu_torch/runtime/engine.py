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

**Checkpoints.**  ``save_checkpoint`` / ``load_checkpoint`` write and
restore the fp32 master parameters, the optimizer state, the loss scaler,
the LR schedule and the step counters in the port's tag format
(``runtime/checkpoint_engine``), under the JAX engine's tag layout,
``latest`` pointer and, with ``fault.enabled``, its crash-atomic protocol
(``MANIFEST.json``, verified walk-back, retries, retention).  A load copies
into the live tensors in place.  ``save_16bit_model`` exports the weights
under the JAX export's flax-path keys.

Not in this slice (ROADMAP.md, queue A): the compile cache, the profiler,
the monitor, offload, multi-GPU.
"""

import dataclasses
import os
import shutil
import time
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.accelerator import get_accelerator, resolve_device
from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
    NebulaCheckpointEngine, TorchCheckpointEngine, copy_groups)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.fault import inject
from deepspeed_tpu_torch.runtime.fault.atomic import (atomic_publish_dir,
                                                      atomic_write_text)
from deepspeed_tpu_torch.runtime.fault.manifest import (
    CheckpointCorrupt, build_manifest, gc_checkpoints, is_reserved_tag,
    list_tags, newest_valid_tag, read_latest, read_manifest,
    verify_manifest, write_manifest)
from deepspeed_tpu_torch.runtime.fault.retry import (retry_call,
                                                     retry_policy_from_config)
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (StaticLossScaler,
                                                          create_loss_scaler)
from deepspeed_tpu_torch.runtime.lr_schedules import build_lr_scheduler
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer
from deepspeed_tpu_torch.utils.logging import log_dist, logger

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
        # the nebula block selects the asynchronous writer, as in JAX
        self.checkpoint_engine = NebulaCheckpointEngine(
            self._config.nebula_config) \
            if self._config.nebula_config.enabled else TorchCheckpointEngine()
        # the last save's and load's bytes, files and seconds by phase
        self.checkpoint_stats = {}

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

    # ------------------------------------------------------------------ #
    # Checkpointing (the JAX engine's save_checkpoint / load_checkpoint)
    # ------------------------------------------------------------------ #
    def _fault_config(self):
        fcfg = self._config.fault
        return fcfg if fcfg.enabled else None

    def _checkpoint_arrays(self):
        """The tag's array groups, as the live tensors: ``module`` (the
        fp32 master ``state_dict``, detached views of the parameters),
        ``optimizer`` (its state NamedTuple of per-parameter lists, in
        ``engine.params`` order) and ``loss_scaler``."""
        return {"module": self.module.state_dict(),
                "optimizer": self._opt_state,
                "loss_scaler": self._scaler_state}

    def _checkpoint_meta(self, client_state):
        """The JAX engine's ``meta.pkl`` keys.  There is no
        ``rng_key_data``: the port's engine draws no random numbers after
        its init (dropout is not ported), so a resumed run needs no RNG
        state to be bitwise the uninterrupted one; loading a tag that has
        the key ignores it."""
        cfg = getattr(self.module, "config", None)
        return {
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "micro_steps": self.micro_steps,
            "skipped_steps": self.skipped_steps,
            "lr_scheduler": self.lr_scheduler.state_dict()
            if self.lr_scheduler else None,
            "ds_config": self._config._param_dict,
            "client_state": client_state or {},
            # the port's own key: the model's config, for offline tools
            # that rename the weights to flax paths (zero_to_fp32)
            "model_config": dataclasses.asdict(cfg)
            if dataclasses.is_dataclass(cfg) else None,
        }

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True, exclude_frozen_parameters=False):
        """Write the engine's state under ``<save_dir>/<tag>/state`` (tag
        ``global_step<N>`` by default) and point ``latest`` at it; with
        ``fault.enabled`` through the crash-atomic protocol.
        ``exclude_frozen_parameters`` is accepted for the JAX signature and,
        as there, changes nothing: every module tensor is saved."""
        save_dir = str(save_dir)
        if tag is None:
            tag = f"global_step{self.global_steps}"
        tag = str(tag)
        arrays = self._checkpoint_arrays()
        fcfg = self._fault_config()
        if fcfg is not None:
            return self._save_checkpoint_atomic(save_dir, tag, arrays,
                                                client_state, save_latest,
                                                fcfg)
        t0 = time.monotonic()
        ckpt_dir = os.path.join(save_dir, tag)
        os.makedirs(ckpt_dir, exist_ok=True)
        self.checkpoint_engine.create(tag)
        self.checkpoint_engine.save(arrays, self._checkpoint_meta(
            client_state), os.path.join(ckpt_dir, "state"))
        # commit (the async engine: the arrays are on disk) BEFORE moving
        # 'latest' — a crash mid-save leaves it on the previous checkpoint
        self.checkpoint_engine.commit(tag)
        if save_latest:
            atomic_write_text(os.path.join(save_dir, "latest"), tag)
        self.checkpoint_stats = {
            "save": {**self.checkpoint_engine.stats.get("save", {}),
                     "total_s": time.monotonic() - t0}}
        log_dist(f"saved checkpoint {tag} to {save_dir}", ranks=[0])
        return True

    def _save_checkpoint_atomic(self, save_dir, tag, arrays, client_state,
                                save_latest, fcfg):
        """Crash-atomic checkpoint protocol (``fault.enabled``): stage into
        ``<tag>.tmp/``, emit ``MANIFEST.json`` (sizes, checksums,
        fingerprint, step metadata), fsync, rename to ``<tag>/``, swap
        ``latest`` atomically, then GC per the retention policy.  A kill
        at any instruction leaves the previous consistent state or the new
        one, never a loadable partial.  Transient I/O during the write
        stage retries with backoff."""
        if is_reserved_tag(tag):
            # '<x>.tmp' / '<x>.old.<pid>' are the protocol's staging
            # namespace — the next GC pass would destroy such a tag
            raise ValueError(
                f"checkpoint tag {tag!r} collides with the crash-atomic "
                "staging namespace ('*.tmp' / '*.old.<pid>'); pick "
                "another tag")
        t0 = time.monotonic()
        os.makedirs(save_dir, exist_ok=True)
        final_dir = os.path.join(save_dir, tag)
        tmp_dir = final_dir + ".tmp"
        meta = self._checkpoint_meta(client_state)

        def write_stage():
            if os.path.isdir(tmp_dir):      # stale orphan / failed attempt
                shutil.rmtree(tmp_dir)
            os.makedirs(tmp_dir)
            inject.fire("ckpt.save_io", path=tmp_dir)
            self.checkpoint_engine.create(tag)
            self.checkpoint_engine.save(arrays, meta,
                                        os.path.join(tmp_dir, "state"))
            # the async engine's arrays and deferred metadata must be on
            # disk before the manifest walks the staging dir
            self.checkpoint_engine.commit(tag)

        retry_call(write_stage, label=f"checkpoint write ({tag})",
                   **retry_policy_from_config(fcfg))
        t1 = time.monotonic()
        inject.fire("ckpt.before_manifest", path=tmp_dir)
        manifest = build_manifest(
            tmp_dir, tag,
            step_meta={"global_steps": self.global_steps,
                       "global_samples": self.global_samples,
                       "micro_steps": self.micro_steps},
            checksum=fcfg.checksum, advance_latest=bool(save_latest))
        write_manifest(tmp_dir, manifest)
        t2 = time.monotonic()
        inject.fire("ckpt.corrupt_shard", path=os.path.join(tmp_dir, "state"))
        inject.fire("ckpt.before_commit_rename", path=tmp_dir)
        atomic_publish_dir(tmp_dir, final_dir)
        inject.fire("ckpt.before_latest_swap", path=save_dir)
        if save_latest:
            atomic_write_text(os.path.join(save_dir, "latest"), tag)
        # retention never deletes this tag nor 'latest''s target (they
        # differ under save_latest=False)
        protect = {tag}
        latest = read_latest(save_dir)
        if latest:
            protect.add(latest)
        gc_checkpoints(save_dir, fcfg.keep_last_n, protect=tuple(protect))
        t3 = time.monotonic()
        self.checkpoint_stats = {"save": {
            **self.checkpoint_engine.stats.get("save", {}),
            "write_stage_s": t1 - t0, "manifest_s": t2 - t1,
            "publish_s": t3 - t2, "total_s": t3 - t0}}
        log_dist(f"saved checkpoint {tag} to {save_dir} "
                 f"(manifest {len(manifest['files'])} files, "
                 f"checksum {t2 - t1:.2f}s)", ranks=[0])
        return True

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True,
                        load_module_only=False):
        """Restore a tag written by :meth:`save_checkpoint` into this
        engine, in place.  Returns ``(path, client_state)``, or
        ``(None, {})`` when there is nothing to load.  With
        ``fault.enabled`` and ``tag=None`` the newest valid resume-eligible
        tag is taken (verified against its manifest; a corrupt or partial
        tag is walked past, a transient I/O error retries the same tag);
        an explicitly requested tag that fails raises."""
        load_dir = str(load_dir)
        fcfg = self._fault_config()
        requested = tag
        knobs = (load_module_strict, load_optimizer_states,
                 load_lr_scheduler_states, load_module_only)
        if tag is None:
            tag = read_latest(load_dir)
            if tag is None and fcfg is None:
                logger.warning(f"no 'latest' file at {load_dir}; "
                               "nothing loaded")
                return None, {}
        if fcfg is None:
            return self._load_checkpoint_tag(load_dir, tag, *knobs)
        # fault-tolerant load: the manifest step order, not 'latest', is
        # authoritative for resume-eligible tags (the pointer lags one tag
        # when a crash lands between the tag rename and the pointer swap)
        if requested is None:
            tag = None
        tried = []
        t0 = time.monotonic()
        verify_s = 0.0
        pre_verified = False
        while True:
            if tag is None:
                tv = time.monotonic()
                tag = newest_valid_tag(load_dir,
                                       checksum_verify=fcfg.verify_on_load,
                                       skip=tried, for_resume=True)
                verify_s += time.monotonic() - tv
                # newest_valid_tag checksummed it already
                pre_verified = fcfg.verify_on_load
            if tag is None:
                remaining = [t for t in list_tags(load_dir)
                             if t not in tried]
                # tags that should have been candidates but were rejected,
                # apart from side checkpoints (advance_latest=false)
                eligible = [t for t in remaining
                            if (read_manifest(os.path.join(load_dir, t))
                                or {}).get("advance_latest") is not False]
                if tried or eligible:
                    raise RuntimeError(
                        f"no valid checkpoint in {load_dir}: every "
                        "resume-eligible tag failed verification or load "
                        f"(tried={tried or eligible})")
                if remaining:
                    logger.warning(
                        f"{load_dir} holds only side checkpoints "
                        f"(save_latest=False: {remaining}); nothing "
                        "loaded — starting fresh")
                else:
                    logger.warning(f"no checkpoint found at {load_dir}; "
                                   "nothing loaded")
                return None, {}
            ckpt_dir = os.path.join(load_dir, str(tag))
            if fcfg.verify_on_load and not pre_verified \
                    and read_manifest(ckpt_dir) is not None:
                tv = time.monotonic()
                problems = verify_manifest(ckpt_dir, deep=True)
                verify_s += time.monotonic() - tv
                if problems:
                    if requested is not None:
                        # an explicitly requested tag fails loudly: older
                        # weights in its place would poison evals/exports
                        raise CheckpointCorrupt(
                            f"requested checkpoint {tag!r} in {load_dir} "
                            f"failed verification: {problems[:5]}")
                    logger.warning(
                        f"[fault] checkpoint {tag} failed verification "
                        f"({problems[:3]}) — walking back to the previous "
                        "valid tag")
                    tried.append(str(tag))
                    tag = None
                    continue
            try:
                # a transient I/O error retries the SAME tag first —
                # walking back on a flake would discard committed steps
                result = retry_call(self._load_checkpoint_tag, load_dir,
                                    tag, *knobs,
                                    label=f"checkpoint load ({tag})",
                                    **retry_policy_from_config(fcfg))
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                if requested is not None:
                    raise
                logger.warning(f"[fault] tag {tag} failed to load "
                               f"({type(e).__name__}: {e}); walking back")
                tried.append(str(tag))
                tag = None
                continue
            latest = read_latest(load_dir)
            if requested is None and latest and latest != str(tag):
                logger.warning(
                    f"[fault] resuming from {tag} although 'latest' "
                    f"points at {latest} (newest valid resume-eligible "
                    "tag wins; for a manual rollback load an explicit tag "
                    "or remove the newer tags)")
            self.checkpoint_stats.setdefault("load", {}).update(
                verify_s=verify_s, total_s=time.monotonic() - t0)
            return result

    def _restore_targets(self, load_optimizer_states, load_module_only):
        """The live tensors a load writes into: the module always, the
        optimizer state unless told not to, the loss scaler unless only
        the module is loaded."""
        live = self._checkpoint_arrays()
        targets = {"module": live["module"]}
        if not load_module_only:
            if load_optimizer_states and live["optimizer"] is not None:
                targets["optimizer"] = live["optimizer"]
            targets["loss_scaler"] = live["loss_scaler"]
        return targets

    def _restore_meta(self, meta, load_lr_scheduler_states,
                      load_module_only):
        # the loaded state is a step boundary: no half-done window
        self.zero_grad()
        self._pending = None
        if load_module_only:
            return
        self.global_steps = meta.get("global_steps", 0)
        self.global_samples = meta.get("global_samples", 0)
        self.micro_steps = meta.get("micro_steps", 0)
        self.skipped_steps = meta.get("skipped_steps", 0)
        if load_lr_scheduler_states and self.lr_scheduler \
                and meta.get("lr_scheduler"):
            self.lr_scheduler.load_state_dict(meta["lr_scheduler"])

    def _load_checkpoint_tag(self, load_dir, tag, load_module_strict=True,
                             load_optimizer_states=True,
                             load_lr_scheduler_states=True,
                             load_module_only=False):
        """Copy one tag into the live tensors.  At world size 1 the JAX
        engine's fresh-engine and metadata restore-target paths (which
        reshard onto another mesh) reduce to this in-place ``copy_``: the
        parameters and optimizer lists keep their identity."""
        t0 = time.monotonic()
        path = os.path.join(load_dir, str(tag), "state")
        arrays, meta = self.checkpoint_engine.load(
            path, targets=self._restore_targets(load_optimizer_states,
                                                load_module_only),
            strict=load_module_strict)
        if arrays is None:
            # permanent (not an OSError, which the retry policy would
            # treat as transient); fault-enabled loads walk back past it
            raise CheckpointCorrupt(
                f"checkpoint {tag!r} at {path} has no loadable 'arrays' "
                "payload (partial or corrupt save?) — cannot restore "
                "module weights")
        self._restore_meta(meta, load_lr_scheduler_states, load_module_only)
        self.checkpoint_stats = {"load": {
            **self.checkpoint_engine.stats.get("load", {}),
            "tag_s": time.monotonic() - t0}}
        log_dist(f"loaded checkpoint {tag} from {load_dir}", ranks=[0])
        return path, meta.get("client_state", {})

    def load_state(self, arrays, meta=None, load_module_strict=True,
                   load_optimizer_states=True, load_lr_scheduler_states=True,
                   load_module_only=False):
        """Copy array groups held in memory (``module`` / ``optimizer`` /
        ``loss_scaler``, e.g. from ``models.transformer.
        engine_state_from_flax``) and a tag's ``meta`` into this engine in
        place, with :meth:`load_checkpoint`'s knobs.  Returns the
        ``client_state``."""
        meta = meta or {}
        copy_groups(self._restore_targets(load_optimizer_states,
                                          load_module_only),
                    {k: v for k, v in arrays.items() if v is not None},
                    strict=load_module_strict)
        self._restore_meta(meta, load_lr_scheduler_states, load_module_only)
        return meta.get("client_state", {})

    @torch.no_grad()
    def save_16bit_model(self, save_dir, save_filename="pytorch_model.bin",
                         hf_policy=None):
        """The weights in 16 bits for serving, under the JAX export's
        flax-path keys and layouts (``params_to_flax``; the compute dtype,
        bf16 for an fp32 engine): a ``.safetensors`` file for that suffix,
        a ``torch.save`` state dict otherwise.  Both load through either
        package's ``InferenceEngine.load_checkpoint``."""
        if hf_policy is not None:
            raise NotImplementedError(
                "save_16bit_model(hf_policy=...) renames to HF keys through "
                "module_inject, which is not ported to deepspeed_tpu_torch "
                "yet (see ROADMAP.md)")
        from deepspeed_tpu_torch.checkpoint.safetensors_io import save_file
        from deepspeed_tpu_torch.models.transformer import params_to_flax
        save_dir = str(save_dir)
        os.makedirs(save_dir, exist_ok=True)
        dtype = self.compute_dtype if self.compute_dtype != torch.float32 \
            else torch.bfloat16
        flat = params_to_flax(self.module.state_dict(), self.module.config,
                              dtype=dtype)
        path = os.path.join(save_dir, save_filename)
        if save_filename.endswith(".safetensors"):
            save_file(flat, path)
        else:
            torch.save(flat, path)
        log_dist(f"saved 16-bit model ({len(flat)} tensors, {dtype}) to "
                 f"{path}", ranks=[0])
        return True
