"""ZeRO-Offload: the optimizer in host RAM or on disk, stepped by the C++
Adam (port of ``deepspeed_tpu/runtime/zero/offload.py``).

* the card keeps only the compute-dtype parameters (bf16 for a bf16 run);
* the fp32 masters and Adam moments live in host RAM (``device: cpu``) or
  in swap files behind a bounded pool of host buffers (``device: nvme``);
* at each accumulation boundary the engine brings the gradients to the
  host, unscales and clips them there, and this class steps them one
  parameter at a time with ``csrc/adam/cpu_adam.cpp`` (bf16 copy-out in
  the same pass), then the engine uploads the new parameters.  On disk the
  next parameter's state is read behind the current one's compute
  (``pipeline_read``).

The parameters are taken in the engine's order (``engine.params``); the
state is flat fp32 per parameter.
"""

import atexit
import os
import shutil

import numpy as np
import torch

from deepspeed_tpu_torch.ops.adam import cpu_adam as cpu_adam_mod
from deepspeed_tpu_torch.ops.adam.cpu_adam import (DeepSpeedCPUAdam,
                                                   host_buffer, host_copy)
from deepspeed_tpu_torch.utils.logging import log_dist


class HostOffloadedAdam:
    """Host Adam over the engine's parameters, in RAM or on disk."""

    _instances = 0     # engines of this process: their swap dirs differ

    def __init__(self, params, offload_config, lr=1e-3, betas=(0.9, 0.999),
                 eps=1e-8, weight_decay=0.0, adamw_mode=True,
                 bias_correction=True, pin=None):
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.bias_correction = bias_correction
        self.step_count = 0

        self.nvme = offload_config.device == "nvme"
        # page-locked host state (``pin_memory``; ``pin`` overrides it: a
        # CPU engine has no card to copy to and PyTorch no pinned memory)
        self.pin = bool(getattr(offload_config, "pin_memory", False)
                        if pin is None else pin)
        self.pipeline_read = bool(getattr(offload_config, "pipeline_read",
                                          False))
        self.shapes = [tuple(p.shape) for p in params]
        self.numels = [int(np.prod(s)) for s in self.shapes]
        self.names = [f"leaf{i}" for i in range(len(self.shapes))]
        self.cpu_opt = None          # the RAM tier, built by init_from_params
        self.swapper = None
        if self.nvme:
            from deepspeed_tpu_torch.runtime.swap_tensor.optimizer_swapper \
                import OptimizerSwapper
            base = offload_config.nvme_path or os.path.join(
                os.environ.get("TMPDIR", "/tmp"), "dstpu_nvme_swap")
            # one directory per process and engine: jobs, ranks and
            # engines sharing an nvme_path do not clobber each other's
            # files; they are run-time state, removed at exit
            HostOffloadedAdam._instances += 1
            self._swap_dir = os.path.join(
                base, f"rank0_pid{os.getpid()}"
                      f"_e{HostOffloadedAdam._instances}")
            atexit.register(shutil.rmtree, self._swap_dir,
                            ignore_errors=True)
            self.swapper = OptimizerSwapper(
                self._swap_dir,
                buffer_count=getattr(offload_config, "buffer_count", 4),
                pipeline_read=self.pipeline_read,
                pipeline_write=bool(getattr(offload_config, "pipeline_write",
                                            False)),
                pin=self.pin)
            # two staging sets of 3 state tensors, ping-pong: the next
            # parameter's state streams in behind this one's compute
            maxn = max(self.numels) if self.numels else 0
            self._stage = [[host_buffer(maxn, pin=self.pin)
                            for _ in range(3)] for _ in range(2)]

    # -------------------------------------------------------------- #
    def init_from_params(self, params):
        """Seed the fp32 masters from ``params`` (device tensors, brought
        down once) with zero moments; on disk one parameter at a time, so
        the host holds one parameter's state at a time."""
        if self.nvme:
            for name, n, p in zip(self.names, self.numels, params):
                m = host_copy(p)
                zeros = torch.zeros(n, dtype=torch.float32)
                self.swapper.register(name, n, m, zeros, zeros)
                del m
            self.swapper.drain()
            log_dist(f"offloaded optimizer state for {len(self.names)} "
                     f"parameters to disk", ranks=[0])
        else:
            self.cpu_opt = DeepSpeedCPUAdam(
                [host_copy(p) for p in params], lr=self.lr,
                betas=(self.beta1, self.beta2), eps=self.eps,
                weight_decay=self.weight_decay, adamw_mode=self.adamw_mode,
                bias_correction=self.bias_correction, pin_memory=self.pin)

    def reseed_masters(self, params):
        """Overwrite only the fp32 master values from ``params``; the
        moments and the step count stay (a full ``init_from_params`` would
        zero the moments and restart the bias correction)."""
        if self.nvme:
            for name, p in zip(self.names, params):
                self.swapper.update_master(name, host_copy(p))
            self.swapper.drain()
        else:
            for i, p in enumerate(params):
                self.cpu_opt.params[i] = host_copy(p, self.pin)

    # -------------------------------------------------------------- #
    def step(self, host_grads, lr=None, fp32_out=False, outs=None):
        """One Adam step over every parameter.  ``host_grads``: contiguous
        fp32 CPU tensors, one a parameter.  Returns flat tensors for the
        upload: bf16 bits (``uint16``) by default, the updated fp32 masters
        with ``fp32_out`` (an fp32 run must not round its parameters through
        bf16).  ``outs`` are ``uint16`` tensors to write the bf16 bits into
        (the engine's pinned upload buffers); new ones otherwise."""
        self.step_count += 1
        lr = float(self.lr if lr is None else lr)
        host_grads = [g.reshape(-1) for g in host_grads]
        if not fp32_out and outs is None:
            outs = [torch.empty(n, dtype=torch.uint16) for n in self.numels]
        if not self.nvme:
            self.cpu_opt.step(host_grads, bf16_outs=None if fp32_out
                              else outs, lr=lr)
            self.step_count = self.cpu_opt.step_count
            return self.cpu_opt.params if fp32_out else outs

        # on disk: ping-pong staging; with pipeline_read the next
        # parameter's state streams in behind this one's C++ Adam, and the
        # writes drain lazily unless pipeline_write is off
        ups = []
        n_leaves = len(host_grads)
        piped = self.pipeline_read and n_leaves > 1
        if piped:
            self.swapper.start_swap_in(self.names[0], self._stage[0])
            self.swapper.finish_swap_ins()
        for i, g in enumerate(host_grads):
            n = self.numels[i]
            cur = self._stage[i % 2]
            if piped:
                if i + 1 < n_leaves:
                    self.swapper.start_swap_in(self.names[i + 1],
                                               self._stage[(i + 1) % 2])
            else:
                self.swapper.swap_in(self.names[i], *cur)
            cpu_adam_mod.adam_step(
                cur[0][:n], cur[1][:n], cur[2][:n], g, lr, self.beta1,
                self.beta2, self.eps, self.weight_decay, self.adamw_mode,
                self.bias_correction, self.step_count,
                bf16_out=None if fp32_out else outs[i])
            self.swapper.swap_out(self.names[i], *cur)
            if piped and i + 1 < n_leaves:
                self.swapper.finish_swap_ins()
            # the staging set is reused two parameters on: fp32 out copies
            ups.append(cur[0][:n].clone() if fp32_out else outs[i])
        self.swapper.drain()
        return ups

    @property
    def masters(self):
        """The fp32 masters (RAM tier only; on disk use
        :meth:`master_params`)."""
        if self.nvme:
            raise AttributeError("the masters are on disk; use "
                                 "master_params()")
        return self.cpu_opt.params

    # -------------------------------------------------------------- #
    def _iter_states(self):
        """``(index, master, exp_avg, exp_avg_sq)`` a parameter at a time;
        from disk through fresh tensors, so the host holds one parameter's
        state at a time."""
        if not self.nvme:
            for i in range(len(self.names)):
                yield (i, self.cpu_opt.params[i], self.cpu_opt.exp_avg[i],
                       self.cpu_opt.exp_avg_sq[i])
            return
        for i, (name, n) in enumerate(zip(self.names, self.numels)):
            m, a, v = (torch.empty(n, dtype=torch.float32) for _ in range(3))
            self.swapper.swap_in(name, m, a, v)
            yield i, m, a, v

    def save(self, ckpt_dir):
        """The state as one ``.npy`` file a tensor (the JAX layout:
        ``step.npy``, ``leaf<i>.{master,exp_avg,exp_avg_sq}.npy``, here in
        ``engine.params`` order)."""
        os.makedirs(ckpt_dir, exist_ok=True)
        np.save(os.path.join(ckpt_dir, "step.npy"), np.int64(self.step_count))
        for i, m, a, v in self._iter_states():
            for field, t in (("master", m), ("exp_avg", a),
                             ("exp_avg_sq", v)):
                np.save(os.path.join(ckpt_dir, f"leaf{i}.{field}.npy"),
                        t.numpy())

    def load(self, ckpt_dir, cut=None):
        """Read :meth:`save`'s files; ``cut(i, flat)`` takes this rank's
        piece of leaf ``i`` where the files hold a group's global state."""
        self.step_count = int(np.load(os.path.join(ckpt_dir, "step.npy")))

        def read(i, field):
            t = torch.from_numpy(np.ascontiguousarray(np.load(
                os.path.join(ckpt_dir, f"leaf{i}.{field}.npy")), np.float32))
            return t if cut is None else cut(i, t)

        for i, (name, n) in enumerate(zip(self.names, self.numels)):
            m, a, v = (read(i, f) for f in ("master", "exp_avg",
                                            "exp_avg_sq"))
            if self.nvme:
                if name in self.swapper.groups:
                    self.swapper.swap_out(name, m, a, v)
                else:
                    self.swapper.register(name, n, m, a, v)
            else:
                self.cpu_opt.params[i] = host_copy(m, self.pin)
                self.cpu_opt.exp_avg[i] = host_copy(a, self.pin)
                self.cpu_opt.exp_avg_sq[i] = host_copy(v, self.pin)
        if self.nvme:
            self.swapper.drain()
        else:
            self.cpu_opt.step_count = self.step_count

    def state_dict(self):
        ms, avs, vs = [], [], []
        for _, m, a, v in self._iter_states():
            ms.append(m)
            avs.append(a)
            vs.append(v)
        return {"step": self.step_count, "masters": ms, "exp_avg": avs,
                "exp_avg_sq": vs}

    def load_state_dict(self, sd, cut=None):
        """:meth:`state_dict`'s form back; ``cut`` as in :meth:`load`."""
        self.step_count = int(sd["step"])

        pin = self.pin and not self.nvme
        ms, avs, vs = ([host_copy(t if cut is None else cut(i, t), pin)
                        for i, t in enumerate(sd[k])]
                       for k in ("masters", "exp_avg", "exp_avg_sq"))
        if self.nvme:
            for name, n, m, a, v in zip(self.names, self.numels, ms, avs,
                                        vs):
                if name in self.swapper.groups:
                    self.swapper.swap_out(name, m, a, v)
                else:
                    self.swapper.register(name, n, m, a, v)
            self.swapper.drain()
        else:
            self.cpu_opt.params, self.cpu_opt.exp_avg = ms, avs
            self.cpu_opt.exp_avg_sq = vs
            self.cpu_opt.step_count = self.step_count

    def master_params(self):
        """The fp32 masters, shaped as the parameters (copies)."""
        return [m.clone().reshape(s)
                for (_, m, _, _), s in zip(self._iter_states(), self.shapes)]


def save_host_state(ckpt_dir, sd):
    """:meth:`HostOffloadedAdam.save`'s files from a ``state_dict``-form
    dict (a data-parallel group's state gathered to global tensors)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    np.save(os.path.join(ckpt_dir, "step.npy"), np.int64(sd["step"]))
    for i, tensors in enumerate(zip(sd["masters"], sd["exp_avg"],
                                    sd["exp_avg_sq"])):
        for field, t in zip(("master", "exp_avg", "exp_avg_sq"), tensors):
            np.save(os.path.join(ckpt_dir, f"leaf{i}.{field}.npy"),
                    t.numpy())
