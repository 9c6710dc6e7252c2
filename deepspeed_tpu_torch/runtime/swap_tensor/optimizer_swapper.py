"""Optimizer state on disk (port of
``deepspeed_tpu/runtime/swap_tensor/optimizer_swapper.py``).

Each parameter's fp32 master and Adam moments live in three swap files;
around each host optimizer step a parameter's state is read in, updated in
place by the C++ Adam and written back, with the next parameter's read
started behind the current one's compute (``pipeline_read``) and the
writes drained lazily (``pipeline_write``).
"""

import torch

from deepspeed_tpu_torch.runtime.swap_tensor.async_swapper import \
    AsyncTensorSwapper


class SwappedStateGroup:
    """The swap files of one parameter: master, exp_avg, exp_avg_sq."""

    def __init__(self, name, numel):
        self.name = name
        self.numel = numel
        self.keys = [f"{name}.master", f"{name}.exp_avg",
                     f"{name}.exp_avg_sq"]


class OptimizerSwapper:
    """Disk residency of per-parameter optimizer state (the JAX package's
    ``OptimizerSwapper``)."""

    def __init__(self, swap_dir, buffer_count=4, pipeline_read=True,
                 pipeline_write=True, thread_count=4, pin=False):
        # reads and writes keep pools of their own, so a prefetch never
        # waits for a write's buffer
        self._read = AsyncTensorSwapper(swap_dir, buffer_count=buffer_count,
                                        thread_count=thread_count, pin=pin)
        self._write = AsyncTensorSwapper(swap_dir, buffer_count=buffer_count,
                                         thread_count=thread_count, pin=pin)
        self.pipeline_read = pipeline_read
        self.pipeline_write = pipeline_write
        self.groups = {}

    def register(self, name, numel, master, exp_avg, exp_avg_sq):
        """Write a parameter's state for the first time."""
        g = SwappedStateGroup(name, numel)
        self.groups[name] = g
        for key, t in zip(g.keys, (master, exp_avg, exp_avg_sq)):
            self._write.swap_out(key, t)
        self._write.synchronize_writes()
        return g

    def swap_in(self, name, out_master, out_avg, out_avg_sq):
        g = self.groups[name]
        for key, out in zip(g.keys, (out_master, out_avg, out_avg_sq)):
            self._read.swap_in(key, g.numel, out)

    def start_swap_in(self, name, bufs):
        """Start reading a parameter's three state tensors into ``bufs``,
        which must not be touched before ``finish_swap_ins``."""
        g = self.groups[name]
        for key, t in zip(g.keys, bufs):
            self._read.handle.async_pread(t[:g.numel],
                                          self._read.path_for(key))

    def finish_swap_ins(self):
        self._read.handle.wait()

    def swap_out(self, name, master, exp_avg, exp_avg_sq):
        g = self.groups[name]
        for key, t in zip(g.keys, (master, exp_avg, exp_avg_sq)):
            self._write.swap_out(key, t[:g.numel])
        if not self.pipeline_write:
            self._write.synchronize_writes()

    def update_master(self, name, master):
        """Overwrite only a parameter's master file; its moments on disk
        stay as they are."""
        g = self.groups[name]
        self._write.swap_out(g.keys[0], master[:g.numel])
        if not self.pipeline_write:
            self._write.synchronize_writes()

    def drain(self):
        self._write.synchronize_writes()

    def state_files(self):
        return {n: [self._read.path_for(k) for k in g.keys]
                for n, g in self.groups.items()}


class PartitionedParameterSwapper:
    """The disk tier for parameter tensors (the JAX package's
    ``PartitionedParameterSwapper``): write tensors of any dtype to files
    and read them back on demand.  No engine path uses it, in either
    package: ``offload_param`` raises in the config."""

    def __init__(self, swap_dir, buffer_count=5, thread_count=4):
        self._swap = AsyncTensorSwapper(swap_dir, buffer_count=buffer_count,
                                        thread_count=thread_count)
        self._meta = {}

    def swap_out_param(self, name, tensor):
        t = torch.as_tensor(tensor).detach().contiguous()
        self._meta[name] = (tuple(t.shape), t.dtype)
        # the raw bytes, written from the tensor itself (kept alive until
        # the write is drained)
        self._swap.handle.async_pwrite(t.reshape(-1).view(torch.uint8),
                                       self._swap.path_for(name))
        self._swap._pending_writes.append(_Hold(t))

    def synchronize(self):
        self._swap.synchronize_writes()

    def swap_in_param(self, name):
        shape, dtype = self._meta[name]
        n = 1
        for s in shape:
            n *= s
        out = torch.empty(n * torch.empty((), dtype=dtype).element_size(),
                          dtype=torch.uint8)
        self._swap.handle.sync_pread(out, self._swap.path_for(name))
        return out.view(dtype).reshape(shape)

    def available_params(self):
        return set(self._meta)


class _Hold:
    """Keeps a tensor alive until its write is drained (a ``SwapBuffer``'s
    flag)."""

    def __init__(self, t):
        self.t = t
        self.in_flight = True
