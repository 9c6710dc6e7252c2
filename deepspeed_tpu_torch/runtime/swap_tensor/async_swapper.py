"""Asynchronous tensor swapping between host RAM and disk (port of
``deepspeed_tpu/runtime/swap_tensor/async_swapper.py``).

A bounded pool of reusable fp32 host buffers moved to and from swap files
by the aio thread pool (``csrc/aio/aio.cpp``), so swap I/O overlaps the
host's compute and the host RAM it takes stays ``buffer_count`` buffers,
whatever the size of the state on disk.
"""

import os

import torch

from deepspeed_tpu_torch.ops.aio import AIO_DEFAULT_BLOCK_SIZE, AsyncIOHandle


class SwapBuffer:
    """One reusable fp32 host staging buffer."""

    def __init__(self, numel, pin=False):
        self.data = torch.zeros(numel, dtype=torch.float32,
                                pin_memory=bool(pin))
        self.in_flight = False

    def view(self, numel):
        assert numel <= self.data.numel()
        return self.data[:numel]


class AsyncTensorSwapper:
    """Move fp32 tensors host ↔ disk asynchronously through a buffer pool
    (the JAX package's ``AsyncTensorSwapper``)."""

    def __init__(self, swap_dir, aio_handle=None, buffer_count=4,
                 buffer_size=None, block_size=AIO_DEFAULT_BLOCK_SIZE,
                 thread_count=4, pin=False):
        self.swap_dir = swap_dir
        os.makedirs(swap_dir, exist_ok=True)
        self.handle = aio_handle or AsyncIOHandle(block_size=block_size,
                                                  thread_count=thread_count)
        self.buffer_count = buffer_count
        self.buffer_size = buffer_size
        self.pin = pin
        self._buffers = []
        self._pending_writes = []

    def _new_buffer(self, numel):
        b = SwapBuffer(max(numel, self.buffer_size or 0), pin=self.pin)
        self._buffers.append(b)
        return b

    def _get_buffer(self, numel):
        for b in self._buffers:
            if not b.in_flight and b.data.numel() >= numel:
                return b
        if len(self._buffers) < self.buffer_count:
            return self._new_buffer(numel)
        # pool exhausted: drain the writes and look again
        self.synchronize_writes()
        for b in self._buffers:
            if not b.in_flight and b.data.numel() >= numel:
                return b
        return self._new_buffer(numel)

    def path_for(self, key):
        return os.path.join(self.swap_dir, f"{key}.swp")

    def swap_out(self, key, tensor):
        """Stage ``tensor`` into a pool buffer and start its write."""
        flat = torch.as_tensor(tensor).detach().reshape(-1)
        buf = self._get_buffer(flat.numel())
        buf.view(flat.numel()).copy_(flat)
        buf.in_flight = True
        self.handle.async_pwrite(buf.view(flat.numel()), self.path_for(key))
        self._pending_writes.append(buf)
        return self.path_for(key)

    def synchronize_writes(self):
        if self._pending_writes:
            self.handle.wait()
            for b in self._pending_writes:
                b.in_flight = False
            self._pending_writes.clear()

    def swap_in(self, key, numel, out=None):
        """Read a swapped tensor, synchronously."""
        out = out if out is not None else torch.empty(numel,
                                                      dtype=torch.float32)
        self.handle.sync_pread(out[:numel], self.path_for(key))
        return out[:numel]

    def start_swap_in(self, key, numel):
        """Start reading a swapped tensor into a pool buffer; returns the
        buffer, which ``finish_swap_ins`` makes readable."""
        buf = self._get_buffer(numel)
        buf.in_flight = True
        self.handle.async_pread(buf.view(numel), self.path_for(key))
        return buf

    def finish_swap_ins(self):
        self.handle.wait()
        for b in self._buffers:
            b.in_flight = False

    def release(self):
        self.synchronize_writes()
        self._buffers.clear()
