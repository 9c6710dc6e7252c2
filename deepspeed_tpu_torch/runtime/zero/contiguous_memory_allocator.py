"""Contiguous memory allocator (port of
``deepspeed_tpu/runtime/zero/contiguous_memory_allocator.py``, reference
``runtime/zero/contiguous_memory_allocator.py``): one preallocated flat
tensor carved into tensor assignments, with release and defragmentation,
so repeated staging buffers (offload, swap) do not churn the allocator.

The arena is one torch tensor, on the card or in (page-locked) host
memory; a tensor handed out is a view of it.  ``defragment`` moves the
live tensors to the front, in address order, and re-binds their views.
The same sequence of calls gives the JAX allocator's offsets: a best-fit
block (the smallest free block that holds the request, the lowest offset
among equals), freed blocks merged with their neighbours.
"""

import torch

from deepspeed_tpu_torch.utils.logging import logger


class ContiguousMemoryAllocator:

    def __init__(self, size, dtype=torch.float32, device="cpu",
                 pin_memory=False):
        self.size = int(size)
        self.dtype = dtype
        self.device = torch.device(device)
        self.buffer = torch.zeros(
            self.size, dtype=dtype, device=self.device,
            pin_memory=bool(pin_memory) and self.device.type == "cpu")
        # offset -> length of free blocks
        self.contiguous_sizes = {0: self.size}
        # tensor id -> (offset, numel)
        self.tensor_addresses = {}
        self.tensor_map = {}
        self.total_free = self.size
        self.largest_contiguous = self.size
        self.max_allocated = 0
        self.count = 0

    # ---------------------------------------------------------------- #
    def allocate_tensor(self, numel):
        """``(id, view)`` of ``numel`` elements, defragmenting first when
        only fragmented space remains (reference ``allocate_tensor``)."""
        numel = int(numel)
        assert numel <= self.total_free, \
            f"allocate {numel} > free {self.total_free}"
        if self.largest_contiguous < numel:
            logger.info("ContiguousMemoryAllocator: defragmenting to satisfy "
                        f"a {numel}-element request")
            self.defragment()
        offset = self._find_block(numel)
        assert offset is not None
        self._carve(offset, numel)
        self.count += 1
        tid = self.count
        self.tensor_addresses[tid] = (offset, numel)
        view = self.buffer.narrow(0, offset, numel)
        self.tensor_map[tid] = view
        self.max_allocated = max(self.max_allocated,
                                 self.size - self.total_free)
        return tid, view

    def release_tensor(self, tid):
        offset, numel = self.tensor_addresses.pop(tid)
        self.tensor_map.pop(tid)
        self._free(offset, numel)

    def release_tensor_with_id(self, tid):
        self.release_tensor(tid)

    def get_tensor(self, tid):
        return self.tensor_map[tid]

    # ---------------------------------------------------------------- #
    @torch.no_grad()
    def defragment(self):
        """Move the live tensors to the front in address order and re-bind
        their views (reference ``defragment``)."""
        new_offset = 0
        for tid in sorted(self.tensor_addresses,
                          key=lambda t: self.tensor_addresses[t][0]):
            offset, numel = self.tensor_addresses[tid]
            if offset != new_offset:
                # front to back: a move never overwrites a live source
                src = self.buffer.narrow(0, offset, numel).clone()
                self.buffer.narrow(0, new_offset, numel).copy_(src)
                self.tensor_addresses[tid] = (new_offset, numel)
                self.tensor_map[tid] = self.buffer.narrow(0, new_offset,
                                                          numel)
            new_offset += numel
        self.contiguous_sizes = {new_offset: self.size - new_offset} \
            if new_offset < self.size else {}
        self._recompute()

    # ---------------------------------------------------------------- #
    def _find_block(self, numel):
        best = None
        for off, length in sorted(self.contiguous_sizes.items()):
            if length >= numel and (best is None or
                                    length < self.contiguous_sizes[best]):
                best = off
        return best

    def _carve(self, offset, numel):
        length = self.contiguous_sizes.pop(offset)
        if length > numel:
            self.contiguous_sizes[offset + numel] = length - numel
        self._recompute()

    def _free(self, offset, numel):
        self.contiguous_sizes[offset] = numel
        merged = {}
        for off in sorted(self.contiguous_sizes):
            length = self.contiguous_sizes[off]
            if merged:
                last = max(merged)
                if last + merged[last] == off:
                    merged[last] += length
                    continue
            merged[off] = length
        self.contiguous_sizes = merged
        self._recompute()

    def _recompute(self):
        self.total_free = sum(self.contiguous_sizes.values())
        self.largest_contiguous = max(self.contiguous_sizes.values()) \
            if self.contiguous_sizes else 0

    def print_allocation(self, resolution=200):
        occupied = self.size - self.total_free
        logger.info(
            f"ContiguousMemoryAllocator: {occupied}/{self.size} used, "
            f"{len(self.tensor_addresses)} tensors, largest free block "
            f"{self.largest_contiguous}")
