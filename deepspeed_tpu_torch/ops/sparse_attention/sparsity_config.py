"""Block-sparse attention sparsity layouts (a copy of
``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``, which imports
no JAX: the port keeps its own so that it never imports the JAX package).
The constructors, their errors and the ``np.random.default_rng(seed)``
draws are the same, so a config built with the same arguments and asked
for layouts in the same order gives bitwise the same layouts.

Capability parity with reference
``deepspeed/ops/sparse_attention/sparsity_config.py`` (``SparsityConfig :10``,
``DenseSparsityConfig :63``, ``FixedSparsityConfig :95``,
``VariableSparsityConfig :239``, ``BigBirdSparsityConfig :411``,
``BSLongformerSparsityConfig :546``, sliding-window ``:674``): each config
produces a layout of shape ``[num_heads, num_blocks, num_blocks]`` with 1 for
kept (block-row attends block-col) and 0 for skipped blocks.

Layouts are host-side numpy and static: ``block_sparse.layout_tables``
turns one into the per-row index tables that kernel K8 walks.  Block
default is 64 (K8's main-path block) vs the reference's 16.
"""

import numpy as np


class SparsityConfig:
    """Base: block size, per-head layouts (reference ``:10``)."""

    def __init__(self, num_heads, block=64, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len):
        if seq_len % self.block != 0:
            raise ValueError(
                f"seq_len {seq_len} must be divisible by block {self.block}")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks), np.int64)

    def check_and_propagate_first_head_layout(self, layout):
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len):
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """Everything attends everything (reference ``:63``) — for testing."""

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Local chunks + periodic global blocks (reference ``:95``; the
    GPT-3-style 'fixed' pattern)."""

    def __init__(self, num_heads, block=64, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1,
                 attention="bidirectional", horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(f"attention {attention}")
        self.attention = attention
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal global attention requires "
                             "bidirectional attention")
        self.horizontal_global_attention = horizontal_global_attention
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError("different global patterns require "
                             "different_layout_per_head")
        self.num_different_global_patterns = num_different_global_patterns

    def set_local_layout(self, h, layout):
        nb = layout.shape[1]
        for start in range(0, nb, self.num_local_blocks):
            end = min(start + self.num_local_blocks, nb)
            for r in range(start, end):
                cols = range(start, r + 1 if self.attention == "unidirectional"
                             else end)
                layout[h, r, list(cols)] = 1
        return layout

    def set_global_layout(self, h, layout):
        nb = layout.shape[1]
        # the last num_global_blocks of each local window act as global
        # representatives; pattern index rotates per head group
        pattern = (h % self.num_different_global_patterns
                   if self.num_different_global_patterns > 1 else 0)
        first = max(0, self.num_local_blocks - (1 + pattern)
                    * self.num_global_blocks)
        for start in range(first, nb, self.num_local_blocks):
            gcols = [c for c in range(start, min(start + self.num_global_blocks, nb))]
            for r in range(nb):
                for c in gcols:
                    if self.attention == "bidirectional" or c <= r:
                        layout[h, r, c] = 1
            if self.horizontal_global_attention:
                for g in gcols:
                    layout[h, g, :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_local_layout(h, layout)
            self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Random + variable-width local windows + global (reference ``:239``)."""

    def __init__(self, num_heads, block=64, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks=None,
                 global_block_indices=None, global_block_end_indices=None,
                 attention="bidirectional", horizontal_global_attention=False,
                 seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(f"attention {attention}")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.rng = np.random.default_rng(seed)

    def set_random_layout(self, h, layout):
        nb = layout.shape[1]
        for r in range(nb):
            if self.num_random_blocks > 0:
                hi = r + 1 if self.attention == "unidirectional" else nb
                k = min(self.num_random_blocks, hi)
                cols = self.rng.choice(hi, size=k, replace=False)
                layout[h, r, cols] = 1
        return layout

    def set_local_layout(self, h, layout):
        nb = layout.shape[1]
        start = 0
        win_i = 0
        while start < nb:
            w = self.local_window_blocks[min(win_i,
                                             len(self.local_window_blocks) - 1)]
            end = min(start + w, nb)
            for r in range(start, end):
                cols = range(start, r + 1 if self.attention == "unidirectional"
                             else end)
                layout[h, r, list(cols)] = 1
            start = end
            win_i += 1
        return layout

    def set_global_layout(self, h, layout):
        nb = layout.shape[1]
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for lo, hi in spans:
            for c in range(lo, min(hi, nb)):
                for r in range(nb):
                    if self.attention == "bidirectional" or c <= r:
                        layout[h, r, c] = 1
                if self.horizontal_global_attention:
                    layout[h, c, :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_random_layout(h, layout)
            self.set_local_layout(h, layout)
            self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """random + sliding window + global (reference ``:411``, BigBird paper)."""

    def __init__(self, num_heads, block=64, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3,
                 num_global_blocks=1, attention="bidirectional", seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(f"attention {attention}")
        self.attention = attention
        self.rng = np.random.default_rng(seed)

    def set_random_layout(self, h, layout):
        nb = layout.shape[1]
        if nb < self.num_random_blocks:
            raise ValueError(f"num_random_blocks {self.num_random_blocks} "
                             f"exceeds {nb} blocks")
        for r in range(nb):
            hi = r + 1 if self.attention == "unidirectional" else nb
            k = min(self.num_random_blocks, hi)
            cols = self.rng.choice(hi, size=k, replace=False)
            layout[h, r, cols] = 1
        return layout

    def set_sliding_window_layout(self, h, layout):
        nb = layout.shape[1]
        if nb < self.num_sliding_window_blocks:
            raise ValueError("sliding window wider than sequence")
        w = self.num_sliding_window_blocks // 2
        for r in range(nb):
            lo = max(0, r - w)
            hi = min(nb, r + w + 1)
            layout[h, r, lo:hi] = 1
        return layout

    def set_global_layout_itc(self, h, layout):
        nb = layout.shape[1]
        if nb < self.num_global_blocks:
            raise ValueError("more global blocks than blocks")
        g = self.num_global_blocks
        layout[h, 0:g, :] = 1
        layout[h, :, 0:g] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_random_layout(h, layout)
            self.set_sliding_window_layout(h, layout)
            self.set_global_layout_itc(h, layout)
        layout = self.check_and_propagate_first_head_layout(layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class BSLongformerSparsityConfig(SparsityConfig):
    """sliding window + selected global rows/cols (reference ``:546``,
    block-sparse Longformer)."""

    def __init__(self, num_heads, block=64, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices=None,
                 global_block_end_indices=None, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def set_sliding_window_layout(self, h, layout):
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for r in range(nb):
            layout[h, r, max(0, r - w):min(nb, r + w + 1)] = 1
        return layout

    def set_global_layout(self, h, layout):
        nb = layout.shape[1]
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for lo, hi in spans:
            layout[h, :, lo:min(hi, nb)] = 1
            layout[h, lo:min(hi, nb), :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_sliding_window_layout(h, layout)
            self.set_global_layout(h, layout)
        layout = self.check_and_propagate_first_head_layout(layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Pure sliding window (reference ``:674``)."""

    def __init__(self, num_heads, block=64, num_sliding_window_blocks=3,
                 attention="unidirectional"):
        super().__init__(num_heads, block, different_layout_per_head=False)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for r in range(nb):
                lo = max(0, r - (self.num_sliding_window_blocks - 1
                                 if self.attention == "unidirectional" else w))
                hi = r + 1 if self.attention == "unidirectional" \
                    else min(nb, r + w + 1)
                layout[h, r, lo:hi] = 1
        return self.check_and_propagate_first_head_layout(layout)
