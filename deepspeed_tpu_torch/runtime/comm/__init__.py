"""Runtime collectives: the coalesced forms the ZeRO engine buckets
through (``coalesced_collectives.py``).  The JAX package's compressed
(1-bit) backends wait with the 1-bit optimizers (ROADMAP.md, queue A)."""

from deepspeed_tpu_torch.runtime.comm.coalesced_collectives import (  # noqa: F401
    all_gather_coalesced, all_reduce_coalesced, gathered_views,
    reduce_scatter_coalesced)
