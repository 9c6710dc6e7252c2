"""Data loading (port of ``deepspeed_tpu/runtime/dataloader.py``).

``DeepSpeedDataLoader`` batches an indexable dataset (numpy arrays,
dicts of arrays, torch Datasets or any sequence) on the host; with an
engine it places each batch on the engine's device.  Batches are
*global*, as in the JAX package: ``batch_size`` samples a batch over the
whole data-parallel group.  With an engine of ``dp`` ranks each rank
collates only its rows of each global batch — rank r's ``[r * n, (r + 1)
* n)``, ``n = batch_size / dp``, the rows JAX's data sharding gives dp
index r — and the engine takes them as they are (``put_batch``'s
``rank_rows``).
"""

import numpy as np


def default_collate(samples):
    """Stack a list of samples into a batch."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(s[k]) for s in samples])
                for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(np.stack([np.asarray(s[i]) for s in samples])
                           for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


class DeepSpeedDataLoader:
    """Micro batches of ``batch_size`` samples in dataset order; a last
    partial batch is dropped."""

    def __init__(self, dataset, batch_size, collate_fn=None, engine=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or default_collate
        self.engine = engine
        self.len = len(dataset) // batch_size
        dp = getattr(engine, "dp_world", 1) if engine is not None else 1
        if batch_size % dp:
            raise ValueError(f"a global batch of {batch_size} samples does "
                             f"not split over {dp} data-parallel ranks")
        self.rank_batch = batch_size // dp
        self.rank_offset = (getattr(engine, "dp_rank", 0) if dp > 1 else 0) \
            * self.rank_batch

    def __len__(self):
        return self.len

    def __iter__(self):
        for start in range(0, self.len * self.batch_size, self.batch_size):
            lo = start + self.rank_offset
            batch = self.collate_fn([self.dataset[i] for i in
                                     range(lo, lo + self.rank_batch)])
            if self.engine is not None:
                batch = self.engine.put_batch(batch, rank_rows=True)
            yield batch
