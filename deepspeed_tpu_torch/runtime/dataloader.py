"""Data loading (port of ``deepspeed_tpu/runtime/dataloader.py``).

``DeepSpeedDataLoader`` batches an indexable dataset (numpy arrays,
dicts of arrays, torch Datasets or any sequence) on the host at world
size 1; with an engine it places each batch on the engine's device.
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

    def __len__(self):
        return self.len

    def __iter__(self):
        for start in range(0, self.len * self.batch_size, self.batch_size):
            batch = self.collate_fn([self.dataset[i] for i in
                                     range(start, start + self.batch_size)])
            if self.engine is not None:
                batch = self.engine.put_batch(batch)
            yield batch
