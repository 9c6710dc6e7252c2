"""Accelerator abstraction (port of ``deepspeed_tpu/accelerator/
abstract_accelerator.py``).

Only the surface the inference slice uses is ported: identity (name,
count, availability), synchronisation, the RNG seed and the device-memory
snapshot.  Every method takes its device explicitly: the port never
consults a process-wide "current" accelerator.
"""

import abc


class Accelerator(abc.ABC):
    """One device family (``cuda`` or ``cpu``)."""

    _name = None

    def name(self):
        return self._name

    @abc.abstractmethod
    def is_available(self):
        ...

    @abc.abstractmethod
    def device_count(self):
        ...

    @abc.abstractmethod
    def device_name(self, device):
        """Human-readable name of ``device`` (a ``torch.device``)."""
        ...

    @abc.abstractmethod
    def synchronize(self, device):
        """Block until all work queued on ``device`` has finished."""
        ...

    @abc.abstractmethod
    def manual_seed(self, seed, device):
        """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
        ...

    @abc.abstractmethod
    def memory_snapshot(self, device):
        """``{"device", "bytes_in_use", "peak_bytes_in_use", "bytes_limit"}``
        for ``device`` — the one device-memory read of the port (the JAX
        package's ``memory_snapshot``)."""
        ...
