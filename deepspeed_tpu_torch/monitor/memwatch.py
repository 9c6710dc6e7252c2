"""Live device-memory telemetry (port of
``deepspeed_tpu/monitor/memwatch.py``).

:class:`DeviceMemorySampler` is a default-off sampler that reads the
device's ``bytes_in_use`` / ``peak_bytes_in_use`` / ``bytes_limit``
through the port accelerator's ``memory_snapshot`` and reconciles the
serving engine's known owners — the page pool or slot lanes, the draft
workspace, the parameters, the CUDA-graph pool — against the device total
into an **unattributed bytes** figure: the gap is where a leak, a
retained copy or a forgotten staging buffer hides.

* **Owner thread only.**  ``torch.cuda.mem_get_info`` is a CUDA call, and
  a CUDA call from another thread during a graph capture fails the
  capture; the serving engine samples only at a scheduler seam on its
  owner thread, and ``/metrics`` renders the last sample.
* **Own cadence.**  ``maybe_sample(now)`` is a clock compare until
  ``interval_s`` has passed.
* **Injectable reader.**  The CPU reports no device memory, so the reader
  is a constructor argument; tests inject their own.
* **Flight recorder.**  With a recorder attached, every sample lands in
  its ring as a ``memory_sample`` event.
"""

import time

import torch

# the /metrics families the HTTP front end renders from a sample (the JAX
# package's names)
MEMORY_SERIES = (
    "dstpu_device_memory_bytes_in_use",
    "dstpu_device_memory_peak_bytes",
    "dstpu_device_memory_limit_bytes",
    "dstpu_device_memory_owned_bytes",
    "dstpu_device_memory_unattributed_bytes",
)


def accelerator_reader(device):
    """The production reader: ``[snapshot]`` of ``device`` from the port
    accelerator's ``memory_snapshot``, with the limit's source named
    (``device_total`` for a card, ``unknown`` when none is reported)."""
    from deepspeed_tpu_torch.accelerator.real_accelerator import \
        get_accelerator
    device = torch.device(device)
    snap = dict(get_accelerator(device).memory_snapshot(device))
    snap.setdefault("limit_source", "device_total"
                    if snap.get("bytes_limit") else "unknown")
    return [snap]


def tree_device_bytes(tree):
    """Bytes of every tensor in a nest of dicts, lists and tuples (0 for
    anything else) — owner figures without touching device data."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_device_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_device_bytes(v) for v in tree)
    return 0


class DeviceMemorySampler:
    """Periodic device-memory sampler with owner reconciliation.

    ``owners_fn`` returns ``{owner_name: bytes}`` for every buffer class
    the caller can name; ``read_fn`` returns the per-device snapshot list.
    ``flightrec`` (optional) receives a ``memory_sample`` event per sample.
    Not self-locked: the serving engine calls it under its lock, at a
    scheduler seam."""

    def __init__(self, interval_s=10.0, read_fn=None, owners_fn=None,
                 flightrec=None, clock=time.monotonic, device=None):
        self.interval_s = float(interval_s)
        if read_fn is None:
            dev = device if device is not None else "cuda"
            read_fn = lambda: accelerator_reader(dev)  # noqa: E731
        self._read = read_fn
        self._owners = owners_fn or (lambda: {})
        self._flightrec = flightrec
        self._clock = clock
        self._last_t = None
        self.samples = 0
        self.last = None                 # newest sample dict

    def sample(self):
        """Take one sample now: per-device snapshots and owner
        reconciliation.  Returns the sample dict (kept as ``self.last``)."""
        devices = list(self._read() or [])
        owners = {k: int(v) for k, v in (self._owners() or {}).items()}
        in_use = sum(d.get("bytes_in_use", 0) for d in devices)
        peak = sum(d.get("peak_bytes_in_use", 0) for d in devices)
        limit = sum(d.get("bytes_limit", 0) for d in devices)
        owned = sum(owners.values())
        # clamped at zero: a device that reports nothing (the CPU) must
        # not give a negative gap
        unattributed = max(0, in_use - owned)
        sample = {
            "t_mono": round(self._clock(), 6),
            "devices": devices,
            "bytes_in_use": in_use,
            "peak_bytes_in_use": peak,
            "bytes_limit": limit,
            "owners": owners,
            "owned_bytes": owned,
            "unattributed_bytes": unattributed,
        }
        self.samples += 1
        self.last = sample
        if self._flightrec is not None:
            self._flightrec.record(
                "memory_sample", bytes_in_use=in_use,
                peak_bytes_in_use=peak, owned_bytes=owned,
                unattributed_bytes=unattributed,
                owners={k: v for k, v in sorted(owners.items())})
        return sample

    def maybe_sample(self, now=None):
        """Sample when ``interval_s`` has passed since the last one (a
        clock compare otherwise); returns the new sample or ``None``."""
        now = self._clock() if now is None else now
        if self._last_t is not None \
                and now - self._last_t < self.interval_s:
            return None
        self._last_t = now
        return self.sample()


def device_memory_record(device="cuda"):
    """One-shot device-memory record (no sampler): the device's snapshot
    and its in-use / peak / limit bytes."""
    devices = accelerator_reader(device)
    return {
        "devices": devices,
        "bytes_in_use": sum(d.get("bytes_in_use", 0) for d in devices),
        "peak_bytes_in_use": sum(d.get("peak_bytes_in_use", 0)
                                 for d in devices),
        "bytes_limit": sum(d.get("bytes_limit", 0) for d in devices),
    }


__all__ = ["DeviceMemorySampler", "MEMORY_SERIES", "accelerator_reader",
           "tree_device_bytes", "device_memory_record"]
