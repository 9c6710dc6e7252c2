"""Fault tolerance (port of ``deepspeed_tpu/runtime/fault/``, the parts the
serving lifecycle runs): the crash-atomic publish protocol and the
deterministic fault injection.

* :mod:`~deepspeed_tpu_torch.runtime.fault.atomic` — fsync'd atomic file
  and directory publish.
* :mod:`~deepspeed_tpu_torch.runtime.fault.manifest` — write into
  ``<tag>.tmp/``, emit a ``MANIFEST.json`` (per-file sizes and checksums,
  a torch / device fingerprint, step metadata), rename to ``<tag>/``;
  verification and walk-back to the newest valid tag.
* :mod:`~deepspeed_tpu_torch.runtime.fault.inject` — named injection
  points, armed in code or by ``DSTPU_FAULT_INJECT``.

Serving snapshots (``inference/serving/snapshot.py``) publish through
them.  The JAX package's retry policy, supervisor and ``fault`` config
block are not ported yet.
"""

from deepspeed_tpu_torch.runtime.fault.inject import (  # noqa: F401
    InjectedFault, fire, configure_injection, reset_injection,
    injection_points)
from deepspeed_tpu_torch.runtime.fault.manifest import (  # noqa: F401
    MANIFEST_NAME, CheckpointCorrupt, build_manifest, write_manifest,
    verify_manifest, read_manifest, list_tags, newest_valid_tag,
    gc_checkpoints)
