"""Fault tolerance (port of ``deepspeed_tpu/runtime/fault/``):
crash-atomic checkpoints, fault injection, retries and auto-resume
supervision.

* :mod:`~deepspeed_tpu_torch.runtime.fault.atomic` — fsync'd atomic file
  and directory publish.
* :mod:`~deepspeed_tpu_torch.runtime.fault.manifest` — write into
  ``<tag>.tmp/``, emit a ``MANIFEST.json`` (per-file sizes and checksums,
  a torch / device fingerprint, step metadata), rename to ``<tag>/``;
  verification, walk-back to the newest valid tag, retention.
* :mod:`~deepspeed_tpu_torch.runtime.fault.inject` — named injection
  points, armed in code or by ``DSTPU_FAULT_INJECT``.
* :mod:`~deepspeed_tpu_torch.runtime.fault.retry` — bounded retry with
  exponential backoff and deterministic jitter for transient I/O.
* :mod:`~deepspeed_tpu_torch.runtime.fault.supervisor` —
  ``run_resilient``: resume before the first step, the heartbeat
  watchdog, reload-latest-valid-then-continue, preemption through
  ``DSElasticAgent``, ``elastic_resume_config``.
* :mod:`~deepspeed_tpu_torch.runtime.fault.ckpt_cli` — ``list`` /
  ``verify`` / ``gc`` of a checkpoint directory.

All knobs live in the ``fault`` config block (:class:`FaultConfig`),
off by default.  The training engine's ``save_checkpoint`` /
``load_checkpoint`` and the serving snapshots
(``inference/serving/snapshot.py``) publish through this protocol.
"""

from deepspeed_tpu_torch.runtime.fault.config import FaultConfig  # noqa: F401
from deepspeed_tpu_torch.runtime.fault.inject import (  # noqa: F401
    InjectedFault, fire, configure_injection, reset_injection,
    injection_points)
from deepspeed_tpu_torch.runtime.fault.manifest import (  # noqa: F401
    MANIFEST_NAME, CheckpointCorrupt, build_manifest, write_manifest,
    verify_manifest, read_manifest, list_tags, newest_valid_tag,
    gc_checkpoints)
from deepspeed_tpu_torch.runtime.fault.retry import (  # noqa: F401
    retry_call, TRANSIENT_IO_ERRORS)
from deepspeed_tpu_torch.runtime.fault.supervisor import (  # noqa: F401
    run_resilient, StepHangError, elastic_resume_config)
