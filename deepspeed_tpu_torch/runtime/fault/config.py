"""``fault`` config block (port of ``deepspeed_tpu/runtime/fault/config.py``)
— every fault-tolerance knob in one dataclass, with the JAX defaults.

Shared by the training config (``runtime/config.py``) and the inference
config (``inference/config.py``); ``enabled: false`` (the default) keeps
the plain save / load: no manifest protocol, no retries, no verification.
"""

import dataclasses

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel

CHECKSUMS = ("sha256", "crc32")


@dataclasses.dataclass(init=False)
class FaultConfig(DeepSpeedConfigModel):
    # master switch: off = plain checkpoints (the temp-file 'latest' and
    # meta.pkl writes stay atomic either way)
    enabled: bool = False

    # ---- crash-atomic checkpoint protocol ---------------------------- #
    # verify MANIFEST.json (sizes + checksums) before trusting a tag on
    # load; a failed tag is skipped and load walks back to the newest
    # valid one
    verify_on_load: bool = True
    # per-file checksum recorded in the manifest: "sha256" or "crc32"
    checksum: str = "sha256"
    # retention: keep the newest N valid tags, GC older ones and orphaned
    # <tag>.tmp dirs after every successful save; 0 = keep everything
    keep_last_n: int = 0

    # ---- transient-failure retry policy ------------------------------ #
    max_retries: int = 3
    backoff_base_secs: float = 0.5
    backoff_max_secs: float = 30.0
    # fraction of the backoff added as deterministic jitter
    backoff_jitter: float = 0.25

    # ---- auto-resume supervisor (run_resilient) ---------------------- #
    # give up after this many reload-and-continue recoveries
    max_resumes: int = 10
    # a step longer than this dumps all thread stacks and (with
    # emergency_checkpoint_on_hang) saves before recovering; 0 = off
    heartbeat_timeout_secs: float = 0.0
    emergency_checkpoint_on_hang: bool = True
    # steps between periodic supervisor checkpoints; 0 = only emergency /
    # final checkpoints
    save_interval: int = 0

    # ---- inference graceful degradation ------------------------------ #
    # split an over-budget generation batch under strict_memory (the
    # inference config refuses it: strict_memory is not ported)
    bucket_downshift: bool = False

    def validate(self):
        if self.checksum not in CHECKSUMS:
            raise ValueError(f"fault.checksum must be one of {CHECKSUMS}, "
                             f"got {self.checksum!r}")
        if self.keep_last_n < 0 or self.max_retries < 0 \
                or self.max_resumes < 0:
            raise ValueError("fault.keep_last_n, max_retries and "
                             "max_resumes must be >= 0")
