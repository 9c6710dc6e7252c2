"""Bounded retry with exponential backoff + jitter (a copy of
``deepspeed_tpu/runtime/fault/retry.py``).

The policy for every transient failure class the fault subsystem absorbs:
checkpoint I/O (network filesystems flake), collective initialization
(peers of a resized slice arrive seconds apart), inference executable
loads (shared compile-cache stores are eventually consistent).  Jitter is
deterministic per (attempt, pid) so retries stay reproducible under test
while still decorrelating a herd of preempted workers in production.
"""

import os
import time

from deepspeed_tpu_torch.utils.logging import logger

# the transient class worth retrying: OS-level I/O (IOError and
# TimeoutError are OSError aliases/subclasses; InjectedFault is an
# IOError).  Deliberately NOT Exception — a ValueError from corrupt
# state must fail fast, not loop.
TRANSIENT_IO_ERRORS = (OSError,)

# OSError subclasses that are PERMANENT (a typo'd path or a permissions
# problem does not heal with backoff) — retry_call re-raises these
# immediately, and the supervisor treats them as bugs, not faults
PERMANENT_OS_ERRORS = (FileNotFoundError, NotADirectoryError,
                       IsADirectoryError, PermissionError,
                       FileExistsError)


def is_transient(exc):
    """True when ``exc`` is in the retryable class: an OSError that is
    not one of the permanent-errno subclasses."""
    return isinstance(exc, TRANSIENT_IO_ERRORS) \
        and not isinstance(exc, PERMANENT_OS_ERRORS)


def backoff_delay(attempt, base=0.5, max_delay=30.0, jitter=0.25):
    """Delay before retry ``attempt`` (1-based): ``base * 2^(attempt-1)``
    capped at ``max_delay``, plus up to ``jitter`` fraction of that,
    derived deterministically from (attempt, pid)."""
    delay = min(float(max_delay), float(base) * (2.0 ** (attempt - 1)))
    if jitter:
        # cheap deterministic hash → [0, 1): reproducible, no RNG state
        seed = (attempt * 2654435761 + os.getpid() * 40503) & 0xFFFFFFFF
        delay += delay * float(jitter) * (seed / 2 ** 32)
    return delay


def retry_call(fn, *args, retries=3, base=0.5, max_delay=30.0, jitter=0.25,
               retry_on=TRANSIENT_IO_ERRORS, on_retry=None, label=None,
               sleep=time.sleep, **kwargs):
    """Call ``fn(*args, **kwargs)``; on a ``retry_on`` exception, back off
    and retry up to ``retries`` times (so at most ``retries + 1`` calls).
    ``on_retry(attempt, exc)`` is invoked before each backoff — the
    supervisor counts retries through it.  The final failure re-raises."""
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if retry_on is TRANSIENT_IO_ERRORS and not is_transient(e):
                raise        # permanent errno class: backoff cannot help
            attempt += 1
            if attempt > retries:
                raise
            delay = backoff_delay(attempt, base, max_delay, jitter)
            logger.warning(f"[fault] {label or getattr(fn, '__name__', fn)}"
                           f": transient failure ({type(e).__name__}: {e});"
                           f" retry {attempt}/{retries} in {delay:.2f}s")
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(delay)


def retry_policy_from_config(fault_config):
    """kwargs for :func:`retry_call` from a :class:`FaultConfig` (or None
    → a single attempt, no retries: seed behavior)."""
    if fault_config is None or not getattr(fault_config, "enabled", False):
        return dict(retries=0, base=0.0, jitter=0.0)
    return dict(retries=int(fault_config.max_retries),
                base=float(fault_config.backoff_base_secs),
                max_delay=float(fault_config.backoff_max_secs),
                jitter=float(fault_config.backoff_jitter))
