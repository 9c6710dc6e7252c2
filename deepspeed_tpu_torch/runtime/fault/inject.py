"""Deterministic fault injection — kill the run at every seam, on purpose
(port of ``deepspeed_tpu/runtime/fault/inject.py``: the same point names,
the same ``DSTPU_FAULT_INJECT`` spec syntax, and its ``exit``, ``raise``,
``sigterm``, ``hang`` and ``corrupt`` actions; ``yield`` waits for the
serving lock seams that need it).

Recovery code that has never seen a failure does not work; this registry
lets tests (and chaos drills on real slices) trigger a precise failure at a
named point in the checkpoint / training / serving pipeline:

====================================  ====================================
point                                 seam
====================================  ====================================
``ckpt.save_io``                      start of a checkpoint save (the
                                      transient-IOError seam the retry
                                      policy covers)
``ckpt.arrays_write``                 after array shards are written,
                                      before metadata — a kill here leaves
                                      a data-partial staging dir
``ckpt.before_manifest``              staging dir fully written, manifest
                                      not yet emitted
``ckpt.corrupt_shard``                after the manifest: the ``corrupt``
                                      action flips bytes in one array
                                      shard (bit-rot simulation)
``ckpt.before_commit_rename``         manifest durable, atomic rename not
                                      yet performed
``ckpt.before_latest_swap``           tag committed, ``latest`` pointer
                                      not yet swapped
``train.step_begin``                  top of every supervised train step
                                      (``sigterm``-at-step-K, ``hang``)
``infer.executable_load``             AOT executable load/compile in the
                                      inference engine
``serving.pre_admit``                 before the serving engine's fused
                                      admit dispatch (slot reserved, lane
                                      prefilled, state not yet written)
``serving.pre_decode_dispatch``       before each serving decode-block
                                      dispatch
``serving.mid_drain``                 every iteration of the graceful
                                      preemption drain loop (kills here
                                      land BEFORE the snapshot publish)
``serving.sigterm_at_iter``           top of every serving scheduler
                                      iteration (``sigterm``-at-iter-K:
                                      the graceful-preemption proof)
``serving.pre_step_lock``             in ``step()``, after the owner
                                      check, before the engine lock
``serving.pre_submit_lock``           in ``submit()`` before the lock
``serving.pre_cancel_lock``           in ``cancel()`` before the lock
``serving.pre_subscribe_lock``        in ``token_events()`` before the
                                      lock
``serving.mirror_drain``              per event popped in the host
                                      mirror's drain loop
====================================  ====================================

In the port the training engine's checkpoint save fires the six
``ckpt.*`` points, ``run_resilient`` fires ``train.step_begin``, and the
serving engine fires ``serving.pre_admit``,
``serving.pre_decode_dispatch``, ``serving.mid_drain``,
``serving.sigterm_at_iter`` and ``serving.mirror_drain``; the four lock
seams are registered names that nothing fires yet (the port's serving
engine has no lock), and ``infer.executable_load`` has no caller (the
port keeps no executable store).

Arm points programmatically (:func:`configure_injection`) or via the
``DSTPU_FAULT_INJECT`` env var — specs separated by ``;``, fields by
``,``::

    DSTPU_FAULT_INJECT="point=ckpt.before_latest_swap,action=exit,at=1"

Spec fields: ``point`` (required), ``action`` (``exit`` | ``raise`` |
``sigterm`` | ``hang`` | ``corrupt``; default ``raise``), ``at`` (fire on
the Nth hit of the point, 1-based; default 1), ``times`` (how many
consecutive hits fire, default 1; ``0`` = every hit from ``at`` on),
``seconds`` (hang duration, default 3600), ``exit_code`` (default 17).

Actions:

* ``exit`` — ``os._exit``: the process dies with no cleanup, no atexit, no
  finally blocks.  The honest simulation of SIGKILL / machine preemption.
* ``raise`` — raise :class:`InjectedFault` (an ``IOError``): the transient
  failure the retry/backoff policy must absorb.
* ``sigterm`` — deliver SIGTERM to self: the graceful-preemption path the
  elastic agent handles.
* ``hang`` — sleep at the seam: what a stuck step looks like to the
  heartbeat watchdog.
* ``corrupt`` — flip bytes in the largest file under the ``path`` the seam
  provides (an array file): manifest verification must catch it.

``fire()`` is a dict-lookup no-op when nothing is armed — it is safe on
hot-ish paths like the supervisor step loop.
"""

import os
import signal
import threading
import time

from deepspeed_tpu_torch.utils.logging import logger

ENV_VAR = "DSTPU_FAULT_INJECT"

INJECTION_POINTS = (
    "ckpt.save_io",
    "ckpt.arrays_write",
    "ckpt.before_manifest",
    "ckpt.corrupt_shard",
    "ckpt.before_commit_rename",
    "ckpt.before_latest_swap",
    "train.step_begin",
    "infer.executable_load",
    "serving.pre_admit",
    "serving.pre_decode_dispatch",
    "serving.mid_drain",
    "serving.sigterm_at_iter",
    "serving.pre_step_lock",
    "serving.pre_submit_lock",
    "serving.pre_cancel_lock",
    "serving.pre_subscribe_lock",
    "serving.mirror_drain",
)


class InjectedFault(IOError):
    """The transient failure raised by the ``raise`` action."""


class _Spec:
    __slots__ = ("point", "action", "at", "times", "seconds", "exit_code",
                 "hits", "fired")

    def __init__(self, point, action="raise", at=1, times=1, seconds=3600.0,
                 exit_code=17):
        if point not in INJECTION_POINTS:
            raise ValueError(f"unknown injection point {point!r}; one of "
                             f"{INJECTION_POINTS}")
        if action not in ("exit", "raise", "sigterm", "hang", "corrupt"):
            raise ValueError(f"unknown injection action {action!r}")
        self.point = point
        self.action = action
        self.at = int(at)
        self.times = int(times)
        self.seconds = float(seconds)
        self.exit_code = int(exit_code)
        self.hits = 0
        self.fired = 0


_armed = {}          # point -> list[_Spec]
_env_loaded = False


def injection_points():
    return INJECTION_POINTS


def configure_injection(specs):
    """Arm injection specs.  ``specs``: an env-var-style string, a dict, or
    a list of dicts.  Returns the armed spec objects (tests inspect
    ``.hits`` / ``.fired``)."""
    if isinstance(specs, str):
        specs = [_parse_one(s) for s in specs.split(";") if s.strip()]
    elif isinstance(specs, dict):
        specs = [specs]
    armed = []
    for spec in specs:
        s = _Spec(**spec)
        _armed.setdefault(s.point, []).append(s)
        armed.append(s)
    if armed:
        logger.warning("[fault] injection ARMED: "
                       + "; ".join(f"{s.point}:{s.action}@{s.at}"
                                   for s in armed))
    return armed


def _parse_one(text):
    out = {}
    for field in text.split(","):
        field = field.strip()
        if not field:
            continue
        k, _, v = field.partition("=")
        out[k.strip()] = v.strip()
    return out


def reset_injection():
    """Disarm everything (test teardown)."""
    _armed.clear()


def _load_env():
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    spec = os.environ.get(ENV_VAR)
    if spec:
        configure_injection(spec)


def active():
    _load_env()
    return bool(_armed)


_fire_lock = threading.Lock()


def fire(point, path=None):
    """Hit an injection point.  No-op unless a spec is armed for it.  The
    spec bookkeeping (``hits`` / ``fired``) is locked, so that an
    ``at`` / ``times``-limited spec fires exactly as often as it says
    whatever thread hits it; the action runs outside the lock — it may
    raise or never return."""
    _load_env()
    specs = _armed.get(point)
    if not specs:
        return
    to_run = []
    with _fire_lock:
        for spec in specs:
            spec.hits += 1
            if spec.hits < spec.at:
                continue
            if spec.times and spec.fired >= spec.times:
                continue
            spec.fired += 1
            to_run.append(spec)
    for spec in to_run:
        _execute(spec, path)


def _execute(spec, path):
    logger.warning(f"[fault] injection FIRING: {spec.point} -> "
                   f"{spec.action} (hit {spec.hits})")
    if spec.action == "exit":
        # os._exit: no atexit, no finally, no flush — a crash, not an exit
        os._exit(spec.exit_code)
    if spec.action == "raise":
        raise InjectedFault(
            f"injected transient fault at {spec.point} (hit {spec.hits})")
    if spec.action == "sigterm":
        os.kill(os.getpid(), signal.SIGTERM)
        return
    if spec.action == "hang":
        time.sleep(spec.seconds)
        return
    if spec.action == "corrupt":
        _corrupt_largest_file(path)


def _corrupt_largest_file(path):
    """Flip bytes in the middle of the largest regular file under ``path``
    (a directory or a single file) — the bit-rot manifest verification
    exists to catch.  The size is unchanged, so only checksums notice."""
    if path is None:
        raise ValueError("corrupt action needs the seam to provide a path")
    target, size = None, -1
    if os.path.isfile(path):
        target, size = path, os.path.getsize(path)
    else:
        for dirpath, _d, filenames in os.walk(path):
            for name in filenames:
                if name == "MANIFEST.json":
                    continue
                p = os.path.join(dirpath, name)
                s = os.path.getsize(p)
                if s > size:
                    target, size = p, s
    if target is None or size <= 0:
        raise ValueError(f"corrupt action: no file to corrupt under {path}")
    with open(target, "r+b") as f:
        f.seek(size // 2)
        chunk = f.read(min(64, size - size // 2))
        f.seek(size // 2)
        f.write(bytes(b ^ 0xFF for b in chunk))
    logger.warning(f"[fault] corrupted {len(chunk)} bytes of {target}")
