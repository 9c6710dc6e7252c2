"""Auto-resume supervisor: ``run_resilient(engine, step_fn)`` (port of
``deepspeed_tpu/runtime/fault/supervisor.py``).

The in-process half of surviving preemptible capacity (the out-of-process
half — restarting the killed process — belongs to the cluster scheduler;
this loop makes every restart land on its feet):

* **resume-before-run**: load the newest *valid* checkpoint (manifest
  verification + walk-back — see ``fault/manifest.py``) before the first
  step, so a restarted process continues instead of restarting.
* **retry with exponential backoff + jitter** for transient I/O and
  collective-init failures (``fault/retry.py``).
* **heartbeat watchdog**: a step exceeding ``heartbeat_timeout_secs``
  dumps every thread's stack (``faulthandler``) and raises
  :class:`StepHangError` in the main thread; the supervisor saves an
  emergency checkpoint and recovers.
* **reload-latest-valid-then-continue**: a faulted step reloads the newest
  valid checkpoint into the live engine and keeps going, up to
  ``max_resumes`` times.
* **preemption** (via :class:`DSElasticAgent`): SIGTERM marks the run; the
  next step boundary writes an emergency checkpoint and returns
  ``("preempted", ...)`` so the scheduler can reschedule; on the resized
  slice, :func:`elastic_resume_config` recomputes a global-batch-preserving
  config before the engine is rebuilt.

``step_fn(engine)`` runs ONE optimizer step (e.g. ``engine.train_batch``
on a batch derived from ``engine.global_steps``) — deriving data from the
step counter is what makes a resumed trajectory bitwise-identical to an
uninterrupted one.
"""

import faulthandler
import os
import signal
import sys
import threading
import time

from deepspeed_tpu_torch.runtime.fault import inject
from deepspeed_tpu_torch.runtime.fault.config import FaultConfig
from deepspeed_tpu_torch.runtime.fault.retry import (
    is_transient, retry_call, retry_policy_from_config, TRANSIENT_IO_ERRORS)
from deepspeed_tpu_torch.utils.logging import logger


class StepHangError(RuntimeError):
    """Raised in the main thread when the heartbeat watchdog expires."""


class HeartbeatWatchdog:
    """Background thread that watches an armed step deadline; on expiry it
    dumps all thread stacks and delivers a signal to the main thread whose
    handler raises :class:`StepHangError` — which interrupts blocking
    Python code (sleeps, socket waits) at the next bytecode boundary.

    The watchdog covers the ARMED window only (``arm()`` at step start,
    ``disarm()`` at step end) — checkpoint saves and recovery reloads run
    outside it, so a slow checksum pass is never mistaken for a hang."""

    _SIGNAL = getattr(signal, "SIGALRM", None)

    def __init__(self, timeout_secs, poll_secs=None):
        self.timeout = float(timeout_secs)
        self.poll = poll_secs or max(0.05, min(1.0, self.timeout / 4))
        self._beat = time.monotonic()
        self._armed = False
        self._fired = False
        self._stop = threading.Event()
        self._thread = None
        self._prev_handler = None

    def arm(self):
        self._beat = time.monotonic()
        self._fired = False
        self._armed = True

    def disarm(self):
        self._armed = False

    def _on_signal(self, signum, frame):
        if not self._armed:
            # the step finished (or recovery began) between the watchdog's
            # deadline check and the signal landing — a late StepHangError
            # outside the guarded step block would crash the supervisor
            # or interrupt a checkpoint save mid-write
            return
        raise StepHangError(
            f"step exceeded heartbeat timeout ({self.timeout:.1f}s)")

    def _watch(self):
        while not self._stop.wait(self.poll):
            if not self._armed or self._fired:
                continue
            if time.monotonic() - self._beat <= self.timeout:
                continue
            self._fired = True
            logger.error(f"[fault] heartbeat missed for "
                         f"{time.monotonic() - self._beat:.1f}s — dumping "
                         "all thread stacks")
            try:
                faulthandler.dump_traceback(file=sys.stderr,
                                            all_threads=True)
            except Exception:
                pass
            # re-check: the stack dump takes tens of ms and the step may
            # have completed during it (the handler re-checks too)
            if self._SIGNAL is not None and self._armed:
                os.kill(os.getpid(), self._SIGNAL)

    def start(self):
        if self._SIGNAL is not None:
            self._prev_handler = signal.signal(self._SIGNAL, self._on_signal)
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="ds-heartbeat-watchdog")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._SIGNAL is not None and self._prev_handler is not None:
            signal.signal(self._SIGNAL, self._prev_handler)
            self._prev_handler = None


def elastic_resume_config(ds_config, world_size=None):
    """Global-batch-preserving config for resuming on a (possibly resized)
    slice: when the ``elasticity`` block is enabled, recompute the batch
    triple for ``world_size`` devices via the elasticity solver (the
    reference's v0.1/v0.2 schedulers); otherwise return the config
    unchanged.  Call BEFORE constructing the engine of a restarted run.
    ``world_size`` defaults to the agent's (the visible CUDA devices, else
    1)."""
    if not dict(ds_config).get("elasticity", {}).get("enabled", False):
        return dict(ds_config)
    from deepspeed_tpu_torch.elasticity.elastic_agent import DSElasticAgent
    agent = DSElasticAgent(ds_config, world_size=world_size)
    world_size = agent.world_size
    cfg = agent.elastic_config_for(world_size)
    logger.info(f"[fault] elastic resume config for world={world_size}: "
                f"global={cfg['train_batch_size']} "
                f"micro={cfg['train_micro_batch_size_per_gpu']} "
                f"gas={cfg['gradient_accumulation_steps']}")
    return cfg


class _Counters:
    def __init__(self):
        self.retries = 0
        self.resumes = 0
        self.hangs = 0
        self.saves = 0


def run_resilient(engine, step_fn, checkpoint_dir, max_steps=None,
                  agent=None, fault_config=None, save_interval=None,
                  save_final=True, client_state=None, monitor=None):
    """Supervised training loop.  Returns ``(status, info)`` with status
    one of ``"done"`` / ``"preempted"`` / ``"failed"`` and info carrying
    the counters (steps/resumes/retries/hangs).

    ``max_steps`` bounds ``engine.global_steps`` (the absolute step count,
    checkpoint-resumable), not steps executed by this call.
    """
    cfg = fault_config or getattr(engine._config, "fault", None) \
        or FaultConfig()
    monitor = monitor if monitor is not None \
        else getattr(engine, "monitor", None)
    policy = retry_policy_from_config(cfg)
    counters = _Counters()

    own_agent = agent is None
    if own_agent:
        from deepspeed_tpu_torch.elasticity.elastic_agent import (
            DSElasticAgent)
        agent = DSElasticAgent(getattr(engine._config, "_param_dict", {}),
                               checkpoint_dir=checkpoint_dir)
    agent.start()

    watchdog = None
    if cfg.enabled and cfg.heartbeat_timeout_secs > 0:
        watchdog = HeartbeatWatchdog(cfg.heartbeat_timeout_secs).start()

    last_saved_step = [-1]

    def _save(tag=None):
        # no outer retry_call here: the engine's fault-enabled save
        # already retries its write stage with this same policy, and two
        # stacked layers compound to (retries+1)^2 attempts against a
        # genuinely down filesystem
        engine.save_checkpoint(checkpoint_dir, tag=tag,
                               client_state=client_state)
        counters.saves += 1
        last_saved_step[0] = engine.global_steps

    def _count_retry():
        counters.retries += 1
        _emit("Fault/retry_count", counters.retries)

    def _emit(name, value):
        if monitor is not None and getattr(monitor, "enabled", False):
            monitor.write_events([(name, value, engine.global_steps)])

    def _reload():
        """Reload the newest valid checkpoint into the live engine (the
        engine's fault-aware load verifies + walks back).  Any half-done
        accumulation window is dropped — the reloaded state is a step
        boundary."""
        engine.zero_grad()
        engine._pending = None
        retry_call(engine.load_checkpoint, checkpoint_dir,
                   on_retry=lambda a, e: _count_retry(),
                   label="load_checkpoint", **policy)
        counters.resumes += 1
        _emit("Fault/resume_events", counters.resumes)

    interval = cfg.save_interval if save_interval is None else save_interval
    status = "done"
    try:
        # resume-before-run: a restarted process picks up where the newest
        # valid checkpoint left off
        if checkpoint_dir and os.path.isdir(checkpoint_dir) \
                and _has_checkpoint(checkpoint_dir):
            start = engine.global_steps
            retry_call(engine.load_checkpoint, checkpoint_dir,
                       on_retry=lambda a, e: _count_retry(),
                       label="load_checkpoint", **policy)
            if engine.global_steps != start or start == 0:
                logger.info(f"[fault] resumed at global step "
                            f"{engine.global_steps}")
                _emit("Fault/resume_events", counters.resumes)
        steps_run = 0
        while max_steps is None or engine.global_steps < max_steps:
            try:
                if watchdog is not None:
                    watchdog.arm()
                # the injection seam sits INSIDE the recovery scope: a
                # hang/raise fired here exercises the same path a fault
                # inside step_fn would
                inject.fire("train.step_begin")
                step_fn(engine)
                steps_run += 1
            except StepHangError:
                if watchdog is not None:
                    # disarm BEFORE recovery: the emergency save + reload
                    # below can legitimately outlast the step timeout, and
                    # a watchdog firing mid-recovery would escape the
                    # supervisor entirely
                    watchdog.disarm()
                counters.hangs += 1
                logger.error("[fault] step hang detected")
                if cfg.emergency_checkpoint_on_hang:
                    try:
                        _save(tag=f"hang_step{engine.global_steps}")
                    except Exception as e:
                        logger.error(f"[fault] emergency checkpoint after "
                                     f"hang failed: {e}")
                if counters.resumes >= cfg.max_resumes:
                    status = "failed"
                    break
                _reload()
                continue
            except TRANSIENT_IO_ERRORS as e:
                if not is_transient(e):
                    # FileNotFoundError/PermissionError etc. are BUGS —
                    # reload-and-retry would re-run the identical failing
                    # step max_resumes times and mask the real problem
                    raise
                if watchdog is not None:
                    watchdog.disarm()   # recovery runs outside the window
                logger.error(f"[fault] step fault: {type(e).__name__}: {e}")
                if counters.resumes >= cfg.max_resumes:
                    status = "failed"
                    break
                _reload()
                continue
            finally:
                if watchdog is not None:
                    watchdog.disarm()
            if agent.checkpoint_if_preempted(engine):
                status = "preempted"
                break
            if interval and engine.global_steps % interval == 0:
                _save()
        if status == "done" and save_final and steps_run \
                and last_saved_step[0] != engine.global_steps:
            _save()
    finally:
        if watchdog is not None:
            watchdog.stop()
        if own_agent:
            agent.stop()
        _emit("Fault/resume_events", counters.resumes)
        _emit("Fault/retry_count", counters.retries)
    info = {"steps": engine.global_steps, "resumes": counters.resumes,
            "retries": counters.retries, "hangs": counters.hangs,
            "saves": counters.saves}
    logger.info(f"[fault] run_resilient: {status} {info}")
    return status, info


def _has_checkpoint(checkpoint_dir):
    from deepspeed_tpu_torch.runtime.fault.manifest import list_tags
    return os.path.exists(os.path.join(checkpoint_dir, "latest")) \
        or bool(list_tags(checkpoint_dir))
