"""Concurrency contract of the serving engine (port of
``deepspeed_tpu/inference/serving/concurrency.py``): the registry of
lock-guarded fields, the ``DSTPU_CONCURRENCY_CHECKS=1`` runtime prover,
and the engine lock that meters its own wait.

The serving engine is multi-threaded: one engine lock, an owner-bound
scheduler thread, condition-blocked submits, and an asyncio loop that
reaches the engine through ``run_in_executor``.  Every piece of the port
engine's mutable scheduler state is declared here once, as guarded by
that lock; :func:`install_concurrency_checks` turns the declaration into
an assertion at every access (``DSTPU_CONCURRENCY_CHECKS=1``).

Not in the registry, each for its reason:

* ``wake`` — a ``threading.Event``, synchronized by itself.
* ``_flightrec`` — the flight recorder's ring has its own lock: readers
  (``/debug/flightrec``, SIGUSR2, crash dumps) never contend the engine
  lock; the reference is set once in ``__init__``.
* ``_hist`` — the histograms lock themselves (``monitor/trace.py``), so
  ``/metrics`` renders them without the engine lock.
* ``_breaker`` — changed only under the lock; its unlocked reads are
  single-attribute probes.
* ``_lock`` / ``_cond`` — the guards themselves.
* ``FairnessTracker`` internals — reached only through the guarded
  ``_fairness`` attribute.
* configuration set once in ``__init__`` (``num_slots``, ``cache_len``,
  ``paged``, ``config``, the captured programs, ...).
"""

import os
import threading
import time
from collections import deque

# ---------------------------------------------------------------------- #
# The registry: the port engine's fields (pure literals)
# ---------------------------------------------------------------------- #
# class -> {field -> lock attribute that must be held to touch it}
GUARDED_FIELDS = {
    "ServingEngine": {
        # request queue and admission
        "_queue": "_lock",
        "_pending": "_lock",
        "_requests": "_lock",
        "_next_rid": "_lock",
        "_lane_pool": "_lock",
        # host mirror of the device state (the lag-one protocol)
        "_events": "_lock",
        "_slots": "_lock",
        "_free": "_lock",
        "_mirror_active": "_lock",
        "_slot_last_dispatch": "_lock",
        "_state": "_lock",
        "_cache": "_lock",
        "_gen": "_lock",
        # lanes retired by a thread that may not touch the device: made
        # inactive on the device at the owner's next dispatch
        "_deactivate": "_lock",
        # paged KV bookkeeping
        "_slot_pages": "_lock",
        "_page_table": "_lock",
        "_pages_dev": "_lock",
        "_pool": "_lock",
        "_prefix": "_lock",
        # speculative decoding: the draft's slot lanes and prefill lanes
        "_draft_cache": "_lock",
        "_draft_lanes": "_lock",
        # results and lifecycle
        "_results": "_lock",
        "_pending_reports": "_lock",
        "_closed": "_lock",
        "_close_report": "_lock",
        "_it": "_lock",
        "_snap_seq": "_lock",
        "_owner_thread": "_lock",
        # token streams, fairness, counters
        "_streams": "_lock",
        "_fairness": "_lock",
        "stats": "_lock",
        "occupancy_trace": "_lock",
        # observability: the span ring is appended to at the scheduler
        # seams and copied whole by dump_trace(); the memory sampler's
        # cadence and last sample change at the same seams
        "_tracer": "_lock",
        "_memwatch": "_lock",
        # tensor parallelism: the plan link, the leader's next plan, the
        # plan's clock during a step
        "_plans": "_lock",
        "_plan_out": "_lock",
        "_step_now": "_lock",
    },
}

# class -> {alias lock attr -> canonical lock attr}: the engine's condition
# wraps the engine lock, so ``with self._cond:`` holds ``_lock`` too
LOCK_ALIASES = {
    "ServingEngine": {"_cond": "_lock"},
}

# ServingEngine methods that take the engine lock themselves — the
# thread-safe surface.  An asyncio handler calls them through
# ``run_in_executor``: on the loop thread they would block the loop for
# as long as the scheduler holds the lock.
LOCKED_METHODS = (
    "submit", "cancel", "status", "result", "token_events", "close",
    "restore", "snapshot", "health_snapshot", "work_pending",
    "bind_owner", "release_owner",
)

# Driving methods bound to the one scheduler-owner thread: a call from any
# other thread raises.
OWNER_BOUND_METHODS = ("step", "drain", "preempt")

ENV_VAR = "DSTPU_CONCURRENCY_CHECKS"


def checks_enabled():
    """True when ``DSTPU_CONCURRENCY_CHECKS`` requests the debug mode."""
    return os.environ.get(ENV_VAR, "").lower() in ("1", "true", "yes", "on")


class ConcurrencyViolation(AssertionError):
    """A guarded field was touched without its lock held.  Raised at the
    access, so the stack points at the offending read or write, not at a
    later corruption."""


def _checked_class(base):
    """A subclass of ``base`` whose ``__getattribute__``/``__setattr__``
    assert the declared lock is held for every guarded-field access."""
    guarded = GUARDED_FIELDS["ServingEngine"]

    def _assert_held(self, name, verb):
        lock = object.__getattribute__(self, guarded[name])
        if not lock._is_owned():
            # last-gasp observability: the flight recorder (own lock —
            # safe to touch here) captures the violation and dumps the
            # ring, so the post-mortem shows what the scheduler was
            # doing when the discipline broke.  Strictly best-effort:
            # the violation must raise regardless.
            try:
                fr = object.__getattribute__(self, "_flightrec")
            except AttributeError:
                fr = None
            if fr is not None:
                try:
                    fr.record("concurrency_violation", field=name,
                              verb=verb)
                    fr.dump("concurrency_violation")
                except Exception:        # noqa: BLE001
                    pass
            raise ConcurrencyViolation(
                f"{verb} of lock-guarded field {name!r} from thread "
                f"{threading.current_thread().name!r} without holding "
                f"self.{guarded[name]} (DSTPU_CONCURRENCY_CHECKS=1)")

    class _Checked(base):
        def __getattribute__(self, name):
            if name in guarded:
                _assert_held(self, name, "read")
            return super().__getattribute__(name)

        def __setattr__(self, name, value):
            if name in guarded:
                _assert_held(self, name, "write")
            super().__setattr__(name, value)

    _Checked.__name__ = base.__name__ + "+concurrency_checks"
    _Checked.__qualname__ = _Checked.__name__
    return _Checked


_checked_cache = {}


def install_concurrency_checks(srv):
    """Flip ``srv`` (a fully-constructed :class:`ServingEngine`) into the
    held-lock-asserting debug subclass.  Idempotent; called from the
    engine's ``__init__`` tail when :func:`checks_enabled`."""
    base = type(srv)
    if getattr(base, "_dstpu_concurrency_checked", False):
        return srv
    checked = _checked_cache.get(base)
    if checked is None:
        checked = _checked_class(base)
        checked._dstpu_concurrency_checked = True
        _checked_cache[base] = checked
    srv.__class__ = checked
    return srv


class InstrumentedRLock:
    """A re-entrant lock that accounts wall time spent WAITING to acquire
    it, split by thread class (the scheduler owner vs everyone else) —
    the serving engine's lock-contention observability
    (``Serving/lock_wait_*_s`` monitor events,
    ``dstpu_serving_lock_wait_seconds`` in ``/metrics``).

    Accounting is mutated only AFTER a successful acquire — i.e. while
    holding the lock — so the totals need no extra synchronization.
    ``_owner_ref`` is set by the engine to a zero-arg callable returning
    the current scheduler-owner thread (read lock-held, so it is safe
    under ``DSTPU_CONCURRENCY_CHECKS`` too).  Delegates ``_is_owned`` /
    ``_release_save`` / ``_acquire_restore`` so ``threading.Condition``
    (the engine's blocked-submit condvar) composes; a condvar re-acquire
    after ``wait()`` counts as lock wait — that IS time the thread spent
    blocked on the lock.

    Handlers go first: the scheduler owner takes the lock again right
    after each step, before a woken waiter can, and without this a
    handler waited seconds for a lock held 5 ms at a time.  At each of
    its top-level acquires the owner yields (``time.sleep(0)``, for at
    most ``YIELD_S``) while handler threads wait on the lock; that time
    counts as its lock wait."""

    SAMPLE_WINDOW = 4096                 # newest per-acquire waits kept
    YIELD_S = 0.005

    def __init__(self):
        self._inner = threading.RLock()
        self._handlers_waiting = 0
        self._count_lock = threading.Lock()
        self._owner_ref = lambda: None
        self.wait_s = {"scheduler": 0.0, "handler": 0.0}
        self.acquires = {"scheduler": 0, "handler": 0}
        self.samples = {"scheduler": deque(maxlen=self.SAMPLE_WINDOW),
                        "handler": deque(maxlen=self.SAMPLE_WINDOW)}
        # optional per-acquire observer ``(thread_class, wait_s) -> None``
        # — the serving engine points it at its lock-wait histogram
        # under ``serving.tracing``.  Called lock-HELD (right after a
        # successful acquire) and must be internally synchronized and
        # non-raising; exceptions are swallowed so a broken observer
        # can never poison the lock.
        self.on_wait = None

    def _account(self, dt):
        cls = ("scheduler"
               if threading.current_thread() is self._owner_ref()
               else "handler")
        self.wait_s[cls] += dt
        self.acquires[cls] += 1
        self.samples[cls].append(dt)
        cb = self.on_wait
        if cb is not None:
            try:
                cb(cls, dt)
            except Exception:            # noqa: BLE001 — observer only
                pass

    def acquire(self, blocking=True, timeout=-1):
        if self._inner._is_owned():
            # re-entrant acquire: cannot wait by definition — keep it
            # out of the samples so the wait percentiles measure real
            # contention, not the locked monitoring properties
            # re-entering from an already-locked caller
            return self._inner.acquire(blocking, timeout)
        t0 = time.perf_counter()
        ok = self._waiting(lambda: self._inner.acquire(blocking, timeout),
                           t0, blocking)
        if ok:
            self._account(time.perf_counter() - t0)
        return ok

    def _waiting(self, take, t0, blocking=True):
        """``take()`` the lock: the owner after the waiting handlers,
        a handler counted among them while it waits."""
        if threading.current_thread() is self._owner_ref():
            while blocking and self._handlers_waiting \
                    and time.perf_counter() - t0 < self.YIELD_S:
                time.sleep(0)
            return take()
        with self._count_lock:
            self._handlers_waiting += 1
        try:
            return take()
        finally:
            with self._count_lock:
                self._handlers_waiting -= 1

    def release(self):
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # ---- threading.Condition integration ----
    def _is_owned(self):
        return self._inner._is_owned()

    def _release_save(self):
        return self._inner._release_save()

    def _acquire_restore(self, state):
        t0 = time.perf_counter()
        self._waiting(lambda: self._inner._acquire_restore(state), t0)
        self._account(time.perf_counter() - t0)


__all__ = ["GUARDED_FIELDS", "LOCK_ALIASES", "LOCKED_METHODS",
           "OWNER_BOUND_METHODS", "checks_enabled",
           "ConcurrencyViolation", "install_concurrency_checks",
           "InstrumentedRLock"]
