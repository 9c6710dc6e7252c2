"""Request lifecycle, per-token streams and the dispatch circuit breaker of
the serving engine (port of ``deepspeed_tpu/inference/serving/slo.py``).

A request is ``QUEUED``, then ``PREFILLING`` while its prompt streams into
a slot, then ``RUNNING``, and ends in one of four typed terminal statuses:
``COMPLETED``, ``SHED_DEADLINE`` (its deadline passed, in the queue or in
its slot), ``CANCELLED`` (:meth:`ServingEngine.cancel`) or ``ABORTED``
(the engine was closed, or a dispatch failed with it in flight).
``PREEMPTED`` marks a request snapshotted by ``preempt()``: not terminal,
a restarted server finishes it.  The bounded queue refuses work with
:class:`QueueFull`, the :class:`CircuitBreaker` with :class:`CircuitOpen`,
and a ``drain()`` past its wall-clock budget raises :class:`DrainTimeout`.
:class:`TokenStream` carries a request's generated tokens one event each,
then one typed ``end`` event.  All of it is host bookkeeping.
"""

import queue
import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from deepspeed_tpu_torch.utils.logging import logger


class RequestStatus:
    """Request lifecycle states; ``COMPLETED`` | ``SHED_DEADLINE`` |
    ``CANCELLED`` | ``ABORTED`` are terminal, ``PREEMPTED`` is not."""
    QUEUED = "QUEUED"
    PREFILLING = "PREFILLING"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    SHED_DEADLINE = "SHED_DEADLINE"
    CANCELLED = "CANCELLED"
    ABORTED = "ABORTED"
    PREEMPTED = "PREEMPTED"


TERMINAL_STATUSES = frozenset({RequestStatus.COMPLETED,
                               RequestStatus.SHED_DEADLINE,
                               RequestStatus.CANCELLED,
                               RequestStatus.ABORTED})


@dataclass
class RequestResult:
    """Terminal record of one request (``ServingEngine.result(rid)``):
    ``output`` follows the ``generate()`` contract ``[prompt...,
    generated...]`` for ``COMPLETED`` and is ``None`` otherwise;
    ``detail`` says why a request was shed, cancelled or aborted;
    ``client_id`` is the caller's correlation value from ``submit()``;
    ``ttft_s`` is submit-to-first-token wall time as the host saw it
    (``None`` when no token was produced).

    With ``serving.tracing`` on, the latency breakdown comes from the
    request's span tree: ``queue_s`` (submit → admission start),
    ``prefill_s`` (→ admit dispatched), ``host_s`` (→ first token
    processed: the lag-one event plus host bookkeeping), ``decode_s`` (→
    terminal) and ``latency_s`` (submit → terminal); the phases sum to
    ``latency_s``, and a phase never reached stays ``None``."""
    rid: int
    status: str
    output: Optional[np.ndarray] = None
    detail: str = ""
    client_id: Any = None
    submitted_it: int = 0
    finished_it: Optional[int] = None
    ttft_s: Optional[float] = None
    queue_s: Optional[float] = None
    prefill_s: Optional[float] = None
    decode_s: Optional[float] = None
    host_s: Optional[float] = None
    latency_s: Optional[float] = None


class QueueFull(RuntimeError):
    """``submit()`` backpressure: the bounded queue is at
    ``max_queue_depth`` and the policy is ``reject`` (or ``block`` could
    not make progress)."""


class CircuitOpen(RuntimeError):
    """``submit()`` refused because the dispatch circuit breaker is open
    — the device failed ``breaker_threshold`` consecutive dispatches and
    admission is suspended until the cooldown's half-open probe
    succeeds."""


class DrainTimeout(RuntimeError):
    """``drain()`` exceeded ``drain_timeout_s`` without retiring the
    remaining work; the message carries per-slot diagnostics (slot id,
    request id, last dispatch age)."""


class TokenStream:
    """Subscription to one request's per-token events
    (``ServingEngine.token_events(rid)``), fed at the host mirror's drain
    point — one event behind the device — so time to first token and
    time between tokens are observable without synchronizing the
    dispatch path.  Events are dicts:

    - ``{"event": "token", "rid": r, "index": i, "token": t}`` — the
      ``i``-th generated token (index 0 is the admission's first token);
      a speculative round that commits m tokens pushes m such events;
    - ``{"event": "end", "rid": r, "status": s, "detail": d}`` — the
      typed terminal event, exactly once and last (``PREEMPTED`` for a
      request snapshotted for resume on a restarted server).

    Subscribing replays everything already generated, so the stream is
    lossless whenever the consumer attaches.  ``push`` is the engine's
    side; ``get`` / ``events`` / ``tokens`` may run on any thread.
    ``on_event`` (optional) is called with every event as it is pushed
    and must not block; if it raises, it is dropped (the queue stays
    readable) and ``on_drop(rid, exc)`` is told."""

    def __init__(self, rid, on_event=None, on_drop=None):
        self.rid = rid
        self._q = queue.SimpleQueue()
        self._on_event = on_event
        self._on_drop = on_drop

    def push(self, event):
        self._q.put(event)
        cb = self._on_event
        if cb is None:
            return
        try:
            cb(event)
        except Exception as e:           # noqa: BLE001 — never the producer's
            self._on_event = None
            logger.warning(
                f"serving: token-event subscriber bridge for request "
                f"{self.rid} dropped on {type(e).__name__}: {e} — the "
                f"stream queue stays readable; counted in "
                f"stats['stream_bridge_drops']")
            if self._on_drop is not None:
                self._on_drop(self.rid, e)

    def get(self, timeout=None):
        """The next event (blocking up to ``timeout`` seconds; raises
        :class:`queue.Empty` on expiry)."""
        return self._q.get(timeout=timeout)

    def events(self, timeout=None):
        """Yield events up to and including the ``end`` event;
        ``timeout`` bounds each wait."""
        while True:
            ev = self._q.get(timeout=timeout)
            yield ev
            if ev.get("event") == "end":
                return

    def tokens(self, timeout=None):
        """Drain the stream to its end: ``(token ids, end event)``."""
        toks, end = [], None
        for ev in self.events(timeout=timeout):
            if ev.get("event") == "token":
                toks.append(int(ev["token"]))
            else:
                end = ev
        return toks, end


class CircuitBreaker:
    """Consecutive-dispatch-failure breaker of the serving engine.

    ``threshold <= 0`` disables it (dispatch failures propagate to the
    caller).  Enabled, every failed dispatch is absorbed and counted;
    ``threshold`` consecutive failures OPEN the breaker — new work is
    refused with a reason (:class:`CircuitOpen`) and nothing is
    dispatched until ``cooldown_s`` has passed, when ONE half-open probe
    goes through: success closes the breaker, failure opens it again (and
    restarts the cooldown)."""

    def __init__(self, threshold, cooldown_s):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.consecutive_failures = 0
        self.trips = 0
        self._opened_at = None           # monotonic; None = closed
        self.last_error = ""

    @property
    def enabled(self):
        return self.threshold > 0

    @property
    def open(self):
        return self._opened_at is not None

    def allow_dispatch(self):
        """True when dispatching is permitted: closed, or half-open (the
        cooldown elapsed — the next dispatch is the probe)."""
        if self._opened_at is None:
            return True
        return time.monotonic() - self._opened_at >= self.cooldown_s

    def seconds_until_half_open(self):
        if self._opened_at is None:
            return 0.0
        return max(0.0,
                   self.cooldown_s - (time.monotonic() - self._opened_at))

    def record_success(self):
        self.consecutive_failures = 0
        self._opened_at = None

    def record_failure(self, exc):
        self.consecutive_failures += 1
        self.last_error = f"{type(exc).__name__}: {exc}"
        if self._opened_at is not None \
                or self.consecutive_failures >= self.threshold:
            # a trip, or a failed half-open probe: (re-)open and restart
            # the cooldown
            self._opened_at = time.monotonic()
            self.trips += 1

    def check_submit(self):
        """Raise :class:`CircuitOpen` while open.  Once the cooldown has
        elapsed (half-open) submissions are admitted again — the next
        dispatch is the probe, and a breaker that opened with an empty
        queue would otherwise refuse work forever."""
        if not self.enabled or self.allow_dispatch():
            return
        raise CircuitOpen(
            f"serving circuit breaker OPEN after "
            f"{self.consecutive_failures} consecutive dispatch failures "
            f"(last: {self.last_error}); half-open probe in "
            f"{self.seconds_until_half_open():.1f}s")
