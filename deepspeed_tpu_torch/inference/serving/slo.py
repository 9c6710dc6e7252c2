"""Request lifecycle and per-token streams of the serving engine (the
core-engine part of ``deepspeed_tpu/inference/serving/slo.py``).

A request is ``QUEUED``, then ``PREFILLING`` while its prompt streams into
a slot, then ``RUNNING``, and ends ``COMPLETED`` — or ``CANCELLED``
(:meth:`ServingEngine.cancel`), or ``ABORTED`` when the engine is closed
or a dispatch fails with it in flight.  :class:`TokenStream` carries a
request's generated tokens one event each, then one typed ``end`` event.
Deadlines, the bounded queue, the circuit breaker, drain timeouts and
preemption are not ported yet.
"""

import queue
from dataclasses import dataclass
from typing import Optional

import numpy as np

from deepspeed_tpu_torch.utils.logging import logger


class RequestStatus:
    QUEUED = "QUEUED"
    PREFILLING = "PREFILLING"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    CANCELLED = "CANCELLED"
    ABORTED = "ABORTED"


TERMINAL_STATUSES = frozenset({RequestStatus.COMPLETED,
                               RequestStatus.CANCELLED,
                               RequestStatus.ABORTED})


@dataclass
class RequestResult:
    """Terminal record of one request (``ServingEngine.result(rid)``):
    ``output`` follows the ``generate()`` contract ``[prompt...,
    generated...]`` for ``COMPLETED`` and is ``None`` otherwise;
    ``detail`` says why a request was cancelled or aborted; ``ttft_s`` is
    submit-to-first-token wall time as the host saw it (``None`` when no
    token was produced)."""
    rid: int
    status: str
    output: Optional[np.ndarray] = None
    detail: str = ""
    submitted_it: int = 0
    finished_it: Optional[int] = None
    ttft_s: Optional[float] = None


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
      typed terminal event, exactly once and last.

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
