"""Host-side span tracing and fixed-bucket latency histograms of the
serving engine (port of ``deepspeed_tpu/monitor/trace.py``; the JAX
package's ``docs/observability.md`` tells the whole story).

Two primitives, both pure host bookkeeping — no CUDA call and no device
sync on the observe path, so tracing on or off leaves the served tokens
and the captured CUDA graphs unchanged:

* :class:`SpanTracer` — a bounded ring of finished spans recorded at the
  serving scheduler's seams (submit → queue wait → prefill chunks →
  admit dispatch → decode / spec-propose / spec-verify dispatches →
  terminal), each stamped with the monotonic clock and anchored to the
  wall clock.  :meth:`SpanTracer.to_chrome` renders the ring as Chrome
  trace-event JSON (``"X"`` complete events plus ``"M"`` thread-name
  metadata), loadable in Perfetto / ``chrome://tracing``, one track per
  KV slot plus the scheduler / queue / handler tracks.
* :class:`Histogram` / :class:`HistogramFamily` /
  :class:`ServingHistograms` — fixed-bucket Prometheus histograms
  (cumulative ``_bucket{le=...}`` counts, ``_sum``, ``_count``) for time
  to first token, time between tokens, queue wait, per-program dispatch
  time and engine-lock wait.  The buckets are the JAX package's, fixed at
  construction; ``observe`` takes its own small lock, never the engine
  lock.

The tracer's clock is injectable (``clock=``) so tests drive the
histograms deterministically; timestamps are taken once, where the host
mirror drains, so a late ``TokenStream`` replay never re-stamps them.
"""

import json
import threading
import time
from collections import deque

# Default span-ring bound: ~7 spans per request-lifetime plus 1-3 per
# dispatch; 100k spans ≈ tens of MB and hours of light traffic.
DEFAULT_MAX_SPANS = 100_000

# Latency bucket bounds (seconds) — shared by the TTFT / TBT /
# queue-wait / dispatch-duration histograms.  Fixed so dashboards can
# diff rounds; spans sub-ms host dispatch up to the 60 s shed horizon.
LATENCY_BUCKETS_S = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# Lock-wait buckets (seconds) — contention lives orders of magnitude
# below request latency; the 1 µs floor resolves uncontended acquires.
LOCK_WAIT_BUCKETS_S = (1e-6, 1e-5, 1e-4, 1e-3, 0.01, 0.1, 1.0)

# The histogram series the serving engine exports through ``/metrics``
# when ``serving.tracing`` is on (the JAX package's names).
HISTOGRAM_SERIES = (
    "dstpu_serving_ttft_seconds",
    "dstpu_serving_tbt_seconds",
    "dstpu_serving_queue_wait_seconds",
    "dstpu_serving_dispatch_seconds",
    "dstpu_serving_lock_acquire_wait_seconds",
)


class Histogram:
    """One fixed-bucket Prometheus histogram.  ``observe`` is safe from
    any thread (its own tiny lock, never the engine lock); ``collect``
    returns the cumulative exposition samples."""

    __slots__ = ("buckets", "counts", "sum", "count", "_lock")

    def __init__(self, buckets):
        self.buckets = tuple(float(b) for b in buckets)
        assert list(self.buckets) == sorted(self.buckets), \
            "histogram buckets must be ascending"
        self.counts = [0] * len(self.buckets)     # per-bucket (not cum.)
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, v):
        v = float(v)
        with self._lock:
            self.sum += v
            self.count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1
                    break

    def collect(self, labels=None):
        """``[(suffix, extra_labels, value), ...]`` exposition samples —
        cumulative ``_bucket`` counts (incl. ``+Inf``), ``_sum``,
        ``_count``.  ``labels``: dict merged into every sample."""
        base = dict(labels or {})
        with self._lock:
            counts = list(self.counts)
            total, s = self.count, self.sum
        out, cum = [], 0
        for b, c in zip(self.buckets, counts):
            cum += c
            out.append(("_bucket", {**base, "le": repr(b)}, cum))
        out.append(("_bucket", {**base, "le": "+Inf"}, total))
        out.append(("_sum", base, s))
        out.append(("_count", base, total))
        return out

    def snapshot(self):
        with self._lock:
            return {"count": self.count, "sum": self.sum,
                    "counts": list(self.counts)}


class HistogramFamily:
    """Same-bucket histograms keyed by one label value (e.g. the
    dispatch program name).  Children are created lazily under the
    family lock; each child observes under its own."""

    def __init__(self, label, buckets):
        self.label = label
        self.buckets = tuple(buckets)
        self._children = {}
        self._lock = threading.Lock()

    def child(self, value):
        value = str(value)
        h = self._children.get(value)
        if h is None:
            with self._lock:
                h = self._children.setdefault(value,
                                              Histogram(self.buckets))
        return h

    def observe(self, value, v):
        self.child(value).observe(v)

    def collect(self):
        with self._lock:
            items = sorted(self._children.items())
        out = []
        for value, h in items:
            out.extend(h.collect(labels={self.label: value}))
        return out


class ServingHistograms:
    """The serving engine's histogram set (``serving.tracing``),
    exported through ``/metrics`` as the :data:`HISTOGRAM_SERIES`
    families.  All internally locked — the HTTP scrape thread never
    takes the engine lock to render them."""

    def __init__(self):
        self.ttft = Histogram(LATENCY_BUCKETS_S)
        self.tbt = Histogram(LATENCY_BUCKETS_S)
        self.queue_wait = Histogram(LATENCY_BUCKETS_S)
        self.dispatch = HistogramFamily("program", LATENCY_BUCKETS_S)
        self.lock_wait = HistogramFamily("thread_class",
                                         LOCK_WAIT_BUCKETS_S)

    def collect(self):
        """``[(series_name, help, samples), ...]`` for the Prometheus
        renderer; ``samples`` are ``(suffix, labels, value)``."""
        return [
            ("dstpu_serving_ttft_seconds",
             "submit-to-first-token wall time per request",
             self.ttft.collect()),
            ("dstpu_serving_tbt_seconds",
             "time between consecutive committed tokens, per request",
             self.tbt.collect()),
            ("dstpu_serving_queue_wait_seconds",
             "submit-to-admission-start wait per request",
             self.queue_wait.collect()),
            ("dstpu_serving_dispatch_seconds",
             "host dispatch duration per program",
             self.dispatch.collect()),
            ("dstpu_serving_lock_acquire_wait_seconds",
             "per-acquire engine-lock wait by thread class",
             self.lock_wait.collect()),
        ]


class SpanTracer:
    """Bounded ring of finished spans with Chrome trace-event export.

    ``add`` records one complete span (``t1=None`` = instant event);
    timestamps come from :meth:`now` — the injectable monotonic clock —
    and the wall-clock epoch of the tracer's construction anchors the
    export.  The caller provides external synchronization for ``add``
    (the serving engine records lock-held); ``to_chrome``/``dump`` take
    a point-in-time copy."""

    def __init__(self, max_spans=DEFAULT_MAX_SPANS, clock=time.monotonic,
                 wallclock=time.time):
        self._clock = clock
        self._t0 = clock()               # monotonic epoch
        self.wall_t0 = wallclock()       # wall-clock anchor of _t0
        self._spans = deque(maxlen=int(max_spans))
        self.added = 0                   # total, incl. ring-dropped

    def now(self):
        """The tracer's monotonic clock (injectable for tests)."""
        return self._clock()

    def add(self, name, cat, t0, t1=None, track="scheduler", **args):
        """Record one finished span: ``[t0, t1]`` on ``track`` (a slot
        id int or a named thread track), with ``args`` attached
        (rid/client_id/slot/priority/phase...).  ``None`` args are
        dropped so exports stay compact."""
        self.added += 1
        self._spans.append(
            (name, cat, float(t0),
             None if t1 is None else float(t1), track,
             {k: v for k, v in args.items() if v is not None}))

    @property
    def dropped(self):
        return self.added - len(self._spans)

    def span_snapshot(self):
        """A point-in-time ``(spans, added)`` copy of the span ring —
        take it under whatever lock guards ``add`` (the serving
        engine's), then render/serialize OUTSIDE it:
        :meth:`to_chrome`/:meth:`dump` on a 100k-span ring build tens
        of MB of JSON, far too long to stall the scheduler for.  The
        paired ``added`` counter keeps the export's ``dropped`` figure
        consistent with the copy: spans recorded AFTER the snapshot
        must not read as ring-dropped."""
        return list(self._spans), self.added

    def to_chrome(self, spans=None):
        """The Chrome trace-event JSON object (``{"traceEvents": [...]}``
        — the Perfetto-loadable format): one ``pid``, a ``tid`` per
        track (scheduler / queue / handler threads, then one per slot),
        ``"X"`` complete events in microseconds, ``"M"`` thread-name
        metadata, and the wall-clock anchor under ``otherData``.
        ``spans``: a :meth:`span_snapshot` tuple taken lock-held;
        ``None`` copies the live ring (single-threaded callers
        only)."""
        spans, added = self.span_snapshot() if spans is None else spans
        tids, events = {}, []

        def tid_for(track):
            t = tids.get(track)
            if t is None:
                t = tids[track] = len(tids)
                name = f"slot {track}" if isinstance(track, int) \
                    else str(track)
                events.append({"ph": "M", "pid": 1, "tid": t,
                               "name": "thread_name",
                               "args": {"name": name}})
            return t

        # stable track order: the named threads first, slots ascending
        for track in ("scheduler", "queue"):
            tid_for(track)
        for track in sorted({s[4] for s in spans
                             if isinstance(s[4], int)}):
            tid_for(track)
        for name, cat, t0, t1, track, args in spans:
            ev = {"name": name, "cat": cat, "pid": 1,
                  "tid": tid_for(track),
                  "ts": round((t0 - self._t0) * 1e6, 3)}
            if t1 is None:
                ev["ph"] = "i"
                ev["s"] = "t"            # thread-scoped instant
            else:
                ev["ph"] = "X"
                ev["dur"] = round(max(t1 - t0, 0.0) * 1e6, 3)
            if args:
                ev["args"] = args
            events.append(ev)
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {"wall_t0": self.wall_t0,
                              "spans": len(spans),
                              "dropped": added - len(spans)}}

    def dump(self, path, spans=None):
        """Write :meth:`to_chrome` to ``path``; returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(spans=spans), f)
        return path


__all__ = ["SpanTracer", "Histogram", "HistogramFamily",
           "ServingHistograms", "LATENCY_BUCKETS_S",
           "LOCK_WAIT_BUCKETS_S", "HISTOGRAM_SERIES",
           "DEFAULT_MAX_SPANS"]
