"""Serving flight recorder (port of
``deepspeed_tpu/inference/serving/flightrec.py``): a bounded ring of the
scheduler's recent structured events that dumps itself to a JSON file at
the moments a serving process is least able to explain itself.

Every dispatch begin / end, scheduler decision (admit, shed, cancel,
abort, stall), breaker transition, lock-wait sample and fault-injection
hit is appended as a plain dict with a sequence number, monotonic and
wall timestamps, and the recording thread's name.

* **Own lock.**  The ring has its own lock, never the engine lock, so a
  reader (``GET /debug/flightrec``, SIGUSR2, a crash-path dump) never
  contends the scheduler, and ``record()`` is a constant-time append.
* **Bounded.**  Old events fall off; ``dropped`` counts them.
* **Dump on distress.**  The serving engine dumps at breaker-open,
  ``DrainTimeout``, ``ConcurrencyViolation`` and scheduler-thread death;
  the HTTP front end adds ``GET /debug/flightrec`` and a SIGUSR2
  handler.  ``dump`` swallows nothing: callers on crash paths wrap it, so
  a failing dump never masks the fault it records.
"""

import json
import os
import tempfile
import threading
import time
from collections import deque

DEFAULT_MAX_EVENTS = 2048


def default_dump_dir():
    """Where auto-dumps land when ``serving.flight_recorder_dir`` is
    unset: a per-user directory under the system temp root."""
    return os.path.join(tempfile.gettempdir(), "dstpu_flightrec")


class FlightRecorder:
    """Bounded, self-locked ring of structured serving events."""

    def __init__(self, max_events=DEFAULT_MAX_EVENTS, dump_dir=None,
                 clock=time.monotonic, wallclock=time.time):
        self._events = deque(maxlen=int(max_events))
        # RLock, deliberately: the SIGUSR2 dump handler runs on the
        # main thread and may interrupt that SAME thread inside
        # record()'s critical section — a plain Lock would self-
        # deadlock the handler (and wedge every other recorder).  The
        # re-entrant snapshot can at worst observe the interrupted
        # append as one transiently-dropped event, which a debug dump
        # tolerates.
        self._lock = threading.RLock()
        self._clock = clock
        self._wallclock = wallclock
        self._seq = 0
        self._dump_seq = 0
        self.dump_dir = dump_dir or default_dump_dir()
        self.last_dump_path = None       # newest auto/manual dump

    def record(self, ev, **fields):
        """Append one event (``ev`` = kind tag, ``fields`` = structured
        payload; ``None`` values dropped).  Constant time, own lock."""
        entry = {"ev": ev, "t_mono": round(self._clock(), 6),
                 "t_wall": round(self._wallclock(), 6),
                 "thread": threading.current_thread().name}
        entry.update((k, v) for k, v in fields.items() if v is not None)
        with self._lock:
            self._seq += 1
            entry["seq"] = self._seq
            self._events.append(entry)

    def snapshot(self):
        """Point-in-time copy: ``{"events": [...], "recorded": total,
        "dropped": fell-off-the-ring}`` — oldest first."""
        with self._lock:
            events = list(self._events)
            seq = self._seq
        return {"events": events, "recorded": seq,
                "dropped": seq - len(events)}

    def dump(self, reason, path=None):
        """Write the snapshot (plus the dump reason and pid) as JSON to
        ``path`` — default: ``<dump_dir>/flightrec_<reason>_<pid>_<n>
        .json`` — and return the path.  Callers on crash paths wrap
        this in try/except: a failing dump must never mask the fault
        being recorded."""
        snap = self.snapshot()
        snap["reason"] = reason
        snap["pid"] = os.getpid()
        snap["dumped_at_wall"] = self._wallclock()
        if path is None:
            os.makedirs(self.dump_dir, exist_ok=True)
            with self._lock:
                self._dump_seq += 1
                n = self._dump_seq
            safe = "".join(c if c.isalnum() or c in "-_" else "_"
                           for c in str(reason))[:48]
            path = os.path.join(
                self.dump_dir,
                f"flightrec_{safe}_{os.getpid()}_{n}.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(snap, f)
        os.replace(tmp, path)            # a reader never sees a torn dump
        self.last_dump_path = path
        return path


__all__ = ["FlightRecorder", "DEFAULT_MAX_EVENTS", "default_dump_dir"]
