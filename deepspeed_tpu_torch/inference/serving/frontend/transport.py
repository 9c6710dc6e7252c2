"""Asyncio HTTP front end of the serving engine (port of
``deepspeed_tpu/inference/serving/frontend/transport.py``).  Standard
library only: an ``asyncio`` HTTP/1.1 server on 127.0.0.1.

Endpoints
---------
- ``POST /v1/generate`` — submit one request.  JSON body::

      {"input_ids": [...], "max_new_tokens": 32, "eos_token_id": -1,
       "deadline_s": null, "client_id": "tenant-a", "priority": 0,
       "stream": false}

  Blocking (the default): answers once the request reaches a terminal
  status with ``{"rid", "status", "output", "detail", "ttft_s",
  "client_id"}``.  ``"stream": true``: answers at once with
  ``Transfer-Encoding: chunked`` ``application/x-ndjson``, one JSON line
  per token event as the host mirror drains it (``{"event": "token",
  "rid", "index", "token"}``), then exactly one ``{"event": "end", "rid",
  "status", "detail"}``.  A client that disconnects mid-stream cancels its
  request.
- ``GET /v1/requests/<rid>`` — status (``404`` for an id never issued);
  a terminal request carries its result.
- ``DELETE /v1/requests/<rid>`` — cancel (``404`` unknown; ``200`` with
  ``{"cancelled": bool}``).
- ``GET /healthz`` — the engine's ``health_snapshot()`` and uptime
  (``503`` once the engine is closed).
- ``GET /metrics`` — Prometheus text (``dstpu_serving_*``, the series of
  the JAX package): the engine's counters, the per-client fairness
  balances, the last device-memory sample, and with tracing the
  histograms.  Every series has ``# HELP`` / ``# TYPE`` lines and label
  values are escaped.
- ``GET /debug/flightrec`` — the flight-recorder ring (``404`` unless
  ``serving.flight_recorder``).  SIGUSR2 dumps it to a file.
- ``POST /debug/profile?secs=N`` — a ``torch.profiler`` capture of N
  seconds (at most 60) of everything the process runs, CPU and CUDA,
  written as a Chrome trace (``404`` unless ``serving.profile_endpoint``;
  ``409`` while another runs); answers with its path.

Errors: over quota / full queue → ``429``, open breaker / closed engine →
``503``, malformed request → ``400``, unknown id → ``404``.

Threads
-------
1. The **asyncio loop thread** parses HTTP and writes responses; it calls
   the engine's thread-safe surface only through ``run_in_executor``, so
   a blocked submit never stalls the loop.
2. The **scheduler thread** claims the engine's owner role
   (``bind_owner()``) before the port is bound, and is the only caller of
   ``step()`` / ``preempt()``: every CUDA call of the engine runs there.
   Idle, it sleeps on ``srv.wake``.
3. Engine → loop: the ``token_events`` hook hands each event over with
   ``loop.call_soon_threadsafe``.

Nothing here calls the device.  ``/debug/profile`` has the scheduler
thread start and stop the profiler between two of its steps
(:meth:`ServingHTTPFrontend.on_scheduler`), so neither meets a CUDA graph
capture and no other thread calls CUDA; the stop, which collects the
records, holds the scheduler for as long as it takes.

SIGTERM (``install_signal_handlers()``, main thread only) or
:meth:`ServingHTTPFrontend.request_preempt` (any thread) asks for a
graceful preemption: the scheduler thread stops admitting, drains under
the config's budget, snapshots the undrained requests crash-atomically
(fairness balances and priorities included), and every open stream ends
with a typed ``PREEMPTED`` event.  A restarted server ``restore()``s
them.
"""

import asyncio
import concurrent.futures
import json
import math
import os
import queue
import signal
import tempfile
import threading
import time
import urllib.parse

import numpy as np

from deepspeed_tpu_torch.inference.serving.slo import (CircuitOpen,
                                                       QueueFull,
                                                       RequestStatus,
                                                       TERMINAL_STATUSES)
from deepspeed_tpu_torch.utils.logging import logger

_MAX_BODY = 8 << 20                      # request bodies past this: 413


class _HTTPError(Exception):
    def __init__(self, code, message):
        super().__init__(message)
        self.code = code


_STATUS_TEXT = {200: "OK", 400: "Bad Request", 404: "Not Found",
                405: "Method Not Allowed", 408: "Request Timeout",
                413: "Payload Too Large", 429: "Too Many Requests",
                500: "Internal Server Error", 503: "Service Unavailable"}


class ServingHTTPFrontend:
    """Asyncio HTTP server over one :class:`ServingEngine`.

    ``port=0`` binds an ephemeral port (read ``self.port`` after
    :meth:`start`).  ``snapshot_dir`` is where a preemption publishes its
    snapshot — without it a preempt request closes the engine (undrained
    work ``ABORTED``, never silently lost).  ``profile_dir`` is where
    ``/debug/profile`` writes its traces (default: a fresh temporary
    directory per capture).  Use as a context manager or call
    :meth:`start` / :meth:`shutdown`::

        with ServingHTTPFrontend(srv, snapshot_dir=d) as fe:
            requests.post(f"http://127.0.0.1:{fe.port}/v1/generate", ...)
    """

    def __init__(self, srv, host="127.0.0.1", port=0, snapshot_dir=None,
                 idle_poll_s=0.05, max_body_bytes=_MAX_BODY,
                 profile_dir=None):
        self.srv = srv
        self.host = host
        self.port = int(port)
        self.snapshot_dir = snapshot_dir
        self.profile_dir = profile_dir
        self.idle_poll_s = float(idle_poll_s)
        self.max_body_bytes = int(max_body_bytes)
        self._loop = None
        self._server = None
        self._loop_thread = None
        self._sched_thread = None
        self._stop = threading.Event()
        self._preempt = threading.Event()
        self._profile_lock = threading.Lock()   # one capture at a time
        # work for the scheduler thread, run between two of its steps
        self._owner_tasks = queue.Queue()
        self._sched_error = None
        self.preempt_result = None       # (tag, rids, finished) after SIGTERM
        self._t0 = time.monotonic()
        self._prev_handlers = {}

    # ------------------------------------------------------------------ #
    # Lifecycle
    # ------------------------------------------------------------------ #
    def start(self):
        """Start the scheduler-owner thread (which claims the engine's
        owner role), then bind the port and the asyncio loop thread —
        in that order, so no HTTP request can race the ownership claim
        (a blocked ``queue_policy="block"`` submit would otherwise bind
        ITSELF as owner and wedge the scheduler).  Returns ``self``
        (``self.port`` holds the bound port)."""
        if self._loop is not None:
            raise RuntimeError("ServingHTTPFrontend already started")
        self._owner_ready = threading.Event()
        self._sched_thread = threading.Thread(
            target=self._scheduler_loop, name="dstpu-serving-scheduler",
            daemon=True)
        self._sched_thread.start()
        if not self._owner_ready.wait(timeout=30):
            self._stop.set()             # unwind the scheduler thread
            self.srv.wake.set()
            raise RuntimeError(
                "scheduler thread failed to claim the engine's owner "
                "role — was the engine already driven by another thread? "
                f"({self._sched_error})")
        if self._sched_error is not None:
            raise RuntimeError(f"scheduler thread failed to start: "
                               f"{self._sched_error}")
        self._loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(
            target=self._run_loop, name="dstpu-http-loop", daemon=True)
        self._loop_thread.start()
        fut = asyncio.run_coroutine_threadsafe(self._start_server(),
                                               self._loop)
        try:
            fut.result(timeout=30)
        except Exception:
            # e.g. the port is already bound: unwind BOTH threads — the
            # scheduler releases its owner binding on exit, so a retry
            # frontend (or the caller driving step() directly) can claim
            # the engine instead of finding it wedged forever
            self._stop.set()
            self.srv.wake.set()
            self._sched_thread.join(timeout=10)
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._loop_thread.join(timeout=10)
            raise
        logger.info(f"[serving] HTTP front end listening on "
                    f"{self.host}:{self.port}")
        return self

    def _run_loop(self):
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_forever()
        finally:
            self._loop.close()

    async def _start_server(self):
        # the StreamReader limit must cover the largest allowed body:
        # readexactly() on a body larger than the buffer limit deadlocks
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port,
            limit=self.max_body_bytes + 65536)
        self.port = self._server.sockets[0].getsockname()[1]

    def request_preempt(self):
        """Ask the scheduler thread to preempt gracefully (the SIGTERM
        path, callable from any thread/signal handler — sets a flag and
        wakes the owner; never touches the engine directly)."""
        self._preempt.set()
        self.srv.wake.set()

    def install_signal_handlers(self, signals=(signal.SIGTERM,)):
        """Route SIGTERM to :meth:`request_preempt` (main thread only —
        CPython restricts ``signal.signal``).  Previous handlers are
        restored by :meth:`shutdown`.  When the engine carries a flight
        recorder, SIGUSR2 additionally dumps its ring to a file (the
        recorder never takes the engine lock, so the dump is safe from a
        signal frame)."""
        for sig in signals:
            self._prev_handlers[sig] = signal.signal(
                sig, lambda *_: self.request_preempt())
        if getattr(self.srv, "flightrec_enabled", False):
            self.install_flightrec_signal_handler()

    def install_flightrec_signal_handler(self, sig=None):
        """Route SIGUSR2 (or ``sig``) to a flight-recorder dump.  Main
        thread only; restored by :meth:`shutdown`."""
        sig = sig if sig is not None else signal.SIGUSR2
        self._prev_handlers[sig] = signal.signal(
            sig, lambda *_: self._dump_flightrec_signal())

    def _dump_flightrec_signal(self):
        try:
            path = self.srv.dump_flightrec(reason="sigusr2")
            logger.warning(f"[serving] SIGUSR2: flight recorder dumped "
                           f"to {path}")
        except Exception as e:           # noqa: BLE001 — signal frame
            logger.warning(f"[serving] SIGUSR2 flight-recorder dump "
                           f"failed: {type(e).__name__}: {e}")

    def _scheduler_loop(self):
        """The one scheduler owner: drives ``step()`` while work is
        pending, sleeps on ``srv.wake`` when idle, and runs the graceful
        preemption on request."""
        srv = self.srv
        try:
            srv.bind_owner()             # before any request can arrive
        except Exception as e:           # noqa: BLE001
            self._sched_error = f"{type(e).__name__}: {e}"
            self._owner_ready.set()
            return
        self._owner_ready.set()
        try:
            while not self._stop.is_set():
                self._run_owner_tasks()
                if self._preempt.is_set():
                    self._do_preempt()
                    return
                if srv.work_pending():   # one lock round-trip, not three
                    srv.step()
                else:
                    srv.wake.wait(timeout=self.idle_poll_s)
                    srv.wake.clear()
        except Exception as e:           # noqa: BLE001 — surfaced via healthz
            self._sched_error = f"{type(e).__name__}: {e}"
            logger.error(f"[serving] scheduler thread died: "
                         f"{self._sched_error}")
            # a dead scheduler is exactly what the flight recorder
            # exists for: dump the ring BEFORE close() clears the scene
            try:
                if getattr(srv, "flightrec_enabled", False):
                    srv._flightrec.record("scheduler_thread_death",
                                          error=self._sched_error[:200])
                    srv.dump_flightrec(reason="scheduler_thread_death")
            except Exception:            # noqa: BLE001 — best effort
                pass
            # nothing will drive the engine again: close it so every
            # in-flight request ends with a typed ABORTED event (waiting
            # handlers unblock) and new submits get 503 instead of
            # queueing into a void
            try:
                srv.close()
            except Exception as ce:      # noqa: BLE001
                logger.error(f"[serving] close after scheduler death "
                             f"failed: {type(ce).__name__}: {ce}")
        finally:
            # the exiting owner releases its binding so a successor
            # driver (a retry frontend after a failed start(), or the
            # caller after shutdown(close_engine=False)) can claim the
            # engine instead of finding it bound to a dead thread
            try:
                srv.release_owner()
            except Exception:            # noqa: BLE001
                pass
            self._cancel_owner_tasks()

    def on_scheduler(self, fn, timeout=60.0):
        """Run ``fn()`` on the scheduler thread between two of its steps
        (where it may call the device) and return its result; raises
        ``TimeoutError`` past ``timeout`` seconds, and
        ``concurrent.futures.CancelledError`` when the scheduler thread
        ends first."""
        fut = concurrent.futures.Future()
        self._owner_tasks.put((fn, fut))
        self.srv.wake.set()
        if not self._sched_thread.is_alive():
            self._cancel_owner_tasks()
        return fut.result(timeout=timeout)

    def _run_owner_tasks(self):
        while True:
            try:
                fn, fut = self._owner_tasks.get_nowait()
            except queue.Empty:
                return
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except BaseException as e:   # noqa: BLE001 — the caller's
                fut.set_exception(e)

    def _cancel_owner_tasks(self):
        while True:
            try:
                _, fut = self._owner_tasks.get_nowait()
            except queue.Empty:
                return
            fut.cancel()

    def _do_preempt(self):
        srv = self.srv
        try:
            if self.snapshot_dir:
                self.preempt_result = srv.preempt(self.snapshot_dir)
                tag, snapped, _ = self.preempt_result
                logger.warning(f"[serving] HTTP front end preempted — "
                               f"snapshot {tag!r} holds {len(snapped)} "
                               f"request(s)")
            else:
                logger.warning("[serving] preempt requested with no "
                               "snapshot_dir — closing (undrained work "
                               "ABORTED, typed status preserved)")
                srv.close()
        except Exception as e:           # noqa: BLE001
            self._sched_error = f"{type(e).__name__}: {e}"
            logger.error(f"[serving] preempt failed: {self._sched_error}")
            try:                         # same rationale as scheduler death
                srv.close()
            except Exception:            # noqa: BLE001
                pass

    def shutdown(self, close_engine=False):
        """Stop the scheduler thread, close the listener and the loop;
        ``close_engine=True`` also retires the engine (undrained work
        ABORTED).  Idempotent."""
        self._stop.set()
        self.srv.wake.set()
        if self._sched_thread is not None:
            self._sched_thread.join(timeout=30)
        if self._loop is not None and not self._loop.is_closed():
            async def _close():
                self._server.close()
                await self._server.wait_closed()
                # keep-alive connections park in readuntil() waiting for
                # a next request that will never come — cancel them so
                # the loop stops clean instead of destroying live tasks
                mine = asyncio.current_task()
                pending = [t for t in asyncio.all_tasks()
                           if t is not mine]
                for t in pending:
                    t.cancel()
                await asyncio.gather(*pending, return_exceptions=True)
            try:
                asyncio.run_coroutine_threadsafe(
                    _close(), self._loop).result(timeout=10)
            except Exception:            # noqa: BLE001 — already closing
                pass
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._loop_thread.join(timeout=10)
        for sig, prev in self._prev_handlers.items():
            signal.signal(sig, prev)
        self._prev_handlers.clear()
        if close_engine:
            self.srv.close()             # idempotent; takes its own lock

    def join_preempted(self, timeout=60):
        """Block until the scheduler thread has finished a requested
        preemption (snapshot published); returns ``preempt_result``."""
        self._sched_thread.join(timeout=timeout)
        if self._sched_thread.is_alive():
            raise TimeoutError("scheduler thread still running — "
                               "preemption did not complete")
        return self.preempt_result

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # ------------------------------------------------------------------ #
    # HTTP plumbing
    # ------------------------------------------------------------------ #
    async def _handle_conn(self, reader, writer):
        try:
            while True:
                try:
                    req = await self._read_request(reader)
                except _HTTPError as e:
                    # malformed head / oversized body: the request
                    # framing can't be trusted past this point — answer
                    # the error, then drop the connection
                    await self._respond(writer, e.code,
                                        {"error": str(e)})
                    break
                if req is None:
                    break
                keep_alive = await self._route(req, writer)
                if not keep_alive:
                    break
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.LimitOverrunError):
            pass                         # client went away / oversized head
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _read_request(self, reader):
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.IncompleteReadError:
            return None                  # clean EOF between requests
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, path, _version = lines[0].split(" ", 2)
        except ValueError:
            raise _HTTPError(400, f"malformed request line: {lines[0]!r}")
        headers = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        raw_n = headers.get("content-length")
        try:
            n = int(raw_n) if raw_n else 0
        except ValueError:
            raise _HTTPError(400, f"malformed Content-Length: {raw_n!r}")
        if n < 0:
            raise _HTTPError(400, f"negative Content-Length: {raw_n!r}")
        if n > self.max_body_bytes:
            raise _HTTPError(413, f"body of {n} bytes exceeds the "
                                  f"{self.max_body_bytes}-byte limit")
        body = await reader.readexactly(n) if n else b""
        return {"method": method.upper(), "path": path,
                "headers": headers, "body": body}

    @staticmethod
    def _head(code, ctype, extra=""):
        return (f"HTTP/1.1 {code} {_STATUS_TEXT.get(code, 'Unknown')}\r\n"
                f"Content-Type: {ctype}\r\n{extra}")

    async def _respond(self, writer, code, payload, ctype=None):
        if isinstance(payload, (dict, list)):
            body = (json.dumps(payload) + "\n").encode()
            ctype = ctype or "application/json"
        else:
            body = payload if isinstance(payload, bytes) \
                else str(payload).encode()
            ctype = ctype or "text/plain; charset=utf-8"
        writer.write(self._head(code, ctype).encode()
                     + f"Content-Length: {len(body)}\r\n"
                       f"Connection: keep-alive\r\n\r\n".encode() + body)
        await writer.drain()
        return True

    async def _route(self, req, writer):
        method = req["method"]
        path, _, query = req["path"].partition("?")
        try:
            if path == "/v1/generate" and method == "POST":
                return await self._generate(req, writer)
            if path == "/healthz" and method == "GET":
                return await self._healthz(writer)
            if path == "/metrics" and method == "GET":
                return await self._metrics(writer)
            if path == "/debug/flightrec" and method == "GET":
                return await self._debug_flightrec(writer)
            if path == "/debug/profile" and method == "POST":
                return await self._debug_profile(query, writer)
            if path.startswith("/v1/requests/"):
                return await self._request_resource(method, path, writer)
            return await self._respond(
                writer, 404, {"error": f"no route {method} {path}"})
        except _HTTPError as e:
            return await self._respond(writer, e.code, {"error": str(e)})
        except (ConnectionError, asyncio.IncompleteReadError):
            raise
        except Exception as e:           # noqa: BLE001 — 500, keep serving
            logger.error(f"[serving] handler error on {method} {path}: "
                         f"{type(e).__name__}: {e}")
            try:
                return await self._respond(
                    writer, 500, {"error": f"{type(e).__name__}: {e}"})
            except (ConnectionError, OSError):
                return False

    # ------------------------------------------------------------------ #
    # /v1/generate
    # ------------------------------------------------------------------ #
    def _parse_generate(self, body):
        try:
            spec = json.loads(body.decode() or "{}")
        except (ValueError, UnicodeDecodeError) as e:
            raise _HTTPError(400, f"request body is not JSON: {e}")
        if not isinstance(spec, dict):
            raise _HTTPError(400, "request body must be a JSON object")
        ids = spec.get("input_ids")
        if not isinstance(ids, list) or not ids \
                or not all(isinstance(t, int) for t in ids):
            raise _HTTPError(400, "input_ids: non-empty list of ints "
                                  "required")
        known = {"input_ids", "max_new_tokens", "eos_token_id",
                 "deadline_s", "client_id", "priority", "stream"}
        unknown = set(spec) - known
        if unknown:
            raise _HTTPError(400, f"unknown field(s) {sorted(unknown)} — "
                                  f"accepted: {sorted(known)}")
        return spec

    def _submit_from_spec(self, spec):
        """Engine submit with the HTTP error mapping (runs in an
        executor thread: queue_policy='block' may wait here)."""
        try:
            return self.srv.submit(
                np.asarray(spec["input_ids"], np.int32),
                max_new_tokens=int(spec.get("max_new_tokens", 32)),
                eos_token_id=int(spec.get("eos_token_id", -1)),
                deadline_s=spec.get("deadline_s"),
                client_id=spec.get("client_id"),
                priority=int(spec.get("priority", 0)))
        except QueueFull as e:           # over quota / full queue
            raise _HTTPError(429, str(e))
        except CircuitOpen as e:
            raise _HTTPError(503, str(e))
        except (TypeError, ValueError) as e:
            raise _HTTPError(400, str(e))
        except RuntimeError as e:        # closed engine
            raise _HTTPError(503, str(e))

    def _result_payload(self, rid):
        res = self.srv.result(rid)
        if res is None:                  # PREEMPTED ends without a result
            return {"rid": rid, "status": self.srv.status(rid),
                    "output": None, "detail": "", "ttft_s": None,
                    "client_id": None}
        return {"rid": rid, "status": res.status,
                "output": res.output.tolist()
                if res.output is not None else None,
                "detail": res.detail, "ttft_s": res.ttft_s,
                "client_id": res.client_id}

    async def _generate(self, req, writer):
        spec = self._parse_generate(req["body"])
        loop = asyncio.get_running_loop()
        if not spec.get("stream"):
            rid = await loop.run_in_executor(
                None, self._submit_from_spec, spec)
            done = asyncio.Event()

            def on_ev(ev, _loop=loop, _done=done):
                # called under the engine lock — hand off, never block
                if ev.get("event") == "end":
                    _loop.call_soon_threadsafe(_done.set)

            # engine calls take the engine lock, which the scheduler
            # thread holds across step() — keep them off the loop thread
            await loop.run_in_executor(
                None, self.srv.token_events, rid, on_ev)
            await done.wait()
            payload = await loop.run_in_executor(
                None, self._result_payload, rid)
            return await self._respond(writer, 200, payload)
        # streaming: subscribe BEFORE any await so no event can slip
        # between submit and subscription (token_events replays anyway —
        # this just keeps the replay empty in the common case)
        rid = await loop.run_in_executor(
            None, self._submit_from_spec, spec)
        q = asyncio.Queue()

        def on_ev(ev, _loop=loop, _q=q):
            _loop.call_soon_threadsafe(_q.put_nowait, ev)

        await loop.run_in_executor(
            None, self.srv.token_events, rid, on_ev)
        writer.write(
            self._head(200, "application/x-ndjson",
                       "Transfer-Encoding: chunked\r\n"
                       "Connection: close\r\n"
                       "X-Accel-Buffering: no\r\n").encode() + b"\r\n")
        try:
            while True:
                ev = await q.get()
                line = (json.dumps(ev) + "\n").encode()
                writer.write(f"{len(line):x}\r\n".encode() + line
                             + b"\r\n")
                await writer.drain()     # flush per token event
                if ev.get("event") == "end":
                    break
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        except (ConnectionError, OSError):
            # client hung up mid-stream: release its slot
            def _cancel():
                try:
                    self.srv.cancel(rid)
                except KeyError:
                    pass
            await loop.run_in_executor(None, _cancel)
            return False
        return False                     # Connection: close after a stream

    # ------------------------------------------------------------------ #
    # /v1/requests/<rid>
    # ------------------------------------------------------------------ #
    async def _request_resource(self, method, path, writer):
        tail = path[len("/v1/requests/"):]
        try:
            rid = int(tail)
        except ValueError:
            raise _HTTPError(400, f"request id must be an int, got "
                                  f"{tail!r}")
        srv = self.srv
        loop = asyncio.get_running_loop()
        if method == "GET":
            def _status_payload():
                status = srv.status(rid)
                payload = {"rid": rid, "status": status}
                if status in TERMINAL_STATUSES \
                        or status == RequestStatus.PREEMPTED:
                    payload.update(self._result_payload(rid))
                return payload
            try:
                payload = await loop.run_in_executor(
                    None, _status_payload)
            except KeyError as e:
                raise _HTTPError(404, str(e))
            return await self._respond(writer, 200, payload)
        if method == "DELETE":
            def _cancel_payload():
                return {"rid": rid, "cancelled": bool(srv.cancel(rid)),
                        "status": srv.status(rid)}
            try:
                payload = await loop.run_in_executor(
                    None, _cancel_payload)
            except KeyError as e:
                raise _HTTPError(404, str(e))
            return await self._respond(writer, 200, payload)
        raise _HTTPError(405, f"{method} not allowed on {path}")

    # ------------------------------------------------------------------ #
    # /healthz and /metrics
    # ------------------------------------------------------------------ #
    async def _healthz(self, writer):
        # one locked engine snapshot, taken off the loop thread: unlocked
        # field reads would race the scheduler, and a lock taken on the
        # loop thread would block the loop across a step()
        snap = await asyncio.get_running_loop().run_in_executor(
            None, self.srv.health_snapshot)
        payload = {
            "ok": not snap["closed"] and self._sched_error is None,
            "uptime_s": round(time.monotonic() - self._t0, 3),
            **snap,
            "scheduler_error": self._sched_error,
        }
        return await self._respond(
            writer, 503 if snap["closed"] else 200, payload)

    @staticmethod
    def _esc_label(v):
        """Prometheus text-format label-value escaping: backslash,
        double quote and newline (exposition-format spec)."""
        return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    @staticmethod
    def _esc_help(v):
        """HELP-line escaping: backslash and newline."""
        return str(v).replace("\\", "\\\\").replace("\n", "\\n")

    def _metrics_body(self):
        """Render the Prometheus text (in an executor thread; the snapshot
        is taken under the engine lock — the scheduler grows ``stats`` and
        the fairness tracker compacts its map in place).  The memory
        series are the scheduler's last sample (none before its first
        step): sampling reads the device, which only the owner thread
        does.  Every series has ``# HELP`` / ``# TYPE``; label values are
        escaped."""
        srv = self.srv
        with srv._lock:
            mem = None if srv._memwatch is None else srv._memwatch.last
            stats = dict(srv.stats)
            lock_wait = dict(srv._lock.wait_s)
            snap = {
                "queue_depth": srv.queue_depth,
                "active_slots": srv.active_slots,
                "in_flight": srv.in_flight,
                "breaker_open": srv._breaker.open,
                "paged_util": srv.page_pool_utilization
                if srv.paged else None,
                "fairness": None if srv._fairness is None
                else sorted(srv._fairness.window_usage().items()),
                "fairness_budget": None if srv._fairness is None
                else srv._fairness.budget,
                # serving.memory_telemetry: the newest interval sample
                "memory": mem,
            }
        hist = srv.histograms()          # internally locked; may be None
        lines = []

        def series(name, help_, type_, samples):
            """One metric family: HELP/TYPE exactly once, then every
            sample — ``samples`` is ``[(suffix, labels_dict, value)]``
            (suffix: ``""`` for gauges, ``_bucket``/``_sum``/``_count``
            for histograms)."""
            lines.append(f"# HELP {name} {self._esc_help(help_)}")
            lines.append(f"# TYPE {name} {type_}")
            for suffix, labels, value in samples:
                lab = ""
                if labels:
                    inner = ",".join(
                        f'{k}="{self._esc_label(v)}"'
                        for k, v in labels.items())
                    lab = "{" + inner + "}"
                lines.append(f"{name}{suffix}{lab} {float(value)}")

        def gauge(name, value, help_, labels=None):
            series(f"dstpu_serving_{name}", help_, "gauge",
                   [("", labels or {}, value)])

        for key, val in sorted(stats.items()):
            gauge(key, val, help_=f"serving engine counter {key!r}")
        gauge("queue_depth", snap["queue_depth"],
              "queued + pending prefill")
        gauge("active_slots", snap["active_slots"],
              "host-mirror live slots")
        gauge("slot_occupancy", snap["active_slots"] / srv.num_slots,
              "live / total slots")
        gauge("in_flight_events", snap["in_flight"],
              "dispatched device events not yet processed")
        gauge("breaker_open", 1.0 if snap["breaker_open"] else 0.0,
              "dispatch circuit breaker state")
        gauge("uptime_seconds", time.monotonic() - self._t0,
              "front-end uptime")
        series("dstpu_serving_lock_wait_seconds",
               "cumulative wall time waiting on the engine lock per "
               "thread class", "gauge",
               [("", {"thread_class": cls}, lock_wait[cls])
                for cls in sorted(lock_wait)])
        if snap["paged_util"] is not None:
            gauge("page_pool_utilization", snap["paged_util"],
                  "allocated fraction of the KV page pool")
        if snap["fairness"] is not None:
            series("dstpu_serving_fairness_window_tokens",
                   "per-client decayed window balance", "gauge",
                   [("", {"client": key}, bal)
                    for key, bal in snap["fairness"]])
            gauge("fairness_budget", snap["fairness_budget"],
                  "window budget above which submit() is 429'd")
        if snap["memory"] is not None:
            # serving.memory_telemetry: the device's in-use / peak / limit,
            # the engine's owners and the unattributed gap
            mem = snap["memory"]
            series("dstpu_device_memory_bytes_in_use",
                   "device bytes in use (accelerator memory_snapshot)",
                   "gauge",
                   [("", {"device": d["device"]}, d["bytes_in_use"])
                    for d in mem["devices"]])
            series("dstpu_device_memory_peak_bytes",
                   "peak device bytes in use since process start",
                   "gauge",
                   [("", {"device": d["device"]}, d["peak_bytes_in_use"])
                    for d in mem["devices"]])
            series("dstpu_device_memory_limit_bytes",
                   "device memory capacity (0 = unknown)", "gauge",
                   [("", {"device": d["device"],
                          "source": d["limit_source"]},
                     d["bytes_limit"]) for d in mem["devices"]])
            series("dstpu_device_memory_owned_bytes",
                   "bytes attributed to a known serving-engine owner",
                   "gauge",
                   [("", {"owner": o}, b)
                    for o, b in sorted(mem["owners"].items())])
            series("dstpu_device_memory_unattributed_bytes",
                   "device bytes in use beyond every known owner — "
                   "where leaks hide", "gauge",
                   [("", {}, mem["unattributed_bytes"])])
        if hist is not None:
            # serving.tracing: the TTFT / TBT / queue-wait / dispatch /
            # lock-wait histograms
            for name, help_, samples in hist.collect():
                series(name, help_, "histogram", samples)
        return ("\n".join(lines) + "\n").encode()

    async def _metrics(self, writer):
        body = await asyncio.get_running_loop().run_in_executor(
            None, self._metrics_body)
        return await self._respond(
            writer, 200, body,
            ctype="text/plain; version=0.0.4; charset=utf-8")

    # ------------------------------------------------------------------ #
    # /debug/flightrec and /debug/profile
    # ------------------------------------------------------------------ #
    async def _debug_flightrec(self, writer):
        """The flight-recorder ring as JSON (the ring locks itself; the
        copy runs off the loop thread)."""
        snap = await asyncio.get_running_loop().run_in_executor(
            None, self.srv.flightrec_snapshot)
        if snap is None:
            raise _HTTPError(404, "flight recorder disabled — set "
                                  "serving.flight_recorder")
        return await self._respond(writer, 200, snap)

    async def _debug_profile(self, query, writer):
        """An on-demand ``torch.profiler`` capture of ``secs`` seconds (at
        most 60) in an executor thread, one at a time (409 while one
        runs), written as a Chrome trace; answers with its path."""
        if not getattr(self.srv.config, "profile_endpoint", False):
            raise _HTTPError(404, "profiling endpoint disabled — set "
                                  "serving.profile_endpoint")
        params = urllib.parse.parse_qs(query)
        try:
            secs = float(params.get("secs", ["1"])[0])
        except ValueError:
            raise _HTTPError(400, f"secs must be a number, got "
                                  f"{params.get('secs')!r}")
        if not math.isfinite(secs):      # NaN slips through min / max
            raise _HTTPError(400, f"secs must be finite, got {secs!r}")
        secs = min(max(secs, 0.0), 60.0)

        def capture():
            if not self._profile_lock.acquire(blocking=False):
                raise _HTTPError(409, "a profile capture is already "
                                      "running — retry when it ends")
            try:
                return self._profile(secs)
            finally:
                self._profile_lock.release()

        payload = await asyncio.get_running_loop().run_in_executor(
            None, capture)
        return await self._respond(writer, 200, payload)

    def _profile(self, secs):
        """Profile the process for ``secs`` seconds; the scheduler thread
        starts and stops the profiler between two of its steps."""
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.srv.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        d = self.profile_dir or tempfile.mkdtemp(prefix="dstpu_profile_")
        os.makedirs(d, exist_ok=True)
        prof = profile(activities=activities)
        t0 = time.perf_counter()
        self.on_scheduler(prof.start)
        t1 = time.perf_counter()
        try:
            time.sleep(secs)
        finally:
            t2 = time.perf_counter()
            self.on_scheduler(prof.stop)
        t3 = time.perf_counter()
        path = os.path.join(d, f"profile_{os.getpid()}_{time.time_ns()}"
                               f".json")
        prof.export_chrome_trace(path)
        # the seconds of the start, the stop and the export
        return {"trace_dir": d, "trace": path, "secs": secs,
                "start_s": t1 - t0, "stop_s": t3 - t2,
                "export_s": time.perf_counter() - t3}


def serve_http(srv, **kwargs):
    """``ServingHTTPFrontend(srv, **kwargs).start()``: the front end,
    listening (``.port``) with its scheduler thread driving ``srv``.

    At tensor-parallel size > 1 only tp rank 0 listens.  On the other
    ranks this binds no port and decides nothing: it runs
    ``srv.follow()``, applying rank 0's plans until rank 0 closes the
    server, and returns its ``{rid: output}``."""
    if srv.tp_follower:
        return srv.follow()
    return ServingHTTPFrontend(srv, **kwargs).start()


__all__ = ["ServingHTTPFrontend", "serve_http"]
