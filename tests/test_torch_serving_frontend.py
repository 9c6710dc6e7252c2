"""The serving front end of ``deepspeed_tpu_torch`` — the HTTP transport
(``inference/serving/frontend/transport.py``), fairness (``fairness.py``),
priority lanes and the thread-safe engine — against the JAX package, in
the scenarios of ``tests/unit/test_serving_frontend.py``.

Greedy tokens over HTTP (blocking and NDJSON streaming, two clients, two
priorities, concurrent) are bitwise the JAX front end's for the same
requests, and the port's direct ``submit`` / ``drain``'s.  Admission order
under priority lanes and aging, on an injected clock, and the fairness
tracker's allow / refuse decisions and ``state_dict`` are the JAX
engine's.  SIGTERM during HTTP streaming runs in a child process (its
handler preempts; the parent restores and finishes bitwise).  Every socket
has a timeout and every join a bound.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from torch_frontend_common import (WAIT_S, FakeClock, clock_module,
                                   drain_all, engines, get, post,
                                   read_stream, workload)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _disarm_injection():
    from deepspeed_tpu_torch.runtime.fault import inject
    inject.reset_injection()
    yield
    inject.reset_injection()


def _slow_steps(seconds=0.03):
    """Stretch every scheduler step by a seeded random sleep (a yield at
    the step's lock seam), so that a request is still running when the
    test looks at it."""
    from deepspeed_tpu_torch.runtime.fault import inject
    inject.configure_injection({"point": "serving.pre_step_lock",
                                "action": "yield", "times": 0,
                                "seconds": seconds})


def _join(*threads):
    for t in threads:
        t.join(timeout=WAIT_S)
        assert not t.is_alive(), f"thread {t.name} did not finish"


# ---------------------------------------------------------------------- #
# Fairness: the tracker, and the engine's decisions
# ---------------------------------------------------------------------- #
def test_fairness_tracker_matches_jax():
    """Decay, budget, allow / refuse and ``state_dict`` on one injected
    clock: the JAX tracker's values, bitwise."""
    from deepspeed_tpu.inference.serving.frontend.fairness import \
        FairnessTracker as J
    from deepspeed_tpu_torch.inference.serving.frontend.fairness import \
        FairnessTracker as P
    out = []
    for cls in (J, P):
        now = [0.0]
        tr = cls(10.0, window_s=5.0, clock=lambda: now[0])
        log = [tr.budget, tr.allow("a"), tr.usage("a")]
        tr.charge("a", 50.0)
        log += [tr.allow("a"), tr.allow("b")]
        now[0] = 5.0
        log += [tr.usage("a"), tr.allow("a")]
        tr.charge("b", 30.0)
        state = tr.state_dict()
        tr2 = cls(10.0, window_s=5.0, clock=lambda: now[0])
        tr2.load_state(state)
        log += [state, tr2.usage("b")]
        now[0] = 500.0
        log.append(tr.window_usage())
        with pytest.raises(ValueError):
            cls(0.0)
        out.append(log)
    assert out[1] == out[0]
    assert out[1][3] is False and out[1][-1] == {}


def test_fairness_decisions_match_jax():
    """A heavy and a light client on a frozen fairness clock: which
    submits the engine refuses with ``QueueFull``, the charges at
    admission and per token, and the balances are the JAX engine's."""
    from deepspeed_tpu.inference.serving.slo import QueueFull as JQF
    from deepspeed_tpu_torch.inference.serving.slo import QueueFull
    jeng, eng = engines()
    prompts, news = workload(9, 10, new_lo=4, new_hi=9)
    out = []
    for e in (jeng, eng):
        srv = e.serve(fairness_tokens_per_s=1.0, fairness_window_s=60.0)
        srv._fairness._clock = lambda: 100.0          # no decay
        log = []
        for k, (p, n) in enumerate(zip(prompts, news)):
            client = "light" if k in (0, 5) else "heavy"
            try:
                srv.submit(p, max_new_tokens=n, client_id=client)
                log.append((client, "ok"))
            except (QueueFull, JQF) as err:
                assert "fairness budget" in str(err)
                log.append((client, 429))
            srv.step()
        srv.drain()
        with srv._lock:
            log.append(srv.stats["fairness_rejected"])
            log.append(srv._fairness.state_dict())
        srv.close()
        out.append(log)
    assert out[1] == out[0]
    assert ("heavy", 429) in out[1] and ("light", 429) not in out[1]


# ---------------------------------------------------------------------- #
# Priority lanes
# ---------------------------------------------------------------------- #
def _admission_order(e, mod, monkeypatch, aging, arrivals):
    """Admission order of ``arrivals`` [(advance_s, prompt, priority)] on
    a one-slot server whose engine module reads ``clock``."""
    clock = FakeClock(t=1000.0)
    monkeypatch.setattr(mod, "time", clock_module(clock))
    srv = e.serve(num_slots=1, priority_lanes=3, priority_aging_s=aging)
    order, rids = [], []
    pop = srv._pop_request
    srv._pop_request = lambda: order.append(pop()) or order[-1]
    for dt, p, prio in arrivals:
        clock.advance(dt)
        rids.append(srv.submit(p, max_new_tokens=3, priority=prio))
    clock.advance(0.5)
    srv.drain()
    srv.close()
    monkeypatch.undo()
    return [rids.index(r.rid) for r in order]


@pytest.mark.parametrize("aging", [0.0, 1.0], ids=["strict", "aging"])
def test_priority_lanes_order_and_aging_match_jax(monkeypatch, aging):
    """Lane 0 before lane 1 before lane 2, fcfs within a lane; with aging a
    request that waited k ``priority_aging_s`` moves up k lanes.  The
    clock is injected (the engine module's ``time``), nothing sleeps."""
    import deepspeed_tpu.inference.serving.engine as jmod
    import deepspeed_tpu_torch.inference.serving.engine as pmod
    jeng, eng = engines()
    prompts, _ = workload(21, 5, lo=9, hi=12)
    arrivals = [(0.0, prompts[0], 2), (0.0, prompts[1], 1),
                (1.5, prompts[2], 2), (0.0, prompts[3], 0),
                (0.2, prompts[4], 1)]
    want = _admission_order(jeng, jmod, monkeypatch, aging, arrivals)
    got = _admission_order(eng, pmod, monkeypatch, aging, arrivals)
    assert got == want
    if aging == 0.0:
        assert got == [3, 1, 4, 0, 2]
    _, eng = engines()
    srv = eng.serve(priority_lanes=2)
    with pytest.raises(ValueError, match="priority"):
        srv.submit(prompts[0], max_new_tokens=3, priority=2)
    srv.close()


# ---------------------------------------------------------------------- #
# The engine's thread-safe surface
# ---------------------------------------------------------------------- #
def test_unknown_rid_raises_keyerror():
    _, eng = engines()
    srv = eng.serve()
    rid = srv.submit(np.arange(1, 10, dtype=np.int32), max_new_tokens=3)
    for call in (srv.result, srv.cancel, srv.status, srv.token_events):
        with pytest.raises(KeyError, match="unknown request id"):
            call(rid + 999)
    assert srv.result(rid) is None
    srv.drain()
    assert srv.result(rid).status == "COMPLETED"
    srv.close()


def test_token_stream_bitwise_with_eos_and_cancel():
    """A request's stream is its result's tokens, a mid-stream eos last; a
    cancelled stream ends ``CANCELLED``; a late subscription replays; the
    outputs are the JAX engine's."""
    jeng, eng = engines()
    prompts, news = workload(7, 4)
    probe = drain_all(jeng.serve(), prompts[:1], news[:1])[0]
    eos0 = int(probe[len(prompts[0]) + news[0] // 2])
    eoss = [eos0, -1, -1, -1]
    jsrv = jeng.serve()
    jr = [jsrv.submit(p, max_new_tokens=n, eos_token_id=e)
          for p, n, e in zip(prompts[:3], news[:3], eoss[:3])]
    jouts = jsrv.drain()
    jsrv.close()
    srv = eng.serve()
    rids = [srv.submit(p, max_new_tokens=n, eos_token_id=e)
            for p, n, e in zip(prompts, news, eoss)]
    streams = [srv.token_events(r) for r in rids]
    while srv.status(rids[3]) == "QUEUED":
        srv.step()
    srv.cancel(rids[3])
    srv.drain()
    for i in range(3):
        toks, end = streams[i].tokens(timeout=WAIT_S)
        res = srv.result(rids[i])
        np.testing.assert_array_equal(res.output, jouts[jr[i]])
        P = len(prompts[i])
        assert toks == [int(t) for t in res.output[P:P + len(toks)]]
        assert end["status"] == "COMPLETED"
        if i == 0:
            gen = [int(t) for t in probe[P:]]
            assert toks[-1] == eos0 and len(toks) == gen.index(eos0) + 1
        else:
            assert len(toks) == news[i]
    _, end3 = streams[3].tokens(timeout=WAIT_S)
    assert end3["status"] == "CANCELLED"
    replay, rend = srv.token_events(rids[1]).tokens(timeout=WAIT_S)
    assert replay == [int(t) for t in
                      srv.result(rids[1]).output[len(prompts[1]):]]
    assert rend["status"] == "COMPLETED"
    srv.close()


def test_concurrent_submit_many_threads():
    """Six threads submit while one owner thread steps; every output is
    the JAX engine's, and a second driver is refused."""
    jeng, eng = engines()
    n_threads, per = 6, 3
    prompts, news = workload(33, n_threads * per)
    want = drain_all(jeng.serve(), prompts, news)
    srv = eng.serve()
    rids, errors = {}, []

    def driver():
        try:
            deadline = time.monotonic() + WAIT_S
            while time.monotonic() < deadline:
                with srv._lock:
                    if len(srv._results) >= n_threads * per:
                        return
                srv.step()
        except Exception as e:           # noqa: BLE001
            errors.append(e)

    def submitter(t):
        try:
            for i in range(per):
                k = t * per + i
                rids[k] = srv.submit(prompts[k], max_new_tokens=news[k],
                                     client_id=f"tenant-{t % 2}")
                time.sleep(0.001)
        except Exception as e:           # noqa: BLE001
            errors.append(e)

    drv = threading.Thread(target=driver, name="owner")
    drv.start()
    deadline = time.monotonic() + WAIT_S
    while srv._owner_thread is None and time.monotonic() < deadline:
        time.sleep(0.002)
    with pytest.raises(RuntimeError, match="scheduler owner"):
        srv.step()
    subs = [threading.Thread(target=submitter, args=(t,))
            for t in range(n_threads)]
    for s in subs:
        s.start()
    _join(*subs, drv)
    assert not errors, errors
    for k, rid in rids.items():
        res = srv.result(rid)
        assert res.status == "COMPLETED"
        np.testing.assert_array_equal(res.output, want[k])
    srv.close()


# ---------------------------------------------------------------------- #
# HTTP
# ---------------------------------------------------------------------- #
def _http_run(fe_cls, srv, prompts, news, **fe_kw):
    """Every request posted at once from its own thread (odd ones
    streaming, two clients, two priorities); ``{k: tokens}`` plus the
    statuses of /healthz and /metrics read meanwhile."""
    outs, errors = {}, []

    def client(k):
        try:
            stream = bool(k % 2)
            conn, resp = post(fe.port, {
                "input_ids": [int(t) for t in prompts[k]],
                "max_new_tokens": news[k], "client_id": f"tenant-{k % 2}",
                "priority": (k // 2) % 2, "stream": stream})
            assert resp.status == 200, (k, resp.status)
            if stream:
                toks, end, n_end = read_stream(resp)
                assert end["status"] == "COMPLETED" and n_end == 1, end
                outs[k] = [int(t) for t in prompts[k]] + toks
            else:
                body = json.loads(resp.read())
                assert body["status"] == "COMPLETED", body
                outs[k] = body["output"]
            conn.close()
        except Exception as e:           # noqa: BLE001
            errors.append((k, e))

    fe = fe_cls(srv, **fe_kw).start()
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(len(prompts))]
        for t in threads:
            t.start()
        _join(*threads)
        health = json.loads(get(fe.port, "/healthz")[1])
        status, metrics = get(fe.port, "/metrics")
    finally:
        fe.shutdown()
    assert not errors, errors
    assert health["ok"] and health["num_slots"] == srv.num_slots
    assert status == 200 and b"dstpu_serving_completed" in metrics
    srv.close()
    return outs


@pytest.mark.parametrize("over", [dict(priority_lanes=2),
                                  dict(paged=True, page_size=16,
                                       priority_lanes=2)],
                         ids=["lanes", "pool"])
def test_http_tokens_match_the_jax_front_end(over):
    """Fourteen concurrent mixed requests over HTTP: every output is the
    JAX front end's for the same requests, and the port's direct
    ``submit`` / ``drain``'s."""
    from deepspeed_tpu.inference.serving.frontend import \
        ServingHTTPFrontend as JFE
    from deepspeed_tpu_torch.inference.serving import ServingHTTPFrontend
    jeng, eng = engines()
    prompts, news = workload(5, 14)
    direct = drain_all(eng.serve(**over), prompts, news)
    got = _http_run(ServingHTTPFrontend, eng.serve(**over), prompts, news)
    want = _http_run(JFE, jeng.serve(**over), prompts, news)
    for k in range(len(prompts)):
        assert got[k] == want[k] == direct[k].tolist(), k


def test_http_fairness_overload_sheds_only_heavy_client():
    """The heavy client (4 connections × 4 requests) is refused with 429
    once over its budget; every light request completes."""
    from deepspeed_tpu_torch.inference.serving import serve_http
    _, eng = engines()
    heavy_p, heavy_n = workload(9, 16, new_lo=6, new_hi=12)
    light_p, light_n = workload(10, 4, new_lo=3, new_hi=6)
    srv = eng.serve(fairness_tokens_per_s=1.5, fairness_window_s=30.0)
    stats = {"heavy_429": 0, "heavy_ok": 0}
    light, errors = [], []
    lock = threading.Lock()

    def heavy(c):
        try:
            for k in range(c * 4, c * 4 + 4):
                conn, resp = post(fe.port, {
                    "input_ids": [int(t) for t in heavy_p[k]],
                    "max_new_tokens": heavy_n[k], "client_id": "heavy"})
                body = json.loads(resp.read())
                with lock:
                    if resp.status == 429:
                        assert "fairness budget" in body["error"]
                        stats["heavy_429"] += 1
                    else:
                        assert resp.status == 200, body
                        stats["heavy_ok"] += 1
                conn.close()
        except Exception as e:           # noqa: BLE001
            errors.append(("heavy", c, e))

    def light_client(k):
        try:
            conn, resp = post(fe.port, {
                "input_ids": [int(t) for t in light_p[k]],
                "max_new_tokens": light_n[k], "client_id": "light"})
            light.append((resp.status, json.loads(resp.read())))
            conn.close()
        except Exception as e:           # noqa: BLE001
            errors.append(("light", k, e))

    fe = serve_http(srv, port=0)
    try:
        threads = [threading.Thread(target=heavy, args=(c,))
                   for c in range(4)]
        threads += [threading.Thread(target=light_client, args=(k,))
                    for k in range(len(light_p))]
        for t in threads:
            t.start()
        _join(*threads)
    finally:
        fe.shutdown()
    assert not errors, errors
    assert stats["heavy_429"] >= 1, stats
    assert [c for c, _ in light] == [200] * len(light_p)
    assert all(b["status"] == "COMPLETED" for _, b in light)
    assert srv.stats["fairness_rejected"] == stats["heavy_429"]
    srv.close()


def test_http_routes_cancel_and_status():
    """``GET`` / ``DELETE /v1/requests/<rid>``: a status poll, a cancel of a
    running request (``cancelled: true``, its stream ends ``CANCELLED``),
    a cancel of an ended one (``false``), 404 for an unknown id, 400 for
    a malformed one and for a bad body; 503 once the engine is closed."""
    from deepspeed_tpu_torch.inference.serving import serve_http
    _, eng = engines()
    prompts, _ = workload(17, 2, lo=9, hi=12)
    srv = eng.serve(num_slots=1, decode_block=1)
    _slow_steps()
    fe = serve_http(srv, port=0)
    try:
        conn, resp = post(fe.port, {"input_ids": [int(t) for t in prompts[0]],
                                    "max_new_tokens": 40, "stream": True})
        first = json.loads(resp.readline())
        rid = first["rid"]
        status, body = get(fe.port, f"/v1/requests/{rid}")
        assert status == 200 and json.loads(body)["status"] == "RUNNING"
        status, body = get(fe.port, f"/v1/requests/{rid}", "DELETE")
        assert status == 200 and json.loads(body)["cancelled"] is True
        toks, end, n_end = read_stream(resp)
        assert end["status"] == "CANCELLED" and n_end == 1
        conn.close()
        status, body = get(fe.port, f"/v1/requests/{rid}", "DELETE")
        assert status == 200 and json.loads(body)["cancelled"] is False
        assert get(fe.port, f"/v1/requests/{rid + 99}")[0] == 404
        assert get(fe.port, "/v1/requests/abc")[0] == 400
        conn, resp = post(fe.port, {"input_ids": [], "max_new_tokens": 2})
        assert resp.status == 400
        conn.close()
        conn, resp = post(fe.port, {"input_ids": [1, 2], "bogus": 1})
        assert resp.status == 400
        conn.close()
        srv.close()
        assert get(fe.port, "/healthz")[0] == 503
        conn, resp = post(fe.port, {"input_ids": [1, 2, 3],
                                    "max_new_tokens": 2})
        assert resp.status == 503
        conn.close()
    finally:
        fe.shutdown()


def test_http_client_disconnect_cancels_its_request():
    from deepspeed_tpu_torch.inference.serving import serve_http
    _, eng = engines()
    prompts, _ = workload(19, 1, lo=9, hi=12)
    srv = eng.serve(num_slots=1, decode_block=1)
    _slow_steps()
    fe = serve_http(srv, port=0)
    try:
        conn, resp = post(fe.port, {"input_ids": [int(t) for t in prompts[0]],
                                    "max_new_tokens": 40, "stream": True})
        rid = json.loads(resp.readline())["rid"]
        resp.close()                     # the client hangs up mid-stream
        conn.close()
        deadline = time.monotonic() + WAIT_S
        while srv.status(rid) != "CANCELLED" \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.status(rid) == "CANCELLED"
    finally:
        fe.shutdown(close_engine=True)


def test_token_stream_dead_subscriber_does_not_break_producer():
    from deepspeed_tpu_torch.inference.serving.slo import TokenStream
    calls = []

    def bad(ev):
        calls.append(ev)
        raise RuntimeError("Event loop is closed")

    st = TokenStream(7, on_event=bad)
    st.push({"event": "token", "rid": 7, "index": 0, "token": 3})
    st.push({"event": "end", "rid": 7, "status": "COMPLETED", "detail": ""})
    assert len(calls) == 1
    assert st.get(timeout=1)["token"] == 3
    assert st.get(timeout=1)["event"] == "end"


def test_http_malformed_head_gets_400_then_drop():
    from deepspeed_tpu_torch.inference.serving import serve_http
    _, eng = engines()
    srv = eng.serve()
    fe = serve_http(srv, port=0)
    try:
        for head in (b"POST /v1/generate HTTP/1.1\r\nContent-Length: abc"
                     b"\r\n\r\n", b"GARBAGE\r\n\r\n",
                     b"POST /v1/generate HTTP/1.1\r\nContent-Length: -5"
                     b"\r\n\r\n"):
            s = socket.create_connection(("127.0.0.1", fe.port),
                                         timeout=WAIT_S)
            s.sendall(head)
            assert s.recv(4096).startswith(b"HTTP/1.1 400"), head
            assert s.recv(4096) == b""
            s.close()
        conn, resp = post(fe.port, {"input_ids": [1, 2, 3],
                                    "max_new_tokens": 2})
        assert resp.status == 200
        conn.close()
    finally:
        fe.shutdown(close_engine=True)


def test_http_start_failure_releases_engine():
    """A start that fails after its scheduler thread claimed the engine
    (the port is taken) lets go of the claim: a second front end serves
    the same engine."""
    from deepspeed_tpu_torch.inference.serving import ServingHTTPFrontend
    _, eng = engines()
    srv_a, srv_b = eng.serve(), eng.serve()
    fe_a = ServingHTTPFrontend(srv_a).start()
    try:
        with pytest.raises(OSError):
            ServingHTTPFrontend(srv_b, port=fe_a.port).start()
        fe_b = ServingHTTPFrontend(srv_b).start()
        try:
            conn, resp = post(fe_b.port, {"input_ids": [1, 2, 3],
                                          "max_new_tokens": 2})
            assert resp.status == 200
            assert json.loads(resp.read())["status"] == "COMPLETED"
            conn.close()
        finally:
            fe_b.shutdown()
    finally:
        fe_a.shutdown()
        srv_a.close()
        srv_b.close()


# ---------------------------------------------------------------------- #
# SIGTERM during HTTP streaming → preempt → restore (a child process)
# ---------------------------------------------------------------------- #
SIGTERM_NEWS = [40, 40, 38]
FAIR = dict(fairness_tokens_per_s=10000.0, fairness_window_s=60.0,
            priority_lanes=2)


def sigterm_child(out_dir):
    """The child: serve the port engine saved in ``out_dir`` over HTTP,
    stream three requests, SIGTERM itself once two are flowing, and write
    what the streams and the preemption gave to ``result.json``."""
    import signal
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.serving import ServingHTTPFrontend
    from deepspeed_tpu_torch.models import transformer as pt
    from torch_frontend_common import CFG, SERVING
    torch.set_num_threads(1)
    eng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(pt.TransformerConfig(**CFG)),
        config={"dtype": "float32", "prefill_chunk_size": 8,
                "serving": dict(SERVING)}, device="cpu")
    eng.set_params(torch.load(os.path.join(out_dir, "weights.pt")))
    prompts, _ = workload(13, 3, lo=10, hi=14)
    srv = eng.serve(num_slots=2, drain_budget_s=0.0, decode_block=1, **FAIR)
    _slow_steps(0.02)
    got, errors = {}, []

    def streamer(k):
        try:
            conn, resp = post(fe.port, {
                "input_ids": [int(t) for t in prompts[k]],
                "max_new_tokens": SIGTERM_NEWS[k],
                "client_id": f"tenant-{k % 2}", "priority": k % 2,
                "stream": True})
            toks, end, n_end = read_stream(resp)
            got[k] = (toks, end, n_end)
            conn.close()
        except Exception as e:           # noqa: BLE001
            errors.append(repr(e))

    fe = ServingHTTPFrontend(srv, snapshot_dir=os.path.join(out_dir, "snap"))
    fe.start()
    fe.install_signal_handlers()
    threads = [threading.Thread(target=streamer, args=(k,))
               for k in range(3)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        with srv._lock:
            flowing = sum(1 for r in srv._requests.values()
                          if 1 <= len(r.tokens) < r.max_new - 25)
            submitted = len(srv._requests)
        if flowing >= 2 and submitted == 3:
            break
        time.sleep(0.005)
    os.kill(os.getpid(), signal.SIGTERM)
    tag, snapped, _ = fe.join_preempted(timeout=WAIT_S)
    for t in threads:
        t.join(timeout=WAIT_S)
    fe.shutdown()
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump({"tag": tag, "snapped": snapped, "errors": errors,
                   "streams": {str(k): v for k, v in got.items()}}, f)


def test_http_sigterm_streaming_preempt_restore_bitwise(tmp_path):
    """SIGTERM in a child serving three HTTP streams: each stream ends with
    one typed event (``PREEMPTED`` for the snapshotted), the snapshot is
    published, and a fresh server restores the requests with their
    priorities and fairness balances and finishes them as the JAX engine
    serves them uninterrupted; the restore charges only the new
    tokens."""
    from deepspeed_tpu_torch.inference.serving.frontend.fairness import \
        FairnessTracker
    jeng, eng = engines()
    torch.save(eng.module.state_dict(), str(tmp_path / "weights.pt"))
    code = ("import sys; sys.path.insert(0, 'tests'); from "
            "test_torch_serving_frontend import sigterm_child; "
            "sigterm_child(sys.argv[1])")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=3 * WAIT_S,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp_path / "result.json") as f:
        res = json.load(f)
    assert not res["errors"], res["errors"]
    assert res["tag"] is not None and len(res["snapped"]) >= 2, res
    for k in range(3):
        toks, end, n_end = res["streams"][str(k)]
        assert n_end == 1 and end["status"] in ("PREEMPTED", "COMPLETED")
        if end["status"] == "PREEMPTED":
            assert "resume" in end["detail"]
    prompts, _ = workload(13, 3, lo=10, hi=14)
    want = drain_all(jeng.serve(num_slots=2), prompts, SIGTERM_NEWS)
    srv = eng.serve(num_slots=2, **FAIR)
    rids = srv.restore(str(tmp_path / "snap"))
    assert sorted(rids) == sorted(res["snapped"])

    def k_of(req):
        (k,) = [k for k in range(3) if np.array_equal(req.ids, prompts[k])]
        return k

    with srv._lock:
        for rid in rids:
            req = srv._requests[rid]
            assert req.priority == k_of(req) % 2
        frozen = srv._fairness._clock()
        srv._fairness._clock = lambda: frozen
        usage = srv._fairness.window_usage()
        k_by_rid = {rid: k_of(srv._requests[rid]) for rid in rids}
    assert usage and all(v > 0 for v in usage.values())
    outs = srv.drain()
    for rid in rids:
        np.testing.assert_array_equal(outs[rid], want[k_by_rid[rid]])
    with srv._lock:
        post_usage = srv._fairness.window_usage()
        for key in post_usage:
            new = sum(len(srv._requests[r].tokens)
                      - len(srv._requests[r].prefix) for r in rids
                      if FairnessTracker.key(srv._requests[r].client_id)
                      == key)
            assert post_usage[key] == pytest.approx(usage.get(key, 0.0)
                                                    + new)
    srv.close()


def test_request_preempt_from_any_thread(tmp_path):
    """``request_preempt()`` (the path a card run takes, no signal): the
    scheduler thread snapshots, open streams end ``PREEMPTED``, and the
    engine is closed afterwards."""
    from deepspeed_tpu_torch.inference.serving import ServingHTTPFrontend
    _, eng = engines()
    prompts, _ = workload(13, 1, lo=10, hi=14)
    srv = eng.serve(num_slots=1, drain_budget_s=0.0, decode_block=1)
    _slow_steps()
    fe = ServingHTTPFrontend(srv, snapshot_dir=str(tmp_path / "snap")).start()
    try:
        conn, resp = post(fe.port, {"input_ids": [int(t) for t in prompts[0]],
                                    "max_new_tokens": 40, "stream": True})
        resp.readline()
        threading.Thread(target=fe.request_preempt).start()
        tag, snapped, _ = fe.join_preempted(timeout=WAIT_S)
        toks, end, n_end = read_stream(resp)
        conn.close()
    finally:
        fe.shutdown()
    assert tag is not None and len(snapped) == 1
    assert end["status"] == "PREEMPTED" and n_end == 1
    assert srv.health_snapshot()["closed"]
