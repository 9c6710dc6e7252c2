"""Serving observability of ``deepspeed_tpu_torch`` — span tracing and the
histograms (``monitor/trace.py``), the flight recorder (``flightrec.py``),
``/metrics`` and the debug endpoints — against the JAX package, in the
scenarios of ``tests/unit/test_serving_trace.py``.

Both engines serve the same requests with the tracer on one injected clock
(``tick`` seconds a read): the served tokens, the Chrome trace's events
(names, categories, tracks, timestamps, arguments), the latency breakdown
of every result and the TTFT / time-between-tokens / queue-wait /
dispatch histograms are equal, bitwise.  The flight recorder's event
kinds in a breaker-open and a drain-timeout scenario are the JAX
engine's (the periodic ``lock_wait`` sample, taken every 32 iterations,
left out of the drain-timeout comparison: how many iterations a 0.2 s
timeout holds is the wall clock's).  ``/metrics`` names the JAX front
end's series for the same server.
"""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from torch_frontend_common import (WAIT_S, FakeClock, engines, get, post,
                                   workload)
from tests.unit.test_serving_trace import (NASTY_CLIENT, _family,
                                           parse_prometheus)

TICK = 0.125


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _traced_run(eng, prompts, news, **over):
    """Serve with tracing and the flight recorder on a fake tracer clock;
    returns the server (open) and the request ids."""
    srv = eng.serve(tracing=True, flight_recorder=True, **over)
    srv._tracer._clock = FakeClock(tick=TICK)
    srv._tracer._t0 = 0.0                # the trace's epoch on that clock
    rids = [srv.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    srv.drain()
    return srv, rids


def _hist_snapshots(h):
    return {"ttft": h.ttft.snapshot(), "tbt": h.tbt.snapshot(),
            "queue_wait": h.queue_wait.snapshot(),
            "dispatch": {k: c.snapshot()
                         for k, c in sorted(h.dispatch._children.items())}}


def _breakdown(res):
    return (res.queue_s, res.prefill_s, res.host_s, res.decode_s,
            res.latency_s)


@pytest.mark.parametrize("over", [{}, dict(paged=True, page_size=16)],
                         ids=["lanes", "pool"])
def test_tracing_off_on_bitwise_spans_and_histograms_match_jax(tmp_path,
                                                               over):
    """Tracing off and on serve the same tokens (and the JAX engine's);
    the tracing server's spans, breakdowns and histograms are the JAX
    engine's on the same clock; the graphs captured are the same count
    either way."""
    jeng, eng = engines()
    prompts, news = workload(7, 7, new_lo=3, new_hi=9)
    srv_off = eng.serve(**over)
    assert srv_off.histograms() is None
    assert srv_off.flightrec_snapshot() is None
    with pytest.raises(RuntimeError, match="serving.tracing is off"):
        srv_off.dump_trace(str(tmp_path / "no.json"))
    with pytest.raises(RuntimeError, match="flight_recorder is off"):
        srv_off.dump_flightrec()
    rids_off = [srv_off.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, news)]
    outs_off = srv_off.drain()
    assert srv_off.result(rids_off[0]).latency_s is None
    graphs_off = srv_off._decode_prog.num_graphs
    srv_off.close()

    jsrv, jrids = _traced_run(jeng, prompts, news, **over)
    srv, rids = _traced_run(eng, prompts, news, **over)
    assert srv._decode_prog.num_graphs == graphs_off
    for r_off, r, jr in zip(rids_off, rids, jrids):
        np.testing.assert_array_equal(outs_off[r_off], srv.result(r).output)
        np.testing.assert_array_equal(srv.result(r).output,
                                      jsrv.result(jr).output)
        res = srv.result(r)
        assert _breakdown(res) == _breakdown(jsrv.result(jr))
        parts = _breakdown(res)[:4]
        assert all(p is not None and p >= 0 for p in parts)
        assert abs(sum(parts) - res.latency_s) < 1e-9
    want = jsrv._tracer.to_chrome()
    got = srv._tracer.to_chrome()
    assert got["traceEvents"] == want["traceEvents"]
    assert got["otherData"]["spans"] == want["otherData"]["spans"] > 0
    assert _hist_snapshots(srv.histograms()) \
        == _hist_snapshots(jsrv.histograms())
    h = srv.histograms()
    assert h.ttft.count == h.queue_wait.count == len(prompts)
    assert h.tbt.count == sum(news) - len(news)
    assert set(h.dispatch._children) >= {"decode", "admit", "prefill_chunk"}
    path = srv.dump_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        trace = json.load(f)
    tracks = {e["args"]["name"] for e in trace["traceEvents"]
              if e.get("ph") == "M"}
    assert {"scheduler", "queue", "handler"} <= tracks
    assert {f"slot {s}" for s in range(srv.num_slots)} <= tracks
    commits = [e for e in trace["traceEvents"] if e["name"] == "commit"]
    with srv._lock:
        decoded = srv.stats["decode_tokens"]
    assert sum(e["args"]["tokens"] for e in commits) == decoded
    kinds = [e["ev"] for e in srv.flightrec_snapshot()["events"]]
    assert kinds == [e["ev"] for e in jsrv.flightrec_snapshot()["events"]]
    jsrv.close()
    srv.close()


def test_ttft_tbt_injected_clock_and_replay_no_restamp():
    """Every TTFT / TBT / queue-wait observation is a multiple of the fake
    tick; a late ``TokenStream`` replay leaves the histograms as they
    were."""
    _, eng = engines()
    prompts, _ = workload(31, 2, new_lo=3, new_hi=9)
    news = [4, 5]
    srv, rids = _traced_run(eng, prompts, news)
    h = srv.histograms()
    assert h.ttft.count == 2 and h.tbt.count == sum(news) - len(news)
    for hist in (h.ttft, h.tbt, h.queue_wait):
        scaled = hist.snapshot()["sum"] / TICK
        assert abs(scaled - round(scaled)) < 1e-6
    before = _hist_snapshots(h)
    for rid, n in zip(rids, news):
        toks, end = srv.token_events(rid).tokens(timeout=WAIT_S)
        assert len(toks) == n and end["status"] == "COMPLETED"
    assert _hist_snapshots(h) == before
    srv.close()


def _breaker_run(e, tmp_path, fail):
    srv = e.serve(num_slots=2, paged=True, page_size=16,
                  breaker_threshold=2, breaker_cooldown_s=30.0,
                  flight_recorder=True, flight_recorder_dir=str(tmp_path))
    for p in workload(23, 2)[0]:
        srv.submit(p, max_new_tokens=4)
    with fail():
        srv.step()                       # failure 1: absorbed
        assert srv._flightrec.last_dump_path is None
        srv.step()                       # failure 2: the breaker opens
    assert srv._breaker.open
    with open(srv._flightrec.last_dump_path) as f:
        dump = json.load(f)
    srv.close()
    return dump


def test_flightrec_dump_on_breaker_open_matches_jax(tmp_path, monkeypatch):
    """Two failed dispatches open the breaker; the dump's events are the
    JAX engine's kinds, in order, ending dispatch_begin → dispatch_error
    → breaker_open."""
    import contextlib
    from deepspeed_tpu_torch.inference.serving import slots
    jeng, eng = engines()

    def sick(*a, **k):
        raise RuntimeError("injected sick-device dispatch failure")

    @contextlib.contextmanager
    def fail_jax():
        real = jeng._run_guarded
        jeng._run_guarded = lambda fn, args: sick()
        try:
            yield
        finally:
            jeng._run_guarded = real

    @contextlib.contextmanager
    def fail_port():
        with monkeypatch.context() as m:
            m.setattr(slots, "paged_chunk", sick)
            yield

    want = _breaker_run(jeng, tmp_path / "jax", fail_jax)
    got = _breaker_run(eng, tmp_path / "port", fail_port)
    kinds = [e["ev"] for e in got["events"]]
    assert got["reason"] == want["reason"] == "breaker_open"
    assert kinds == [e["ev"] for e in want["events"]]
    i_begin = max(i for i, k in enumerate(kinds) if k == "dispatch_begin")
    i_err = max(i for i, k in enumerate(kinds) if k == "dispatch_error")
    assert i_begin < i_err < kinds.index("breaker_open") == len(kinds) - 1
    errs = [e for e in got["events"] if e["ev"] == "dispatch_error"]
    assert errs and all("sick-device" in e["error"] for e in errs)
    assert all("seq" in e and "t_mono" in e and "t_wall" in e
               for e in got["events"])


def _wedged_drain(e, tmp_path):
    from deepspeed_tpu.inference.serving.slo import DrainTimeout as JDT
    from deepspeed_tpu_torch.inference.serving.slo import DrainTimeout
    srv = e.serve(num_slots=2, flight_recorder=True,
                  flight_recorder_dir=str(tmp_path))
    rid = srv.submit(workload(29, 1)[0][0], max_new_tokens=30)
    while srv.active_slots == 0:
        srv.step()
    srv._dispatch_decode = lambda: False          # wedge the scheduler
    with pytest.raises((DrainTimeout, JDT)):
        srv.drain(timeout_s=0.2)
    with open(srv._flightrec.last_dump_path) as f:
        dump = json.load(f)
    srv.close()
    return rid, dump


def test_flightrec_dump_on_drain_timeout_matches_jax(tmp_path):
    jeng, eng = engines()
    _, want = _wedged_drain(jeng, tmp_path / "jax")
    rid, got = _wedged_drain(eng, tmp_path / "port")
    assert got["reason"] == want["reason"] == "drain_timeout"

    def kinds(dump):
        return [e["ev"] for e in dump["events"] if e["ev"] != "lock_wait"]

    assert kinds(got) == kinds(want)
    assert kinds(got)[-1] == "drain_timeout"
    assert {"dispatch_end", "admit_start"} <= set(kinds(got))
    assert f"request {rid}" in got["events"][-1]["diag"]


def _metrics_series(body):
    types, helps, samples = parse_prometheus(body)
    return types, helps, samples, {_family(n, types) for n, _, _ in samples}


# series the port's engine has from its start; the JAX engine has
# "aborted" only once a request was aborted, and no "dispatch_failures"
PORT_ONLY = {"dstpu_serving_aborted", "dstpu_serving_dispatch_failures"}


def test_metrics_round_trip_histograms_escaping_and_gating():
    """``/metrics`` over HTTP: every sample has HELP and TYPE, a hostile
    client id round-trips, the five histogram families parse with
    monotone buckets, the debug routes of a server without them answer
    404, and the series are the JAX front end's for the same server."""
    from deepspeed_tpu.inference.serving.frontend import \
        ServingHTTPFrontend as JFE
    from deepspeed_tpu_torch.inference.serving import serve_http
    jeng, eng = engines()
    prompts, _ = workload(37, 2)
    srv = eng.serve(tracing=True, fairness_tokens_per_s=10000.0)
    fe = serve_http(srv, port=0)
    try:
        for k, p in enumerate(prompts):
            conn, resp = post(fe.port, {
                "input_ids": [int(t) for t in p], "max_new_tokens": 4,
                "client_id": NASTY_CLIENT if k == 0 else "plain"})
            assert resp.status == 200
            resp.read()
            conn.close()
        status, body = get(fe.port, "/metrics")
        assert status == 200
        status, b = get(fe.port, "/debug/flightrec")
        assert status == 404 and b"flight recorder disabled" in b
        status, b = get(fe.port, "/debug/profile?secs=1", "POST")
        assert status == 404 and b"profiling endpoint disabled" in b
    finally:
        fe.shutdown(close_engine=True)
    types, helps, samples, families = _metrics_series(body.decode())
    for name, _, _ in samples:
        fam = _family(name, types)
        assert fam is not None and fam in helps, name
    fairness = [la for n, la, _ in samples
                if n == "dstpu_serving_fairness_window_tokens"]
    assert any(la.get("client") == NASTY_CLIENT for la in fairness)
    for fam in ("dstpu_serving_ttft_seconds", "dstpu_serving_tbt_seconds",
                "dstpu_serving_queue_wait_seconds",
                "dstpu_serving_dispatch_seconds",
                "dstpu_serving_lock_acquire_wait_seconds"):
        assert types.get(fam) == "histogram"
        rows = [(la, v) for n, la, v in samples if n == f"{fam}_bucket"]
        keysets = {tuple(sorted((k, v) for k, v in la.items() if k != "le"))
                   for la, _ in rows}
        for ks in keysets:
            sub = [(la["le"], v) for la, v in rows
                   if tuple(sorted((k, v2) for k, v2 in la.items()
                                   if k != "le")) == ks]
            counts = [v for _, v in sorted((float(le), v) for le, v in sub
                                           if le != "+Inf")]
            assert counts == sorted(counts)
            inf = [v for le, v in sub if le == "+Inf"]
            cnt = [v for n, la, v in samples if n == f"{fam}_count"
                   and tuple(sorted(la.items())) == ks]
            assert inf == cnt
    assert [v for n, _, v in samples
            if n == "dstpu_serving_ttft_seconds_count"] == [2.0]
    # the JAX front end's series for the same server and requests
    jsrv = jeng.serve(tracing=True, fairness_tokens_per_s=10000.0)
    for k, p in enumerate(prompts):
        jsrv.submit(p, max_new_tokens=4,
                    client_id=NASTY_CLIENT if k == 0 else "plain")
    jsrv.drain()
    jbody = JFE(jsrv)._metrics_body().decode()
    jsrv.close()
    assert families - PORT_ONLY == _metrics_series(jbody)[3]


def test_debug_flightrec_profile_and_sigusr2(tmp_path):
    """``/debug/flightrec`` answers the ring, ``/debug/profile`` writes a
    Chrome trace (400 for a bad ``secs``), and SIGUSR2 dumps the ring
    without the engine lock."""
    from deepspeed_tpu_torch.inference.serving import ServingHTTPFrontend
    _, eng = engines()
    prompts, _ = workload(41, 1)
    srv = eng.serve(flight_recorder=True,
                    flight_recorder_dir=str(tmp_path / "fr"),
                    profile_endpoint=True)
    fe = ServingHTTPFrontend(srv, profile_dir=str(tmp_path / "prof")).start()
    try:
        conn, resp = post(fe.port, {"input_ids": [int(t) for t in prompts[0]],
                                    "max_new_tokens": 3})
        assert resp.status == 200
        resp.read()
        conn.close()
        status, body = get(fe.port, "/debug/flightrec")
        assert status == 200
        snap = json.loads(body)
        assert snap["recorded"] >= len(snap["events"]) > 0
        assert {"submit", "terminal"} <= {e["ev"] for e in snap["events"]}
        status, body = get(fe.port, "/debug/profile?secs=0", "POST")
        assert status == 200, body
        prof = json.loads(body)
        assert prof["trace_dir"] == str(tmp_path / "prof")
        with open(prof["trace"]) as f:
            assert "traceEvents" in json.load(f)
        status, _ = get(fe.port, "/debug/profile?secs=abc", "POST")
        assert status == 400
        if threading.current_thread() is threading.main_thread():
            fe.install_flightrec_signal_handler()
            os.kill(os.getpid(), signal.SIGUSR2)
            deadline = time.monotonic() + WAIT_S
            while not srv._flightrec.last_dump_path \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            with open(srv._flightrec.last_dump_path) as f:
                assert json.load(f)["reason"] == "sigusr2"
    finally:
        fe.shutdown(close_engine=True)       # restores the handlers


def test_trace_and_histogram_primitives_match_jax():
    """The primitives alone: the same buckets, the same exposition
    samples and the same Chrome JSON for the same observations."""
    from deepspeed_tpu.monitor import trace as jtr
    from deepspeed_tpu_torch.monitor import trace as ptr
    assert ptr.LATENCY_BUCKETS_S == jtr.LATENCY_BUCKETS_S
    assert ptr.LOCK_WAIT_BUCKETS_S == jtr.LOCK_WAIT_BUCKETS_S
    assert ptr.HISTOGRAM_SERIES == jtr.HISTOGRAM_SERIES
    out = []
    for mod in (jtr, ptr):
        h = mod.ServingHistograms()
        for i, v in enumerate((0.0004, 0.003, 0.2, 7.0, 100.0)):
            h.ttft.observe(v)
            h.dispatch.observe(("decode", "admit")[i % 2], v / 10)
            h.lock_wait.observe("handler", v / 1000)
        tr = mod.SpanTracer(max_spans=3, clock=FakeClock(tick=0.5),
                            wallclock=lambda: 1e9)
        for k in range(4):
            tr.add("decode", "dispatch", tr.now(), tr.now(), track=k % 2,
                   live_slots=k, skipped=None)
        tr.add("submit", "request", tr.now(), track="handler", rid=1)
        out.append((h.collect(), tr.to_chrome(), tr.dropped))
    assert out[1] == out[0]
