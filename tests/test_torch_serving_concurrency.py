"""The serving engine's threads in ``deepspeed_tpu_torch``
(``inference/serving/concurrency.py`` and the engine's lock, owner and
condition) in the scenarios of ``tests/unit/test_serving_concurrency.py``.

With ``DSTPU_CONCURRENCY_CHECKS=1`` an unlocked access to a guarded field
raises, and ``GUARDED_FIELDS`` names fields the port engine has (not the
JAX engine's names); a cancel racing the mirror's retirement ends in
exactly one terminal status; concurrent submits, cancels, subscriptions
and status reads against a stepping owner, with yields at the lock seams,
serve the JAX engine's tokens; the lock meters its waiters by thread
class; a ``"block"`` submit from another thread waits on the condition;
and a lane another thread cancels is made inactive by the owner, before
its next dispatch.  Every join, wait and socket is bounded.
"""

import threading
import time
from collections import defaultdict

import numpy as np
import pytest
import torch

from torch_frontend_common import WAIT_S, drain_all, engines, workload


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


def _join(*threads):
    for t in threads:
        t.join(timeout=WAIT_S)
        assert not t.is_alive(), f"thread {t.name} did not finish"


def test_runtime_checks_trip_on_unlocked_access(monkeypatch):
    from deepspeed_tpu_torch.inference.serving.concurrency import \
        ConcurrencyViolation
    monkeypatch.setenv("DSTPU_CONCURRENCY_CHECKS", "1")
    _, eng = engines()
    srv = eng.serve()
    assert type(srv).__name__.endswith("+concurrency_checks")
    with pytest.raises(ConcurrencyViolation, match="_queue"):
        srv._queue
    with pytest.raises(ConcurrencyViolation, match="stats"):
        srv.stats["completed"] = 999
    with pytest.raises(ConcurrencyViolation, match="_deactivate"):
        srv._deactivate
    with srv._lock:
        assert len(srv._queue) == 0
    rid = srv.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=2)
    out = srv.drain()
    assert rid in out and srv.result(rid).status == "COMPLETED"
    assert srv.health_snapshot()["queue_depth"] == 0
    assert srv.close() == []


def test_checks_off_by_default(monkeypatch):
    monkeypatch.delenv("DSTPU_CONCURRENCY_CHECKS", raising=False)
    _, eng = engines()
    srv = eng.serve()
    assert not type(srv).__name__.endswith("+concurrency_checks")
    srv._queue
    srv.close()


@pytest.mark.parametrize("over", [{}, dict(paged=True, page_size=16),
                                  dict(speculative=True,
                                       spec_draft_model="self", spec_k=2)],
                         ids=["lanes", "pool", "spec"])
def test_registry_matches_engine_fields(over):
    """Every registered field exists on a live port engine (a stale entry
    would check nothing), and every mutable scheduler field the engine
    sets is registered."""
    from deepspeed_tpu_torch.inference.serving.concurrency import \
        GUARDED_FIELDS
    paged_only = {"_slot_pages", "_page_table", "_pages_dev", "_pool",
                  "_prefix"}
    spec_only = {"_draft_cache", "_draft_lanes"}
    _, eng = engines()
    srv = eng.serve(**over)
    fields = GUARDED_FIELDS["ServingEngine"]
    with srv._lock:
        for field in fields:
            if field in paged_only and not srv.paged:
                continue
            if field in spec_only and not srv.speculative:
                continue
            assert hasattr(srv, field), field
    # the rest of the instance: set once in __init__, self-locked, or the
    # guards themselves
    unguarded = set(vars(srv)) - set(fields)
    assert unguarded <= {
        "engine", "module", "device", "config", "monitor", "num_slots",
        "priority_lanes", "cache_len", "chunk", "block", "paged", "page",
        "n_slot_pages", "num_pages", "speculative", "spec_k",
        "draft_module", "max_pos", "_sample_fn", "kernel_modes",
        "_decode_prog", "_propose_prog", "_verify_prog", "_lock", "_cond",
        "wake", "_breaker", "tracing", "_hist", "_flightrec",
        "_inject_observer"}, unguarded
    srv.close()


def test_cancel_vs_retire_race_single_terminal(monkeypatch):
    """A cancel from another thread in the window where the owner's
    mirror retires the same request (a yield stretching the drain):
    exactly one terminal record, ``COMPLETED`` or ``CANCELLED``, under
    ``DSTPU_CONCURRENCY_CHECKS=1``."""
    from deepspeed_tpu_torch.runtime.fault import inject
    monkeypatch.setenv("DSTPU_CONCURRENCY_CHECKS", "1")
    _, eng = engines()
    srv = eng.serve()
    counts = defaultdict(int)
    orig_rt, orig_fin = srv._record_terminal, srv._finalize

    def counting_rt(req, status, detail):
        counts[req.rid] += 1
        return orig_rt(req, status, detail)

    def counting_fin(req):
        counts[req.rid] += 1
        return orig_fin(req)

    srv._record_terminal = counting_rt
    srv._finalize = counting_fin
    inject.configure_injection([{"point": "serving.mirror_drain",
                                 "action": "yield", "at": 1, "times": 0,
                                 "seconds": 0.002, "seed": 42}])
    rng = np.random.default_rng(0)
    errors = []
    for trial in range(25):
        rid = srv.submit(rng.integers(1, 97, (8,)).astype(np.int32),
                         max_new_tokens=3)
        delay = float(rng.random()) * 0.02

        def cancel_late(rid=rid, delay=delay, trial=trial):
            try:
                time.sleep(delay)
                srv.cancel(rid)
            except Exception as e:   # noqa: BLE001 — a KeyError is a bug
                errors.append(f"trial {trial}: {type(e).__name__}: {e}")

        t = threading.Thread(target=cancel_late)
        t.start()
        deadline = time.monotonic() + WAIT_S
        while srv.status(rid) not in ("COMPLETED", "CANCELLED") \
                and time.monotonic() < deadline:
            srv.step()
        _join(t)
        status = srv.status(rid)
        assert status in ("COMPLETED", "CANCELLED"), status
        assert counts[rid] == 1, (trial, counts[rid], status)
        assert srv.result(rid) is not None
    assert not errors, errors
    srv.drain()
    srv.close()


def test_interleaved_traffic_serves_the_jax_tokens(monkeypatch):
    """Twelve threads (more than the cores) submit, subscribe, poll and
    cancel against an owner thread that steps, with seeded yields at the
    four lock seams and a short interpreter switch interval, under
    ``DSTPU_CONCURRENCY_CHECKS=1``: no check trips, every request ends
    exactly once, the streams end with one ``end`` event carrying the
    status, and every completed request is the JAX engine's output."""
    import sys
    monkeypatch.setenv("DSTPU_CONCURRENCY_CHECKS", "1")
    jeng, eng = engines()
    prompts, news = workload(51, 12)
    want = drain_all(jeng.serve(), prompts, news)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for seed in (0, 1):
            _interleaved_run(eng, prompts, news, want, seed)
    finally:
        sys.setswitchinterval(switch)


def _interleaved_run(eng, prompts, news, want, seed):
    from deepspeed_tpu_torch.runtime.fault import inject
    inject.reset_injection()
    inject.configure_injection([
        {"point": p, "action": "yield", "times": 0, "seconds": 0.002,
         "seed": seed}
        for p in ("serving.pre_submit_lock", "serving.pre_cancel_lock",
                  "serving.pre_subscribe_lock", "serving.pre_step_lock")])
    srv = eng.serve()
    got, errors = {}, []
    stop = threading.Event()

    def owner():
        try:
            while not stop.is_set() or srv.work_pending():
                if srv.work_pending():
                    srv.step()
                else:
                    srv.wake.wait(0.01)
                    srv.wake.clear()
        except Exception as e:       # noqa: BLE001
            errors.append(e)

    def client(t):
        try:
            for k in range(t, len(prompts), 12):
                rid = srv.submit(prompts[k], max_new_tokens=news[k])
                stream = srv.token_events(rid)
                srv.status(rid)
                if k == 5:
                    srv.cancel(rid)
                toks, end = stream.tokens(timeout=WAIT_S)
                got[k] = (rid, toks, end)
        except Exception as e:       # noqa: BLE001
            errors.append(e)

    drv = threading.Thread(target=owner, name="owner")
    drv.start()
    clients = [threading.Thread(target=client, args=(t,))
               for t in range(12)]
    for c in clients:
        c.start()
    _join(*clients)
    stop.set()
    srv.wake.set()
    _join(drv)
    assert not errors, errors
    assert len(got) == len(prompts)
    for k, (rid, toks, end) in got.items():
        res = srv.result(rid)
        assert end["status"] == res.status
        if k == 5 and res.status == "CANCELLED":
            continue
        assert res.status == "COMPLETED", (k, res)
        np.testing.assert_array_equal(res.output, want[k])
        assert toks == [int(t) for t in want[k][len(prompts[k]):]]
    with srv._lock:
        assert srv.stats["lock_wait_handler_s"] >= 0.0
    assert srv._lock.acquires["handler"] > 0
    srv.close()


def test_lock_wait_observability():
    """A handler blocked on the engine lock lands in the meter, in
    ``stats`` after the next step and as labelled
    ``dstpu_serving_lock_wait_seconds`` lines in ``/metrics``."""
    from deepspeed_tpu_torch.inference.serving import ServingHTTPFrontend
    _, eng = engines()
    srv = eng.serve()
    rid = srv.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=2)
    held = threading.Event()

    def contender():
        held.wait(timeout=WAIT_S)
        srv.status(rid)

    t = threading.Thread(target=contender)
    t.start()
    with srv._lock:
        held.set()
        time.sleep(0.05)
    _join(t)
    assert srv._lock.wait_s["handler"] >= 0.04
    srv.drain()
    assert srv.stats["lock_wait_handler_s"] >= 0.04
    body = ServingHTTPFrontend(srv)._metrics_body().decode()
    for cls in ("handler", "scheduler"):
        assert f'dstpu_serving_lock_wait_seconds{{thread_class="{cls}"}}' \
            in body
    assert "dstpu_serving_lock_wait_handler_s" in body
    srv.close()


def test_instrumented_rlock_condition_compat():
    from deepspeed_tpu_torch.inference.serving.concurrency import \
        InstrumentedRLock
    lock = InstrumentedRLock()
    cond = threading.Condition(lock)
    hits = []

    def waiter():
        with lock:
            cond.wait(timeout=5)
            hits.append(True)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with lock:
        cond.notify_all()
    _join(t)
    assert hits == [True] and not lock._is_owned()
    assert sum(lock.acquires.values()) >= 3


def test_handlers_are_not_starved_by_the_owner():
    """The owner takes the lock again right after each of its 5 ms holds;
    four handler threads still get it within about one hold (without the
    owner's yield a handler waited seconds: it lost every race against the
    owner's next acquire)."""
    from deepspeed_tpu_torch.inference.serving.concurrency import \
        InstrumentedRLock
    lock = InstrumentedRLock()
    owner = {}
    lock._owner_ref = lambda: owner.get("t")
    stop, waits = threading.Event(), []

    def scheduler():
        owner["t"] = threading.current_thread()
        while not stop.is_set():
            with lock:
                t = time.perf_counter()
                while time.perf_counter() - t < 0.005:
                    pass

    def handler():
        for _ in range(20):
            t = time.perf_counter()
            with lock:
                waits.append(time.perf_counter() - t)
            time.sleep(0.002)

    sched = threading.Thread(target=scheduler, name="owner")
    sched.start()
    while "t" not in owner:
        time.sleep(0.001)
    handlers = [threading.Thread(target=handler) for _ in range(4)]
    for h in handlers:
        h.start()
    try:
        _join(*handlers)
    finally:
        stop.set()
        _join(sched)
    assert len(waits) == 80 and max(waits) < 1.0, sorted(waits)[-5:]
    assert lock.acquires["handler"] == 80 and lock.acquires["scheduler"] > 0


def test_stream_bridge_drop_counted_in_stats():
    _, eng = engines()
    srv = eng.serve()
    rid = srv.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=4)

    def dead_bridge(ev):
        raise RuntimeError("Event loop is closed")

    stream = srv.token_events(rid, on_event=dead_bridge)
    srv.drain()
    assert srv.stats["stream_bridge_drops"] == 1
    toks, end = stream.tokens(timeout=WAIT_S)
    assert end["status"] == "COMPLETED" and len(toks) == 4
    srv.close()


def test_health_snapshot_locked_view():
    _, eng = engines()
    srv = eng.serve(paged=True, page_size=16)
    snap = srv.health_snapshot()
    assert snap["closed"] is False and snap["queue_depth"] == 0
    assert snap["num_slots"] == srv.num_slots
    assert snap["breaker"]["open"] is False
    assert snap["page_pool_utilization"] == 0.0
    srv.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=2)
    assert srv.health_snapshot()["queue_depth"] == 1
    srv.drain()
    srv.close()
    assert srv.health_snapshot()["closed"] is True


def test_owner_binding_refuses_a_second_driver():
    """The first thread to drive the engine is its owner; another
    thread's ``step`` / ``drain`` / ``preempt`` / ``warmup`` raises, its
    ``release_owner`` too; once released, another thread may drive."""
    _, eng = engines()
    srv = eng.serve()
    srv.bind_owner()
    errors = []

    def other():
        for call in (srv.step, srv.drain, lambda: srv.preempt("/nonexistent"),
                     srv.warmup, srv.release_owner):
            try:
                call()
            except RuntimeError as e:
                errors.append(str(e))

    t = threading.Thread(target=other, name="intruder")
    t.start()
    _join(t)
    assert len(errors) == 5 and all("owner" in e for e in errors), errors
    srv.release_owner()
    t = threading.Thread(target=srv.bind_owner, name="successor")
    t.start()
    _join(t)
    assert srv._owner_thread is t
    srv.close()


def test_block_submit_from_another_thread_waits_for_the_owner():
    """``queue_policy="block"`` at a full queue: a submit on another
    thread waits on the lock's condition (it never steps), and returns
    once the owner's steps free a spot."""
    _, eng = engines()
    prompts, news = workload(61, 4)
    srv = eng.serve(num_slots=1, max_queue_depth=1, queue_policy="block")
    srv.bind_owner()
    first = srv.submit(prompts[0], max_new_tokens=news[0])
    got, steps_seen = [], []

    def blocked():
        got.append(srv.submit(prompts[1], max_new_tokens=news[1]))

    t = threading.Thread(target=blocked, name="handler")
    t.start()
    time.sleep(0.1)
    assert t.is_alive() and not got, "the submit must wait"
    with srv._lock:
        steps_seen.append(srv.stats["iterations"])
    deadline = time.monotonic() + WAIT_S
    while t.is_alive() and time.monotonic() < deadline:
        srv.step()
    _join(t)
    assert steps_seen == [0] and got == [first + 1]
    outs = srv.drain()
    assert set(outs) | {first} >= {first, got[0]}
    srv.close()


def test_cancel_on_another_thread_deactivates_at_the_owners_dispatch():
    """A request cancelled in its slot from another thread: its slot and
    pages are freed at once, the device write waits for the owner (no
    CUDA call off the owner's thread), and the owner's next dispatch
    makes the lane inactive before anything reuses it."""
    _, eng = engines()
    prompts, _ = workload(71, 2)
    srv = eng.serve(num_slots=2, paged=True, page_size=16)
    srv.bind_owner()
    rid = srv.submit(prompts[0], max_new_tokens=30)
    while srv.active_slots == 0:
        srv.step()
    slot = srv._requests[rid].slot
    t = threading.Thread(target=srv.cancel, args=(rid,))
    t.start()
    _join(t)
    with srv._lock:
        assert srv._deactivate == [slot]
        assert bool(srv._state["active"][slot])   # not written yet
        assert slot in srv._free and slot not in srv._slot_pages
    other = srv.submit(prompts[1], max_new_tokens=3)
    srv.step()
    with srv._lock:
        assert srv._deactivate == []
        lane = srv._requests[other].slot
        assert lane == slot or not bool(srv._state["active"][slot])
    outs = srv.drain()
    assert srv.result(rid).status == "CANCELLED" and other in outs
    srv.close()
