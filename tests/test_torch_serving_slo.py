"""The serving request lifecycle of ``deepspeed_tpu_torch`` — deadlines and
shedding, the bounded queue, the circuit breaker, drain timeouts, and
preempt → crash-atomic snapshot → restore — against the JAX package, in
the scenarios of ``tests/unit/test_serving_slo.py`` and
``tests/unit/test_serving_spec.py``'s preemption test.

The JAX file's ``tiny_cfg`` and ``SERVING`` in fp32 on the CPU, the
weights the JAX tests draw (``model.init(jax.random.key(0), ...)``)
converted by ``params_from_flax``.  Every request that completes, or
resumes from a snapshot, gives the JAX engine's greedy tokens for the same
request, bitwise (one JAX server drains every request of every scenario
once: ``jax_reference``); statuses, details and stats follow the JAX
tests' own assertions.  Beyond them: preemption over a page pool, a
snapshot written by the JAX engine restored by the port, a request shed in
its slot on a pool stopping on the device (its next occupant's pages stay
its own), ``close()`` reporting the same ids on every call, and the
config knobs this slice ports.

The card tests (``cuda`` marker, skipped without a card; no JAX import)
count graph captures per server through overload, shed, cancel, preempt
and restore, and read the lane of a request shed in its slot on a pool:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_serving_slo.py
"""

import functools
import json
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference.serving import config as serving_config
from deepspeed_tpu_torch.inference.serving.config import ServingConfig
from deepspeed_tpu_torch.inference.serving.slo import (CircuitOpen,
                                                       DrainTimeout,
                                                       QueueFull,
                                                       RequestStatus)
from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.runtime.fault import inject
from deepspeed_tpu_torch.runtime.fault.manifest import (list_tags,
                                                        verify_manifest)

# tests/unit/test_serving_slo.py's tiny_cfg() and SERVING
CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, use_flash_attention=False, dtype="float32")
SERVING = {"enabled": True, "num_slots": 3, "max_cache_len": 64,
           "prefill_chunk": 8, "prefill_token_budget": 16,
           "decode_block": 2}
POOL = dict(paged=True, page_size=8)
SELF = dict(speculative=True, spec_draft_model="self")
# the lifecycle knobs, and the front end's (ported since)
LIFECYCLE = ("max_queue_depth", "queue_policy", "default_deadline_s",
             "breaker_threshold", "breaker_cooldown_s", "drain_timeout_s",
             "drain_budget_s")
FRONT_END = ("priority_lanes", "priority_aging_s", "fairness_tokens_per_s",
             "fairness_window_s", "tracing", "trace_max_spans",
             "flight_recorder", "flight_recorder_events",
             "flight_recorder_dir", "profile_endpoint", "memory_telemetry",
             "memory_sample_interval_s")


def _jax():
    import jax
    import jax.numpy as jnp
    import deepspeed_tpu
    from deepspeed_tpu.models import transformer as jt
    return jax, jnp, deepspeed_tpu, jt


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny models run thousands of small ops: one intra-op thread
    keeps a parallel test run's workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _disarm_injection():
    inject.reset_injection()
    yield
    inject.reset_injection()


@functools.lru_cache(maxsize=None)
def _engines():
    """The JAX engine and the port's over the JAX tests' parameters."""
    jax, jnp, deepspeed_tpu, jt = _jax()
    model = jt.Transformer(jt.TransformerConfig(**CFG))
    ids = jnp.asarray(np.random.default_rng(0).integers(0, 97, (2, 12)),
                      jnp.int32)
    params = model.init(jax.random.key(0), {"input_ids": ids})
    config = {"dtype": "float32", "prefill_chunk_size": 8,
              "serving": dict(SERVING)}
    jeng = deepspeed_tpu.init_inference(model, config=dict(config))
    jeng.set_params(params)
    cfg = pt.TransformerConfig(**CFG)
    eng = deepspeed_tpu_torch.init_inference(pt.Transformer(cfg),
                                             config=dict(config),
                                             device="cpu")
    eng.set_params(pt.params_from_flax(jax.tree.map(np.asarray, params),
                                       cfg))
    return jeng, eng


@pytest.fixture(scope="module")
def eng():
    return _engines()[1]


def _prompts(rng, n, lo=9, hi=21):
    return [rng.integers(1, 97, (int(p),)).astype(np.int32)
            for p in rng.integers(lo, hi, (n,))]


# the scenarios' requests, drawn as the JAX tests draw them
def w_shed():
    p1, p2 = _prompts(np.random.default_rng(41), 2)
    return [(p1, 5), (p2, 5)]


def w_in_slot():
    p1, p2 = _prompts(np.random.default_rng(43), 2)
    return [(p1, 30), (p2, 4)]


def w_cancel():
    p1, p2, p3 = _prompts(np.random.default_rng(45), 3)
    return [(p1, 30), (p2, 5), (p3, 4)]


def w_backpressure():
    return [(p, 3) for p in _prompts(np.random.default_rng(47), 5)]


def w_breaker():
    prompts = _prompts(np.random.default_rng(49), 4)
    return [(p, 4) for p in prompts] + [(prompts[0], 3)]


def w_half_open():
    return [(_prompts(np.random.default_rng(59), 1)[0], 3)]


def w_seams():
    return [(p, 4) for p in _prompts(np.random.default_rng(53), 2)]


def w_preempt():
    rng = np.random.default_rng(55)
    prompts = _prompts(rng, 5)
    news = [int(n) for n in rng.integers(6, 13, (5,))]
    return list(zip(prompts, news))


def w_fit():
    rng = np.random.default_rng(61)
    big = rng.integers(1, 97, (50,)).astype(np.int32)
    ok = rng.integers(1, 97, (10,)).astype(np.int32)
    return [(big, 40), (ok, 4)]


def w_spec():
    """test_serving_spec.py's ``_mixed_workload(rng(29), n=3)`` prompts,
    14 new tokens each."""
    rng = np.random.default_rng(29)
    lens = rng.integers(9, 21, (3,))
    rng.integers(3, 13, (3,))                # the unused max_new draws
    return [(rng.integers(1, 97, (int(p),)).astype(np.int32), 14)
            for p in lens]


def w_pool_shed():
    """test_torch_spec_serving.py's cancelled-lane workload: two long
    requests and a newcomer whose prompt spans several pages."""
    rng = np.random.default_rng(5)
    long_a, long_c = (rng.integers(1, 97, 10).astype(np.int32)
                      for _ in range(2))
    newcomer = rng.integers(1, 97, 30).astype(np.int32)
    return [(long_c, 40), (long_a, 40), (newcomer, 6)]


WORKLOADS = (w_shed, w_in_slot, w_cancel, w_backpressure, w_breaker,
             w_half_open, w_seams, w_preempt, w_spec, w_pool_shed)


@functools.lru_cache(maxsize=None)
def jax_reference():
    """One JAX server over every scenario's requests (and the fitting one
    of ``w_fit``): ``{(prompt, max_new): output}``.  Greedy serving gives
    each request its solo ``generate()`` tokens (the JAX tests' proof),
    so one drain stands for every scenario."""
    jeng = _engines()[0]
    reqs = {(tuple(int(t) for t in p), n): p
            for w in WORKLOADS for p, n in w()}
    p_ok, n_ok = w_fit()[1]
    reqs[(tuple(int(t) for t in p_ok), n_ok)] = p_ok
    srv = jeng.serve(num_slots=8)
    rids = {key: srv.submit(p, max_new_tokens=key[1])
            for key, p in reqs.items()}
    outs = srv.drain()
    return {key: np.asarray(outs[r]) for key, r in rids.items()}


def want(p, n):
    return jax_reference()[(tuple(int(t) for t in p), n)]


def check(out, p, n, what=""):
    np.testing.assert_array_equal(np.asarray(out), want(p, n),
                                  err_msg=what)


# --------------------------------------------------------------------- #
# Deadlines: shed before admission, retire in slot
# --------------------------------------------------------------------- #
def test_deadline_shed_before_admission(eng):
    (p1, n1), (p2, n2) = w_shed()
    srv = eng.serve()
    r_ok = srv.submit(p1, max_new_tokens=n1, client_id="ok")
    r_shed = srv.submit(p2, max_new_tokens=n2, deadline_s=0.0)
    outs = srv.drain()
    assert sorted(outs) == sorted([r_ok, r_shed])
    assert outs[r_shed] is None
    res = srv.result(r_shed)
    assert res.status == RequestStatus.SHED_DEADLINE
    assert "never occupied a slot" in res.detail
    assert srv.stats["admitted"] == 1, "shed request must not admit"
    assert srv.stats["shed"] == 1
    ok = srv.result(r_ok)
    assert ok.status == RequestStatus.COMPLETED
    assert ok.client_id == "ok" and ok.ttft_s is not None
    check(outs[r_ok], p1, n1)


def test_deadline_retires_in_slot_and_slot_is_reusable(eng):
    (p1, n1), (p2, n2) = w_in_slot()
    srv = eng.serve(num_slots=1)
    r1 = srv.submit(p1, max_new_tokens=n1, deadline_s=60.0)
    r2 = srv.submit(p2, max_new_tokens=n2)
    while srv.active_slots == 0:
        srv.step()
    slot = srv._requests[r1].slot
    srv._requests[r1].deadline = time.monotonic() - 1.0   # force expiry
    srv._shed_expired()                  # the top of the next step()
    # the shed lane was written inactive on the device at once
    assert not bool(srv._state["active"][slot])
    assert srv.active_slots == 0
    outs = srv.drain()
    assert outs.get(r1, None) is None
    assert srv.result(r1).status == RequestStatus.SHED_DEADLINE
    assert "in slot" in srv.result(r1).detail
    check(outs[r2], p2, n2)


def test_cancel_queued_and_running(eng):
    (p1, n1), (p2, n2), (p3, n3) = w_cancel()
    srv = eng.serve(num_slots=1)
    r1 = srv.submit(p1, max_new_tokens=n1)
    r2 = srv.submit(p2, max_new_tokens=n2)
    assert srv.cancel(r2) is True
    assert srv.result(r2).status == RequestStatus.CANCELLED
    assert srv.cancel(r2) is False, "terminal requests cannot re-cancel"
    with pytest.raises(KeyError, match="unknown request id"):
        srv.cancel(10**9)
    while srv.active_slots == 0:
        srv.step()
    assert srv.cancel(r1) is True
    assert srv.active_slots == 0
    r3 = srv.submit(p3, max_new_tokens=n3)
    outs = srv.drain()
    assert outs.get(r1, None) is None and outs.get(r2, "x") in (None, "x")
    check(outs[r3], p3, n3)
    assert srv.stats["cancelled"] == 2


# --------------------------------------------------------------------- #
# Backpressure: bounded queue, reject / block
# --------------------------------------------------------------------- #
def test_backpressure_reject_and_block(eng):
    reqs = w_backpressure()
    srv = eng.serve(num_slots=1, max_queue_depth=2, queue_policy="reject")
    srv.submit(reqs[0][0], max_new_tokens=3)
    srv.submit(reqs[1][0], max_new_tokens=3)
    with pytest.raises(QueueFull, match="max_queue_depth=2"):
        srv.submit(reqs[2][0], max_new_tokens=3)
    srv.drain()

    srv2 = eng.serve(num_slots=1, max_queue_depth=2, queue_policy="block")
    rids = [srv2.submit(p, max_new_tokens=n) for p, n in reqs]
    assert srv2.stats["iterations"] > 0, "block ran the scheduler inline"
    outs = srv2.drain()
    outs.update({r: srv2.result(r).output for r in rids
                 if r not in outs})          # finished while blocking
    for r, (p, n) in zip(rids, reqs):
        check(outs[r], p, n)
    with pytest.raises(ValueError, match="queue_policy"):
        eng.serve(queue_policy="drop")


# --------------------------------------------------------------------- #
# Circuit breaker
# --------------------------------------------------------------------- #
def _make_sick(srv):
    """Every device call of ``srv`` fails (through the server's own
    failure path) while ``sick[0]``: JAX's ``_run_guarded`` patch."""
    real = srv._guarded
    sick = [True]

    def guarded(fn, *args, point=None):
        if sick[0]:
            def fn(*_):
                raise RuntimeError("injected sick-device dispatch failure")
        return real(fn, *args, point=point)

    srv._guarded = guarded
    return sick


def test_circuit_breaker_trips_rejects_and_recovers(eng):
    reqs = w_breaker()
    srv = eng.serve(num_slots=2, breaker_threshold=2,
                    breaker_cooldown_s=0.05)
    rids = [srv.submit(p, max_new_tokens=n) for p, n in reqs[:4]]
    sick = _make_sick(srv)
    srv.step()                           # failure 1 — absorbed
    assert not srv._breaker.open
    srv.step()                           # failure 2 — the breaker trips
    assert srv._breaker.open
    assert srv.stats["dispatch_failures"] == 2
    with pytest.raises(CircuitOpen, match="consecutive dispatch"):
        srv.submit(reqs[0][0], max_new_tokens=2)
    # open breaker: no dispatches are attempted at all
    calls = srv.stats["prefill_tokens"]
    srv.step()
    assert srv.stats["prefill_tokens"] == calls
    sick[0] = False
    time.sleep(0.06)                     # past the cooldown -> half-open
    outs = srv.drain()
    assert not srv._breaker.open
    status = [srv.result(r).status for r in rids]
    # the JAX test's outcome: the first two admissions die with the device
    assert status == [RequestStatus.ABORTED] * 2 \
        + [RequestStatus.COMPLETED] * 2, status
    for r, (p, n) in zip(rids[2:], reqs[2:4]):
        check(outs[r], p, n)
    assert srv._breaker.trips == 1
    p, n = reqs[4]
    r_new = srv.submit(p, max_new_tokens=n)
    check(srv.drain()[r_new], p, n)


def test_circuit_breaker_half_open_admits_submissions(eng):
    ((p1, n1),) = w_half_open()
    srv = eng.serve(num_slots=1, breaker_threshold=2,
                    breaker_cooldown_s=0.05)
    srv._breaker.record_failure(RuntimeError("boom 1"))
    srv._breaker.record_failure(RuntimeError("boom 2"))
    assert srv._breaker.open
    with pytest.raises(CircuitOpen):
        srv.submit(p1, max_new_tokens=n1)
    time.sleep(0.06)                      # cooldown elapsed -> half-open
    r = srv.submit(p1, max_new_tokens=n1)  # admitted: the probe's work
    out = srv.drain()[r]
    assert not srv._breaker.open          # the probe dispatch succeeded
    check(out, p1, n1)


def test_restore_rejects_requests_that_do_not_fit(eng, tmp_path):
    """A snapshot from a server with longer lanes (the JAX test's, written
    by the JAX engine) restored onto the port's: the request that cannot
    fit ends ABORTED with the reason, the other resumes; and a port
    snapshot restored onto a pool too small for it is refused the same
    way."""
    jeng = _engines()[0]
    (p_big, n_big), (p_ok, n_ok) = w_fit()
    big = jeng.serve(max_cache_len=128, num_slots=2)
    r_big = big.submit(p_big, max_new_tokens=n_big)
    r_ok = big.submit(p_ok, max_new_tokens=n_ok)
    big.preempt(str(tmp_path / "lanes"), drain_budget_s=0.0)

    small = eng.serve(max_cache_len=64, num_slots=2)
    assert small.restore(str(tmp_path / "lanes")) == [r_ok]
    res = small.result(r_big)
    assert res.status == RequestStatus.ABORTED
    assert "cache positions" in res.detail
    outs = small.drain()
    assert r_big in outs and outs[r_big] is None
    check(outs[r_ok], p_ok, n_ok)

    (p, _), _ = w_in_slot()
    lanes = eng.serve()
    rid = lanes.submit(p, max_new_tokens=30)
    lanes.preempt(str(tmp_path / "pool"), drain_budget_s=0.0)
    tiny_pool = eng.serve(**POOL, num_pages=4)     # 3 pages of 8
    assert tiny_pool.restore(str(tmp_path / "pool")) == []
    assert tiny_pool.result(rid).status == RequestStatus.ABORTED
    assert "pages" in tiny_pool.result(rid).detail


# --------------------------------------------------------------------- #
# drain() timeout diagnostics
# --------------------------------------------------------------------- #
def test_drain_timeout_reports_per_slot_diagnostics(eng):
    p1 = _prompts(np.random.default_rng(51), 1)[0]
    srv = eng.serve(num_slots=2)
    r1 = srv.submit(p1, max_new_tokens=30)
    while srv.active_slots == 0:
        srv.step()
    srv._dispatch_decode = lambda: False          # wedge the scheduler
    with pytest.raises(DrainTimeout) as ei:
        srv.drain(timeout_s=0.2)
    msg = str(ei.value)
    assert "slot" in msg and f"request {r1}" in msg \
        and "last dispatch" in msg, msg
    # the config's default bounds drain() too
    srv.config.drain_timeout_s = 0.1
    with pytest.raises(DrainTimeout, match="0.1s wall-clock budget"):
        srv.drain()


# --------------------------------------------------------------------- #
# Serving fault-injection seams
# --------------------------------------------------------------------- #
SEAMS = ("serving.pre_admit", "serving.pre_decode_dispatch",
         "serving.mid_drain", "serving.sigterm_at_iter",
         "serving.mirror_drain")


def test_serving_seams_registered_and_fire(eng):
    for point in SEAMS:
        assert point in inject.injection_points()
    (p1, n1), (p2, n2) = w_seams()
    srv = eng.serve(num_slots=1)
    srv.submit(p1, max_new_tokens=n1)
    inject.configure_injection({"point": "serving.pre_decode_dispatch",
                                "action": "raise"})
    with pytest.raises(IOError, match="injected transient fault"):
        srv.drain()
    inject.reset_injection()
    assert srv.active_slots == 0 and not srv._events
    r2 = srv.submit(p2, max_new_tokens=n2)
    check(srv.drain()[r2], p2, n2)


def test_every_serving_seam_is_hit(eng, tmp_path):
    """Each seam the port fires is reached on a run that admits, decodes,
    drains under ``preempt()`` and processes events; a ``DSTPU_FAULT_
    INJECT``-style spec arms them (armed past their hits: none fires)."""
    armed = inject.configure_injection(";".join(
        f"point={p},action=raise,at=100000" for p in SEAMS))
    srv = eng.serve(num_slots=2)
    for p, n in w_preempt()[:3]:
        srv.submit(p, max_new_tokens=n)
    for _ in range(4):
        srv.step()
    srv.preempt(str(tmp_path), drain_budget_s=60.0)
    hits = {s.point: s.hits for s in armed}
    assert all(hits[p] > 0 for p in SEAMS), hits


# --------------------------------------------------------------------- #
# Preempt -> snapshot -> restore, bitwise
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("pool", [False, True], ids=["lanes", "pool"])
def test_preempt_snapshot_resume_bitwise(eng, pool, tmp_path):
    """Requests with partial tokens snapshot crash-atomically; a fresh
    server restores them (same rids and client ids, prefix continuation)
    and each stitched output equals the JAX engine's; the snapshot keeps
    the generator's state under ``rng_torch`` only."""
    from deepspeed_tpu_torch.inference.serving.snapshot import \
        read_snapshot_tag
    reqs = w_preempt()
    kw = POOL if pool else {}
    srv = eng.serve(num_slots=2, **kw)
    rids = [srv.submit(p, max_new_tokens=n, client_id=i)
            for i, (p, n) in enumerate(reqs)]
    stream = srv.token_events(rids[0])
    early = {}
    for _ in range(6):
        early.update(srv.step())
    tag, snapped, finished = srv.preempt(str(tmp_path), drain_budget_s=0.0)
    finished = {**early, **finished}
    assert snapped, "expected undrained work at preemption"
    assert srv.close() == sorted(snapped)
    assert verify_manifest(str(tmp_path / tag)) == []
    state = read_snapshot_tag(str(tmp_path), tag)
    assert any(r["tokens"] for r in state["requests"]), \
        "expected a mid-decode request with partial tokens"
    assert {r["rid"] for r in state["requests"]} == set(snapped)
    assert "rng_torch" in state and "rng" not in state
    if pool:
        assert any("pages" in r for r in state["requests"])
    if rids[0] in snapped:
        assert stream.tokens(timeout=1)[1]["status"] \
            == RequestStatus.PREEMPTED
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(reqs[0][0], max_new_tokens=2)

    srv2 = eng.serve(num_slots=2, **kw)
    restored = srv2.restore(str(tmp_path))
    assert sorted(restored) == sorted(snapped)
    assert srv2.stats["resumed"] == len(restored)
    outs = dict(finished)
    outs.update(srv2.drain())
    for i, (rid, (p, n)) in enumerate(zip(rids, reqs)):
        check(outs[rid], p, n, f"resumed request {rid}")
        if rid in restored:
            assert srv2.result(rid).client_id == i
    assert srv2.submit(reqs[0][0], max_new_tokens=2) not in rids
    srv2.drain()


def test_snapshot_corruption_walks_back(tmp_path):
    from deepspeed_tpu_torch.inference.serving.snapshot import (
        load_newest_snapshot, save_snapshot)
    req = {"rid": 0, "client_id": None, "prompt": [1, 2, 3], "tokens": [],
           "max_new": 4, "eos": -1, "deadline_remaining_s": None,
           "submitted_it": 0}
    save_snapshot(str(tmp_path), "serving_1",
                  {"seq": 1, "next_rid": 1, "rng_torch": [0, 0],
                   "requests": [req]})
    save_snapshot(str(tmp_path), "serving_2",
                  {"seq": 2, "next_rid": 2, "rng_torch": [0, 0],
                   "requests": [dict(req, rid=1)]})
    tag, state = load_newest_snapshot(str(tmp_path))
    assert tag == "serving_2" and state["requests"][0]["rid"] == 1
    assert list_tags(str(tmp_path)) == ["serving_2", "serving_1"]
    # size-preserving corruption: manifest checksums catch it, walk back
    payload = tmp_path / "serving_2" / "serving_state.json"
    raw = bytearray(payload.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    payload.write_bytes(bytes(raw))
    assert verify_manifest(str(tmp_path / "serving_2"))
    tag, state = load_newest_snapshot(str(tmp_path))
    assert tag == "serving_1" and state["requests"][0]["rid"] == 0
    # stale staging orphans are never candidates
    (tmp_path / "serving_9.tmp").mkdir()
    tag, _ = load_newest_snapshot(str(tmp_path))
    assert tag == "serving_1"
    with pytest.raises(ValueError, match="staging"):
        save_snapshot(str(tmp_path), "serving_3.tmp", {"requests": []})


@pytest.mark.parametrize("pool", [False, True], ids=["lanes", "pool"])
def test_spec_preempt_restore_bitwise(eng, pool, tmp_path):
    """``preempt()`` mid-speculation snapshots COMMITTED tokens only
    (every snapshotted token list is a prefix of the final output) and
    nothing of the draft's; a restarted speculative server resumes to the
    JAX engine's tokens."""
    reqs = w_spec()
    kw = dict(spec_k=3, **SELF, **(POOL if pool else {}))
    srv = eng.serve(**kw)
    rids = [srv.submit(p, max_new_tokens=n) for p, n in reqs]
    for _ in range(4):
        srv.step()
    tag, snapped, finished = srv.preempt(str(tmp_path), drain_budget_s=0.0)
    assert snapped, "nothing was mid-flight — the test lost its point"
    state = json.loads((tmp_path / tag / "serving_state.json").read_text())
    assert not any("draft" in k for k in state), \
        "draft state must be re-derived on restore, never snapshotted"

    srv2 = eng.serve(**kw)
    restored = srv2.restore(str(tmp_path))
    assert sorted(restored) == sorted(snapped)
    outs = dict(finished)
    outs.update(srv2.drain())
    by_rid = {int(r["rid"]): r for r in state["requests"]}
    assert any(by_rid[r]["tokens"] for r in by_rid)
    for rid, (p, n) in zip(rids, reqs):
        check(outs[rid], p, n)
        if rid in by_rid:
            snap_toks = [int(t) for t in by_rid[rid]["tokens"]]
            gen = [int(t) for t in outs[rid][len(p):]]
            assert snap_toks == gen[:len(snap_toks)], (snap_toks, gen)


def test_jax_snapshot_restored_by_port(eng, tmp_path):
    """A snapshot the JAX engine's ``preempt()`` wrote mid-decode, restored
    by the port's server: the resumed outputs equal the JAX engine's
    uninterrupted run (the JAX key in ``rng`` is ignored)."""
    jeng = _engines()[0]
    reqs = w_preempt()
    jsrv = jeng.serve(num_slots=2)
    rids = [jsrv.submit(p, max_new_tokens=n, client_id=i)
            for i, (p, n) in enumerate(reqs)]
    early = {}
    for _ in range(6):
        early.update(jsrv.step())
    tag, snapped, finished = jsrv.preempt(str(tmp_path),
                                          drain_budget_s=0.0)
    state = json.loads((tmp_path / tag / "serving_state.json").read_text())
    assert "rng" in state and "rng_torch" not in state
    assert any(r["tokens"] for r in state["requests"])
    srv = eng.serve(num_slots=2)
    gen_state = srv._gen.get_state()
    assert sorted(srv.restore(str(tmp_path))) == sorted(snapped)
    assert torch.equal(srv._gen.get_state(), gen_state)
    outs = {**early, **finished}
    outs.update(srv.drain())
    for i, (rid, (p, n)) in enumerate(zip(rids, reqs)):
        check(outs[rid], p, n, f"request {rid}")
        if rid in snapped:
            assert srv.result(rid).client_id == i


# --------------------------------------------------------------------- #
# A lane shed in its slot stops on the device; close() keeps its report
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_in_slot_shed_stops_the_lane_on_a_pool(eng, spec):
    """A request shed at its deadline in its slot stops on the device at
    once: the slot's next occupant prefills into pages its table row now
    maps over several iterations while another slot keeps decoding, and
    its tokens (and the other's) stay the JAX engine's."""
    (p_c, n_c), (p_a, n_a), (p_b, n_b) = w_pool_shed()
    kw = dict(spec_k=2, **SELF) if spec else {}
    srv = eng.serve(**POOL, num_slots=2, prefill_token_budget=8, **kw)
    rc = srv.submit(p_c, max_new_tokens=n_c)
    ra = srv.submit(p_a, max_new_tokens=n_a, deadline_s=60.0)
    rb = srv.submit(p_b, max_new_tokens=n_b)
    while srv.status(ra) != RequestStatus.RUNNING \
            or not srv._mirror_active[srv._requests[ra].slot]:
        srv.step()
    srv._requests[ra].deadline = time.monotonic() - 1.0
    outs = srv.drain()
    assert srv.result(ra).status == RequestStatus.SHED_DEADLINE
    check(outs[rb], p_b, n_b)
    check(outs[rc], p_c, n_c)


def test_close_reports_the_same_ids_every_call(eng):
    """``close()`` is idempotent: every call returns the sorted ids that
    were undrained at the first (JAX ``tests/unit/test_serving.py``
    ``test_serving_close_releases_and_recovers``)."""
    (p, n), _ = w_in_slot()
    srv = eng.serve()
    r1 = srv.submit(p, max_new_tokens=4)
    assert srv.drain()[r1] is not None
    q = srv.submit(p, max_new_tokens=4)        # left undrained on purpose
    assert srv.close() == [q]
    assert srv._cache is None
    assert srv.result(q).status == RequestStatus.ABORTED
    assert srv.close() == [q]
    assert srv.close() == [q]
    with pytest.raises(RuntimeError, match="closed ServingEngine"):
        srv.submit(p, max_new_tokens=4)


def test_lifecycle_knobs_ported_and_the_rest_raise():
    """The seven lifecycle knobs parse, and so do the twelve front-end
    knobs, ported since: no serving knob raises ``NotImplementedError``
    any more but ``paged_kernel=False`` (the gather path the port does not
    offer)."""
    defaults = {k: v for k, v in ServingConfig().to_dict().items()}
    assert not hasattr(serving_config, "NOT_PORTED")
    for knob in FRONT_END:
        d = defaults[knob]
        off = (not d) if isinstance(d, bool) else \
            (d + "x" if isinstance(d, str) else d + 1)
        assert getattr(ServingConfig(**{knob: off}), knob) == off
    with pytest.raises(NotImplementedError, match="paged_kernel=False"):
        ServingConfig(paged_kernel=False)
    cfg = ServingConfig(max_queue_depth=4, queue_policy="block",
                        default_deadline_s=1.5, breaker_threshold=2,
                        breaker_cooldown_s=0.5, drain_timeout_s=3.0,
                        drain_budget_s=0.0)
    assert (cfg.max_queue_depth, cfg.queue_policy, cfg.drain_budget_s) \
        == (4, "block", 0.0)
    with pytest.raises(ValueError, match="queue_policy"):
        ServingConfig(queue_policy="drop")


def test_default_deadline_and_priority(eng):
    (p1, n1), _ = w_shed()
    srv = eng.serve(default_deadline_s=1e-9)
    rid = srv.submit(p1, max_new_tokens=n1)
    assert srv.drain() == {rid: None}
    assert srv.result(rid).status == RequestStatus.SHED_DEADLINE
    with pytest.raises(ValueError, match="priority_lanes=1"):
        srv.submit(p1, max_new_tokens=n1, priority=1)


def test_fault_modules_stand_alone(tmp_path, monkeypatch):
    """The port's manifest fingerprints torch and the device, the
    injection spec syntax is JAX's, and the elastic agent counts the
    devices torch sees."""
    from deepspeed_tpu_torch.elasticity import DSElasticAgent
    from deepspeed_tpu_torch.runtime.fault.manifest import build_manifest
    (tmp_path / "a.bin").write_bytes(b"x" * 10)
    fp = build_manifest(str(tmp_path), "t")["fingerprint"]
    assert fp == {"torch": torch.__version__, "device_type": "cpu",
                  "device_count": 1}
    monkeypatch.setenv(inject.ENV_VAR,
                       "point=serving.pre_admit,action=raise,at=2,times=0")
    monkeypatch.setattr(inject, "_env_loaded", False)
    inject.fire("serving.pre_admit")
    for _ in range(2):
        with pytest.raises(inject.InjectedFault):
            inject.fire("serving.pre_admit")
    with pytest.raises(ValueError, match="unknown injection action"):
        inject.configure_injection("point=serving.mid_drain,action=nap")
    # the serving lock seams' yield is ported: a seeded random sleep
    (spec,) = inject.configure_injection(
        "point=serving.mid_drain,action=yield,seconds=0.001,times=0")
    inject.fire("serving.mid_drain")
    assert spec.fired == 1
    inject.reset_injection()
    assert DSElasticAgent({}).world_size == 1


# --------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------- #
CARD = dict(CFG, hidden_size=256, vocab_size=512, max_seq_len=128,
            use_flash_attention=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels and CUDA graphs)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_engine(dtype="float32"):
    eng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(pt.TransformerConfig(**dict(CARD, dtype=dtype))),
        config={"dtype": dtype, "serving": dict(
            SERVING, max_cache_len=128, num_slots=4, page_size=16)},
        device="cuda")
    eng.init_params(0)
    return eng


def _card_requests(n=10, seed=4):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, int(rng.integers(5, 60))), int(m))
            for m in rng.integers(2, 30, n)]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(paged=True), dict(spec_k=3, **SELF)],
                         ids=["lanes", "pool", "spec"])
def test_card_graph_captures_per_server(cuda, kw, tmp_path):
    """Overload (a queue past the slots), a deadline shed, a cancel, a
    preemption mid-decode and a restore: one capture per program per
    server, and every output equal to the uninterrupted server's."""
    eng = _card_engine()
    reqs = _card_requests()
    ref = eng.serve(**kw)
    ref_rids = [ref.submit(p, max_new_tokens=n) for p, n in reqs]
    want = ref.drain()
    srv = eng.serve(**kw)
    srv.warmup()
    got = {}
    rids = [srv.submit(p, max_new_tokens=n) for p, n in reqs]
    shed = srv.submit(reqs[0][0], max_new_tokens=4, deadline_s=0.0)
    cancel = srv.submit(reqs[1][0], max_new_tokens=4)
    srv.cancel(cancel)
    for _ in range(4):
        got.update(srv.step())
    _, snapped, finished = srv.preempt(str(tmp_path), drain_budget_s=0.0)
    got.update(finished)
    assert snapped
    assert srv.result(shed).status == RequestStatus.SHED_DEADLINE
    srv2 = eng.serve(**kw)
    srv2.warmup()
    srv2.restore(str(tmp_path))
    got.update(srv2.drain())
    for r, r_ref in zip(rids, ref_rids):
        np.testing.assert_array_equal(got[r], want[r_ref])
    for server in (srv, srv2):
        assert [p.captures for p in server._progs] \
            == [1] * len(server._progs)


@pytest.mark.cuda
def test_card_in_slot_shed_stops_the_lane_on_a_pool(cuda):
    """On the card, a request shed in its slot on a pool: its lane reads
    inactive on the device at the next step, and its neighbours' tokens
    equal their solo runs."""
    eng = _card_engine()
    rng = np.random.default_rng(5)
    long_a, long_c = (rng.integers(0, 512, 10) for _ in range(2))
    newcomer = rng.integers(0, 512, 60)
    srv = eng.serve(paged=True, page_size=16, num_slots=2,
                    prefill_token_budget=8)
    rc = srv.submit(long_c, max_new_tokens=90)
    ra = srv.submit(long_a, max_new_tokens=90, deadline_s=600.0)
    rb = srv.submit(newcomer, max_new_tokens=8)
    while srv.status(ra) != RequestStatus.RUNNING \
            or not srv._mirror_active[srv._requests[ra].slot]:
        srv.step()
    slot = srv._requests[ra].slot
    srv._requests[ra].deadline = time.monotonic() - 1.0
    srv._shed_expired()                  # the top of the next step()
    assert not bool(srv._state["active"][slot].item())
    outs = srv.drain()
    solo = eng.serve(paged=True, page_size=16, num_slots=2)
    want = {r: solo.submit(p, max_new_tokens=n)
            for r, p, n in ((rb, newcomer, 8), (rc, long_c, 90))}
    ref = solo.drain()
    for r, r_ref in want.items():
        np.testing.assert_array_equal(outs[r], ref[r_ref])
