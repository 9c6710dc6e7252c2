"""The serving front end on the card (``cuda`` marker; skipped without a
CUDA device; no JAX import):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_serving_frontend_cuda.py

Each server here is put behind ``serve_http`` before it captured anything:
its decode block is captured by the scheduler thread while handler threads
scrape ``/metrics`` and ``/healthz``, poll statuses and stream tokens.  A
CUDA call of another thread during a capture would fail the capture (the
capture's global error mode); each test asserts one capture per program and
the tokens of the same requests served directly on the same engine.
"""

import json
import threading

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference.serving import serve_http
from deepspeed_tpu_torch.models import transformer as pt
from torch_frontend_common import WAIT_S, get, post, read_stream

CARD = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
            max_seq_len=128, use_flash_attention=True)
SERVING = {"enabled": True, "num_slots": 4, "max_cache_len": 128,
           "prefill_chunk": 16, "prefill_token_budget": 32,
           "decode_block": 4, "page_size": 16}
SELF = dict(speculative=True, spec_draft_model="self", spec_k=3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels and CUDA graphs)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _engine(dtype):
    eng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(pt.TransformerConfig(**dict(CARD, dtype=dtype))),
        config={"dtype": dtype, "serving": dict(SERVING)}, device="cuda")
    eng.init_params(0)
    return eng


def _requests(n=12, seed=8):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, int(rng.integers(5, 60))).astype(np.int32),
             int(m)) for m in rng.integers(2, 40, n)]


def _busy_handlers(port, stop, errors):
    """Scrape /metrics and /healthz and poll statuses until ``stop``."""
    def loop():
        try:
            while not stop.is_set():
                for path in ("/metrics", "/healthz", "/v1/requests/0"):
                    status, _ = get(port, path)
                    if status not in (200, 404):
                        errors.append(f"{path}: {status}")
        except Exception as e:           # noqa: BLE001
            errors.append(repr(e))
    threads = [threading.Thread(target=loop, name=f"scraper {k}")
               for k in range(3)]
    for t in threads:
        t.start()
    return threads


def _over_http(srv, reqs):
    """Every request posted from its own thread (odd ones streaming) while
    three scrapers keep the handlers busy; ``{i: output}``."""
    outs, errors = {}, []
    stop = threading.Event()
    fe = serve_http(srv, port=0)
    scrapers = _busy_handlers(fe.port, stop, errors)

    def client(i):
        try:
            p, n = reqs[i]
            conn, resp = post(fe.port, {"input_ids": [int(t) for t in p],
                                        "max_new_tokens": n,
                                        "stream": bool(i % 2)})
            assert resp.status == 200, resp.status
            if i % 2:
                toks, end, n_end = read_stream(resp)
                assert end["status"] == "COMPLETED" and n_end == 1
                outs[i] = np.concatenate([p, np.asarray(toks, np.int32)])
            else:
                outs[i] = np.asarray(json.loads(resp.read())["output"])
            conn.close()
        except Exception as e:           # noqa: BLE001
            errors.append(repr(e))

    clients = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    try:
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=WAIT_S)
    finally:
        stop.set()
        for t in scrapers:
            t.join(timeout=WAIT_S)
        fe.shutdown()
    assert not errors, errors
    assert not any(t.is_alive() for t in clients + scrapers)
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(paged=True), {}, dict(paged=True, **SELF)],
                         ids=["pool", "lanes", "spec_pool"])
def test_card_capture_under_http_load(cuda, kw):
    """The first capture runs on the scheduler thread while the handlers
    are busy: one capture per program, every output the direct server's."""
    eng = _engine("float32")
    reqs = _requests()
    ref = eng.serve(**kw)
    rids = [ref.submit(p, max_new_tokens=n) for p, n in reqs]
    want = ref.drain()
    ref.close()
    srv = eng.serve(**kw, tracing=True, flight_recorder=True,
                    memory_telemetry=True, memory_sample_interval_s=0.0)
    got = _over_http(srv, reqs)
    for i, r in enumerate(rids):
        np.testing.assert_array_equal(got[i], want[r])
    assert [p.captures for p in srv._progs] == [1] * len(srv._progs)
    with srv._lock:
        assert srv.stats["memory_samples"] > 0
        assert srv._memwatch.last["bytes_in_use"] > 0
    srv.close()


@pytest.mark.cuda
def test_card_observability_off_on_same_tokens_and_captures(cuda):
    """bf16 over a pool: tracing, telemetry and the recorder on or off
    serve bitwise the same tokens with the same captures."""
    eng = _engine("bfloat16")
    reqs = _requests(seed=9)
    runs = []
    for over in ({}, dict(tracing=True, flight_recorder=True,
                          memory_telemetry=True)):
        srv = eng.serve(paged=True, **over)
        runs.append((_over_http(srv, reqs),
                     [p.captures for p in srv._progs]))
        srv.close()
    (a, ca), (b, cb) = runs
    assert ca == cb == [1]
    for i in range(len(reqs)):
        np.testing.assert_array_equal(a[i], b[i])


@pytest.mark.cuda
def test_card_profile_endpoint_names_k6_and_k7(cuda, tmp_path):
    """``POST /debug/profile`` during a pool's traffic: the trace holds K6
    and K7 launches; no capture fails around it."""
    from deepspeed_tpu_torch.profiling.trace import _group
    eng = _engine("bfloat16")
    reqs = _requests(24, seed=10)
    srv = eng.serve(paged=True, profile_endpoint=True, decode_block=1)
    fe = serve_http(srv, port=0, profile_dir=str(tmp_path))
    prof, errors = {}, []

    def profile():
        status, body = get(fe.port, "/debug/profile?secs=1", "POST")
        prof.update(json.loads(body), status=status)

    try:
        conns = [post(fe.port, {"input_ids": [int(t) for t in p],
                                "max_new_tokens": n})
                 for p, n in reqs[:12]]
        t = threading.Thread(target=profile)
        t.start()
        conns += [post(fe.port, {"input_ids": [int(t) for t in p],
                                 "max_new_tokens": n})
                  for p, n in reqs[12:]]
        for conn, resp in conns:
            if resp.status != 200:
                errors.append(resp.status)
            resp.read()
            conn.close()
        t.join(timeout=WAIT_S)
    finally:
        fe.shutdown()
    assert not errors and prof["status"] == 200, (errors, prof)
    with open(prof["trace"]) as f:
        names = {_group(e["name"]) for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    assert {"K6 decode_kernel (paged)", "K7 flash_fwd_kernel (paged)"} \
        <= names, names
    assert srv._decode_prog.captures == 1
    srv.close()
