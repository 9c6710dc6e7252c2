"""Device-memory telemetry of ``deepspeed_tpu_torch`` (``monitor/memwatch.py``
and the serving engine's ``memory_telemetry``) against the JAX package, in
the scenarios of ``tests/unit/test_memwatch.py``.

The sampler is held to the JAX sampler on the same injected reader and
owners (the same sample dicts, the same flight-recorder events); on the
CPU, where the device reports no memory, the serving engine samples an
injected reader at its scheduler seams.  Telemetry on or off serves the
same tokens, bitwise, and the JAX engine's; ``/metrics`` carries the
``dstpu_device_memory_*`` gauges through a text-format round trip.
"""

import json

import numpy as np
import pytest
import torch

from torch_frontend_common import (WAIT_S, drain_all, engines, get, post,
                                   workload)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fake_reader(in_use=1000, peak=1500, limit=16000):
    def read():
        return [{"device": "fake:0", "platform": "fake",
                 "bytes_in_use": in_use, "peak_bytes_in_use": peak,
                 "bytes_limit": limit, "limit_source": "runtime"}]
    return read


def _samplers(**kw):
    from deepspeed_tpu.monitor import memwatch as jm
    from deepspeed_tpu_torch.monitor import memwatch as pm
    return jm.DeviceMemorySampler(**kw), pm.DeviceMemorySampler(**kw)


@pytest.mark.parametrize("in_use,owners", [
    (1000, {"params": 600, "kv": 150}),
    (0, {"params": 999}),
], ids=["gap", "clamped"])
def test_sampler_owner_reconciliation_matches_jax(in_use, owners):
    """Owner reconciliation and the clamped unattributed gap: the same
    sample on both sides (``t_mono`` from one frozen clock)."""
    js, ps = _samplers(interval_s=0.0, read_fn=_fake_reader(in_use=in_use),
                       owners_fn=lambda: dict(owners), clock=lambda: 3.5)
    want, got = js.sample(), ps.sample()
    assert got == want
    assert got["unattributed_bytes"] == max(0, in_use - sum(owners.values()))


def test_sampler_interval_gating_and_flightrec_match_jax():
    from deepspeed_tpu.inference.serving.flightrec import \
        FlightRecorder as JFR
    from deepspeed_tpu_torch.inference.serving.flightrec import \
        FlightRecorder as PFR
    out = []
    for FR, side in ((JFR, 0), (PFR, 1)):
        fr = FR(64, clock=lambda: 1.0, wallclock=lambda: 2.0)
        clock = [0.0]
        s = _samplers(interval_s=10.0, read_fn=_fake_reader(),
                      owners_fn=lambda: {"a": 1}, flightrec=fr,
                      clock=lambda: clock[0])[side]
        hits = [s.maybe_sample() is not None]
        hits.append(s.maybe_sample() is not None)    # a clock compare
        clock[0] = 10.5
        hits.append(s.maybe_sample() is not None)
        events = [{k: v for k, v in e.items() if k != "thread"}
                  for e in fr.snapshot()["events"]]
        out.append((hits, s.samples, s.last, events))
    assert out[1] == out[0]
    assert out[1][0] == [True, False, True] and out[1][1] == 2


def test_tree_device_bytes_and_record_shape():
    from deepspeed_tpu_torch.monitor.memwatch import (device_memory_record,
                                                      tree_device_bytes)
    tree = {"a": torch.zeros((4, 8), dtype=torch.float32),
            "b": [torch.zeros((3,), dtype=torch.int8), None]}
    assert tree_device_bytes(tree) == 4 * 8 * 4 + 3
    rec = device_memory_record("cpu")
    assert set(rec) == {"devices", "bytes_in_use", "peak_bytes_in_use",
                        "bytes_limit"}
    assert {"device", "bytes_in_use", "bytes_limit", "limit_source"} \
        <= set(rec["devices"][0])


def test_memory_telemetry_off_on_bitwise(tmp_path):
    """Telemetry on or off: the same tokens, and the JAX engine's; the
    samples land in ``stats`` and the flight recorder, every owner the
    port can name is reported, and the off server has no sampler."""
    jeng, eng = engines()
    prompts, news = workload(11, 5, new_lo=3, new_hi=9)
    want = drain_all(jeng.serve(), prompts, news)
    srv_off = eng.serve()
    assert srv_off._memwatch is None and srv_off.memory_snapshot() is None
    assert not any(k.startswith("hbm_") for k in srv_off.stats)
    off = drain_all(srv_off, prompts, news)
    srv = eng.serve(memory_telemetry=True, memory_sample_interval_s=0.0,
                    flight_recorder=True,
                    flight_recorder_dir=str(tmp_path / "fr"))
    srv._memwatch._read = _fake_reader(in_use=10 ** 7, peak=2 * 10 ** 7)
    rids = [srv.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    outs = srv.drain()
    for w, o, r in zip(want, off, rids):
        np.testing.assert_array_equal(o, w)
        np.testing.assert_array_equal(outs[r], w)
    assert srv.stats["memory_samples"] == srv.stats["iterations"]
    assert srv.stats["hbm_peak_bytes"] == 2 * 10 ** 7
    owners = srv.memory_snapshot()["owners"]
    assert set(owners) == {"params", "kv_slots", "slot_state",
                           "prefill_lanes", "graph_pool"}
    params = sum(t.numel() * t.element_size() for t in
                 list(eng.module.parameters()) + list(eng.module.buffers()))
    assert owners["params"] == params
    kv = srv._cache
    assert owners["kv_slots"] == sum(
        t.numel() * t.element_size() for t in
        (kv.values() if isinstance(kv, dict) else kv))
    snap = srv.flightrec_snapshot()
    assert any(e["ev"] == "memory_sample" for e in snap["events"])
    with open(srv.dump_flightrec("memtest")) as f:
        assert any(e["ev"] == "memory_sample"
                   for e in json.load(f)["events"])
    srv.close()


def test_metrics_round_trip_device_memory_gauges():
    """The ``dstpu_device_memory_*`` families (``MEMORY_SERIES``, the JAX
    package's names) as gauges with HELP / TYPE; the scrape renders the
    scheduler's last sample and reconciles within it."""
    from deepspeed_tpu.monitor.memwatch import MEMORY_SERIES as JAX_SERIES
    from deepspeed_tpu_torch.inference.serving import serve_http
    from deepspeed_tpu_torch.monitor.memwatch import MEMORY_SERIES
    from tests.unit.test_serving_trace import parse_prometheus
    assert MEMORY_SERIES == JAX_SERIES
    _, eng = engines()
    prompts, _ = workload(13, 1)
    srv = eng.serve(memory_telemetry=True, memory_sample_interval_s=0.0)
    srv._memwatch._read = _fake_reader(in_use=5000, peak=7000, limit=16000)
    fe = serve_http(srv, port=0)
    try:
        conn, resp = post(fe.port, {"input_ids": [int(t) for t in prompts[0]],
                                    "max_new_tokens": 3})
        assert resp.status == 200
        resp.read()
        conn.close()
        status, body = get(fe.port, "/metrics")
        assert status == 200
    finally:
        fe.shutdown(close_engine=True)
    types, helps, samples = parse_prometheus(body.decode())
    by_name = {}
    for name, labels, value in samples:
        by_name.setdefault(name, []).append((labels, value))
    for fam in MEMORY_SERIES:
        assert types.get(fam) == "gauge" and fam in helps and by_name[fam]
    in_use = by_name["dstpu_device_memory_bytes_in_use"]
    assert in_use[0][0]["device"] == "fake:0" and in_use[0][1] == 5000.0
    limit = by_name["dstpu_device_memory_limit_bytes"][0]
    assert limit[0]["source"] == "runtime" and limit[1] == 16000.0
    owned = {la["owner"]: v for la, v in
             by_name["dstpu_device_memory_owned_bytes"]}
    assert {"params", "kv_slots", "slot_state", "prefill_lanes"} \
        <= set(owned)
    unattr = by_name["dstpu_device_memory_unattributed_bytes"][0][1]
    assert unattr == max(0.0, 5000.0 - sum(owned.values()))
    assert by_name["dstpu_serving_hbm_peak_bytes"][0][1] >= 5000.0


def test_metrics_before_the_first_step_reads_no_device():
    """A scrape before the scheduler's first step renders no memory
    series and takes no sample: sampling reads the device, which only the
    owner thread does."""
    from deepspeed_tpu_torch.inference.serving import ServingHTTPFrontend
    _, eng = engines()
    srv = eng.serve(memory_telemetry=True)
    calls = []
    srv._memwatch._read = lambda: calls.append(1) or _fake_reader()()
    body = ServingHTTPFrontend(srv)._metrics_body().decode()
    assert "dstpu_device_memory_bytes_in_use" not in body and not calls
    srv.close()


def test_memory_knobs_default_off():
    from deepspeed_tpu_torch.inference.serving.config import ServingConfig
    cfg = ServingConfig()
    assert cfg.memory_telemetry is False
    assert cfg.memory_sample_interval_s == 10.0


def test_memory_snapshot_refused_off_the_owner_thread():
    """``memory_snapshot()`` reads the device: from a thread other than
    the bound owner it raises instead of racing a graph capture."""
    import threading
    _, eng = engines()
    srv = eng.serve(memory_telemetry=True)
    srv._memwatch._read = _fake_reader()
    srv.bind_owner()
    errors = []
    t = threading.Thread(target=lambda: _record(errors, srv.memory_snapshot))
    t.start()
    t.join(WAIT_S)
    assert not t.is_alive()
    assert len(errors) == 1 and "owner" in str(errors[0])
    assert srv.memory_snapshot()["bytes_in_use"] == 1000
    srv.close()


def _record(errors, fn):
    try:
        fn()
    except RuntimeError as e:
        errors.append(e)
