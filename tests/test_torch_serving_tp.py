"""Serving at tensor-parallel size 2 (world 2, gloo on the CPU) of the port
against the JAX serving engine at tp 2 on the CPU mesh
(``tests/torch_tp_worker.py`` suite ``serve``; one launch for the module):

- ``InferenceEngine.serve()`` at tp 2 over slot lanes, over a page pool
  (warmed up first: the followers capture alike) and sampled: rank 0
  submits and drains, rank 1 ``follow()``s; fp32 greedy tokens equal JAX's
  ``init_inference(tensor_parallel.tp_size=2).serve()`` tokens and the
  port's tp-1 server's, and every rank's outputs, statuses and replayed
  token streams are equal (the sampled ones bitwise);
- a lifecycle decided on rank 0 — a deadline shed from the queue, a
  deadline that passes later, a cancel of a queued and of a running
  request — with rank 1's clock a day ahead: both ranks end every request
  alike, with equal streams (rank 1 takes no time decision);
- ``serve_http`` at tp 2 listens on rank 0 only (rank 1 returns its
  follower results, binding nothing): its tokens equal direct submits';
- the circuit breaker is refused at tp 2, and a fault injected into rank
  1's decode dispatch alone ends both ranks' servers with a clean error
  (rank 0's in its next collective, once rank 1's process ends), not a
  hang.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.parallel.topology import reset_topology

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as pt

import torch_tp_common as common
from test_torch_serving_parity import random_tree

CFG = dict(common.OPT, use_flash_attention=True)
SERVING = {"enabled": True, "num_slots": 3, "max_cache_len": 64,
           "prefill_chunk": 8, "prefill_token_budget": 16,
           "decode_block": 2, "page_size": 16}
ROUTES = {"mono": {}, "paged": {"paged": True, "page_size": 16},
          "sample": {"do_sample": True, "temperature": 1.0, "seed": 5}}
N_REQ = 7


def _workload(sd):
    """7 requests, eos probed mid-stream on every other one (from the
    port's tp-1 solo greedy stream)."""
    eng = _port_tp1(sd)
    rng = np.random.default_rng(3)
    lens = rng.integers(9, 21, (N_REQ,))
    news = [int(x) for x in rng.integers(3, 13, (N_REQ,))]
    prompts = [rng.integers(1, 96, (int(n),)).astype(np.int32) for n in lens]
    reqs = []
    for i, (p, n) in enumerate(zip(prompts, news)):
        e = -1
        if i % 2 == 0:
            e = int(eng.generate(torch.from_numpy(p[None]).long(),
                                 max_new_tokens=n)[0, len(p) + n // 2])
        reqs.append((p, n, e))
    return eng, reqs


def _port_tp1(sd):
    eng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(pt.TransformerConfig(**CFG)),
        config={"dtype": "float32", "prefill_chunk_size": 8,
                "serving": dict(SERVING)}, device="cpu")
    eng.set_params(sd)
    return eng


def _jax_served(tree, reqs, **kw):
    reset_topology()
    try:
        eng = deepspeed_tpu.init_inference(
            jt.Transformer(jt.TransformerConfig(**CFG)),
            config={"dtype": "float32", "prefill_chunk_size": 8,
                    "tensor_parallel": {"tp_size": 2},
                    "serving": dict(SERVING)})
        eng.set_params(tree)
        assert eng.topology.tp == 2
        srv = eng.serve(**kw)
        rids = [srv.submit(jnp.asarray(p), max_new_tokens=n, eos_token_id=e)
                for p, n, e in reqs]
        outs = srv.drain()
        return [np.asarray(outs[r]) for r in rids]
    finally:
        reset_topology()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_tp")
    tree = random_tree(jt.Transformer(jt.TransformerConfig(**CFG)))
    sd = pt.params_from_flax(tree, pt.TransformerConfig(**CFG))
    tp1, reqs = _workload(sd)
    inp = {"cfg": CFG, "serving": SERVING, "sd": sd, "requests": reqs,
           "routes": ROUTES}
    torch.save(inp, tmp / "input.pt")
    (tmp / "serve").mkdir()
    proc = common.launch(2, "serve", tmp / "serve", tmp / "input.pt")
    try:
        ref = {"mono": _jax_served(tree, reqs),
               "paged": _jax_served(tree, reqs, paged=True, page_size=16)}
        for route in ("mono", "paged"):
            srv = tp1.serve(**ROUTES[route])
            rids = [srv.submit(p, max_new_tokens=n, eos_token_id=e)
                    for p, n, e in reqs]
            outs = srv.drain()
            ref[f"tp1_{route}"] = [outs[r] for r in rids]
        ranks = common.join(proc, tmp / "serve", "serve", 2)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"ref": ref, "ranks": ranks, "reqs": reqs}


def _same_on_both_ranks(a, b):
    assert a["status"] == b["status"]
    assert a["detail"] == b["detail"]
    assert a["streams"] == b["streams"]
    assert sorted(a["outs"]) == sorted(b["outs"])
    for rid, out in a["outs"].items():
        if out is None:
            assert b["outs"][rid] is None
        else:
            np.testing.assert_array_equal(out, b["outs"][rid])


@pytest.mark.parametrize("route", ["mono", "paged"])
def test_tp2_greedy_equals_jax_tp2_and_port_tp1(results, route):
    r0, r1 = (r[route] for r in results["ranks"])
    _same_on_both_ranks(r0, r1)
    assert r0["returned"] == r1["returned"] == list(range(N_REQ))
    got = [r0["outs"][i] for i in range(N_REQ)]
    for g, want, tp1 in zip(got, results["ref"][route],
                            results["ref"][f"tp1_{route}"]):
        np.testing.assert_array_equal(g, want)
        np.testing.assert_array_equal(g, tp1)
    assert set(r0["status"].values()) == {"COMPLETED"}


def test_sampled_streams_are_bitwise_equal_on_both_ranks(results):
    r0, r1 = (r["sample"] for r in results["ranks"])
    _same_on_both_ranks(r0, r1)
    greedy = results["ranks"][0]["mono"]["outs"]
    assert any(not np.array_equal(r0["outs"][i], greedy[i])
               for i in range(N_REQ))


def test_rank0_decides_sheds_and_cancels_with_rank1_clock_skewed(results):
    r0, r1 = (r["lifecycle"] for r in results["ranks"])
    _same_on_both_ranks(r0, r1)
    status = r0["status"]
    assert status[0] == "SHED_DEADLINE"
    assert "while queued" in r0["detail"][0]
    assert status[1] == "SHED_DEADLINE"
    cancelled = [r for r, s in status.items() if s == "CANCELLED"]
    assert len(cancelled) == 2
    assert any("in slot" in r0["detail"][r] for r in cancelled)
    assert any("while queued" in r0["detail"][r] for r in cancelled)
    done = [r for r, s in status.items() if s == "COMPLETED"]
    assert len(done) == N_REQ - 4
    # the completed ones are the greedy outputs
    mono = results["ranks"][0]["mono"]["outs"]
    for r in done:
        np.testing.assert_array_equal(r0["outs"][r], mono[r])


def test_serve_http_listens_on_rank0_only(results):
    r0, r1 = (r["http"] for r in results["ranks"])
    assert r1 == {"follower_result": "dict"}
    mono = results["ranks"][0]["mono"]["outs"]
    assert len(r0["outputs"]) == N_REQ
    for i, out in enumerate(r0["outputs"]):
        np.testing.assert_array_equal(np.asarray(out, np.int32), mono[i])


def test_breaker_refused_and_one_rank_failure_fails_the_group(results):
    r0, r1 = results["ranks"]
    for r in (r0, r1):
        assert "breaker_threshold=2 at tensor-parallel size 2" in r["breaker"]
        assert "ROADMAP.md" in r["breaker"]
    f0, f1 = r0["failure"], r1["failure"]
    assert "a dispatch failed on this rank (InjectedFault" in f1["error"]
    assert "a dispatch failed on this rank" in f0["error"]
    assert "InjectedFault" not in f0["error"]
    for f in (f0, f1):
        assert f["closed"]
        assert set(f["status"]) <= {"ABORTED", "COMPLETED"}
        assert "ABORTED" in f["status"]
    # rank 0 fails as rank 1's process ends, not at a collective timeout
    assert f0["at"] - f1["at"] < 60
