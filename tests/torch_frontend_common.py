"""Shared set-up of the serving front-end parity tests
(``tests/test_torch_serving_{frontend,trace,concurrency}.py``,
``tests/test_torch_memwatch.py``, ``tests/test_torch_monitor.py``; the
card tests use its HTTP helpers only), imported as
``torch_frontend_common``: pytest puts ``tests/`` on the path.

The JAX front-end tests' tiny OPT (``tests/unit/test_serving_frontend.py``
``tiny_cfg``: 2 layers, hidden 64, vocabulary 97) in fp32 on the CPU; the
port's weights are the JAX tests' (``model.init(jax.random.key(0), ...)``)
converted by ``params_from_flax``.  One JAX engine and one port engine per
process (``engines()``); each test opens its own servers over them.
"""

import functools
import http.client
import json
import time
import types

import numpy as np

CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, use_flash_attention=False, dtype="float32")
SERVING = {"enabled": True, "num_slots": 3, "max_cache_len": 64,
           "prefill_chunk": 8, "prefill_token_budget": 16,
           "decode_block": 2}
# how long a test waits on any socket, thread or stream before failing
WAIT_S = 60


@functools.lru_cache(maxsize=None)
def engines():
    """``(jax_engine, port_engine)`` over the same weights."""
    import jax
    import jax.numpy as jnp
    import deepspeed_tpu
    from deepspeed_tpu.models import transformer as jt
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as pt
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


def workload(seed, n, lo=9, hi=21, new_lo=3, new_hi=13):
    """``n`` prompts and budgets, drawn as the JAX front-end tests draw
    theirs."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, 97, (int(p),)).astype(np.int32)
               for p in rng.integers(lo, hi, (n,))]
    news = [int(x) for x in rng.integers(new_lo, new_hi, (n,))]
    return prompts, news


def drain_all(srv, prompts, news, **submit_kw):
    """Submit every request, drain, close; the outputs in submit order."""
    rids = [srv.submit(p, max_new_tokens=n, **submit_kw)
            for p, n in zip(prompts, news)]
    outs = srv.drain()
    srv.close()
    return [np.asarray(outs[r]) for r in rids]


class FakeClock:
    """A clock that moves only when told (``advance``) or by ``tick`` on
    every read."""

    def __init__(self, t=0.0, tick=0.0):
        self.t, self.tick = float(t), float(tick)

    def __call__(self):
        self.t += self.tick
        return self.t

    def advance(self, dt):
        self.t += dt


def clock_module(clock):
    """A stand-in for an engine module's ``time``: ``monotonic`` is
    ``clock``, everything else the real module's."""
    return types.SimpleNamespace(monotonic=clock,
                                 perf_counter=time.perf_counter,
                                 sleep=time.sleep, time=time.time)


def post(port, payload, timeout=WAIT_S):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/generate", json.dumps(payload))
    return conn, conn.getresponse()


def get(port, path, method="GET", timeout=WAIT_S):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, body


def read_stream(resp):
    """An NDJSON token stream: ``(tokens, end event, end-event count)``."""
    toks, end, n_end = [], None, 0
    while True:
        line = resp.readline()
        if not line:
            break
        ev = json.loads(line)
        assert "event" in ev, ev
        if ev["event"] == "token":
            toks.append(ev["token"])
        else:
            end, n_end = ev, n_end + 1
    return toks, end, n_end

