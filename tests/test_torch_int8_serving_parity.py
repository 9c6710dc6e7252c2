"""int8 serving on the CPU: ``engine.serve()`` of an engine with
per-channel int8 weights and an int8 KV cache (``quant`` block) against
the port's solo ``generate()`` and a JAX paged int8 ``ServingEngine``.

The contract is the JAX package's ``test_paged_int8_kv_serving_matches_
solo`` (``tests/unit/test_serving_paged.py``): mixed requests on 3 slots,
eos probed mid-stream, give every request the greedy tokens of its solo
``generate()`` (same ``prefill_chunk_size`` as the serving chunk) on a
paged int8 pool (K7-int8 admission, K6-int8 decode, plain versions on
the CPU) and on monolithic int8 lanes (K3-int8 / K2-int8) — and those
equal a JAX paged ``ServingEngine``'s on the same weights and config.
The pool holds int8 pages and fp32 scale pages in the same layout, so a
shared prefix shares its scales.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.ops.transformer import decode_attention as da
from deepspeed_tpu_torch.ops.transformer import paged_attention as pa

CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, dtype="float32", use_flash_attention=True,
           tie_word_embeddings=True, activation="relu", scan_layers=False)
SERVING = {"enabled": True, "num_slots": 3, "max_cache_len": 64,
           "prefill_chunk": 8, "prefill_token_budget": 16,
           "decode_block": 2, "page_size": 16}
QUANT = {"enabled": True, "bits": 8, "per_channel": True, "kv_cache": True}
N_REQ = 7


def random_tree(jmodel, seed=0):
    """Numpy-drawn parameter tree (as in test_torch_serving_parity.py)."""
    ids = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0),
                                                {"input_ids": ids}))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.1 * x
        if "bias" in name:
            return 0.1 * x
        return 0.5 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def solo(eng, prompt, new, eos=-1):
    return eng.generate(torch.from_numpy(prompt[None]).long(),
                        max_new_tokens=new, eos_token_id=eos).numpy()[0]


@pytest.fixture(scope="module")
def setup():
    jmodel = jt.Transformer(jt.TransformerConfig(**CFG))
    tree = random_tree(jmodel)
    sd = pt.params_from_flax(tree, pt.TransformerConfig(**CFG))
    eng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(pt.TransformerConfig(**CFG)),
        config={"dtype": "float32", "prefill_chunk_size": 8,
                "serving": dict(SERVING), "quant": dict(QUANT)},
        device="cpu")
    eng.set_params(sd)
    rng = np.random.default_rng(11)
    lens = rng.integers(9, 21, (N_REQ,))
    news = [int(x) for x in rng.integers(3, 13, (N_REQ,))]
    prompts = [rng.integers(1, 97, (int(p),)).astype(np.int32) for p in lens]
    eos = [int(solo(eng, p, n)[len(p) + n // 2]) if i % 2 == 0 else -1
           for i, (p, n) in enumerate(zip(prompts, news))]
    want = [solo(eng, p, n, e) for p, n, e in zip(prompts, news, eos)]
    return dict(jmodel=jmodel, tree=tree, eng=eng, prompts=prompts,
                news=news, eos=eos, want=want)


def serve_all(srv, s):
    rids = [srv.submit(p, max_new_tokens=n, eos_token_id=e)
            for p, n, e in zip(s["prompts"], s["news"], s["eos"])]
    outs = srv.drain()
    assert sorted(outs) == sorted(rids)
    return [outs[r] for r in rids]


@pytest.mark.parametrize("route", ["monolithic", "paged_16", "paged_64"])
def test_int8_serving_matches_solo_generate(setup, route, monkeypatch):
    """Every request's tokens equal its solo int8 ``generate()``; the pool
    or lanes are int8 with fp32 scales; each layer's decode step runs the
    int8-KV decode (K6 paged, K2 monolithic) and each prefill chunk the
    int8-KV chunk kernel (K7 / K3) — counted at the plain versions."""
    s = setup
    paged = route != "monolithic"
    over = dict(paged=paged)
    if paged:
        over["page_size"] = int(route.split("_")[1])
    calls = {"decode": 0, "chunk": 0}
    decode_fn = pa.paged_decode_attention_plain if paged \
        else da.decode_attention_plain
    chunk_fn = pa.paged_chunk_prefill_attention_plain if paged \
        else da.chunk_prefill_attention_plain

    def counted(key, fn):
        def wrapper(*args, **kw):
            assert kw.get("k_scale") is not None    # the int8-KV mode
            calls[key] += 1
            return fn(*args, **kw)
        return wrapper

    mod = pa if paged else da
    monkeypatch.setattr(mod, decode_fn.__name__, counted("decode", decode_fn))
    monkeypatch.setattr(mod, chunk_fn.__name__, counted("chunk", chunk_fn))
    srv = s["eng"].serve(**over)
    assert srv.kernel_modes["decode"] == ("cuda_paged_decode" if paged
                                          else "cuda_decode")
    got = serve_all(srv, s)
    for g, w in zip(got, s["want"]):
        np.testing.assert_array_equal(g, w)
    L, st = CFG["num_layers"], srv.stats
    assert calls == {"decode": L * srv.block * st["decode_calls"],
                     "chunk": L * st["prefill_tokens"] // srv.chunk}
    assert srv._cache["k"].dtype == torch.int8
    assert srv._cache["k_scale"].dtype == torch.float32
    assert srv._cache["k_scale"].shape == srv._cache["k"].shape[:-1] + (4,)


def test_jax_paged_int8_serving_matches_port(setup):
    """A JAX paged int8 ServingEngine and the port's on the same requests,
    config and weights give equal tokens."""
    s = setup
    jeng = deepspeed_tpu.init_inference(
        s["jmodel"], config={"dtype": "float32", "prefill_chunk_size": 8,
                             "serving": dict(SERVING, paged=True),
                             "quant": dict(QUANT)})
    jeng.set_params(s["tree"])
    assert jeng.module.config.kv_cache_quant
    jsrv = jeng.serve()
    rids = [jsrv.submit(p, max_new_tokens=n, eos_token_id=e)
            for p, n, e in zip(s["prompts"], s["news"], s["eos"])]
    jouts = jsrv.drain()
    got = serve_all(s["eng"].serve(paged=True), s)
    for rid, g, w in zip(rids, got, s["want"]):
        np.testing.assert_array_equal(g, jouts[rid])
        np.testing.assert_array_equal(g, w)


def test_int8_prefix_sharing_shares_scales(setup):
    """Requests behind one page-aligned prefix on an int8 pool: the prefix
    is prefilled once (its payload and scale pages shared) and every
    request's tokens equal its solo ``generate()``."""
    s = setup
    eng = s["eng"]
    rng = np.random.default_rng(5)
    prefix = rng.integers(1, 97, (32,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(1, 97, (5,))
                               .astype(np.int32)]) for _ in range(4)]
    srv = eng.serve(paged=True, prefix_cache=True)
    rids = [srv.submit(p, max_new_tokens=6) for p in prompts]
    outs = srv.drain()
    assert srv.stats["prefix_hits"] == 3
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(outs[rid], solo(eng, p, 6))
