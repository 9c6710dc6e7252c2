"""int8 generation: ``deepspeed_tpu_torch.init_inference(..., quant=...)``
against the JAX package's ``init_inference`` on one parameter tree, with
per-channel int8 weights and an int8 KV cache (``quant.kv_cache``).

Greedy tokens must be identical on the one-pass route, the split
(chunked) prefill route and with ``decode_int8_matmuls``.  At the model
level, with the same quantized weights on both sides, the logits of a
prefill and four decode steps agree within 2e-4 (fp32; the int8 cache
rounds each row's K/V, so a 1-ulp difference in a projection can move a
payload by one step, ~0.4 % of that row's scale), the cache payloads in
≥ 99.9 % of entries and by at most 1 where they differ, and the scales at
rtol 1e-5.  The JAX trees are unrolled (``scan_layers=False``), the layout
whose quantization the port follows (see test_torch_weight_quant.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.runtime.weight_quantizer import WeightQuantization
from deepspeed_tpu_torch.models import transformer as pt

CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, dtype="float32", use_flash_attention=True,
           tie_word_embeddings=True, activation="relu", scan_layers=False)
B, P, NEW = 2, 24, 8
QUANT = {"enabled": True, "bits": 8, "per_channel": True, "kv_cache": True}


def random_tree(jmodel, seed=0):
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


@pytest.fixture(scope="module")
def setup():
    tree = random_tree(jt.Transformer(jt.TransformerConfig(**CFG)))
    sd = pt.params_from_flax(tree, pt.TransformerConfig(**CFG))
    ids = np.random.default_rng(5).integers(0, 97, (B, P)).astype(np.int32)
    return tree, sd, ids


def engines(setup, model_over=None, **config):
    tree, sd, _ = setup
    cfg = dict(CFG, **(model_over or {}))
    config = dict(dtype="float32", quant=dict(QUANT), **config)
    jeng = deepspeed_tpu.init_inference(
        jt.Transformer(jt.TransformerConfig(**cfg)), config=dict(config))
    jeng.set_params(tree)
    teng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(pt.TransformerConfig(**cfg)), config=dict(config),
        device="cpu")
    teng.set_params(sd)
    assert jeng.module.config.kv_cache_quant
    assert teng.module.config.kv_cache_quant
    return jeng, teng


def both(jeng, teng, ids, **kw):
    want = np.asarray(jeng.generate(jnp.asarray(ids), **kw))
    got = teng.generate(torch.from_numpy(np.asarray(ids)), **kw).numpy()
    return want, got


def test_one_pass_int8_greedy_identical(setup):
    jeng, teng = engines(setup)
    assert jeng.prefill_plan(B, P)[0] == teng.prefill_plan(B, P)[0] \
        == "one_pass"
    want, got = both(jeng, teng, setup[2], max_new_tokens=NEW)
    np.testing.assert_array_equal(got, want)
    for row in got[:, P:]:                     # a stream, not one token
        assert len(set(row.tolist())) >= 3, row
    # the workspace is int8 with fp32 scales, the weights int8
    cache = teng._workspace._cache
    assert cache["k"].dtype == torch.int8
    assert cache["k_scale"].shape == cache["k"].shape[:-1] + (4,)
    assert teng.module.quantized_leaves()


def test_chunked_int8_greedy_identical(setup):
    jeng, teng = engines(setup, prefill_chunk_size=8)
    assert jeng.prefill_plan(B, P)[0] == teng.prefill_plan(B, P)[0] \
        == "chunked"
    want, got = both(jeng, teng, setup[2], max_new_tokens=NEW)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk", [None, 8])
def test_int8_matmuls_greedy_identical(setup, chunk):
    jeng, teng = engines(setup, dict(kv_cache_quant=True,
                                     decode_int8_matmuls=True),
                         prefill_chunk_size=chunk)
    want, got = both(jeng, teng, setup[2], max_new_tokens=NEW)
    np.testing.assert_array_equal(got, want)


def test_kv_cache_only_greedy_identical(setup):
    """``quant={"kv_cache": True}`` alone: float weights, int8 cache; the
    knob sets the model's ``kv_cache_quant`` on both sides."""
    tree, sd, ids = setup
    config = dict(dtype="float32", quant={"kv_cache": True})
    jeng = deepspeed_tpu.init_inference(
        jt.Transformer(jt.TransformerConfig(**CFG)), config=dict(config))
    jeng.set_params(tree)
    model = pt.Transformer(pt.TransformerConfig(**CFG))
    assert not model.config.kv_cache_quant
    teng = deepspeed_tpu_torch.init_inference(model, config=dict(config),
                                              device="cpu")
    teng.set_params(sd)
    assert teng.module.config.kv_cache_quant and model.config.kv_cache_quant
    assert all(blk.attn.config.kv_cache_quant for blk in teng.module.layers)
    assert not teng.module.quantized_leaves()
    want, got = both(jeng, teng, ids, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("i8mm", [False, True], ids=["int8_kv", "i8mm"])
def test_int8_model_logits_and_caches_match_jax(setup, i8mm):
    """The same quantized weights on both sides: a one-pass prefill and
    four decode steps through the int8 cache, logits within 2e-4, cache
    payloads ≥ 99.9 % equal (off by at most 1), scales at rtol 1e-5."""
    tree, _, ids = setup
    cfg = dict(CFG, kv_cache_quant=True, decode_int8_matmuls=i8mm)
    wq = WeightQuantization(bits=8, per_channel=True)
    deq = wq.dequantize_tree(wq.quantize_tree(tree), jnp.float32)
    jmodel = jt.Transformer(jt.TransformerConfig(**cfg))
    teng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(pt.TransformerConfig(**cfg)),
        config={"dtype": "float32", "quant": dict(QUANT)}, device="cpu")
    teng.set_params(pt.params_from_flax(tree, pt.TransformerConfig(**CFG)))
    S_max = P + 8
    jcache = jmodel.init_cache(B, S_max)
    tcache = teng.module.init_cache(B, S_max)
    assert tcache["k"].dtype == torch.int8 and tcache["k_scale"].dtype == \
        torch.float32
    want, jcache = jmodel.apply(deq, jnp.asarray(ids), jcache, 0,
                                method=jt.Transformer.decode)
    with torch.no_grad():
        got, tcache = teng.module.decode(torch.from_numpy(ids).long(),
                                         tcache, 0, prefill=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    tok = np.asarray(want)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for t in range(P, P + 4):
        want, jcache = jmodel.apply(deq, jnp.asarray(tok), jcache, t,
                                    method=jt.Transformer.decode)
        with torch.no_grad():
            got, tcache = teng.module.decode(torch.from_numpy(tok).long(),
                                             tcache, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4, err_msg=f"decode step {t}")
        tok = np.asarray(want)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for key in ("k", "v"):
        mine = tcache[key].numpy().astype(np.int32)
        theirs = np.asarray(jcache[key]).astype(np.int32)
        diff = np.abs(mine - theirs)
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, \
            (diff.max(), (diff == 0).mean())
        np.testing.assert_allclose(tcache[key + "_scale"].numpy(),
                                   np.asarray(jcache[key + "_scale"]),
                                   rtol=1e-5, atol=0)
