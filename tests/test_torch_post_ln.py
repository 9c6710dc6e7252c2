"""OPT-350m's published layout in the port against the JAX package's, on
one parameter tree: post-LN blocks (``pre_layer_norm=False``: each norm
after its residual add, no final norm) and a narrower embedding
(``embed_proj_dim`` 16 at hidden 64) with bias-less ``project_in`` /
``project_out`` (the shapes of ``tests/unit/test_module_inject.py``'s
``test_opt_350m_layout_parity``, at the width the flash kernels' plain
versions take).

Weights are drawn with numpy into the JAX tree and converted with
``params_from_flax``.  Tolerances (fp32, summation order): logits and
cached decode 1e-4 absolute and relative; the loss 1e-5 relative and
gradients 1e-4; greedy tokens and served requests exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.runtime.weight_quantizer import (
    WeightQuantization as JWeightQuantization)
from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.runtime.weight_quantizer import WeightQuantization

CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, dtype="float32", use_flash_attention=True,
           tie_word_embeddings=True, activation="relu",
           pre_layer_norm=False, embed_proj_dim=16)
TOL = dict(rtol=1e-4, atol=1e-4)
SERVING = {"enabled": True, "num_slots": 3, "max_cache_len": 64,
           "prefill_chunk": 8, "prefill_token_budget": 16,
           "decode_block": 2, "page_size": 16}


def random_tree(jmodel, seed=0, std=0.5):
    """The JAX model's parameter tree with numpy leaves drawn from a seed:
    norm scales near 1, biases small, matrices and embeddings std 0.5 (a
    flax init would make the greedy stream one repeated token; gradient
    checks take std 0.2, as ``test_torch_train_parity.py`` does)."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), {"input_ids": jnp.zeros((1, 8), jnp.int32)}))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.1 * x
        if "bias" in name:
            return 0.1 * x
        return std * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def setup():
    jmodel = jt.Transformer(jt.TransformerConfig(**CFG))
    tree = random_tree(jmodel)
    cfg = pt.TransformerConfig(**CFG)
    sd = pt.params_from_flax(tree, cfg)
    return jmodel, tree, sd


def port_model(sd, **over):
    m = pt.Transformer(pt.TransformerConfig(**{**CFG, "remat": False,
                                               **over}), device="cpu")
    m.load_state_dict(sd)
    return m


def test_layout_and_num_params(setup):
    """No final norm, a 16-wide embedding with both projections, and the
    JAX formula's parameter count (which counts no projection)."""
    jmodel, tree, sd = setup
    flat = pt._flatten(tree["params"])
    assert not any(k.startswith("final_norm") for k in flat)
    assert flat["project_in/kernel"].shape == (16, 64)
    assert flat["project_out/kernel"].shape == (64, 16)
    m = port_model(sd)
    assert m.final_norm is None
    assert tuple(m.embed_tokens.weight.shape) == (97, 16)
    assert pt.TransformerConfig(**CFG).num_params() == \
        jt.TransformerConfig(**CFG).num_params()


def test_params_roundtrip_is_the_identity(setup):
    """``params_to_flax ∘ params_from_flax`` gives every leaf of the tree
    back bitwise, stacked (``scan_layers``) and unrolled."""
    _, tree, sd = setup
    flat = pt._flatten(tree["params"])
    back = pt.params_to_flax(sd, pt.TransformerConfig(**CFG))
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    unrolled = pt.TransformerConfig(**{**CFG, "scan_layers": False})
    flat_u = pt.params_to_flax(sd, unrolled)
    again = pt.params_from_flax(flat_u, unrolled)
    for k, v in sd.items():
        assert torch.equal(again[k], v), k


def test_projections_quantize_as_jax(setup):
    """``quantize_weights_`` takes ``project_in`` / ``project_out`` as the
    JAX ``WeightQuantization`` takes their flax kernels: the same int8
    payloads and scales."""
    _, tree, sd = setup
    m = port_model(sd)
    m.quantize_weights_(WeightQuantization(bits=8, per_channel=True),
                        torch.float32)
    got = m.quantized_leaves()
    want = JWeightQuantization(bits=8, per_channel=True).quantize_tree(
        {k: jnp.asarray(v) for k, v in pt._flatten(tree["params"]).items()})
    for path in ("project_in/kernel", "project_out/kernel"):
        np.testing.assert_array_equal(got[path].q.numpy(),
                                      np.asarray(want[path].q))
        np.testing.assert_array_equal(got[path].scale.numpy(),
                                      np.asarray(want[path].scale))


def test_logits_match_jax(setup):
    jmodel, tree, sd = setup
    ids = np.random.default_rng(1).integers(0, 97, (2, 20)).astype(np.int32)
    want = jmodel.apply(tree, jnp.asarray(ids), method=jt.Transformer.logits)
    with torch.no_grad():
        got = port_model(sd).logits(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("chunks", [0, 4], ids=["full", "chunked"])
def test_loss_and_grads_match_jax(setup, chunks):
    """The causal-LM loss, full and in 4 sequence chunks (the head chains
    ``project_out`` inside each chunk), and every parameter's gradient."""
    tree = random_tree(setup[0], seed=1, std=0.2)
    sd = pt.params_from_flax(tree, pt.TransformerConfig(**CFG))
    ids = np.random.default_rng(2).integers(0, 97, (2, 16)).astype(np.int32)
    jm = jt.Transformer(jt.TransformerConfig(**{**CFG,
                                                "loss_seq_chunks": chunks}))
    loss, grads = jax.value_and_grad(
        lambda p: jm.apply(p, {"input_ids": jnp.asarray(ids)}))(tree)
    want = pt.params_from_flax(grads, pt.TransformerConfig(**CFG))
    m = port_model(sd, loss_seq_chunks=chunks)
    got_loss = m({"input_ids": torch.from_numpy(ids).long()})
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(loss),
                               rtol=1e-5)
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "pool"])
def test_prefill_then_cached_decode_match_jax(setup, paged):
    """One-pass prefill (flash) then 4 cached decode steps, over a slab
    cache and (port only) over a page pool, against the JAX decode."""
    jmodel, tree, sd = setup
    B, P, steps, S_max = 2, 12, 4, 16
    ids = np.random.default_rng(3).integers(0, 97, (B, P + steps))
    ids = ids.astype(np.int32)
    jcache = jmodel.init_cache(B, S_max, dtype=jnp.float32)
    want, jcache = jmodel.apply(tree, jnp.asarray(ids[:, :P]), jcache, 0,
                                method=jt.Transformer.decode)
    m = port_model(sd)
    if paged:
        page = 8
        cache = m.init_paged_cache(1 + B * S_max // page, page,
                                   dtype=torch.float32)
        cache["pages"] = torch.arange(1, 1 + B * S_max // page).view(B, -1)
    else:
        cache = m.init_cache(B, S_max, dtype=torch.float32)
    with torch.no_grad():
        if paged:     # a pool takes chunks: the whole prompt is one
            got, cache = m.decode(torch.from_numpy(ids[:, :P]).long(),
                                  cache, 0)
        else:
            got, cache = m.decode(torch.from_numpy(ids[:, :P]).long(),
                                  cache, 0, prefill=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for t in range(P, P + steps):
        want, jcache = jmodel.apply(tree, jnp.asarray(ids[:, t:t + 1]),
                                    jcache, t, method=jt.Transformer.decode)
        with torch.no_grad():
            got, cache = m.decode(torch.from_numpy(ids[:, t:t + 1]).long(),
                                  cache, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"decode step {t}")


def _engines(tree, sd, **config):
    config = dict(dtype="float32", **config)
    jeng = deepspeed_tpu.init_inference(
        jt.Transformer(jt.TransformerConfig(**CFG)), config=dict(config))
    jeng.set_params(tree)
    teng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(pt.TransformerConfig(**CFG)), config=dict(config),
        device="cpu")
    teng.set_params(sd)
    return jeng, teng


@pytest.mark.parametrize("chunk", [None, 8], ids=["one_pass", "chunked"])
def test_greedy_tokens_match_jax(setup, chunk):
    _, tree, sd = setup
    jeng, teng = _engines(tree, sd, prefill_chunk_size=chunk)
    ids = np.random.default_rng(5).integers(0, 97, (2, 24)).astype(np.int32)
    want = np.asarray(jeng.generate(jnp.asarray(ids), max_new_tokens=8))
    got = teng.generate(torch.from_numpy(ids), max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(got[0, 24:].tolist())) >= 3     # a stream, not one token


def test_served_requests_match_jax(setup):
    """7 requests on 3 slots: a JAX paged ``ServingEngine`` and the port's
    server on a page pool and on monolithic lanes give every request the
    same tokens, each equal to its solo ``generate()``."""
    _, tree, sd = setup
    config = {"prefill_chunk_size": 8, "serving": dict(SERVING, paged=True)}
    jeng, teng = _engines(tree, sd, **config)
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(1, 97, (int(p),)).astype(np.int32), int(n))
            for p, n in zip(rng.integers(9, 21, 7), rng.integers(3, 13, 7))]
    jsrv = jeng.serve()
    jrids = [jsrv.submit(p, max_new_tokens=n) for p, n in reqs]
    jouts = jsrv.drain()
    for paged in (True, False):
        srv = teng.serve(paged=paged)
        rids = [srv.submit(p, max_new_tokens=n) for p, n in reqs]
        outs = srv.drain()
        for (p, n), rid, jrid in zip(reqs, rids, jrids):
            np.testing.assert_array_equal(outs[rid], jouts[jrid])
            solo = teng.generate(torch.from_numpy(p[None]).long(),
                                 max_new_tokens=n).numpy()[0]
            np.testing.assert_array_equal(outs[rid], solo)
