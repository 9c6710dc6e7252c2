"""The port's OPT model against the JAX package's, on one parameter tree.

A tiny OPT (2 layers, hidden 64, 4 heads, vocab 97, fp32, flash attention
on) gets weights drawn with numpy (normal, std 0.5 — a flax init would
make the greedy stream one repeated token) and loaded into both packages
through ``params_from_flax``.  Logits agree at 2e-4, the bar of
``tests/unit/test_inference.py``; the difference is fp32 summation order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.models import transformer as pt

TOL = dict(rtol=2e-4, atol=2e-4)
CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, dtype="float32", use_flash_attention=True,
           tie_word_embeddings=True, activation="relu")


def random_tree(jmodel, seed=0):
    """The JAX model's parameter tree with numpy leaves drawn from a seed:
    norm scales near 1, biases small, matrices and embeddings std 0.5."""
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
def models():
    jcfg = jt.TransformerConfig(**CFG)
    jmodel = jt.Transformer(jcfg)
    tree = random_tree(jmodel)
    tmodel = pt.Transformer(pt.TransformerConfig(**CFG), device="cpu")
    tmodel.load_state_dict(pt.params_from_flax(tree, tmodel.config))
    return jmodel, tree, tmodel


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def test_params_from_flax_uses_every_leaf_once(models):
    jmodel, tree, tmodel = models
    sd = pt.params_from_flax(tree, tmodel.config)
    assert set(sd) == set(tmodel.state_dict())
    assert sum(v.numel() for v in sd.values()) == \
        sum(int(np.prod(l.shape)) for l in _leaves(tree))
    # an extra leaf is refused, a missing one too
    extra = {"params": dict(tree["params"], stray={"kernel": np.zeros(3)})}
    with pytest.raises(ValueError, match="not used"):
        pt.params_from_flax(extra, tmodel.config)
    missing = {"params": {k: v for k, v in tree["params"].items()
                          if k != "final_norm"}}
    with pytest.raises(KeyError, match="final_norm"):
        pt.params_from_flax(missing, tmodel.config)


def test_params_from_flax_unstacked_layout(models):
    """``scan_layers=False`` trees (``layers_{i}``) convert to the same
    state dict as the stacked form."""
    _, tree, tmodel = models
    p = dict(tree["params"])
    stacked = p.pop("layers")
    for i in range(CFG["num_layers"]):
        p[f"layers_{i}"] = jax.tree_util.tree_map(lambda a: a[i], stacked)
    a = pt.params_from_flax(tree, tmodel.config)
    b = pt.params_from_flax({"params": p}, tmodel.config)
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_logits_match_jax(models):
    jmodel, tree, tmodel = models
    ids = np.random.default_rng(1).integers(0, 97, (2, 20)).astype(np.int32)
    want = jmodel.apply(tree, jnp.asarray(ids), method=jt.Transformer.logits)
    with torch.no_grad():
        got = tmodel.logits(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_then_cached_decode_matches_jax(models):
    """One-pass prefill (flash) then 4 cached decode steps (fused write)."""
    jmodel, tree, tmodel = models
    B, P, steps = 2, 12, 4
    ids = np.random.default_rng(2).integers(0, 97, (B, P + steps))
    ids = ids.astype(np.int32)
    S_max = 16
    jcache = jmodel.init_cache(B, S_max, dtype=jnp.float32)
    want, jcache = jmodel.apply(tree, jnp.asarray(ids[:, :P]), jcache, 0,
                                method=jt.Transformer.decode)
    tcache = tmodel.init_cache(B, S_max, dtype=torch.float32)
    with torch.no_grad():
        got, tcache = tmodel.decode(torch.from_numpy(ids[:, :P]).long(),
                                    tcache, 0, prefill=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for t in range(P, P + steps):
        want, jcache = jmodel.apply(tree, jnp.asarray(ids[:, t:t + 1]),
                                    jcache, t, method=jt.Transformer.decode)
        with torch.no_grad():
            got, tcache = tmodel.decode(
                torch.from_numpy(ids[:, t:t + 1]).long(), tcache, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"decode step {t}")
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               **TOL)


def test_unported_features_raise():
    for over in (dict(position_embedding="rope"), dict(num_kv_heads=2),
                 dict(pre_layer_norm=False), dict(gated_mlp=True),
                 dict(embed_proj_dim=32),
                 dict(moe_num_experts=2, scan_layers=False)):
        with pytest.raises(NotImplementedError):
            pt.Transformer(pt.TransformerConfig(**dict(CFG, **over)))
    # int8 KV is ported; its int8 x int8 mode still needs it, as in JAX
    pt.Transformer(pt.TransformerConfig(**dict(CFG, kv_cache_quant=True)))
    with pytest.raises(ValueError, match="kv_cache_quant"):
        pt.TransformerConfig(**dict(CFG, decode_int8_matmuls=True))
