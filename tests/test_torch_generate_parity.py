"""``deepspeed_tpu_torch.init_inference(..., device="cpu").generate`` against
the JAX package's ``init_inference(...).generate`` on one parameter tree.

Greedy tokens must be identical on every route: one-pass prefill, the
split (chunked) prefill path, a right-padded attention mask, and an eos
probed from the greedy stream with the early exit.
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

CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, dtype="float32", use_flash_attention=True,
           tie_word_embeddings=True, activation="relu")
B, P, NEW = 2, 24, 8


def random_tree(jmodel, seed=0):
    """Numpy-drawn parameter tree (see test_torch_model_parity.py)."""
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
    jmodel = jt.Transformer(jt.TransformerConfig(**CFG))
    tree = random_tree(jmodel)
    sd = pt.params_from_flax(tree, pt.TransformerConfig(**CFG))
    ids = np.random.default_rng(5).integers(0, 97, (B, P)).astype(np.int32)
    return jmodel, tree, sd, ids


def engines(setup, **config):
    jmodel, tree, sd, _ = setup
    config = dict(dtype="float32", **config)
    jeng = deepspeed_tpu.init_inference(jmodel, config=dict(config))
    jeng.set_params(tree)
    teng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(pt.TransformerConfig(**CFG)), config=dict(config),
        device="cpu")
    teng.set_params(sd)
    return jeng, teng


def both(jeng, teng, ids, **kw):
    want = np.asarray(jeng.generate(jnp.asarray(ids), **kw))
    tkw = dict(kw)
    if "attention_mask" in tkw:
        tkw["attention_mask"] = np.asarray(tkw["attention_mask"])
    got = teng.generate(torch.from_numpy(np.asarray(ids)), **tkw).numpy()
    return want, got


def test_one_pass_greedy_identical(setup):
    jeng, teng = engines(setup)
    ids = setup[3]
    assert jeng.prefill_plan(B, P)[0] == teng.prefill_plan(B, P)[0] \
        == "one_pass"
    want, got = both(jeng, teng, ids, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, want)
    for row in got[:, P:]:                     # a stream, not one token
        assert len(set(row.tolist())) >= 3, row
    # top-k = 1 sampling is greedy
    sampled = teng.generate(torch.from_numpy(ids), max_new_tokens=NEW,
                            do_sample=True, top_k=1, seed=3).numpy()
    np.testing.assert_array_equal(sampled, got)


def test_chunked_prefill_greedy_identical(setup):
    jeng, teng = engines(setup, prefill_chunk_size=8)
    assert jeng.prefill_plan(B, P)[0] == teng.prefill_plan(B, P)[0] \
        == "chunked"
    want, got = both(jeng, teng, setup[3], max_new_tokens=NEW)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk", [None, 8])
def test_right_padded_mask_identical(setup, chunk):
    jeng, teng = engines(setup, prefill_chunk_size=chunk)
    mask = np.ones((B, P), np.int32)
    mask[1, 17:] = 0
    want, got = both(jeng, teng, setup[3], max_new_tokens=NEW,
                     attention_mask=jnp.asarray(mask))
    np.testing.assert_array_equal(got, want)


def test_eos_early_exit_identical(setup):
    jeng, teng = engines(setup)
    ids = setup[3]
    greedy = teng.generate(torch.from_numpy(ids), max_new_tokens=NEW).numpy()
    eos = int(greedy[0, P + 2])                 # row 0 stops at step 2
    want, got = both(jeng, teng, ids, max_new_tokens=NEW, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    first = int(np.argmax(got[0, P:] == eos))
    assert (got[0, P + first:] == eos).all()


class _Counted:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.mark.parametrize("chunk", [None, 8])
def test_routes_reach_each_kernel_once_per_layer(setup, chunk, monkeypatch):
    """The dispatch of each route, counted where a CUDA tensor would
    launch the kernel (on the CPU the wrappers call the plain versions):
    one-pass prefill runs K1 once per layer, split prefill runs K3 once
    per layer and chunk, and every decode step runs K2 once per layer —
    the launch counts chip_smoke.py requires on the card."""
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    k1 = _Counted(fa.flash_attention_plain)
    k2 = _Counted(da.decode_attention_plain)
    k3 = _Counted(da.chunk_prefill_attention_plain)
    monkeypatch.setattr(fa, "flash_attention_plain", k1)
    monkeypatch.setattr(da, "decode_attention_plain", k2)
    monkeypatch.setattr(da, "chunk_prefill_attention_plain", k3)
    _, teng = engines(setup, prefill_chunk_size=chunk)
    teng.generate(torch.from_numpy(setup[3]), max_new_tokens=NEW)
    L = CFG["num_layers"]
    n_chunks = -(-P // chunk) if chunk else 0
    assert (k1.calls, k2.calls, k3.calls) == \
        (0 if chunk else L, L * (NEW - 1), L * n_chunks)
