"""GPT-Neo generation: ``deepspeed_tpu_torch.init_inference(...).generate``
against the JAX package's on one parameter tree, with a tiny GPT-Neo
config (layers global / local, window 8 against 24-token prompts, so the
band bites in prefill and in every decode step).

Greedy tokens must be identical on the one-pass route (K1 on the global
layer, the dense band on the local one, then K2 and K2-window decode) and
the chunked route (K3 on global chunks, dense on local ones), with a
float KV cache, an int8 KV cache and with ``decode_int8_matmuls``
(K2-i8mm-window on the local layer).  The routes are counted where a
CUDA tensor would launch each kernel.
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
           tie_word_embeddings=True, activation="gelu",
           attention_bias=False, attention_out_bias=True,
           attention_softmax_scale=1.0, attention_layers=("global", "local"),
           window_size=8, scan_layers=False)
B, P, NEW = 2, 24, 8
KV = {"fp": {}, "int8": dict(kv_cache_quant=True),
      "i8mm": dict(kv_cache_quant=True, decode_int8_matmuls=True)}


def random_tree(jmodel, seed=0):
    """Numpy-drawn parameter tree (std 0.2 matrices: the logits are
    unscaled)."""
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
        return 0.2 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def setup():
    tree = random_tree(jt.Transformer(jt.TransformerConfig(**CFG)))
    sd = pt.params_from_flax(tree, pt.TransformerConfig(**CFG))
    ids = np.random.default_rng(5).integers(0, 97, (B, P)).astype(np.int32)
    return tree, sd, ids


def engines(setup, kv, chunk):
    tree, sd, _ = setup
    cfg = dict(CFG, **KV[kv])
    config = dict(dtype="float32", prefill_chunk_size=chunk)
    jeng = deepspeed_tpu.init_inference(
        jt.Transformer(jt.TransformerConfig(**cfg)), config=dict(config))
    jeng.set_params(tree)
    teng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(pt.TransformerConfig(**cfg)), config=dict(config),
        device="cpu")
    teng.set_params(sd)
    return jeng, teng


class _Counted:
    """A plain version that counts its calls by window."""

    def __init__(self, fn):
        self.fn, self.calls = fn, {}

    def __call__(self, *args, **kwargs):
        key = kwargs.get("window") is not None
        self.calls[key] = self.calls.get(key, 0) + 1
        return self.fn(*args, **kwargs)


@pytest.mark.parametrize("kv", list(KV))
@pytest.mark.parametrize("chunk", [None, 8], ids=["one_pass", "chunked"])
def test_greedy_identical_to_jax(setup, chunk, kv, monkeypatch):
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    jeng, teng = engines(setup, kv, chunk)
    route = "chunked" if chunk else "one_pass"
    assert jeng.prefill_plan(B, P)[0] == teng.prefill_plan(B, P)[0] == route
    ids = setup[2]
    want = np.asarray(jeng.generate(jnp.asarray(ids), max_new_tokens=NEW))
    decode = "decode_attention_i8mm_plain" if kv == "i8mm" \
        else "decode_attention_plain"
    counted = {name: _Counted(getattr(mod, name)) for mod, name in
               ((fa, "flash_attention_plain"), (da, decode),
                (da, "chunk_prefill_attention_plain"))}
    for name, fn in counted.items():
        monkeypatch.setattr(fa if name.startswith("flash") else da, name, fn)
    got = teng.generate(torch.from_numpy(ids), max_new_tokens=NEW).numpy()
    np.testing.assert_array_equal(got, want)
    for row in got[:, P:]:                     # a stream, not one token
        assert len(set(row.tolist())) >= 3, row
    # one global and one local layer: K1 (one pass) or K3 (each chunk)
    # on the global layer only, K2 and K2-window once per decode step
    n_chunks = P // chunk if chunk else 0
    assert counted["flash_attention_plain"].calls == \
        ({} if chunk else {False: 1})
    assert counted["chunk_prefill_attention_plain"].calls == \
        ({False: n_chunks} if chunk else {})
    assert counted[decode].calls == {False: NEW - 1, True: NEW - 1}
