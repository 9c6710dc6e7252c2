"""The port's GPT-Neo model (alternating global / local attention) against
the JAX package's, and against HF ``transformers``' own GPT-Neo.

- config: ``attention_layers`` builds (one entry per layer, refused with
  ``scan_layers=True``, as in JAX) and ``window_for_layer`` picks each
  layer's band;
- model: logits, the causal-LM loss and every parameter's gradient of a
  tiny GPT-Neo config (4 layers global / local, hidden 64, 4 heads, window
  8 against 24-token inputs so the band bites, ``attention_softmax_scale=
  1.0``, no q/k/v biases, a biased out-projection, gelu, unrolled layers)
  against the JAX model on one numpy-drawn tree converted by
  ``params_from_flax`` (JAX's flash kernel in interpret mode on the global
  layers).  Tolerances: logits and loss 1e-4, gradients 1e-4 (fp32
  summation order);
- a third oracle: a tiny random-init ``transformers.GPTNeoForCausalLM``
  (window 5) converted by the JAX package's ``convert_hf_model``, then
  ``params_from_flax``: the port's fp32 logits equal HF's at 1e-4, and its
  KV-cached decode (K2-window's plain version on the local layers)
  reproduces its full forward at 1e-4.  Skips where ``transformers`` is
  not installed.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.models import gpt_neo
from deepspeed_tpu_torch.models import transformer as pt

CFG = dict(vocab_size=97, hidden_size=64, num_layers=4, num_heads=4,
           max_seq_len=64, dtype="float32", use_flash_attention=True,
           tie_word_embeddings=True, activation="gelu",
           attention_bias=False, attention_out_bias=True,
           attention_softmax_scale=1.0,
           attention_layers=("global", "local", "global", "local"),
           window_size=8, scan_layers=False)
TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 24


def random_tree(jmodel, seed=0):
    """The JAX model's parameter tree with numpy leaves from a seed: norm
    scales near 1, biases small, matrices and embeddings std 0.2 (the
    logits are unscaled, so wider weights would saturate the softmax)."""
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
def models():
    jmodel = jt.Transformer(jt.TransformerConfig(**CFG))
    tree = random_tree(jmodel)
    cfg = pt.TransformerConfig(**dict(CFG, remat=False))
    tmodel = pt.Transformer(cfg, device="cpu")
    tmodel.load_state_dict(pt.params_from_flax(tree, cfg))
    ids = np.random.default_rng(1).integers(0, 97, (B, S)).astype(np.int32)
    return jmodel, tree, tmodel, ids


def test_config_checks_and_windows():
    cfg = pt.TransformerConfig(**CFG)
    assert [cfg.window_for_layer(i) for i in range(4)] == [None, 8, None, 8]
    assert cfg.window_for_layer(None) is None
    assert pt.TransformerConfig(**dict(
        CFG, attention_layers=None)).window_for_layer(1) is None
    with pytest.raises(ValueError, match="scan_layers"):
        pt.TransformerConfig(**dict(CFG, scan_layers=True))
    with pytest.raises(ValueError, match="entries"):
        pt.TransformerConfig(**dict(CFG, attention_layers=("local",)))
    m = pt.Transformer(cfg)
    assert [blk.attn.layer_idx for blk in m.layers] == [0, 1, 2, 3]
    # the typed-in preset maps as GPTNeoPolicy.build_config maps HF's
    neo = gpt_neo.gpt_neo_config("gpt-neo-1.3b")
    assert (neo.hidden_size, neo.num_layers, neo.num_heads, neo.head_dim,
            neo.ffn_size, neo.vocab_size) == (2048, 24, 16, 128, 8192, 50257)
    assert neo.attention_layers == ("global", "local") * 12
    assert (neo.window_size, neo.attention_softmax_scale,
            neo.attn_bias_enabled, neo.attn_out_bias_enabled,
            neo.activation, neo.scan_layers) == (256, 1.0, False, True,
                                                 "gelu", False)
    assert gpt_neo.gpt_neo_config("gpt-neo-1.3b", num_layers=4) \
        .attention_layers == ("global", "local") * 2


def test_params_from_flax_unrolled_uses_every_leaf_once(models):
    """The unrolled ``layers_{i}`` tree: q/k/v without biases, o_proj
    with one; every leaf used once, the state dict complete."""
    _, tree, tmodel, _ = models
    sd = pt.params_from_flax(tree, tmodel.config)
    assert set(sd) == set(tmodel.state_dict())
    assert "layers.0.attn.o_proj.bias" in sd
    assert "layers.0.attn.q_proj.bias" not in sd
    n = sum(int(np.prod(leaf.shape))
            for leaf in jax.tree_util.tree_leaves(tree))
    assert sum(v.numel() for v in sd.values()) == n


def test_logits_match_jax(models):
    jmodel, tree, tmodel, ids = models
    want = np.asarray(jmodel.apply(tree, jnp.asarray(ids),
                                   method=jt.Transformer.logits))
    with torch.no_grad():
        got = tmodel.logits(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the band bites: a model with every layer global differs
    glob = pt.Transformer(pt.TransformerConfig(**dict(
        CFG, attention_layers=("global",) * 4)), device="cpu")
    glob.load_state_dict(tmodel.state_dict())
    with torch.no_grad():
        other = glob.logits(torch.from_numpy(ids).long()).numpy()
    assert np.abs(other - got).max() > 1e-2


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_grads_match_jax(models, remat):
    jmodel, tree, tmodel, ids = models
    batch = {"input_ids": ids}
    want_loss, grads = jax.value_and_grad(
        lambda p: jmodel.apply(p, {"input_ids": jnp.asarray(ids)}))(tree)
    want = pt.params_from_flax(grads, tmodel.config)
    model = pt.Transformer(pt.TransformerConfig(**dict(CFG, remat=remat)),
                           device="cpu")
    model.load_state_dict(tmodel.state_dict())
    loss = model({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-4)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("prefill", [True, False], ids=["one_pass", "chunk"])
def test_cached_decode_reproduces_full_forward(models, prefill):
    """A prefill of 12 tokens (one pass, or one 12-token chunk) and 12
    decode steps past the window reproduce the full forward's logits."""
    _, _, tmodel, ids = models
    full = tmodel.logits(torch.from_numpy(ids).long()).detach()
    P = 12
    with torch.no_grad():
        cache = tmodel.init_cache(B, S, dtype=torch.float32)
        got, _ = tmodel.decode(torch.from_numpy(ids[:, :P]).long(), cache, 0,
                               prefill=prefill)
        steps = [got]
        for t in range(P, S):
            step, _ = tmodel.decode(torch.from_numpy(ids[:, t:t + 1]).long(),
                                    cache, t)
            steps.append(step)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               **TOL)


def _port_config(jcfg, **over):
    fields = {f.name for f in dataclasses.fields(pt.TransformerConfig)}
    return pt.TransformerConfig(**{**{k: v for k, v in
                                      dataclasses.asdict(jcfg).items()
                                      if k in fields}, **over})


def test_hf_gpt_neo_is_a_third_oracle():
    """HF's GPT-Neo (window 5), through the JAX package's converter and
    ``params_from_flax``: the port's logits equal HF's; its KV-cached
    decode equals its own full forward."""
    transformers = pytest.importorskip("transformers")
    from deepspeed_tpu.module_inject import convert_hf_model
    torch.manual_seed(0)
    hf = transformers.GPTNeoForCausalLM(transformers.GPTNeoConfig(
        vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
        intermediate_size=64, max_position_embeddings=64,
        attention_types=[[["global", "local"], 1]], window_size=5)).eval()
    ids = np.random.default_rng(0).integers(0, 97, (2, 24))
    with torch.no_grad():
        want = hf(torch.from_numpy(ids)).logits.float().numpy()
    jmodel, params = convert_hf_model(hf, use_flash_attention=False,
                                      dtype="float32")
    cfg = _port_config(jmodel.config, use_flash_attention=True)
    assert cfg.attention_layers == ("global", "local")
    assert (cfg.window_size, cfg.attention_softmax_scale) == (5, 1.0)
    model = pt.Transformer(cfg, device="cpu")
    model.load_state_dict(pt.params_from_flax(jax.device_get(params), cfg))
    tids = torch.from_numpy(ids).long()
    with torch.no_grad():
        full = model.logits(tids)
        np.testing.assert_allclose(full.numpy(), want, **TOL)
        cache = model.init_cache(2, 24, dtype=torch.float32)
        steps = [model.decode(tids[:, :3], cache, 0, prefill=True)[0]]
        for t in range(3, 24):
            steps.append(model.decode(tids[:, t:t + 1], cache, t)[0])
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               **TOL)
