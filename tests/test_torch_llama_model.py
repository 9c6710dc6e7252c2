"""The port's Llama model (rope, RMSNorm, SwiGLU, GQA) against the JAX
package's, and against HF ``transformers``' own Llama.

``llama-tiny`` (4 layers, hidden 256, 8 heads of 32, 4 kv heads: G = 2)
in fp32, with its MHA twin (8 kv heads) and a G = 4 twin (2 kv heads),
on one numpy-drawn flax tree per twin converted by ``params_from_flax``
(JAX's flash kernel in interpret mode):

- presets: the port's ``LLAMA_CONFIGS`` / ``llama_config`` are the JAX
  package's; ``llama-7b`` has 6.74 B parameters, no position table, no
  biases;
- ``_rope`` in the half-split, interleaved (gptj) and partial
  (``rope_dim``) layouts against JAX's at 1e-6, in fp32; RMSNorm against
  flax's ``nn.RMSNorm`` at 1e-6 (fp32 and bf16 inputs: the result is
  fp32 in both);
- ``params_from_flax`` uses every leaf once, scanned and unrolled;
- logits at 1e-4, the causal-LM loss at 1e-4 and every gradient at 1e-4;
- the cached decode (one-pass or chunked prefill, then single steps)
  reproduces the full forward, and the cache it wrote holds JAX's rotated
  keys;
- GQA's head order (query head h reads kv head h // G) at G = 2 and 4
  with distinct kv heads;
- per-channel int8 weights: the engine quantizes the same leaves as the
  JAX ``WeightQuantization`` (``mlp/gate_proj/kernel`` included,
  ``lm_head`` float by name), payloads and scales bitwise;
- a third oracle: a random-init ``transformers.LlamaForCausalLM`` at
  ``llama-tiny``'s widths, through the JAX package's converter and
  ``params_from_flax``: logits at 1e-4 (the half-split layout and the
  order gate / up of SwiGLU).  Skips where ``transformers`` is missing.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as nn

from deepspeed_tpu.models import opt as jopt
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.models import opt as popt
from deepspeed_tpu_torch.models import transformer as pt

TOL = dict(rtol=1e-4, atol=1e-4)
TIGHT = dict(rtol=1e-6, atol=1e-6)
OVER = dict(dtype="float32", scan_layers=False)
# llama-tiny (G = 2) and its MHA and G = 4 twins
TWINS = {"gqa2": {}, "mha": dict(num_kv_heads=8), "gqa4": dict(num_kv_heads=2)}
B, S = 2, 24


def configs(twin, **over):
    """(JAX config, port config) of llama-tiny's ``twin``."""
    kw = dict(OVER, **TWINS[twin], **over)
    return (jopt.llama_config("llama-tiny", **kw),
            popt.llama_config("llama-tiny", **kw))


def random_tree(jmodel, seed=0):
    """Numpy-drawn parameter tree: RMS scales near 1, matrices and
    embeddings std 0.1."""
    ids = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0),
                                                {"input_ids": ids}))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        return 1.0 + 0.1 * x if "scale" in name else 0.1 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module", params=sorted(TWINS))
def models(request):
    jcfg, cfg = configs(request.param)
    jmodel = jt.Transformer(jcfg)
    tree = random_tree(jmodel)
    tmodel = pt.Transformer(dataclasses.replace(cfg, remat=False),
                            device="cpu")
    tmodel.load_state_dict(pt.params_from_flax(tree, cfg))
    ids = np.random.default_rng(1).integers(0, 32000, (B, S)) \
        .astype(np.int32)
    return jmodel, tree, tmodel, ids


def test_presets_match_jax():
    assert popt.LLAMA_CONFIGS == jopt.LLAMA_CONFIGS
    fields = {f.name for f in dataclasses.fields(pt.TransformerConfig)}
    for name in jopt.LLAMA_CONFIGS:
        want = dataclasses.asdict(jopt.llama_config(name))
        got = dataclasses.asdict(popt.llama_config(name))
        assert got == {k: v for k, v in want.items() if k in fields}, name
    cfg = popt.llama_config("llama-7b")
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.head_dim,
            cfg.kv_heads, cfg.ffn_size, cfg.vocab_size, cfg.max_seq_len) == \
        (4096, 32, 32, 128, 32, 11008, 32000, 2048)
    assert (cfg.position_embedding, cfg.rope_theta, cfg.rope_interleaved,
            cfg.rms_norm, cfg.layernorm_epsilon, cfg.gated_mlp,
            cfg.activation, cfg.tie_word_embeddings) == \
        ("rope", 10000.0, False, True, 1e-5, True, "silu", False)
    m = popt.llama_model("llama-7b")
    assert m.embed_positions is None
    assert not any(n.endswith("bias") for n, _ in m.named_parameters())
    n = sum(p.numel() for p in m.parameters())
    assert n == cfg.num_params() == jopt.llama_config("llama-7b").num_params()
    assert n == 6_738_415_616
    with pytest.raises(ValueError, match="unknown Llama"):
        popt.llama_config("llama-70b")


ROPE = {"half_split": {}, "interleaved": dict(interleaved=True),
        "partial": dict(rope_dim=16), "partial_interleaved":
        dict(rope_dim=16, interleaved=True)}


@pytest.mark.parametrize("layout", sorted(ROPE))
def test_rope_matches_jax(layout):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 16, 8, 32)).astype(np.float32)
    k = rng.standard_normal((2, 16, 4, 32)).astype(np.float32)
    pos = np.sort(rng.integers(0, 2048, (2, 16)), axis=1).astype(np.int32)
    jq, jk = jt._rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), 32,
                      10000.0, **ROPE[layout])
    tq, tk = pt._rope(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(pos).long(), 32, 10000.0,
                      **ROPE[layout])
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TIGHT)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TIGHT)
    if "rope_dim" in ROPE[layout]:           # the tail passes through
        np.testing.assert_array_equal(tq[..., 16:].numpy(), q[..., 16:])
    # position 0 is the identity; the layouts differ elsewhere
    np.testing.assert_array_equal(
        pt._rope(torch.from_numpy(q), torch.from_numpy(k),
                 torch.zeros(2, 16, dtype=torch.long), 32, 1e4,
                 **ROPE[layout])[0].numpy(), q)


def test_rope_layouts_differ():
    x = torch.randn(1, 4, 2, 32, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(4)[None]
    outs = [pt._rope(x, x, pos, 32, 1e4, **kw)[0] for kw in ROPE.values()]
    for i in range(len(outs)):
        for j in range(i):
            assert (outs[i] - outs[j]).abs().max() > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_flax(dtype):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 5, 256)) * 3.0).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = nn.RMSNorm(epsilon=1e-5, param_dtype=jnp.float32).apply(
        {"params": {"scale": jnp.asarray(scale)}}, jx)
    assert want.dtype == jnp.float32
    norm = pt.RMSNorm(256, device="cpu")
    norm.weight.data = torch.from_numpy(scale)
    with torch.no_grad():
        got = pt._rms_norm(torch.tensor(np.asarray(jx.astype(jnp.float32)))
                           .to(getattr(torch, dtype)), norm, 1e-5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)


@pytest.mark.parametrize("layout", ["unrolled", "scanned"])
def test_params_from_flax_uses_every_leaf_once(layout):
    """Both flax layouts: every leaf used once (gate_proj, RMS scales
    without biases, an untied head, no position table), the state dict
    complete and equal between the layouts."""
    jcfg, cfg = configs("gqa2", scan_layers=layout == "scanned")
    tree = random_tree(jt.Transformer(jcfg))
    flat = pt._flatten(tree["params"])
    assert not any("embed_positions" in k or k.endswith("bias")
                   for k in flat)
    sd = pt.params_from_flax(tree, cfg)
    assert set(sd) == set(pt.Transformer(cfg).state_dict())
    assert "layers.0.mlp.gate_proj.weight" in sd
    assert "layers.0.input_norm.bias" not in sd
    assert sum(v.numel() for v in sd.values()) == sum(
        int(np.prod(v.shape)) for v in flat.values()) == cfg.num_params()
    with pytest.raises(ValueError, match="not used"):
        pt.params_from_flax({**tree["params"], "extra": np.zeros(3)}, cfg)
    if layout == "scanned":
        unrolled = {k: v for k, v in tree["params"].items() if k != "layers"}
        for i in range(cfg.num_layers):
            unrolled[f"layers_{i}"] = jax.tree_util.tree_map(
                lambda a: a[i], tree["params"]["layers"])
        other = pt.params_from_flax({"params": unrolled}, cfg)
        for key in sd:
            torch.testing.assert_close(sd[key], other[key], rtol=0, atol=0)


def test_logits_match_jax(models):
    jmodel, tree, tmodel, ids = models
    want = np.asarray(jmodel.apply(tree, jnp.asarray(ids),
                                   method=jt.Transformer.logits))
    with torch.no_grad():
        got = tmodel.logits(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_loss_and_grads_match_jax(models):
    jmodel, tree, tmodel, ids = models
    want_loss, grads = jax.value_and_grad(
        lambda p: jmodel.apply(p, {"input_ids": jnp.asarray(ids)}))(tree)
    want = pt.params_from_flax(grads, tmodel.config)
    model = pt.Transformer(dataclasses.replace(tmodel.config, remat=True),
                           device="cpu")
    model.load_state_dict(tmodel.state_dict())
    loss = model({"input_ids": torch.from_numpy(ids)})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-4)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(),
                                   err_msg=name, **TOL)


@pytest.fixture(scope="module")
def jax_cache(models):
    """The JAX model's cache after a 12-token prefill and single decode
    steps to S (the steps jitted once, the start a traced scalar)."""
    jmodel, tree, _, ids = models
    P = 12
    cache = jmodel.init_cache(B, S, dtype=jnp.float32)
    _, cache = jmodel.apply(tree, jnp.asarray(ids[:, :P]), cache, 0,
                            method=jt.Transformer.decode)
    step = jax.jit(lambda p, x, c, t: jmodel.apply(
        p, x, c, t, method=jt.Transformer.decode))
    for t in range(P, S):
        _, cache = step(tree, jnp.asarray(ids[:, t:t + 1]), cache,
                        jnp.int32(t))
    return {key: np.asarray(cache[key]) for key in ("k", "v")}


@pytest.mark.parametrize("prefill", [True, False], ids=["one_pass", "chunk"])
def test_cached_decode_reproduces_full_forward(models, jax_cache, prefill):
    """A 12-token prefill (one pass, or one chunk) and 12 single steps
    reproduce the full forward's logits; the cache then holds the JAX
    model's rotated keys and its values."""
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
                                    cache, torch.full((B,), t))
            steps.append(step)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), jax_cache[key],
                                   err_msg=key, **TOL)
    # the keys are rotated: position 5's row is not the bare projection
    with torch.no_grad():
        x = tmodel.embed_tokens.weight[torch.from_numpy(ids[:, 5]).long()]
        bare = pt._linear(pt._norm(x, tmodel.layers[0].input_norm,
                                   tmodel.config),
                          tmodel.layers[0].attn.k_proj, torch.float32)
    assert (cache["k"][0, :, 5] - bare).abs().max() > 1e-2


@pytest.mark.parametrize("G", [2, 4])
def test_gqa_query_head_reads_kv_head_h_over_g(G):
    """With distinct kv heads (each a one-hot value direction), query head
    h's output is kv head h // G's value: the port's dense, flash and
    decode paths, and JAX's ``jnp.repeat``."""
    H, D, T = 8, 32, 6
    KVH = H // G
    q = torch.zeros(1, T, H, D)
    k = torch.zeros(1, T, KVH, D)
    v = torch.zeros(1, T, KVH, D)
    for j in range(KVH):
        v[0, :, j, j] = 1.0 + j
    want = torch.zeros(1, T, H, D)
    for h in range(H):
        want[0, :, h, h // G] = 1.0 + h // G
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    torch.testing.assert_close(pt.reference_attention(q, k, v), want)
    torch.testing.assert_close(fa.flash_attention(q, k, v), want)
    jout = jt.reference_attention(jnp.asarray(q.numpy()),
                                  jnp.asarray(k.numpy()),
                                  jnp.asarray(v.numpy()))
    np.testing.assert_array_equal(np.asarray(jout), want.numpy())
    kc, vc = k.reshape(1, T, KVH * D), v.reshape(1, T, KVH * D)
    got = da.decode_attention(q[:, -1], kc, vc, torch.tensor([T],
                                                            dtype=torch.int32))
    torch.testing.assert_close(got, want[:, -1])


def _flat_jax(tree):
    from deepspeed_tpu.runtime.weight_quantizer import QuantizedWeight
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, QuantizedWeight))[0]:
        keys = [p.key for p in path]
        out["/".join(keys[1:] if keys[0] == "params" else keys)] = leaf
    return out


def test_quantized_weights_match_jax():
    """``init_inference(quant=per-channel int8)`` + ``set_params`` on
    llama-tiny: the JAX ``WeightQuantization``'s leaves exactly (the seven
    matrices of each layer, gate_proj included; embeddings, RMS scales and
    ``lm_head`` float), payloads and scales bitwise."""
    import deepspeed_tpu_torch
    from deepspeed_tpu.runtime.weight_quantizer import QuantizedWeight as JQW
    from deepspeed_tpu.runtime.weight_quantizer import WeightQuantization
    jcfg, cfg = configs("gqa2")
    tree = random_tree(jt.Transformer(jcfg))
    jq = _flat_jax(WeightQuantization(bits=8, per_channel=True)
                   .quantize_tree(tree))
    want = {k: v for k, v in jq.items() if isinstance(v, JQW)}
    eng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(cfg), config={"dtype": "float32", "quant": {
            "enabled": True, "bits": 8, "per_channel": True}}, device="cpu")
    eng.set_params(pt.params_from_flax(tree, cfg))
    got = eng.module.quantized_leaves()
    assert set(got) == set(want)
    assert len(got) == cfg.num_layers * 7
    assert "layers_0/mlp/gate_proj/kernel" in got
    assert "lm_head/kernel" not in got
    for path, qw in got.items():
        assert qw.shape == tuple(want[path].shape)
        np.testing.assert_array_equal(qw.q.numpy(), np.asarray(want[path].q))
        np.testing.assert_array_equal(qw.scale.numpy(),
                                      np.asarray(want[path].scale))


def test_hf_llama_is_a_third_oracle():
    """HF's Llama at llama-tiny's widths (random init, G = 2), through the
    JAX package's converter and ``params_from_flax``: the port's fp32
    logits equal HF's, and its cached decode its own full forward."""
    transformers = pytest.importorskip("transformers")
    from deepspeed_tpu.module_inject import convert_hf_model
    torch.manual_seed(0)
    tiny = popt.LLAMA_CONFIGS["llama-tiny"]
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=tiny["vocab_size"], hidden_size=tiny["hidden_size"],
        intermediate_size=tiny["ffn_hidden_size"],
        num_hidden_layers=tiny["num_layers"],
        num_attention_heads=tiny["num_heads"],
        num_key_value_heads=tiny["num_kv_heads"], rms_norm_eps=1e-5,
        rope_theta=10000.0, max_position_embeddings=2048,
        initializer_range=0.1)).eval()
    ids = np.random.default_rng(0).integers(0, tiny["vocab_size"], (2, 24))
    with torch.no_grad():
        want = hf(torch.from_numpy(ids)).logits.float().numpy()
    jmodel, params = convert_hf_model(hf, use_flash_attention=False,
                                      dtype="float32")
    fields = {f.name for f in dataclasses.fields(pt.TransformerConfig)}
    cfg = pt.TransformerConfig(**{
        **{k: v for k, v in dataclasses.asdict(jmodel.config).items()
           if k in fields}, "use_flash_attention": True, "remat": False})
    assert (cfg.position_embedding, cfg.rms_norm, cfg.gated_mlp,
            cfg.kv_heads) == ("rope", True, True, 4)
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
