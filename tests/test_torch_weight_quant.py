"""The port's weight quantization (``ops/quantizer/kernels.py``,
``runtime/weight_quantizer.py`` and the inference engine's quantized
layers) against the JAX package's on one parameter tree.

On an unrolled (``scan_layers=False``) tree — the layout of the JAX
bench's serving point — for per-channel int8, grouped int8 and grouped
int4: the same quantized leaves (the q/k/v biases ``[H, D]`` included,
embeddings and the LM head skipped by name), payloads and scales bitwise,
and the dequantized weights in bf16 and fp32, in the torch layout,
bitwise JAX's ``dequantize_tree`` converted.  The JAX functions run
eagerly here: under ``jax.jit`` XLA rewrites ``x / 127.0`` into a
multiply by the reciprocal (the port divides, as the JAX source does).

A JAX fault is pinned too: with ``scan_layers=True`` (its default) the
leaves are stacked ``[L, ...]`` and ``quantize_tree`` quantizes the
LayerNorm parameters and the 1-D biases and reduces the per-channel
scales over the layer axis.  The port quantizes each layer's weights as
the unrolled tree does, whatever layout the weights came from.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.ops.quantizer import kernels as jax_kernels
from deepspeed_tpu.runtime.weight_quantizer import QuantizedWeight as JaxQW
from deepspeed_tpu.runtime.weight_quantizer import (
    WeightQuantization as JaxWQ)
from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.ops.quantizer import kernels as pt_kernels
from deepspeed_tpu_torch.runtime.weight_quantizer import (QuantizedWeight,
                                                          WeightQuantization)

# opt-125m's layout cut to 2 layers, hidden 64, 4 heads
CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           ffn_hidden_size=256, max_seq_len=64, dtype="float32",
           tie_word_embeddings=True, activation="relu")
MODES = {"per_channel_int8": dict(bits=8, per_channel=True),
         "grouped_int8": dict(bits=8, group_size=64),
         "grouped_int4": dict(bits=4, group_size=64)}


def random_tree(cfg, seed=0):
    """A numpy-drawn parameter tree for the JAX model ``cfg``."""
    model = jt.Transformer(jt.TransformerConfig(**cfg))
    ids = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0),
                                               {"input_ids": ids}))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        name = jax.tree_util.keystr(path)
        return 1.0 + 0.1 * x if "scale" in name else 0.1 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _flat_jax(tree):
    """{"a/b/c": leaf} of a JAX tree (QuantizedWeight nodes kept)."""
    out = {}
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JaxQW))[0]
    for path, leaf in leaves:
        keys = [p.key for p in path]
        if keys[0] == "params":
            keys = keys[1:]
        out["/".join(keys)] = leaf
    return out


def _port_flat(tree):
    return {k: torch.from_numpy(v)
            for k, v in pt._flatten(tree["params"]).items()}


def _same_qw(mine, theirs):
    """Payload, scale and zero bitwise, same metadata."""
    assert isinstance(mine, QuantizedWeight)
    assert (mine.shape, mine.bits, mine.per_channel) == \
        (tuple(theirs.shape), theirs.bits, theirs.per_channel)
    np.testing.assert_array_equal(mine.q.numpy(), np.asarray(theirs.q))
    assert mine.q.dtype == {"int8": torch.int8, "uint8": torch.uint8}[
        str(np.asarray(theirs.q).dtype)]
    np.testing.assert_array_equal(mine.scale.numpy(),
                                  np.asarray(theirs.scale))
    if theirs.zero is None:
        assert mine.zero is None
    else:
        np.testing.assert_array_equal(mine.zero.numpy(),
                                      np.asarray(theirs.zero))


@pytest.fixture(scope="module")
def unrolled():
    cfg = dict(CFG, scan_layers=False)
    return cfg, random_tree(cfg)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_quantize_tree_matches_jax(unrolled, mode):
    """The same leaves quantized (count and paths), payloads and scales
    bitwise, on the unrolled tree."""
    _, tree = unrolled
    jq = _flat_jax(JaxWQ(**MODES[mode]).quantize_tree(tree))
    tq = WeightQuantization(**MODES[mode]).quantize_tree(_port_flat(tree))
    jkeys = {k for k, v in jq.items() if isinstance(v, JaxQW)}
    tkeys = {k for k, v in tq.items() if isinstance(v, QuantizedWeight)}
    assert tkeys == jkeys
    # every matrix and the [H, D] q/k/v biases; never embeddings or norms
    assert len(tkeys) == CFG["num_layers"] * 9
    assert {k.split("/")[-2] for k in tkeys if k.endswith("bias")} == \
        {"q_proj", "k_proj", "v_proj"}
    assert not any("embed" in k or "norm" in k for k in tkeys)
    for k in tkeys:
        _same_qw(tq[k], jq[k])
    for k in set(tq) - tkeys:                # the rest stays as it was
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_quantized_weights_match_jax_dequantize(unrolled, mode, dtype):
    """``init_inference(quant=...)`` + ``set_params`` holds the JAX leaves
    (bitwise) as int8 / packed int4, and every quantized layer's weight
    and bias, dequantized to the compute dtype in the torch layout, is
    bitwise JAX's ``dequantize_tree`` of the same tree converted."""
    cfg, tree = unrolled
    jwq = JaxWQ(**MODES[mode])
    jq = jwq.quantize_tree(tree)
    # the JAX engine's view: dequantized leaves, the rest cast to dtype
    want_sd = pt.params_from_flax(
        jax.tree.map(lambda x: x.astype(dtype),
                     jwq.dequantize_tree(jq, getattr(jnp, dtype))),
        pt.TransformerConfig(**dict(cfg, dtype=dtype)))
    eng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(pt.TransformerConfig(**dict(cfg, dtype=dtype))),
        config={"dtype": dtype, "quant": {"enabled": True, **MODES[mode]}},
        device="cpu")
    eng.set_params(pt.params_from_flax(tree, pt.TransformerConfig(**cfg)))
    leaves = eng.module.quantized_leaves()
    jflat = _flat_jax(jq)
    assert set(leaves) == {k for k, v in jflat.items()
                           if isinstance(v, JaxQW)}
    for path, qw in leaves.items():
        _same_qw(qw, jflat[path])
        assert qw.q.dtype in (torch.int8, torch.uint8)   # resident as int
    dt = getattr(torch, dtype)
    from deepspeed_tpu_torch.runtime.weight_quantizer import QuantizedLinear
    n = 0
    for name, mod in eng.module.named_modules():
        if not isinstance(mod, QuantizedLinear):
            continue
        n += 1
        assert mod.weight.dtype == dt and mod.bias.dtype == dt
        np.testing.assert_array_equal(mod.weight.float().numpy(),
                                      want_sd[name + ".weight"].numpy())
        np.testing.assert_array_equal(mod.bias.float().numpy(),
                                      want_sd[name + ".bias"].numpy())
    assert n == CFG["num_layers"] * 6
    # what stays float is in the compute dtype
    assert all(p.dtype == dt for p in eng.module.parameters())


def test_untied_lm_head_stays_float(unrolled):
    """The skip patterns keep an untied LM head float, as in JAX."""
    cfg = dict(unrolled[0], tie_word_embeddings=False)
    tree = random_tree(cfg, seed=1)
    jq = _flat_jax(JaxWQ(bits=8, per_channel=True).quantize_tree(tree))
    assert not isinstance(jq["lm_head/kernel"], JaxQW)
    eng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(pt.TransformerConfig(**cfg)),
        config={"dtype": "float32",
                "quant": {"enabled": True, "per_channel": True}},
        device="cpu")
    eng.set_params(pt.params_from_flax(tree, pt.TransformerConfig(**cfg)))
    assert isinstance(eng.module.lm_head, torch.nn.Linear)
    assert "lm_head/kernel" not in eng.module.quantized_leaves()


def test_scan_layers_true_fault_is_pinned(unrolled):
    """JAX on the scanned (default) tree quantizes the LayerNorm params and
    1-D biases and takes per-channel scales over the layer axis; the port
    quantizes the scanned weights exactly as the unrolled ones."""
    cfg, tree = unrolled
    scanned_cfg = dict(cfg, scan_layers=True)
    scanned = random_tree(scanned_cfg)
    jq = _flat_jax(JaxWQ(bits=8, per_channel=True).quantize_tree(scanned))
    # the fault: norms quantized, scale reduced over the 2 stacked layers
    assert isinstance(jq["layers/input_norm/scale"], JaxQW)
    assert isinstance(jq["layers/mlp/up_proj/bias"], JaxQW)
    assert jq["layers/input_norm/scale"].scale.shape == (1, 64)
    assert jq["layers/attn/q_proj/kernel"].scale.shape == (1, 64, 4, 16)
    n_jax = sum(isinstance(v, JaxQW) for v in jq.values())
    assert n_jax == 16                       # every stacked leaf
    # the port: the scanned tree's weights quantize as the unrolled tree
    # holding the same weights would
    flat = pt._flatten(scanned["params"])
    same = {f"layers_{i}/{k[len('layers/'):]}": v[i]
            for k, v in flat.items() if k.startswith("layers/")
            for i in range(cfg["num_layers"])}
    same.update({k: v for k, v in flat.items()
                 if not k.startswith("layers/")})

    def port_leaves(sd):
        eng = deepspeed_tpu_torch.init_inference(
            pt.Transformer(pt.TransformerConfig(**cfg)),
            config={"dtype": "float32",
                    "quant": {"enabled": True, "per_channel": True}},
            device="cpu")
        eng.set_params(sd)
        return eng.module.quantized_leaves()

    from_scanned = port_leaves(pt.params_from_flax(
        scanned, pt.TransformerConfig(**cfg)))
    unrolled_tree = {"params": {}}
    for k, v in same.items():
        node = unrolled_tree["params"]
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    jq_un = _flat_jax(JaxWQ(bits=8, per_channel=True).quantize_tree(
        unrolled_tree))
    assert set(from_scanned) == {k for k, v in jq_un.items()
                                 if isinstance(v, JaxQW)}
    for path, qw in from_scanned.items():
        _same_qw(qw, jq_un[path])
    assert len(from_scanned) == 18 != n_jax


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("symmetric", [True, False])
def test_quantizer_kernels_match_jax(bits, symmetric):
    """quantize / dequantize / pack_int4 / unpack_int4 bitwise JAX's."""
    rng = np.random.default_rng(bits + symmetric)
    x = (rng.standard_normal((8, 64)) * 0.3).astype(np.float32)
    x[2] = 0.0                                # an all-zero group
    jq, js, jz = jax_kernels.quantize(jnp.asarray(x), 8, bits, symmetric)
    tq, ts, tz = pt_kernels.quantize(torch.from_numpy(x), 8, bits, symmetric)
    for mine, theirs in ((tq, jq), (ts, js), (tz, jz)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    np.testing.assert_array_equal(
        pt_kernels.dequantize(tq, ts, tz, bits, symmetric).numpy(),
        np.asarray(jax_kernels.dequantize(jq, js, jz, bits, symmetric)))
    if bits == 4:
        jp = jax_kernels.pack_int4(jq)
        tp = pt_kernels.pack_int4(tq)
        assert tp.dtype == torch.uint8
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(pt_kernels.unpack_int4(tp).numpy(),
                                      np.asarray(jax_kernels.unpack_int4(jp)))
        assert torch.equal(pt_kernels.unpack_int4(tp), tq)


def test_quantizer_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="bits"):
        WeightQuantization(bits=2)
    with pytest.raises(ValueError, match="per_channel"):
        WeightQuantization(bits=4, per_channel=True)
    with pytest.raises(ValueError, match="group_size"):
        WeightQuantization(group_size=1)
    assert WeightQuantization(group_size=63).group_size == 64


def test_set_params_again_requantizes(unrolled):
    """A quantized engine takes new float weights: ``set_params`` goes back
    to float layers, loads them and quantizes them again (the payloads
    follow the new weights); ``init_params`` does the same from a seed."""
    cfg, tree = unrolled
    other = random_tree(cfg, seed=3)
    pcfg = pt.TransformerConfig(**cfg)
    eng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(pcfg), device="cpu",
        config={"dtype": "float32",
                "quant": {"enabled": True, "per_channel": True}})
    for t in (tree, other):
        eng.set_params(pt.params_from_flax(t, pcfg))
        want = _flat_jax(JaxWQ(bits=8, per_channel=True).quantize_tree(t))
        for path, qw in eng.module.quantized_leaves().items():
            _same_qw(qw, want[path])
    eng.init_params(seed=1)
    assert eng.module.quantized_leaves()
    assert all(p.dtype == torch.float32 for p in eng.module.parameters())
