"""``checkpoint/reshape_utils.py`` in the port against the JAX package's, on
the CPU, from seeded numpy arrays:

- ``partition_data``, ``merge_tp_shards``, ``split_tp_shards`` and
  ``reshape_tp`` bitwise JAX's, on numpy arrays and torch tensors (the
  port returns the type it was given);
- ``infer_tp_dim`` equals JAX's on every flax path of
  ``Transformer.flax_paths()`` of an OPT, a Llama GQA and a GPT-Neo model,
  and the dim the port's live plan (``tp_plan`` over
  ``DEFAULT_TP_RULES``) shards on the JAX layout wherever that dim
  divides, for every leaf of two dims or more (1-D leaves: JAX's offline
  rule keeps them whole, the live plan cuts the o / down biases);
- ``reshape_flat_state_dict`` 2 → 4 → 1 bitwise JAX's on those models'
  leaves, with both packages refusing differing shards of a leaf no rule
  classifies.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint import reshape_utils as jru

from deepspeed_tpu_torch.checkpoint import reshape_utils as ru
from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.parallel.tensor_parallel import (TensorParallel,
                                                          tp_plan)

BASE = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=64, dtype="float32", scan_layers=False)
MODELS = {
    "opt": dict(BASE, activation="relu"),
    "llama": dict(BASE, num_heads=8, num_kv_heads=2, gated_mlp=True,
                  rms_norm=True, position_embedding="rope",
                  tie_word_embeddings=False, activation="silu"),
    "gpt_neo": dict(BASE, attention_layers=("global", "local"),
                    window_size=8, attention_bias=False),
}


def flax_leaves(name):
    """``{flax path: (JAX-layout shape, port name)}`` of a model."""
    model = pt.Transformer(pt.TransformerConfig(**MODELS[name]))
    lay = model.jax_layouts()
    paths = model.flax_paths()
    return {paths[n]: (tuple(lay[n][2]) if n in lay else tuple(p.shape), n)
            for n, p in model.named_parameters()}, model


def test_partition_and_shard_ops_bitwise_jax():
    rng = np.random.default_rng(0)
    for n, k in ((10, 3), (7, 7), (3, 5), (0, 2)):
        data = list(range(n))
        assert ru.partition_data(data, k) == jru.partition_data(data, k)
    a = rng.standard_normal((8, 12, 4)).astype(np.float32)
    for dim in (0, 1, 2):
        for deg in (1, 2, 4):
            if a.shape[dim] % deg:
                continue
            want = jru.split_tp_shards(a, deg, dim)
            got = ru.split_tp_shards(a, deg, dim)
            got_t = ru.split_tp_shards(torch.from_numpy(a), deg, dim)
            assert len(got) == len(want) == len(got_t)
            for g, gt, w in zip(got, got_t, want):
                np.testing.assert_array_equal(g, w)
                assert torch.is_tensor(gt) and gt.is_contiguous()
                np.testing.assert_array_equal(gt.numpy(), w)
            np.testing.assert_array_equal(ru.merge_tp_shards(got, dim),
                                          jru.merge_tp_shards(want, dim))
            merged_t = ru.merge_tp_shards(got_t, dim)
            assert torch.is_tensor(merged_t)
            np.testing.assert_array_equal(merged_t.numpy(), a)
            for target in (1, 2, 4):
                if a.shape[dim] % target:
                    continue
                for g, w in zip(ru.reshape_tp(got, target, dim),
                                jru.reshape_tp(want, target, dim)):
                    np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="divisible"):
        ru.split_tp_shards(a, 3, 0)
    with pytest.raises(ValueError, match="divisible"):
        ru.split_tp_shards(torch.from_numpy(a), 3, 0)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_infer_tp_dim_agrees_with_jax_and_the_live_plan(name):
    leaves, model = flax_leaves(name)
    plans = {tp: tp_plan(model, TensorParallel(tp, 0)) for tp in (2, 4)}
    for path, (shape, pname) in leaves.items():
        got = ru.infer_tp_dim(path, len(shape))
        assert got == jru.infer_tp_dim(path, len(shape)), path
        for tp, plan in plans.items():
            leaf = plan[pname]
            if len(shape) < 2:
                # JAX's offline rule keeps 1-D leaves whole; the live rule
                # order sends the o / down biases to "row" (dim 0)
                assert got is None
                assert (leaf is not None) == path.endswith(
                    ("o_proj/bias", "down_proj/bias")), (path, tp)
            elif got is not None and shape[got] % tp == 0:
                assert leaf is not None and leaf.dim == got, (path, tp)
            else:
                assert leaf is None, (path, tp)
    custom = [(r"dense$", "row")]
    assert ru.infer_tp_dim("a/dense", 2, rules=custom) == \
        jru.infer_tp_dim("a/dense", 2, rules=custom) == 0
    assert ru.infer_tp_dim("a/b/kernel", 1) is None


@pytest.mark.parametrize("name", sorted(MODELS))
def test_reshape_flat_state_dict_bitwise_jax(name):
    leaves, _ = flax_leaves(name)
    rng = np.random.default_rng(1)
    full = {p: rng.standard_normal(s).astype(np.float32)
            for p, (s, _) in leaves.items()}
    src = {}
    for p, a in full.items():
        dim = ru.infer_tp_dim(p, a.ndim)
        if dim is not None and a.shape[dim] % 4:
            continue                    # a dim 4 ranks cannot split
        src[p] = [a, a] if dim is None else ru.split_tp_shards(a, 2, dim)
    got4 = ru.reshape_flat_state_dict(src, 2, 4)
    want4 = jru.reshape_flat_state_dict(src, 2, 4)
    assert sorted(got4) == sorted(want4)
    for p in want4:
        assert len(got4[p]) == len(want4[p]) == 4
        for g, w in zip(got4[p], want4[p]):
            np.testing.assert_array_equal(g, w)
    got1 = ru.reshape_flat_state_dict(got4, 4, 1)
    for p, (a,) in got1.items():
        np.testing.assert_array_equal(a, full[p])
        np.testing.assert_array_equal(
            a, jru.reshape_flat_state_dict(want4, 4, 1)[p][0])
    # torch shards round-trip too
    t4 = ru.reshape_flat_state_dict(
        {p: [torch.from_numpy(x) for x in s] for p, s in src.items()}, 2, 4)
    for p in want4:
        for g, w in zip(t4[p], want4[p]):
            np.testing.assert_array_equal(g.numpy(), w)
    # a leaf no rule classifies must not differ across ranks
    bad = {"mystery/thing": [np.zeros((2, 2)), np.ones((2, 2))]}
    for mod in (ru, jru):
        with pytest.raises(ValueError, match="no TP rule"):
            mod.reshape_flat_state_dict(bad, 2, 1)
        with pytest.raises(ValueError, match="expected 2 shards"):
            mod.reshape_flat_state_dict({"x": [np.zeros(2)]}, 2, 1)
