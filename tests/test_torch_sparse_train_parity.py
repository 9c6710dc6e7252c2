"""The port's block-sparse training slice against the JAX package's, on the
CPU, from the same numpy inputs and converted weights.

- model: the causal-LM loss and every parameter's gradient of a tiny OPT
  (2 layers, hidden 64, 4 heads, vocab 97, S 64, fp32) whose attention is
  block-sparse (BigBird and Fixed, block 16) against ``jax.value_and_grad``
  of the JAX model (Pallas in interpret mode), with and without an
  ``attention_mask`` batch.  Tolerance: loss 1e-5 relative, gradients
  1e-4, as ``tests/test_torch_train_parity.py`` states (fp32 summation
  order).  The masked batch needs the JAX gather backward repaired in the
  test (``repair_jax_gather``: its v reshape takes q's widened width);
- engine: 3 ``train_batch`` steps of the port engine against the JAX
  engine from the same converted init;
- the layout hazard: random configs draw anew on every ``make_layout``,
  so a remat recompute must find the cached layout — remat and non-remat
  gradients are equal;
- generation: a sparse model's prefill never goes block-sparse (flash or
  dense, as in JAX) and decode attends densely: greedy tokens equal JAX
  ``generate()`` on the one-pass and the chunked prefill route, and the
  dense-decode warning fires once.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.parallel.topology import initialize_topology, reset_topology

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.ops import sparse_attention as psa
from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as pbs
from deepspeed_tpu_torch.utils import logging as plog

from test_torch_sparse_attention import repair_jax_gather

CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, dtype="float32", use_flash_attention=True,
           tie_word_embeddings=True, activation="relu")
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 64
SPARSITY = {
    "bigbird": ("BigBirdSparsityConfig", dict(
        num_heads=4, block=16, num_random_blocks=1,
        num_sliding_window_blocks=3, num_global_blocks=1, seed=2)),
    "fixed": ("FixedSparsityConfig", dict(
        num_heads=4, block=16, num_local_blocks=2,
        attention="unidirectional")),
    # each block sees only itself: far from dense, so a prefill that went
    # block-sparse would change the tokens
    "local": ("LocalSlidingWindowSparsityConfig", dict(
        num_heads=4, block=16, num_sliding_window_blocks=1)),
}


def _configs(kind, **over):
    """The JAX and the port model config with equal sparsity configs
    (separate instances: each draws its own layout, in the same order)."""
    cls, kw = SPARSITY[kind]
    return (jt.TransformerConfig(**CFG, **over,
                                 sparse_attention=getattr(jsa, cls)(**kw)),
            pt.TransformerConfig(**CFG, **over,
                                 sparse_attention=getattr(psa, cls)(**kw)))


def random_tree(jmodel, seed=0):
    """The JAX model's parameter tree with numpy leaves drawn from a
    seed: norm scales near 1, biases small, matrices std 0.2."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), {"input_ids": jnp.zeros((1, 16), jnp.int32)}))
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
def tree():
    # a sparse model has the dense model's parameters
    return random_tree(jt.Transformer(jt.TransformerConfig(**CFG)))


def _port_model(cfg, tree):
    m = pt.Transformer(cfg, device="cpu")
    m.load_state_dict(pt.params_from_flax(tree, cfg))
    return m


def _batch(seed, masked=False):
    rng = np.random.default_rng(seed)
    batch = {"input_ids": rng.integers(0, 97, (B, S)).astype(np.int32)}
    if masked:                      # right-padded second row: blocks 3, 4
        mask = np.ones((B, S), np.int32)
        mask[1, 37:] = 0
        batch["attention_mask"] = mask
    return batch


def _port_loss_and_grads(model, batch):
    model.zero_grad()
    loss = model({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone()
                                  for n, p in model.named_parameters()}


@pytest.mark.parametrize("kind", ["bigbird", "fixed"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_loss_and_grads_match_jax(tree, kind, masked, monkeypatch):
    if masked:
        repair_jax_gather(monkeypatch)
    jcfg, pcfg = _configs(kind)
    batch = _batch(1, masked)
    jloss, jgrads = jax.value_and_grad(lambda p: jt.Transformer(jcfg).apply(
        p, {k: jnp.asarray(v) for k, v in batch.items()}))(tree)
    want = pt.params_from_flax(jgrads, pcfg)
    got_loss, got = _port_loss_and_grads(_port_model(pcfg, tree), batch)
    np.testing.assert_allclose(got_loss, float(jloss), rtol=1e-5)
    np.testing.assert_array_equal(
        pbs.cached_layout(pcfg.sparse_attention, S, True),
        jsa.block_sparse.cached_layout(jcfg.sparse_attention, S, True))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_remat_recompute_finds_the_cached_layout(tree):
    """BigBird draws random blocks on each ``make_layout``: under remat the
    recompute must attend over the forward's layout, so remat and
    non-remat gradients agree (and the layout was drawn once)."""
    batch = _batch(2)
    _, plain_cfg = _configs("bigbird", remat=False)
    _, remat_cfg = _configs("bigbird", remat=True, loss_seq_chunks=4)
    want_loss, want = _port_loss_and_grads(_port_model(plain_cfg, tree),
                                           batch)
    draws = []
    sc = remat_cfg.sparse_attention
    make = sc.make_layout
    sc.make_layout = lambda seq: draws.append(seq) or make(seq)
    got_loss, got = _port_loss_and_grads(_port_model(remat_cfg, tree), batch)
    assert draws == [S]
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=1e-5,
                                   atol=1e-6, msg=name)


ENGINE_CONFIG = {
    "train_micro_batch_size_per_gpu": B,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "AdamW",
                  "params": {"lr": 3e-3, "weight_decay": 0.01}},
    "gradient_clipping": 1.0,
}


def test_engine_trajectory_matches_jax(tree):
    jcfg, pcfg = _configs("bigbird")
    rng = np.random.default_rng(11)
    batches = [{"input_ids": rng.integers(0, 97, (2, B, S)).astype(np.int32)}
               for _ in range(3)]
    topo = initialize_topology(dp=1, devices=jax.devices()[:1])
    try:
        jeng, *_ = deepspeed_tpu.initialize(
            model=jt.Transformer(jcfg), model_parameters=tree,
            config=ENGINE_CONFIG, topology=topo)
        want = [float(jeng.train_batch(batch=b)) for b in batches]
        want_params = pt.params_from_flax(jax.device_get(jeng.params), pcfg)
    finally:
        reset_topology()
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=pt.Transformer(pcfg), model_parameters=tree,
        config=ENGINE_CONFIG, device="cpu")
    got = [float(eng.train_batch(batch=b)) for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    sd = eng.module_state_dict()
    for name, w in want_params.items():
        if name.endswith("attn.k_proj.bias"):
            continue     # true gradient 0: Adam steps on roundoff (see
            #              test_torch_train_parity.py)
        np.testing.assert_allclose(sd[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


# --------------------------------------------------------------------- #
# Generation with a sparse model: prefill flash / dense, decode dense
# --------------------------------------------------------------------- #
P, NEW = 48, 8
DECODE_WARNING = ("sparse_attention model decoding with dense KV-cache "
                  "attention — train/decode attention patterns differ")


@pytest.mark.parametrize("chunk", [None, 8], ids=["one_pass", "chunked"])
@pytest.mark.parametrize("kind", ["local", "bigbird"])
def test_sparse_model_generates_like_jax(tree, kind, chunk, monkeypatch):
    jcfg, pcfg = _configs(kind)
    config = dict(dtype="float32", prefill_chunk_size=chunk)
    jeng = deepspeed_tpu.init_inference(jt.Transformer(jcfg),
                                        config=dict(config))
    jeng.set_params(tree)
    teng = deepspeed_tpu_torch.init_inference(pt.Transformer(pcfg),
                                              config=dict(config),
                                              device="cpu")
    teng.set_params(pt.params_from_flax(tree, pcfg))
    route = "chunked" if chunk else "one_pass"
    assert jeng.prefill_plan(B, P)[0] == teng.prefill_plan(B, P)[0] == route
    warned = []
    monkeypatch.setattr(plog.logger, "warning", warned.append)
    plog.warning_once.__defaults__[0].discard(DECODE_WARNING)
    ids = np.random.default_rng(5).integers(0, 97, (B, P)).astype(np.int32)
    want = np.asarray(jeng.generate(jnp.asarray(ids), max_new_tokens=NEW))
    got = teng.generate(torch.from_numpy(ids), max_new_tokens=NEW).numpy()
    np.testing.assert_array_equal(got, want)
    assert warned == [DECODE_WARNING]
