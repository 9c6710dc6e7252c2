"""The remat policies of the port's model (``remat_policy``, the JAX names)
against the JAX package's, on the CPU, from one numpy-drawn parameter
tree.

- for each policy, the loss (1e-5 relative) and every parameter's
  gradient (1e-4 absolute and relative: fp32 summation order) equal
  ``jax.value_and_grad`` of the JAX model under the same policy;
- within the port the loss and every gradient are bitwise equal across
  every policy and ``remat=False``, for OPT-1.3B's layout, OPT-350m's
  post-LN / ``embed_proj_dim`` one and Llama's (rope, GQA);
- the flash forward runs once a layer a step under the flash policies and
  twice under ``nothing_saveable`` (counted at its plain version, where a
  CUDA tensor would launch K1);
- the bytes a policy keeps for the backward, summed through
  ``torch.autograd.graph.saved_tensors_hooks``, are ordered
  ``nothing_saveable`` < ``flash_only_saveable`` <
  ``dots_and_attn_saveable`` <= ``remat=False``, and a region's own graph
  is freed when its forward returns, without a garbage collection;
- with the embeddings frozen (no block's input then needs a gradient
  through its argument) every block still gets its gradients: bitwise
  ``remat=False``'s, JAX's within 1e-4, and through the training engine
  the same step as ``remat=False``.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, dtype="float32", use_flash_attention=True,
           tie_word_embeddings=True, activation="relu")
LAYOUTS = {"opt": {},
           "opt_350m": dict(pre_layer_norm=False, embed_proj_dim=16),
           "llama": dict(position_embedding="rope", rms_norm=True,
                         gated_mlp=True, activation="silu", num_kv_heads=2)}
POLICIES = ["nothing_saveable", "everything_saveable", "dots_saveable",
            "checkpoint_dots", "dots_with_no_batch_dims_saveable",
            "checkpoint_dots_with_no_batch_dims", "flash_only_saveable",
            "dots_and_attn_saveable", "attn_residuals_saveable",
            "not_a_policy"]
B, S = 2, 16


def random_tree(jmodel, seed=0):
    """Numpy-drawn parameter tree (as ``test_torch_train_parity.py``):
    norm scales near 1, biases small, matrices std 0.2."""
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
        return 0.2 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, over in LAYOUTS.items():
        cfg = {**CFG, **over}
        tree = random_tree(jt.Transformer(jt.TransformerConfig(**cfg)))
        out[name] = (cfg, tree,
                     pt.params_from_flax(tree, pt.TransformerConfig(**cfg)))
    return out


def _ids(seed=1):
    return np.random.default_rng(seed).integers(0, 97, (B, S)).astype(
        np.int32)


def port_step(cfg, sd, frozen=(), **over):
    """Loss and gradients of one forward / backward of the port model, the
    parameters named in ``frozen`` needing no gradient."""
    m = pt.Transformer(pt.TransformerConfig(**{**cfg, **over}), device="cpu")
    m.load_state_dict(sd)
    for name, p in m.named_parameters():
        p.requires_grad_(name not in frozen)
    loss = m({"input_ids": torch.from_numpy(_ids()).long()})
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in m.named_parameters()}


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_loss_and_grads_match_jax(trees, policy):
    cfg, tree, sd = trees["opt"]
    jm = jt.Transformer(jt.TransformerConfig(**{**CFG, "remat": True,
                                                "remat_policy": policy}))
    loss, grads = jax.value_and_grad(
        lambda p: jm.apply(p, {"input_ids": jnp.asarray(_ids())}))(tree)
    want = pt.params_from_flax(grads, pt.TransformerConfig(**cfg))
    got_loss, got = port_step(cfg, sd, remat=True, remat_policy=policy)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_grads_bitwise_equal_across_policies(trees, layout):
    cfg, _, sd = trees[layout]
    want_loss, want = port_step(cfg, sd, remat=False)
    for policy in POLICIES:
        loss, got = port_step(cfg, sd, remat=True, remat_policy=policy)
        assert torch.equal(loss, want_loss), policy
        for name, g in got.items():
            assert torch.equal(g, want[name]), (policy, name)


FROZEN = ("embed_tokens.weight", "embed_positions.weight")
FROZEN_POLICIES = ["nothing_saveable", "dots_saveable",
                   "dots_with_no_batch_dims_saveable", "flash_only_saveable",
                   "dots_and_attn_saveable"]


@pytest.mark.parametrize("policy", FROZEN_POLICIES)
def test_frozen_embeddings_still_train_every_block(trees, policy):
    """The first block's input needs no gradient when the embeddings are
    frozen, but what each block closes over does: every other parameter's
    gradient is bitwise ``remat=False``'s and JAX's within 1e-4 (JAX
    differentiates every parameter; freezing one changes no other's
    gradient), and the frozen ones get none."""
    cfg, tree, sd = trees["opt"]
    jm = jt.Transformer(jt.TransformerConfig(**{**CFG, "remat": True,
                                                "remat_policy": policy}))
    grads = jax.grad(
        lambda p: jm.apply(p, {"input_ids": jnp.asarray(_ids())}))(tree)
    want_jax = pt.params_from_flax(grads, pt.TransformerConfig(**cfg))
    want_loss, want = port_step(cfg, sd, FROZEN, remat=False)
    loss, got = port_step(cfg, sd, FROZEN, remat=True, remat_policy=policy)
    assert torch.equal(loss, want_loss)
    for name, g in got.items():
        if name in FROZEN:
            assert g is None and want[name] is None, name
            continue
        assert g is not None, name
        assert torch.equal(g, want[name]), name
        np.testing.assert_allclose(g.numpy(), want_jax[name].numpy(),
                                   err_msg=name, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("policy", ["nothing_saveable",
                                    "flash_only_saveable"])
def test_frozen_embeddings_train_through_the_engine(trees, policy):
    """One ``train_batch`` of the training engine, embeddings frozen: the
    remat'd model's step moves every trainable parameter exactly as
    ``remat=False``'s does."""
    import deepspeed_tpu_torch
    cfg, _, sd = trees["opt"]
    config = {"train_micro_batch_size_per_gpu": B,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}}}
    batch = {"input_ids": _ids()[None].astype(np.int64)}
    after = {}
    for name, over in (("plain", dict(remat=False)),
                       ("remat", dict(remat=True, remat_policy=policy))):
        m = pt.Transformer(pt.TransformerConfig(**{**cfg, **over}),
                           device="cpu")
        m.load_state_dict(sd)
        for n, p in m.named_parameters():
            p.requires_grad_(n not in FROZEN)
        engine, *_ = deepspeed_tpu_torch.initialize(model=m, config=config,
                                                    device="cpu")
        engine.train_batch(batch=batch)
        after[name] = {n: p.detach().clone()
                       for n, p in m.named_parameters()}
    for n, p in after["remat"].items():
        assert torch.equal(p, after["plain"][n]), n
        moved = not torch.equal(p, sd[n])
        assert moved == (n not in FROZEN), n


class _Counted:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.mark.parametrize("policy, per_layer", [
    ("nothing_saveable", 2), ("dots_with_no_batch_dims_saveable", 2),
    ("dots_saveable", 2), ("flash_only_saveable", 1),
    ("dots_and_attn_saveable", 1), ("everything_saveable", 1),
    (None, 1)])
def test_flash_forward_runs_once_a_layer_under_flash_policies(
        trees, monkeypatch, policy, per_layer):
    """K1's forward (its plain version on the CPU, reached through the
    call site a CUDA tensor launches the kernel from) per step:
    2L where the backward recomputes it, L where a policy keeps its output
    and LSE (``None``: ``remat=False``)."""
    k1 = _Counted(fa.flash_attention_plain)
    monkeypatch.setattr(fa, "flash_attention_plain", k1)
    cfg, _, sd = trees["opt"]
    over = dict(remat=False) if policy is None else \
        dict(remat=True, remat_policy=policy)
    port_step(cfg, sd, **over)
    assert k1.calls == per_layer * cfg["num_layers"]


def saved_bytes(cfg, sd, **over):
    """Bytes of the distinct storages autograd keeps for the backward of
    one forward (parameters excluded), summed through
    ``saved_tensors_hooks``."""
    m = pt.Transformer(pt.TransformerConfig(**{**cfg, **over}), device="cpu")
    m.load_state_dict(sd)
    params = {p.untyped_storage().data_ptr() for p in m.parameters()}
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in params:
            seen[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = m({"input_ids": torch.from_numpy(_ids()).long()})
    loss.backward()
    return sum(seen.values())


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_saved_bytes_are_ordered(trees, layout):
    cfg, _, sd = trees[layout]
    got = {p: saved_bytes(cfg, sd, remat=True, remat_policy=p)
           for p in ("nothing_saveable", "flash_only_saveable",
                     "dots_and_attn_saveable")}
    got["remat=False"] = saved_bytes(cfg, sd, remat=False)
    assert got["nothing_saveable"] < got["flash_only_saveable"] \
        < got["dots_and_attn_saveable"] <= got["remat=False"], got
    # flash_only keeps, on top of nothing_saveable, exactly K1's output
    # and fp32 LSE of every layer
    H, D = cfg["num_heads"], cfg["hidden_size"] // cfg["num_heads"]
    per_layer = B * S * H * D * 4 + B * H * S * 4
    assert got["flash_only_saveable"] - got["nothing_saveable"] == \
        cfg["num_layers"] * per_layer


@pytest.mark.parametrize("policy", ["nothing_saveable",
                                    "dots_and_attn_saveable"])
def test_region_graph_is_freed_after_the_forward(trees, monkeypatch, policy):
    """What a block computes and does not keep dies with the region's
    forward, with the garbage collector off: no block intermediate (here
    each MLP input) outlives the forward pass."""
    from deepspeed_tpu_torch.models.transformer import MLP
    cfg, _, sd = trees["opt"]
    seen = []
    forward = MLP.forward

    def watched(self, x):
        seen.append(weakref.ref(x))
        return forward(self, x)

    monkeypatch.setattr(MLP, "forward", watched)
    m = pt.Transformer(pt.TransformerConfig(**{**cfg, "remat": True,
                                               "remat_policy": policy}),
                       device="cpu")
    m.load_state_dict(sd)
    gc.disable()
    try:
        loss = m({"input_ids": torch.from_numpy(_ids()).long()})
        assert len(seen) == cfg["num_layers"]
        assert all(ref() is None for ref in seen)
        loss.backward()
    finally:
        gc.enable()
