"""The port's block-sparse attention (``deepspeed_tpu_torch.ops.
sparse_attention``) against the JAX package's on the CPU, from the same
numpy inputs.

- layouts: every sparsity config gives bitwise the JAX class's layout for
  the same constructor arguments and call order (random configs too), and
  ``layout_tables`` bitwise the same ``idx`` / ``counts``; constructor
  errors match;
- forward: the plain version of kernel K8 (the CPU forward) against JAX
  ``block_sparse_attention`` (its Pallas kernel in interpret mode), fp32
  at B 2, S 64, H 2, D 8, block 16: causal and non-causal, per-head
  layouts, key-padding masks with a fully padded block, a row with no
  active block.  Tolerance rtol 2e-4 / atol 2e-5, the JAX test's own;
- gradients: the autograd Function on the CPU against ``jax.grad``
  (rtol 5e-3 / atol 1e-4, as the JAX test holds its kernel against its
  reference) and against the port's dense reference at 1e-4;
- ``SparseSelfAttention`` on converted flax params against JAX's module;
- the table cache and the wrapper's refusals.

K8 itself runs only on a card (``tests/test_torch_cuda_kernels.py`` and
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.sparse_attention import block_sparse as jbs
from deepspeed_tpu_torch.ops import sparse_attention as psa
from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as pbs
from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention

BLOCK = 16
FWD_TOL = dict(rtol=2e-4, atol=2e-5)

# (class name, constructor kwargs) — every config class, both attention
# directions, per-head layouts, random draws
CONFIGS = {
    "dense": ("DenseSparsityConfig", dict(num_heads=2)),
    "fixed": ("FixedSparsityConfig", dict(num_heads=2, num_local_blocks=2)),
    "fixed_uni": ("FixedSparsityConfig", dict(
        num_heads=2, num_local_blocks=2, attention="unidirectional")),
    "fixed_horizontal": ("FixedSparsityConfig", dict(
        num_heads=2, num_local_blocks=2, horizontal_global_attention=True)),
    "fixed_per_head": ("FixedSparsityConfig", dict(
        num_heads=2, num_local_blocks=2, different_layout_per_head=True,
        num_different_global_patterns=2)),
    "variable": ("VariableSparsityConfig", dict(
        num_heads=2, num_random_blocks=1, local_window_blocks=[1, 2],
        global_block_indices=[0], different_layout_per_head=True, seed=3)),
    "variable_uni": ("VariableSparsityConfig", dict(
        num_heads=2, num_random_blocks=2, global_block_indices=[1],
        global_block_end_indices=[2], attention="unidirectional",
        horizontal_global_attention=False)),
    "bigbird": ("BigBirdSparsityConfig", dict(
        num_heads=2, num_random_blocks=1, num_sliding_window_blocks=3)),
    "bigbird_per_head_uni": ("BigBirdSparsityConfig", dict(
        num_heads=2, num_random_blocks=2, different_layout_per_head=True,
        attention="unidirectional", seed=5)),
    "longformer": ("BSLongformerSparsityConfig", dict(num_heads=2)),
    "longformer_spans": ("BSLongformerSparsityConfig", dict(
        num_heads=2, global_block_indices=[0, 2],
        global_block_end_indices=[1, 4])),
    "sliding_uni": ("LocalSlidingWindowSparsityConfig", dict(
        num_heads=2, num_sliding_window_blocks=2)),
    "sliding_bi": ("LocalSlidingWindowSparsityConfig", dict(
        num_heads=2, num_sliding_window_blocks=3, attention="bidirectional")),
}


def _pair(name, block=BLOCK):
    cls, kw = CONFIGS[name]
    return (getattr(jsa, cls)(block=block, **kw),
            getattr(psa, cls)(block=block, **kw))


def _causal(cfg):
    return getattr(cfg, "attention", "bidirectional") == "unidirectional"


def _qkv(B=2, S=64, H=2, D=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(4)]


# ------------------------------ layouts -------------------------------- #
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_layouts_and_tables_bitwise_equal_jax(name):
    jcfg, pcfg = _pair(name)
    for seq in (128, 64, 128):          # repeated calls draw anew in both
        want, got = jcfg.make_layout(seq), pcfg.make_layout(seq)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        for a, b in zip(pbs.layout_tables(got), jbs.layout_tables(want)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    jcfg, pcfg = _pair(name)
    for seq, causal in ((64, True), (64, False), (64, True)):
        np.testing.assert_array_equal(pbs.cached_layout(pcfg, seq, causal),
                                      jbs.cached_layout(jcfg, seq, causal))


@pytest.mark.parametrize("ctor", [
    lambda m: m.FixedSparsityConfig(num_heads=2, attention="sideways"),
    lambda m: m.FixedSparsityConfig(num_heads=2, attention="unidirectional",
                                    horizontal_global_attention=True),
    lambda m: m.FixedSparsityConfig(num_heads=2,
                                    num_different_global_patterns=2),
    lambda m: m.VariableSparsityConfig(num_heads=2, attention="sideways"),
    lambda m: m.BigBirdSparsityConfig(num_heads=2, attention="sideways"),
    lambda m: m.BigBirdSparsityConfig(num_heads=1, block=16,
                                      num_random_blocks=5).make_layout(64),
    lambda m: m.BigBirdSparsityConfig(
        num_heads=1, block=16, num_sliding_window_blocks=5).make_layout(64),
    lambda m: m.DenseSparsityConfig(num_heads=1, block=16).make_layout(65),
    lambda m: m.SparsityConfig(num_heads=1).make_layout(64),
], ids=["fixed_attention", "fixed_horizontal_uni", "fixed_patterns",
        "variable_attention", "bigbird_attention", "bigbird_random",
        "bigbird_window", "seq_not_divisible", "base_make_layout"])
def test_config_errors_match_jax(ctor):
    with pytest.raises(Exception) as want:
        ctor(jsa)
    with pytest.raises(Exception) as got:
        ctor(psa)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


# ------------------------------ forward -------------------------------- #
def _masks(kind, B=2, S=64):
    if kind is None:
        return None
    keep = np.ones((B, S), np.int32)
    keep[1, 48:] = 0                    # row 1: its tail block fully padded
    if kind == "ragged":
        keep[0, 37:] = 0
    return keep


FWD_CASES = [(name, causal, mask)
             for name in ("dense", "fixed", "fixed_per_head", "bigbird",
                          "variable", "longformer", "sliding_uni")
             for causal in (False, True)
             for mask in (None, "tail", "ragged")
             if not (mask and causal)] + \
    [("bigbird", True, "tail"), ("fixed_uni", True, None),
     ("bigbird_per_head_uni", True, "ragged")]


@pytest.mark.parametrize("case", FWD_CASES,
                         ids=[f"{n}-{'causal' if c else 'full'}-{m}"
                              for n, c, m in FWD_CASES])
def test_plain_forward_matches_jax_pallas(case):
    name, causal, mask = case
    jcfg, pcfg = _pair(name)
    lay_j, lay_p = jcfg.make_layout(64), pcfg.make_layout(64)
    np.testing.assert_array_equal(lay_p, lay_j)
    q, k, v, _ = _qkv(seed=len(name))
    keep = _masks(mask)
    want = jbs.block_sparse_attention(
        *(jnp.asarray(x) for x in (q, k, v)), lay_j, BLOCK, causal=causal,
        key_padding_mask=None if keep is None else jnp.asarray(keep))
    got = pbs.block_sparse_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), lay_p, BLOCK,
        causal=causal,
        key_padding_mask=None if keep is None else torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_all_padded_rows_attend_like_jax():
    """A query row whose active keys are all padded keeps finite scores
    (the bias is -1e4, not a mask) and gives a weighted mean of their
    values, as in JAX — not 0.  Such rows are held at atol 2e-4: their
    scores are ~-3.5e3 in fp32, whose rounding (2^-10 before the scale)
    moves the softmax weights by ~1e-4 relative, and JAX's own two
    forwards (Pallas and gather) differ by 7.8e-5 on these inputs."""
    lay = np.zeros((1, 4, 4), np.int64)
    lay[0, :, 3] = 1                    # every row sees only block 3
    lay[0, 3, :] = 1
    keep = np.ones((2, 64), np.int32)
    keep[0, 48:] = 0                    # row 0: block 3 fully padded
    q, k, v, _ = _qkv(seed=9)
    want = jbs.block_sparse_attention(
        *(jnp.asarray(x) for x in (q, k, v)), lay, BLOCK,
        key_padding_mask=jnp.asarray(keep))
    got = pbs.block_sparse_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), lay, BLOCK,
        key_padding_mask=torch.from_numpy(keep))
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got[1], want[1], **FWD_TOL)
    np.testing.assert_allclose(got[0, 48:], want[0, 48:], **FWD_TOL)
    np.testing.assert_allclose(got[0, :48], want[0, :48], rtol=2e-4,
                               atol=2e-4)
    assert float(np.abs(got[0, :48]).min()) > 0


def test_empty_row_gives_zero_like_the_kernel():
    """A row with no active block: 0 from the Pallas kernel and from the
    port (both its kernel and its plain version)."""
    lay = np.ones((2, 4, 4), np.int64)
    lay[:, 2] = 0                        # block-row 2 attends nothing
    lay[1, 1] = 0
    q, k, v, _ = _qkv(seed=4)
    want = np.asarray(jbs.block_sparse_attention(
        *(jnp.asarray(x) for x in (q, k, v)), lay, BLOCK))
    got = pbs.block_sparse_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), lay, BLOCK).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)
    assert (got[:, 32:48] == 0).all() and (got[:, 16:32, 1] == 0).all()
    assert (want[:, 32:48] == 0).all()


@pytest.mark.parametrize("causal", [False, True])
def test_reference_matches_jax(causal):
    jcfg, pcfg = _pair("bigbird")
    lay = pcfg.make_layout(64)
    q, k, v, _ = _qkv(seed=2)
    want = jbs.sparse_attention_reference(
        *(jnp.asarray(x) for x in (q, k, v)), jcfg.make_layout(64), BLOCK,
        causal=causal)
    got = pbs.sparse_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), lay, BLOCK, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


# ----------------------------- gradients ------------------------------- #
GRAD_CASES = [("fixed", False, None), ("bigbird", True, None),
              ("fixed_per_head", False, "ragged"),
              ("bigbird_per_head_uni", True, "tail")]


def repair_jax_gather(monkeypatch):
    """``jax.grad`` through the JAX ``block_sparse_attention`` with a
    key-padding mask raises: its ``_sparse_attn_gather`` reshapes v with
    q's width, which the fold widened by one feature.  Patched here (the
    package's file is untouched) to pad v with a zero feature and drop it
    from the output, so ``jax.vjp`` of the same formulation runs."""
    gather = jbs._sparse_attn_gather

    def padded(q, k, v, *args):
        pad = q.shape[-1] - v.shape[-1]
        if pad:
            v = jnp.concatenate([v, jnp.zeros(v.shape[:-1] + (pad,),
                                              v.dtype)], axis=-1)
        out = gather(q, k, v, *args)
        return out[..., :out.shape[-1] - pad]

    monkeypatch.setattr(jbs, "_sparse_attn_gather", padded)


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=[f"{n}-{'causal' if c else 'full'}-{m}"
                              for n, c, m in GRAD_CASES])
def test_gradients_match_jax_and_dense_reference(case, monkeypatch):
    name, causal, mask = case
    if mask:
        repair_jax_gather(monkeypatch)
    jcfg, pcfg = _pair(name)
    lay_j, lay_p = jcfg.make_layout(64), pcfg.make_layout(64)
    q, k, v, w = _qkv(seed=7 + len(name))
    keep = _masks(mask)

    def jloss(q, k, v):
        out = jbs.block_sparse_attention(
            q, k, v, lay_j, BLOCK, causal=causal,
            key_padding_mask=None if keep is None else jnp.asarray(keep))
        return jnp.sum(out * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = pbs.block_sparse_attention(
        *leaves, lay_p, BLOCK, causal=causal,
        key_padding_mask=None if keep is None else torch.from_numpy(keep))
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-3,
                                   atol=1e-4)
    if keep is not None:
        return                  # the dense reference takes no padding mask
    ref_leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    ref = pbs.sparse_attention_reference(*ref_leaves, lay_p, BLOCK,
                                         causal=causal)
    ref_grads = torch.autograd.grad((ref * torch.from_numpy(w)).sum(),
                                    ref_leaves)
    for a, b in zip(got, ref_grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_empty_row_gradient_is_zero():
    """The port's backward is the gradient of its forward: a row with no
    active block sends nothing back (JAX's gather vjp would send its
    gradient into block 0's values)."""
    lay = np.zeros((1, 4, 4), np.int64)
    lay[0, [0, 1, 3], 0] = 1            # block-row 2 attends nothing
    lay[0, 3, 3] = 1
    q, k, v, _ = _qkv(B=1, H=1, seed=5)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    g = torch.zeros(1, 64, 1, 8)
    g[:, 32:48] = 1.0                   # only the empty row's output
    out = pbs.block_sparse_attention(*leaves, lay, BLOCK)
    for grad in torch.autograd.grad(out, leaves, g):
        assert float(grad.abs().max()) == 0.0


# ------------------------------- module -------------------------------- #
@pytest.mark.parametrize("masked", [False, True])
def test_sparse_self_attention_module_matches_jax(masked):
    jcfg, pcfg = _pair("bigbird")
    jmod = jsa.SparseSelfAttention(hidden_size=32, num_heads=2,
                                   sparsity_config=jcfg)
    pmod = psa.SparseSelfAttention(hidden_size=32, num_heads=2,
                                   sparsity_config=pcfg)
    x = np.random.default_rng(0).standard_normal((2, 64, 32)).astype(
        np.float32)
    keep = _masks("ragged") if masked else None
    params = jmod.init(jax.random.key(0), jnp.asarray(x))
    params = jax.tree.map(lambda a: np.asarray(a) + 0.05, params)
    want = jmod.apply(params, jnp.asarray(x),
                      None if keep is None else jnp.asarray(keep))
    pmod.load_state_dict(sparse_self_attention.params_from_flax(params))
    got = pmod(torch.from_numpy(x),
               None if keep is None else torch.from_numpy(keep))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-5)


def test_sparse_attention_fn_default_config():
    fn = psa.SparseAttentionFn()
    assert isinstance(fn.sparsity_config, psa.FixedSparsityConfig)
    assert fn.get_layout(256).shape == (4, 4, 4)


# ------------------------- tables and refusals ------------------------- #
def test_device_tables_are_cached_per_config_and_device():
    _, pcfg = _pair("bigbird")
    a = pbs.cached_tables(pcfg, 64, 2, torch.device("cpu"), causal=True)
    b = pbs.cached_tables(pcfg, 64, 2, torch.device("cpu"), causal=True)
    assert a[0] is b[0] and a[1] is b[1]
    idx, counts = pbs.layout_tables(np.tril(pbs.cached_layout(pcfg, 64,
                                                              True)))
    np.testing.assert_array_equal(a[0].numpy(), idx)
    np.testing.assert_array_equal(a[1].numpy(), counts)
    assert a[0].dtype == torch.int32 and a[1].dtype == torch.int32


@pytest.mark.parametrize("block,D", [(8, 64), (48, 64), (64, 32), (64, 80)])
def test_kernel_wrapper_refuses_blocks_and_head_dims(block, D):
    """A block or head dim K8 has no instantiation for raises ValueError
    before anything is launched (never a quiet dense path)."""
    S = 2 * block
    q = torch.zeros(1, S, 2, D)
    nt = -(-S // pbs.TILE)
    tables = pbs.SparseTables(torch.zeros(2, 2, 1, dtype=torch.int32),
                              torch.ones(2, 2, dtype=torch.int32),
                              torch.zeros(2, nt, 1, dtype=torch.int32),
                              torch.ones(2, nt, dtype=torch.int32))
    with pytest.raises(ValueError, match="block|head_dim"):
        pbs.block_sparse_attention_fwd(q, q, q, tables, 0.1, True, block)
