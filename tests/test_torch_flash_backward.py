"""The port's flash-attention backward on the CPU against the JAX package's
(``jax.grad`` through its custom_vjp, Pallas kernels in interpret mode) on
the same numpy inputs.

Two of the port's paths are checked: ``flash_attention_bwd_plain`` (the
dense counterpart of kernels K4 / K5) from the forward's residuals, and
autograd through ``flash_attention`` (the port's custom Function, which
takes that plain backward on CPU tensors).  S = 40 is ragged against the
kernels' 64-row tiles; D = 16 folds its power-of-two scale into q, D = 32
keeps the scale in the kernel.  Tolerance: fp32 at 1e-4 — both sides
compute the same gradient in fp32 and differ in summation order.

bf16 cases: the same comparison on bf16 inputs, with the plain backward
given the residuals of JAX's own forward kernel (out and lse, as
``jax.grad`` saves them), so the two sides differ only in summation order
and in where that moves a bf16 rounding — of P and dS before the second
products (both round them, JAX at ``ds.astype(k.dtype)`` and
``p.astype(do.dtype)``), of each head's dk / dv, and of the outputs.
Tolerance: max |err| <= 2^-9 * max |grad| (``BF16_REL``), half an ulp of
the largest bf16 gradient: rounding P and dS as JAX does is what meets it
(an fp32 P and dS, rounded only at the end, misses it by 1.2-2.9x on these
inputs).  The CUDA kernels themselves run only on a card
(``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``).
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.transformer import flash_attention as jax_flash
from deepspeed_tpu_torch.ops.transformer import flash_attention as pt_flash

TOL = dict(rtol=1e-4, atol=1e-4)
CASES = [(S, causal, kvh, D) for S in (8, 40) for causal in (True, False)
         for kvh, D in ((4, 16), (2, 32))]
IDS = [f"S{S}-{'causal' if c else 'full'}-kvh{kvh}-D{D}"
       for S, c, kvh, D in CASES]
# bf16: ragged S = 40, GQA (4 query heads on 2 kv heads), the folded
# (D = 16) and the in-kernel (D = 32) scale, both causal modes
BF16_REL = 2.0 ** -9
BF16_CASES = [(40, causal, 2, D) for causal in (True, False) for D in (16, 32)]
BF16_IDS = [f"bf16-S{S}-{'causal' if c else 'full'}-kvh{kvh}-D{D}"
            for S, c, kvh, D in BF16_CASES]


def _inputs(S, causal, kvh, D):
    rng = np.random.default_rng(S * 100 + kvh * 10 + D + int(causal))
    B, H = 2, 4
    shapes = [(B, S, H, D), (B, S, kvh, D), (B, S, kvh, D), (B, S, H, D)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@functools.lru_cache(maxsize=None)
def _jax_grads(S, causal, kvh, D):
    q, k, v, do = _inputs(S, causal, kvh, D)

    def f(q, k, v):
        out = jax_flash.flash_attention(q, k, v, causal=causal)
        return jnp.sum(out * do)

    grads = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax(case):
    S, causal, kvh, D = case
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(*case))
    scale = 1.0 / math.sqrt(D)
    folded = math.log2(scale).is_integer()
    qk = q * scale if folded else q          # q as the kernel sees it
    kscale = 1.0 if folded else scale
    out, lse = pt_flash.flash_attention_plain(qk, k, v, causal=causal,
                                              scale=kscale)
    dq, dk, dv = pt_flash.flash_attention_bwd_plain(qk, k, v, out, lse, do,
                                                    causal, kscale)
    if folded:
        dq = dq * scale                      # the chain rule through q*scale
    for got, want in zip((dq, dk, dv), _jax_grads(*case)):
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_autograd_flash_attention_matches_jax(case):
    S, causal, kvh, D = case
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(*case))
    for t in (q, k, v):
        t.requires_grad_(True)
    out = pt_flash.flash_attention(q, k, v, causal=causal)
    grads = torch.autograd.grad(out, (q, k, v), do)
    for got, want in zip(grads, _jax_grads(*case)):
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_bf16(S, causal, kvh, D):
    """bf16 inputs, JAX's forward residuals (out, lse [B, H, S]) for q as
    the kernel sees it, and ``jax.grad``'s (dq, dk, dv), all as fp32 numpy
    (every value exact in bf16 but lse)."""
    q, k, v, do = (_bf16(a) for a in _inputs(S, causal, kvh, D))
    scale = 1.0 / math.sqrt(D)
    folded = math.log2(scale).is_integer()
    bf = functools.partial(jnp.asarray, dtype=jnp.bfloat16)
    qk = bf(q) * jnp.asarray(scale, jnp.bfloat16) if folded else bf(q)
    out, lse = jax_flash._fwd(
        qk.transpose(0, 2, 1, 3), bf(k).transpose(0, 2, 1, 3),
        bf(v).transpose(0, 2, 1, 3), 1.0 if folded else scale, causal,
        jax_flash.DEFAULT_BLOCK_Q, jax_flash.DEFAULT_BLOCK_K)

    def f(q, k, v):
        out = jax_flash.flash_attention(q, k, v, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * do)

    grads = jax.grad(f, argnums=(0, 1, 2))(bf(q), bf(k), bf(v))
    f32 = [np.asarray(x.astype(jnp.float32))
           for x in (qk, out.transpose(0, 2, 1, 3), *grads)]
    return (q, k, v, do, f32[0], f32[1], np.asarray(lse[..., 0]), f32[2:])


@pytest.mark.parametrize("case", BF16_CASES, ids=BF16_IDS)
def test_plain_backward_bf16_matches_jax(case):
    """The plain backward in bf16 (P and dS rounded to bf16 before the
    second products, as K4 / K5 and JAX round them) against ``jax.grad``
    through the Pallas kernels in interpret mode, from JAX's residuals."""
    S, causal, kvh, D = case
    q, k, v, do, qk, out, lse, want = _jax_bf16(*case)
    bf = torch.bfloat16
    scale = 1.0 / math.sqrt(D)
    folded = math.log2(scale).is_integer()
    kscale = 1.0 if folded else scale
    t = {n: torch.from_numpy(np.array(a)).to(bf) for n, a in
         (("qk", qk), ("k", k), ("v", v), ("out", out), ("do", do))}
    dq, dk, dv = pt_flash.flash_attention_bwd_plain(
        t["qk"], t["k"], t["v"], t["out"], torch.from_numpy(np.array(lse)), t["do"],
        causal, kscale)
    if folded:
        dq = dq * torch.tensor(scale, dtype=bf)   # the chain rule, exact
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == bf
        err = float(np.abs(got.float().numpy() - w).max())
        assert err <= BF16_REL * float(np.abs(w).max()), (err, case)


def test_plain_backward_bf16_rounds_p_and_ds():
    """For 16-bit inputs the plain backward rounds P and dS to the input
    dtype before the second products; fp32 inputs of the same values keep
    them in fp32, so the two differ."""
    q, k, v, do = (torch.from_numpy(_bf16(a)).to(torch.bfloat16)
                   for a in _inputs(40, True, 2, 32))
    out, lse = pt_flash.flash_attention_plain(q, k, v, causal=True)
    got = pt_flash.flash_attention_bwd_plain(q, k, v, out, lse, do, True)
    f32 = pt_flash.flash_attention_bwd_plain(
        *(x.float() for x in (q, k, v, out)), lse, do.float(), True)
    assert any(not torch.equal(a, b.to(torch.bfloat16))
               for a, b in zip(got, f32))


def test_inference_path_unchanged():
    """Without a gradient to compute, flash_attention is the plain forward
    (one K1 launch on a card): no autograd node, the LSE only on request."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(8, True, 4, 16))
    q.requires_grad_(True)
    with torch.no_grad():
        out = pt_flash.flash_attention(q, k, v)
    assert out.grad_fn is None
    out2 = pt_flash.flash_attention(q, k, v)
    assert out2.grad_fn is not None
    torch.testing.assert_close(out, out2.detach(), rtol=0, atol=0)

