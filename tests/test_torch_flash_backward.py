"""The port's flash-attention backward on the CPU against the JAX package's
(``jax.grad`` through its custom_vjp, Pallas kernels in interpret mode) on
the same numpy inputs.

Two of the port's paths are checked: ``flash_attention_bwd_plain`` (the
dense counterpart of kernels K4 / K5) from the forward's residuals, and
autograd through ``flash_attention`` (the port's custom Function, which
takes that plain backward on CPU tensors).  S = 40 is ragged against the
kernels' 64-row tiles; D = 16 folds its power-of-two scale into q, D = 32
keeps the scale in the kernel.  Tolerance: fp32 at 1e-4 — both sides
compute the same gradient in fp32 and differ in summation order.  The CUDA
kernels themselves run only on a card (``tests/test_torch_cuda_kernels.py``
and ``chip_smoke.py``).
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

