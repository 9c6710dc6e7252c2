"""The port's attention kernels (plain versions on the CPU) against the JAX
package's Pallas kernels (interpret mode on the CPU) on the same inputs.

Tolerance: fp32 at 2e-5 — both sides compute the same online/dense
softmax in fp32 and differ only in summation order.  The fused-write
decode must leave caches bitwise equal to the JAX kernel's.  The CUDA
kernels themselves run only on a card: ``chip_smoke.py`` holds each one
against its plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.transformer import decode_attention as jax_decode
from deepspeed_tpu.ops.transformer import flash_attention as jax_flash
from deepspeed_tpu_torch.ops.transformer import decode_attention as pt_decode
from deepspeed_tpu_torch.ops.transformer import flash_attention as pt_flash

TOL = dict(rtol=2e-5, atol=2e-5)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("S", [8, 40])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kvh", [4, 2])
def test_flash_attention_matches_jax(S, causal, kvh):
    rng = np.random.default_rng(S * 10 + kvh + int(causal))
    B, H, D = 2, 4, 16
    q, k, v = (_normal(rng, (B, S, h, D)) for h in (H, kvh, kvh))
    want = jax_flash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal)
    got = pt_flash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_attention_lse_matches_jax_forward():
    """The LSE rows the port returns are the JAX kernel's residual."""
    rng = np.random.default_rng(3)
    B, S, H, D = 2, 24, 4, 16
    q, k, v = (_normal(rng, (B, S, H, D)) for _ in range(3))
    qt = jnp.asarray(q * 0.25).transpose(0, 2, 1, 3)   # scale folded, as the wrapper does
    kt = jnp.asarray(k).transpose(0, 2, 1, 3)
    vt = jnp.asarray(v).transpose(0, 2, 1, 3)
    _, lse = jax_flash._fwd(qt, kt, vt, 1.0, True, 512, 2048)
    _, got = pt_flash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), causal=True,
                                      return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(lse)[..., 0], **TOL)


def _stacked_cache(rng, L, B, S_max, kvh, D):
    return _normal(rng, (L, B, S_max, kvh * D))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kvh", [4, 2])
def test_decode_attention_matches_jax(fused, kvh):
    rng = np.random.default_rng(7 + kvh + 10 * int(fused))
    L, B, H, D, S_max, layer = 3, 4, 4, 16, 32, 1
    q = _normal(rng, (B, H, D))
    kc = _stacked_cache(rng, L, B, S_max, kvh, D)
    vc = _stacked_cache(rng, L, B, S_max, kvh, D)
    lengths = np.asarray([1, 9, 32, 17], np.int32)      # ragged, incl. 1
    kw_j, kw_t = {}, {}
    if fused:
        kn, vn = _normal(rng, (B, kvh, D)), _normal(rng, (B, kvh, D))
        kw_j = dict(new_k=jnp.asarray(kn), new_v=jnp.asarray(vn))
        kw_t = dict(new_k=torch.from_numpy(kn), new_v=torch.from_numpy(vn))
    want = jax_decode.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lengths), layer=layer, **kw_j)
    kt, vt = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = pt_decode.decode_attention(torch.from_numpy(q), kt, vt,
                                     torch.from_numpy(lengths), layer=layer,
                                     **kw_t)
    if fused:
        want, want_k, want_v = want
        got, got_k, got_v = got
        assert got_k is kt and got_v is vt          # written in place
        np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    else:
        np.testing.assert_array_equal(kt.numpy(), kc)   # untouched
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("starts", [(0, 0), (8, 20)])
@pytest.mark.parametrize("kvh", [4, 2])
def test_chunk_prefill_matches_jax(starts, kvh):
    rng = np.random.default_rng(sum(starts) + kvh)
    L, B, C, H, D, S_max, layer = 2, 2, 8, 4, 16, 32, 1
    q = _normal(rng, (B, C, H, D))
    kc = _stacked_cache(rng, L, B, S_max, kvh, D)
    vc = _stacked_cache(rng, L, B, S_max, kvh, D)
    st = np.asarray(starts, np.int32)
    want = jax_decode.chunk_prefill_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(st),
        layer=layer)
    got = pt_decode.chunk_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(st), layer=layer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_wrappers_do_not_count_launches():
    """Launch counters move only where a CUDA kernel launches."""
    before = (pt_flash.flash_attention.launches,
              pt_decode.decode_attention.launches,
              pt_decode.chunk_prefill_attention.launches)
    x = torch.zeros(1, 8, 4, 16)
    pt_flash.flash_attention(x, x, x)
    cache = torch.zeros(1, 16, 64)
    pt_decode.decode_attention(x[:, 0], cache, cache, torch.tensor([3]))
    pt_decode.chunk_prefill_attention(x, cache, cache, torch.tensor([0]))
    assert before == (pt_flash.flash_attention.launches,
                      pt_decode.decode_attention.launches,
                      pt_decode.chunk_prefill_attention.launches)
