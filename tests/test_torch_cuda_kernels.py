"""The CUDA kernels against their plain versions on the card, at small
shapes with ragged edges (K1: ragged S, GQA, D = 128, both causal modes;
K2: GQA, zero-length rows, fused and unfused; K3: ragged chunks; K4 / K5:
ragged S, GQA, D = 128, both causal modes, a strided dO), the autograd
flash attention on the card against the CPU's gradients, plus the port's
model on the card against the same model on the CPU.

These tests need a CUDA device and skip without one.  They import no JAX,
so they run on the card's machine without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_kernels.py

Tolerances: fp32 1e-4 (summation order), bf16 / fp16 2e-2 (output
rounding); written cache rows bitwise.
"""

import pytest
import torch

from deepspeed_tpu_torch.ops.transformer import decode_attention as da
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _randn(gen, *shape, dtype, device):
    return torch.randn(*shape, generator=gen, device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kvh", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda, dtype, D, kvh, causal):
    g = torch.Generator(device=cuda).manual_seed(D + kvh)
    B, S, H = 2, 100, 4                      # S ragged against 64-row tiles
    q = _randn(g, B, S, H, D, dtype=dtype, device=cuda)
    k = _randn(g, B, S, kvh, D, dtype=dtype, device=cuda)
    v = _randn(g, B, S, kvh, D, dtype=dtype, device=cuda)
    before = fa.flash_attention.launches
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    assert fa.flash_attention.launches == before + 1
    want, want_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                              scale=D ** -0.5)
    _close(out, want, dtype)
    _close(lse, want_lse, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("fused", [True, False])
def test_decode_kernel_matches_plain(cuda, dtype, D, fused):
    g = torch.Generator(device=cuda).manual_seed(D)
    L, B, H, KVH, S_max, layer = 2, 5, 8, 2, 136, 1
    kc = _randn(g, L, B, S_max, KVH * D, dtype=dtype, device=cuda)
    vc = _randn(g, L, B, S_max, KVH * D, dtype=dtype, device=cuda)
    q = _randn(g, B, H, D, dtype=dtype, device=cuda)
    nk = _randn(g, B, KVH, D, dtype=dtype, device=cuda)
    nv = _randn(g, B, KVH, D, dtype=dtype, device=cuda)
    lengths = torch.tensor([0, 1, 64, 65, 136], dtype=torch.int32,
                           device=cuda)
    kw = dict(new_k=nk, new_v=nv) if fused else {}
    k1, v1 = kc.clone(), vc.clone()
    got = da.decode_attention(q, k1, v1, lengths, layer=layer, **kw)
    k2, v2 = kc.clone(), vc.clone()
    want = da.decode_attention_plain(q, k2[layer], v2[layer], lengths, **kw)
    if fused:
        got, ko, vo = got
        assert ko is k1 and vo is v1
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    _close(got, want, dtype)
    assert torch.equal(got[0], torch.zeros_like(got[0]))   # empty row


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [64, 128])
def test_chunk_kernel_matches_plain(cuda, dtype, D):
    g = torch.Generator(device=cuda).manual_seed(D + 1)
    L, B, C, H, KVH, S_max, layer = 2, 3, 40, 4, 2, 200, 0
    kc = _randn(g, L, B, S_max, KVH * D, dtype=dtype, device=cuda)
    vc = _randn(g, L, B, S_max, KVH * D, dtype=dtype, device=cuda)
    q = _randn(g, B, C, H, D, dtype=dtype, device=cuda)
    starts = torch.tensor([0, 57, 160], dtype=torch.int32, device=cuda)
    got = da.chunk_prefill_attention(q, kc, vc, starts, layer=layer)
    want = da.chunk_prefill_attention_plain(q, kc[layer], vc[layer], starts)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kvh", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_kernels_match_plain(cuda, dtype, D, kvh, causal):
    """K4 (dq) and K5 (dk / dv) against the plain backward on the same
    residuals; the in-kernel scale is D^-0.5 (the dS scale path), and a
    strided dO (a slice of a wider tensor) is read through its strides."""
    g = torch.Generator(device=cuda).manual_seed(3 * D + kvh)
    B, S, H = 2, 100, 4
    q = _randn(g, B, S, H, D, dtype=dtype, device=cuda)
    k = _randn(g, B, S, kvh, D, dtype=dtype, device=cuda)
    v = _randn(g, B, S, kvh, D, dtype=dtype, device=cuda)
    dout = _randn(g, B, S, 2 * H, D, dtype=dtype, device=cuda)[:, :, ::2]
    scale = D ** -0.5
    out, lse = fa.launch_attention_kernel(q, k, v, causal, scale, None, True)
    before = (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal, scale)
    assert (fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == (before[0] + 1, before[1] + 1)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal,
                                        scale)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        _close(a, b, dtype)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kvh", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_autograd_on_card_matches_cpu(cuda, D, kvh, causal):
    """The autograd Function (K1 with LSE, then K4 / K5) on the card gives
    the CPU's gradients (plain forward and backward), fp32: D = 64 folds
    its scale into q, D = 128 keeps it in the kernels."""
    gen = torch.Generator().manual_seed(D + kvh)
    B, S, H = 2, 77, 4
    cpu = [torch.randn(B, S, n, D, generator=gen) for n in (H, kvh, kvh, H)]
    grads = []
    for dev in ("cpu", cuda):
        q, k, v = (t.to(dev).requires_grad_(True) for t in cpu[:3])
        out = fa.flash_attention(q, k, v, causal=causal)
        grads.append(torch.autograd.grad(out, (q, k, v), cpu[3].to(dev)))
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)


def test_unsupported_head_dim_raises(cuda):
    x = torch.zeros(1, 8, 4, 16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(x, x, x)
    lse = torch.zeros(1, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_bwd(x, x, x, x, lse, x, True, 0.25)


def test_model_on_card_matches_cpu(cuda):
    """Prefill + cached decode through K1 and K2 on the card equal the
    plain path on the CPU, fp32, same weights (matrices normal with std
    0.5, as in the CPU parity tests).  Tolerance 1e-3: the projections'
    fp32 GEMMs sum in another order in cuBLAS than in the CPU BLAS, and
    two layers carry that into the logits.  On an H100 the prefill logits'
    largest gap was 4.7e-4 (abs) and 3.5e-4 (rel), the one logit of 3,104
    past a 2e-4 bar."""
    from deepspeed_tpu_torch.models.transformer import (Transformer,
                                                        TransformerConfig)
    cfg = TransformerConfig(vocab_size=97, hidden_size=256, num_layers=2,
                            num_heads=4, max_seq_len=64, dtype="float32",
                            tie_word_embeddings=True)
    cpu = Transformer(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():                  # init_weights' layout, std 0.5
        for mod in cpu.modules():
            if isinstance(mod, torch.nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, (torch.nn.Linear, torch.nn.Embedding)):
                mod.weight.normal_(0.0, 0.5, generator=gen)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
    gpu = Transformer(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.randint(0, 97, (2, 20), generator=torch.Generator()
                        .manual_seed(1))
    caches = [m.init_cache(2, 24, dtype=torch.float32) for m in (cpu, gpu)]
    with torch.no_grad():
        want, _ = cpu.decode(ids[:, :16], caches[0], 0, prefill=True)
        got, _ = gpu.decode(ids[:, :16].cuda(), caches[1], 0, prefill=True)
        torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-3)
        for t in range(16, 20):
            want, _ = cpu.decode(ids[:, t:t + 1], caches[0], t)
            got, _ = gpu.decode(ids[:, t:t + 1].cuda(), caches[1], t)
            torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("over", [{}, dict(remat=True, loss_seq_chunks=4)],
                         ids=["plain", "remat-chunked"])
def test_model_training_on_card_matches_cpu(cuda, over):
    """The loss and every gradient of the port's model, through K1 / K4 /
    K5 on the card, against the same model on the CPU (plain attention
    forward and backward), fp32, same weights and a ragged S = 40.
    Gradients at rtol 1e-4 / atol 1e-6 (the largest gradients are ~1e-1):
    the GEMMs sum in another order in cuBLAS than in the CPU BLAS.  The key biases are left out: their true
    gradient is 0 (a key bias shifts a row's scores alike), so both sides
    give roundoff."""
    from deepspeed_tpu_torch.models.transformer import (Transformer,
                                                        TransformerConfig)
    cfg = TransformerConfig(vocab_size=97, hidden_size=256, num_layers=2,
                            num_heads=4, max_seq_len=64, dtype="float32",
                            tie_word_embeddings=True,
                            **{"remat": False, **over})
    cpu = Transformer(cfg, device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(0))
    gpu = Transformer(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.randint(0, 97, (2, 40), generator=torch.Generator()
                        .manual_seed(1))
    counters = (fa.flash_attention, fa.flash_attention_dq,
                fa.flash_attention_dkv)
    losses = []
    for m, dev in ((cpu, "cpu"), (gpu, cuda)):
        before = [c.launches for c in counters]
        loss = m({"input_ids": ids.to(dev)})
        loss.backward()
        losses.append(loss.detach().cpu())
    # remat runs each block's forward again in the backward
    k1 = 4 if cfg.remat else 2
    assert [c.launches - b for c, b in zip(counters, before)] == [k1, 2, 2]
    torch.testing.assert_close(losses[1], losses[0], atol=1e-5, rtol=1e-5)
    for (name, p), (_, g) in zip(cpu.named_parameters(),
                                 gpu.named_parameters()):
        if name.endswith("attn.k_proj.bias"):
            continue
        torch.testing.assert_close(g.grad.cpu(), p.grad, atol=1e-6,
                                   rtol=1e-4, msg=name)
