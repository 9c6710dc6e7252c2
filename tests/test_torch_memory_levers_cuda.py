"""Card tests of the Llama training / memory-lever slice (``cuda`` marker:
they skip without a CUDA device; this file imports no JAX, so the card's
machine runs it with ``python -m pytest --noconftest -p no:cacheprovider
-q -m cuda tests/test_torch_memory_levers_cuda.py``).

- K1 / K4 / K5 at Llama-7B's training shape [1, 2048, 32, 128] against
  their plain versions (bf16: the output at 2e-2, the LSE at 1e-4, the
  gradients at 2^-7 · max|grad| against the fp32 plain backward of the
  same inputs), then inside a Llama training step (one layer at llama-7b's
  width, bf16 masters and moments): one launch each, and the loss and
  every gradient against the same step with the plain attention (loss
  within 1e-2 relative, cosine >= 0.99 per gradient);
- ZeRO-Offload with page-locked host buffers and without: two steps each,
  bitwise the same parameters, masters and losses.
"""

import pytest
import torch

from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models.opt import llama_model
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

SHAPE = dict(B=1, S=2048, H=32, D=128)
REL = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.cuda
def test_cuda_flash_kernels_at_llama_training_shape(cuda):
    B, S, H, D = (SHAPE[k] for k in "BSHD")
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn(B, S, H, D, generator=g, device=cuda,
                               dtype=torch.bfloat16) for _ in range(4))
    sc = D ** -0.5
    out, lse = fa.launch_attention_kernel(q, k, v, True, sc, None, True)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, do, True, sc)
    want, want_lse = fa.flash_attention_plain(q, k, v, causal=True, scale=sc)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    ref = fa.flash_attention_bwd_plain(
        *(t.float() for t in (q, k, v, out)), lse, do.float(), True, sc)
    for got, r in zip((dq, dk, dv), ref):
        assert _rel_err(got, r) <= REL


def _step(device, attention_plain, monkeypatch):
    model = llama_model("llama-7b", num_layers=1, max_seq_len=2048,
                        dtype="bfloat16", remat=False)
    cfg = {"train_micro_batch_size_per_gpu": 1,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 3e-4, "state_dtype": "bfloat16"}},
           "bf16": {"enabled": True, "master_weights_in_bf16": True},
           "data_types": {"grad_accum_dtype": "bf16"}, "seed": 5}
    eng, *_ = initialize(model=model, config=cfg, device=device)
    if attention_plain:
        monkeypatch.setattr(fa, "flash_attention", lambda q, k, v, causal=True,
                            scale=None: fa.flash_attention_plain(
                                q, k, v, causal=causal, scale=scale)[0])
    ids = torch.randint(0, 32000, (1, 2048), device=device,
                        generator=torch.Generator(device=device).manual_seed(7))
    counts = [f.launches for f in (fa.flash_attention, fa.flash_attention_dq,
                                   fa.flash_attention_dkv)] \
        if not attention_plain else None
    loss = eng({"input_ids": ids})
    eng.backward(loss)
    torch.cuda.synchronize()
    if counts is not None:
        after = [f.launches for f in (fa.flash_attention,
                                      fa.flash_attention_dq,
                                      fa.flash_attention_dkv)]
        assert [a - b for a, b in zip(after, counts)] == [1, 1, 1]
    grads = {n: p.grad.float().clone()
             for n, p in eng.module.named_parameters()}
    monkeypatch.undo()
    return float(loss), grads


@pytest.mark.cuda
def test_cuda_llama_training_step_through_the_kernels(cuda, monkeypatch):
    loss, grads = _step(cuda, False, monkeypatch)
    want_loss, want = _step(cuda, True, monkeypatch)
    assert abs(loss - want_loss) <= 1e-2 * abs(want_loss)
    for name, g in grads.items():
        cos = torch.nn.functional.cosine_similarity(
            g.flatten(), want[name].flatten(), dim=0)
        assert float(cos) >= 0.99, (name, float(cos))


@pytest.mark.cuda
def test_cuda_pinned_and_pageable_offload_are_bitwise_equal(cuda):
    runs = []
    for pin in (True, False):
        model = llama_model("llama-tiny", num_layers=2, num_heads=4,
                            num_kv_heads=2, max_seq_len=256,
                            dtype="bfloat16", remat=False)
        cfg = {"train_micro_batch_size_per_gpu": 2,
               "gradient_accumulation_steps": 2,
               "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
               "bf16": {"enabled": True}, "gradient_clipping": 1.0,
               "zero_optimization": {"offload_optimizer": {
                   "device": "cpu", "pin_memory": pin}},
               "seed": 3}
        eng, *_ = initialize(model=model, config=cfg, device=cuda)
        assert all(b.is_pinned() == pin for b in eng._host_grads)
        g = torch.Generator(device=cuda).manual_seed(9)
        batch = {"input_ids": torch.randint(0, 32000, (2, 2, 128),
                                            generator=g, device=cuda)}
        losses = [eng.train_batch(batch=batch) for _ in range(2)]
        runs.append((losses, [p.detach().clone() for p in eng.params],
                     [m.clone() for m in eng._host_opt.masters]))
    (la, pa, ma), (lb, pb, mb) = runs
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    assert all(torch.equal(x, y) for x, y in zip(ma, mb))
