"""Card tests of the HF-layout and remat slice (``cuda`` marker: they skip
without a CUDA device; this file imports no JAX, so the card's machine
runs it with ``python -m pytest --noconftest -p no:cacheprovider -q -m
cuda tests/test_torch_hf_remat_cuda.py``).

- the remat policies on the card: the loss and every gradient bitwise
  equal to ``remat=False`` in bf16, K1 launched once a layer a step under
  the flash policies and twice under ``nothing_saveable``, K4 / K5 once;
- OPT-350m's layout (post-LN, ``embed_proj_dim``) through the kernels in
  fp32 against the same model's plain path on the CPU (1e-4);
- with the embeddings frozen every block still gets its gradients,
  bitwise ``remat=False``'s.
"""

import pytest
import torch

from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

# heads of 64: a width the attention kernels take
CFG = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=2,
           max_seq_len=256, use_flash_attention=True,
           tie_word_embeddings=True, activation="relu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _model(device, seed=0, **over):
    m = pt.Transformer(pt.TransformerConfig(**{**CFG, **over}),
                       device=device)
    m.init_weights(torch.Generator(device=device).manual_seed(seed))
    return m


@pytest.mark.cuda
def test_cuda_remat_policies_bitwise_and_k1_launches(cuda):
    ids = torch.randint(0, 97, (2, 128), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    runs = {}
    for policy in (None, "nothing_saveable", "flash_only_saveable",
                   "dots_and_attn_saveable",
                   "dots_with_no_batch_dims_saveable"):
        over = dict(remat=False) if policy is None else \
            dict(remat=True, remat_policy=policy)
        m = _model(cuda, dtype="bfloat16", **over)
        before = (fa.flash_attention.launches, fa.flash_attention_dq.launches,
                  fa.flash_attention_dkv.launches)
        loss = m({"input_ids": ids})
        loss.backward()
        torch.cuda.synchronize()
        after = (fa.flash_attention.launches, fa.flash_attention_dq.launches,
                 fa.flash_attention_dkv.launches)
        runs[policy] = (loss.detach(),
                        {n: p.grad for n, p in m.named_parameters()},
                        tuple(b - a for a, b in zip(before, after)))
    L = CFG["num_layers"]
    want_loss, want, _ = runs[None]
    for policy, (loss, grads, launches) in runs.items():
        k1 = L if policy in (None, "flash_only_saveable",
                             "dots_and_attn_saveable") else 2 * L
        assert launches == (k1, L, L), policy
        assert torch.equal(loss, want_loss), policy
        for name, g in grads.items():
            assert torch.equal(g, want[name]), (policy, name)


@pytest.mark.cuda
def test_cuda_opt_350m_layout_matches_plain(cuda):
    over = dict(dtype="float32", pre_layer_norm=False, embed_proj_dim=64,
                remat=False)
    m = _model(cuda, **over)
    ref = pt.Transformer(pt.TransformerConfig(**{**CFG, **over}),
                         device="cpu")
    ref.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
    ids = torch.randint(0, 97, (2, 96), generator=torch.Generator()
                        .manual_seed(2))
    with torch.no_grad():
        got = m.logits(ids.to(cuda))
        want = ref.logits(ids)
        cache = m.init_cache(2, 128)
        pre, cache = m.decode(ids[:, :64].to(cuda), cache, 0, prefill=True)
        step, _ = m.decode(ids[:, 64:65].to(cuda), cache, 64)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(pre.cpu(), want[:, :64], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(step.cpu(), want[:, 64:65], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["nothing_saveable",
                                    "flash_only_saveable"])
def test_cuda_frozen_embeddings_train_every_block(cuda, policy):
    """Embeddings frozen, so the first block's input needs no gradient:
    every other parameter's bf16 gradient is still bitwise
    ``remat=False``'s, and the frozen ones get none."""
    frozen = ("embed_tokens.weight", "embed_positions.weight")
    ids = torch.randint(0, 97, (2, 128), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(3))
    grads = {}
    for name, over in (("plain", dict(remat=False)),
                       ("remat", dict(remat=True, remat_policy=policy))):
        m = _model(cuda, dtype="bfloat16", **over)
        for n, p in m.named_parameters():
            p.requires_grad_(n not in frozen)
        m({"input_ids": ids}).backward()
        torch.cuda.synchronize()
        grads[name] = {n: p.grad for n, p in m.named_parameters()}
    for n, g in grads["remat"].items():
        if n in frozen:
            assert g is None, n
        else:
            assert g is not None and torch.equal(g, grads["plain"][n]), n
