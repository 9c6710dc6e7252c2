"""The port's ``module_inject`` against the JAX package's and against HF,
on random-init HF models built from their config classes (no download):
OPT (OPT-1.3B's pre-LN layout and OPT-350m's post-LN / ``embed_proj_dim``
one), GPT-2, Llama, Mistral and GPT-Neo, at the sizes of
``tests/unit/test_module_inject.py``.

- each policy's flat ``{flax path: array}`` dict equals the JAX policy's,
  key for key and bitwise (one weight format for both packages);
- logits of the converted port model equal HF's and the JAX model's
  (fp32, 1e-4 absolute and relative, as the JAX test holds them);
- cached decode equals the full forward (1e-4);
- ``init_inference(hf_model)`` gives the JAX ``init_inference``'s greedy
  tokens exactly;
- an unported family raises ``NotImplementedError`` naming what it lacks;
- ``save_16bit_model(hf_policy="opt")`` writes HF's key names and shapes,
  each tensor bitwise HF's rounded to bf16, and converts back.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.module_inject import convert_hf_model as jconvert
from deepspeed_tpu.module_inject import policy_for as jpolicy_for
from deepspeed_tpu_torch.checkpoint.safetensors_io import load_file
from deepspeed_tpu_torch.module_inject import (OPTPolicy, UNPORTED_FAMILIES,
                                               convert_hf_model, policy_for)

transformers = pytest.importorskip("transformers")

TINY = dict(hidden=32, layers=2, heads=4, vocab=97, ffn=64, seq=24)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["opt", "opt_350m", "gpt2", "llama", "mistral", "gpt_neo"]


def tiny_hf_model(arch):
    """A random-init HF model of ``arch`` (the JAX test's fixtures, plus
    OPT-350m's layout and Mistral)."""
    t = TINY
    torch.manual_seed(0)
    if arch in ("opt", "opt_350m"):
        cfg = transformers.OPTConfig(
            vocab_size=t["vocab"], hidden_size=t["hidden"],
            num_hidden_layers=t["layers"], num_attention_heads=t["heads"],
            ffn_dim=t["ffn"], max_position_embeddings=64,
            word_embed_proj_dim=16 if arch == "opt_350m" else t["hidden"],
            do_layer_norm_before=arch == "opt")
        return transformers.OPTForCausalLM(cfg).eval()
    if arch == "gpt2":
        cfg = transformers.GPT2Config(
            vocab_size=t["vocab"], n_embd=t["hidden"], n_layer=t["layers"],
            n_head=t["heads"], n_positions=64, n_inner=t["ffn"])
        return transformers.GPT2LMHeadModel(cfg).eval()
    if arch in ("llama", "mistral"):
        kind = "Llama" if arch == "llama" else "Mistral"
        cfg = getattr(transformers, f"{kind}Config")(
            vocab_size=t["vocab"], hidden_size=t["hidden"],
            num_hidden_layers=t["layers"], num_attention_heads=t["heads"],
            num_key_value_heads=2, intermediate_size=t["ffn"],
            max_position_embeddings=64)
        return getattr(transformers, f"{kind}ForCausalLM")(cfg).eval()
    if arch == "gpt_neo":
        # window_size < seq so the local layer's band mask really bites
        cfg = transformers.GPTNeoConfig(
            vocab_size=t["vocab"], hidden_size=t["hidden"],
            num_layers=t["layers"], num_heads=t["heads"],
            intermediate_size=t["ffn"], max_position_embeddings=64,
            attention_types=[[["global", "local"], t["layers"] // 2]],
            window_size=5)
        return transformers.GPTNeoForCausalLM(cfg).eval()
    raise ValueError(arch)


@pytest.fixture(scope="module")
def hf_models():
    return {arch: tiny_hf_model(arch) for arch in ARCHS}


def _ids(seed, shape=(2, TINY["seq"])):
    return np.random.default_rng(seed).integers(0, TINY["vocab"], shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_policy_flat_dict_equals_jax(hf_models, arch):
    hf = hf_models[arch]
    sd = hf.state_dict()
    jp, pp = jpolicy_for(hf.config), policy_for(hf.config)
    want = jp.convert(sd, jp.build_config(hf.config))
    got = pp.convert(sd, pp.build_config(hf.config))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_hf_and_jax(hf_models, arch):
    hf = hf_models[arch]
    ids = _ids(0)
    with torch.no_grad():
        want = hf(torch.from_numpy(ids)).logits.float().numpy()
    jmodel, params = jconvert(hf, use_flash_attention=False, dtype="float32")
    jgot = np.asarray(jax.jit(lambda p, i: jmodel.apply(
        p, i, method=type(jmodel).logits))(params, ids.astype(np.int32)))
    m = convert_hf_model(hf, dtype="float32")
    with torch.no_grad():
        got = m.logits(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, jgot, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_cached_decode_matches_full_forward(hf_models, arch):
    """Prefill 6 tokens, then 4 cached decode steps, against the logits
    of the uncached forward over the whole sequence."""
    m = convert_hf_model(hf_models[arch], dtype="float32")
    ids = torch.from_numpy(_ids(1, (1, 10)))
    with torch.no_grad():
        full = m.logits(ids)
        cache = m.init_cache(1, 16, dtype=torch.float32)
        got, cache = m.decode(ids[:, :6], cache, 0, prefill=True)
        np.testing.assert_allclose(got.numpy(), full[:, :6].numpy(), **TOL)
        for t in range(6, 10):
            got, cache = m.decode(ids[:, t:t + 1], cache, t)
            np.testing.assert_allclose(got.numpy(),
                                       full[:, t:t + 1].numpy(), **TOL,
                                       err_msg=f"step {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_inference_greedy_matches_jax(hf_models, arch):
    hf = hf_models[arch]
    ids = _ids(2, (2, 12))
    jeng = deepspeed_tpu.init_inference(hf, config={"dtype": "float32"})
    want = np.asarray(jeng.generate(jnp.asarray(ids.astype(np.int32)),
                                    max_new_tokens=8))
    teng = deepspeed_tpu_torch.init_inference(
        hf, config={"dtype": "float32"}, device="cpu")
    got = teng.generate(torch.from_numpy(ids), max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("model_type", sorted(UNPORTED_FAMILIES))
def test_policy_for_unported_family_raises(model_type):
    """A family the JAX package converts but the port cannot build yet
    raises, naming what it lacks; an unknown type raises too."""
    cfg = types.SimpleNamespace(model_type=model_type)
    with pytest.raises(NotImplementedError,
                       match=UNPORTED_FAMILIES[model_type].split()[0]):
        policy_for(cfg)
    with pytest.raises(NotImplementedError, match="no injection policy"):
        policy_for(types.SimpleNamespace(model_type="some_unknown_arch"))


def test_bloom_model_is_refused_naming_alibi():
    hf = transformers.BloomForCausalLM(transformers.BloomConfig(
        vocab_size=97, hidden_size=32, n_layer=2, n_head=4))
    with pytest.raises(NotImplementedError, match="alibi"):
        deepspeed_tpu_torch.init_inference(hf, device="cpu")


@pytest.mark.parametrize("arch", ["opt", "opt_350m"])
def test_opt_export_roundtrips_to_hf_keys(hf_models, arch, tmp_path):
    """``save_16bit_model(hf_policy="opt")`` from a training engine over
    the converted model: exactly HF's key names and shapes (the tied
    ``lm_head.weight`` is HF's alias of the embedding and is not written),
    every tensor HF's rounded once to bf16 (the two offset rows of the
    position table are zeros, never read), and the export converts back
    to the same bf16 weights."""
    hf = hf_models[arch]
    hsd = hf.state_dict()
    m = convert_hf_model(hf, dtype="float32")
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=m, config={"train_micro_batch_size_per_gpu": 1}, device="cpu")
    engine.save_16bit_model(str(tmp_path), "model.safetensors",
                            hf_policy="opt")
    out = load_file(str(tmp_path / "model.safetensors"))
    assert set(out) == set(hsd) - {"lm_head.weight"}
    for k, v in out.items():
        assert v.dtype == torch.bfloat16 and v.shape == hsd[k].shape, k
        want = hsd[k].to(torch.bfloat16)
        if k.endswith("embed_positions.weight"):
            assert not out[k][:2].any()
            want, v = want[2:], v[2:]
        assert torch.equal(v, want), k
    # the export loads back through the HF path (an object with the HF
    # config and the exported state dict)
    back = convert_hf_model(types.SimpleNamespace(
        config=hf.config, state_dict=lambda: out), dtype="float32")
    for k, v in back.state_dict().items():
        assert torch.equal(v, m.state_dict()[k].to(torch.bfloat16).float()), k
    # a policy instance works too; a family without an export mapping or
    # without a policy raises
    engine.save_16bit_model(str(tmp_path), "model.bin",
                            hf_policy=OPTPolicy())
    assert set(torch.load(tmp_path / "model.bin")) == set(out)
    with pytest.raises(NotImplementedError, match="no HF export mapping"):
        engine.save_16bit_model(str(tmp_path), "x.bin", hf_policy="gpt2")
    with pytest.raises(NotImplementedError, match="alibi"):
        engine.save_16bit_model(str(tmp_path), "x.bin", hf_policy="bloom")


@pytest.mark.parametrize("arch", ["opt", "opt_350m"])
def test_chip_smoke_hf_state_has_hf_keys(hf_models, arch):
    """``chip_smoke.py`` builds run (o)'s HF-named state dict by hand (the
    card has no ``transformers``): the same keys and shapes as HF's
    ``OPTForCausalLM``, and it converts to the same flax leaves."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    hf = hf_models[arch]
    c = hf.config
    cfg = types.SimpleNamespace(**{k: getattr(c, k) for k in (
        "model_type", "vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "ffn_dim", "word_embed_proj_dim",
        "do_layer_norm_before", "max_position_embeddings",
        "activation_function", "tie_word_embeddings")})
    got = cs.opt_hf_state(cfg, seed=0)
    want = hf.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    p = policy_for(cfg)
    flat = p.convert(got, p.build_config(cfg))
    assert sorted(flat) == sorted(p.convert(want, p.build_config(c)))
