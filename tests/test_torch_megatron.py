"""Megatron-LM checkpoints in the port against the JAX package, on the CPU:
``runtime/state_dict_factory.py`` (the description json, ``MegatronSDLoader``
merge / split / ``load``), ``MegatronGPTPolicy`` and
``load_megatron_model``, on a random-init HF GPT-2 (hidden 32, 2 layers, 4
heads of 8, ffn 64; a vocabulary of 128, Megatron's padding, so that the
word embeddings split) re-emitted as Megatron-LM shards:

- the loader's merged, split and per-rank state dicts equal JAX's bitwise,
  for the v2 (head-interleaved) and v1 (``[q|k|v]`` thirds) fused QKV,
  through 1 → 2 → 4 → 1 shard files (and the round trip is the identity);
- ``load_megatron_model`` on 2 shard files gives JAX's tensors bitwise and
  HF's logits within 1e-5 (fp32), as JAX's
  ``test_megatron_checkpoint_loads_with_tp_merge``;
- at tp 2 a rank's ``MegatronSDLoader.load(2, rank)`` slice equals the
  merged dict cut by the port's tensor-parallel plan, and
  ``InferenceEngine.load_checkpoint(description json)`` greedy tokens equal
  the model built from the unsharded dict.
"""

import json
import types

import numpy as np
import pytest
import torch

import jax

from deepspeed_tpu.module_inject import load_megatron_model as jload
from deepspeed_tpu.runtime import state_dict_factory as jsdf

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.module_inject import (MegatronGPTPolicy,
                                               load_megatron_model,
                                               policy_for)
from deepspeed_tpu_torch.parallel.tensor_parallel import (TensorParallel,
                                                          tp_plan)
from deepspeed_tpu_torch.runtime import state_dict_factory as sdf

transformers = pytest.importorskip("transformers")

H, HID, L, FFN, V = 4, 32, 2, 64, 128
D = HID // H


@pytest.fixture(scope="module")
def hf():
    torch.manual_seed(0)
    cfg = transformers.GPT2Config(vocab_size=V, n_embd=HID, n_layer=L,
                                  n_head=H, n_positions=64, n_inner=FFN)
    return transformers.GPT2LMHeadModel(cfg).eval()


def megatron_dict(hf, v2=True):
    """HF GPT-2 → a merged Megatron-LM GPT state dict (torch layouts; the
    fused QKV rows head-interleaved ``[H, 3, D]`` for v2, ``[3, H·D]``
    for v1)."""
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}

    def qkv(w_in_3h):                          # [in, 3h] → [3h, in]
        w = w_in_3h.T
        if not v2:
            return np.ascontiguousarray(w)
        return np.ascontiguousarray(
            w.reshape(3, H, D, -1).transpose(1, 0, 2, 3).reshape(3 * HID, -1))

    def qkv_bias(b):
        if not v2:
            return b.copy()
        return np.ascontiguousarray(
            b.reshape(3, H, D).transpose(1, 0, 2).reshape(-1))

    meg = {"word_embeddings.weight": sd["transformer.wte.weight"],
           "position_embeddings.weight": sd["transformer.wpe.weight"],
           "transformer.final_layernorm.weight": sd["transformer.ln_f.weight"],
           "transformer.final_layernorm.bias": sd["transformer.ln_f.bias"]}
    for i in range(L):
        src, dst = f"transformer.h.{i}", f"transformer.layers.{i}"
        meg[f"{dst}.input_layernorm.weight"] = sd[f"{src}.ln_1.weight"]
        meg[f"{dst}.input_layernorm.bias"] = sd[f"{src}.ln_1.bias"]
        meg[f"{dst}.attention.query_key_value.weight"] = \
            qkv(sd[f"{src}.attn.c_attn.weight"])
        meg[f"{dst}.attention.query_key_value.bias"] = \
            qkv_bias(sd[f"{src}.attn.c_attn.bias"])
        meg[f"{dst}.attention.dense.weight"] = np.ascontiguousarray(
            sd[f"{src}.attn.c_proj.weight"].T)
        meg[f"{dst}.attention.dense.bias"] = sd[f"{src}.attn.c_proj.bias"]
        meg[f"{dst}.post_attention_layernorm.weight"] = sd[f"{src}.ln_2.weight"]
        meg[f"{dst}.post_attention_layernorm.bias"] = sd[f"{src}.ln_2.bias"]
        meg[f"{dst}.mlp.dense_h_to_4h.weight"] = np.ascontiguousarray(
            sd[f"{src}.mlp.c_fc.weight"].T)
        meg[f"{dst}.mlp.dense_h_to_4h.bias"] = sd[f"{src}.mlp.c_fc.bias"]
        meg[f"{dst}.mlp.dense_4h_to_h.weight"] = np.ascontiguousarray(
            sd[f"{src}.mlp.c_proj.weight"].T)
        meg[f"{dst}.mlp.dense_4h_to_h.bias"] = sd[f"{src}.mlp.c_proj.bias"]
    return meg


def write_shards(tmp, name, shards, kind="npz"):
    paths = []
    for r, shard in enumerate(shards):
        if kind == "npz":
            p = tmp / f"{name}_mp_rank_{r:02d}.npz"
            np.savez(p, **shard)
        else:
            p = tmp / f"{name}_mp_rank_{r:02d}_model_states.pt"
            torch.save({"module": {k: torch.from_numpy(np.array(v))
                                   for k, v in shard.items()}}, p)
        paths.append(str(p))
    return paths


def assert_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


@pytest.mark.parametrize("kind", ["npz", "pt"])
@pytest.mark.parametrize("version", [2.0, 1.0])
def test_shards_round_trip_1_2_4_1_as_jax(hf, tmp_path, version, kind):
    """Split 1 → 2 → 4 with ``load(n, rank)``, merge 4 → 1: each stage's
    state dicts bitwise JAX's, and the merge the original."""
    full = megatron_dict(hf, v2=version >= 2.0)
    files = write_shards(tmp_path, "s1", [full], kind)
    for n, name in ((2, "s2"), (4, "s4")):
        ours = sdf.MegatronSDLoader(files, version)
        theirs = jsdf.MegatronSDLoader(files, version)
        shards = [ours.load(n, r) for r in range(n)]
        for r, shard in enumerate(shards):
            assert_dicts_equal(shard, theirs.load(n, r))
        files = write_shards(tmp_path, name, shards, kind)
    merged = sdf.MegatronSDLoader(files, version).merge_state_dict()
    assert_dicts_equal(merged,
                       jsdf.MegatronSDLoader(files, version).merge_state_dict())
    assert_dicts_equal(merged, full)
    # 4 files onto 2 ranks: each merges its pair
    for r in range(2):
        assert_dicts_equal(sdf.MegatronSDLoader(files, version).load(2, r),
                           jsdf.MegatronSDLoader(files, version).load(2, r))


def test_description_json_and_classify_as_jax(tmp_path):
    desc = {"type": "Megatron", "version": 2.0, "base_dir": str(tmp_path),
            "checkpoints": ["a.pt", "b.pt"]}
    (tmp_path / "d.json").write_text(json.dumps(desc))
    for d in (desc, str(tmp_path / "d.json"),
              dict(desc, checkpoints={"0": ["a.pt"], "1": "b.pt"})):
        assert sdf.get_sd_loader_json(d) == jsdf.get_sd_loader_json(d)
    assert sdf.get_sd_loader_json({"checkpoints": ["x"]}) == \
        ("Megatron", ["x"], 0.0)
    names = list(megatron_dict_names()) + ["h.0.mlp.wo.weight", "wi.bias",
                                           "decoder.qkv.weight"]
    for name in names:
        assert sdf._classify(name) == jsdf._classify(name), name
    assert isinstance(sdf.get_sd_loader(["a"]), sdf.MegatronSDLoader)


def megatron_dict_names():
    yield "word_embeddings.weight"
    for sfx in ("attention.query_key_value.weight", "attention.dense.weight",
                "attention.dense.bias", "mlp.dense_h_to_4h.bias",
                "mlp.dense_4h_to_h.weight", "input_layernorm.weight"):
        yield f"transformer.layers.0.{sfx}"


def test_policy_for_megatron_gpt():
    pol = policy_for(types.SimpleNamespace(model_type="megatron-gpt"))
    assert isinstance(pol, MegatronGPTPolicy)
    with pytest.raises(NotImplementedError, match="MoE"):
        policy_for(types.SimpleNamespace(model_type="megatron-gpt-moe"))
    sd = {"model.language_model.encoder.layers.0.x": 1, "module.y": 2}
    assert MegatronGPTPolicy.normalize(sd) == \
        {"transformer.layers.0.x": 1, "y": 2}


@pytest.mark.parametrize("version", [2.0, 1.0])
def test_load_megatron_model_matches_jax_and_hf(hf, tmp_path, version):
    """JAX's scenario: 2 TP shard files (replicated embeddings) through
    ``load_megatron_model``: the port's tensors are JAX's bitwise and its
    fp32 logits HF's within 1e-5."""
    v2 = version >= 2.0
    full = megatron_dict(hf, v2=v2)
    shards = [{}, {}]
    for name, w in full.items():
        kind = sdf._classify(name)
        if "query_key_value" in name:
            continue                   # cut below, as Megatron cuts it
        if kind == "column":
            parts = np.split(w, 2, axis=0)
        elif kind == "row" and name.endswith("weight"):
            parts = np.split(w, 2, axis=1)
        else:
            parts = [w, w]
        for r in range(2):
            shards[r][name] = parts[r]
    # the fused QKV as Megatron shards it (v1: [q_r|k_r|v_r] a rank)
    one = write_shards(tmp_path, "full", [full])
    for r in range(2):
        cut = sdf.MegatronSDLoader(one, version).load(2, r)
        for name in full:
            if "query_key_value" in name:
                shards[r][name] = cut[name]
    paths = write_shards(tmp_path, "mp", shards)
    model, sd = load_megatron_model(paths, num_heads=H, megatron_v2=v2,
                                    dtype="float32",
                                    use_flash_attention=False)
    jmodel, jparams = jload(paths, num_heads=H, megatron_v2=v2,
                            dtype="float32", use_flash_attention=False)
    want = pt.params_from_flax(jax.device_get(jparams), model.config)
    assert sorted(sd) == sorted(want)
    for k in want:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0,
                                   msg=k)
    ids = np.random.default_rng(7).integers(0, V, (2, 16))
    with torch.no_grad():
        got = model.logits(torch.from_numpy(ids)).numpy()
        ref = hf(torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    # a description json of the same files, and a merged dict
    desc = {"type": "Megatron", "version": version, "checkpoints": paths}
    _, sd2 = load_megatron_model(desc, num_heads=H, megatron_v2=v2)
    _, sd3 = load_megatron_model(
        dict(full, iteration=7), num_heads=H, megatron_v2=v2)
    for k in want:
        assert torch.equal(sd2[k], want[k]) and torch.equal(sd3[k], want[k])
    with pytest.raises(ValueError, match="num_heads"):
        load_megatron_model(paths)


# Megatron name → (port name, the port tensor's layout of Megatron's rows)
def _port_pairs(i):
    p, m = f"layers.{i}.", f"transformer.layers.{i}."
    return {m + "attention.dense.weight": p + "attn.o_proj.weight",
            m + "mlp.dense_h_to_4h.weight": p + "mlp.up_proj.weight",
            m + "mlp.dense_4h_to_h.weight": p + "mlp.down_proj.weight"}


def test_rank_slice_equals_merged_cut_by_plan(hf, tmp_path):
    """At tp 2: each rank's ``MegatronSDLoader.load(2, rank)`` (from one
    file, and from 4 merged in pairs) gives, through the policy, the slice
    the port's plan cuts from the merged dict — the q / k / v heads, the
    o / down input rows, the up output rows and the vocabulary rows."""
    full = megatron_dict(hf)
    one = write_shards(tmp_path, "one", [full])
    four = write_shards(tmp_path, "four", [
        sdf.MegatronSDLoader(one, 2.0).load(4, r) for r in range(4)])
    model, sd = load_megatron_model(one, num_heads=H)
    for files in (one, four):
        for r in range(2):
            plan = tp_plan(model, TensorParallel(2, r))
            cut = {k: sd[k] if plan[k] is None else plan[k].take(sd[k])
                   for k in sd}
            part = sdf.MegatronSDLoader(files, 2.0).load(2, r)
            torch.testing.assert_close(
                torch.from_numpy(part["word_embeddings.weight"]),
                cut["embed_tokens.weight"], rtol=0, atol=0)
            for i in range(L):
                flat = MegatronGPTPolicy().layer_params(
                    part, i, types.SimpleNamespace(num_heads=H // 2,
                                                   head_dim=D))
                for proj in ("q_proj", "k_proj", "v_proj"):
                    got = torch.from_numpy(
                        flat[f"attn/{proj}/kernel"].reshape(HID, -1).T.copy())
                    torch.testing.assert_close(
                        got, cut[f"layers.{i}.attn.{proj}.weight"],
                        rtol=0, atol=0)
                for meg, name in _port_pairs(i).items():
                    torch.testing.assert_close(
                        torch.from_numpy(part[meg]), cut[name], rtol=0,
                        atol=0, msg=name)


def test_engine_loads_description_json(hf, tmp_path):
    """``init_inference(config={"checkpoint": description.json})``: greedy
    tokens equal the model built from the merged dict."""
    full = megatron_dict(hf)
    paths = write_shards(tmp_path, "e", [
        sdf.MegatronSDLoader(write_shards(tmp_path, "f", [full]),
                             2.0).load(2, r) for r in range(2)])
    desc = tmp_path / "megatron.json"
    desc.write_text(json.dumps({"type": "Megatron", "version": 2.0,
                                "checkpoints": paths}))
    model, sd = load_megatron_model(full, num_heads=H, dtype="float32")
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, V, (2, 8)))
    want = deepspeed_tpu_torch.init_inference(
        model, config={"dtype": "float32"}, device="cpu").generate(
            ids, max_new_tokens=6)
    fresh = pt.Transformer(model.config)
    eng = deepspeed_tpu_torch.init_inference(
        fresh, config={"dtype": "float32", "checkpoint": str(desc)},
        device="cpu")
    assert torch.equal(eng.generate(ids, max_new_tokens=6), want)
