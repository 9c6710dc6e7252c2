"""Tensor parallelism at tp 2 (world 2) of the port against the JAX
engine at the same mesh, on the CPU over gloo.

The ranks are real processes (``tests/torch_tp_worker.py`` suite ``tp``,
through the port's launcher) while this process computes the JAX
references on its virtual devices (``initialize_topology(dp=1, tp=2,
devices=jax.devices()[:2])``; ``tests/torch_tp_common.py``).  Weights are
the flax init of tiny models converted with ``params_from_flax``:

- the TP placement: every leaf's spec of tiny OPT and Llama equals JAX's
  ``tp_spec_for`` (tp 2 and 4), AutoTP's rules on HF OPT / GPT-2 / Llama /
  GPT-Neo built from their config classes equal JAX's, the row rule takes
  ``o_proj`` / ``down_proj`` biases and leaves q / k / v / up biases whole,
  ``embed_positions`` follows the vocab rule (OPT-1.3B's 2,048 rows
  sharded at tp 2 and 4, a 2,050-row table whole at tp 4);
- training at tp 2 in fp32 and bf16 (vocab 96, sharded) and at vocab 97
  (whole): losses and parameters against JAX's tp-2 engine, each rank's
  slices against JAX's addressable shards, the engine's tp dims against
  the JAX plan's;
- one micro step's gradients (LayerNorm and embedding included) against
  ``jax.grad``, and with copy-to-TP's backward all-reduce removed the
  LayerNorm gradients wrong (the hazard the operator exists for); the
  gradient norm with clipping active equals JAX's, and counting the
  replicated leaves twice would not;
- greedy ``generate`` at tp 2 equals JAX's tp-2 tokens and the port's tp 1
  (fp32); speculative ``serve()`` at tp 2 raises naming ROADMAP.md
  (``tests/test_torch_serving_tp.py`` serves at tp 2);
- ``initialize(mpu=)`` with Megatron's legacy and Megatron-Core names, an
  explicit ``topology`` winning over an mpu, the config's tp otherwise;
- ``init_inference`` at tp 2 of an HF model (converted, then cut) and of
  int8 weights (whole on every rank, as in JAX): the tokens of tp 1.
"""

import threading

import numpy as np
import pytest
import torch

import jax

from deepspeed_tpu.module_inject.auto_tp import get_tp_rules as jax_rules
from deepspeed_tpu.parallel.topology import initialize_topology, reset_topology
from deepspeed_tpu.runtime.zero.partition import tp_spec_for as jax_spec_for

from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.models.opt import opt_model
from deepspeed_tpu_torch.module_inject import get_tp_rules
from deepspeed_tpu_torch.parallel import tensor_parallel as ptp
from deepspeed_tpu_torch.runtime.zero.partition import tp_spec_for

import torch_tp_common as common

WORLD = 2


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    # the HF model classes the AutoTP tests build import while the JAX
    # references compile (XLA releases the GIL)
    warm = threading.Thread(target=_hf_models)
    warm.start()
    try:
        return common.results(tmp_path_factory.mktemp("tp2"), WORLD)
    finally:
        warm.join()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("variant", sorted(common.CFGS))
def test_tp_specs_match_jax(variant, tp):
    model = pt.Transformer(pt.TransformerConfig(**common.CFGS[variant]))
    paths = model.flax_paths()
    lay = model.jax_layouts()
    topo = initialize_topology(dp=1, tp=tp, devices=jax.devices()[:tp])
    try:
        n_sharded = 0
        for name, p in model.named_parameters():
            shape = tuple(lay.get(name, (None, None, tuple(p.shape)))[2])
            want = tuple(jax_spec_for(paths[name], shape, topo.mesh))
            want = want + (None,) * (len(shape) - len(want))
            assert tp_spec_for(paths[name], shape, tp) == want, name
            n_sharded += "tp" in want
        assert n_sharded > 0
    finally:
        reset_topology()


def test_row_rule_takes_out_biases_and_in_biases_stay_whole():
    model = pt.Transformer(pt.TransformerConfig(**common.CFGS["opt96"]))
    plan = ptp.tp_plan(model, ptp.TensorParallel(2, 0))
    for i in range(2):
        p = f"layers.{i}."
        for name in ("attn.o_proj.bias", "mlp.down_proj.bias"):
            assert plan[p + name].dim == 0, name          # "row": on h
        for name in ("attn.q_proj.bias", "attn.k_proj.bias",
                     "attn.v_proj.bias", "mlp.up_proj.bias",
                     "input_norm.weight", "post_attn_norm.bias"):
            assert plan[p + name] is None, name           # "replicate"


@pytest.mark.parametrize("positions,tp,sharded", [
    (2048, 2, True), (2048, 4, True), (2050, 2, True), (2050, 4, False)])
def test_opt_positions_follow_the_vocab_rule(positions, tp, sharded):
    """``embed_positions`` matches the "vocab" rule: OPT-1.3B's table (2,048
    rows once the HF offset rows are dropped) is sharded at tp 2 and 4; a
    table of 2,050 rows (HF's, offset rows kept) at tp 2 and whole at tp 4,
    where the rows do not divide."""
    model = opt_model("opt-1.3b", max_seq_len=positions)
    plan = ptp.tp_plan(model, ptp.TensorParallel(tp, 0))
    leaf = plan["embed_positions.weight"]
    assert (leaf is not None) == sharded
    if sharded:
        assert (leaf.dim, leaf.local_shape()) == (0, (positions // tp, 2048))
    lay = ptp.layouts_for(model, plan, ptp.TensorParallel(tp, 0))[model]
    assert lay.pos_sharded == sharded
    # the vocabulary divides by both
    assert plan["embed_tokens.weight"].local_shape() == (50272 // tp, 2048)


@pytest.mark.parametrize("run", common.RUNS[WORLD], ids=str)
def test_training_matches_jax_tp2(results, run):
    common.check_run(results, run)


@pytest.mark.parametrize("run", common.RUNS[WORLD], ids=str)
def test_tp_dims_are_the_jax_plans(results, run):
    common.check_plan(results, run)


@pytest.mark.parametrize("variant", ["opt96", "opt97"])
def test_gradients_match_jax_grad(results, variant):
    loss, want = results["ref"]["grads"][variant]
    names = results["names"][variant]
    n_checked = 0
    for r, rank in enumerate(results["ranks"]):
        got = rank["grads"][variant]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        spec_of = results["ref"][(variant, 0, "float32", 2)]["param_shards"]
        for name, g in got["grads"].items():
            if name.endswith("attn.k_proj.bias"):
                continue
            spec, _ = spec_of[names[name]]
            # JAX's gradient in the JAX layout, cut as the parameter is
            w = _natural_slice(want[name], name, spec, r, variant)
            np.testing.assert_allclose(
                g.numpy(), w, rtol=1e-4, atol=1e-6,
                err_msg=f"rank {r} {variant} {name}")
            n_checked += ("norm" in name or "embed" in name)
    assert n_checked >= 6


def _natural_slice(full, name, spec, rank, variant):
    """``full`` (a port-layout global tensor) in the JAX layout, cut to
    tp rank ``rank`` where ``spec`` shards it."""
    model = pt.Transformer(pt.TransformerConfig(**common.CFGS[variant]))
    view = model.jax_layouts().get(name, (None,))[0]
    t = full if view is None else view(full)
    d = common.tp_dim(spec)
    if d is not None:
        n = t.shape[d] // 2
        t = t.narrow(d, rank * n, n)
    return t.numpy()


def test_copy_to_tp_backward_allreduce_makes_layernorm_grads(results):
    """Without copy-to-TP's backward all-reduce each rank's LayerNorm
    gradient holds only its own heads' share: wrong against JAX."""
    _, want = results["ref"]["grads"]["opt96"]
    for rank in results["ranks"]:
        bad = rank["grads_no_copy_allreduce"]["grads"]
        good = rank["grads"]["opt96"]["grads"]
        for name in ("layers.0.input_norm.weight",
                     "layers.1.post_attn_norm.bias"):
            w = want[name].numpy()
            np.testing.assert_allclose(good[name].numpy(), w, rtol=1e-4,
                                       atol=1e-6)
            assert not np.allclose(bad[name].numpy(), w, rtol=1e-3,
                                   atol=1e-5), name


def test_grad_norm_counts_replicated_leaves_once(results):
    key = ("opt96", 0, "float32", 2)
    want = results["ref"][key]["grad_norms"]
    for rank in results["ranks"]:
        np.testing.assert_allclose(rank["runs"][key]["grad_norms"], want,
                                   rtol=1e-4)
    # clipping is active, and counting the replicated leaves on both ranks
    # gives another number
    assert min(want) > common.CLIP
    _, g = results["ref"]["grads"]["opt96"]
    plan = results["ranks"][0]["runs"][key]["plan"]
    once = sum(float((t.double() ** 2).sum()) for t in g.values())
    twice = once + sum(float((t.double() ** 2).sum()) for n, t in g.items()
                       if plan[n] is None)
    assert abs(np.sqrt(twice) - np.sqrt(once)) > 1e-3 * np.sqrt(once)


def test_generate_matches_jax_tp2_and_port_tp1(results):
    import deepspeed_tpu_torch as ds
    ids = results["inp"]["gen_ids"]
    want = results["ref"]["generate"]
    eng = ds.init_inference(
        pt.Transformer(pt.TransformerConfig(**common.CFGS["opt96"])),
        config={"dtype": "float32", "prefill_chunk_size": None},
        device="cpu")
    eng.set_params(results["weights"]["opt96"])
    tp1 = eng.generate(ids, max_new_tokens=8).numpy()
    np.testing.assert_array_equal(tp1, want)
    for rank in results["ranks"]:
        got = rank["generate"]["opt96"]
        np.testing.assert_array_equal(got["one_pass"].numpy(), want)
        assert got["serve_raises"]


def _hf_models():
    from transformers import (GPT2Config, GPT2LMHeadModel, GPTNeoConfig,
                              GPTNeoForCausalLM, LlamaConfig,
                              LlamaForCausalLM, OPTConfig, OPTForCausalLM)
    small = dict(vocab_size=96)
    return {
        "opt": lambda: OPTForCausalLM(OPTConfig(
            hidden_size=32, num_hidden_layers=2, ffn_dim=64,
            num_attention_heads=4, max_position_embeddings=32,
            word_embed_proj_dim=32, **small)),
        "gpt2": lambda: GPT2LMHeadModel(GPT2Config(
            n_embd=32, n_layer=2, n_head=4, n_positions=32, **small)),
        "llama": lambda: LlamaForCausalLM(LlamaConfig(
            hidden_size=32, num_hidden_layers=2, intermediate_size=64,
            num_attention_heads=4, num_key_value_heads=2, **small)),
        "gpt_neo": lambda: GPTNeoForCausalLM(GPTNeoConfig(
            hidden_size=32, num_layers=2, num_heads=4,
            attention_types=[[["global", "local"], 1]],
            max_position_embeddings=32, **small)),
    }


@pytest.mark.parametrize("family", ["opt", "gpt2", "llama", "gpt_neo"])
def test_autotp_rules_match_jax(results, family):
    torch.manual_seed(0)
    hf = _hf_models()[family]()
    got = get_tp_rules(hf)
    assert got == jax_rules(hf)
    assert any(kind == "row" for _, kind in got)


def test_initialize_takes_mpu_and_topology(results):
    """``initialize(mpu=)`` reads Megatron's legacy and Megatron-Core
    names; an explicit ``topology`` wins over an mpu; the config's
    ``tensor_parallel.tp_size`` otherwise (JAX ``initialize``): (tp, dp,
    micro) of each engine over 2 ranks."""
    for rank in results["ranks"]:
        e = rank["entry"]
        assert e["legacy_mpu"] == (2, 1, 4)
        assert e["core_mpu"] == (2, 1, 4)
        assert e["topology_wins"] == (1, 2, 2)
        assert e["config"] == (2, 1, 4)


def test_ranks_that_drew_their_own_init_train_one_model(results):
    """A module with weights, each tp rank's drawn from its own seed: the
    engine's slices come from the first tp rank's model, so the model every
    rank gathers is rank 0's init, replicated leaves (norms, biases) alike."""
    cfg = pt.TransformerConfig(**common.CFGS["opt96"])
    model = pt.Transformer(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(100))
    want = model.state_dict()
    for rank in results["ranks"]:
        got = rank["rank_inits"]
        assert sorted(got) == sorted(want)
        for name, t in want.items():
            assert torch.equal(got[name], t), name


@pytest.mark.parametrize("variant", sorted(common.CFGS))
def test_slices_hold_only_their_own_storage(variant):
    """A rank's slice is a compact copy: a view would keep the whole
    tensor's storage alive (every rank would hold the model)."""
    cfg = pt.TransformerConfig(**common.CFGS[variant])
    full = pt.Transformer(cfg, device="cpu")
    full.init_weights(torch.Generator().manual_seed(0))
    values = {k: v.clone() for k, v in full.state_dict().items()}
    model = pt.Transformer(cfg)
    plan = ptp.shard_module_(model, ptp.TensorParallel(2, 1), device="cpu",
                             values=values)
    assert any(leaf is not None for leaf in plan.values())
    for name, p in model.named_parameters():
        assert p.untyped_storage().nbytes() == p.numel() * p.element_size(), \
            name
        leaf = plan[name]
        want = values[name] if leaf is None else leaf.take(values[name])
        assert torch.equal(p.data, want), name


def test_hf_model_and_int8_weights_at_tp2(results):
    """``init_inference`` of an HF model at tp 2 converts it
    (``convert_hf_model``) and cuts it: the tokens of tp 1; int8 weights at
    tp 2 stay whole on every rank (JAX's warning and placement): the tokens
    of the tp-1 int8 engine."""
    import deepspeed_tpu_torch as ds
    from torch_tp_worker import hf_like
    ids = results["inp"]["gen_ids"]
    hf = ds.init_inference(hf_like(results["inp"]), config={
        "dtype": "float32", "prefill_chunk_size": None}, device="cpu")
    want_hf = hf.generate(ids, max_new_tokens=8)
    q = ds.init_inference(
        pt.Transformer(pt.TransformerConfig(**common.CFGS["opt96"])),
        config={"dtype": "float32", "quant": {"enabled": True, "bits": 8},
                "prefill_chunk_size": None}, device="cpu")
    q.set_params(results["weights"]["opt96"])
    want_q = q.generate(ids, max_new_tokens=8)
    for rank in results["ranks"]:
        cut, got = rank["routes"]["hf"]
        assert cut and torch.equal(got, want_hf)
        whole, got = rank["routes"]["int8"]
        assert whole and torch.equal(got, want_q)
