"""Llama training through the port's engine against the JAX engine, on the
CPU, from the same numpy-drawn weights.

``llama-tiny`` cut to 2 layers and a vocabulary of 1024 (hidden 256, 8
heads of 32, ffn 688, untied head; the 32000-row embedding and head would
be 90 % of the parameters and of the test's time), with its 4 kv heads
(GQA, G = 2) and an MHA twin (8 kv heads), through ``initialize()`` → ``train_batch()`` in both packages (the
JAX engine on a one-device topology; its flash kernel in interpret mode)
for 3 steps of AdamW + clipping at gradient accumulation 2:

- fp32: losses within 1e-5 relative, final parameters within 1e-4;
- bf16 (``bf16.enabled``, fp32 masters): losses within 2e-2 relative,
  final parameters within 2e-2 (bf16 activations; JAX's jitted program
  keeps some intermediates in fp32 that eager PyTorch rounds);
- in both, at most 1 element in 10^5 of a parameter may sit outside that
  bar, and then within Adam's largest move over the run (2 · lr · steps):
  an element whose gradient is roundoff in both packages (a component
  that cancels) gets lr-sized steps of either sign from m / sqrt(v);
- every JAX remat policy on the port gives the first step of
  ``remat=False`` bitwise (loss and every parameter), 2 steps each.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.models import opt as jopt
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.parallel.topology import initialize_topology, reset_topology

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import opt as popt
from deepspeed_tpu_torch.models import transformer as pt

B, S, STEPS, VOCAB = 2, 16, 3, 1024
TWINS = {"gqa": {}, "mha": dict(num_kv_heads=8)}
CONFIG = {
    "train_micro_batch_size_per_gpu": B,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "AdamW",
                  "params": {"lr": 3e-3, "weight_decay": 0.01}},
    "gradient_clipping": 1.0,
}
TOLS = {"float32": dict(loss=1e-5, params=1e-4),
        "bfloat16": dict(loss=2e-2, params=2e-2)}
POLICIES = ("nothing_saveable", "flash_only_saveable",
            "dots_and_attn_saveable", "dots_with_no_batch_dims_saveable",
            "everything_saveable")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread in this process, whatever an earlier module of
    the same worker left set: the in-process engines sum in one order
    under any load, as the launched ranks (one thread each) do."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def overrides(twin, dtype):
    return dict(TWINS[twin], num_layers=2, vocab_size=VOCAB, dtype=dtype,
                scan_layers=False, remat=False)


def random_tree(jmodel, seed=0):
    """Numpy leaves from a seed: RMS scales near 1, matrices std 0.05."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), {"input_ids": jnp.zeros((1, 8), jnp.int32)}))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if "scale" in jax.tree_util.keystr(path):
            return 1.0 + 0.1 * x
        return 0.05 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def batches(vocab, seed=3):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (2, B, S)).astype(np.int32)}
            for _ in range(STEPS)]


def config(dtype):
    return dict(CONFIG, bf16={"enabled": dtype == "bfloat16"})


def jax_run(twin, dtype):
    jmodel = jopt.llama_model("llama-tiny", **overrides(twin, dtype))
    tree = random_tree(jmodel)
    topo = initialize_topology(dp=1, devices=jax.devices()[:1])
    try:
        jeng, *_ = deepspeed_tpu.initialize(
            model=jmodel, model_parameters=tree, config=config(dtype),
            topology=topo)
        losses = [float(jeng.train_batch(batch=b))
                  for b in batches(jmodel.config.vocab_size)]
        params = jax.device_get(jeng.params)
    finally:
        reset_topology()
    return tree, losses, params


def port_engine(tree, twin, dtype, **over):
    model = popt.llama_model("llama-tiny", **{**overrides(twin, dtype),
                                              **over})
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=tree, config=config(dtype),
        device="cpu")
    return eng


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("twin", sorted(TWINS))
def test_llama_train_batch_matches_jax(twin, dtype):
    tree, want, jparams = jax_run(twin, dtype)
    eng = port_engine(tree, twin, dtype)
    got = [float(eng.train_batch(batch=b))
           for b in batches(eng.module.config.vocab_size)]
    tol = TOLS[dtype]
    np.testing.assert_allclose(got, want, rtol=tol["loss"])
    want_sd = pt.params_from_flax(jparams, eng.module.config)
    sd = eng.module_state_dict()
    assert set(sd) == set(want_sd)
    for name, w in want_sd.items():
        assert_params_close(name, sd[name].float(), w, tol["params"])


def assert_params_close(name, got, want, tol):
    """``got`` within ``tol`` of ``want`` but for at most 1 element in
    10^5, which must stay within Adam's largest move (see the module
    docstring)."""
    diff = (got - want).abs()
    off = diff > tol + tol * want.abs()
    assert int(off.sum()) <= max(1, want.numel() // 100_000), \
        (name, int(off.sum()), float(diff.max()))
    lr = CONFIG["optimizer"]["params"]["lr"]
    assert float(diff.max()) <= 2 * lr * STEPS, (name, float(diff.max()))


def test_llama_remat_policies_equal_remat_off():
    jmodel = jopt.llama_model("llama-tiny", **overrides("gqa", "float32"))
    tree = random_tree(jmodel)
    data = batches(VOCAB)[:2]

    def run(**over):
        eng = port_engine(tree, "gqa", "float32", **over)
        losses = [eng.train_batch(batch=b) for b in data]
        return losses, {k: v.clone() for k, v in
                        eng.module_state_dict().items()}

    want_losses, want_sd = run()
    for policy in POLICIES:
        losses, sd = run(remat=True, remat_policy=policy)
        for a, b in zip(losses, want_losses):
            assert torch.equal(a, b), policy
        for name, w in want_sd.items():
            assert torch.equal(sd[name], w), (policy, name)
