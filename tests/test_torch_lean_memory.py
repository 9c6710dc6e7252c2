"""The single-device memory levers of the port's engine against the JAX
engine, on the CPU, from the same numpy-drawn weights of a tiny OPT
(2 layers, hidden 64, vocab 97) — both engines on one device:

- **lean mode** (``bf16.master_weights_in_bf16`` + ``state_dtype:
  bfloat16``), the JAX scenario (``tests/unit/test_engine.py:170-195``):
  it trains, every parameter and moment is bf16, and a checkpoint round
  trip keeps the dtypes and the bits; against the JAX engine over 3
  ``train_batch`` steps: losses within 2e-2 relative; every parameter
  element within Adam's largest move over the run (2 · lr · steps) and
  each tensor's mean difference within lr / 2 (bf16 parameters, moments
  and activations in both, rounded at different places: JAX's jitted
  program keeps some bf16 intermediates wider, and a gradient component
  near zero then takes an lr-sized step of the other sign);
- **``data_types.grad_accum_dtype: bf16``** at gas 2 and 4 against the JAX
  engine's 3-call path (``forward`` / ``backward`` / ``step``; the JAX
  fused ``train_batch`` ignores the knob, ROADMAP.md queue C): losses
  within 1e-5 relative, fp32 masters within 2e-3 (each micro step's
  gradients are rounded to bf16 and summed in bf16 on both sides; a
  last-bit difference of the fp32 gradients can round to the other bf16);
  and the port's bf16 sum differs from its fp32 sum;
- bf16 parameters (lean mode) with an **fp32 accumulator** (the default):
  the engine
  keeps fp32 sums beside the bf16 ``.grad``s, bitwise equal to summing the
  micro steps' bf16 gradients in fp32 by hand;
- **``zero_optimization.grad_partition_groups``** 2 and 3: the port's
  engine gives bitwise the bits of groups = 1 (every parameter's gradient
  is computed by the same ops, only the others' are skipped), and matches
  the JAX engine's grouped path over 3 steps (losses 1e-5, parameters
  1e-4); the group split is JAX's rule (contiguous, about equal bytes);
- **``BF16_Optimizer``** against the JAX class: fp32 masters, fp32
  accumulation over two ``backward`` calls, clipping, 3 steps (masters
  within 1e-6, the bf16 view bitwise of the port's own masters);
- the device step's parameter groups (``SKIP_GROUP_NUMEL``) give the bits
  of one whole-tree update in lean mode.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.ops.adam.fused_adam import FusedAdamW as JAdamW
from deepspeed_tpu.parallel.topology import initialize_topology, reset_topology
from deepspeed_tpu.runtime.bf16_optimizer import BF16_Optimizer as JBF16

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdamW
from deepspeed_tpu_torch.runtime import engine as peng
from deepspeed_tpu_torch.runtime.bf16_optimizer import BF16_Optimizer

CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, ffn_hidden_size=128, remat=False,
           scan_layers=False)
B, S = 2, 16
LEAN = {"bf16": {"enabled": True, "master_weights_in_bf16": True},
        "optimizer": {"type": "AdamW",
                      "params": {"lr": 1e-2, "state_dtype": "bfloat16"}}}


def base(gas=2, **extra):
    return {"train_micro_batch_size_per_gpu": B,
            "gradient_accumulation_steps": gas,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 3e-3, "weight_decay": 0.01}},
            "gradient_clipping": 1.0, **extra}


def random_tree(seed=0):
    jmodel = jt.Transformer(jt.TransformerConfig(**CFG, dtype="float32"))
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), {"input_ids": jnp.zeros((1, 8), jnp.int32)}))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return 1.0 + 0.1 * x
        if "bias" in name:
            return 0.02 * x
        return 0.2 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def data(gas, n, seed=5):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, CFG["vocab_size"],
                                       (gas, B, S)).astype(np.int32)}
            for _ in range(n)]


def jax_engine(tree, config, dtype):
    jmodel = jt.Transformer(jt.TransformerConfig(**CFG, dtype=dtype))
    topo = initialize_topology(dp=1, devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(model=jmodel, model_parameters=tree,
                                        config=config, topology=topo)
    return jeng


def jax_three_call(jeng, batch):
    """The JAX engine's forward / backward / step over a stacked batch."""
    losses = []
    for i in range(batch["input_ids"].shape[0]):
        loss = jeng({"input_ids": batch["input_ids"][i]})
        jeng.backward(loss)
        jeng.step()
        losses.append(float(loss))
    return float(np.mean(losses))


def port_engine(tree, config, dtype):
    model = pt.Transformer(pt.TransformerConfig(**CFG, dtype=dtype))
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=tree, config=config, device="cpu")
    return eng


def close_params(eng, jparams, tol, skip_k_bias=True):
    want = pt.params_from_flax(jax.tree.map(np.asarray, jparams),
                               eng.module.config)
    for name, got in eng.module_state_dict().items():
        if skip_k_bias and name.endswith("attn.k_proj.bias"):
            # its true gradient is 0 (softmax ignores a key bias): both
            # sides' gradients are roundoff that Adam turns into lr steps
            continue
        np.testing.assert_allclose(got.float().numpy(), want[name].numpy(),
                                   rtol=tol, atol=tol, err_msg=name)


# --------------------------------------------------------------------- #
# Lean mode: bf16 masters and moments
# --------------------------------------------------------------------- #
def test_lean_mode_dtypes_training_and_checkpoint(tmp_path):
    eng = port_engine(random_tree(), base(gas=1, **LEAN), "bfloat16")
    batch = data(1, 1)[0]
    losses = [float(eng.train_batch(batch=batch)) for _ in range(10)]
    assert losses[-1] < losses[0], losses
    assert all(p.dtype == torch.bfloat16 for p in eng.params)
    assert all(t.dtype == torch.bfloat16 for f in eng._opt_state for t in f)
    eng.save_checkpoint(str(tmp_path))
    before = {k: v.clone() for k, v in eng.module_state_dict().items()}
    moments = [t.clone() for t in eng._opt_state.exp_avg]
    eng.train_batch(batch=batch)
    eng.load_checkpoint(str(tmp_path))
    assert all(p.dtype == torch.bfloat16 for p in eng.params)
    for k, v in eng.module_state_dict().items():
        assert torch.equal(v, before[k])
    for a, b in zip(eng._opt_state.exp_avg, moments):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_lean_mode_matches_jax():
    tree = random_tree()
    cfg = base(**LEAN)
    jcfg = dict(cfg, optimizer={"type": "AdamW", "params": {
        "lr": 1e-2, "state_dtype": jnp.bfloat16}})
    batches = data(2, 3)
    try:
        jeng = jax_engine(tree, jcfg, "bfloat16")
        want = [float(jeng.train_batch(batch=b)) for b in batches]
        jparams = jax.device_get(jeng.params)
        assert all(l.dtype == jnp.bfloat16 for l in jax.tree.leaves(jparams))
    finally:
        reset_topology()
    eng = port_engine(tree, cfg, "bfloat16")
    got = [float(eng.train_batch(batch=b)) for b in batches]
    np.testing.assert_allclose(got, want, rtol=2e-2)
    lr, steps = 1e-2, len(batches)
    wantp = pt.params_from_flax(jax.tree.map(np.asarray, jparams),
                                eng.module.config)
    for name, p in eng.module_state_dict().items():
        if name.endswith("attn.k_proj.bias"):
            continue                 # roundoff gradients (see close_params)
        diff = (p.float() - wantp[name]).abs()
        assert float(diff.max()) <= 2 * lr * steps, name
        assert float(diff.mean()) <= lr / 2, name


def test_lean_mode_warns_without_bf16(caplog):
    cfg = base(gas=1, bf16={"enabled": False,
                            "master_weights_in_bf16": True})
    eng = port_engine(random_tree(), cfg, "float32")
    assert all(p.dtype == torch.float32 for p in eng.params)


def test_groups_of_the_device_step_equal_one_group(monkeypatch):
    tree = random_tree()
    batches = data(2, 2)
    runs = []
    for numel in (1 << 26, 1000):          # one group; many
        monkeypatch.setattr(peng, "SKIP_GROUP_NUMEL", numel)
        eng = port_engine(tree, base(**LEAN), "bfloat16")
        n_groups = len(peng._skip_groups(eng.params))
        assert (n_groups == 1) == (numel > 1000), n_groups
        for b in batches:
            eng.train_batch(batch=b)
        runs.append(eng)
    a, b = runs
    for x, y in zip(a.params + list(a._opt_state.exp_avg_sq),
                    b.params + list(b._opt_state.exp_avg_sq)):
        assert torch.equal(x, y)


# --------------------------------------------------------------------- #
# The gradient accumulation dtype
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("gas", [2, 4])
def test_bf16_grad_accum_matches_jax_three_call(gas):
    tree = random_tree()
    cfg = base(gas=gas, data_types={"grad_accum_dtype": "bf16"})
    batches = data(gas, 3)
    try:
        jeng = jax_engine(tree, cfg, "float32")
        want = [jax_three_call(jeng, b) for b in batches]
        jparams = jax.device_get(jeng.params)
    finally:
        reset_topology()
    eng = port_engine(tree, cfg, "float32")
    got = [float(eng.train_batch(batch=b)) for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    close_params(eng, jparams, 2e-3)
    # the bf16 sum is not the fp32 sum
    ref = port_engine(tree, base(gas=gas), "float32")
    for b in batches:
        ref.train_batch(batch=b)
    assert any(not torch.equal(x, y) for x, y in zip(eng.params, ref.params))


def test_bf16_params_accumulate_in_fp32():
    tree = random_tree()
    batch = data(2, 1)[0]
    eng = port_engine(tree, base(**LEAN), "bfloat16")       # bf16 params
    eng.zero_grad()
    # the same micro steps by hand: bf16 .grads summed in fp32
    model = pt.Transformer(pt.TransformerConfig(**CFG, dtype="bfloat16"),
                           device="cpu")
    model.load_state_dict({k: v.float() for k, v in
                           eng.module_state_dict().items()})
    model.to(torch.bfloat16)
    want = None
    for i in range(2):
        model.zero_grad()
        loss = model({"input_ids": torch.from_numpy(batch["input_ids"][i])})
        (loss.float() * 1.0 / 2).backward()
        g = [p.grad.float() for p in model.parameters()]
        want = g if want is None else [a + b for a, b in zip(want, g)]
    for i in range(2):
        loss = eng({"input_ids": batch["input_ids"][i]})
        eng.backward(loss)
    assert all(p.grad is None for p in eng.params)     # folded and cleared
    got = eng._grads()
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    eng.step()


def test_unknown_grad_accum_dtype_raises():
    with pytest.raises(ValueError, match="grad_accum_dtype"):
        port_engine(random_tree(), base(data_types={"grad_accum_dtype":
                                                    "int8"}), "float32")


# --------------------------------------------------------------------- #
# The partitioned backward
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("groups", [2, 3])
def test_grad_partition_groups_match_one_group_and_jax(groups):
    tree = random_tree()
    batches = data(2, 3)
    cfg = base(zero_optimization={"grad_partition_groups": groups})
    try:
        jeng = jax_engine(tree, cfg, "float32")
        want = [float(jeng.train_batch(batch=b)) for b in batches]
        jparams = jax.device_get(jeng.params)
    finally:
        reset_topology()
    eng = port_engine(tree, cfg, "float32")
    bounds = eng._group_bounds(groups)
    assert len(bounds) == groups and bounds[0][0] == 0 \
        and bounds[-1][1] == len(eng.params)
    one = port_engine(tree, base(), "float32")
    got = []
    for b in batches:
        got.append(float(eng.train_batch(batch=b)))
        one.train_batch(batch=b)
        for x, y in zip(eng.params, one.params):
            assert torch.equal(x, y)
    assert all(p.requires_grad for p in eng.params)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    close_params(eng, jparams, 1e-4)


def test_grouped_forward_twice_raises():
    eng = port_engine(random_tree(), base(zero_optimization={
        "grad_partition_groups": 2}), "float32")
    mb = {"input_ids": data(2, 1)[0]["input_ids"][0]}
    eng(mb)
    with pytest.raises(RuntimeError, match="twice without backward"):
        eng(mb)


# --------------------------------------------------------------------- #
# BF16_Optimizer
# --------------------------------------------------------------------- #
def test_bf16_optimizer_matches_jax():
    rng = np.random.default_rng(8)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    bf = [torch.from_numpy(p).to(torch.bfloat16) for p in params]
    jopt = JBF16(JAdamW(lr=1e-2), params=[jnp.asarray(p.float().numpy())
                                          for p in bf], clip_grad=0.5)
    popt = BF16_Optimizer(FusedAdamW(lr=1e-2), params=bf, clip_grad=0.5)
    for _ in range(3):
        for _ in range(2):                       # two micro steps
            grads = [rng.standard_normal(s).astype(np.float32)
                     for s in shapes]
            jopt.backward([jnp.asarray(g).astype(jnp.bfloat16)
                           for g in grads])
            popt.backward([torch.from_numpy(g).to(torch.bfloat16)
                           for g in grads])
        assert jopt.step() is False and popt.step() is False
    for got, want in zip(popt.fp32_groups_flat, jopt.fp32_groups_flat):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    for got, m in zip(popt.get_bf16_params(), popt.fp32_groups_flat):
        assert torch.equal(got, m.to(torch.bfloat16))
    sd = popt.state_dict()
    fresh = BF16_Optimizer(FusedAdamW(lr=1e-2), params=bf)
    fresh.load_state_dict(sd)
    assert fresh.step_count == 3 and fresh.cur_scale == 1.0
    for a, b in zip(fresh.opt_state.exp_avg, popt.opt_state.exp_avg):
        assert torch.equal(a, b)
