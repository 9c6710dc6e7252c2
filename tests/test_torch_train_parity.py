"""The port's training slice against the JAX package's, on the CPU, from
the same numpy inputs.

- model: the causal-LM loss and every parameter's gradient of a tiny OPT
  (2 layers, hidden 64, 4 heads, vocab 97, fp32, flash attention on)
  against ``jax.value_and_grad`` of the JAX model (Pallas in interpret
  mode), the JAX gradient tree mapped to the port's layout by
  ``params_from_flax`` (the conversion is linear); the chunked loss, remat
  and an ``attention_mask`` batch too.  Tolerance: loss 1e-5 relative,
  gradients 1e-4 (fp32 summation order);
- engine: 5 ``train_batch`` steps of AdamW + WarmupLR + clipping 1.0 at
  gradient accumulation 2 in both packages (the JAX engine on a one-device
  topology): losses within 1e-5 relative, final parameters within 1e-4;
  the port's 3-call path gives bitwise what its ``train_batch`` gives;
- the optimizers' updates, every LR schedule and the dynamic loss scaler
  against the JAX ones (schedules and scaler exactly), and the config's
  batch-triple errors, the single-device memory knobs it parses and the
  out-of-slice refusals.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.parallel.topology import initialize_topology, reset_topology
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime import optimizers as jopt
from deepspeed_tpu.runtime.fp16 import loss_scaler as jscaler

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.runtime import config as pconfig
from deepspeed_tpu_torch.runtime import engine as peng
from deepspeed_tpu_torch.runtime import lr_schedules as plr
from deepspeed_tpu_torch.runtime import optimizers as popt
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as pscaler

CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, dtype="float32", use_flash_attention=True,
           tie_word_embeddings=True, activation="relu")
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 16


def random_tree(jmodel, seed=0):
    """The JAX model's parameter tree with numpy leaves drawn from a
    seed: norm scales near 1, biases small, matrices std 0.2."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), {"input_ids": jnp.zeros((1, 8), jnp.int32)}))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.1 * x
        if "bias" in name:
            return 0.1 * x
        return 0.2 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def jmodel_tree():
    jmodel = jt.Transformer(jt.TransformerConfig(**CFG))
    return jmodel, random_tree(jmodel)


def _port_model(tree, **over):
    cfg = pt.TransformerConfig(**{**CFG, "remat": False, **over})
    m = pt.Transformer(cfg, device="cpu")
    m.load_state_dict(pt.params_from_flax(tree, cfg))
    return m


def _batch(seed, masked=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 97, (B, S)).astype(np.int32)
    batch = {"input_ids": ids}
    if masked:                               # right-padded second row
        mask = np.ones((B, S), np.int32)
        mask[1, 11:] = 0
        batch["attention_mask"] = mask
    return batch


def _jax_loss_and_grads(jmodel, tree, batch):
    loss, grads = jax.value_and_grad(
        lambda p: jmodel.apply(p, {k: jnp.asarray(v)
                                   for k, v in batch.items()}))(tree)
    return float(loss), pt.params_from_flax(grads, pt.TransformerConfig(**CFG))


def _port_loss_and_grads(model, batch):
    model.zero_grad()
    loss = model({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in
                         model.named_parameters()}


def _assert_grads(got, want, tol=GRAD_TOL):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_loss_and_grads_match_jax(jmodel_tree, masked):
    jmodel, tree = jmodel_tree
    batch = _batch(1, masked)
    want_loss, want = _jax_loss_and_grads(jmodel, tree, batch)
    got_loss, got = _port_loss_and_grads(_port_model(tree), batch)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    _assert_grads(got, want)


def test_chunked_loss_and_remat_equal_the_plain_forward(jmodel_tree):
    """``loss_seq_chunks=4`` (checkpointed head per chunk) and
    ``remat=True`` (checkpointed blocks) give the plain forward's loss and
    gradients."""
    _, tree = jmodel_tree
    batch = _batch(2)
    want_loss, want = _port_loss_and_grads(_port_model(tree), batch)
    for over in (dict(loss_seq_chunks=4), dict(remat=True),
                 dict(remat=True, loss_seq_chunks=4)):
        got_loss, got = _port_loss_and_grads(_port_model(tree, **over),
                                             batch)
        np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6,
                                   err_msg=str(over))
        _assert_grads(got, want, dict(rtol=1e-5, atol=1e-6))


def test_forward_semantics():
    """A bare id tensor, explicit labels and the ignore index behave as
    the JAX ``__call__``."""
    ids = torch.from_numpy(_batch(3)["input_ids"]).long()
    labels = pt.derive_causal_labels(ids)
    assert (labels[:, -1] == -100).all()
    assert torch.equal(labels[:, :-1], ids[:, 1:])
    mask = torch.ones_like(ids)
    mask[0, 5:] = 0
    masked = pt.derive_causal_labels(ids, mask)
    assert (masked[0, 4:] == -100).all() and (masked[1, :-1] >= 0).all()
    logits = torch.randn(B, S, 97)
    full = pt.cross_entropy_loss(logits, labels)
    want = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, 97), ids[:, 1:].reshape(-1))
    torch.testing.assert_close(full, want, rtol=1e-6, atol=1e-6)
    z = pt.cross_entropy_loss(logits, labels, z_loss=1e-2)
    jz = jt.cross_entropy_loss(jnp.asarray(logits.numpy()),
                               jnp.asarray(labels.numpy()), z_loss=1e-2)
    np.testing.assert_allclose(float(z), float(jz), rtol=1e-6)


# --------------------------------------------------------------------- #
# Engine trajectory
# --------------------------------------------------------------------- #
ENGINE_CONFIG = {
    "train_micro_batch_size_per_gpu": B,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "AdamW",
                  "params": {"lr": 3e-3, "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_min_lr": 1e-3, "warmup_max_lr": 3e-3,
                             "warmup_num_steps": 3,
                             "warmup_type": "linear"}},
    "gradient_clipping": 1.0,
}
STEPS = 5


def _stacked_batches():
    rng = np.random.default_rng(11)
    return [{"input_ids": rng.integers(0, 97, (2, B, S)).astype(np.int32)}
            for _ in range(STEPS)]


def _port_engine(tree):
    model = pt.Transformer(pt.TransformerConfig(**dict(CFG, remat=False)))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=tree, config=ENGINE_CONFIG,
        device="cpu")
    return engine


def test_engine_trajectory_matches_jax(jmodel_tree):
    jmodel, tree = jmodel_tree
    batches = _stacked_batches()
    topo = initialize_topology(dp=1, devices=jax.devices()[:1])
    try:
        jeng, *_ = deepspeed_tpu.initialize(
            model=jmodel, model_parameters=tree, config=ENGINE_CONFIG,
            topology=topo)
        want = [float(jeng.train_batch(batch=b)) for b in batches]
        want_params = pt.params_from_flax(jax.device_get(jeng.params),
                                          pt.TransformerConfig(**CFG))
        want_lr = jeng.get_lr()
    finally:
        reset_topology()
    eng = _port_engine(tree)
    got = [float(eng.train_batch(batch=b)) for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert eng.get_lr() == want_lr
    assert eng.global_steps == STEPS and eng.micro_steps == 2 * STEPS
    assert eng.global_samples == STEPS * 2 * B
    sd = eng.module_state_dict()
    for name, w in want_params.items():
        if name.endswith("attn.k_proj.bias"):
            # its true gradient is 0 (a key bias shifts every score of a
            # row alike; softmax ignores it), so both gradients are
            # roundoff and Adam's m/sqrt(v) turns roundoff into lr-sized
            # steps of either sign: nothing to compare
            continue
        np.testing.assert_allclose(sd[name].numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_three_call_path_equals_train_batch(jmodel_tree):
    _, tree = jmodel_tree
    batches = _stacked_batches()[:3]
    a, b = _port_engine(tree), _port_engine(tree)
    for batch in batches:
        want = a.train_batch(batch=batch)
        losses = []
        for i in range(2):
            loss = b({"input_ids": batch["input_ids"][i]})
            b.backward(loss)
            losses.append(float(loss.detach()))
            b.step()
        np.testing.assert_allclose(np.mean(losses), float(want), rtol=1e-7)
    assert b.global_steps == a.global_steps == 3
    sa, sb = a.module_state_dict(), b.module_state_dict()
    for name in sa:
        torch.testing.assert_close(sb[name], sa[name], rtol=0, atol=0)
    torch.testing.assert_close(b.get_global_grad_norm(),
                               a.get_global_grad_norm(), rtol=0, atol=0)


def test_engine_guards():
    model = pt.Transformer(pt.TransformerConfig(**CFG))
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=model, config={"train_micro_batch_size_per_gpu": B,
                             "gradient_accumulation_steps": 2},
        device="cpu")
    ids = _batch(4)["input_ids"]
    with pytest.raises(RuntimeError, match="without a prior forward"):
        eng.backward(None)
    eng.backward(eng(ids))
    eng.step()                               # mid-window: no update yet
    assert eng.global_steps == 0
    eng(ids)
    with pytest.raises(RuntimeError, match="twice without backward"):
        eng(ids)
    with pytest.raises(ValueError, match="float32"):
        deepspeed_tpu_torch.initialize(
            model=pt.Transformer(pt.TransformerConfig(**CFG)),
            config={"train_micro_batch_size_per_gpu": 1,
                    "bf16": {"enabled": True}}, device="cpu")


def test_meta_model_is_seeded_from_config():
    def build(seed):
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=pt.Transformer(pt.TransformerConfig(**CFG)),
            config={"train_micro_batch_size_per_gpu": 1, "seed": seed},
            device="cpu")
        return eng.module.embed_tokens.weight.detach()
    torch.testing.assert_close(build(3), build(3), rtol=0, atol=0)
    assert not torch.equal(build(3), build(4))


# --------------------------------------------------------------------- #
# Optimizers, schedules, loss scaler, config
# --------------------------------------------------------------------- #
OPTIMIZERS = {
    "adam_l2": ({"type": "Adam", "params": {"lr": 1e-2, "weight_decay": 0.1,
                                            "adam_w_mode": False}}),
    "adamw": ({"type": "AdamW", "params": {"lr": 1e-2, "weight_decay": 0.1}}),
    "adamw_bf16_state": ({"type": "AdamW",
                          "params": {"lr": 1e-2, "state_dtype": "bfloat16"}}),
    "sgd_nesterov": ({"type": "SGD", "params": {
        "lr": 1e-2, "momentum": 0.9, "nesterov": True,
        "weight_decay": 0.01}}),
    "sgd": ({"type": "SGD", "params": {"lr": 1e-2}}),
    "adagrad": ({"type": "Adagrad", "params": {"lr": 1e-2,
                                               "weight_decay": 0.01}}),
    "lion": ({"type": "Lion", "params": {"lr": 1e-3, "weight_decay": 0.1}}),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_updates_match_jax(name):
    block = OPTIMIZERS[name]
    jparams = dict(block["params"])
    if jparams.get("state_dtype") == "bfloat16":
        jparams["state_dtype"] = jnp.bfloat16
    jo = jopt.build_optimizer(jconfig.OptimizerConfig(
        type=block["type"], params=jparams))
    po = popt.build_optimizer(pconfig.OptimizerConfig(**block))
    rng = np.random.default_rng(5)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jp = list(map(jnp.asarray, params))
    pp = [torch.from_numpy(p.copy()) for p in params]
    jstate, pstate = jo.init(jp), po.init(pp)
    for step in range(1, 4):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        jp, jstate = jo.update(list(map(jnp.asarray, grads)), jstate, jp,
                               lr=jnp.float32(2e-2), step=step)
        po.update([torch.from_numpy(g) for g in grads], pstate, pp,
                  lr=2e-2, step=step)
    for got, want in zip(pp, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-6, atol=2e-6)


def test_unported_optimizers_raise():
    for name in ("Lamb", "OneBitAdam", "ZeroOneAdam", "OneBitLamb"):
        with pytest.raises(NotImplementedError):
            popt.build_optimizer(pconfig.OptimizerConfig(type=name))
    with pytest.raises(ValueError, match="unknown optimizer"):
        popt.build_optimizer(pconfig.OptimizerConfig(type="nope"))


SCHEDULES = [
    ("WarmupLR", dict(warmup_min_lr=1e-4, warmup_max_lr=1e-2,
                      warmup_num_steps=7)),
    ("WarmupLR", dict(warmup_max_lr=1e-3, warmup_num_steps=5,
                      warmup_type="linear")),
    ("WarmupDecayLR", dict(total_num_steps=20, warmup_num_steps=4)),
    ("WarmupCosineLR", dict(total_num_steps=20, warmup_num_steps=4,
                            cos_min_ratio=0.1)),
    ("CosineAnnealingLR", dict(total_num_steps=12, warmup_num_steps=2)),
    ("LRRangeTest", dict(lr_range_test_step_size=3,
                         lr_range_test_staircase=True)),
    ("LRRangeTest", dict(lr_range_test_step_size=3,
                         lr_range_test_step_rate=2.0)),
    ("OneCycle", dict(cycle_first_step_size=4, cycle_second_step_size=6,
                      decay_step_size=2, decay_lr_rate=0.5)),
]


@pytest.mark.parametrize("name,params", SCHEDULES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCHEDULES)])
def test_lr_schedules_match_jax_exactly(name, params):
    j = jlr.build_lr_scheduler(jconfig.SchedulerConfig(type=name,
                                                       params=params))
    p = plr.build_lr_scheduler(pconfig.SchedulerConfig(type=name,
                                                       params=params))
    assert [p.lr_at(s) for s in range(30)] == [j.lr_at(s) for s in range(30)]
    for _ in range(10):
        assert p.get_lr() == j.get_lr()
        p.step()
        j.step()
    if name == "OneCycle":
        assert [p.mom_at(s) for s in range(30)] == \
            [j.mom_at(s) for s in range(30)]


@pytest.mark.parametrize("consecutive", [False, True])
def test_dynamic_loss_scaler_matches_jax(consecutive):
    kw = dict(init_scale=2.0 ** 8, scale_window=3, min_scale=2.0,
              delayed_shift=2, consecutive_hysteresis=consecutive)
    js, ps = jscaler.DynamicLossScaler(**kw), pscaler.DynamicLossScaler(**kw)
    jst, pst = js.init(), ps.init()
    flags = [0, 0, 0, 1, 0, 1, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 0]
    for f in flags:
        jst = js.update(jst, jnp.asarray(bool(f)))
        pst = ps.update(pst, torch.tensor(bool(f)))
        assert (float(pst.scale), int(pst.good_steps),
                int(pst.hysteresis)) == \
            (float(jst.scale), int(jst.good_steps), int(jst.hysteresis))
    static = pscaler.create_loss_scaler(pconfig.FP16Config(
        enabled=True, loss_scale=128.0))
    assert float(static.update(static.init(), torch.tensor(True)).scale) \
        == 128.0


@pytest.mark.parametrize("triple", [
    dict(train_batch_size=7, train_micro_batch_size_per_gpu=2,
         gradient_accumulation_steps=3),
    dict(train_batch_size=7, train_micro_batch_size_per_gpu=2),
    dict(train_batch_size=7, gradient_accumulation_steps=2),
])
def test_batch_triple_errors_match_jax(triple):
    with pytest.raises(ValueError) as want:
        jconfig.DeepSpeedConfig(dict(triple), mesh_world_size=1)
    with pytest.raises(ValueError) as got:
        pconfig.DeepSpeedConfig(dict(triple))
    assert str(got.value) == str(want.value)


def test_batch_triple_completion_matches_jax():
    for triple in (dict(train_batch_size=8, train_micro_batch_size_per_gpu=2),
                   dict(train_batch_size=8, gradient_accumulation_steps=4),
                   dict(train_micro_batch_size_per_gpu=3),
                   dict(train_batch_size=6), {}):
        j = jconfig.DeepSpeedConfig(dict(triple), mesh_world_size=1)
        p = pconfig.DeepSpeedConfig(dict(triple))
        assert (p.train_batch_size, p.train_micro_batch_size_per_gpu,
                p.gradient_accumulation_steps) == \
            (j.train_batch_size, j.train_micro_batch_size_per_gpu,
             j.gradient_accumulation_steps)


@pytest.mark.parametrize("knob", [
    {"zero_optimization": {"offload_param": {"device": "nvme"}}},
    {"zero_optimization": {"mics_shard_size": 2}},
    {"tensor_parallel": {"tp_size": 2}},
    {"pipeline": {"stages": 2}},
    {"sequence_parallel": {"sp_size": 2}},
    {"moe": {"ep_size": 2}},
    {"curriculum_learning": {"enabled": True}},
    {"compression_training": {"weight_quantization": {"shared": 1}}},
    {"flops_profiler": {"enabled": True}},
    {"compile_cache": {"enabled": True}},
    {"hybrid_engine": {"enabled": True}},
], ids=lambda k: next(iter(k)))
def test_out_of_slice_knobs_raise(knob):
    if "mics_shard_size" in str(knob):
        # MiCS is ported (the ZeRO-3 slice): the config takes it
        cfg = pconfig.DeepSpeedConfig(dict(knob,
                                           train_micro_batch_size_per_gpu=1))
        assert cfg.zero_config.mics_shard_size == 2
        return
    if "tensor_parallel" in knob:
        # tensor parallelism is ported (the TP slice): the config takes it;
        # an engine without a process group of tp ranks refuses it
        cfg = pconfig.DeepSpeedConfig(dict(knob,
                                           train_micro_batch_size_per_gpu=1))
        assert cfg.tensor_parallel.tp_size == 2
        with pytest.raises(ValueError, match="process group"):
            deepspeed_tpu_torch.initialize(
                model=pt.Transformer(pt.TransformerConfig(**CFG)), config=dict(
                    knob, train_micro_batch_size_per_gpu=1), device="cpu")
        return
    with pytest.raises(NotImplementedError):
        pconfig.DeepSpeedConfig(dict(knob, train_micro_batch_size_per_gpu=1))


# the single-device memory levers: parsed, no longer refused
MEMORY_KNOBS = {
    "offload_optimizer_cpu": (
        {"zero_optimization": {"offload_optimizer": {"device": "cpu"}}},
        lambda c: (c.zero_config.offload_optimizer.device,
                   c.zero_config.offload_optimizer.pin_memory), ("cpu", False)),
    "grad_partition_groups": (
        {"zero_optimization": {"grad_partition_groups": 2}},
        lambda c: c.zero_config.grad_partition_groups, 2),
    "master_weights_in_bf16": (
        {"bf16": {"enabled": True, "master_weights_in_bf16": True}},
        lambda c: (c.bf16.enabled, c.bf16.master_weights_in_bf16),
        (True, True)),
    "grad_accum_dtype": (
        {"data_types": {"grad_accum_dtype": "bf16"}},
        lambda c: c.gradient_accumulation_dtype, "bf16"),
}


@pytest.mark.parametrize("name", sorted(MEMORY_KNOBS))
def test_single_device_memory_knobs_parse(name):
    knob, field, want = MEMORY_KNOBS[name]
    cfg = pconfig.DeepSpeedConfig(dict(knob, train_micro_batch_size_per_gpu=1))
    assert field(cfg) == want


def test_in_slice_config():
    cfg = pconfig.DeepSpeedConfig({
        "train_micro_batch_size_per_gpu": 2, "zero_optimization":
            {"stage": 3, "offload_optimizer": {"device": "none"}},
        "fp16": {"enabled": True, "loss_scale": 0, "hysteresis": 3},
        "gradient_clipping": 0.5, "steps_per_print": 7, "seed": 9,
        "unknown_block": {"x": 1}})
    assert cfg.zero_optimization_stage == 3 and cfg.seed == 9
    assert cfg.fp16.hysteresis == 3 and cfg.gradient_clipping == 0.5
    assert not cfg.fault.enabled and not cfg.nebula_config.enabled
    ckpt = pconfig.DeepSpeedConfig({
        "train_micro_batch_size_per_gpu": 1, "nebula": {"enabled": True},
        "fault": {"enabled": True, "checksum": "crc32", "keep_last_n": 2}})
    assert ckpt.nebula_config.enabled and ckpt.fault.keep_last_n == 2
    assert (ckpt.fault.checksum, ckpt.fault.verify_on_load) == ("crc32", True)
    with pytest.raises(ValueError, match="checksum"):
        pconfig.DeepSpeedConfig({"fault": {"checksum": "md5"}})
    with pytest.raises(ValueError, match="mics_shard_size"):
        pconfig.DeepSpeedConfig({"zero_optimization":
                                 {"zero_hpz_partition_size": 4}})


def test_dataloader_feeds_train_batch(jmodel_tree):
    """``training_data`` becomes the engine's loader (micro batches on the
    engine's device); ``train_batch(data_iter=...)`` over it equals
    ``train_batch(batch=...)`` on the same samples stacked."""
    _, tree = jmodel_tree
    rng = np.random.default_rng(12)
    data = [{"input_ids": rng.integers(0, 97, S).astype(np.int32)}
            for _ in range(9)]
    eng, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=pt.Transformer(pt.TransformerConfig(**dict(CFG, remat=False))),
        model_parameters=tree, config=ENGINE_CONFIG, training_data=data,
        device="cpu")
    assert loader is eng.training_dataloader and len(loader) == 9 // B
    first = next(iter(loader))["input_ids"]
    assert torch.is_tensor(first) and first.shape == (B, S)
    got = eng.train_batch(data_iter=iter(loader))
    stacked = np.stack([d["input_ids"] for d in data[:2 * B]])
    want = _port_engine(tree).train_batch(
        batch={"input_ids": stacked.reshape(2, B, S)})
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fp16_overflow_skips_the_step_branch_free():
    """fp16 with a dynamic scale so large that the gradients overflow: the
    step leaves parameters and moments as they were, counts one skipped
    step and halves the scale (hysteresis 1), with no host read of the
    flag until ``skipped_steps`` is asked for."""
    model = pt.Transformer(pt.TransformerConfig(
        **dict(CFG, dtype="float16", remat=False)))
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=model, device="cpu",
        config={"train_micro_batch_size_per_gpu": B,
                "fp16": {"enabled": True, "initial_scale_power": 40,
                         "hysteresis": 1},
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}}})
    before = {k: v.clone() for k, v in eng.module_state_dict().items()}
    loss = eng.train_batch(batch={"input_ids": _batch(5)["input_ids"][None]})
    assert torch.isfinite(loss)
    assert eng.global_steps == 1 and eng.skipped_steps == 1
    assert float(eng._scaler_state.scale) == 2.0 ** 39
    for name, w in eng.module_state_dict().items():
        torch.testing.assert_close(w, before[name], rtol=0, atol=0)
    assert all(not m.any() for m in eng._opt_state.exp_avg)


@pytest.mark.parametrize("group_numel", [1, 5000])
def test_fp16_skip_in_groups_equals_one_group(monkeypatch, group_numel):
    """The overflow skip runs the optimizer a group of parameters at a
    time (one tensor per group, or a few): with finite gradients the
    update equals the whole list's in one group bitwise, and an overflowed
    step still leaves every group as it was."""
    def train(numel, scale_power, steps):
        monkeypatch.setattr(peng, "SKIP_GROUP_NUMEL", numel)
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=pt.Transformer(pt.TransformerConfig(
                **dict(CFG, dtype="float16", remat=False))), device="cpu",
            config={"train_micro_batch_size_per_gpu": B,
                    "fp16": {"enabled": True,
                             "initial_scale_power": scale_power,
                             "hysteresis": 1},
                    "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}}})
        groups = len(peng._skip_groups(eng.params))
        start = {k: v.clone() for k, v in eng.module_state_dict().items()}
        for i in range(steps):
            eng.train_batch(batch={"input_ids": _batch(i)["input_ids"][None]})
        return eng, groups, start

    grouped, n_groups, _ = train(group_numel, 4, 2)
    whole, one, _ = train(1 << 40, 4, 2)
    assert n_groups > 1 and one == 1
    assert grouped.skipped_steps == whole.skipped_steps == 0
    for (name, w), (_, want) in zip(grouped.module_state_dict().items(),
                                    whole.module_state_dict().items()):
        torch.testing.assert_close(w, want, rtol=0, atol=0, msg=name)
    for got, want in zip(peng._state_tensors(grouped._opt_state),
                         peng._state_tensors(whole._opt_state)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    skipped, _, start = train(group_numel, 40, 1)
    assert skipped.skipped_steps == 1
    for name, w in skipped.module_state_dict().items():
        torch.testing.assert_close(w, start[name], rtol=0, atol=0)


def test_eval_mode_and_accessors(jmodel_tree, tmp_path):
    _, tree = jmodel_tree
    eng = _port_engine(tree)
    ids = _batch(6)["input_ids"]
    eng.eval()
    loss = eng(ids)
    assert not loss.requires_grad
    with pytest.raises(RuntimeError, match="eval mode"):
        eng.backward(loss)
    torch.testing.assert_close(eng.eval_batch(ids), loss, rtol=0, atol=0)
    eng.train()
    assert eng.get_lr() == [1e-3] and eng.get_global_grad_norm() is None
    assert (eng.train_batch_size(), eng.train_micro_batch_size_per_gpu(),
            eng.gradient_accumulation_steps()) == (2 * B, B, 2)
    assert eng.save_checkpoint(str(tmp_path)) is True
    assert (tmp_path / "latest").read_text() == "global_step0"
