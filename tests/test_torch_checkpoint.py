"""The port's checkpoints against its own unbroken runs and against the
JAX package's, on the CPU, on a tiny OPT (2 layers, hidden 64, 4 heads,
vocab 97).

- resume: save at step k, continue, resume in a fresh engine built from
  another seed: the losses, master parameters, optimizer moments, loss
  scaler, step counters and LR after the resume are bitwise the unbroken
  run's — AdamW + WarmupLR at gradient accumulation 2 in fp32, and fp16
  with a dynamic loss scale whose overflows (one before the save, one
  after) skip steps;
- JAX parity: the JAX engine (``fault`` on, Orbax) trains and saves; the
  tag, read on the JAX side and converted (``engine_state_from_flax``),
  goes into the port's engine, and both engines take 3 more steps:
  losses within 1e-5 relative (fp32 summation order), ``global_steps``
  and the LR equal; the load knobs ``load_module_only``,
  ``load_optimizer_states=False`` and ``load_lr_scheduler_states=False``
  leave the same state in both engines; ``zero_to_fp32`` of the JAX tag
  and of its port twin give the same keys and values (exactly);
- exports: ``save_16bit_model`` in both formats loads in both packages'
  ``InferenceEngine.load_checkpoint`` to the same greedy tokens (fp32
  compute over the bf16 weights), and the port's safetensors files and
  the ``safetensors`` package's read each other's bytes exactly; a file
  only full unpickling reads loads only when the environment allows it.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.parallel.topology import initialize_topology, reset_topology
from deepspeed_tpu.runtime.checkpoint_engine.checkpoint_engine import (
    OrbaxCheckpointEngine)

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint import safetensors_io
from deepspeed_tpu_torch.models import transformer as pt

CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, dtype="float32", use_flash_attention=True,
           tie_word_embeddings=True, activation="relu")
B, S, GAS = 2, 16, 2
LOSS_RTOL = 1e-5
CONFIG = {
    "train_micro_batch_size_per_gpu": B,
    "gradient_accumulation_steps": GAS,
    "optimizer": {"type": "AdamW",
                  "params": {"lr": 3e-3, "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_min_lr": 1e-3, "warmup_max_lr": 3e-3,
                             "warmup_num_steps": 4,
                             "warmup_type": "linear"}},
    "gradient_clipping": 1.0,
    "fault": {"enabled": True, "checksum": "crc32"},
}
# fp16 with a scale of 2^18 that doubles every 2 good steps: this data
# overflows at steps 5 and 8 (each skipped, the scale halved)
FP16_CONFIG = {
    "train_micro_batch_size_per_gpu": B,
    "gradient_accumulation_steps": GAS,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}},
    "fp16": {"enabled": True, "initial_scale_power": 18, "hysteresis": 1,
             "loss_scale_window": 2},
    "seed": 3,
}
# (config, model dtype, the step of the save, the last step)
RESUME_CASES = {"fp32_gas2_warmup": (CONFIG, "float32", 2, 5),
                "fp16_dynamic_scale": (FP16_CONFIG, "float16", 5, 8)}


def stacked(step):
    """The global batch of step ``step`` (1-based), a function of the step
    alone, as a resumed run must see it."""
    rng = np.random.default_rng(100 + step)
    return {"input_ids": rng.integers(0, 97, (GAS, B, S)).astype(np.int64)}


def port_engine(config=CONFIG, dtype="float32", seed=0, **model_over):
    model = pt.Transformer(pt.TransformerConfig(
        **{**CFG, "dtype": dtype, "remat": False, **model_over}))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=dict(config, seed=seed), device="cpu")
    return engine


def train(engine, last):
    return [float(engine.train_batch(batch=stacked(s)))
            for s in range(engine.global_steps + 1, last + 1)]


def state_of(engine):
    return ([p.clone() for p in engine.params],
            [t.clone() for field in engine._opt_state if field is not None
             for t in field],
            [t.clone() for t in engine._scaler_state])


def assert_same_tensors(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_port_resume_is_bitwise(case, tmp_path):
    config, dtype, k, last = RESUME_CASES[case]
    unbroken = port_engine(config, dtype, seed=1)
    train(unbroken, k)
    assert unbroken.save_checkpoint(str(tmp_path), client_state={"k": k})
    want = train(unbroken, last)
    resumed = port_engine(config, dtype, seed=2)
    assert not torch.equal(resumed.params[0], unbroken.params[0])
    path, client = resumed.load_checkpoint(str(tmp_path))
    assert client == {"k": k} and path.endswith(f"global_step{k}/state")
    assert resumed.global_steps == k and resumed.micro_steps == k * GAS
    got = train(resumed, last)
    assert got == want
    for a, b in zip(state_of(resumed), state_of(unbroken)):
        assert_same_tensors(a, b)
    assert resumed.global_steps == unbroken.global_steps == last
    assert resumed.global_samples == unbroken.global_samples
    assert resumed.get_lr() == unbroken.get_lr()
    assert resumed.skipped_steps == unbroken.skipped_steps
    if dtype == "float16":
        # one overflow before the save and one after it
        assert unbroken.skipped_steps == 2


# --------------------------------------------------------------------- #
# Against the JAX engine
# --------------------------------------------------------------------- #
def random_tree(jmodel, seed=0):
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


def jax_batch(step):
    return {"input_ids": stacked(step)["input_ids"].astype(np.int32)}


@pytest.fixture(scope="module")
def jax_tag(tmp_path_factory):
    """A JAX engine's tag after 2 steps, the JAX engine's losses of steps
    3-5 after it, and its LR then."""
    d = tmp_path_factory.mktemp("jax_ckpt")
    jmodel = jt.Transformer(jt.TransformerConfig(**CFG))
    tree = random_tree(jmodel)
    topo = initialize_topology(dp=1, devices=jax.devices()[:1])
    try:
        jeng, *_ = deepspeed_tpu.initialize(
            model=jmodel, model_parameters=tree, config=CONFIG,
            topology=topo)
        for s in (1, 2):
            jeng.train_batch(batch=jax_batch(s))
        jeng.save_checkpoint(str(d), client_state={"epoch": 1})
        losses = [float(jeng.train_batch(batch=jax_batch(s)))
                  for s in (3, 4, 5)]
        lr = jeng.get_lr()
    finally:
        reset_topology()
    return {"dir": d, "losses": losses, "lr": lr, "tree": tree,
            "jmodel": jmodel}


def read_jax_tag(d, tag="global_step2"):
    arrays, meta = OrbaxCheckpointEngine().load(
        os.path.join(str(d), tag, "state"))
    return jax.tree.map(np.asarray, arrays), meta


def port_from_jax(jax_tag, **knobs):
    arrays, meta = read_jax_tag(jax_tag["dir"])
    eng = port_engine(seed=5)
    state, meta = pt.engine_state_from_flax(arrays, meta, eng.module)
    client = eng.load_state(state, meta, **knobs)
    return eng, client


def test_jax_tag_continues_in_the_port(jax_tag, tmp_path):
    eng, client = port_from_jax(jax_tag)
    assert client == {"epoch": 1}
    assert eng.global_steps == 2 and eng.micro_steps == 2 * GAS
    got = [float(eng.train_batch(batch=stacked(s))) for s in (3, 4, 5)]
    np.testing.assert_allclose(got, jax_tag["losses"], rtol=LOSS_RTOL)
    assert eng.global_steps == 5
    assert eng.get_lr() == jax_tag["lr"]


def _knob_state(global_steps, lr, moments_zero, params_from_tag):
    return {"global_steps": global_steps, "lr": lr,
            "moments_zero": moments_zero,
            "params_from_tag": params_from_tag}


KNOBS = {"module_only": dict(load_module_only=True),
         "no_optimizer": dict(load_optimizer_states=False),
         "no_lr_scheduler": dict(load_lr_scheduler_states=False)}


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_load_knobs_match_jax(knob, jax_tag, tmp_path):
    """The same knob on a fresh engine of each package, loading the same
    state: the step counter, the LR, whether the moments stayed fresh and
    whether the weights came from the tag agree."""
    kw = KNOBS[knob]
    arrays, _ = read_jax_tag(jax_tag["dir"])
    tag_w = np.asarray(arrays["module"]["params"]["final_norm"]["scale"])
    topo = initialize_topology(dp=1, devices=jax.devices()[:1])
    try:
        jeng, *_ = deepspeed_tpu.initialize(
            model=jax_tag["jmodel"], model_parameters=jax_tag["tree"],
            config=CONFIG, topology=topo)
        jeng.load_checkpoint(str(jax_tag["dir"]), **kw)
        jp = jax.device_get(jeng.params)
        jopt = jax.device_get(jeng._opt_state)
        want = _knob_state(
            jeng.global_steps, jeng.get_lr(),
            all(not np.any(x) for x in jax.tree.leaves(jopt.exp_avg)),
            np.array_equal(np.asarray(jp["params"]["final_norm"]["scale"]),
                           tag_w))
    finally:
        reset_topology()
    eng, _ = port_from_jax(jax_tag, **kw)
    got = _knob_state(
        eng.global_steps, eng.get_lr(),
        all(not t.any() for t in eng._opt_state.exp_avg),
        np.array_equal(eng.module.final_norm.weight.detach().numpy(), tag_w))
    assert got == want


def test_zero_to_fp32_on_jax_tag_and_port_twin(jax_tag, tmp_path):
    from deepspeed_tpu.utils.zero_to_fp32 import (
        get_fp32_state_dict_from_zero_checkpoint as jax_fp32)
    from deepspeed_tpu_torch.utils import zero_to_fp32
    eng, _ = port_from_jax(jax_tag)
    eng.save_checkpoint(str(tmp_path))
    want = jax_fp32(str(jax_tag["dir"]))
    out = tmp_path / "fp32.pt"
    zero_to_fp32.main([str(tmp_path), str(out)])
    got = torch.load(out, weights_only=True)
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), w, err_msg=key)


# --------------------------------------------------------------------- #
# save_16bit_model in both directions
# --------------------------------------------------------------------- #
PROMPT = np.random.default_rng(7).integers(0, 97, (2, 9)).astype(np.int32)
NEW = 6


def port_tokens(path):
    eng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(pt.TransformerConfig(**CFG)), dtype="float32",
        device="cpu", config={"checkpoint": str(path)})
    return eng.generate(torch.from_numpy(PROMPT).long(),
                        max_new_tokens=NEW).numpy()


def jax_tokens(path):
    eng = deepspeed_tpu.init_inference(
        jt.Transformer(jt.TransformerConfig(**CFG)),
        config={"dtype": "float32", "checkpoint": str(path)})
    return np.asarray(eng.generate(jnp.asarray(PROMPT),
                                   max_new_tokens=NEW))


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_port_export_loads_in_jax(fmt, jax_tag, tmp_path):
    eng, _ = port_from_jax(jax_tag)
    name = f"model.{fmt}"
    assert eng.save_16bit_model(str(tmp_path), name)
    path = tmp_path / name
    got = port_tokens(path)
    np.testing.assert_array_equal(jax_tokens(path), got)
    np.testing.assert_array_equal(got[:, :PROMPT.shape[1]], PROMPT)
    if fmt == "safetensors":
        # the safetensors package reads the port's bytes
        from safetensors.numpy import load_file
        theirs = load_file(str(path))
        ours = safetensors_io.load_file(str(path))
        assert set(theirs) == set(ours)
        for k, v in ours.items():
            np.testing.assert_array_equal(
                v.float().numpy(), np.asarray(theirs[k], np.float32))
            assert str(theirs[k].dtype) == "bfloat16"


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_jax_export_loads_in_port(fmt, jax_tag, tmp_path):
    topo = initialize_topology(dp=1, devices=jax.devices()[:1])
    try:
        jeng, *_ = deepspeed_tpu.initialize(
            model=jax_tag["jmodel"], model_parameters=jax_tag["tree"],
            config=CONFIG, topology=topo)
        jeng.load_checkpoint(str(jax_tag["dir"]))
        jeng.save_16bit_model(str(tmp_path), f"model.{fmt}")
    finally:
        reset_topology()
    path = tmp_path / f"model.{fmt}"
    np.testing.assert_array_equal(port_tokens(path), jax_tokens(path))


def test_safetensors_bytes_both_ways(tmp_path):
    """Each of the port's reader / writer and the ``safetensors`` package
    reads the other's file back to the same tensors, every dtype the
    export can hold; a truncated file is refused."""
    from safetensors.torch import load_file, save_file
    rng = np.random.default_rng(3)
    tensors = {
        "b/w": torch.from_numpy(rng.standard_normal((3, 5)).astype(
            np.float32)).to(torch.bfloat16),
        "a": torch.from_numpy(rng.standard_normal(7).astype(np.float32)),
        "c/h": torch.from_numpy(rng.standard_normal((2, 2)).astype(
            np.float16)),
        "i": torch.arange(6, dtype=torch.int64).reshape(2, 3),
        "q": torch.from_numpy(rng.integers(-128, 127, (4,)).astype(np.int8)),
        "flag": torch.tensor([True, False]),
        "empty": torch.zeros((0, 3)),
    }
    ours, theirs = tmp_path / "ours.safetensors", tmp_path / "theirs.safetensors"
    safetensors_io.save_file(tensors, str(ours))
    save_file(tensors, str(theirs))
    for loaded in (load_file(str(ours)), safetensors_io.load_file(str(theirs)),
                   safetensors_io.load_file(str(ours))):
        assert set(loaded) == set(tensors)
        for k, t in tensors.items():
            assert loaded[k].dtype == t.dtype and torch.equal(loaded[k], t)
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(ours.read_bytes()[:-4])
    with pytest.raises(ValueError, match="offsets|truncated"):
        safetensors_io.load_file(str(bad))


def test_params_to_flax_inverts_params_from_flax():
    """Both layer layouts: the port's state dict → flax paths → back is
    the identity, and the flax side has the JAX model's shapes."""
    for scan in (True, False):
        cfg = pt.TransformerConfig(**dict(CFG, scan_layers=scan))
        jmodel = jt.Transformer(jt.TransformerConfig(
            **dict(CFG, scan_layers=scan)))
        tree = random_tree(jmodel, seed=4)
        sd = pt.params_from_flax(tree, cfg)
        flat = pt.params_to_flax(sd, cfg)
        want = {"/".join(str(k.key) for k in path[1:]): leaf.shape
                for path, leaf in
                jax.tree_util.tree_flatten_with_path(tree)[0]}
        assert {k: tuple(v.shape) for k, v in flat.items()} == want
        back = pt.params_from_flax({k: v.numpy() for k, v in flat.items()},
                                   cfg)
        for k, v in sd.items():
            assert torch.equal(back[k], v), k
        assert all(v.dtype == torch.bfloat16 for v in
                   pt.params_to_flax(sd, cfg, torch.bfloat16).values())


def test_pickled_tree_needs_opt_in_and_hf_keys_raise(tmp_path, monkeypatch):
    """A file that only full unpickling reads (a pickled flax tree) loads
    with ``DSTPU_ALLOW_PICKLE_CHECKPOINTS=1`` alone, to the weights the
    tree holds; an export with HF-named keys is refused."""
    import pickle
    tree = random_tree(jt.Transformer(jt.TransformerConfig(**CFG)), seed=9)
    path = tmp_path / "tree.pkl"
    path.write_bytes(pickle.dumps(jax.tree.map(np.asarray, tree)))
    eng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(pt.TransformerConfig(**CFG)), dtype="float32",
        device="cpu")
    monkeypatch.delenv("DSTPU_ALLOW_PICKLE_CHECKPOINTS", raising=False)
    with pytest.raises(ValueError, match="DSTPU_ALLOW_PICKLE_CHECKPOINTS"):
        eng.load_checkpoint(str(path))
    monkeypatch.setenv("DSTPU_ALLOW_PICKLE_CHECKPOINTS", "1")
    eng.load_checkpoint(str(path))
    want = pt.params_from_flax(tree, pt.TransformerConfig(**CFG))
    for name, w in eng.module.state_dict().items():
        assert torch.equal(w, want[name]), name
    hf = tmp_path / "hf.safetensors"
    safetensors_io.save_file({"model.decoder.embed_tokens.weight":
                              torch.zeros(97, 64)}, str(hf))
    with pytest.raises(ValueError, match="HF-named keys"):
        eng.load_checkpoint(str(hf))
