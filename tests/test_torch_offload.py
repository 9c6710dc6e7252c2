"""ZeRO-Offload in the port against the JAX package, on the CPU.

The JAX package's own offload scenarios (``tests/unit/test_offload.py``)
run on the port, with a tiny OPT (2 layers, hidden 64) in place of the
flax ``SimpleModel``:

- the aio round trip, the tensor swapper, the optimizer swapper (and the
  parameter swapper, which no engine path uses);
- training with ``offload_optimizer`` on ``cpu`` and ``nvme`` (swap files
  written; bf16 parameters on the device, fp32 masters on the host), the
  pipelined disk tier equal to the sequential one (bitwise: the same
  arithmetic in the same order), the host Adam against the device AdamW
  (JAX's bar: rtol 0.1, atol 0.05 — bf16 forward, and the two round their
  denominators differently);
- the checkpoint round trip of the host state, re-seeding the masters on a
  load without optimizer states and on ``load_params`` (cpu and nvme),
  and a fresh engine restoring the moments; a crash-atomic tag lists the
  host state in its manifest;
- the overflow skip (norm ``inf``, masters untouched) and the refusal of a
  non-Adam optimizer, as in the JAX engine.

Against the JAX package's code on the same inputs:

- ``HostOffloadedAdam.step`` fed the same host gradients as JAX's, on
  ``cpu``, ``nvme`` and ``nvme`` with ``pipeline_read``: masters, moments
  and the bf16 upload bits **bitwise** (the same C++ kernel and order);
- an offload engine against JAX's offload engine on converted tiny OPT and
  Llama (llama-tiny, 2 layers, vocabulary 1024) weights (AdamW, gas 2, fp32 accumulation; no clipping, which
  raises in the JAX offload step), losses
  over 4 steps: fp32 compute within 1e-5 relative and the host masters
  within 1e-4 (``attn.k_proj.bias`` apart, whose true gradient is 0, and
  1 element in 10^4 within Adam's largest move); bf16 compute within 2e-2 relative (bf16 activations); then
  the JAX engine's host state carried into a port engine
  (``engine_state_from_flax`` with ``host_optimizer``) continues the JAX
  trajectory over 2 more steps at the same bars.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.models import opt as jopt
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.parallel.topology import initialize_topology, reset_topology
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime.zero.offload import HostOffloadedAdam as JHost

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import opt as popt
from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.runtime import config as pconfig
from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadedAdam

CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, ffn_hidden_size=128, remat=False)
B, S = 2, 16


def tiny(dtype="bfloat16"):
    return pt.Transformer(pt.TransformerConfig(**CFG, dtype=dtype))


def offload_config(device, nvme_path=None, **extra):
    off = {"device": device, **extra}
    if nvme_path:
        off["nvme_path"] = str(nvme_path)
    return {
        "train_micro_batch_size_per_gpu": B,
        "gradient_accumulation_steps": 1,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}},
        "bf16": {"enabled": True},
        "zero_optimization": {"stage": 2, "offload_optimizer": off},
    }


def engine(config, dtype="bfloat16", seed=0):
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tiny(dtype), config=dict(config, seed=seed), device="cpu")
    return eng


def batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": torch.from_numpy(
        rng.integers(0, CFG["vocab_size"], (B, S)))}


def train(eng, steps, seed=0):
    """The 3-call sequence on one fixed batch (memorization makes the
    falling loss deterministic), as the JAX scenarios train."""
    losses = []
    for _ in range(steps):
        loss = eng(batch(seed))
        eng.backward(loss)
        eng.step()
        losses.append(float(loss.detach()))
    return losses


# --------------------------------------------------------------------- #
# aio and the swappers
# --------------------------------------------------------------------- #
def test_aio_roundtrip(tmp_path):
    from deepspeed_tpu_torch.ops.aio import AsyncIOHandle
    h = AsyncIOHandle(block_size=1 << 16, thread_count=2)
    buf = torch.from_numpy(np.random.default_rng(0).standard_normal(
        100_000).astype(np.float32))
    path = str(tmp_path / "t.bin")
    h.async_pwrite(buf, path)
    h.wait()
    rd = torch.empty_like(buf)
    h.async_pread(rd, path)
    h.wait()
    assert torch.equal(buf, rd)
    h.sync_pwrite(buf[:777], path)
    small = torch.empty(777)
    h.sync_pread(small, path)
    assert torch.equal(small, buf[:777])
    with pytest.raises(IOError):
        h.sync_pread(torch.empty(1000), path)       # the file is shorter
    assert h.num_threads == 2 and h.block_size == 1 << 16


def test_async_tensor_swapper(tmp_path):
    from deepspeed_tpu_torch.runtime.swap_tensor import AsyncTensorSwapper
    sw = AsyncTensorSwapper(str(tmp_path), buffer_count=2, thread_count=2)
    a = torch.arange(1000, dtype=torch.float32)
    b = torch.arange(2000, dtype=torch.float32) * 2
    c = torch.arange(500, dtype=torch.float32) - 7   # the pool is full
    for key, t in (("a", a), ("b", b), ("c", c)):
        sw.swap_out(key, t)
    sw.synchronize_writes()
    assert torch.equal(sw.swap_in("a", 1000), a)
    assert torch.equal(sw.swap_in("b", 2000), b)
    buf = sw.start_swap_in("c", 500)
    sw.finish_swap_ins()
    assert torch.equal(buf.view(500), c)


def test_optimizer_swapper(tmp_path):
    from deepspeed_tpu_torch.runtime.swap_tensor import OptimizerSwapper
    sw = OptimizerSwapper(str(tmp_path), pipeline_write=True)
    n = 777
    m = torch.from_numpy(np.random.default_rng(0).standard_normal(
        n).astype(np.float32))
    a, v = torch.ones(n), torch.full((n,), 2.0)
    sw.register("w", n, m, a, v)
    mo, ao, vo = (torch.empty(n) for _ in range(3))
    sw.swap_in("w", mo, ao, vo)
    assert torch.equal(mo, m) and torch.equal(ao, a) and torch.equal(vo, v)
    sw.swap_out("w", m * 3, a, v)
    sw.drain()
    sw.swap_in("w", mo, ao, vo)
    assert torch.equal(mo, m * 3)
    sw.update_master("w", m)
    sw.drain()
    sw.start_swap_in("w", (mo, ao, vo))
    sw.finish_swap_ins()
    assert torch.equal(mo, m) and torch.equal(ao, a)
    assert len(sw.state_files()["w"]) == 3


def test_partitioned_parameter_swapper(tmp_path):
    from deepspeed_tpu_torch.runtime.swap_tensor import \
        PartitionedParameterSwapper
    sw = PartitionedParameterSwapper(str(tmp_path))
    w = torch.randn(5, 7).to(torch.bfloat16)
    i = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    sw.swap_out_param("w", w)
    sw.swap_out_param("i", i)
    sw.synchronize()
    assert torch.equal(sw.swap_in_param("w"), w)
    assert torch.equal(sw.swap_in_param("i"), i)
    assert sw.available_params() == {"w", "i"}


# --------------------------------------------------------------------- #
# The engine with an offloaded optimizer
# --------------------------------------------------------------------- #
def test_offload_cpu_trains():
    eng = engine(offload_config("cpu"))
    losses = train(eng, 8)
    assert losses[-1] < losses[0], losses
    # the device keeps the compute dtype (the saving), the host fp32
    assert all(p.dtype == torch.bfloat16 for p in eng.params)
    assert all(m.dtype == torch.float32 for m in eng._host_opt.masters)
    assert eng._opt_state is None
    assert set(eng.offload_stats) >= {"d2h_s", "host_adam_s", "h2d_s"}


def test_offload_nvme_trains(tmp_path):
    eng = engine(offload_config("nvme", tmp_path))
    losses = train(eng, 6)
    assert losses[-1] < losses[0], losses
    files = [f for _, _, fs in os.walk(tmp_path) for f in fs]
    assert files, "no swap files written under nvme_path"
    assert all(os.path.commonpath([eng._host_opt._swap_dir, str(tmp_path)])
               == str(tmp_path) for _ in files)


def test_offload_nvme_pipelined(tmp_path):
    piped = engine(offload_config("nvme", tmp_path / "a", pipeline_read=True,
                                  pipeline_write=True))
    plain = engine(offload_config("nvme", tmp_path / "b"))
    a, b = train(piped, 6), train(plain, 6)
    assert a[-1] < a[0], a
    assert a == b
    for x, y in zip(piped._host_opt.master_params(),
                    plain._host_opt.master_params()):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_offload_matches_device_adamw(dtype):
    """The host C++ AdamW and the device AdamW walk the same trajectory:
    with fp32 compute within 1e-4 (only the denominators' rounding
    differs); with the bf16 forward at JAX's bar (rtol 0.1, atol 0.05) but
    for at most 1 element in 10^3, which stays within Adam's largest move
    over the run (2 · lr · steps): a gradient component that is roundoff
    takes the sign the bf16 forward gives it."""
    dev = engine({"train_micro_batch_size_per_gpu": B,
                  "gradient_clipping": 1.0,
                  "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}}},
                 dtype="float32")
    train(dev, 4, seed=7)
    cfg = dict(offload_config("cpu"), gradient_clipping=1.0)
    cfg["bf16"] = {"enabled": dtype == "bfloat16"}
    off = engine(cfg, dtype=dtype)
    train(off, 4, seed=7)
    got = off._host_opt.master_params()
    names = [n for n, _ in dev.module.named_parameters()]
    for name, r, g in zip(names, dev.params, got):
        r = r.detach()
        if name.endswith("attn.k_proj.bias"):
            # its true gradient is 0 (softmax ignores a key bias), so both
            # gradients are roundoff: nothing to compare
            continue
        if dtype == "float32":
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
            continue
        off_bar = (g - r).abs() > 0.05 + 0.1 * r.abs()
        assert int(off_bar.sum()) <= max(1, r.numel() // 1000)
        assert float((g - r).abs().max()) <= 2 * 1e-2 * 4


def test_offload_checkpoint_roundtrip(tmp_path):
    eng = engine(offload_config("cpu"))
    train(eng, 3)
    eng.save_checkpoint(str(tmp_path / "ckpt"))
    assert os.path.isfile(tmp_path / "ckpt" / "global_step3" /
                          "host_optimizer" / "leaf0.exp_avg.npy")
    step_before = eng._host_opt.step_count
    masters_before = [m.clone() for m in eng._host_opt.masters]
    params_before = [p.detach().clone() for p in eng.params]
    train(eng, 2)
    eng.load_checkpoint(str(tmp_path / "ckpt"))
    assert eng._host_opt.step_count == step_before
    for a, b in zip(eng._host_opt.masters, masters_before):
        assert torch.equal(a, b)
    for a, b in zip(eng.params, params_before):
        assert torch.equal(a, b)


def test_offload_load_without_opt_states_reseeds_masters(tmp_path):
    """A load without the host state re-seeds the fp32 masters from the
    loaded parameters; else the next step would run Adam on stale masters
    and overwrite the checkpoint's weights."""
    eng = engine(offload_config("cpu"))
    train(eng, 3)
    eng.save_checkpoint(str(tmp_path / "ckpt"))
    trained = [p.detach().float().reshape(-1).clone() for p in eng.params]
    train(eng, 2)
    eng.load_checkpoint(str(tmp_path / "ckpt"), load_optimizer_states=False)
    for m, p in zip(eng._host_opt.masters, trained):
        assert torch.equal(m, p)               # the bf16 values, widened
    assert np.isfinite(train(eng, 1)[-1])


@pytest.mark.parametrize("device", ["cpu", "nvme"])
def test_offload_load_params_reseeds_host_masters(device, tmp_path):
    """Surgery + ``load_params`` under offload: the host masters are
    authoritative, so they are re-seeded (values only: moments and step
    survive), or the next step reverts the surgery."""
    eng = engine(offload_config(device, tmp_path if device == "nvme"
                                else None))
    train(eng, 2)
    step_before = eng._host_opt.step_count
    moments = [t.clone() for t in eng._host_opt.state_dict()["exp_avg"]]
    sd = {k: v.detach().float().clone()
          for k, v in eng.module_state_dict().items()}
    name = "layers.0.mlp.up_proj.weight"
    sd[name][:] = 0.125
    eng.load_params(sd)
    host = eng._host_opt.state_dict()
    assert eng._host_opt.step_count == step_before
    for a, b in zip(host["exp_avg"], moments):
        assert torch.equal(a, b)
    train(eng, 1, seed=50)
    got = eng.module_state_dict()[name].float()
    # Adam at lr 1e-2 moves a weight by about lr a step: the surgery holds
    assert bool(((got - 0.125).abs() < 0.05).all()), got


def test_offload_fresh_engine_load_restores_moments(tmp_path):
    ck = tmp_path / "ck"
    eng = engine(offload_config("cpu"))
    train(eng, 4)
    eng.save_checkpoint(str(ck))
    want_m = [m.clone() for m in eng._host_opt.cpu_opt.exp_avg]
    fresh = engine(offload_config("cpu"), seed=9)
    fresh.load_checkpoint(str(ck))
    assert fresh._host_opt.step_count == eng._host_opt.step_count
    assert any(float(m.abs().max()) > 0 for m in fresh._host_opt.cpu_opt.
               exp_avg), "moments zeroed"
    for a, b in zip(want_m, fresh._host_opt.cpu_opt.exp_avg):
        assert torch.equal(a, b)
    # both continue alike
    assert train(fresh, 2, seed=3) == train(eng, 2, seed=3)


def test_offload_atomic_checkpoint_lists_host_state(tmp_path):
    from deepspeed_tpu_torch.runtime.fault.manifest import read_manifest
    cfg = dict(offload_config("nvme", tmp_path / "swap"),
               fault={"enabled": True})
    eng = engine(cfg)
    train(eng, 2)
    eng.save_checkpoint(str(tmp_path / "ck"))
    man = read_manifest(str(tmp_path / "ck" / "global_step2"))
    assert any("host_optimizer/leaf0.master.npy" in f for f in man["files"])
    want = eng._host_opt.state_dict()
    train(eng, 1)
    eng.load_checkpoint(str(tmp_path / "ck"))
    got = eng._host_opt.state_dict()
    assert got["step"] == want["step"] == 2
    for key in ("masters", "exp_avg", "exp_avg_sq"):
        for a, b in zip(got[key], want[key]):
            assert torch.equal(a, b)


def test_offload_overflow_skips_the_step():
    eng = engine(offload_config("cpu"))
    train(eng, 1)
    masters = [m.clone() for m in eng._host_opt.masters]
    loss = eng(batch())
    eng.backward(loss)
    eng._found_inf = torch.tensor(True)       # as an fp16 overflow sets it
    eng.step()
    assert eng.get_global_grad_norm() == float("inf")
    assert eng.skipped_steps == 1 and eng.global_steps == 2
    for a, b in zip(eng._host_opt.masters, masters):
        assert torch.equal(a, b)


def test_offload_refuses_a_non_adam_optimizer():
    cfg = offload_config("cpu")
    cfg["optimizer"] = {"type": "SGD", "params": {"lr": 1e-2}}
    with pytest.raises(ValueError, match="Adam-family"):
        engine(cfg)


def test_offload_config_parses():
    cfg = pconfig.DeepSpeedConfig(offload_config(
        "nvme", "/x", buffer_count=6, pin_memory=True, pipeline_read=True,
        pipeline_write=True, fast_init=True))
    off = cfg.zero_config.offload_optimizer
    assert (off.device, off.nvme_path, off.buffer_count, off.pin_memory,
            off.pipeline_read, off.pipeline_write, off.fast_init) == \
        ("nvme", "/x", 6, True, True, True, True)


# --------------------------------------------------------------------- #
# Against the JAX package's code
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("device,piped", [("cpu", False), ("nvme", False),
                                          ("nvme", True)],
                         ids=["cpu", "nvme", "nvme-pipelined"])
def test_host_offloaded_adam_step_bitwise_jax(device, piped, tmp_path):
    shapes = [(33, 5), (64,), (3, 4, 2), (129,)]
    rng = np.random.default_rng(1)
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    kw = dict(lr=1e-2, weight_decay=0.01)
    jcfg = jconfig.DeepSpeedZeroOffloadOptimizerConfig(
        device=device, nvme_path=str(tmp_path / "j"), pipeline_read=piped)
    pcfg = pconfig.OffloadOptimizerConfig(
        device=device, nvme_path=str(tmp_path / "p"), pipeline_read=piped)
    jh = JHost([jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes], jcfg,
               **kw)
    jh.init_from_params([jnp.asarray(p) for p in params])
    ph = HostOffloadedAdam([torch.from_numpy(p) for p in params], pcfg,
                           **kw)
    ph.init_from_params([torch.from_numpy(p.copy()) for p in params])
    for step in range(3):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        jout = jh.step([g.copy() for g in grads], lr=2e-2)
        pout = ph.step([torch.from_numpy(g) for g in grads], lr=2e-2)
        for a, b in zip(pout, jout):
            assert np.array_equal(a.numpy(), b)
    jsd, psd = jh.state_dict(), ph.state_dict()
    assert jsd["step"] == psd["step"] == 3
    for key in ("masters", "exp_avg", "exp_avg_sq"):
        for a, b in zip(psd[key], jsd[key]):
            assert np.array_equal(a.numpy(), b)


def random_tree(jmodel, seed=0):
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
        return 0.1 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


FAMILIES = {
    "opt": (lambda **kw: jt.Transformer(jt.TransformerConfig(**CFG, **kw)),
            lambda **kw: pt.Transformer(pt.TransformerConfig(**CFG, **kw))),
    # llama-tiny cut to 2 layers and a vocabulary of 1024
    "llama": (lambda **kw: jopt.llama_model("llama-tiny", num_layers=2,
                                            vocab_size=1024, remat=False,
                                            **kw),
              lambda **kw: popt.llama_model("llama-tiny", num_layers=2,
                                            vocab_size=1024, remat=False,
                                            **kw)),
}
PARITY = {"float32": dict(loss=1e-5, masters=1e-4),
          "bfloat16": dict(loss=2e-2, masters=None)}


def parity_config(dtype):
    # no clipping: the JAX _offload_step multiplies the clip factor into
    # read-only device_get arrays and raises (ROADMAP.md, queue C); the
    # port's host clip is held against its device clip above
    return {"train_micro_batch_size_per_gpu": B,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 3e-3, "weight_decay": 0.01}},
            "bf16": {"enabled": dtype == "bfloat16"},
            "zero_optimization": {"offload_optimizer": {"device": "cpu"}}}


def parity_batches(vocab, n, seed=4):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (2, B, S)).astype(np.int32)}
            for _ in range(n)]


def assert_masters_close(name, got, want, tol):
    """Within ``tol`` but for at most 1 element in 10^4, which stays within
    Adam's largest move over the run (2 · lr · steps): an embedding element
    whose gradient cancels to roundoff in both packages takes lr-sized
    steps of either sign."""
    diff = (got - want).abs()
    assert int((diff > tol + tol * want.abs()).sum()) <= \
        max(1, want.numel() // 10_000), (name, float(diff.max()))
    assert float(diff.max()) <= 2 * 3e-3 * 4, (name, float(diff.max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_offload_engine_matches_jax(family, dtype):
    jbuild, pbuild = FAMILIES[family]
    over = dict(dtype=dtype, scan_layers=False)
    jmodel = jbuild(**over)
    tree = random_tree(jmodel)
    vocab = jmodel.config.vocab_size
    data = parity_batches(vocab, 6)
    topo = initialize_topology(dp=1, devices=jax.devices()[:1])
    try:
        jeng, *_ = deepspeed_tpu.initialize(
            model=jmodel, model_parameters=tree, config=parity_config(dtype),
            topology=topo)
        want = [float(jeng.train_batch(batch=b)) for b in data[:4]]
        jhost = jeng._host_opt.state_dict()
        jmasters = jeng._host_opt.master_params_tree()
        # copies: on the CPU the fp32 upload may alias the host masters
        jparams = jax.tree.map(np.array, jax.device_get(jeng.params))
        jscaler = jax.device_get(jeng._scaler_state)
        unflat = jeng._host_opt.treedef.unflatten
        carried = {"step": jhost["step"], **{
            # copies: the JAX host state is the live arrays its next
            # steps update in place
            k: unflat([a.reshape(s).copy() for a, s in zip(
                jhost[k], jeng._host_opt.shapes)])
            for k in ("masters", "exp_avg", "exp_avg_sq")}}
        want_more = [float(jeng.train_batch(batch=b)) for b in data[4:]]
    finally:
        reset_topology()
    tol = PARITY[dtype]
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=pbuild(**over), model_parameters=tree,
        config=parity_config(dtype), device="cpu")
    got = [float(eng.train_batch(batch=b)) for b in data[:4]]
    np.testing.assert_allclose(got, want, rtol=tol["loss"])
    if tol["masters"] is not None:
        want_m = pt.params_from_flax(jmasters, eng.module.config)
        names = [n for n, p in eng.module.named_parameters()]
        for name, m in zip(names, eng._host_opt.master_params()):
            if name.endswith("attn.k_proj.bias"):
                continue           # roundoff gradients (see above)
            assert_masters_close(name, m, want_m[name], tol["masters"])

    # the JAX engine's state, host optimizer included, carried over
    fresh, *_ = deepspeed_tpu_torch.initialize(
        model=pbuild(**over), config=parity_config(dtype), device="cpu")
    arrays, meta = pt.engine_state_from_flax(
        {"module": jparams, "optimizer": None, "host_optimizer": carried,
         "loss_scaler": jscaler},
        {"global_steps": 4, "micro_steps": 8}, fresh.module)
    fresh.load_state(arrays, meta)
    assert fresh._host_opt.step_count == 4
    more = [float(fresh.train_batch(batch=b)) for b in data[4:]]
    np.testing.assert_allclose(more, want_more, rtol=tol["loss"])
