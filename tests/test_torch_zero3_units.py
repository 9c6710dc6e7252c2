"""The ZeRO-3 slice's pieces that need no group of processes, against the
JAX package on the same inputs, and stage 3 over a gloo group of one
(a group in this process, destroyed after):

- a group of one at stage 3 (every leaf its own whole shard, so every
  gather and reduce-scatter runs, as identities) is **bitwise** the engine
  without a group: fp32 and bf16 at gas 2 with clipping, remat with the
  chunked loss, the offload, and the lean levers (bf16 masters and
  moments, bf16 accumulation); the hooks count each unit's gathers;
- MiCS's topology split and the shard size that does not divide, with
  JAX's ``initialize_topology`` errors; the config at dp > 1 (stage 3,
  MiCS, the offload taken; ``grad_partition_groups`` refused) and the
  ``stage3_*`` knobs parsed as in JAX;
- ``wall_clock_breakdown``: the forward / backward / step timers logged
  every ``steps_per_print`` steps; without it a step makes no call to
  ``torch.cuda.synchronize`` (patched and counted) — and a card timer
  syncs at each start and stop;
- ``zero3_linear_wrap`` / ``LinearModuleForZeroStage3``, ``TiledLinear``
  (with ``full_weight`` and ``TiledLinearReturnBias``) and the contiguous
  allocator against their JAX counterparts (``tests/unit/
  test_coalesced_zero_linear.py:52``, ``test_ops_models_parity.py``):
  fp32 outputs and gradients at 1e-5, the allocator's offsets exactly;
- ``OnDevice``: a module built on ``meta`` in the context's dtype.
"""

import os
import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu_torch
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.runtime import config as pconfig
from deepspeed_tpu_torch.runtime.zero import Init

CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, dtype="float32", use_flash_attention=True,
           tie_word_embeddings=True, activation="relu", remat=False)
# (dtype, remat policy with the chunked loss or None, offload, lean: bf16
# masters and moments with bf16 accumulation)
VARIANTS = [("float32", None, False, False), ("bfloat16", None, False, False),
            ("bfloat16", "nothing_saveable", False, False),
            ("float32", None, True, False), ("bfloat16", None, False, True)]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(variant, stage=None, steps=3):
    dtype, policy, offload, lean = variant
    cfg = dict(CFG, dtype=dtype)
    if policy is not None:
        cfg.update(remat=True, remat_policy=policy, loss_seq_chunks=4)
    config = {"train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": 2, "seed": 3,
              "optimizer": {"type": "AdamW", "params": {
                  "lr": 3e-3, "weight_decay": 0.01}},
              "gradient_clipping": 0.0 if offload else 1.0}
    if stage is not None:
        config["zero_optimization"] = {"stage": stage}
    if offload:
        config.setdefault("zero_optimization", {})["offload_optimizer"] = {
            "device": "cpu"}
    if dtype == "bfloat16":
        config["bf16"] = {"enabled": True, "master_weights_in_bf16": lean}
    if lean:
        config["data_types"] = {"grad_accum_dtype": "bf16"}
        config["optimizer"]["params"]["state_dtype"] = "bfloat16"
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=pt.Transformer(pt.TransformerConfig(**cfg)), config=config,
        device="cpu")
    rng = np.random.default_rng(4)
    losses = [eng.train_batch(batch={"input_ids": rng.integers(
        0, 97, (2, 2, 16)).astype(np.int32)}) for _ in range(steps)]
    return losses, eng


@pytest.fixture(scope="module")
def world_one():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    want = {v: _run(v) for v in VARIANTS}
    os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    comm.init_distributed(device="cpu")
    try:
        got = {v: _run(v, 3) for v in VARIANTS}
        # zero.Init over one rank: the whole tensors come back
        init = Init().materialize(lambda: {"w": torch.ones(4, 6)})
    finally:
        torch.set_num_threads(threads)
        comm.destroy_process_group()
        for var in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR",
                    "MASTER_PORT"):
            os.environ.pop(var, None)
    return want, got, init


@pytest.mark.parametrize("variant", VARIANTS, ids=str)
def test_group_of_one_stage3_is_bitwise_no_group(world_one, variant):
    want, got, _ = world_one
    (wl, we), (gl, ge) = want[variant], got[variant]
    assert ge._dp and ge._stage3 and not we._dp
    assert all(m is not None for m in ge._masters)
    for a, b in zip(gl, wl):
        assert torch.equal(a, b)
    assert float(ge.get_global_grad_norm()) == \
        float(we.get_global_grad_norm())
    for (name, a), b in zip(ge.module_state_dict().items(),
                            we.module_state_dict().values()):
        assert torch.equal(a, b), name
    if variant[2]:
        for a, b in zip(ge._host_opt.state_dict()["exp_avg"],
                        we._host_opt.state_dict()["exp_avg"]):
            assert torch.equal(a, b)
    else:
        for fa, fb in zip(ge._opt_state, we._opt_state):
            for a, b in zip(fa, fb):
                assert torch.equal(a.view(b.shape), b)
    # 5 units (embed, 2 blocks, norm, head) at 2 micro steps x 3 steps
    st = ge._coord.stats
    assert st["units_gathered_forward"] == 5 * 6
    assert st["units_reduced"] == 5 * 6
    # at rest no sharded parameter holds storage
    assert all(p.numel() == 0 for p in ge.params)


def test_zero_init_over_one_rank_is_whole(world_one):
    *_, init = world_one
    assert torch.equal(init["w"], torch.ones(4, 6))


def test_mics_topology_split_and_invalid_size():
    from deepspeed_tpu.parallel import topology as jtopo
    from deepspeed_tpu_torch.parallel import topology as ptopo
    t = ptopo.initialize_topology(dp=8, mics=2, world_size=8)
    try:
        assert (t.mdp, t.edp, t.dp) == (4, 2, 8)
        assert t.get_zero_shard_axes() == ("edp",)
        assert t.get_zero_shard_world_size() == 2
        # the shard groups are consecutive ranks, the replica groups stride
        assert t.group_ranks(("edp",))[:2] == [[0, 1], [2, 3]]
        assert t.group_ranks(("mdp",))[0] == [0, 2, 4, 6]
        assert [t.get_zero_shard_rank(r) for r in range(8)] == \
            [0, 1] * 4
        with pytest.raises(ValueError) as got:
            ptopo.initialize_topology(dp=8, mics=3, world_size=8)
        with pytest.raises(ValueError) as want:
            jtopo.initialize_topology(dp=8, mics=3,
                                      devices=jax.devices()[:8])
        assert str(got.value) == str(want.value)
    finally:
        ptopo.reset_topology()
        jtopo.reset_topology()


def test_config_at_dp_takes_zero3_mics_offload():
    from deepspeed_tpu.runtime import config as jconfig
    zero = {"stage": 3, "mics_shard_size": 2,
            "offload_optimizer": {"device": "cpu"},
            "stage3_max_live_parameters": 7,
            "stage3_param_persistence_threshold": 10,
            "stage3_gather_16bit_weights_on_model_save": True}
    cfg = {"train_micro_batch_size_per_gpu": 1, "zero_optimization": zero}
    got = pconfig.DeepSpeedConfig(dict(cfg), mesh_world_size=4).zero_config
    want = jconfig.DeepSpeedConfig(dict(cfg), mesh_world_size=4).zero_config
    for key in ("stage", "mics_shard_size", "stage3_max_live_parameters",
                "stage3_max_reuse_distance", "stage3_prefetch_bucket_size",
                "stage3_param_persistence_threshold",
                "stage3_gather_16bit_weights_on_model_save"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.offload_optimizer.device == "cpu"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pconfig.DeepSpeedConfig(
            {"train_micro_batch_size_per_gpu": 1,
             "zero_optimization": {"stage": 3, "grad_partition_groups": 2}},
            mesh_world_size=2)


def test_wall_clock_breakdown_logs_and_costs_nothing_off(monkeypatch):
    from deepspeed_tpu_torch.runtime import engine as engine_mod
    calls, lines = [], []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(a))
    monkeypatch.setattr(engine_mod, "log_dist", lambda *a, **k: None)
    import deepspeed_tpu_torch.utils.timer as timer_mod
    monkeypatch.setattr(timer_mod, "log_dist",
                        lambda msg, **k: lines.append(msg))

    def run(on):
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=pt.Transformer(pt.TransformerConfig(**CFG)), device="cpu",
            config={"train_micro_batch_size_per_gpu": 2,
                    "steps_per_print": 2, "wall_clock_breakdown": on,
                    "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}})
        batch = {"input_ids": np.ones((1, 2, 8), np.int32)}
        for _ in range(4):
            eng.train_batch(batch=batch)
        return eng

    def timer_lines():
        return [m for m in lines if m.startswith("time (ms)")]

    eng = run(False)
    assert calls == [] and timer_lines() == []
    # the throughput timer runs always, and never syncs
    assert eng.tput_timer.global_step_count == 4
    run(True)
    # logged at steps 2 and 4; the CPU's timers wait for nothing
    lines = timer_lines()
    assert len(lines) == 2 and calls == []
    assert all(line.startswith("time (ms) | fwd: ") and "| bwd: " in line
               and "| step: " in line for line in lines)
    # a card's timer synchronizes at each start and stop
    t = timer_mod.SynchronizedWallClockTimer("cuda")("fwd")
    t.start()
    t.stop()
    assert len(calls) == 2


def test_zero3_linear_matches_jax():
    from deepspeed_tpu.runtime.zero.linear import (
        LinearModuleForZeroStage3 as JLinear, zero3_linear_wrap as jwrap)
    from deepspeed_tpu_torch.runtime.zero.linear import (
        LinearModuleForZeroStage3, zero3_linear_wrap)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 8)).astype(np.float32)
    w = rng.standard_normal((5, 8)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)

    def jloss(x, w, b):
        return jnp.sum(jwrap(x, w, b) ** 2)

    jy = jwrap(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                             jnp.asarray(b))
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    y = zero3_linear_wrap(tx, tw, tb)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    for got, want in zip((tx.grad, tw.grad, tb.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    # bf16 input: one rounding of the fp32 result, as JAX's
    xb = torch.tensor(x).to(torch.bfloat16)
    yb = zero3_linear_wrap(xb, torch.tensor(w).to(torch.bfloat16),
                           torch.tensor(b))
    jyb = jwrap(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                jnp.asarray(b))
    assert yb.dtype == torch.bfloat16
    np.testing.assert_array_equal(yb.float().numpy(),
                                  np.asarray(jyb, np.float32))
    # the module: torch's [out, in] layout, JAX's weights carried over
    jm = JLinear(in_features=8, out_features=5)
    params = jm.init(jax.random.key(0), jnp.asarray(x))
    m = LinearModuleForZeroStage3(8, 5)
    m.load_state_dict({k: torch.tensor(np.asarray(v))
                       for k, v in params["params"].items()})
    np.testing.assert_allclose(m(torch.tensor(x)).detach().numpy(),
                               np.asarray(jm.apply(params, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def _tiled_from_jax(cls_j, cls_p, **kw):
    x = np.random.default_rng(0).standard_normal((4, kw["in_features"]))
    x = x.astype(np.float32)
    jt = cls_j(**kw)
    params = jt.init(jax.random.key(0), jnp.asarray(x))["params"]
    pt_mod = cls_p(kw["in_features"], kw["out_features"],
                   in_splits=kw["in_splits"], out_splits=kw["out_splits"])
    sd = {}
    for name, v in params.items():
        if name.startswith("tile_"):
            sd[f"{name}.weight"] = torch.tensor(np.asarray(v["kernel"]).T)
        else:
            sd[name] = torch.tensor(np.asarray(v))
    pt_mod.load_state_dict(sd)
    return x, jt, params, pt_mod


def test_tiled_linear_matches_jax():
    from deepspeed_tpu.runtime.zero.tiling import (
        TiledLinear as JTiled, TiledLinearReturnBias as JTiledRB)
    from deepspeed_tpu_torch.runtime.zero.tiling import (
        TiledLinear, TiledLinearReturnBias)
    kw = dict(in_features=12, out_features=8, in_splits=3, out_splits=2)
    x, jt, params, tl = _tiled_from_jax(JTiled, TiledLinear, **kw)
    want = jt.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(tl(torch.tensor(x)).detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        TiledLinear.full_weight(tl, 3, 2).numpy(),
        np.asarray(JTiled.full_weight(params, in_splits=3, out_splits=2)),
        rtol=0, atol=0)
    kw = dict(in_features=8, out_features=6, in_splits=2, out_splits=3)
    x, jt, params, tl = _tiled_from_jax(JTiledRB, TiledLinearReturnBias,
                                        **kw)
    jy, jb = jt.apply({"params": params}, jnp.asarray(x))
    y, b = tl(torch.tensor(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(b.detach().numpy(), np.asarray(jb))


def test_contiguous_allocator_matches_jax():
    from deepspeed_tpu.runtime.zero.contiguous_memory_allocator import (
        ContiguousMemoryAllocator as JAlloc)
    from deepspeed_tpu_torch.runtime.zero.contiguous_memory_allocator \
        import ContiguousMemoryAllocator
    ja, pa = JAlloc(100), ContiguousMemoryAllocator(100)
    script = [("a", 40), ("a", 30), ("a", 30), ("r", 1), ("r", 3),
              ("a", 60), ("r", 2), ("a", 10), ("a", 25), ("r", 5),
              ("a", 12)]
    ids = {}
    for op, n in script:
        if op == "a":
            jt, jv = ja.allocate_tensor(n)
            tid, v = pa.allocate_tensor(n)
            assert tid == jt
            ids[tid] = n
            v.fill_(float(tid))
            jv[:] = float(tid)
        else:
            ja.release_tensor(n)
            pa.release_tensor(n)
        assert pa.tensor_addresses == ja.tensor_addresses
        assert pa.contiguous_sizes == ja.contiguous_sizes
        assert (pa.total_free, pa.largest_contiguous, pa.max_allocated) == \
            (ja.total_free, ja.largest_contiguous, ja.max_allocated)
    # the live tensors' values survive the compactions
    for tid in pa.tensor_addresses:
        np.testing.assert_array_equal(pa.get_tensor(tid).numpy(),
                                      np.asarray(ja.get_tensor(tid)))
        assert torch.all(pa.get_tensor(tid) == float(tid))
    with pytest.raises(AssertionError):
        pa.allocate_tensor(pa.total_free + 1)


def test_on_device_builds_on_meta():
    from deepspeed_tpu_torch.utils.init_on_device import OnDevice
    with OnDevice(dtype=torch.bfloat16, device="meta"):
        model = pt.Transformer(pt.TransformerConfig(**CFG), device="cpu")
        ids = torch.arange(4)
    assert all(p.is_meta and p.dtype == torch.bfloat16
               for p in model.parameters())
    assert ids.is_meta and ids.dtype == torch.int64
    outside = torch.zeros(2)
    assert not outside.is_meta and outside.dtype == torch.float32
