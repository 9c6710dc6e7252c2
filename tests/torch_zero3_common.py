"""Shared pieces of the port's ZeRO-3 tests against the JAX engine
(``tests/test_torch_zero3_dp.py`` at dp 2, ``tests/test_torch_zero3_dp4.py``
at dp 4): the runs the ranks make (``tests/torch_dp_worker.py``, suite
``zero3``), the JAX engine's references at the same dp (stage 3, MiCS,
the offload; computed while the ranks run), and the checks.

The model, weights and batches are ``tests/torch_zero_dp_common.py``'s.
Tolerances are that module's: fp32 losses 1e-5 relative, parameters 1e-4
for 99.9 % of each tensor and every element within Adam's largest move
(2 · lr · steps); bf16 losses 2e-2, parameters within Adam's largest move
with each tensor's mean difference within lr / 2.  Shards before training
are JAX's addressable shards exactly (the same converted elements); after
3 steps at the parameter tolerance.  Moments 1e-3 relative + 1e-4 ·
max|m|.  Stage 3 against the port's stage 2 on the same ranks (and MiCS
against flat ZeRO-3): losses 1e-6 relative; parameters within 1e-6 for
99.9 % of each tensor and every element within Adam's largest move (fp32
roundoff of another summation order, which Adam amplifies).
``attn.k_proj.bias`` is left out of the parameter checks: its true
gradient is 0 (softmax ignores a key bias), so every run steps it on
roundoff.
"""

import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.parallel.topology import initialize_topology, reset_topology
from deepspeed_tpu.utils import tensor_fragment as jtf

from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.runtime.zero.partition import build_sharding_plan

import torch_zero_dp_common as zc

CFG, GM, S, STEPS, LR = zc.CFG, zc.GM, zc.S, zc.STEPS, zc.LR
# (stage, dtype, gas, mics) a rank runs, by world size
RUNS = {2: [(3, "float32", 2, -1), (3, "bfloat16", 2, -1),
            (2, "float32", 2, -1)],
        4: [(3, "float32", 1, -1), (3, "bfloat16", 1, -1),
            (2, "float32", 1, -1), (3, "float32", 1, 2)]}
# the run whose engine tensor_fragment reads after its steps
FRAGMENT_RUN = {2: (3, "float32", 2, -1)}


def _keys(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _shards(tree, devs):
    """``{keystr: (sharded, [device r's shard])}`` of a sharded tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        by_dev = {s.device: np.asarray(s.data)
                  for s in leaf.addressable_shards}
        out[jax.tree_util.keystr(path)] = (
            not leaf.sharding.is_fully_replicated,
            [by_dev[d] for d in devs])
    return out


def _jax_engine(jmodel, tree, dp, dtype, gas, stage=3, mics=-1, clip=1.0,
                offload=False):
    topo = initialize_topology(dp=dp, devices=jax.devices()[:dp],
                               mics=max(mics, 0))
    zero = {"stage": stage, "mics_shard_size": mics}
    if offload:
        zero["offload_optimizer"] = {"device": "cpu"}
    config = {"train_micro_batch_size_per_gpu": GM // dp,
              "gradient_accumulation_steps": gas,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": LR, "weight_decay": 0.01}},
              "gradient_clipping": clip, "zero_optimization": zero}
    if dtype == "bfloat16":
        config["bf16"] = {"enabled": True}
    jeng, *_ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=tree, config=config, topology=topo)
    return jeng, [topo.mesh.devices.reshape(-1)[r] for r in range(dp)]


def _jax_run(jmodel, tree, key, dp, batches, fragments=False):
    stage, dtype, gas, mics = key
    cfg = pt.TransformerConfig(**CFG)
    try:
        jeng, devs = _jax_engine(jmodel, tree, dp, dtype, gas, stage, mics)
        out = {"shards0": _shards(jeng.params, devs)}
        out["losses"] = [float(jeng.train_batch(batch=b)) for b in batches]
        out["params"] = pt.params_from_flax(jax.device_get(jeng.params), cfg)
        out["shards"] = _shards(jeng.params, devs)
        out["moments"] = {f: _shards(getattr(jeng._opt_state, f), devs)
                          for f in ("exp_avg", "exp_avg_sq")}
        if fragments:
            out["fragments"] = _jax_fragments(jeng, cfg)
        return out
    finally:
        reset_topology()


def _jax_fragments(jeng, cfg):
    """tensor_fragment's whole views of the JAX engine, port-named."""
    paths = [_keys(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(jeng.params)]

    def tree_of(fn):
        leaves = [fn(p) for p in paths]
        treedef = jax.tree_util.tree_structure(jeng.params)
        return pt.params_from_flax(jax.tree.unflatten(treedef, leaves), cfg)

    out = {"fp32": tree_of(lambda p: jtf.safe_get_full_fp32_param(jeng, p)),
           "exp_avg": tree_of(lambda p: jtf.safe_get_full_optimizer_state(
               jeng, p, "exp_avg"))}
    b = _mid_batch()
    loss = jeng({k: jnp.asarray(v) for k, v in b.items()})
    jeng.backward(loss)
    out["grad"] = tree_of(lambda p: jtf.safe_get_full_grad(jeng, p))
    return out


def _mid_batch():
    """The micro batch the fragment run takes after its steps."""
    rng = np.random.default_rng(77)
    return {"input_ids": rng.integers(0, 97, (GM, S)).astype(np.int32)}


def _jax_offload(jmodel, tree, dp, stage, batches):
    """The JAX offload engine without clipping: its host state, port-named
    whole tensors (port layouts)."""
    cfg = pt.TransformerConfig(**CFG)
    try:
        jeng, _ = _jax_engine(jmodel, tree, dp, "float32", 1, stage,
                              clip=0.0, offload=True)
        losses = [float(jeng.train_batch(batch=b)) for b in batches]
        host = jeng._host_opt
        st = host.state_dict()
        out = {"losses": losses}
        for field in ("masters", "exp_avg", "exp_avg_sq"):
            leaves = [np.array(a, np.float32).reshape(s)
                      for a, s in zip(st[field], host.shapes)]
            out[field] = pt.params_from_flax(
                jax.tree.unflatten(host.treedef, leaves), cfg)
        return out
    finally:
        reset_topology()


def results(tmp, dp, with_ckpt=False):
    """Launch the ranks at ``dp``, compute the JAX references meanwhile,
    join; with ``with_ckpt`` the dp-4 ranks' checkpoint round trips."""
    jmodel = jt.Transformer(jt.TransformerConfig(**CFG))
    tree = jax.device_get(jmodel.init(
        jax.random.key(0), {"input_ids": jnp.zeros((1, 8), jnp.int32)}))
    cfg = pt.TransformerConfig(**CFG)
    weights = pt.params_from_flax(tree, cfg)
    batches = {g: zc._batches(10 + g, g) for g in (1, 2)}
    inp = {"cfg": CFG, "lr": LR, "weights": weights, "global_micro": GM,
           "batches": batches, "zero3_runs": RUNS,
           "fragment_run": FRAGMENT_RUN, "mid_batch": _mid_batch()}
    if with_ckpt:
        inp["ckpt3"] = {"dir": str(tmp / "ckpt3"),
                        "batches": zc._batches(40, 1, n=4)}
        os.makedirs(inp["ckpt3"]["dir"])
    torch.save(inp, tmp / "input.pt")
    out_dir = tmp / f"zero3_{dp}"
    os.makedirs(out_dir)
    proc = zc.launch(dp, "zero3", out_dir, tmp / "input.pt")
    try:
        jb = {"bfloat16": jt.Transformer(jt.TransformerConfig(
            **dict(CFG, dtype="bfloat16"))), "float32": jmodel}
        ref = {}
        for key in RUNS[dp]:
            if key[0] == 3:
                ref[key] = _jax_run(jb[key[1]], tree, key, dp,
                                    batches[key[2]],
                                    fragments=key == FRAGMENT_RUN.get(dp))
        if dp == 2:
            ref["offload"] = {s: _jax_offload(jmodel, tree, dp, s,
                                              batches[1]) for s in (2, 3)}
        ckpt = None
        if with_ckpt:
            ckpt = world_one_checkpoint(inp, weights, proc)
        ranks = zc.join(proc, out_dir, "zero3", dp)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"ref": ref, "ranks": ranks, "names": zc._name_map(tree, cfg),
            "inp": inp, "weights": weights, "dp": dp, "ckpt": ckpt}


def port_engine(weights, stage=0, **extra):
    """An engine without a group on the CPU, the ranks' config."""
    import deepspeed_tpu_torch
    config = {"train_micro_batch_size_per_gpu": GM,
              "optimizer": {"type": "AdamW", "params": {
                  "lr": LR, "weight_decay": 0.01}},
              "gradient_clipping": 1.0,
              "zero_optimization": {"stage": stage}, **extra}
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=pt.Transformer(pt.TransformerConfig(**CFG)),
        model_parameters=weights, device="cpu", config=config)
    return eng


def world_one_checkpoint(inp, weights, proc):
    """While the dp-4 ranks run: wait for their stage-3 tag, load it at
    world size 1 (stage 0) and take their next step; write a world-size-1
    tag (2 steps) for them to load at stage 3, and the step after it."""
    import time
    ck = inp["ckpt3"]
    done = os.path.join(ck["dir"], "dp4s3.done")
    deadline = time.monotonic() + zc.JOIN_TIMEOUT
    while not os.path.exists(done):
        if proc.poll() is not None:
            raise RuntimeError(f"the ranks exited ({proc.returncode}) before "
                               f"their tag:\n{proc.stdout.read()[-4000:]}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"{done} never appeared")
        time.sleep(0.2)
    eng = port_engine(weights)
    eng.load_checkpoint(ck["dir"], tag="dp4s3")
    # the offline merge of the stage-3 tag, and the 16-bit export at dp 4,
    # against this engine's
    from deepspeed_tpu_torch.checkpoint.safetensors_io import load_file
    from deepspeed_tpu_torch.models.transformer import params_to_flax
    from deepspeed_tpu_torch.utils.zero_to_fp32 import \
        get_fp32_state_dict_from_zero_checkpoint
    merged = get_fp32_state_dict_from_zero_checkpoint(ck["dir"], tag="dp4s3")
    want = {f"params/{k}": v for k, v in params_to_flax(
        eng.module_state_dict(), eng.module.config).items()}
    eng.save_16bit_model(os.path.join(ck["dir"], "export_w1"),
                         "model.safetensors")
    exp = [load_file(os.path.join(ck["dir"], d, "model.safetensors"))
           for d in ("export_dp4", "export_w1")]
    out = {"merged_equal": set(merged) == set(want) and all(
               torch.equal(merged[k], want[k]) for k in want),
           "export_equal": set(exp[0]) == set(exp[1]) and all(
               torch.equal(exp[0][k], exp[1][k]) for k in exp[1])}
    out.update({"steps": eng.global_steps,
           "loss_after": float(eng.train_batch(batch=ck["batches"][2])),
           "params_after": {k: v.clone() for k, v in
                            eng.module_state_dict().items()}})
    w1 = port_engine(weights)
    for b in ck["batches"][:2]:
        w1.train_batch(batch=b)
    w1.save_checkpoint(ck["dir"], tag="w1")
    out["w1_loss_after"] = float(w1.train_batch(batch=ck["batches"][2]))
    open(os.path.join(ck["dir"], "w1.done"), "w").close()
    return out


# --------------------------------------------------------------------- #
# checks
# --------------------------------------------------------------------- #
def check_losses_and_params(res, key):
    want = res["ref"][key]
    ranks = [r["runs"][key] for r in res["ranks"]]
    rtol = 1e-5 if key[1] == "float32" else 2e-2
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=rtol)
    assert len({r["digest"] for r in ranks}) == 1
    zc._assert_params(ranks[0]["params"], want["params"], key[1],
                      f"dp {res['dp']} {key}: ")


def check_shards(res, key, when):
    """Each rank's master shard is JAX's addressable shard at its dp index
    (``when``: ``shards0`` before training, exactly; ``shards`` after the
    steps, at the parameter tolerance), whole where JAX keeps it whole."""
    want = res["ref"][key][when]
    n_sharded = 0
    for r, rank in enumerate(res["ranks"]):
        for name, (got, sharded) in rank["runs"][key][when].items():
            j_sharded, j_shards = want[res["names"][name]]
            assert sharded == j_sharded, (r, name)
            n_sharded += sharded
            w = j_shards[r]
            g = got.numpy()
            assert g.shape == w.shape, (name, g.shape, w.shape)
            if when == "shards0":
                np.testing.assert_array_equal(g, w, err_msg=name)
            elif not name.endswith("attn.k_proj.bias"):
                close = np.isclose(g, w, rtol=1e-4, atol=1e-4)
                assert close.mean() >= 0.999, (name, close.mean())
                assert np.abs(g - w).max() <= 2 * LR * STEPS, name
    assert n_sharded > 0


def check_moments(res, key):
    want = res["ref"][key]["moments"]
    for r, rank in enumerate(res["ranks"]):
        for k, (got, sharded) in rank["runs"][key]["moments"].items():
            field, name = k.split("/", 1)
            if name.endswith("attn.k_proj.bias"):
                continue
            j_sharded, j_shards = want[field][res["names"][name]]
            assert sharded == j_sharded, k
            w = j_shards[r]
            g = got.numpy()
            assert g.shape == w.shape, (k, g.shape, w.shape)
            np.testing.assert_allclose(
                g, w, rtol=1e-3, atol=1e-4 * float(np.abs(w).max()),
                err_msg=f"rank {r} {k}")


def check_stage3_against_stage2(res, dtype="float32"):
    gas = RUNS[res["dp"]][0][2]
    rank0 = res["ranks"][0]["runs"]
    s2, s3 = rank0[(2, dtype, gas, -1)], rank0[(3, dtype, gas, -1)]
    np.testing.assert_allclose(s3["losses"], s2["losses"], rtol=1e-6)
    for name, w in s2["params"].items():
        if name.endswith("attn.k_proj.bias"):
            # its true gradient is 0: both step on roundoff
            continue
        assert_roundoff(s3["params"][name], w, name)


def assert_roundoff(got, want, name):
    """Two runs that differ by fp32 roundoff (another summation order):
    99.9 % of the tensor within 1e-6, every element within Adam's largest
    move (Adam steps a roundoff-level gradient component by about lr)."""
    g, w = got.numpy(), want.numpy()
    close = np.isclose(g, w, rtol=0, atol=1e-6)
    assert close.mean() >= 0.999, (name, close.mean())
    assert np.abs(g - w).max() <= 2 * LR * STEPS, name


def plan_leaves(dp, rank, stage):
    """The port's placements of the test model's parameters."""
    model = pt.Transformer(pt.TransformerConfig(**CFG), device="meta")
    names = [n for n, _ in model.named_parameters()]
    lay = model.jax_layouts()
    plan = build_sharding_plan([p.shape for p in model.parameters()], dp,
                               rank, stage, [lay.get(n) for n in names])
    return dict(zip(names, plan.param if stage >= 3 else plan.opt))
