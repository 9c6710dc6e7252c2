"""Shared pieces of the port's tensor-parallel tests against the JAX engine
(``tests/test_torch_tp.py`` at world 2, ``tests/test_torch_tp_dp4.py`` at
world 4): the tiny models (OPT with a vocabulary of 96, which tp 2 and 4
shard, and of 97, which JAX's rules keep whole; a Llama-style model with 8
query and 2 kv heads, whose k / v kernels tp 4 keeps whole), their flax
init, the global batches, the launch of ``tests/torch_tp_worker.py`` and
the JAX engine's references at the same ``tp × dp`` mesh on the 8 virtual
devices, computed while the ranks run.

Tolerances are PR 20's (``tests/torch_zero_dp_common.py``): fp32 losses
1e-5 relative, parameters 1e-4 for 99.9 % and within Adam's largest move
over the run; bf16 losses 2e-2; moments 1e-3 relative + 1e-4 · max|m|.
"""

import os
import subprocess
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.parallel.topology import initialize_topology, reset_topology

from deepspeed_tpu_torch.models import transformer as pt

from torch_zero_dp_common import _assert_params, _name_map, free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_tp_worker.py")
OPT = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, dtype="float32", use_flash_attention=True,
           tie_word_embeddings=True, activation="relu", remat=False,
           scan_layers=False)
CFGS = {"opt96": OPT, "opt97": dict(OPT, vocab_size=97),
        "llama": dict(vocab_size=96, hidden_size=64, num_layers=2,
                      num_heads=8, num_kv_heads=2, max_seq_len=64,
                      dtype="float32", use_flash_attention=False,
                      tie_word_embeddings=False, activation="silu",
                      gated_mlp=True, rms_norm=True,
                      position_embedding="rope", remat=False,
                      scan_layers=False)}
S, GM, GAS, STEPS, LR, CLIP = 16, 4, 2, 3, 3e-3, 1.0
# (variant, stage, dtype, tp) — world 2: tp 2; world 4: tp 2 × dp 2 under
# ZeRO-1/2/3 and tp 4 with whole k / v
RUNS = {2: [("opt96", 0, "float32", 2), ("opt96", 0, "bfloat16", 2),
            ("opt97", 0, "float32", 2)],
        4: [("opt96", 1, "float32", 2), ("opt96", 2, "float32", 2),
            ("opt96", 3, "float32", 2), ("llama", 0, "float32", 4)]}
JOIN_TIMEOUT = 900


def jax_model(variant, dtype="float32"):
    return jt.Transformer(jt.TransformerConfig(**dict(CFGS[variant],
                                                      dtype=dtype)))


def flax_tree(variant):
    return jax.device_get(jax_model(variant).init(
        jax.random.key(0), {"input_ids": jnp.zeros((1, 8), jnp.int32)}))


def batches(seed=10, n=STEPS):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 96, (GAS, GM, S)).astype(np.int32)}
            for _ in range(n)]


def launch(world, suite, out_dir, inp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner",
         "--num_gpus", str(world), "--master_port", str(free_port()),
         WORKER, suite, str(out_dir), str(inp_path)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def join(proc, out_dir, suite, world):
    out, _ = proc.communicate(timeout=JOIN_TIMEOUT)
    assert proc.returncode == 0, out[-4000:]
    return [torch.load(os.path.join(out_dir, f"{suite}.rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def jax_run(variant, tree, tp, dp, stage, dtype, data):
    """The JAX engine at ``tp × dp`` on the first ``tp · dp`` virtual
    devices: losses, gradient norms, final parameters (the port's names)
    and, per device in the port's rank order (tp innermost), each
    parameter's and moment's addressable shard."""
    topo = initialize_topology(dp=dp, tp=tp, devices=jax.devices()[:tp * dp])
    try:
        config = {"train_micro_batch_size_per_gpu": GM // dp,
                  "gradient_accumulation_steps": GAS,
                  "optimizer": {"type": "AdamW",
                                "params": {"lr": LR, "weight_decay": 0.01}},
                  "gradient_clipping": CLIP,
                  "zero_optimization": {"stage": stage},
                  "tensor_parallel": {"tp_size": tp}}
        if dtype == "bfloat16":
            config["bf16"] = {"enabled": True}
        jeng, *_ = deepspeed_tpu.initialize(
            model=jax_model(variant, dtype), model_parameters=tree,
            config=config, topology=topo)
        losses, norms = [], []
        for b in data:
            losses.append(float(jeng.train_batch(batch=b)))
            norms.append(float(jeng.get_global_grad_norm()))
        cfg = pt.TransformerConfig(**CFGS[variant])
        devs = list(topo.mesh.devices.reshape(-1))

        def shards(tree_):
            out = {}
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree_):
                by_dev = {s.device: np.asarray(s.data)
                          for s in leaf.addressable_shards}
                out[jax.tree_util.keystr(path)] = (
                    tuple(leaf.sharding.spec), [by_dev[d] for d in devs])
            return out

        rec = {"losses": losses, "grad_norms": norms,
               "params": pt.params_from_flax(jax.device_get(jeng.params),
                                             cfg),
               "param_shards": shards(jeng.params)}
        rec["moment_shards"] = {f: shards(getattr(jeng._opt_state, f))
                                for f in ("exp_avg", "exp_avg_sq")}
        return rec
    finally:
        reset_topology()


def tp_dim(spec):
    """The dim a JAX ``PartitionSpec`` (as a tuple) shards over tp."""
    return next((i for i, s in enumerate(spec) if s == "tp" or (
        isinstance(s, tuple) and "tp" in s)), None)


def _leaf_key(names, name, keys):
    """The moment tree's key of the parameter path ``names[name]``."""
    want = names[name]
    for k in keys:
        if k.endswith(want):
            return k
    raise KeyError(want)


def check_run(results, key):
    """Losses, every rank's parameters (the same on every rank of a
    global gather), each rank's slices (stages 0-2) and moments against
    JAX's addressable shards at its device."""
    variant, _, dtype, _ = key
    want = results["ref"][key]
    ranks = [r["runs"][key] for r in results["ranks"]]
    rtol = 1e-5 if dtype == "float32" else 2e-2
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=rtol)
    assert len({r["digest"] for r in ranks}) == 1
    _assert_params(ranks[0]["params"], want["params"], dtype,
                   f"{key}: ")
    names = results["names"][variant]
    n_tp = 0
    for r, rank in enumerate(ranks):
        if rank["local"] is not None:
            for name, got in rank["local"].items():
                spec, shards = want["param_shards"][names[name]]
                w = shards[r]
                assert got.shape == w.shape, (key, r, name, got.shape,
                                              w.shape, spec)
                n_tp += tp_dim(spec) is not None
                if dtype == "float32" and not name.endswith(
                        "attn.k_proj.bias"):
                    close = np.isclose(got.numpy(), w, rtol=1e-4, atol=1e-4)
                    assert close.mean() >= 0.999, (key, r, name)
        for field, moments in rank.get("moments", {}).items():
            mshards = want["moment_shards"][field]
            for name, got in moments.items():
                if name.endswith("attn.k_proj.bias"):
                    continue
                spec, shards = mshards[_leaf_key(names, name, mshards)]
                w = shards[r]
                assert got.shape == w.shape, (key, r, field, name, spec)
                np.testing.assert_allclose(
                    got.numpy(), w, rtol=1e-3,
                    atol=1e-4 * float(np.abs(w).max()) + 1e-30,
                    err_msg=f"{key} rank {r} {field} {name}")
    if ranks[0]["local"] is not None:
        assert n_tp > 0


def check_plan(results, key):
    """The port's tp dims are JAX's engine's: a leaf the JAX plan shards
    over tp is sharded on the same dim of the same layout."""
    variant = key[0]
    want = results["ref"][key]["param_shards"]
    names = results["names"][variant]
    plan = results["ranks"][0]["runs"][key]["plan"]
    for name, dim in plan.items():
        spec = want[names[name]][0]
        assert dim == tp_dim(spec), (key, name, dim, spec)


def results(tmp, world):
    """Launch the ranks at ``world``, compute the JAX references (and
    the reference gradients and tokens at world 2) meanwhile, join."""
    used = sorted({key[0] for key in RUNS[world]} | (
        {"opt96", "opt97"} if world == 2 else {"opt96"}))
    trees = {v: flax_tree(v) for v in used}
    weights = {v: pt.params_from_flax(trees[v], pt.TransformerConfig(
        **CFGS[v])) for v in used}
    data = batches()
    gen_ids = np.random.default_rng(3).integers(0, 96, (2, 12))
    inp = {"cfgs": CFGS, "lr": LR, "clip": CLIP, "weights": weights,
           "global_micro": GM, "batches": data, "runs": RUNS,
           "grad_variants": ["opt96", "opt97"], "gen_variants": ["opt96"],
           "gen_ids": gen_ids, "ckpt_dir": str(tmp / "ckpt")}
    os.makedirs(inp["ckpt_dir"])
    torch.save(inp, tmp / "input.pt")
    suite = "tp" if world == 2 else "tp4"
    out = tmp / suite
    os.makedirs(out)
    proc = launch(world, suite, out, tmp / "input.pt")
    try:
        ref = {}
        for key in RUNS[world]:
            variant, stage, dtype, tp = key
            ref[key] = jax_run(variant, trees[variant], tp, world // tp,
                               stage, dtype, data)
        if world == 2:
            ref["grads"] = {}
            for v in inp["grad_variants"]:
                mb = {"input_ids": jnp.asarray(data[0]["input_ids"][0])}
                loss, g = jax.jit(jax.value_and_grad(
                    lambda p: jax_model(v).apply(p, mb)))(trees[v])
                ref["grads"][v] = (float(loss), pt.params_from_flax(
                    jax.device_get(g), pt.TransformerConfig(**CFGS[v])))
            ref["generate"] = jax_generate("opt96", trees["opt96"], gen_ids)
        ranks = join(proc, out, suite, world)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    names = {v: _name_map(trees[v], pt.TransformerConfig(**CFGS[v]))
             for v in used}
    return {"ref": ref, "ranks": ranks, "names": names, "inp": inp,
            "weights": weights}


def jax_generate(variant, tree, ids):
    """Greedy tokens of the JAX inference engine at tp 2 (fp32)."""
    reset_topology()
    try:
        eng = deepspeed_tpu.init_inference(
            jax_model(variant), config={"dtype": "float32",
                                        "tensor_parallel": {"tp_size": 2},
                                        "prefill_chunk_size": None})
        eng.set_params(tree)
        assert eng.topology.tp == 2
        return np.asarray(eng.generate(jnp.asarray(ids), max_new_tokens=8))
    finally:
        reset_topology()
