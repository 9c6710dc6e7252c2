"""Shared pieces of the port's data-parallel tests against the JAX engine
(``tests/test_torch_zero_dp.py`` at dp 2, ``tests/test_torch_zero_dp4.py``
at dp 4): the tiny model and its flax-init weights, the global batches,
the launch of ``tests/torch_dp_worker.py`` through the port's launcher,
the JAX engine's references at the same dp (computed while the ranks
run), and the checks both files make.

Tolerances (fp32): losses 1e-5 relative; parameters 1e-4 for 99.9 % of
each tensor and within Adam's largest move over the run (2 · lr · steps)
for the rest — a gradient component at roundoff level, summed in another
order over the ranks, steps by about lr either way; moments 1e-3 relative
+ 1e-4 · max|m|.  bf16: losses 2e-2 relative, every parameter within
Adam's largest move and each tensor's mean difference within lr / 2, as
the lean-memory tests hold bf16; moments: the same shard shapes.
"""


import os
import socket
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, dtype="float32", use_flash_attention=True,
           tie_word_embeddings=True, activation="relu", remat=False,
           scan_layers=False)
S, GM, STEPS, LR = 16, 4, 3, 3e-3
RUNS = {2: [(s, d, 2) for d in ("float32", "bfloat16") for s in (0, 1, 2)],
        4: [(s, d, 1) for d in ("float32", "bfloat16") for s in (0, 1, 2)]}
JOIN_TIMEOUT = 900


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world, suite, out_dir, *extra):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner",
         "--num_gpus", str(world), "--master_port", str(free_port()),
         WORKER, suite, str(out_dir), *map(str, extra)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def join(proc, out_dir, suite, world):
    out, _ = proc.communicate(timeout=JOIN_TIMEOUT)
    assert proc.returncode == 0, out[-4000:]
    return [torch.load(os.path.join(out_dir, f"{suite}.rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _batches(seed, gas, n=STEPS):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 97, (gas, GM, S)).astype(np.int32)}
            for _ in range(n)]


def _padded():
    """Rows 0-1 (dp 2's rank 0) whole, rows 2-3 mostly padding."""
    rng = np.random.default_rng(31)
    ids = rng.integers(0, 97, (1, GM, S)).astype(np.int32)
    mask = np.ones((1, GM, S), np.int32)
    mask[0, 2, 5:] = 0
    mask[0, 3, 3:] = 0
    return {"input_ids": ids, "attention_mask": mask}


def _name_map(tree, cfg):
    """port parameter name → JAX leaf path (a tree of leaf ids through the
    conversion)."""
    paths = {}

    def tag(path, leaf):
        paths[len(paths)] = jax.tree_util.keystr(path)
        return np.full(leaf.shape, len(paths) - 1, np.float32)

    ids = jax.tree_util.tree_map_with_path(tag, tree)
    conv = pt.params_from_flax(ids, cfg)
    return {name: paths[int(t.reshape(-1)[0])] for name, t in conv.items()}


def _jax_run(jmodel, tree, dp, dtype, gas, batches):
    topo = initialize_topology(dp=dp, devices=jax.devices()[:dp])
    try:
        config = {"train_micro_batch_size_per_gpu": GM // dp,
                  "gradient_accumulation_steps": gas,
                  "optimizer": {"type": "AdamW",
                                "params": {"lr": LR, "weight_decay": 0.01}},
                  "gradient_clipping": 1.0, "zero_optimization": {"stage": 2}}
        if dtype == "bfloat16":
            config["bf16"] = {"enabled": True}
        jeng, *_ = deepspeed_tpu.initialize(
            model=jmodel, model_parameters=tree, config=config,
            topology=topo)
        losses = [float(jeng.train_batch(batch=b)) for b in batches]
        cfg = pt.TransformerConfig(**CFG)
        params = pt.params_from_flax(jax.device_get(jeng.params), cfg)
        devs = [topo.mesh.devices.reshape(-1)[r] for r in range(dp)]
        moments = {}
        for field in ("exp_avg", "exp_avg_sq"):
            tr = getattr(jeng._opt_state, field)
            flat = {jax.tree_util.keystr(p): leaf for p, leaf in
                    jax.tree_util.tree_leaves_with_path(tr)}
            full = pt.params_from_flax(jax.device_get(tr), cfg)
            shards = {}
            for path, leaf in flat.items():
                by_dev = {s.device: np.asarray(s.data)
                          for s in leaf.addressable_shards}
                shards[path] = (not leaf.sharding.is_fully_replicated,
                                [by_dev[d] for d in devs])
            moments[field] = (full, shards)
        return {"losses": losses, "params": params, "moments": moments}
    finally:
        reset_topology()


def zero_results(tmp, dp, with_ckpt=False):
    """Launch the ranks at ``dp`` (and, ``with_ckpt``, dp 2's save for the
    dp ranks to load), compute the JAX references meanwhile, join."""
    jmodel = jt.Transformer(jt.TransformerConfig(**CFG))
    tree = jax.device_get(jmodel.init(
        jax.random.key(0), {"input_ids": jnp.zeros((1, 8), jnp.int32)}))
    cfg = pt.TransformerConfig(**CFG)
    weights = pt.params_from_flax(tree, cfg)
    batches = {g: _batches(10 + g, g) for g in (1, 2)}
    inp = {"cfg": CFG, "lr": LR, "weights": weights, "global_micro": GM,
           "batches": batches, "runs": RUNS, "padded": _padded()}
    if with_ckpt:
        inp["ckpt"] = {"dir": str(tmp / "ckpt"), "batches": _batches(40, 1)}
        os.makedirs(inp["ckpt"]["dir"])
    if dp == 2:
        inp["remainder"] = {k: str(tmp / k) for k in
                            ("sync_dir", "nebula_dir", "offload_dir")}
    torch.save(inp, tmp / "input.pt")
    jobs = {("zero", dp): dp}
    if with_ckpt:
        jobs[("ckpt", 2)] = 2
    outs = {job: tmp / f"{job[0]}{job[1]}" for job in jobs}
    for d in outs.values():
        os.makedirs(d)
    procs = {job: launch(w, job[0], outs[job], tmp / "input.pt")
             for job, w in jobs.items()}
    try:
        # the JAX references, while the ranks run
        jb = {"bfloat16": jt.Transformer(jt.TransformerConfig(
            **dict(CFG, dtype="bfloat16"))), "float32": jmodel}
        gas = RUNS[dp][0][2]
        ref = {(dp, d): _jax_run(jb[d], tree, dp, d, gas, batches[gas])
               for d in ("float32", "bfloat16")}
        padded = _padded()
        loss, grads = jax.value_and_grad(lambda p: jmodel.apply(
            p, {k: jnp.asarray(v[0]) for k, v in padded.items()}))(tree)
        ref["padded"] = (float(loss), float(jnp.sqrt(sum(
            jnp.sum(jnp.square(g)) for g in jax.tree.leaves(grads)))))
        ranks = {job: join(procs[job], outs[job], job[0], w)
                 for job, w in jobs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return {"ref": ref, "ranks": ranks[("zero", dp)],
            "saved": ranks.get(("ckpt", 2)), "names": _name_map(tree, cfg),
            "inp": inp, "weights": weights, "dp": dp}


def _assert_params(got, want, dtype, err=""):
    for name, w in want.items():
        if name.endswith("attn.k_proj.bias"):
            # its true gradient is 0 (softmax ignores a key bias): both
            # packages step on roundoff (test_torch_train_parity.py)
            continue
        g, w = got[name].double().numpy(), w.double().numpy()
        if dtype == "float32":
            # Adam's first steps move a component by about lr whatever its
            # gradient's size, so a gradient component at roundoff level
            # (summed in another order over the ranks) may step otherwise:
            # 99.9 % of each tensor within 1e-4, every element within
            # Adam's largest move over the run
            close = np.isclose(g, w, rtol=1e-4, atol=1e-4)
            assert close.mean() >= 0.999, (err + name, close.mean())
            assert np.abs(g - w).max() <= 2 * LR * STEPS, err + name
        else:
            assert np.abs(g - w).max() <= 2 * LR * STEPS + 1e-6, err + name
            assert abs((g - w).mean()) <= LR / 2, err + name




def check_losses_and_params(results, run):
    dp = results["dp"]
    stage, dtype, gas = run
    want = results["ref"][(dp, dtype)]
    ranks = [r["runs"][run] for r in results["ranks"]]
    rtol = 1e-5 if dtype == "float32" else 2e-2
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=rtol)
    # every rank ends with the same parameters
    assert len({r["digest"] for r in ranks}) == 1
    _assert_params(ranks[0]["params"], want["params"], dtype,
                   f"dp {dp} {run}: ")


def check_moments(results, run):
    """Each rank's moments: JAX's addressable shard at its dp index (the
    same elements), whole where JAX keeps the leaf whole."""
    stage, dtype, gas = run
    want = results["ref"][(results["dp"], dtype)]["moments"]
    names = results["names"]
    n_sharded = 0
    for r, rank in enumerate(results["ranks"]):
        for key, (got, sharded) in rank["runs"][run]["moments"].items():
            field, name = key.split("/", 1)
            if name.endswith("attn.k_proj.bias"):
                continue
            full, shards = want[field]
            j_sharded, j_shards = shards[names[name]]
            if stage == 0:
                assert not sharded, key
                w = full[name].numpy()
            else:
                assert sharded == j_sharded, key
                w = j_shards[r] if sharded else full[name].numpy()
                n_sharded += sharded
            g = got.numpy()
            assert g.shape == w.shape, (key, g.shape, w.shape)
            if dtype == "float32":
                np.testing.assert_allclose(
                    g, w, rtol=1e-3, atol=1e-4 * float(np.abs(w).max()),
                    err_msg=f"rank {r} {key}")
    if stage > 0:
        assert n_sharded > 0


def check_stage1_bitwise_stage0(results):
    rank0 = results["ranks"][0]["runs"]
    gas = RUNS[results["dp"]][0][2]
    for dtype in ("float32", "bfloat16"):
        s0, s1 = rank0[(0, dtype, gas)], rank0[(1, dtype, gas)]
        assert s0["losses"] == s1["losses"]
        for name, w in s0["params"].items():
            assert torch.equal(s1["params"][name], w), (dtype, name)


def check_paths(results):
    for rank in results["ranks"]:
        paths = rank["paths"]
        np.testing.assert_allclose(paths["three_call"], paths["train_batch"],
                                   rtol=1e-7)
        assert paths["loader"] == paths["train_batch"]
        assert paths["equal_3call"] and paths["equal_loader"]
        assert paths["loader_rows"] == (GM // results["dp"], S)


def check_padding(results):
    dp = results["dp"]
    loss, gnorm = results["ref"]["padded"]
    for rank in results["ranks"]:
        for stage, rec in rank["padded"].items():
            np.testing.assert_allclose(rec["loss"], loss, rtol=1e-5,
                                       err_msg=f"stage {stage}")
            np.testing.assert_allclose(rec["grad_norm"], gnorm, rtol=1e-4,
                                       err_msg=f"stage {stage}")
    # a mean of per-rank means would differ: the test has teeth
    padded = _padded()
    model = pt.Transformer(pt.TransformerConfig(**CFG), device="cpu")
    model.load_state_dict(results["weights"])
    per_rank = []
    with torch.no_grad():
        for rows in np.split(np.arange(GM), dp):
            per_rank.append(float(model({k: torch.from_numpy(v[0][rows])
                                         for k, v in padded.items()})))
    assert abs(np.mean(per_rank) - loss) > 1e-3 * loss


def check_fp16_skip(results):
    for r, rank in enumerate(results["ranks"]):
        for stage, rec in rank["fp16"].items():
            assert rec["unchanged"], (r, stage)
            assert rec["skipped"] == 1, (r, stage)
            assert rec["scale"] == rec["scale0"] / 2, (r, stage)


def check_grouped(results):
    """The partitioned backward at dp 2 (stages 0 and 2): JAX's losses and
    parameters at the same dp."""
    want = results["ref"][(results["dp"], "float32")]
    for rank in results["ranks"]:
        for stage, rec in rank["remainder"]["grouped"].items():
            np.testing.assert_allclose(rec["losses"], want["losses"],
                                       rtol=1e-5, err_msg=f"stage {stage}")
    for stage, rec in results["ranks"][0]["remainder"]["grouped"].items():
        _assert_params(rec["params"], want["params"], "float32",
                       f"grouped stage {stage}: ")


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def check_nebula(results):
    """The asynchronous writer's tag at dp 2 is the synchronous one's,
    byte for byte."""
    rem = results["inp"]["remainder"]
    sync = _files(rem["sync_dir"])
    neb = _files(rem["nebula_dir"])
    assert sorted(sync) == sorted(neb)
    assert any(k.endswith(".pt") for k in sync)
    for k in sync:
        assert sync[k] == neb[k], k


def check_offload(results):
    """An offloaded optimizer's tag at dp 2: each rank's host shard
    gathered into global tensors; a fresh dp-2 engine resumes bitwise, and
    an engine at world size 1 loads it (the parameters bitwise the saved
    ones, the host masters theirs)."""
    import deepspeed_tpu_torch as ds
    for rank in results["ranks"]:
        off = rank["remainder"]["offload"]
        assert off["resumed_bitwise"] and off["host_bitwise"]
    saved = results["ranks"][0]["remainder"]["offload"]["saved"]
    cfg = {"train_micro_batch_size_per_gpu": GM, "optimizer": {
        "type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}},
        "zero_optimization": {"stage": 2,
                              "offload_optimizer": {"device": "cpu"}}}
    eng, *_ = ds.initialize(model=pt.Transformer(pt.TransformerConfig(
        **CFG)), config=cfg, device="cpu")
    eng.load_checkpoint(results["inp"]["remainder"]["offload_dir"],
                        tag="off")
    got = eng.module_state_dict()
    names = [n for n, p in eng.module.named_parameters()]
    for name, want in saved.items():
        assert torch.equal(got[name], want), name
    for name, m in zip(names, eng._host_opt.master_params()):
        assert torch.equal(m, saved[name]), name
    assert eng.global_steps == 2
