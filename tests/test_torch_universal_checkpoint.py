"""Universal checkpoints of the port against the JAX package's, on the CPU
(``checkpoint/universal_checkpoint.py``, ``ZeROCheckpoint``;
``tests/torch_tp_worker.py`` suites ``uni4`` and ``uni2``, JAX's engines
on the CPU mesh):

- a port tag written at tp 2 × dp 2 under ZeRO-3 (gloo, world 4; 3 steps
  of the tiny OPT from converted weights) converts to the JAX layout file
  for file: every parameter equal to JAX's conversion of JAX's tp 2 ×
  dp 2 ZeRO-3 tag after the same steps within the data-parallel tests'
  bound (``tests/torch_zero_dp_common.py``: 99.9 % of each tensor at 1e-4,
  every element within Adam's largest move), every moment within 1e-3
  relative + 1e-4 · max|m|;
- that directory loads at world size 1 (no group), at tp 2 (ZeRO-1) and
  at dp 2 (ZeRO-3): each engine's own tag converts back to the directory's
  files bitwise, and each takes the next step with the tp 2 × dp 2 run's
  loss (1e-5 relative);
- JAX's directory loads into the port's engine bitwise, and the port's
  into JAX's ``load_universal_into_engine`` bitwise; a parameter missing
  from a directory keeps its value (a warning) and a stacked
  (``scan_layers``) leaf loads by its layer's row.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu
from deepspeed_tpu.checkpoint import convert_to_universal as jconvert
from deepspeed_tpu.checkpoint import load_universal_into_engine as jload
from deepspeed_tpu.parallel.topology import initialize_topology, reset_topology
from deepspeed_tpu.runtime.zero.partition import path_to_str

import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.checkpoint import (ZeROCheckpoint,
                                            load_hp_checkpoint_state,
                                            load_universal_into_engine,
                                            load_universal_meta)
from deepspeed_tpu_torch.checkpoint import universal_checkpoint as uc
from deepspeed_tpu_torch.models import transformer as pt

import torch_tp_common as common

VARIANT = "opt96"
CFG = pt.TransformerConfig(**common.CFGS[VARIANT])
FIELDS = ("exp_avg", "exp_avg_sq")


def _config(stage, tp, dp):
    return {"train_micro_batch_size_per_gpu": common.GM // dp,
            "gradient_accumulation_steps": common.GAS,
            "optimizer": {"type": "AdamW", "params": {
                "lr": common.LR, "weight_decay": 0.01}},
            "gradient_clipping": common.CLIP,
            "zero_optimization": {"stage": stage},
            "tensor_parallel": {"tp_size": tp}}


def _jax_engine(tree, stage, tp, dp):
    topo = initialize_topology(dp=dp, tp=tp, devices=jax.devices()[:tp * dp])
    eng, *_ = deepspeed_tpu.initialize(
        model=common.jax_model(VARIANT), model_parameters=tree,
        config=_config(stage, tp, dp), topology=topo)
    return eng


def _jax_universal(tree, data, out):
    """JAX's tp 2 × dp 2 ZeRO-3 run: its tag and its universal dir."""
    try:
        eng = _jax_engine(tree, 3, 2, 2)
        for b in data:
            eng.train_batch(batch=b)
        eng.save_checkpoint(str(out / "jax_ckpt"))
        jconvert(str(out / "jax_ckpt"), str(out / "jax_uni"))
    finally:
        reset_topology()
    return str(out / "jax_uni")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("universal")
    tree = common.flax_tree(VARIANT)
    weights = {VARIANT: pt.params_from_flax(tree, CFG)}
    data = common.batches()
    uni = {"dir": str(tmp / "uni"), "ckpt_dir": str(tmp / "ckpt"),
           "next": common.batches(seed=20, n=1)[0]}
    inp = {"cfgs": common.CFGS, "lr": common.LR, "clip": common.CLIP,
           "weights": weights, "global_micro": common.GM, "batches": data,
           "uni": uni}
    torch.save(inp, tmp / "input.pt")
    procs = {}
    for suite, world in (("uni4", 4), ("uni2", 2)):
        (tmp / suite).mkdir()
        procs[suite] = (common.launch(world, suite, tmp / suite,
                                      tmp / "input.pt"), world)
    try:
        jax_uni = _jax_universal(tree, data, tmp)
        ranks = {s: common.join(p, tmp / s, s, w)
                 for s, (p, w) in procs.items()}
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return {"tmp": tmp, "tree": tree, "weights": weights, "uni": uni,
            "jax_uni": jax_uni, "ranks": ranks}


def _files(udir):
    meta = load_universal_meta(udir)
    return {name: load_hp_checkpoint_state(udir, name)
            for name in meta["param_names"]}, meta


def _port_engine(stage=0):
    eng, *_ = ds.initialize(model=pt.Transformer(CFG),
                            config=_config(stage, 1, 1), device="cpu")
    return eng


def _assert_tag_is_universal(ckpt_dir, tag, udir):
    """The tag's parameters and moments, under flax paths, bitwise the
    directory's files."""
    want, _ = _files(udir)
    ck = ZeROCheckpoint(ckpt_dir, tag=tag)
    params, moments = ck.flax_parameters(), ck.flat_optimizer_moments()
    assert sorted(params) == sorted(want) and sorted(moments) == list(FIELDS)
    for name, files in want.items():
        np.testing.assert_array_equal(params[name], files["fp32"], name)
        for f in FIELDS:
            np.testing.assert_array_equal(moments[f][name], files[f], name)


def test_port_conversion_matches_jax_file_for_file(results):
    got, meta = _files(results["uni"]["dir"])
    want, jmeta = _files(results["jax_uni"])
    assert sorted(got) == sorted(want) == sorted(meta["param_names"])
    assert meta["moment_fields"] == jmeta["moment_fields"] == list(FIELDS)
    assert meta["global_steps"] == jmeta["global_steps"] == common.STEPS
    assert meta["universal_source_tag"] == "tp2dp2"
    for name, w in want.items():
        g = got[name]
        assert set(g) == set(w) == {"fp32", *FIELDS}, name
        assert g["fp32"].dtype == np.float32 and \
            g["fp32"].shape == w["fp32"].shape, name
        if name.endswith("k_proj/bias"):
            continue            # its true gradient is 0: roundoff steps
        close = np.isclose(g["fp32"], w["fp32"], rtol=1e-4, atol=1e-4)
        assert close.mean() >= 0.999, (name, close.mean())
        assert np.abs(g["fp32"] - w["fp32"]).max() <= \
            2 * common.LR * common.STEPS, name
        for f in FIELDS:
            np.testing.assert_allclose(
                g[f], w[f], rtol=1e-3,
                atol=1e-4 * float(np.abs(w[f]).max()) + 1e-30,
                err_msg=f"{f} {name}")


def test_loads_at_world1_tp2_dp2_bitwise(results):
    uni = results["uni"]
    eng = _port_engine()
    load_universal_into_engine(eng, uni["dir"])
    assert eng.global_steps == common.STEPS
    eng.save_checkpoint(uni["ckpt_dir"], tag="w1")
    for tag in ("w1", "tp2", "dp2"):
        _assert_tag_is_universal(uni["ckpt_dir"], tag, uni["dir"])
    want = results["ranks"]["uni4"][0]["loss_next"]
    losses = [float(eng.train_batch(batch=uni["next"]))] + [
        rec[tag]["loss_next"] for rec in results["ranks"]["uni2"]
        for tag in ("tp2", "dp2")]
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    for rec in results["ranks"]["uni2"]:
        assert rec["tp2"]["steps"] == rec["dp2"]["steps"] == common.STEPS


def test_jax_directory_loads_into_the_port(results):
    tmp = results["tmp"]
    eng = _port_engine(stage=2)
    load_universal_into_engine(eng, results["jax_uni"])
    eng.save_checkpoint(str(tmp / "from_jax"), tag="t")
    _assert_tag_is_universal(str(tmp / "from_jax"), "t", results["jax_uni"])


def test_port_directory_loads_into_jax(results):
    want, _ = _files(results["uni"]["dir"])
    reset_topology()
    try:
        jeng = _jax_engine(results["tree"], 0, 1, 1)
        jload(jeng, results["uni"]["dir"])
        params = {path_to_str(p): np.asarray(v) for p, v in
                  jax.tree_util.tree_flatten_with_path(jeng.params)[0]}
        assert sorted(params) == sorted(want)
        for name, files in want.items():
            np.testing.assert_array_equal(params[name], files["fp32"], name)
        for f in FIELDS:
            tree = getattr(jeng._opt_state, f)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
                np.testing.assert_array_equal(
                    np.asarray(v), want[path_to_str(p)][f])
        assert jeng.global_steps == common.STEPS
    finally:
        reset_topology()


def test_missing_and_stacked_leaves(results, monkeypatch):
    """A directory without one parameter: the engine keeps it and its
    moments (a warning); a stacked ``layers/`` leaf (JAX's scan_layers)
    loads by its layer's row."""
    tmp = results["tmp"]
    part = str(tmp / "partial")
    shutil.copytree(results["uni"]["dir"], part)
    gone = "params/layers_1/mlp/up_proj/kernel"
    shutil.rmtree(os.path.join(part, "zero", gone))
    stacked = "params/layers/attn/q_proj/kernel"
    os.makedirs(os.path.join(part, "zero", stacked))
    for f in ("fp32", *FIELDS):
        rows = [np.load(os.path.join(part, "zero", f"params/layers_{i}/"
                                     f"attn/q_proj/kernel/{f}.npy"))
                for i in range(CFG.num_layers)]
        np.save(os.path.join(part, "zero", stacked, f"{f}.npy"),
                np.stack(rows))
    shutil.rmtree(os.path.join(part, "zero", "params/layers_0/attn/q_proj"))
    eng = _port_engine()
    before = eng.module_state_dict()["layers.1.mlp.up_proj.weight"].clone()
    warned = []
    monkeypatch.setattr(uc.logger, "warning", warned.append)
    load_universal_into_engine(eng, part)
    assert any(gone in w for w in warned)
    sd = eng.module_state_dict()
    assert torch.equal(sd["layers.1.mlp.up_proj.weight"], before)
    full, _ = _files(results["uni"]["dir"])
    lay = eng.module.jax_layouts()
    q = lay["layers.0.attn.q_proj.weight"][0](sd["layers.0.attn.q_proj.weight"])
    np.testing.assert_array_equal(
        q.contiguous().numpy(),
        full["params/layers_0/attn/q_proj/kernel"]["fp32"])
