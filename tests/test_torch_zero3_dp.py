"""ZeRO-3 of the port against the JAX engine at dp 2, on the CPU over
gloo (``tests/test_torch_zero3_dp4.py`` holds dp 4, MiCS and the
checkpoints; ``tests/torch_zero3_common.py`` has the tolerances).

The ranks are ``tests/torch_dp_worker.py`` processes (suite ``zero3``, no
JAX) started through the port's launcher, while this process runs the
JAX engine at stage 3 on 2 of its virtual devices.  The model, weights
(the flax init, converted) and global batches are
``tests/torch_zero_dp_common.py``'s.  Checked:

- stage 3, fp32 and bf16 at gas 2: losses and parameters against JAX's
  stage 3; each rank's master shard is JAX's addressable shard at its dp
  index before training (exactly) and after 3 steps, and so are its
  moments; stage 3 against the port's stage 2 to fp32 roundoff; the hooks
  gather each unit once a forward and once a backward and reduce it once;
- the fp16 overflow on one rank skips the stage-3 step on every rank;
- ``zero.Init`` / ``OnDevice``: the shards made at birth are the chunks
  of the world-size-1 init, a sharded module parameter holds no storage
  after ``Init``, and an engine built from a ``meta`` module takes the
  same shards; ``GatheredParameters`` on the engine's live parameters
  writes rank 0's edit back into every rank's shard;
- ZeRO-Offload at dp 2 (stages 2 and 3, no clipping): each rank's host
  masters and moments are the JAX offload engine's state at that shard
  (masters at the parameter tolerance; moments at the moments' tolerance
  for 99 % of each tensor and within 1e-3 · max|m| everywhere, since a
  near-zero gradient component's moment differs relatively more), and a
  rank holds 12 bytes a parameter of its shard;
- ``tensor_fragment``: the whole masters, moments and a mid-window
  gradient against JAX's ``tensor_fragment`` on its engine, and each
  rank's local fragments against JAX's addressable shards;
- a ``TiledLinear`` under stage 3 gathers each tile on its own and
  trains as stage 0 does.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models import transformer as pt

import torch_zero3_common as common

DP = 2
STAGE3 = [k for k in common.RUNS[DP] if k[0] == 3]
FP32 = [k for k in STAGE3 if k[1] == "float32"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return common.results(tmp_path_factory.mktemp("zero3_dp2"), DP)


@pytest.mark.parametrize("key", STAGE3, ids=str)
def test_losses_and_params_match_jax(results, key):
    common.check_losses_and_params(results, key)


@pytest.mark.parametrize("when", ["shards0", "shards"])
@pytest.mark.parametrize("key", FP32, ids=str)
def test_param_shards_are_jax_shards(results, key, when):
    common.check_shards(results, key, when)


@pytest.mark.parametrize("key", FP32, ids=str)
def test_moments_are_jax_shards(results, key):
    common.check_moments(results, key)


def test_stage3_is_stage2_to_roundoff(results):
    common.check_stage3_against_stage2(results)


def test_hooks_gather_a_unit_at_a_time(results):
    L = common.CFG["num_layers"]
    units = L + 3                      # embed, the blocks, norm, head
    for key in STAGE3:
        gas = key[2]
        micro_steps = gas * common.STEPS
        for rank in results["ranks"]:
            st = rank["runs"][key]["stats"]
            assert st["units_gathered_forward"] == units * micro_steps
            assert st["units_reduced"] == units * micro_steps
            # the tied head reads its bf16 copy in the backward; fp32
            # reads the table itself
            back = units if key[1] == "float32" else units - 1
            assert st["units_gathered_backward"] == back * micro_steps


def test_fp16_overflow_on_one_rank_skips_on_all(results):
    for r, rank in enumerate(results["ranks"]):
        rec = rank["fp16"]
        assert rec["unchanged"], r
        assert rec["skipped"] == 1, r
        assert rec["scale"] == rec["scale0"] / 2, r


def _world_one_init(seed):
    model = pt.Transformer(pt.TransformerConfig(**common.CFG), device="cpu")
    model.init_weights(torch.Generator("cpu").manual_seed(seed))
    return model.state_dict()


def test_zero_init_shards_are_world_size_1_chunks(results):
    full = _world_one_init(5)
    for r, rank in enumerate(results["ranks"]):
        rec = rank["init"]
        leaves = common.plan_leaves(DP, r, 3)
        n_sharded = 0
        for key in ("init", "engine_masters", "birth_masters"):
            for name, (got, sharded) in rec[key].items():
                leaf = leaves[name]
                assert sharded == leaf.sharded, (key, name)
                want = leaf.to_natural(leaf.take(full[name])) \
                    if sharded else full[name]
                assert torch.equal(got, want), (key, name)
                n_sharded += sharded
        assert n_sharded > 0
        # a sharded module parameter holds no storage after Init
        for name, n in rec["storage"].items():
            assert (n == 0) == leaves[name].sharded, name


def test_gathered_parameters_write_back(results):
    for rank in results["ranks"]:
        rec = rank["init"]
        assert rec["released"] == 0 and rec["after_exit"] == 0
        assert rec["inside_shape"] == (256, 64)      # mlp.up_proj, whole
        assert torch.equal(rec["written_back"],
                           torch.full_like(rec["written_back"], 0.25))
        assert np.isfinite(rec["loss_after"])


@pytest.mark.parametrize("stage", (2, 3))
def test_offload_host_state_is_jax_shards(results, stage):
    want = results["ref"]["offload"][stage]
    n = sum(v.numel() for v in results["weights"].values())
    for r, rank in enumerate(results["ranks"]):
        rec = rank["offload"][stage]
        np.testing.assert_allclose(rec["losses"], want["losses"], rtol=1e-5)
        leaves = common.plan_leaves(DP, r, stage)
        for key, (got, sharded) in rec["host"].items():
            field, name = key.split("/", 1)
            if name.endswith("attn.k_proj.bias"):
                continue
            leaf = leaves[name]
            assert sharded == leaf.sharded, key
            full = want[field][name]
            w = (leaf.to_natural(leaf.take(full)) if sharded
                 else full).numpy()
            g = got.numpy()
            assert g.shape == w.shape, key
            if field == "masters":
                close = np.isclose(g, w, rtol=1e-4, atol=1e-4)
                assert close.mean() >= 0.999, key
                assert np.abs(g - w).max() <= 2 * common.LR * common.STEPS
            else:
                # a moment of a gradient component at roundoff level
                # differs relatively more: 99 % of each tensor at the
                # moments' tolerance, every element within 1e-3 of max|m|
                top = float(np.abs(w).max())
                close = np.isclose(g, w, rtol=1e-3, atol=1e-4 * top)
                assert close.mean() >= 0.99, (key, close.mean())
                assert np.abs(g - w).max() <= 1e-3 * top, key
        # a rank's host state: 12 bytes a parameter of its shard (whole
        # leaves on every rank)
        whole = sum(results["weights"][k].numel() for k, leaf in
                    leaves.items() if not leaf.sharded)
        assert rec["host_numel"] * 4 == 12 * ((n - whole) // DP + whole)


def test_tensor_fragment_matches_jax(results):
    key = common.FRAGMENT_RUN[DP]
    want = results["ref"][key]["fragments"]
    shards = results["ref"][key]["shards"]
    for r, rank in enumerate(results["ranks"]):
        got = rank["fragments"]
        for name in got["fp32"]:
            if name.endswith("attn.k_proj.bias"):
                continue
            g, w = got["fp32"][name].numpy(), want["fp32"][name].numpy()
            close = np.isclose(g, w, rtol=1e-4, atol=1e-4)
            assert close.mean() >= 0.999, name
            g, w = got["exp_avg"][name].numpy(), want["exp_avg"][name].numpy()
            np.testing.assert_allclose(
                g, w, rtol=1e-3, atol=1e-4 * float(np.abs(w).max()),
                err_msg=name)
            g, w = got["grad"][name].numpy(), want["grad"][name].numpy()
            np.testing.assert_allclose(
                g, w, rtol=1e-3, atol=1e-4 * float(np.abs(w).max()),
                err_msg=name)
            (index, frag), = got["local"][name]
            j_sharded, j_shards = shards[results["names"][name]]
            close = np.isclose(frag.numpy(), j_shards[r], rtol=1e-4,
                               atol=1e-4)
            assert close.mean() >= 0.999, name
        # every rank sees the same whole tensors
        assert all(torch.equal(got["fp32"][n],
                               results["ranks"][0]["fragments"]["fp32"][n])
                   for n in got["fp32"])


def test_tiled_linear_gathers_each_tile(results):
    for rank in results["ranks"]:
        rec = rank["tiled"]
        np.testing.assert_allclose(rec[3]["losses"], rec[0]["losses"],
                                   rtol=1e-6)
        st = rec[3]["stats"]
        # 6 tiles and the biases, a unit each, every forward (3 steps)
        assert st["units_gathered_forward"] == 7 * 3
        assert st["units_reduced"] == 7 * 3
