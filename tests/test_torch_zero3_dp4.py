"""ZeRO-3 and MiCS of the port against the JAX engine at dp 4 (gas 1,
fp32 and bf16; ``tests/test_torch_zero3_dp.py`` holds dp 2 and says what
is checked), and the checkpoints of a partitioned model:

- MiCS (``mics_shard_size`` 2: two replica groups of two sharding ranks)
  against JAX's MiCS engine (losses, parameters, group-local shards and
  moments at JAX's addressable shards), the topology split, and against
  flat ZeRO-3 to roundoff (the scenarios of JAX's
  ``tests/unit/test_mics.py``);
- a stage-3 tag saved at dp 4 loads at world size 1 (stage 0), where
  ``utils/zero_to_fp32.py`` merges it and the 16-bit export is the dp-4
  export bitwise, and takes dp 4's next step (loss 1e-4, parameters 1e-4, JAX's
  ``tests/unit/test_multiprocess_bootstrap.py:105``), and a world-size-1
  tag loads at stage 3 at dp 4 and takes its next step;
- a MiCS tag loads into flat ZeRO-3 with every parameter bitwise, and the
  flat tag back under MiCS (JAX's
  ``test_mics_checkpoint_reshards_to_flat_and_back``).
"""

import numpy as np
import pytest
import torch

import torch_zero3_common as common

DP = 4
STAGE3 = [k for k in common.RUNS[DP] if k[0] == 3]
FP32 = [k for k in STAGE3 if k[1] == "float32"]
MICS = (3, "float32", 1, 2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread in this process, whatever an earlier module of
    the same worker left set: the in-process engines sum in one order
    under any load, as the launched ranks (one thread each) do."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return common.results(tmp_path_factory.mktemp("zero3_dp4"), DP,
                          with_ckpt=True)


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


def test_mics_topology_split(results):
    for r, rank in enumerate(results["ranks"]):
        rec = rank["runs"][MICS]
        assert (rec["shard_world"], rec["shard_rank"]) == (2, r % 2)
        flat = rank["runs"][(3, "float32", 1, -1)]
        assert (flat["shard_world"], flat["shard_rank"]) == (4, r)


def test_mics_param_shards_are_group_local(results):
    """Ranks r and r + 2 (one shard group apart) hold the same shards."""
    ranks = results["ranks"]
    for r in (0, 1):
        a, b = ranks[r]["runs"][MICS]["shards"], \
            ranks[r + 2]["runs"][MICS]["shards"]
        n_sharded = 0
        for name, (t, sharded) in a.items():
            assert np.array_equal(t.numpy(), b[name][0].numpy()), name
            n_sharded += sharded
        assert n_sharded > 0


def test_mics_equals_flat_zero3(results):
    rank0 = results["ranks"][0]["runs"]
    mics, flat = rank0[MICS], rank0[(3, "float32", 1, -1)]
    np.testing.assert_allclose(mics["losses"], flat["losses"], rtol=1e-6)
    for name, w in flat["params"].items():
        if name.endswith("attn.k_proj.bias"):
            # its true gradient is 0: both step on roundoff
            continue
        common.assert_roundoff(mics["params"][name], w, name)


def test_stage3_checkpoint_moves_between_world_sizes(results):
    ck = results["ckpt"]
    ranks = [r["ckpt3"] for r in results["ranks"]]
    assert ck["steps"] == 2
    # zero_to_fp32 merges the stage-3 tag, and the 16-bit export at dp 4
    # is the world-size-1 engine's, bitwise
    assert ck["merged_equal"] and ck["export_equal"]
    np.testing.assert_allclose(ck["loss_after"], ranks[0]["loss_after"],
                               rtol=1e-4)
    for name, w in ranks[0]["params_after"].items():
        np.testing.assert_allclose(ck["params_after"][name].numpy(),
                                   w.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    for rec in ranks:
        assert rec["w1_steps"] == 2
        np.testing.assert_allclose(rec["w1_loss_after"], ck["w1_loss_after"],
                                   rtol=1e-4)


def test_mics_checkpoint_reshards_to_flat_and_back(results):
    for rec in (r["ckpt3"] for r in results["ranks"]):
        assert rec["mics_to_flat_equal"] and rec["mics_to_flat_steps"] == 2
        assert rec["flat_to_mics_equal"] and rec["flat_to_mics_steps"] == 3
        assert np.isfinite(rec["flat_to_mics_loss"])
