"""Tensor parallelism with data parallelism (world 4) of the port against
the JAX engine at the same mesh, on the CPU over gloo
(``tests/torch_tp_worker.py`` suite ``tp4``; references in
``tests/torch_tp_common.py``):

- tp 2 × dp 2 under ZeRO-1, 2 and 3: losses and parameters against JAX's
  tp 2 × dp 2 engine at the same stage; each rank's Adam moments (the tp
  slice, then the ZeRO shard of the dim JAX's ``apply_zero_to_spec``
  picks beside the tp dim) against JAX's addressable shards at its device;
  at stages 1 and 2 each rank's parameter slices too;
- tp 4 with 8 query and 2 kv heads (a Llama-style model): JAX's rules keep
  k / v whole (2 heads do not divide by 4), each rank attends with its
  query heads' kv head; losses, parameters and slices against JAX's tp 4;
- every rank issues one order of collectives across the tp and dp groups
  in a tp 2 × dp 2 ZeRO-2 step;
- JAX's ``test_universal_checkpoint.py:136-175`` scenario: a tag saved at
  dp 4 under ZeRO-3 loads at tp 2 × dp 2 (ZeRO-3), which trains a step and
  saves; dp 4 loads that tag back — the parameters after each load are the
  saved ones bitwise, and the moments survive the round trip.
"""

import pytest
import torch

import torch_tp_common as common

WORLD = 4


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return common.results(tmp_path_factory.mktemp("tp4"), WORLD)


@pytest.mark.parametrize("run", common.RUNS[WORLD], ids=str)
def test_training_matches_jax(results, run):
    common.check_run(results, run)


@pytest.mark.parametrize("run", common.RUNS[WORLD], ids=str)
def test_tp_dims_are_the_jax_plans(results, run):
    common.check_plan(results, run)


def test_kv_heads_that_do_not_divide_stay_whole(results):
    plan = results["ranks"][0]["runs"][("llama", 0, "float32", 4)]["plan"]
    for i in range(2):
        a = f"layers.{i}.attn."
        assert plan[a + "q_proj.weight"] == 1 and plan[a + "o_proj.weight"] \
            == 0
        assert plan[a + "k_proj.weight"] is None
        assert plan[a + "v_proj.weight"] is None


def test_one_collective_order_on_every_rank(results):
    orders = [r["order"] for r in results["ranks"]]
    assert orders[0] and all(o == orders[0] for o in orders)
    sizes = {size for _, size in orders[0]}
    assert {2} <= sizes           # tp and dp groups both of 2 ranks


def test_checkpoint_reshards_between_dp4_and_tp2_dp2(results):
    ck = results["ranks"][0]["ckpt"]
    for name, want in ck["dp4"].items():
        assert torch.equal(ck["tp2_loaded"][name], want), name
    for name, want in ck["tp2"].items():
        assert torch.equal(ck["dp4_loaded"][name], want), name
    assert ck["tp2_steps"] == 2
    assert all(r["ckpt"]["moments_back"] for r in results["ranks"])
