"""Data-parallel training (ZeRO stages 0, 1, 2) of the port against the
JAX engine at dp 2, on the CPU over gloo (``tests/test_torch_zero_dp4.py``
holds dp 4 and the checkpoint across world sizes).

The ranks are real processes: ``tests/torch_dp_worker.py`` (no JAX),
started through the port's launcher, while this process computes the JAX
references on its 8 virtual devices (``initialize_topology(dp=2,
devices=jax.devices()[:2])``; ``tests/torch_zero_dp_common.py``).  The
weights are the flax init of a tiny OPT (2 layers, hidden 64, vocab 97,
``scan_layers=False``), converted with ``params_from_flax``; the batches
are global (``micro × dp`` rows a micro step).  AdamW, weight decay,
clipping 1.0, 3 steps at gas 2, fp32 and bf16, each at stages 0, 1, 2:

- losses and final parameters against the JAX engine's; each rank's Adam
  moments against JAX's addressable shard at its dp index (the same
  shard), whole where JAX keeps the leaf whole (tolerances in the common
  module); stage 1 bitwise stage 0; every rank's parameters equal;
- the 3-call path and the engine's loader (each rank collates only its
  rows) give ``train_batch``'s bits;
- rows padded unequally over the ranks: the loss and the gradient norm
  are the global-token mean's, JAX's on the global batch (1e-5, 1e-4),
  which a mean of per-rank means is not;
- fp16 with rank 1's gradients overflowing: every rank skips the step
  (parameters untouched, one skipped step, the scale halved), stages 0, 2;
- the data-parallel remainder: the partitioned backward
  (``grad_partition_groups`` 2, stages 0 and 2) against JAX; the nebula
  writer's tag byte-equal to the synchronous one of the same state; an
  offloaded optimizer's tag resumed bitwise by a fresh dp-2 engine and
  loaded by an engine at world size 1;
- the config at dp > 1 (ZeRO-3, the offload, MiCS, the partitioned
  backward and tensor parallelism taken) and the batch triple against the
  dp world, with the JAX errors.
"""

import pytest

from deepspeed_tpu.runtime import config as jconfig

from deepspeed_tpu_torch.runtime import config as pconfig

import torch_zero_dp_common as common

DP = 2


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return common.zero_results(tmp_path_factory.mktemp("zero_dp2"), DP)


@pytest.mark.parametrize("run", common.RUNS[DP], ids=str)
def test_losses_and_params_match_jax(results, run):
    common.check_losses_and_params(results, run)


@pytest.mark.parametrize("run", common.RUNS[DP], ids=str)
def test_moments_are_jax_shards(results, run):
    common.check_moments(results, run)


def test_stage1_is_bitwise_stage0(results):
    common.check_stage1_bitwise_stage0(results)


def test_three_call_path_and_loader_give_train_batch_bits(results):
    common.check_paths(results)


def test_unequal_padding_is_the_global_token_mean(results):
    common.check_padding(results)


def test_fp16_overflow_on_one_rank_skips_on_all(results):
    common.check_fp16_skip(results)


def test_partitioned_backward_at_dp2_matches_jax(results):
    common.check_grouped(results)


def test_nebula_tag_at_dp2_is_the_synchronous_tag(results):
    common.check_nebula(results)


def test_offloaded_optimizer_tag_at_dp2_resumes_and_loads_alone(results):
    common.check_offload(results)


@pytest.mark.parametrize("triple", [
    dict(train_batch_size=8, train_micro_batch_size_per_gpu=2,
         gradient_accumulation_steps=2),
    dict(train_batch_size=6, train_micro_batch_size_per_gpu=2),
    dict(train_batch_size=6, gradient_accumulation_steps=2),
    dict(train_batch_size=6),
], ids=["triple", "tbs_mbs", "tbs_gas", "tbs"])
def test_batch_triple_errors_at_dp_match_jax(triple):
    with pytest.raises(ValueError) as want:
        jconfig.DeepSpeedConfig(dict(triple), mesh_world_size=4)
    with pytest.raises(ValueError) as got:
        pconfig.DeepSpeedConfig(dict(triple), mesh_world_size=4)
    assert str(got.value) == str(want.value)


def test_batch_triple_completion_at_dp_matches_jax():
    for triple in (dict(train_batch_size=16, train_micro_batch_size_per_gpu=2),
                   dict(train_batch_size=16, gradient_accumulation_steps=2),
                   dict(train_micro_batch_size_per_gpu=3),
                   dict(train_batch_size=8), {}):
        j = jconfig.DeepSpeedConfig(dict(triple), mesh_world_size=4)
        p = pconfig.DeepSpeedConfig(dict(triple), mesh_world_size=4)
        assert (p.train_batch_size, p.train_micro_batch_size_per_gpu,
                p.gradient_accumulation_steps) == \
            (j.train_batch_size, j.train_micro_batch_size_per_gpu,
             j.gradient_accumulation_steps)


@pytest.mark.parametrize("knob", [
    {"zero_optimization": {"stage": 3}},
    {"zero_optimization": {"stage": 2,
                           "offload_optimizer": {"device": "cpu"}}},
    {"zero_optimization": {"grad_partition_groups": 2}},
    {"tensor_parallel": {"tp_size": 2}},
    {"zero_optimization": {"mics_shard_size": 2}},
], ids=["stage3", "offload", "grad_partition_groups", "tp", "mics"])
def test_dp_refusals(knob):
    # ZeRO-3, the offload and MiCS (the ZeRO-3 slice), the partitioned
    # backward and tensor parallelism (the TP slice) are ported at dp > 1:
    # the config takes every one of them
    cfg = dict(knob, train_micro_batch_size_per_gpu=1)
    got = pconfig.DeepSpeedConfig(cfg, mesh_world_size=2)
    want = knob.get("zero_optimization", {})
    assert got.zero_config.stage == want.get("stage", 0)
    assert got.zero_config.mics_shard_size == want.get("mics_shard_size", -1)
    assert got.zero_config.grad_partition_groups == \
        want.get("grad_partition_groups", got.zero_config.grad_partition_groups)
    assert got.tensor_parallel.tp_size == \
        knob.get("tensor_parallel", {}).get("tp_size", 1)
    # the JAX config takes them alike; at world size 1 they are the
    # single-device layouts and levers (tp: the world size is the engine's)
    jconfig.DeepSpeedConfig(dict(cfg), mesh_world_size=2)
    pconfig.DeepSpeedConfig(dict(knob, train_micro_batch_size_per_gpu=1))
