"""Data-parallel training (ZeRO stages 0, 1, 2) of the port against the
JAX engine at dp 4 (gas 1, fp32 and bf16; ``tests/test_torch_zero_dp.py``
holds dp 2 and says what is checked), and a checkpoint across world
sizes: a tag saved at dp 2 (stage 2, sharded moments, crash-atomic)
resumes at dp 4 (stage 1) and at dp 1 (an engine without a group), and
the resumed step gives dp 2's next step (loss rtol 1e-4, JAX's
``tests/unit/test_multiprocess_bootstrap.py:105``; parameters 1e-4)."""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as pt

import torch_zero_dp_common as common

DP = 4


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
    return common.zero_results(tmp_path_factory.mktemp("zero_dp4"), DP,
                               with_ckpt=True)


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


def test_checkpoint_moves_between_world_sizes(results):
    saved = results["saved"][0]
    for rank in results["ranks"]:
        assert rank["ckpt"]["global_steps"] == 2
        np.testing.assert_allclose(rank["ckpt"]["loss_after"],
                                   saved["loss_after"], rtol=1e-4)
    ck = results["inp"]["ckpt"]
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=pt.Transformer(pt.TransformerConfig(**common.CFG)),
        model_parameters=results["weights"], device="cpu",
        config={"train_micro_batch_size_per_gpu": common.GM,
                "optimizer": {"type": "AdamW", "params": {
                    "lr": common.LR, "weight_decay": 0.01}},
                "gradient_clipping": 1.0, "fault": {"enabled": True}})
    eng.load_checkpoint(ck["dir"], tag="dp2")
    assert eng.global_steps == 2
    loss = float(eng.train_batch(batch=ck["batches"][2]))
    np.testing.assert_allclose(loss, saved["loss_after"], rtol=1e-4)
    for name, w in saved["params"].items():
        np.testing.assert_allclose(eng.module_state_dict()[name].numpy(),
                                   w.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
