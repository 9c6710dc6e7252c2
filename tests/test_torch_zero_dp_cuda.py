"""Card tests of data-parallel training (``cuda`` marker; they skip below
two CUDA devices; this file imports no JAX, so a machine with the cards
runs it with ``python -m pytest --noconftest -p no:cacheprovider -q -m
cuda tests/test_torch_zero_dp_cuda.py``).

``tests/torch_dp_worker.py`` runs on every visible card over NCCL
(``WORKER_DEVICE=cuda``, one rank a card, started through the port's
launcher):

- every collective of ``deepspeed_tpu_torch.comm`` against numpy (exact:
  small integers), the coalesced collectives, the live topology and
  ``GatheredParameters``;
- ZeRO stages 0, 1, 2 on a small model at the kernels' head width (2
  layers, hidden 256, 4 heads of 64, K1 / K4 / K5 in fp32 and bf16):
  stage 1 bitwise stage 0 (losses, parameters); stage 2 within fp32's
  1e-5 of stage 0's losses and bf16's 2e-2, its parameters within Adam's
  largest move over the run; every rank's parameters equal; the 3-call
  path and the loader give ``train_batch``'s bits; fp16 with rank 1's
  gradients overflowing skips on every rank; unequally padded rows give
  the global-token mean of one card's engine without a group (1e-5).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from torch_dp_worker import VERBS, comm_expected  # noqa: E402

WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
CFG = dict(vocab_size=128, hidden_size=256, num_layers=2, num_heads=4,
           max_seq_len=64, dtype="float32", use_flash_attention=True,
           tie_word_embeddings=True, activation="relu", remat=False)
S, STEPS, LR = 64, 3, 3e-3


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(world, suite, out_dir, *extra):
    env = dict(os.environ, WORKER_DEVICE="cuda", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner",
         "--num_gpus", str(world), "--master_port", str(_free_port()),
         WORKER, suite, str(out_dir), *map(str, extra)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-6000:]
    return [torch.load(os.path.join(out_dir, f"{suite}.rank{r}.pt"),
                       map_location="cpu", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def world():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two CUDA devices or more")
    from deepspeed_tpu_torch.ops import op_builder
    op_builder.build_all()
    return n


@pytest.fixture(scope="module")
def comm_ranks(world, tmp_path_factory):
    return _run(world, "comm", tmp_path_factory.mktemp("comm_cuda"))


def _np(t):
    return t.float().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


@pytest.mark.cuda
@pytest.mark.parametrize("verb", VERBS)
def test_nccl_collective_matches_numpy(comm_ranks, world, verb):
    for r, rec in enumerate(comm_ranks):
        assert rec["backend"] == "nccl"
        if verb == "reduce" and r != 0:
            continue
        np.testing.assert_array_equal(_np(rec[verb]),
                                      comm_expected(verb, world, r),
                                      err_msg=f"rank {r}")


@pytest.mark.cuda
def test_nccl_coalesced_topology_and_gathered(comm_ranks, world):
    for r, rec in enumerate(comm_ranks):
        s1, s2 = (_np(t) for t in rec["reduce_scatter_coalesced"])
        np.testing.assert_array_equal(
            s1, (world * np.arange(16.0)).reshape(world, -1)[r])
        full2 = np.concatenate([world * np.ones(15),
                                np.zeros(-(-15 // world) * world - 15)])
        np.testing.assert_array_equal(s2, full2.reshape(world, -1)[r])
        np.testing.assert_array_equal(_np(rec["all_gather_coalesced"]),
                                      np.arange(float(world)))
        assert rec["topology"]["dp"] == world
        assert rec["topology"]["dp_rank"] == r
        np.testing.assert_array_equal(_np(rec["gathered_shard"]), 0.25)
        np.testing.assert_array_equal(_np(rec["gathered_plain"]), 7.0)
        assert rec["tp_group_size"] == 2 and rec["init_partitions"]


@pytest.fixture(scope="module")
def zero(world, tmp_path_factory):
    from deepspeed_tpu_torch.models import transformer as pt
    tmp = tmp_path_factory.mktemp("zero_cuda")
    gm = 2 * world
    model = pt.Transformer(pt.TransformerConfig(**CFG), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(5)
    batches = {g: [{"input_ids": rng.integers(
        0, CFG["vocab_size"], (g, gm, S)).astype(np.int32)}
        for _ in range(STEPS)] for g in (1, 2)}
    ids = rng.integers(0, CFG["vocab_size"], (1, gm, S)).astype(np.int32)
    mask = np.ones((1, gm, S), np.int32)
    mask[0, gm - 1, 5:] = 0
    mask[0, gm - 2, 20:] = 0
    runs = [(s, "float32", 1) for s in (0, 1, 2)] + \
        [(s, "bfloat16", 2) for s in (0, 1, 2)]
    inp = {"cfg": CFG, "lr": LR, "weights": weights, "global_micro": gm,
           "batches": batches, "runs": {world: runs},
           "padded": {"input_ids": ids, "attention_mask": mask}}
    torch.save(inp, tmp / "input.pt")
    ranks = _run(world, "zero", tmp, tmp / "input.pt")
    # the padded batch's global-token mean on one card, no group
    one = pt.Transformer(pt.TransformerConfig(**CFG), device="cuda:0")
    one.load_state_dict(weights)
    with torch.no_grad():
        want = float(one({k: torch.from_numpy(v[0]).cuda()
                          for k, v in inp["padded"].items()}))
    return ranks, runs, want


@pytest.mark.cuda
def test_nccl_stages(zero):
    ranks, runs, _ = zero
    for dtype, gas in (("float32", 1), ("bfloat16", 2)):
        recs = [r["runs"] for r in ranks]
        s0, s1, s2 = (recs[0][(s, dtype, gas)] for s in (0, 1, 2))
        assert all(np.isfinite(s0["losses"]))
        assert s1["losses"] == s0["losses"]
        for name, w in s0["params"].items():
            assert torch.equal(s1["params"][name], w), (dtype, name)
            d = (s2["params"][name] - w).abs().max()
            assert float(d) <= 2 * LR * STEPS, (dtype, name)
        rtol = 1e-5 if dtype == "float32" else 2e-2
        np.testing.assert_allclose(s2["losses"], s0["losses"], rtol=rtol)
        for key in ((s, dtype, gas) for s in (0, 1, 2)):
            assert len({r[key]["digest"] for r in recs}) == 1, key


@pytest.mark.cuda
def test_nccl_paths_fp16_and_padding(zero, world):
    ranks, _, want = zero
    for r, rank in enumerate(ranks):
        paths = rank["paths"]
        assert paths["loader"] == paths["train_batch"]
        assert paths["equal_3call"] and paths["equal_loader"]
        for stage, rec in rank["fp16"].items():
            assert rec["unchanged"] and rec["skipped"] == 1, (r, stage)
            assert rec["scale"] == rec["scale0"] / 2
        for stage, rec in rank["padded"].items():
            np.testing.assert_allclose(rec["loss"], want, rtol=1e-5)
