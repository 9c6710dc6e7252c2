"""Card tests of ZeRO-3 (``cuda`` marker; they skip below two CUDA
devices; this file imports no JAX, so a machine with the cards runs it
with ``python -m pytest --noconftest -p no:cacheprovider -q -m cuda
tests/test_torch_zero3_cuda.py``).

``tests/torch_dp_worker.py`` (suite ``zero3_cuda``) runs on every visible
card over NCCL, on a model whose weights outweigh its activations (4
layers, hidden 1024, 16 heads of 64, K1 / K4 / K5 in bf16, micro 1 ×
128 tokens a rank):

- **the saved-cast trap**: a stage-3 step's peak is below stage 2's by at
  least what the shards save — the fp32 masters, 4 N (1 − 1/dp) bytes —
  plus half of the bf16 weight copies a forward would leave saved for the
  backward (2 N bytes, all layers' at once) if the gathered weights were
  cast at use rather than gathered in the compute dtype;
- **one collective order**: every rank issues the same all-gathers,
  reduce-scatters and all-reduces, in the same order, with the same sizes
  and dtypes, in a stage-3 step; one reduction a unit;
- **the fp16 skip at stage 3**: with rank 1's gradients overflowing, every
  rank keeps its shards, counts one skipped step and halves the scale.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
CFG = dict(vocab_size=512, hidden_size=1024, num_layers=4, num_heads=16,
           max_seq_len=128, dtype="bfloat16", use_flash_attention=True,
           tie_word_embeddings=True, activation="relu", remat=False)
S, LR = 128, 3e-3


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two CUDA devices or more")
    sys.path.insert(0, REPO)
    from deepspeed_tpu_torch.models import transformer as pt
    from deepspeed_tpu_torch.ops import op_builder
    op_builder.build_all()
    tmp = tmp_path_factory.mktemp("zero3_cuda")
    model = pt.Transformer(pt.TransformerConfig(**CFG), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    inp = {"cfg": CFG, "lr": LR, "global_micro": n,
           "weights": {k: v.detach().clone()
                       for k, v in model.state_dict().items()},
           "batches": {1: [{"input_ids": rng.integers(
               0, CFG["vocab_size"], (1, n, S)).astype(np.int32)}
               for _ in range(3)]}}
    torch.save(inp, tmp / "input.pt")
    env = dict(os.environ, WORKER_DEVICE="cuda", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner",
         "--num_gpus", str(n), "--master_port", str(_free_port()),
         WORKER, "zero3_cuda", str(tmp), str(tmp / "input.pt")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-6000:]
    return [torch.load(os.path.join(tmp, f"zero3_cuda.rank{r}.pt"),
                       map_location="cpu", weights_only=False)
            for r in range(n)]


@pytest.mark.cuda
def test_stage3_peak_falls_by_what_the_shards_save(ranks):
    world = len(ranks)
    for rec in ranks:
        s2, s3 = rec["peak"][2], rec["peak"][3]
        n = s3["n"]
        saved = 4 * n * (1 - 1 / world) + 0.5 * 2 * n
        assert s2["peak"] - s3["peak"] >= saved, (s2, s3, saved)


@pytest.mark.cuda
def test_one_collective_order_on_every_rank(ranks):
    seqs = [rec["collectives"] for rec in ranks]
    assert seqs[0] and all(s == seqs[0] for s in seqs)
    units = CFG["num_layers"] + 3
    assert ranks[0]["stats"]["units_reduced"] == 3 * units
    names = {name for name, _, _ in seqs[0]}
    assert {"all_gather_into_tensor", "reduce_scatter_tensor"} <= names


@pytest.mark.cuda
def test_fp16_overflow_on_one_rank_skips_stage3_on_all(ranks):
    for r, rec in enumerate(ranks):
        f = rec["fp16"]
        assert f["unchanged"] and f["skipped"] == 1, r
        assert f["scale"] == f["scale0"] / 2, r
