"""Card tests of tensor parallelism (``cuda`` marker; they skip below two
CUDA devices; this file imports no JAX, so a machine with the cards runs
it with ``python -m pytest --noconftest -p no:cacheprovider -q -m cuda
tests/test_torch_tp_cuda.py``).

``tests/torch_tp_worker.py`` suite ``tp_cuda`` on 2 cards over NCCL: a
small OPT at the kernels' head width (2 layers, hidden 256, 4 heads of 64:
2 a rank at tp 2, vocab 128) —

- tp 2 in bf16: K1 / K4 / K5 at each rank's 2 heads, losses within bf16's
  2e-2 of one card's engine on the same batches;
- greedy ``generate`` at tp 2 (fp32 weights): the tokens of one card's
  engine, with the captured decode graphs (the NCCL collectives inside
  them) and eagerly, bitwise each other; where the capture of the
  collectives fails the engine raises naming ``enable_cuda_graph``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
WORKER = os.path.join(REPO, "tests", "torch_tp_worker.py")
CFG = dict(vocab_size=128, hidden_size=256, num_layers=2, num_heads=4,
           max_seq_len=64, dtype="float32", use_flash_attention=True,
           tie_word_embeddings=True, activation="relu", remat=False)


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
    from deepspeed_tpu_torch.models import transformer as pt
    from deepspeed_tpu_torch.ops import op_builder
    op_builder.build_all()
    tmp = tmp_path_factory.mktemp("tp_cuda")
    model = pt.Transformer(pt.TransformerConfig(**CFG), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    inp = {"cfgs": {"cuda": CFG}, "lr": 3e-3, "clip": 1.0,
           "global_micro": 2,
           "weights": {"cuda": {k: v.clone() for k, v in
                                model.state_dict().items()}},
           "batches": [{"input_ids": rng.integers(0, 128, (2, 2, 64))}
                       for _ in range(3)],
           "gen_ids": rng.integers(0, 128, (2, 16))}
    torch.save(inp, tmp / "input.pt")
    env = dict(os.environ, WORKER_DEVICE="cuda", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner",
         "--num_gpus", "2", "--master_port", str(_free_port()), WORKER,
         "tp_cuda", str(tmp), str(tmp / "input.pt")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-6000:]
    return [torch.load(tmp / f"tp_cuda.rank{r}.pt", weights_only=False)
            for r in range(2)]


@pytest.mark.cuda
def test_tp2_training_matches_one_card(ranks):
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], rank["ref"]["losses"],
                                   rtol=2e-2)
    assert ranks[0]["losses"] == ranks[1]["losses"]


@pytest.mark.cuda
def test_tp2_generate_matches_one_card_graphs_and_eager(ranks):
    for rank in ranks:
        want = rank["ref"]["tokens"]
        eager = rank["tokens"][False]
        assert torch.equal(eager, want)
        graph = rank["tokens"][True]
        if isinstance(graph, str):
            assert "enable_cuda_graph" in graph
        else:
            assert torch.equal(graph, eager)
