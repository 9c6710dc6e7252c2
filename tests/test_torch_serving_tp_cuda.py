"""Card tests of serving at tensor-parallel size 2 (``cuda`` marker; they
skip below two CUDA devices; this file imports no JAX, so a machine with
the cards runs it with ``python -m pytest --noconftest -p
no:cacheprovider -q -m cuda tests/test_torch_serving_tp_cuda.py``).

``tests/torch_tp_worker.py`` suite ``serve_cuda`` on 2 cards over NCCL: a
small OPT at the kernels' head width (2 layers, hidden 256, 4 heads of 64:
2 a rank at tp 2, vocab 128), 7 requests (eos probed on every other one)
on 3 slots — ``serve()`` at tp 2 (rank 0 drives, rank 1 follows its
plans; the decode block captured with its NCCL all-reduces, K6 / K7 on a
pool, K2 / K3 on lanes) gives one card's fp32 greedy tokens on both
routes.
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
           tie_word_embeddings=True, activation="relu", remat=False,
           scan_layers=False)
SERVING = {"enabled": True, "num_slots": 3, "max_cache_len": 64,
           "prefill_chunk": 8, "prefill_token_budget": 16,
           "decode_block": 2, "page_size": 16}
ROUTES = {"paged": {"paged": True, "page_size": 16}, "lanes": {}}


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
    tmp = tmp_path_factory.mktemp("serve_cuda")
    model = pt.Transformer(pt.TransformerConfig(**CFG), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(1, 128, (int(p),)).astype(np.int32), int(n),
             int(rng.integers(1, 128)) if i % 2 == 0 else -1)
            for i, (p, n) in enumerate(zip(rng.integers(9, 21, 7),
                                           rng.integers(3, 13, 7)))]
    inp = {"cfg": CFG, "serving": SERVING, "routes": ROUTES,
           "requests": reqs,
           "sd": {k: v.clone() for k, v in model.state_dict().items()}}
    torch.save(inp, tmp / "input.pt")
    env = dict(os.environ, WORKER_DEVICE="cuda", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner",
         "--num_gpus", "2", "--master_port", str(_free_port()), WORKER,
         "serve_cuda", str(tmp), str(tmp / "input.pt")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-6000:]
    return [torch.load(tmp / f"serve_cuda.rank{r}.pt", weights_only=False)
            for r in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_tp2_serving_gives_one_cards_tokens(ranks, route):
    rank0 = ranks[0]
    assert ranks[1]["tp2"][route] is None        # rank 1 followed
    for got, want in zip(rank0["tp2"][route], rank0["ref"][route]):
        np.testing.assert_array_equal(got, want)
