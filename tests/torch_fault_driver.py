"""Subprocess driver for the port's kill-and-resume proof
(``test_torch_fault_tolerance.py``), importing torch and the port only.

Trains a tiny OPT under ``run_resilient`` with data derived from
``engine.global_steps`` (the determinism contract), appending
``step,repr(loss)`` lines to ``--losses`` after every completed step.  The
test arms ``DSTPU_FAULT_INJECT`` (e.g.
``point=ckpt.before_latest_swap,action=exit,at=2``) so this process dies
mid-save with ``os._exit`` — no cleanup, the honest SIGKILL simulation —
and relaunches it; the merged loss trajectory must be bitwise the
uninterrupted one.

Run:  python tests/torch_fault_driver.py --ckpt-dir D --losses F
Exit codes: 0 done, 3 preempted, 4 failed (and the injected
``exit_code`` — default 17 — when a kill fires).
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MODEL = dict(vocab_size=97, hidden_size=32, num_layers=1, num_heads=2,
             max_seq_len=16, dtype="float32", tie_word_embeddings=True,
             activation="relu", remat=False)
CONFIG = {
    "train_micro_batch_size_per_gpu": 2,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}},
    "seed": 7,
    "fault": {"enabled": True, "checksum": "crc32",
              "backoff_base_secs": 0.01, "backoff_max_secs": 0.05},
}


def make_engine(**fault):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import (Transformer,
                                                        TransformerConfig)
    config = dict(CONFIG, fault={**CONFIG["fault"], **fault})
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=Transformer(TransformerConfig(**MODEL)), config=config,
        device="cpu")
    return engine


def batch(step):
    """The micro batch of a step, a function of the step alone: a resumed
    run replays exactly the batches the uninterrupted run saw."""
    rng = np.random.default_rng(1000 + step)
    return {"input_ids": rng.integers(0, MODEL["vocab_size"],
                                      (2, 8)).astype(np.int64)}


def step_fn(engine):
    """One optimizer step on the 3-call path; returns the loss."""
    loss = engine(batch(engine.global_steps))
    engine.backward(loss)
    engine.step()
    return float(loss.detach())


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt-dir", required=True)
    parser.add_argument("--max-steps", type=int, default=6)
    parser.add_argument("--save-interval", type=int, default=2)
    parser.add_argument("--losses", required=True)
    args = parser.parse_args(argv)
    from deepspeed_tpu_torch.runtime.fault.supervisor import run_resilient

    def recording_step(engine):
        loss = step_fn(engine)
        with open(args.losses, "a") as f:
            f.write(f"{engine.global_steps},{loss!r}\n")

    status, info = run_resilient(make_engine(), recording_step,
                                 checkpoint_dir=args.ckpt_dir,
                                 max_steps=args.max_steps,
                                 save_interval=args.save_interval)
    print(f"[driver] {status} {info}", flush=True)
    return {"done": 0, "preempted": 3, "failed": 4}[status]


if __name__ == "__main__":
    sys.exit(main())
