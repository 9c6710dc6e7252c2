#!/usr/bin/env python3
"""Time ``generate()`` on captured decode graphs of k steps for two values
of k (``inference/engine.py`` ``DECODE_STEPS_PER_GRAPH``), in turns, on
one card, at ``chip_smoke.py``'s run (a) shape.

    python3 scripts/decode_graph_steps.py [--steps 4 16] [--rounds 2]

OPT-1.3B with seeded random bf16 weights, batch 16 × prompt 256 × 64 new
tokens (``chip_smoke.RUN_A``), greedy, one engine per k over the same
weights, each warmed up (``warmup()``: its capture is timed).  Two
traffic forms:

- ``no_eos``: eos -1, as in ``chip_smoke.py``: no row can finish, so
  ``done`` is never read and the replays queue back to back;
- ``eos``: the token of the greedy stream that every row emits soonest,
  so rows finish at different steps and the loop reads ``done`` once per
  replay and stops after the block in which the last row finished.

Each reading is the wall time of 3 calls ending in a device sync, taken
in the order k1, k2, k2, k1 per round.  The tokens of every k must be
bitwise equal.  Prints one JSON line ``{"decode_graph_steps": ...}`` and
the card's name and power limit.  Needs one CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def soonest_eos(out, P):
    """The token every row emits, with the earliest last first-emission
    over the rows, and that step; None if no token is in every row."""
    best = None
    gen = out[:, P:].tolist()
    for tok in set(gen[0]):
        if all(tok in row for row in gen):
            step = max(row.index(tok) for row in gen)
            if best is None or step < best[1]:
                best = (tok, step)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, nargs=2, default=[4, 16])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference import engine as te
    from deepspeed_tpu_torch.models.opt import opt_model
    from deepspeed_tpu_torch.ops import op_builder
    op_builder.build_all()
    B, P, new = (chip_smoke.RUN_A[k] for k in ("batch", "prompt", "new"))
    base = init_inference(opt_model(chip_smoke.MODEL), dtype="bfloat16",
                          device="cuda")
    base.init_params(seed=0)
    V = base.module.config.vocab_size
    g = torch.Generator(device="cuda").manual_seed(4)
    ids = torch.randint(0, V, (B, P), generator=g, device="cuda")
    engines, capture = {}, {}
    for k in args.steps:
        te.DECODE_STEPS_PER_GRAPH = k
        eng = init_inference(base.module, dtype="bfloat16", device="cuda")
        capture[k] = eng.warmup(P, new, batch_sizes=(B,))
        engines[k] = eng
    greedy = engines[args.steps[0]].generate(ids, max_new_tokens=new)
    eos, last = soonest_eos(greedy.cpu(), P) or (-1, new)
    forms = {"no_eos": -1, "eos": eos}
    times = {k: {f: [] for f in forms} for k in args.steps}
    outs = {}

    def reading(k, form):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            out = engines[k].generate(ids, max_new_tokens=new,
                                      eos_token_id=forms[form])
        torch.cuda.synchronize()
        times[k][form].append((time.perf_counter() - t0) / 3)
        outs.setdefault(form, out)
        if not torch.equal(outs[form], out):
            sys.exit(f"k={k}: tokens differ from k={args.steps[0]}'s "
                     f"({form})")

    k1, k2 = args.steps
    for _ in range(args.rounds):
        for k in (k1, k2, k2, k1):
            for form in forms:
                reading(k, form)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({"decode_graph_steps": {
        "shape": {"batch": B, "prompt": P, "new": new},
        "eos": eos, "last_row_done_at_step": last,
        "seconds_per_call": {str(k): times[k] for k in args.steps},
        "tokens_per_s": {str(k): {f: B * new * len(v) / sum(v)
                                  for f, v in times[k].items()}
                         for k in args.steps},
        "warmup_seconds": {str(k): capture[k] for k in args.steps}}}),
        flush=True)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
