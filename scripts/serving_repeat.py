#!/usr/bin/env python3
"""Serve ``chip_smoke.py``'s run (d) again and again on one card, on the
page pool and on the monolithic lanes, and report which outputs repeat.

    python3 scripts/serving_repeat.py [--order p,pe,m,p,m] [--no-checks]

OPT-1.3B with seeded random bf16 weights (``chip_smoke.main_path``: runs
(a) and (b) first, after the kernel checks unless ``--no-checks``), run
(d)'s 192 requests (``chip_smoke.serving_traffic``) on ``SERVE_D``.  Each
entry of ``--order`` is one server, counted as ``chip_smoke.py`` counts
it: ``p`` the pool on captured decode graphs, ``pe`` the pool on the
eager twin, ``m`` the lanes.  The pool and the lanes run bitwise equal
kernels (K6 / K7 and K2 / K3), so every run must give the same tokens.
Prints a JSON line per server (wall seconds, scheduler iterations,
admission stalls), then one per comparison: each kind's runs against its
first, and every other kind's against the first pool run, with the
requests that differ (index, prompt, new tokens, the first differing new
token and the two tokens there), then the card's name and power limit.
Exits 1 if any comparison differs.  Needs one CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def differing(ref, outs, reqs):
    import numpy as np
    bad = []
    for i, (a, b) in enumerate(zip(ref, outs)):
        if not np.array_equal(a, b):
            P = len(reqs[i][0])
            k = int(np.flatnonzero(a != b)[0])
            bad.append({"request": i, "prompt": P, "new": reqs[i][1],
                        "new_token": k - P, "tokens": [int(a[k]),
                                                       int(b[k])]})
    return bad


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--order", default="p,pe,m,p,m,p,m")
    parser.add_argument("--no-checks", action="store_true",
                        help="skip chip_smoke.py's kernel checks")
    args = parser.parse_args()
    kinds = args.order.split(",")
    if not set(kinds) <= {"p", "pe", "m"} or "p" not in kinds:
        parser.error("--order takes p, pe and m, with at least one p")
    import torch
    if not torch.cuda.is_available():
        sys.exit("serving_repeat.py needs a CUDA card")
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deepspeed_tpu_torch.ops import op_builder
    op_builder.build_all()
    if not args.no_checks:
        cs.kernel_checks({})
    _, eng, eng_e, _ = cs.main_path()
    reqs = cs.serving_traffic(eng.module.config.vocab_size)
    warm = eng.serve(**cs.SERVE_D)
    cs.drive(warm, reqs[:4])
    warm.close()
    runs = {}
    for n, kind in enumerate(kinds):
        serve = dict(cs.SERVE_D, paged=kind != "m")
        srv, outs, secs, _, _ = cs.serve_counted(
            eng_e if kind == "pe" else eng, reqs, f"{kind} {n}", **serve)
        print(json.dumps({"server": n, "kind": kind, "seconds": secs,
                          "iterations": srv.stats["iterations"],
                          "admission_stalls":
                              srv.stats["admission_stalls"]}), flush=True)
        runs.setdefault(kind, []).append(outs)
    pairs = [(f"{kind}[0]", lst[0], f"{kind}[{i}]", o)
             for kind, lst in runs.items() for i, o in enumerate(lst[1:], 1)]
    pairs += [("p[0]", runs["p"][0], f"{kind}[{i}]", o)
              for kind, lst in runs.items() if kind != "p"
              for i, o in enumerate(lst)]
    failed = False
    for a, ref, b, outs in pairs:
        bad = differing(ref, outs, reqs)
        failed |= bool(bad)
        print(json.dumps({"compare": f"{a} vs {b}", "differ": len(bad),
                          "requests": bad[:8]}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
