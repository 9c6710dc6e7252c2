"""The kill-at-seam proof for the port's serving tier: a subprocess serving
a fixed workload through ``serve_resilient`` is killed at each serving
fault-injection seam — gracefully (SIGTERM → drain → crash-atomic
snapshot, exit 3) or hard (``os._exit``, 17) — relaunched clean, and the
merged per-request results must equal the JAX engine's (the six
``SERVING_KILL_SCENARIOS`` of ``tests/unit/test_serving_slo.py``, two of
them under speculation).

The workload is ``tests/unit/serving_driver.py``'s: five greedy requests
and one whose deadline has passed at submit.  The reference is the JAX
engine's solo greedy output of the five, computed here once per module,
and ``SHED_DEADLINE`` for the sixth.  The subprocess driver is this file
run as a script (``if __name__ == "__main__"``): it imports torch, never
JAX, runs on one thread, and loads the JAX model's parameters converted by
``params_from_flax`` from an ``.npz`` the test writes:

    python tests/test_torch_serving_resilient.py --weights W.npz \\
        --ckpt-dir DIR --results FILE [--drain-budget S] [--spec]

Results file: one ``<client_idx>,<status>,<tok tok ...>`` line per request
that reached a terminal status, appended when the serve loop returns (the
last line for an index wins).  Exit codes: 0 done, 3 preempted (snapshot
written), and the injected ``exit_code`` (17) when a hard kill fires.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
# tests/unit/serving_driver.py's model and serving config
MODEL = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
             max_seq_len=64, use_flash_attention=False, dtype="float32")
SERVING = {"enabled": True, "num_slots": 2, "max_cache_len": 64,
           "prefill_chunk": 8, "prefill_token_budget": 16,
           "decode_block": 2}


def workload():
    """``tests/unit/serving_driver.py``'s requests: 5 greedy ones and one
    whose deadline has already passed at submit (it must be shed, never
    admitted) — ``(prompt, max_new_tokens, deadline_s)``."""
    rng = np.random.default_rng(42)
    reqs = []
    for _ in range(5):
        p = rng.integers(1, 97, (int(rng.integers(9, 21)),)).astype(np.int32)
        reqs.append((p, int(rng.integers(4, 11)), None))
    reqs.append((rng.integers(1, 97, (10,)).astype(np.int32), 6, 0.0))
    return reqs


def read_done(path):
    """client_idx -> (status, tokens), the last line for an index
    winning."""
    done = {}
    if not os.path.exists(path):
        return done
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",", 2)
            if len(parts) == 3:
                done[int(parts[0])] = (parts[1], parts[2])
    return done


def main():
    """The driver: restore the newest snapshot, submit what is neither
    finished (results file) nor restored, serve to the end or to a
    preemption, append the results."""
    import argparse
    import torch
    sys.path.insert(0, REPO)
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.serving.resilient import \
        serve_resilient
    from deepspeed_tpu_torch.models import transformer as pt
    parser = argparse.ArgumentParser()
    parser.add_argument("--weights", required=True)
    parser.add_argument("--ckpt-dir", required=True)
    parser.add_argument("--results", required=True)
    parser.add_argument("--drain-budget", type=float, default=0.0)
    # self-draft speculation, k = 2: greedy outputs stay the reference's,
    # and a SIGTERM mid-speculation snapshots committed tokens only
    parser.add_argument("--spec", action="store_true")
    args = parser.parse_args()
    torch.set_num_threads(1)
    cfg = pt.TransformerConfig(**MODEL)
    eng = init_inference(pt.Transformer(cfg), config={
        "dtype": "float32", "prefill_chunk_size": 8,
        "serving": {**SERVING, "drain_budget_s": args.drain_budget,
                    **({"speculative": True, "spec_k": 2,
                        "spec_draft_model": "self"} if args.spec else {})}},
        device="cpu")
    with np.load(args.weights) as w:
        eng.set_params({k: torch.from_numpy(w[k]) for k in w.files})
    srv = eng.serve()

    restored = srv.restore(args.ckpt_dir)
    done = read_done(args.results)
    have = set(done) | {srv._requests[rid].client_id for rid in restored}
    rids = list(restored)
    for i, (p, n, dl) in enumerate(workload()):
        if i not in have:
            rids.append(srv.submit(p, max_new_tokens=n, deadline_s=dl,
                                   client_id=i))

    status, _ = serve_resilient(srv, args.ckpt_dir, resume=False)

    with open(args.results, "a") as f:
        for rid in rids:
            res = srv.result(rid)
            if res is None:               # snapshotted: the relaunch
                continue                  # finishes it
            toks = " ".join(str(t) for t in res.output) \
                if res.output is not None else ""
            f.write(f"{res.client_id},{res.status},{toks}\n")
        f.flush()
        os.fsync(f.fileno())
    print(f"[driver] {status}", flush=True)
    return {"done": 0, "preempted": 3}[status]


# --------------------------------------------------------------------- #
# The harness
# --------------------------------------------------------------------- #
# (scenario, DSTPU_FAULT_INJECT spec, expected first-run rc, drain budget,
#  speculative serving) — tests/unit/test_serving_slo.py's
SERVING_KILL_SCENARIOS = [
    # graceful: SIGTERM mid-serving -> drain -> snapshot -> exit 3
    ("sigterm_graceful",
     "point=serving.sigterm_at_iter,action=sigterm,at=4", 3, 0.0, False),
    # hard kills (os._exit, no cleanup) at each dispatch seam
    ("exit_pre_admit",
     "point=serving.pre_admit,action=exit,at=2", 17, 0.0, False),
    ("exit_pre_decode_dispatch",
     "point=serving.pre_decode_dispatch,action=exit,at=3", 17, 0.0,
     False),
    # a hard kill DURING the graceful drain, before the snapshot publishes
    ("exit_mid_drain",
     "point=serving.sigterm_at_iter,action=sigterm,at=5;"
     "point=serving.mid_drain,action=exit,at=1", 17, 5.0, False),
    # speculative serving (self-draft, k=2): SIGTERM mid-speculation
    ("sigterm_graceful_spec",
     "point=serving.sigterm_at_iter,action=sigterm,at=4", 3, 0.0, True),
    # a hard kill at the decode seam mid-speculation
    ("exit_pre_decode_dispatch_spec",
     "point=serving.pre_decode_dispatch,action=exit,at=3", 17, 0.0,
     True),
]


def _launch(weights, ckpt, results, spec=None, budget=0.0,
            speculative=False):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("DSTPU_FAULT_INJECT", None)
    if spec:
        env["DSTPU_FAULT_INJECT"] = spec
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--weights",
         str(weights), "--ckpt-dir", str(ckpt), "--results", str(results),
         "--drain-budget", str(budget)] + (["--spec"] if speculative else []),
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _finish(proc):
    out, err = proc.communicate(timeout=240)
    return proc.returncode, out, err


def _jax_solo(model, params):
    """The JAX engine's solo greedy output of each request of the
    workload (``SHED_DEADLINE`` for the expired one)."""
    import jax.numpy as jnp
    import deepspeed_tpu
    jeng = deepspeed_tpu.init_inference(
        model, config={"dtype": "float32", "prefill_chunk_size": 8})
    jeng.set_params(params)
    ref = {}
    for i, (p, n, dl) in enumerate(workload()):
        if dl is not None:
            ref[i] = ("SHED_DEADLINE", "")
            continue
        out = np.asarray(jeng.generate(jnp.asarray(p[None]),
                                       max_new_tokens=n))[0]
        ref[i] = ("COMPLETED", " ".join(str(int(t)) for t in out))
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX reference and every scenario's two runs: the converted
    weights go to disk, every first run starts at once, the JAX reference
    is computed while they run, then every relaunch starts at once.
    Returns ``(reference, {name: (first (rc, out, err), second, dir)})``."""
    import jax
    from deepspeed_tpu.models import transformer as jt
    from deepspeed_tpu_torch.models import transformer as pt
    model = jt.Transformer(jt.TransformerConfig(**MODEL))
    params = model.init(jax.random.key(0),
                        {"input_ids": np.zeros((1, 8), np.int32)})
    base = tmp_path_factory.mktemp("serving_resilient")
    weights = base / "weights.npz"
    sd = pt.params_from_flax(jax.tree.map(np.asarray, params),
                             pt.TransformerConfig(**MODEL))
    np.savez(weights, **{k: v.numpy() for k, v in sd.items()})
    firsts = {}
    for name, spec, _, budget, speculative in SERVING_KILL_SCENARIOS:
        d = base / name
        d.mkdir()
        firsts[name] = _launch(weights, d / "ckpt", d / "results.txt",
                               spec, budget, speculative)
    ref = _jax_solo(model, params)
    firsts = {name: _finish(p) for name, p in firsts.items()}
    seconds = {}
    for name, _, _, budget, speculative in SERVING_KILL_SCENARIOS:
        d = base / name
        seconds[name] = _launch(weights, d / "ckpt", d / "results.txt",
                                None, budget, speculative)
    return ref, {name: (firsts[name], _finish(p), base / name)
                 for name, p in seconds.items()}


@pytest.mark.parametrize("name,spec,want_rc,budget,speculative",
                         SERVING_KILL_SCENARIOS,
                         ids=[s[0] for s in SERVING_KILL_SCENARIOS])
def test_serving_kill_at_seam_resumes_bitwise(name, spec, want_rc, budget,
                                              speculative, runs):
    """The driver killed at the seam — gracefully or hard — relaunches,
    resumes or resubmits, and every request's merged result equals the
    JAX engine's: the five greedy outputs bitwise, the expired request
    ``SHED_DEADLINE``.  A graceful preemption leaves a manifest-valid
    snapshot; a mid-speculation kill surfaces no uncommitted token."""
    from deepspeed_tpu_torch.runtime.fault.manifest import (list_tags,
                                                            verify_manifest)
    ref, by_name = runs
    (rc, out, err), (rc2, out2, err2), d = by_name[name]
    assert rc == want_rc, \
        f"{name}: expected rc={want_rc}, got {rc}\n{err[-3000:]}{out[-1000:]}"
    if want_rc == 3:
        tags = list_tags(str(d / "ckpt"))
        assert tags, "preemption must leave a snapshot"
        assert verify_manifest(str(d / "ckpt" / tags[0])) == []
        assert "[driver] preempted" in out
    assert rc2 == 0, f"{name}: resume failed\n{err2[-3000:]}"
    got = read_done(d / "results.txt")
    assert got == ref, \
        f"{name}: resumed outputs diverge from the reference\n" \
        f"want {ref}\ngot  {got}"


if __name__ == "__main__":
    sys.exit(main())
