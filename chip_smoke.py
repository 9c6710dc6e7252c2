#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

1. builds the attention kernels from ``deepspeed_tpu_torch/ops/csrc`` with
   ``nvcc`` for sm_90a (one compiler process per source, started together);
2. holds each kernel against its plain PyTorch version on the card at the
   shapes OPT-1.3B's serving path gives it (bf16 at atol = rtol = 2e-2,
   the output's bf16 rounding; fp32 at 1e-4, summation order), and times
   kernel, plain version and ``F.scaled_dot_product_attention`` (a
   yardstick the port never calls) by their device time in
   ``torch.profiler``'s kernel records, beside the card's bound;
3. drives the port's main path — ``init_inference(opt_model("opt-1.3b"))``
   with seeded random weights, then ``generate`` — once with one-pass
   prefill and once with chunked prefill, counting each kernel's launches
   in each run, and checks the outputs against the plain path on the card;
   the one-pass run goes once more under ``torch.profiler``, and a
   ``profile`` line gives its device busy time, idle share and device time
   by kernel group (trace in ``build/profiles/generate_trace.json``);
4. prints the card, a ``kernels`` JSON line and, last, the result line.

It exits non-zero, with no result line, when there is no CUDA device, when
the package is missing, or when any phase fails.
"""

import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # fp32 outside the tensor cores
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
DEV = "cuda"
ROOT = os.path.dirname(os.path.abspath(__file__))
MODEL = "opt-1.3b"
# kernel checks at the shapes OPT-1.3B's serving path gives each kernel
K1_SHAPE = dict(B=16, S=256, H=32, D=64)
K2_SHAPE = dict(L=24, B=16, S_max=320, H=32, D=64,
                lengths=[1, 320, 17, 64, 100, 255, 256, 200, 5, 8, 33, 128,
                         300, 150, 2, 77])
K3_SHAPE = dict(L=24, B=16, C=128, S_max=512, H=32, D=64,
                starts=[0, 128, 256, 384] * 4)
# the two main-path runs: one-pass prefill (a) and chunked prefill (b)
RUN_A = dict(batch=16, prompt=256, new=64)
RUN_B = dict(batch=16, prompt=512, new=16, chunk=128)


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_all(tag, kernel_name, kernel_fn, plain_fn, library_fn, iters):
    """Device time per call (``torch.profiler`` kernel records) of the
    kernel, of its plain version and of the library call, plus the
    kernel's wall time per call with the wrapper (``call_ms``, CUDA events
    around back-to-back calls: where it exceeds ``kernel_ms`` the host
    cannot keep the card fed)."""
    from deepspeed_tpu_torch.profiling.trace import device_ms_per_call
    trace = os.path.join(ROOT, "build", "profiles", f"chip_smoke_{tag}.json")
    return {
        "kernel_ms": device_ms_per_call(kernel_fn, iters, trace,
                                        name=kernel_name),
        "call_ms": cuda_time(kernel_fn, iters),
        "plain_ms": device_ms_per_call(plain_fn, max(iters // 10, 2), trace),
        "library_ms": device_ms_per_call(library_fn, iters, trace),
    }


def cuda_time(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops > t_mem
                                     else "bytes")


def max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def check_close(name, got, want, dtype):
    import torch
    tol = TOL[dtype]
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got.float(), want.float(), atol=tol, rtol=tol)
    err = max_err(got, want)
    if not ok:
        fail(f"{name} ({dtype}) disagrees with its plain version: "
             f"max_abs_err={err} (atol=rtol={tol})")
    return err


# --------------------------------------------------------------------- #
# Kernels against their plain versions, at main-path shapes
# --------------------------------------------------------------------- #
def check_flash(dtype, timed):
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    B, S, H, D = (K1_SHAPE[x] for x in "BSHD")
    g = torch.Generator(device=DEV).manual_seed(1)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(B, S, H, D, generator=g, device=DEV, dtype=dt)
               for _ in range(3))
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    want, want_lse = fa.flash_attention_plain(q, k, v, causal=True,
                                              scale=1 / math.sqrt(D))
    err = check_close("K1 flash_attention", out, want, dtype)
    check_close("K1 flash_attention lse", lse, want_lse, dtype)
    rec = {"kernel": "K1 flash_attention", "dtype": dtype,
           "shape": [B, S, H, D], "causal": True, "max_abs_err": err,
           "tol": TOL[dtype]}
    if timed:
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        rec.update(time_all(
            "k1", "flash_fwd_kernel",
            lambda: fa.flash_attention(q, k, v, causal=True),
            lambda: fa.flash_attention_plain(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                   is_causal=True), 50))
        pairs = B * H * S * (S + 1) // 2
        nbytes = 4 * q.numel() * q.element_size()  # q, k, v read; out written
        rec["bound_ms"], rec["bound_by"] = bound(4 * D * pairs, nbytes, dtype)
    emit(rec)
    return rec


def check_decode(dtype, timed):
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    L, B, S_max, H, D = (K2_SHAPE[x] for x in ("L", "B", "S_max", "H", "D"))
    layer = L // 4
    g = torch.Generator(device=DEV).manual_seed(2)
    dt = getattr(torch, dtype)
    kc = torch.randn(L, B, S_max, H * D, generator=g, device=DEV, dtype=dt)
    vc = torch.randn(L, B, S_max, H * D, generator=g, device=DEV, dtype=dt)
    q = torch.randn(B, H, D, generator=g, device=DEV, dtype=dt)
    nk = torch.randn(B, H, D, generator=g, device=DEV, dtype=dt)
    nv = torch.randn(B, H, D, generator=g, device=DEV, dtype=dt)
    lengths = torch.tensor(K2_SHAPE["lengths"], dtype=torch.int32,
                           device=DEV)
    k1, v1 = kc.clone(), vc.clone()
    out, _, _ = da.decode_attention(q, k1, v1, lengths, layer=layer,
                                    new_k=nk, new_v=nv)
    torch.cuda.synchronize()
    k2, v2 = kc.clone(), vc.clone()
    want = da.decode_attention_plain(q, k2[layer], v2[layer], lengths,
                                     new_k=nk, new_v=nv)
    err = check_close("K2 decode_attention", out, want, dtype)
    if not (torch.equal(k1, k2) and torch.equal(v1, v2)):
        fail(f"K2 decode_attention ({dtype}): written caches differ from "
             f"the plain write")
    unfused = da.decode_attention(q, k1, v1, lengths, layer=layer)
    check_close("K2 decode_attention (unfused)", unfused, want, dtype)
    del k2, v2
    rec = {"kernel": "K2 decode_attention", "dtype": dtype,
           "cache": [L, B, S_max, H * D], "fused_write": True,
           "lengths": lengths.tolist(), "max_abs_err": err,
           "tol": TOL[dtype], "cache_rows_bitwise_equal": True}
    if timed:
        it = iter(range(10 ** 9))

        def run_kernel():       # one layer per call, as decode walks them
            da.decode_attention(q, k1, v1, lengths, layer=next(it) % L,
                                new_k=nk, new_v=nv)

        def run_plain():
            li = next(it) % L
            da.decode_attention_plain(q, k1[li], v1[li], lengths,
                                      new_k=nk, new_v=nv)

        heads = [(k1[li].view(B, S_max, H, D).transpose(1, 2).contiguous(),
                  v1[li].view(B, S_max, H, D).transpose(1, 2).contiguous())
                 for li in range(L)]
        live = (torch.arange(S_max, device=DEV)[None]
                < lengths[:, None].long())[:, None, None, :]
        qh = q[:, :, None, :]

        def run_library():
            kh, vh = heads[next(it) % L]
            F.scaled_dot_product_attention(qh, kh, vh, attn_mask=live)

        rec.update(time_all("k2", "decode_kernel", run_kernel, run_plain,
                            run_library, 240))
        del heads
        n_live = int(lengths.sum())
        es = q.element_size()
        # each row's last live position is this step's fresh row
        nbytes = (2 * (n_live - B) * H * D * es    # older K and V rows read
                  + 2 * 2 * nk.numel() * es         # new rows read + written
                  + 2 * q.numel() * es              # q read, out written
                  + lengths.numel() * 4)
        rec["bound_ms"], rec["bound_by"] = bound(4 * H * D * n_live, nbytes,
                                                 dtype)
    emit(rec)
    return rec


def check_chunk(dtype, timed):
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    L, B, C, S_max, H, D = (K3_SHAPE[x]
                            for x in ("L", "B", "C", "S_max", "H", "D"))
    layer = L // 3
    g = torch.Generator(device=DEV).manual_seed(3)
    dt = getattr(torch, dtype)
    kc = torch.randn(L, B, S_max, H * D, generator=g, device=DEV, dtype=dt)
    vc = torch.randn(L, B, S_max, H * D, generator=g, device=DEV, dtype=dt)
    q = torch.randn(B, C, H, D, generator=g, device=DEV, dtype=dt)
    starts = torch.tensor(K3_SHAPE["starts"], dtype=torch.int32, device=DEV)
    out = da.chunk_prefill_attention(q, kc, vc, starts, layer=layer)
    torch.cuda.synchronize()
    want = da.chunk_prefill_attention_plain(q, kc[layer], vc[layer], starts)
    err = check_close("K3 chunk_prefill_attention", out, want, dtype)
    rec = {"kernel": "K3 chunk_prefill_attention", "dtype": dtype,
           "q": [B, C, H, D], "cache": [L, B, S_max, H * D],
           "starts": starts.tolist(), "max_abs_err": err, "tol": TOL[dtype]}
    if timed:
        it = iter(range(10 ** 9))
        qh = q.transpose(1, 2).contiguous()
        qpos = starts[:, None].long() + torch.arange(C, device=DEV)[None]
        live = (torch.arange(S_max, device=DEV)[None, None]
                <= qpos[..., None])[:, None]               # [B, 1, C, S_max]
        heads = [(kc[li].view(B, S_max, H, D).transpose(1, 2).contiguous(),
                  vc[li].view(B, S_max, H, D).transpose(1, 2).contiguous())
                 for li in range(L)]

        def run_library():
            kh, vh = heads[next(it) % L]
            F.scaled_dot_product_attention(qh, kh, vh, attn_mask=live)

        def run_kernel():
            da.chunk_prefill_attention(q, kc, vc, starts, layer=next(it) % L)

        def run_plain():
            li = next(it) % L
            da.chunk_prefill_attention_plain(q, kc[li], vc[li], starts)

        rec.update(time_all("k3", "flash_fwd_kernel", run_kernel, run_plain,
                            run_library, 96))
        del heads
        pairs = int(qpos.sum()) + B * C      # keys pos <= qpos, per row
        es = q.element_size()
        nbytes = (2 * int((starts.long() + C).sum()) * H * D * es  # K/V rows
                  + 2 * q.numel() * es + starts.numel() * 4)
        rec["bound_ms"], rec["bound_by"] = bound(4 * H * D * pairs, nbytes,
                                                 dtype)
    emit(rec)
    return rec


# --------------------------------------------------------------------- #
# The main path: init_inference -> generate for OPT-1.3B
# --------------------------------------------------------------------- #
def counters():
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    return {"flash_attention": fa.flash_attention,
            "decode_attention": da.decode_attention,
            "chunk_prefill_attention": da.chunk_prefill_attention}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def cosine_rows(a, b):
    import torch
    a, b = a.float().flatten(1), b.float().flatten(1)
    return torch.nn.functional.cosine_similarity(a, b, dim=1)


def compare_logits(tag, got, want):
    cos = cosine_rows(got, want)
    top1 = (got.float().argmax(-1) == want.float().argmax(-1)).float().mean()
    rec = {"check": tag, "min_cosine": float(cos.min()),
           "top1_agreement": float(top1)}
    emit(rec)
    if not (float(cos.min()) >= 0.999):
        fail(f"{tag}: kernel-path logits cosine {float(cos.min())} < 0.999 "
             f"against the plain path")
    return rec


def run_generate(eng, ids, new, expect):
    import torch
    from deepspeed_tpu_torch.accelerator import get_accelerator
    accel = get_accelerator(eng.device)
    B, P = ids.shape
    torch.cuda.reset_peak_memory_stats(eng.device)
    reset_counts()
    accel.synchronize(eng.device)
    t0 = time.perf_counter()
    out = eng.generate(ids, max_new_tokens=new)
    accel.synchronize(eng.device)
    dt = time.perf_counter() - t0
    counts = read_counts()
    peak = accel.memory_snapshot(eng.device)["peak_bytes_in_use"]
    V = eng.module.config.vocab_size
    if tuple(out.shape) != (B, P + new):
        fail(f"generate returned {tuple(out.shape)}, expected {(B, P + new)}")
    if not torch.equal(out[:, :P], ids):
        fail("generate did not keep the prompt columns")
    if int(out.min()) < 0 or int(out.max()) >= V:
        fail("generate produced token ids outside the vocabulary")
    for name, n in expect.items():
        if counts[name] != n:
            fail(f"{name}: {counts[name]} launches in this run, the path "
                 f"needs {n}")
    return out, dt, counts, peak


def profile_run(eng, ids, new):
    """The same generate() once more under ``torch.profiler`` (CUDA
    activity only): where its time goes on the card."""
    import torch
    from deepspeed_tpu_torch.profiling.trace import breakdown, kernel_events
    wall = {}

    def run():
        t0 = time.perf_counter()
        eng.generate(ids, max_new_tokens=new)
        torch.cuda.synchronize()
        wall["s"] = time.perf_counter() - t0

    trace = os.path.join(ROOT, "build", "profiles", "generate_trace.json")
    rec = {"profile": "a", **breakdown(kernel_events(run, trace), wall["s"]),
           "trace": os.path.relpath(trace, ROOT)}
    emit(rec)
    return rec


def main_path():
    """Drive init_inference -> generate twice, counting launches per run
    (and run (a) once more under the profiler), then hold the kernel path's
    logits against the plain path's."""
    import torch
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.opt import opt_model
    t0 = time.perf_counter()
    eng = init_inference(opt_model(MODEL), dtype="bfloat16", device=DEV)
    eng.init_params(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    L, V = eng.module.config.num_layers, eng.module.config.vocab_size
    g = torch.Generator(device=DEV).manual_seed(4)
    runs = {}

    # (a) one-pass prefill: "auto" declines to chunk (B * P <= 16384)
    B, P, new = RUN_A["batch"], RUN_A["prompt"], RUN_A["new"]
    ids_a = torch.randint(0, V, (B, P), generator=g, device=DEV)
    plan = eng.prefill_plan(B, P)
    if plan[0] != "one_pass":
        fail(f"run (a) should take one-pass prefill, plan says {plan}")
    eng.generate(ids_a, max_new_tokens=4)     # warm-up (cuBLAS, allocator)
    _, dt, cnt, peak = run_generate(eng, ids_a, new, {
        "flash_attention": L, "decode_attention": L * (new - 1),
        "chunk_prefill_attention": 0})
    runs["a"] = {"run": "a", "route": "one_pass", "batch": B, "prompt": P,
                 "new_tokens": new, "seconds": dt,
                 "tokens_per_s": B * new / dt, "launches": cnt,
                 "peak_device_bytes": peak,
                 "plan": plan[2], "init_seconds": init_s}
    emit(runs["a"])
    runs["a_profile"] = profile_run(eng, ids_a, new)

    # (b) split (chunked) prefill over the same weights
    B, P, new, C = (RUN_B[x] for x in ("batch", "prompt", "new", "chunk"))
    eng_b = init_inference(eng.module, {"prefill_chunk_size": C},
                           dtype="bfloat16", device=DEV)
    ids_b = torch.randint(0, V, (B, P), generator=g, device=DEV)
    plan_b = eng_b.prefill_plan(B, P)
    if plan_b[:2] != ("chunked", C):
        fail(f"run (b) should take chunked prefill, plan says {plan_b}")
    eng_b.generate(ids_b, max_new_tokens=2)   # warm-up
    _, dt, cnt, peak = run_generate(eng_b, ids_b, new, {
        "flash_attention": 0, "decode_attention": L * (new - 1),
        "chunk_prefill_attention": L * (-(-P // C))})
    runs["b"] = {"run": "b", "route": "chunked", "chunk": C, "batch": B,
                 "prompt": P, "new_tokens": new, "seconds": dt,
                 "tokens_per_s": B * new / dt, "launches": cnt,
                 "peak_device_bytes": peak,
                 "plan": plan_b[2]}
    emit(runs["b"])

    # the kernel path's logits against the plain path on the same card and
    # weights: a key-padding mask (all ones: plain causal attention) routes
    # every layer of the uncached forward to the dense reference attention
    m = eng.module
    with torch.no_grad():
        B, P = ids_a.shape
        cache = m.init_cache(B, P + 8, dtype=torch.bfloat16)
        last = torch.full((B,), P - 1, device=DEV)
        got, cache = m.decode(ids_a, cache, 0, logits_at=last, prefill=True)
        want = m.logits(ids_a, torch.ones_like(ids_a))[:, -1:]
        compare_logits("(a) prefill logits, K1 vs plain", got, want)
        nxt = got[:, 0].float().argmax(-1)
        got, cache = m.decode(nxt[:, None], cache, P)
        ids_next = torch.cat([ids_a, nxt[:, None]], 1)
        want = m.logits(ids_next, torch.ones_like(ids_next))[:, -1:]
        compare_logits("(a) first decode step logits, K2 vs plain", got,
                       want)
        del cache
        B, P = ids_b.shape
        cache = m.init_cache(B, P, dtype=torch.bfloat16)
        loc = torch.full((B,), C - 1, device=DEV)
        for c0 in range(0, P, C):
            got, cache = m.decode(ids_b[:, c0:c0 + C], cache, c0,
                                  logits_at=loc)
        want = m.logits(ids_b, torch.ones_like(ids_b))[:, -1:]
        compare_logits("(b) chunked prefill logits, K3 vs plain", got, want)
        del cache
    return runs


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke test runs only on a GPU")
    if not os.path.isdir(os.path.join(ROOT, "deepspeed_tpu_torch")):
        fail("deepspeed_tpu_torch/ is missing: run from a checkout of the "
             "repository")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deepspeed_tpu_torch.ops import op_builder

    t0 = time.perf_counter()
    logs = op_builder.build_all()
    build_s = time.perf_counter() - t0
    ptxas = sorted({line.strip() for log in logs.values()
                    for line in log.splitlines() if "registers" in line})
    emit({"build_seconds": build_s, "built": sorted(logs),
          "ptxas": ptxas})

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi unavailable ({smi.returncode})"
    print(card, flush=True)

    checks = {}
    for dtype in ("float32", "bfloat16"):
        timed = dtype == "bfloat16"
        checks[("K1", dtype)] = check_flash(dtype, timed)
        checks[("K2", dtype)] = check_decode(dtype, timed)
        torch.cuda.empty_cache()
        checks[("K3", dtype)] = check_chunk(dtype, timed)
        torch.cuda.empty_cache()

    runs = main_path()

    def row(key, name, source, replaces, launches):
        c = checks[(key, "bfloat16")]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": c["max_abs_err"], "ms": c["kernel_ms"],
                "call_ms": c["call_ms"],
                "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": c["library_ms"]}

    csrc = "deepspeed_tpu_torch/ops/csrc/"
    pallas = "deepspeed_tpu/ops/transformer/"
    kernels = [
        row("K1", "flash_attention", csrc + "flash_attention.cu",
            pallas + "flash_attention.py:175",
            runs["a"]["launches"]["flash_attention"]),
        row("K2", "decode_attention", csrc + "decode_attention.cu",
            pallas + "decode_attention.py:630",
            runs["a"]["launches"]["decode_attention"]),
        row("K3", "chunk_prefill_attention", csrc + "flash_attention.cu",
            pallas + "decode_attention.py:448",
            runs["b"]["launches"]["chunk_prefill_attention"]),
    ]
    kernels[1]["launches_run_b"] = runs["b"]["launches"]["decode_attention"]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
