#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

1. builds the attention kernels from ``deepspeed_tpu_torch/ops/csrc`` with
   ``nvcc`` for sm_90a (one compiler process per source, started together);
2. holds each kernel against its plain PyTorch version on the card at the
   shapes OPT-1.3B's serving and training paths give it (bf16 at atol =
   rtol = 2e-2, the output's bf16 rounding, except the backward kernels,
   see ``BWD_BF16_REL``; fp32 at 1e-4, summation order), and times
   kernel, plain version and ``F.scaled_dot_product_attention`` (forward,
   or its backward for K4 / K5: a yardstick the port never calls) by
   their device time in ``torch.profiler``'s kernel records, beside the
   card's bound;
3. drives the port's serving path — ``init_inference(opt_model("opt-1.3b"))``
   with seeded random weights, then ``generate`` — once with one-pass
   prefill (a) and once with chunked prefill (b), counting each kernel's
   launches in each run, and checks the outputs against the plain path on
   the card; run (a) goes once more under ``torch.profiler``, and a
   ``profile`` line gives its device busy time, idle share and device time
   by kernel group (trace in ``build/profiles/generate_trace.json``);
4. drives the port's training path (c) — ``initialize(opt_model(
   "opt-1.3b", max_seq_len=2048))`` with bf16, AdamW and clipping, then
   ``train_batch`` on one seeded [2, 2048] batch, 2 warm-up and 5 timed
   steps — counting 24 K1, 24 K4 and 24 K5 launches per step, checking that
   the loss is finite and falls, and profiling one more step; then holds
   the kernel path's loss and gradients against the dense attention's on a
   2-layer cut of the same widths (cosine per parameter);
5. prints the card, a ``kernels`` JSON line and, last, the result line.

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
# the LSE is an fp32 result on both sides (summation order apart), and
# every gradient of K4 / K5 goes through exp(s - lse)
LSE_TOL = TOL["float32"]
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
# the training path (c): OPT-1.3B at seq 2048, micro batch 2, and the
# shapes its attention kernels (K1 with LSE, K4, K5) see in every layer
RUN_C = dict(micro=2, seq=2048, loss_chunks=8, warmup=2, steps=5)
KB_SHAPE = dict(B=2, S=2048, H=32, D=64)
TRAIN_CONFIG = {"train_micro_batch_size_per_gpu": RUN_C["micro"],
                "gradient_accumulation_steps": 1,
                "optimizer": {"type": "AdamW",
                              "params": {"lr": 9.65e-6, "weight_decay": 0.0}},
                "bf16": {"enabled": True},
                "gradient_clipping": 1.0,
                "zero_optimization": {"stage": 0},
                "seed": 0}
# K4 / K5 in bf16 against the fp32 plain backward of the same bf16 inputs:
# both sum in fp32, then the kernel rounds each gradient to bf16, which is
# off by at most half an ulp (2^-8 of the value, <= 2^-8 of the largest
# |gradient|); the bar is twice that, for the fp32 summation order
BWD_BF16_REL = 2.0 ** -7
# gradient check, kernel path vs dense attention, on a 2-layer cut
GRAD_CHECK = dict(layers=2, batch=2, seq=2048, loss_rel=1e-2, cosine=0.99)


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


def check_close(name, got, want, dtype, tol=None):
    import torch
    tol = TOL[dtype] if tol is None else tol
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got.float(), want.float(), atol=tol, rtol=tol)
    err = max_err(got, want)
    if not ok:
        fail(f"{name} ({dtype}) disagrees with its plain version: "
             f"max_abs_err={err} (atol=rtol={tol})")
    return err


def check_lse(name, got, want, dtype):
    """K1's LSE is fp32 on both sides, from the same inputs, whatever the
    inputs' dtype: it is held to the fp32 bar in every dtype."""
    return check_close(name, got, want, dtype, tol=LSE_TOL)


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
    lse_err = check_lse("K1 flash_attention lse", lse, want_lse, dtype)
    rec = {"kernel": "K1 flash_attention", "dtype": dtype,
           "shape": [B, S, H, D], "causal": True, "max_abs_err": err,
           "tol": TOL[dtype], "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL}
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


def check_rel(name, got, want, rel):
    """max |got - want| <= rel * max |want| (a bar scaled by the output's
    magnitude); returns the max abs error."""
    import torch
    err = max_err(got, want)
    top = float(want.float().abs().max())
    if not (bool(torch.isfinite(got).all()) and err <= rel * top):
        fail(f"{name} disagrees with its plain version: max_abs_err={err}, "
             f"bar {rel} * max|want| = {rel * top}")
    return err


def check_flash_bwd(dtype, timed):
    """K1 (with the LSE, as the training forward launches it), K4 and K5 at
    the training path's shapes: causal, q/k/v/dO [2, 2048, 32, 64], the
    power-of-two scale folded into q as the autograd wrapper folds it."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    B, S, H, D = (KB_SHAPE[x] for x in "BSHD")
    g = torch.Generator(device=DEV).manual_seed(5)
    dt = getattr(torch, dtype)
    q, k, v, dout = (torch.randn(B, S, H, D, generator=g, device=DEV,
                                 dtype=dt) for _ in range(4))
    q = q * torch.tensor(1 / math.sqrt(D), dtype=dt)
    out, lse = fa.launch_attention_kernel(q, k, v, True, 1.0, None, True)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, dout, True, 1.0)
    torch.cuda.synchronize()
    want, want_lse = fa.flash_attention_plain(q, k, v, causal=True, scale=1.0)
    k1_err = check_close("K1 flash_attention (training shape)", out, want,
                         dtype)
    lse_err = check_lse("K1 flash_attention lse (training shape)", lse,
                        want_lse, dtype)
    # the plain backward in fp32 from the same (16-bit) inputs
    ref = fa.flash_attention_bwd_plain(
        *(t.float() for t in (q, k, v, out)), lse, dout.float(), True, 1.0)
    errs = {}
    for name, got, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        tag = f"K{4 if name == 'dq' else 5} {name} ({dtype})"
        errs[name] = (check_close(tag, got, r, dtype) if dtype == "float32"
                      else check_rel(tag, got, r, BWD_BF16_REL))
    del ref, want
    tol = TOL[dtype] if dtype == "float32" else f"{BWD_BF16_REL} * max|want|"
    recs = {
        "K1": {"kernel": "K1 flash_attention (training, with lse)",
               "dtype": dtype, "max_abs_err": k1_err, "tol": TOL[dtype],
               "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL},
        "K4": {"kernel": "K4 flash_attention_dq", "dtype": dtype,
               "max_abs_err": errs["dq"], "tol": tol},
        "K5": {"kernel": "K5 flash_attention_dkv", "dtype": dtype,
               "max_abs_err": max(errs["dk"], errs["dv"]),
               "max_abs_err_dk": errs["dk"], "max_abs_err_dv": errs["dv"],
               "tol": tol},
    }
    for rec in recs.values():
        rec.update(shape=[B, S, H, D], causal=True)
    if timed:
        delta = fa._delta(out, dout)
        qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        oh = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                            scale=1.0)
        doh = dout.transpose(1, 2).contiguous()

        def sdpa_backward():       # dq, dk and dv in one library call
            torch.autograd.grad(oh, (qh, kh, vh), doh, retain_graph=True)

        def plain_backward():      # the plain version of K4 and K5 together
            fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, True, 1.0)

        with torch.no_grad():
            recs["K1"].update(time_all(
                "k1_train", "flash_fwd_kernel",
                lambda: fa.launch_attention_kernel(q, k, v, True, 1.0, None,
                                                   True),
                lambda: fa.flash_attention_plain(q, k, v, True, 1.0),
                lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=True, scale=1.0), 20))
        recs["K4"].update(time_all(
            "k4", "flash_bwd_dq_kernel",
            lambda: fa.flash_attention_dq(q, k, v, dout, lse, delta, True,
                                          1.0),
            plain_backward, sdpa_backward, 20))
        recs["K5"].update(time_all(
            "k5", "flash_bwd_dkv_kernel",
            lambda: fa.flash_attention_dkv(q, k, v, dout, lse, delta, True,
                                           1.0),
            plain_backward, sdpa_backward, 20))
        pairs = B * H * S * (S + 1) // 2        # causal (q, k) pairs
        tensor = q.numel() * q.element_size()   # one [B, S, H, D] tensor
        rows = B * H * S * 4                    # one fp32 [B, H, S] row set
        # K1: q, k, v read, out and lse written; 2 products of 2D flops
        recs["K1"]["bound_ms"], recs["K1"]["bound_by"] = bound(
            4 * D * pairs, 4 * tensor + rows, dtype)
        # K4: q, k, v, dO, lse, delta read, dq written; S, dP, dQ
        recs["K4"]["bound_ms"], recs["K4"]["bound_by"] = bound(
            6 * D * pairs, 5 * tensor + 2 * rows, dtype)
        # K5: the same reads, dk and dv written; S, dP, dV, dK
        recs["K5"]["bound_ms"], recs["K5"]["bound_by"] = bound(
            8 * D * pairs, 6 * tensor + 2 * rows, dtype)
    for rec in recs.values():
        emit(rec)
    return recs


# --------------------------------------------------------------------- #
# The main path: init_inference -> generate for OPT-1.3B
# --------------------------------------------------------------------- #
def counters():
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    return {"flash_attention": fa.flash_attention,
            "decode_attention": da.decode_attention,
            "chunk_prefill_attention": da.chunk_prefill_attention,
            "flash_attention_dq": fa.flash_attention_dq,
            "flash_attention_dkv": fa.flash_attention_dkv}


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
        "chunk_prefill_attention": 0, "flash_attention_dq": 0,
        "flash_attention_dkv": 0})
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
        "chunk_prefill_attention": L * (-(-P // C)),
        "flash_attention_dq": 0, "flash_attention_dkv": 0})
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


# --------------------------------------------------------------------- #
# The training path: initialize -> train_batch for OPT-1.3B
# --------------------------------------------------------------------- #
def train_path():
    """Run (c): warm-up steps, timed steps with launch counts, one profiled
    step.  Returns the run's record."""
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.opt import opt_model
    from deepspeed_tpu_torch.profiling.trace import breakdown, kernel_events
    micro, S, steps = RUN_C["micro"], RUN_C["seq"], RUN_C["steps"]
    t0 = time.perf_counter()
    engine, *_ = initialize(
        model=opt_model(MODEL, max_seq_len=S, loss_seq_chunks=RUN_C[
            "loss_chunks"], remat=False, dtype="bfloat16"),
        config=TRAIN_CONFIG, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    L, V = engine.module.config.num_layers, engine.module.config.vocab_size
    n_params = sum(p.numel() for p in engine.params)
    g = torch.Generator(device=DEV).manual_seed(6)
    batch = {"input_ids": torch.randint(0, V, (1, micro, S), generator=g,
                                        device=DEV)}
    losses = [engine.train_batch(batch=batch)
              for _ in range(RUN_C["warmup"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(DEV)
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(engine.train_batch(batch=batch))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    peak = engine.max_memory_allocated()
    losses = torch.stack(losses).float().tolist()
    per_step = {name: n / steps for name, n in counts.items()}
    want = {"flash_attention": L, "flash_attention_dq": L,
            "flash_attention_dkv": L, "decode_attention": 0,
            "chunk_prefill_attention": 0}
    if per_step != want:
        fail(f"run (c): launches per step {per_step}, the path needs {want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"run (c): non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"run (c): the loss did not fall on a repeated batch: {losses}")
    tok_s = steps * micro * S / dt
    rec = {"run": "c", "route": "train_batch", "micro_batch": micro,
           "seq": S, "layers": L, "params": n_params, "steps": steps,
           "step_ms": dt / steps * 1e3, "tokens_per_s": tok_s,
           "mfu": 6 * n_params * tok_s / PEAK_FLOPS["bfloat16"],
           "peak_device_bytes": peak, "losses": losses,
           "launches": counts, "launches_per_step": per_step,
           "init_seconds": init_s}
    emit(rec)

    wall = {}

    def one_step():
        t = time.perf_counter()
        engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        wall["s"] = time.perf_counter() - t

    trace = os.path.join(ROOT, "build", "profiles", "train_trace.json")
    emit({"profile": "c", **breakdown(kernel_events(one_step, trace),
                                      wall["s"]),
          "trace": os.path.relpath(trace, ROOT)})
    del engine, batch
    torch.cuda.empty_cache()
    return rec


def grad_check():
    """Loss and every parameter's gradient through K1 / K4 / K5 against
    the dense reference attention, on OPT-1.3B's widths cut to 2 layers,
    bf16, the same weights and batch."""
    import torch
    from deepspeed_tpu_torch.models.opt import opt_model
    n, B, S = (GRAD_CHECK[x] for x in ("layers", "batch", "seq"))
    kw = dict(device=DEV, num_layers=n, max_seq_len=S, remat=False,
              loss_seq_chunks=RUN_C["loss_chunks"], dtype="bfloat16")
    flash = opt_model(MODEL, use_flash_attention=True, **kw)
    flash.init_weights(torch.Generator(device=DEV).manual_seed(7))
    dense = opt_model(MODEL, use_flash_attention=False, **kw)
    dense.load_state_dict(flash.state_dict())
    g = torch.Generator(device=DEV).manual_seed(8)
    ids = torch.randint(0, flash.config.vocab_size, (B, S), generator=g,
                        device=DEV)
    losses = []
    for m in (flash, dense):
        loss = m({"input_ids": ids})
        loss.backward()
        losses.append(float(loss.detach()))
    # a key bias shifts every score of a row alike, which the softmax
    # ignores: its true gradient is 0 and both paths give roundoff
    cos = {name: float(torch.nn.functional.cosine_similarity(
        p.grad.flatten().float(), q.grad.flatten().float(), dim=0))
        for (name, p), (_, q) in zip(flash.named_parameters(),
                                     dense.named_parameters())
        if not name.endswith("attn.k_proj.bias")}
    worst = min(cos, key=cos.get)
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    rec = {"check": "grad: K1/K4/K5 vs dense attention", "layers": n,
           "batch": B, "seq": S, "loss_flash": losses[0],
           "loss_dense": losses[1], "loss_rel_diff": rel,
           "min_grad_cosine": cos[worst], "min_grad_cosine_param": worst,
           "params": len(cos)}
    emit(rec)
    if not rel <= GRAD_CHECK["loss_rel"]:
        fail(f"grad check: losses differ by {rel} relative "
             f"(bar {GRAD_CHECK['loss_rel']})")
    if not cos[worst] >= GRAD_CHECK["cosine"]:
        fail(f"grad check: gradient cosine {cos[worst]} for {worst} "
             f"(bar {GRAD_CHECK['cosine']})")
    del flash, dense
    torch.cuda.empty_cache()
    return rec


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
        bwd = check_flash_bwd(dtype, timed)
        for key in ("K4", "K5"):
            checks[(key, dtype)] = bwd[key]
        checks[("K1 train", dtype)] = bwd["K1"]
        torch.cuda.empty_cache()

    runs = main_path()
    runs["c"] = train_path()
    grad_check()

    def timing(c):
        return {"max_abs_err": c["max_abs_err"], "ms": c["kernel_ms"],
                "call_ms": c["call_ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": c["library_ms"]}

    def row(key, name, source, replaces, launches):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                **timing(checks[(key, "bfloat16")])}

    csrc = "deepspeed_tpu_torch/ops/csrc/"
    pallas = "deepspeed_tpu/ops/transformer/"
    train = runs["c"]["launches"]
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
        row("K4", "flash_attention_dq", csrc + "flash_attention_bwd.cu",
            pallas + "flash_attention.py:388", train["flash_attention_dq"]),
        row("K5", "flash_attention_dkv", csrc + "flash_attention_bwd.cu",
            pallas + "flash_attention.py:421", train["flash_attention_dkv"]),
    ]
    kernels[1]["launches_run_b"] = runs["b"]["launches"]["decode_attention"]
    # K1 also runs in every layer of run (c), with the LSE, at [2, 2048]
    kernels[0]["launches_run_c"] = train["flash_attention"]
    kernels[0]["run_c_shape"] = timing(checks[("K1 train", "bfloat16")])
    for k in kernels[3:]:
        k["launches_per_step"] = runs["c"]["launches_per_step"][k["name"]]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
