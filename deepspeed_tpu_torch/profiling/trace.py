"""Device kernel times from ``torch.profiler``.

A host clock (or CUDA events around many calls) measures a small kernel's
wrapper as much as the kernel when the host cannot keep the card fed; the
profiler's kernel records give the device's own time.  The trace is
written as Chrome JSON (``path``) and its kernel events are returned;
:func:`breakdown` sums them by kernel group.
"""

import json
import sys
from pathlib import Path

import torch

# kernel-name patterns -> group (first match wins; a tuple pattern needs
# all its parts: the paged and the int8-KV (int8_t = "signed char")
# instantiations of K2's and K1's templates)
GROUPS = (("K6-i8mm decode_i8mm_kernel (paged)",
           (("decode_i8mm_kernel", "PagedRows"),)),
          ("K2-i8mm decode_i8mm_kernel", ("decode_i8mm_kernel",)),
          ("K6-int8 decode_kernel (paged)",
           (("decode_kernel", "signed char", "PagedRows"),)),
          ("K2-int8 decode_kernel", (("decode_kernel", "signed char"),)),
          ("K7-int8 flash_fwd_kernel (paged)",
           (("flash_fwd_kernel", "signed char", "PagedRows"),)),
          ("K3-int8 flash_fwd_kernel", (("flash_fwd_kernel",
                                         "signed char"),)),
          ("K6 decode_kernel (paged)", (("decode_kernel", "PagedRows"),)),
          ("K7 flash_fwd_kernel (paged)", (("flash_fwd_kernel",
                                            "PagedRows"),)),
          ("K1 flash_fwd_kernel", ("flash_fwd_kernel",)),
          ("K4 flash_bwd_dq_kernel", ("flash_bwd_dq_kernel",)),
          ("K5 flash_bwd_dkv_kernel", ("flash_bwd_dkv_kernel",)),
          ("K2 decode_kernel", ("decode_kernel",)),
          # K8: wgmma_sparse_fwd_kernel (16-bit), block_sparse_fwd_kernel
          ("K8 sparse_fwd_kernel", ("sparse_fwd_kernel",)),
          ("GEMM (cuBLAS)", ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                             "splitKreduce")),
          # advanced-indexing gathers and their scatter-add backward: in a
          # block-sparse training step, the k / v block gathers of K8's
          # gather backward and the scatter-add of their gradients
          ("gather / scatter (index)", ("index_elementwise",
                                        "indexing_backward")),
          ("layer norm", ("layer_norm", "LayerNorm")),
          ("optimizer / grad norm (foreach)", ("multi_tensor_apply",)),
          ("embedding", ("embedding",)),
          ("softmax / sampling", ("softmax", "argmax", "reduce")),
          ("copy / cast / index", ("copy", "Copy", "index", "cat", "fill",
                                   "Fill")),
          ("elementwise", ("elementwise", "vectorized")))
# profiler windows tried before a trace that dropped records is used (or,
# if every one is empty, an error): the profiler drops records on an H100,
# from 1 of 1,524 of this package's kernels in a window of ~25,000 to 49
# of 240 in a window of 240 short launches
PROFILE_ATTEMPTS = 3


def _group(name):
    for group, pats in GROUPS:
        if any(all(part in name for part in
                   (p if isinstance(p, tuple) else (p,))) for p in pats):
            return group
    return "other"


def _union_us(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def breakdown(kernels, wall_s, top=12):
    """Where a call's time went on the device: its wall time, the device's
    busy time (union of kernel intervals) and idle share, the kernel
    launches, and device time by kernel group and by kernel name."""
    busy_us = _union_us([(e["ts"], e["ts"] + e["dur"]) for e in kernels])
    by_group, by_name = {}, {}
    for e in kernels:
        grp = _group(e["name"])
        by_group[grp] = by_group.get(grp, 0.0) + e["dur"] / 1e3
        n, t = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, t + e["dur"] / 1e3)
    heaviest = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"wall_ms": wall_s * 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / (wall_s * 1e6),
            "kernel_launches": len(kernels),
            "device_ms_by_group": dict(sorted(by_group.items(),
                                              key=lambda kv: -kv[1])),
            "top_kernels": [{"name": k[:90], "calls": n, "device_ms": t}
                            for k, (n, t) in heaviest]}


def kernel_events(fn, path, expected=None):
    """Run ``fn()`` under ``torch.profiler`` (CUDA activity), write the
    Chrome trace to ``path`` and return its kernel events as dicts with
    ``name``, ``ts`` and ``dur`` (microseconds).  The profiler can drop
    records: a trace with no kernel at all (seen once on an H100, in a
    window of 50 short launches that an identical run had traced), or,
    with ``expected`` (a function returning, after ``fn``, how many of
    this package's kernels -- names containing ``dstt::`` -- ``fn``
    launched), a trace with fewer of them.  Each miss is printed to
    stderr and ``fn`` runs again under a fresh profiler, so ``fn`` must be
    safe to repeat.  After ``PROFILE_ATTEMPTS`` misses the most complete
    trace is returned (the caller can count what it misses); if every
    trace was empty, this raises."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    best = None                 # (ours, all kernels, kernels)
    for attempt in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())
        events = events.get("traceEvents", events) \
            if isinstance(events, dict) else events
        kernels = [e for e in events
                   if e.get("cat") == "kernel" and "dur" in e]
        ours = sum("dstt::" in e["name"] for e in kernels)
        want = None if expected is None else expected()
        if kernels and (want is None or ours >= want):
            return kernels
        print(f"profiler recorded {len(kernels)} device kernels, {ours} of "
              f"this package's where {want} ran (attempt {attempt + 1} of "
              f"{PROFILE_ATTEMPTS})", file=sys.stderr, flush=True)
        if kernels and (best is None or (ours, len(kernels)) > best[:2]):
            best = (ours, len(kernels), kernels)
    if best is None:
        raise RuntimeError("the profiler recorded no device kernels "
                           f"{PROFILE_ATTEMPTS} times")
    print(f"using the trace with {best[0]} of this package's kernels",
          file=sys.stderr, flush=True)
    return best[2]


def device_ms_per_call(fn, iters, path, name=None, alone=False):
    """Device time per call of ``fn``: the summed duration of the kernels
    it launches over ``iters`` calls, divided by ``iters`` -- or, with
    ``name``, the mean duration of the kernels whose name contains
    ``name`` (the time per launch of that kernel).  ``alone``: each call
    launches exactly one kernel, this package's and named like ``name``,
    so the time per launch is the time per call; a trace holding any
    other kernel, or more than ``iters`` of them, raises.  A record the
    profiler dropped then removes one sample of the mean and biases
    nothing."""
    fn()                                    # warm-up outside the window

    def loop():
        for _ in range(iters):
            fn()

    ks = kernel_events(loop, path, expected=(lambda: iters) if alone
                       else None)
    if name is not None:
        if alone and (len(ks) > iters or any(
                name not in e["name"] or "dstt::" not in e["name"]
                for e in ks)):
            raise RuntimeError(
                f"{len(ks)} kernels over {iters} calls, not one "
                f"{name!r} a call: "
                f"{sorted({e['name'][:60] for e in ks})}")
        ks = [e for e in ks if name in e["name"]]
        if not ks:
            raise RuntimeError(f"no kernel named like {name!r} ran")
        return sum(e["dur"] for e in ks) / 1e3 / len(ks)
    return sum(e["dur"] for e in ks) / 1e3 / iters
