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

# kernel-name patterns -> group (first match wins)
GROUPS = (("K1 flash_fwd_kernel", ("flash_fwd_kernel",)),
          ("K4 flash_bwd_dq_kernel", ("flash_bwd_dq_kernel",)),
          ("K5 flash_bwd_dkv_kernel", ("flash_bwd_dkv_kernel",)),
          ("K2 decode_kernel", ("decode_kernel",)),
          ("GEMM (cuBLAS)", ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                             "splitKreduce")),
          ("layer norm", ("layer_norm", "LayerNorm")),
          ("optimizer / grad norm (foreach)", ("multi_tensor_apply",)),
          ("embedding", ("embedding", "indexing_backward")),
          ("softmax / sampling", ("softmax", "argmax", "reduce")),
          ("copy / cast / index", ("copy", "Copy", "index", "cat", "fill",
                                   "Fill")),
          ("elementwise", ("elementwise", "vectorized")))
# profiler windows tried before an empty trace is an error
PROFILE_ATTEMPTS = 3


def _group(name):
    for group, pats in GROUPS:
        if any(p in name for p in pats):
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


def kernel_events(fn, path):
    """Run ``fn()`` under ``torch.profiler`` (CUDA activity), write the
    Chrome trace to ``path`` and return its kernel events as dicts with
    ``name``, ``ts`` and ``dur`` (microseconds).  A trace with no kernel
    at all is a profiler miss (seen once on an H100, in a window of 50
    short launches that an identical run had traced): each miss is
    printed to stderr and ``fn`` runs again under a fresh profiler, so
    ``fn`` must be safe to repeat; after ``PROFILE_ATTEMPTS`` empty
    traces this raises."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
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
        if kernels:
            return kernels
        print(f"profiler recorded no device kernels (attempt "
              f"{attempt + 1} of {PROFILE_ATTEMPTS})", file=sys.stderr,
              flush=True)
    raise RuntimeError("the profiler recorded no device kernels")


def device_ms_per_call(fn, iters, path, name=None):
    """Device time per call of ``fn``: the summed duration of the kernels
    it launches over ``iters`` calls, divided by ``iters`` — only kernels
    whose name contains ``name`` when given (then divided by their count,
    which is the time per launch of that kernel)."""
    fn()                                    # warm-up outside the window

    def loop():
        for _ in range(iters):
            fn()

    ks = kernel_events(loop, path)
    if name is not None:
        ks = [e for e in ks if name in e["name"]]
        if not ks:
            raise RuntimeError(f"no kernel named like {name!r} ran")
        return sum(e["dur"] for e in ks) / 1e3 / len(ks)
    return sum(e["dur"] for e in ks) / 1e3 / iters
