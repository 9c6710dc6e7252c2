#!/usr/bin/env python3
"""Time K8 (the block-sparse attention forward) of several builds on one
card, in turns, at the shapes ``chip_smoke.py`` checks it at.

    python3 scripts/k8_variants.py [--parent DIR] [--patch NAME ...]
                                   [--rounds N]

Each build is timed in a process of its own, in the order parent, this
tree, the patched builds, then the same in reverse (``--rounds`` times):
K8's device time per launch (``torch.profiler`` kernel records of
``*sparse_fwd_kernel``) at run (f)'s shape (``chip_smoke.K8_SHAPE``) and
at every ``chip_smoke.K8_VARIANTS`` shape, in bf16, and at run (f)'s shape
the kernel's max and mean |error| against the plain version in fp32.

- ``--parent DIR``: a checkout of another commit (``git archive`` it into a
  directory ``.gitignore`` lists); its own ``deepspeed_tpu_torch`` and
  kernel sources are built and timed, through its own wrapper.
- ``--patch NAME``: this tree's ``block_sparse_attention.cu`` copied under
  ``build/k8_variants/NAME/`` with one of ``PATCHES`` applied (a text
  replacement that must match exactly once), built and timed.

Every build is compiled first, all at once (one ``nvcc`` each).  Prints
one JSON line per timed process, then a summary line
``{"k8_variants": {build: {case: [ms, ...]}}}``, and the card's name and
power limit.  Needs one CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the alternatives to the kernel's fixed choices: (old, new) text
PATCHES = {
    # a third k / v tile in the ring (3 blocks an SM at D 64)
    "stages3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    # 4 blocks an SM at D 64 for bf16
    "blocks4": [("constexpr int kBlocksD64 = 5;",
                 "constexpr int kBlocksD64 = 4;")],
    # P rounded once to the input type, as K1 rounds it: no P_lo.V
    "round_p": [("""#pragma unroll
    for (int t = 0; t < KT; ++t)                        // O += P_lo.V
      hk::wgmma_rs_ab<T>(acc[t], p_lo, hk::smem_u32(vst) + t * hk::kTileBytes);
""", "")],
}


def patched_library(op_builder, name):
    """This tree's K8 library built from a copy of its source with
    ``PATCHES[name]`` applied, under build/k8_variants/."""
    src = (op_builder.CSRC / "block_sparse_attention.cu").read_text()
    for old, new in PATCHES[name]:
        if src.count(old) != 1:
            raise ValueError(f"patch {name}: {old!r} occurs "
                             f"{src.count(old)} times in the source")
        src = src.replace(old, new)
    path = os.path.join(ROOT, "build", "k8_variants", name,
                        "block_sparse_attention.cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(src)
    return op_builder.KernelLibrary(f"block_sparse_attention_{name}", path,
                                    op_builder.SPARSE.signatures)


def load_chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cases(chip_smoke, bs):
    """(tag, B, S, H, D, block, causal, layout, key-padding mask)."""
    f = chip_smoke.K8_SHAPE
    out = [("run (f)", f["B"], f["S"], f["H"], f["D"],
            chip_smoke.BIGBIRD["block"], True,
            bs.cached_layout(chip_smoke.bigbird(), f["S"], causal=True),
            None)]
    for v in chip_smoke.K8_VARIANTS:
        out.append((v["tag"], v["B"], v["S"], v["H"], v["D"], v["block"],
                    v["causal"], *chip_smoke.k8_layout(v)))
    return out


def worker(tree, name, build_only):
    sys.path.insert(0, tree)
    from deepspeed_tpu_torch.ops import op_builder
    lib = patched_library(op_builder, name) if name in PATCHES else \
        op_builder.SPARSE
    if build_only:                      # ptxas: registers and spills
        proc = lib.start_build()
        log = op_builder._finish(proc) if proc is not None else ""
        kernel = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif kernel and ("spill" in line or "registers" in line):
                print(json.dumps({"build": name, "kernel": kernel,
                                  "ptxas": line.strip()}), flush=True)
        return
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
    from deepspeed_tpu_torch.profiling.trace import device_ms_per_call
    chip_smoke = load_chip_smoke()      # this tree's, for any tree
    op_builder.SPARSE = lib
    new_api = hasattr(bs, "SparseTables")   # a parent before the tile walk
    dev = "cuda"
    res = {"build": name, "tree": tree, "ms": {}}
    trace = os.path.join(ROOT, "build", "profiles", f"k8_{name}.json")
    for tag, B, S, H, D, block, causal, lay, keep in cases(chip_smoke, bs):
        g = torch.Generator(device=dev).manual_seed(S + H + D + block)
        q, k, v = (torch.randn(B, S, H, D, generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        bias = None if keep is None else bs.padding_bias(keep,
                                                         torch.bfloat16, dev)
        if new_api:
            tables = bs.device_tables(lay, H, causal, dev, block)
            plain_tables = (tables.idx, tables.counts)
            args = (tables,)
        else:
            plain_tables = args = bs.device_tables(lay, H, causal, dev)

        def run():
            return bs.block_sparse_attention_fwd(q, k, v, *args, D ** -0.5,
                                                 causal, block, bias)

        with torch.no_grad():
            res["ms"][tag] = device_ms_per_call(run, 20, trace,
                                                name="sparse_fwd_kernel")
            if tag == "run (f)":
                got = run().float()
                want = bs.block_sparse_attention_plain(
                    q.float(), k.float(), v.float(), *plain_tables,
                    D ** -0.5, causal, block)
                err = (got - want).abs()
                res["max_abs_err"] = float(err.max())
                res["mean_abs_err"] = float(err.mean())
        del q, k, v
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--patch", action="append", default=[],
                    choices=sorted(PATCHES))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", nargs=2, metavar=("TREE", "NAME"))
    ap.add_argument("--build-only", action="store_true")
    a = ap.parse_args()
    if a.worker:
        worker(*a.worker, a.build_only)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("k8_variants: no CUDA device")
    builds = []
    if a.parent:
        builds.append((os.path.abspath(a.parent), "parent"))
    builds.append((ROOT, "change"))
    builds += [(ROOT, name) for name in a.patch]
    me = os.path.abspath(__file__)

    def cmd(b):
        return [sys.executable, me, "--worker", *b]

    procs = [subprocess.Popen(cmd(b) + ["--build-only"]) for b in builds]
    if any(p.wait() for p in procs):
        sys.exit("k8_variants: a build failed")
    order = []
    for _ in range(a.rounds):
        order += builds + builds[::-1]
    summary = {}
    for b in order:
        out = subprocess.run(cmd(b), capture_output=True, text=True)
        if out.returncode:
            sys.exit(f"k8_variants: {b[1]} failed\n{out.stderr[-4000:]}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        for tag, ms in rec["ms"].items():
            summary.setdefault(b[1], {}).setdefault(tag, []).append(ms)
    print(json.dumps({"k8_variants": summary}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi unavailable", flush=True)


if __name__ == "__main__":
    main()
