"""Kernel build and load layer (port of ``deepspeed_tpu/ops/op_builder.py``).

Each CUDA source under ``ops/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries land
in ``build/torch_kernels/`` at the root of the checkout, named by a hash
of their sources and flags: the first call after a change rebuilds, later
calls reuse the file.  ``build_all()`` starts one ``nvcc`` per library at
once and waits for all of them.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when it is not 0.  Nothing here runs at import time.

Each kernel wrapper counts its launches in attributes of its own
(``decode_attention.launches``, ...), registered here with
:func:`launch_counters`, so a captured CUDA graph
(``model_implementations/features/cuda_graph.py``) can add the launches
its capture recorded on every replay.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v")

# pointer / stream arguments must be c_void_p: ctypes would pass a bare
# Python int as a 32-bit int and cut the address
P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# every kernel wrapper's launch counters, ``(wrapper, attribute)``
LAUNCH_COUNTERS = []


def launch_counters(wrapper, *attrs):
    """Register ``wrapper``'s launch counters ``attrs``, each set to 0.  A
    wrapper adds one to a counter where it launches its kernel."""
    for attr in attrs:
        setattr(wrapper, attr, 0)
        LAUNCH_COUNTERS.append((wrapper, attr))


def launch_counts():
    """Every registered counter's value, in registration order."""
    return [getattr(w, a) for w, a in LAUNCH_COUNTERS]


def add_launch_counts(delta):
    """Add ``delta`` (values in registration order, possibly fewer than
    the counters) to the counters."""
    for (w, a), n in zip(LAUNCH_COUNTERS, delta):
        if n:
            setattr(w, a, getattr(w, a) + n)


class KernelLibrary:
    """One CUDA source (plus the shared headers) compiled into one shared
    library.  ``signatures`` maps each exported C function to its
    ``argtypes``; every function returns an ``int``: a CUDA error code, or
    a size for the queries (``*_smem``, ``dstt_decode_tile_positions``)."""

    def __init__(self, name, source, signatures):
        self.name = name
        self.source = CSRC / source
        self.signatures = signatures
        self._lib = None
        self._lock = threading.Lock()

    def _inputs(self):
        return [self.source] + sorted(CSRC.glob("*.cuh"))

    def lib_path(self):
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in self._inputs():
            h.update(p.name.encode())
            h.update(p.read_bytes())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def start_build(self):
        """Start ``nvcc`` for this library unless it is built already;
        returns the running process, or None."""
        out = self.lib_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp),
               str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.dstt_out = (tmp, out, cmd)
        return proc

    def load(self):
        """The loaded library, building it first if needed."""
        with self._lock:
            if self._lib is None:
                proc = self.start_build()
                if proc is not None:
                    _finish(proc)
                lib = ctypes.CDLL(str(self.lib_path()))
                for fn, argtypes in self.signatures.items():
                    f = getattr(lib, fn)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
                self._lib = lib
            return self._lib


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return str(path)


def _finish(proc):
    log, _ = proc.communicate()
    tmp, out, cmd = proc.dstt_out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return log


def check(err, what):
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def check_tma(what, name, t):
    """The 16-bit kernels (K1 / K3 / K7, K4 / K5, K8) load tiles by TMA,
    which needs a 16-byte aligned address and (b, s, h) strides of whole
    16-byte units; raise (no fallback) for a tensor that breaks either."""
    size = t.element_size()
    if t.data_ptr() % 16 or any(st * size % 16 for st in t.stride()[:3]):
        raise ValueError(
            f"{what}: {name} (strides {tuple(t.stride())}, "
            f"address {t.data_ptr():#x}) breaks TMA's 16-byte rules: the "
            f"address and the (b, s, h) strides in bytes must be multiples "
            f"of 16")


FLASH = KernelLibrary("flash_attention", "flash_attention.cu", {
    # q, k, v, o, lse, q_offsets, dtype, B, Sq, H, KVH, D, Sk,
    # 12 strides (b, s, h for q, k, v, o), causal, scale, stream
    "dstt_flash_attention_fwd":
        [P, P, P, P, P, P, I, I, I, I, I, I, I] + [L] * 12 + [I, F, P],
    # K3 on an int8-KV cache: q, k, v, k_scale, v_scale, o, starts, dtype,
    # B, Sq, H, KVH, D, S_max, 6 strides (b, s, h for q and o), scale,
    # stream
    "dstt_chunk_prefill_int8":
        [P] * 7 + [I] * 7 + [L] * 6 + [F, P],
    # K7: q, k_pool, v_pool, k_scale, v_scale (null: float pool), o,
    # starts, pages, dtype, B, Sq, H, KVH, D, num_pages, page, n_virt,
    # box_rows, 6 strides (b, s, h for q and o), scale, stream
    "dstt_paged_chunk_prefill":
        [P] * 8 + [I] * 10 + [L] * 6 + [F, P],
    # dtype, int8 (1: int8-KV), D -> dynamic shared memory bytes
    "dstt_flash_attention_fwd_smem": [I, I, I],
})

FLASH_BWD = KernelLibrary("flash_attention_bwd", "flash_attention_bwd.cu", {
    # q, k, v, dout, lse, delta, dq, dtype, B, Sq, H, KVH, D, Sk,
    # 15 strides (b, s, h for q, k, v, dout, dq), causal, scale, stream
    "dstt_flash_attention_bwd_dq":
        [P, P, P, P, P, P, P, I, I, I, I, I, I, I] + [L] * 15 + [I, F, P],
    # q, k, v, dout, lse, delta, dk, dv, dtype, B, Sq, H, KVH, D, Sk,
    # 15 strides (b, s, h for q, k, v, dout, and dk = dv), causal, scale,
    # stream
    "dstt_flash_attention_bwd_dkv":
        [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I] + [L] * 15
        + [I, F, P],
    # kernel (0: dq, 1: dk / dv), dtype, D -> dynamic shared memory bytes
    "dstt_flash_attention_bwd_smem": [I, I, I],
})

DECODE = KernelLibrary("decode_attention", "decode_attention.cu", {
    # q, k_cache, v_cache, k_scale, v_scale (null: float cache), lengths,
    # new_k, new_v, out, dtype, B, H, KVH, D, S_max, window (0: none),
    # hpb (kv heads a block), scale, stream
    "dstt_decode_attention": [P] * 9 + [I] * 8 + [F, P],
    # K6: q, k_pool, v_pool, k_scale, v_scale, lengths, pages, new_k,
    # new_v, out, dtype, B, H, KVH, D, page, n_virt, window, hpb, scale,
    # stream
    "dstt_paged_decode_attention": [P] * 10 + [I] * 9 + [F, P],
    # cache_bytes, D, hpb -> positions of one decode_kernel tile
    "dstt_decode_tile_positions": [I] * 3,
    # int8 x int8: q, k_cache, v_cache, k_scale, v_scale, lengths, out,
    # dtype, B, H, KVH, D, S_max, block_k, window, hpb, scale, stream
    "dstt_decode_attention_i8mm": [P] * 7 + [I] * 9 + [F, P],
    # q, k_pool, v_pool, k_scale, v_scale, lengths, pages, out, dtype, B,
    # H, KVH, D, page, n_virt, block_k, window, hpb, scale, stream
    "dstt_paged_decode_attention_i8mm": [P] * 8 + [I] * 10 + [F, P],
    # D, G, hpb, paged (1: K6), block_k -> dynamic shared memory bytes of
    # a decode_i8mm_kernel launch
    "dstt_decode_i8mm_smem": [I] * 5,
})

SPARSE = KernelLibrary("block_sparse_attention", "block_sparse_attention.cu", {
    # K8: q, k, v, o, lse (null: none), idx, counts (fp32), tiles,
    # tile_counts (bf16 / fp16), bias (null: none), dtype, B, S, H, D, A,
    # T (tiles' width), block, 12 strides (b, s, h for q, k, v, o), causal,
    # scale, stream
    "dstt_block_sparse_attention_fwd":
        [P] * 10 + [I] * 8 + [L] * 12 + [I, F, P],
    # dtype, D, block -> dynamic shared memory bytes of that launch
    "dstt_block_sparse_attention_fwd_smem": [I, I, I],
})

LIBRARIES = (FLASH, FLASH_BWD, DECODE, SPARSE)


def build_all():
    """Build every kernel library at once (one ``nvcc`` each, started
    together); returns ``{name: compiler output}`` for the ones built."""
    procs = [(lib, lib.start_build()) for lib in LIBRARIES]
    logs = {}
    for lib, proc in procs:
        if proc is not None:
            logs[lib.name] = _finish(proc)
    for lib in LIBRARIES:
        lib.load()
    return logs


DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2}


def dtype_code(dtype):
    name = str(dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"CUDA kernels take float32/bfloat16/float16, "
                        f"got {dtype}")
    return DTYPE_CODES[name]
