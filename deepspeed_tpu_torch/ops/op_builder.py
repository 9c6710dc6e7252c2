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


class KernelLibrary:
    """One CUDA source (plus the shared headers) compiled into one shared
    library.  ``signatures`` maps each exported C function to its
    ``argtypes``; every function returns an ``int`` CUDA error code."""

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


FLASH = KernelLibrary("flash_attention", "flash_attention.cu", {
    # q, k, v, o, lse, q_offsets, dtype, B, Sq, H, KVH, D, Sk,
    # 12 strides (b, s, h for q, k, v, o), causal, scale, stream
    "dstt_flash_attention_fwd":
        [P, P, P, P, P, P, I, I, I, I, I, I, I] + [L] * 12 + [I, F, P],
})

DECODE = KernelLibrary("decode_attention", "decode_attention.cu", {
    # q, k_cache, v_cache, lengths, new_k, new_v, out,
    # dtype, B, H, KVH, D, S_max, scale, stream
    "dstt_decode_attention": [P, P, P, P, P, P, P, I, I, I, I, I, I, F, P],
})

LIBRARIES = (FLASH, DECODE)


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
