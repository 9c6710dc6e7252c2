"""Build and load the host (C++) libraries (port of
``deepspeed_tpu/ops/native_build.py``).

The shared sources under ``csrc/`` at the root of the checkout (the host
Adam / Adagrad of ZeRO-Offload, ``csrc/adam/cpu_adam.cpp``, and the
asynchronous file I/O of the NVMe tier, ``csrc/aio/aio.cpp``) are compiled
by ``g++`` into shared libraries with a plain C interface and loaded with
``ctypes``.  The flags are the JAX package's first flag set
(``-O3 -std=c++17 -shared -fPIC -march=native``, and ``-fopenmp`` for the
optimizer), so both packages run the same machine code.

Unlike the JAX package, nothing degrades: a failed compile raises, with
the compiler's output, and no flag set is tried in its place.  Libraries
land in ``build/torch_kernels/`` beside the CUDA ones, named by a hash of
their sources, their flags, the compiler and the host's CPU
(``-march=native`` code built on one machine may not run on another that
shares the checkout);
the build writes a name of its own and
``os.replace``-s it into place, so processes building at once do not
clash.  Nothing here runs at import time.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

from deepspeed_tpu_torch.ops.op_builder import BUILD_DIR
from deepspeed_tpu_torch.utils.logging import logger

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(os.path.dirname(_PKG), "csrc")
BASE_FLAGS = ("-shared", "-fPIC", "-std=c++17", "-O3", "-march=native")
OPENMP_FLAGS = ("-fopenmp",)

_lock = threading.Lock()
_loaded = {}


def csrc_path(*parts):
    """A shared source under ``csrc/``; raises when it is not there."""
    path = os.path.join(CSRC, *parts)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"host source {path} is missing: the host libraries build from "
            f"csrc/ at the root of a checkout of the repository")
    return path


def compiler(want_openmp=True):
    """The C++ compiler: ``$CXX`` or else the first ``g++`` on ``PATH``;
    for an OpenMP library the first of those that links OpenMP (its
    ``libgomp.spec`` exists).  A machine may name a toolchain without
    OpenMP in ``$CXX`` or put one first on ``PATH``; passing it over (with
    a warning for ``$CXX``) changes no flag.  Raises when there is none."""
    return _find_compiler(want_openmp, os.environ.get("CXX") or "",
                          os.environ.get("PATH", ""))


def _has_openmp(cxx):
    spec = subprocess.run([cxx, "-print-file-name=libgomp.spec"],
                          capture_output=True, text=True).stdout.strip()
    return os.path.isabs(spec) and os.path.exists(spec)


@functools.lru_cache(maxsize=None)
def _find_compiler(want_openmp, cxx_env, path_env):
    found = [shutil.which(cxx_env)] if cxx_env else []
    if cxx_env and not found[0]:
        raise RuntimeError(f"no C++ compiler {cxx_env!r} ($CXX): the host "
                           f"libraries cannot be built")
    for d in path_env.split(os.pathsep):
        cxx = os.path.join(d, "g++")
        if os.access(cxx, os.X_OK) and os.path.realpath(cxx) not in {
                os.path.realpath(f) for f in found}:
            found.append(cxx)
    for cxx in found:
        if not want_openmp or _has_openmp(cxx):
            if cxx_env and cxx != found[0]:
                logger.warning(f"$CXX={cxx_env} cannot link OpenMP "
                               f"(no libgomp.spec); building with {cxx}")
            return cxx
    raise RuntimeError(
        "no C++ compiler (g++) on PATH" + (
            f" with OpenMP (libgomp.spec; tried {found})" if found else "")
        + ": the host optimizer and aio libraries cannot be built (set "
        "CXX to a g++ that links -fopenmp)")


def flags(want_openmp=True):
    return BASE_FLAGS + (OPENMP_FLAGS if want_openmp else ())


def host_cpu():
    """The host CPU's model name and feature flags (what ``-march=native``
    compiles for), from ``/proc/cpuinfo``."""
    keep = ("model name", "flags", "Features", "CPU part")
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.split(":")[0].strip() in keep]
    except OSError:
        return ""
    return "".join(sorted(set(lines)))


def lib_path(name, sources, want_openmp=True):
    h = hashlib.sha256(" ".join(flags(want_openmp)).encode())
    h.update(compiler(want_openmp).encode())
    h.update(host_cpu().encode())
    for src in sources:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(str(BUILD_DIR), f"{name}-{h.hexdigest()[:16]}.so")


def jit_build(name, sources, want_openmp=True):
    """Compile ``sources`` into ``build/torch_kernels/`` unless built
    already; returns the library's path.  Raises with the compiler's output
    when the compile fails (a missing ``-fopenmp`` included)."""
    out = lib_path(name, sources, want_openmp)
    if os.path.exists(out):
        return out
    with _lock:
        if os.path.exists(out):
            return out
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [compiler(want_openmp), *flags(want_openmp), *sources, "-o",
               tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"failed to build host library {name} "
                    f"({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def load_library(name, sources, want_openmp=True):
    """:func:`jit_build`, then ``ctypes.CDLL``, once per process."""
    key = (name, tuple(sources), want_openmp)
    if key not in _loaded:
        _loaded[key] = ctypes.CDLL(jit_build(name, sources, want_openmp))
    return _loaded[key]
