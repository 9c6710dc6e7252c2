"""Asynchronous tensor file I/O, the NVMe tier's binding (port of
``deepspeed_tpu/ops/aio/__init__.py``).

An :class:`AsyncIOHandle` owns a pool of I/O threads of the shared C++
library ``csrc/aio/aio.cpp`` (``pread`` / ``pwrite`` in ``block_size``
chunks spread over the pool), built by :mod:`ops.native_build` at first
use and bound with ``ctypes``.  Buffers are contiguous CPU tensors (any
dtype; their bytes move).  A failed build raises: there is no fallback.
"""

import ctypes

import torch

AIO_DEFAULT_BLOCK_SIZE = 1 << 20
AIO_DEFAULT_THREADS = 8

_lib = None


def load():
    """Build (if needed) and load the aio library."""
    global _lib
    if _lib is None:
        from deepspeed_tpu_torch.ops.native_build import (csrc_path,
                                                          load_library)
        lib = load_library("ds_aio", [csrc_path("aio", "aio.cpp")],
                           want_openmp=False)
        P, L = ctypes.c_void_p, ctypes.c_int64
        lib.aio_handle_create.restype = P
        lib.aio_handle_create.argtypes = [ctypes.c_int, L, ctypes.c_int]
        lib.aio_handle_destroy.restype = None
        lib.aio_handle_destroy.argtypes = [P]
        lib.aio_handle_num_threads.restype = ctypes.c_int
        lib.aio_handle_num_threads.argtypes = [P]
        lib.aio_handle_block_size.restype = L
        lib.aio_handle_block_size.argtypes = [P]
        for fn in ("aio_async_pwrite", "aio_sync_pwrite", "aio_async_pread",
                   "aio_sync_pread"):
            f = getattr(lib, fn)
            f.restype = ctypes.c_int
            f.argtypes = [P, ctypes.c_char_p, P, L]
        lib.aio_wait.restype = ctypes.c_int
        lib.aio_wait.argtypes = [P]
        _lib = lib
    return _lib


def _buf(t):
    if not (torch.is_tensor(t) and t.device.type == "cpu"
            and t.is_contiguous()):
        raise TypeError("aio buffers must be contiguous CPU tensors")
    return t.data_ptr(), t.numel() * t.element_size()


class AsyncIOHandle:
    """The JAX package's ``AsyncIOHandle``: asynchronous and synchronous
    reads and writes on a thread pool; ``wait()`` drains every pending
    request.  A buffer in flight is kept alive until ``wait()``."""

    def __init__(self, block_size=AIO_DEFAULT_BLOCK_SIZE, queue_depth=None,
                 thread_count=AIO_DEFAULT_THREADS, single_submit=False,
                 overlap_events=True, o_direct=False):
        self._lib = load()
        self._h = self._lib.aio_handle_create(int(thread_count),
                                              int(block_size),
                                              1 if o_direct else 0)
        self._inflight = []

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.aio_handle_destroy(h)
            self._h = None

    @property
    def num_threads(self):
        return self._lib.aio_handle_num_threads(self._h)

    @property
    def block_size(self):
        return self._lib.aio_handle_block_size(self._h)

    def async_pwrite(self, tensor, path):
        ptr, n = _buf(tensor)
        rc = self._lib.aio_async_pwrite(self._h, str(path).encode(), ptr, n)
        if rc != 0:
            raise IOError(f"aio submit write {path} failed ({rc})")
        self._inflight.append(tensor)

    def async_pread(self, tensor, path):
        ptr, n = _buf(tensor)
        rc = self._lib.aio_async_pread(self._h, str(path).encode(), ptr, n)
        if rc != 0:
            raise IOError(f"aio submit read {path} failed ({rc})")
        self._inflight.append(tensor)

    def wait(self):
        rc = self._lib.aio_wait(self._h)
        self._inflight.clear()
        if rc != 0:
            raise IOError(f"aio completed with {-rc} failed requests")
        return rc

    def sync_pwrite(self, tensor, path):
        ptr, n = _buf(tensor)
        rc = self._lib.aio_sync_pwrite(self._h, str(path).encode(), ptr, n)
        if rc != 0:
            raise IOError(f"aio write {path} failed ({rc})")

    def sync_pread(self, tensor, path):
        ptr, n = _buf(tensor)
        rc = self._lib.aio_sync_pread(self._h, str(path).encode(), ptr, n)
        if rc != 0:
            raise IOError(f"aio read {path} failed ({rc})")
