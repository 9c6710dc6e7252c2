"""The safetensors file format, read and written without the
``safetensors`` package (the card's machine does not have it).

A file is an 8-byte little-endian header length ``N``, ``N`` bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}`` and an
optional ``"__metadata__"`` map of strings, padded with spaces to a
multiple of 8), then the tensors' raw little-endian bytes (the host's
order, x86 and AArch64 alike), back to back in the order of their offsets.
:func:`save_file` writes the tensors in name order one at a time;
:func:`load_file` reads them one at a time.
"""

import json
import os
import struct

import numpy as np
import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
# the header must stay below this size (the safetensors package's limit)
MAX_HEADER = 100_000_000


def _as_tensor(x):
    if torch.is_tensor(x):
        return x.detach().to("cpu")
    return torch.from_numpy(np.ascontiguousarray(x))


def save_file(tensors, path):
    """Write ``{name: tensor or numpy array}`` to ``path``."""
    names = sorted(tensors)
    header, offset = {}, 0
    for name in names:
        t = tensors[name]
        dtype = t.dtype if torch.is_tensor(t) else \
            torch.from_numpy(np.empty(0, t.dtype)).dtype
        if dtype not in _NAMES:
            raise ValueError(f"safetensors: {name!r} has unsupported dtype "
                             f"{dtype}")
        n = int(np.prod(tuple(t.shape), dtype=np.int64)) * \
            torch.empty(0, dtype=dtype).element_size()
        header[name] = {"dtype": _NAMES[dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in names:
            t = _as_tensor(tensors[name]).contiguous()
            # a uint8 view of the same bytes: numpy has no bfloat16
            f.write(t.reshape(-1).view(torch.uint8).numpy().data)


def read_header(path):
    """``(header dict without its __metadata__, data start)``."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        (n,) = struct.unpack("<Q", head)
        if n > MAX_HEADER:
            raise ValueError(f"{path}: safetensors header of {n} bytes")
        raw = f.read(n)
    if len(raw) != n:
        raise ValueError(f"{path}: truncated safetensors header")
    header = json.loads(raw.decode("utf-8"))
    header.pop("__metadata__", None)
    return header, 8 + n


def load_file(path, device="cpu"):
    """``{name: tensor}`` from a safetensors file, each tensor checked
    against its header entry and the file's size."""
    header, start = read_header(path)
    size = os.path.getsize(path)
    out = {}
    with open(path, "rb") as f:
        for name, e in sorted(header.items(),
                              key=lambda kv: kv[1]["data_offsets"][0]):
            if e["dtype"] not in DTYPES:
                raise ValueError(f"{path}: {name!r} has unsupported dtype "
                                 f"{e['dtype']}")
            dtype = DTYPES[e["dtype"]]
            begin, end = e["data_offsets"]
            n = int(np.prod(e["shape"], dtype=np.int64)) * \
                torch.empty(0, dtype=dtype).element_size()
            if end - begin != n or start + end > size:
                raise ValueError(f"{path}: {name!r} has offsets "
                                 f"{[begin, end]} for {n} bytes")
            f.seek(start + begin)
            buf = bytearray(n)
            if f.readinto(buf) != n:
                raise ValueError(f"{path}: {name!r} is truncated")
            t = torch.frombuffer(buf, dtype=torch.uint8) if n else \
                torch.empty(0, dtype=torch.uint8)
            out[name] = t.view(dtype).reshape(e["shape"]).to(device)
    return out
