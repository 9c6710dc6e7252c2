"""Checkpoint I/O engines (port of
``deepspeed_tpu/runtime/checkpoint_engine/checkpoint_engine.py``).

The ``CheckpointEngine`` protocol is the JAX one (``create`` / ``save`` /
``load`` / ``commit``); ``save`` takes the array groups and a picklable
metadata dict apart.  :class:`TorchCheckpointEngine` saves synchronously,
:class:`NebulaCheckpointEngine` writes the arrays on a background thread
and publishes ``meta.pkl`` only at ``commit()``, after the arrays are on
disk — as the JAX Orbax engine's async mode does.

**The format is the port's own** (the card's machine has no jax and no
orbax)::

    <path>/meta.pkl                       the metadata dict (pickle)
    <path>/arrays/index.json              every leaf: path, shape, dtype
    <path>/arrays/<group>/<leaf>.pt       one tensor per file

Each ``.pt`` file holds one CPU tensor that ``torch.load(...,
weights_only=True)`` reads.  A group is a mapping (``module``: parameter
name → tensor), a NamedTuple of tensor lists (``optimizer``, e.g.
``AdamState``: ``exp_avg/<i>.pt``) or a NamedTuple of tensors
(``loss_scaler``); ``None`` leaves are recorded and not written.  The
writer moves one tensor at a time to the host, so a save never holds more
than the largest tensor there (the embedding, 412 MB at OPT-1.3B), not
the whole state.

``load(path, targets)`` copies each file into the tensor at the same
place of ``targets`` in place (the engine's parameters and optimizer
lists keep their identity); without ``targets`` it returns the groups as
nested dicts / lists of CPU tensors (NamedTuples come back as dicts, as
the JAX engine's Orbax restore gives them).
"""

import json
import os
import pickle
import threading
import time
from abc import ABC, abstractmethod
from collections.abc import Mapping

import torch

from deepspeed_tpu_torch.runtime.fault import inject
from deepspeed_tpu_torch.runtime.fault.atomic import atomic_write_bytes
from deepspeed_tpu_torch.runtime.fault.manifest import CheckpointCorrupt
from deepspeed_tpu_torch.utils.logging import logger

INDEX_NAME = "index.json"
INDEX_VERSION = 1


def _is_namedtuple(x):
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_groups(arrays):
    """``{group: tree}`` → ordered ``[(path, tensor or None)]`` with
    ``/``-joined paths (``module/<name>``, ``optimizer/exp_avg/3``,
    ``loss_scaler/scale``)."""
    leaves = []

    def walk(path, node):
        # ``ckpt_leaf`` objects stand in for tensors (the data-parallel
        # engine's sharded state: gathered on write, scattered on load)
        if node is None or torch.is_tensor(node) or \
                getattr(node, "ckpt_leaf", False):
            leaves.append((path, node))
        elif _is_namedtuple(node):
            for name, child in zip(node._fields, node):
                walk(f"{path}/{name}", child)
        elif isinstance(node, Mapping):
            for key, child in node.items():
                if "/" in str(key):
                    raise ValueError(f"checkpoint key {key!r} holds '/'")
                walk(f"{path}/{key}", child)
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(f"{path}/{i}", child)
        else:
            raise TypeError(f"checkpoint leaf {path!r} is a "
                            f"{type(node).__name__}, not a tensor")

    for group, tree in arrays.items():
        walk(str(group), tree)
    return leaves


def _leaf_file(arrays_dir, path):
    return os.path.join(arrays_dir, *path.split("/")) + ".pt"


def _read_index(arrays_dir):
    try:
        with open(os.path.join(arrays_dir, INDEX_NAME)) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except ValueError as e:
        raise CheckpointCorrupt(f"{arrays_dir}: unreadable {INDEX_NAME} "
                                f"({e})") from e


def _nest(index, tensors):
    """Index entries + ``{path: tensor}`` → ``{group: nested dicts}``;
    integer-keyed levels (the optimizer's per-parameter lists) become
    lists."""
    root = {}
    for entry in index["leaves"]:
        *parents, last = entry["path"].split("/")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = tensors.get(entry["path"])

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return {k: listify(v) for k, v in root.items()}


def restore_into(targets, entries, fetch, strict=True, where="checkpoint"):
    """Copy saved leaves into ``targets`` (``{group: tree}`` of live
    tensors) in place.  ``entries``: ``{path: shape or None}`` of what was
    saved (None: a ``None`` leaf); ``fetch(path)`` returns the saved
    tensor.  Every leaf is matched and
    shape-checked before the first copy, so a tag that does not fit leaves
    the targets untouched.  Groups ``targets`` does not name are ignored;
    ``strict=False`` lets the ``module`` group's names differ (the
    intersection is copied)."""
    want = flatten_groups(targets)
    plan = []
    for p, target in want:
        lenient = not strict and p.split("/", 1)[0] == "module"
        if p not in entries:
            if lenient or target is None:
                continue
            raise CheckpointCorrupt(f"{where}: the checkpoint has no {p!r}")
        shape = entries[p]
        if (target is None) != (shape is None):
            raise CheckpointCorrupt(
                f"{where}: {p!r} is {'absent' if target is None else 'present'}"
                f" here but not in the checkpoint")
        if target is None:
            continue
        if list(target.shape) != list(shape):
            raise ValueError(f"{where}: {p!r} has shape {list(shape)}, the "
                             f"engine's is {list(target.shape)}")
        plan.append((p, target))
    if strict:
        groups = {p.split("/", 1)[0] for p, _ in want}
        names = {p for p, _ in want}
        extra = sorted(p for p, shape in entries.items()
                       if p.split("/", 1)[0] in groups and p not in names
                       and shape is not None)
        if extra:
            raise CheckpointCorrupt(f"{where}: unexpected keys in the "
                                    f"checkpoint: {extra[:5]}")
    with torch.no_grad():
        for p, target in plan:
            target.copy_(fetch(p))
            if target.is_cuda:
                torch.cuda.synchronize(target.device)


def copy_groups(targets, source, strict=True):
    """:func:`restore_into` from array groups held in memory
    (``{group: tree}`` of tensors; NamedTuples or dicts alike)."""
    leaves = dict(flatten_groups(source))
    restore_into(targets, {p: None if t is None else list(t.shape)
                           for p, t in leaves.items()}, leaves.__getitem__,
                 strict, where="state")


class CheckpointEngine(ABC):
    """create / save / load / commit protocol.  ``save`` takes the array
    groups and a picklable metadata dict apart — array leaves go through
    the tensor writer, metadata through pickle."""

    def __init__(self, config_params=None):
        self.config_params = config_params
        # the last save's and load's accounting (bytes, files, seconds)
        self.stats = {}

    def create(self, tag):
        logger.info(f"[ckpt] checkpoint tag {tag} begin")

    @abstractmethod
    def save(self, arrays, meta, path: str):
        ...

    @abstractmethod
    def load(self, path: str, targets=None, strict=True, groups=None):
        """Returns ``(arrays, meta)``; see the module docstring."""
        ...

    @abstractmethod
    def commit(self, tag):
        ...


class TorchCheckpointEngine(CheckpointEngine):
    """Synchronous writer and reader of the port's tag format."""

    use_async = False

    def __init__(self, config_params=None):
        super().__init__(config_params)
        # async mode: (path, pickled meta) pairs whose publish waits for
        # commit() — metadata never lands before the arrays it describes
        self._pending_meta = []
        self._writer = None
        self._writer_error = []

    # ---------------------------------------------------------------- #
    def _write_arrays(self, arrays, arrays_dir):
        """One tensor at a time: device → host, ``torch.save``."""
        t0 = time.monotonic()
        leaves = flatten_groups(arrays)
        os.makedirs(arrays_dir, exist_ok=True)
        index = {"version": INDEX_VERSION, "leaves": []}
        nbytes = files = 0
        for path, t in leaves:
            entry = {"path": path}
            if t is not None:
                entry.update(shape=list(t.shape),
                             dtype=str(t.dtype).replace("torch.", ""))
                f = _leaf_file(arrays_dir, path)
                os.makedirs(os.path.dirname(f), exist_ok=True)
                # clone() on the host: a view of a larger storage would
                # serialise the whole storage
                torch.save(t.detach().to("cpu", copy=True), f)
                nbytes += os.path.getsize(f)
                files += 1
            index["leaves"].append(entry)
        with open(os.path.join(arrays_dir, INDEX_NAME), "w") as f:
            json.dump(index, f)
        self.stats["save"] = {"bytes": nbytes, "files": files + 1,
                              "write_s": time.monotonic() - t0}

    def save(self, arrays, meta, path):
        path = os.path.abspath(path)
        os.makedirs(path, exist_ok=True)
        self.stats.pop("save", None)
        meta_bytes = pickle.dumps(meta)
        if arrays is not None and self.use_async:
            if self._writer is not None:
                raise RuntimeError("NebulaCheckpointEngine.save called "
                                   "before the previous save's commit()")
            # the caller must not update the saved tensors before commit()
            self._writer_error = []

            def write():
                try:
                    self._write_arrays(arrays, os.path.join(path, "arrays"))
                    inject.fire("ckpt.arrays_write", path=path)
                except BaseException as e:          # re-raised by commit
                    self._writer_error.append(e)

            self._writer = threading.Thread(target=write, daemon=True,
                                            name="ds-ckpt-writer")
            self._writer.start()
            self._pending_meta.append((path, meta_bytes))
            return
        if arrays is not None:
            self._write_arrays(arrays, os.path.join(path, "arrays"))
        inject.fire("ckpt.arrays_write", path=path)
        # temp-file + os.replace: a crash mid-write never leaves a
        # truncated meta.pkl shadowing the real one
        atomic_write_bytes(os.path.join(path, "meta.pkl"), meta_bytes)

    def commit(self, tag):
        if self._writer is not None:
            writer, self._writer = self._writer, None
            writer.join()
            if self._writer_error:
                self._pending_meta = []
                raise self._writer_error[0]
        # arrays are on disk — publish the deferred metadata.  Entries
        # whose staging dir has vanished belong to an earlier save that
        # aborted and was GC'd: drop them rather than failing this commit
        pending, self._pending_meta = self._pending_meta, []
        for path, meta_bytes in pending:
            if not os.path.isdir(path):
                logger.warning(f"[ckpt] dropping deferred metadata for "
                               f"vanished save at {path} (aborted save?)")
                continue
            atomic_write_bytes(os.path.join(path, "meta.pkl"), meta_bytes)
        logger.info(f"[ckpt] checkpoint tag {tag} committed")
        return True

    # ---------------------------------------------------------------- #
    def load(self, path, targets=None, strict=True, groups=None):
        """``(arrays, meta)``.  With ``targets`` (``{group: tree}`` of the
        live tensors) each saved leaf is copied into its target in place
        and the returned ``arrays`` is ``targets``; groups of the tag that
        ``targets`` does not name are not read.  ``strict=False`` lets the
        ``module`` group's names differ (the intersection is loaded).
        Without ``targets``, ``groups`` (default: all) names the groups to
        read."""
        path = os.path.abspath(path)
        meta = {}
        meta_path = os.path.join(path, "meta.pkl")
        if os.path.exists(meta_path):
            with open(meta_path, "rb") as f:
                meta = pickle.load(f)
        arrays_dir = os.path.join(path, "arrays")
        index = _read_index(arrays_dir)
        if index is None:
            return None, meta
        saved = {e["path"]: e for e in index["leaves"]}
        stats = {"bytes": 0, "files": 0, "read_s": 0.0, "copy_s": 0.0}
        self.stats["load"] = stats

        def read(entry):
            t0 = time.monotonic()
            f = _leaf_file(arrays_dir, entry["path"])
            t = torch.load(f, map_location="cpu", weights_only=True)
            stats["read_s"] += time.monotonic() - t0
            stats["bytes"] += os.path.getsize(f)
            stats["files"] += 1
            if list(t.shape) != entry["shape"]:
                raise CheckpointCorrupt(
                    f"{f}: shape {list(t.shape)} != index {entry['shape']}")
            return t

        if targets is None:
            index = dict(index, leaves=[
                e for e in index["leaves"]
                if groups is None or e["path"].split("/", 1)[0] in groups])
            tensors = {e["path"]: read(e) for e in index["leaves"]
                       if "shape" in e}
            return _nest(index, tensors), meta

        t0 = time.monotonic()
        restore_into(targets, {p: e.get("shape") for p, e in saved.items()},
                     lambda p: read(saved[p]), strict, where=path)
        stats["copy_s"] = time.monotonic() - t0 - stats["read_s"]
        return targets, meta


class NebulaCheckpointEngine(TorchCheckpointEngine):
    """Asynchronous save (the JAX package's Nebula role): the arrays are
    written on a background thread; ``commit()`` waits for it and only
    then publishes ``meta.pkl``.  The saved tensors must not change until
    ``commit()`` returns — the engine commits inside ``save_checkpoint``,
    so its step never overlaps a write."""

    use_async = True
