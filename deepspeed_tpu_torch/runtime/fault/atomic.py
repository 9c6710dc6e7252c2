"""Atomic durable filesystem primitives for the checkpoint protocol (a copy
of ``deepspeed_tpu/runtime/fault/atomic.py``).

Every mutation of checkpoint state goes through these three idioms:

* **atomic file publish** — write to ``<name>.tmp.<pid>`` in the same
  directory, fsync the file, ``os.replace`` onto the final name, fsync the
  directory.  A crash at any instruction leaves either the old file or the
  new file, never a truncated hybrid (the seed's in-place ``latest``
  truncate-then-write bricked resume when killed between the two).
* **atomic directory publish** — stage everything under ``<tag>.tmp``,
  fsync the payload, ``os.rename`` to ``<tag>``, fsync the parent.  POSIX
  rename is atomic on one filesystem; a crash leaves only a ``.tmp``
  orphan that recovery ignores and GC removes.
* **recursive fsync** — flush file data AND directory entries; a rename is
  only crash-durable once the parent directory entry is on disk.
"""

import os

from deepspeed_tpu_torch.utils.logging import logger


def fsync_file(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path):
    """fsync a directory entry (no-op on filesystems that refuse O_RDONLY
    dir fds — e.g. some FUSE mounts — where rename durability is the
    mount's problem, not ours)."""
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError as e:
        logger.debug(f"fsync_dir({path}) skipped: {e}")
        return
    try:
        os.fsync(fd)
    except OSError as e:
        logger.debug(f"fsync_dir({path}) failed: {e}")
    finally:
        os.close(fd)


def fsync_tree(root):
    """fsync every regular file under ``root``, then every directory
    bottom-up — the durability barrier before an atomic rename publish."""
    for dirpath, _dirnames, filenames in os.walk(root, topdown=False):
        for name in filenames:
            p = os.path.join(dirpath, name)
            if os.path.isfile(p) and not os.path.islink(p):
                fsync_file(p)
        fsync_dir(dirpath)


def atomic_write_bytes(path, data: bytes):
    """Publish ``data`` at ``path`` atomically and durably."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path))


def atomic_write_text(path, text: str):
    atomic_write_bytes(path, text.encode("utf-8"))


def atomic_publish_dir(tmp_dir, final_dir):
    """Promote a fully-written staging directory to its final name.  The
    payload is fsynced first, so after the rename lands the checkpoint is
    durable; if ``final_dir`` already exists (re-save of the same tag) it
    is moved aside and removed only after the new version is in place."""
    import shutil
    fsync_tree(tmp_dir)
    parent = os.path.dirname(os.path.abspath(final_dir))
    backup = None
    if os.path.isdir(final_dir):
        backup = f"{final_dir}.old.{os.getpid()}"
        os.rename(final_dir, backup)
    os.rename(tmp_dir, final_dir)
    fsync_dir(parent)
    if backup is not None:
        shutil.rmtree(backup, ignore_errors=True)
