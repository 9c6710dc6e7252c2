"""Checkpoint manifest: the integrity contract of a committed tag (port of
``deepspeed_tpu/runtime/fault/manifest.py``; the fingerprint differs, and
the files of a tag are checksummed on up to ``CHECKSUM_THREADS`` threads —
``hashlib`` and ``zlib`` release the interpreter lock on large buffers, so
a tag of many large files hashes at several times one core's rate).

A committed checkpoint directory ``<save_dir>/<tag>/`` carries a
``MANIFEST.json`` listing every file with its size and checksum, plus the
torch/device fingerprint and step metadata of the run that wrote it.  A tag
without a verifiable manifest is treated as absent: load walks back to the
newest valid tag instead of crashing on a partial or bit-rotted save
(CheckFreq's "verified checkpoint" property).

The manifest is written LAST inside the staging directory, so its presence
implies every listed file was fully written before the atomic rename
published the tag.
"""

import binascii
import hashlib
import json
import os
import re
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

from deepspeed_tpu_torch.runtime.fault.atomic import atomic_write_text, fsync_dir
from deepspeed_tpu_torch.utils.logging import logger

MANIFEST_NAME = "MANIFEST.json"
MANIFEST_VERSION = 1
_CHUNK = 4 * 1024 * 1024
CHECKSUM_THREADS = min(8, os.cpu_count() or 1)


class CheckpointCorrupt(RuntimeError):
    """A tag failed manifest verification (missing/truncated/corrupt
    files) — callers walk back to the previous valid tag."""


def _checksum_file(path, algorithm="sha256"):
    if algorithm == "crc32":
        crc = 0
        with open(path, "rb") as f:
            while chunk := f.read(_CHUNK):
                crc = binascii.crc32(chunk, crc)
        return f"{crc & 0xFFFFFFFF:08x}"
    if algorithm != "sha256":
        raise ValueError(f"unknown checksum algorithm {algorithm!r} "
                         "(expected 'sha256' or 'crc32')")
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(_CHUNK):
            h.update(chunk)
    return h.hexdigest()


def _checksum_files(paths, algorithm):
    """Each file's checksum, in the order of ``paths``."""
    if len(paths) <= 1:
        return [_checksum_file(p, algorithm) for p in paths]
    with ThreadPoolExecutor(min(CHECKSUM_THREADS, len(paths))) as pool:
        return list(pool.map(lambda p: _checksum_file(p, algorithm), paths))


def runtime_fingerprint(mesh_shape=None):
    """What must match (or at least be visible) when a checkpoint is
    resumed: recorded informationally — load does NOT refuse on mismatch
    (cross-topology resume is a supported path), it logs the delta.  The
    torch version, the device type (``cuda`` when a card is visible, else
    ``cpu``) and the device count."""
    import torch
    cuda = torch.cuda.is_available()
    fp = {
        "torch": torch.__version__,
        "device_type": "cuda" if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
    }
    if mesh_shape:
        fp["mesh"] = dict(mesh_shape)
    return fp


def build_manifest(ckpt_dir, tag, step_meta=None, checksum="sha256",
                   mesh_shape=None, advance_latest=True):
    """Walk ``ckpt_dir`` and record every regular file (path relative to
    the tag dir, size, checksum).  Called on the fully-written staging
    directory, before the manifest itself is added."""
    if checksum not in ("sha256", "crc32"):
        raise ValueError(f"unknown checksum algorithm {checksum!r} "
                         "(expected 'sha256' or 'crc32')")
    found = []
    root = os.path.abspath(ckpt_dir)
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in sorted(filenames):
            if name == MANIFEST_NAME:
                continue
            p = os.path.join(dirpath, name)
            if not os.path.isfile(p) or os.path.islink(p):
                continue
            found.append((os.path.relpath(p, root), p))
    sums = _checksum_files([p for _rel, p in found], checksum)
    files = {rel: {"size": os.path.getsize(p), checksum: digest}
             for (rel, p), digest in zip(found, sums)}
    return {
        "version": MANIFEST_VERSION,
        "tag": str(tag),
        "checksum_algorithm": checksum,
        "files": files,
        "fingerprint": runtime_fingerprint(mesh_shape),
        "step": dict(step_meta or {}),
        # False = this save deliberately did NOT advance 'latest'
        # (side checkpoints, debug dumps) — auto-resume skips it
        "advance_latest": bool(advance_latest),
        "created_unix": time.time(),
    }


def write_manifest(ckpt_dir, manifest):
    atomic_write_text(os.path.join(ckpt_dir, MANIFEST_NAME),
                      json.dumps(manifest, indent=2, sort_keys=True))


def read_manifest(ckpt_dir):
    """Parsed manifest dict, or None when absent/unreadable."""
    path = os.path.join(ckpt_dir, MANIFEST_NAME)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def verify_manifest(ckpt_dir, deep=True):
    """Check every manifest entry against the tag directory.  Returns the
    list of problems (empty = valid).  ``deep=False`` checks existence and
    sizes only — the cheap scan ``ds_ckpt list`` uses; ``deep=True`` also
    re-checksums every file."""
    manifest = read_manifest(ckpt_dir)
    if manifest is None:
        return [f"{MANIFEST_NAME} missing or unparseable"]
    algo = manifest.get("checksum_algorithm", "sha256")
    problems, deep_check = [], []
    for rel, want in manifest.get("files", {}).items():
        p = os.path.join(ckpt_dir, rel)
        if not os.path.isfile(p):
            problems.append(f"{rel}: missing")
            continue
        size = os.path.getsize(p)
        if size != want.get("size"):
            problems.append(f"{rel}: size {size} != {want.get('size')}")
            continue
        if deep and algo in want:
            deep_check.append((rel, p, want[algo]))
    got = _checksum_files([p for _rel, p, _w in deep_check], algo)
    problems += [f"{rel}: {algo} {g} != {w}"
                 for (rel, _p, w), g in zip(deep_check, got) if g != w]
    return problems


# --------------------------------------------------------------------- #
# Tag discovery / walk-back / retention
# --------------------------------------------------------------------- #
_OLD_BACKUP_RE = re.compile(r"^(?P<tag>.+)\.old\.\d+$")
_TMP_FILE_RE = re.compile(r"\.tmp\.\d+$")


def _is_staging(name):
    """Exactly the names the publish protocol generates — ``<tag>.tmp``
    (atomic-save staging) and ``<tag>.old.<pid>`` (re-publish backup).
    Substring matching would swallow user tags that merely CONTAIN
    '.tmp' or '.old.'."""
    return name.endswith(".tmp") or _OLD_BACKUP_RE.match(name) is not None


def is_reserved_tag(name):
    """Tag names the protocol reserves for its staging machinery —
    ``save_checkpoint`` refuses them up front, because GC would later
    classify the committed directory as an orphan and destroy it."""
    return _is_staging(str(name))


def _sort_entries(entries):
    # manifest-less dirs (seed-era checkpoints) sort by mtime among
    # themselves but below any manifested tag of the same mtime era
    entries.sort(key=lambda e: (e[1] is not None, e[1] or 0, e[2]),
                 reverse=True)
    return entries


def _tag_entries(save_dir):
    """(name, step, mtime, path) for every committed tag dir, newest
    first by (manifest step, mtime)."""
    if not os.path.isdir(save_dir):
        return []
    entries = []
    for name in os.listdir(save_dir):
        p = os.path.join(save_dir, name)
        if not os.path.isdir(p) or _is_staging(name):
            continue
        manifest = read_manifest(p)
        step = (manifest or {}).get("step", {}).get("global_steps")
        entries.append((name, step, os.path.getmtime(p), p))
    return _sort_entries(entries)


def read_latest(save_dir):
    """The tag ``<save_dir>/latest`` names, or None."""
    try:
        with open(os.path.join(save_dir, "latest")) as f:
            return f.read().strip() or None
    except FileNotFoundError:
        return None


def list_tags(save_dir):
    """Committed tag names under ``save_dir`` (staging/backup dirs
    excluded), newest first by (manifest step, mtime)."""
    return [name for name, _s, _m, _p in _tag_entries(save_dir)]


def newest_valid_tag(save_dir, checksum_verify=True, skip=(),
                     for_resume=False):
    """The newest tag that passes manifest verification; tags in ``skip``
    and invalid tags are walked past.  Manifest-less tags count as valid
    only when NO tag in the directory has a manifest (pre-protocol
    checkpoints stay loadable).  ``for_resume=True`` additionally skips
    tags whose manifest records ``advance_latest: false`` — side
    checkpoints saved with ``save_latest=False`` must not hijack
    auto-resume."""
    tags = [t for t in list_tags(save_dir) if t not in skip]
    manifests = {t: read_manifest(os.path.join(save_dir, t)) for t in tags}
    any_manifest = any(m is not None for m in manifests.values())
    for tag in tags:
        p = os.path.join(save_dir, tag)
        m = manifests[tag]
        if m is None:
            if any_manifest:
                logger.warning(f"[fault] tag {tag}: no {MANIFEST_NAME}; "
                               "skipping (newer tags are manifested)")
                continue
            return tag
        if for_resume and m.get("advance_latest") is False:
            logger.info(f"[fault] tag {tag}: saved with save_latest=False "
                        "— not an auto-resume candidate")
            continue
        problems = verify_manifest(p, deep=checksum_verify)
        if problems:
            logger.warning(f"[fault] tag {tag} failed verification "
                           f"({len(problems)} problem(s): {problems[:3]}) "
                           "— walking back")
            continue
        return tag
    return None


def gc_checkpoints(save_dir, keep_last_n, protect=(), dry_run=False):
    """Retention: delete committed tags beyond the newest ``keep_last_n``,
    plus every orphaned staging (``*.tmp`` / ``*.old.*``) directory.

    Safety properties:

    * an ``<tag>.old.*`` backup whose tag directory is MISSING and whose
      manifest verifies is RESTORED (renamed back), not deleted — the
      crash window of a same-tag re-publish must never destroy the only
      copy of a valid checkpoint;
    * the newest ``keep_last_n`` *valid* tags survive even when newer
      invalid (bit-rotted / partial) tags exist above them — retention
      must never leave the directory without a loadable checkpoint;
    * tags named in ``protect`` (e.g. the one ``latest`` points to)
      always survive.

    ``dry_run=True`` computes the same plan (``ds_ckpt gc --dry-run``)
    without touching disk — ONE implementation, with pending restores
    folded into the retention candidates, so the preview cannot diverge
    from the real run.

    Returns the action list: tag/staging names that were (or would be)
    removed, plus ``restore:<name>`` entries for orphaned backups that
    were (or would be) renamed back to their tag."""
    actions = []
    if not os.path.isdir(save_dir):
        return actions
    restored = []          # (tag, step, mtime, path) pending in dry-run
    for name in sorted(os.listdir(save_dir)):
        p = os.path.join(save_dir, name)
        if os.path.isfile(p) and _TMP_FILE_RE.search(name):
            # a crashed atomic_write_bytes leaves '<file>.tmp.<pid>'
            if not dry_run:
                os.remove(p)
            actions.append(name)
            continue
        if not os.path.isdir(p) or not _is_staging(name):
            continue
        if name in protect:
            continue
        m = _OLD_BACKUP_RE.match(name)
        if m and not os.path.isdir(os.path.join(save_dir, m.group("tag"))) \
                and read_manifest(p) is not None \
                and not verify_manifest(p, deep=False):
            # a re-publish died between moving the old tag aside and
            # promoting the new one — put the valid backup back
            tag = m.group("tag")
            manifest = read_manifest(p)
            if dry_run:
                restored.append((tag, manifest.get("step", {})
                                 .get("global_steps"),
                                 os.path.getmtime(p), p))
            else:
                os.rename(p, os.path.join(save_dir, tag))
                logger.warning(f"[fault] restored {tag} from orphaned "
                               f"backup {name}")
            actions.append(f"restore:{name}")
            continue
        if not dry_run:
            shutil.rmtree(p, ignore_errors=True)
        actions.append(name)
    if keep_last_n and keep_last_n > 0:
        # dry-run folds pending restores in at their sorted position, so
        # the retention plan matches what the real run (restore first,
        # then retain) would do
        entries = _sort_entries(_tag_entries(save_dir) + restored)
        tags = [name for name, _s, _m, _p in entries]
        paths = {name: p for name, _s, _m, p in entries}
        # keep the newest N tags AND the newest N tags that actually
        # verify (shallow: existence + sizes) — deleting a valid older
        # tag because corrupt newer ones outrank it would be data loss
        keep = set(tags[:keep_last_n])
        valid = [t for t in tags
                 if read_manifest(paths[t]) is None
                 or not verify_manifest(paths[t], deep=False)]
        keep.update(valid[:keep_last_n])
        for tag in tags:
            if tag in keep or tag in protect:
                continue
            if not dry_run:
                shutil.rmtree(os.path.join(save_dir, tag),
                              ignore_errors=True)
            actions.append(tag)
    if actions and not dry_run:
        fsync_dir(save_dir)
        logger.info(f"[fault] checkpoint GC: {sorted(actions)}")
    return actions
