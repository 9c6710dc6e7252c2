"""Crash-atomic serving snapshots (port of
``deepspeed_tpu/inference/serving/snapshot.py``; the same files, so the two
packages read each other's snapshots) — graceful-preemption state for the
continuous-batching engine, written through the same protocol as training
checkpoints (``runtime/fault/``): stage into ``<tag>.tmp/``, emit a
``MANIFEST.json`` with per-file sizes + checksums, fsync, atomic-rename,
atomic ``latest`` swap.  A kill at ANY instruction leaves either the
previous snapshot or the new one — never a half-written hybrid — and
``load_newest_snapshot`` walks back past corrupt/partial tags exactly
like checkpoint auto-resume does.

The payload is host bookkeeping only: per undrained request its prompt,
the tokens generated so far, the remaining budget/eos/deadline, plus the
scheduler's RNG state (the port's ``torch.Generator`` state under
``rng_torch``; the JAX engine's key data under ``rng``). Device state
(KV lanes, slot vectors) is deliberately NOT saved — a resumed request
re-prefills ``prompt + generated`` through the ordinary admission path,
whose greedy continuation is bitwise-identical to the uninterrupted run
(proven by the kill-at-seam harness in
``tests/test_torch_serving_resilient.py``)."""

import json
import os
import shutil

from deepspeed_tpu_torch.runtime.fault.atomic import (atomic_publish_dir,
                                                atomic_write_text)
from deepspeed_tpu_torch.runtime.fault.manifest import (build_manifest,
                                                  is_reserved_tag,
                                                  newest_valid_tag,
                                                  write_manifest)
from deepspeed_tpu_torch.utils.logging import logger

SNAPSHOT_FILE = "serving_state.json"
SNAPSHOT_VERSION = 1


def save_snapshot(snapshot_dir, tag, state, checksum="sha256"):
    """Publish ``state`` (a JSON-serializable dict) crash-atomically as
    ``<snapshot_dir>/<tag>/`` and swap ``latest``.  Returns the tag."""
    tag = str(tag)
    if is_reserved_tag(tag):
        raise ValueError(f"snapshot tag {tag!r} collides with the staging "
                         "namespace (*.tmp / *.old.<pid>)")
    os.makedirs(snapshot_dir, exist_ok=True)
    staging = os.path.join(snapshot_dir, f"{tag}.tmp")
    if os.path.isdir(staging):           # a previous crash's orphan
        shutil.rmtree(staging)
    os.makedirs(staging)
    payload = dict(state)
    payload["version"] = SNAPSHOT_VERSION
    with open(os.path.join(staging, SNAPSHOT_FILE), "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    write_manifest(staging, build_manifest(
        staging, tag, checksum=checksum,
        step_meta={"global_steps": int(state.get("seq", 0))}))
    atomic_publish_dir(staging, os.path.join(snapshot_dir, tag))
    atomic_write_text(os.path.join(snapshot_dir, "latest"), tag)
    logger.info(f"[serving] snapshot {tag}: "
                f"{len(state.get('requests', []))} undrained request(s)")
    return tag


def load_newest_snapshot(snapshot_dir):
    """``(tag, state)`` for the newest manifest-valid snapshot under
    ``snapshot_dir`` (walk-back past corrupt/partial tags), or
    ``(None, None)`` when there is nothing to resume."""
    if not snapshot_dir or not os.path.isdir(snapshot_dir):
        return None, None
    tag = newest_valid_tag(snapshot_dir, for_resume=True)
    if tag is None:
        return None, None
    path = os.path.join(snapshot_dir, tag, SNAPSHOT_FILE)
    try:
        with open(path) as f:
            state = json.load(f)
    except (OSError, ValueError) as e:
        # the manifest passed but the payload does not parse — treat it
        # like any other invalid tag and walk back past it
        logger.warning(f"[serving] snapshot {tag}: unreadable payload "
                       f"({e}) — walking back")
        older = newest_valid_tag(snapshot_dir, skip=(tag,), for_resume=True)
        if older is None:
            return None, None
        with open(os.path.join(snapshot_dir, older, SNAPSHOT_FILE)) as f:
            return older, json.load(f)
    if state.get("version") != SNAPSHOT_VERSION:
        logger.warning(f"[serving] snapshot {tag}: version "
                       f"{state.get('version')} != {SNAPSHOT_VERSION} — "
                       "ignoring")
        return None, None
    return tag, state


def read_snapshot_tag(snapshot_dir, tag):
    """Explicit-tag read (diagnostics / tests); manifest verification is
    the caller's concern — this only parses."""
    with open(os.path.join(snapshot_dir, str(tag), SNAPSHOT_FILE)) as f:
        return json.load(f)
