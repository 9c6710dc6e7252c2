"""Inspect, verify and garbage-collect checkpoint directories against
their manifests (port of ``deepspeed_tpu/runtime/fault/ckpt_cli.py``,
the JAX package's ``ds_ckpt``).

Subcommands::

    python -m deepspeed_tpu_torch.runtime.fault.ckpt_cli list <dir>
        # tags, steps, sizes, validity
    python -m deepspeed_tpu_torch.runtime.fault.ckpt_cli verify <dir> [--tag TAG]
        # deep-verify manifests; exit 1 on any invalid tag
    python -m deepspeed_tpu_torch.runtime.fault.ckpt_cli gc <dir> --keep N
        # retention: keep newest N valid tags, drop older + .tmp orphans
"""

import argparse
import json
import os
import sys

from deepspeed_tpu_torch.runtime.fault.manifest import (
    gc_checkpoints, list_tags, read_latest, read_manifest, verify_manifest)


def _tag_bytes(path):
    total = 0
    for dirpath, _d, filenames in os.walk(path):
        for name in filenames:
            p = os.path.join(dirpath, name)
            if os.path.isfile(p):
                total += os.path.getsize(p)
    return total


def cmd_list(args):
    tags = list_tags(args.dir)
    if not tags:
        print(f"{args.dir}: no checkpoint tags")
        return 0
    latest = read_latest(args.dir)
    print(f"{'tag':<28} {'step':>10} {'files':>6} {'MB':>10} "
          f"{'status':<10}")
    for tag in tags:
        p = os.path.join(args.dir, tag)
        manifest = read_manifest(p)
        if manifest is None:
            step, nfiles, status = "-", "-", "no-manifest"
        else:
            step = manifest.get("step", {}).get("global_steps", "-")
            nfiles = len(manifest.get("files", {}))
            # shallow check (existence + sizes): the cheap scan; use
            # `verify` for checksums
            status = "ok" if not verify_manifest(p, deep=False) \
                else "INVALID"
        mark = " <- latest" if tag == latest else ""
        print(f"{tag:<28} {step!s:>10} {nfiles!s:>6} "
              f"{_tag_bytes(p) / 1e6:>10.2f} {status:<10}{mark}")
    return 0


def cmd_verify(args):
    tags = [args.tag] if args.tag else list_tags(args.dir)
    if not tags:
        print(f"{args.dir}: no checkpoint tags", file=sys.stderr)
        return 1
    bad = 0
    report = {}
    for tag in tags:
        p = os.path.join(args.dir, tag)
        problems = verify_manifest(p, deep=not args.shallow)
        report[tag] = problems
        if problems:
            bad += 1
            print(f"{tag}: INVALID ({len(problems)} problem(s))")
            for prob in problems:
                print(f"  - {prob}")
        else:
            print(f"{tag}: ok")
    if args.json:
        print(json.dumps(report, indent=2))
    return 1 if bad else 0


def cmd_gc(args):
    """Real run and --dry-run share ONE implementation
    (``gc_checkpoints(dry_run=...)``) so the preview can never diverge
    from what the real run does (incl. the keep-newest-valid rule and
    orphaned-backup restores)."""
    latest = read_latest(args.dir)
    actions = gc_checkpoints(args.dir, args.keep,
                             protect=(latest,) if latest else (),
                             dry_run=args.dry_run)
    would = "would " if args.dry_run else ""
    for name in sorted(actions):
        if name.startswith("restore:"):
            print(f"{would}restore{'' if args.dry_run else 'd'} "
                  f"{name[len('restore:'):]}")
        else:
            print(f"{would}remove{'' if args.dry_run else 'd'} {name}")
    print(f"{len(actions)} action{'' if len(actions) == 1 else 's'}; "
          f"{len(list_tags(args.dir))} tag(s) remain")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.runtime.fault.ckpt_cli",
        description="verify / list / gc a deepspeed_tpu_torch checkpoint "
                    "directory against its MANIFEST.json files")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("list", help="tags with step, size and validity")
    p.add_argument("dir")
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("verify", help="verify manifests (checksums)")
    p.add_argument("dir")
    p.add_argument("--tag", help="verify one tag only")
    p.add_argument("--shallow", action="store_true",
                   help="existence + sizes only, skip checksums")
    p.add_argument("--json", action="store_true",
                   help="also print a JSON problem report")
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("gc", help="apply retention policy")
    p.add_argument("dir")
    p.add_argument("--keep", type=int, required=True,
                   help="number of newest tags to keep")
    p.add_argument("--dry-run", action="store_true",
                   help="report what would be removed, touch nothing")
    p.set_defaults(fn=cmd_gc)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
