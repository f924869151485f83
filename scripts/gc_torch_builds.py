#!/usr/bin/env python3
"""Clean the port's build cache: the digest-named libraries under build/.

    python3 scripts/gc_torch_builds.py [--dry-run]

The port's compile cache is its libraries, each named by a digest of what
it was built from: build/kernels/lib<source>_<digest>.so (nvcc,
webauthn_halo2_tpu_torch/ops/kernels.py, each beside its compiler report
lib<source>_<digest>.log) and build/host/lib<source>_<digest>.so (g++,
webauthn_halo2_tpu_torch/utils/host_build.py). An edited source, header,
flag or host compiler gives a new name and leaves the old library behind.

Policy:
  * a library is current when its name is the one that
    ops/kernels.library_paths() or utils/host_build.library_paths() gives
    for today's sources, flags and compiler; every other lib*.so, and its
    .log, is stale and deleted;
  * a build's temporary file (lib<source>_<digest>.<pid>[.<thread>].tmp)
    is deleted when no build holds its source's file lock (.<source>.lock):
    its build was interrupted.
The digest settles what is current, so no size budget is needed: what is
left is today's libraries and their compiler reports, which chip_smoke.py
reads for its ptxas lines and which are not rebuilt while their library
exists. A current library and a .lock file are never deleted. Nothing is built:
the host compiler is only asked for its version (where it cannot run,
build/host/ is left as it is). --dry-run lists and deletes nothing. The
last line of stdout is a JSON object: the deleted files by reason, the
bytes freed and kept.
"""
from __future__ import annotations

import argparse
import fcntl
import json
import os
import re
import sys
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

# lib<source>_<16 hex digits>.<so | log | pid.tmp | pid.thread.tmp>
_LIBRARY_FILE = re.compile(r"^lib(?P<source>\w+?)_[0-9a-f]{16}\.(?P<rest>.+)$")


def _build_running(directory: Path, source: str) -> bool:
    """Whether a build of `source` holds its file lock in `directory`."""
    lock = directory / f".{source}.lock"
    if not lock.exists():
        return False
    with open(lock, "a") as f:
        try:
            fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:
            return True
        fcntl.flock(f, fcntl.LOCK_UN)
    return False


def plan(directories: dict) -> dict:
    """What to delete in each directory of `directories` ({Path: the set of
    its current library Paths}): {"stale": [...], "orphaned": [...],
    "kept": [...]}, each a list of Paths. Deletes nothing."""
    out = {"stale": [], "orphaned": [], "kept": []}
    for directory, current in directories.items():
        if not directory.is_dir():
            continue
        live = {p.with_suffix("") for p in current}  # lib<source>_<digest>
        for path in sorted(directory.iterdir()):
            m = _LIBRARY_FILE.match(path.name)
            if not path.is_file() or m is None:
                out["kept"].append(path)  # .lock files and anything not ours
            elif m["rest"].endswith(".tmp"):
                running = _build_running(directory, m["source"])
                out["kept" if running else "orphaned"].append(path)
            elif directory / f"{path.name.split('.')[0]}" in live:
                out["kept"].append(path)
            elif m["rest"] in ("so", "log"):
                out["stale"].append(path)
            else:
                out["kept"].append(path)
    return out


def _size(path: Path) -> int:
    """The file's size, 0 when it is gone (a build's renamed temporary file)."""
    try:
        return path.stat().st_size
    except FileNotFoundError:
        return 0


def directories() -> tuple[dict, list]:
    """{build directory: its current libraries} of the kernels and the host
    libraries, and notes on what could not be named."""
    from webauthn_halo2_tpu_torch.ops import kernels as K
    from webauthn_halo2_tpu_torch.utils import host_build as HB

    dirs = {K.BUILD_DIR: set(K.library_paths().values())}
    notes = []
    try:
        dirs[HB.BUILD_DIR] = set(HB.library_paths().values())
    except RuntimeError as e:  # the host compiler cannot say what is current
        notes.append(f"{HB.BUILD_DIR} left as it is: {e}")
    return dirs, notes


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)
    dirs, notes = directories()
    for note in notes:
        print(note)
    todo = plan(dirs)
    freed = 0
    for reason in ("stale", "orphaned"):
        done = []
        for path in todo[reason]:
            try:  # a build may rename its temporary file after the listing
                size = path.stat().st_size
                if not args.dry_run:
                    path.unlink()
            except FileNotFoundError:
                continue
            print(f"{reason}: {path} ({size / 1e6:.1f} MB)")
            freed += size
            done.append(path)
        todo[reason] = done
    kept = sum(_size(p) for p in todo["kept"])
    print(f"freed {freed / 1e9:.3f} GB{' (dry run)' if args.dry_run else ''}; "
          f"kept {kept / 1e9:.3f} GB")
    print(json.dumps({"dry_run": args.dry_run, "freed_bytes": freed, "kept_bytes": kept,
                      **{reason: [str(p) for p in paths] for reason, paths in todo.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
