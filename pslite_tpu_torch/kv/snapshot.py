"""Coordinated cluster snapshots of the message-path KV tier.

Copy of ``pslite_tpu/kv/snapshot.py``, over this package's
``checkpoint.save_range_segment``/``load_range_segment``.

The scheduler broadcasts ``Command.SNAPSHOT`` to every live server; each
server fences a consistent cut (its apply pool quiesces behind a submit
token while the request thread holds new arrivals), writes its owned
ranges through the ``export_range`` iterator into per-range segment
files under the snapshot directory, and replies with per-range digests.
The scheduler commits the cut by writing the cluster ``MANIFEST.json``:
a snapshot without a manifest never restores, so a crash mid-snapshot
leaves only ignorable files, never a half-restored store.

Restore (``PS_SNAPSHOT_RESTORE=1``) runs at server boot, before any
request is served: the manifest's ranges are digest-verified and
imported through ``import_range``, optimizer slots included.  A digest
mismatch fails the restore (CheckError).

Files are the JAX package's: range segments that carry their own range
(``range_<begin>_<end>.<uid>.npz``, keys, vals, lens as int64), equal
crc digests and the same manifest, so a snapshot written by either
package restores in the other.  The port writes npz only
(``PS_SNAPSHOT_FORMAT=orbax`` warns and writes npz, as JAX does where
orbax is not importable).
"""

from __future__ import annotations

import json
import os
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..checkpoint import fsync_dir, load_range_segment, save_range_segment
from ..message import SNAPSHOT_LOCAL_CMD
from ..range import find_range
from ..utils import logging as log

__all__ = ["MANIFEST_NAME", "SNAPSHOT_LOCAL_CMD", "load_manifest",
           "manifest_age_s", "prune_segments", "range_digest",
           "read_range_segment", "restore_into", "segment_filename",
           "snapshot_summary", "write_manifest", "write_range_segment"]

MANIFEST_NAME = "MANIFEST.json"


def range_digest(keys: np.ndarray, vals: np.ndarray,
                 lens: Optional[np.ndarray]) -> str:
    """Content digest of one exported range: crc32 chained over the
    key/val/len bytes AND their dtypes — a dtype swap with identical
    bytes must not verify."""
    crc = zlib.crc32(str(vals.dtype).encode())
    crc = zlib.crc32(np.ascontiguousarray(keys), crc)
    crc = zlib.crc32(np.ascontiguousarray(vals), crc)
    if lens is not None:
        crc = zlib.crc32(np.ascontiguousarray(
            np.asarray(lens, dtype=np.int64)), crc)
    return f"{crc:08x}"


def segment_filename(begin: int, end: int, uid: str = "") -> str:
    """Per-range segment name.  ``uid`` (the scheduler-minted attempt
    id) keeps each snapshot ATTEMPT's files distinct: without it, a
    later attempt that gets vetoed (one server errored after another
    already wrote) would have overwritten the previously COMMITTED
    snapshot's bytes in place, bricking the restore point the stale
    manifest still references."""
    base = f"range_{begin:016x}_{end:016x}"
    return f"{base}.{uid}" if uid else base


def write_range_segment(directory: str, begin: int, end: int,
                        keys: np.ndarray, vals: np.ndarray,
                        lens: Optional[np.ndarray],
                        fmt: str = "npz", uid: str = "") -> dict:
    """Write one exported range to its segment file; returns the
    manifest entry (begin/end/file/key count/bytes/digest/format)."""
    os.makedirs(directory, exist_ok=True)
    name = segment_filename(begin, end, uid)
    fmt = save_range_segment(
        os.path.join(directory, name), keys, vals, lens, fmt=fmt
    )
    return {
        "begin": int(begin),
        "end": int(end),
        "file": name,
        "keys": int(len(keys)),
        "nbytes": int(keys.nbytes + vals.nbytes
                      + (lens.nbytes if lens is not None else 0)),
        "digest": range_digest(keys, vals, lens),
        "format": fmt,
    }


def read_range_segment(directory: str, entry: dict) -> Tuple[
        np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Load one manifest entry's segment and VERIFY its digest; raises
    CheckError on mismatch or a missing file — a restore must fail
    loudly, never serve silently corrupted state."""
    keys, vals, lens = load_range_segment(
        os.path.join(directory, entry["file"]),
        fmt=entry.get("format", "npz"),
    )
    got = range_digest(keys, vals, lens)
    log.check(
        got == entry["digest"],
        f"snapshot digest mismatch for range [{entry['begin']:#x}, "
        f"{entry['end']:#x}): manifest says {entry['digest']}, segment "
        f"file {entry['file']!r} hashes to {got} — the snapshot is "
        f"corrupt; refusing to restore",
    )
    return keys, vals, lens


def write_manifest(directory: str, epoch: int, entries: List[dict],
                   extra: Optional[dict] = None) -> str:
    """Atomically commit the cluster manifest (the snapshot exists only
    once this file does)."""
    os.makedirs(directory, exist_ok=True)
    doc = {
        "version": 1,
        "epoch": int(epoch),
        "wall_time": time.time(),
        "ranges": sorted(entries, key=lambda e: e["begin"]),
    }
    if extra:
        doc.update(extra)
    path = os.path.join(directory, MANIFEST_NAME)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    fsync_dir(directory)
    return path


def prune_segments(directory: str, manifest: dict) -> int:
    """Best-effort GC after a COMMIT: remove ``range_*`` segment files
    (and their writers' leftover temporaries) that the just-committed
    manifest does not reference — the previous snapshot's segments and
    any vetoed attempt's orphans.  Runs only AFTER the new manifest is
    durable, so the restore point is never without a full segment set.
    Returns the number of entries removed; IO errors are ignored (a
    shared directory may race another writer — garbage is harmless,
    a failed prune must not fail the snapshot)."""
    referenced = {e["file"] for e in manifest.get("ranges", [])}
    removed = 0
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    for name in names:
        # npz segments live as "<entry>.npz" on disk; orbax segments
        # are directories named exactly "<entry>".
        base = name[:-4] if name.endswith(".npz") else name
        if not base.startswith("range_") or base in referenced:
            continue
        path = os.path.join(directory, name)
        try:
            if os.path.isdir(path):
                import shutil

                shutil.rmtree(path, ignore_errors=True)
            else:
                os.unlink(path)
            removed += 1
        except OSError:
            pass
    return removed


def load_manifest(directory: Optional[str]) -> Optional[dict]:
    """The committed manifest, or None (no directory / never
    snapshotted / manifest unreadable — unreadable is logged, not
    fatal: restore then declines like a cold start)."""
    if not directory:
        return None
    path = os.path.join(directory, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as fh:
            return json.load(fh)
    except Exception as exc:  # noqa: BLE001 - corrupt manifest
        log.warning(f"unreadable snapshot manifest {path!r}: {exc!r}")
        return None


def manifest_age_s(directory: Optional[str]) -> float:
    """Seconds since the newest committed manifest, or -1.0 when none
    exists — the ``snapshot.age_s`` gauge the SLO watchdog's
    ``snapshot_age`` rule grades (negative = never snapshotted, which
    the rule skips rather than alarming on un-configured clusters)."""
    if not directory:
        return -1.0
    path = os.path.join(directory, MANIFEST_NAME)
    try:
        return max(0.0, time.time() - os.path.getmtime(path))
    except OSError:
        return -1.0


def _filter_to_ranges(keys: np.ndarray, vals: np.ndarray,
                      lens: Optional[np.ndarray], owned) -> Tuple[
                          np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Keep only the keys inside the caller's owned ranges (an elastic
    reboot can own a different cut than the manifest's writer did).
    Keys are sorted (export_range sorts), so each range is one slice."""
    mask = np.zeros(len(keys), dtype=bool)
    for rng in owned:
        pos = find_range(keys, rng.begin, rng.end)
        mask[pos.begin:pos.end] = True
    if mask.all():
        return keys, vals, lens
    if lens is not None:
        # abs(): negative lens tag slot-packed optimizer records; the
        # magnitude is the record length (kv_app state iterator).
        offs = np.concatenate(
            ([0], np.cumsum(np.abs(np.asarray(lens, dtype=np.int64)))))
        parts = [vals[offs[i]:offs[i + 1]]
                 for i in np.nonzero(mask)[0]]
        out_vals = (np.concatenate(parts) if parts
                    else vals[:0])
        return keys[mask], out_vals, np.asarray(lens)[mask]
    k = len(vals) // max(len(keys), 1)
    return keys[mask], vals.reshape(len(keys), k)[mask].reshape(-1), None


def restore_into(handle, directory: str, owned_ranges,
                 manifest: Optional[dict] = None) -> Tuple[int, int]:
    """Restore every manifest range intersecting ``owned_ranges`` into
    ``handle`` (digest-verified, optimizer slots riding the handle's
    ``import_range``).  Returns ``(keys, bytes)`` restored; (0, 0) when
    no manifest is committed.  Digest mismatches and missing segment
    files raise (loud restore failure)."""
    from .replication import import_range

    manifest = manifest or load_manifest(directory)
    if manifest is None:
        return 0, 0
    total_keys = 0
    total_bytes = 0
    for entry in manifest.get("ranges", []):
        if not any(rng.begin < entry["end"] and entry["begin"] < rng.end
                   for rng in owned_ranges):
            continue
        keys, vals, lens = read_range_segment(directory, entry)
        keys, vals, lens = _filter_to_ranges(keys, vals, lens,
                                             owned_ranges)
        if not len(keys):
            continue
        import_range(handle, keys, vals, lens)
        total_keys += len(keys)
        total_bytes += int(vals.nbytes)
    return total_keys, total_bytes


def snapshot_summary(replies: Dict[int, dict]) -> Tuple[
        List[dict], List[str]]:
    """Split the scheduler's gathered per-server replies into manifest
    entries and error strings (an errored or silent server VETOES the
    commit — a manifest that is missing a range would restore a
    silently truncated store)."""
    entries: List[dict] = []
    errors: List[str] = []
    for nid, rep in sorted(replies.items()):
        if rep.get("error"):
            errors.append(f"node {nid}: {rep['error']}")
            continue
        entries.extend(rep.get("ranges", []))
    return entries, errors
