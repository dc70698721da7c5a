"""Verified checkpoints: per-file CRC manifests (counterpart of
``neuronx_distributed_tpu/integrity/checkpoint.py``: ``INTEGRITY_MANIFEST``,
``compute_digests``, ``write_manifest``, ``verify_manifest``).

Every save writes ``integrity.json`` into its tag AFTER the payload lands
and BEFORE the ``done`` marker commits, so a tag with a marker always holds
a manifest of what was on disk at commit. A restore verifies every
manifested file before a byte reaches the live state; a mismatch means the
bytes rotted after a clean commit (the corruption the marker protocol
cannot see), and the restore falls back to the previous good tag. Digests
are CRC-32 (``utils/fingerprint.bytes_fingerprint``): a save hands in the
payload files' CRCs taken as they were written, every other file is read
back; a verify streams every file in chunks, several files at once in
threads (``zlib.crc32`` releases the GIL). A tag without a manifest
verifies as ``legacy``."""

from __future__ import annotations

import concurrent.futures
import json
import os
from typing import Dict, Optional, Tuple

from neuronx_distributed_tpu_torch.utils.fingerprint import bytes_fingerprint

INTEGRITY_MANIFEST = "integrity.json"
DIGEST_THREADS = 8

__all__ = ["INTEGRITY_MANIFEST", "compute_digests", "write_manifest", "verify_manifest"]


def _digest(storage, path: str) -> int:
    fp = 0
    for block in storage.iter_bytes(path):
        fp = bytes_fingerprint(block, fp)
    return fp


def _digest_all(storage, tag: str, rels) -> Dict[str, int]:
    rels = list(rels)
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, min(DIGEST_THREADS, len(rels)))) as pool:
        values = list(pool.map(lambda rel: _digest(storage, os.path.join(tag, rel)), rels))
    return dict(zip(rels, values))


def compute_digests(storage, tag: str) -> Dict[str, int]:
    """CRC-32 of every file under ``tag`` (relative paths), the manifest
    itself excluded (the ``done`` marker is written after it; ``newest``
    lives outside tags)."""
    return _digest_all(storage, tag,
                       (rel for rel in storage.list_files(tag) if rel != INTEGRITY_MANIFEST))


def write_manifest(storage, tag: str, known: Optional[Dict[str, int]] = None) -> None:
    """Digest the tag's files and write the manifest: between the payload
    and the commit, so it describes exactly the bytes the marker is about to
    bless. ``known`` holds CRCs already taken of files written (relative
    paths); every other file under the tag is read."""
    known = known or {}
    rels = [rel for rel in storage.list_files(tag) if rel != INTEGRITY_MANIFEST]
    files = dict(known)
    files.update(_digest_all(storage, tag, [rel for rel in rels if rel not in known]))
    manifest = {"version": 1, "files": {rel: files[rel] for rel in rels}}
    storage.save_text(json.dumps(manifest), os.path.join(tag, INTEGRITY_MANIFEST))


def verify_manifest(storage, tag: str) -> Tuple[bool, str]:
    """``(ok, detail)``: ``(True, "legacy")`` without a manifest, ``(True,
    "verified <n> files")`` on a match, ``(False, ...)`` naming the first
    missing or mismatched file (in sorted order) otherwise."""
    path = os.path.join(tag, INTEGRITY_MANIFEST)
    if not storage.file_exists(path):
        return True, "legacy"
    try:
        files = json.loads(storage.load_text(path))["files"]
    except Exception as e:  # an unreadable manifest IS corruption
        return False, f"unreadable manifest: {type(e).__name__}: {e}"
    names = sorted(files)
    for rel in names:
        if not storage.file_exists(os.path.join(tag, rel)):
            return False, f"missing file {rel!r}"
    have = _digest_all(storage, tag, names)
    for rel in names:
        want = int(files[rel])
        if have[rel] != want:
            return False, (f"digest mismatch on {rel!r}: manifest {want:#010x}, on disk "
                           f"{have[rel]:#010x}")
    return True, f"verified {len(files)} files"
