"""Checkpoint integrity sidecars (the port's own copy of
`moco_tpu/resilience/integrity.py`, with the same on-disk layout, so a
checkpoint directory one package wrote reads the same in the other).

After every finished save, a manifest (relative path, size and sha256 of
each file of the step) goes to `<ckpt_dir>/.integrity/<step>.json`; a
resume with `"auto"` walks back from the newest step to the newest one
that VERIFIES (`checkpoint.restore_checkpoint`), so a writer killed mid-save
cannot brick the resume. The data-stream position of a step goes to
`<ckpt_dir>/.position/<step>.json`. Both directory names start with a dot,
so no reader mistakes them for steps, and both files are written atomically
(a temporary file, then `os.replace`).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

INTEGRITY_DIRNAME = ".integrity"
POSITION_DIRNAME = ".position"
_CHUNK = 1 << 20


def _log(msg: str) -> None:
    print(f"[ckpt-verify] {msg}", file=sys.stderr, flush=True)


def position_path(ckpt_dir: str, step: int) -> str:
    """Path of a step's data-stream position sidecar."""
    return os.path.join(ckpt_dir, POSITION_DIRNAME, f"{step}.json")


def digest_file(path: str) -> str:
    """Chunked sha256 of one file, as the manifests record it."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(_CHUNK)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def manifest_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), INTEGRITY_DIRNAME, f"{step}.json")


def _walk_step_files(step_dir: str) -> list[str]:
    out = []
    for dirpath, _dirnames, filenames in os.walk(step_dir):
        for fname in filenames:
            out.append(os.path.relpath(os.path.join(dirpath, fname), step_dir))
    return sorted(out)


def write_manifest(ckpt_dir: str, step: int) -> dict:
    """Record a finished step's file inventory and digests. Run it only
    after the step's files are complete: a manifest of a save in flight
    would certify garbage."""
    step_dir = os.path.join(os.path.abspath(ckpt_dir), str(step))
    files = {}
    for rel in _walk_step_files(step_dir):
        full = os.path.join(step_dir, rel)
        files[rel] = {"size": os.path.getsize(full), "sha256": digest_file(full)}
    manifest = {"step": int(step), "files": files}
    path = manifest_path(ckpt_dir, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, path)
    return manifest


def verify_step(ckpt_dir: str, step: int) -> str | None:
    """None when the step's files match its manifest, or when it has no
    manifest (then the restore itself is the only gate); else a readable
    reason for the mismatch."""
    path = manifest_path(ckpt_dir, step)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        return f"unreadable manifest {path}: {e}"
    step_dir = os.path.join(os.path.abspath(ckpt_dir), str(step))
    expected = manifest.get("files", {})
    for rel, meta in expected.items():
        full = os.path.join(step_dir, rel)
        if not os.path.exists(full):
            return f"missing file {rel}"
        size = os.path.getsize(full)
        if size != meta["size"]:
            return f"size mismatch on {rel}: {size} != {meta['size']}"
        if digest_file(full) != meta["sha256"]:
            return f"digest mismatch on {rel}"
    extra = set(_walk_step_files(step_dir)) - set(expected)
    if extra:
        # tolerated, but noted: they can explain a later restore surprise
        _log(f"step {step}: {len(extra)} file(s) not in manifest: {sorted(extra)[:4]}")
    return None
