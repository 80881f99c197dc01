"""Versioned kNN-bank builder: bulk re-embed a corpus against ONE named
checkpoint step (port of `moco_tpu/serve/bankbuild.py`; the files and the
manifest are the same, so either package reads and verifies what the
other wrote).

The service refuses to hot-swap encoder weights under a configured
kNN bank because the bank's features live in the OLD
encoder's space. This module closes the loop: it produces a **versioned
bank artifact** that is cryptographically bound to the checkpoint it was
embedded with, so the fleet can roll engine+bank together as a verified
pair (the dual swap in service.py / fleet.py).

Artifact layout mirrors the checkpoint-export scheme so the same
integrity machinery verifies both halves of a pair::

    <bank_dir>/<step>/bank.npz            features [N,D] f32 + labels [N] i32
    <bank_dir>/.integrity/<step>.json     manifest, written LAST

The manifest carries three bindings on top of the standard
``files:{rel:{size,sha256}}`` block (resilience/integrity.py ignores
extra top-level keys, so ``verify_step`` works unchanged):

* ``checkpoint`` — sha256 + size of the encoder payload the corpus was
  embedded with. A doctored or mismatched pair fails this check before
  any engine is built.
* ``probe`` — a few rows of a SEEDED synthetic probe batch embedded at
  build time. At swap time the serving replica re-embeds the same probe
  with the candidate engine and compares row-wise cosine: the
  space-agreement check that catches a bank whose manifest lies.
* ``shards`` — build topology, recorded for forensics only: the merge
  is in dataset-index order, so the output bytes are identical for any
  shard count (the engine embeds a row independently of its batch).

Builds are resumable and worker-death tolerant: each shard lands
atomically in ``<bank_dir>/.build/<step>/`` and a restarted build reuses
completed shards; a failing shard is retried on another worker up to
``max_shard_retries`` times. All artifact writes go through the
``atomic_*`` helpers below (temp + rename).

numpy + stdlib only — the engine import stays inside the offline-build
path so the batch-lane builder (HTTP against a serving replica) never
pulls torch.
"""

from __future__ import annotations

import io
import json
import os
import queue
import tempfile
import threading
import zipfile

import numpy as np

from moco_tpu_torch.resilience.integrity import (
    digest_file,
    manifest_path,
    verify_step,
)

# Same seed family as the reload drift guard's probe: any party holding
# (seed, rows, image_size) regenerates the identical probe batch.
PROBE_SEED = 20130613
BANK_FILENAME = "bank.npz"
BUILD_DIRNAME = ".build"
DEFAULT_PROBE_ROWS = 8


class BankBuildError(RuntimeError):
    """A shard exhausted its retries or the corpus/checkpoint is unusable."""


# ---------------------------------------------------------------------------
# atomic, deterministic artifact writes
# ---------------------------------------------------------------------------


def atomic_write_json(path: str, obj: dict) -> None:
    """Write JSON via temp + rename so readers never see a torn file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(path) or ".", prefix=".tmp_", suffix=".json"
    )
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_save_npz(path: str, arrays: dict) -> None:
    """Byte-DETERMINISTIC npz write via temp + rename.

    ``np.savez`` is not reproducible across numpy versions (the zip
    member timestamps come from localtime on some versions, the 1980
    epoch on others), so the 1-shard-vs-3-shard bit-identity pin would
    be at the mercy of the environment. We write the zip by hand:
    ZIP_STORED members in sorted-name order with the ZipInfo default
    (1980) timestamp. ``np.load`` reads the result like any npz.
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(path) or ".", prefix=".tmp_", suffix=".npz"
    )
    try:
        with os.fdopen(fd, "wb") as f:
            with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED) as zf:
                for name in sorted(arrays):
                    buf = io.BytesIO()
                    np.lib.format.write_array(
                        buf, np.ascontiguousarray(arrays[name]),
                        allow_pickle=False,
                    )
                    zf.writestr(zipfile.ZipInfo(name + ".npy"),
                                buf.getvalue())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# ---------------------------------------------------------------------------
# probe + shard geometry
# ---------------------------------------------------------------------------


def probe_batch(image_size: int, rows: int) -> np.ndarray:
    """The seeded synthetic probe batch — identical bytes for any caller
    holding (PROBE_SEED, rows, image_size). Row i is a deterministic
    prefix of one rng stream, so a consumer may compare only the first
    k <= rows rows (a serving ladder whose largest bucket is smaller
    than ``rows`` embeds a prefix)."""
    rng = np.random.default_rng(PROBE_SEED)
    return rng.integers(
        0, 256, size=(rows, image_size, image_size, 3), dtype=np.uint8
    )


def shard_ranges(n: int, shards: int) -> list:
    """[(start, end), ...] covering [0, n) in dataset-index order.

    The merge concatenates in this order, so the bank bytes do not
    depend on the shard count — only on the corpus and the engine.
    """
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    shards = min(shards, max(n, 1))
    base, extra = divmod(n, shards)
    out, start = [], 0
    for i in range(shards):
        end = start + base + (1 if i < extra else 0)
        out.append((start, end))
        start = end
    return out


def _shard_path(work_dir: str, start: int, end: int) -> str:
    return os.path.join(work_dir, f"shard_{start:08d}_{end:08d}.npz")


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def _embed_range(embed_fn, images: np.ndarray, start: int, end: int,
                 batch_rows: int) -> np.ndarray:
    rows = []
    for lo in range(start, end, batch_rows):
        hi = min(lo + batch_rows, end)
        out = np.asarray(embed_fn(images[lo:hi]), dtype=np.float32)
        if out.ndim != 2 or out.shape[0] != hi - lo:
            raise BankBuildError(
                f"embed_fn returned shape {out.shape} for rows "
                f"[{lo}:{hi}) — expected [{hi - lo}, D]"
            )
        rows.append(out)
    return np.concatenate(rows, axis=0) if rows else np.zeros(
        (0, 0), np.float32
    )


def build_bank(bank_dir: str, step: int, images: np.ndarray,
               labels: np.ndarray, embed_fn, *, checkpoint_path: str,
               image_size: int, shards: int = 1, workers: int = 1,
               probe_rows: int = DEFAULT_PROBE_ROWS, batch_rows: int = 64,
               emit=None, max_shard_retries: int = 3) -> dict:
    """Embed ``images`` with ``embed_fn`` into a versioned bank artifact.

    Sharded fan-out over ``workers`` threads, merge in dataset-index
    order (bit-identical for any shard count), shard files + the final
    bank written atomically, manifest written LAST so a partial build is
    never eligible for promotion. A re-run after a crash reuses every
    completed shard. Returns the manifest dict.

    ``embed_fn(batch[B,S,S,3] uint8) -> [B,D] float32`` may be an
    in-process engine closure (offline path) or an HTTP closure over a
    serve fleet's batch lane (``http_embed_fn``) — worker death in
    either shows up as an exception and the shard retries elsewhere.
    ``emit(event, **fields)`` (optional) receives build telemetry
    (build_start / shard_done / build_done).
    """
    images = np.asarray(images)
    labels = np.asarray(labels)
    if images.ndim != 4 or images.shape[0] != labels.shape[0]:
        raise BankBuildError(
            f"corpus shape mismatch: images {images.shape} vs labels "
            f"{labels.shape}"
        )
    n = int(images.shape[0])
    if n == 0:
        raise BankBuildError("empty corpus")
    ckpt_sha = digest_file(checkpoint_path)
    work_dir = os.path.join(bank_dir, BUILD_DIRNAME, str(step))
    os.makedirs(work_dir, exist_ok=True)
    ranges = shard_ranges(n, shards)
    if emit is not None:
        emit("build_start", step=step, rows=n, shards=len(ranges),
             checkpoint_sha256=ckpt_sha)

    todo: "queue.Queue" = queue.Queue()
    pending = 0
    for idx, (start, end) in enumerate(ranges):
        if os.path.exists(_shard_path(work_dir, start, end)):
            if emit is not None:
                emit("shard_done", step=step, shard=idx, start=start,
                     end=end, reused=True)
            continue
        todo.put((idx, 0))
        pending += 1

    errors: list = []
    done = threading.Event()
    lock = threading.Lock()

    def worker():
        nonlocal pending
        while not done.is_set():
            try:
                idx, attempts = todo.get(timeout=0.1)
            except queue.Empty:
                with lock:
                    if pending == 0:
                        return
                continue
            start, end = ranges[idx]
            try:
                feats = _embed_range(embed_fn, images, start, end,
                                     batch_rows)
                atomic_save_npz(_shard_path(work_dir, start, end),
                                {"features": feats})
            except Exception as e:  # retry on another worker
                if attempts + 1 >= max_shard_retries:
                    with lock:
                        errors.append(
                            BankBuildError(
                                f"shard {idx} rows [{start}:{end}) failed "
                                f"{attempts + 1}x: {e}"
                            )
                        )
                        pending -= 1
                    done.set()
                else:
                    todo.put((idx, attempts + 1))
                continue
            with lock:
                pending -= 1
            if emit is not None:
                emit("shard_done", step=step, shard=idx, start=start,
                     end=end, reused=False)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(1, workers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]

    # merge in dataset-index order — byte-identical for any shard count
    parts = []
    for start, end in ranges:
        with np.load(_shard_path(work_dir, start, end)) as z:
            part = z["features"].astype(np.float32, copy=False)
        if part.shape[0] != end - start:
            raise BankBuildError(
                f"shard rows [{start}:{end}) holds {part.shape[0]} rows "
                "— stale shard file? delete the .build dir and rerun"
            )
        parts.append(part)
    features = np.concatenate(parts, axis=0)
    probe = probe_batch(image_size, probe_rows)
    probe_feats = np.asarray(embed_fn(probe), dtype=np.float32)

    step_dir = os.path.join(bank_dir, str(step))
    bank_path = os.path.join(step_dir, BANK_FILENAME)
    atomic_save_npz(bank_path, {
        "features": features.astype(np.float32, copy=False),
        "labels": labels.astype(np.int32, copy=False),
    })
    manifest = {
        "v": 1,
        "kind": "bank",
        "step": int(step),
        "rows": int(features.shape[0]),
        "feat_dim": int(features.shape[1]),
        "shards": len(ranges),
        "files": {
            BANK_FILENAME: {
                "size": os.path.getsize(bank_path),
                "sha256": digest_file(bank_path),
            },
        },
        "checkpoint": {
            "file": os.path.basename(checkpoint_path),
            "size": os.path.getsize(checkpoint_path),
            "sha256": ckpt_sha,
        },
        "probe": {
            "seed": PROBE_SEED,
            "rows": int(probe_rows),
            "image_size": int(image_size),
            "features": [[float(x) for x in row] for row in probe_feats],
        },
    }
    # manifest LAST: only now is the artifact eligible for promotion
    atomic_write_json(manifest_path(bank_dir, step), manifest)
    _cleanup_build_dir(work_dir)
    if emit is not None:
        emit("build_done", step=step, rows=int(features.shape[0]),
             feat_dim=int(features.shape[1]), shards=len(ranges),
             manifest_sha256=digest_file(manifest_path(bank_dir, step)))
    return manifest


def _cleanup_build_dir(work_dir: str) -> None:
    try:
        for name in os.listdir(work_dir):
            os.unlink(os.path.join(work_dir, name))
        os.rmdir(work_dir)
        parent = os.path.dirname(work_dir)
        if not os.listdir(parent):
            os.rmdir(parent)
    except OSError:
        pass  # best-effort; a leftover .build dir never promotes


# ---------------------------------------------------------------------------
# load + verify (the serving side)
# ---------------------------------------------------------------------------


def load_bank(path: str):
    """(features [N,D] f32, labels [N], meta|None) from a bank npz.

    Works for BOTH a plain npz (the unversioned --knn-bank contract)
    and a versioned artifact — ``meta`` is None when the npz has no
    adjacent manifest, so bank-free and legacy deployments are
    untouched.
    """
    bank = np.load(path)
    if "features" not in bank or "labels" not in bank:
        raise ValueError(
            f"--knn-bank {path!r} needs `features` [N,D] and `labels` "
            "[N] arrays"
        )
    return bank["features"], bank["labels"], read_bank_meta(path)


def read_bank_meta(bank_npz_path: str):
    """Manifest-derived metadata for a versioned bank npz, or None.

    A versioned bank lives at ``<bank_dir>/<step>/bank.npz`` with its
    manifest at ``<bank_dir>/.integrity/<step>.json``. Any other layout
    (plain npz, digit-less parent) is a legacy bank: None.
    """
    step_dir = os.path.dirname(os.path.abspath(bank_npz_path))
    step_name = os.path.basename(step_dir)
    if not step_name.isdigit():
        return None
    bank_dir = os.path.dirname(step_dir)
    step = int(step_name)
    mpath = manifest_path(bank_dir, step)
    if not os.path.exists(mpath):
        return None
    with open(mpath) as f:
        manifest = json.load(f)
    return {
        "step": step,
        "path": os.path.abspath(bank_npz_path),
        "bank_dir": bank_dir,
        "manifest_path": mpath,
        "manifest_sha256": digest_file(mpath),
        "rows": manifest.get("rows"),
        "feat_dim": manifest.get("feat_dim"),
        "shards": manifest.get("shards"),
        "checkpoint_sha256": (manifest.get("checkpoint") or {}).get("sha256"),
        "probe": manifest.get("probe"),
    }


def verify_bank(bank_dir: str, step: int):
    """integrity.verify_step over the bank layout: None when the npz
    matches its manifest hashes, else the failure reason."""
    return verify_step(bank_dir, step)


def probe_agreement(embed_fn, meta) -> float:
    """Mean row-wise cosine between the bank's recorded probe features
    and the same probe rows embedded by ``embed_fn`` — the bank/encoder
    space-agreement score. 1.0 = identical space; a bank whose manifest
    lies about its checkpoint scores near chance.

    Embeds only as many rows as ``embed_fn`` can take in one call if
    the caller pre-slices; rows are a deterministic prefix of one rng
    stream, so comparing the first k rows is sound.
    """
    probe = meta.get("probe") or {}
    recorded = np.asarray(probe.get("features", ()), dtype=np.float32)
    if recorded.ndim != 2 or recorded.shape[0] == 0:
        raise ValueError("bank manifest records no probe rows")
    batch = probe_batch(int(probe["image_size"]), recorded.shape[0])
    ours = np.asarray(embed_fn(batch), dtype=np.float32)
    k = min(recorded.shape[0], ours.shape[0])
    if k == 0 or ours.shape[1] != recorded.shape[1]:
        return 0.0
    a, b = recorded[:k], ours[:k]
    an = np.linalg.norm(a, axis=1)
    bn = np.linalg.norm(b, axis=1)
    denom = np.maximum(an * bn, 1e-12)
    return float(np.mean(np.sum(a * b, axis=1) / denom))


# ---------------------------------------------------------------------------
# batch-lane embed_fn: build over a running serve fleet
# ---------------------------------------------------------------------------


def http_embed_fn(base_url: str, *, timeout_s: float = 30.0):
    """embed_fn closure over a serve fleet's POST /v1/embed lane.

    Each row goes out as one request (the replica's batcher coalesces
    them into bucket-ladder batches); a dead worker surfaces as an
    exception and build_bank retries the shard elsewhere. NOTE: the
    fleet must be SERVING the target checkpoint — a bank built through
    replicas on older weights would fail the space-agreement check at
    swap time (by design).
    """
    import urllib.request

    url = base_url.rstrip("/") + "/v1/embed"

    def embed(batch: np.ndarray) -> np.ndarray:
        rows = []
        for img in np.asarray(batch):
            body = json.dumps({
                "pixels": img.astype(np.uint8).tolist(),
                # tiered admission: a fleet-mode bank build
                # is throughput work — it rides the batch lane so a
                # build flood can never shed interactive traffic
                "tier": "batch",
            }).encode()
            req = urllib.request.Request(
                url, data=body,
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                payload = json.loads(resp.read().decode())
            rows.append(np.asarray(payload["embedding"], np.float32))
        return np.stack(rows, axis=0)

    return embed
