"""Pre-staged epoch cache: a dataset decoded once into an mmap-served file
set (port of `moco_tpu/data/service/prestage.py` and `tools/prestage.py`).

The staged canvas is a deterministic function of the file bytes (every
random transform runs on the device), so a whole dataset can be decoded
once, offline, into a packed fixed-shape memmap that every epoch of every
run then serves at memcpy speed:

    <root>/
        canvases.u8     [N, H, W, 3] uint8, C order (.npy format, memmapped)
        extents.i32     [N, 3] int32 (valid_h, valid_w, rot)
        labels.i32      [N] int32
        meta.json       geometry, counts, source: written LAST by an atomic
                        rename, so its presence marks a complete prestage

Rows are stored in dataset-index order, not in an epoch's order, so one
prestage serves every epoch and every mid-epoch resume: an epoch is row
gathers. `PrestagedDataset` speaks the batch protocol (`get_batch`,
`get_batch_into`, `labels`, `__len__`), so `epoch_loader` stages from it
unchanged. A prestaged batch equals the freshly decoded one bit for bit:
its bytes are the decode's output, copied once. The layout is the JAX
package's, so either package reads the other's prestage.

    python -m moco_tpu_torch.data.service.prestage /fast/ssd/prestage \\
        --dataset imagefolder --data-dir /data/imagenet/train --stage-size 512

then train from it with `--input-prestage /fast/ssd/prestage`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

META_FILENAME = "meta.json"
CANVASES_FILENAME = "canvases.u8"
EXTENTS_FILENAME = "extents.i32"
LABELS_FILENAME = "labels.i32"

FORMAT_VERSION = 1

EXIT_OK = 0
EXIT_CONFIG_ERROR = 45  # the JAX package's exit code for a bad config


class PrestageError(ValueError):
    """The directory is not a complete, consistent prestage (missing meta,
    truncated payload, geometry mismatch). Loud on purpose: a half-written
    prestage read as zeros would poison a run."""


def _paths(root: str) -> dict:
    return {name: os.path.join(root, fname) for name, fname in (
        ("meta", META_FILENAME), ("canvases", CANVASES_FILENAME),
        ("extents", EXTENTS_FILENAME), ("labels", LABELS_FILENAME),
    )}


def write_prestage(dataset, root: str, *, chunk: int = 64, progress=None) -> dict:
    """Decode `dataset` (batch protocol) into a prestage at `root`, in
    `chunk`-row slices straight into the memmap (`get_batch_into` where the
    dataset has it, else `get_batch` and a copy). Returns the meta dict;
    `progress(done, total)` is an optional callback.

    Any decode failure aborts the write: one zero canvas frozen into an
    artifact that serves every epoch would do more harm than any runtime
    failure (`decode_abort_rate` guards those)."""
    n = len(dataset)
    if n == 0:
        raise PrestageError("refusing to prestage an empty dataset")
    probe, _labels, _extents = dataset.get_batch(np.asarray([0]))
    img_shape = tuple(int(d) for d in probe.shape[1:])
    if probe.dtype != np.uint8:
        raise PrestageError(f"prestage expects uint8 canvases, got {probe.dtype}")
    os.makedirs(root, exist_ok=True)
    paths = _paths(root)
    if os.path.exists(paths["meta"]):
        raise PrestageError(f"{root!r} already holds a complete prestage; remove it first "
                            "(a prestage is never overwritten silently)")
    canvases = np.lib.format.open_memmap(paths["canvases"], mode="w+", dtype=np.uint8,
                                         shape=(n,) + img_shape)
    extents = np.lib.format.open_memmap(paths["extents"], mode="w+", dtype=np.int32,
                                        shape=(n, 3))
    labels = np.lib.format.open_memmap(paths["labels"], mode="w+", dtype=np.int32,
                                       shape=(n,))
    fail_before = getattr(dataset, "decode_failures", 0)
    into = hasattr(dataset, "get_batch_into")
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        idx = np.arange(lo, hi)
        if into:
            labels[lo:hi] = dataset.get_batch_into(idx, canvases[lo:hi], extents[lo:hi])
        else:
            imgs, labs, exts = dataset.get_batch(idx)
            canvases[lo:hi] = imgs
            extents[lo:hi] = exts
            labels[lo:hi] = labs
        if progress is not None:
            progress(hi, n)
    failed = getattr(dataset, "decode_failures", 0) - fail_before
    if failed:
        raise PrestageError(f"{failed} decode failure(s) during prestage: refusing to "
                            "freeze zero canvases into it")
    for arr in (canvases, extents, labels):
        arr.flush()
    meta = {
        "v": FORMAT_VERSION,
        "n": n,
        "img_shape": list(img_shape),
        "img_dtype": "uint8",
        "num_classes": int(getattr(dataset, "num_classes", 0)),
        "image_size": int(getattr(dataset, "image_size", img_shape[0])),
        "stage_h": int(getattr(dataset, "stage_h", img_shape[0])),
        "stage_w": int(getattr(dataset, "stage_w", img_shape[1])),
        "canvas_bytes": int(canvases.nbytes),
        "source": type(getattr(dataset, "dataset", dataset)).__name__,
    }
    tmp = paths["meta"] + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, paths["meta"])  # meta lands last, atomically
    return meta


class PrestagedDataset:
    """A prestage directory through the batch protocol. The canvases are an
    `np.memmap` (`mmap=True`): the page cache is the only copy, shared by
    every process on the host that reads it. `mmap=False` loads everything
    into memory up front."""

    def __init__(self, root: str, *, mmap: bool = True):
        paths = _paths(root)
        if not os.path.exists(paths["meta"]):
            raise PrestageError(f"{root!r} has no {META_FILENAME}: not a complete prestage "
                                "(the writer lands meta last, so a missing meta means a "
                                "killed or still-running write)")
        with open(paths["meta"], encoding="utf-8") as f:
            self.meta = json.load(f)
        if self.meta.get("v") != FORMAT_VERSION:
            raise PrestageError(f"prestage format v{self.meta.get('v')} != "
                                f"v{FORMAT_VERSION} reader")
        self.root = root
        mode = "r" if mmap else None
        try:
            self.images = np.load(paths["canvases"], mmap_mode=mode)
            self._extents = np.load(paths["extents"], mmap_mode=mode)
            self.labels = np.asarray(np.load(paths["labels"]), np.int32)
        except (OSError, ValueError, EOFError) as e:
            raise PrestageError(f"{root!r}: unreadable payload ({e})") from e
        n = int(self.meta["n"])
        shape = (n,) + tuple(self.meta["img_shape"])
        if (self.images.shape != shape or self.images.dtype != np.uint8
                or self._extents.shape != (n, 3) or self.labels.shape != (n,)):
            raise PrestageError(
                f"prestage payload disagrees with meta: canvases {self.images.shape}/"
                f"{self.images.dtype} vs {shape}/uint8, extents {self._extents.shape}, "
                f"labels {self.labels.shape}")
        self.num_classes = int(self.meta.get("num_classes", 0))
        self.image_size = int(self.meta.get("image_size", shape[1]))
        self.stage_h = int(self.meta.get("stage_h", shape[1]))
        self.stage_w = int(self.meta.get("stage_w", shape[2]))

    def __len__(self) -> int:
        return int(self.meta["n"])

    def get_batch(self, indices):
        idx = np.asarray(indices)
        # fancy indexing a memmap materializes real arrays (the one copy)
        return np.asarray(self.images[idx]), self.labels[idx], np.asarray(self._extents[idx])

    def get_batch_into(self, indices, out_imgs: np.ndarray,
                       out_extents: np.ndarray) -> np.ndarray:
        """Copy rows straight into caller-owned canvas rows (the staging
        canvas protocol)."""
        idx = [int(i) for i in indices]
        for j, i in enumerate(idx):
            out_imgs[j] = self.images[i]
            out_extents[j] = self._extents[i]
        return self.labels[np.asarray(idx)]


def main(argv=None) -> int:
    from moco_tpu_torch.data.datasets import build_dataset

    parser = argparse.ArgumentParser(description="decode a dataset once into a pre-staged "
                                                 "epoch cache")
    parser.add_argument("root", help="output directory")
    parser.add_argument("--dataset", default="synthetic")
    parser.add_argument("--data-dir", default="")
    parser.add_argument("--image-size", type=int, default=32)
    parser.add_argument("--stage-size", type=int, default=0)
    parser.add_argument("--loader-workers", type=int, default=8)
    parser.add_argument("--num-samples", type=int, default=2048,
                        help="synthetic datasets only")
    parser.add_argument("--seed", type=int, default=0, help="synthetic datasets only")
    parser.add_argument("--chunk", type=int, default=64, help="rows per memmap write")
    args = parser.parse_args(argv)
    kw = {}
    if args.dataset.startswith("synthetic"):
        kw = {"num_samples": args.num_samples, "seed": args.seed}
    try:
        dataset = build_dataset(args.dataset, data_dir=args.data_dir,
                                image_size=args.image_size, stage_size=args.stage_size,
                                num_workers=args.loader_workers, **kw)
    except (ValueError, OSError) as e:
        print(f"[prestage] cannot build dataset: {e}", file=sys.stderr, flush=True)
        return EXIT_CONFIG_ERROR
    t0 = time.perf_counter()
    last = [0.0]

    def progress(done: int, total: int) -> None:
        now = time.perf_counter()
        if now - last[0] >= 5.0 or done == total:
            last[0] = now
            print(f"[prestage] {done}/{total} rows ({done / max(now - t0, 1e-9):.0f} rows/s)",
                  file=sys.stderr, flush=True)

    try:
        meta = write_prestage(dataset, args.root, chunk=args.chunk, progress=progress)
    except PrestageError as e:
        print(f"[prestage] refused: {e}", file=sys.stderr, flush=True)
        return EXIT_CONFIG_ERROR
    print(f"[prestage] complete: {meta['n']} rows, {meta['canvas_bytes'] / 2**30:.2f} GiB "
          f"canvases in {time.perf_counter() - t0:.1f} s at {args.root}", flush=True)
    return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
