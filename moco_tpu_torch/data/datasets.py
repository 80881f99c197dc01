"""Datasets of the port (port of `moco_tpu/data/datasets.py`; the same
classes, names and bytes).

- `SyntheticDataset`: class-structured random images (a fixed
  low-frequency pattern per class plus per-sample noise).
- `SyntheticTextureDataset`: clusterable fake data an untrained network
  cannot solve (a class texture under a strong per-sample color cast).
- `CIFAR10`: the `cifar-10-batches-py` pickle layout; `write_cifar10_tree`
  writes a tree in that layout from a seed (tests, `chip_smoke.py`).
- `ImageFolder`: a class-per-subdirectory image tree, each image decoded
  whole into a fixed `[stage_size, 2 * stage_size]` landscape uint8
  canvas (portrait images transposed, fit-downscaled, edge-padded) by the
  native JPEG stager (`native_loader.py`) or PIL.

Every dataset serves the same batch protocol: `get_batch(indices) ->
(images [B, H, W, 3] uint8, labels [B] int32, extents [B, 3] int32)` with
extents `(valid_h, valid_w, rot)` per sample: the whole canvas for the
in-memory square datasets, the staged geometry for ImageFolder. The host
never does float math on images; all augmentation runs on the device.
"""

from __future__ import annotations

import os
import pickle
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np


def full_extents(n: int, h: int, w: int) -> np.ndarray:
    """`[n, 3] (valid_h, valid_w, rot)` covering the whole canvas."""
    return np.tile(np.asarray([h, w, 0], np.int32), (n, 1))


class SyntheticDataset:
    """Deterministic clusterable fake images: each class is a fixed
    low-frequency pattern (a random 4x4 grid upsampled), each sample adds
    pixel noise. The same numpy draws as the JAX package's class, so both
    produce the same uint8 images for the same arguments."""

    def __init__(self, num_samples: int = 2048, image_size: int = 32,
                 num_classes: int = 10, seed: int = 0, noise: float = 0.15):
        rng = np.random.RandomState(seed)
        self.num_classes = num_classes
        self.image_size = image_size
        # prototypes from a FIXED seed: train/val instances share classes
        protos = np.random.RandomState(12345).rand(num_classes, 4, 4, 3)
        reps = image_size // 4
        protos = protos.repeat(reps, axis=1).repeat(reps, axis=2)
        labels = rng.randint(0, num_classes, size=num_samples)
        imgs = protos[labels] + noise * rng.randn(num_samples, image_size, image_size, 3)
        self.images = (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
        self.labels = labels.astype(np.int32)

    def __len__(self) -> int:
        return len(self.images)

    def get_batch(self, indices: np.ndarray):
        return (self.images[indices], self.labels[indices],
                full_extents(len(indices), self.image_size, self.image_size))


class SyntheticTextureDataset:
    """Clusterable fake data that an untrained network cannot solve.

    The class signal is a class-specific high-frequency grayscale 8x8 tile,
    tiled across the image with a random per-sample phase roll; the pixel
    variance is dominated by a per-sample RGB gain/bias (color cast),
    brightness offset and noise, which the augmentation randomizes away
    between views. Random-init features follow the cast (kNN near chance);
    augmentation-invariant features keep the texture. Class tiles come from
    a fixed seed, so train/val instances with other `seed`s share classes.
    `cast_strength` 0.5 gives gain U[0.7, 1.3], within the jitter's range.
    The same numpy draws as the JAX package's class, so the same bytes."""

    def __init__(self, num_samples: int = 16384, image_size: int = 32,
                 num_classes: int = 16, seed: int = 0, texture_amp: float = 0.4,
                 cast_strength: float = 0.5):
        if image_size % 8:
            raise ValueError(f"tile period 8 must divide image_size, got {image_size}")
        self.num_classes = num_classes
        self.image_size = image_size
        self.seed = seed
        self.texture_amp = texture_amp
        self.cast_strength = cast_strength
        g = np.random.RandomState(7777)
        tiles = g.rand(num_classes, 8, 8).astype(np.float32)
        tiles -= tiles.mean(axis=(1, 2), keepdims=True)  # zero-mean signal
        self.class_tiles = tiles
        rng = np.random.RandomState(seed)
        labels = rng.randint(0, num_classes, size=num_samples)
        reps = image_size // 8
        # f32 throughout: the output is quantized to uint8 anyway
        tex = np.tile(tiles[labels], (1, reps, reps))
        for i in range(num_samples):  # random texture phase per sample
            dy, dx = rng.randint(0, 8, size=2)
            tex[i] = np.roll(tex[i], (dy, dx), axis=(0, 1))
        g, b = 1.2 * cast_strength, 0.5 * cast_strength
        gain = (1.0 - g / 2) + g * rng.rand(num_samples, 1, 1, 3).astype(np.float32)
        imgs = (0.5 + texture_amp * tex[..., None]) * gain  # (N, H, W, 3) f32
        imgs += -b / 2 + b * rng.rand(num_samples, 1, 1, 3).astype(np.float32)
        imgs += 0.04 * rng.randn(num_samples, image_size, image_size, 3).astype(np.float32)
        self.images = (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
        self.labels = labels.astype(np.int32)

    def __len__(self) -> int:
        return len(self.images)

    def get_batch(self, indices: np.ndarray):
        return (self.images[indices], self.labels[indices],
                full_extents(len(indices), self.image_size, self.image_size))


class CIFAR10:
    """`cifar-10-batches-py` reader (pickle layout, 50k train / 10k test).
    The pickles are the dataset's own files: unpickling runs code, so
    `data_dir` must be a tree the user trusts, as with any CIFAR reader."""

    def __init__(self, data_dir: str, train: bool = True):
        batch_dir = data_dir
        if os.path.isdir(os.path.join(data_dir, "cifar-10-batches-py")):
            batch_dir = os.path.join(data_dir, "cifar-10-batches-py")
        names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        xs, ys = [], []
        for n in names:
            path = os.path.join(batch_dir, n)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"CIFAR-10 batch {path} not found: place the "
                    "'cifar-10-batches-py' directory under data_dir"
                )
            with open(path, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.extend(d[b"labels"])
        x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.images = np.ascontiguousarray(x)
        self.labels = np.asarray(ys, np.int32)
        self.num_classes = 10
        self.image_size = 32

    def __len__(self) -> int:
        return len(self.images)

    def get_batch(self, indices: np.ndarray):
        return self.images[indices], self.labels[indices], full_extents(len(indices), 32, 32)


def write_cifar10_tree(root: str, per_batch: int = 512, test_size: int = 512,
                       seed: int = 0) -> str:
    """Write a `cifar-10-batches-py` tree under `root` in the dataset's own
    pickle layout (5 train batches of `per_batch` images and a test batch,
    uint8 `[N, 3072]` channel-major rows, labels 0-9, `batches.meta`),
    drawn from `seed` with numpy: each class a fixed low-frequency color
    pattern, each image half that pattern and half one of its own, plus
    noise (so that instances differ past the augmentation, as photographs
    do). Returns the tree's path."""
    rng = np.random.RandomState(seed)

    def pattern(n: int) -> np.ndarray:
        return rng.rand(n, 3, 4, 4).repeat(8, axis=2).repeat(8, axis=3)

    protos = pattern(10)
    out = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(out, exist_ok=True)

    def batch(name: str, n: int) -> None:
        labels = rng.randint(0, 10, size=n)
        imgs = 0.5 * (protos[labels] + pattern(n)) + 0.1 * rng.randn(n, 3, 32, 32)
        data = (np.clip(imgs, 0, 1) * 255).astype(np.uint8).reshape(n, 3072)
        with open(os.path.join(out, name), "wb") as f:
            pickle.dump({b"batch_label": name.encode(), b"labels": labels.tolist(),
                         b"data": data,
                         b"filenames": [f"{name}_{i}.png".encode() for i in range(n)]},
                        f, protocol=2)

    for i in range(1, 6):
        batch(f"data_batch_{i}", per_batch)
    batch("test_batch", test_size)
    names = [b"airplane", b"automobile", b"bird", b"cat", b"deer", b"dog", b"frog",
             b"horse", b"ship", b"truck"]
    with open(os.path.join(out, "batches.meta"), "wb") as f:
        pickle.dump({b"label_names": names, b"num_cases_per_batch": per_batch,
                     b"num_vis": 3072}, f, protocol=2)
    return out


@dataclass
class _ImageEntry:
    path: str
    label: int


class ImageFolder:
    """Class-per-subdir image tree; decodes the WHOLE image into a fixed
    `[stage_size, 2 * stage_size]` landscape uint8 canvas on the host
    (transpose-if-portrait, bilinear fit-downscale, edge-replicated
    padding), with a per-image `(valid_h, valid_w, rot)` extent. The
    on-device RandomResizedCrop then samples over the true image area.

    `backend`: "native" decodes JPEG trees with the C++ stager and raises if
    it cannot be built; "pil" decodes with PIL; "auto" takes the native
    stager for a JPEG tree where it builds, else PIL, and prints one line
    naming the decoder it took. A native batch with a failed image is
    decoded again by PIL, which reads some streams libjpeg rejects and
    names the bad file."""

    def __init__(self, root: str, stage_size: int = 512, num_workers: int = 8,
                 backend: str = "auto"):
        from PIL import Image  # lazy: only an image tree needs PIL

        if backend not in ("auto", "native", "pil"):
            raise ValueError(f"unknown backend {backend!r}; choose auto, native or pil")
        self._Image = Image
        self.stage_size = stage_size
        self.stage_h = stage_size
        self.stage_w = stage_size * 2  # aspect <= 2:1 keeps the shorter side at full res
        self.image_size = stage_size
        self._native = None
        # cumulative decode meters, read by the training loop every step:
        # failures substitute zero canvases, and the loop aborts past
        # config.decode_abort_rate. Locked: staging workers decode disjoint
        # sub-slices of one batch at once.
        self.decode_failures = 0
        self.decode_total = 0
        self._meter_lock = threading.Lock()
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise FileNotFoundError(f"no class subdirectories under {root!r}")
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.num_classes = len(classes)
        self.entries: list[_ImageEntry] = []
        exts = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if os.path.splitext(fname)[1].lower() in exts:
                    self.entries.append(_ImageEntry(os.path.join(cdir, fname),
                                                    self.class_to_idx[c]))
        self.labels = np.asarray([e.label for e in self.entries], np.int32)
        self._pool = ThreadPoolExecutor(max_workers=num_workers)
        has_jpeg = any(e.path.lower().endswith((".jpg", ".jpeg")) for e in self.entries)
        if backend == "native" and not has_jpeg:
            raise RuntimeError("backend='native' requires JPEG images")
        if backend != "pil" and has_jpeg:
            from moco_tpu_torch.data.native_loader import NativeBuildError, \
                NativeStagingLoader

            try:
                self._native = NativeStagingLoader(self.stage_h, self.stage_w, num_workers)
            except NativeBuildError as e:
                if backend == "native":
                    raise
                print(f"ImageFolder: decoding with PIL (native stager unavailable: "
                      f"{str(e).splitlines()[0]})", flush=True)
            else:
                if backend == "auto":
                    print(f"ImageFolder: decoding with the native stager "
                          f"({self._native.path.name})", flush=True)
        elif backend == "auto":
            print("ImageFolder: decoding with PIL (no JPEG files)", flush=True)

    def __len__(self) -> int:
        return len(self.entries)

    def _load_one(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        img = self._Image.open(self.entries[idx].path).convert("RGB")
        arr = np.asarray(img, np.uint8)
        rot = 0
        if arr.shape[0] > arr.shape[1]:  # portrait: stage transposed
            arr = np.ascontiguousarray(np.swapaxes(arr, 0, 1))
            rot = 1
        h, w = arr.shape[:2]
        # fit-DOWNSCALE only (scale capped at 1, as the native path does): an
        # image that fits stages at its original resolution
        scale = min(1.0, self.stage_h / h, self.stage_w / w)
        # int(x + 0.5), not round(): Python rounds half to even, the native
        # path uses lround (half away from zero); sizes must agree exactly
        nh = min(max(1, int(h * scale + 0.5)), self.stage_h)
        nw = min(max(1, int(w * scale + 0.5)), self.stage_w)
        if (nh, nw) == (h, w):
            resized = arr
        else:
            resized = np.asarray(
                self._Image.fromarray(arr).resize((nw, nh), self._Image.BILINEAR), np.uint8)
        canvas = np.empty((self.stage_h, self.stage_w, 3), np.uint8)
        canvas[:nh, :nw] = resized
        # edge-replicated padding: crop taps at the content boundary read
        # clamped pixels, never black
        canvas[:nh, nw:] = resized[:, -1:]
        canvas[nh:, :] = canvas[nh - 1:nh, :]
        return canvas, np.asarray([nh, nw, rot], np.int32)

    def _load_one_tolerant(self, idx: int):
        """`_load_one`, with a per-image decode failure turned into a zero
        canvas and a counted failure: one corrupt file must not end a run;
        `train.py`'s `decode_abort_rate` check catches the systemic case."""
        try:
            canvas, extent = self._load_one(idx)
            return canvas, extent, 0
        except (OSError, ValueError) as e:
            print(f"[data] decode failed for {self.entries[idx].path!r} "
                  f"({type(e).__name__}: {e}); substituting a zero canvas",
                  file=sys.stderr, flush=True)
            canvas = np.zeros((self.stage_h, self.stage_w, 3), np.uint8)
            extent = np.asarray([self.stage_h, self.stage_w, 0], np.int32)
            return canvas, extent, 1

    def get_batch(self, indices: np.ndarray):
        out = np.empty((len(indices), self.stage_h, self.stage_w, 3), np.uint8)
        extents = np.empty((len(indices), 3), np.int32)
        labels = self.get_batch_into(indices, out, extents)
        return out, labels, extents

    def get_batch_into(self, indices, out_imgs: np.ndarray,
                       out_extents: np.ndarray) -> np.ndarray:
        """Decode `indices` INTO caller-owned rows and return the labels.
        `out_imgs` is `[n, stage_h, stage_w, 3] uint8` and `out_extents`
        `[n, 3] int32`, typically disjoint row ranges of a pooled staging
        canvas, so the native decode threads write the final bytes in place.
        Thread-safe: concurrent calls for disjoint rows share the pool and
        the decode meters."""
        idx = [int(i) for i in indices]
        paths = [self.entries[i].path for i in idx]
        with self._meter_lock:
            self.decode_total += len(idx)
        if self._native is not None and all(p.lower().endswith((".jpg", ".jpeg"))
                                            for p in paths):
            _, _, failures = self._native.load_batch(paths, out=out_imgs, extents=out_extents)
            if failures == 0:
                return self.labels[np.asarray(idx)]
        staged = list(self._pool.map(self._load_one_tolerant, idx))
        failed = sum(s[2] for s in staged)
        if failed:
            with self._meter_lock:
                self.decode_failures += failed
        for j, s in enumerate(staged):
            out_imgs[j] = s[0]
            out_extents[j] = s[1]
        return self.labels[np.asarray(idx)]


def build_dataset(name: str, data_dir: str = "", image_size: int = 32, stage_size: int = 0,
                  num_workers: int = 0, **kw):
    """The dataset a config names. `stage_size`/`num_workers` are the
    ImageFolder staging knobs (0 = the class default); the in-memory
    datasets have no staging and ignore both."""
    if name == "synthetic":
        return SyntheticDataset(image_size=image_size, **kw)
    if name == "synthetic_texture":
        return SyntheticTextureDataset(image_size=image_size, **kw)
    if name == "cifar10":
        return CIFAR10(data_dir, **kw)
    if name == "imagefolder":
        sub = os.path.join(data_dir, "train")
        root = sub if os.path.isdir(sub) else data_dir
        if stage_size:
            kw["stage_size"] = stage_size
        if num_workers:
            kw["num_workers"] = num_workers
        return ImageFolder(root, **kw)
    raise ValueError(f"unknown dataset {name!r}")
