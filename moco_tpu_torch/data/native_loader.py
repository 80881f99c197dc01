"""ctypes binding of the native JPEG stager (port of
`moco_tpu/data/native_loader.py`).

`native/staging_loader.cc` (repo-level C++, shared with the JAX package) is
a thread pool that turns JPEG files into fixed-size uint8 staging canvases:
decode, transpose if portrait, bilinear fit-downscale of the whole image
and edge-replicated padding, with a per-image `(valid_h, valid_w, rot)`
extent. The port compiles it with `g++ -O3 ... -ljpeg` at first use into
`moco_tpu_torch/_build/`, under a name that carries a hash of the source
and flags; a build that cannot run raises `NativeBuildError`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR.parent / "native" / "staging_loader.cc"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
LIBS = ("-ljpeg", "-lpthread")
_build_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """g++, libjpeg or the stager's source is missing, or the compile failed."""


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libstaging_loader_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the stager if this source has no library yet; returns its
    path. The library is written under a temporary name and renamed, so a
    concurrent reader never sees half a file."""
    with _build_lock:
        if not SOURCE.is_file():
            raise NativeBuildError(f"the stager's source {SOURCE} is missing")
        target = library_path()
        if target.is_file():
            return target
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise NativeBuildError("no C++ compiler (g++ or $CXX) on PATH")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            tmp_so = Path(tmp) / target.name
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp_so), str(SOURCE), *LIBS],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise NativeBuildError(f"compiling {SOURCE.name} failed (libjpeg and its "
                                       f"jpeglib.h are needed):\n{proc.stdout}")
            os.replace(tmp_so, target)
        return target


class NativeStagingLoader:
    """Threaded JPEG -> staging-canvas batch loader. Raises `NativeBuildError`
    if the library cannot be built."""

    def __init__(self, stage_h: int, stage_w: int, num_threads: int | None = None):
        self.path = build()
        self._lib = ctypes.CDLL(str(self.path))
        self._lib.sl_create.restype = ctypes.c_void_p
        self._lib.sl_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        self._lib.sl_load_batch.restype = ctypes.c_int
        self._lib.sl_load_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)]
        self._lib.sl_destroy.restype = None
        self._lib.sl_destroy.argtypes = [ctypes.c_void_p]
        self._lib.sl_version.restype = ctypes.c_int
        self._lib.sl_version.argtypes = []
        self.version = int(self._lib.sl_version())
        self.num_threads = num_threads or max(os.cpu_count() or 1, 1)
        self.stage_h = stage_h
        self.stage_w = stage_w
        # cumulative decode meters; locked, since staging workers call
        # load_batch concurrently for disjoint sub-slices of one batch
        self.total_images = 0
        self.total_failures = 0
        self._meter_lock = threading.Lock()
        self._handle = self._lib.sl_create(self.num_threads, stage_h, stage_w)
        if not self._handle:
            raise RuntimeError("sl_create failed")

    def load_batch(self, paths: list[str], out: np.ndarray | None = None,
                   extents: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray, int]:
        """Decode `paths` in parallel -> (`[n, H, W, 3] uint8`, `[n, 3] int32
        (h, w, rot)`, failures). A failed image comes back as a zero canvas
        with the full-canvas extent. `out`/`extents` let the caller own the
        destination (C-contiguous, exactly these shapes); omitted, fresh
        arrays are allocated."""
        n = len(paths)
        if out is None:
            out = np.empty((n, self.stage_h, self.stage_w, 3), dtype=np.uint8)
        if extents is None:
            extents = np.empty((n, 3), dtype=np.int32)
        if out.shape != (n, self.stage_h, self.stage_w, 3) or out.dtype != np.uint8:
            raise ValueError(f"out must be uint8 [{n}, {self.stage_h}, {self.stage_w}, 3], "
                             f"got {out.dtype} {out.shape}")
        if extents.shape != (n, 3) or extents.dtype != np.int32:
            raise ValueError(f"extents must be int32 [{n}, 3], got {extents.dtype} "
                             f"{extents.shape}")
        if not out.flags.c_contiguous or not extents.flags.c_contiguous:
            raise ValueError("out/extents must be C-contiguous")
        arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        failures = int(self._lib.sl_load_batch(
            self._handle, arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            extents.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))))
        with self._meter_lock:
            self.total_images += n
            self.total_failures += failures
        if failures:
            print(f"[data] native decode: {failures}/{n} failure(s) in batch (cumulative "
                  f"{self.total_failures}/{self.total_images})", file=sys.stderr, flush=True)
        return out, extents, failures

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.sl_destroy(handle)
            self._handle = None
