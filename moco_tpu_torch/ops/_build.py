"""Build and load the port's CUDA kernels (`moco_tpu_torch/csrc/*.cu`).

Each source is compiled by `nvcc` for `sm_90a` into an object file, all of
them at once, and the objects are linked into one shared library with a
plain C interface, loaded with `ctypes`. The library lands in
`moco_tpu_torch/_build/` under a name that carries a hash of the sources
and flags, so an edited source builds anew and an unchanged one is built
once. Nothing here runs at import: the first kernel launch calls
`load_library()`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("channel_stats.cu", "blur.cu", "fused_conv.cu", "fused_conv_dw.cu", "conv3x3_dw.cu",
           "conv3x3_fwd.cu", "matmul_fwd.cu", "matmul_dw.cu")
HEADERS = ("implicit_gemm.cuh", "band_mma.cuh")  # included by the sources; hashed with them
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# C entry points and their argument types (every pointer and the stream as
# c_void_p, or ctypes would pass them as 32-bit ints)
SIGNATURES = {
    "moco_channel_sums": (_P, _I, _L, _I, _I, _I, _I, _I, _L, _P, _P, _P),
    "moco_channel_grad_sums": (_P, _P, _I, _P, _P, _L, _I, _I, _I, _I, _I, _L, _P, _P, _P),
    "moco_gaussian_blur": (_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "moco_bn_relu_matmul": (_P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _P),
    "moco_bn_relu_conv3x3_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "moco_bn_relu_conv3x3_s2_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "moco_conv3x3_fwd_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                              _P),
    "moco_matmul_fwd_bf16": (_P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _I, _P),
    "moco_bn_relu_matmul_dw": (_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _P),
    "moco_matmul_dw_bf16": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P),
    "moco_conv3x3_dw_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "moco_conv3x3_dw_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "moco_error_string": (_I,),
}
RESTYPES = {"moco_error_string": ctypes.c_char_p}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def find_nvcc() -> str:
    """`nvcc` from PATH, else from the CUDA toolkit's usual homes."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise KernelBuildError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's "
        "kernels are built from moco_tpu_torch/csrc at first use"
    )


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update(name.encode())
        digest.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libmoco_kernels_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the sources (one `nvcc` each, all started together) and link
    them. Returns (library path, compiler output); a library that already
    exists for these sources is reused with no compile."""
    target = library_path()
    if target.is_file():
        return target, ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            objs.append(str(obj))
        logs, failed = [], []
        for name, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"--- nvcc {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise KernelBuildError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_so = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        logs.append(f"--- link\n{link.stdout}")
        if link.returncode != 0:
            raise KernelBuildError("linking the kernels failed:\n" + "\n".join(logs))
        os.replace(tmp_so, target)  # atomic: a reader never sees half a file
    return target, "\n".join(logs)


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built kernel library with every entry point's types declared."""
    path, _log = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (its return value is
    `cudaGetLastError()` after the launch)."""
    if err != 0:
        text = load_library().moco_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({text}) at launch")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
