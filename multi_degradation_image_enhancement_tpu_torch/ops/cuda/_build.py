"""Build and load the port's CUDA kernels (``csrc/*.cu``).

All kernels are compiled by one ``nvcc`` call into a shared library with a
plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/torch_kernels/<hash>/libmdie_kernels.so csrc/*.cu

The library is built at first use into ``build/torch_kernels/`` at the repo
root (listed in ``.gitignore``), keyed by a hash of the sources and flags, so a
fresh checkout builds it on its own and a changed source never loads a stale
library.  There is no fallback: a missing ``nvcc`` or a failed build raises.
Nothing here runs at import time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Tuple

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_ROOT = _PKG_DIR.parent / "build" / "torch_kernels"
LIB_NAME = "libmdie_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _source_hash() / LIB_NAME


def build() -> Tuple[Path, float, str]:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.

    Returns ``(library path, nvcc seconds, nvcc output)``; the output holds
    ptxas's register / shared-memory report.  A cached library gives
    ``(path, 0.0, "")``."""
    out = library_path()
    if out.is_file():
        return out, 0.0, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in sorted(CSRC_DIR.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", tmp, *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out, seconds, log


def load():
    """The loaded kernel library (``ctypes.CDLL``), built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            import ctypes

            lib = ctypes.CDLL(str(build()[0]))
            _declare(lib, ctypes)
            _lib = lib
        return _lib


def _declare(lib, ctypes) -> None:
    p, i, i64, u32, f = (
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32, ctypes.c_float,
    )
    signatures = {
        # noise.cu
        "mdie_noise_degrade": [p, p, p, i, i, i64, u32, f, p],
        "mdie_philox_bits": [p, p, i, i64, u32, p],
        # dense_block.cu
        "mdie_growth_layer": [p, i, i, i, i, i, p, p, p, p, i, p],
        "mdie_transition": [p, i, i, i, p, p, p, p, i, p, i, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mdie_error_string.argtypes = [i]
    lib.mdie_error_string.restype = ctypes.c_char_p


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = load().mdie_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {msg}")


def require(t, name: str, dtype, shape=None) -> None:
    """Validate a tensor handed to a kernel: CUDA, dtype, shape, contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


# CUDA's limit on gridDim.y and gridDim.z; the kernels put the batch there.
MAX_GRID_YZ = 65535


def require_batch(batch: int, name: str) -> None:
    if not 0 < batch <= MAX_GRID_YZ:
        raise ValueError(f"{name}: batch {batch} outside 1..{MAX_GRID_YZ}")


def stream_of(t) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
