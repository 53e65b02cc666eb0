"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
         -c csrc/<name>.cu -o build/torch_kernels/<hash>/<name>.o      (one per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o .../libmdie_kernels.so *.o

The library is built at first use into ``build/torch_kernels/`` at the repo
root (listed in ``.gitignore``), keyed by a hash of the sources and flags, so a
fresh checkout builds it on its own and a changed source never loads a stale
library.  There is no fallback: a missing ``nvcc`` or a failed build raises.
Nothing here runs at import time.
"""

from __future__ import annotations

import functools
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=out.parent))
    t0 = time.perf_counter()
    jobs = []
    try:
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = work / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src), "-o", str(obj)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for cmd, _, proc in jobs:
            log = proc.communicate()[0]
            logs.append(log)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = work / LIB_NAME
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{logs[-1]}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        for _, _, proc in jobs:  # none left running if anything above raised
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    return out, time.perf_counter() - t0, "".join(logs)


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
        "mdie_db_entry": [p, i, i, i, i, i, i, i, p, i, p],
        "mdie_db_growth": [p, i, i, i, i, i, i, p, p, p, p, i, i, p],
        "mdie_db_transition": [p, i, i, i, i, i, p, p, p, p, i, i, p, i, i, i, p],
        # growth_train.cu
        "mdie_growth_fwd": [p, i, i, i, i, p, p, p, p, p, p],
        "mdie_growth_bwd": [p, p, i, i, i, i, p, p, p, p, p, p, p, p, p],
        "mdie_growth_bwd_scratch": [i, i, i, i],  # returns a float count
        # conv_cm.cu
        "mdie_conv3x3": [p, i, i, i, i, i, p, p, i, i, p, i, i, p, p],
        "mdie_conv3x3_pool": [p, i, i, i, i, i, p, i, i, p, i, p, i, p],
        # probe_matmul.cu
        "mdie_probe_matmul": [p, p, i, i, i, i, i, p, p, p],
        # probe_transpose.cu
        "mdie_probe_transpose": [p, i, i, i, p, p],
        "mdie_probe_rhsT": [p, p, i, i, p, p],
        "mdie_probe_lhsT": [p, p, i, i, p, p],
        # upsample.cu
        "mdie_bilinear_x2_add": [p, p, p, i, i, i64, i, i, p],
        # cbam.cu
        "mdie_cbam_cm": [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, p],
        # dwconv.cu
        "mdie_dwconv3x3": [p, p, p, p, i, i, i, i64, i, i, i, i, p],
    }
    restypes = {"mdie_growth_bwd_scratch": i64}
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restypes.get(name, ctypes.c_int)
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


def on_device(t):
    """The context a launch runs in: ``t``'s card made current, so a kernel of
    a process that drives several cards (or a rank on ``cuda:1`` and up)
    launches where its tensors are, on that card's current stream."""
    import torch

    return torch.cuda.device(t.device)


@functools.lru_cache(maxsize=16)
def sm_count(index: int) -> int:
    """The SMs of CUDA card ``index`` (132 on an H100), which the kernels'
    plans size their grids by."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_of(t) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
