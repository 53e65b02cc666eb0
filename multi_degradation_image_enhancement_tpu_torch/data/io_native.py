"""ctypes bindings of the native host-IO engine (``csrc/host_io.cpp``).

Counterpart of ``multi_degradation_image_enhancement_tpu/data/io_native.py``,
with its API and contracts: :func:`available`, :func:`decode_image`,
:func:`decode_batch` (failed slots zero-filled), :func:`encode_png`,
:func:`encode_png_batch`, the ``MODE_*`` constants, and ``MDIE_NATIVE_IO=0``
to force every caller onto PIL.  The engine decodes JPEG and PNG with libjpeg
and libpng and resizes with a bilinear of half-pixel centres and no
antialias, straight into the caller's batch buffer; the same arithmetic as
the JAX package's engine, so both give the same pixels (PIL's ``BILINEAR``
antialiases when it shrinks, and does not).

The library is host code, built with the system's C++ compiler (``$CXX``,
default ``g++``) at first use, never at import, into
``build/host_io/<hash of source and flags>/`` at the repo root (listed in
``.gitignore``).  The build runs under a lock file and writes a temporary
name that ``os.replace`` moves into place, so several processes building at
once each load a whole library.  Where the compiler, ``jpeglib.h``,
``png.h`` or the libraries are missing, :func:`available` is false, as in
the JAX package, and :func:`build_error` says why.

:func:`resize_bilinear_np` and :func:`letterbox_np` are the plain NumPy
versions of the engine's resize and letterbox, float32 step for step: the
tests and ``chip_smoke.py`` hold the engine to them bit for bit.
``decode_calls`` and ``encode_calls`` count the engine's calls (a batch is
one call), ``decode_failures`` the images a batch call could not decode.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = _PKG_DIR / "csrc" / "host_io.cpp"
BUILD_ROOT = _PKG_DIR.parent / "build" / "host_io"
LIB_NAME = "libmdie_host_io.so"
# The JAX package's native/Makefile flags, so both engines compile the same
# arithmetic (no -march: no fused multiply-add on x86-64).
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LDLIBS = ("-ljpeg", "-lpng", "-lz", "-lpthread")

MODE_EXACT = 0
MODE_RESIZE = 1
MODE_LETTERBOX = 2
LETTERBOX_PAD = 128

decode_calls = 0
encode_calls = 0
decode_failures = 0

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> Path:
    h = hashlib.sha256(" ".join((_compiler(), *CXXFLAGS, *LDLIBS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile ``csrc/host_io.cpp`` unless the library for this source and
    these flags exists; raises with the compiler's output on failure."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one builder at a time; the others wait, then load
        try:
            if out.is_file():
                return out
            tmp = out.parent / f".{LIB_NAME}.{os.getpid()}.tmp"
            cmd = [_compiler(), *CXXFLAGS, "-o", str(tmp), str(SOURCE), *LDLIBS]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)  # atomic: no process ever opens half a library
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    p, u8p, i, strs = (ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                       ctypes.POINTER(ctypes.c_char_p))
    signatures = {
        "mdie_decode_image": [p, u8p, i, i, i],
        "mdie_decode_batch": [strs, i, u8p, i, i, i, i],
        "mdie_encode_png": [p, u8p, i, i, i],
        "mdie_encode_png_batch": [strs, u8p, i, i, i, i, i],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


def _load() -> Optional[ctypes.CDLL]:
    """The engine, built and loaded once; None when it cannot be (the
    reason in :func:`build_error`) or ``MDIE_NATIVE_IO=0``."""
    global _lib, _error
    if os.environ.get("MDIE_NATIVE_IO", "1") == "0":
        return None
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(str(build()))
                _declare(lib)
                _lib = lib
            except Exception as exc:  # no compiler, headers or libraries: PIL takes over
                _error = f"{type(exc).__name__}: {exc}"
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the engine could not be built or loaded in this process, or None."""
    _load()
    return _error


def _count(name: str) -> None:
    with _lock:
        globals()[name] += 1


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _paths(paths: List[str]):
    return (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])


def decode_image(path: str, target_h: int, target_w: int,
                 mode: int = MODE_RESIZE) -> Optional[np.ndarray]:
    """Decode one image to uint8 RGB ``[target_h, target_w, 3]``; None when
    the engine is unavailable or the file does not decode (or, in
    ``MODE_EXACT``, has another size)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((target_h, target_w, 3), np.uint8)
    rc = lib.mdie_decode_image(os.fsencode(path), _u8p(out), target_h, target_w, mode)
    _count("decode_calls")
    return out if rc == 0 else None


def decode_batch(paths: List[str], target_h: int, target_w: int, mode: int = MODE_RESIZE,
                 n_threads: int = 4) -> Optional[np.ndarray]:
    """Decode a batch into one ``[N, target_h, target_w, 3]`` uint8 buffer
    on ``n_threads`` threads; None when the engine is unavailable.  A file
    that does not decode leaves its slot zero and adds one to
    ``decode_failures``."""
    global decode_failures
    lib = _load()
    if lib is None:
        return None
    out = np.empty((len(paths), target_h, target_w, 3), np.uint8)
    failed = lib.mdie_decode_batch(_paths(paths), len(paths), _u8p(out), target_h, target_w,
                                   mode, n_threads)
    _count("decode_calls")
    with _lock:
        decode_failures += failed
    return out


def encode_png(path: str, img_u8: np.ndarray, compress_level: int = 1) -> bool:
    """Write one RGB uint8 ``[H, W, 3]`` image as PNG with libpng; False when
    the engine is unavailable or the write failed (callers then use PIL)."""
    lib = _load()
    if lib is None:
        return False
    img_u8 = np.ascontiguousarray(img_u8, dtype=np.uint8)
    h, w, c = img_u8.shape
    if c != 3:
        return False
    rc = lib.mdie_encode_png(os.fsencode(path), _u8p(img_u8), h, w, compress_level)
    _count("encode_calls")
    return rc == 0


def encode_png_batch(paths: List[str], imgs_u8: np.ndarray, compress_level: int = 1,
                     n_threads: int = 4) -> Optional[int]:
    """Write a ``[N, H, W, 3]`` uint8 batch to one PNG a path on
    ``n_threads`` threads; the number of failed writes, or None when the
    engine is unavailable or the shapes do not fit."""
    lib = _load()
    if lib is None:
        return None
    imgs_u8 = np.ascontiguousarray(imgs_u8, dtype=np.uint8)
    n, h, w, c = imgs_u8.shape
    if c != 3 or n != len(paths):
        return None
    failed = lib.mdie_encode_png_batch(_paths(paths), _u8p(imgs_u8), n, h, w, compress_level,
                                       n_threads)
    _count("encode_calls")
    return int(failed)


# ------------------------------------------------------------ plain versions


def resize_bilinear_np(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """The engine's ``resize_bilinear`` in NumPy: half-pixel centres clamped
    to the edge, no antialias, a horizontal then a vertical lerp in float32
    (each product and sum rounded, as the C++ computes them), rounded half
    up to uint8.  ``src`` uint8 ``[h, w, 3]`` → ``[dh, dw, 3]``."""
    h, w = src.shape[:2]
    f32 = np.float32

    def taps(n_src: int, n_dst: int):
        scale = f32(n_src) / f32(n_dst)
        pos = (np.arange(n_dst, dtype=f32) + f32(0.5)) * scale - f32(0.5)
        pos = np.minimum(np.maximum(pos, f32(0)), f32(n_src - 1))
        i0 = pos.astype(np.int64)  # pos >= 0: truncation is floor
        return i0, np.minimum(i0 + 1, n_src - 1), pos - i0.astype(f32)

    x0, x1, tx = taps(w, dw)
    y0, y1, ty = taps(h, dh)
    s = src.astype(np.int32)
    # horizontal: p0 + t·(p1 − p0), the integer difference converted exactly
    rows = s[:, x0].astype(f32) + tx[None, :, None] * (s[:, x1] - s[:, x0]).astype(f32)
    a, b = rows[y0], rows[y1]
    v = a + ty[:, None, None] * (b - a)
    return np.clip((v + f32(0.5)).astype(np.int32), 0, 255).astype(np.uint8)


def letterbox_np(src: np.ndarray, dh: int, dw: int, pad: int = LETTERBOX_PAD) -> np.ndarray:
    """The engine's ``letterbox``: the aspect-preserving resize of
    :func:`resize_bilinear_np`, centred on a ``pad`` grey canvas."""
    h, w = src.shape[:2]
    f32 = np.float32
    scale = min(f32(dw) / f32(w), f32(dh) / f32(h))
    nw = max(1, int(f32(w) * scale + f32(0.5)))
    nh = max(1, int(f32(h) * scale + f32(0.5)))
    out = np.full((dh, dw, 3), pad, np.uint8)
    y0, x0 = (dh - nh) // 2, (dw - nw) // 2
    out[y0:y0 + nh, x0:x0 + nw] = resize_bilinear_np(src, nh, nw)
    return out
