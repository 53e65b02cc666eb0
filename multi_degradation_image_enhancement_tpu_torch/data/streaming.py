"""Streaming serving IO: decode-ahead producer + PNG writer pool (counterpart
of ``multi_degradation_image_enhancement_tpu/data/streaming.py``).

The three stages overlap as in the JAX package: a producer thread decodes
batch i+1 (the native engine on its own threads, ``data.io_native``; PIL
where it is unavailable) while batch i runs on the device, restored images
go to a pool of writer threads (libpng through the engine, else PIL), and a
bounded feed (two batches) keeps host memory flat.  :func:`stream_restore`
is compute-agnostic: it takes any ``run_batch(u8_batch) -> (restored u8,
aux or None)``.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from multi_degradation_image_enhancement_tpu_torch.data import io_native
from multi_degradation_image_enhancement_tpu_torch.data.dataset import _load_rgb


def decode_chunk(paths: Sequence[str], hw: Tuple[int, int], io_threads: int = 4) -> np.ndarray:
    """Decode files to one [N, H, W, 3] u8 batch: one engine call on
    ``io_threads`` threads, or PIL image by image without the engine."""
    batch = io_native.decode_batch(list(paths), hw[0], hw[1], n_threads=io_threads)
    if batch is not None:
        return batch
    return np.stack([_load_rgb(p, hw) for p in paths])


def stream_restore(
    files: Sequence[str],
    images_dir: str,
    out_dir: str,
    *,
    hw: Tuple[int, int],
    batch: int,
    run_batch: Callable[[np.ndarray], Tuple[np.ndarray, Optional[np.ndarray]]],
    io_threads: int = 4,
    progress: Optional[Callable[[int, int], None]] = None,
    write: bool = True,
) -> List[Tuple[str, Optional[np.ndarray]]]:
    """Run ``run_batch`` over a directory with overlapped decode and write.

    ``run_batch(u8 [N,H,W,3]) -> (restored u8 [N,H,W,3], aux or None)``;
    restored frames are written as ``<stem>.png`` under ``out_dir`` by
    ``io_threads`` writers.  Returns ``[(filename, aux_row), ...]`` in input
    order.  A decode error reaches the caller (it is raised here) instead of
    leaving the loop waiting; the first writer failure is raised after the
    loop drains.  ``write=False`` runs every batch and writes nothing (an
    expert-parallel rank other than the primary).
    """
    if write:
        os.makedirs(out_dir, exist_ok=True)
    feed: "queue.Queue" = queue.Queue(maxsize=2)

    def producer() -> None:
        # The sentinel goes in from ``finally``: without it a decode failure
        # would leave the consumer blocked on ``feed.get()`` for ever.
        error: Optional[BaseException] = None
        try:
            for i in range(0, len(files), batch):
                chunk = files[i : i + batch]
                paths = [os.path.join(images_dir, f) for f in chunk]
                feed.put((chunk, decode_chunk(paths, hw, io_threads)))
        except BaseException as exc:  # re-raised in the consumer loop
            error = exc
        finally:
            feed.put(error)

    threading.Thread(target=producer, daemon=True).start()

    def save_png(img_u8: np.ndarray, path: str) -> None:
        # libpng through the engine (compress level 1), else PIL: the same
        # pixels either way (lossless).
        if not io_native.encode_png(path, img_u8):
            Image.fromarray(img_u8).save(path)

    results: List[Tuple[str, Optional[np.ndarray]]] = []
    done = 0
    with ThreadPoolExecutor(max_workers=io_threads) as writers:
        pending = []
        while True:
            item = feed.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            chunk, imgs = item
            restored, aux = run_batch(imgs)
            for j, fname in enumerate(chunk):
                stem = os.path.splitext(fname)[0]
                if write:
                    pending.append(writers.submit(save_png, restored[j],
                                                  os.path.join(out_dir, f"{stem}.png")))
                results.append((fname, aux[j] if aux is not None else None))
            done += len(chunk)
            if progress is not None:
                progress(done, len(files))
        for fut in pending:
            fut.result()
    return results
