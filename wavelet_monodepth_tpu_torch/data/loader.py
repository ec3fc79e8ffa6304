"""Parallel host batch loading and the host-to-device copy.

Counterpart of `wavelet_monodepth_tpu/data/loader.py` (the reference's
`DataLoader(num_workers=12)`, `KITTI/trainer.py:128-139`): a thread pool
runs `dataset.item` (PIL decode, Lanczos resize and jitter release the
GIL) and a background thread collates batches into a bounded queue, so
loading batch N+k overlaps the card's work on batch N.

Determinism: augmentation draws are keyed per (seed, epoch, item index)
through `dataset.item(index, rng: random.Random)`, so the worker count
and completion order cannot change the stream. Closing the generator (or
letting it be collected) stops the loading thread.

`to_device` replaces the JAX package's `data/prefetch.py`: each batch is
copied from pinned host memory with non_blocking copies on the card's
current stream. The JAX package's `stack_batches` (the `lax.scan` K-step
feed) has no counterpart: `--steps_per_call` is a plain loop here.
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch


def _collate(items: list) -> dict:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def _load_item(dataset, index: int, seed: int, epoch: int):
    # str seeds hash stably (sha512) across processes/versions
    rng = random.Random(f"{seed}/{epoch}/{int(index)}")
    return dataset.item(int(index), rng)


def parallel_batches(dataset, batch_size: int, num_workers: int = 4,
                     shuffle: bool = True, drop_last: bool = True,
                     seed: int = 0, epochs: Optional[int] = None,
                     prefetch_batches: int = 2) -> Iterator[dict]:
    """Yield collated NHWC batches, loading items with `num_workers`
    threads and keeping up to `prefetch_batches` ready batches ahead of
    the consumer. num_workers=0 degrades to synchronous loading (same
    batches: the item order and per-item RNG keys are identical)."""
    if drop_last and len(dataset) < batch_size:
        # an epoch would yield ZERO batches and the epochs=None stream
        # would spin forever producing nothing (a too-small val split
        # used to hang the train CLIs here)
        raise ValueError(
            f"dataset has {len(dataset)} items < batch_size={batch_size} "
            f"with drop_last: no batch can ever be yielded")
    order = np.arange(len(dataset))
    rng = np.random.RandomState(seed)

    def index_stream():
        # epochs=None repeats indefinitely (training/val streams); pass
        # epochs=1 for a single deterministic pass (eval loops)
        epoch = 0
        while epochs is None or epoch < epochs:
            if shuffle:
                rng.shuffle(order)
            for start in range(0, len(order), batch_size):
                idx = order[start:start + batch_size]
                if len(idx) < batch_size and drop_last:
                    continue
                yield epoch, idx.copy()
            epoch += 1

    if num_workers <= 0:
        for epoch, idx in index_stream():
            yield _collate([_load_item(dataset, i, seed, epoch)
                            for i in idx])
        return

    q: queue.Queue = queue.Queue(maxsize=max(1, prefetch_batches))
    stop = object()
    closed = threading.Event()
    err: list = []

    def put(item) -> bool:
        while not closed.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            with ThreadPoolExecutor(max_workers=num_workers) as pool:
                for epoch, idx in index_stream():
                    items = list(pool.map(
                        lambda i: _load_item(dataset, i, seed, epoch),
                        idx))
                    if not put(_collate(items)):
                        return
        except BaseException as e:          # surface in the consumer
            err.append(e)
        finally:
            put(stop)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        # the consumer closed the stream (or it ended): let the producer
        # finish its batch and exit instead of blocking on a full queue
        closed.set()
        t.join(timeout=60)


def to_device(batches: Iterator[dict], device) -> Iterator[dict]:
    """Yield each numpy batch as torch tensors on `device`. On a CUDA
    device the arrays are pinned and copied with non_blocking=True, so the
    copy of the next batch can overlap the card's work; the copies run on
    the current stream, which orders them before the step that reads
    them."""
    device = torch.device(device)
    for batch in batches:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            else:
                t = t.to(device)
            out[k] = t
        yield out
