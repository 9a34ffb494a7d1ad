"""Dataset pipeline for one process — the port of
``deeplearning_cfn_tpu/data/pipeline.py`` as far as the NMT training slice
needs it.

- :class:`ArraySource`: an in-memory dict of equal-length numpy arrays.
- :class:`DataPipeline`: shuffles with the JAX package's per-epoch
  ``RandomState(seed + epoch)`` permutation, batches with the Python gather,
  pads the eval tail with an ``eval_mask`` (``drop_remainder=False``), and
  prefetches host batches on a thread. One process only: the port has no
  multi-host sharding yet (ROADMAP A.10), and the C++ ``dataio`` gather
  belongs to the JAX package. Given the same source, seed and batch size it
  yields exactly the JAX pipeline's batches.
- :class:`DevicePrefetcher`: stages ``depth`` batches to the card ahead of
  the step loop, from pinned host memory with non-blocking copies on a side
  stream, so the host→device transfer overlaps the previous step's compute.
- :func:`build_pipeline`: ``wmt_en_de`` only; the other datasets raise
  ``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Union

import numpy as np
import torch

from ..config import DataConfig

Batch = Dict[str, np.ndarray]


class ArraySource:
    """An in-memory (features, labels) source."""

    def __init__(self, arrays: Dict[str, np.ndarray]):
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"ragged source: {sizes}")
        self.arrays = arrays
        self.size = next(iter(sizes.values()))

    def gather(self, idx: np.ndarray) -> Batch:
        return {k: v[idx] for k, v in self.arrays.items()}


class DataPipeline:
    """Shuffles, batches and prefetches one process's batches.

    ``drop_remainder=False`` keeps the tail by PADDING the final batch
    (wrapped indices) and attaching an ``eval_mask`` key (1=real, 0=pad) to
    every batch, so evaluation covers exactly the full set.
    """

    def __init__(self, source: ArraySource, local_batch: int, seed: int = 0,
                 shuffle: bool = True, drop_remainder: bool = True,
                 prefetch: int = 2):
        self.source = source
        self.local_batch = local_batch
        self.seed = seed
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch

    @property
    def steps_per_epoch(self) -> int:
        if self.drop_remainder:
            return self.source.size // self.local_batch
        return -(-self.source.size // self.local_batch)  # ceil

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(self.source.size)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        return idx

    def _epoch_batches(self, epoch: int) -> Iterator[Batch]:
        idx = self._epoch_indices(epoch)
        for start in range(0, self.steps_per_epoch * self.local_batch,
                           self.local_batch):
            batch_idx = idx[start:start + self.local_batch]
            eval_mask = None
            if not self.drop_remainder:
                real = len(batch_idx)
                eval_mask = np.zeros(self.local_batch, np.float32)
                eval_mask[:real] = 1.0
                if real < self.local_batch:
                    # Pad with wrapped indices — shapes stay static, the
                    # mask zeroes their metric contribution.
                    pad = np.resize(idx[:max(real, 1)],
                                    self.local_batch - real)
                    batch_idx = np.concatenate([batch_idx, pad])
            batch = self.source.gather(batch_idx)
            if eval_mask is not None:
                batch = {**batch, "eval_mask": eval_mask}
            yield batch

    def epochs(self) -> Iterator[Batch]:
        """Infinite stream across epochs from epoch 0, optionally prefetched
        on a thread. (Resuming mid-epoch comes with the port's checkpoints,
        ROADMAP A.5 ckpt.)"""
        def gen():
            epoch = 0
            while True:
                yield from self._epoch_batches(epoch)
                epoch += 1

        if self.prefetch > 0:
            return _thread_prefetch(gen(), self.prefetch)
        return gen()

    def one_epoch(self, epoch: int = 0) -> Iterator[Batch]:
        return self._epoch_batches(epoch)


def _thread_prefetch(it: Iterator[Batch], depth: int) -> Iterator[Batch]:
    """Background-thread prefetch with a shutdown path: closing (or
    abandoning) the returned generator stops the worker and drains the
    queue, so no thread is left blocked on a full queue."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
            put(sentinel)
        except BaseException as e:  # propagate loader crashes to consumer
            put(("__prefetch_error__", e))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, tuple) and len(item) == 2 and \
                    item[0] == "__prefetch_error__":
                raise RuntimeError("data pipeline worker crashed") \
                    from item[1]
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def to_device(batch: Batch, device: torch.device,
              pin: bool = False) -> Dict[str, torch.Tensor]:
    """numpy batch → tensors on ``device``; integer arrays become int64
    (token ids index embeddings and labels gather). With ``pin`` the host
    copy is pinned and the transfer is non-blocking."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if pin:
            t = t.pin_memory()
        t = t.to(device, non_blocking=pin)
        out[k] = t.long() if not t.is_floating_point() else t
    return out


class DevicePrefetcher:
    """Host→device staging ``depth`` batches ahead, on a background thread.

    On the card the copies run on a side stream from pinned memory; each
    staged batch carries an event that the consuming stream waits on, and
    its tensors are recorded on that stream so the caching allocator does
    not reuse them early. On the CPU it only converts. ``close()`` stops
    and joins the worker, then closes the wrapped iterator.
    """

    def __init__(self, it: Iterator[Batch], device: Union[str, torch.device],
                 depth: int = 2):
        self._it = it
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) if self._cuda \
            else None
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._sentinel = object()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _stage(self, batch: Batch):
        if not self._cuda:
            return to_device(batch, self._device), None
        with torch.cuda.stream(self._stream):
            out = to_device(batch, self._device, pin=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                if not self._put(self._stage(item)):
                    return
            self._put(self._sentinel)
        except BaseException as e:  # propagate staging crashes to consumer
            self._put(("__prefetch_error__", e))

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        item = self._q.get()
        if item is self._sentinel:
            raise StopIteration
        if isinstance(item[0], str) and item[0] == "__prefetch_error__":
            raise RuntimeError("device prefetch worker crashed") from item[1]
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for t in batch.values():
                t.record_stream(stream)
        return batch

    def close(self):
        self._stop.set()
        # Unblock a worker stuck in put(); it re-checks the event and exits.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        # Join BEFORE closing the wrapped iterator: generator.close() on a
        # generator mid-next() in another thread raises ValueError.
        self._thread.join(timeout=10.0)
        close = getattr(self._it, "close", None)
        if close is not None:
            try:
                close()
            except ValueError:  # worker outlived the join timeout
                pass

    def __del__(self):
        self._stop.set()


_NOT_PORTED = {
    "cifar10": "A.8 (the ResNet path)",
    "imagenet": "A.8 (the ResNet path)",
    "wikipedia_mlm": "A.9 (BERT)",
    "lm_text": "A.9 (the GPT family)",
    "coco": "A.11 (detection)",
}


def build_pipeline(cfg: DataConfig, local_batch: int, num_classes: int = 0,
                   seed: int = 0, train: bool = True,
                   drop_remainder: bool = True) -> DataPipeline:
    """The dataset's pipeline. Only ``wmt_en_de`` is ported."""
    del num_classes  # the image datasets' argument
    if cfg.name in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset {cfg.name!r} is not ported yet (ROADMAP "
            f"{_NOT_PORTED[cfg.name]})")
    if cfg.name != "wmt_en_de":
        raise KeyError(f"unknown dataset {cfg.name!r}")
    from .text import build_text_source

    return DataPipeline(build_text_source(cfg, train), local_batch,
                        seed=seed, shuffle=train, prefetch=cfg.prefetch,
                        drop_remainder=drop_remainder)
