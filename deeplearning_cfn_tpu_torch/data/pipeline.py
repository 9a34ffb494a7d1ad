"""Dataset pipelines — the port of ``deeplearning_cfn_tpu/data/pipeline.py``.

- Sources: :class:`ArraySource` (an in-memory dict of equal-length numpy
  arrays), :func:`synthetic_image_source` (the JAX package's learnable
  class-mean images, the stand-in for CIFAR-10 and ImageNet when no data
  directory is given), :func:`load_cifar10` (the pickled
  ``cifar-10-batches-py`` batches) and, in ``data/imagenet.py``, the
  mmap'd ImageNet shards with their seeded gather.
- :class:`DataPipeline`: shuffles with the JAX package's per-epoch
  ``RandomState(seed + epoch)`` permutation, pads the eval tail with an
  ``eval_mask`` (``drop_remainder=False``), prefetches host batches on a
  thread, and gathers through the same branch the JAX pipeline takes under
  the same conditions: a source with ``gather_seeded`` (ImageNet shards)
  gets the pipeline's (seed, epoch, offset) seed; an :class:`ArraySource`
  with no augmentation or CIFAR's :func:`augment_crop_flip` goes through
  the native C++ ``dataio`` gather when ``use_native_loader`` is set and
  the library builds (crop and flip then come from dataio's SplitMix64
  stream); anything else gathers in Python (crop and flip from numpy's
  ``RandomState``). Across processes each takes its contiguous slice of the
  epoch's permutation (``process_index`` of ``process_count``, by default
  the process group's) and seeds its augmentation with its index, as the
  JAX pipeline does. Given the same source, seed, batch size and process
  it yields exactly the JAX pipeline's batches.
- :class:`DevicePrefetcher`: stages ``depth`` batches to the card ahead of
  the step loop, from pinned host memory with non-blocking copies on a side
  stream, so the host→device transfer overlaps the previous step's compute.
- :func:`build_pipeline`: ``cifar10``, ``imagenet``, ``wmt_en_de``,
  ``wikipedia_mlm``, ``lm_text`` (``data/text.py``) and ``coco``
  (``data/detection.py``).
"""

from __future__ import annotations

import os
import pickle
import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Union

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


def synthetic_image_source(num_examples: int, image_size: int,
                           num_classes: int, seed: int,
                           channels: int = 3) -> ArraySource:
    """Learnable synthetic image data: each class has a fixed random mean
    image; examples are mean + noise (the JAX package's network-free
    stand-in for CIFAR-10 and ImageNet, draw for draw)."""
    rng = np.random.RandomState(seed)
    means = rng.normal(0.0, 1.0, (num_classes, 8, 8, channels)) \
        .astype(np.float32)
    labels = rng.randint(0, num_classes, num_examples).astype(np.int32)
    noise = rng.normal(0.0, 0.25, (num_examples, image_size, image_size,
                                   channels)).astype(np.float32)
    # Upsample the 8x8 class mean to the image size (nearest) — keeps memory
    # small for ImageNet-sized synthetic data.
    reps = image_size // 8
    mean_imgs = np.repeat(np.repeat(means, reps, axis=1), reps, axis=2)
    images = mean_imgs[labels] + noise
    return ArraySource({"image": images, "label": labels})


def load_cifar10(data_dir: str, train: bool) -> ArraySource:
    """Read the standard ``cifar-10-batches-py`` pickled format (files the
    user put there: unpickling runs code, so never point it at others')."""
    names = [f"data_batch_{i}" for i in range(1, 6)] if train \
        else ["test_batch"]
    xs, ys = [], []
    for name in names:
        with open(os.path.join(data_dir, name), "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        xs.append(d[b"data"])
        ys.append(np.asarray(d[b"labels"], np.int32))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    mean = np.array([0.4914, 0.4822, 0.4465], np.float32) * 255
    std = np.array([0.2470, 0.2435, 0.2616], np.float32) * 255
    x = (x.astype(np.float32) - mean) / std
    return ArraySource({"image": x, "label": np.concatenate(ys)})


def augment_crop_flip(batch: Batch, rng: np.random.RandomState,
                      pad: int = 4) -> Batch:
    """Random crop (with reflect padding) + horizontal flip — the standard
    CIFAR augmentation, numpy's draws (the Python branch)."""
    x = batch["image"]
    n, h, w, c = x.shape
    padded = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                    mode="reflect")
    out = np.empty_like(x)
    ys = rng.randint(0, 2 * pad + 1, n)
    xs = rng.randint(0, 2 * pad + 1, n)
    flips = rng.rand(n) < 0.5
    for i in range(n):
        img = padded[i, ys[i]:ys[i] + h, xs[i]:xs[i] + w]
        out[i] = img[:, ::-1] if flips[i] else img
    return {**batch, "image": out}


def _batch_seed(seed: int, epoch: int, start: int, pidx: int = 0) -> int:
    """The (seed, epoch, batch offset, process) mix the JAX pipeline hands
    to the native gather and to seeded sources."""
    return ((seed + 1) * 7919 + epoch * 2654435761 + start * 31 + pidx) \
        & (2**64 - 1)


class DataPipeline:
    """Shards, shuffles, batches, augments and prefetches one process's
    batches. ``local_batch`` is the per-process batch; the epoch's indices
    are sharded by ``process_index``/``process_count`` (the process
    group's when not given) after a shuffle from the shared seed, so across
    processes every example appears once per epoch.

    ``drop_remainder=False`` keeps the tail by PADDING the final batch
    (wrapped indices) and attaching an ``eval_mask`` key (1=real, 0=pad) to
    every batch, so evaluation covers exactly the full set. The gather
    branch (seeded, native or Python) is chosen as the JAX pipeline
    chooses it; see the module docstring.
    """

    def __init__(self, source, local_batch: int, seed: int = 0,
                 shuffle: bool = True,
                 augment: Optional[Callable[[Batch, np.random.RandomState],
                                            Batch]] = None,
                 drop_remainder: bool = True, prefetch: int = 2,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 native: bool = True, num_workers: int = 4):
        from ..parallel import mesh

        self.source = source
        self.local_batch = local_batch
        self.seed = seed
        self.shuffle = shuffle
        self.augment = augment
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch
        self.pidx = mesh.process_index() if process_index is None \
            else process_index
        self.pcount = mesh.process_count() if process_count is None \
            else process_count
        self.num_workers = max(1, num_workers)
        # Sources exposing gather_seeded (ImageNet shards) do their own
        # augmentation/decode — the pipeline just hands them a seed.
        self._seeded = hasattr(source, "gather_seeded") and augment is None
        # Native path handles the plain and crop/flip cases; anything else
        # (custom augment fns, sources overriding gather) stays in Python.
        self._native = False
        if not self._seeded and native \
                and (augment is None or augment is augment_crop_flip) \
                and isinstance(source, ArraySource) \
                and type(source).gather is ArraySource.gather:
            from .. import dataio

            self._native = dataio.available()

    @property
    def _per_proc(self) -> int:
        if self.drop_remainder:
            return self.source.size // self.pcount
        return -(-self.source.size // self.pcount)  # ceil

    @property
    def steps_per_epoch(self) -> int:
        if self.drop_remainder:
            return self._per_proc // self.local_batch
        return -(-self._per_proc // self.local_batch)  # ceil

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(self.source.size)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        per_proc = self._per_proc
        return idx[self.pidx * per_proc:(self.pidx + 1) * per_proc]

    def _gather_native(self, idx: np.ndarray, epoch: int, start: int
                       ) -> Batch:
        """GIL-free threaded gather (+ crop/flip) through dataio, seeded by
        (pipeline seed, epoch, batch offset, process), so augmentation does
        not depend on thread scheduling."""
        from .. import dataio

        seed = _batch_seed(self.seed, epoch, start, self.pidx)
        out: Batch = {}
        for k, v in self.source.arrays.items():
            if k == "image" and v.ndim == 4 and v.dtype == np.float32:
                out[k] = dataio.gather_augment(
                    v, idx, pad=4, seed=seed,
                    augment=self.augment is augment_crop_flip,
                    nthreads=self.num_workers)
            else:
                out[k] = dataio.gather_rows(v, idx,
                                            nthreads=self.num_workers)
        return out

    def _epoch_batches(self, epoch: int, start_batch: int = 0
                       ) -> Iterator[Batch]:
        rng = np.random.RandomState((self.seed + 1) * 7919 + epoch * 31
                                    + self.pidx)
        idx = self._epoch_indices(epoch)
        for start in range(start_batch * self.local_batch,
                           self.steps_per_epoch * self.local_batch,
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
            if self._seeded:
                batch = self.source.gather_seeded(
                    np.asarray(batch_idx, np.int64),
                    _batch_seed(self.seed, epoch, start, self.pidx))
            elif self._native:
                batch = self._gather_native(np.asarray(batch_idx, np.int32),
                                            epoch, start)
            else:
                batch = self.source.gather(batch_idx)
                if self.augment is not None:
                    batch = self.augment(batch, rng)
            if eval_mask is not None:
                batch = {**batch, "eval_mask": eval_mask}
            yield batch

    def epochs(self, start_epoch: int = 0, skip_batches: int = 0
               ) -> Iterator[Batch]:
        """Infinite stream across epochs, optionally prefetched on a thread.

        ``skip_batches`` fast-forwards within the first epoch (mid-epoch
        checkpoint resume: the stream continues where training stopped
        instead of replaying the epoch's head)."""
        def gen():
            epoch = start_epoch
            skip = skip_batches
            while True:
                yield from self._epoch_batches(epoch, start_batch=skip)
                skip = 0
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
    and joins the worker, then closes the wrapped iterator. A CUDA graph
    reads fixed buffers, so a replayed step copies the batch it gets here
    (on the consuming stream, after the wait) into the graph's static
    inputs (``train/graphs.py``); the staging itself is unchanged.
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


def build_pipeline(cfg: DataConfig, local_batch: int, num_classes: int = 0,
                   seed: int = 0, train: bool = True,
                   drop_remainder: bool = True,
                   process_index: Optional[int] = None,
                   process_count: Optional[int] = None) -> DataPipeline:
    """The dataset's pipeline, with the JAX package's sources, seeds and
    defaults: real CIFAR-10 batches or ImageNet shards under
    ``data.data_dir`` (unless ``data.synthetic``), else the synthetic
    images (train seeds 17 / 29, eval 23 / 31); ``coco`` reads
    ``<data_dir>/{train,eval}.npz`` or makes synthetic scenes (47 / 53).
    ``process_index``/``process_count`` default to the process group's."""
    name = cfg.name
    common = dict(seed=seed, shuffle=train, prefetch=cfg.prefetch,
                  native=cfg.use_native_loader, num_workers=cfg.num_workers,
                  drop_remainder=drop_remainder,
                  process_index=process_index, process_count=process_count)
    want_real = bool(cfg.data_dir) and not cfg.synthetic \
        and os.path.isdir(cfg.data_dir)
    if name in ("cifar10", "imagenet"):
        if want_real and name == "cifar10":
            source = load_cifar10(cfg.data_dir, train)
        elif want_real:
            from .imagenet import load_imagenet_source

            source = load_imagenet_source(cfg, train)
        else:
            default = {"cifar10": (50_000, 10_000),
                       "imagenet": (8192, 1024)}[name]
            # As in the JAX package, an eval set with no size of its own
            # takes num_train_examples when that is set.
            n = cfg.num_train_examples or default[0 if train else 1]
            if not train and cfg.num_eval_examples:
                n = cfg.num_eval_examples
            seeds = {"cifar10": (17, 23), "imagenet": (29, 31)}[name]
            source = synthetic_image_source(n, cfg.image_size, num_classes,
                                            seed=seeds[0] if train
                                            else seeds[1])
        augment = augment_crop_flip if name == "cifar10" and train \
            else None
        return DataPipeline(source, local_batch, augment=augment, **common)
    if name == "coco":
        from .detection import build_detection_source

        source = build_detection_source(cfg, train, num_classes=num_classes,
                                        max_boxes=cfg.max_boxes)
        return DataPipeline(source, local_batch, **common)
    if name not in ("wmt_en_de", "wikipedia_mlm", "lm_text"):
        raise KeyError(f"unknown dataset {name!r}")
    from .text import build_text_source

    return DataPipeline(build_text_source(cfg, train), local_batch, **common)
