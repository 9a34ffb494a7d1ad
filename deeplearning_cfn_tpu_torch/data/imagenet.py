"""Real ImageNet ingestion: pre-decoded binary shards + native hot path — a
copy of ``deeplearning_cfn_tpu/data/imagenet.py`` for the port (numpy and
the port's own ``dataio`` only; PIL is imported inside ``prepare_imagenet``
and nowhere else). Shards either package writes, the other reads.

The reference's flagship workload (BASELINE.json configs[1] — ImageNet
ResNet-50 via TF+Horovod) consumed TFRecords with on-the-fly JPEG decode on
host CPUs. At TPU feed rates JPEG decode is the classic host bottleneck
(SURVEY.md §8 hard-part #2), so the rebuild splits ingestion in two:

1. **Preparation** (one-off, ``prepare_imagenet`` / the JAX package's
   ``dlcfn-tpu data prepare-imagenet`` CLI): decode JPEGs (PIL), resize
   the short side to ``size`` (default 256), center-crop to square u8 RGB, and
   write fixed-record binary shards. This is the FFCV-style trade: pay
   decode once, stream bytes forever after.
2. **Runtime** (:class:`ShardedImageNetSource`): mmap the shards, and per
   batch do random-resized-crop → bilinear resize to the train resolution →
   flip → per-channel normalize, in the native C++ loader
   (``dataio.dlcfn_crop_resize_norm``, threaded, GIL-free) with a numpy
   fallback that replicates the C++ RNG draw-for-draw.

Shard format (``dlcfn-imagenet-shards-v1``)::

    <split_dir>/index.json
      {"format": "dlcfn-imagenet-shards-v1",
       "image_hw": [H, W],           # stored (pre-decoded) resolution
       "record_bytes": 4 + H*W*3,
       "num_classes": C,
       "shards": [{"file": "shard-00000.bin", "num_records": N0}, ...]}
    <split_dir>/shard-XXXXX.bin
      num_records consecutive records, each:
        int32 (little-endian) label | uint8[H*W*3] RGB, HWC

Per-host sharding happens at the index level (DataPipeline hands each
process its slice of the global shuffled index), so any number of hosts can
share one shard set — the GCS/EFS "shared data store" role from SURVEY.md §6.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import DataConfig

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

FORMAT_NAME = "dlcfn-imagenet-shards-v1"
_GOLDEN = 0x9E3779B97F4A7C15
_MASK64 = (1 << 64) - 1


# ---------------------------------------------------------------------------
# RNG — SplitMix64, bit-identical to dataio.cpp
# ---------------------------------------------------------------------------


def _splitmix64(x: int) -> int:
    x = (x + _GOLDEN) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


class _Rng:
    def __init__(self, seed: int):
        self.state = seed & _MASK64

    def next(self) -> int:
        self.state = _splitmix64(self.state)
        return self.state

    def below(self, bound: int) -> int:
        return self.next() % bound

    def uniform01(self) -> float:
        return (self.next() >> 11) * (1.0 / 9007199254740992.0)


# Eval center-crop field of view: crop EVAL_CROP_RATIO*min(h,w), then
# resize — with 256² stored sources exactly the classic resize-256 /
# center-crop-224 recipe, and the same field of view at any other shard
# size. Must match kEvalCropRatio in dataio.cpp (same contract style as
# the shared RNG).
EVAL_CROP_RATIO = 0.875


def _crop_params(rng: "_Rng", h: int, w: int, augment: bool
                 ) -> Tuple[int, int, int, int, bool]:
    """(y0, x0, crop_h, crop_w, flip) — the draw order is the contract
    shared with crop_resize_one in dataio.cpp."""
    if augment:
        area = float(h * w)
        for _ in range(10):
            target_area = (0.08 + rng.uniform01() * 0.92) * area
            log_lo, log_hi = math.log(3.0 / 4.0), math.log(4.0 / 3.0)
            ar = math.exp(log_lo + rng.uniform01() * (log_hi - log_lo))
            w_c = int(math.floor(math.sqrt(target_area * ar) + 0.5))
            h_c = int(math.floor(math.sqrt(target_area / ar) + 0.5))
            if 0 < w_c <= w and 0 < h_c <= h:
                y0 = rng.below(h - h_c + 1)
                x0 = rng.below(w - w_c + 1)
                return y0, x0, h_c, w_c, bool(rng.next() & 1)
        side = min(h, w)
        return (h - side) // 2, (w - side) // 2, side, side, \
            bool(rng.next() & 1)
    # floor(x + 0.5): the one tie-breaking rule both implementations use
    # (Python round() is half-to-even and would diverge from C++ lround).
    side = max(1, int(EVAL_CROP_RATIO * min(h, w) + 0.5))
    return (h - side) // 2, (w - side) // 2, side, side, False


def _crop_resize_norm_py(
    images: Sequence[np.ndarray], out_size: int, seed: int, augment: bool,
    mean: np.ndarray = IMAGENET_MEAN, std: np.ndarray = IMAGENET_STD,
) -> np.ndarray:
    """Numpy fallback for dataio.dlcfn_crop_resize_norm — same RNG, same
    sampling formula, same normalization (parity-tested)."""
    b = len(images)
    out = np.empty((b, out_size, out_size, 3), np.float32)
    s = out_size
    for i, img in enumerate(images):
        h, w = img.shape[:2]
        rng = _Rng(_splitmix64(seed ^ (((i + 1) * _GOLDEN) & _MASK64)))
        y0, x0, ch, cw, flip = _crop_params(rng, h, w, augment)
        fy = y0 + (np.arange(s, dtype=np.float64) + 0.5) * ch / s - 0.5
        cols = np.arange(s)
        if flip:
            cols = s - 1 - cols
        fx = x0 + (cols.astype(np.float64) + 0.5) * cw / s - 0.5
        yi = np.floor(fy).astype(np.int64)
        xi = np.floor(fx).astype(np.int64)
        wy1 = (fy - yi).astype(np.float32)[:, None, None]
        wx1 = (fx - xi).astype(np.float32)[None, :, None]
        y0i = np.clip(yi, 0, h - 1)
        y1i = np.clip(yi + 1, 0, h - 1)
        x0i = np.clip(xi, 0, w - 1)
        x1i = np.clip(xi + 1, 0, w - 1)
        fimg = img.astype(np.float32)
        v00 = fimg[y0i[:, None], x0i[None, :]]
        v01 = fimg[y0i[:, None], x1i[None, :]]
        v10 = fimg[y1i[:, None], x0i[None, :]]
        v11 = fimg[y1i[:, None], x1i[None, :]]
        top = v00 + (v01 - v00) * wx1
        bot = v10 + (v11 - v10) * wx1
        v = top + (bot - top) * wy1
        out[i] = (v * (1.0 / 255.0) - mean) / std
    return out


# ---------------------------------------------------------------------------
# Shard writing
# ---------------------------------------------------------------------------


class ShardWriter:
    """Streaming writer for dlcfn-imagenet-shards-v1 — the single place
    that knows the record layout and index schema (write_shards and
    prepare_imagenet both go through it)."""

    def __init__(self, out_dir: str, image_hw: Tuple[int, int],
                 shard_records: int, prefix: str = "shard"):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.image_hw = tuple(image_hw)
        self.shard_records = shard_records
        self.prefix = prefix
        self.shards: List[Dict] = []
        self._fh = None
        self._in_shard = 0

    def add(self, image_u8: np.ndarray, label: int) -> None:
        h, w = self.image_hw
        img = np.ascontiguousarray(image_u8, np.uint8)
        assert img.shape == (h, w, 3), (
            f"record shape {img.shape} != {(h, w, 3)}")
        if self._fh is None:
            fname = f"{self.prefix}-{len(self.shards):05d}.bin"
            self.shards.append({"file": fname, "num_records": 0})
            self._fh = open(os.path.join(self.out_dir, fname), "wb")
            self._in_shard = 0
        self._fh.write(np.int32(label).tobytes())
        self._fh.write(img.tobytes())
        self._in_shard += 1
        self.shards[-1]["num_records"] = self._in_shard
        if self._in_shard >= self.shard_records:
            self._fh.close()
            self._fh = None

    def finish(self, num_classes: int) -> Dict:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        h, w = self.image_hw
        index = {
            "format": FORMAT_NAME,
            "image_hw": [h, w],
            "record_bytes": 4 + h * w * 3,
            "num_classes": int(num_classes),
            "shards": self.shards,
        }
        with open(os.path.join(self.out_dir, "index.json"), "w") as fh:
            json.dump(index, fh, indent=1)
        return index


def write_shards(
    out_dir: str,
    images_u8,
    labels: Sequence[int],
    num_classes: int,
    shard_records: int = 1024,
    prefix: str = "shard",
) -> Dict:
    """Write u8 HWC images + labels as dlcfn-imagenet-shards-v1.

    ``images_u8`` is any sequence of equal-shape [H,W,3] u8 arrays (list or
    [N,H,W,3] array). Returns the index dict (also written to index.json).
    """
    n = len(images_u8)
    assert n == len(labels) and n > 0
    writer = ShardWriter(out_dir, images_u8[0].shape[:2], shard_records,
                         prefix=prefix)
    for img, lab in zip(images_u8, labels):
        writer.add(img, int(lab))
    return writer.finish(num_classes)


def prepare_imagenet(
    src_dir: str,
    out_dir: str,
    size: int = 256,
    shard_records: int = 8192,
    limit: Optional[int] = None,
    log_every: int = 5000,
) -> Dict:
    """Convert a class-per-directory JPEG tree (the torchvision ImageFolder
    layout the reference's scripts also consumed) into binary shards.

    ``src_dir`` holds one subdirectory per class; sorted subdirectory names
    define the label ids. Each image is decoded with PIL, short-side resized
    to ``size``, center-cropped square. Run once per split::

        dlcfn-tpu data prepare-imagenet --src train/ --out shards/train
    """
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "prepare_imagenet needs PIL for JPEG decode; install pillow or "
            "produce shards with write_shards() from pre-decoded arrays"
        ) from e

    classes = sorted(
        d for d in os.listdir(src_dir)
        if os.path.isdir(os.path.join(src_dir, d)))
    if not classes:
        raise ValueError(f"no class directories under {src_dir}")
    files: List[Tuple[str, int]] = []
    for label, cls in enumerate(classes):
        cdir = os.path.join(src_dir, cls)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith((".jpg", ".jpeg", ".png")):
                files.append((os.path.join(cdir, fname), label))
    if limit:
        files = files[:limit]
    if not files:
        raise ValueError(f"no images found under {src_dir}")

    def decode(path: str) -> np.ndarray:
        img = Image.open(path).convert("RGB")
        w, h = img.size
        scale = size / min(w, h)
        img = img.resize((max(size, round(w * scale)),
                          max(size, round(h * scale))), Image.BILINEAR)
        w, h = img.size
        left, top = (w - size) // 2, (h - size) // 2
        return np.asarray(img.crop((left, top, left + size, top + size)),
                          np.uint8)

    writer = ShardWriter(out_dir, (size, size), shard_records)
    for i, (path, label) in enumerate(files):
        writer.add(decode(path), label)
        if log_every and (i + 1) % log_every == 0:
            print(f"[prepare-imagenet] {i + 1}/{len(files)} images")
    return writer.finish(len(classes))


# ---------------------------------------------------------------------------
# Runtime source
# ---------------------------------------------------------------------------


class ShardedImageNetSource:
    """mmap-backed source over dlcfn-imagenet-shards-v1.

    Exposes the seeded-gather protocol (``gather_seeded``) DataPipeline
    prefers: augmentation randomness comes from the pipeline's
    (seed, epoch, offset, process) mix, so results are deterministic and
    resume-stable. Labels are read once at load (4 bytes/record); image
    payloads stay on disk until gathered (the OS page cache is the prefetch
    buffer, as with the reference's RecordIO/TFRecord readers).
    """

    def __init__(self, split_dir: str, train: bool, image_size: int = 224,
                 native: bool = True, num_workers: int = 4):
        index_path = os.path.join(split_dir, "index.json")
        if not os.path.exists(index_path):
            raise FileNotFoundError(
                f"no index.json under {split_dir}; build shards with "
                "`dlcfn-tpu data prepare-imagenet`")
        with open(index_path) as fh:
            self.index = json.load(fh)
        if self.index.get("format") != FORMAT_NAME:
            raise ValueError(
                f"unsupported shard format {self.index.get('format')!r}")
        self.split_dir = split_dir
        self.train = train
        self.image_size = image_size
        self.num_workers = num_workers
        self.image_hw = tuple(self.index["image_hw"])
        self.record_bytes = int(self.index["record_bytes"])
        self.num_classes = int(self.index["num_classes"])

        self._mmaps: List[np.ndarray] = []
        counts = []
        for shard in self.index["shards"]:
            path = os.path.join(split_dir, shard["file"])
            mm = np.memmap(path, dtype=np.uint8, mode="r")
            expect = shard["num_records"] * self.record_bytes
            if mm.size != expect:
                raise ValueError(
                    f"{path}: {mm.size} bytes, expected {expect}")
            self._mmaps.append(mm)
            counts.append(shard["num_records"])
        self._cum = np.concatenate([[0], np.cumsum(counts)])
        self.size = int(self._cum[-1])

        # Labels up front: one int32 per record at each record head.
        labels = np.empty(self.size, np.int32)
        for s, mm in enumerate(self._mmaps):
            n = counts[s]
            recs = mm[:n * self.record_bytes].reshape(n, self.record_bytes)
            labels[self._cum[s]:self._cum[s + 1]] = (
                recs[:, :4].copy().view(np.int32).ravel())
        self._labels = labels

        self._native = False
        if native:
            from .. import dataio

            self._native = dataio.available()

    def _payload_ptr(self, example: int) -> int:
        shard = int(np.searchsorted(self._cum, example, side="right")) - 1
        rec = int(example - self._cum[shard])
        mm = self._mmaps[shard]
        return mm.ctypes.data + rec * self.record_bytes + 4

    def _payload_view(self, example: int) -> np.ndarray:
        shard = int(np.searchsorted(self._cum, example, side="right")) - 1
        rec = int(example - self._cum[shard])
        mm = self._mmaps[shard]
        start = rec * self.record_bytes + 4
        h, w = self.image_hw
        return mm[start:start + h * w * 3].reshape(h, w, 3)

    def gather_seeded(self, idx: np.ndarray, seed: int
                      ) -> Dict[str, np.ndarray]:
        labels = self._labels[idx]
        if self._native:
            from .. import dataio

            ptrs = np.fromiter((self._payload_ptr(int(e)) for e in idx),
                               np.uint64, count=len(idx))
            images = dataio.crop_resize_norm(
                ptrs, self.image_hw, self.image_size, seed,
                augment=self.train, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                nthreads=self.num_workers)
        else:
            views = [self._payload_view(int(e)) for e in idx]
            images = _crop_resize_norm_py(views, self.image_size, seed,
                                          augment=self.train)
        return {"image": images, "label": np.asarray(labels, np.int32)}

    # DataPipeline's unseeded path (eval under custom wrappers) — center
    # crop is draw-free, so seed 0 is exact.
    def gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return self.gather_seeded(idx, 0)


def load_imagenet_source(cfg: DataConfig, train: bool
                         ) -> ShardedImageNetSource:
    """Factory used by build_pipeline for the real-data path: expects
    ``cfg.data_dir/{train,val}/index.json``."""
    split = "train" if train else "val"
    return ShardedImageNetSource(
        os.path.join(cfg.data_dir, split), train=train,
        image_size=cfg.image_size, native=cfg.use_native_loader,
        num_workers=cfg.num_workers)


# ---------------------------------------------------------------------------
# Feed-rate measurement (SURVEY.md §8 hard-part #2 acceptance)
# ---------------------------------------------------------------------------


def measure_feed_rate(pipeline, num_batches: int = 30,
                      warmup: int = 3) -> Dict[str, float]:
    """Host-side images/sec the pipeline can sustain (no device in the
    loop) — must exceed one chip's training consumption rate for input and
    compute to overlap cleanly."""
    import time

    it = pipeline.epochs()
    batch = None
    for _ in range(warmup + 1):
        batch = next(it)
    per_batch = len(next(iter(batch.values())))
    t0 = time.perf_counter()
    for _ in range(num_batches):
        next(it)
    dt = time.perf_counter() - t0
    return {
        "images_per_sec": per_batch * num_batches / dt,
        "batch_size": float(per_batch),
        "batches": float(num_batches),
        "seconds": dt,
    }
