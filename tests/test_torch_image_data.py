"""The port's image data path (data.pipeline, data.imagenet, dataio) against
the JAX package's, on the CPU: the same arrays, bit for bit.

- ``synthetic_image_source``, ``augment_crop_flip`` and ``load_cifar10``
  (on pickled ``cifar-10-batches-py`` files the test writes);
- ``DataPipeline`` batches, train and eval, on the native (C++ ``dataio``)
  branch and on the Python branch — CIFAR's crop and flip come from
  dataio's SplitMix64 stream on the one and numpy's ``RandomState`` on the
  other, in both packages alike — and through ``build_pipeline`` for the
  ``cifar10`` and ``imagenet`` datasets (synthetic and real files);
- the ``dataio`` calls ``gather_augment``, ``gather_rows`` and
  ``crop_resize_norm``;
- ``ShardedImageNetSource.gather_seeded`` over shards made by
  ``write_shards`` (native and numpy), shards from ``prepare_imagenet``,
  and ``measure_feed_rate``.
"""

import os
import pickle

import numpy as np
import pytest

from deeplearning_cfn_tpu import dataio as jdataio
from deeplearning_cfn_tpu.config import DataConfig as JDataConfig
from deeplearning_cfn_tpu.data import imagenet as jimg
from deeplearning_cfn_tpu.data import pipeline as jpipe
from deeplearning_cfn_tpu_torch import dataio as tdataio
from deeplearning_cfn_tpu_torch.config import DataConfig
from deeplearning_cfn_tpu_torch.data import imagenet as timg
from deeplearning_cfn_tpu_torch.data import pipeline as tpipe


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _jax_batches(pipe, epochs):
    return [b for e in range(epochs) for b in pipe.one_epoch(e)]


def test_both_loaders_build():
    assert tdataio.available() and jdataio.available()
    # The port builds its own copy under its _build/, never beside the JAX
    # package's source.
    path = tdataio._lib_path()
    assert os.path.exists(path)
    assert os.sep.join(("deeplearning_cfn_tpu_torch", "_build")) in path


def test_synthetic_source_and_augment_match_jax():
    for args in ((64, 32, 10, 17), (16, 224, 1000, 29)):
        _same(tpipe.synthetic_image_source(*args).arrays,
              jpipe.synthetic_image_source(*args).arrays)
    batch = {"image": np.random.RandomState(3).normal(
        0, 1, (6, 8, 8, 3)).astype(np.float32), "label": np.arange(6)}
    _same(tpipe.augment_crop_flip(batch, np.random.RandomState(9)),
          jpipe.augment_crop_flip(batch, np.random.RandomState(9)))


def _write_cifar(root, n=4):
    rng = np.random.RandomState(0)
    os.makedirs(root)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        d = {b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
             b"labels": list(rng.randint(0, 10, n))}
        with open(os.path.join(root, name), "wb") as fh:
            pickle.dump(d, fh)
    return root


def test_load_cifar10_matches_jax(tmp_path):
    root = _write_cifar(str(tmp_path / "cifar-10-batches-py"))
    for train in (True, False):
        got = tpipe.load_cifar10(root, train)
        assert got.size == (20 if train else 4)
        _same(got.arrays, jpipe.load_cifar10(root, train).arrays)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("train", [True, False])
def test_pipeline_batches_match_jax(native, train):
    src = dict(num_examples=40, image_size=16, num_classes=10, seed=5)
    augment = dict(augment=(tpipe.augment_crop_flip if train else None))
    port = tpipe.DataPipeline(tpipe.synthetic_image_source(**src), 8,
                              seed=3, shuffle=train, native=native,
                              prefetch=0, drop_remainder=train, **augment)
    ref = jpipe.DataPipeline(
        jpipe.synthetic_image_source(**src), 8, seed=3, shuffle=train,
        native=native, prefetch=0, drop_remainder=train,
        augment=jpipe.augment_crop_flip if train else None,
        process_index=0, process_count=1)
    assert port._native == ref._native == native
    got = [b for e in range(2) for b in port.one_epoch(e)]
    want = _jax_batches(ref, 2)
    assert len(got) == len(want) == 10
    for a, b in zip(got, want):
        _same(a, b)
    if train:  # augmentation moved pixels
        plain = tpipe.synthetic_image_source(**src)
        assert not np.array_equal(got[0]["image"],
                                  plain.gather(np.arange(8))["image"])


@pytest.mark.parametrize("dataset,real", [("cifar10", False),
                                          ("cifar10", True),
                                          ("imagenet", False),
                                          ("imagenet", True)])
def test_build_pipeline_matches_jax(dataset, real, tmp_path):
    over = dict(name=dataset, image_size=32 if dataset == "cifar10" else 24,
                num_train_examples=48, prefetch=0)
    if real and dataset == "cifar10":
        over["data_dir"] = _write_cifar(str(tmp_path / "c"), n=8)
    elif real:
        rng = np.random.RandomState(1)
        for split, n in (("train", 40), ("val", 12)):
            jimg.write_shards(str(tmp_path / "i" / split),
                              rng.randint(0, 256, (n, 40, 36, 3),
                                          dtype=np.uint8),
                              rng.randint(0, 10, n), 10, shard_records=16)
        over["data_dir"] = str(tmp_path / "i")
    for train in (True, False):
        port = tpipe.build_pipeline(DataConfig(**over), 16, 10, seed=2,
                                    train=train, drop_remainder=train)
        ref = jpipe.build_pipeline(JDataConfig(**over), 16, 10, seed=2,
                                   train=train, drop_remainder=train)
        assert port._native == ref._native
        assert port._seeded == ref._seeded == (real and
                                               dataset == "imagenet")
        got = list(port.one_epoch(1))
        want = list(ref.one_epoch(1))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            _same(a, b)


def test_dataio_calls_match_jax():
    rng = np.random.RandomState(4)
    src = rng.normal(0, 1, (20, 12, 10, 3)).astype(np.float32)
    idx = np.array([3, 19, 0, 3, 7], np.int32)
    for augment in (True, False):
        for nthreads in (1, 3):
            np.testing.assert_array_equal(
                tdataio.gather_augment(src, idx, 4, 12345, augment,
                                       nthreads),
                jdataio.gather_augment(src, idx, 4, 12345, augment,
                                       nthreads))
    ints = rng.randint(0, 99, (20, 7)).astype(np.int32)
    for arr in (src, ints, ints.astype(np.int64)):
        np.testing.assert_array_equal(tdataio.gather_rows(arr, idx),
                                      jdataio.gather_rows(arr, idx))
    with pytest.raises(IndexError):
        tdataio.gather_rows(ints, np.array([20], np.int32))
    images = rng.randint(0, 256, (3, 30, 40, 3), dtype=np.uint8)
    ptrs = np.array([images[i].ctypes.data for i in range(3)], np.uint64)
    for augment in (True, False):
        got = tdataio.crop_resize_norm(ptrs, (30, 40), 16, 77, augment,
                                       timg.IMAGENET_MEAN, timg.IMAGENET_STD)
        want = jdataio.crop_resize_norm(ptrs, (30, 40), 16, 77, augment,
                                        jimg.IMAGENET_MEAN,
                                        jimg.IMAGENET_STD)
        np.testing.assert_array_equal(got, want)
        # ... and the numpy replay of the same draws agrees (to f32
        # rounding of the bilinear weights).
        py = timg._crop_resize_norm_py(list(images), 16, 77, augment)
        np.testing.assert_allclose(got, py, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("native", [True, False])
def test_sharded_source_matches_jax(native, tmp_path):
    rng = np.random.RandomState(6)
    images = rng.randint(0, 256, (37, 34, 30, 3), dtype=np.uint8)
    labels = rng.randint(0, 7, 37)
    index = timg.write_shards(str(tmp_path / "t"), images, labels, 7,
                              shard_records=10)
    jindex = jimg.write_shards(str(tmp_path / "j"), images, labels, 7,
                               shard_records=10)
    assert index == jindex
    for name in sorted(os.listdir(tmp_path / "t")):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
    idx = np.array([36, 0, 9, 10, 21, 9], np.int64)
    for train in (True, False):
        port = timg.ShardedImageNetSource(str(tmp_path / "t"), train, 20,
                                          native=native)
        ref = jimg.ShardedImageNetSource(str(tmp_path / "j"), train, 20,
                                         native=native)
        assert port.size == 37 and port._native == native
        _same(port.gather_seeded(idx, 2024), ref.gather_seeded(idx, 2024))
    np.testing.assert_array_equal(
        port.gather_seeded(idx, 1)["label"], labels[idx])


def test_prepare_imagenet_matches_jax(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(7)
    for cls in ("a", "b"):
        os.makedirs(tmp_path / "jpg" / cls)
        for i in range(3):
            Image.fromarray(rng.randint(0, 256, (20 + i, 27, 3),
                                        dtype=np.uint8)).save(
                tmp_path / "jpg" / cls / f"{i}.jpg")
    got = timg.prepare_imagenet(str(tmp_path / "jpg"), str(tmp_path / "t"),
                                size=16, shard_records=4, log_every=0)
    want = jimg.prepare_imagenet(str(tmp_path / "jpg"), str(tmp_path / "j"),
                                 size=16, shard_records=4, log_every=0)
    assert got == want and got["num_classes"] == 2
    for shard in got["shards"]:
        assert (tmp_path / "t" / shard["file"]).read_bytes() == \
            (tmp_path / "j" / shard["file"]).read_bytes()


def test_feed_rate_reports_images_per_second(tmp_path):
    rng = np.random.RandomState(8)
    timg.write_shards(str(tmp_path / "s"),
                      rng.randint(0, 256, (32, 24, 24, 3), dtype=np.uint8),
                      rng.randint(0, 4, 32), 4)
    pipe = tpipe.DataPipeline(
        timg.ShardedImageNetSource(str(tmp_path / "s"), True, 16), 8,
        prefetch=0)
    assert pipe._seeded
    rate = timg.measure_feed_rate(pipe, num_batches=3, warmup=1)
    assert rate["batch_size"] == 8 and rate["images_per_sec"] > 0
