"""Native data-loading bindings (ctypes over ``dataio.cpp``) — a copy of the
JAX package's ``dataio`` for the port, which never imports that package.

This is host C++, not a device kernel: a threaded, GIL-free batch gather
with CIFAR's crop/flip augmentation, and ImageNet's random-resized-crop →
bilinear resize → normalize from mmap'd u8 records. ``dataio.cpp`` is the
JAX package's file (same C entry points, same SplitMix64 streams), so a
pipeline that takes the native branch gives the same batches in both
packages.

The library is built with ``g++ -O3`` at first use into the port's
``_build/`` directory, under a name that carries a hash of the source (an
edited source is rebuilt, a stale library never loaded); nothing is built
when the module is imported. Without a compiler ``available()`` is False
and ``data/pipeline.py`` takes the Python branch — the same condition under
which the JAX package falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dataio.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
_CMD = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _lib_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(_CMD).encode())
    return os.path.join(_BUILD_DIR, f"_dataio-{h.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    # Compile to a private temp path, then rename: concurrent processes
    # (parallel pytest workers) must never dlopen a half-written library.
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([*_CMD, "-o", tmp, _SRC], capture_output=True,
                              text=True, timeout=120)
        if proc.returncode != 0 or not os.path.exists(tmp):
            return False
        os.replace(tmp, path)
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
    return os.path.exists(path)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it if needed; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        u64, i32, i64, f32p, i32p = (ctypes.c_uint64, ctypes.c_int,
                                     ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_float),
                                     ctypes.POINTER(ctypes.c_int32))
        try:
            lib.dlcfn_version.restype = ctypes.c_int
            if lib.dlcfn_version() != 2:
                return None
            for fn in (lib.dlcfn_gather_augment, lib.dlcfn_gather_rows_f32,
                       lib.dlcfn_gather_rows_i32, lib.dlcfn_crop_resize_norm):
                fn.restype = None
            lib.dlcfn_gather_augment.argtypes = [
                f32p, i32p, f32p, i32, i32, i32, i32, i32, u64, i32, i32]
            lib.dlcfn_gather_rows_f32.argtypes = [
                f32p, i32p, f32p, i32, i64, i32]
            lib.dlcfn_gather_rows_i32.argtypes = [
                i32p, i32p, i32p, i32, i64, i32]
            lib.dlcfn_crop_resize_norm.argtypes = [
                ctypes.POINTER(u64), i32, i32, f32p, i32, i32, u64, i32,
                f32p, f32p, i32]
        except AttributeError:
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _require():
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native dataio unavailable (no g++ to build "
                           "dataio.cpp)")
    return lib


def _check_idx(idx: np.ndarray, n: int) -> np.ndarray:
    idx = np.ascontiguousarray(idx, np.int32)
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(f"gather index out of range [0, {n})")
    return idx


def gather_augment(src: np.ndarray, idx: np.ndarray, pad: int, seed: int,
                   augment: bool, nthreads: int = 4) -> np.ndarray:
    """Batched image gather with optional crop/flip augmentation.

    src [N,H,W,C] f32 contiguous; idx [B] i32 → out [B,H,W,C].
    """
    lib = _require()
    src = np.ascontiguousarray(src, np.float32)
    if src.ndim != 4:
        raise ValueError(f"gather_augment wants [N,H,W,C], got {src.shape}")
    idx = _check_idx(idx, src.shape[0])
    b = len(idx)
    _, h, w, c = src.shape
    out = np.empty((b, h, w, c), np.float32)
    lib.dlcfn_gather_augment(_f32(src), _i32(idx), _f32(out), b, h, w, c,
                             pad, seed & (2**64 - 1), int(augment), nthreads)
    return out


def crop_resize_norm(src_ptrs: np.ndarray, src_hw, out_size: int,
                     seed: int, augment: bool, mean: np.ndarray,
                     std: np.ndarray, nthreads: int = 4) -> np.ndarray:
    """Batched u8 record → cropped/resized/normalized f32 [B,S,S,3].

    ``src_ptrs``: uint64 array of B addresses, each pointing at a contiguous
    u8 HWC image payload of shape ``src_hw + (3,)`` (records inside mmap'd
    ImageNet shards, which the caller keeps alive). Augmentation
    (random-resized-crop + flip) is deterministic per (seed, batch
    position); ``data/imagenet.py:_crop_resize_norm_py`` replays the same
    draws in numpy.
    """
    lib = _require()
    src_ptrs = np.ascontiguousarray(src_ptrs, np.uint64)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if mean.shape != (3,) or std.shape != (3,):
        raise ValueError("mean and std must have 3 entries (RGB)")
    b = len(src_ptrs)
    out = np.empty((b, out_size, out_size, 3), np.float32)
    lib.dlcfn_crop_resize_norm(
        src_ptrs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        int(src_hw[0]), int(src_hw[1]), _f32(out), b, out_size,
        seed & (2**64 - 1), int(augment), _f32(mean), _f32(std), nthreads)
    return out


def gather_rows(src: np.ndarray, idx: np.ndarray, nthreads: int = 4
                ) -> np.ndarray:
    """out[b] = src[idx[b]] for f32/i32 arrays of any trailing shape."""
    lib = _require()
    idx = _check_idx(idx, len(src))
    row = int(np.prod(src.shape[1:], dtype=np.int64)) if src.ndim > 1 else 1
    out = np.empty((len(idx),) + src.shape[1:], src.dtype)
    if src.dtype == np.float32:
        src = np.ascontiguousarray(src)
        lib.dlcfn_gather_rows_f32(_f32(src), _i32(idx), _f32(out),
                                  len(idx), row, nthreads)
    elif src.dtype == np.int32:
        src = np.ascontiguousarray(src)
        lib.dlcfn_gather_rows_i32(_i32(src), _i32(idx), _i32(out),
                                  len(idx), row, nthreads)
    else:
        return src[idx]
    return out
