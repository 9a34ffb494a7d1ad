"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``_build/`` at first use, and loaded through ``ctypes`` (no PyTorch headers,
so a build takes seconds, not minutes). The library's file name carries a
hash of its source, of every ``csrc/*.cuh`` header the source includes
(``#include "..."``, followed recursively) and of the compiler flags, so an
edited source, header or flag is rebuilt and a stale library is never
loaded. Nothing is built when a module is imported: the CPU tests
import every module and this machine may have no ``nvcc``.

``build()`` compiles several kernels at once (one ``nvcc`` process per
source, all started together) — ``chip_smoke.py`` calls it before anything
else so the build time is paid once and reported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler",
              "-fPIC"]
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)

KERNEL_NAMES = ("flash_attn_fwd", "flash_attn_bwd_dkdv", "flash_attn_bwd_dq")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are "
            "built from csrc/ at first use on a machine with the CUDA toolkit")
    return path


def sources(name: str) -> List[str]:
    """``csrc/<name>.cu`` and every local header it includes, directly or
    through another header, in the order first met."""
    todo, seen = [os.path.join(CSRC_DIR, f"{name}.cu")], []
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as fh:
            for inc in _INCLUDE.findall(fh.read()):
                todo.append(os.path.join(os.path.dirname(path),
                                         inc.decode()))
    return seen


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        with open(path, "rb") as fh:
            digest.update(os.path.basename(path).encode() + b"\0"
                          + fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _nvcc_cmd(name: str, out: str) -> List[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", out,
            os.path.join(CSRC_DIR, f"{name}.cu")]


def build(names: Iterable[str] = KERNEL_NAMES) -> Dict[str, str]:
    """Compile every named kernel that has no up-to-date library, in
    parallel. Returns name -> library path; raises with nvcc's output if
    any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for csrc/{name}.cu "
                          f"(rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, paths[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building it first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _loaded[name] = lib
        return lib
