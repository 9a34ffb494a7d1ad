"""The kernel build's cache key (deeplearning_cfn_tpu_torch.kernels).

A library under ``_build/`` is reused only while its name's hash still
covers what it was built from: the ``.cu`` source, every ``csrc/*.cuh``
header it includes, and the compiler flags. These tests need no ``nvcc``:
they point ``CSRC_DIR`` at a copy of the sources and compare library paths.
The last one reads the sources for the variant numbers the wrappers pass.
"""

import os
import re
import shutil

import pytest

from deeplearning_cfn_tpu_torch import kernels
from deeplearning_cfn_tpu_torch.ops import attention


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC_DIR, src)
    monkeypatch.setattr(kernels, "CSRC_DIR", str(src))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "_build"))
    return src


def _append(path, text):
    with open(path, "a") as fh:
        fh.write(text)


@pytest.mark.parametrize("name", kernels.KERNEL_NAMES)
def test_library_path_is_stable_and_follows_the_source(csrc, name):
    first = kernels._lib_path(name)
    assert kernels._lib_path(name) == first
    assert os.path.dirname(first) == kernels.BUILD_DIR
    _append(csrc / f"{name}.cu", "\n// edited\n")
    assert kernels._lib_path(name) != first


def test_library_path_follows_an_included_header(csrc):
    """Editing the shared header rebuilds every kernel that includes it, and
    only those."""
    (csrc / "no_header.cu").write_text("// includes no local header\n")
    names = (*kernels.KERNEL_NAMES, "no_header")
    users = [n for n in names
             if any(p.endswith("hopper.cuh") for p in kernels.sources(n))]
    assert set(users) == set(kernels.KERNEL_NAMES)
    before = {n: kernels._lib_path(n) for n in names}
    _append(csrc / "hopper.cuh", "\n// edited\n")
    for name in names:
        changed = kernels._lib_path(name) != before[name]
        assert changed == (name in users), name


def test_headers_are_followed_through_other_headers(csrc):
    (csrc / "inner.cuh").write_text("#pragma once\n")
    _append(csrc / "hopper.cuh", '\n#include "inner.cuh"\n')
    assert kernels.sources("flash_attn_fwd")[-1] == str(csrc / "inner.cuh")
    before = kernels._lib_path("flash_attn_fwd")
    _append(csrc / "inner.cuh", "// edited\n")
    assert kernels._lib_path("flash_attn_fwd") != before


def test_library_path_follows_the_flags(csrc, monkeypatch):
    """An extra flag (an -I or -lcuda) both reaches nvcc and renames the
    library."""
    before = {n: kernels._lib_path(n) for n in kernels.KERNEL_NAMES}
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels, "NVCC_FLAGS", [*kernels.NVCC_FLAGS, "-lcuda"])
    for name in kernels.KERNEL_NAMES:
        assert kernels._lib_path(name) != before[name]
        cmd = kernels._nvcc_cmd(name, "out.so")
        assert cmd[0] == "nvcc" and "-lcuda" in cmd
        assert cmd[-1] == str(csrc / f"{name}.cu")


@pytest.mark.parametrize("name,wrapper", [
    ("flash_attn_fwd", attention.flash_attention_forward),
    ("flash_attn_bwd_dkdv", attention.flash_attn_bwd_dkdv),
    ("flash_attn_bwd_dq", attention.flash_attn_bwd_dq)])
def test_variant_codes_match_the_c_sources(name, wrapper):
    """The wrapper passes its variant to the C entry point as an int; each
    source's ``enum Variant`` says what the ints mean there, and names every
    variant the wrapper counts."""
    with open(os.path.join(kernels.CSRC_DIR, f"{name}.cu")) as fh:
        enum = re.search(r"enum Variant \{([^}]*)\}", fh.read()).group(1)
    codes = {}
    for entry in enum.split(","):
        key, value = entry.split("=")
        codes[key.strip()[1:].lower()] = int(value)
    assert set(codes) == set(wrapper.variant_launches)
    assert codes == {k: attention._VARIANT_CODES[k] for k in codes}
