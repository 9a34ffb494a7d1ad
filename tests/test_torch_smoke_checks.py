"""The limits ``chip_smoke.py`` holds the attention kernels to at GPT's long
causal rows (``scaled_error``: relative norm error <= 1e-2, largest error
<= 2e-2 of the largest |ref|) pass bf16 rounding and fail a kernel that
skips one 64-key tile or one 64-row query tile.

A missing tile is built from the port's plain versions on the CPU, at
[1, 2, 1024, 1024, 64] causal with bf16 inputs: the forward and dQ without
one KV tile, dK/dV without one query tile (the last of the 16-step loop
among them). A bf16-rounded plain result stands in for a correct kernel.
"""

import math
import os

import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning_cfn_tpu_torch.ops import attention as attn

S, TILE = 1024, 64


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One worker's share of the cores (torch would start a thread per core
    in every pytest-xdist worker)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def inputs():
    """q, k, v, dO [1, 2, 1024, 64] bf16 (randn, as the smoke phases make
    them), the plain forward's lse and delta = rowsum(dO · O)."""
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 2, S, 64),
                                                        dtype=np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    scale = 1.0 / math.sqrt(64)
    out = attn.attention_reference(q, k, v, causal=True)
    lse = attn._reference_lse(q, k, None, True, scale)
    delta = (do.float() * out.float()).sum(-1)
    return q, k, v, do, lse, delta, True, scale


def _exact(inputs):
    """The forward, dK, dV and dQ in f64 from the same bf16 inputs."""
    q, k, v, do, lse, delta, _, scale = inputs
    q, k, v, do = (t.double() for t in (q, k, v, do))
    s = q @ k.transpose(-1, -2) * scale
    live = torch.ones(S, S, dtype=torch.bool).tril()
    p = torch.softmax(s.masked_fill(~live, -math.inf), dim=-1)
    out = p @ v
    ds = p * (do @ v.transpose(-1, -2) - delta.double()[..., None])
    return dict(out=out, dk=scale * ds.transpose(-1, -2) @ q,
                dv=p.transpose(-1, -2) @ do, dq=scale * ds @ k)


def test_bf16_rounding_passes(inputs):
    """The plain versions, rounded to bf16 as the kernels' outputs are,
    against f64: every output within the limits."""
    exact = _exact(inputs)
    q, k, v = inputs[:3]
    dk, dv = attn.flash_bwd_dkdv_reference(*inputs)
    got = dict(out=attn.attention_reference(q, k, v, causal=True), dk=dk,
               dv=dv, dq=attn.flash_bwd_dq_reference(*inputs))
    for name, value in got.items():
        assert value.dtype == torch.bfloat16
        e = chip_smoke.scaled_error(value, exact[name])
        assert e["ok"], (name, e)


@pytest.mark.parametrize("tile", [0, 8, 15])
def test_forward_missing_one_kv_tile_fails(inputs, tile):
    q, k, v = inputs[:3]
    ref = attn.attention_reference(q, k, v, causal=True)
    keys = torch.arange(S)
    gone = (keys >= tile * TILE) & (keys < (tile + 1) * TILE)
    # Rows that see only the missing tile keep it (they would see no key).
    bias = torch.where(gone, -1e30, 0.0)[None, None, None, :]
    got = attn.attention_reference(q, k, v, bias, causal=True)
    if tile == 0:
        got[:, :, :TILE] = ref[:, :, :TILE]
    e = chip_smoke.scaled_error(got, ref)
    assert not e["ok"], e


@pytest.mark.parametrize("tile", [0, 8, 15])
def test_dkdv_missing_one_query_tile_fails(inputs, tile):
    """dK/dV whose loop over query tiles skipped one: that tile's dO and
    delta rows contribute nothing."""
    q, k, v, do, lse, delta, causal, scale = inputs
    rk, rv = attn.flash_bwd_dkdv_reference(*inputs)
    rows = slice(tile * TILE, (tile + 1) * TILE)
    do_cut, delta_cut = do.clone(), delta.clone()
    do_cut[:, :, rows] = 0
    delta_cut[:, :, rows] = 0
    dk, dv = attn.flash_bwd_dkdv_reference(q, k, v, do_cut, lse, delta_cut,
                                           causal, scale)
    for name, got, ref in (("dk", dk, rk), ("dv", dv, rv)):
        e = chip_smoke.scaled_error(got, ref)
        assert not e["ok"], (name, e)


@pytest.mark.parametrize("tile", [0, 8, 15])
def test_dq_missing_one_kv_tile_fails(inputs, tile):
    """dQ whose loop over key tiles skipped one."""
    q, k, v, do, lse, delta, causal, scale = inputs
    ref = attn.flash_bwd_dq_reference(*inputs)
    _, ds = attn._bwd_ds(*inputs)
    ds[..., tile * TILE:(tile + 1) * TILE] = 0
    got = (scale * ds @ k.float()).to(q.dtype)
    e = chip_smoke.scaled_error(got, ref)
    assert not e["ok"], e
