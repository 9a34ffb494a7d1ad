"""The port's network serving plane (deeplearning_cfn_tpu_torch.net) against
the JAX package's, on the CPU.

Every frame type encodes to the JAX package's bytes (a KV-handoff frame
with bfloat16 leaves included), a loopback ``ReplicaServer`` +
``RemoteReplica`` pair on a port engine with converted weights gives the
JAX loopback's tokens, and one cross-process fleet — ``cli fleet up --net
--accelerator cpu``, its two server children SIGKILLed in mid-stream —
drops nothing and matches the in-process port engine of the same seeded
recipe.
Last, the new modules import in a fresh interpreter without ``jax``, the
JAX package or ``ml_dtypes``. Tolerance: token-identical; bytes exact.
"""

import importlib
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from flax import traverse_util

from deeplearning_cfn_tpu.models.transformer_nmt import (
    transformer_nmt_tiny as jax_tiny)
from deeplearning_cfn_tpu.serve.engine import Engine as JaxEngine
from deeplearning_cfn_tpu_torch.convert import params_from_flax
from deeplearning_cfn_tpu_torch.models.transformer_nmt import (
    transformer_nmt_tiny as torch_tiny)
from deeplearning_cfn_tpu_torch.serve.engine import Engine
from torch_tiny_nmt import tiny_nmt_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": "deeplearning_cfn_tpu", "port": "deeplearning_cfn_tpu_torch"}
VOCAB, SRC, MAX_LEN = 96, 8, 64


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One worker's share of the cores (torch would start a thread per core
    in every pytest-xdist worker)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _mod(pkg, name):
    return importlib.import_module(f"{PACKAGES[pkg]}.{name}")


def _trace(n, seed=0):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(3, VOCAB, size=SRC - 1)] + [2]
            for _ in range(n)]


# -- frames ------------------------------------------------------------------


def _bf16_artifact(pkg):
    import ml_dtypes

    rng = np.random.default_rng(1)
    kv = rng.standard_normal((2, 2, 4, 3)).astype(ml_dtypes.bfloat16)
    enc = rng.standard_normal((8, 16)).astype(ml_dtypes.bfloat16)
    if pkg == "port":
        as_tensor = _mod("port", "serve.handoff").as_tensor
        kv, enc = as_tensor(kv), as_tensor(enc)
    pack_meta = _mod(pkg, "serve.handoff").pack_meta
    return {
        "meta": pack_meta(version=1, width=1, steps=1, budget=4,
                          kv_block_size=4, model_max_len=64, max_src_len=8,
                          enc_hid=16),
        "row_block_index": np.array([[0, 1]], np.int32),
        "kv_0": kv, "enc": enc, "src_mask": np.ones((8,), np.int32),
        "src_ids": np.arange(3, 11, dtype=np.int32),
        "tokens": np.array([7], np.int32), "prev": np.array([7], np.int32),
        "pos": np.array([1], np.int32),
        "deadline": np.array([np.nan], np.float64),
    }


def _frames(pkg):
    codec = _mod(pkg, "net.codec")
    queue = _mod(pkg, "serve.queue")
    router = _mod(pkg, "fleet.router")
    ft = codec.FrameType
    body = codec.pack_artifact(_bf16_artifact(pkg))
    req = {"id": "a", "state": "running", "tokens": [1, 2],
           "submitted_at": 1.5, "admitted_at": None}
    headers = {
        ft.SUBMIT: {"rid": "r-1", "src_ids": [3, 7, 11], "beam_size": 2},
        ft.SUBMIT_OK: {"rid": "r-1", "req": req},
        ft.TOKENS: {"req": req},
        ft.CANCEL: {"rid": "r-2", "request_id": "a"},
        ft.CANCEL_OK: {"rid": "r-2", "ok": True},
        ft.HEALTH: {"rid": "r-3"},
        ft.HEALTH_OK: {"rid": "r-3", "health": {"queue_depth": 0}},
        ft.HANDOFF_EXPORT: {"rid": "r-4", "request_id": "a"},
        ft.HANDOFF_EXPORT_OK: {"rid": "r-4"},
        ft.HANDOFF_IMPORT: {"rid": "r-5", "request_id": "a#a1",
                            "trace_id": "a"},
        ft.HANDOFF_IMPORT_OK: {"rid": "r-5", "req": req},
        ft.HANDOFF_RELEASE: {"rid": "r-6", "request_id": "a"},
        ft.HANDOFF_RELEASE_OK: {"rid": "r-6"},
        ft.DRAIN: {"rid": "r-7"},
        ft.DRAIN_OK: {"rid": "r-7"},
    }
    bodies = {ft.HANDOFF_EXPORT_OK: body, ft.HANDOFF_IMPORT: body}
    out = [codec.encode_frame(t, h, bodies.get(t, b""))
           for t, h in sorted(headers.items())]
    errors = [
        queue.OverloadError(3, 4, retry_after_s=0.25),
        queue.RateLimitError("batch", "t", retry_after_s=0.5, depth=1,
                             max_depth=2),
        queue.DeadlineExceededError("late"),
        router.FleetOverloadError(5, 6, retry_after_s=1.0,
                                  per_replica={"r0": 1.0}),
        router.NoReplicasError("none"),
        _mod(pkg, "serve.handoff").HandoffCorruptError("bad"),
        KeyError("unknown"), ValueError("bad submit"),
    ]
    out += [codec.encode_frame(ft.ERROR, codec.error_header(e, rid="r-8"))
            for e in errors]
    return out


def test_every_frame_encodes_to_jax_bytes():
    jax_frames, port_frames = _frames("jax"), _frames("port")
    assert len(port_frames) == len(jax_frames) == 23
    for i, (p, j) in enumerate(zip(port_frames, jax_frames)):
        assert p == j, f"frame {i} differs"
    # The handoff body decodes on either side with equal bits.
    port_codec, jax_codec = _mod("port", "net.codec"), _mod("jax",
                                                           "net.codec")
    body = jax_codec.pack_artifact(_bf16_artifact("jax"))
    in_port = port_codec.unpack_artifact(body)
    in_jax = jax_codec.unpack_artifact(
        port_codec.pack_artifact(_bf16_artifact("port")))
    for key in ("kv_0", "enc"):
        assert in_port[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            in_port[key].view(torch.int16).numpy().view(np.uint16),
            in_jax[key].view(np.uint16))


# -- loopback ----------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    jm = jax_tiny(vocab_size=VOCAB, max_len=MAX_LEN)
    flat = tiny_nmt_params(jm, SRC, kernel_scale=3.0)
    tm = torch_tiny(vocab_size=VOCAB, max_len=MAX_LEN)
    tm.load_state_dict(params_from_flax(flat), strict=True)
    kw = dict(capacity=2, max_src_len=SRC, queue_depth=4,
              default_max_new_tokens=5, decode_window=4)
    params = traverse_util.unflatten_dict(
        {tuple(n.split("/")): x for n, x in flat.items()})
    return {"jax": lambda: JaxEngine(jm, {"params": params}, **kw),
            "port": lambda: Engine(tm.requires_grad_(False), **kw)}


def _loopback_tokens(pkg, engine, sock_dir):
    server_mod = _mod(pkg, "net.server")
    client_mod = _mod(pkg, "net.client")
    addr = f"unix://{sock_dir}/{pkg}.sock"
    server = server_mod.ReplicaServer(engine, addr, replica_id=f"loop-{pkg}")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    replica = client_mod.RemoteReplica(
        f"loop-{pkg}", addr, connect_retry_deadline_s=30.0).connect()
    try:
        reqs = [replica.submit(src, max_new_tokens=5, request_id=f"l{i}")
                for i, src in enumerate(_trace(3, seed=4))]
        for _ in range(2000):
            if all(r.state.value == "done" for r in reqs):
                break
            replica.step()
        assert replica.health()["replica"] == f"loop-{pkg}"
        return [(r.state.value, list(r.tokens)) for r in reqs]
    finally:
        replica.drain()
        replica.close()
        thread.join(timeout=10)


def test_loopback_tokens_equal_jax(engines, tmp_path):
    got = {pkg: _loopback_tokens(pkg, engines[pkg](), tmp_path)
           for pkg in PACKAGES}
    assert got["port"] == got["jax"]
    assert all(state == "done" for state, _ in got["port"])
    assert len({tuple(t) for _, t in got["port"]}) > 1


# -- a process fleet ---------------------------------------------------------


def test_sigkill_mid_stream_drops_nothing(tmp_path, monkeypatch):
    """``cli fleet up --net --accelerator cpu`` (two server children behind
    unix sockets), driven by ``chip_smoke.py``'s own phase 27e: both children
    are SIGKILLed in mid-stream with streams in flight. The router evacuates
    and replays them, the supervisor restarts each child, the restarted
    children reach ready, serve what is left and exit cleanly, nothing
    drops, and the tokens equal the in-process engine of the same seeded
    recipe."""
    import chip_smoke

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = chip_smoke.fleet_up_net(str(tmp_path), accelerator="cpu",
                                  n_requests=24, slots=2, budget=24)
    assert out["done"] == out["token_identical"] == "24/24"
    assert set(out["killed"]) == {"replica-0", "replica-1"}
    for rep in out["replicas"].values():
        assert rep["outcomes"][0] == "crash"
        assert rep["restarted"]["launches"] == 0  # the CPU launches nothing
    assert sum(r["restarted"]["steps"] for r in out["replicas"].values()) > 0


def test_new_modules_import_without_jax_or_ml_dtypes():
    modules = ["deeplearning_cfn_tpu_torch.serve.handoff",
               "deeplearning_cfn_tpu_torch.serve.engine",
               "deeplearning_cfn_tpu_torch.fleet",
               "deeplearning_cfn_tpu_torch.fleet.rollout",
               "deeplearning_cfn_tpu_torch.net",
               "deeplearning_cfn_tpu_torch.net.bench",
               "deeplearning_cfn_tpu_torch.net.server",
               "deeplearning_cfn_tpu_torch.cli.main"]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "from deeplearning_cfn_tpu_torch.serve import handoff\n"
        "import numpy as np, torch\n"
        "raw = np.arange(8, dtype=np.uint8).reshape(2, 4)\n"
        "assert handoff.decode_extension_array(raw, 'bfloat16').shape "
        "== (2, 2)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'ml_dtypes', "
        "'deeplearning_cfn_tpu', 'flax') or m.startswith(('jax.', "
        "'ml_dtypes.', 'deeplearning_cfn_tpu.', 'flax.')))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
