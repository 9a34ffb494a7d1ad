"""The port's serving stack (deeplearning_cfn_tpu_torch.serve) against the
JAX package's, on the CPU in f32.

Both engines serve the same trace on the same weights (a Flax
``transformer_nmt_tiny`` init with its Dense kernels scaled ×3, bridged with
``convert.params_from_flax``). The JAX Engine runs the mixed trace once;
every port configuration — greedy, beam 3 and mixed traffic, dense and
paged KV, decode windows 1 and 4 — must give the identical tokens for every
request (continuous batching is a pure scheduling optimisation, so a
request's tokens do not depend on its neighbours). Also here: the scheduler
invariants of tests/test_serve.py on the port, serving a checkpoint the JAX
package saved, the ``serve`` CLI, the import guard, and the device rules.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from deeplearning_cfn_tpu.ckpt.checkpoint import save_checkpoint
from deeplearning_cfn_tpu.models.transformer_nmt import (
    transformer_nmt_tiny as jax_tiny)
from deeplearning_cfn_tpu.serve import Engine as JaxEngine
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.config import apply_overrides
from deeplearning_cfn_tpu_torch.convert import params_from_flax
from deeplearning_cfn_tpu_torch.models.transformer_nmt import (
    transformer_nmt_tiny as torch_tiny)
from deeplearning_cfn_tpu_torch.ops import attention as tattn
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.runtime.platform import resolve_device
from deeplearning_cfn_tpu_torch.serve import (Engine, OverloadError,
                                              RequestState)
from deeplearning_cfn_tpu_torch.serve.loader import load_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, SRC, MAX_LEN = 64, 8, 32
MODEL_KW = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=2,
                mlp_dim=64, max_len=MAX_LEN)
# The same architecture through the preset path (transformer_nmt, f32).
CFG_OVERRIDES = [
    "model.kwargs.hidden_size=32", "model.kwargs.num_layers=2",
    "model.kwargs.num_heads=2", "model.kwargs.mlp_dim=64",
    f"model.kwargs.max_len={MAX_LEN}", f"model.kwargs.vocab_size={VOCAB}",
    f"data.seq_len={SRC}", "train.dtype=float32",
]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _src(seed, n):
    rng = np.random.RandomState(seed)
    return [int(t) for t in rng.randint(3, VOCAB, size=n - 1)] + [2]


# Request trace: (id, src_ids, max_new_tokens, beam_size).
GREEDY = [(f"g{i}", _src(i, 3 + i % 6), 5 + (3 * i) % 17, 1)
          for i in range(8)]
BEAM = [(f"b{i}", _src(100 + i, 4 + i), 6 + 4 * i, 3) for i in range(3)]
MIXED = [GREEDY[0], BEAM[0], GREEDY[1], GREEDY[2], BEAM[1], GREEDY[3],
         GREEDY[4], BEAM[2], GREEDY[5], GREEDY[6], GREEDY[7]]
TRAFFIC = {"greedy": GREEDY, "beam": BEAM, "mixed": MIXED}


@pytest.fixture(scope="module")
def weights():
    jm = jax_tiny(**MODEL_KW)
    ids = np.zeros((1, SRC), np.int32)
    params = jm.init(jax.random.PRNGKey(0), ids, np.ones_like(ids), ids,
                     train=False)["params"]
    flat = {n: np.asarray(x) * (3.0 if n.endswith("kernel") else 1.0)
            for n, x in flatten_with_names(params)[0]}
    params = traverse_util.unflatten_dict(
        {tuple(n.split("/")): x for n, x in flat.items()})
    return jm, params, flat


def _serve(engine, trace):
    for rid, src, budget, beam in trace:
        engine.submit(src, max_new_tokens=budget, beam_size=beam,
                      request_id=rid)
    engine.run_until_drained()
    out = {}
    for rid, *_ in trace:
        req = engine.poll(rid)
        assert req.state.value == "done", (rid, req.state)
        out[rid] = list(req.tokens)
    return out


@pytest.fixture(scope="module")
def jax_tokens(weights):
    jm, params, _ = weights
    eng = JaxEngine(jm, {"params": params}, capacity=4, max_src_len=SRC,
                    decode_window=4, kv_block_size=8, prefix_cache_size=8)
    return _serve(eng, MIXED)


def _port_model(flat):
    tm = torch_tiny(**MODEL_KW)
    tm.load_state_dict(params_from_flax(flat), strict=True)
    tm.requires_grad_(False)
    return tm


def _port_engine(flat, **kw):
    kw.setdefault("capacity", 4)
    kw.setdefault("max_src_len", SRC)
    return Engine(_port_model(flat), **kw)


# -- token parity with the JAX Engine ---------------------------------------


@pytest.mark.parametrize("window", [1, 4])
@pytest.mark.parametrize("kv_block_size", [0, 8])
@pytest.mark.parametrize("traffic", sorted(TRAFFIC))
def test_engine_tokens_identical_to_jax_engine(weights, jax_tokens, traffic,
                                               kv_block_size, window):
    _, _, flat = weights
    eng = _port_engine(flat, decode_window=window,
                       kv_block_size=kv_block_size, prefix_cache_size=8)
    got = _serve(eng, TRAFFIC[traffic])
    for rid, toks in got.items():
        assert toks == jax_tokens[rid], rid
    assert len({tuple(t) for t in got.values()}) > 1, "degenerate outputs"
    # CPU tensors take the plain attention: no kernel launch counted.
    assert tattn.flash_attention_forward.launches == 0
    # The launch audit's tallies: the warmup encode plus at least one
    # admission encode, and one decode step per generated greedy token at
    # least.
    assert eng.encoder_forwards >= 2
    assert eng.decoder_steps >= max(len(t) for t in got.values())


def test_prefix_cache_hits_keep_tokens_and_skip_the_encoder(weights,
                                                            jax_tokens):
    _, _, flat = weights
    eng = _port_engine(flat, decode_window=4, kv_block_size=8,
                       prefix_cache_size=8)
    first = _serve(eng, GREEDY[:3])
    forwards = eng.encoder_forwards
    again = [(rid + "x", src, budget, beam)
             for rid, src, budget, beam in GREEDY[:3]]
    second = _serve(eng, again)
    assert eng.encoder_forwards == forwards, "hits must skip the encoder"
    assert eng.metrics.prefix_hits == 3
    for rid, *_ in GREEDY[:3]:
        assert first[rid] == second[rid + "x"] == jax_tokens[rid]


# -- scheduler invariants (tests/test_serve.py, on the port) -----------------


def test_slot_exclusivity_under_churn(weights):
    eng = _port_engine(weights[2], capacity=3, queue_depth=32)
    reqs = [eng.submit(_src(i, 5), max_new_tokens=2 + i % 4)
            for i in range(10)]
    steps = 0
    while eng.queue.depth > 0 or eng.active_requests:
        eng.step()
        steps += 1
        owners = eng.slot_view()
        running = {g.req.id: g.rows for g in eng._groups}
        claimed = [r for rows in running.values() for r in rows]
        assert len(claimed) == len(set(claimed)), "row in two groups"
        for rid, rows in running.items():
            assert all(owners[r] == rid for r in rows)
        for r, owner in enumerate(owners):
            assert owner is None or r in running[owner]
        assert steps < 200
    assert all(eng.poll(r.id).state is RequestState.DONE for r in reqs)


def test_admission_is_fifo_and_only_into_free_rows(weights):
    eng = _port_engine(weights[2], capacity=2, queue_depth=8)
    big = eng.submit(_src(1, 5), max_new_tokens=4, beam_size=2)
    small = eng.submit(_src(2, 5), max_new_tokens=2)
    eng.step()
    assert eng.poll(big.id).state is RequestState.RUNNING
    assert eng.poll(small.id).state is RequestState.QUEUED
    assert eng.active_rows == 2
    eng.run_until_drained()
    assert eng.poll(big.id).state is RequestState.DONE
    assert eng.poll(small.id).state is RequestState.DONE


def test_overload_and_unplaceable_requests(weights):
    eng = _port_engine(weights[2], capacity=2, queue_depth=2)
    eng.submit(_src(1, 5), max_new_tokens=2)
    eng.submit(_src(2, 5), max_new_tokens=2)
    with pytest.raises(OverloadError):
        eng.submit(_src(3, 5), max_new_tokens=2)
    assert eng.metrics.rejected == 1
    with pytest.raises(ValueError):
        eng.submit(_src(1, 5), beam_size=3)  # wider than the slot table
    with pytest.raises(ValueError):
        eng.submit([5] * (SRC + 1), max_new_tokens=2)
    eng.run_until_drained()


def test_cancel_frees_slot_within_one_step(weights):
    clock = FakeClock()
    eng = _port_engine(weights[2], clock=clock, capacity=1)
    a = eng.submit(_src(1, 5), max_new_tokens=30)
    eng.step()
    assert eng.poll(a.id).state is RequestState.RUNNING
    b = eng.submit(_src(2, 5), max_new_tokens=2)
    assert eng.cancel(a.id) is True
    eng.step()
    assert eng.poll(a.id).state is RequestState.CANCELLED
    assert eng.poll(b.id).state is RequestState.RUNNING
    assert eng.slot_view() == [b.id]
    assert eng.poll(a.id).tokens, "partial output is kept"
    eng.run_until_drained()
    assert eng.poll(b.id).state is RequestState.DONE


def test_deadline_expires_running_request_within_one_step(weights):
    clock = FakeClock()
    eng = _port_engine(weights[2], clock=clock, capacity=1)
    a = eng.submit(_src(1, 5), max_new_tokens=30, deadline_s=5.0)
    eng.step()
    assert eng.poll(a.id).state is RequestState.RUNNING
    clock.advance(10.0)
    b = eng.submit(_src(2, 5), max_new_tokens=2)
    eng.step()
    assert eng.poll(a.id).state is RequestState.EXPIRED
    assert eng.slot_view() == [b.id]
    assert eng.metrics.expired == 1
    eng.run_until_drained()


@pytest.mark.parametrize("option,value", [
    ("speculate_gamma", 2), ("radix_cache", True), ("prefill_chunk", 4),
    ("quantize", "int8"), ("kv_quant", "int8"), ("phase", "prefill"),
])
def test_out_of_slice_options_name_their_roadmap_item(weights, option,
                                                      value):
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.6"):
        _port_engine(weights[2], **{option: value})


# -- checkpoints, loader, CLI -----------------------------------------------


def test_serves_a_jax_checkpoint_token_identically(weights, jax_tokens,
                                                   tmp_path):
    _, params, _ = weights
    cfg = apply_overrides(get_preset("transformer_nmt_wmt"),
                          CFG_OVERRIDES + [f"workdir={tmp_path}"])
    ckpt_dir = os.path.join(str(tmp_path), "transformer_nmt_wmt", "ckpt")
    save_checkpoint(ckpt_dir, 7, {"params": params})
    eng, _, step = load_engine(cfg, capacity=4, decode_window=4,
                               kv_block_size=8, prefix_cache_size=8,
                               device="cpu")
    assert step == 7
    got = _serve(eng, MIXED)
    assert got == {rid: jax_tokens[rid] for rid in got}


def test_loader_seeded_init_is_deterministic(tmp_path):
    cfg = apply_overrides(get_preset("transformer_nmt_wmt"),
                          CFG_OVERRIDES + [f"workdir={tmp_path}"])
    with pytest.raises(FileNotFoundError):
        load_engine(cfg, device="cpu")
    runs = []
    for _ in range(2):
        eng, _, step = load_engine(cfg, allow_init=True, device="cpu")
        assert step == -1
        runs.append(_serve(eng, GREEDY[:2]))
    assert runs[0] == runs[1]


def test_cli_serve_on_cpu(tmp_path, capsys):
    from deeplearning_cfn_tpu_torch.cli.main import main

    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text(
        json.dumps({"src_ids": [5, 9, 2], "id": "raw",
                    "max_new_tokens": 4}) + "\n"
        + json.dumps({"src_ids": [7, 8, 9, 2], "beam_size": 2,
                      "max_new_tokens": 5}) + "\n")
    base = ["serve", "--preset", "transformer_nmt_wmt", "--accelerator",
            "cpu", "--requests", str(reqs), *CFG_OVERRIDES,
            f"workdir={tmp_path}"]
    assert main(base) == 1  # no checkpoint, no --allow-init
    capsys.readouterr()
    metrics = tmp_path / "m.jsonl"
    assert main(base + ["--allow-init", "--metrics-path", str(metrics)]) == 0
    out, err = capsys.readouterr()
    lines = [json.loads(ln) for ln in out.splitlines() if ln.strip()]
    assert len(lines) == 2 and lines[0]["id"] == "raw"
    assert all(ln["state"] == "done" for ln in lines)
    assert "drained in" in err and "2 done" in err
    final = json.loads(metrics.read_text().splitlines()[-1])
    assert final["serve_completed"] == 2 and final["drained"] is True


# -- import guard and device rules ------------------------------------------


def _port_modules():
    """Every module of the port, discovered (so a later slice's modules are
    covered without an edit here)."""
    import pkgutil

    import deeplearning_cfn_tpu_torch as pkg

    return [pkg.__name__] + sorted(
        m.name for m in pkgutil.walk_packages(pkg.__path__,
                                              pkg.__name__ + "."))


def test_port_imports_neither_jax_nor_the_jax_package():
    """A fresh interpreter starts without jax; importing every port module
    must leave it (and the JAX package) unloaded — and PIL, which the card's
    machine does not have (only ``prepare_imagenet`` imports it, inside)."""
    modules = _port_modules()
    assert {"deeplearning_cfn_tpu_torch.train.trainer",
            "deeplearning_cfn_tpu_torch.data.pipeline",
            "deeplearning_cfn_tpu_torch.metrics.bleu",
            "deeplearning_cfn_tpu_torch.models.resnet",
            "deeplearning_cfn_tpu_torch.data.imagenet",
            "deeplearning_cfn_tpu_torch.dataio"} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'flax', 'deeplearning_cfn_tpu.', 'PIL.')) "
        "or m in ('deeplearning_cfn_tpu', 'PIL'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_asking_for_the_card_without_one_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        resolve_device("gpu")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("tpu")
