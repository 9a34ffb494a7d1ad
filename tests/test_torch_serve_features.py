"""The port's radix prefix KV cache, chunked prefill and multi-tenant QoS
against the JAX package's, on the CPU in f32.

The model is ``tests/test_torch_serve.py``'s tiny NMT (a Flax
``transformer_nmt_tiny`` init with its Dense kernels scaled ×3, bridged with
``convert.params_from_flax``). One JAX Engine with the radix cache and
chunked prefill both armed serves a trace of repeated sources, greedy and
beam: every port configuration below — radix on and off, chunk sizes 1 and
3, dense and paged, QoS-tagged with preemptions — must give its tokens
exactly. Also here: the radix tree's pool accounting and eviction, the
chunk cursor, preemption's zero-loss audit, class-ordered admission and the
``serve`` CLI's new flags.
"""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from deeplearning_cfn_tpu.models.transformer_nmt import (
    transformer_nmt_tiny as jax_tiny)
from deeplearning_cfn_tpu.serve import Engine as JaxEngine
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.config import apply_overrides
from deeplearning_cfn_tpu_torch.convert import params_from_flax
from deeplearning_cfn_tpu_torch.models.transformer_nmt import (
    transformer_nmt_tiny as torch_tiny)
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.serve import Engine, RequestState
from deeplearning_cfn_tpu_torch.serve.loader import load_engine

VOCAB, SRC, MAX_LEN = 64, 8, 32
MODEL_KW = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=2,
                mlp_dim=64, max_len=MAX_LEN)
CFG_OVERRIDES = [
    "model.kwargs.hidden_size=32", "model.kwargs.num_layers=2",
    "model.kwargs.num_heads=2", "model.kwargs.mlp_dim=64",
    f"model.kwargs.max_len={MAX_LEN}", f"model.kwargs.vocab_size={VOCAB}",
    f"data.seq_len={SRC}", "train.dtype=float32",
]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One worker's share of the cores (torch would start a thread per core
    in every pytest-xdist worker)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _src(seed, n):
    rng = np.random.RandomState(seed)
    return [int(t) for t in rng.randint(3, VOCAB, size=n - 1)] + [2]


S0, S1, S2 = _src(1, 5), _src(2, 8), _src(3, 7)
# (id, src_ids, max_new_tokens, beam_size): repeats at budgets shorter
# than, equal to and longer than what the tree holds (instant completes,
# block-boundary resumes), a beam request on a cached source, and sources
# up to the full padding.
TRACE = [("a0", S0, 17, 1), ("a1", S1, 12, 1), ("b0", S2, 9, 2),
         ("a2", S0, 8, 1), ("a3", S0, 17, 1), ("a4", S1, 12, 1),
         ("a5", S0, 24, 1), ("b1", S0, 10, 2), ("a6", S1, 5, 1),
         ("a7", S2, 16, 1)]


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


def _serve(engine, trace, tags=None, sequential=False):
    """Submit the trace (``tags``: rid → (tenant, qos_class)), drain, and
    return rid → tokens. ``sequential`` drains after every submit."""
    for rid, src, budget, beam in trace:
        tenant, cls = (tags or {}).get(rid, (None, None))
        engine.submit(src, max_new_tokens=budget, beam_size=beam,
                      request_id=rid, tenant=tenant, qos_class=cls)
        if sequential:
            engine.run_until_drained()
    engine.run_until_drained()
    out = {}
    for rid, *_ in trace:
        req = engine.poll(rid)
        assert req.state.value == "done", (rid, req.state)
        out[rid] = list(req.tokens)
    return out


@pytest.fixture(scope="module")
def jax_tokens(weights):
    """The JAX Engine with the radix cache and 3-token chunks, requests
    served one at a time so that repeats really hit the tree."""
    jm, params, _ = weights
    eng = JaxEngine(jm, {"params": params}, capacity=4, max_src_len=SRC,
                    decode_window=4, kv_block_size=8, radix_cache=True,
                    prefill_chunk=3)
    out = _serve(eng, TRACE, sequential=True)
    assert eng.metrics.snapshot()["serve_radix_hits"] > 0
    assert len({tuple(t) for t in out.values()}) > 3, "degenerate outputs"
    return out


def _port_engine(weights, **kw):
    kw.setdefault("capacity", 4)
    kw.setdefault("max_src_len", SRC)
    kw.setdefault("decode_window", 4)
    tm = torch_tiny(**MODEL_KW)
    tm.load_state_dict(params_from_flax(weights[2]), strict=True)
    return Engine(tm.requires_grad_(False), **kw)


# -- the radix prefix KV cache ---------------------------------------------


@pytest.mark.parametrize("sequential", [True, False],
                         ids=["one-at-a-time", "concurrent"])
def test_radix_tokens_identical_to_cold_cache_and_jax(weights, jax_tokens,
                                                      sequential):
    cold = _serve(_port_engine(weights, kv_block_size=8), TRACE,
                  sequential=sequential)
    eng = _port_engine(weights, kv_block_size=8, radix_cache=True)
    warm = _serve(eng, TRACE, sequential=sequential)
    assert warm == cold == jax_tokens
    snap = eng.metrics.snapshot()
    if sequential:
        assert snap["serve_radix_hits"] > 0
        assert snap["serve_radix_instant_completes"] > 0
        assert snap["serve_radix_hit_tokens"] > 0
    # Ledger: every decoded row-step is goodput or waste; resumed tokens
    # were never decoded here.
    assert snap["serve_goodput_tokens"] + snap["serve_wasted_tokens"] \
        == snap["serve_tokens_generated"]


def test_radix_beams_bypass_the_tree(weights):
    trace = [("b0", S0, 6, 2), ("g0", S0, 6, 1), ("g1", S0, 6, 1),
             ("b1", S0, 6, 2)]
    cold = _serve(_port_engine(weights, kv_block_size=4), trace,
                  sequential=True)
    eng = _port_engine(weights, kv_block_size=4, radix_cache=True)
    assert _serve(eng, trace, sequential=True) == cold
    snap = eng.metrics.snapshot()
    # Two greedy admissions: one miss (it inserts), one cached reuse.
    assert snap["serve_radix_misses"] == 1
    assert snap["serve_radix_hits"] == 1
    assert eng.radix.source_count == 1


def test_radix_needs_the_paged_pool_and_a_colocated_engine(weights):
    with pytest.raises(ValueError, match="paged"):
        _port_engine(weights, radix_cache=True)
    with pytest.raises(ValueError, match="co-located"):
        _port_engine(weights, radix_cache=True, kv_block_size=8,
                     phase="prefill")


def test_radix_evicts_under_pool_pressure(weights):
    trace = [(f"p{i}", _src(10 + i, 6), 12, 1) for i in range(6)]
    cold = _serve(_port_engine(weights, capacity=1, kv_block_size=4,
                               kv_blocks=9), trace)
    eng = _port_engine(weights, capacity=1, kv_block_size=4, kv_blocks=9,
                       radix_cache=True)
    assert _serve(eng, trace) == cold
    assert eng.radix.evictions.get("pressure", 0) > 0
    alloc = eng.allocator
    assert alloc.committed_blocks + eng.radix.tree_exclusive_blocks(alloc) \
        <= alloc.usable_blocks
    assert eng.metrics.snapshot()["serve_radix_evictions"] > 0


def test_radix_refcounts_are_conserved_and_reset_empties_the_pool(weights):
    eng = _port_engine(weights, kv_block_size=8, radix_cache=True)
    _serve(eng, TRACE, sequential=True)
    alloc = eng.allocator
    refs = alloc.refcounts()
    assert len(refs) == eng.radix.block_count > 0
    assert all(c == 1 for c in refs.values())
    dropped = eng.reset_radix_cache()
    assert dropped > 0 and alloc.blocks_in_use == 0
    snap = eng.metrics.snapshot()
    assert snap["serve_radix_evictions_by_cause"]["reset"] == dropped
    assert snap["serve_radix_nodes"] == 0 and snap["serve_radix_blocks"] == 0


# -- chunked prefill ---------------------------------------------------------


@pytest.mark.parametrize("kv_block_size", [0, 8], ids=["dense", "paged"])
@pytest.mark.parametrize("chunk", [1, 3])
def test_chunked_prefill_tokens_identical_to_jax(weights, jax_tokens, chunk,
                                                 kv_block_size):
    eng = _port_engine(weights, kv_block_size=kv_block_size,
                       prefill_chunk=chunk)
    assert _serve(eng, TRACE) == jax_tokens
    for rid, src, *_ in TRACE:
        # Groups chunking in one tick share its quota.
        assert eng.poll(rid).prefill_chunks >= math.ceil(len(src) / chunk)
    # Every chunk tick that left a source incomplete ran one partial
    # encode; completions ran the full encode.
    assert eng.partial_encodes > 0
    snap = eng.metrics.snapshot()
    assert snap["serve_chunk_tokens"] == sum(len(t[1]) for t in TRACE)


def test_chunk_cursor_progresses_one_quota_per_tick(weights):
    eng = _port_engine(weights, capacity=2, decode_window=1, prefill_chunk=3)
    r = eng.submit(S1, max_new_tokens=4)
    ticks = math.ceil(len(S1) / 3)
    for t in range(ticks):
        assert eng.poll(r.id).state is (RequestState.QUEUED if t == 0
                                        else RequestState.PREFILLING)
        eng.step()
        group = eng._prefilling[0] if eng._prefilling else eng._groups[0]
        assert group.prefill_cursor == min(3 * (t + 1), len(S1))
        assert eng.active_requests == 1 and eng.active_rows == 1
    assert eng.poll(r.id).state is RequestState.RUNNING
    assert eng.partial_encodes == ticks - 1
    eng.run_until_drained()
    assert eng.poll(r.id).state is RequestState.DONE


def test_preempt_mid_prefill_loses_nothing(weights, jax_tokens):
    eng = _port_engine(weights, capacity=1, decode_window=1, prefill_chunk=3)
    batch = eng.submit(S0, max_new_tokens=17, request_id="a0",
                       tenant="t-b", qos_class="batch")
    eng.step()  # admitted, first chunk: mid-prefill on the only row
    assert eng.poll(batch.id).state is RequestState.PREFILLING
    lat = eng.submit(S2, max_new_tokens=16, request_id="a7",
                     tenant="t-a", qos_class="latency")
    eng.run_until_drained()
    assert eng.metrics.preemptions >= 1
    assert eng.metrics.qos_token_loss == 0
    assert eng.metrics.preempted_tokens_replayed == 0
    assert eng.poll(lat.id).tokens == jax_tokens["a7"]
    assert eng.poll(batch.id).tokens == jax_tokens["a0"]
    # Chunk ticks accumulate over both attempts.
    assert eng.poll(batch.id).prefill_chunks > math.ceil(len(S0) / 3)


# -- multi-tenant QoS ---------------------------------------------------------


@pytest.mark.parametrize("beam,kv_block_size",
                         [(1, 0), (1, 8), (2, 0), (2, 8)],
                         ids=["greedy-dense", "greedy-paged", "beam-dense",
                              "beam-paged"])
def test_preempt_resume_token_parity(weights, jax_tokens, beam,
                                     kv_block_size):
    """Batch-class work fills every row; a latency arrival evicts it, and
    the resumed streams finish token-identical to an unpreempted run."""
    kw = dict(capacity=2, decode_window=2, kv_block_size=kv_block_size)
    batch = [("a0", S0, 17, 1), ("a1", S1, 12, 1)] if beam == 1 \
        else [("b1", S0, 10, 2)]
    lat = ("a7", S2, 16, 1)
    base = _serve(_port_engine(weights, **kw), batch + [lat])
    eng = _port_engine(weights, **kw)
    for rid, src, budget, w in batch:
        eng.submit(src, max_new_tokens=budget, beam_size=w, request_id=rid,
                   tenant="t-b", qos_class="batch")
    for _ in range(2):  # the batch work decodes a little first
        eng.step()
    got = _serve(eng, [lat], tags={"a7": ("t-a", "latency")})
    got.update({rid: list(eng.poll(rid).tokens) for rid, *_ in batch})
    assert got == base
    assert all(got[rid] == jax_tokens[rid] for rid in got)
    assert eng.metrics.preemptions >= 1
    assert eng.metrics.qos_token_loss == 0
    if beam == 1:  # a beam group's tokens exist only once it finishes
        assert eng.metrics.preempted_tokens_replayed > 0
    assert any(eng.poll(rid).preemptions > 0 for rid, *_ in batch)
    snap = eng.metrics.snapshot()
    assert snap["serve_preemptions"] == eng.metrics.preemptions
    assert snap["serve_goodput_tokens"] + snap["serve_wasted_tokens"] \
        == snap["serve_tokens_generated"]


def test_untagged_traffic_never_preempts(weights):
    eng = _port_engine(weights, capacity=2)
    _serve(eng, TRACE[:4])
    assert not eng.queue.qos_active and eng.metrics.preemptions == 0
    snap = eng.metrics.snapshot()
    assert "serve_preemptions" not in snap
    assert "serve_qos_by_class" not in snap


def test_admission_is_class_ordered(weights):
    """With one row and both queued, the latency request is admitted
    before the batch request submitted ahead of it."""
    eng = _port_engine(weights, capacity=1, decode_window=1)
    b = eng.submit(S0, max_new_tokens=3, tenant="t-b", qos_class="batch")
    lt = eng.submit(S1, max_new_tokens=3, tenant="t-a", qos_class="latency")
    eng.step()
    assert eng.poll(lt.id).state is RequestState.RUNNING
    assert eng.poll(b.id).state is RequestState.QUEUED
    eng.run_until_drained()
    by_cls = eng.metrics.snapshot()["serve_qos_by_class"]
    assert by_cls["latency"]["completed"] == by_cls["batch"]["completed"] \
        == 1


# -- the serve CLI --------------------------------------------------------------


@pytest.mark.parametrize("flags,keys", [
    (["--speculate", "2", "--speculate-device", "--decode-window", "4"],
     ["serve_spec_accept_rate", "serve_spec_host_syncs_per_token"]),
    (["--radix-cache"], ["serve_radix_hits"]),
    (["--prefill-chunk", "3"], ["serve_chunk_tokens"]),
], ids=["speculate", "radix", "chunk"])
def test_cli_serve_new_flags_on_cpu(tmp_path, capsys, flags, keys):
    from deeplearning_cfn_tpu_torch.cli.main import main

    reqs = tmp_path / "reqs.jsonl"
    lines = [{"src_ids": S0, "id": "x", "max_new_tokens": 9},
             {"src_ids": S0, "id": "y", "max_new_tokens": 9,
              "tenant": "t-a", "qos_class": "latency"},
             {"src_ids": S1, "max_new_tokens": 6, "beam_size": 2,
              "tenant": "t-b", "qos_class": "batch"}]
    reqs.write_text("".join(json.dumps(ln) + "\n" for ln in lines))
    base = ["serve", "--preset", "transformer_nmt_wmt", "--accelerator",
            "cpu", "--requests", str(reqs), "--allow-init", "--slots", "2",
            "--kv-block-size", "8", *CFG_OVERRIDES, f"workdir={tmp_path}"]
    assert main(base) == 0
    plain = [json.loads(ln) for ln in capsys.readouterr()[0].splitlines()]
    metrics = tmp_path / "m.jsonl"
    assert main(base + flags + ["--metrics-path", str(metrics)]) == 0
    out = [json.loads(ln) for ln in capsys.readouterr()[0].splitlines()]
    assert [o["tokens"] for o in out] == [p["tokens"] for p in plain]
    assert all(o["state"] == "done" for o in out)
    final = json.loads(metrics.read_text().splitlines()[-1])
    assert all(final.get(k) is not None for k in keys), final
    assert final["serve_qos_by_class"]["latency"]["completed"] == 1


def test_cli_serve_refusals(tmp_path, capsys):
    from deeplearning_cfn_tpu_torch.cli.main import main

    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text(json.dumps({"src_ids": S0}) + "\n")
    base = ["serve", "--preset", "transformer_nmt_wmt", "--accelerator",
            "cpu", "--requests", str(reqs), "--allow-init", *CFG_OVERRIDES,
            f"workdir={tmp_path}"]
    for flags, says in ((["--speculate-device"], "speculate_gamma"),
                        (["--radix-cache", "--kv-block-size", "0"], "paged"),
                        (["--draft", "tiny-distilled"], "speculate_gamma"),
                        (["--speculate", "2", "--draft", "nope"], "nope"),
                        (["--speculate", "2", "--draft", "tiny-distilled"],
                         "vocab_size")):
        assert main(base + flags) == 1, flags
        assert says in capsys.readouterr()[1], flags


def test_loader_builds_a_seeded_draft_from_a_second_experiment(tmp_path):
    cfg = apply_overrides(get_preset("transformer_nmt_wmt"),
                          CFG_OVERRIDES + [f"workdir={tmp_path}"])
    draft_cfg = apply_overrides(
        get_preset("transformer_nmt_wmt"),
        CFG_OVERRIDES + ["model.kwargs.num_layers=1",
                         "model.kwargs.hidden_size=16", "train.seed=3",
                         f"workdir={tmp_path}/draft"])
    eng, _, step = load_engine(cfg, allow_init=True, device="cpu",
                               speculate_gamma=2, draft_cfg=draft_cfg,
                               kv_block_size=8)
    assert step == -1 and eng.draft_model.num_layers == 1
    plain, _, _ = load_engine(cfg, allow_init=True, device="cpu",
                              kv_block_size=8)
    trace = [(rid, src, budget, 1) for rid, src, budget, _ in TRACE[:4]]
    assert _serve(eng, trace) == _serve(plain, trace)
    assert eng.metrics.spec_accept_rate < 1.0
