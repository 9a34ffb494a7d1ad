"""Disaggregated prefill/decode serving in the port against the JAX package,
on the CPU in f32.

The handoff codec (bfloat16 leaves with ``ml_dtypes`` blocked, and bytes
that cross between the packages both ways), KV-handoff artifacts that cross
between a JAX engine and a port engine in both directions through a store
(greedy, beam 2 with a shared prefix block, the int8 KV pool, self-draft
speculation on the decode side), and the importer's refusals, each of which
raises the JAX engine's exception type before any state commits.

Weights: ``transformer_nmt_tiny``'s parameters drawn with numpy from a
seed (``torch_tiny_nmt.py``), Dense kernels ×3 so greedy streams do not
collapse onto one token, bridged with ``convert.params_from_flax``. Tolerance: token-identical; arrays exact.
"""

import os
import sys

import numpy as np
import pytest
import torch
from flax import traverse_util

from deeplearning_cfn_tpu.ckpt.store import MemoryObjectStore as JaxStore
from deeplearning_cfn_tpu.models.transformer_nmt import (
    transformer_nmt_tiny as jax_tiny)
from deeplearning_cfn_tpu.serve import handoff as jax_handoff
from deeplearning_cfn_tpu.serve.engine import Engine as JaxEngine
from deeplearning_cfn_tpu.serve.queue import (
    DeadlineExceededError as JaxDeadlineExceededError)
from deeplearning_cfn_tpu_torch.ckpt.store import MemoryObjectStore
from deeplearning_cfn_tpu_torch.convert import params_from_flax
from deeplearning_cfn_tpu_torch.models.transformer_nmt import (
    transformer_nmt_tiny as torch_tiny)
from deeplearning_cfn_tpu_torch.serve import handoff
from deeplearning_cfn_tpu_torch.serve.engine import Engine
from deeplearning_cfn_tpu_torch.serve.queue import DeadlineExceededError
from torch_tiny_nmt import tiny_nmt_params

VOCAB, SRC, MAX_LEN, MAX_NEW = 96, 8, 64, 6


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One worker's share of the cores (torch would start a thread per core
    in every pytest-xdist worker)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _trace():
    rng = np.random.RandomState(3)
    return [[int(t) for t in rng.randint(3, VOCAB, size=SRC - 1)] + [2]
            for _ in range(3)]


@pytest.fixture(scope="module")
def setup():
    jm = jax_tiny(vocab_size=VOCAB, max_len=MAX_LEN)
    flat = tiny_nmt_params(jm, SRC, kernel_scale=3.0)
    params = traverse_util.unflatten_dict(
        {tuple(n.split("/")): x for n, x in flat.items()})
    tm = torch_tiny(vocab_size=VOCAB, max_len=MAX_LEN)
    tm.load_state_dict(params_from_flax(flat), strict=True)
    tm.requires_grad_(False)

    built = {}

    def engine(pkg, phase, kv_block_size=4, capacity=2, **kw):
        """One engine of ``pkg`` per set of options, shared by every test
        that asks for it (each leaves it drained, and request ids name
        their test); an engine on its own clock is built anew."""
        key = (pkg, phase, kv_block_size, capacity, tuple(sorted(kw.items())))
        if "clock" in kw or key not in built:
            kw = {**dict(capacity=capacity, max_src_len=SRC,
                         queue_depth=16, default_max_new_tokens=MAX_NEW,
                         decode_window=2, kv_block_size=kv_block_size,
                         phase=phase), **kw}
            if pkg == "jax":
                eng = JaxEngine(jm, {"params": params}, **kw)
            else:
                eng = Engine(tm, **kw)
            if "clock" in kw:
                return eng
            built[key] = eng
        return built[key]

    trace = _trace()
    baselines = {}
    for name, kw in (("plain", {}), ("int8", {"kv_quant": "int8"})):
        eng = engine("jax", "both", **kw)
        rids = [eng.submit(s, max_new_tokens=MAX_NEW).id for s in trace]
        eng.run_until_drained()
        baselines[name] = [list(eng.poll(r).tokens) for r in rids]
    eng = engine("jax", "both", kv_block_size=1)
    rb = eng.submit(trace[1], max_new_tokens=MAX_NEW, beam_size=2)
    eng.run_until_drained()
    baselines["beam"] = [list(eng.poll(rb.id).tokens)]
    assert len({tuple(t) for t in baselines["plain"]}) > 1
    return {"engine": engine, "trace": trace, "baselines": baselines}


def _park(engine, src, **kw):
    req = engine.submit(src, max_new_tokens=MAX_NEW, **kw)
    engine.run_until_drained()
    assert engine.handoff_ready(req.id)
    return req


def _bf16_artifact(kv, enc):
    return {
        "meta": handoff.pack_meta(version=1, width=1, steps=1, budget=4,
                                  kv_block_size=4, model_max_len=64,
                                  max_src_len=8, enc_hid=16),
        "row_block_index": np.array([[0, 1]], np.int32),
        "kv_0": kv, "enc": enc,
        "src_mask": np.ones((8,), np.int32),
        "src_ids": np.arange(3, 11, dtype=np.int32),
        "tokens": np.array([7], np.int32),
        "prev": np.array([7], np.int32),
        "pos": np.array([1], np.int32),
        "deadline": np.array([np.nan], np.float64),
    }


# -- the handoff codec -------------------------------------------------------


def test_handoff_codec_round_trips_bf16_without_ml_dtypes(monkeypatch):
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    g = torch.Generator().manual_seed(0)
    kv = torch.randn((2, 2, 4, 3), generator=g).to(torch.bfloat16)
    enc = torch.randn((8, 16), generator=g).to(torch.bfloat16)
    store = MemoryObjectStore()
    nbytes = handoff.save_handoff(store, "handoff/bf16",
                                  _bf16_artifact(kv, enc))
    assert nbytes == len(store.get_bytes("handoff/bf16"))
    loaded = handoff.load_handoff(store, "handoff/bf16")
    for key, want in (("kv_0", kv), ("enc", enc)):
        assert loaded[key].dtype == torch.bfloat16
        assert torch.equal(loaded[key].view(torch.int16),
                           want.view(torch.int16))
    assert loaded["src_mask"].dtype == np.int32
    handoff.drop_handoff(store, "handoff/bf16")
    with pytest.raises(FileNotFoundError):
        handoff.load_handoff(store, "handoff/bf16")


def test_handoff_bytes_cross_between_the_packages():
    """The same bf16 artifact saved by either package gives the same bytes,
    and each package loads the other's with equal bits."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    kv = rng.standard_normal((2, 2, 4, 3)).astype(ml_dtypes.bfloat16)
    enc = rng.standard_normal((8, 16)).astype(ml_dtypes.bfloat16)
    jstore, pstore = JaxStore(), MemoryObjectStore()
    jax_handoff.save_handoff(jstore, "k", _bf16_artifact(kv, enc))
    handoff.save_handoff(pstore, "k", _bf16_artifact(
        handoff.as_tensor(kv), handoff.as_tensor(enc)))
    assert jstore.get_bytes("k") == pstore.get_bytes("k")
    # JAX's bytes in the port, the port's in JAX.
    pstore.put_bytes("j", jstore.get_bytes("k"))
    jstore.put_bytes("p", pstore.get_bytes("k"))
    in_port = handoff.load_handoff(pstore, "j")
    in_jax = jax_handoff.load_handoff(jstore, "p")
    for key, want in (("kv_0", kv), ("enc", enc)):
        bits = want.view(np.uint16)
        np.testing.assert_array_equal(
            in_port[key].view(torch.int16).numpy().view(np.uint16), bits)
        assert in_jax[key].dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(in_jax[key].view(np.uint16), bits)
    for key in ("row_block_index", "src_ids", "meta", "pos"):
        np.testing.assert_array_equal(in_port[key], in_jax[key])


# -- artifacts across the packages -------------------------------------------

# case -> (engine options, submit options, the baseline, decode options)
PAIRS = {
    "greedy": ({}, {}, "plain", {}),
    "beam_shared_prefix": ({"kv_block_size": 1}, {"beam_size": 2}, "beam",
                           {}),
    "int8_kv": ({"kv_quant": "int8"}, {}, "int8", {}),
    "decode_side_speculation": ({}, {}, "plain", {"speculate_gamma": 2}),
}
STORES = {"jax": (JaxStore, jax_handoff), "port": (MemoryObjectStore,
                                                   handoff)}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("case", list(PAIRS))
def test_artifacts_cross_between_the_packages(setup, case, direction):
    """A prefill engine of one package parks each request; its artifact is
    saved through that package's store codec, the bytes move to the other
    package's store and a decode engine of the other package imports them.
    The tokens equal the JAX package's co-located engine."""
    opts, submit, base, dec_opts = PAIRS[case]
    src_pkg, dst_pkg = direction.split("_to_")
    trace = setup["trace"][1:2] if case.startswith("beam") \
        else setup["trace"]
    pre = setup["engine"](src_pkg, "prefill", **opts)
    dec = setup["engine"](dst_pkg, "decode", **opts, **dec_opts)
    (src_store, src_codec), (dst_store, dst_codec) = \
        STORES[src_pkg], STORES[dst_pkg]
    out = []
    for i, src in enumerate(trace):
        req = _park(pre, src, request_id=f"{case}-{direction}-{i}",
                    **submit)
        art = pre.export_handoff(req.id)
        if case.startswith("beam"):
            rbi = np.asarray(art["row_block_index"])
            assert rbi[0, 0] == rbi[1, 0]      # one shared block, once
        a, b = src_store(), dst_store()
        nbytes = src_codec.save_handoff(a, f"h/{i}", art)
        b.put_bytes(f"h/{i}", a.get_bytes(f"h/{i}"))
        loaded = dst_codec.load_handoff(b, f"h/{i}")
        new = dec.import_handoff(loaded, request_id=f"{req.id}#a1",
                                 trace_id=req.id)
        if case.startswith("beam"):
            g = dec._groups[-1]
            first = [dec._blocks_bound[r][0] for r in g.rows]
            assert first[0] == first[1]
            assert dec.allocator.refcount(first[0]) == 2
        pre.release_handoff(req.id)
        dec.run_until_drained()
        assert nbytes > 0 and dec.poll(new.id).state.value == "done"
        out.append(list(dec.poll(new.id).tokens))
    assert out == setup["baselines"][base]
    assert pre.allocator.blocks_in_use == 0
    assert dec.allocator.blocks_in_use == 0
    if case == "decode_side_speculation":
        assert dec.metrics.snapshot()["serve_spec_proposed"] > 0


def test_parked_blocks_keep_what_the_prefill_step_wrote(setup):
    """Streams that wait parked while the prefill engine goes on stepping
    other requests keep their blocks bit for bit as their own prefill step
    wrote them (a parked row's stray writes go to the null block), so an
    int8 pair serves the trace token-identically to a co-located int8
    engine."""
    eng = setup["engine"]
    pre = eng("port", "prefill", kv_quant="int8", capacity=3)
    first, parked = None, []
    for src in setup["trace"]:
        parked.append(pre.submit(src, max_new_tokens=MAX_NEW).id)
        pre.step()  # admits and parks this one; earlier ones wait
        if first is None:
            first = pre.export_handoff(parked[0])
    again = pre.export_handoff(parked[0])
    kv = [k for k in first if k.startswith("kv_")]
    assert len(kv) == 8
    for k in kv:
        np.testing.assert_array_equal(again[k], first[k], err_msg=k)
    dec = eng("port", "decode", kv_quant="int8")
    got = []
    for rid in parked:
        new = dec.import_handoff(pre.export_handoff(rid), rid + "#a1")
        pre.release_handoff(rid)
        dec.run_until_drained()
        got.append(list(dec.poll(new.id).tokens))
    assert got == setup["baselines"]["int8"]


# -- refusals ----------------------------------------------------------------


def _refusal(setup, case, pkg):
    """(importer, artifact, retry engine) for one refusal case."""
    eng = setup["engine"]
    clock = FakeClock()
    opts = {"kv_quant": "int8"} if case == "cross_precision" else {}
    timed = {"clock": clock} if case == "deadline_in_transit" else {}
    pre = eng("port", "prefill", **timed, **opts)
    submit = {"deadline_s": 5.0} if timed else {}
    req = _park(pre, setup["trace"][0], request_id=f"refused-{case}-{pkg}",
                **submit)
    art = pre.export_handoff(req.id)
    importer = {
        "mismatched_geometry": lambda: eng(pkg, "decode", kv_block_size=2),
        "cross_precision": lambda: eng(pkg, "decode"),
        "deadline_in_transit": lambda: eng(pkg, "decode", clock=clock),
        # not the exporter itself, which holds the parked stream
        "into_a_prefill_engine": lambda: eng(pkg, "prefill", queue_depth=4),
        "into_a_dense_engine": lambda: eng(pkg, "both", kv_block_size=0),
    }[case]()
    if case == "deadline_in_transit":
        clock.t += 10.0
    return pre, req, art, importer, opts


@pytest.mark.parametrize("case", [
    "mismatched_geometry", "cross_precision", "deadline_in_transit",
    "into_a_prefill_engine", "into_a_dense_engine"])
def test_import_refusals_raise_the_jax_type_before_committing(setup, case):
    raised = {}
    for pkg in ("jax", "port"):
        pre, req, art, importer, opts = _refusal(setup, case, pkg)
        with pytest.raises(Exception) as info:
            importer.import_handoff(art, request_id=f"{req.id}#a1")
        raised[pkg] = type(info.value)
        if pkg == "port":
            # Nothing committed on the importer ...
            if importer.paged:
                assert importer.allocator.blocks_in_use == 0
                assert importer.allocator.committed_blocks == 0
            assert importer.active_rows == 0 and not importer._groups
            with pytest.raises(KeyError):
                importer.poll(f"{req.id}#a1")
        else:
            pre.release_handoff(req.id)
    names = {"jax": raised["jax"].__name__, "port": raised["port"].__name__}
    assert names["jax"] == names["port"], names
    if raised["jax"] is JaxDeadlineExceededError:
        assert raised["port"] is DeadlineExceededError
    # ... and the exporter's parked copy still resumes where it matches.
    if case != "deadline_in_transit":
        dec = setup["engine"]("port", "decode", **opts)
        new = dec.import_handoff(art, request_id=f"{req.id}#a2")
        pre.release_handoff(req.id)
        dec.run_until_drained()
        want = setup["baselines"]["int8" if opts else "plain"][0]
        assert list(dec.poll(new.id).tokens) == want
