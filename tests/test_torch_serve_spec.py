"""Speculative decoding in the port's serving stack against the JAX
package's, on the CPU in f32.

The model is ``tests/test_torch_serve.py``'s tiny NMT (a Flax
``transformer_nmt_tiny`` init with its Dense kernels scaled ×3, bridged with
``convert.params_from_flax``); the distinct draft is a shrunk Flax init of
its own. ``decode_span_at`` / ``decode_span_paged`` must give the JAX
methods' logits (within 1e-5 of the largest) and leave the same cache
contents, with spans running past ``max_len`` (the dense drop rule and the
paged null-block rule). The engine, with speculation on the host path and
on the device chain, dense and paged, self-draft and distinct draft, must
give the JAX Engine's tokens exactly.
"""

import os

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from deeplearning_cfn_tpu.models.transformer_nmt import (
    transformer_nmt_tiny as jax_tiny)
from deeplearning_cfn_tpu.serve import Engine as JaxEngine
from deeplearning_cfn_tpu.serve.bench import _fixed_trace
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.convert import params_from_flax
from deeplearning_cfn_tpu_torch.models.decoding import EOS_ID
from deeplearning_cfn_tpu_torch.models.transformer_nmt import (
    transformer_nmt_tiny as torch_tiny)
from deeplearning_cfn_tpu_torch.serve import Engine, RequestState
from deeplearning_cfn_tpu_torch.serve.loader import (DRAFT_PRESETS,
                                                     distilled_draft)

VOCAB, SRC, MAX_LEN = 64, 8, 32
MODEL_KW = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=2,
                mlp_dim=64, max_len=MAX_LEN)
DRAFT_KW = dict(vocab_size=VOCAB, hidden_size=16, num_layers=1, num_heads=2,
                mlp_dim=32, max_len=MAX_LEN)


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


# (id, src_ids, max_new_tokens): budgets up to 21, so spans reach well
# into the cache and several windows hit the budget mid-window.
GREEDY = [(f"g{i}", _src(i, 3 + i % 6), 5 + (3 * i) % 17) for i in range(8)]


def _flax_init(kw, seed, scale):
    jm = jax_tiny(**kw)
    ids = np.zeros((1, SRC), np.int32)
    params = jm.init(jax.random.PRNGKey(seed), ids, np.ones_like(ids), ids,
                     train=False)["params"]
    flat = {n: np.asarray(x) * (scale if n.endswith("kernel") else 1.0)
            for n, x in flatten_with_names(params)[0]}
    params = traverse_util.unflatten_dict(
        {tuple(n.split("/")): x for n, x in flat.items()})
    return jm, params, flat


def _port_model(flat, kw):
    tm = torch_tiny(**kw)
    tm.load_state_dict(params_from_flax(flat), strict=True)
    tm.requires_grad_(False)
    return tm


@pytest.fixture(scope="module")
def weights():
    return _flax_init(MODEL_KW, 0, 3.0)


@pytest.fixture(scope="module")
def draft_weights():
    return _flax_init(DRAFT_KW, 7, 3.0)


def _serve(engine, trace, **submit_kw):
    for rid, src, budget in trace:
        engine.submit(src, max_new_tokens=budget, request_id=rid,
                      **submit_kw)
    engine.run_until_drained()
    out = {}
    for rid, *_ in trace:
        req = engine.poll(rid)
        assert req.state.value == "done", (rid, req.state)
        out[rid] = list(req.tokens)
    return out


@pytest.fixture(scope="module")
def jax_tokens(weights, draft_weights):
    """The JAX Engine's tokens: speculation on its host path with the
    distinct draft (γ=3, paged). JAX's own tests hold these equal to plain
    greedy."""
    jm, params, _ = weights
    dm, dparams, _ = draft_weights
    eng = JaxEngine(jm, {"params": params}, capacity=4, max_src_len=SRC,
                    kv_block_size=8, speculate_gamma=3, draft_model=dm,
                    draft_variables={"params": dparams})
    return _serve(eng, GREEDY)


def _port_engine(weights, draft_weights=None, **kw):
    kw.setdefault("capacity", 4)
    kw.setdefault("max_src_len", SRC)
    if draft_weights is not None:
        kw["draft_model"] = _port_model(draft_weights[2], DRAFT_KW)
    return Engine(_port_model(weights[2], MODEL_KW), **kw)


# -- decode_span_* against JAX ----------------------------------------------


def _jax_cache_leaves(cache):
    """(layer, 'cached_key'|'cached_value', array) in layer order."""
    return [(i, name, cache[f"dec_{i}"]["self_attn"][name])
            for i in range(MODEL_KW["num_layers"])
            for name in ("cached_key", "cached_value")]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_span_matches_jax_logits_and_cache(weights, paged):
    """Spans of S=4 from per-row positions, some running past max_len (the
    dense rows' dropped positions, the paged rows' null-block writes) and
    into unbound table entries: logits within 1e-5 of the largest and
    every cache entry (the null block's aside) equal to JAX's."""
    jm, params, flat = weights
    tm = _port_model(flat, MODEL_KW)
    b, s, bs = 4, 4, 8
    rng = np.random.RandomState(0)
    src = np.stack([np.pad(_src(20 + i, 5 + i), (0, SRC - 5 - i))
                    for i in range(b)]).astype(np.int32)
    mask = (src != 0).astype(np.int32)
    tgt = rng.randint(3, VOCAB, size=(b, s)).astype(np.int32)
    pos = np.array([6, 0, 29, 31], np.int32)  # rows 2, 3 run past 32
    enc = np.array(jm.apply({"params": params}, src, mask,
                            method=jm.encode))
    if paged:
        # Row 0's position 8.. falls in an unbound entry (the null block).
        tables = np.array([[1, 0, 0, 0], [2, 3, 4, 5], [6, 7, 8, 9],
                           [10, 11, 12, 13]], np.int32)
        cache = jm.init(jax.random.PRNGKey(0), np.zeros((b, 1), np.int32),
                        enc, mask, np.zeros((b,), np.int32), tables,
                        num_blocks=17, block_size=bs,
                        method=jm.decode_step_paged)["cache"]
        tcache = tm.init_paged_cache(17, bs)
    else:
        cache = jm.init(jax.random.PRNGKey(0), np.zeros((b, 1), np.int32),
                        enc, mask, np.zeros((b,), np.int32),
                        method=jm.decode_step_at)["cache"]
        tcache = tm.init_cache(b)
    # Random prior contents, the same on both sides.
    for i, name, leaf in _jax_cache_leaves(cache):
        vals = rng.standard_normal(leaf.shape).astype(np.float32)
        cache[f"dec_{i}"]["self_attn"][name] = jax.numpy.asarray(vals)
        tcache[i][0 if name == "cached_key" else 1].copy_(
            torch.from_numpy(vals))
    variables = {"params": params, "cache": cache}
    if paged:
        logits, mut = jm.apply(variables, tgt, enc, mask, pos, tables,
                               num_blocks=17, block_size=bs,
                               method=jm.decode_span_paged,
                               mutable=["cache"])
    else:
        logits, mut = jm.apply(variables, tgt, enc, mask, pos,
                               method=jm.decode_span_at, mutable=["cache"])
    t = lambda a: torch.as_tensor(np.asarray(a)).long()  # noqa: E731
    with torch.no_grad():
        if paged:
            got = tm.decode_span_paged(t(tgt), torch.from_numpy(enc),
                                       t(mask), t(pos), t(tables), tcache)
        else:
            got = tm.decode_span_at(t(tgt), torch.from_numpy(enc), t(mask),
                                    t(pos), tcache)
    ref = np.asarray(logits)
    assert got.shape == ref.shape == (b, s, VOCAB)
    tol = 1e-5 * np.abs(ref).max()
    assert np.abs(got.numpy() - ref).max() <= tol
    for i, name, leaf in _jax_cache_leaves(mut["cache"]):
        mine = tcache[i][0 if name == "cached_key" else 1].numpy()
        want = np.asarray(leaf)
        if paged:  # the null block takes the dropped writes in any order
            mine, want = mine[1:], want[1:]
        np.testing.assert_allclose(mine, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_decode_span_of_one_is_the_single_step(weights):
    """S = 1 is the single-position step, bit for bit."""
    _, _, flat = weights
    tm = _port_model(flat, MODEL_KW)
    src = torch.tensor([_src(3, SRC)] * 2)
    mask = torch.ones_like(src)
    pos = torch.tensor([4, 31])
    ids = torch.tensor([[5], [9]])
    with torch.no_grad():
        enc = tm.encode(src, mask)
        c1, c2 = tm.init_cache(2), tm.init_cache(2)
        a = tm.decode_step_at(ids, enc, mask, pos, c1)
        b = tm.decode_span_at(ids, enc, mask, pos, c2)
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for p, q in zip(c1, c2)
               for x, y in zip(p, q))


# -- the engine against the JAX Engine --------------------------------------


@pytest.mark.parametrize("draft", ["self", "shrunk"])
@pytest.mark.parametrize("kv_block_size", [0, 8], ids=["dense", "paged"])
@pytest.mark.parametrize("window", [1, 4])
@pytest.mark.parametrize("gamma", [1, 3])
def test_spec_engine_tokens_identical_to_jax_engine(
        weights, draft_weights, jax_tokens, gamma, window, kv_block_size,
        draft):
    eng = _port_engine(weights,
                       draft_weights if draft == "shrunk" else None,
                       speculate_gamma=gamma, decode_window=window,
                       kv_block_size=kv_block_size)
    got = _serve(eng, GREEDY)
    assert got == jax_tokens
    rate = eng.metrics.spec_accept_rate
    if draft == "self":
        assert rate == pytest.approx(1.0)
    else:
        assert rate is not None and rate < 1.0  # the draft disagrees
    assert eng.metrics.spec_tokens_per_target_step >= 1.0
    # The launch audit: every verify ran after γ+1 draft steps, and no
    # single-position target step ran.
    assert eng.draft_steps == (gamma + 1) * eng.verify_steps > 0
    assert eng.decoder_steps == 0
    assert eng.draft_encoder_forwards == (0 if draft == "self"
                                          else eng.encoder_forwards)
    if kv_block_size:
        assert eng.allocator.blocks_in_use == 0  # leak-free drain


@pytest.mark.parametrize("draft", ["self", "shrunk"])
@pytest.mark.parametrize("kv_block_size", [0, 8], ids=["dense", "paged"])
def test_spec_device_chain_tokens_identical_to_jax_engine(
        weights, draft_weights, jax_tokens, kv_block_size, draft):
    eng = _port_engine(weights,
                       draft_weights if draft == "shrunk" else None,
                       speculate_gamma=3, speculate_device=True,
                       decode_window=4, kv_block_size=kv_block_size)
    assert _serve(eng, GREEDY) == jax_tokens
    assert eng.metrics.spec_windows_per_chain > 1.0
    if kv_block_size:
        assert eng.allocator.blocks_in_use == 0


def test_device_chain_makes_fewer_host_syncs(weights):
    kw = dict(speculate_gamma=4, decode_window=4, kv_block_size=8)
    host = _port_engine(weights, **kw)
    dev = _port_engine(weights, speculate_device=True, **kw)
    assert _serve(host, GREEDY) == _serve(dev, GREEDY)
    h = host.metrics.spec_host_syncs_per_token
    d = dev.metrics.spec_host_syncs_per_token
    assert h is not None and d is not None and d < h


@pytest.mark.parametrize("device_chain", [False, True],
                         ids=["host", "chain"])
@pytest.mark.parametrize("kv_block_size", [0, 8], ids=["dense", "paged"])
def test_spec_acceptance_truncates_at_the_budget(weights, kv_block_size,
                                                 device_chain):
    """γ=4 against a 3-token budget: emission stops token by token at the
    budget, exactly as the plain engine does."""
    trace = [(rid, src, 3) for rid, src, _ in GREEDY]
    plain = _serve(_port_engine(weights, kv_block_size=kv_block_size),
                   trace)
    spec = _serve(_port_engine(weights, speculate_gamma=4,
                               speculate_device=device_chain,
                               decode_window=4,
                               kv_block_size=kv_block_size), trace)
    assert spec == plain
    assert all(len(t) <= 3 for t in spec.values())


def _scripted(eng, windows):
    """Replace the draft and the verify with scripted [capacity, γ]
    proposals and [capacity, γ+1] target tokens, one pair per window."""
    calls = iter(windows)
    cap, g = eng.capacity, eng.speculate_gamma
    state = {}

    def propose(prev, pos, active, tables):
        props, state["tgt"] = next(calls)
        return torch.tensor(props).expand(cap, g).clone()

    def verify(tgt_in, pos, tables):
        return torch.tensor(state["tgt"]).expand(cap, g + 1).clone()

    eng._draft_propose = propose
    eng._verify = verify


def test_spec_draft_eos_mid_window(weights):
    """An accepted EOS mid-window ends the request there: the rest of the
    window is discarded and the row released."""
    eng = _port_engine(weights, capacity=2, speculate_gamma=4)
    req = eng.submit(_src(3, 5), max_new_tokens=8)
    _scripted(eng, [([7, EOS_ID, 7, 7], [7, EOS_ID, 7, 7, 7])])
    eng.step()
    assert eng.poll(req.id).tokens == [7, EOS_ID]
    assert eng.poll(req.id).state is RequestState.DONE
    assert eng.active_rows == 0 and int(eng._pos[0]) == 0
    assert eng.metrics.spec_tokens_per_target_step == pytest.approx(2.0)


def test_spec_device_chain_eos_in_a_later_window(weights):
    """Window 0 rejects its first proposal (so the second, which the target
    agrees with, is not accepted either: one correction token); window 1
    accepts one whose target token is EOS: one host sync for 3 tokens."""
    eng = _port_engine(weights, capacity=2, speculate_gamma=2,
                       speculate_device=True, decode_window=2)
    req = eng.submit(_src(3, 5), max_new_tokens=8)
    _scripted(eng, [([9, 7], [7, 7, 7]), ([7, 5], [7, EOS_ID, 7])])
    eng.step()
    assert eng.poll(req.id).tokens == [7, 7, EOS_ID]
    assert eng.poll(req.id).state is RequestState.DONE
    assert eng.metrics.spec_windows_per_chain == pytest.approx(2.0)
    assert eng.metrics.spec_host_syncs_per_token == pytest.approx(1 / 3)


def test_spec_falls_back_for_beams_and_deadlines(weights, jax_tokens):
    """A beam group or a running deadline sends the tick to the plain
    paths; the greedy requests still get the JAX Engine's tokens, and the
    beam the plain engine's."""
    trace = GREEDY[:5]
    beam_src = _src(100, 6)
    plain = _port_engine(weights)
    plain.submit(beam_src, max_new_tokens=10, beam_size=2, request_id="b")
    plain.run_until_drained()
    eng = _port_engine(weights, speculate_gamma=2, decode_window=4)
    eng.submit(beam_src, max_new_tokens=10, beam_size=2, request_id="b")
    for i, (rid, src, budget) in enumerate(trace):
        eng.submit(src, max_new_tokens=budget, request_id=rid,
                   deadline_s=60.0 if i % 2 else None)
    eng.run_until_drained()
    for rid, *_ in trace:
        assert eng.poll(rid).tokens == jax_tokens[rid], rid
    assert eng.poll("b").tokens == plain.poll("b").tokens
    assert eng.decoder_steps > 0 and eng.verify_steps > 0


def test_spec_engine_validates_its_options(weights, draft_weights):
    with pytest.raises(ValueError, match="speculate_gamma"):
        _port_engine(weights, speculate_gamma=-1)
    with pytest.raises(ValueError, match="speculate_device"):
        _port_engine(weights, speculate_device=True)
    short = _port_model(
        _flax_init({**DRAFT_KW, "max_len": 16}, 7, 1.0)[2],
        {**DRAFT_KW, "max_len": 16})
    with pytest.raises(ValueError, match="max_len"):
        _port_engine(weights, speculate_gamma=2, draft_model=short)
    other = _port_model(
        _flax_init({**DRAFT_KW, "vocab_size": 96}, 7, 1.0)[2],
        {**DRAFT_KW, "vocab_size": 96})
    with pytest.raises(ValueError, match="vocab_size"):
        _port_engine(weights, speculate_gamma=2, draft_model=other)
    # Without speculation the engine keeps no draft state.
    eng = _port_engine(weights, draft_weights)
    assert eng.draft_model is None and eng._draft_cache is None
    assert not any(k.startswith("serve_spec_")
                   for k in eng.metrics.snapshot())


def test_distilled_draft_serves_token_identically():
    """The committed distilled draft (read from the port's own copy of the
    npz) against the random-init tiny teacher it was distilled from: the
    plain engine's tokens, at a real accept rate."""
    assert "tiny-distilled" in DRAFT_PRESETS
    with pytest.raises(ValueError, match="tiny-distilled"):
        distilled_draft("no-such-preset", device="cpu")
    src_len = 8
    jm = jax_tiny(vocab_size=96, max_len=64)
    ids = np.zeros((1, src_len), np.int32)
    params = jm.init(jax.random.PRNGKey(0), ids, np.ones_like(ids), ids,
                     train=False)["params"]
    flat = {n: np.asarray(x) for n, x in flatten_with_names(params)[0]}

    def model():
        tm = torch_tiny(vocab_size=96, max_len=64)
        tm.load_state_dict(params_from_flax(flat), strict=True)
        return tm.requires_grad_(False)

    trace = [(f"t{i}", [int(t) for t in s], 8)
             for i, s in enumerate(_fixed_trace(4, src_len, 96, seed=0))]
    kw = dict(capacity=2, max_src_len=src_len, queue_depth=8)
    plain = _serve(Engine(model(), **kw), trace)
    spec = Engine(model(), speculate_gamma=4,
                  draft_model=distilled_draft(device="cpu"), **kw)
    assert _serve(spec, trace) == plain
    rate = spec.metrics.spec_accept_rate
    assert rate is not None and 0.5 <= rate <= 1.0
