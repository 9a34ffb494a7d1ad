"""The port's int8 serving engine and the rest of the JAX ``Engine``'s
surface (``swap_variables``, the brownout knobs, text requests) against the
JAX package's, on the CPU in f32.

The engines serve ``tests/test_serve.py``'s scheduler model (a Flax
``transformer_nmt_tiny``: vocab 64, hidden 32, 1 layer, seed 0), bridged
with ``convert.params_from_flax``; the mirrored JAX tests are
``tests/test_serve.py``'s int8 and KV-quant tests and ``tests/test_radix.py``'s
kv-quant parity and weight-swap tests. The int8 engines must give the JAX
int8 engines' tokens exactly (greedy and beams), and ``cli serve --vocab``
the JAX CLI's tokens and text on the same checkpoint.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from deeplearning_cfn_tpu.data.bpe import NMT_SPECIALS, train_bpe
from deeplearning_cfn_tpu.models.transformer_nmt import (
    transformer_nmt_tiny as jax_tiny)
from deeplearning_cfn_tpu.serve import Engine as JaxEngine
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.convert import params_from_flax
from deeplearning_cfn_tpu_torch.models.decoding import EOS_ID
from deeplearning_cfn_tpu_torch.models.transformer_nmt import (
    transformer_nmt_tiny as torch_tiny)
from deeplearning_cfn_tpu_torch.serve import Engine, RequestState
from deeplearning_cfn_tpu_torch.serve.queue import OverloadError

VOCAB, SRC, MAX_LEN = 64, 8, 32
MODEL_KW = dict(vocab_size=VOCAB, hidden_size=32, num_layers=1, num_heads=2,
                mlp_dim=64, max_len=MAX_LEN)
DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


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
def sched():
    """(JAX model, JAX variables, the port's f32 state_dict)."""
    model = jax_tiny(**MODEL_KW)
    ids = np.zeros((1, SRC), np.int32)
    params = model.init(jax.random.PRNGKey(0), ids, np.ones_like(ids), ids,
                        train=False)["params"]
    flat = {n: np.asarray(x) for n, x in flatten_with_names(params)[0]}
    return model, {"params": params}, params_from_flax(flat)


def _port(sched, **kw):
    tm = torch_tiny(**MODEL_KW)
    tm.load_state_dict(sched[2], strict=True)
    kw.setdefault("capacity", 2)
    kw.setdefault("max_src_len", SRC)
    return Engine(tm.requires_grad_(False), **kw)


def _jax(sched, **kw):
    kw.setdefault("capacity", 2)
    kw.setdefault("max_src_len", SRC)
    return JaxEngine(sched[0], sched[1], **kw)


def _src(seed, n=5):
    rng = np.random.RandomState(seed)
    return [int(t) for t in rng.randint(3, VOCAB, size=n - 1)] + [EOS_ID]


def _decode_all(eng, trace):
    """Submit (src, budget, beam) triples with backpressure, drain, and
    return the per-trace-index token lists (every request done)."""
    ids = []
    for src, budget, beam in trace:
        while True:
            try:
                ids.append(eng.submit(src, max_new_tokens=budget,
                                      beam_size=beam).id)
                break
            except OverloadError:
                eng.step()
    eng.run_until_drained()
    assert all(eng.poll(i).state.value == "done" for i in ids)
    return [list(eng.poll(i).tokens) for i in ids]


# A mixed trace: greedy requests of several budgets and two beam groups.
MIXED = [(_src(0), 8, 1), (_src(1, 7), 6, 2), (_src(2), 10, 1),
         (_src(3, 6), 5, 1), (_src(4), 7, 2), (_src(5, 8), 9, 1)]


# -- token parity with the JAX int8 engines ----------------------------------


@pytest.mark.parametrize("quantize,kv_quant", [
    ("int8", ""), ("", "int8"), ("int8", "int8")],
    ids=["weights", "kv", "both"])
def test_int8_engine_tokens_identical_to_jax_int8_engine(sched, quantize,
                                                         kv_quant):
    kw = dict(quantize=quantize, kv_quant=kv_quant, kv_block_size=4,
              decode_window=4, prefix_cache_size=4, queue_depth=16)
    want = _decode_all(_jax(sched, **kw), MIXED)
    got = _decode_all(_port(sched, **kw), MIXED)
    assert got == want
    assert len({tuple(t) for t in got}) > 1, "degenerate outputs"


def test_kv_quant_window_invariance(sched):
    """Windows 1 and 2 give the same tokens: the requantizing write and the
    dequantizing gather commute with window fusion."""
    trace = [(_src(i), 8, 1) for i in range(4)]
    outs = [_decode_all(_port(sched, kv_block_size=4, kv_quant="int8",
                              decode_window=w, queue_depth=8), trace)
            for w in (1, 2)]
    assert outs[0] == outs[1]


def test_kv_quant_beam_cow_preserves_scales(sched):
    """Beam forks copy tail blocks WITH their scales (block size 2, so a
    fork copies a partial tail at most steps): the int8 beam matches the
    f32-KV beam choice on this trace and is window invariant, as in JAX."""
    def run(kv_quant, w):
        eng = _port(sched, kv_block_size=2, kv_quant=kv_quant,
                    decode_window=w, queue_depth=4)
        toks = _decode_all(eng, [(_src(9), 6, 2)])
        assert eng.allocator.blocks_in_use == 0
        return toks

    fp32 = run("", 1)
    assert run("int8", 1) == fp32
    assert run("int8", 2) == fp32


def test_beam_fork_copies_every_pool_tensor(sched, monkeypatch):
    """The copy-on-write fork moves codes and scales of the same blocks
    (a fork that dropped the scales would decode the copy wrong)."""
    eng = _port(sched, kv_block_size=2, kv_quant="int8", queue_depth=4)
    seen = []
    orig = eng._fork_beam_blocks

    def fork(g, beam_idx, copy_dst, copy_src):
        orig(g, beam_idx, copy_dst, copy_src)
        seen.extend(zip(copy_dst, copy_src))

    monkeypatch.setattr(eng, "_fork_beam_blocks", fork)
    req = eng.submit(_src(9), max_new_tokens=6, beam_size=2)
    copies = 0
    while eng.poll(req.id).state is not RequestState.DONE:
        seen.clear()
        eng.step()
        # The fresh tail blocks were handed out before the tick's frees,
        # so no source block was written after its copy.
        for dst, src in seen:
            for layer in eng.cache:
                for t in layer:
                    assert torch.equal(t[dst], t[src])
        copies += len(seen)
    assert copies > 0
    assert eng.allocator.blocks_in_use == 0


def test_int8_weights_kv_and_device_spec_match_plain_int8(sched):
    kw = dict(kv_block_size=4, kv_quant="int8", quantize="int8",
              queue_depth=8)
    trace = [(_src(i), 8, 1) for i in range(4)]
    plain = _decode_all(_port(sched, **kw), trace)
    eng = _port(sched, speculate_gamma=2, speculate_device=True,
                decode_window=2, **kw)
    assert _decode_all(eng, trace) == plain
    assert eng.metrics.spec_host_syncs_per_token is not None
    assert eng.verify_steps > 0
    # Self-draft runs the target's int8 weights over a float pool.
    assert eng.draft_model is eng.model
    assert eng._draft_cache[0][0].dtype == torch.float32
    assert eng.cache[0][0].dtype == torch.int8


def test_int8_engine_spec_parity_as_jax(sched):
    """tests/test_serve.py's quantized-engine test: speculation on the int8
    engine is token-identical to the plain int8 engine."""
    srcs = [(_src(i), 8, 1) for i in range(4)]
    plain = _decode_all(_port(sched, quantize="int8"), srcs)
    spec = _decode_all(_port(sched, quantize="int8", speculate_gamma=2),
                       srcs)
    assert spec == plain


# -- radix parity (tests/test_radix.py) --------------------------------------


def _parity_trace():
    s0, s1 = _src(1), _src(2)
    return [(s0, 8, 1), (s1, 6, 1), (s0, 4, 1), (s0, 8, 1),
            (s1, 6, 1), (s0, 12, 1), (s1, 3, 1), (s0, 8, 1)]


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_radix_token_parity_vs_cold_cache(sched, kv_quant):
    kw = dict(queue_depth=32, kv_block_size=4, kv_quant=kv_quant)
    cold = _decode_all(_port(sched, **kw), _parity_trace())
    eng = _port(sched, radix_cache=True, **kw)
    assert _decode_all(eng, _parity_trace()) == cold
    snap = eng.metrics.snapshot()
    assert snap["serve_radix_hits"] > 0
    assert snap["serve_radix_instant_completes"] > 0
    assert snap["serve_radix_hit_tokens"] > 0


# -- swap_variables ----------------------------------------------------------


def test_swap_variables_requantizes_and_keeps_the_draft_alias(sched):
    """An f32 state in, int8 inside; the self-draft still is the target,
    and serving goes on with the same tokens (tests/test_serve.py)."""
    eng = _port(sched, quantize="int8", speculate_gamma=2)
    before = _decode_all(eng, [(_src(4), 6, 1)])
    weight = eng.model.dec[0].self_attn.query.weight
    eng.swap_variables(sched[2])
    assert eng.model.state_dict()["dec.0.self_attn.query.weight"].dtype \
        == torch.int8
    assert eng.model.dec[0].self_attn.query.weight is weight  # in place
    assert eng.draft_model is eng.model
    assert _decode_all(eng, [(_src(4), 6, 1)]) == before


def test_swap_variables_loads_new_weights_and_drops_the_caches(sched):
    """A swap to other weights gives those weights' tokens (a fresh engine
    on them), and drops the encoder prefix cache and every radix block."""
    other = {k: v * 1.5 if v.ndim == 2 else v for k, v in sched[2].items()}
    eng = _port(sched, kv_block_size=4, radix_cache=True,
                prefix_cache_size=4, queue_depth=8)
    _decode_all(eng, [(_src(1), 8, 1)])
    assert eng.radix.source_count == 1 and len(eng._prefix) == 1
    eng.swap_variables(other)
    assert eng.radix.source_count == 0
    assert eng.allocator.blocks_in_use == 0
    assert len(eng._prefix) == 0
    fresh = _port((None, None, other), kv_block_size=4, queue_depth=8)
    trace = [(_src(1), 8, 1), (_src(2), 6, 1)]
    assert _decode_all(eng, trace) == _decode_all(fresh, trace)


def test_swap_variables_refuses_a_busy_engine_with_the_jax_message(sched):
    je, te = _jax(sched), _port(sched)
    for eng in (je, te):
        eng.submit(_src(1), max_new_tokens=4)
    with pytest.raises(RuntimeError) as want:
        je.swap_variables(sched[1])
    with pytest.raises(RuntimeError) as got:
        te.swap_variables(sched[2])
    assert str(got.value) == str(want.value)
    assert "idle engine" in str(got.value)


# -- brownout knobs ----------------------------------------------------------


def test_brownout_knobs_change_no_token(sched, monkeypatch):
    """``_degrade_no_spec`` runs no speculative step; ``_degrade_window_cap``
    bounds every fused window; neither changes a token. The JAX engine's
    ``_plan_window`` reads the same cap."""
    trace = [(_src(i), 9, 1) for i in range(4)]
    kw = dict(decode_window=4, speculate_gamma=2, queue_depth=8)
    plain = _decode_all(_port(sched, decode_window=4, queue_depth=8), trace)
    eng = _port(sched, **kw)
    eng._degrade_no_spec = True
    eng._degrade_window_cap = 2
    windows = []
    orig = eng._fused_step
    monkeypatch.setattr(eng, "_fused_step",
                        lambda k: windows.append(k) or orig(k))
    assert _decode_all(eng, trace) == plain
    assert eng.verify_steps == eng.draft_steps == 0
    assert windows and max(windows) == 2
    # Lifted, the engine speculates again with the same tokens.
    eng._degrade_no_spec = False
    eng._degrade_window_cap = None
    assert _decode_all(eng, trace) == plain
    assert eng.verify_steps > 0
    je = _jax(sched, decode_window=4)
    te = _port(sched, decode_window=4)
    for cap in (None, 1, 3, 8):
        je._degrade_window_cap = te._degrade_window_cap = cap
        assert te._plan_window() == je._plan_window()


# -- loader and cli serve: text requests -------------------------------------


def _sliver_lines(lang):
    with open(os.path.join(DATA_DIR, f"wmt_sliver.{lang}")) as fh:
        return [ln.strip() for ln in fh if ln.strip()]


@pytest.fixture(scope="module")
def served_checkpoint(tmp_path_factory):
    """A JAX checkpoint of a tiny NMT over a BPE vocab, the vocab file and
    the overrides both CLIs take."""
    from deeplearning_cfn_tpu.ckpt.checkpoint import save_checkpoint

    root = tmp_path_factory.mktemp("served")
    bpe = train_bpe(_sliver_lines("de") + _sliver_lines("en"),
                    vocab_size=300, specials=NMT_SPECIALS)
    vocab = str(root / "vocab.json")
    bpe.save(vocab)
    kw = dict(MODEL_KW, vocab_size=bpe.vocab_size)
    model = jax_tiny(**kw)
    ids = np.zeros((1, 16), np.int32)
    params = model.init(jax.random.PRNGKey(3), ids, np.ones_like(ids), ids,
                        train=False)["params"]
    overrides = [
        "model.kwargs.hidden_size=32", "model.kwargs.num_layers=1",
        "model.kwargs.num_heads=2", "model.kwargs.mlp_dim=64",
        f"model.kwargs.max_len={MAX_LEN}",
        f"model.kwargs.vocab_size={bpe.vocab_size}", "data.seq_len=32",
        "train.dtype=float32", f"workdir={root}"]
    save_checkpoint(os.path.join(str(root), "transformer_nmt_wmt", "ckpt"),
                    5, {"params": params})
    return root, vocab, overrides


def _run_cli(main, capsys, argv):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, [json.loads(ln) for ln in out.splitlines() if ln.strip()], err


def test_cli_serve_text_requests_match_the_jax_cli(served_checkpoint,
                                                    capsys):
    from deeplearning_cfn_tpu.cli.main import main as jax_main
    from deeplearning_cfn_tpu_torch.cli.main import main as port_main

    root, vocab, overrides = served_checkpoint
    reqs = root / "text.jsonl"
    lines = _sliver_lines("de")[:3]
    reqs.write_text("".join(
        json.dumps({"text": t[:24], "id": f"t{i}", "max_new_tokens": 6})
        + "\n" for i, t in enumerate(lines))
        + json.dumps({"src_ids": [5, 9, 2], "id": "raw",
                      "beam_size": 2}) + "\n")
    argv = ["serve", "--preset", "transformer_nmt_wmt", "--accelerator",
            "cpu", "--requests", str(reqs), "--slots", "2",
            "--max-new-tokens", "6", "--kv-quant", "int8", "--quantize",
            "int8", "--vocab", vocab, *overrides]
    rc_j, want, _ = _run_cli(jax_main, capsys, argv)
    rc_p, got, err = _run_cli(port_main, capsys, argv)
    assert rc_j == rc_p == 0
    assert "serving checkpoint step 5" in err
    assert [r["id"] for r in got] == ["t0", "t1", "t2", "raw"]
    for g, w in zip(got, want):
        assert g["state"] == w["state"] == "done"
        assert g["tokens"] == w["tokens"]
        assert g["text"] == w["text"]
    assert len({tuple(r["tokens"]) for r in got}) > 1


@pytest.mark.parametrize("line,vocab", [
    ({"text": "hallo welt"}, False), ({"id": "x"}, True)],
    ids=["text_without_vocab", "neither_key"])
def test_cli_serve_bad_request_lines_exit_1_as_jax(served_checkpoint,
                                                   capsys, line, vocab):
    from deeplearning_cfn_tpu.cli.main import main as jax_main
    from deeplearning_cfn_tpu_torch.cli.main import main as port_main

    root, vocab_path, overrides = served_checkpoint
    reqs = root / "bad.jsonl"
    reqs.write_text(json.dumps(line) + "\n")
    argv = ["serve", "--preset", "transformer_nmt_wmt", "--accelerator",
            "cpu", "--requests", str(reqs), *overrides]
    if vocab:
        argv += ["--vocab", vocab_path]
    rc_j, _, err_j = _run_cli(jax_main, capsys, argv)
    rc_p, out, err_p = _run_cli(port_main, capsys, argv)
    assert rc_j == rc_p == 1 and not out
    want = [ln for ln in err_j.splitlines() if "ERROR" in ln]
    got = [ln for ln in err_p.splitlines() if "ERROR" in ln]
    assert got == want and len(got) == 1


def test_load_engine_takes_quantize_kv_quant_and_vocab(served_checkpoint):
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.data.bpe import Bpe
    from deeplearning_cfn_tpu_torch.presets import get_preset
    from deeplearning_cfn_tpu_torch.serve.loader import load_engine

    _, vocab, overrides = served_checkpoint
    cfg = apply_overrides(get_preset("transformer_nmt_wmt"), overrides)
    eng, bpe, step = load_engine(cfg, kv_block_size=4, quantize="int8",
                                 kv_quant="int8", vocab=vocab, device="cpu")
    assert step == 5 and isinstance(bpe, Bpe)
    assert eng.quantize == eng.kv_quant == "int8"
    assert eng.model.quantized and eng.cache[0][0].dtype == torch.int8
    assert eng.metrics.snapshot()["serve_kv_quant_bytes"] > 0
    eng, bpe, _ = load_engine(cfg, device="cpu")
    assert bpe is None and not eng.model.quantized
    # phase (A.6d) is ported: it goes through, and the engine refuses it
    # on a dense pool as JAX's does.
    with pytest.raises(ValueError, match="paged"):
        load_engine(cfg, device="cpu", phase="decode")
    eng, _, _ = load_engine(cfg, device="cpu", phase="decode",
                            kv_block_size=4)
    assert eng.phase == "decode"
