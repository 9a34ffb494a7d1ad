"""Int8 serving in the port (serve/quant.py, QuantDense/QuantEmbed, the int8
paged KV pool) against the JAX package's, on the CPU in f32.

The model is ``tests/test_torch_serve.py``'s tiny NMT (a Flax
``transformer_nmt_tiny`` init with its Dense kernels scaled ×3, bridged with
``convert.params_from_flax``). The port's quantizer must give the codes and
scales of JAX ``quantize_variables`` bit for bit; the quantized forward the
JAX quantized clone's logits within 1e-5 of the largest; and
``decode_step_paged`` / ``decode_span_paged`` over the int8 pool JAX's codes
exactly, its scales within 1e-6 relative and its logits within 1e-5 — with
spans running past the table, an unbound table entry and a row whose whole
table is the null block, which JAX's scatter drops and a clamped index
would write.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from deeplearning_cfn_tpu.models.transformer_nmt import (
    transformer_nmt_tiny as jax_tiny)
from deeplearning_cfn_tpu.serve import quant as jquant
from deeplearning_cfn_tpu.serve import Engine as JaxEngine
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.convert import params_from_flax
from deeplearning_cfn_tpu_torch.models.transformer import (QuantDense,
                                                           QuantEmbed)
from deeplearning_cfn_tpu_torch.models.transformer_nmt import (
    transformer_nmt_tiny as torch_tiny)
from deeplearning_cfn_tpu_torch.serve import Engine
from deeplearning_cfn_tpu_torch.serve import quant as tquant

VOCAB, SRC, MAX_LEN = 64, 8, 32
MODEL_KW = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=2,
                mlp_dim=64, max_len=MAX_LEN)
POOL = ("cached_key", "cached_value", "cached_key_scale",
        "cached_value_scale")


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


def _port_model(flat):
    tm = torch_tiny(**MODEL_KW)
    tm.load_state_dict(params_from_flax(flat), strict=True)
    return tm.requires_grad_(False)


def _flat(tree):
    return {n: np.asarray(x) for n, x in flatten_with_names(tree)[0]}


def _batch(seed, b=2, t=SRC):
    rng = np.random.RandomState(seed)
    src = rng.randint(3, VOCAB, size=(b, SRC)).astype(np.int32)
    src[0, SRC - 2:] = 0  # a padded row
    tgt = rng.randint(3, VOCAB, size=(b, t)).astype(np.int32)
    return src, (src != 0).astype(np.int32), tgt


def _t(a):
    return torch.as_tensor(np.array(a)).long()


# -- the quantizer -----------------------------------------------------------


def test_codes_and_scales_equal_jax_quantize_variables(weights):
    """Every int8 leaf and its scale bit for bit: the JAX ``kernel`` [in,
    out] is the port's ``weight`` [out, in] transposed; the token table
    keeps its layout. Everything else passes through unquantized."""
    _, params, flat = weights
    jq = _flat(jquant.quantize_variables({"params": params})["params"])
    q = tquant.quantize_model(_port_model(flat))
    sd = q.state_dict()
    assert len(sd) == len(jq)
    n_int8 = 0
    for name, want in jq.items():
        parent, _, leaf = name.rpartition("/")
        key = re.sub(r"(enc|dec)_(\d+)", r"\1.\2", parent).replace("/", ".")
        if leaf in ("kernel", "embedding"):
            mine = sd[f"{key}.weight"].numpy()
            assert mine.dtype == np.int8 == want.dtype
            np.testing.assert_array_equal(
                mine.T if leaf == "kernel" else mine, want)
            np.testing.assert_array_equal(sd[f"{key}.scale"].numpy(),
                                          jq[f"{parent}/scale"])
            n_int8 += 1
        elif leaf == "bias":
            np.testing.assert_array_equal(sd[f"{key}.bias"].numpy(), want)
    # Every 2-D weight: 6 per encoder layer (Q/K/V/out, mlp_in, mlp_out),
    # 10 per decoder layer (cross-attention's 4 more) and the token table.
    assert n_int8 == 2 * 6 + 2 * 10 + 1
    assert sum(v.dtype == torch.int8 for v in sd.values()) == n_int8


def test_quantizer_leaves_the_source_untouched_and_swaps_the_layers(weights):
    tm = _port_model(weights[2])
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    q = tquant.quantize_model(tm)
    assert all(torch.equal(v, before[k]) for k, v in tm.state_dict().items())
    assert not tm.quantized and q.quantized
    assert isinstance(q.embed.token, QuantEmbed)
    assert isinstance(q.dec[1].cross_attn.value, QuantDense)
    assert isinstance(q.enc[0].mlp.mlp_out, QuantDense)
    assert q.embed.src_position.dtype == torch.float32
    # The state_dict form (swap_variables' input) gives the same tensors.
    qs = tquant.quantize_state_dict(tm.state_dict())
    assert qs.keys() == q.state_dict().keys()
    assert all(torch.equal(v, qs[k]) for k, v in q.state_dict().items())


def test_round_half_to_even_and_true_division():
    """np.rint's rounding (half to even) and a true division: values that
    land on .5 steps and a channel of zeros (scale 1)."""
    w = np.array([[127.0, 0.0, 0.5], [63.5, 0.0, -1.5], [-0.5, 0.0, 2.5],
                  [1.0 / 3.0, 0.0, 0.1]], np.float32)
    want_q, want_s = jquant._quantize_array(w)
    got_q, got_s = tquant._quantize_array(torch.from_numpy(w))
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    rng = np.random.RandomState(5)
    w = rng.standard_normal((300, 40)).astype(np.float32)
    want_q, want_s = jquant._quantize_array(w)
    got_q, got_s = tquant._quantize_array(torch.from_numpy(w))
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


def test_variables_bytes_equal_jax(weights):
    _, params, flat = weights
    tm = _port_model(flat)
    f32 = jquant.variables_bytes({"params": params})
    int8 = jquant.variables_bytes(
        jquant.quantize_variables({"params": params}))
    assert tquant.variables_bytes(tm) == f32
    assert tquant.variables_bytes(tquant.quantize_model(tm)) == int8
    assert tquant.variables_bytes(
        tquant.quantize_state_dict(tm.state_dict())) == int8
    assert int8 < 0.5 * f32


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_kv_pool_bytes_equal_jax(weights, kv_quant):
    """The engines' paged pools: bytes as stored and the f32 equivalent."""
    jm, params, flat = weights
    kw = dict(capacity=2, max_src_len=SRC, kv_block_size=8,
              kv_quant=kv_quant)
    je = JaxEngine(jm, {"params": params}, **kw)
    te = Engine(_port_model(flat), **kw)
    assert te.kv_blocks == je.kv_blocks
    # The f32 model (train.dtype float32): the f32 pool's two numbers agree.
    want = jquant.kv_pool_bytes(je.cache, je.kv_blocks)
    assert tquant.kv_pool_bytes(te.cache, te.kv_blocks) == want
    if kv_quant:
        stored, fp32 = want
        assert stored <= 0.30 * fp32
        assert te.metrics.snapshot()["serve_kv_quant_bytes"] == stored


def test_dequantize_kv_blocks_equals_jax():
    rng = np.random.RandomState(1)
    codes = rng.randint(-127, 128, size=(3, 2, 4, 8)).astype(np.int8)
    scales = rng.uniform(0.001, 0.1, size=(3, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tquant.dequantize_kv_blocks(torch.from_numpy(codes),
                                    torch.from_numpy(scales)).numpy(),
        jquant.dequantize_kv_blocks(codes, scales))


@pytest.mark.parametrize("what", ["quantize", "kv_quant", "kv_quant_dense"])
def test_refusals_raise_the_jax_messages(weights, what):
    jm, params, flat = weights
    kw = {"quantize": dict(quantize="int4"),
          "kv_quant": dict(kv_quant="int4", kv_block_size=8),
          "kv_quant_dense": dict(kv_quant="int8")}[what]
    with pytest.raises(ValueError) as want:
        JaxEngine(jm, {"params": params}, capacity=2, max_src_len=SRC, **kw)
    with pytest.raises(ValueError) as got:
        Engine(_port_model(flat), capacity=2, max_src_len=SRC, **kw)
    assert str(got.value) == str(want.value)


def test_a_model_without_the_quantized_field_is_refused():
    from deeplearning_cfn_tpu_torch.models.lm import gpt_tiny

    with pytest.raises(ValueError, match="has no 'quantized' field"):
        tquant.quantize_model(gpt_tiny(vocab_size=32, max_len=8))


# -- the quantized forward ---------------------------------------------------


def test_quantized_forward_matches_jax(weights):
    jm, params, flat = weights
    src, mask, tgt = _batch(0)
    ref = np.asarray(jquant.quantized_model(jm).apply(
        jquant.quantize_variables({"params": params}), src, mask, tgt,
        train=False))
    with torch.no_grad():
        got = tquant.quantize_model(_port_model(flat))(
            _t(src), _t(mask), _t(tgt), train=False).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    # It is the int8 model: the f32 one's logits differ by more.
    with torch.no_grad():
        f32 = _port_model(flat)(_t(src), _t(mask), _t(tgt),
                                train=False).numpy()
    assert np.abs(f32 - ref).max() > 1e-3 * np.abs(ref).max()


def test_a_loaded_jax_quantized_tree_gives_the_same_logits(weights):
    """``params_from_flax`` on JAX's int8 tree: ``scale`` beside a 2-D
    ``kernel``/``embedding`` keeps its name, codes stay int8 (transposed for
    a kernel), LayerNorm scales still become ``weight``."""
    _, params, flat = weights
    jq = _flat(jquant.quantize_variables({"params": params})["params"])
    state = params_from_flax(jq)
    assert state["dec.1.self_attn.query.weight"].dtype == torch.int8
    assert state["embed.token.scale"].shape == (MODEL_KW["hidden_size"],)
    assert state["enc.0.mlp_norm.weight"].dtype == torch.float32
    loaded = tquant.quantize_model(torch_tiny(**MODEL_KW))
    loaded.load_state_dict(state, strict=True)
    mine = tquant.quantize_model(_port_model(flat))
    src, mask, tgt = _batch(1)
    with torch.no_grad():
        a = loaded(_t(src), _t(mask), _t(tgt), train=False)
        b = mine(_t(src), _t(mask), _t(tgt), train=False)
    assert torch.equal(a, b)


# -- the int8 paged pool against JAX ----------------------------------------


def _jax_pool(cache, i, name):
    return cache[f"dec_{i}"]["self_attn"][name]


@pytest.mark.parametrize("s", [1, 5], ids=["step", "span5"])
def test_int8_paged_decode_matches_jax(weights, s):
    """Random prior pool contents (codes and scales) on both sides, then one
    paged decode. Rows: 0 has one bound block and the rest of its table
    unbound (its span-5 window runs into an unbound entry); 1's whole table
    is the null block; 2 and 3 sit near the end of the span, so the span's
    window runs past the table. Codes equal JAX's everywhere (the null
    block included: neither side writes it), scales within 1e-6 relative,
    logits within 1e-5 of the largest."""
    jm, params, flat = weights
    jkv = jquant.kv_quantized_model(jm)
    tm = _port_model(flat)
    b, bs, nb = 4, 8, 17
    rng = np.random.RandomState(10 + s)
    src, mask, _ = _batch(2, b)
    tgt = rng.randint(3, VOCAB, size=(b, s)).astype(np.int32)
    pos = np.array([6, 9, 29, 31], np.int32)
    tables = np.array([[1, 0, 0, 0], [0, 0, 0, 0], [6, 7, 8, 9],
                       [10, 11, 12, 13]], np.int32)
    enc = np.array(jm.apply({"params": params}, src, mask,
                              method=jm.encode))
    cache = jkv.init(jax.random.PRNGKey(0), np.zeros((b, 1), np.int32),
                     enc, mask, np.zeros((b,), np.int32), tables,
                     num_blocks=nb, block_size=bs,
                     method=jkv.decode_step_paged)["cache"]
    tcache = tm.init_paged_cache(nb, bs, kv_quant="int8")
    assert [t.dtype for t in tcache[0]] == [torch.int8, torch.int8,
                                            torch.float32, torch.float32]
    for i in range(MODEL_KW["num_layers"]):
        for j, name in enumerate(POOL):
            np.testing.assert_array_equal(
                tcache[i][j].numpy(), np.asarray(_jax_pool(cache, i, name)))
            shape = tcache[i][j].shape
            vals = rng.randint(-127, 128, size=shape).astype(np.int8) \
                if j < 2 else rng.uniform(0.01, 0.05, size=shape) \
                .astype(np.float32)
            cache[f"dec_{i}"]["self_attn"][name] = jax.numpy.asarray(vals)
            tcache[i][j].copy_(torch.from_numpy(vals))
    method = jkv.decode_span_paged if s > 1 else jkv.decode_step_paged
    logits, mut = jkv.apply({"params": params, "cache": cache}, tgt, enc,
                            mask, pos, tables, num_blocks=nb, block_size=bs,
                            method=method, mutable=["cache"])
    step = tm.decode_span_paged if s > 1 else tm.decode_step_paged
    with torch.no_grad():
        got = step(_t(tgt), torch.from_numpy(enc), _t(mask), _t(pos),
                   _t(tables), tcache).numpy()
    ref = np.asarray(logits)
    assert got.shape == ref.shape == (b, s, VOCAB)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    for i in range(MODEL_KW["num_layers"]):
        for j, name in enumerate(POOL):
            want = np.asarray(_jax_pool(mut["cache"], i, name))
            mine = tcache[i][j].numpy()
            if j < 2:
                np.testing.assert_array_equal(mine, want)
            else:
                np.testing.assert_allclose(mine, want, rtol=1e-6, atol=0)


def test_int8_pool_write_never_touches_the_null_block_or_unselected_blocks(
        weights):
    """Only the blocks of the touched windows change; block 0 keeps its
    content even when every row of the batch is on it."""
    tm = _port_model(weights[2])
    nb, bs = 9, 8
    src, mask, _ = _batch(3, 2)
    with torch.no_grad():
        enc = tm.encode(_t(src), _t(mask))
        for tables, changed in (([[0, 0, 0, 0], [0, 0, 0, 0]], set()),
                                ([[3, 0, 0, 0], [5, 6, 0, 0]], {3, 5, 6})):
            cache = tm.init_paged_cache(nb, bs, kv_quant="int8")
            for layer in cache:
                layer[0].random_(-127, 127)
            before = [t.clone() for t in cache[0]]
            tm.decode_span_paged(_t([[5, 6, 7], [8, 9, 10]]), enc, _t(mask),
                                 _t([2, 6]), _t(tables), cache)
            for t, old in zip(cache[0], before):
                moved = {int(i) for i in range(nb)
                         if not torch.equal(t[i], old[i])}
                assert moved <= changed and 0 not in moved
            assert {int(i) for i in range(nb)
                    if not torch.equal(cache[0][0][i], before[0][i])} \
                == changed


def test_int8_kv_logits_stay_within_the_divergence_bound(weights):
    """Teacher-forced paged decode, f32 pool against int8 pool: max |Δlogit|
    within 0.1 · max(1, max |ref|), JAX's serving bound (serve/bench.py)."""
    tm = _port_model(weights[2])
    b, bs, steps = 2, 4, 8
    src, mask, toks = _batch(4, b, steps)
    mb = MAX_LEN // bs
    tables = torch.arange(1, b * mb + 1).view(b, mb)
    outs = {}
    with torch.no_grad():
        enc = tm.encode(_t(src), _t(mask))
        for kvq in ("", "int8"):
            cache = tm.init_paged_cache(b * mb + 1, bs, kv_quant=kvq)
            outs[kvq] = torch.cat([
                tm.decode_step_paged(_t(toks[:, t:t + 1]), enc, _t(mask),
                                     torch.full((b,), t), tables, cache)
                for t in range(steps)], dim=1)
    ref, q = outs[""], outs["int8"]
    diff = (q - ref).abs().max().item()
    assert 0 < diff <= 0.1 * max(1.0, ref.abs().max().item())
