"""Parity of the port's Transformer NMT (deeplearning_cfn_tpu_torch.models)
with the JAX package's, on the CPU in f32.

One ``transformer_nmt_tiny`` is initialized in Flax, its Dense kernels
scaled ×3 (so the random model's argmax is not one repeated token), and
carried into the port through ``convert.params_from_flax``. The same numpy
inputs, made from a seed, then go through both. Logits agree within 1e-4
(f32, summation order only); the port's paged and dense decode steps are
bit-identical; the offline greedy and beam decoders give identical tokens.
"""

import jax
import numpy as np
from flax import traverse_util
import pytest
import torch

from deeplearning_cfn_tpu.models import decoding as jdec
from deeplearning_cfn_tpu.models.transformer_nmt import (
    TransformerNMT as JaxNMT, transformer_nmt_tiny as jax_tiny)
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.convert import params_from_flax
from deeplearning_cfn_tpu_torch.models import decoding as tdec
from deeplearning_cfn_tpu_torch.models.transformer_nmt import (
    transformer_nmt_tiny as torch_tiny)

VOCAB, SRC, MAX_LEN, BLOCK = 96, 12, 32, 8
TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    kw = dict(vocab_size=VOCAB, max_len=MAX_LEN)
    jm = jax_tiny(**kw)
    ids = np.zeros((1, SRC), np.int32)
    params = jm.init(jax.random.PRNGKey(0), ids, np.ones_like(ids), ids,
                     train=False)["params"]
    flat = {n: np.asarray(x) * (3.0 if n.endswith("kernel") else 1.0)
            for n, x in flatten_with_names(params)[0]}
    params = traverse_util.unflatten_dict(
        {tuple(n.split("/")): x for n, x in flat.items()})
    tm = torch_tiny(**kw)
    tm.load_state_dict(params_from_flax(flat), strict=True)
    tm.requires_grad_(False)
    return jm, {"params": params}, tm


def _batch(seed, b=3):
    rng = np.random.RandomState(seed)
    src = rng.randint(3, VOCAB, size=(b, SRC)).astype(np.int32)
    lengths = rng.randint(2, SRC + 1, size=b)
    for i, n in enumerate(lengths):
        src[i, n:] = 0
    src[0, lengths[0] - 1] = jdec.EOS_ID
    return src, (src != 0).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


def test_encode_and_teacher_forced_decode(models):
    jm, v, tm = models
    src, mask = _batch(1)
    jenc = np.asarray(jm.apply(v, src, mask, method=JaxNMT.encode))
    tenc = tm.encode(_t(src), _t(mask))
    np.testing.assert_allclose(tenc.numpy(), jenc, atol=TOL, rtol=0)
    tgt = np.random.RandomState(2).randint(3, VOCAB, (3, 9)).astype(np.int32)
    jl = np.asarray(jm.apply(v, tgt, jenc, mask, method=JaxNMT.decode))
    tl = tm.decode(_t(tgt), torch.tensor(jenc), _t(mask))
    np.testing.assert_allclose(tl.numpy(), jl, atol=TOL, rtol=0)


def _jax_steps(jm, v, method, enc, mask, toks, poss, **extra):
    """Run a sequence of per-row decode steps in JAX, threading the cache."""
    b = toks[0].shape[0]
    args = extra.pop("tables", None)
    lead = (args,) if args is not None else ()
    cache = jm.init(jax.random.PRNGKey(0), np.zeros((b, 1), np.int32), enc,
                    mask, np.zeros((b,), np.int32), *lead, method=method,
                    **extra)["cache"]
    out = []
    for tok, pos in zip(toks, poss):
        logits, mut = jm.apply({**v, "cache": cache}, tok[:, None], enc, mask,
                               pos, *lead, method=method, mutable=["cache"],
                               **extra)
        cache = mut["cache"]
        out.append(np.asarray(logits))
    return out


def _step_inputs(seed, b, steps):
    rng = np.random.RandomState(seed)
    toks = [rng.randint(3, VOCAB, size=b).astype(np.int32)
            for _ in range(steps)]
    start = np.array([0, 3, 7][:b], np.int32)
    poss = [start + t for t in range(steps)]
    return toks, poss


def test_decode_step_at_and_paged_match_jax(models):
    jm, v, tm = models
    src, mask = _batch(3)
    jenc = np.asarray(jm.apply(v, src, mask, method=JaxNMT.encode))
    toks, poss = _step_inputs(4, 3, 6)
    jdense = _jax_steps(jm, v, JaxNMT.decode_step_at, jenc, mask, toks, poss)
    mb = MAX_LEN // BLOCK
    tables = (1 + np.arange(3 * mb, dtype=np.int32)).reshape(3, mb)[:, ::-1]
    tables = np.ascontiguousarray(tables)
    nb = 3 * mb + 1
    jpaged = _jax_steps(jm, v, JaxNMT.decode_step_paged, jenc, mask, toks,
                        poss, tables=tables, num_blocks=nb, block_size=BLOCK)
    enc_t = torch.tensor(jenc)
    dense_cache = tm.init_cache(3)
    paged_cache = tm.init_paged_cache(nb, BLOCK)
    for i, (tok, pos) in enumerate(zip(toks, poss)):
        ld = tm.decode_step_at(_t(tok)[:, None], enc_t, _t(mask), _t(pos),
                               dense_cache)
        lp = tm.decode_step_paged(_t(tok)[:, None], enc_t, _t(mask), _t(pos),
                                  _t(tables), paged_cache)
        np.testing.assert_allclose(ld.numpy(), jdense[i], atol=TOL, rtol=0)
        np.testing.assert_allclose(lp.numpy(), jpaged[i], atol=TOL, rtol=0)
        # The gathered paged span equals the dense row: bit-identical.
        assert torch.equal(ld, lp), f"paged != dense at step {i}"


def test_greedy_decode_cached_tokens_identical(models):
    jm, v, tm = models
    src, mask = _batch(5, b=4)
    jt = np.asarray(jdec.greedy_decode_cached(jm, v, src, mask, 20))
    tt = tdec.greedy_decode_cached(tm, _t(src), _t(mask), 20).numpy()
    assert len({tuple(r) for r in tt}) > 1, "degenerate model outputs"
    np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("beam", [2, 3])
def test_beam_decode_cached_tokens_identical(models, beam):
    jm, v, tm = models
    src, mask = _batch(6 + beam, b=3)
    jt, js = jdec.beam_decode_cached(jm, v, src, mask, 16, beam_size=beam)
    tt, ts = tdec.beam_decode_cached(tm, _t(src), _t(mask), 16,
                                     beam_size=beam)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=TOL, rtol=0)


def test_strip_special_matches_jax():
    row = [1, 5, 0, 7, 2, 9]
    assert tdec.strip_special(row) == jdec.strip_special(row) == [5, 7]
