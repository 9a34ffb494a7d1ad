"""The port's GPT family (deeplearning_cfn_tpu_torch.models.lm, the LM data
source, ``lm_generate`` and the BPE copy) against the JAX package's, on the
CPU in f32.

- ``make_lm_source`` bit-equal from the same seeds (train 41, eval 43), the
  ``lm_text`` pipeline's batches equal, ``prepare_lm_text`` writing the
  same npz files and refusing the same inputs;
- ``gpt_tiny`` (2 layers, hidden 64, 4 heads, vocab 512) from one Flax init
  (Dense kernels ×3, so greedy decoding does not repeat one token) carried
  by ``convert.params_from_flax``: logits within 1e-5 of the largest logit,
  with the JAX attention through its plain reference and through the
  Pallas kernel in interpret mode; causality; ``decode_step`` rolled over a
  sequence equal to the full forward in both packages; ``flax_layout``
  naming every leaf of ``gpt_small`` as the Flax tree does;
- ``lm_generate``: greedy token-identical to the JAX package's, the
  recompute mode equal to the cached one, sampling seeded, in range and
  keeping every logit tied at the top-k cut, and the refusals;
- ``Bpe``/``train_bpe``: the same merges, ids and text as the JAX package's;
- MoE builds (``tests/test_torch_moe.py`` holds it against JAX), and
  across processes refuses, naming A.10; ``gpt_long`` builds without a
  decode step (``tests/test_torch_long.py`` holds it against JAX).

Inputs are numpy arrays made from seeds and handed to both packages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from deeplearning_cfn_tpu.config import DataConfig as JDataConfig
from deeplearning_cfn_tpu.data import bpe as jbpe
from deeplearning_cfn_tpu.data import text as jtext
from deeplearning_cfn_tpu.data.pipeline import DataPipeline as JaxPipeline
from deeplearning_cfn_tpu.models import build_model as j_build_model
from deeplearning_cfn_tpu.models.decoding import lm_generate as j_generate
from deeplearning_cfn_tpu.models.lm import TransformerCausalLm as JaxLm
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.config import DataConfig
from deeplearning_cfn_tpu_torch.convert import flax_layout, params_from_flax
from deeplearning_cfn_tpu_torch.data import bpe as tbpe
from deeplearning_cfn_tpu_torch.data import text as ttext
from deeplearning_cfn_tpu_torch.data.pipeline import build_pipeline
from deeplearning_cfn_tpu_torch.models import build_model
from deeplearning_cfn_tpu_torch.models.decoding import lm_generate

VOCAB, MAX_LEN, SEQ = 512, 32, 20


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One worker's share of the cores (torch would start a thread per core
    in every pytest-xdist worker)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


# -- data ---------------------------------------------------------------------


@pytest.mark.parametrize("train", [True, False])
def test_lm_source_bit_equal_and_pipeline_batches(train):
    kw = dict(name="lm_text", seq_len=16, vocab_size=64,
              num_train_examples=40, num_eval_examples=12)
    want = jtext.build_text_source(JDataConfig(**kw), train).arrays
    got = ttext.build_text_source(DataConfig(**kw), train).arrays
    assert sorted(got) == ["loss_mask", "tokens"]
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n = 40 if train else 12
    assert got["tokens"].shape == (n, 17)
    direct = ttext.make_lm_source(n, 16, 64, 41 if train else 43).arrays
    np.testing.assert_array_equal(direct["tokens"], got["tokens"])
    jpipe = JaxPipeline(jtext.build_text_source(JDataConfig(**kw), train), 8,
                        seed=3, shuffle=train, prefetch=0, native=False,
                        drop_remainder=train)
    tpipe = build_pipeline(DataConfig(**kw, prefetch=0), 8, seed=3,
                           train=train, drop_remainder=train)
    for jb, tb in zip(jpipe.one_epoch(), tpipe.one_epoch()):
        assert sorted(jb) == sorted(tb)
        for k in jb:
            np.testing.assert_array_equal(np.asarray(tb[k]),
                                          np.asarray(jb[k]), err_msg=k)


def test_prepare_lm_text_writes_the_same_files(tmp_path):
    src = tmp_path / "corpus.txt"
    src.write_bytes(bytes(range(256)) * 40)
    want = jtext.prepare_lm_text(str(src), str(tmp_path / "jax"), seq_len=31)
    got = ttext.prepare_lm_text(str(src), str(tmp_path / "port"), seq_len=31)
    assert got == want
    for split in ("train", "eval"):
        with np.load(tmp_path / "jax" / f"{split}.npz") as j, \
                np.load(tmp_path / "port" / f"{split}.npz") as t:
            assert sorted(j.files) == sorted(t.files)
            for k in j.files:
                np.testing.assert_array_equal(t[k], j[k])
    cfg = DataConfig(name="lm_text", seq_len=31, vocab_size=260,
                     data_dir=str(tmp_path / "port"), synthetic=False)
    batch = ttext.build_text_source(cfg, train=True).gather(np.arange(4))
    assert batch["tokens"].shape == (4, 32)
    assert batch["tokens"].min() >= 4 and batch["tokens"].max() < 260
    tiny = tmp_path / "tiny.txt"
    tiny.write_bytes(b"x" * 10)
    with pytest.raises(ValueError, match="at least"):
        ttext.prepare_lm_text(str(tiny), str(tmp_path / "t"), seq_len=31)
    with pytest.raises(ValueError, match="eval_fraction"):
        ttext.prepare_lm_text(str(src), str(tmp_path / "t"), seq_len=31,
                              eval_fraction=1.5)


def test_bpe_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    words = ["the", "then", "there", "hello", "help", "world", "word",
             "wordy", "über", "lower", "lowest"]
    lines = [" ".join(rng.choice(words, 7)) for _ in range(60)]
    want = jbpe.train_bpe(lines, 300, jbpe.NMT_SPECIALS)
    got = tbpe.train_bpe(lines, 300, tbpe.NMT_SPECIALS)
    assert got.merges == want.merges and got.vocab_size == want.vocab_size
    text = "the lowest wordy hello über zzz"
    assert got.encode(text) == want.encode(text)
    ids = got.encode(text) + [1, 999999]
    assert got.decode(ids) == want.decode(ids)
    path = str(tmp_path / "vocab.json")
    got.save(path)
    assert jbpe.Bpe.load(path).merges == want.merges
    assert tbpe.Bpe.load(path).encode(text) == want.encode(text)
    with pytest.raises(ValueError, match="smaller than"):
        tbpe.train_bpe(lines, 100)


# -- the model ----------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jm = j_build_model("gpt_tiny", 0, jnp.float32, vocab_size=VOCAB,
                       max_len=MAX_LEN, dropout_rate=0.0)
    ids = np.zeros((1, SEQ), np.int32)
    params = jm.init(jax.random.PRNGKey(0), ids, train=False)["params"]
    flat = {n: np.asarray(x) * (3.0 if n.endswith("kernel") else 1.0)
            for n, x in flatten_with_names(params)[0]}
    params = traverse_util.unflatten_dict(
        {tuple(n.split("/")): x for n, x in flat.items()})
    tm = build_model("gpt_tiny", 0, torch.float32, vocab_size=VOCAB,
                     max_len=MAX_LEN)
    tm.load_state_dict(params_from_flax(flat), strict=True)
    tm.requires_grad_(False)
    return jm, {"params": params}, tm


def _ids(seed, b=3, s=SEQ):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, s)) \
        .astype(np.int32)


@pytest.mark.parametrize("jax_impl", ["auto", "interpret"])
def test_logits_match_jax(models, jax_impl):
    _, v, tm = models
    jm = j_build_model("gpt_tiny", 0, jnp.float32, vocab_size=VOCAB,
                       max_len=MAX_LEN, attention_impl=jax_impl)
    ids = _ids(1)
    want = np.asarray(jm.apply(v, ids, train=False))
    got = tm(torch.from_numpy(ids).long())
    assert got.dtype == torch.float32 and got.shape == (3, SEQ, VOCAB)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_lm_is_causal(models):
    _, _, tm = models
    ids = torch.from_numpy(_ids(2, b=1)).long()
    base = tm(ids)
    bumped = ids.clone()
    bumped[0, 8] = (bumped[0, 8] + 7) % VOCAB
    out = tm(bumped)
    assert torch.equal(out[0, :8], base[0, :8])
    assert not torch.allclose(out[0, 8:], base[0, 8:])


def test_decode_step_rollout_equals_full_forward(models):
    jm, v, tm = models
    ids = _ids(3, b=2, s=12)
    full = tm(torch.from_numpy(ids).long())
    cache = tm.init_cache(2)
    steps = torch.cat([tm.decode_step(torch.from_numpy(ids[:, t:t + 1])
                                      .long(), t, cache)
                       for t in range(12)], dim=1)
    np.testing.assert_allclose(steps.numpy(), full.numpy(), rtol=0,
                               atol=1e-5 * full.abs().max().item())
    jcache = jm.init(jax.random.PRNGKey(0), ids[:, :1], 0,
                     method=JaxLm.decode_step)["cache"]
    jsteps = []
    for t in range(12):
        logits, mut = jm.apply({**v, "cache": jcache}, ids[:, t:t + 1], t,
                               method=JaxLm.decode_step, mutable=["cache"])
        jcache = mut["cache"]
        jsteps.append(np.asarray(logits))
    jsteps = np.concatenate(jsteps, axis=1)
    np.testing.assert_allclose(jsteps, np.asarray(jm.apply(v, ids)),
                               rtol=0, atol=1e-5 * np.abs(jsteps).max())
    np.testing.assert_allclose(steps.numpy(), jsteps, rtol=0,
                               atol=1e-5 * np.abs(jsteps).max())


def test_flax_layout_names_every_gpt_small_leaf():
    jm = j_build_model("gpt_small", 0, jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    want = {"params/" + n: tuple(x.shape)
            for n, x in flatten_with_names(shapes)[0]}
    tm = build_model("gpt_small", 0, torch.bfloat16, device="meta")
    got = {}
    for name, _, t, kind in flax_layout(tm):
        shape = tuple(t.shape)
        got[name] = shape[::-1] if kind == "dense" else shape
    assert got == want
    assert sum(np.prod(s) for s in got.values()) == \
        sum(p.numel() for p in tm.parameters())


def test_refusals_name_their_roadmap_items():
    moe = build_model("gpt_tiny", 0, torch.float32, num_experts=2)
    assert [lyr.num_experts for lyr in moe.layer] == [0, 2]
    # gpt_long is ported (tests/test_torch_long.py), and so is a MoE GPT
    # across processes: on an expert=2 mesh each process holds one expert
    # of every MoE layer (the JAX lm shares BERT's MoE rules).
    assert not hasattr(type(build_model("gpt_long", 0, torch.float32)),
                       "decode_step")
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.parallel import build_mesh
    from deeplearning_cfn_tpu_torch.presets import get_preset
    from deeplearning_cfn_tpu_torch.train import task as t_task

    cfg = apply_overrides(get_preset("gpt_small_lm"), [
        "model.name=gpt_tiny", "model.kwargs.num_experts=2",
        "mesh.expert=2"])
    mesh = build_mesh(cfg.mesh, num_processes=2, index=1)
    task = t_task.build_task(cfg, torch.device("meta"), mesh=mesh)
    moe = task.model.layer[1].moe_mlp
    assert moe.mesh is mesh and moe.ways == 2
    assert tuple(moe.w_out.shape) == (1, 128, 64)


# -- generation ---------------------------------------------------------------


class _Recompute(torch.nn.Module):
    """The model without ``decode_step``: ``lm_generate`` drives it in
    recompute mode."""

    def __init__(self, model):
        super().__init__()
        self.inner = model
        self.max_len = model.max_len

    def forward(self, tokens, train=False):
        return self.inner(tokens, train=train)


def test_lm_generate_greedy_matches_jax_and_recompute(models):
    jm, v, tm = models
    prompt = np.array([[5, 9, 3, 11], [1, 2, 7, 300]], np.int32)
    want = np.asarray(j_generate(jm, v, jnp.asarray(prompt), 10))
    got = lm_generate(tm, torch.from_numpy(prompt).long(), 10)
    assert got.shape == (2, 14)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(got[:, 4:].flatten().tolist())) > 2, "degenerate model"
    recompute = lm_generate(_Recompute(tm), torch.from_numpy(prompt).long(),
                            10)
    assert torch.equal(recompute, got)


class _Fixed(torch.nn.Module):
    """A causal LM stub whose every step gives the same logits: ids 3, 5
    and 6 tie at the second-largest value, id 9 is the largest."""

    max_len = 64

    def init_cache(self, batch):
        return []

    def decode_step(self, token, pos, cache):
        logits = torch.full((token.shape[0], 1, 16), -2.0)
        logits[..., 9] = 1.0
        logits[..., [3, 5, 6]] = 0.5
        return logits


def test_sampling_is_seeded_in_range_and_keeps_top_k_ties(models):
    _, _, tm = models
    prompt = torch.tensor([[4, 8]])
    gen = lambda seed: torch.Generator().manual_seed(seed)
    a = lm_generate(tm, prompt, 5, temperature=1.0, top_k=8,
                    generator=gen(7))
    b = lm_generate(tm, prompt, 5, temperature=1.0, top_k=8,
                    generator=gen(7))
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < VOCAB
    drawn = lm_generate(_Fixed(), torch.zeros((64, 1), dtype=torch.long),
                        40, temperature=1.0, top_k=2, generator=gen(0))
    seen = set(drawn[:, 1:].flatten().tolist())
    # top-2 keeps every logit >= the 2nd largest: 9 and all three ties.
    assert seen == {3, 5, 6, 9}
    with pytest.raises(ValueError, match="rng"):
        lm_generate(tm, prompt, 5, temperature=1.0)
    with pytest.raises(ValueError, match="max_len"):
        lm_generate(tm, prompt, MAX_LEN)
