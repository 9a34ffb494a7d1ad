"""The port's BERT (deeplearning_cfn_tpu_torch.models.bert) against the JAX
package's, on the CPU.

- MLM and NSP logits of ``bert_tiny`` (2 layers, hidden 32, vocab 64, f32)
  from one Flax init carried by ``convert.params_from_flax``, on batches of
  the synthetic MLM source with the tails of some rows padded (so the
  padding bias of every self-attention matters): within 1e-5, with the JAX
  attention through its plain reference and through the Pallas kernel in
  interpret mode;
- the gradients of the MLM+NSP loss (``MlmTask.loss_fn``) against
  ``jax.grad``: every parameter's gradient within 1e-4 of the largest
  gradient entry, absolute;
- ``bert_base``: its parameter count on the ``meta`` device against
  ``jax.eval_shape`` of the Flax init, and ``convert.flax_layout`` naming
  every parameter as the Flax tree does (shapes in Flax's layout);
- the BERT variants: the MoE and pipelined presets build their tasks
  (``tests/test_torch_moe.py`` and ``tests/test_torch_pipelined.py`` hold
  them against JAX), and the MoE task builds across processes on the
  preset's ``expert=8`` mesh, each process holding one expert of every MoE
  layer (``tests/test_torch_pipe_expert.py`` trains it); the long-context
  trunk builds (``tests/test_torch_long.py`` holds it against JAX).

Inputs are numpy arrays made from seeds and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning_cfn_tpu.config import apply_overrides as j_overrides
from deeplearning_cfn_tpu.models import build_model as j_build_model
from deeplearning_cfn_tpu.presets import get_preset as j_preset
from deeplearning_cfn_tpu.train.task import MlmTask as JaxMlmTask
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.config import apply_overrides
from deeplearning_cfn_tpu_torch.convert import flax_layout, params_from_flax
from deeplearning_cfn_tpu_torch.data.pipeline import to_device
from deeplearning_cfn_tpu_torch.data.text import make_mlm_source
from deeplearning_cfn_tpu_torch.models import build_model
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.train.task import MlmTask, build_task

TINY = ["model.name=bert_tiny", "model.kwargs.hidden_size=32",
        "model.kwargs.num_layers=2", "model.kwargs.num_heads=2",
        "model.kwargs.mlp_dim=64", "model.kwargs.max_len=32",
        "model.kwargs.dropout_rate=0.0", "data.vocab_size=64",
        "data.seq_len=16", "train.dtype=float32"]


def _batch(n=6, seed=3):
    """MLM examples with the tails of rows 1 and 4 padded (ids 0, mask 0),
    their MLM positions kept inside the real tokens."""
    arrays = make_mlm_source(n, 16, 64, seed).arrays
    b = {k: v.copy() for k, v in arrays.items()}
    for row, length in ((1, 9), (4, 12)):
        b["input_ids"][row, length:] = 0
        b["input_mask"][row, length:] = 0
        pos = b["mlm_positions"][row]
        b["mlm_positions"][row] = np.minimum(pos, length - 1)
    return b


@pytest.fixture(scope="module")
def jax_side():
    jcfg = j_overrides(j_preset("bert_base_wikipedia"), TINY)
    task = JaxMlmTask(jcfg)
    params = jax.jit(task.init)(jax.random.PRNGKey(0))["params"]
    flat = {n: np.asarray(v) for n, v in flatten_with_names(params)[0]}
    return jcfg, task, params, flat


def _port(flat):
    cfg = apply_overrides(get_preset("bert_base_wikipedia"), TINY)
    task = MlmTask(cfg, torch.device("cpu"))
    task.model.load_state_dict(params_from_flax(flat), strict=True)
    return task


@pytest.mark.parametrize("jax_impl", ["auto", "interpret"])
def test_logits_match_jax(jax_side, jax_impl):
    jcfg, _, params, flat = jax_side
    model = j_build_model("bert_tiny", 2, jnp.float32, hidden_size=32,
                          num_layers=2, num_heads=2, mlp_dim=64, max_len=32,
                          vocab_size=64, attention_impl=jax_impl)
    b = _batch()
    want = jax.jit(lambda p, *xs: model.apply({"params": p}, *xs,
                                              train=False))(
        params, b["input_ids"], b["input_mask"], b["segment_ids"],
        b["mlm_positions"])
    task = _port(flat)
    t = to_device(b, torch.device("cpu"))
    with torch.no_grad():
        got = task.model(t["input_ids"], t["input_mask"], t["segment_ids"],
                         t["mlm_positions"], train=False)
    for key in ("mlm_logits", "nsp_logits"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    # The padding matters: unpadding row 1 changes its logits.
    unpadded = {k: v.clone() for k, v in t.items()}
    unpadded["input_mask"][1] = 1
    with torch.no_grad():
        other = task.model(unpadded["input_ids"], unpadded["input_mask"],
                           unpadded["segment_ids"],
                           unpadded["mlm_positions"], train=False)
    assert not torch.allclose(other["mlm_logits"][1], got["mlm_logits"][1])
    assert torch.equal(other["mlm_logits"][0], got["mlm_logits"][0])


def test_gradients_match_jax_grad(jax_side):
    _, jtask, params, flat = jax_side
    b = _batch(n=8, seed=5)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def loss(p):
        return jtask.loss_fn(p, {}, jb, None, True)[0]

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss))(params)
    want = params_from_flax({n: np.asarray(v) for n, v in
                             flatten_with_names(j_grads)[0]})
    task = _port(flat)
    t_loss, aux = task.loss_fn(to_device(b, torch.device("cpu")), True)
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss),
                               rtol=1e-6)
    np.testing.assert_allclose(
        float((aux["mlm_loss"] + aux["nsp_loss"]).detach()), float(j_loss),
        rtol=1e-6)
    scale = max(float(v.abs().max()) for v in want.values())
    named = dict(task.model.named_parameters())
    assert set(named) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                   rtol=0, atol=1e-4 * scale, err_msg=name)


def test_bert_base_shapes_and_names_match_flax():
    jmodel = j_build_model("bert_base", 2, jnp.bfloat16)
    s, p = 128, 25
    ids = jnp.zeros((1, s), jnp.int32)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), ids,
                            jnp.ones((1, s), jnp.int32), ids,
                            jnp.zeros((1, p), jnp.int32), train=False))
    want = {"params/" + n: tuple(v.shape) for n, v in
            flatten_with_names(shapes["params"])[0]}
    model = build_model("bert_base", 2, torch.bfloat16, device="meta")
    assert sum(t.numel() for t in model.parameters()) == \
        sum(int(np.prod(v)) for v in want.values())
    layout = flax_layout(model)
    assert len(layout) == len(want)
    for name, _, t, kind in layout:
        shape = tuple(t.shape)
        if kind == "dense":
            shape = shape[::-1]
        assert want[name] == shape, name


def test_unported_bert_variants_name_their_roadmap_item():
    moe = build_task(apply_overrides(get_preset("bert_moe_wikipedia"), []),
                     torch.device("meta"))
    assert isinstance(moe, MlmTask)
    assert [lyr.num_experts for lyr in moe.model.encoder.layer] == \
        [0, 8] * 6
    pipelined = build_task(
        apply_overrides(get_preset("bert_pipelined_wikipedia"), []),
        torch.device("meta"))
    assert isinstance(pipelined, MlmTask)
    # bert_long is ported (tests/test_torch_long.py), and so is the MoE
    # trunk across processes: on the preset's expert=8 mesh over 8
    # processes each holds one expert of every MoE layer and the router
    # whole.
    from deeplearning_cfn_tpu_torch.models.bert_long import LongBert
    from deeplearning_cfn_tpu_torch.parallel import build_mesh, param_pieces

    long = build_task(apply_overrides(get_preset("bert_long_wikipedia"), []),
                      torch.device("meta"))
    assert isinstance(long, MlmTask) and isinstance(long.model, LongBert)
    cfg = apply_overrides(get_preset("bert_moe_wikipedia"), [])
    mesh = build_mesh(cfg.mesh, num_processes=8, index=3)
    task = build_task(cfg, torch.device("meta"), mesh=mesh)
    moe = task.model.encoder.layer[1].moe_mlp
    assert moe.num_experts == 8 and tuple(moe.w_in.shape) == (1, 768, 3072)
    assert tuple(moe.router.weight.shape) == (8, 768)
    pieces = param_pieces(task.model)
    assert len(pieces) == 4 * 6  # w_in, b_in, w_out, b_out of 6 layers
    assert {(p.axis, p.start, p.stop, p.whole) for p in pieces.values()} \
        == {("expert", 3, 4, 8)}
