"""The ``model`` mesh axis across processes (tensor parallelism:
``parallel/mesh.py``'s ``model`` group, ``parallel/sharding.py``'s column
and row pieces, ``parallel/collectives.py``'s ``model_copy``/``model_sum``,
``models/transformer.py``'s split ``Dense``, attention and MLP, LAMB,
ZeRO-1 and checkpoints of pieces along dim 1) against one process and
against the JAX package's meshes, on the CPU.

Four port processes in one gloo group (``tests/torch_dist_worker.py``,
spawned once for the module):

- op level: a seeded f32 post-LN ``TransformerLayer`` (self-attention +
  MLP, 4 heads) on ``model=4`` (one head each) and on ``(data=2,
  model=2)``: the output, the input's gradient and every parameter's
  gradient within 1e-6 of one process's layer on the global batch;
- model level, on ``(data=2, model=2)``: ``bert_base_wikipedia`` (LAMB,
  ``shard_opt_state=true``), ``gpt_small_lm`` (``gpt_tiny``) and
  ``transformer_nmt_wmt`` (its final eval's beam decode and BLEU
  included), and ``bert_long_wikipedia`` with ring attention on ``(data=1,
  seq=2, model=2)``, cut to vocab 64, hidden 32, 2 layers, 4 heads, f32,
  dropout 0, 3 steps from JAX's initial state on the same global batches,
  against JAX's ``Trainer`` on the same mesh (with the tasks'
  ``param_rules``) over four fake devices and against the port's
  one-process run: losses within ``rtol=1e-5`` and parameters within 1e-5
  (the key projections' biases left out, as in ``test_torch_dist.py``),
  and every split kernel written as pieces (JAX's own test asserts 12 or
  more split leaves);
- dropout 0.1 on ``(data=2, model=2)``: after 3 steps every replicated
  parameter is bit-equal across each ``model`` group (the processes of a
  group draw the same masks on the activations they share);
- checkpoints: the BERT run's checkpoint (query, key, value and
  ``mlp_in`` pieces written with their dim-1 range) restores in JAX's
  ``restore_checkpoint`` with whole leaves; JAX's checkpoint of its GPT
  run restores into the four port processes, each keeping its pieces,
  which train on as JAX does;
- the mesh: every rank's coordinates and its ``model``, data and holder
  groups for ``(data=-1, model=2)`` over 4 match JAX's device array.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from deeplearning_cfn_tpu.ckpt import restore_checkpoint as j_restore
from deeplearning_cfn_tpu.ckpt import save_checkpoint as j_save
from deeplearning_cfn_tpu.config import MeshConfig
from deeplearning_cfn_tpu.config import apply_overrides as j_overrides
from deeplearning_cfn_tpu.parallel import build_mesh as j_build_mesh
from deeplearning_cfn_tpu.presets import get_preset as j_preset
from deeplearning_cfn_tpu.train import create_train_state
from deeplearning_cfn_tpu.train import optim as joptim
from deeplearning_cfn_tpu.train.task import build_task as j_build_task
from deeplearning_cfn_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.ckpt import read_leaves
from deeplearning_cfn_tpu_torch.config import apply_overrides
from deeplearning_cfn_tpu_torch.data.pipeline import build_pipeline
from deeplearning_cfn_tpu_torch.parallel import build_mesh
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.runtime.cluster import free_local_port

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_worker import seeded_tp_layer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
WORLD, STEPS, MORE = 4, 3, 2

TP_SHAPE = [4, 8, 16, 4, 32]  # batch, sequence, features, heads, mlp
OPS = [dict(kind="tp_layer", name="tp-model4", mesh=dict(data=1, model=4),
            seed=31, shape=TP_SHAPE),
       dict(kind="tp_layer", name="tp-data2-model2",
            mesh=dict(data=2, model=2), seed=32, shape=TP_SHAPE)]

COMMON = ["model.kwargs.max_len=32", "data.vocab_size=64", "data.seq_len=32",
          "train.dtype=float32", "data.num_train_examples=128",
          "data.num_eval_examples=16", "train.global_batch=16",
          "schedule.warmup_steps=2"]
WIDTHS = ["model.kwargs.hidden_size=32", "model.kwargs.num_layers=2",
          "model.kwargs.num_heads=4", "model.kwargs.mlp_dim=64"]
BERT = COMMON + WIDTHS + ["schedule.base_lr=5e-3",
                          "train.shard_opt_state=true",
                          "model.kwargs.dropout_rate=0.0"]
GPT = COMMON + ["model.name=gpt_tiny", "model.kwargs.vocab_size=64",
                "model.kwargs.dropout_rate=0.0", "schedule.base_lr=3e-3"]
NMT = [o for o in COMMON if "seq_len" not in o and "max_len" not in o] \
    + WIDTHS + ["data.seq_len=16", "model.kwargs.max_len=64",
                "model.kwargs.dropout_rate=0.0", "schedule.base_lr=3e-3",
                "eval.max_decode_len=8", "eval.beam_size=2",
                "train.eval_batch=8"]
LONG = COMMON + WIDTHS + ["model.kwargs.seq_impl=ring",
                          "schedule.base_lr=5e-3"]
DATA2_MODEL2 = dict(data=2, model=2)
# name: (preset, overrides, mesh)
CASES = {
    "bert": ("bert_base_wikipedia", BERT, DATA2_MODEL2),
    "gpt": ("gpt_small_lm", GPT, DATA2_MODEL2),
    "nmt": ("transformer_nmt_wmt", NMT, DATA2_MODEL2),
    "bert_long": ("bert_long_wikipedia", LONG, dict(data=1, seq=2, model=2)),
}
DROPOUT = ("bert_base_wikipedia",
           [o for o in BERT if "dropout" not in o]
           + ["model.kwargs.dropout_rate=0.1"], DATA2_MODEL2)
JAX_ONLY = ["model.kwargs.attention_impl=interpret"]
LOSS_RTOL, PARAM_TOL, OP_TOL = 1e-5, 1e-5, 1e-6


def _mesh_over(mesh):
    return [f"mesh.{k}={v}" for k, v in {**dict(data=1, seq=1, model=1),
                                         **mesh}.items()]


def _jax_state(preset, over, mesh_axes, steps):
    """JAX's initial state on ``mesh_axes`` over four fake devices, the
    kernels placed by the task's ``param_rules`` (its leaves, and the count
    of leaves split over ``model``), and the function that trains it with
    JAX's ``Trainer`` on given batches; with ``more`` that function then
    checkpoints into ``ckpt`` and trains on."""
    # JAX's long trunk takes no attention_impl (its attention is the
    # sequence-parallel one).
    jcfg = j_overrides(j_preset(preset), over + _mesh_over(mesh_axes)
                       + ([] if preset == "bert_long_wikipedia"
                          else JAX_ONLY))
    mesh = j_build_mesh(MeshConfig(**mesh_axes), devices=jax.devices()[:4])
    task = j_build_task(jcfg, mesh=mesh)
    tx = joptim.build_optimizer(jcfg.optimizer, joptim.build_schedule(
        jcfg.schedule, steps, jcfg.train.global_batch))
    state = create_train_state(jax.random.PRNGKey(0), task.init, tx, mesh,
                               param_rules=task.param_rules,
                               shard_opt_state=jcfg.train.shard_opt_state)
    split = sum(1 for leaf in jax.tree_util.tree_leaves(state.params)
                if "model" in (getattr(leaf.sharding, "spec", None) or ()))
    init = {n: np.asarray(v) for n, v in flatten_with_names(state)[0]
            if v is not None}

    def train(batches, more=(), ckpt=None):
        trainer = JaxTrainer(jcfg, task.loss_fn, tx, mesh=mesh, donate=False)
        st, losses = state, []
        for b in batches:
            st, metrics = trainer.train_step(
                st, trainer.device_batch(b), jax.random.PRNGKey(1))
            losses.append(float(metrics["loss"]))
        params = {"params/" + n: np.asarray(v)
                  for n, v in flatten_with_names(st.params)[0]}
        out = dict(losses=losses, params=params, state=st, split=split)
        if more:
            j_save(ckpt, len(batches), st)
            after, later = [], st
            for b in more:
                later, metrics = trainer.train_step(
                    later, trainer.device_batch(b), jax.random.PRNGKey(1))
                after.append(float(metrics["loss"]))
            out["resumed"] = (after, later)
        return out

    return init, train


def _batches(cfg, n, train=True):
    return [b for _, b in zip(range(n), build_pipeline(
        cfg.data, cfg.train.global_batch if train else cfg.train.eval_batch,
        cfg.model.num_classes, seed=0, train=train).one_epoch())]


def _save_batches(path, batches):
    np.savez(path, **{f"{i}/{k}": v for i, b in enumerate(batches)
                      for k, v in b.items()})


def _whole(parts):
    """Leaves of every process: pieces (``name::first row`` along dim 0,
    ``name::dim:first index`` along another) put together into whole
    leaves."""
    out, pieces = {}, {}
    for leaves in parts:
        for k, v in leaves.items():
            if "::" in k:
                name, at = k.rsplit("::", 1)
                dim, start = (int(x) for x in at.split(":")) \
                    if ":" in at else (0, int(at))
                pieces.setdefault(name, {})[start] = (dim, v)
            elif not k.startswith("local/"):
                out[k] = v
    for name, by_start in pieces.items():
        dim = by_start[min(by_start)][0]
        out[name] = np.concatenate([by_start[s][1] for s in sorted(by_start)],
                                   axis=dim)
    return out


def _start(root, ops, cases):
    """The four worker processes of one spawn, started."""
    spec = root / "spec.json"
    spec.write_text(json.dumps(dict(world=WORLD, port=free_local_port(),
                                    out=str(root), ops=ops, cases=cases)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO, os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen([sys.executable, WORKER, str(spec), str(r)],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]


def _wait(procs):
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]


def _parts(root, name):
    parts = []
    for r in range(WORLD):
        with np.load(root / f"{name}-p{r}.npz") as data:
            parts.append({k: data[k] for k in data.files})
    return parts


def _one_process(cfg, batches, init, eval_batches=None):
    """The port's one-process run (and its final eval) on the same global
    batches."""
    import chip_smoke
    from deeplearning_cfn_tpu_torch.train.task import build_task

    losses, state = chip_smoke.fed_run(torch, cfg, batches, "cpu",
                                       init=init)
    final = None
    if eval_batches is not None:
        task = build_task(cfg, torch.device("cpu"))
        task.model = state.model
        final = task.final_eval(state, lambda: iter(eval_batches))
    return losses, state, final


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's initial states and GPT's JAX run with its checkpoint; one
    spawn of four port processes for the ops and every case, which runs
    while this process trains JAX on the other cases and runs the port's
    one process on each."""
    root = tmp_path_factory.mktemp("model_axis")
    cases, states, data = [], {}, {}
    for name, (preset, over, mesh) in CASES.items():
        cfg = apply_overrides(get_preset(preset), over)
        batches = _batches(cfg, STEPS)
        init, train = states[name] = _jax_state(preset, over, mesh, STEPS)
        np.savez(root / f"{name}-init.npz", **init)
        _save_batches(root / f"{name}-batches.npz", batches)
        case = dict(name=name, preset=preset, overrides=over
                    + _mesh_over(mesh), init=str(root / f"{name}-init.npz"),
                    batches=str(root / f"{name}-batches.npz"),
                    ckpt=str(root / f"{name}-ckpt") if name == "bert"
                    else None)
        eval_batches = None
        if name == "nmt":
            eval_batches = _batches(cfg, 2, train=False)
            _save_batches(root / "nmt-eval.npz", eval_batches)
            case["eval_batches"] = str(root / "nmt-eval.npz")
        cases.append(case)
        data[name] = (cfg, batches, init, eval_batches)
    # GPT's JAX run first: the port resumes its checkpoint.
    cfg = data["gpt"][0]
    more = _batches(cfg, STEPS + MORE)[STEPS:]
    jax_side = {"gpt": states["gpt"][1](data["gpt"][1], more,
                                        str(root / "jax-ckpt"))}
    _save_batches(root / "from_jax-batches.npz", more)
    cases.append(dict(cases[1], name="from_jax", ckpt=None,
                      restore=str(root / "jax-ckpt"), restore_step=STEPS,
                      total_steps=STEPS,
                      batches=str(root / "from_jax-batches.npz")))
    preset, over, mesh = DROPOUT
    cases.append(dict(cases[0], name="dropout", ckpt=None, all_params=True,
                      overrides=over + _mesh_over(mesh)))
    procs = _start(root, OPS, cases)
    single = {}
    try:
        for name, (cfg, batches, init, eval_batches) in data.items():
            if name not in jax_side:
                jax_side[name] = states[name][1](batches)
            single[name] = _one_process(cfg, batches, init, eval_batches)
    finally:
        _wait(procs)
    port_side = {}
    for case in cases:
        parts = _parts(root, case["name"])
        port_side[case["name"]] = (
            json.loads((root / f"{case['name']}.json").read_text()),
            _whole(parts), parts)
    return dict(root=root, jax=jax_side, port=port_side, single=single)


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("name", ["tp-model4", "tp-data2-model2"])
def test_tensor_parallel_layer_matches_one_process(runs, name):
    """Each process's output rows are the one-process layer's; the input's
    gradient parts add up over the model group, the replicated leaves'
    over every process, and each piece's over its holders, to the
    one-process gradients."""
    op = next(o for o in OPS if o["name"] == name)
    layer, x, proj = seeded_tp_layer(TP_SHAPE, op["seed"])
    xt = torch.tensor(x, requires_grad=True)
    y = layer(xt)
    (y * torch.from_numpy(proj)).sum().backward()
    want = {n: p.grad.numpy() for n, p in layer.named_parameters()}
    got = {n: np.zeros_like(v) for n, v in want.items()}
    got_dx = np.zeros_like(x)
    parts = _op_parts(runs, name)
    for part in parts:
        rows = slice(*part["rows"])
        _close(part["out"], y.detach().numpy()[rows], OP_TOL, "out")
        got_dx[rows] += part["dx"]
        for n in got:
            g = part[f"grad/{n}"]
            if f"range/{n}" in part:
                dim, start, stop = part[f"range/{n}"]
                at = [slice(None)] * g.ndim
                at[dim] = slice(start, stop)
                got[n][tuple(at)] += g
            else:
                got[n] += g
    assert sum(f"range/{n}" in parts[0] for n in want) == 6
    _close(got_dx, xt.grad.numpy(), OP_TOL, "dx")
    for n, v in want.items():
        _close(got[n], v, OP_TOL, n)


def _op_parts(runs, name):
    return _parts(runs["root"], name)


def _compared(names):
    # The key projections' biases are left out, as in
    # tests/test_torch_dist.py: their true gradient is 0, and LAMB's
    # normalised update turns rounding noise there into steps of random
    # sign that no output can see.
    return [n for n in names if not n.endswith("key/bias")]


def _params(state):
    return {n: v for n, v in state.named_leaves() if n.startswith("params/")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_mesh_trains_as_jax_and_as_one_process(runs, name):
    _, _, mesh = CASES[name]
    jax_run = runs["jax"][name]
    record, leaves, parts = runs["port"][name]
    one_losses, one_state, _ = runs["single"][name]
    np.testing.assert_allclose(record["losses"], jax_run["losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(record["losses"], one_losses,
                               rtol=LOSS_RTOL)
    # The steps moved the loss far beyond the bound.
    losses = record["losses"]
    assert max(abs(x - losses[0]) for x in losses) \
        > 100 * LOSS_RTOL * losses[0]
    one = _params(one_state)
    compared = _compared(jax_run["params"])
    assert len(compared) > 20
    for n in compared:
        np.testing.assert_allclose(leaves[n], jax_run["params"][n],
                                   rtol=PARAM_TOL, atol=PARAM_TOL, err_msg=n)
        np.testing.assert_allclose(leaves[n], one[n], rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=n)
    # The kernels really split: JAX placed 12 or more leaves on 'model',
    # each process held (and wrote) only its piece of those, and the
    # model group's sums ran.
    assert jax_run["split"] >= 12
    split = {k.rsplit("::", 1)[0] for p in parts for k in p
             if "::" in k and k.startswith("params/")}
    assert len(split) == jax_run["split"]
    assert record["comm_calls"].get("model", 0) > 0
    for leaf in split:
        kind = "(query|key|value|mlp_in)" if leaf.endswith((
            "query/kernel", "key/kernel", "value/kernel", "mlp_in/kernel")) \
            else "(attn_out|mlp_out)"
        want_dim = 1 if kind.startswith("(query") else 0
        starts = sorted(k.rsplit("::", 1)[1] for p in parts for k in p
                        if k.startswith(leaf + "::"))
        n = jax_run["params"][leaf].shape[want_dim] // mesh["model"]
        want = [f"1:{n * i}" if want_dim else str(n * i)
                for i in range(mesh["model"])]
        assert starts == sorted(want), (leaf, starts)


def test_nmt_bleu_decodes_under_the_mesh(runs):
    """The NMT's final eval (beam decode with the local heads' KV caches)
    under ``(data=2, model=2)`` scores what one process scores, each
    eval row once."""
    record, _, _ = runs["port"]["nmt"]
    _, _, one_final = runs["single"]["nmt"]
    assert set(record["final_eval"]) == {"bleu"}
    np.testing.assert_allclose(record["final_eval"]["bleu"],
                               one_final["bleu"], rtol=1e-6, atol=1e-9)


def test_dropout_keeps_each_model_group_equal(runs):
    """With dropout 0.1, the processes of each model group draw the same
    masks: every parameter held whole is bit-equal across the group after
    3 steps, and the two groups (other rows, other masks) differ."""
    from deeplearning_cfn_tpu_torch.models.transformer import Dense

    record, _, parts = runs["port"]["dropout"]
    assert all(np.isfinite(record["losses"]))
    cfg = apply_overrides(get_preset(DROPOUT[0]),
                          DROPOUT[1] + _mesh_over(DROPOUT[2]))
    mesh = build_mesh(cfg.mesh, num_processes=WORLD, index=0)
    from deeplearning_cfn_tpu_torch.train.task import build_task

    model = build_task(cfg, torch.device("cpu"), mesh=mesh).model
    split = {f"{m}.weight" for m, mod in model.named_modules()
             if isinstance(mod, Dense) and mod.split is not None}
    whole = [k[len("local/"):] for k in parts[0] if k.startswith("local/")
             and k[len("local/"):] not in split]
    assert len(whole) > 20
    for r in range(WORLD):
        peers = build_mesh(cfg.mesh, num_processes=WORLD,
                           index=r).model_ranks
        for n in whole:
            np.testing.assert_array_equal(parts[r][f"local/{n}"],
                                          parts[peers[0]][f"local/{n}"],
                                          err_msg=f"{n} on rank {r}")
    # Process 0's and process 2's groups (data blocks 0 and 1) hold other
    # rows and draw other masks; the gradients are summed, so the weights
    # are still equal across them.
    assert build_mesh(cfg.mesh, num_processes=WORLD, index=2).data_index \
        == 1


def test_model_checkpoint_restores_in_jax_with_whole_leaves(runs):
    ckpt = str(runs["root"] / "bert-ckpt")
    with open(os.path.join(ckpt, f"step_{STEPS:08d}",
                           "manifest_p1.json")) as fh:
        p1 = json.load(fh)["leaves"]
    # Process 1 (model 1, data 0) wrote its columns of the query kernel
    # (dim 1) and its rows of attn_out (dim 0).
    q = "params/encoder/layer_0/self_attn/query/kernel"
    o = "params/encoder/layer_0/self_attn/attn_out/kernel"
    assert p1[q][0]["index"] == [[0, 32], [16, 32]]
    assert p1[o][0]["index"] == [[16, 32], [0, 32]]
    j_state = runs["jax"]["bert"]["state"]
    restored, step = j_restore(ckpt, j_state)
    assert step == STEPS
    got = {n: np.asarray(v) for n, v in flatten_with_names(restored)[0]
           if v is not None}
    port = read_leaves(ckpt, STEPS)
    assert set(got) == set(port)
    assert got[q].shape == (32, 32)
    for n, v in got.items():
        np.testing.assert_array_equal(v, port[n], err_msg=n)
    trained = {n: np.asarray(v) for n, v in flatten_with_names(j_state)[0]
               if v is not None}
    for n in _compared(n for n in got if n.startswith("params/")):
        np.testing.assert_allclose(got[n], trained[n], rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=n)


def test_model_processes_resume_a_jax_checkpoint(runs):
    """JAX's checkpoint of its ``(data=2, model=2)`` GPT run, restored by
    the four port processes: each keeps its pieces (and their AdamW
    slots) and they train on as JAX does."""
    j_losses, j_state = runs["jax"]["gpt"]["resumed"]
    record, leaves, parts = runs["port"]["from_jax"]
    np.testing.assert_allclose(record["losses"], j_losses, rtol=LOSS_RTOL)
    assert len(record["losses"]) == MORE
    q = "params/layer_0/self_attn/query/kernel"
    for r, part in enumerate(parts):
        model_index = build_mesh(MeshConfig(**DATA2_MODEL2),
                                 num_processes=WORLD, index=r).model_index
        if r < 2:  # the first of each piece's holders writes it
            assert f"{q}::1:{32 * model_index}" in part
    want = {n: np.asarray(v) for n, v in flatten_with_names(j_state)[0]
            if v is not None}
    assert int(want["step"]) == STEPS + MORE
    compared = _compared(n for n in leaves if n.startswith(
        ("params/", "opt_state/")))
    assert len(compared) > 20 and set(compared) <= set(want)
    for n in compared:
        np.testing.assert_allclose(leaves[n], want[n], rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=n)


@pytest.mark.parametrize("rank", range(4))
def test_mesh_resolves_model_coordinates_as_jax(rank):
    """``(data=-1, model=2)`` over 4 processes: each process sits where
    JAX's mesh puts the device of its index; its model, data and holder
    groups are the devices along JAX's axes; the processes of a model group
    read the same rows; a kernel's piece is the range at its coordinate."""
    from deeplearning_cfn_tpu_torch.parallel import batch_sharding

    cfg = MeshConfig(data=-1, model=2)
    j_mesh = j_build_mesh(cfg, devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(j_mesh.devices)
    names = j_mesh.axis_names
    mesh = build_mesh(cfg, num_processes=4, index=rank)
    assert dict(j_mesh.shape) == mesh.shape
    at = tuple(mesh.coords[a] for a in names)
    assert ids[at] == rank

    def along(*axes_):
        idx = tuple(slice(None) if a in axes_ else at[i]
                    for i, a in enumerate(names))
        return [int(x) for x in ids[idx].reshape(-1)]

    assert mesh.model_ranks == along("model")
    assert mesh.data_ranks == along("dcn_data", "data", "expert")
    assert mesh.holder_ranks("model") == along(
        *[a for a in names if a != "model"])
    assert (mesh.model_index, mesh.model_ways) == (at[names.index("model")],
                                                   2)
    assert mesh.replicas == 2 and mesh.data_ways == 2
    assert batch_sharding(mesh, 8) == slice(4 * mesh.data_index,
                                            4 * mesh.data_index + 4)
