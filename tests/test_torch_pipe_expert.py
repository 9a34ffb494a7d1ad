"""The ``pipe`` and ``expert`` mesh axes across processes
(``parallel/mesh.py``'s groups, ``parallel/sharding.py``'s pieces,
``ops/pipeline.py:gpipe``, ``models/moe.py``'s all-to-all dispatch, the
group-aware sums, LAMB, ZeRO-1 and checkpoints of split leaves) against one
process and against the JAX package's meshes, on the CPU.

Four port processes in one gloo group (``tests/torch_dist_worker.py``,
spawned once for the module):

- op level: ``gpipe`` of a seeded 4-layer ``tanh`` stage function with 4
  microbatches on ``pipe=4`` and on ``(data=2, pipe=2)``, the output and
  the input and parameter gradients within 1e-6 of ``scan_layers`` on one
  process; a seeded f32 ``MoeMlp`` (8 experts, top-2) on ``expert=4`` (2
  experts each) and on ``(data=2, expert=2)``, the output, both aux losses
  and every gradient within 1e-5 of one process's ``MoeMlp`` on the global
  batch (every router margin above 1e-6, so no choice can flip);
- model level: ``bert_pipelined_wikipedia`` on ``(data=1, pipe=4)`` and
  ``(data=2, pipe=2)`` and ``bert_moe_wikipedia`` on ``(data=2, expert=2)``
  and ``(data=1, expert=4)``, cut to vocab 64, hidden 32, 4 layers, 4
  heads, sequence 32, f32, dropout 0, under the presets' LAMB with
  ``shard_opt_state=true`` (ZeRO-1 over the holders of each piece), 3
  steps from JAX's initial state on the same global batches, against JAX's
  ``Trainer`` on the same mesh over four fake devices and against the
  port's one-process run: losses within ``rtol=1e-5`` and parameters
  within 1e-5, the ``bert_zero1`` bounds of ``tests/test_torch_dist.py``;
- checkpoints: the ``(data=2, pipe=2)`` run's checkpoint (each stage's
  layers written as rows of the ``[L, ...]`` leaves) restores in JAX's
  ``restore_checkpoint`` with whole leaves, equal to the port's reading;
  JAX's checkpoint of its ``(data=1, expert=4)`` run restores into the four
  port processes, each keeping its experts, which train on as JAX does.
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
from deeplearning_cfn_tpu_torch.models.moe import MoeMlp
from deeplearning_cfn_tpu_torch.ops.pipeline import scan_layers
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.runtime.cluster import free_local_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
WORLD, STEPS, MORE = 4, 3, 2

GPIPE_SHAPE = [8, 6, 4]  # batch, features, layers
MOE_SHAPE = [4, 16, 8, 8, 12]  # batch, sequence, features, experts, mlp
OPS = [dict(kind="gpipe", name="gpipe-pipe4", mesh=dict(data=1, pipe=4),
            seed=21, shape=GPIPE_SHAPE, m=4),
       dict(kind="gpipe", name="gpipe-data2-pipe2",
            mesh=dict(data=2, pipe=2), seed=22, shape=GPIPE_SHAPE, m=4),
       dict(kind="moe", name="moe-expert4", mesh=dict(data=1, expert=4),
            seed=23, shape=MOE_SHAPE),
       dict(kind="moe", name="moe-data2-expert2",
            mesh=dict(data=2, expert=2), seed=24, shape=MOE_SHAPE)]

TINY = ["model.kwargs.hidden_size=32", "model.kwargs.num_layers=4",
        "model.kwargs.num_heads=4", "model.kwargs.mlp_dim=64",
        "model.kwargs.max_len=32", "data.vocab_size=64", "data.seq_len=32",
        "train.dtype=float32", "data.num_train_examples=128",
        "data.num_eval_examples=16", "train.global_batch=16",
        "schedule.warmup_steps=2", "schedule.base_lr=5e-3",
        "train.shard_opt_state=true"]
PIPE = TINY + ["model.kwargs.n_microbatches=4"]
MOE = TINY + ["model.kwargs.dropout_rate=0.0"]
# name: (preset, overrides, mesh)
CASES = {
    "pipe4": ("bert_pipelined_wikipedia", PIPE, dict(data=1, pipe=4)),
    "data2_pipe2": ("bert_pipelined_wikipedia", PIPE, dict(data=2, pipe=2)),
    "data2_expert2": ("bert_moe_wikipedia", MOE, dict(data=2, expert=2)),
    "expert4": ("bert_moe_wikipedia", MOE, dict(data=1, expert=4)),
}
JAX_ONLY = ["model.kwargs.attention_impl=interpret"]
LOSS_RTOL, PARAM_TOL = 1e-5, 1e-5


def _mesh_over(mesh):
    return [f"mesh.{k}={v}" for k, v in {**dict(data=1, pipe=1, expert=1),
                                         **mesh}.items()]


def _jax_run(preset, over, mesh_axes, batches, more=(), ckpt=None):
    """JAX's ``Trainer`` on ``mesh_axes`` over four fake devices; with
    ``more`` it then checkpoints into ``ckpt`` and trains on."""
    jcfg = j_overrides(j_preset(preset), over + JAX_ONLY
                       + _mesh_over(mesh_axes))
    mesh = j_build_mesh(MeshConfig(**mesh_axes), devices=jax.devices()[:4])
    task = j_build_task(jcfg, mesh=mesh)
    tx = joptim.build_optimizer(jcfg.optimizer, joptim.build_schedule(
        jcfg.schedule, len(batches), jcfg.train.global_batch))
    state = create_train_state(jax.random.PRNGKey(0), task.init, tx, mesh,
                               shard_opt_state=jcfg.train.shard_opt_state)
    init = {n: np.asarray(v) for n, v in flatten_with_names(state)[0]
            if v is not None}
    trainer = JaxTrainer(jcfg, task.loss_fn, tx, mesh=mesh, donate=False)
    losses = []
    for b in batches:
        state, metrics = trainer.train_step(
            state, trainer.device_batch(b), jax.random.PRNGKey(1))
        losses.append(float(metrics["loss"]))
    params = {"params/" + n: np.asarray(v)
              for n, v in flatten_with_names(state.params)[0]}
    if not more:
        return init, losses, params, state, None
    j_save(ckpt, len(batches), state)
    after, later = [], state
    for b in more:
        later, metrics = trainer.train_step(
            later, trainer.device_batch(b), jax.random.PRNGKey(1))
        after.append(float(metrics["loss"]))
    return init, losses, params, state, (after, later)


def _batches(cfg, n):
    return [b for _, b in zip(range(n), build_pipeline(
        cfg.data, cfg.train.global_batch, cfg.model.num_classes,
        seed=0).one_epoch())]


def _save_batches(path, batches):
    np.savez(path, **{f"{i}/{k}": v for i, b in enumerate(batches)
                      for k, v in b.items()})


def _whole(parts):
    """Leaves of every process: pieces (``name::first row``) put together
    into whole leaves."""
    out, pieces = {}, {}
    for leaves in parts:
        for k, v in leaves.items():
            if "::" in k:
                name, start = k.rsplit("::", 1)
                pieces.setdefault(name, {})[int(start)] = v
            else:
                out[k] = v
    for name, by_start in pieces.items():
        out[name] = np.concatenate([by_start[s] for s in sorted(by_start)])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs, then one spawn of four port processes for the ops and
    every case; the one-process runs of each preset in this process."""
    import chip_smoke

    root = tmp_path_factory.mktemp("pipe_expert")
    cases, jax_side, single = [], {}, {}
    for name, (preset, over, mesh) in CASES.items():
        cfg = apply_overrides(get_preset(preset), over)
        batches = _batches(cfg, STEPS)
        resume = name == "expert4"
        more = _batches(cfg, STEPS + MORE)[STEPS:] if resume else ()
        init, losses, params, state, resumed = _jax_run(
            preset, over, mesh, batches, more, str(root / "jax-ckpt"))
        jax_side[name] = (losses, params, state)
        np.savez(root / f"{name}-init.npz", **init)
        _save_batches(root / f"{name}-batches.npz", batches)
        cases.append(dict(name=name, preset=preset,
                          overrides=over + _mesh_over(mesh),
                          init=str(root / f"{name}-init.npz"),
                          batches=str(root / f"{name}-batches.npz"),
                          ckpt=str(root / f"{name}-ckpt")
                          if name == "data2_pipe2" else None))
        if preset not in single:
            single[preset] = chip_smoke.fed_run(
                torch, apply_overrides(get_preset(preset), over), batches,
                "cpu", init=init)
        if resume:
            jax_side["from_jax"] = resumed
            _save_batches(root / "from_jax-batches.npz", more)
            cases.append(dict(cases[-1], name="from_jax", ckpt=None,
                              restore=str(root / "jax-ckpt"),
                              restore_step=STEPS, total_steps=STEPS,
                              batches=str(root / "from_jax-batches.npz")))
    spec = root / "spec.json"
    spec.write_text(json.dumps(dict(world=WORLD, port=free_local_port(),
                                    out=str(root), ops=OPS, cases=cases)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, WORKER, str(spec), str(r)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    port_side = {}
    for case in cases:
        parts = []
        for r in range(WORLD):
            with np.load(root / f"{case['name']}-p{r}.npz") as data:
                parts.append({k: data[k] for k in data.files})
        port_side[case["name"]] = (
            json.loads((root / f"{case['name']}.json").read_text()),
            _whole(parts), parts)
    return dict(root=root, jax=jax_side, port=port_side, single=single)


def _op_parts(runs, name):
    parts = []
    for r in range(WORLD):
        with np.load(runs["root"] / f"{name}-p{r}.npz") as data:
            parts.append({k: data[k] for k in data.files})
    return parts


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("name", ["gpipe-pipe4", "gpipe-data2-pipe2"])
def test_gpipe_over_processes_matches_the_scan(runs, name):
    op = next(o for o in OPS if o["name"] == name)
    b, f, layers = GPIPE_SHAPE
    rng = np.random.RandomState(op["seed"])
    w = torch.tensor(rng.normal(0, 0.5, (layers, f, f)).astype(np.float32),
                     requires_grad=True)
    bias = torch.tensor(rng.normal(0, 0.5, (layers, f)).astype(np.float32),
                        requires_grad=True)
    x = torch.tensor(rng.standard_normal((b, f)).astype(np.float32),
                     requires_grad=True)
    proj = torch.from_numpy(rng.standard_normal((b, f)).astype(np.float32))
    stage = scan_layers(lambda p, st: {"h": torch.tanh(st["h"] @ p["w"]
                                                       + p["b"])})
    out = stage({"w": w, "b": bias}, {"h": x})["h"]
    (out * proj).sum().backward()
    got_dx, got_dw, got_db = (np.zeros_like(t.detach().numpy())
                              for t in (x, w, bias))
    for part in _op_parts(runs, name):
        rows, mine = slice(*part["rows"]), slice(*part["layers"])
        # Every stage holds the last stage's output for its rows.
        _close(part["out"], out.detach().numpy()[rows], 1e-6, "out")
        got_dx[rows] += part["dx"]  # stage 0's; the others give zeros
        got_dw[mine] += part["dw"]  # summed over the data ways
        got_db[mine] += part["db"]
    _close(got_dx, x.grad.numpy(), 1e-6, "dx")
    _close(got_dw, w.grad.numpy(), 1e-6, "dw")
    _close(got_db, bias.grad.numpy(), 1e-6, "db")


@pytest.mark.parametrize("name", ["moe-expert4", "moe-data2-expert2"])
def test_moe_over_processes_matches_one_process(runs, name):
    op = next(o for o in OPS if o["name"] == name)
    b, s, f, e, m = MOE_SHAPE
    rng = np.random.RandomState(op["seed"])
    x = torch.tensor(rng.standard_normal((b, s, f)).astype(np.float32),
                     requires_grad=True)
    proj = torch.from_numpy(rng.standard_normal((b, s, f))
                            .astype(np.float32))
    weights = {k: rng.normal(0, 0.5, shape).astype(np.float32)
               for k, shape in (("router", (e, f)), ("w_in", (e, f, m)),
                                ("b_in", (e, m)), ("w_out", (e, m, f)),
                                ("b_out", (e, f)))}
    moe = MoeMlp(f, e, m, dtype=torch.float32)
    with torch.no_grad():
        moe.router.weight.copy_(torch.from_numpy(weights["router"]))
        for k in ("w_in", "b_in", "w_out", "b_out"):
            getattr(moe, k).copy_(torch.from_numpy(weights[k]))
    y, aux = moe(x)
    ((y * proj).sum() + aux["load_balance"] + aux["router_z"]).backward()
    # No token sits near a tie between its choices: the processes' f32
    # rounding cannot flip a route.
    with torch.no_grad():
        probs = torch.softmax(moe.router(x), -1).sort(-1, descending=True)
        margins = probs.values[..., :2] - probs.values[..., 1:3]
    assert float(margins.min()) > 1e-6
    parts = _op_parts(runs, name)
    for key in ("load_balance", "router_z"):
        # Each process returns its share; the shares add up.
        np.testing.assert_allclose(sum(float(p[key]) for p in parts),
                                   float(aux[key].detach()), rtol=1e-5)
    got = {k: np.zeros(getattr(moe, k).shape, np.float32)
           for k in ("w_in", "b_in", "w_out", "b_out")}
    got_router, got_dx = np.zeros((e, f), np.float32), np.zeros(
        (b, s, f), np.float32)
    for part in parts:
        rows, experts = slice(*part["rows"]), slice(*part["experts"])
        _close(part["out"], y.detach().numpy()[rows], 1e-5, "out")
        got_dx[rows] += part["dx"]
        got_router += part["router"]
        for k in got:
            got[k][experts] += part[k]
    _close(got_dx, x.grad.numpy(), 1e-5, "dx")
    _close(got_router, moe.router.weight.grad.numpy(), 1e-5, "router")
    for k, v in got.items():
        _close(v, getattr(moe, k).grad.numpy(), 1e-5, k)


def _one_process_params(runs, preset):
    _, state = runs["single"][preset]
    return {n: v for n, v in state.named_leaves() if n.startswith("params/")}


def _compared(names):
    # The key projections' biases are left out, as in
    # tests/test_torch_dist.py: their true gradient is 0, and LAMB's
    # normalised update turns rounding noise there into steps of random
    # sign that no output can see.
    return [n for n in names if not n.endswith(("key/bias", "pipe_stack/bk"))]


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_trains_as_jax_and_as_one_process(runs, name):
    preset, _, mesh = CASES[name]
    j_losses, j_params, _ = runs["jax"][name]
    record, leaves, parts = runs["port"][name]
    one_losses, _ = runs["single"][preset]
    np.testing.assert_allclose(record["losses"], j_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(record["losses"], one_losses,
                               rtol=LOSS_RTOL)
    # The steps moved the loss far beyond the bound (the comparison sees
    # training, not the initial state).
    losses = record["losses"]
    assert max(abs(x - losses[0]) for x in losses) \
        > 100 * LOSS_RTOL * losses[0]
    one = _one_process_params(runs, preset)
    compared = _compared(j_params)
    assert len(compared) > 20
    for n in compared:
        np.testing.assert_allclose(leaves[n], j_params[n], rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=n)
        np.testing.assert_allclose(leaves[n], one[n], rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=n)
    # The mesh really split the work: the stage hops or the all-to-alls
    # ran, and each process held (and wrote) only its piece of a split
    # leaf.
    axis = "pipe" if "pipe" in mesh else "expert"
    assert record["comm_calls"].get(axis, 0) > 0
    leaf = "params/pipe_stack/w_in" if axis == "pipe" \
        else "params/encoder/layer_1/moe_mlp/w_in"
    starts = sorted(int(k.rsplit("::", 1)[1]) for p in parts for k in p
                    if k.startswith(leaf + "::"))
    rows = j_params[leaf].shape[0] // mesh[axis]
    assert starts == [rows * i for i in range(mesh[axis])]
    # ZeRO-1 over the holders of each piece: each process holds a share of
    # the slots.
    assert record["slot_bytes"] < 0.8 * record["slot_bytes_all"]


def test_pipe_checkpoint_restores_in_jax_with_whole_leaves(runs):
    ckpt = str(runs["root"] / "data2_pipe2-ckpt")
    with open(os.path.join(ckpt, f"step_{STEPS:08d}",
                           "manifest_p2.json")) as fh:
        p2 = json.load(fh)["leaves"]
    # Process 2 (stage 1, data 0) wrote the rows of its stage's layers.
    assert p2["params/pipe_stack/w_in"][0]["index"][0] == [2, 4]
    _, _, j_state = runs["jax"]["data2_pipe2"]
    restored, step = j_restore(ckpt, j_state)
    assert step == STEPS
    got = {n: np.asarray(v) for n, v in flatten_with_names(restored)[0]
           if v is not None}
    port = read_leaves(ckpt, STEPS)
    assert set(got) == set(port)
    assert got["params/pipe_stack/w_in"].shape == (4, 32, 64)
    for n, v in got.items():
        np.testing.assert_array_equal(v, port[n], err_msg=n)
    trained = {n: np.asarray(v) for n, v in flatten_with_names(j_state)[0]
               if v is not None}
    for n in _compared(got):
        np.testing.assert_allclose(got[n], trained[n], rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=n)


def test_expert_processes_resume_a_jax_checkpoint(runs):
    """JAX's checkpoint of its ``(data=1, expert=4)`` run, restored by the
    four port processes: each keeps its two experts (and their LAMB slots)
    and they train on as JAX does."""
    j_losses, j_state = runs["jax"]["from_jax"]
    record, leaves, parts = runs["port"]["from_jax"]
    np.testing.assert_allclose(record["losses"], j_losses, rtol=LOSS_RTOL)
    assert len(record["losses"]) == MORE
    for r, part in enumerate(parts):
        assert f"params/encoder/layer_1/moe_mlp/w_in::{2 * r}" in part
    want = {n: np.asarray(v) for n, v in flatten_with_names(j_state)[0]
            if v is not None}
    assert int(want["step"]) == STEPS + MORE
    compared = _compared(n for n in leaves if "key/bias" not in n)
    assert len(compared) > 20 and set(compared) <= set(want)
    for n in compared:
        np.testing.assert_allclose(leaves[n], want[n], rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=n)
