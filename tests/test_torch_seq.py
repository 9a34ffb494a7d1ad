"""The ``seq`` mesh axis across processes (``parallel/mesh.py``'s groups,
``ops/ring_attention.py``, ``ops/ulysses.py``, the long trunks' slices and
gather) against full attention and against the JAX package's
``(data=2, seq=2)`` mesh, on the CPU.

Four port processes in one gloo group (``tests/torch_dist_worker.py``,
spawned once for the module):

- op level, the four processes as one ``seq`` group: ring and Ulysses
  attention, causal and not, of each process's slice of seeded global Q, K,
  V ``[2, 4, 32, 8]`` f32 — the slices' outputs and the gradients of a
  seeded projection, put back in sequence order, within 1e-5 of full
  attention (``attention_reference`` under autograd). Four ways take three
  ring rotations, so every hop is exercised;
- model level, on the mesh ``(data=2, seq=2)``: ``bert_long_wikipedia``
  with ring attention and ``gpt_long_lm`` with Ulysses (its preset's
  ``grad_accum_steps=2``), cut to vocab 64, hidden 32, 2 layers, 4 heads,
  sequence 32, f32, 3 steps from JAX's initial state on the same global
  batches, against JAX's ``Trainer`` on ``(data=2, seq=2)`` over four fake
  devices and against the port's own data-only run (``data=4``, the same
  four processes): losses within ``rtol=3e-4`` and parameters within
  ``atol=5e-3``, the bounds of ``tests/test_long_context.py`` (the
  blockwise online softmax sums in another order, and the optimizer
  amplifies that f32 noise);
- both cases' steps on the seq mesh run nothing a CUDA graph capture
  refuses (so NCCL can replay them whole);
- ``parallel/comm_volume.py``'s count of one executed step of JAX's tiny
  ``bert_long`` ring configuration on ``(data=2, seq=2)`` and on
  ``data=4``, against JAX's ``comm_volume(compile_train_step(...))`` on
  the same meshes of four fake devices: the gradient sum's all-reduce
  bytes are the model's parameter bytes, which JAX's data-only all-reduce
  holds too (see the test for what else each counts).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from deeplearning_cfn_tpu.config import MeshConfig
from deeplearning_cfn_tpu.config import apply_overrides as j_overrides
from deeplearning_cfn_tpu.parallel import build_mesh as j_build_mesh
from deeplearning_cfn_tpu.presets import get_preset as j_preset
from deeplearning_cfn_tpu.train import create_train_state
from deeplearning_cfn_tpu.train import optim as joptim
from deeplearning_cfn_tpu.train.task import build_task as j_build_task
from deeplearning_cfn_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.config import apply_overrides
from deeplearning_cfn_tpu_torch.data.pipeline import build_pipeline
from deeplearning_cfn_tpu_torch.ops.attention import attention_reference
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.runtime.cluster import free_local_port
from torch_capture_check import capture_op, refused_by_rank

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
WORLD, STEPS = 4, 3
OP_SHAPE = [2, 4, 32, 8]
OPS = [dict(name=f"{impl}-{'causal' if causal else 'full'}", impl=impl,
            causal=causal, seed=11 + i, shape=OP_SHAPE)
       for i, (impl, causal) in enumerate(
           [(impl, causal) for impl in ("ring", "ulysses")
            for causal in (False, True)])]

TINY = ["model.kwargs.hidden_size=32", "model.kwargs.num_layers=2",
        "model.kwargs.num_heads=4", "model.kwargs.mlp_dim=64",
        "model.kwargs.max_len=32", "data.vocab_size=64", "data.seq_len=32",
        "train.dtype=float32", "data.num_train_examples=64",
        "data.num_eval_examples=16", "train.global_batch=16",
        "schedule.warmup_steps=2"]
# name: (preset, overrides)
CASES = {
    "bert_long_ring": ("bert_long_wikipedia",
                       TINY + ["model.kwargs.seq_impl=ring",
                               "schedule.base_lr=5e-3"]),
    "gpt_long_ulysses": ("gpt_long_lm",
                         TINY + ["model.kwargs.seq_impl=ulysses",
                                 "schedule.base_lr=3e-3"]),
}
SEQ_MESH = ["mesh.data=2", "mesh.seq=2"]
DATA_MESH = ["mesh.data=4", "mesh.seq=1"]
LOSS_RTOL, PARAM_ATOL = 3e-4, 5e-3
# The seq mesh's steps checked for what a CUDA graph capture refuses.
CAPTURE = [capture_op(f"capture-{name}", preset, over + SEQ_MESH)
           for name, (preset, over) in CASES.items()]
# parallel/comm_volume.py's count of JAX's tiny bert_long ring step on the
# seq mesh and on the data-only one.
VOLUME = {"seq": dict(data=2, seq=2), "data": dict(data=4)}
VOLUME_OPS = [dict(kind="comm_volume", name=f"comm-volume-{name}",
                   model="bert_long", impl="ring", mesh=mesh)
              for name, mesh in VOLUME.items()]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One worker's share of the cores (torch would start a thread per core
    in every pytest-xdist worker)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _jax_run(preset, over, batches):
    jcfg = j_overrides(j_preset(preset), over)
    mesh = j_build_mesh(MeshConfig(data=2, seq=2), devices=jax.devices()[:4])
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
    return init, losses, params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs, then one spawn of four port processes for the ops and
    every case, on the seq mesh and on the data-only mesh."""
    root = tmp_path_factory.mktemp("seq")
    cases, jax_side = [], {}
    for name, (preset, over) in CASES.items():
        cfg = apply_overrides(get_preset(preset), over)
        batches = [b for _, b in zip(range(STEPS), build_pipeline(
            cfg.data, cfg.train.global_batch, cfg.model.num_classes,
            seed=0).one_epoch())]
        init, losses, params = _jax_run(preset, over + SEQ_MESH, batches)
        jax_side[name] = (losses, params)
        np.savez(root / f"{name}-init.npz", **init)
        np.savez(root / f"{name}-batches.npz",
                 **{f"{i}/{k}": v for i, b in enumerate(batches)
                    for k, v in b.items()})
        for mesh_name, mesh in (("seq", SEQ_MESH), ("data", DATA_MESH)):
            cases.append(dict(name=f"{name}-{mesh_name}", preset=preset,
                              overrides=over + mesh,
                              init=str(root / f"{name}-init.npz"),
                              batches=str(root / f"{name}-batches.npz")))
    spec = root / "spec.json"
    spec.write_text(json.dumps(dict(
        world=WORLD, port=free_local_port(), out=str(root),
        ops=OPS + CAPTURE + VOLUME_OPS, cases=cases)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, WORKER, str(spec), str(r)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    port_side = {}
    for case in cases:
        leaves = {}
        for r in range(WORLD):
            with np.load(root / f"{case['name']}-p{r}.npz") as data:
                leaves.update({k: data[k] for k in data.files})
        port_side[case["name"]] = (
            json.loads((root / f"{case['name']}.json").read_text()), leaves)
    return dict(root=root, jax=jax_side, port=port_side)


@pytest.mark.parametrize("op", [o["name"] for o in OPS])
def test_seq_attention_over_four_processes_matches_full(runs, op):
    spec = next(o for o in OPS if o["name"] == op)
    parts = []
    for r in range(WORLD):
        with np.load(runs["root"] / f"{op}-p{r}.npz") as data:
            parts.append({k: data[k] for k in data.files})
    got = {k: np.concatenate([p[k] for p in parts], axis=2)
           for k in parts[0]}
    rng = np.random.RandomState(spec["seed"])
    q, k, v, w = (torch.from_numpy(rng.standard_normal(OP_SHAPE)
                                   .astype(np.float32)) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = attention_reference(q, k, v, causal=spec["causal"])
    (out * w).sum().backward()
    want = {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
    for key, ref in want.items():
        ref = ref.numpy()
        np.testing.assert_allclose(got[key], ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=f"{op} {key}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_seq_mesh_trains_as_jax_and_as_data_only(runs, name):
    j_losses, j_params = runs["jax"][name]
    seq, seq_leaves = runs["port"][f"{name}-seq"]
    data, data_leaves = runs["port"][f"{name}-data"]
    np.testing.assert_allclose(seq["losses"], j_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(seq["losses"], data["losses"],
                               rtol=LOSS_RTOL)
    assert seq["losses"][-1] < seq["losses"][0]
    # The seq mesh really split the sequence: its attention exchanged
    # slices (no silent fallback to whole rows), the data-only mesh none.
    impl = "ring" if "ring" in name else "ulysses"
    assert seq["comm_calls"].get(impl, 0) > 0 and not data["comm_calls"]
    if name.startswith("bert"):
        assert seq["comm_calls"].get("gather", 0) > 0
    assert len(j_params) > 10
    for n, want in j_params.items():
        np.testing.assert_allclose(seq_leaves[n], want, rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
        np.testing.assert_allclose(seq_leaves[n], data_leaves[n], rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)


@pytest.mark.parametrize("name", [o["name"] for o in CAPTURE])
def test_seq_steps_do_nothing_a_capture_refuses(runs, name):
    assert refused_by_rank(runs["root"], name, WORLD) == [[]] * WORLD


def test_comm_volume_holds_jax_gradient_bytes(runs, monkeypatch):
    """The gradient sum is one all-reduce of every parameter's gradient,
    the model's f32 parameter bytes on both meshes (JAX's parameters of
    the same model, from the seq case). JAX's data-only step all-reduces
    the same gradients in one tuple, whose members hold the tied token
    embedding twice (its lookup's and its decoder's partials, added after
    the sum) and the loss's f32 scalars; the port sums each global-batch
    denominator apart. On the seq mesh the two count differently
    (``parallel/comm_volume.py``'s docstring): XLA splits the gradient
    sum over its replica groups and emits the heads' gather as three
    all-gathers and its backward as a reduce-scatter, where the port
    gathers the heads once and sums the gradient back with an
    all-reduce; and JAX counts each ring rotation's while body once,
    where the port counts the rotations it runs. Both count the ring's
    exchanges as collective-permutes and nothing as all-to-all."""
    from deeplearning_cfn_tpu.parallel import mesh as j_mesh_module
    from deeplearning_cfn_tpu.parallel.comm_volume import \
        comm_volume as j_volume, compile_train_step

    whole = j_mesh_module.build_mesh
    monkeypatch.setattr(j_mesh_module, "build_mesh",
                        lambda cfg=None, devices=None:
                        whole(cfg, jax.devices()[:WORLD]))
    want = {name: j_volume(compile_train_step(
        "bert_long", MeshConfig(**mesh), seq_impl="ring"))
        for name, mesh in VOLUME.items()}
    got = {name: json.loads(
        (runs["root"] / f"comm-volume-{name}.json").read_text())
        for name in VOLUME}
    _, j_params = runs["jax"]["bert_long_ring"]
    param_bytes = sum(v.size * v.itemsize for v in j_params.values())
    tied = 64 * 32 * 4  # the token embedding [vocab, hidden], f32
    for name in VOLUME:
        assert set(got[name]) == set(want[name]) | {"gradient_sum"}
        assert got[name]["gradient_sum"] == {"count": 1,
                                             "bytes": param_bytes}
        assert got[name]["total"]["bytes"] == sum(
            v["bytes"] for k, v in got[name].items()
            if k not in ("total", "gradient_sum"))
    extra = want["data"]["all-reduce"]["bytes"] - param_bytes - tied
    assert 0 <= extra <= 32, extra
    assert got["data"]["total"] == got["data"]["all-reduce"]
    assert got["data"]["all-reduce"]["bytes"] - param_bytes <= 32
    for name in VOLUME:
        assert got[name]["all-to-all"]["count"] == \
            want[name]["all-to-all"]["count"] == 0
    assert got["seq"]["collective-permute"]["count"] > 0 and \
        want["seq"]["collective-permute"]["count"] > 0
    assert got["data"]["collective-permute"]["count"] == \
        want["data"]["collective-permute"]["count"] == 0
