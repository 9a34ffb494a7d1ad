"""Data parallelism across processes (deeplearning_cfn_tpu_torch.parallel, the
rendezvous, the trainer's sums, mesh-wide BatchNorm, ZeRO-1, multi-process
checkpoints) against the JAX package's ``data=2`` mesh, on the CPU.

- (a) two port processes in a gloo group (``tests/torch_dist_worker.py``,
  spawned once for the module) train each config from the same initial
  state as JAX's ``Trainer`` over ``build_mesh(MeshConfig(data=2))`` on two
  of the conftest's fake devices, each process its contiguous half of the
  same global batches: the tiny NMT with masks that are ragged per process
  (process 0's targets cut short), label smoothing 0.1 and
  ``grad_accum_steps=2``; the tiny f32 ResNet-20 (mesh-wide BatchNorm);
  the tiny BERT under LAMB with ``shard_opt_state=True`` (ZeRO-1 in both
  packages). Dropout is 0: each process draws its own rows' masks (a
  difference kept on purpose). Per-step losses within 1e-4 (NMT, ResNet)
  and 1e-5 (BERT) relative, the single-process parity files' bounds: the
  reordered sums over two processes change f32 rounding only. Final
  parameters within 1e-4 (BERT 1e-5), BatchNorm statistics within 1e-5;
- (b) the port's pipeline as process r of 2 yields the JAX pipeline's
  batches bit for bit (text, and CIFAR through both gathers);
- (c) the checkpoint the two BERT processes wrote (each its ZeRO-1 slots,
  process 0 the replicated leaves) restores in JAX's ``restore_checkpoint``
  to the leaves the port reads, bit for bit, and within 1e-5 of JAX's own
  trained state; ZeRO-1's update equals the replicated one bit for bit;
  and the other way: JAX's checkpoint of its ZeRO-1 BERT run, restored by
  the two processes (each keeping the slots it owns), trains on as JAX
  does (losses and every leaf within 1e-5);
- (d) ``choose_backend`` on faked topologies, the mesh's refusals naming
  ROADMAP A.10 (``model``, ``spatial``), a ``(data, seq)`` mesh's and the
  pipe and expert presets' meshes' coordinates and groups in JAX's order,
  ZeRO-1's ownership and slot bytes.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from deeplearning_cfn_tpu.ckpt import restore_checkpoint as j_restore
from deeplearning_cfn_tpu.ckpt import save_checkpoint as j_save
from deeplearning_cfn_tpu.config import MeshConfig
from deeplearning_cfn_tpu.config import apply_overrides as j_overrides
from deeplearning_cfn_tpu.data.pipeline import DataPipeline as JaxPipeline
from deeplearning_cfn_tpu.data.pipeline import augment_crop_flip as j_augment
from deeplearning_cfn_tpu.data.pipeline import synthetic_image_source \
    as j_images
from deeplearning_cfn_tpu.data.text import build_text_source as j_source
from deeplearning_cfn_tpu.parallel import build_mesh as j_build_mesh
from deeplearning_cfn_tpu.presets import get_preset as j_preset
from deeplearning_cfn_tpu.train import create_train_state
from deeplearning_cfn_tpu.train import optim as joptim
from deeplearning_cfn_tpu.train.task import build_task as j_build_task
from deeplearning_cfn_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning_cfn_tpu.utils.trees import flatten_with_names
from deeplearning_cfn_tpu_torch.ckpt import read_leaves
from deeplearning_cfn_tpu_torch.config import apply_overrides
from deeplearning_cfn_tpu_torch.data.pipeline import DataPipeline, \
    augment_crop_flip, build_pipeline, synthetic_image_source
from deeplearning_cfn_tpu_torch.parallel import build_mesh
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.runtime.cluster import ClusterSpec, \
    choose_backend, free_local_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
STEPS = 3
MORE = 2  # steps after the resumed JAX checkpoint

NMT = ["model.kwargs.hidden_size=32", "model.kwargs.num_layers=2",
       "model.kwargs.num_heads=2", "model.kwargs.mlp_dim=64",
       "model.kwargs.dropout_rate=0.0", "data.vocab_size=64",
       "data.seq_len=16", "train.dtype=float32",
       "data.num_train_examples=64", "data.num_eval_examples=16",
       "train.label_smoothing=0.1", "train.global_batch=8",
       "train.grad_accum_steps=2", "schedule.warmup_steps=2",
       "schedule.base_lr=0.01"]
RESNET = ["train.dtype=float32", "train.global_batch=8",
          "data.num_train_examples=64", "data.num_eval_examples=16",
          "data.prefetch=0", "schedule.name=constant",
          "schedule.base_lr=0.1", "schedule.warmup_epochs=0"]
BERT = ["model.name=bert_tiny", "model.kwargs.hidden_size=32",
        "model.kwargs.num_layers=2", "model.kwargs.num_heads=2",
        "model.kwargs.mlp_dim=64", "model.kwargs.max_len=32",
        "model.kwargs.dropout_rate=0.0", "data.vocab_size=64",
        "data.seq_len=16", "train.dtype=float32",
        "data.num_train_examples=40", "data.num_eval_examples=12",
        "train.global_batch=8", "schedule.warmup_steps=2",
        "schedule.base_lr=5e-3", "train.shard_opt_state=true"]
# name: (preset, overrides, JAX-only overrides, loss rtol, param tol)
CASES = {
    "nmt": ("transformer_nmt_wmt", NMT,
            ["model.kwargs.attention_impl=interpret"], 1e-4, 1e-4),
    "resnet20": ("cifar10_resnet20", RESNET, [], 1e-4, 1e-4),
    "bert_zero1": ("bert_base_wikipedia", BERT,
                   ["model.kwargs.attention_impl=interpret"], 1e-5, 1e-5),
}


def _global_batches(name, cfg, steps=STEPS):
    batches = [b for _, b in zip(range(steps), build_pipeline(
        cfg.data, cfg.train.global_batch, cfg.model.num_classes,
        seed=0).one_epoch())]
    if name == "nmt":
        # Ragged per process: process 0's rows (the first half) keep 2-6
        # target tokens, process 1's the pipeline's lengths.
        rng = np.random.RandomState(3)
        for b in batches:
            half = b["tgt_mask"].shape[0] // 2
            for i in range(half):
                b["tgt_mask"][i, rng.randint(2, 7):] = 0
            assert b["tgt_mask"][:half].sum() != b["tgt_mask"][half:].sum()
    return batches


def _jax_run(preset, over, batches, more=(), ckpt=None):
    """JAX's ``Trainer`` over a ``data=2`` mesh on ``batches``; with
    ``more``, it then saves its checkpoint at that step into ``ckpt`` and
    trains on over ``more`` with the same schedule, returning those losses
    and that state too."""
    jcfg = j_overrides(j_preset(preset), over)
    mesh = j_build_mesh(MeshConfig(data=2), devices=jax.devices()[:2])
    task = j_build_task(jcfg, mesh=mesh)
    tx = joptim.build_optimizer(jcfg.optimizer, joptim.build_schedule(
        jcfg.schedule, len(batches), jcfg.train.global_batch))
    state = create_train_state(jax.random.PRNGKey(0), task.init, tx, mesh,
                               ema=jcfg.train.ema_decay > 0,
                               shard_opt_state=jcfg.train.shard_opt_state)
    init = {n: np.asarray(v) for n, v in flatten_with_names(state)[0]
            if v is not None}
    trainer = JaxTrainer(jcfg, task.loss_fn, tx, mesh=mesh, donate=False)
    losses = []
    for b in batches:
        state, metrics = trainer.train_step(
            state, trainer.device_batch(b), jax.random.PRNGKey(1))
        losses.append(float(metrics["loss"]))
    if not more:
        return init, losses, state
    j_save(ckpt, len(batches), state)
    after, later = [], state
    for b in more:
        later, metrics = trainer.train_step(
            later, trainer.device_batch(b), jax.random.PRNGKey(1))
        after.append(float(metrics["loss"]))
    return init, losses, state, (after, later)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs, then one spawn of two port processes for every case."""
    root = tmp_path_factory.mktemp("dist")
    cases, jax_side = [], {}
    for name, (preset, over, jax_only, _, _) in CASES.items():
        cfg = apply_overrides(get_preset(preset), over)
        batches = _global_batches(name, cfg)
        if name == "bert_zero1":
            # JAX's ZeRO-1 run also checkpoints at STEPS and trains on.
            more = _global_batches(name, cfg, STEPS + MORE)[STEPS:]
            init, losses, state, resumed = _jax_run(
                preset, over + jax_only, batches, more,
                str(root / "jax-zero1-ckpt"))
            jax_side["bert_from_jax"] = resumed
            np.savez(root / "bert_from_jax-batches.npz",
                     **{f"{i}/{k}": v for i, b in enumerate(more)
                        for k, v in b.items()})
        else:
            init, losses, state = _jax_run(preset, over + jax_only, batches)
        jax_side[name] = (losses, state)
        np.savez(root / f"{name}-init.npz", **init)
        np.savez(root / f"{name}-batches.npz",
                 **{f"{i}/{k}": v for i, b in enumerate(batches)
                    for k, v in b.items()})
        cases.append(dict(name=name, preset=preset, overrides=over,
                          init=str(root / f"{name}-init.npz"),
                          batches=str(root / f"{name}-batches.npz"),
                          ckpt=str(root / f"{name}-ckpt")))
    # The same BERT run with replicated slots, for ZeRO-1's bitwise check.
    cases.append(dict(cases[-1], name="bert_replicated", ckpt=None,
                      overrides=BERT + ["train.shard_opt_state=false"]))
    # Two processes resume JAX's ZeRO-1 checkpoint and train on.
    cases.append(dict(cases[-2], name="bert_from_jax", ckpt=None,
                      restore=str(root / "jax-zero1-ckpt"),
                      restore_step=STEPS, total_steps=STEPS,
                      batches=str(root / "bert_from_jax-batches.npz")))
    spec = root / "spec.json"
    spec.write_text(json.dumps(dict(world=2, port=free_local_port(),
                                    out=str(root), cases=cases)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, WORKER, str(spec), str(r)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    port_side = {}
    for name in [*CASES, "bert_replicated", "bert_from_jax"]:
        leaves, owned = {}, []
        for r in range(2):
            with np.load(root / f"{name}-p{r}.npz") as data:
                leaves.update({k: data[k] for k in data.files})
                owned.append({k for k in data.files
                              if k.startswith("opt_state/")})
        port_side[name] = (json.loads((root / f"{name}.json").read_text()),
                           leaves, owned)
    return dict(root=root, jax=jax_side, port=port_side, outs=outs)


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_processes_train_as_jax_data2_mesh(runs, name):
    _, _, _, loss_rtol, tol = CASES[name]
    j_losses, j_state = runs["jax"][name]
    record, leaves, _ = runs["port"][name]
    np.testing.assert_allclose(record["losses"], j_losses, rtol=loss_rtol)
    assert record["losses"][-1] < record["losses"][0]
    want = {n: np.asarray(v) for n, v in flatten_with_names(
        {"params": j_state.params, "batch_stats": j_state.batch_stats})[0]}
    # The key projections' biases are left out, as in the single-process
    # parity files: their true gradient is 0, and Adam's and LAMB's
    # normalised updates turn each package's rounding noise there into
    # steps of random sign that no output can see.
    compared = [n for n in want if not n.endswith("key/bias")]
    assert len(compared) > 0
    for n in compared:
        bound = 1e-5 if n.startswith("batch_stats/") else tol
        np.testing.assert_allclose(leaves[n], want[n], rtol=bound,
                                   atol=bound, err_msg=n)
    if name == "resnet20":
        assert any(n.startswith("batch_stats/") for n in compared)
    if name == "bert_zero1":
        # ZeRO-1: each process held and wrote about half of the slots.
        assert record["slot_bytes"] < 0.6 * record["slot_bytes_all"]


def test_zero1_update_equals_the_replicated_update_bit_for_bit(runs):
    zero, zero_leaves, _ = runs["port"]["bert_zero1"]
    rep, rep_leaves, _ = runs["port"]["bert_replicated"]
    assert zero["losses"] == rep["losses"]
    assert rep["slot_bytes"] == rep["slot_bytes_all"] == \
        zero["slot_bytes_all"]
    assert set(zero_leaves) == set(rep_leaves)
    for n, v in rep_leaves.items():
        np.testing.assert_array_equal(zero_leaves[n], v, err_msg=n)


def test_two_process_checkpoint_restores_in_jax(runs):
    ckpt = str(runs["root"] / "bert_zero1-ckpt")
    step_dir = os.path.join(ckpt, f"step_{STEPS:08d}")
    names = sorted(os.listdir(step_dir))
    for f in ("COMMIT", "DONE_p0", "DONE_p1", "manifest.json",
              "manifest_p0.json", "manifest_p1.json"):
        assert f in names, names
    with open(os.path.join(step_dir, "manifest_p1.json")) as fh:
        p1 = json.load(fh)["leaves"]
    # Process 1 wrote its ZeRO-1 slots only; process 0 the rest.
    assert p1 and all(n.startswith("opt_state/") for n in p1)
    _, j_state = runs["jax"]["bert_zero1"]
    restored, step = j_restore(ckpt, j_state)
    assert step == STEPS
    got = {n: np.asarray(v) for n, v in flatten_with_names(restored)[0]
           if v is not None}
    port = read_leaves(ckpt, STEPS)
    assert set(got) == set(port)
    for n, v in got.items():
        np.testing.assert_array_equal(v, port[n], err_msg=n)
    trained = {n: np.asarray(v) for n, v in flatten_with_names(j_state)[0]
               if v is not None}
    for n, v in got.items():
        if n.endswith("key/bias") or "key/bias" in n:
            continue
        np.testing.assert_allclose(v, trained[n], rtol=1e-5, atol=1e-5,
                                   err_msg=n)


def test_two_processes_resume_a_jax_zero1_checkpoint(runs):
    """JAX's checkpoint of the BERT run on a ``data=2`` mesh with
    ``shard_opt_state=True`` (one process wrote every leaf), restored by the
    two port processes: each keeps the LAMB slots it owns
    (``zero1_owners``), and they train on as JAX does — losses within 1e-5
    relative, then every leaf either process holds within 1e-5 of JAX's
    state after the same steps."""
    j_losses, j_state = runs["jax"]["bert_from_jax"]
    record, leaves, owned = runs["port"]["bert_from_jax"]
    np.testing.assert_allclose(record["losses"], j_losses, rtol=1e-5)
    assert len(record["losses"]) == MORE
    # Each process holds the slots it owns, as in the port's own ZeRO-1
    # run (zero1_owners), and no slot twice.
    _, _, zero_owned = runs["port"]["bert_zero1"]
    assert owned == zero_owned and all(owned)
    assert not owned[0] & owned[1]
    want = {n: np.asarray(v) for n, v in flatten_with_names(j_state)[0]
            if v is not None}
    assert int(want["step"]) == STEPS + MORE
    compared = [n for n in leaves if "key/bias" not in n]
    assert len(compared) > 20 and set(compared) <= set(want)
    for n in compared:
        np.testing.assert_allclose(leaves[n], want[n], rtol=1e-5, atol=1e-5,
                                   err_msg=n)


# -- (b) the pipeline's shards ------------------------------------------------


@pytest.mark.parametrize("rank", [0, 1])
def test_pipeline_shards_match_jax_bit_for_bit(rank):
    cfg = apply_overrides(get_preset("transformer_nmt_wmt"), NMT)
    jcfg = j_overrides(j_preset("transformer_nmt_wmt"), NMT)
    kw = dict(process_index=rank, process_count=2, prefetch=0)
    pairs = []
    for train, drop in ((True, True), (False, False)):
        pairs.append((DataPipeline(
            build_pipeline(cfg.data, 4, seed=5, train=train).source, 4,
            seed=5, shuffle=train, drop_remainder=drop, native=False, **kw),
            JaxPipeline(j_source(jcfg.data, train), 4, seed=5, shuffle=train,
                        drop_remainder=drop, native=False, **kw)))
    for native in (False, True):
        pairs.append((DataPipeline(synthetic_image_source(40, 8, 10, 17), 4,
                                   seed=5, augment=augment_crop_flip,
                                   native=native, **kw),
                      JaxPipeline(j_images(40, 8, 10, 17), 4, seed=5,
                                  augment=j_augment, native=native, **kw)))
    assert pairs[-1][0]._native == pairs[-1][1]._native
    for port, ref in pairs:
        assert port.steps_per_epoch == ref.steps_per_epoch > 0
        got = [b for e in range(2) for b in port.one_epoch(e)]
        want = [b for e in range(2) for b in ref.one_epoch(e)]
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- (d) the rendezvous, the mesh, ZeRO-1 --------------------------------------


@pytest.mark.parametrize("hosts,rank,accel,cards,want", [
    (["10.0.0.1", "10.0.0.2"], 1, "gpu", 1, ("nccl", "cuda:0")),
    (["h"] * 4, 3, "gpu", 4, ("nccl", "cuda:3")),
    (["h", "h", "g", "g"], 3, "gpu", 2, ("nccl", "cuda:1")),
    (["127.0.0.1"] * 2, 1, "gpu", 1, ("gloo", "cuda:0")),
    (["h"] * 4, 2, "gpu", 2, ("gloo", "cuda:0")),
    (["127.0.0.1"] * 2, 0, "cpu", 8, ("gloo", "cpu")),
])
def test_backend_follows_the_topology(hosts, rank, accel, cards, want):
    spec = ClusterSpec(hosts=hosts, process_id=rank)
    backend, device, why = choose_backend(spec, accel, cards)
    assert (backend, device) == want and why


def test_backend_without_a_card_raises():
    with pytest.raises(RuntimeError, match="--accelerator cpu"):
        choose_backend(ClusterSpec(hosts=["a", "b"]), "gpu", 0)


@pytest.mark.parametrize("axis,ways", [("model", 2), ("spatial", 2),
                                      ("model", 4), ("spatial", 4)])
def test_mesh_refuses_a_non_batch_axis_across_processes(axis, ways):
    """The ``model`` and ``spatial`` axes resolve over processes as JAX
    resolves them; what the mesh refuses is a size that does not divide
    the processes, with JAX's message."""
    cfg = MeshConfig(data=-1, **{axis: ways})
    mesh = build_mesh(cfg, num_processes=4, index=0)
    j_mesh = j_build_mesh(cfg, devices=jax.devices()[:4])
    assert dict(j_mesh.shape) == mesh.shape
    assert mesh.shape[axis] == ways and mesh.data_ways == 4 // ways
    assert mesh.replicas == ways
    with pytest.raises(ValueError, match="does not divide"):
        build_mesh(MeshConfig(data=-1, **{axis: 3}), num_processes=4,
                   index=0)
    # One process ignores the preset's mesh, as it always did.
    assert build_mesh(cfg, num_processes=1).size == 1


def test_mesh_resolves_the_batch_axes_as_jax():
    mesh = build_mesh(MeshConfig(data=-1, num_slices=2), num_processes=4,
                      index=3)
    assert mesh.shape["dcn_data"] == 2 and mesh.shape["data"] == 2
    assert mesh.coords["dcn_data"] == 1 and mesh.coords["data"] == 1
    j_mesh = j_build_mesh(MeshConfig(data=-1, num_slices=2),
                          devices=jax.devices()[:4])
    assert dict(j_mesh.shape) == mesh.shape
    with pytest.raises(ValueError, match="data=-1 to auto-size"):
        build_mesh(MeshConfig(data=3), num_processes=2, index=0)


@pytest.mark.parametrize("rank", range(4))
def test_mesh_resolves_data_and_seq_coordinates_as_jax(rank):
    """``(data=-1, seq=2)`` over 4 processes: each process sits where JAX's
    mesh puts the device of its index, its seq group is the devices along
    JAX's ``seq`` axis and its data group the devices along ``data``, and
    the processes of a seq group take the same rows of a batch (JAX's batch
    spec shards dim 0 over the batch axes only)."""
    from deeplearning_cfn_tpu.parallel.sharding import \
        batch_sharding as j_batch_sharding
    from deeplearning_cfn_tpu_torch.parallel import batch_sharding, \
        seq_slice

    cfg = MeshConfig(data=-1, seq=2)
    j_mesh = j_build_mesh(cfg, devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(j_mesh.devices)
    names = j_mesh.axis_names
    mesh = build_mesh(cfg, num_processes=4, index=rank)
    assert dict(j_mesh.shape) == mesh.shape
    at = tuple(mesh.coords[a] for a in names)
    assert ids[at] == rank

    def along(axis):
        i = names.index(axis)
        return [int(x) for x in ids[at[:i] + (slice(None),) + at[i + 1:]]]

    assert mesh.seq_ranks == along("seq")
    assert mesh.data_ranks == along("data")
    assert (mesh.data_index, mesh.data_ways) == (at[names.index("data")], 2)
    assert (mesh.seq_index, mesh.seq_ways) == (at[names.index("seq")], 2)
    assert j_batch_sharding(j_mesh, 1).spec[0] == "data"
    rows = batch_sharding(mesh, 8)
    assert (rows.start, rows.stop) == (4 * mesh.data_index,
                                       4 * mesh.data_index + 4)
    assert seq_slice(mesh, 32) == slice(16 * mesh.seq_index,
                                        16 * mesh.seq_index + 16)
    assert build_mesh(cfg, num_processes=4, index=rank ^ 1).data_index \
        == mesh.data_index  # the other process of the seq group


# name: (mesh, processes); the preset meshes of bert_moe_wikipedia and
# bert_pipelined_wikipedia, and the pipelined one with two data ways.
RESOLVED = {"expert8": (dict(data=-1, expert=8), 8),
            "pipe4": (dict(data=-1, pipe=4), 4),
            "data2_pipe4": (dict(data=2, pipe=4), 8)}


@pytest.mark.parametrize("name,rank", [(n, r) for n, (_, w) in
                                       RESOLVED.items() for r in range(w)])
def test_mesh_resolves_pipe_and_expert_coordinates_as_jax(name, rank):
    """Each process sits where JAX's mesh puts the device of its index; its
    pipe, expert, data and holder groups are the devices along JAX's axes;
    the rows it reads are its block over the batch axes (``expert`` one of
    them, ``pipe`` not: a pipe group reads the same rows); its piece of a
    split leaf is the rows at its coordinate."""
    from deeplearning_cfn_tpu.parallel.sharding import \
        batch_sharding as j_batch_sharding
    from deeplearning_cfn_tpu_torch.parallel import batch_sharding
    from deeplearning_cfn_tpu_torch.parallel.sharding import piece_rows

    axes, world = RESOLVED[name]
    cfg = MeshConfig(**axes)
    j_mesh = j_build_mesh(cfg, devices=jax.devices()[:world])
    ids = np.vectorize(lambda d: d.id)(j_mesh.devices)
    names = j_mesh.axis_names
    mesh = build_mesh(cfg, num_processes=world, index=rank)
    assert dict(j_mesh.shape) == mesh.shape
    at = tuple(mesh.coords[a] for a in names)
    assert ids[at] == rank

    def along(*axes_):
        idx = tuple(slice(None) if a in axes_ else at[i]
                    for i, a in enumerate(names))
        return [int(x) for x in ids[idx].reshape(-1)]

    assert mesh.pipe_ranks == along("pipe")
    assert mesh.expert_ranks == along("expert")
    assert mesh.data_ranks == along("dcn_data", "data", "expert")
    for axis in ("pipe", "expert"):
        others = [a for a in names if a != axis]
        assert mesh.holder_ranks(axis) == along(*others)
    spec = j_batch_sharding(j_mesh, 1).spec[0]
    spec = {spec} if isinstance(spec, str) else set(spec)
    assert {a for a in ("data", "expert") if mesh.shape[a] > 1} <= spec \
        <= {"dcn_data", "data", "expert"}
    ways = mesh.shape["data"] * mesh.shape["expert"]
    assert mesh.data_ways == ways and mesh.replicas == world // ways
    rows = batch_sharding(mesh, 16)
    assert rows == slice(16 // ways * mesh.data_index,
                         16 // ways * (mesh.data_index + 1))
    assert mesh.data_index == mesh.coords["data"] * mesh.shape["expert"] \
        + mesh.coords["expert"]
    assert piece_rows(mesh, "pipe", 12) == slice(
        12 // mesh.pipe_ways * mesh.pipe_index,
        12 // mesh.pipe_ways * (mesh.pipe_index + 1))
    assert piece_rows(mesh, "expert", 8) == slice(
        8 // mesh.expert_ways * mesh.expert_index,
        8 // mesh.expert_ways * (mesh.expert_index + 1))


@pytest.mark.parametrize("slice_type", ["v5p-8", "v4-32", "v5e-4",
                                        "v5p", "v5p-x"])
def test_slice_helpers_match_jax(slice_type):
    from deeplearning_cfn_tpu.parallel import mesh as j_mesh
    from deeplearning_cfn_tpu_torch.parallel import mesh as t_mesh

    def run(m):
        try:
            return (m.slice_chip_count(slice_type),
                    m.hosts_for_slice(slice_type),
                    m.hosts_for_slice(slice_type, chips_per_host=8))
        except ValueError as e:
            return str(e)

    assert run(t_mesh) == run(j_mesh)


def test_zero1_owners_balance_and_cover():
    import torch

    from deeplearning_cfn_tpu_torch.train.optim import zero1_owners

    params = [torch.zeros(n) for n in (100, 7, 60, 50, 3, 3)]
    owners = zero1_owners(params, 2)
    assert owners == [0, 0, 1, 1, 0, 0]
    loads = [sum(p.numel() for p, o in zip(params, owners) if o == r)
             for r in range(2)]
    assert abs(loads[0] - loads[1]) <= 100


def test_each_process_draws_its_own_dropout_stream():
    from deeplearning_cfn_tpu_torch.train.graphs import StepGenerator, \
        step_seed

    # One process keeps the (seed, step) stream it always had, and process
    # 0 of a job draws it too (SeedSequence pads the key with zeros); the
    # other processes draw their own.
    assert step_seed(7, 3, None) == step_seed(7, 3) == step_seed(7, 3, 0)
    assert len({step_seed(7, 3, r) for r in range(4)}) == 4
    import torch

    gens = [StepGenerator(torch.device("cpu"), 7, r) for r in (0, 1)]
    for g in gens:
        g.reseed(3)
    a, b = (torch.rand(8, generator=g) for g in gens)
    assert not torch.equal(a, b)
