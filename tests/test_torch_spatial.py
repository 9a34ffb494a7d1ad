"""The ``spatial`` mesh axis across processes (``parallel/mesh.py``'s
``spatial`` group, ``parallel/collectives.py``'s ``halo_rows`` and
``gather_rows``, ``models/resnet.py``'s convs and pool over split rows,
``models/maskrcnn.py``'s gathered pyramid, ``train/detection_task.py``'s
``spatial_keys``) against one process and against the JAX package's
meshes, on the CPU.

Four port processes in one gloo group (``tests/torch_dist_worker.py``,
spawned once for the module):

- op level: ``Conv`` 7×7/2, 3×3/1, 3×3/2, 1×1/2 and ``max_pool_same``
  3×3/2 of seeded f32 images ``[4, 3, 16, 16]`` on ``(data=2, spatial=2)``
  and on ``spatial=4``, each process on its rows: the output rows, the
  input rows' gradient and the weight's gradient (summed over the
  processes) within 1e-6 of one process;
- model level: JAX's ``_tiny_cfg`` Mask R-CNN (``tests/test_detection.py``:
  the full ResNet-50-FPN, 7 classes, 64 pre-NMS and 16 post-NMS
  proposals, 4 mask RoIs, momentum with weight decay and the clip) at image
  size 128, so that P6 splits over two processes, f32, 3 steps from JAX's
  initial state on the same global batches of 4, on ``(data=2,
  spatial=2)`` and on ``(data=2, model=2)`` (where everything is
  replicated), against JAX's ``Trainer`` on the same mesh (its
  ``spatial_dim``/``spatial_keys``) over four fake devices and against the
  port's one-process run: losses within ``rtol=1e-5``, parameters within
  1e-5 and BatchNorm statistics within 1e-4 of one process (the fast
  variance's cancellation), losses and leaves within 1e-4 of JAX (the
  packages' f32 trunk gradients differ by ~1e-4 of the norm on one device
  already), a control with the gradients never summed beyond every bound,
  and the final eval's mAP equal to one process's (each image counted
  once). The learning rate is 1e-3 (the config's 0.01 moves the weights so
  far in a step that a proposal choice flips between two f32 runs by the
  third). The RPN's top-k margins on every
  step's batch at the initial state are asserted above 1e-6, so no
  proposal choice can flip on f32 rounding;
- BatchNorm's mesh-wide moments count each pixel once: one sum of
  ``[Σx, Σx², n]`` over every process;
- the mesh: every rank's coordinates and its ``spatial``, data and holder
  groups for ``(data=-1, spatial=2)`` over 4 and for ``maskrcnn_coco``'s
  preset mesh over 2 and 8 match JAX's device array; an image size that
  does not split is refused, naming the smallest.
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
from deeplearning_cfn_tpu_torch.models.resnet import Conv, max_pool_same
from deeplearning_cfn_tpu_torch.parallel import build_mesh
from deeplearning_cfn_tpu_torch.presets import get_preset
from deeplearning_cfn_tpu_torch.runtime.cluster import free_local_port

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_worker import seeded_spatial_op  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
WORLD, STEPS = 4, 3

OP_SHAPE = [4, 3, 16, 4]  # batch, channels, height (= width), out channels
# name: (kernel, stride, pool)
WINDOWS = {"conv7s2": (7, 2, False), "conv3s1": (3, 1, False),
           "conv3s2": (3, 2, False), "conv1s2": (1, 2, False),
           "pool3s2": (3, 2, True)}
MESHES = {"data2-spatial2": dict(data=2, spatial=2),
          "spatial4": dict(data=1, spatial=4)}
OPS = [dict(kind="spatial", name=f"{w}-{m}", mesh=mesh, seed=41 + i,
            shape=OP_SHAPE, kernel=k, stride=s, pool=pool)
       for i, ((w, (k, s, pool)), (m, mesh)) in enumerate(
           (wk, mk) for wk in WINDOWS.items() for mk in MESHES.items())]

TINY = ["model.num_classes=7", "model.kwargs.image_size=128",
        "model.kwargs.pre_nms_topk=64", "model.kwargs.post_nms_topk=16",
        "model.kwargs.num_mask_rois=4", "model.kwargs.anchor_scale=4.0",
        "data.image_size=128", "data.max_boxes=4",
        "data.num_train_examples=32", "data.num_eval_examples=4",
        "train.global_batch=4", "train.eval_batch=4", "train.dtype=float32",
        "optimizer.name=momentum", "optimizer.momentum=0.9",
        "optimizer.weight_decay=1e-4", "optimizer.grad_clip_norm=10.0",
        "schedule.name=constant", "schedule.base_lr=1e-3",
        "schedule.warmup_steps=0", "eval.detect_topk=8"]
CASES = {"data2_spatial2": dict(data=2, spatial=2),
         "data2_model2": dict(data=2, model=2)}
# Against one process: the bounds of every mesh test.
LOSS_RTOL, PARAM_TOL, OP_TOL = 1e-5, 1e-5, 1e-6
# Against JAX the bounds are looser, and the control, the spatial mesh's
# four processes with their gradients never summed, exceeds them. The
# full-depth trunk's f32 gradients differ between the packages by ~1e-4 of
# the global norm on one device already (tests/test_torch_detection.py's
# GRAD_TOL; JAX's own f32 error against f64 is of that size), which the
# steps carry into the losses and weights.
JAX_LOSS_RTOL, JAX_PARAM_TOL = 1e-4, 1e-4
# The BatchNorm running variance against one process: Flax's fast variance
# E[x²] − E[x]² cancels, and on (data=2, model=2) the sums over four
# processes (each pixel twice) round apart from one process's by 1.1e-5 of
# the largest variance in one channel (3.5e-5 of 3.11); the control
# exceeds this bound as well.
STATS_TOL = 1e-4
# The smallest gap between consecutive RPN scores among each image's
# top pre_nms_topk + 1 that the runs may meet, the MoE tests' router margin:
# an order of magnitude above f32's resolution at these scores (about 6e-8
# at 0.5), which is what the meshes' reordered sums move them by. These
# batches' smallest gap is 4.947e-6.
MARGIN = 1e-6


def _mesh_over(mesh):
    return [f"mesh.{k}={v}" for k, v in {**dict(data=1, spatial=1, model=1),
                                         **mesh}.items()]


def _jax_state(mesh_axes, steps):
    """JAX's initial state on ``mesh_axes`` over four fake devices (its
    leaves), and the function that trains it with JAX's ``Trainer``, the
    detection task's spatial shard of the images, on given batches."""
    jcfg = j_overrides(j_preset("maskrcnn_coco"), TINY
                       + _mesh_over(mesh_axes))
    mesh = j_build_mesh(MeshConfig(**mesh_axes), devices=jax.devices()[:4])
    task = j_build_task(jcfg, mesh=mesh)
    tx = joptim.build_optimizer(jcfg.optimizer, joptim.build_schedule(
        jcfg.schedule, steps, jcfg.train.global_batch))
    state = create_train_state(jax.random.PRNGKey(0), task.init, tx, mesh,
                               param_rules=task.param_rules)
    init = {n: np.asarray(v) for n, v in flatten_with_names(state)[0]
            if v is not None}

    def train(batches):
        trainer = JaxTrainer(jcfg, task.loss_fn, tx, mesh=mesh,
                             donate=False, spatial_dim=task.spatial_dim,
                             spatial_keys=task.spatial_keys)
        st, losses = state, []
        for b in batches:
            st, metrics = trainer.train_step(
                st, trainer.device_batch(b), jax.random.PRNGKey(1))
            losses.append(float(metrics["loss"]))
        return losses, {n: np.asarray(v) for n, v in
                        flatten_with_names(st)[0] if v is not None
                        and n.startswith(("params/", "batch_stats/"))}

    return init, train


def _batches(cfg, n, train=True):
    return [b for _, b in zip(range(n), build_pipeline(
        cfg.data, cfg.train.global_batch, cfg.model.num_classes, seed=0,
        train=train).one_epoch())]


def _save_batches(path, batches):
    np.savez(path, **{f"{i}/{k}": v for i, b in enumerate(batches)
                      for k, v in b.items()})


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
        outs = [p.communicate(timeout=600)[0] for p in procs]
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


def _rpn_margins(cfg, init, batches):
    """The smallest gap between consecutive RPN scores among each image's
    top ``pre_nms_topk + 1``, over the given batches, at the initial state
    (train-mode BatchNorm, as the step's forward)."""
    from deeplearning_cfn_tpu_torch.train.state import create_train_state
    from deeplearning_cfn_tpu_torch.train.task import build_task

    task = build_task(cfg, torch.device("cpu"))
    state = create_train_state(task.model, None)
    state.load_named(init)
    smallest = np.inf
    with torch.no_grad():
        for b in batches:
            out = task.model(torch.from_numpy(b["image"]), train=True)
            scores = torch.sigmoid(out["rpn_logits"]).sort(
                -1, descending=True).values[:, :task.pre_nms_topk + 1]
            smallest = min(smallest, float((scores[:, :-1]
                                            - scores[:, 1:]).min()))
    return smallest


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's initial state; one spawn of four port processes for the ops
    and the cases, which runs while this process trains JAX on both meshes
    and runs the port's one process (and its final eval)."""
    import chip_smoke
    from deeplearning_cfn_tpu_torch.train.task import build_task

    root = tmp_path_factory.mktemp("spatial")
    cfg = apply_overrides(get_preset("maskrcnn_coco"), TINY)
    batches = _batches(cfg, STEPS)
    eval_batches = _batches(cfg, 1, train=False)
    _save_batches(root / "batches.npz", batches)
    _save_batches(root / "eval.npz", eval_batches)
    states = {name: _jax_state(mesh, STEPS) for name, mesh in CASES.items()}
    init = states["data2_spatial2"][0]
    for n, v in states["data2_model2"][0].items():
        np.testing.assert_array_equal(v, init[n], err_msg=n)
    np.savez(root / "init.npz", **init)
    cases = [dict(name=name, preset="maskrcnn_coco",
                  overrides=TINY + _mesh_over(mesh),
                  init=str(root / "init.npz"),
                  batches=str(root / "batches.npz"),
                  eval_batches=str(root / "eval.npz"))
             for name, mesh in CASES.items()]
    cases.append(dict(cases[0], name="unsummed", grad_sum="discard",
                      eval_batches=None))
    procs = _start(root, OPS, cases)
    try:
        jax_side = {name: train(batches)
                    for name, (_, train) in states.items()}
        one_losses, one_state = chip_smoke.fed_run(torch, cfg, batches,
                                                   "cpu", init=init)
    finally:
        _wait(procs)
    task = build_task(cfg, torch.device("cpu"))
    task.model = one_state.model
    one_final = task.final_eval(one_state, lambda: iter(eval_batches))
    port_side = {c["name"]: (
        json.loads((root / f"{c['name']}.json").read_text()),
        _parts(root, c["name"])) for c in cases}
    return dict(root=root, jax=jax_side, port=port_side,
                single=(one_losses, one_state, one_final),
                margin=_rpn_margins(cfg, init, batches))


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("name", [o["name"] for o in OPS])
def test_spatial_window_matches_one_process(runs, name):
    """Each process's output rows are the one-process op's; its input
    rows' gradient is the one-process gradient (its halo's sent back and
    added); the weight's gradient parts add up to one process's."""
    op = next(o for o in OPS if o["name"] == name)
    w, x, proj = seeded_spatial_op(op)
    xt = torch.tensor(x, requires_grad=True)
    k, s = op["kernel"], op["stride"]
    if op["pool"]:
        y = max_pool_same(xt, k, s)
        conv = None
    else:
        conv = Conv(w.shape[1], w.shape[0], k, s, torch.float32)
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(w))
        y = conv(xt)
    (y * torch.from_numpy(proj)).sum().backward()
    want_out, want_dx = y.detach().numpy(), xt.grad.numpy()
    ways = op["mesh"]["spatial"]
    got_out, got_dx = np.zeros_like(want_out), np.zeros_like(want_dx)
    got_dw = np.zeros_like(w)
    for part in _parts(runs["root"], name):
        rows, at = slice(*part["rows"]), int(part["spatial"])
        n_out, n_in = want_out.shape[2] // ways, want_dx.shape[2] // ways
        got_out[rows, :, at * n_out:(at + 1) * n_out] = part["out"]
        got_dx[rows, :, at * n_in:(at + 1) * n_in] = part["dx"]
        got_dw += part["dw"]
    _close(got_out, want_out, OP_TOL, "out")
    _close(got_dx, want_dx, OP_TOL, "dx")
    if conv is not None:
        _close(got_dw, conv.weight.grad.numpy(), OP_TOL, "dw")


def _leaves(parts):
    """Process 0's leaves: every parameter and statistic is replicated."""
    return {k: v for k, v in parts[0].items()
            if k.startswith(("params/", "batch_stats/"))}


def _loss_gap(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def _leaf_gap(got, want):
    """The largest difference over the leaves, each on ``_close``'s
    scale."""
    return max(float(np.abs(got[n] - want[n]).max())
               / max(1.0, float(np.abs(want[n]).max())) for n in want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_maskrcnn_mesh_trains_as_jax_and_as_one_process(runs, name):
    j_losses, j_leaves = runs["jax"][name]
    record, parts = runs["port"][name]
    one_losses, one_state, one_final = runs["single"]
    # No proposal choice sits within the runs' differences.
    assert runs["margin"] > MARGIN
    np.testing.assert_allclose(record["losses"], one_losses,
                               rtol=LOSS_RTOL)
    losses = record["losses"]
    assert max(abs(x - losses[0]) for x in losses) \
        > 100 * LOSS_RTOL * losses[0]
    leaves = _leaves(parts)
    one = {n: v for n, v in one_state.named_leaves()
           if n.startswith(("params/", "batch_stats/"))}
    assert set(leaves) == set(j_leaves) == set(one)
    assert len(leaves) > 300
    stats = [n for n in leaves if n.startswith("batch_stats/")]
    for n, v in leaves.items():
        _close(v, one[n], STATS_TOL if n in stats else PARAM_TOL, n)
    # Against JAX's run on the same mesh, within the looser bounds; the
    # control exceeds every bound.
    control, control_parts = runs["port"]["unsummed"]
    unsummed = _leaves(control_parts)
    gaps = (_loss_gap(losses, j_losses), _leaf_gap(leaves, j_leaves))
    control_gaps = (_loss_gap(control["losses"], j_losses),
                    _leaf_gap(unsummed, j_leaves))
    assert gaps[0] <= JAX_LOSS_RTOL < control_gaps[0], (gaps, control_gaps)
    assert gaps[1] <= JAX_PARAM_TOL < control_gaps[1], (gaps, control_gaps)
    assert _leaf_gap({n: unsummed[n] for n in stats},
                     {n: one[n] for n in stats}) > STATS_TOL
    # The axis really split the rows (halos and the pyramid's gather ran)
    # or, on the model axis, replicated them (no split leaf, no exchange).
    calls = record["comm_calls"]
    if "spatial" in CASES[name]:
        assert calls.get("halo", 0) > 0 and calls.get("spatial", 0) > 0
    else:
        assert not any("::" in k for p in parts for k in p)
        assert calls.get("halo", 0) == calls.get("model", 0) == 0
    # The final eval counts each image once: the same mAP as one process.
    assert set(record["final_eval"]) >= {"map", "map50", "mask_map"}
    for key in ("map", "map50", "mask_map"):
        np.testing.assert_allclose(record["final_eval"][key],
                                   one_final[key], rtol=1e-6, atol=1e-9,
                                   err_msg=key)


def test_batchnorm_moments_count_each_pixel_once():
    """Over a spatial axis BatchNorm's moments are one sum of ``[Σx, Σx²,
    n]`` over every process, so each pixel counts once: split rows give
    the whole batch's mean and variance (pinned without a process group by
    summing the parts' sums as the collective would)."""
    from deeplearning_cfn_tpu_torch.models.resnet import BatchNorm

    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, 8, 6))
                         .astype(np.float32))
    parts = [x[:, :, :4], x[:, :, 4:]]
    sums = sum(torch.cat([p.sum((0, 2, 3)), (p * p).sum((0, 2, 3)),
                          torch.full((1,), float(p.numel() // 3))])
               for p in parts)
    n = sums[-1]
    assert float(n) == x.numel() // 3
    mean, mean_sq = sums[:3] / n, sums[3:6] / n
    torch.testing.assert_close(mean, x.mean((0, 2, 3)))
    torch.testing.assert_close(mean_sq - mean * mean,
                               x.var((0, 2, 3), unbiased=False))
    # The module's own reduction has that form: the sum's operand is the
    # part's [Σx, Σx², n].
    import deeplearning_cfn_tpu_torch.models.resnet as resnet

    seen = []
    before = resnet.global_sum
    resnet.global_sum = lambda t: seen.append(t) or t
    try:
        BatchNorm._global_moments(parts[0])
    finally:
        resnet.global_sum = before
    torch.testing.assert_close(seen[0][-1], torch.tensor(
        float(parts[0].numel() // 3)))


@pytest.mark.parametrize("axes,world,rank", [
    (dict(data=-1, spatial=2), 4, r) for r in range(4)] + [
    ("preset", w, r) for w in (2, 8) for r in range(w)])
def test_mesh_resolves_spatial_coordinates_as_jax(axes, world, rank):
    """Each process sits where JAX's mesh puts the device of its index; its
    spatial, data and holder groups are the devices along JAX's axes; the
    processes of a spatial group read the same rows of the batch and each
    its rows of every image."""
    from deeplearning_cfn_tpu.parallel.sharding import \
        batch_sharding as j_batch_sharding
    from deeplearning_cfn_tpu_torch.parallel import batch_sharding, \
        spatial_slice

    cfg = get_preset("maskrcnn_coco").mesh if axes == "preset" \
        else MeshConfig(**axes)
    j_mesh = j_build_mesh(MeshConfig(**{f: getattr(cfg, f) for f in (
        "data", "model", "spatial", "expert", "pipe", "seq",
        "num_slices")}), devices=jax.devices()[:world])
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

    assert mesh.spatial_ranks == along("spatial")
    assert mesh.data_ranks == along("dcn_data", "data", "expert")
    assert mesh.holder_ranks("spatial") == along(
        *[a for a in names if a != "spatial"])
    assert mesh.spatial_ways == 2 and mesh.replicas == 2
    assert mesh.data_ways == world // 2
    spec = j_batch_sharding(j_mesh, 4, spatial_dim=1).spec
    assert spec[1] == "spatial"
    b = 2 * mesh.data_ways
    assert batch_sharding(mesh, b) == slice(2 * mesh.data_index,
                                            2 * mesh.data_index + 2)
    image = np.arange(8 * 4).reshape(1, 8, 4, 1)
    np.testing.assert_array_equal(
        spatial_slice(image, mesh, 1),
        image[:, 4 * mesh.spatial_index:4 * mesh.spatial_index + 4])


def test_image_size_that_does_not_split_is_refused():
    """Each process's rows must be a multiple of 64 (P6's stride over
    even P5 rows): 96 over two processes is refused, naming 128."""
    from deeplearning_cfn_tpu_torch.models.maskrcnn import MaskRCNN

    mesh = build_mesh(MeshConfig(data=1, spatial=2), num_processes=2,
                      index=0)
    model = MaskRCNN(7, torch.float32, mesh=mesh)
    with pytest.raises(ValueError, match="the smallest is 128"):
        model(torch.zeros(1, 48, 96, 3), train=False)
