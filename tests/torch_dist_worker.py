"""One process of a multi-process group for ``tests/test_torch_dist.py``,
``tests/test_torch_seq.py``, ``tests/test_torch_pipe_expert.py``,
``tests/test_torch_model_axis.py`` and ``tests/test_torch_spatial.py``.

    python tests/torch_dist_worker.py SPEC.json RANK

joins a gloo group of ``world`` processes on the CPU through the port's
``runtime.cluster.initialize`` (at ``127.0.0.1:<port>``). It first runs the
spec's ``ops`` (sequence-parallel attention over the whole group as one
``seq`` group: this process's slice of seeded global Q, K, V, the output
and the gradients of a seeded projection of it, to
``<out>/<op>-p<rank>.npz``; with ``kind`` ``gpipe`` or ``moe``, the GPipe
schedule of a seeded stage function or a seeded ``MoeMlp`` on the op's
mesh, this process's rows and pieces, with the same outputs; with ``kind``
``tp_layer``, a seeded ``TransformerLayer`` on the op's ``model`` mesh;
with ``kind`` ``spatial``, a seeded ``Conv`` or ``max_pool_same`` over the
op's ``spatial`` mesh, this process's rows of each image; with ``kind``
``capture_check``, two train steps of a preset on the op's mesh, the
second under ``tests/torch_capture_check.py``; with ``comm_volume`` and
``collectives_bench``, those modules of ``parallel/`` on the op's mesh;
with ``adafactor``, ``tests/torch_adafactor_check.py``'s updates of
seeded leaves split over the op's mesh), then every case in turn (the
port's ``vit_w128`` registered first, as that file's
``register_vit_w128`` makes it): the preset with the
case's overrides (its mesh resolved over the group), the initial state from
a file of JAX-named leaves (``TrainState.load_named``) or, with
``restore``, from a committed checkpoint of either package (waited for:
the test may write it while the spawn runs), and the given
global batches, of which this process trains its rows through the port's
``Trainer`` (``chip_smoke.fed_run``). Each case writes
``<out>/<case>-p<rank>.npz`` (the leaves this process holds; a piece of
a split leaf as ``<name>::<first row>``) and, on
process 0, ``<out>/<case>.json`` (the per-step losses summed over the
processes, and the sequence collectives' calls); with ``ckpt`` every process writes its part of a checkpoint of
the final state there. With ``grad_sum`` ``discard`` the gradients are
never summed (a control). With ``eval_batches`` process 0's json also holds
the task's ``final_eval`` over them (each process its rows) and the
decoded outputs; with ``all_params`` every process also saves each of its
parameters as it holds it (``local/<port name>``). Imports torch, the port
and ``chip_smoke`` only.
"""

import json
import os
import sys
import time

import numpy as np
import torch


def run_case(case, out_dir, rank):
    import chip_smoke
    from deeplearning_cfn_tpu_torch.ckpt import save_checkpoint
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.parallel import Elsewhere
    from deeplearning_cfn_tpu_torch.presets import get_preset

    cfg = apply_overrides(get_preset(case["preset"]), case["overrides"])
    if case.get("restore"):
        from deeplearning_cfn_tpu_torch.ckpt import read_leaves

        # The test may still be writing the checkpoint while this spawn
        # runs: wait for its commit.
        commit = os.path.join(case["restore"],
                              f"step_{case['restore_step']:08d}", "COMMIT")
        deadline = time.monotonic() + 300
        while not os.path.exists(commit):
            if time.monotonic() > deadline:
                raise TimeoutError(f"no checkpoint committed at {commit}")
            time.sleep(0.1)
        init = read_leaves(case["restore"], case["restore_step"])
    else:
        with np.load(case["init"]) as data:
            init = dict(data)
    from deeplearning_cfn_tpu_torch.parallel.collectives import comm_timer

    comm_timer.reset()
    comm_timer.enabled = True
    from deeplearning_cfn_tpu_torch.train import trainer

    summed = trainer.all_reduce_sum_
    if case.get("grad_sum") == "discard":
        # The control: the same processes with their gradients never
        # summed (chip_smoke's, as phases 28-32 run it).
        chip_smoke.time_grad_sum(torch, "discard", {})
    try:
        losses, state = chip_smoke.fed_run(
            torch, cfg, chip_smoke.load_batches(case["batches"]), "cpu",
            init=init, total_steps=case.get("total_steps"))
    finally:
        trainer.all_reduce_sum_ = summed
    comm_timer.enabled = False
    from deeplearning_cfn_tpu_torch.parallel import Rows

    leaves = {}
    for name, value in state.named_leaves():
        if isinstance(value, Rows):
            # A piece along dim 0 as <name>::<first row>, along another dim
            # as <name>::<dim>:<first index>.
            at = f"{value.dim}:{value.start}" if value.dim else value.start
            leaves[f"{name}::{at}"] = value.data
        elif not isinstance(value, Elsewhere):
            leaves[name] = value
    if case.get("all_params"):
        leaves.update({f"local/{n}": p.detach().numpy()
                       for n, p in state.model.named_parameters()})
    np.savez(os.path.join(out_dir, f"{case['name']}-p{rank}.npz"), **leaves)
    if case.get("ckpt"):
        save_checkpoint(case["ckpt"], state.step, state)
    record = {"losses": losses, "comm_calls": comm_timer.calls,
              "slot_bytes": state.optimizer.slot_bytes(),
              "slot_bytes_all": state.optimizer.slot_bytes(owned_only=False)}
    if case.get("eval_batches"):
        record["final_eval"] = final_eval(cfg, state,
                                          case["eval_batches"])
    if rank == 0:
        with open(os.path.join(out_dir, f"{case['name']}.json"), "w") as fh:
            json.dump(record, fh)


def final_eval(cfg, state, path):
    """The task's ``final_eval`` of ``state`` over the global eval batches
    in ``path``, each process on its rows (the same task, rebuilt on the
    trained model's mesh)."""
    import chip_smoke
    from deeplearning_cfn_tpu_torch.parallel import build_mesh, local_shard
    from deeplearning_cfn_tpu_torch.train.task import build_task

    mesh = build_mesh(cfg.mesh)
    task = build_task(cfg, torch.device("cpu"), mesh=mesh)
    task.model = state.model
    batches = chip_smoke.load_batches(path)
    out = task.final_eval(state, lambda: iter(
        [{k: local_shard(v, mesh) for k, v in b.items()} for b in batches]))
    return {k: float(v) for k, v in out.items()}


def run_gpipe(op, out_dir, rank):
    """``gpipe`` of ``tanh(h @ w + b)`` layers stacked [L, F, F] on the
    op's mesh: this process's stage and rows; the loss, a seeded projection
    of the output, is divided by the pipe ways (each stage computes it)."""
    from deeplearning_cfn_tpu_torch.config import MeshConfig
    from deeplearning_cfn_tpu_torch.ops.pipeline import gpipe, scan_layers
    from deeplearning_cfn_tpu_torch.parallel import batch_sharding, \
        build_mesh

    mesh = build_mesh(MeshConfig(**op["mesh"]))
    rng = np.random.RandomState(op["seed"])
    b, f, layers = op["shape"]
    w = rng.normal(0, 0.5, (layers, f, f)).astype(np.float32)
    bias = rng.normal(0, 0.5, (layers, f)).astype(np.float32)
    x = rng.standard_normal((b, f)).astype(np.float32)
    proj = rng.standard_normal((b, f)).astype(np.float32)
    rows = batch_sharding(mesh, b)
    n = layers // mesh.pipe_ways
    mine = slice(mesh.pipe_index * n, (mesh.pipe_index + 1) * n)
    params = {"w": torch.tensor(w[mine], requires_grad=True),
              "b": torch.tensor(bias[mine], requires_grad=True)}
    xt = torch.tensor(x[rows], requires_grad=True)
    stage = scan_layers(lambda p, st: {"h": torch.tanh(st["h"] @ p["w"]
                                                       + p["b"])})
    out = gpipe(stage, params, {"h": xt}, mesh=mesh,
                n_microbatches=op["m"])["h"]
    ((out * torch.from_numpy(proj[rows])).sum()
     / mesh.pipe_ways).backward()
    np.savez(os.path.join(out_dir, f"{op['name']}-p{rank}.npz"),
             out=out.detach().numpy(), dx=xt.grad.numpy(),
             dw=params["w"].grad.numpy(), db=params["b"].grad.numpy(),
             rows=[rows.start, rows.stop], layers=[mine.start, mine.stop])


def run_moe(op, out_dir, rank):
    """A seeded f32 ``MoeMlp`` on the op's mesh: this process's rows and
    experts; the loss is a seeded projection of the output plus the two
    aux losses (this process's shares of them)."""
    from deeplearning_cfn_tpu_torch.config import MeshConfig
    from deeplearning_cfn_tpu_torch.models.moe import MoeMlp
    from deeplearning_cfn_tpu_torch.parallel import batch_sharding, \
        build_mesh

    mesh = build_mesh(MeshConfig(**op["mesh"]))
    b, s, f, e, m = op["shape"]
    rng = np.random.RandomState(op["seed"])
    x = rng.standard_normal((b, s, f)).astype(np.float32)
    proj = rng.standard_normal((b, s, f)).astype(np.float32)
    weights = {k: rng.normal(0, 0.5, shape).astype(np.float32)
               for k, shape in (("router", (e, f)), ("w_in", (e, f, m)),
                                ("b_in", (e, m)), ("w_out", (e, m, f)),
                                ("b_out", (e, f)))}
    moe = MoeMlp(f, e, m, dtype=torch.float32, mesh=mesh)
    experts = slice(mesh.expert_index * e // mesh.expert_ways,
                    (mesh.expert_index + 1) * e // mesh.expert_ways)
    with torch.no_grad():
        moe.router.weight.copy_(torch.from_numpy(weights["router"]))
        for k in ("w_in", "b_in", "w_out", "b_out"):
            getattr(moe, k).copy_(torch.from_numpy(weights[k][experts]))
    rows = batch_sharding(mesh, b)
    xt = torch.tensor(x[rows], requires_grad=True)
    y, aux = moe(xt)
    ((y * torch.from_numpy(proj[rows])).sum() + aux["load_balance"]
     + aux["router_z"]).backward()
    np.savez(os.path.join(out_dir, f"{op['name']}-p{rank}.npz"),
             out=y.detach().numpy(), dx=xt.grad.numpy(),
             load_balance=aux["load_balance"].item(),
             router_z=aux["router_z"].item(),
             router=moe.router.weight.grad.numpy(),
             **{k: getattr(moe, k).grad.numpy()
                for k in ("w_in", "b_in", "w_out", "b_out")},
             rows=[rows.start, rows.stop],
             experts=[experts.start, experts.stop])


def seeded_tp_layer(shape, seed, mesh=None):
    """A seeded f32 post-LN ``TransformerLayer`` (hidden, heads, mlp of
    ``shape``) holding ``mesh``'s pieces of the one-process layer's
    weights, the seeded inputs [B, S, F] and the output projection."""
    from deeplearning_cfn_tpu_torch.models.transformer import Dense, \
        TransformerLayer

    b, s, f, h, m = shape
    rng = np.random.RandomState(seed)
    whole = TransformerLayer(f, h, m, torch.float32)
    with torch.no_grad():
        for _, p in whole.named_parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.3, tuple(p.shape))
                                     .astype(np.float32)))
    x = rng.standard_normal((b, s, f)).astype(np.float32)
    proj = rng.standard_normal((b, s, f)).astype(np.float32)
    if mesh is None:
        return whole, x, proj
    layer = TransformerLayer(f, h, m, torch.float32, mesh=mesh)
    mods = dict(whole.named_modules())
    with torch.no_grad():
        for name, mod in layer.named_modules():
            for pname, p in mod.named_parameters(recurse=False):
                src = getattr(mods[name], pname)
                if isinstance(mod, Dense) and pname == "weight":
                    src = mod.piece_of(src)
                p.copy_(src)
    return layer, x, proj


def run_tp_layer(op, out_dir, rank):
    """A seeded ``TransformerLayer`` on the op's ``model`` mesh: this
    process's rows, heads and hidden units; its loss, a seeded projection
    of the output, is divided by the replicas (each process of a model
    group computes the whole output). Saves the output, the input's and
    every parameter's gradient, and each split weight's range."""
    from deeplearning_cfn_tpu_torch.config import MeshConfig
    from deeplearning_cfn_tpu_torch.models.transformer import Dense
    from deeplearning_cfn_tpu_torch.parallel import batch_sharding, \
        build_mesh

    mesh = build_mesh(MeshConfig(**op["mesh"]))
    layer, x, proj = seeded_tp_layer(op["shape"], op["seed"], mesh)
    rows = batch_sharding(mesh, x.shape[0])
    xt = torch.tensor(x[rows], requires_grad=True)
    y = layer(xt)
    ((y * torch.from_numpy(proj[rows])).sum() / mesh.replicas).backward()
    ranges = {}
    for name, mod in layer.named_modules():
        if isinstance(mod, Dense) and mod.split is not None:
            dim = 0 if mod.split == "column" else 1
            n = mod.weight.shape[dim]
            ranges[f"range/{name}.weight"] = [dim, mesh.model_index * n,
                                              (mesh.model_index + 1) * n]
    np.savez(os.path.join(out_dir, f"{op['name']}-p{rank}.npz"),
             out=y.detach().numpy(), dx=xt.grad.numpy(),
             rows=[rows.start, rows.stop], **ranges,
             **{f"grad/{n}": p.grad.numpy()
                for n, p in layer.named_parameters()})


def seeded_spatial_op(op):
    """The op's seeded weights, inputs [B, C, H, W] and projection."""
    b, c, h, o = op["shape"]
    rng = np.random.RandomState(op["seed"])
    k = op["kernel"]
    w = rng.normal(0, 0.3, (o, c, k, k)).astype(np.float32)
    x = rng.standard_normal((b, c, h, h)).astype(np.float32)
    out_h = -(-h // op["stride"])
    proj = rng.standard_normal((b, c if op["pool"] else o, out_h, out_h)) \
        .astype(np.float32)
    return w, x, proj


def run_spatial(op, out_dir, rank):
    """A seeded ``Conv`` (or ``max_pool_same``) over the op's ``spatial``
    mesh: this process's rows of its images. Saves the output rows, the
    input rows' gradient and the weight's gradient (this process's
    part)."""
    from deeplearning_cfn_tpu_torch.config import MeshConfig
    from deeplearning_cfn_tpu_torch.models.resnet import Conv, \
        max_pool_same
    from deeplearning_cfn_tpu_torch.parallel import batch_sharding, \
        build_mesh, spatial_slice

    mesh = build_mesh(MeshConfig(**op["mesh"]))
    w, x, proj = seeded_spatial_op(op)
    rows = batch_sharding(mesh, x.shape[0])
    xt = torch.tensor(spatial_slice(x[rows], mesh, 2).copy(),
                      requires_grad=True)
    conv = Conv(w.shape[1], w.shape[0], op["kernel"], op["stride"],
                torch.float32)
    conv.mesh = mesh
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
    y = max_pool_same(xt, op["kernel"], op["stride"], mesh) if op["pool"] \
        else conv(xt)
    mine = spatial_slice(proj[rows], mesh, 2)
    (y * torch.from_numpy(np.ascontiguousarray(mine))).sum().backward()
    np.savez(os.path.join(out_dir, f"{op['name']}-p{rank}.npz"),
             out=y.detach().numpy(), dx=xt.grad.numpy(),
             dw=np.zeros_like(w) if op["pool"] else conv.weight.grad.numpy(),
             rows=[rows.start, rows.stop], spatial=mesh.spatial_index)


def run_capture_check(op, out_dir, rank):
    """Two train steps of the op's preset on its mesh (seeded init, this
    process's rows of two global batches), the second under the capture
    check (``tests/torch_capture_check.py``): the ops a CUDA graph capture
    would refuse, which the step must not run for NCCL to replay it whole
    (``train/graphs.py``), to ``<out>/<op>-p<rank>.json``."""
    import chip_smoke
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.data.pipeline import build_pipeline
    from deeplearning_cfn_tpu_torch.presets import get_preset
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer
    from torch_capture_check import refused_ops

    cfg = apply_overrides(get_preset(op["preset"]), op["overrides"])
    # The global batches: the whole pipeline, as one process reads it.
    batches = [b for _, b in zip(range(2), build_pipeline(
        cfg.data, cfg.train.global_batch, cfg.model.num_classes, seed=0,
        process_index=0, process_count=1).one_epoch())]
    step, calls, seen = Trainer.train_step, [], []

    def checked(self, state, batch):
        calls.append(len(calls))
        if len(calls) == 1:
            return step(self, state, batch)
        out, refused = refused_ops(lambda: step(self, state, batch))
        seen.extend(refused)
        return out

    Trainer.train_step = checked
    try:
        chip_smoke.fed_run(torch, cfg, batches, "cpu")
    finally:
        Trainer.train_step = step
    with open(os.path.join(out_dir, f"{op['name']}-p{rank}.json"),
              "w") as fh:
        json.dump({"refused": seen, "steps": len(calls)}, fh)


def run_comm_volume(op, out_dir, rank):
    """``parallel.comm_volume.count_train_step`` of JAX's tiny
    configuration of the op's model on its mesh; process 0 writes the row
    to ``<out>/<op>.json``."""
    from deeplearning_cfn_tpu_torch.config import MeshConfig
    from deeplearning_cfn_tpu_torch.parallel.comm_volume import \
        count_train_step, train_step_config

    row = count_train_step(train_step_config(
        op["model"], MeshConfig(**op["mesh"]), seq_impl=op["impl"]))
    if rank == 0:
        with open(os.path.join(out_dir, f"{op['name']}.json"), "w") as fh:
            json.dump(row, fh)


def run_collectives_bench(op, out_dir, rank):
    """``parallel.collectives_bench.run_collectives_bench`` over the op's
    axis of its mesh; process 0 writes the records to
    ``<out>/<op>.json``."""
    from deeplearning_cfn_tpu_torch.config import MeshConfig
    from deeplearning_cfn_tpu_torch.parallel import build_mesh
    from deeplearning_cfn_tpu_torch.parallel.collectives_bench import \
        run_collectives_bench as bench

    records = bench(build_mesh(MeshConfig(**op["mesh"])), op["axis"],
                    op["size_mb"], iters=2, warmup=1, device="cpu")
    if rank == 0:
        with open(os.path.join(out_dir, f"{op['name']}.json"), "w") as fh:
            json.dump(records, fh)


def run_adafactor(op, out_dir, rank):
    from torch_adafactor_check import run_op as adafactor

    adafactor(op, out_dir, rank)


OP_KINDS = {"adafactor": run_adafactor,
            "capture_check": run_capture_check,
            "comm_volume": run_comm_volume,
            "collectives_bench": run_collectives_bench}


def run_op(op, out_dir, rank):
    if op.get("kind") in OP_KINDS:
        return OP_KINDS[op["kind"]](op, out_dir, rank)
    if op.get("kind") == "gpipe":
        return run_gpipe(op, out_dir, rank)
    if op.get("kind") == "moe":
        return run_moe(op, out_dir, rank)
    if op.get("kind") == "tp_layer":
        return run_tp_layer(op, out_dir, rank)
    if op.get("kind") == "spatial":
        return run_spatial(op, out_dir, rank)
    from deeplearning_cfn_tpu_torch.config import MeshConfig
    from deeplearning_cfn_tpu_torch.ops.ring_attention import \
        ring_attention_sharded
    from deeplearning_cfn_tpu_torch.ops.ulysses import \
        ulysses_attention_sharded
    from deeplearning_cfn_tpu_torch.parallel import build_mesh, seq_slice

    mesh = build_mesh(MeshConfig(data=1, seq=op["world"]))
    fn = {"ring": ring_attention_sharded,
          "ulysses": ulysses_attention_sharded}[op["impl"]]
    rng = np.random.RandomState(op["seed"])
    q, k, v, w = (rng.standard_normal(op["shape"]).astype(np.float32)
                  for _ in range(4))
    mine = seq_slice(mesh, op["shape"][2])
    q, k, v = (torch.from_numpy(t[:, :, mine].copy()).requires_grad_()
               for t in (q, k, v))
    out = fn(q, k, v, mesh, causal=op["causal"])
    (out * torch.from_numpy(w[:, :, mine].copy())).sum().backward()
    np.savez(os.path.join(out_dir, f"{op['name']}-p{rank}.npz"),
             out=out.detach().numpy(), dq=q.grad.numpy(),
             dk=k.grad.numpy(), dv=v.grad.numpy())


def main(spec_path, rank):
    torch.set_num_threads(1)
    from torch_adafactor_check import register_vit_w128

    register_vit_w128()
    with open(spec_path) as fh:
        spec = json.load(fh)
    from deeplearning_cfn_tpu_torch.runtime.cluster import ClusterSpec, \
        initialize

    initialize(ClusterSpec(hosts=["127.0.0.1"] * spec["world"],
                           process_id=rank, chips_per_host=1,
                           coordinator_port=spec["port"]),
               timeout_s=120, accelerator="cpu")
    for op in spec.get("ops", ()):
        run_op(dict(op, world=spec["world"]), spec["out"], rank)
    for case in spec["cases"]:
        run_case(case, spec["out"], rank)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
