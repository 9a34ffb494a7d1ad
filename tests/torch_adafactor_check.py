"""Adafactor over leaves split into pieces across processes: the seeded
whole leaves and gradients (numpy), one process's part of the updates
(:func:`run_op`, a ``tests/torch_dist_worker.py`` op of kind
``adafactor``), and the check of every process's part against
``optax.adafactor`` on the whole leaves as the JAX package builds it
(:func:`check`, used by ``tests/test_torch_model_axis.py`` and
``tests/test_torch_pipe_expert.py``).

The leaves, in Flax's layout, split over the op's one split axis:

- ``stacked`` ``[4, 128, 160]`` along dim 0, which neither factored dim is
  (as ``pipe`` splits a layer stack and ``expert`` an expert stack): both
  moments are pieces;
- ``d0`` ``[256, 136]`` along its largest dim: ``v_row`` is whole;
- ``d1`` ``[136, 512]`` along its second largest: ``v_col`` is whole, and
  ``v_row``'s mean needs the peers;
- ``square`` ``[128, 128]`` along dim 1: the whole leaf factors (the tie
  breaks as numpy's ``argsort`` does), a 128 × 64 piece would not;
- ``bias`` ``[256]``: unfactored, ``v`` a piece;
- ``whole`` ``[160, 130]``: replicated.

``UPDATES`` updates with weight decay, behind the global-norm clip, under
a warmup-then-cosine learning rate. Imports JAX only in :func:`check`.
"""

import os

import numpy as np

# name: (whole Flax shape, the port's layout kind, the split dim or None)
LEAVES = {"stacked": ((4, 128, 160), "none", 0),
          "d0": ((256, 136), "dense", 0),
          "d1": ((136, 512), "dense", 0),
          "square": ((128, 128), "dense", 1),
          "bias": ((256,), "none", 0),
          "whole": ((160, 130), "dense", None)}
SPEC = dict(name="adafactor", weight_decay=0.05, grad_clip_norm=1.0)
SCHED = dict(name="cosine", base_lr=0.05, warmup_steps=2, end_lr_factor=0.1)
UPDATES = 4
PARAM_TOL, SLOT_RTOL = 1e-6, 1e-5
SPLIT_AXES = ("pipe", "model", "expert")
# A ViT whose kernels factor whole (hidden 128, MLP 256) but whose model
# pieces of the 128 × 128 kernels would not alone: 2 layers, 4 heads,
# patch 4. Neither package registers such a width.
VIT_W128 = "vit_w128"
VIT_DIMS = dict(patch_size=4, hidden_size=128, num_layers=2, num_heads=4,
                mlp_dim=256)


def register_vit_w128(jax=False):
    """:data:`VIT_W128` in the port's model registry (and the JAX
    package's with ``jax``)."""
    from deeplearning_cfn_tpu_torch.models import register_model
    from deeplearning_cfn_tpu_torch.models import vit

    register_model(VIT_W128)(lambda num_classes, dtype, device=None, **kw:
                             vit._build(device, num_classes=num_classes,
                                        dtype=dtype, **VIT_DIMS, **kw))
    if jax:
        from deeplearning_cfn_tpu.models import register_model as j_register
        from deeplearning_cfn_tpu.models.vit import VisionTransformer

        j_register(VIT_W128)(lambda num_classes, dtype, **kw:
                             VisionTransformer(num_classes=num_classes,
                                               dtype=dtype, **VIT_DIMS, **kw))


def adafactor_op(name, mesh, seed, zero1=False):
    """A ``tests/torch_dist_worker.py`` op: the updates on ``mesh``
    (ZeRO-1 over it with ``zero1``)."""
    return dict(kind="adafactor", name=name, mesh=dict(mesh), seed=seed,
                zero1=zero1)


def _scales(rng, shape):
    """A factor ``e^N(0, 1)`` per index of each dim, their product over the
    dims: gradients whose scale changes from update to update unevenly
    over each dim, so that each piece's own RMS of its update parts from
    the whole leaf's."""
    out = np.ones(shape)
    for d, n in enumerate(shape):
        at = [1] * len(shape)
        at[d] = n
        out = out * np.exp(rng.normal(0, 1, n)).reshape(at)
    return out


def seeded(seed):
    """The whole leaves and each update's whole gradients (Flax's
    layout)."""
    rng = np.random.RandomState(seed)
    params = {k: rng.normal(0, 0.3, shape).astype(np.float32)
              for k, (shape, _, _) in LEAVES.items()}
    grads = [{k: (rng.normal(0, 1, v.shape) * _scales(rng, v.shape))
              .astype(np.float32) for k, v in params.items()}
             for _ in range(UPDATES)]
    return params, grads


def run_op(op, out_dir, rank):
    """This process's pieces of the seeded leaves through the port's
    ``Optimizer`` on the op's mesh; saves each parameter as it holds it
    (Flax's layout), its range, and the slots it holds with the dim along
    which each is a piece (-1: whole)."""
    import torch

    from deeplearning_cfn_tpu_torch.config import (MeshConfig,
                                                   OptimizerConfig,
                                                   ScheduleConfig)
    from deeplearning_cfn_tpu_torch.convert import from_flax, to_flax
    from deeplearning_cfn_tpu_torch.parallel import Piece, build_mesh
    from deeplearning_cfn_tpu_torch.parallel.sharding import piece_rows
    from deeplearning_cfn_tpu_torch.train import optim

    mesh = build_mesh(MeshConfig(**op["mesh"]))
    axis = next(a for a in SPLIT_AXES if mesh.shape[a] > 1)
    params, grads = seeded(op["seed"])
    tensors, kinds, pieces, out = {}, {}, {}, {}

    def port(whole, name):
        shape, kind, dim = LEAVES[name]
        if dim is not None:
            whole = pieces[name].of(whole)
        return torch.from_numpy(np.ascontiguousarray(from_flax(whole, kind)))

    for name, (shape, kind, dim) in LEAVES.items():
        if dim is not None:
            at = piece_rows(mesh, axis, shape[dim])
            pieces[name] = Piece(axis, at.start, at.stop, shape[dim], mesh,
                                 dim)
            out[f"range/{name}"] = [dim, at.start, at.stop]
        tensors[name] = torch.nn.Parameter(port(params[name], name))
        kinds[tensors[name]] = kind
    opt = optim.Optimizer(
        OptimizerConfig(**SPEC),
        optim.build_schedule(ScheduleConfig(**SCHED), UPDATES, 64),
        list(tensors.values()), kinds, shard_opt_state=op["zero1"],
        pieces={id(tensors[k]): pc for k, pc in pieces.items()})
    for g in grads:
        for name, t in tensors.items():
            t.grad = port(g[name], name)
        opt.step()
    for name, t in tensors.items():
        out[f"param/{name}"] = to_flax(t.detach().numpy(), LEAVES[name][1])
        if not opt.owns(t):
            continue
        for key, dim in opt.inner.slot_dims(t).items():
            out[f"slot/{name}/{key}"] = opt.inner.slot(t, key).numpy()
            out[f"slotdim/{name}/{key}"] = -1 if dim is None else dim
    np.savez(os.path.join(out_dir, f"{op['name']}-p{rank}.npz"), **out)


def _optax_reference(seed):
    """The whole leaves and slots after the updates of
    ``optax.adafactor`` as the JAX package's ``build_optimizer`` chains
    it."""
    import jax
    import jax.numpy as jnp
    import optax

    from deeplearning_cfn_tpu.config import OptimizerConfig, ScheduleConfig
    from deeplearning_cfn_tpu.train import optim as joptim
    from deeplearning_cfn_tpu.utils.trees import flatten_with_names

    params, grads = seeded(seed)
    tx = joptim.build_optimizer(OptimizerConfig(**SPEC), joptim.build_schedule(
        ScheduleConfig(**SCHED), UPDATES, 64))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)

    @jax.jit
    def update(g, state, jp):
        upd, state = tx.update(g, state, jp)
        return optax.apply_updates(jp, upd), state

    for g in grads:
        jp, state = update({k: jnp.asarray(v) for k, v in g.items()}, state,
                           jp)
    # The chain: the clip, the masked decay, then Adafactor.
    slots = {n[len("2/0/"):]: np.asarray(v)
             for n, v in flatten_with_names(state)[0]
             if n.startswith("2/0/v")}
    return {k: np.asarray(v) for k, v in jp.items()}, slots


def _place(whole, part, dim, start, stop):
    at = [slice(None)] * whole.ndim
    at[dim] = slice(start, stop)
    whole[tuple(at)] = part


def check(op, parts):
    """Every process's parameters and slots of ``op`` (``parts``, in rank
    order)
    against optax on the whole leaves: the pieces put together, each whole
    copy on its own; parameters within ``PARAM_TOL`` of the largest
    entry, slots within ``SLOT_RTOL`` relative. Returns the count of
    slots that were pieces and that were whole copies of a split leaf's
    moment."""
    want, want_slots = _optax_reference(op["seed"])
    close = lambda got, ref, what: np.testing.assert_allclose(
        got, ref, rtol=0, atol=PARAM_TOL * max(1.0, np.abs(ref).max()),
        err_msg=what)
    kinds = {"piece": 0, "whole": 0}
    for name, (shape, _, dim) in LEAVES.items():
        got = np.full(shape, np.nan, np.float32)
        for part in parts:
            if dim is None:
                close(part[f"param/{name}"], want[name], name)
                continue
            _, start, stop = part[f"range/{name}"]
            _place(got, part[f"param/{name}"], dim, start, stop)
        if dim is not None:
            close(got, want[name], name)
        for key in ("v_row", "v_col", "v"):
            ref = want_slots[f"{key}/{name}"]
            held = [p for p in parts if f"slot/{name}/{key}" in p]
            assert held, (name, key)
            slot = np.full(ref.shape, np.nan, np.float32)
            for part in held:
                sd = int(part[f"slotdim/{name}/{key}"])
                value = part[f"slot/{name}/{key}"]
                if sd < 0:
                    kinds["whole"] += dim is not None and value.size > 1
                    np.testing.assert_allclose(value, ref, rtol=SLOT_RTOL,
                                               atol=1e-30,
                                               err_msg=f"{name} {key}")
                    slot = value
                    continue
                kinds["piece"] += 1
                _, start, stop = part[f"range/{name}"]
                _place(slot, value, sd, start, stop)
            np.testing.assert_allclose(slot, ref, rtol=SLOT_RTOL, atol=1e-30,
                                       err_msg=f"{name} {key}")
    return kinds
