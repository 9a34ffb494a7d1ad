"""Layer stacks as pipeline stages — the port of
``deeplearning_cfn_tpu/ops/pipeline.py``.

``scan_layers`` lifts a one-layer function into a stage function over a
dict of parameters stacked on a leading layer dim [L, ...], as the JAX
``lax.scan`` does: a loop over the layers, each given its slice. The stack
is split once with ``unbind``, whose backward stacks the L slices'
gradients into one tensor (indexing it layer by layer would allocate a
zero-filled [L, ...] gradient per layer).

``gpipe`` is the GPipe schedule over a ``pipe`` mesh axis, one process per
stage, with JAX's contract: each process holds its stage's L/S layers
(``parallel/sharding.py``'s ``pipe_stack/`` rule), the batch is replicated
over ``pipe`` and split into ``n_microbatches`` contiguous microbatches, and
the last stage's outputs come back to every stage through a masked sum over
the ``pipe`` group (``collectives.masked_sum``), so the heads and the loss
run replicated over ``pipe``. JAX runs the M + S − 1 ticks as one ``scan``
in which every stage computes at every tick (bubble ticks on garbage) and
``ppermute`` moves every state one stage on; AD transposes it. Here a tick
runs stage ``i`` only where it holds a real microbatch (``t − i`` in
``[0, M)``), and the state hops from stage ``i`` to ``i + 1`` only then
(``collectives.exchange``: both ends know the tick), so no garbage is
computed or sent. Under grad the schedule is one ``autograd.Function``
whose forward keeps each microbatch's stage graph and whose backward runs
the ticks in reverse, sending each input's gradient to the previous stage
and receiving each output's from the next: every stage issues its hops in
the same order both ways, whatever order the autograd engine would pick.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ..parallel.collectives import exchange, masked_sum

Params = Dict[str, torch.Tensor]


class _Plan:
    """The schedule of one process: its stage, its neighbours' global
    ranks, the microbatch count, and which state leaves carry a gradient
    from stage to stage (the floating-point ones, on every stage alike)."""

    def __init__(self, stage_fn, pkeys, xkeys, mesh, axis_name, m, needs):
        self.stage_fn, self.pkeys, self.xkeys = stage_fn, pkeys, xkeys
        self.n = mesh.shape[axis_name]
        self.idx = mesh.coords[axis_name]
        ranks = mesh.ranks_along((axis_name,))
        self.prev = ranks[self.idx - 1] if self.idx > 0 else None
        self.next = ranks[self.idx + 1] if self.idx < self.n - 1 else None
        self.group = mesh.group((axis_name,))
        self.m, self.needs = m, needs
        self.ticks = m + self.n - 1

    def live(self, stage: int, t: int) -> bool:
        return 0 <= t - stage < self.m

    def sends(self, t: int) -> bool:
        """Whether this stage sends its tick-``t`` output on."""
        return self.next is not None and self.live(self.idx, t)

    def receives(self, t: int) -> bool:
        """Whether this stage receives its tick-``t + 1`` input."""
        return self.prev is not None and self.live(self.idx - 1, t)

    def run(self, params: List[torch.Tensor], x: List[torch.Tensor]
            ) -> List[torch.Tensor]:
        out = self.stage_fn(dict(zip(self.pkeys, params)),
                            dict(zip(self.xkeys, x)))
        return [out[k] for k in self.xkeys]

    def forward(self, params, leaves, graphs: Optional[dict]):
        """The ticks; this stage's outputs (the last stage's real ones,
        zeros elsewhere). With ``graphs`` each microbatch's (inputs,
        outputs) are kept there, built with grad."""
        b = leaves[0].shape[0]
        mbs = [t.reshape((self.m, b // self.m) + t.shape[1:]).unbind(0)
               for t in leaves]
        like = [mb[0] for mb in mbs]
        outs, state = [None] * self.m, None
        for t in range(self.ticks):
            y = None
            if self.live(self.idx, t):
                mb = t - self.idx
                x = [l[mb] for l in mbs] if self.idx == 0 else state
                if graphs is None:
                    y = self.run(params, x)
                else:
                    x = [v.detach().requires_grad_(need)
                         for v, need in zip(x, self.needs)]
                    with torch.enable_grad():
                        y = self.run(params, x)
                    graphs[mb] = (x, y)
                if self.next is None:
                    outs[mb] = [v.detach() for v in y]
            state = exchange([v.detach() for v in y] if y is not None
                             else [], self.next if self.sends(t) else None,
                             like, self.prev if self.receives(t) else None,
                             self.group)
        if self.next is not None:
            return [torch.zeros_like(t) for t in leaves]
        return [torch.cat([o[i] for o in outs]) for i in range(len(leaves))]


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan: _Plan, n_params: int, *tensors):
        params = [p.detach().requires_grad_() for p in tensors[:n_params]]
        leaves = list(tensors[n_params:])
        ctx.plan, ctx.params, ctx.graphs = plan, params, {}
        ctx.leaf_shapes = [(t.shape, t.dtype, t.requires_grad)
                           for t in leaves]
        return tuple(plan.forward(params, leaves, ctx.graphs))

    @staticmethod
    def backward(ctx, *g_outs):
        plan, params = ctx.plan, ctx.params
        grad_of = [i for i, need in enumerate(plan.needs) if need]
        p_grads = [torch.zeros_like(p) for p in params]
        x_grads: List[Optional[List[torch.Tensor]]] = [None] * plan.m
        g_state: List[torch.Tensor] = []
        for t in reversed(range(plan.ticks)):
            like = []
            if plan.sends(t):
                _, y = ctx.graphs[t - plan.idx]
                like = [y[i] for i in grad_of]
            # The reverse of tick t's hop: the gradient of the input this
            # stage received goes back, its output's comes in.
            g_y = exchange(g_state, plan.prev if plan.receives(t) else None,
                           like, plan.next if plan.sends(t) else None,
                           plan.group)
            if not plan.live(plan.idx, t):
                continue
            mb = t - plan.idx
            x, y = ctx.graphs.pop(mb)
            if plan.next is None:
                rows = y[0].shape[0]
                g_y = [torch.zeros_like(y[i]) if g_outs[i] is None
                       else g_outs[i][mb * rows:(mb + 1) * rows]
                       for i in grad_of]
            outs = [(y[i], g) for i, g in zip(grad_of, g_y)
                    if y[i].requires_grad]
            inputs = params + [x[i] for i in grad_of]
            grads = torch.autograd.grad([o for o, _ in outs], inputs,
                                        [g for _, g in outs],
                                        allow_unused=True) if outs \
                else [None] * len(inputs)
            for acc, g in zip(p_grads, grads[:len(params)]):
                if g is not None:
                    acc.add_(g)
            g_x = [torch.zeros_like(x[i]) if g is None else g
                   for i, g in zip(grad_of, grads[len(params):])]
            if plan.idx == 0:
                x_grads[mb] = g_x
            else:
                g_state = g_x
        leaf_grads = [None] * len(ctx.leaf_shapes)
        for j, i in enumerate(grad_of):
            shape, dtype, wanted = ctx.leaf_shapes[i]
            if not wanted:
                continue
            leaf_grads[i] = torch.cat([g[j] for g in x_grads]) \
                if plan.idx == 0 else torch.zeros(
                    shape, dtype=dtype, device=params[0].device)
        return (None, None, *p_grads, *leaf_grads)


def gpipe(stage_fn: Callable[[Params, Dict[str, torch.Tensor]],
                             Dict[str, torch.Tensor]],
          stage_params: Params, xs: Dict[str, torch.Tensor], *, mesh,
          n_microbatches: int, axis_name: str = "pipe",
          batch_spec="data") -> Dict[str, torch.Tensor]:
    """Run ``stage_fn`` as an S-stage pipeline over ``mesh[axis_name]``.

    ``stage_fn(local_params, state) -> state`` applies ONE stage's layers to
    a microbatch ``state`` (a dict of [mb, ...] tensors) and returns the
    same keys, shapes and dtypes (pass-through leaves, an attention bias,
    travel with the microbatch). ``stage_params``: this stage's [L/S, ...]
    slices. ``xs``: this process's rows [B, ...] (the same on every stage);
    B must split into ``n_microbatches``. Returns the last stage's output
    [B, ...] on every stage of the group. ``batch_spec`` is JAX's (the
    batch axes the rows came over) and changes nothing here."""
    del batch_spec
    xkeys, pkeys = list(xs), list(stage_params)
    leaves = [xs[k] for k in xkeys]
    b = leaves[0].shape[0]
    if b % n_microbatches:
        raise ValueError(f"local batch {b} not divisible into "
                         f"{n_microbatches} microbatches")
    params = [stage_params[k] for k in pkeys]
    needs = [t.is_floating_point() for t in leaves]
    plan = _Plan(stage_fn, pkeys, xkeys, mesh, axis_name, n_microbatches,
                 needs)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in params + leaves):
        out = _GPipe.apply(plan, len(params), *params, *leaves)
    else:
        out = plan.forward(params, leaves, None)
    last = plan.next is None
    return {k: masked_sum(v, last, plan.group) if plan.group is not None
            else v for k, v in zip(xkeys, out)}


def scan_layers(layer_fn: Callable[[Params, object], object]
                ) -> Callable[[Params, object], object]:
    """``stage_fn(params, state)``: ``layer_fn(layer_params, state)`` over
    every layer of ``params`` (each value [L, ...]) in order."""

    def stage_fn(params: Params, state):
        layers = {k: v.unbind(0) for k, v in params.items()}
        depth = len(next(iter(layers.values())))
        for i in range(depth):
            state = layer_fn({k: v[i] for k, v in layers.items()}, state)
        return state

    return stage_fn
