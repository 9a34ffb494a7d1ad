"""The collectives of data and sequence parallelism over the process group.

The JAX step is one program over the global batch, so its sums run over the
whole batch by construction and XLA inserts the ``psum``. The port's
processes each hold a contiguous block of rows (and, with a ``seq`` axis, a
slice of each row's sequence), and these functions make the same sums
explicit: over every process of the job (the gradient sum, the loss's
denominators, the metrics), or, for the sequence collectives, over a
``group`` argument, a mesh's ``seq_group()``, the processes that share
rows (``parallel/mesh.py``):

- :func:`global_sum`: the sum of a tensor over the processes (or a
  group), differentiable (its backward sums the incoming gradients too:
  every process's loss depends on the sum) — BatchNorm's statistics, the
  MoE router's;
- :func:`global_total`: the same without a gradient — the denominators of a
  global-batch mean (token, mask and example counts);
- :func:`all_reduce_sum_`: gradients summed in place, in one flat buffer per
  dtype and group: each over the processes that hold the same leaf (the
  world for a replicated one, ``Mesh.holders_group`` for a piece of a
  split one);
- :func:`reduce_scalars`: metrics summed in one collective (partials of a
  global mean add up to it), except those every process already holds;
- :func:`broadcast_object`, :func:`all_gather_objects` and
  :func:`gather_batches` for host values (decoded eval sets);
- over a ``seq`` group: :func:`send_recv` (ring attention's rotations),
  :func:`all_to_all` (Ulysses's reswizzles) and :func:`gather_seq` (the
  sequence slices of an activation gathered into whole rows, with a
  gradient);
- over a ``pipe`` group: :func:`exchange` (GPipe's stage hops, forward and
  backward: ``ops/pipeline.py``) and :func:`masked_sum` (the last stage's
  output on every stage, with a gradient);
- over an ``expert`` group: :func:`all_to_all_grad` (:func:`all_to_all`
  with its inverse as the backward: MoE's dispatch and combine);
- over a ``model`` group, the conjugate pair of tensor parallelism:
  :func:`model_copy` into the column-parallel products and
  :func:`model_sum` after the row-parallel ones;
- over a ``spatial`` group: :func:`halo_rows` (a conv's or a pool's rows
  from the neighbours, the halo's gradient sent back and added) and
  :func:`gather_rows` (the groups' rows gathered into whole images, the
  backward a reduce-scatter).

The gradient convention of every collective here is the trainer's: a
process's loss is its share of the global loss (its rows' loss divided by
``Mesh.replicas``), and each gradient is summed, right after the backward,
over the processes that hold its leaf. So a tensor every process of a group
holds (the input of a column-parallel product, the output of the sum) has,
on each process, a part of its gradient, and the parts add up over the
group: :func:`model_copy` is the identity both ways, and :func:`model_sum`
and :func:`gather_rows` sum the parts in their backward, where each process
needs the whole gradient of its own piece. (Megatron's textbook pair puts
the sum in the copy's backward instead and sums nothing over the model
group afterwards; mixed with this trainer it would scale gradients by the
group's size.)

Every function is the identity (no collective) with one process, so the
one-device path computes exactly what it did before the mesh existed. The
backend is the group's: gloo reduces CPU and CUDA tensors (a CUDA tensor
staged through the host), NCCL CUDA tensors. The sequence, pipe and
expert collectives stage a CUDA tensor through host buffers themselves
under gloo (its point-to-point and all-to-all take CPU tensors), and time
the exchange when :data:`comm_timer` is on.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from .mesh import process_count, process_index


def _dist():
    import torch.distributed as dist

    return dist


class CommTimer:
    """Seconds (and calls) of the sequence, pipe, expert, model and spatial
    collectives by kind (``"ring"``, ``"ulysses"``, ``"gather"``,
    ``"pipe"``, ``"expert"``, ``"model"``, ``"halo"``, ``"spatial"``),
    counted while ``enabled``:
    the card is synchronized before and after each exchange, so a time is
    the exchange's alone, the host staging included. Off by default: the
    synchronizations would serialize the step."""

    def __init__(self):
        self.enabled = False
        self.seconds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}

    def reset(self) -> None:
        self.seconds, self.calls = {}, {}

    @contextlib.contextmanager
    def measure(self, kind: str, device: torch.device):
        if not self.enabled:
            yield
            return
        sync = torch.cuda.synchronize if device.type == "cuda" \
            else (lambda *a: None)
        sync(device)
        t0 = time.perf_counter()
        yield
        sync(device)
        self.seconds[kind] = self.seconds.get(kind, 0.0) \
            + time.perf_counter() - t0
        self.calls[kind] = self.calls.get(kind, 0) + 1


comm_timer = CommTimer()


def _staging(t: torch.Tensor, group) -> bool:
    """Whether ``t`` crosses the group through a host buffer: a CUDA
    tensor under gloo."""
    return t.is_cuda and _dist().get_backend(group) == "gloo"


def _to_wire(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    return t.cpu() if _staging(t, group) else t


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone()
        _dist().all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        # d(Σ_s loss_s)/dx_r = Σ_s dloss_s/dy, y = Σ_r x_r on every process.
        out = grad.contiguous().clone()
        _dist().all_reduce(out, group=ctx.group)
        return out, None


def global_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the processes (or over ``group``), with a gradient
    (``x`` itself with one process)."""
    if process_count() == 1:
        return x
    return _GlobalSum.apply(x, group)


def global_total(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the processes (or over ``group``), without a
    gradient: the count a global-batch mean divides by (``x`` itself with
    one process)."""
    if process_count() == 1:
        return x
    out = x.detach().clone()
    _dist().all_reduce(out, group=group)
    return out


WORLD = "world"  # all_reduce_sum_'s group of a replicated tensor


def all_reduce_sum_(tensors: Sequence[torch.Tensor],
                    groups: Optional[Sequence[Any]] = None) -> None:
    """Sum ``tensors`` in place, each over its entry of ``groups``:
    :data:`WORLD` (every process; the default for all), a process group,
    or None (this process alone: left as it is). One collective per group
    and dtype, over a flat buffer of its tensors, the groups in order of
    first appearance (the same on every process that shares one). No-op
    with one process."""
    if process_count() == 1 or not tensors:
        return
    if groups is None:
        groups = [WORLD] * len(tensors)
    buckets: Dict[tuple, List[torch.Tensor]] = {}
    for t, g in zip(tensors, groups):
        if g is not None:
            buckets.setdefault((id(g), t.dtype), [g]).append(t)
    for group, *members in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in members])
        _dist().all_reduce(flat, group=None if group is WORLD else group)
        offset = 0
        for t in members:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def reduce_scalars(values: Dict[str, torch.Tensor],
                   replicated: Sequence[str] = ()) -> Dict[str, float]:
    """Host floats of scalar tensors, summed over the processes in one
    collective; the ``replicated`` keys (the same value on every process,
    such as the norm of the summed gradients) are taken from process 0."""
    keys = list(values)
    if not keys:
        return {}
    flat = torch.stack([values[k].detach().reshape(-1)[-1].float()
                        for k in keys])
    if process_count() > 1:
        if process_index() != 0:
            keep = torch.tensor([k not in replicated for k in keys],
                                device=flat.device)
            flat = torch.where(keep, flat, torch.zeros_like(flat))
        _dist().all_reduce(flat)
    return dict(zip(keys, flat.cpu().tolist()))


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Process ``src``'s ``obj`` on every process."""
    if process_count() == 1:
        return obj
    box = [obj]
    _dist().broadcast_object_list(box, src=src)
    return box[0]


def all_gather_objects(obj: Any) -> List[Any]:
    """Every process's ``obj``, in process order (``[obj]`` with one)."""
    if process_count() == 1:
        return [obj]
    out: List[Any] = [None] * process_count()
    _dist().all_gather_object(out, obj)
    return out


def gather_batches(per_batch: List[List[Any]], mesh=None) -> List[Any]:
    """Items collected batch by batch on every process, in the global
    batch's order: batch 0's items of process 0, then of process 1, ...,
    then batch 1's (``per_batch`` flattened with one process). With a
    ``mesh``, only the processes at coordinate 0 of every axis outside the
    batch axes count, one for each block of rows, so a row that a ``seq``,
    ``pipe``, ``model`` or ``spatial`` group holds on each of its processes
    counts once."""
    if process_count() == 1:
        return [item for batch in per_batch for item in batch]
    gathered = all_gather_objects(per_batch)
    if mesh is not None:
        from .mesh import BATCH_AXES, Mesh

        gathered = [proc for r, proc in enumerate(gathered) if all(
            c == 0 for a, c in Mesh(mesh.shape, r, mesh.process_count)
            .coords.items() if a not in BATCH_AXES)]
    return [item for b in range(len(per_batch)) for proc in gathered
            for item in proc[b]]


# -- over a seq group ---------------------------------------------------------


def send_recv(tensors: Sequence[torch.Tensor], dst: int, src: int,
              group) -> List[torch.Tensor]:
    """Send ``tensors`` to rank ``dst`` and receive as many of the same
    shapes and dtypes from rank ``src`` (global ranks of ``group``), in one
    batch of point-to-point operations; the received tensors land on the
    senders' device."""
    dist = _dist()
    wire = [_to_wire(t, group) for t in tensors]
    got = [torch.empty_like(w) for w in wire]
    ops = [dist.P2POp(dist.isend, w, dst, group=group) for w in wire] \
        + [dist.P2POp(dist.irecv, g, src, group=group) for g in got]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [g.to(t.device) for g, t in zip(got, tensors)]


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``out[j]`` = process ``j``'s ``x[i]`` on process ``i`` of ``group``
    (dim 0 of ``x`` is the group's size)."""
    wire = _to_wire(x, group)
    out = torch.empty_like(wire)
    _dist().all_to_all_single(out, wire, group=group)
    return out.to(x.device)


def _all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    wire = _to_wire(x, group)
    parts = [torch.empty_like(wire)
             for _ in range(_dist().get_world_size(group))]
    _dist().all_gather(parts, wire, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    wire = _to_wire(x, group)
    if wire is x:
        wire = x.clone()
    _dist().all_reduce(wire, group=group)
    return wire.to(x.device)


class _GroupGather(torch.autograd.Function):
    """Forward: the group's slices concatenated along ``dim`` in group
    order. Backward: the incoming gradients summed over the group (every
    process's loss reads the whole rows), then this process's slice: a
    reduce-scatter. ``kind`` names the exchange for :data:`comm_timer`."""

    @staticmethod
    def forward(ctx, x, dim, group, index, kind):
        ctx.dim, ctx.group, ctx.index, ctx.kind = dim, group, index, kind
        ctx.local = x.shape[dim]
        with comm_timer.measure(kind, x.device):
            return _all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        with comm_timer.measure(ctx.kind, grad.device):
            total = _all_reduce(grad, ctx.group)
        mine = total.narrow(ctx.dim, ctx.index * ctx.local, ctx.local)
        return mine.contiguous(), None, None, None, None


def gather_seq(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """The whole rows of ``x`` from its ``seq`` slices: the slices of
    every process of ``mesh``'s ``seq`` group concatenated along ``dim``,
    with a gradient (``x`` itself without a ``seq`` axis)."""
    if mesh.seq_ways == 1:
        return x
    return _GroupGather.apply(x, dim, mesh.seq_group(), mesh.seq_index,
                              "gather")


# -- over a pipe group --------------------------------------------------------


def exchange(sends: Sequence[torch.Tensor], dst: Optional[int],
             like: Sequence[torch.Tensor], src: Optional[int],
             group) -> List[torch.Tensor]:
    """One batch of point-to-point operations over ``group``: ``sends`` to
    global rank ``dst`` (nothing when None) and as many tensors as ``like``
    (their shapes and dtypes, on their device) from rank ``src`` (nothing,
    and ``[]`` back, when None). A stage hop of the GPipe schedule,
    forward (to the next stage) or backward (to the previous one)."""
    dist = _dist()
    ops, got = [], []
    if dst is not None:
        ops += [dist.P2POp(dist.isend, _to_wire(t, group), dst, group=group)
                for t in sends]
    if src is not None:
        got = [torch.empty(t.shape, dtype=t.dtype,
                           device="cpu" if _staging(t, group) else t.device)
               for t in like]
        ops += [dist.P2POp(dist.irecv, g, src, group=group) for g in got]
    if ops:
        with comm_timer.measure("pipe", (list(sends) + list(like))[0].device):
            for work in dist.batch_isend_irecv(ops):
                work.wait()
    return [g.to(t.device) for g, t in zip(got, like)]


class _MaskedSum(torch.autograd.Function):
    """Forward: ``x`` of the process where ``keep`` holds, on every process
    of ``group`` (the others give zeros). Backward: the incoming gradients
    summed over the group (every process's loss reads the result), on the
    process that kept its ``x``; zeros elsewhere."""

    @staticmethod
    def forward(ctx, x, keep, group):
        ctx.keep, ctx.group = keep, group
        with comm_timer.measure("pipe", x.device):
            return _all_reduce(x if keep else torch.zeros_like(x), group)

    @staticmethod
    def backward(ctx, grad):
        with comm_timer.measure("pipe", grad.device):
            total = _all_reduce(grad, ctx.group)
        return (total if ctx.keep else torch.zeros_like(total)), None, None


def masked_sum(x: torch.Tensor, keep: bool, group) -> torch.Tensor:
    """The ``x`` of the one process of ``group`` with ``keep`` true, on
    each of them, with a gradient (JAX's masked ``psum`` over ``pipe``)."""
    return _MaskedSum.apply(x, keep, group)


# -- over an expert group -----------------------------------------------------


class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all`; its backward is the same exchange of the
    gradients (the transpose of a permutation of dim-0 blocks)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        with comm_timer.measure("expert", x.device):
            return all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        with comm_timer.measure("expert", grad.device):
            return all_to_all(grad, ctx.group), None


def all_to_all_grad(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_to_all` over ``group`` with a gradient: ``out[j]`` is
    process ``j``'s ``x[i]`` on process ``i``."""
    return _AllToAll.apply(x, group)


# -- over a model group -------------------------------------------------------


def model_copy(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x``, which every process of ``mesh``'s ``model`` group holds, into
    this process's column-parallel products. The identity both ways: each
    process's gradient of ``x`` is the part through its own columns, and
    the parts add up over the group (the module docstring's
    convention)."""
    del mesh
    return x


class _ModelSum(torch.autograd.Function):
    """Forward: ``x`` summed over the group. Backward: the incoming
    gradients summed over the group, so each process's row-parallel piece
    gets the whole gradient of the sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        with comm_timer.measure("model", x.device):
            return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        with comm_timer.measure("model", grad.device):
            return _all_reduce(grad, ctx.group), None


def model_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The partial products of ``mesh``'s ``model`` group summed, after
    the row-parallel products, with a gradient (``x`` itself without a
    ``model`` axis)."""
    if mesh is None or mesh.model_ways == 1:
        return x
    return _ModelSum.apply(x, mesh.model_group())


# -- over a spatial group -----------------------------------------------------


def _neighbour_swap(up: Optional[torch.Tensor], down: Optional[torch.Tensor],
                    prev: Optional[int], nxt: Optional[int],
                    up_like: Optional[torch.Tensor],
                    down_like: Optional[torch.Tensor], group, device):
    """One batch of point-to-point operations: ``up`` to rank ``prev`` and
    ``down`` to rank ``nxt`` (each when that neighbour exists), and from
    them tensors shaped as ``up_like`` (from ``prev``) and ``down_like``
    (from ``nxt``). Returns ``(from prev, from next)``, None where there is
    no neighbour."""
    dist = _dist()
    ops, got = [], [None, None]
    for t, peer in ((up, prev), (down, nxt)):
        if peer is not None and t is not None and t.numel():
            ops.append(dist.P2POp(dist.isend, _to_wire(t, group), peer,
                                  group=group))
    for i, (like, peer) in enumerate(((up_like, prev), (down_like, nxt))):
        if peer is not None and like is not None and like.numel():
            got[i] = torch.empty(
                like.shape, dtype=like.dtype,
                device="cpu" if _staging(like, group) else like.device)
            ops.append(dist.P2POp(dist.irecv, got[i], peer, group=group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [None if g is None else g.to(device) for g in got]


class _Halo(torch.autograd.Function):
    """Forward: ``x`` [B, C, h, W] with ``top`` rows above it (the previous
    process's last rows, or ``value`` on the first) and ``bottom`` rows
    below (the next process's first rows, or ``value`` on the last).
    Backward: the halos' gradients go back to the processes whose rows
    they were and are added there."""

    @staticmethod
    def forward(ctx, x, top, bottom, value, group, prev, nxt):
        ctx.top, ctx.bottom, ctx.group = top, bottom, group
        ctx.prev, ctx.nxt = prev, nxt
        h = x.shape[2]
        with comm_timer.measure("halo", x.device):
            from_prev, from_next = _neighbour_swap(
                x[:, :, :bottom], x[:, :, h - top:], prev, nxt,
                x[:, :, h - top:], x[:, :, :bottom], group, x.device)
        fill = lambda n: x.new_full(x.shape[:2] + (n,) + x.shape[3:], value)
        above = fill(top) if from_prev is None else from_prev
        below = fill(bottom) if from_next is None else from_next
        return torch.cat([above, x, below], 2).contiguous(
            memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, grad):
        top, bottom = ctx.top, ctx.bottom
        h = grad.shape[2] - top - bottom
        g_top, g_bottom = grad[:, :, :top], grad[:, :, top + h:]
        mine = grad[:, :, top:top + h].clone()
        with comm_timer.measure("halo", grad.device):
            # The previous process's bottom halo was this one's first rows;
            # the next one's top halo its last rows.
            from_prev, from_next = _neighbour_swap(
                g_top, g_bottom, ctx.prev, ctx.nxt, g_bottom, g_top,
                ctx.group, grad.device)
        if from_prev is not None:
            mine[:, :, :bottom] += from_prev
        if from_next is not None:
            mine[:, :, h - top:] += from_next
        return mine, None, None, None, None, None, None


def halo_rows(x: torch.Tensor, top: int, bottom: int, mesh,
              value: float = 0.0) -> torch.Tensor:
    """This process's rows of ``x`` [B, C, h, W] (dim 2 split over
    ``mesh``'s ``spatial`` group, in group order) with ``top`` rows of its
    upper neighbour above and ``bottom`` rows of its lower one below, as a
    window of the whole image sees them: the first process's ``top`` and
    the last one's ``bottom`` rows are the image's SAME padding,
    ``value``. With a gradient."""
    ways, at = mesh.spatial_ways, mesh.spatial_index
    if max(top, bottom) > x.shape[2]:
        raise ValueError(f"a halo of {max(top, bottom)} rows needs more than "
                         f"the {x.shape[2]} rows each of the {ways} spatial "
                         f"processes holds")
    ranks = mesh.spatial_ranks
    prev = ranks[at - 1] if at > 0 else None
    nxt = ranks[at + 1] if at < ways - 1 else None
    return _Halo.apply(x, top, bottom, value, mesh.spatial_group(), prev,
                       nxt)


def gather_rows(x: torch.Tensor, mesh, dim: int = 2) -> torch.Tensor:
    """The whole images of ``x`` from the rows of every process of
    ``mesh``'s ``spatial`` group, concatenated along ``dim`` in group
    order, with a gradient whose backward is a reduce-scatter (``x``
    itself without a ``spatial`` axis)."""
    if mesh is None or mesh.spatial_ways == 1:
        return x
    return _GroupGather.apply(x, dim, mesh.spatial_group(),
                              mesh.spatial_index, "spatial")
