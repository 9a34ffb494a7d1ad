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
  with its inverse as the backward: MoE's dispatch and combine).

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
    """Seconds (and calls) of the sequence, pipe and expert collectives by
    kind (``"ring"``, ``"ulysses"``, ``"gather"``, ``"pipe"``,
    ``"expert"``), counted while ``enabled``:
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


def gather_batches(per_batch: List[List[Any]]) -> List[Any]:
    """Items collected batch by batch on every process, in the global
    batch's order: batch 0's items of process 0, then of process 1, ...,
    then batch 1's (``per_batch`` flattened with one process)."""
    if process_count() == 1:
        return [item for batch in per_batch for item in batch]
    gathered = all_gather_objects(per_batch)
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


class _SeqGather(torch.autograd.Function):
    """Forward: the group's slices concatenated along ``dim`` in group
    order. Backward: the incoming gradients summed over the group (every
    process's loss reads the whole rows), then this process's slice."""

    @staticmethod
    def forward(ctx, x, dim, group, index):
        ctx.dim, ctx.group, ctx.index = dim, group, index
        ctx.local = x.shape[dim]
        with comm_timer.measure("gather", x.device):
            return _all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        with comm_timer.measure("gather", grad.device):
            total = _all_reduce(grad, ctx.group)
        mine = total.narrow(ctx.dim, ctx.index * ctx.local, ctx.local)
        return mine.contiguous(), None, None, None


def gather_seq(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """The whole rows of ``x`` from its ``seq`` slices: the slices of
    every process of ``mesh``'s ``seq`` group concatenated along ``dim``,
    with a gradient (``x`` itself without a ``seq`` axis)."""
    if mesh.seq_ways == 1:
        return x
    return _SeqGather.apply(x, dim, mesh.seq_group(), mesh.seq_index)


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
