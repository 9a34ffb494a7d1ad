"""The collectives of data parallelism over the process group.

The JAX step is one program over the global batch, so its sums run over the
whole batch by construction and XLA inserts the ``psum``. The port's
processes each hold a contiguous block of rows, and these functions make the
same sums explicit, over every process of the group (the batch axes are the
only ones a multi-process mesh has, ``parallel/mesh.py``):

- :func:`global_sum`: the sum of a tensor over the processes, differentiable
  (its backward sums the incoming gradients too: every process's loss
  depends on the sum) — BatchNorm's statistics;
- :func:`global_total`: the same without a gradient — the denominators of a
  global-batch mean (token, mask and example counts);
- :func:`all_reduce_sum_`: gradients summed in place, in one flat buffer per
  dtype;
- :func:`reduce_scalars`: metrics summed in one collective (partials of a
  global mean add up to it), except those every process already holds;
- :func:`broadcast_object`, :func:`all_gather_objects` and
  :func:`gather_batches` for host values (decoded eval sets).

Every function is the identity (no collective) with one process, so the
one-device path computes exactly what it did before the mesh existed. The
backend is the group's: gloo reduces CPU and CUDA tensors (a CUDA tensor
staged through the host), NCCL CUDA tensors.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

from .mesh import process_count, process_index


def _dist():
    import torch.distributed as dist

    return dist


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        _dist().all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        # d(Σ_s loss_s)/dx_r = Σ_s dloss_s/dy, y = Σ_r x_r on every process.
        out = grad.contiguous().clone()
        _dist().all_reduce(out)
        return out


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the processes, with a gradient (``x`` itself with
    one process)."""
    if process_count() == 1:
        return x
    return _GlobalSum.apply(x)


def global_total(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the processes, without a gradient: the count a
    global-batch mean divides by (``x`` itself with one process)."""
    if process_count() == 1:
        return x
    out = x.detach().clone()
    _dist().all_reduce(out)
    return out


def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum ``tensors`` over the processes in place: one collective per
    dtype, over a flat buffer of all of them (no-op with one process)."""
    if process_count() == 1 or not tensors:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        _dist().all_reduce(flat)
        offset = 0
        for t in group:
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
