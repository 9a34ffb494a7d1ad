"""Profiler traces of hot-loop steps — the port of ``trace_steps`` from
``deeplearning_cfn_tpu/runtime/profiling.py``.

The JAX package brackets the traced steps with ``jax.profiler.start_trace``
/ ``stop_trace`` (TensorBoard's profile plugin format). Here the bracket is
a ``torch.profiler`` session over the host and, when the run is on the
card, its CUDA activity; on exit it writes ``<host>_<pid>.<ms>.pt.trace.json``
into ``log_dir`` (``tensorboard_trace_handler``: a Chrome trace that
TensorBoard's PyTorch profiler plugin and ``chrome://tracing`` read).
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, List


@contextlib.contextmanager
def trace_steps(log_dir: str, cuda: bool = False) -> Iterator[None]:
    """Capture a host (+ device, with ``cuda``) trace of the enclosed steps
    to ``log_dir``. The caller synchronises the card before leaving the
    block, so the device side of the last traced step is in the trace.

    The trace is written only if the session started, and an error while
    writing it is swallowed when the body already raised — the body's
    exception is the one the operator needs."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(log_dir))
    prof.start()
    body_failed = False
    try:
        yield
    except BaseException:
        body_failed = True
        raise
    finally:
        try:
            prof.stop()
        except Exception:
            if not body_failed:
                raise


def trace_files(log_dir: str) -> List[str]:
    """The trace files ``trace_steps`` left in ``log_dir``, sorted."""
    if not os.path.isdir(log_dir):
        return []
    return sorted(os.path.join(log_dir, n) for n in os.listdir(log_dir)
                  if n.endswith(".pt.trace.json"))

