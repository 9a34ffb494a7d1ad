"""Device selection, shared by every entry point of the port.

Takes the place of the JAX package's ``force_cpu_platform``: instead of
switching a process-wide backend, each entry point resolves an explicit
``torch.device`` and builds its model and tensors there. The card is the
default; the CPU is used only when the caller asks for it (the tests do).
"""

from __future__ import annotations

from typing import Union

import torch

_ALIASES = {"gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}


def resolve_device(accelerator: Union[str, torch.device] = "gpu"
                   ) -> torch.device:
    """``"gpu"``/``"cuda"`` -> the current CUDA device, ``"cpu"`` -> the CPU.

    Asking for the card on a machine without one raises: the port never
    falls back to the CPU on its own.
    """
    if isinstance(accelerator, torch.device):
        kind = accelerator.type
    else:
        kind = _ALIASES.get(str(accelerator or "gpu").lower())
        if kind is None:
            raise ValueError(
                f"unknown accelerator {accelerator!r} (expected gpu or cpu)")
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"unsupported device type {kind!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA card was asked for but torch.cuda.is_available() is "
            "False — pass --accelerator cpu / device='cpu' to run on the CPU")
    if isinstance(accelerator, torch.device) and accelerator.index is not None:
        return accelerator
    return torch.device("cuda", torch.cuda.current_device())
