"""Hang watchdog: turn a stuck training process into a dead one (a copy of
the JAX package's ``runtime/watchdog.py``, which imports nothing of JAX).

The launcher's failure detection (launch/launcher.py) watches for host
*death* — but the failure mode this image actually exhibits is a *hang*:
the accelerator stops completing work and the process blocks
forever inside a device sync, alive but silent. The reference stack had
the same blind spot (a wedged NCCL collective hung Horovod jobs until a
human killed them). The fix is mechanical: a watchdog thread that
hard-exits the process when the training loop stops making heartbeats,
which converts the hang into exactly the failure the launcher already
handles — kill, restart, auto-resume from the last committed checkpoint.

``os._exit`` (not ``sys.exit``) is deliberate: the main thread is blocked
in native code and will never run Python finalizers; a hung CUDA context
cannot be shut down cleanly from another thread anyway.
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time
from typing import Callable, Optional

HANG_EXIT_CODE = 89  # distinctive, so launcher logs show "hang", not "crash"


class StepWatchdog:
    """Exit the process if ``beat()`` isn't called for ``timeout_s``.

    Beats belong at host-sync points (metric logging, eval, checkpoint) —
    the places the training loop provably made device-side progress. The
    async-dispatch steps between syncs don't beat, so ``timeout_s`` must
    comfortably exceed the wall time of one full logging interval plus
    compile time; first-compile can dominate, hence ``first_beat_grace_s``.
    """

    def __init__(self, timeout_s: float, first_beat_grace_s: float = 0.0,
                 on_hang: Optional[Callable[[float], None]] = None,
                 poll_interval_s: float = 1.0):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be positive, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self._deadline = time.monotonic() + self.timeout_s + \
            max(first_beat_grace_s, 0.0)
        self._on_hang = on_hang or self._default_on_hang
        self._poll_s = poll_interval_s
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="dlcfn-step-watchdog")
        self._thread.start()

    def beat(self) -> None:
        """Record progress; resets the hang deadline."""
        self._deadline = time.monotonic() + self.timeout_s

    def stop(self) -> None:
        self._stopped.set()

    def _watch(self) -> None:
        while not self._stopped.wait(self._poll_s):
            overdue = time.monotonic() - self._deadline
            if overdue > 0:
                self._on_hang(self.timeout_s + overdue)
                return

    def _default_on_hang(self, stalled_s: float) -> None:
        print(f"[dlcfn-tpu] WATCHDOG: no training progress for "
              f"{stalled_s:.0f}s (limit {self.timeout_s:.0f}s) — the "
              f"accelerator backend is presumed hung. Dumping stacks and "
              f"exiting {HANG_EXIT_CODE} so the launcher can restart from "
              f"the last committed checkpoint.", file=sys.stderr, flush=True)
        try:
            faulthandler.dump_traceback(file=sys.stderr)
        except Exception:
            pass
        os._exit(HANG_EXIT_CODE)
