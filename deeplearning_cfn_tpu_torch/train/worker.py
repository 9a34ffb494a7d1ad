"""Per-host worker entry point — the port of the JAX package's
``train/worker.py``::

    python -m deeplearning_cfn_tpu_torch.train.worker --preset P \\
        [--accelerator gpu|cpu] [--max-steps N] [overrides ...]

This is the process the launcher fans to every stack host (SURVEY.md §4.4) —
the analogue of the per-rank ``python train.py`` that mpirun/launch.py spawned
in the reference. It resolves its device (``--accelerator gpu``, the default,
raises without a card; ``cpu`` runs on the CPU), joins the rendezvous (a no-op
for one host; with more it joins the process group, on this host's card,
with the hang timeout ``train.hang_timeout_s`` as the group's timeout when
it is set), then runs the experiment. At the end every process prints its
flash kernel launches over its training steps after the first (their
counts per step do not depend on the batch), its step time p50 over the
logged steps after the first and, on a card, its peak device
memory.

``--profiler-port`` is refused: the JAX worker starts a ``jax.profiler``
server there, and torch has no counterpart. ``train.profile_steps`` writes
the port's traces.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from ..config import apply_overrides
from ..presets import get_preset
from ..runtime import initialize, resolve_device
from .run import run_experiment


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="dlcfn-tpu-worker",
        description="per-host training worker (launched by `train --stack`)",
    )
    parser.add_argument("--preset", required=True)
    parser.add_argument("--accelerator", default="gpu",
                        choices=["gpu", "cpu"])
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--profiler-port", type=int, default=0,
                        help="not supported by the port (torch has no "
                             "profiler server); use train.profile_steps")
    parser.add_argument("overrides", nargs="*",
                        help="config overrides, e.g. train.global_batch=256")
    args = parser.parse_args(argv)
    if args.profiler_port:
        raise ValueError(
            "--profiler-port has no torch counterpart (the JAX worker starts "
            "jax.profiler.start_server there); set train.profile_steps=N for "
            "a Chrome trace of N steps under <workdir>/<preset>/profile")

    resolve_device(args.accelerator)  # no card: raise before joining
    cfg = apply_overrides(get_preset(args.preset), args.overrides)
    cfg.stack.accelerator = args.accelerator
    timeout = cfg.train.hang_timeout_s if cfg.train.hang_timeout_s > 0 \
        else 300
    # No-op for one host; otherwise the rendezvous, which also picks this
    # process's card.
    spec = initialize(timeout_s=int(timeout), accelerator=args.accelerator)
    device = resolve_device(args.accelerator)
    launches = _LaunchTally()
    final = run_experiment(cfg, max_steps=args.max_steps, device=device,
                           hooks=(launches.hook,))
    print(f"[dlcfn-tpu] worker {spec.process_id} {launches.line()}",
          flush=True)
    if launches.step_s:
        print(f"[dlcfn-tpu] worker {spec.process_id} step time p50 "
              f"{sorted(launches.step_s)[len(launches.step_s) // 2]} s over "
              f"{len(launches.step_s)} logged steps", flush=True)
    if device.type == "cuda":
        import torch

        print(f"[dlcfn-tpu] worker {spec.process_id} peak device memory "
              f"{torch.cuda.max_memory_allocated(device)} bytes", flush=True)
    if spec.process_id == 0:
        print(f"[dlcfn-tpu] worker {spec.process_id} final metrics: "
              f"{ {k: round(v, 4) for k, v in final.items()} }")
    return 0


class _LaunchTally:
    """The flash kernels' launch counters at the first and the last step
    boundary of this run (a step hook), so that the count covers training
    steps only: not the first step's, nor any eval's."""

    def __init__(self):
        self.first = self.last = None
        self.step_s = []  # each logged step's time after the first

    @staticmethod
    def _now():
        from ..ops import attention as attn

        return {"fwd": attn.flash_attention_forward.launches,
                "dkdv": attn.flash_attn_bwd_dkdv.launches,
                "dq": attn.flash_attn_bwd_dq.launches}

    def hook(self, step, state, record) -> None:
        now = (step, self._now())
        if self.first is not None and record and "step_time_s" in record \
                and record.get("step") == step:
            self.step_s.append(record["step_time_s"])
        self.first = self.first or now
        self.last = now

    def line(self) -> str:
        if self.first is None or self.last[0] == self.first[0]:
            return "flash kernel launches: no steps after the first"
        steps = self.last[0] - self.first[0]
        got = {k: self.last[1][k] - self.first[1][k] for k in self.last[1]}
        return (f"flash kernel launches over steps {self.first[0] + 1}-"
                f"{self.last[0]}: {json.dumps(got)} ({steps} steps)")


if __name__ == "__main__":
    sys.exit(main())
