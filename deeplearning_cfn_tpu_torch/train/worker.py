"""Per-host worker entry point — the port of the JAX package's
``train/worker.py``::

    python -m deeplearning_cfn_tpu_torch.train.worker --preset P \\
        [--accelerator gpu|cpu] [--max-steps N] [overrides ...]

This is the process the launcher fans to every stack host (SURVEY.md §4.4) —
the analogue of the per-rank ``python train.py`` that mpirun/launch.py spawned
in the reference. It resolves its device (``--accelerator gpu``, the default,
raises without a card; ``cpu`` runs on the CPU), joins the rendezvous (a no-op
for one host; more hosts are ROADMAP A.10), then runs the experiment.

``--profiler-port`` is refused: the JAX worker starts a ``jax.profiler``
server there, and torch has no counterpart. ``train.profile_steps`` writes
the port's traces.
"""

from __future__ import annotations

import argparse
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

    device = resolve_device(args.accelerator)
    spec = initialize()  # no-op for one host; more hosts raise (A.10)

    cfg = apply_overrides(get_preset(args.preset), args.overrides)
    cfg.stack.accelerator = args.accelerator
    final = run_experiment(cfg, max_steps=args.max_steps, device=device)
    if spec.process_id == 0:
        print(f"[dlcfn-tpu] worker {spec.process_id} final metrics: "
              f"{ {k: round(v, 4) for k, v in final.items()} }")
    return 0


if __name__ == "__main__":
    sys.exit(main())
