"""Process fleets of replica servers: the spawn helpers.

The port of the spawn helpers of the JAX package's ``net/bench.py``
(``_child_env`` and ``make_server_spec``), which ``fleet up --net`` builds
its :class:`~..fleet.autoscale.SupervisedSpawner` specs from. Each child is
``python -m deeplearning_cfn_tpu_torch.net.server`` on the device
``accelerator`` names, passed as its ``--accelerator`` (the JAX child pins
``JAX_PLATFORMS`` instead). The wall-clock fleet bench of that module
(``run_net_fleet_bench``, reached through ``bench --fleet --net``, with its
``spawn_process_fleet`` and ``_teardown``) is not ported yet: ROADMAP.md
queues it with the port's ``bench`` verb.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Tuple

from ..fleet.replica import ReplicaProcSpec


def _child_env() -> Dict[str, str]:
    """The replica child's extra environment: the obs switch, when the
    parent has it set (the device is an argument, not the environment)."""
    env = {}
    if os.environ.get("DLCFN_OBS_OFF"):
        env["DLCFN_OBS_OFF"] = os.environ["DLCFN_OBS_OFF"]
    return env


def make_server_spec(replica_id: str, run_dir: str, phase: str = "both",
                     slots: int = 2, src_len: int = 8,
                     max_new_tokens: int = 4, queue_depth: int = 16,
                     decode_window: int = 4, kv_block_size: int = 0,
                     seed: int = 0, warmup_src=(),
                     trace: bool = False, accelerator: str = "gpu"
                     ) -> Tuple[ReplicaProcSpec, str]:
    """Build the (spec, address) pair for one replica server child.
    Unix socket in the replica's run dir: zero port arithmetic, and a
    supervisor-restarted child reclaims the same address."""
    address = f"unix://{os.path.join(run_dir, 'replica.sock')}"
    argv = [sys.executable, "-m", "deeplearning_cfn_tpu_torch.net.server",
            "--listen", address,
            "--replica-id", replica_id,
            "--slots", str(slots),
            "--src-len", str(src_len),
            "--max-new-tokens", str(max_new_tokens),
            "--queue-depth", str(queue_depth),
            "--decode-window", str(decode_window),
            "--kv-block-size", str(kv_block_size),
            "--phase", phase,
            "--seed", str(seed),
            "--accelerator", accelerator]
    if warmup_src:
        argv += ["--warmup-src", ",".join(str(int(t)) for t in warmup_src)]
    if trace:
        argv += ["--run-dir", run_dir]
    return ReplicaProcSpec(replica_id, argv, run_dir,
                           env=_child_env()), address
