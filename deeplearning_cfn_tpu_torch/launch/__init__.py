"""Job-launch layer (L2) — one command on every slice host (the port of the
JAX package's ``launch/``).

The reference launched work through an SSH mesh: MXNet `tools/launch.py
--launcher ssh -H $DEEPLEARNING_WORKERS_PATH` spawned scheduler/server/worker
processes, and `mpirun`/`horovodrun` fanned one process per GPU (SURVEY.md
§4.2–4.3). The TPU shape is simpler — ONE process per host owns all local
chips — so this layer is: fan the same command to every host with the
per-rank env contract, aggregate logs, watch for death, and auto-restart the
whole job from the last checkpoint when a host fails (the failure-detection
subsystem of SURVEY.md §6, which the reference lacked).
"""

from .launcher import (
    JobHandle,
    JobLauncher,
    JobResult,
    LocalTransport,
    SshTransport,
    Transport,
    classify_attempt,
)

__all__ = [
    "JobHandle",
    "JobLauncher",
    "JobResult",
    "LocalTransport",
    "SshTransport",
    "Transport",
    "classify_attempt",
]
