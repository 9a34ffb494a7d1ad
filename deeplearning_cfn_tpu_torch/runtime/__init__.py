"""Runtime layer for the port: device selection, the cluster env contract
and rendezvous (one host until ROADMAP A.10), fault injection, the hang
watchdog and profiler traces.

Env-var contract (the JAX package's ``runtime/__init__.py``, unchanged):

===========================  ==================================================
``DLCFN_WORKERS_PATH``       hostfile path — one host address per line
``DLCFN_WORKERS_COUNT``      number of hosts (processes) in the job
``DLCFN_WORKER_CHIP_COUNT``  accelerator chips per host
``DLCFN_COORDINATOR``        ``host:port`` of process 0 (rendezvous address)
``DLCFN_PROCESS_ID``         this host's rank in [0, WORKERS_COUNT)
===========================  ==================================================

Not here: the JAX package's ``StepTimer`` (its one user is the collectives
benchmark, ROADMAP A.10) and ``start_profiler_server`` (torch has no
profiler server; ``train.profile_steps`` writes the port's traces).
"""

from .cluster import (  # noqa: F401
    ClusterSpec,
    cluster_env,
    current_cluster,
    initialize,
    read_hostfile,
    write_hostfile,
)
from .platform import resolve_device  # noqa: F401
from .profiling import trace_steps  # noqa: F401

__all__ = [
    "ClusterSpec",
    "cluster_env",
    "current_cluster",
    "initialize",
    "read_hostfile",
    "resolve_device",
    "trace_steps",
    "write_hostfile",
]
