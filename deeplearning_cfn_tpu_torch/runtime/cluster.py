"""Cluster contract + rendezvous bootstrap (the port of the JAX package's
``runtime/cluster.py``).

Replaces the reference's bootstrap flow (SURVEY.md §4.1): master polls the
AutoScalingGroup, collects worker private IPs, writes the hostfile, exports
``DEEPLEARNING_WORKERS_*``, and every node cfn-signals a WaitCondition. Here
the same information travels as a :class:`ClusterSpec` — written by the
provisioner/launcher, read by every worker process. The env contract and the
hostfile I/O are the JAX package's, unchanged. The rendezvous is one host
only in this slice: :func:`initialize` is a no-op for one host and refuses
more, because there the rendezvous becomes ``torch.distributed``'s
``init_process_group`` (ROADMAP A.10).
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Dict, List, Optional

# Env-var names. DLCFN_* mirror the reference's DEEPLEARNING_* contract.
ENV_WORKERS_PATH = "DLCFN_WORKERS_PATH"
ENV_WORKERS_COUNT = "DLCFN_WORKERS_COUNT"
ENV_CHIP_COUNT = "DLCFN_WORKER_CHIP_COUNT"
ENV_COORDINATOR = "DLCFN_COORDINATOR"
ENV_PROCESS_ID = "DLCFN_PROCESS_ID"

DEFAULT_COORDINATOR_PORT = 8476


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Everything a worker process needs to join the job.

    The reference's equivalent state was spread across the hostfile, three
    env vars, and MPI's own rank assignment; this is that state in one value.
    """

    hosts: List[str]
    process_id: int = 0
    chips_per_host: int = 4
    coordinator_port: int = DEFAULT_COORDINATOR_PORT
    hostfile: str = ""

    @property
    def num_processes(self) -> int:
        return len(self.hosts)

    @property
    def coordinator(self) -> str:
        return f"{self.hosts[0]}:{self.coordinator_port}"

    @property
    def is_multi_host(self) -> bool:
        return self.num_processes > 1

    def validate(self) -> None:
        if not self.hosts:
            raise ValueError("cluster has no hosts")
        if not 0 <= self.process_id < self.num_processes:
            raise ValueError(
                f"process_id {self.process_id} out of range "
                f"[0, {self.num_processes})"
            )


def write_hostfile(path: str, hosts: List[str]) -> str:
    """Write the hostfile — same one-address-per-line format the reference's
    master generated at ``$DEEPLEARNING_WORKERS_PATH`` for MPI/launch.py."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("\n".join(hosts) + "\n")
    return path


def read_hostfile(path: str) -> List[str]:
    with open(path) as fh:
        return [line.strip() for line in fh if line.strip()
                and not line.startswith("#")]


def cluster_env(spec: ClusterSpec, process_id: int) -> Dict[str, str]:
    """The env block the launcher exports into each worker process — the
    rebuild's version of the reference's UserData `export DEEPLEARNING_*`."""
    env = {
        ENV_WORKERS_COUNT: str(spec.num_processes),
        ENV_CHIP_COUNT: str(spec.chips_per_host),
        ENV_COORDINATOR: spec.coordinator,
        ENV_PROCESS_ID: str(process_id),
    }
    if spec.hostfile:
        env[ENV_WORKERS_PATH] = spec.hostfile
    return env


def current_cluster(environ: Optional[Dict[str, str]] = None
                    ) -> Optional[ClusterSpec]:
    """Reconstruct the ClusterSpec from this process's environment.

    Returns None when the contract is absent (single-host / interactive run —
    the same degenerate case as running a reference example without the
    stack)."""
    env = os.environ if environ is None else environ
    if ENV_COORDINATOR not in env and ENV_WORKERS_PATH not in env:
        return None
    if ENV_WORKERS_PATH in env and os.path.exists(env[ENV_WORKERS_PATH]):
        hosts = read_hostfile(env[ENV_WORKERS_PATH])
    elif ENV_COORDINATOR not in env:
        raise FileNotFoundError(
            f"{ENV_WORKERS_PATH}={env[ENV_WORKERS_PATH]!r} does not exist "
            f"and {ENV_COORDINATOR} is unset — stale environment from a "
            "deleted stack? Unset the DLCFN_* vars or recreate the stack."
        )
    else:
        # Coordinator-only contract: synthesize host list of unknown peers.
        coord_host = env[ENV_COORDINATOR].rsplit(":", 1)[0]
        count = int(env.get(ENV_WORKERS_COUNT, "1"))
        hosts = [coord_host] + [f"worker-{i}" for i in range(1, count)]
    port = DEFAULT_COORDINATOR_PORT
    if ENV_COORDINATOR in env and ":" in env[ENV_COORDINATOR]:
        port = int(env[ENV_COORDINATOR].rsplit(":", 1)[1])
    spec = ClusterSpec(
        hosts=hosts,
        process_id=int(env.get(ENV_PROCESS_ID, "0")),
        chips_per_host=int(env.get(ENV_CHIP_COUNT, "4")),
        coordinator_port=port,
        hostfile=env.get(ENV_WORKERS_PATH, ""),
    )
    spec.validate()
    return spec


def initialize(spec: Optional[ClusterSpec] = None, timeout_s: int = 300
               ) -> ClusterSpec:
    """Join the job — the rebuild's `hvd.init()` / MPI_Init.

    Single-host (no contract in the environment, or a one-host contract) is
    a no-op returning the spec. A multi-host spec raises: the port's
    rendezvous (``torch.distributed.init_process_group`` against process 0's
    ``coordinator``, with the world size and rank of the spec) is ROADMAP
    A.10. ``timeout_s`` is kept for the JAX package's call signature.
    """
    spec = spec if spec is not None else current_cluster()
    if spec is None:
        return ClusterSpec(hosts=[socket.gethostname()], process_id=0)
    spec.validate()
    if spec.is_multi_host:
        raise NotImplementedError(
            f"a {spec.num_processes}-host job needs the multi-host "
            f"rendezvous (torch.distributed.init_process_group at "
            f"{spec.coordinator}), which is not ported yet (ROADMAP A.10)")
    return spec
