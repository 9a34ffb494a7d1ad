"""Cluster contract + rendezvous bootstrap (the port of the JAX package's
``runtime/cluster.py``).

Replaces the reference's bootstrap flow (SURVEY.md §4.1): master polls the
AutoScalingGroup, collects worker private IPs, writes the hostfile, exports
``DEEPLEARNING_WORKERS_*``, and every node cfn-signals a WaitCondition. Here
the same information travels as a :class:`ClusterSpec` — written by the
provisioner/launcher, read by every worker process. The env contract and the
hostfile I/O are the JAX package's, unchanged. The rendezvous
(:func:`initialize`) is ``torch.distributed.init_process_group`` at process
0's ``coordinator``: NCCL when every process of this machine has a card of
its own, gloo otherwise (the CPU, or processes that share a card — NCCL
refuses two ranks on one GPU). The choice follows the topology alone and is
printed; a failed init raises and is never retried on another backend.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Dict, List, Optional, Tuple

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


def free_local_port() -> int:
    """A free TCP port on this machine, for the rendezvous of a job whose
    hosts are all local processes (a dry-run stack)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def choose_backend(spec: ClusterSpec, accelerator: str = "gpu",
                   cards: int = 0) -> Tuple[str, str, str]:
    """``(backend, device, why)`` of this process from the topology alone.

    The local rank is the number of earlier hosts of the spec with this
    process's host name (a dry-run stack lists one address many times). On
    the CPU (``accelerator="cpu"``) the backend is gloo; on the card it is
    NCCL with ``cuda:<local rank>`` when this machine's ``cards`` cover its
    processes, and gloo with ``cuda:<local rank % cards>`` when processes
    share a card."""
    host = spec.hosts[spec.process_id]
    local_rank = spec.hosts[:spec.process_id].count(host)
    local_procs = spec.hosts.count(host)
    if accelerator == "cpu":
        return "gloo", "cpu", "the CPU"
    if cards < 1:
        raise RuntimeError(
            "a CUDA card was asked for but this machine has none — pass "
            "--accelerator cpu to run on the CPU")
    if cards >= local_procs:
        return ("nccl", f"cuda:{local_rank}",
                f"{local_procs} process(es) on {cards} card(s): one each")
    return ("gloo", f"cuda:{local_rank % cards}",
            f"{local_procs} processes share {cards} card(s); NCCL takes "
            f"one rank per card")


_initialized = False


def initialize(spec: Optional[ClusterSpec] = None, timeout_s: int = 300,
               accelerator: str = "gpu") -> ClusterSpec:
    """Join the job — the rebuild's ``hvd.init()`` / MPI_Init.

    Single-host (no contract in the environment, or a one-host contract) is
    a no-op returning the spec. A multi-host spec joins the process group
    once (later calls return the spec): ``init_process_group`` at
    ``tcp://<coordinator>`` with the spec's world size and rank and a
    ``timeout_s`` timeout (a peer that never joins, or dies in a collective,
    raises here or there instead of hanging), on the backend and card of
    :func:`choose_backend`, which the process's first line names."""
    global _initialized
    spec = spec if spec is not None else current_cluster()
    if spec is None:
        return ClusterSpec(hosts=[socket.gethostname()], process_id=0)
    spec.validate()
    if not spec.is_multi_host or _initialized:
        return spec
    import torch
    import torch.distributed as dist

    cards = torch.cuda.device_count() if accelerator != "cpu" else 0
    backend, device, why = choose_backend(spec, accelerator, cards)
    print(f"[dlcfn-tpu] process {spec.process_id}/{spec.num_processes}: "
          f"backend {backend}, device {device} ({why})", flush=True)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(
        backend, init_method=f"tcp://{spec.coordinator}",
        world_size=spec.num_processes, rank=spec.process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    _initialized = True
    return spec
