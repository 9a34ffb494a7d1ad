"""Provisioners: create/delete/poll TPU pod slices.

A copy of the JAX package's ``provision/provisioner.py``, which
imports nothing of JAX (the port never imports that package).

Reference flow replaced (SURVEY.md §4.1): `aws cloudformation create-stack`
→ ASG boots workers → master polls until all InService → WaitCondition gates
CREATE_COMPLETE. Here: one queued-resource/node create call → poll host
states until all READY (the readiness gate) → write the hostfile and mark the
stack complete. `DryRunProvisioner` stands in for the GCP control plane so
the whole lifecycle is testable offline — including staged readiness and
injected failures (the fixture strategy SURVEY.md §5.5 calls for).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import time
from typing import Callable, List, Optional

from ..config import StackConfig
from ..runtime.cluster import write_hostfile
from .stack import HostRecord, StackState, StackStatus, StackStore
from .topology import slice_topology


class ProvisionError(RuntimeError):
    pass


class Provisioner:
    """Lifecycle interface every backend implements."""

    name = "base"

    def create(self, cfg: StackConfig) -> StackState:
        raise NotImplementedError

    def refresh(self, state: StackState) -> StackState:
        """Poll the control plane and update host states in-place."""
        raise NotImplementedError

    def delete(self, state: StackState) -> None:
        raise NotImplementedError


class DryRunProvisioner(Provisioner):
    """Simulated control plane for tests and offline development.

    Hosts progress CREATING → READY over a configurable number of refresh
    polls; a fixture can mark hosts that never become ready (partial-ready
    slice) or die after N polls (preemption), which is how the provisioner's
    failure paths get exercised without hardware (SURVEY.md §8 risk 4).
    """

    name = "dryrun"

    def __init__(self, ready_after_polls: int = 1,
                 fail_hosts: Optional[List[int]] = None,
                 preempt_after: Optional[int] = None):
        self.ready_after_polls = ready_after_polls
        self.fail_hosts = set(fail_hosts or [])
        self.preempt_after = preempt_after
        self._polls = 0

    def create(self, cfg: StackConfig) -> StackState:
        topo = slice_topology(cfg.slice_type)
        # Loopback addresses so a dry-run stack is actually drivable: the
        # launcher simulates hosts as local processes, and a multi-host
        # job's jax.distributed rendezvous must bind/connect for real.
        hosts = [
            HostRecord(
                name=f"{cfg.name}-worker-{i}",
                internal_ip="127.0.0.1",
                state="CREATING",
            )
            for i in range(topo.num_hosts)
        ]
        return StackState(
            name=cfg.name, slice_type=cfg.slice_type, zone=cfg.zone,
            project=cfg.project or "dryrun-project",
            status=StackStatus.CREATE_IN_PROGRESS, hosts=hosts,
            provisioner=self.name,
        )

    def refresh(self, state: StackState) -> StackState:
        self._polls += 1
        for i, host in enumerate(state.hosts):
            if i in self.fail_hosts:
                host.state = "UNHEALTHY"
            elif self.preempt_after is not None and \
                    self._polls > self.preempt_after:
                host.state = "DELETED"
            elif self._polls >= self.ready_after_polls:
                host.state = "READY"
        return state

    def delete(self, state: StackState) -> None:
        for host in state.hosts:
            host.state = "DELETED"


class GcpProvisioner(Provisioner):
    """Real backend driving the GCP TPU API through the ``gcloud`` CLI.

    Uses subprocess `gcloud compute tpus tpu-vm ...` rather than a client
    library so there is no SDK dependency to vendor; every call degrades to a
    clear ProvisionError when gcloud/credentials/network are absent. (The
    reference leaned on the aws CLI + cfn-bootstrap the same way.)
    """

    name = "gcp"

    def __init__(self, gcloud: str = "gcloud"):
        self.gcloud = gcloud
        if shutil.which(gcloud) is None:
            raise ProvisionError(
                f"{gcloud!r} not found on PATH — install the Google Cloud CLI "
                "or use provisioner='dryrun'"
            )

    def _run(self, *args: str) -> str:
        cmd = [self.gcloud, *args, "--format=json"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise ProvisionError(
                f"gcloud failed ({' '.join(cmd)}): {proc.stderr.strip()}"
            )
        return proc.stdout

    def create(self, cfg: StackConfig) -> StackState:
        topo = slice_topology(cfg.slice_type)
        args = [
            "compute", "tpus", "tpu-vm", "create", cfg.name,
            f"--zone={cfg.zone}",
            f"--accelerator-type={topo.accelerator_type}",
            f"--version={cfg.runtime_version}",
            "--async",
        ]
        if cfg.project:
            args.append(f"--project={cfg.project}")
        if cfg.preemptible:
            args.append("--preemptible")
        self._run(*args)
        return StackState(
            name=cfg.name, slice_type=cfg.slice_type, zone=cfg.zone,
            project=cfg.project, status=StackStatus.CREATE_IN_PROGRESS,
            hosts=[HostRecord(name=f"{cfg.name}-worker-{i}", state="CREATING")
                   for i in range(topo.num_hosts)],
            provisioner=self.name,
        )

    def refresh(self, state: StackState) -> StackState:
        out = self._run("compute", "tpus", "tpu-vm", "describe", state.name,
                        f"--zone={state.zone}",
                        *( [f"--project={state.project}"] if state.project
                           else [] ))
        desc = json.loads(out)
        tpu_state = desc.get("state", "UNKNOWN")
        endpoints = desc.get("networkEndpoints", [])
        hosts: List[HostRecord] = []
        for i, ep in enumerate(endpoints):
            hosts.append(HostRecord(
                name=f"{state.name}-worker-{i}",
                internal_ip=ep.get("ipAddress", ""),
                external_ip=ep.get("accessConfig", {}).get("externalIp", ""),
                state="READY" if tpu_state == "READY" else tpu_state,
            ))
        if hosts:
            state.hosts = hosts
        else:
            for h in state.hosts:
                h.state = tpu_state
        return state

    def delete(self, state: StackState) -> None:
        self._run("compute", "tpus", "tpu-vm", "delete", state.name,
                  f"--zone={state.zone}", "--quiet",
                  *( [f"--project={state.project}"] if state.project
                     else [] ))


def get_provisioner(cfg: StackConfig) -> Provisioner:
    """'auto' prefers the real backend when gcloud exists, else dry-run —
    so the same CLI flow works on a laptop, in CI, and on a GCP VM."""
    kind = cfg.provisioner
    if kind == "auto":
        try:
            return GcpProvisioner()
        except ProvisionError:
            return DryRunProvisioner()
    if kind == "gcp":
        return GcpProvisioner()
    if kind == "dryrun":
        return DryRunProvisioner()
    raise ValueError(f"unknown provisioner {kind!r}")


def create_stack(
    cfg: StackConfig,
    provisioner: Optional[Provisioner] = None,
    store: Optional[StackStore] = None,
    poll_interval_s: float = 5.0,
    on_status: Optional[Callable[[StackState], None]] = None,
    _sleep: Callable[[float], None] = time.sleep,
) -> StackState:
    """The full `stack create` flow, readiness gate included.

    Polls until every host is READY or ``cfg.create_timeout_s`` elapses — the
    WaitCondition-timeout equivalent: a partial cluster is a failed stack,
    never silently handed to the launcher. On success writes the hostfile
    next to the state record so `train` can pick it up.
    """
    prov = provisioner or get_provisioner(cfg)
    store = store or StackStore(cfg.state_dir)
    if store.load_or_none(cfg.name) is not None:
        raise ProvisionError(
            f"stack {cfg.name!r} already exists; delete it first"
        )
    state = prov.create(cfg)
    state.create_config = dataclasses.asdict(cfg)
    store.save(state)

    deadline = time.time() + cfg.create_timeout_s
    while True:
        state = prov.refresh(state)
        store.save(state)
        if on_status:
            on_status(state)
        states = {h.state for h in state.hosts}
        if states == {"READY"}:
            break
        # Terminal states fail fast: the dry-run backend's invented ones
        # plus the real GCP TPU node states that cannot progress to READY.
        if states & {"UNHEALTHY", "DELETED", "FAILED", "PREEMPTED",
                     "TERMINATED", "STOPPED", "STOPPING", "DELETING",
                     "SUSPENDED"}:
            state.status = StackStatus.CREATE_FAILED
            state.message = f"host states: {sorted(states)}"
            store.save(state)
            raise ProvisionError(
                f"stack {cfg.name!r} failed to assemble: {state.message}"
            )
        if time.time() >= deadline:
            state.status = StackStatus.CREATE_FAILED
            state.message = f"timed out after {cfg.create_timeout_s}s"
            store.save(state)
            raise ProvisionError(
                f"stack {cfg.name!r} creation timed out "
                f"({cfg.create_timeout_s}s) — host states {sorted(states)}"
            )
        _sleep(poll_interval_s)

    hostfile = os.path.join(store.state_dir, f"{cfg.name}.hosts")
    write_hostfile(hostfile, state.host_addresses())
    state.hostfile = hostfile
    state.status = StackStatus.CREATE_COMPLETE
    store.save(state)
    return state


def resize_stack(
    name: str,
    new_slice_type: str,
    store: Optional[StackStore] = None,
    provisioner: Optional[Provisioner] = None,
    poll_interval_s: float = 5.0,
    on_status: Optional[Callable[[StackState], None]] = None,
    _sleep: Callable[[float], None] = time.sleep,
) -> StackState:
    """Scale a stack to a new topology: delete + recreate under the same
    name (SURVEY §4.5 — the reference resized by updating the ASG's worker
    count; TPU slices are fixed shapes, so resize is teardown + new slice).
    Training state survives through checkpoints, not the cluster: relaunch
    `train --stack <name>` afterwards and the run auto-resumes from the
    last committed checkpoint, resharded onto the new topology by the
    cross-topology restore (ckpt/checkpoint.py).

    Every creation knob of the old stack (runtime version, preemptible,
    timeouts, zone/project/provisioner) carries over from the recorded
    create-time config; only the slice type changes. If the new slice
    fails its readiness gate the old stack is already gone — the state
    record then holds CREATE_FAILED, same as any failed create (no silent
    half-cluster)."""
    store = store or StackStore()
    old = store.load(name)  # KeyError if the stack doesn't exist
    if old.slice_type == new_slice_type and old.ready:
        # Only a HEALTHY same-type stack makes resize a no-op; a
        # CREATE_FAILED record at the target type must stay retryable
        # with the same command (the natural recovery after a failed
        # resize's create phase).
        raise ProvisionError(
            f"stack {name!r} is already a ready {new_slice_type}")
    # Rebuild from the recorded create-time config; fall back to the
    # mirrored StackState fields for records from before create_config
    # existed.
    base = dict(old.create_config) if old.create_config else {
        "name": name, "slice_type": old.slice_type, "zone": old.zone,
        "project": old.project, "provisioner": old.provisioner,
    }
    base.update(name=name, slice_type=new_slice_type,
                state_dir=store.state_dir)
    known = {f.name for f in dataclasses.fields(StackConfig)}
    cfg = StackConfig(**{k: v for k, v in base.items() if k in known})
    delete_stack(name, store=store, provisioner=provisioner)
    return create_stack(cfg, provisioner=provisioner, store=store,
                        poll_interval_s=poll_interval_s,
                        on_status=on_status, _sleep=_sleep)


def delete_stack(
    name: str,
    store: Optional[StackStore] = None,
    provisioner: Optional[Provisioner] = None,
) -> None:
    store = store or StackStore()
    state = store.load(name)
    if provisioner is None:
        if state.provisioner == "gcp":
            provisioner = GcpProvisioner()
        else:
            provisioner = DryRunProvisioner()
    state.status = StackStatus.DELETE_IN_PROGRESS
    store.save(state)
    provisioner.delete(state)
    if state.hostfile and os.path.exists(state.hostfile):
        os.unlink(state.hostfile)
    store.delete(name)
