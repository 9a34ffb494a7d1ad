"""Stack state store — the CloudFormation stack table, locally.

A copy of the JAX package's ``provision/stack.py``, which imports
nothing of JAX (the port never imports that package).

The reference's source of truth for "what clusters exist and are they ready"
was the CFN control plane (`aws cloudformation describe-stacks`). The rebuild
keeps that lifecycle state in a JSON file per stack under a state dir
(default ``~/.dlcfn_tpu/stacks``), written atomically so a killed CLI never
leaves a corrupt record.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import tempfile
import time
from typing import Dict, List, Optional


class StackStatus(str, enum.Enum):
    """Mirrors the CFN stack states the reference flow surfaced to users."""

    CREATE_IN_PROGRESS = "CREATE_IN_PROGRESS"
    CREATE_COMPLETE = "CREATE_COMPLETE"
    CREATE_FAILED = "CREATE_FAILED"
    DELETE_IN_PROGRESS = "DELETE_IN_PROGRESS"
    DELETED = "DELETED"


@dataclasses.dataclass
class HostRecord:
    """One slice host (the reference's per-EC2-instance record)."""

    name: str
    internal_ip: str = ""
    external_ip: str = ""
    state: str = "UNKNOWN"  # CREATING | READY | UNHEALTHY | DELETED

    def to_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class StackState:
    name: str
    slice_type: str
    zone: str
    project: str = ""
    status: StackStatus = StackStatus.CREATE_IN_PROGRESS
    hosts: List[HostRecord] = dataclasses.field(default_factory=list)
    created_at: float = 0.0
    provisioner: str = "dryrun"
    message: str = ""
    hostfile: str = ""
    # The full StackConfig this stack was created from (asdict), so
    # lifecycle operations that recreate the stack (resize) can carry
    # every knob over — runtime_version, preemptible, timeouts — not just
    # the fields this record mirrors. Empty for pre-upgrade records.
    create_config: Dict = dataclasses.field(default_factory=dict)

    @property
    def ready(self) -> bool:
        return self.status == StackStatus.CREATE_COMPLETE

    def host_addresses(self) -> List[str]:
        return [h.internal_ip or h.name for h in self.hosts]

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["status"] = self.status.value
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "StackState":
        d = dict(d)
        d["status"] = StackStatus(d["status"])
        d["hosts"] = [HostRecord(**h) for h in d.get("hosts", [])]
        return cls(**d)


DEFAULT_STATE_DIR = os.path.expanduser("~/.dlcfn_tpu/stacks")


class StackStore:
    """Atomic JSON persistence for stack records."""

    def __init__(self, state_dir: str = ""):
        self.state_dir = state_dir or DEFAULT_STATE_DIR
        os.makedirs(self.state_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        if not name or "/" in name or name.startswith("."):
            raise ValueError(f"invalid stack name {name!r}")
        return os.path.join(self.state_dir, f"{name}.json")

    def save(self, state: StackState) -> None:
        if not state.created_at:
            state.created_at = time.time()
        path = self._path(state.name)
        fd, tmp = tempfile.mkstemp(dir=self.state_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(state.to_dict(), fh, indent=2)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def load(self, name: str) -> StackState:
        path = self._path(name)
        if not os.path.exists(path):
            raise KeyError(f"no such stack {name!r} (state dir {self.state_dir})")
        with open(path) as fh:
            return StackState.from_dict(json.load(fh))

    def load_or_none(self, name: str) -> Optional[StackState]:
        try:
            return self.load(name)
        except KeyError:
            return None

    def delete(self, name: str) -> None:
        path = self._path(name)
        if os.path.exists(path):
            os.unlink(path)

    def list(self) -> List[StackState]:
        out = []
        for fn in sorted(os.listdir(self.state_dir)):
            if fn.endswith(".json"):
                with open(os.path.join(self.state_dir, fn)) as fh:
                    out.append(StackState.from_dict(json.load(fh)))
        return out
