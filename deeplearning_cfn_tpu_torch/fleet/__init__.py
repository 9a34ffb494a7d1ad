"""fleet/ — multi-replica serving: router, supervision, rolling upgrades.
The port of the JAX package's ``fleet/``.

N engine replicas behind an in-process router (the control plane), each
replica either an in-process Engine (:class:`.replica.EngineReplica`) or a
supervised child process (:class:`.replica.ReplicaSupervisor` over the
launcher's Transport abstraction — each with its own obs run dir).

- :mod:`.replica` — replica state machine, health snapshots,
  deterministic crash injection, process supervision with hang-vs-crash
  classification and bounded restart.
- :mod:`.router` — pluggable routing policies (round-robin,
  least-loaded, prefix affinity), retry-after-aware shedding, per-replica
  circuit breaking, crash failover with zero dropped requests, and the
  disaggregated prefill → decode KV handoff.
- :mod:`.rollout` — rolling checkpoint upgrades: drain → swap → probe →
  readmit, one replica at a time, fleet keeps serving throughout.
- :mod:`.autoscale` — closed-loop membership control: SignalBus
  pressure through hysteresis + cooldown into phase-aware scale-up
  (spawn + register) and zero-drop drain-based scale-down.
- :mod:`.degrade` — brownout graceful degradation: the same SignalBus
  pressure stepped through audited quality levels (disable speculation
  → cap decode windows → shed batch-class admission) before any
  latency-class traffic is rejected, with hysteretic recovery.

``router``, ``replica``, ``autoscale`` and ``degrade`` are copies of the
JAX package's modules (they import nothing of JAX); ``rollout`` restores
its checkpoint through the port's loader; :mod:`.bench` is the
in-process fleet bench (``bench --fleet``).

CLI surface: ``python -m deeplearning_cfn_tpu_torch.cli fleet up | route |
rollout | status``.
"""

from .autoscale import (  # noqa: F401
    AutoscalePolicy,
    Autoscaler,
    SupervisedSpawner,
    pool_signals,
)
from .degrade import (  # noqa: F401
    DegradeController,
    DegradePolicy,
)
from .replica import (  # noqa: F401
    EngineReplica,
    ReplicaCrashed,
    ReplicaProcSpec,
    ReplicaState,
    ReplicaSupervisor,
)
from .router import (  # noqa: F401
    POLICIES,
    FleetOverloadError,
    LeastLoadedPolicy,
    NoReplicasError,
    Router,
    RoundRobinPolicy,
    RoutingPolicy,
)
from .rollout import (  # noqa: F401
    ReplicaRolloutResult,
    RolloutReport,
    restore_swap_variables,
    rolling_upgrade,
)

__all__ = [
    "AutoscalePolicy",
    "Autoscaler",
    "DegradeController",
    "DegradePolicy",
    "EngineReplica",
    "FleetOverloadError",
    "LeastLoadedPolicy",
    "NoReplicasError",
    "POLICIES",
    "ReplicaCrashed",
    "ReplicaProcSpec",
    "ReplicaRolloutResult",
    "ReplicaState",
    "ReplicaSupervisor",
    "RolloutReport",
    "Router",
    "RoundRobinPolicy",
    "RoutingPolicy",
    "SupervisedSpawner",
    "pool_signals",
    "restore_swap_variables",
    "rolling_upgrade",
]
