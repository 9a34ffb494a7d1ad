"""Rolling checkpoint upgrades across a serving fleet — zero dropped
requests.

The runbook, mechanized (docs/SERVING.md has the operator version): for
each replica in turn —

1. **drain** — the router stops routing new work to it; its in-flight
   requests keep decoding while the REST of the fleet serves traffic.
   A drain that outlasts ``drain_deadline_steps`` fleet ticks is cut
   short by evacuating the stragglers to the other replicas (they
   restart decoding from scratch there — greedy decode is deterministic,
   so their final tokens are unchanged).
2. **swap** — :meth:`Engine.swap_variables` replaces the weights with
   the target checkpoint's (restored the way serving loads weights —
   :func:`restore_swap_variables`) and drops the prefix cache (old-weight
   encoder outputs).
3. **probe** — one tiny request runs to completion on the out-of-
   rotation replica; a replica that can't decode under the new weights
   is left BROKEN instead of being handed traffic.
4. **readmit** — back into rotation with a clean breaker.

One replica is out of rotation at a time, so fleet capacity never dips
below N-1 engines and no request is ever dropped — the end-to-end test
(tests/test_fleet.py) runs an upgrade mid-stream, with and without a
chaos kill, and asserts token parity with a single-engine baseline.

The port of the JAX package's ``fleet/rollout.py``: ``rolling_upgrade`` is
a copy; ``restore_swap_variables`` restores through the port's loader.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .router import Router


@dataclasses.dataclass
class ReplicaRolloutResult:
    replica: str
    drained: bool            # finished in-flight work within the deadline
    drain_steps: int
    evacuated: bool          # deadline hit → work moved to the fleet
    swapped: bool
    probe_ok: bool
    readmitted: bool
    skipped: str = ""        # non-empty = why the replica was skipped
    phase: str = "both"      # prefill / decode / both (disaggregation)


@dataclasses.dataclass
class RolloutReport:
    results: List[ReplicaRolloutResult]

    @property
    def upgraded(self) -> List[str]:
        return [r.replica for r in self.results if r.readmitted]

    @property
    def failed(self) -> List[str]:
        return [r.replica for r in self.results
                if not r.readmitted and not r.skipped]

    @property
    def ok(self) -> bool:
        return not self.failed

    def to_dict(self) -> Dict:
        return {
            "ok": self.ok,
            "upgraded": self.upgraded,
            "failed": self.failed,
            "replicas": [dataclasses.asdict(r) for r in self.results],
        }


def rolling_upgrade(router: Router, variables,
                    drain_deadline_steps: int = 2048,
                    probe_src=(5, 4, 3),
                    order: Optional[List[str]] = None) -> RolloutReport:
    """Upgrade every live replica in ``router`` to ``variables``, one at
    a time, while the fleet keeps serving. ``router.step()`` keeps being
    driven here during each drain, so traffic already submitted makes
    progress throughout; callers interleaving new submissions just keep
    submitting between replicas (the end-to-end test does exactly that).
    """
    results: List[ReplicaRolloutResult] = []
    if order is None:
        order = router.replica_ids()
        if getattr(router, "disaggregated", False):
            # Phase-aware order: decode replicas first, so the fleet's
            # decode path is probed under the new weights before any
            # prefill replica starts producing new-weight KV artifacts.
            # While a decode replica is out of rotation, prefill
            # replicas simply park finished streams — the router's
            # handoff retry loop delivers them once it is readmitted.
            order = sorted(order, key=lambda rid: (
                0 if getattr(router.replica(rid), "phase", "both")
                == "decode" else 1, rid))
    for rep_id in order:
        r = router.replica(rep_id)
        phase = getattr(r, "phase", "both")
        if r.crashed or r.state.value in ("down", "broken"):
            results.append(ReplicaRolloutResult(
                replica=rep_id, drained=False, drain_steps=0,
                evacuated=False, swapped=False, probe_ok=False,
                readmitted=False, skipped=f"state={r.state.value}",
                phase=phase))
            continue
        router.drain(rep_id)
        drain_steps = 0
        while r.busy and not r.crashed \
                and drain_steps < drain_deadline_steps:
            router.step()   # the whole fleet keeps decoding
            drain_steps += 1
        evacuated = False
        if r.busy and not r.crashed:
            # Deadline: hand the stragglers to the rest of the fleet and
            # let the replica's local cancellations settle.
            router.evacuate(rep_id)
            evacuated = True
            settle = 0
            while r.busy and settle < 8:
                r.step()
                settle += 1
        if r.crashed:
            # Died mid-drain (the chaos variant): the router already
            # evacuated its work; there is nothing left to upgrade.
            results.append(ReplicaRolloutResult(
                replica=rep_id, drained=False, drain_steps=drain_steps,
                evacuated=True, swapped=False, probe_ok=False,
                readmitted=False, skipped="crashed during drain",
                phase=phase))
            continue
        drained = not r.busy
        swapped = False
        probe_ok = False
        readmitted = False
        if drained:
            r.swap_variables(variables)
            swapped = True
            probe_ok = r.probe(probe_src)
            if probe_ok:
                router.readmit(rep_id)
                readmitted = True
            else:
                from .replica import ReplicaState
                r.state = ReplicaState.BROKEN
        results.append(ReplicaRolloutResult(
            replica=rep_id, drained=drained, drain_steps=drain_steps,
            evacuated=evacuated, swapped=swapped, probe_ok=probe_ok,
            readmitted=readmitted, phase=phase))
    return RolloutReport(results=results)


def restore_swap_variables(cfg, step: int = 0):
    """Restore checkpoint ``step`` (0 = latest) of ``cfg``'s experiment as
    the f32 state dict :meth:`Engine.swap_variables` takes — read from the
    same checkpoint directory and through the same converter
    :func:`~..serve.loader.load_engine` uses, so a rollout loads weights
    exactly the way the replicas originally did. Returns
    ``(state_dict, at_step)``."""
    from ..convert import committed_steps, load_flax_checkpoint, \
        params_from_flax
    from ..serve.loader import checkpoint_dir

    ckpt_dir = checkpoint_dir(cfg)
    if not committed_steps(ckpt_dir):
        raise FileNotFoundError(
            f"no committed checkpoint in {ckpt_dir} — nothing to roll "
            f"out to")
    flat, at_step = load_flax_checkpoint(ckpt_dir, step=step)
    return params_from_flax(flat), int(at_step)
