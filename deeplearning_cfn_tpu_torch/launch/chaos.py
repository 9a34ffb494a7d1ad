"""End-to-end crash-recovery harness: SIGKILL a real run, verify resume (the
port of the JAX package's ``launch/chaos.py``; the workers are the port's
``train.worker`` on the card, or on the CPU with ``accelerator="cpu"``).

This is the executable version of the recovery contract the launcher +
checkpoint layers promise (SURVEY.md §6): a rank dying mid-run costs at most
the steps since the last committed checkpoint, and the restarted job's
trajectory is STEP-EXACT — not "approximately resumes", but float-equal
per-step metrics against an uninterrupted control run (the resume path
replays the data stream via skip_batches and re-derives per-step RNG from
the global step, so there is no legitimate source of divergence).

Mechanics: two short real training jobs through :class:`JobLauncher` over
:class:`LocalTransport` — a baseline that runs to completion, and a chaos
job with ``DLCFN_CHAOS_KILL_AT_STEP`` armed, which makes the worker SIGKILL
itself at the planned step on attempt 0 only (runtime/faults.py:
``chaos_kill_hook_from_env``; the launcher exports ``DLCFN_ATTEMPT``). The
launcher restarts it; auto-resume restores the last committed step; the
harness then compares per-step metrics.jsonl records and checks that no
torn (uncommitted) step directory survives.

Test-only by design — nothing imports this from the production paths;
tests/test_torch_launch.py and ``chip_smoke.py`` drive it.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from ..runtime.cluster import ClusterSpec
from ..runtime.faults import CHAOS_KILL_ENV
from .launcher import JobLauncher, JobResult, LocalTransport


@dataclasses.dataclass
class ChaosReport:
    """Everything the parity assertions need, in one value."""

    parity_ok: bool
    mismatches: List[str]
    baseline_steps: List[int]
    chaos_steps: List[int]
    resumed_from: Optional[int]
    baseline_result: JobResult
    chaos_result: JobResult
    uncommitted_after: List[str]  # torn step dirs left in the chaos ckpt dir

    @property
    def ok(self) -> bool:
        return (self.parity_ok and self.chaos_result.success
                and self.chaos_result.restarts >= 1
                and self.resumed_from is not None
                and not self.uncommitted_after)


def _read_step_records(metrics_path: str,
                       keys: Sequence[str]) -> Dict[int, List[Dict]]:
    """Per-step training records (those carrying every compare key).

    The chaos run's metrics.jsonl holds records from BOTH attempts (the
    writer appends across restarts), so a step may map to several records —
    parity requires every one of them to match the baseline.
    """
    out: Dict[int, List[Dict]] = {}
    if not os.path.exists(metrics_path):
        return out
    with open(metrics_path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if "step" in rec and all(k in rec for k in keys):
                out.setdefault(int(rec["step"]), []).append(rec)
    return out


def _uncommitted_step_dirs(ckpt_dir: str) -> List[str]:
    torn = []
    for path in sorted(glob.glob(os.path.join(ckpt_dir, "step_*"))):
        if os.path.isdir(path) and \
                not os.path.exists(os.path.join(path, "COMMIT")):
            torn.append(os.path.basename(path))
    return torn


def _grep_resumed_step(log_dir: str) -> Optional[int]:
    """The resume step announced by any non-first attempt's rank-0 log."""
    for path in sorted(glob.glob(os.path.join(log_dir, "attempt*-host0.log"))):
        if "attempt0-" in os.path.basename(path):
            continue
        try:
            text = open(path, errors="replace").read()
        except OSError:
            continue
        m = re.search(r"resumed from step (\d+)", text)
        if m:
            return int(m.group(1))
    return None


def _worker_argv(preset: str, workdir: str, total_steps: int,
                 ckpt_every: int, overrides: Sequence[str],
                 accelerator: str) -> List[str]:
    return [
        sys.executable, "-m", "deeplearning_cfn_tpu_torch.train.worker",
        "--preset", preset, "--accelerator", accelerator,
        f"workdir={workdir}",
        f"train.steps={total_steps}",
        "train.log_every_steps=1",       # parity compares EVERY step
        "train.eval_every_steps=1000000",
        f"checkpoint.every_steps={ckpt_every}",
        *overrides,
    ]


def run_crash_recovery(
    workdir: str,
    preset: str = "cifar10_resnet20",
    overrides: Sequence[str] = (),
    total_steps: int = 8,
    kill_at_step: int = 4,
    ckpt_every: int = 2,
    max_restarts: int = 2,
    compare_keys: Tuple[str, ...] = ("loss",),
    extra_env: Optional[Dict[str, str]] = None,
    accelerator: str = "gpu",
) -> ChaosReport:
    """Run the kill → restart → resume scenario and compare trajectories.

    ``kill_at_step`` must be a multiple of ``ckpt_every``: the SIGKILL hook
    fires at hook-cadence boundaries (right after the checkpoint hook), so
    the kill lands in the torn window between a just-dispatched save and
    its commit — the exact failure two-phase commit exists for.

    ``compare_keys`` should hold deterministic metrics only ("loss",
    "grad_norm") — never timings (examples_per_sec), which legitimately
    differ between runs.

    ``accelerator`` is the workers' ``--accelerator``: ``gpu`` (the
    default; a worker without a card exits nonzero, it never moves to the
    CPU) or ``cpu``.
    """
    if kill_at_step % ckpt_every != 0:
        raise ValueError(
            f"kill_at_step={kill_at_step} must be a multiple of "
            f"ckpt_every={ckpt_every} (the SIGKILL hook fires on "
            f"checkpoint-cadence boundaries)")
    spec = ClusterSpec(hosts=["localhost"], process_id=0, chips_per_host=1)
    launcher = JobLauncher(transport=LocalTransport(),
                           max_restarts=max_restarts, tail_rank0=False,
                           poll_interval_s=0.1)
    base_env = dict(extra_env or {})

    base_dir = os.path.join(workdir, "baseline")
    chaos_dir = os.path.join(workdir, "chaos")
    model_sub = preset  # train/run.py: <workdir>/<preset or model.name>

    baseline_result = launcher.run(
        spec,
        _worker_argv(preset, base_dir, total_steps, ckpt_every, overrides,
                     accelerator),
        log_dir=os.path.join(workdir, "logs-baseline"),
        extra_env=base_env)
    chaos_result = launcher.run(
        spec,
        _worker_argv(preset, chaos_dir, total_steps, ckpt_every, overrides,
                     accelerator),
        log_dir=os.path.join(workdir, "logs-chaos"),
        extra_env={**base_env, CHAOS_KILL_ENV: str(kill_at_step)})

    base_recs = _read_step_records(
        os.path.join(base_dir, model_sub, "metrics.jsonl"), compare_keys)
    chaos_recs = _read_step_records(
        os.path.join(chaos_dir, model_sub, "metrics.jsonl"), compare_keys)

    mismatches: List[str] = []
    for step, recs in sorted(chaos_recs.items()):
        base = base_recs.get(step)
        if not base:
            mismatches.append(f"step {step}: no baseline record")
            continue
        for rec in recs:
            for key in compare_keys:
                if rec[key] != base[0][key]:
                    mismatches.append(
                        f"step {step} {key}: chaos {rec[key]!r} != "
                        f"baseline {base[0][key]!r}")
    if not chaos_recs:
        mismatches.append("chaos run produced no per-step records")

    return ChaosReport(
        parity_ok=not mismatches,
        mismatches=mismatches,
        baseline_steps=sorted(base_recs),
        chaos_steps=sorted(chaos_recs),
        resumed_from=_grep_resumed_step(os.path.join(workdir, "logs-chaos")),
        baseline_result=baseline_result,
        chaos_result=chaos_result,
        uncommitted_after=_uncommitted_step_dirs(
            os.path.join(chaos_dir, model_sub, "ckpt")),
    )
