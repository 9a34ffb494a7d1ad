"""Multi-host job launcher: fan-out, log aggregation, failure watch, resume.

A copy of the JAX package's ``launch/launcher.py`` (it imports nothing of
JAX) over the port's ``metrics.jsonl``, ``obs`` and ``runtime`` modules,
plus :func:`run_local`, the job of N processes on this machine that
``cli train --processes`` runs.

Replaces the reference's `mpirun -np N -hostfile ...` / `launch.py --launcher
ssh` hot path (SURVEY.md §4.2). Transports abstract "start this argv on that
host": SSH for real TPU-VM slices (one initial fan-out — no per-step SSH
traffic, unlike the reference's always-on mesh), local subprocesses for
simulation and tests. The watch loop implements the contract SURVEY.md §6
specifies for failure detection: any host death kills the job and restarts
it from the last checkpoint (training code auto-resumes via
CheckpointConfig.resume), up to ``max_restarts`` times.
"""

from __future__ import annotations

import dataclasses
import os
import shlex
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, IO, List, Optional, Sequence

from ..metrics.jsonl import MetricsWriter
from ..obs.sinks import JsonlSink
from ..obs.trace import get_tracer, span
from ..runtime.cluster import ClusterSpec, cluster_env, local_spec
from ..runtime.watchdog import HANG_EXIT_CODE


class Transport:
    """Starts a process on a host; returns the local Popen handle."""

    def popen(self, host: str, argv: Sequence[str], env: Dict[str, str],
              stdout: IO, cwd: Optional[str] = None) -> subprocess.Popen:
        raise NotImplementedError


class LocalTransport(Transport):
    """Run every 'host' as a local subprocess — the simulation/test backend
    (all ranks on one machine, the env contract still per-rank)."""

    def popen(self, host, argv, env, stdout, cwd=None):
        full_env = {**os.environ, **env}
        return subprocess.Popen(
            list(argv), env=full_env, stdout=stdout,
            stderr=subprocess.STDOUT, cwd=cwd,
            start_new_session=True,
        )


class SshTransport(Transport):
    """Run on a real slice host over SSH (BatchMode: keys must already be in
    place — TPU-VM creation installs them, unlike the reference which had to
    build its own key mesh during bootstrap)."""

    def __init__(self, ssh_args: Sequence[str] = ()):
        self.ssh_args = list(ssh_args)

    def popen(self, host, argv, env, stdout, cwd=None):
        exports = " ".join(
            f"export {k}={shlex.quote(v)};" for k, v in env.items()
        )
        cd = f"cd {shlex.quote(cwd)}; " if cwd else ""
        remote = f"{exports} {cd}{' '.join(shlex.quote(a) for a in argv)}"
        # -tt allocates a remote tty so killing the local ssh client tears
        # the remote command down too (HUP on tty loss) — without it,
        # _kill_all would orphan remote workers that keep holding the chips.
        cmd = ["ssh", "-tt", "-o", "BatchMode=yes",
               "-o", "StrictHostKeyChecking=accept-new",
               *self.ssh_args, host, remote]
        return subprocess.Popen(cmd, stdout=stdout,
                                stderr=subprocess.STDOUT,
                                stdin=subprocess.DEVNULL,
                                start_new_session=True)


def classify_attempt(codes: List[int]) -> str:
    """``ok`` | ``hang`` | ``crash`` for one attempt's exit codes. A hang is
    the watchdog's deliberate exit (runtime/watchdog.py, code 89) — a wedged
    collective, not a fault in the program — and operators triage the two
    very differently, so the distinction is recorded per attempt."""
    if all(c == 0 for c in codes):
        return "ok"
    if any(c == HANG_EXIT_CODE for c in codes):
        return "hang"
    return "crash"


@dataclasses.dataclass
class JobResult:
    success: bool
    restarts: int
    exit_codes: List[int]
    log_dir: str
    # One entry per attempt, "ok" | "hang" | "crash" (classify_attempt).
    attempt_outcomes: List[str] = dataclasses.field(default_factory=list)


class _HostProc:
    def __init__(self, index: int, host: str, proc: subprocess.Popen,
                 log_path: str, log_file: IO):
        self.index = index
        self.host = host
        self.proc = proc
        self.log_path = log_path
        self.log_file = log_file


class JobHandle:
    """One started attempt, observable without blocking.

    :meth:`JobLauncher.run` owns its own watch loop; supervisors that
    babysit MANY jobs at once (fleet/replica.py runs one per serve
    replica) can't afford to block in it — they :meth:`poll` every handle
    each tick and decide restarts themselves. The handle only observes;
    restart policy stays with the caller.
    """

    def __init__(self, launcher: "JobLauncher", spec: ClusterSpec,
                 log_dir: str, attempt: int, procs: List[_HostProc]):
        self._launcher = launcher
        self.spec = spec
        self.log_dir = log_dir
        self.attempt = attempt
        self._procs = procs
        self._closed = False

    @property
    def hosts(self) -> List[str]:
        return [hp.host for hp in self._procs]

    @property
    def log_paths(self) -> List[str]:
        return [hp.log_path for hp in self._procs]

    def poll(self) -> List[Optional[int]]:
        """Per-host exit codes right now; None = still running."""
        return [hp.proc.poll() for hp in self._procs]

    def alive(self) -> List[bool]:
        """Per-host liveness (True = the process is still running)."""
        return [c is None for c in self.poll()]

    def done(self) -> bool:
        return all(c is not None for c in self.poll())

    def outcome(self) -> Optional[str]:
        """``ok`` | ``hang`` | ``crash`` once every host has exited, else
        None. Same classification :meth:`JobLauncher.run` records — a
        supervisor triages a watchdog hang-exit differently from a real
        crash (restart helps the latter, a wedged collective wants the
        whole gang re-fanned)."""
        codes = self.poll()
        if any(c is None for c in codes):
            return None
        return classify_attempt(codes)

    def wait(self, timeout_s: Optional[float] = None
             ) -> List[Optional[int]]:
        """Block until every host exits (or the timeout); returns the
        codes as :meth:`poll` would — None entries mean timed out."""
        deadline = None if timeout_s is None else time.time() + timeout_s
        while not self.done():
            if deadline is not None and time.time() >= deadline:
                break
            time.sleep(self._launcher.poll_interval_s)
        return self.poll()

    def terminate(self) -> None:
        """Kill every still-running host process (SIGTERM, then SIGKILL
        after a grace period) and close the log files."""
        self._launcher._kill_all(self._procs)
        self.close()

    def close(self) -> None:
        """Close per-host log files once the attempt is over."""
        if self._closed:
            return
        self._closed = True
        for hp in self._procs:
            try:
                hp.log_file.close()
            except OSError:
                pass


class JobLauncher:
    """Fans one argv to all hosts and babysits the job.

    Parameters
    ----------
    transport: how to reach hosts (SshTransport on real slices).
    max_restarts: full-job restarts after a host failure before giving up.
        Restarted training processes resume from the latest checkpoint —
        the auto-resume contract the reference left manual.
    tail_rank0: stream host 0's log lines to our stdout (the reference user
        watched mpirun's merged output; per-host logs stay on disk).
    tail_stream: where they stream instead of stdout.
    """

    def __init__(
        self,
        transport: Optional[Transport] = None,
        max_restarts: int = 2,
        poll_interval_s: float = 0.2,
        tail_rank0: bool = True,
        tail_stream: Optional[IO] = None,
    ):
        self.transport = transport or LocalTransport()
        self.max_restarts = max_restarts
        self.poll_interval_s = poll_interval_s
        self.tail_rank0 = tail_rank0
        self.tail_stream = tail_stream
        self._handle: Optional[JobHandle] = None

    # -- single attempt -----------------------------------------------------

    def _start_all(self, spec: ClusterSpec, argv: Sequence[str],
                   log_dir: str, attempt: int,
                   extra_env: Dict[str, str], cwd: Optional[str]
                   ) -> List[_HostProc]:
        procs = []
        for i, host in enumerate(spec.hosts):
            # Workers learn which attempt they are (0-based; the chaos
            # harness keys fault arming off it). extra_env second, so an
            # explicit caller value still wins.
            env = {**cluster_env(spec, i),
                   "DLCFN_ATTEMPT": str(attempt), **extra_env}
            log_path = os.path.join(log_dir,
                                    f"attempt{attempt}-host{i}.log")
            log_file = open(log_path, "ab", buffering=0)
            proc = self.transport.popen(host, argv, env, log_file, cwd=cwd)
            procs.append(_HostProc(i, host, proc, log_path, log_file))
        return procs

    def _kill_all(self, procs: List[_HostProc]) -> None:
        for hp in procs:
            if hp.proc.poll() is None:
                try:
                    # Kill the whole session so grandchildren die too.
                    os.killpg(hp.proc.pid, signal.SIGTERM)
                except (ProcessLookupError, PermissionError, OSError):
                    hp.proc.terminate()
        deadline = time.time() + 10
        for hp in procs:
            try:
                hp.proc.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(hp.proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError, OSError):
                    hp.proc.kill()
                hp.proc.wait()

    def _tail(self, path: str, stop: threading.Event) -> None:
        out = self.tail_stream or sys.stdout
        with open(path, "rb") as fh:
            while not stop.is_set():
                line = fh.readline()
                if line:
                    out.write(line.decode("utf-8", errors="replace"))
                    out.flush()
                else:
                    time.sleep(0.1)
            for line in fh:  # drain
                out.write(line.decode("utf-8", errors="replace"))
            out.flush()

    def _run_attempt(self, spec, argv, log_dir, attempt, extra_env, cwd,
                     on_failure: Optional[Callable[[int, str], None]]
                     ) -> List[int]:
        procs = self._start_all(spec, argv, log_dir, attempt, extra_env, cwd)
        stop = threading.Event()
        tailer = None
        if self.tail_rank0:
            tailer = threading.Thread(
                target=self._tail, args=(procs[0].log_path, stop),
                daemon=True)
            tailer.start()
        try:
            while True:
                codes = [hp.proc.poll() for hp in procs]
                failed = [hp for hp, c in zip(procs, codes)
                          if c is not None and c != 0]
                if failed:
                    # Failure detected: kill the survivors (a partial world
                    # would hang in collectives forever — the reference's
                    # Horovod jobs did exactly that on node loss).
                    if on_failure:
                        for hp in failed:
                            on_failure(hp.index, hp.host)
                    self._kill_all(procs)
                    return [hp.proc.returncode if hp.proc.returncode
                            is not None else -1 for hp in procs]
                if all(c == 0 for c in codes):
                    return [0] * len(procs)
                time.sleep(self.poll_interval_s)
        finally:
            stop.set()
            if tailer is not None:
                tailer.join(timeout=5)
            for hp in procs:
                hp.log_file.close()

    # -- public -------------------------------------------------------------

    def start(
        self,
        spec: ClusterSpec,
        argv: Sequence[str],
        log_dir: str,
        attempt: int = 0,
        extra_env: Optional[Dict[str, str]] = None,
        cwd: Optional[str] = None,
    ) -> JobHandle:
        """Start one attempt without blocking; returns a :class:`JobHandle`
        the caller polls. No restart policy, no log tailing, no attempt
        events — the non-blocking primitive a multi-job supervisor builds
        its own loop from (:meth:`run` keeps the blocking single-job
        contract unchanged)."""
        os.makedirs(log_dir, exist_ok=True)
        procs = self._start_all(spec, argv, log_dir, attempt,
                                extra_env or {}, cwd)
        handle = JobHandle(self, spec, log_dir, attempt, procs)
        self._handle = handle
        return handle

    def poll(self) -> Optional[List[Optional[int]]]:
        """Per-host exit codes of the most recently started attempt
        (None entries = still running); None if :meth:`start` was never
        called."""
        if self._handle is None:
            return None
        return self._handle.poll()

    def run(
        self,
        spec: ClusterSpec,
        argv: Sequence[str],
        log_dir: str,
        extra_env: Optional[Dict[str, str]] = None,
        cwd: Optional[str] = None,
        on_failure: Optional[Callable[[int, str], None]] = None,
    ) -> JobResult:
        """Run ``argv`` on every host until success or restart budget spent."""
        os.makedirs(log_dir, exist_ok=True)
        extra_env = extra_env or {}
        attempt = 0
        outcomes: List[str] = []
        # Attempt lifecycle events land in log_dir/launch.jsonl (the obs
        # report's per-attempt-outcomes section reads them). all_processes:
        # the launcher is host-side orchestration — no jax, no rank.
        events = MetricsWriter(os.path.join(log_dir, "launch.jsonl"),
                               also_stdout=False, all_processes=True)
        # launch.attempt spans land in the same launch.jsonl as the
        # attempt events (the trace exporter draws attempts as timeline
        # bars from the spans and outcome markers from the events).
        # Installed only for this run, then removed — the launcher may
        # share a process with other tracer users.
        span_sink = JsonlSink(events)
        get_tracer().add_sink(span_sink)
        try:
            while True:
                with span("launch.attempt", attempt=attempt,
                          hosts=len(spec.hosts)) as sp:
                    codes = self._run_attempt(spec, argv, log_dir, attempt,
                                              extra_env, cwd, on_failure)
                    outcome = classify_attempt(codes)
                    sp.annotate(outcome=outcome)
                outcomes.append(outcome)
                events.write({"event": "launch_attempt", "attempt": attempt,
                              "outcome": outcome, "exit_codes": codes,
                              "success": outcome == "ok"})
                if outcome == "ok":
                    return JobResult(True, attempt, codes, log_dir,
                                     attempt_outcomes=outcomes)
                print(f"[dlcfn-tpu] attempt {attempt} failed ({outcome}): "
                      f"exit codes {codes}"
                      + (" — watchdog hang exit, wedged collective suspected"
                         if outcome == "hang" else ""))
                if attempt >= self.max_restarts:
                    return JobResult(False, attempt, codes, log_dir,
                                     attempt_outcomes=outcomes)
                attempt += 1
                time.sleep(min(2.0 ** attempt, 10.0))  # backoff before retry
        finally:
            get_tracer().remove_sink(span_sink)
            events.close()


def run_local(argv: Sequence[str], processes: int, cards: int, log_dir: str,
              max_restarts: int = 0,
              on_failure: Optional[Callable[[int, str], None]] = None,
              tail_stream: Optional[IO] = None) -> JobResult:
    """``argv`` as ``processes`` processes of one job on this machine
    (:func:`~..runtime.cluster.local_spec` over its ``cards``, the
    hostfile ``<log_dir>/hosts``), through :class:`JobLauncher` over
    :class:`LocalTransport`: the dry-run stack's path without a stack.
    Process 0's log streams to stdout (or ``tail_stream``); every log is
    under ``log_dir``."""
    spec = local_spec(processes, cards, os.path.join(log_dir, "hosts"))
    launcher = JobLauncher(transport=LocalTransport(),
                           max_restarts=max_restarts,
                           tail_stream=tail_stream)
    return launcher.run(spec, argv, log_dir, on_failure=on_failure)
