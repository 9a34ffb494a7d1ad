"""``cli bench --preset`` over several processes of one host (the port's
``bench.py`` and the ``bench`` verb's ``--processes``) against the JAX
package's ``run_bench`` and ``run_obs_overhead_smoke`` over two of the
tests' fake devices, on the CPU.

- ``cli bench --accelerator cpu --processes 2`` on ``cifar10_resnet20`` at
  ``--global-batch 8`` and 2 steps, with ``--with-input``, then with
  ``--obs-smoke``, each as one process that launches two gloo processes
  (each run beside the JAX side's): one record each, printed once (by
  process 0), with JAX's keys and JAX's ``metric``, ``unit``,
  ``global_batch``, ``steps``, ``step_window``, ``n_chips`` (2), ``mesh``,
  ``mfu``, ``measured`` and ``batch_underfilled``; a positive ``value``.
  Both processes end the run with the same ``value``: the step time is
  the slowest process's, reduced over them. Tolerance: equal.
- a child killed at its first step fails the verb (rc 1), names the
  dead child's log, and no record is printed.
"""

import importlib
import json
import os
import re
import signal
import subprocess
import sys
import tempfile

import jax
import pytest

from deeplearning_cfn_tpu import bench as jax_bench
from deeplearning_cfn_tpu.config import MeshConfig
from deeplearning_cfn_tpu.parallel import build_mesh

cli = importlib.import_module("deeplearning_cfn_tpu_torch.cli.main")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = ["--preset", "cifar10_resnet20", "--global-batch", "8", "--steps",
         "2", "--accelerator", "cpu", "--processes", "2"]
JAX_KW = dict(preset="cifar10_resnet20", steps=2, global_batch=8)
EQUAL = ("metric", "unit", "global_batch", "steps", "step_window",
         "n_chips", "mesh", "mfu", "measured", "batch_underfilled")
OBS_EQUAL = ("metric", "unit", "steps", "global_batch", "preset",
             "measured", "trace_valid")


def _env(tmp):
    return dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(tmp),
                PYTHONPATH=os.pathsep.join(
                    [REPO, os.environ.get("PYTHONPATH", "")]))


def _start(flags, tmp):
    return subprocess.Popen(
        [sys.executable, "-m", "deeplearning_cfn_tpu_torch.cli", "bench",
         *BENCH, *flags], cwd=str(tmp), env=_env(tmp),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    records = [json.loads(ln) for ln in out.splitlines()]
    log_dir = re.search(r"logs in (\S+)\)", err).group(1)
    done, printed = [], []
    for r in range(2):
        with open(os.path.join(log_dir, f"attempt0-host{r}.log")) as fh:
            lines = fh.readlines()
        done += [ln for ln in lines if "[bench-stage]" in ln
                 and " done " in ln]
        printed.append(sum(ln.startswith("{") for ln in lines))
    # Process 0 printed the record; process 1 printed none.
    assert printed == [1, 0], printed
    return records, done


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two spawns, each beside the JAX record it is held to."""
    tmp = tmp_path_factory.mktemp("bench_cards")
    mesh = build_mesh(MeshConfig(data=2), jax.devices()[:2])
    proc = _start(["--with-input"], tmp)
    want = jax_bench.run_bench(include_input=True, mesh=mesh, **JAX_KW)
    bench = _finish(proc)
    proc = _start(["--obs-smoke"], tmp)
    want_obs = jax_bench.run_obs_overhead_smoke(mesh=mesh, **JAX_KW)
    obs = _finish(proc)
    return dict(bench=(bench, want), obs=(obs, want_obs))


def test_bench_over_two_processes_equals_jax_over_two_devices(runs):
    (records, done), want = runs["bench"]
    assert len(records) == 1
    got = records[0]
    assert set(got) == set(want)
    for key in EQUAL:
        assert got[key] == want[key], key
    assert got["n_chips"] == 2 and got["mesh"]["data"] == 2
    assert got["value"] > 0 and got["value_with_input"] > 0
    # Each process printed its own end: the same value, from the slowest
    # process's step time.
    values = {ln.rsplit("value=", 1)[1].strip() for ln in done}
    assert len(done) == 2 and values == {str(got["value"])}


def test_obs_smoke_over_two_processes_equals_jax(runs):
    (records, done), want = runs["obs"]
    assert len(records) == 1
    got = records[0]
    assert set(got) == set(want)
    for key in OBS_EQUAL:
        assert got[key] == want[key], key
    assert got["trace_valid"] is True and len(done) == 2


# Process 1 of the job dies (SIGKILL) at its first step's host read.
_DIES = """
import os, runpy, signal, sys
if os.environ.get("DLCFN_PROCESS_ID") == "1":
    from deeplearning_cfn_tpu_torch import bench
    bench._sync = lambda metrics: os.kill(os.getpid(), signal.SIGKILL)
sys.argv[0] = "cli"
runpy.run_module("deeplearning_cfn_tpu_torch.cli", run_name="__main__")
"""


def test_a_dead_child_fails_the_verb(tmp_path, monkeypatch, capsys):
    from deeplearning_cfn_tpu_torch import launch

    run_local = launch.run_local

    def dying(argv, *args, **kwargs):
        # [python, -m, <cli module>, bench, ...] -> [python, -c, _DIES,
        # bench, ...]
        return run_local([argv[0], "-c", _DIES, *argv[3:]], *args,
                         **kwargs)

    monkeypatch.setattr(launch, "run_local", dying)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    for key, value in _env(tmp_path).items():
        monkeypatch.setenv(key, value)
    assert cli.main(["bench", *BENCH]) == 1
    out, err = capsys.readouterr()
    assert not [ln for ln in out.splitlines() if ln.startswith("{")]
    failed = [ln for ln in err.splitlines() if " FAILED " in ln]
    assert any(f"exit code {-signal.SIGKILL};" in ln
               and ln.rstrip(")").endswith("attempt0-host1.log")
               for ln in failed), err[-4000:]
