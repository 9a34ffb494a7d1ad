"""The port's operator verbs (deeplearning_cfn_tpu_torch.cli) against the JAX
package's ``dlcfn-tpu``, on the CPU.

- ``presets``, ``config``, ``metrics`` and the ``obs`` verbs print what the
  JAX CLI prints, with its exit codes;
- the dry-run ``stack`` lifecycle and ``resize`` leave state files equal to
  the JAX CLI's; ``slice_topology`` equals JAX's for every generation and
  size (and raises the same errors);
- ``doctor --skip-backend`` passes and ``doctor`` without a card exits 1
  with FAIL; ``info`` names torch and the one-device layout;
- ``data prepare-text``, ``prepare-wikipedia`` and ``prepare-wmt`` on
  ``tests/data/wmt_sliver.*`` write the JAX converters' files byte for byte;
- ``train --stack`` on a one-host dry-run stack with ``--accelerator cpu``
  and a tiny NMT finishes through the launcher (its log at
  ``attempt0-host0.log``, spans in its ``metrics.jsonl``); on a two-host
  stack a mesh the processes cannot carry (``mesh.model=2``) returns 1
  before any launch, naming ROADMAP A.10 (the two-host run itself:
  ``tests/test_torch_dist_cli.py``).
"""

import json
import os

import pytest
import torch

from deeplearning_cfn_tpu.cli.main import main as jax_main
from deeplearning_cfn_tpu.provision import topology as j_topology
from deeplearning_cfn_tpu_torch.cli.main import main
from deeplearning_cfn_tpu_torch.provision import topology as t_topology

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "obs")
SLIVER = os.path.join(REPO, "tests", "data", "wmt_sliver")
TINY_NMT = ["model.kwargs.hidden_size=32", "model.kwargs.num_layers=1",
            "model.kwargs.num_heads=2", "model.kwargs.mlp_dim=64",
            "data.vocab_size=64", "data.seq_len=16", "train.global_batch=8",
            "data.num_train_examples=64", "data.num_eval_examples=16",
            "eval.max_decode_len=8", "schedule.warmup_steps=2",
            "schedule.base_lr=0.01", "checkpoint.async_write=false",
            "train.log_every_steps=1"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One worker's share of the cores (torch would start a thread per core
    in every pytest-xdist worker)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _both(capsys, argv_of, root=None):
    """Run the JAX CLI, then the port's; (rc, stdout, stderr) of each, with
    each run's own directory (``<root>/<tag>``, where ``argv_of(tag)``
    writes) replaced by a placeholder."""
    out = []
    for tag, fn in (("jax", jax_main), ("port", main)):
        rc = fn(argv_of(tag))
        cap = capsys.readouterr()
        own = str(root / tag) if root is not None else None
        out.append((rc, *(t.replace(own, "RUN") if own else t
                          for t in (cap.out, cap.err))))
    return out


# -- introspection and run reports -------------------------------------------


VERB_CASES = {
    "presets": ["presets"],
    "config": ["config", "--preset", "transformer_nmt_wmt",
               "train.global_batch=64", "model.kwargs.num_layers=2"],
    "metrics": ["metrics", os.path.join(FIXTURES, "train")],
    "metrics_missing": ["metrics", os.path.join(FIXTURES, "nope")],
    "obs_summarize": ["obs", "summarize", os.path.join(FIXTURES, "train")],
    "obs_summarize_json": ["obs", "summarize", "--json", "--since-step", "2",
                           os.path.join(FIXTURES, "serve", "metrics.jsonl")],
    "obs_summarize_fleet": ["obs", "summarize", "--fleet",
                            os.path.join(FIXTURES, "fleet")],
    "obs_check_clean": ["obs", "check", os.path.join(FIXTURES, "train"),
                        "--rules", os.path.join(FIXTURES, "rules.json")],
    "obs_check_breach": ["obs", "check", "--json",
                         os.path.join(FIXTURES, "breach", "metrics.jsonl"),
                         "--rules", os.path.join(FIXTURES, "rules.json")],
    "obs_diff": ["obs", "diff", os.path.join(FIXTURES, "train"),
                 os.path.join(FIXTURES, "breach"), "--tolerance", "0.05"],
    "obs_tail_once": ["obs", "tail", "--once",
                      os.path.join(FIXTURES, "serve")],
    "obs_tail_fleet_once": ["obs", "tail", "--once", "--fleet",
                            os.path.join(FIXTURES, "fleet")],
}


@pytest.mark.parametrize("case", sorted(VERB_CASES))
def test_verb_prints_what_jax_prints(case, capsys):
    jax_run, port_run = _both(capsys, lambda tag: VERB_CASES[case])
    assert port_run == jax_run
    if case != "metrics_missing":
        assert port_run[1]


def test_obs_export_writes_the_jax_trace(tmp_path, capsys):
    for tag in ("jax", "port"):
        (tmp_path / tag).mkdir()
    jax_run, port_run = _both(capsys, lambda tag: [
        "obs", "export", os.path.join(FIXTURES, "train"), "-o",
        str(tmp_path / tag / "trace.json")], tmp_path)
    assert port_run == jax_run and port_run[0] == 0
    assert (tmp_path / "port" / "trace.json").read_bytes() == \
        (tmp_path / "jax" / "trace.json").read_bytes()


def test_info_names_torch_and_the_one_device_layout(capsys):
    assert main(["info"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"torch {torch.__version__}, CUDA ")
    if not torch.cuda.is_available():
        assert out[1:] == ["devices: 0 total, 0 local, process 0/1",
                           "one device: cpu"]


def test_doctor_skip_backend_passes_and_without_a_card_fails(capsys,
                                                              monkeypatch):
    assert main(["doctor", "--skip-backend"]) == 0
    out = capsys.readouterr().out
    for check in ("presets: ok", "native-loader: ok",
                  "backend: ok — skipped on request", "all checks passed"):
        assert check in out, out
    assert "device-exec" not in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["doctor"]) == 1
    out = capsys.readouterr().out
    assert "torch-import: ok" in out
    assert "backend: FAIL" in out and "CHECKS FAILED" in out


# -- the dry-run control plane -----------------------------------------------


def _state_files(state_dir):
    """Every stack state file, with the creation time and the directory
    taken out."""
    out = {}
    for name in sorted(os.listdir(state_dir)):
        path = os.path.join(state_dir, name)
        with open(path) as fh:
            text = fh.read().replace(str(state_dir), "STATE")
        if name.endswith(".json"):
            rec = json.loads(text)
            assert rec.pop("created_at") > 0
            out[name] = rec
        else:
            out[name] = text
    return out


def test_stack_lifecycle_and_resize_leave_jax_state_files(tmp_path, capsys):
    steps = [
        ["stack", "create", "--name", "s1", "--slice-type", "v5p-8",
         "--provisioner", "dryrun"],
        ["stack", "create", "--name", "s2", "--slice-type", "v5e-16",
         "--provisioner", "dryrun", "--zone", "us-west4-a",
         "--preemptible"],
        ["stack", "status", "s1"],
        ["stack", "list"],
        ["stack", "resize", "s1", "--slice", "v5p-16"],
        ["stack", "resize", "s1", "--slice", "v5p-16"],  # no-op: an error
        ["stack", "resize", "ghost", "--slice", "v5p-16"],
        ["stack", "delete", "s2"],
        ["stack", "status", "s2"],
        ["stack", "delete", "s2"],
        ["stack", "list"],
    ]
    files = {}
    for tag, fn in (("jax", jax_main), ("port", main)):
        state = tmp_path / tag
        runs = []
        for argv in steps:
            rc = fn(argv + ["--state-dir", str(state)])
            cap = capsys.readouterr()
            text = (cap.out + cap.err).replace(str(state), "STATE")
            if argv[1] == "status" and rc == 0:
                rec = json.loads(cap.out)
                assert rec.pop("created_at") > 0
                text = json.dumps(rec).replace(str(state), "STATE")
            runs.append((rc, text))
        files[tag] = (runs, _state_files(state))
    assert files["port"] == files["jax"]
    runs, state = files["port"]
    assert [rc for rc, _ in runs] == [0, 0, 0, 0, 0, 1, 1, 0, 1, 1, 0]
    assert state["s1.json"]["slice_type"] == "v5p-16"
    assert len(state["s1.json"]["hosts"]) == 4


def _topologies(module):
    out = {}
    for gen in ("v2", "v3", "v4", "v5p", "v5e", "v5litepod", "v6e"):
        for chips in (1, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096, 8960,
                      9000):
            name = f"{gen}-{chips}"
            try:
                topo = module.slice_topology(name)
                out[name] = (topo.slice_type, topo.generation,
                             topo.num_chips, topo.chips_per_host,
                             topo.num_hosts, topo.ici_mesh,
                             topo.accelerator_type)
            except ValueError as e:
                out[name] = str(e)
    for bad in ("v9-8", "v5p", "v5p-0", "tpu"):
        try:
            module.slice_topology(bad)
        except ValueError as e:
            out[bad] = str(e)
    return out


def test_slice_topology_equals_jax_for_every_generation():
    assert _topologies(t_topology) == _topologies(j_topology)


# -- data preparation --------------------------------------------------------


DATA_CASES = {
    "prepare-text": lambda out: [
        "data", "prepare-text", "--src", SLIVER + ".en", "--out", out,
        "--seq-len", "64"],
    "prepare-wikipedia": lambda out: [
        "data", "prepare-wikipedia", "--src", SLIVER + ".en", "--out", out,
        "--seq-len", "32", "--vocab-size", "400", "--seed", "3"],
    "prepare-wmt": lambda out: [
        "data", "prepare-wmt", "--src", SLIVER + ".en", "--tgt",
        SLIVER + ".de", "--out", out, "--seq-len", "48", "--vocab-size",
        "400", "--eval-fraction", "0.1"],
}


@pytest.mark.parametrize("verb", sorted(DATA_CASES))
def test_data_verb_writes_the_jax_files_byte_for_byte(verb, tmp_path, capsys):
    jax_run, port_run = _both(capsys, lambda tag: DATA_CASES[verb](
        str(tmp_path / tag)), tmp_path)
    assert port_run == jax_run and port_run[0] == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert "train.npz" in names and "eval.npz" in names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def test_data_verb_errors_exit_as_jax_does(tmp_path, capsys):
    jax_run, port_run = _both(capsys, lambda tag: [
        "data", "prepare-wmt", "--src", SLIVER + ".en", "--tgt",
        os.path.join(REPO, "README.md"), "--out", str(tmp_path / tag)],
        tmp_path)
    assert port_run == jax_run and port_run[0] == 1
    assert "parallel files differ in length" in port_run[2]


# -- train --stack -----------------------------------------------------------


def test_train_on_a_dryrun_stack_launches_the_worker(tmp_path, capsys,
                                                     monkeypatch):
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    state = str(tmp_path / "stacks")
    assert main(["stack", "create", "--name", "one", "--slice-type", "v5p-4",
                 "--provisioner", "dryrun", "--state-dir", state]) == 0
    capsys.readouterr()
    rc = main(["train", "--preset", "transformer_nmt_wmt", "--stack", "one",
               "--state-dir", state, "--accelerator", "cpu", "--max-steps",
               "2", f"workdir={tmp_path / 'work'}", *TINY_NMT])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "job finished (restarts=0" in out
    run_dir = tmp_path / "work" / "transformer_nmt_wmt"
    assert sorted(p.name for p in (run_dir / "logs").iterdir()) == [
        "attempt0-host0.log", "launch.jsonl"]
    log = (run_dir / "logs" / "attempt0-host0.log").read_text()
    assert "one device: cpu" in log and "worker 0 final metrics" in log
    recs = [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert {"train.dispatch", "ckpt.save"} <= {r["span"] for r in recs
                                               if "span" in r}
    assert (run_dir / "metrics.prom").exists()


def test_train_refuses_a_missing_or_multihost_stack_naming_a10(tmp_path,
                                                               capsys):
    state = str(tmp_path / "stacks")
    assert main(["train", "--preset", "transformer_nmt_wmt", "--stack",
                 "ghost", "--state-dir", state]) == 1
    assert "no such stack 'ghost'" in capsys.readouterr().err
    assert main(["stack", "create", "--name", "two", "--slice-type", "v5p-8",
                 "--provisioner", "dryrun", "--state-dir", state]) == 0
    capsys.readouterr()
    assert main(["train", "--preset", "transformer_nmt_wmt", "--stack",
                 "two", "--state-dir", state, "--accelerator", "cpu",
                 f"workdir={tmp_path / 'work'}",
                 "train.step_window=2"]) == 1
    err = capsys.readouterr().err
    assert "2 hosts" in err and "ROADMAP A.10" in err
    assert "step_window=2" in err
    assert not (tmp_path / "work").exists()  # nothing was launched
