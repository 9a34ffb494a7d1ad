"""Data-parallel training through the port's entry points on the CPU: ``cli
train --stack`` on a two-host dry-run stack (the counterpart of
``tests/test_cli.py``'s stack run), and the launcher's kill, restart and
resume of a two-process job under ZeRO-1.

- ``train --stack`` with ``--accelerator cpu``: both hosts' workers join one
  gloo group (each log names its backend), both finish, only process 0
  writes ``metrics.jsonl`` (one record per step) and the records; the
  checkpoint has ``manifest_p0``/``manifest_p1`` and ``COMMIT``; a rerun
  with more steps prints ``resumed from step N`` and continues;
- ``run_crash_recovery(hosts=2, kill_process=1)`` on the tiny BERT under
  LAMB with ``shard_opt_state=True``: process 1 is SIGKILLed after the
  step-4 commit, the launcher kills process 0 and restarts both, they resume
  from step 4, and every step's loss equals the uninterrupted two-process
  run's bit for bit;
- ``chip_smoke.py``'s phases 28a and 28b at the tiny f32 NMT's widths on
  the CPU: two processes through ``train --stack`` against one process on
  the same global batches part by at most ``F32_REL`` relative per step
  (the sums change order only: 1.146e-7 measured), and 28b's control, two
  processes whose gradients are never summed, parts by more than 28b's
  bound.

The workers run with one thread each (``OMP_NUM_THREADS=1``).
"""

import json
import os

import pytest

from deeplearning_cfn_tpu_torch.cli.main import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_NMT = ["model.kwargs.hidden_size=32", "model.kwargs.num_layers=1",
            "model.kwargs.num_heads=2", "model.kwargs.mlp_dim=64",
            "data.vocab_size=64", "data.seq_len=16", "train.global_batch=8",
            "data.num_eval_examples=16", "eval.max_decode_len=8",
            "schedule.warmup_steps=10", "schedule.base_lr=0.01",
            "train.dtype=float32", "checkpoint.every_steps=3",
            "train.eval_every_steps=1000", "train.log_every_steps=1"]
TINY_BERT = ["model.name=bert_tiny", "model.kwargs.hidden_size=32",
             "model.kwargs.num_layers=2", "model.kwargs.num_heads=2",
             "model.kwargs.mlp_dim=64", "model.kwargs.max_len=32",
             "data.vocab_size=64", "data.seq_len=16", "train.global_batch=8",
             "data.num_train_examples=64", "data.num_eval_examples=16",
             "train.dtype=float32", "schedule.warmup_steps=2",
             "model.kwargs.dropout_rate=0.0", "checkpoint.async_write=false"]


@pytest.fixture
def workers_env(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_train_on_a_two_host_dryrun_stack(tmp_path, capsys, workers_env):
    state = str(tmp_path / "stacks")
    assert main(["stack", "create", "--name", "two", "--slice-type", "v5p-8",
                 "--provisioner", "dryrun", "--state-dir", state]) == 0
    assert "CREATE_COMPLETE: 2 hosts" in capsys.readouterr().out
    argv = ["train", "--preset", "transformer_nmt_wmt", "--stack", "two",
            "--state-dir", state, "--accelerator", "cpu",
            f"workdir={tmp_path / 'work'}", *TINY_NMT]
    assert main(argv + ["--max-steps", "6"]) == 0
    out = capsys.readouterr().out
    assert "job finished (restarts=0" in out
    run_dir = tmp_path / "work" / "transformer_nmt_wmt"
    logs = {p.name: p.read_text() for p in (run_dir / "logs").iterdir()
            if p.suffix == ".log"}
    assert sorted(logs) == ["attempt0-host0.log", "attempt0-host1.log"]
    for rank, name in enumerate(sorted(logs)):
        assert f"process {rank}/2: backend gloo, device cpu" in logs[name]
        assert f"worker {rank} flash kernel launches over steps 2-6" \
            in logs[name]
    assert "mesh[dcn_data=1, pipe=1, data=2" in logs["attempt0-host0.log"]
    # Process 0 alone writes the records and prints.
    assert '"loss"' not in logs["attempt0-host1.log"]
    assert "total_steps" not in logs["attempt0-host1.log"]
    recs = [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    steps = [r["step"] for r in recs if "loss" in r and "span" not in r]
    assert steps == list(range(1, 7))
    assert all(r["examples_per_sec_per_device"] * 2 ==
               pytest.approx(r["examples_per_sec"])
               for r in recs if "examples_per_sec" in r)
    assert (run_dir / "metrics.prom").exists()
    for step in (3, 6):
        names = os.listdir(run_dir / "ckpt" / f"step_{step:08d}")
        assert {"COMMIT", "manifest_p0.json", "manifest_p1.json",
                "shards_p1.npz"} <= set(names), names
    assert main(argv + ["--max-steps", "8"]) == 0
    out = capsys.readouterr().out
    log0 = (run_dir / "logs" / "attempt0-host0.log").read_text()
    assert "resumed from step 6" in log0 + out
    recs = [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "loss" in r and "span" not in r][6:] \
        == [7, 8]


def test_zero1_job_survives_a_killed_process_bit_for_bit(tmp_path,
                                                          workers_env):
    from deeplearning_cfn_tpu_torch.launch.chaos import run_crash_recovery

    report = run_crash_recovery(
        str(tmp_path), preset="bert_base_wikipedia",
        overrides=TINY_BERT + ["train.shard_opt_state=true"],
        total_steps=6, kill_at_step=4, ckpt_every=2, max_restarts=2,
        accelerator="cpu", hosts=2, kill_process=1)
    assert report.baseline_result.success, report.baseline_result
    assert report.chaos_result.success, report.chaos_result
    assert report.chaos_result.attempt_outcomes == ["crash", "ok"]
    first = report.chaos_result
    assert report.resumed_from == 4
    assert report.parity_ok, report.mismatches
    assert report.chaos_steps == report.baseline_steps == list(range(1, 7))
    assert report.uncommitted_after == []
    # The workers read their host list (two processes of one machine) from
    # the hostfile.
    assert (tmp_path / "hosts").read_text().split() == ["127.0.0.1"] * 2
    logs = tmp_path / "logs-chaos"
    assert "CHAOS: SIGKILL self at step 4" in \
        (logs / "attempt0-host1.log").read_text()
    assert "CHAOS" not in (logs / "attempt0-host0.log").read_text()
    for name in ("attempt0-host0.log", "attempt1-host1.log"):
        assert "ZeRO-1 optimizer slots" in (logs / name).read_text()
    step = tmp_path / "chaos" / "bert_base_wikipedia" / "ckpt" / \
        "step_00000006"
    with open(step / "manifest_p1.json") as fh:
        assert all(n.startswith("opt_state/")
                   for n in json.load(fh)["leaves"])
    assert first.restarts == 1


TINY_DP = ["model.kwargs.hidden_size=32", "model.kwargs.num_layers=2",
           "model.kwargs.num_heads=2", "model.kwargs.mlp_dim=64",
           "data.vocab_size=64", "data.seq_len=16", "train.dtype=float32",
           "data.num_train_examples=512", "data.num_eval_examples=16",
           "eval.max_decode_len=8"]
# f32 sums of 8 rows against sums of 2 × 4 (unit roundoff 6e-8), with room
# for another BLAS build or thread count.
F32_REL = 1e-6


def test_phase28_two_processes_against_one_on_the_cpu(tmp_path, workers_env,
                                                      monkeypatch):
    import torch

    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DP_OVERRIDES",
                        chip_smoke.DP_OVERRIDES + TINY_DP)
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        stacked = chip_smoke.dp_stack_train(torch, str(tmp_path),
                                            accelerator="cpu")
        ref = chip_smoke.dp_reference(torch, str(tmp_path), stacked,
                                      device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert len(stacked["losses"]) == chip_smoke.DP_STEPS
    assert ref["max_rel"] <= F32_REL
    assert ref["control_max_rel"] > chip_smoke.DP_LOSS_REL_BOUND
    assert ref["moved"] >= chip_smoke.DP_MOVE_FACTOR * \
        chip_smoke.DP_LOSS_REL_BOUND
    assert stacked["launches"] == {
        f"rank{r}": {"fwd": 0, "dkdv": 0, "dq": 0} for r in range(2)}
