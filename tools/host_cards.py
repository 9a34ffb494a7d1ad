#!/usr/bin/env python3
"""Every card of one host over NCCL: what ``chip_smoke.py`` cannot show on
a machine with one card.

    python3 tools/host_cards.py [PART ...]

Needs two cards or more (exits 2 otherwise). Imports torch, the port and
``chip_smoke.py``, never JAX. It runs the parts named (all four by
default), and prints with the card's name and power limit:

1. ``chip_smoke.py`` phase 33 as the script runs it on this machine: 33a
   and 33d on the first card only (gloo), 33b, and 33c (``cli train
   --processes 2`` over NCCL, a card per process, windows of 4 replaying
   CUDA graphs against K = 1 and the control);
2. ``cli train`` of phase 33's NMT config with no ``--processes`` (one
   process per card, NCCL) at ``train.step_window=4`` and at K = 1, at
   once: each process's first line naming NCCL and graphs, its launches
   per step a one-process step's, and the K = 4 losses within
   ``HOST_LOSS_REL_BOUND`` of K = 1 at the logged steps;
3. ``parallel/collectives_bench.py`` at 64 MB over NCCL on every card and
   on 2: one JSON record per op from process 0;
4. ``cli bench --preset`` over every card (one process each, NCCL) and on
   one card, in this call: ``imagenet_resnet50`` at a global batch of 512
   per card and ``transformer_nmt_wmt`` at 64 per card (the preset's own
   global batch over four cards is 2048 ResNet-50 images per card, past
   one card's memory at 512's 56 GiB); one record each, the per-card
   rate, and the scaling share (the per-card rate over every card against
   one card's).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# Part 4's presets and per-card global batches (chip_smoke.py's 34a's).
CARD_BENCH = (("imagenet_resnet50", 512), ("transformer_nmt_wmt", 64))


def bench_over_cards(cs, root, cards):
    """Part 4: ``cli bench`` of each of :data:`CARD_BENCH` on one card, then
    over every card, one after the other."""
    import json

    for preset, per_card in CARD_BENCH:
        rates = {}
        for n in (1, cards):
            proc = subprocess.run(
                [sys.executable, "-m", "deeplearning_cfn_tpu_torch.cli",
                 "bench", "--preset", preset, "--processes", str(n),
                 "--global-batch", str(per_card * n), "--steps", "20"],
                cwd=root, capture_output=True, text=True, timeout=900)
            records = [json.loads(ln) for ln in proc.stdout.splitlines()
                       if ln.startswith("{")]
            if proc.returncode != 0 or len(records) != 1:
                raise AssertionError(f"bench {preset} on {n}: rc "
                                     f"{proc.returncode}\n"
                                     f"{proc.stderr[-3000:]}")
            rec = records[0]
            rates[n] = rec["value"]
            print(f"bench {preset} on {n} card(s), global batch "
                  f"{rec['global_batch']}: {json.dumps(rec)}", flush=True)
        print(f"bench {preset}: {rates[1]} per card on one card, "
              f"{rates[cards]} per card on {cards} (scaling share "
              f"{rates[cards] / rates[1]:.4f}) [{cs.card_line()}]",
              flush=True)


def main(argv=None) -> int:
    import torch

    parts = {int(a) for a in (sys.argv[1:] if argv is None else argv)} \
        or {1, 2, 3, 4}
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("host_cards.py: needs two CUDA cards or more", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    cs.keep_bytecode()
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p)
    cards = torch.cuda.device_count()
    print(f"{cs.card_line()} x{cards}", flush=True)
    root = tempfile.mkdtemp(prefix="host_cards_")

    if 1 in parts:
        t = time.perf_counter()
        cs.host_phase(torch, root)
        print(f"phase 33 {time.perf_counter() - t:.1f} s", flush=True)
    if 2 in parts:
        cards_train(cs, root, cards)
    if 3 in parts:
        collectives(root, cards)
    if 4 in parts:
        t = time.perf_counter()
        bench_over_cards(cs, root, cards)
        print(f"part 4 {time.perf_counter() - t:.1f} s", flush=True)
    print(cs.card_line(), flush=True)
    return 0


def cards_train(cs, root, cards):
    """Part 2: ``cli train`` over every card at K = 4 and K = 1, at
    once."""
    t = time.perf_counter()
    started = {}
    for k in (cs.HOST_WINDOW, 1):
        workdir = os.path.join(root, f"cards_k{k}")
        started[k] = (subprocess.Popen(
            [sys.executable, "-m", "deeplearning_cfn_tpu_torch.cli", "train",
             "--preset", "transformer_nmt_wmt", "--max-steps",
             str(cs.HOST_STEPS), f"workdir={workdir}", *cs.HOST_OVERRIDES,
             f"train.step_window={k}"],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), workdir)
    runs = {k: cs.host_train_finish(
                proc, workdir, "nccl", "windows replay CUDA graphs",
                processes=cards)
            for k, (proc, workdir) in started.items()}
    ref = runs[1]["losses"]
    rel = {s: abs(runs[cs.HOST_WINDOW]["losses"][s] - ref[s]) / abs(ref[s])
           for s in ref}
    print(f"cli train on {cards} cards: K=1 losses {ref}; K="
          f"{cs.HOST_WINDOW} relative {rel} (bound "
          f"{cs.HOST_LOSS_REL_BOUND:.1e}); both jobs at once "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    if max(rel.values()) > cs.HOST_LOSS_REL_BOUND:
        raise AssertionError(f"K={cs.HOST_WINDOW} against K=1: {rel}")


def collectives(root, cards):
    """Part 3: ``collectives_bench`` over every card and over 2."""
    for procs in (cards, 2):
        proc = subprocess.run(
            [sys.executable, "-m",
             "deeplearning_cfn_tpu_torch.parallel.collectives_bench",
             "--processes", str(procs), "--size-mb", "64",
             "--log-dir", os.path.join(root, f"bench{procs}")],
            cwd=root, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"collectives_bench on {procs}: rc "
                                 f"{proc.returncode}\n{proc.stderr[-3000:]}")
        print(f"collectives_bench over NCCL on {procs} cards:", flush=True)
        print(proc.stdout.strip(), flush=True)


if __name__ == "__main__":
    sys.exit(main())
