"""One process of a data-parallel group for ``tests/test_torch_dist.py``.

    python tests/torch_dist_worker.py SPEC.json RANK

joins a gloo group of ``world`` processes on the CPU through the port's
``runtime.cluster.initialize`` (at ``127.0.0.1:<port>``), then runs every
case of the spec in turn: the preset with the case's overrides, the initial
state from a file of JAX-named leaves (``TrainState.load_named``), and the
given global batches, of which this process trains its contiguous rows
through the port's ``Trainer`` (``chip_smoke.fed_run``). Each case writes
``<out>/<case>-p<rank>.npz`` (the leaves this process holds) and, on
process 0, ``<out>/<case>.json`` (the per-step losses summed over the
processes); with ``ckpt`` every process writes its part of a checkpoint of
the final state there. Imports torch, the port and ``chip_smoke`` only.
"""

import json
import os
import sys

import numpy as np
import torch


def run_case(case, out_dir, rank):
    import chip_smoke
    from deeplearning_cfn_tpu_torch.ckpt import save_checkpoint
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.parallel import Elsewhere
    from deeplearning_cfn_tpu_torch.presets import get_preset

    cfg = apply_overrides(get_preset(case["preset"]), case["overrides"])
    with np.load(case["init"]) as init:
        losses, state = chip_smoke.fed_run(
            torch, cfg, chip_smoke.load_batches(case["batches"]), "cpu",
            init=dict(init))
    leaves = {name: value for name, value in state.named_leaves()
              if not isinstance(value, Elsewhere)}
    np.savez(os.path.join(out_dir, f"{case['name']}-p{rank}.npz"), **leaves)
    if case.get("ckpt"):
        save_checkpoint(case["ckpt"], state.step, state)
    if rank == 0:
        with open(os.path.join(out_dir, f"{case['name']}.json"), "w") as fh:
            json.dump({"losses": losses,
                       "slot_bytes": state.optimizer.slot_bytes(),
                       "slot_bytes_all":
                           state.optimizer.slot_bytes(owned_only=False)},
                      fh)


def main(spec_path, rank):
    torch.set_num_threads(1)
    with open(spec_path) as fh:
        spec = json.load(fh)
    from deeplearning_cfn_tpu_torch.runtime.cluster import ClusterSpec, \
        initialize

    initialize(ClusterSpec(hosts=["127.0.0.1"] * spec["world"],
                           process_id=rank, chips_per_host=1,
                           coordinator_port=spec["port"]),
               timeout_s=120, accelerator="cpu")
    for case in spec["cases"]:
        run_case(case, spec["out"], rank)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
