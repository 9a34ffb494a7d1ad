"""The port's command line — the JAX package's ``dlcfn-tpu`` verbs on
PyTorch and CUDA:

    python -m deeplearning_cfn_tpu_torch.cli stack create --name demo \\
        --slice-type v5p-4 --provisioner dryrun [--state-dir DIR]
    python -m deeplearning_cfn_tpu_torch.cli train --preset transformer_nmt_wmt \\
        [--stack demo [--state-dir DIR] | --processes N] [--max-restarts N] \\
        [--accelerator gpu|cpu] [--max-steps N] [overrides ...]
    python -m deeplearning_cfn_tpu_torch.cli stack resize|delete|status demo
    python -m deeplearning_cfn_tpu_torch.cli stack list
    python -m deeplearning_cfn_tpu_torch.cli eval --preset bert_base_wikipedia \\
        [--step N] workdir=...
    python -m deeplearning_cfn_tpu_torch.cli generate --preset gpt_small_lm \\
        --prompt "..." [--max-new-tokens N] [--temperature T --top-k K] \\
        [--vocab vocab.json] [--step N] workdir=...
    python -m deeplearning_cfn_tpu_torch.cli serve --preset transformer_nmt_wmt \\
        --allow-init --requests reqs.jsonl [--speculate G [--speculate-device] \\
        [--draft tiny-distilled]] [--radix-cache] [--prefill-chunk N] \\
        [--quantize int8] [--kv-quant int8] [--vocab vocab.json] \\
        [overrides ...]
    python -m deeplearning_cfn_tpu_torch.cli fleet up --preset transformer_nmt_wmt \
        --requests reqs.jsonl [--replicas N | --prefill P --decode D | --net] \
        [--accelerator gpu|cpu] [--allow-init] [overrides ...]
    python -m deeplearning_cfn_tpu_torch.cli fleet route|rollout --preset P \
        --requests reqs.jsonl [--replicas N] [--to-step S] [overrides ...]
    python -m deeplearning_cfn_tpu_torch.cli fleet status <run root> [--json]
    python -m deeplearning_cfn_tpu_torch.cli bench --preset P [--steps N] \
        [--global-batch B | --sweep-batches B1,B2] [--with-input] \
        [--step-window K] [--processes N] [--accelerator gpu|cpu]
    python -m deeplearning_cfn_tpu_torch.cli bench --serve|--fleet [--net] \
        [--smoke] ... | --obs-smoke [--processes N] | --ops SUITE | \
        --collectives [--processes N]
    python -m deeplearning_cfn_tpu_torch.cli ckpt list <ckpt dir>
    python -m deeplearning_cfn_tpu_torch.cli ckpt rollback <ckpt dir> --step N
    python -m deeplearning_cfn_tpu_torch.cli presets | config --preset P | info
    python -m deeplearning_cfn_tpu_torch.cli doctor [--skip-backend]
    python -m deeplearning_cfn_tpu_torch.cli metrics <run dir>
    python -m deeplearning_cfn_tpu_torch.cli obs summarize|export|check|diff|tail ...
    python -m deeplearning_cfn_tpu_torch.cli data prepare-text|prepare-wmt|\\
        prepare-wikipedia|prepare-coco|prepare-imagenet|feed-rate ...

Same flags, defaults, result lines, exit codes and stderr summary as the JAX
package's verbs. ``--accelerator`` takes ``gpu`` (the default — the CUDA
card, raising without one) or ``cpu``. ``train`` without ``--stack`` on
a machine with one card (or on the CPU) runs in this process (a rerun
resumes from the latest committed checkpoint); with several cards it runs
one ``train.worker`` process per card over NCCL, as the JAX package runs
one process over every local device (``--processes N`` sets the count:
more processes than cards share them over gloo, fewer take the first
cards; on the CPU it is the counterpart of JAX's forced host device
count), and prints process 0's final metrics; with ``--stack`` it fans
``train.worker`` to the stack's hosts. Either way through the
launcher, which restarts a dead or hung worker up to ``--max-restarts``
times, each attempt resuming from the last committed checkpoint (logs in
``<workdir>/<preset>/logs/attempt<N>-host<I>.log`` and ``launch.jsonl``). A
dry-run stack runs its host as a local process on the card (or the CPU with
``--accelerator cpu``; the JAX package forces the CPU there). A stack of
several hosts trains on every mesh axis: every host's worker joins the
process group at host 0 (a dry-run stack's hosts are local processes that
share this machine's cards, on a free local port), the mesh resolves over
those processes (``mesh.seq`` > 1 splits each row's sequence for
``bert_long``/``gpt_long``, ``mesh.pipe`` > 1 the pipelined trunk's
layers into GPipe stages, ``mesh.expert`` > 1 a MoE trunk's experts,
``mesh.model`` > 1 the transformers' heads and hidden units,
``mesh.spatial`` > 1 Mask R-CNN's image rows); a mesh they cannot carry
is refused before any launch. ``train.step_window`` > 1 over processes
replays each step as a CUDA graph with its collectives inside under NCCL,
and runs the window's steps eagerly under gloo (``train/graphs.py``). ``generate``
collapses the preset's mesh
(a ``gpt_long`` checkpoint generates on one device, recomputing the causal
forward each step). ``info`` and ``doctor`` report torch, CUDA, the
devices and the mesh of this process. Serve requests are JSONL lines
``{"src_ids": [...]}``, or ``{"text": "..."}`` with ``--vocab``
(BPE-encoded, ``data/bpe.py``, plus EOS; each result line then carries the
decoded ``"text"``), with optional ``id``, ``max_new_tokens``,
``beam_size``, ``deadline_s``, ``tenant`` and ``qos_class``; ``--quantize
int8`` and ``--kv-quant int8`` serve int8 weights and an int8 paged KV pool.
``generate`` takes a byte-level prompt (byte + 4), or a BPE one with
``--vocab``. On the card, ``serve`` adds one stderr line with the
attention kernel's launches after its warm-up and the encoder forwards and
decoder steps they served (its children's counts are how ``fleet up``
shows the card was used). ``fleet up`` runs ``--replicas`` supervised
``serve`` children, each on its shard of the trace; with ``--prefill``/
``--decode`` it serves a disaggregated fleet in this process instead (KV
handoff through a store), and with ``--net`` it drives ``net.server``
children behind unix sockets (the seeded tiny recipe). ``fleet route``
and ``fleet rollout`` serve in-process replicas behind the router
(``rollout`` swaps every replica to ``--to-step`` mid-stream), and
``fleet status`` reports on a fleet run root. ``bench`` prints the JAX
package's records (one JSON line each): a preset's training step
(``bench.py``, its MFU from the model's own FLOP count) and the obs
overhead smoke over every card of the host, one process per card as ``train
--processes`` runs them (``--processes N`` sets the count; one process
takes a per-card batch, several the preset's global batch, as the JAX
verb's over one or several devices; ``--global-batch`` sets it either
way), the serving, fleet and process-fleet scenarios (``serve/bench.py``,
``fleet/bench.py``, ``net/bench.py``), the op suites (``opsbench.py``)
and the collectives over the host's processes (``parallel/
collectives_bench.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from ..config import ExperimentConfig, StackConfig, apply_overrides
from ..presets import get_preset, list_presets


def _stack_cfg_from_args(args) -> StackConfig:
    return StackConfig(
        name=args.name,
        accelerator=args.accelerator,
        slice_type=args.slice_type,
        zone=args.zone,
        project=args.project,
        runtime_version=args.runtime_version,
        preemptible=args.preemptible,
        provisioner=args.provisioner,
        state_dir=args.state_dir,
        create_timeout_s=args.create_timeout_s,
    )


def _cmd_stack_create(args) -> int:
    from ..provision import ProvisionError, create_stack

    cfg = _stack_cfg_from_args(args)
    print(f"[dlcfn-tpu] creating stack {cfg.name!r} "
          f"({cfg.slice_type}, zone {cfg.zone}, "
          f"provisioner {cfg.provisioner}) ...")

    def on_status(state):
        counts = {}
        for h in state.hosts:
            counts[h.state] = counts.get(h.state, 0) + 1
        print(f"[dlcfn-tpu]   hosts: {counts}")

    try:
        state = create_stack(cfg, on_status=on_status)
    except ProvisionError as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 1
    print(f"[dlcfn-tpu] stack {state.name!r} CREATE_COMPLETE: "
          f"{len(state.hosts)} hosts, hostfile {state.hostfile}")
    return 0


def _cmd_stack_resize(args) -> int:
    from ..provision import ProvisionError, StackStore, resize_stack

    # Destroy-first semantics must be visible before the irreversible step:
    # if the replacement create fails (quota, capacity) the old stack is
    # already gone (slices are not elastically resizable).
    print(f"[dlcfn-tpu] resize: tearing down stack {args.name!r} before "
          f"creating its {args.slice_type} replacement — if the new create "
          f"fails, the old stack will NOT be restored", flush=True)
    try:
        state = resize_stack(args.name, args.slice_type,
                             store=StackStore(args.state_dir))
    except (KeyError, ProvisionError) as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 1
    print(f"[dlcfn-tpu] stack {state.name!r} resized to "
          f"{state.slice_type}: {len(state.hosts)} hosts ready; relaunch "
          f"`train --stack {state.name}` to resume from the last "
          f"checkpoint")
    return 0


def _cmd_stack_delete(args) -> int:
    from ..provision import ProvisionError, StackStore, delete_stack

    try:
        delete_stack(args.name, store=StackStore(args.state_dir))
    except (KeyError, ProvisionError) as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 1
    print(f"[dlcfn-tpu] stack {args.name!r} deleted")
    return 0


def _cmd_stack_status(args) -> int:
    from ..provision import StackStore

    store = StackStore(args.state_dir)
    state = store.load_or_none(args.name)
    if state is None:
        print(f"[dlcfn-tpu] no such stack {args.name!r}", file=sys.stderr)
        return 1
    print(json.dumps(state.to_dict(), indent=2))
    return 0


def _cmd_stack_list(args) -> int:
    from ..provision import StackStore

    store = StackStore(args.state_dir)
    stacks = store.list()
    if not stacks:
        print("[dlcfn-tpu] no stacks")
        return 0
    for s in stacks:
        print(f"{s.name:20s} {s.slice_type:10s} {s.status.value:20s} "
              f"{len(s.hosts)} hosts  zone={s.zone}")
    return 0


def _cmd_presets(args) -> int:
    for name in list_presets():
        cfg = get_preset(name)
        print(f"{name:24s} model={cfg.model.name:20s} "
              f"data={cfg.data.name:16s} slice={cfg.stack.slice_type}")
    return 0


def _cmd_show_config(args) -> int:
    cfg = apply_overrides(get_preset(args.preset), args.overrides)
    print(cfg.to_json())
    return 0


def _cmd_info(args) -> int:
    """torch and CUDA versions, the devices, the process and the layout:
    this process's device, behind JAX's mesh line in a process group."""
    import torch

    from ..parallel.mesh import build_mesh
    from ..train.run import _describe

    cuda = torch.cuda.is_available()
    n = torch.cuda.device_count() if cuda else 0
    mesh = build_mesh()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"backend {'cuda' if cuda else 'cpu'}")
    print(f"devices: {n} total, {n} local, process "
          f"{mesh.process_index}/{mesh.process_count}")
    print(_describe(torch.device("cuda", torch.cuda.current_device())
                    if cuda else torch.device("cpu"), mesh))
    return 0


def _cmd_train(args) -> int:
    """Train a preset on this host's cards (or the CPU with ``--accelerator
    cpu``) and print the final metrics: in this process with one card (or
    ``--processes 1``), else as one process per card (``--processes``)
    through the launcher; with ``--stack``, on the stack's hosts
    instead."""
    from ..parallel.mesh import build_mesh
    from ..runtime.cluster import local_processes
    from ..runtime.platform import resolve_device
    from ..train.run import run_experiment

    cfg = apply_overrides(get_preset(args.preset), args.overrides)
    cfg.stack.accelerator = args.accelerator
    if args.stack:
        if args.processes is not None:
            print("[dlcfn-tpu] ERROR: --processes is for one host without "
                  "--stack; a stack runs one process per host",
                  file=sys.stderr)
            return 1
        return _train_on_stack(args, cfg)
    try:
        processes, cards = local_processes(args.processes, args.accelerator)
        if processes > 1:
            build_mesh(cfg.mesh, num_processes=processes, index=0)
        else:
            device = resolve_device(args.accelerator)
    except (RuntimeError, ValueError) as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 1
    if processes > 1:
        return _train_on_this_host(args, cfg, processes, cards)
    final = run_experiment(cfg, max_steps=args.max_steps, device=device)
    print(f"[dlcfn-tpu] final metrics: "
          f"{ {k: round(v, 4) for k, v in final.items()} }")
    return 0


def _worker_argv(args) -> List[str]:
    argv = [sys.executable, "-m", "deeplearning_cfn_tpu_torch.train.worker",
            "--preset", args.preset, "--accelerator", args.accelerator]
    if args.max_steps is not None:
        argv += ["--max-steps", str(args.max_steps)]
    return argv + list(args.overrides)


def _on_failure(idx, host):
    print(f"[dlcfn-tpu] host {idx} ({host}) FAILED — killing job, "
          "will resume from last checkpoint", file=sys.stderr)


def _job_done(result) -> int:
    if result.success:
        print(f"[dlcfn-tpu] job finished "
              f"(restarts={result.restarts}, logs in {result.log_dir})")
        return 0
    print(f"[dlcfn-tpu] job FAILED after {result.restarts} restarts "
          f"(exit codes {result.exit_codes}, logs in {result.log_dir})",
          file=sys.stderr)
    return 1


def _train_on_this_host(args, cfg: ExperimentConfig, processes: int,
                        cards: int) -> int:
    """One process per card of this machine (``processes`` of them) as one
    job over NCCL, or sharing the cards over gloo when there are more
    processes than cards (``runtime.cluster.choose_backend``), through the
    launcher: the restarts and logs of ``--stack``. Then process 0's final
    metrics, as one process prints them."""
    from ..launch import run_local

    result = run_local(_worker_argv(args), processes, cards,
                       os.path.join(cfg.workdir, args.preset, "logs"),
                       max_restarts=args.max_restarts,
                       on_failure=_on_failure)
    if result.success:
        log0 = os.path.join(result.log_dir,
                            f"attempt{result.restarts}-host0.log")
        marker = "[dlcfn-tpu] worker 0 final metrics: "
        with open(log0, errors="replace") as fh:
            lines = [ln for ln in fh if ln.startswith(marker)]
        if lines:
            print(f"[dlcfn-tpu] final metrics: "
                  f"{lines[-1][len(marker):].strip()}")
    return _job_done(result)


def _train_on_stack(args, cfg: ExperimentConfig) -> int:
    """Fan the worker module to every host of the stack through the
    launcher, which restarts a failed attempt on every host (each resumes
    from the last committed checkpoint). Several hosts train over one
    process group; a mesh they cannot carry is refused before any
    launch."""
    from ..launch import JobLauncher, LocalTransport, SshTransport
    from ..parallel.mesh import build_mesh
    from ..provision import StackStore
    from ..provision.topology import slice_topology
    from ..runtime.cluster import DEFAULT_COORDINATOR_PORT, ClusterSpec, \
        free_local_port

    store = StackStore(args.state_dir)
    state = store.load_or_none(args.stack)
    if state is None:
        print(f"[dlcfn-tpu] no such stack {args.stack!r} — "
              "run `stack create` first", file=sys.stderr)
        return 1
    if not state.ready:
        print(f"[dlcfn-tpu] stack {args.stack!r} is {state.status.value}, "
              "not CREATE_COMPLETE", file=sys.stderr)
        return 1
    try:
        build_mesh(cfg.mesh, num_processes=len(state.hosts), index=0)
    except (NotImplementedError, ValueError) as e:
        print(f"[dlcfn-tpu] ERROR: stack {args.stack!r} has "
              f"{len(state.hosts)} hosts: {e}", file=sys.stderr)
        return 1
    if state.provisioner == "dryrun" and args.accelerator == "gpu":
        # A dry-run host is a local process on this machine's card.
        import torch

        if not torch.cuda.is_available():
            print("[dlcfn-tpu] ERROR: a CUDA card was asked for but "
                  "torch.cuda.is_available() is False — pass --accelerator "
                  "cpu to run the dry-run host on the CPU", file=sys.stderr)
            return 1

    topo = slice_topology(state.slice_type)
    # A dry-run stack's hosts are processes of this machine: their
    # rendezvous takes a free local port, so two jobs never meet.
    port = free_local_port() if state.provisioner == "dryrun" \
        else DEFAULT_COORDINATOR_PORT
    spec = ClusterSpec(hosts=state.host_addresses(),
                       chips_per_host=topo.chips_per_host,
                       coordinator_port=port, hostfile=state.hostfile)
    # Dry-run stacks run their host as a local process.
    transport = LocalTransport() if state.provisioner == "dryrun" \
        else SshTransport()
    launcher = JobLauncher(transport=transport,
                           max_restarts=args.max_restarts)
    return _job_done(launcher.run(
        spec, _worker_argv(args), os.path.join(cfg.workdir, args.preset,
                                               "logs"),
        on_failure=_on_failure))


def _cmd_eval(args) -> int:
    """Evaluate a committed checkpoint (the latest, or ``--step``) without
    training and print the metrics as one JSON line."""
    from ..runtime.platform import resolve_device
    from ..train.run import run_eval

    cfg = apply_overrides(get_preset(args.preset), args.overrides)
    cfg.stack.accelerator = args.accelerator
    try:
        device = resolve_device(args.accelerator)
    except RuntimeError as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 1
    try:
        metrics = run_eval(cfg, step=args.step, device=device)
    except FileNotFoundError as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 1
    print(json.dumps({k: round(v, 6) if isinstance(v, float) else v
                      for k, v in metrics.items()}))
    return 0


def _cmd_generate(args) -> int:
    """Prompt → continuation from a trained causal-LM checkpoint (params
    only, the latest or ``--step``): the byte tokenizer of ``lm_text``
    (byte values shifted past the 4 reserved ids), or BPE with
    ``--vocab``; greedy at ``--temperature 0``, else seeded sampling."""
    import torch

    from ..ckpt import CheckpointManager, latest_checkpoint
    from ..config import MeshConfig
    from ..models.decoding import lm_generate
    from ..runtime.platform import resolve_device
    from ..train.run import _workdir_and_ckpt_dir
    from ..train.state import create_train_state
    from ..train.task import CausalLmTask, build_task

    cfg = apply_overrides(get_preset(args.preset), args.overrides)
    cfg.stack.accelerator = args.accelerator
    try:
        device = resolve_device(args.accelerator)
    except RuntimeError as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 1
    _, ckpt_dir = _workdir_and_ckpt_dir(cfg)
    if latest_checkpoint(ckpt_dir) is None:
        print(f"[dlcfn-tpu] ERROR: no committed checkpoint in {ckpt_dir}",
              file=sys.stderr)
        return 1
    # generate is a local inference verb: collapse every model axis, so a
    # sequence-parallel trunk (gpt_long) runs whole rows on this device
    # (the flash kernels, recompute mode) instead of the training pod's
    # data×seq layout.
    cfg.mesh = MeshConfig(data=-1)
    task = build_task(cfg, device)
    if not isinstance(task, CausalLmTask):
        print(f"[dlcfn-tpu] ERROR: model {cfg.model.name!r} is not a "
              f"causal LM (generate needs the gpt family)", file=sys.stderr)
        return 1
    state = create_train_state(task.model, None)
    try:
        leaves, at_step = CheckpointManager(ckpt_dir).restore_or_none(
            state, step=args.step)
        state.load_named(leaves)
        bpe = None
        if args.vocab:
            from ..data.bpe import Bpe

            bpe = Bpe.load(args.vocab)
            prompt_ids = bpe.encode(args.prompt)
            if not prompt_ids:
                print("[dlcfn-tpu] ERROR: prompt encodes to zero tokens",
                      file=sys.stderr)
                return 1
        else:
            prompt_ids = [b + 4 for b in args.prompt.encode()]
        prompt = torch.tensor([prompt_ids], dtype=torch.long, device=device)
        generator = None
        if args.temperature > 0:
            generator = torch.Generator(device=device)
            generator.manual_seed(args.seed)
        out = lm_generate(task.model, prompt, args.max_new_tokens,
                          temperature=args.temperature, top_k=args.top_k,
                          generator=generator)[0].tolist()
    except (FileNotFoundError, ValueError) as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 1
    if bpe is not None:
        text = bpe.decode(out)
    else:
        # Ids outside the byte range print as '?': 0-3 are the specials, and
        # ids >= 260 exist whenever the vocab is larger than the byte
        # tokenizer's (gpt_small_lm's 32768).
        text = bytes(t - 4 if 4 <= t < 260 else 0x3F for t in out) \
            .decode(errors="replace")
    print(f"[dlcfn-tpu] checkpoint step {at_step}:")
    print(text)
    return 0


def _cli_store(args):
    """The ckpt verbs' store; ``--retry-attempts`` > 1 wraps it in the retry
    policy training uses. A local directory that does not exist is an
    error."""
    from ..ckpt import RetryPolicy, open_store

    if not args.dir.startswith("gs://") and not os.path.isdir(args.dir):
        raise FileNotFoundError(f"no such checkpoint directory: {args.dir}")
    retry = None
    if args.retry_attempts > 1:
        retry = RetryPolicy(max_attempts=args.retry_attempts,
                            backoff_s=args.retry_backoff)
    return open_store(args.dir, retry=retry)


def _cmd_ckpt_list(args) -> int:
    from ..ckpt import committed_steps

    try:
        store = _cli_store(args)
        steps = committed_steps(store)
    except FileNotFoundError as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"directory": args.dir, "committed_steps": steps,
                      "store_retries": getattr(store, "retries_total", 0)}))
    return 0


def _cmd_ckpt_rollback(args) -> int:
    from ..ckpt import rollback_checkpoints

    try:
        deleted = rollback_checkpoints(_cli_store(args), args.step)
    except FileNotFoundError as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 1
    print(f"[dlcfn-tpu] rolled back to step {args.step}; deleted "
          f"{len(deleted)} later checkpoint(s): {deleted}. The next "
          f"training launch will auto-resume from step {args.step}.")
    return 0


def _cmd_serve(args) -> int:
    """Offline continuous-batching driver: a JSONL request trace in, one
    result JSON line per request out."""
    from ..metrics.jsonl import MetricsWriter
    from ..models.decoding import EOS_ID, strip_special
    from ..serve import OverloadError
    from ..serve.loader import load_engine

    cfg = apply_overrides(get_preset(args.preset), args.overrides)
    cfg.stack.accelerator = args.accelerator
    try:
        engine, bpe, at_step = load_engine(
            cfg, capacity=args.slots, queue_depth=args.queue_depth,
            default_max_new_tokens=args.max_new_tokens,
            decode_window=args.decode_window,
            kv_block_size=args.kv_block_size, kv_blocks=args.kv_blocks,
            prefix_cache_size=args.prefix_cache,
            speculate_gamma=args.speculate,
            speculate_device=args.speculate_device,
            draft_cfg=args.draft or None,
            quantize=args.quantize, kv_quant=args.kv_quant,
            radix_cache=args.radix_cache,
            prefill_chunk=args.prefill_chunk,
            step=args.step, vocab=args.vocab, allow_init=args.allow_init,
            device=args.accelerator)
    except (FileNotFoundError, ValueError, RuntimeError) as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 1
    if at_step == -1:
        print("[dlcfn-tpu] WARNING: serving RANDOM weights (--allow-init, "
              "no committed checkpoint) — smoke mode only", file=sys.stderr)
    else:
        print(f"[dlcfn-tpu] serving checkpoint step {at_step} "
              f"({args.slots} slots, decode window {args.decode_window})",
              file=sys.stderr)

    from ..ops.attention import flash_attention_forward as fwd
    from ..ops.attention import zero_launch_counts

    # The launch line reports the requests' launches, not the warm-up's.
    zero_launch_counts()
    work0 = (engine.encoder_forwards, engine.decoder_steps)
    if args.requests == "-":
        lines = [ln for ln in sys.stdin if ln.strip()]
    else:
        try:
            with open(args.requests) as fh:
                lines = [ln for ln in fh if ln.strip()]
        except OSError as e:
            print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
            return 1

    writer = MetricsWriter(args.metrics_path, also_stdout=False) \
        if args.metrics_path else None
    submitted = []
    for lineno, ln in enumerate(lines, 1):
        try:
            rec = json.loads(ln)
        except json.JSONDecodeError as e:
            print(f"[dlcfn-tpu] ERROR: bad JSON on requests line {lineno}: "
                  f"{e}", file=sys.stderr)
            return 1
        if "src_ids" in rec:
            src_ids = [int(t) for t in rec["src_ids"]]
        elif "text" in rec:
            if bpe is None:
                print(f"[dlcfn-tpu] ERROR: requests line {lineno} has "
                      "\"text\" but no --vocab was given", file=sys.stderr)
                return 1
            src_ids = bpe.encode(rec["text"]) + [EOS_ID]
        else:
            print(f"[dlcfn-tpu] ERROR: requests line {lineno} has neither "
                  "\"src_ids\" nor \"text\"", file=sys.stderr)
            return 1
        kwargs = dict(
            max_new_tokens=int(rec.get("max_new_tokens",
                                       args.max_new_tokens)),
            beam_size=int(rec.get("beam_size", args.beam_size)),
            request_id=rec.get("id"),
        )
        if rec.get("deadline_s") is not None:
            kwargs["deadline_s"] = float(rec["deadline_s"])
        # Optional multi-tenant QoS tags; untagged lines keep QoS off.
        for key in ("tenant", "qos_class"):
            if rec.get(key) is not None:
                kwargs[key] = str(rec[key])
        while True:
            try:
                submitted.append(engine.submit(src_ids, **kwargs).id)
                break
            except ValueError as e:
                print(f"[dlcfn-tpu] requests line {lineno} rejected: {e}",
                      file=sys.stderr)
                break
            except OverloadError:
                # Bounded queue full: drain a step, then retry.
                if not engine.step():
                    raise
        if writer is not None and args.emit_every and \
                len(submitted) % args.emit_every == 0:
            engine.metrics.emit(writer)
    steps = engine.run_until_drained(writer=writer,
                                     emit_every=args.emit_every)
    for rid in submitted:
        req = engine.poll(rid)
        out = {
            "id": req.id,
            "state": req.state.value,
            "tokens": [int(t) for t in strip_special(req.tokens)],
            "ttft_s": req.ttft_s,
            "latency_s": req.latency_s,
        }
        if bpe is not None:
            out["text"] = bpe.decode(strip_special(req.tokens))
        print(json.dumps(out), flush=True)
    snap = engine.metrics.snapshot()
    print(f"[dlcfn-tpu] drained in {steps} steps: "
          f"{snap['serve_completed']} done, "
          f"{snap['serve_cancelled']} cancelled, "
          f"{snap['serve_expired']} expired; "
          f"tokens/sec={snap['serve_tokens_per_sec']}, "
          f"ttft_p50_s={snap['serve_ttft_p50_s']}, "
          f"occupancy={snap['serve_slot_occupancy']}", file=sys.stderr)
    if fwd.launches:
        print(f"[dlcfn-tpu] flash kernel launches {fwd.launches} "
              f"{dict(fwd.variant_launches)} over "
              f"{engine.encoder_forwards - work0[0]} encoder forwards and "
              f"{engine.decoder_steps - work0[1]} decoder steps",
              file=sys.stderr)
    if writer is not None:
        writer.close()
    return 0


# -- fleet ------------------------------------------------------------------


def _fleet_read_trace(path: str, vocab: str):
    """Parse a serve-style JSONL request trace into submit kwargs.
    Returns (list of dicts, bpe_or_None) or raises ValueError/OSError."""
    bpe = None
    if vocab:
        from ..data.bpe import Bpe

        bpe = Bpe.load(vocab)
    from ..models.decoding import EOS_ID

    if path == "-":
        lines = [ln for ln in sys.stdin if ln.strip()]
    else:
        with open(path) as fh:
            lines = [ln for ln in fh if ln.strip()]
    trace = []
    for lineno, ln in enumerate(lines, 1):
        try:
            rec = json.loads(ln)
        except json.JSONDecodeError as e:
            raise ValueError(f"bad JSON on requests line {lineno}: {e}")
        if "src_ids" in rec:
            src_ids = [int(t) for t in rec["src_ids"]]
        elif "text" in rec:
            if bpe is None:
                raise ValueError(
                    f"requests line {lineno} has \"text\" but no --vocab")
            src_ids = bpe.encode(rec["text"]) + [EOS_ID]
        else:
            raise ValueError(
                f"requests line {lineno} has neither \"src_ids\" nor "
                f"\"text\"")
        trace.append({"src_ids": src_ids, "line": ln.strip(),
                      "rec": rec})
    return trace, bpe


def _fleet_build_replicas(args, n: int, specs=None, kv_block_size: int = 0):
    """N in-process engine replicas from the same checkpoint (fleet
    route / rollout), on the device ``--accelerator`` names. One load per
    replica — each engine owns its model — but the restored weights are
    identical by construction.
    ``specs`` (a [(name, phase)] list) builds a disaggregated topology
    instead of N co-located replicas; the phases require the paged path,
    so pass ``kv_block_size`` with them."""
    from ..fleet import EngineReplica
    from ..serve.loader import load_engine

    replicas, at_step = [], None
    bpe = None
    radix = getattr(args, "radix_cache", False)
    if radix and kv_block_size == 0:
        # The radix cache lives on the paged KV path — co-located
        # route/rollout fleets default to dense rows, so arming it pulls
        # in the serve default block size.
        kv_block_size = 16
    roles = specs if specs is not None \
        else [(f"replica-{i}", "both") for i in range(n)]
    for name, phase in roles:
        cfg = apply_overrides(get_preset(args.preset), args.overrides)
        cfg.stack.accelerator = args.accelerator
        engine, bpe, at_step = load_engine(
            cfg, capacity=args.slots,
            default_max_new_tokens=args.max_new_tokens,
            decode_window=args.decode_window,
            kv_block_size=kv_block_size,
            speculate_gamma=getattr(args, "speculate", 0),
            speculate_device=getattr(args, "speculate_device", False),
            quantize=getattr(args, "quantize", ""),
            kv_quant=getattr(args, "kv_quant", ""),
            radix_cache=radix and phase == "both",
            phase=phase,
            prefill_chunk=getattr(args, "prefill_chunk", 0)
            if phase == "both" else 0,
            vocab=args.vocab, allow_init=args.allow_init,
            device=args.accelerator)
        replicas.append(EngineReplica(name, engine))
    return replicas, bpe, at_step


def _fleet_route_trace(router, trace, args):
    """Submit the whole trace through the router with backpressure and
    drain; returns the ordered logical request ids."""
    from ..serve import OverloadError

    rids = []
    for item in trace:
        rec = item["rec"]
        kwargs = dict(
            max_new_tokens=int(rec.get("max_new_tokens",
                                       args.max_new_tokens)),
            beam_size=int(rec.get("beam_size", 1)),
            request_id=rec.get("id"),
        )
        if rec.get("deadline_s") is not None:
            kwargs["deadline_s"] = float(rec["deadline_s"])
        # Per-request QoS tags ride in the trace line itself
        # ({"tenant": ..., "qos_class": ...}); untagged lines keep the
        # exact pre-QoS submit shape.
        for key in ("tenant", "qos_class"):
            if rec.get(key) is not None:
                kwargs[key] = str(rec[key])
        while True:
            try:
                rids.append(router.submit(item["src_ids"], **kwargs))
                break
            except OverloadError:
                if not router.step():
                    raise
    return rids


def _fleet_print_results(router, rids, bpe):
    import numpy as np

    from ..models.decoding import strip_special

    for rid in rids:
        out = router.result(rid)
        out["tokens"] = [int(t) for t in strip_special(out["tokens"])]
        if bpe is not None:
            out["text"] = bpe.decode(np.asarray(out["tokens"], np.int32))
        print(json.dumps(out), flush=True)


def _fleet_up_disagg(args) -> int:
    """--prefill/--decode: in-process phase-split fleet behind the
    phase-aware router (the KV handoff is an in-memory block transfer,
    so the phases share one process where the co-located default runs
    one supervised child per replica). Writes the standard fleet
    run-root layout — one role-named run dir per replica plus
    router.jsonl — so `fleet status` and `obs summarize --fleet` read
    the per-phase fleet like any other."""
    from ..fleet import Router
    from ..metrics.jsonl import MetricsWriter
    from ..obs.report import render_fleet_report, summarize_fleet
    from ..obs.sinks import JsonlSink

    if args.prefill < 1 or args.decode < 1:
        print("[dlcfn-tpu] a disaggregated fleet needs BOTH --prefill "
              ">= 1 and --decode >= 1", file=sys.stderr)
        return 2
    if getattr(args, "radix_cache", False):
        print("[dlcfn-tpu] --radix-cache needs co-located replicas — a "
              "phase-split stream never owns a reusable finished block "
              "table", file=sys.stderr)
        return 2
    cfg = apply_overrides(get_preset(args.preset), args.overrides)
    cfg.stack.accelerator = args.accelerator
    run_root = args.run_root or os.path.join(
        cfg.workdir, args.preset, "fleet")
    os.makedirs(run_root, exist_ok=True)
    specs = [(f"prefill-{i}", "prefill") for i in range(args.prefill)] \
        + [(f"decode-{i}", "decode") for i in range(args.decode)]
    try:
        replicas, bpe, at_step = _fleet_build_replicas(
            args, len(specs), specs=specs,
            kv_block_size=args.kv_block_size)
        trace, bpe2 = _fleet_read_trace(args.requests, args.vocab)
    except (FileNotFoundError, ValueError, OSError, RuntimeError) as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 1
    bpe = bpe or bpe2
    if at_step == -1:
        print("[dlcfn-tpu] WARNING: fleet serving RANDOM weights "
              "(--allow-init) — smoke mode only", file=sys.stderr)
    router = Router(replicas, policy=args.policy)
    writers = []
    router_writer = MetricsWriter(os.path.join(run_root, "router.jsonl"),
                                  also_stdout=False, all_processes=True)
    writers.append(router_writer)
    router.trace_sink = JsonlSink(router_writer)
    rep_writers = {}
    for rep in replicas:
        os.makedirs(os.path.join(run_root, rep.id), exist_ok=True)
        w = MetricsWriter(os.path.join(run_root, rep.id, "metrics.jsonl"),
                          also_stdout=False, all_processes=True)
        writers.append(w)
        rep_writers[rep.id] = w
        rep.trace_sink = JsonlSink(w)
    print(f"[dlcfn-tpu] fleet up (disaggregated): {args.prefill} "
          f"prefill + {args.decode} decode replica(s), "
          f"{len(trace)} request(s), run root {run_root}",
          file=sys.stderr)
    rids = _fleet_route_trace(router, trace, args)
    router.run_until_drained()
    _fleet_print_results(router, rids, bpe)
    stats = router.stats()
    for rep in replicas:
        rep.engine.metrics.emit(rep_writers[rep.id], replica=rep.id,
                                phase=rep.phase)
        rep.trace_sink = None
    router.trace_sink = None
    for w in writers:
        w.close()
    print(f"[dlcfn-tpu] fleet drained: {len(rids)} request(s), "
          f"{stats['handoffs']} handoff(s) "
          f"({stats['handoff_bytes']} bytes on the wire), "
          f"dropped {stats['dropped_requests']}", file=sys.stderr)
    try:
        print(render_fleet_report(summarize_fleet(run_root)))
    except FileNotFoundError:
        pass
    return 0 if stats["dropped_requests"] == 0 else 1


def _fleet_up_net(args) -> int:
    """--net: `fleet up` over REAL socket-backed replica servers
    (``python -m deeplearning_cfn_tpu_torch.net.server`` on the device
    ``--accelerator`` names), each spawned
    through a :class:`SupervisedSpawner` spec factory so every replica
    carries the launcher's hang-vs-crash restart budget and its own
    ``logs/launch.jsonl`` stream, then driven by the NetRouter over
    unix sockets. The children serve the seeded tiny-NMT recipe engine
    (not a preset checkpoint), so the trace must stay inside its
    vocab; prints one JSON result line per request like `fleet
    route`, and the per-replica run dirs feed `fleet status`."""
    from ..fleet.autoscale import SupervisedSpawner
    from ..fleet.router import NoReplicasError
    from ..net.bench import make_server_spec
    from ..net.client import RemoteReplica
    from ..net.router import NetRouter
    from ..net.server import TINY_VOCAB
    from ..serve import OverloadError

    cfg = apply_overrides(get_preset(args.preset), args.overrides)
    run_root = args.run_root or os.path.join(
        cfg.workdir, args.preset, "fleet")
    os.makedirs(run_root, exist_ok=True)
    try:
        trace, bpe = _fleet_read_trace(args.requests, args.vocab)
    except (OSError, ValueError) as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 1
    for item in trace:
        bad = [t for t in item["src_ids"]
               if t < 0 or t >= TINY_VOCAB]
        if bad:
            print(f"[dlcfn-tpu] ERROR: --net replicas serve the seeded "
                  f"tiny-NMT recipe (vocab {TINY_VOCAB}); request "
                  f"{item['rec'].get('id', '?')} has out-of-range "
                  f"token ids {bad[:4]}", file=sys.stderr)
            return 1
    warmup = trace[0]["src_ids"] if trace else ()
    src_len = max((len(item["src_ids"]) for item in trace), default=8)

    def spec_factory(phase, replica_id):
        run_dir = os.path.join(run_root, replica_id)
        os.makedirs(run_dir, exist_ok=True)
        spec, _ = make_server_spec(
            replica_id, run_dir, phase=phase, slots=args.slots,
            src_len=src_len, max_new_tokens=args.max_new_tokens,
            decode_window=args.decode_window, warmup_src=warmup,
            trace=True, accelerator=args.accelerator)
        return spec

    def replica_factory(phase, replica_id):
        addr = "unix://" + os.path.join(
            run_root, replica_id, "replica.sock")
        return RemoteReplica(replica_id, addr, phase=phase,
                             connect_retry_deadline_s=180.0)

    spawner = SupervisedSpawner(spec_factory, replica_factory,
                                max_restarts=args.max_restarts)

    class _PollAll:
        # NetRouter polls one supervisor per tick; the spawner holds
        # one single-spec supervisor per replica.
        def poll(self):
            for sup in spawner.supervisors.values():
                sup.poll()

    print(f"[dlcfn-tpu] fleet up --net: {args.replicas} replica "
          f"process(es), {len(trace)} request(s), run root {run_root}",
          file=sys.stderr)
    replicas = []
    try:
        for i in range(args.replicas):
            replicas.append(spawner.spawn("both", f"replica-{i}"))
        for r in replicas:
            r.connect()   # readiness barrier: built + warm
        router = NetRouter(replicas, supervisor=_PollAll(),
                           policy=args.policy)
        rids = []
        for item in trace:
            rec = item["rec"]
            kwargs = dict(
                max_new_tokens=int(rec.get("max_new_tokens",
                                           args.max_new_tokens)),
                beam_size=int(rec.get("beam_size", 1)),
                request_id=rec.get("id"))
            if rec.get("deadline_s") is not None:
                kwargs["deadline_s"] = float(rec["deadline_s"])
            for key in ("tenant", "qos_class"):
                if rec.get(key) is not None:
                    kwargs[key] = str(rec[key])
            while True:
                try:
                    rids.append(router.submit(item["src_ids"],
                                              **kwargs))
                    break
                except OverloadError:
                    # Remote children drain between ticks — zero
                    # observed progress is normal, not terminal.
                    router.step()
                    time.sleep(0.01)
                except NoReplicasError:
                    # Every replica is down at once: wait while a
                    # supervisor restarts one, give up when none will.
                    if not any(state == "running"
                               for sup in spawner.supervisors.values()
                               for state in sup.status_states().values()):
                        raise
                    router.step()
                    time.sleep(0.01)
        router.run_until_drained(
            idle_timeout_s=max(args.timeout, 60.0))
        _fleet_print_results(router, rids, bpe)
        for r in replicas:
            try:
                r.drain()
            except Exception:
                pass
        dropped = router.dropped_requests
        print(f"[dlcfn-tpu] fleet up --net drained: "
              f"dropped_requests={dropped}", file=sys.stderr)
        return 0 if dropped == 0 else 1
    finally:
        for r in replicas:
            r.close()
        spawner.close()


def _cmd_fleet_up(args) -> int:
    """Run N serve child processes over a sharded request trace, each in
    its own run dir under --run-root, supervised with hang-vs-crash
    classification and bounded restart; prints the fleet report when
    every replica drains. --prefill/--decode switches to the
    disaggregated in-process topology instead."""
    from ..fleet import ReplicaProcSpec, ReplicaSupervisor
    from ..obs.report import render_fleet_report, summarize_fleet

    if getattr(args, "net", False):
        if getattr(args, "prefill", 0) or getattr(args, "decode", 0):
            print("[dlcfn-tpu] --net spawns co-located server "
                  "processes — drop --prefill/--decode (the process "
                  "fleet's disagg topology lives in `bench --fleet "
                  "--net`)", file=sys.stderr)
            return 2
        return _fleet_up_net(args)
    if getattr(args, "prefill", 0) or getattr(args, "decode", 0):
        return _fleet_up_disagg(args)
    cfg = apply_overrides(get_preset(args.preset), args.overrides)
    cfg.stack.accelerator = args.accelerator
    try:
        with open(args.requests) as fh:
            lines = [ln for ln in fh if ln.strip()]
    except OSError as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 1
    run_root = args.run_root or os.path.join(
        cfg.workdir, args.preset, "fleet")
    os.makedirs(run_root, exist_ok=True)
    specs = []
    for i in range(args.replicas):
        run_dir = os.path.join(run_root, f"replica-{i}")
        os.makedirs(run_dir, exist_ok=True)
        # .json, not .jsonl: the run dir's *.jsonl files are the obs
        # streams (`obs summarize` globs them) — the input shard is not
        # a metrics stream.
        shard_path = os.path.join(run_dir, "requests.json")
        # Round-robin sharding: deterministic, and every replica gets a
        # representative slice of the trace.
        with open(shard_path, "w") as fh:
            for ln in lines[i::args.replicas]:
                fh.write(ln if ln.endswith("\n") else ln + "\n")
        argv = [sys.executable, "-m", "deeplearning_cfn_tpu_torch.cli",
                "serve",
                "--preset", args.preset,
                "--requests", shard_path,
                "--metrics-path", os.path.join(run_dir, "metrics.jsonl"),
                "--slots", str(args.slots),
                "--max-new-tokens", str(args.max_new_tokens),
                "--decode-window", str(args.decode_window),
                "--emit-every", str(args.emit_every)]
        if getattr(args, "speculate", 0):
            argv += ["--speculate", str(args.speculate)]
        if getattr(args, "speculate_device", False):
            argv += ["--speculate-device"]
        if getattr(args, "quantize", ""):
            argv += ["--quantize", args.quantize]
        if getattr(args, "kv_quant", ""):
            argv += ["--kv-quant", args.kv_quant]
        if getattr(args, "radix_cache", False):
            argv += ["--radix-cache"]
        if getattr(args, "prefill_chunk", 0):
            argv += ["--prefill-chunk", str(args.prefill_chunk)]
        argv += ["--accelerator", args.accelerator]
        if args.vocab:
            argv += ["--vocab", args.vocab]
        if args.allow_init:
            argv += ["--allow-init"]
        argv += list(args.overrides)
        specs.append(ReplicaProcSpec(
            replica_id=f"replica-{i}", argv=argv, run_dir=run_dir))
    sup = ReplicaSupervisor(specs, max_restarts=args.max_restarts)
    print(f"[dlcfn-tpu] fleet up: {args.replicas} replica(s), "
          f"{len(lines)} request(s), run root {run_root}",
          file=sys.stderr)
    sup.start()
    try:
        all_ok = sup.wait(timeout_s=args.timeout or None)
    except KeyboardInterrupt:
        sup.terminate()
        sup.close()
        return 1
    if not all_ok:
        sup.terminate()
    sup.close()
    for row in sup.status():
        print(f"[dlcfn-tpu] {row['replica']}: {row['state']} "
              f"(attempts: {row['attempt'] + 1}, "
              f"outcomes: {','.join(row['outcomes']) or '-'})",
              file=sys.stderr)
    try:
        print(render_fleet_report(summarize_fleet(run_root)))
    except FileNotFoundError:
        pass
    return 0 if all_ok else 1


def _cmd_fleet_route(args) -> int:
    """In-process fleet: N engine replicas from one checkpoint behind
    the router; routes a JSONL trace through the chosen policy and
    prints one result line per request plus the fleet stats."""
    from ..fleet import Router

    try:
        replicas, bpe, at_step = _fleet_build_replicas(args, args.replicas)
        trace, bpe2 = _fleet_read_trace(args.requests, args.vocab)
    except (FileNotFoundError, ValueError, OSError, RuntimeError) as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 1
    bpe = bpe or bpe2
    if at_step == -1:
        print("[dlcfn-tpu] WARNING: fleet serving RANDOM weights "
              "(--allow-init) — smoke mode only", file=sys.stderr)
    router = Router(replicas, policy=args.policy)
    rids = _fleet_route_trace(router, trace, args)
    router.run_until_drained()
    _fleet_print_results(router, rids, bpe)
    stats = router.stats()
    print(f"[dlcfn-tpu] fleet drained: {len(rids)} request(s) over "
          f"{len(replicas)} replica(s), policy {router.policy.name}, "
          f"dropped {stats['dropped_requests']}, "
          f"routed " + ", ".join(
              f"{rid}={s['routed']}"
              for rid, s in stats["replicas"].items()), file=sys.stderr)
    return 0 if stats["dropped_requests"] == 0 else 1


def _cmd_fleet_rollout(args) -> int:
    """Rolling checkpoint upgrade while serving: routes the trace,
    upgrades every replica to --to-step mid-stream (drain → swap →
    probe → readmit), keeps serving, and verifies zero drops."""
    from ..fleet import Router, restore_swap_variables, rolling_upgrade

    try:
        replicas, bpe, at_step = _fleet_build_replicas(args, args.replicas)
        trace, bpe2 = _fleet_read_trace(args.requests, args.vocab)
        cfg = apply_overrides(get_preset(args.preset), args.overrides)
        cfg.stack.accelerator = args.accelerator
        variables, to_step = restore_swap_variables(cfg, step=args.to_step)
    except (FileNotFoundError, ValueError, OSError, RuntimeError) as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 1
    bpe = bpe or bpe2
    router = Router(replicas, policy=args.policy)
    # Submit the first half, upgrade mid-stream, submit the rest — the
    # CLI shape of the end-to-end rolling-upgrade contract.
    half = max(1, len(trace) // 2)
    rids = _fleet_route_trace(router, trace[:half], args)
    print(f"[dlcfn-tpu] rolling upgrade: step {at_step} -> {to_step} "
          f"({len(replicas)} replica(s), one at a time)", file=sys.stderr)
    report = rolling_upgrade(router, variables)
    rids += _fleet_route_trace(router, trace[half:], args)
    router.run_until_drained()
    _fleet_print_results(router, rids, bpe)
    stats = router.stats()
    rep = report.to_dict()
    print(f"[dlcfn-tpu] rollout {'OK' if rep['ok'] else 'FAILED'}: "
          f"upgraded {len(rep['upgraded'])}/{len(replicas)}, "
          f"dropped {stats['dropped_requests']}, "
          f"evacuations {stats['evacuations']}", file=sys.stderr)
    return 0 if rep["ok"] and stats["dropped_requests"] == 0 else 1


def _cmd_fleet_status(args) -> int:
    """Fleet-wide one-line status + per-replica report over a directory
    of per-replica run dirs (the `fleet up` run root)."""
    from ..obs.report import render_fleet_report, summarize_fleet

    try:
        summary = summarize_fleet(args.run_root)
    except (FileNotFoundError, OSError) as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(summary))
    else:
        print(render_fleet_report(summary))
    if summary["source"]["replicas"] == 0:
        print(f"[dlcfn-tpu] no replica run dirs under {args.run_root}",
              file=sys.stderr)
        return 1
    return 0


def _cmd_doctor(args) -> int:
    """Preflight: the reference-era 'verify drivers / EFA provider' role.
    Every check prints one line with a wall-clock timestamp so a hang is
    attributable to an exact stage (the JAX package's stages, with torch
    and CUDA in place of jax and its backend)."""
    import time as _time

    t0 = _time.monotonic()
    ok = True

    def report(name, good, detail=""):
        nonlocal ok
        ok &= bool(good)
        mark = "ok" if good else "FAIL"
        print(f"[doctor t=+{_time.monotonic() - t0:5.1f}s] "
              f"{name}: {mark}{' — ' + detail if detail else ''}",
              flush=True)

    # 1. Package + presets resolve.
    try:
        names = list_presets()
        for name in names:
            get_preset(name)
        report("presets", True, f"{len(names)} presets resolve")
    except Exception as e:
        report("presets", False, repr(e))

    # 2. Native data loader builds (or degrades cleanly).
    try:
        from .. import dataio

        if dataio.available():
            report("native-loader", True, "dataio.so built and loadable")
        else:
            report("native-loader", True,
                   "unavailable; Python fallback active (no g++?)")
    except Exception as e:
        report("native-loader", False, repr(e))

    # 3. The card: import → init → devices, stage by stage.
    if args.skip_backend:
        report("backend", True, "skipped on request")
    else:
        try:
            import torch

            report("torch-import", True,
                   f"torch {torch.__version__}, CUDA {torch.version.cuda}")
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA card: torch.cuda.is_available() "
                                   "is False")
            torch.cuda.init()  # the stage that hangs on a bad driver
            n = torch.cuda.device_count()
            kinds = sorted({torch.cuda.get_device_name(i)
                            for i in range(n)})
            report("backend-init", True,
                   f"{n} device(s): {', '.join(kinds)}")
            x = torch.ones((128, 128), device="cuda")
            val = float((x @ x).sum())  # executes + syncs one real program
            report("device-exec", val == 128.0 * 128 * 128,
                   f"matmul sum={val:.0f}")
            free, total = torch.cuda.mem_get_info()
            report("hbm", True,
                   f"{(total - free) / 2**30:.2f} / {total / 2**30:.2f} "
                   f"GiB in use")
            from ..parallel.mesh import build_mesh, describe
            from ..train.run import _describe

            mesh = build_mesh()
            report("mesh", True,
                   f"{describe(mesh)}; {_describe(torch.device('cuda', 0))}")
        except Exception as e:
            report("backend", False, repr(e))

    print(f"[doctor] {'all checks passed' if ok else 'CHECKS FAILED'}")
    return 0 if ok else 1


def _cmd_metrics(args) -> int:
    """Operator's at-a-glance run summary from the JSONL stream."""
    path = args.path
    if os.path.isdir(path):
        path = os.path.join(path, "metrics.jsonl")
    if not os.path.exists(path):
        print(f"[dlcfn-tpu] ERROR: no metrics file at {path}",
              file=sys.stderr)
        return 1
    # Lenient parse: the writer is append-mode and tailed live, so a run
    # killed mid-write leaves a truncated last line — skip bad lines
    # (counted) instead of tracebacking on them.
    records, skipped = [], 0
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                skipped += 1
    train = [r for r in records if "examples_per_sec" in r]
    evals = [r for r in records
             if any(k.startswith("eval_") for k in r)]
    finals = [r for r in records
              if any(k.startswith("final_eval_") for k in r)]
    out = {"path": path, "records": len(records)}
    if skipped:
        out["skipped_malformed_lines"] = skipped
    if train:
        last = train[-1]
        out["last_step"] = last.get("step")
        out["last_loss"] = last.get("loss")
        rates = [r["examples_per_sec"] for r in train]
        out["mean_examples_per_sec"] = round(sum(rates) / len(rates), 2)
    if evals:
        accs = [(r.get("eval_accuracy"), r.get("step")) for r in evals
                if r.get("eval_accuracy") is not None]
        if accs:
            best = max(accs)
            out["best_eval_accuracy"] = best[0]
            out["best_eval_accuracy_step"] = best[1]
    if finals:
        out["final"] = {k: v for k, v in finals[-1].items()
                        if k.startswith("final_eval_")}
    print(json.dumps(out))
    return 0


def _cmd_obs_summarize(args) -> int:
    """Full run report (train + serve + spans + launch attempts) from a
    metrics.jsonl or a run directory — the obs subsystem's reporting verb.
    ``dlcfn-tpu metrics`` stays the quick one-line JSON summary; this one
    answers "what happened in this run"."""
    from ..obs.report import (render_fleet_report, render_report,
                              summarize, summarize_fleet)

    path = args.path
    if not os.path.exists(path):
        print(f"[dlcfn-tpu] ERROR: no metrics file or directory at {path}",
              file=sys.stderr)
        return 1
    if getattr(args, "fleet", False):
        try:
            summary = summarize_fleet(path)
        except (FileNotFoundError, OSError) as e:
            print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(summary))
        else:
            print(render_fleet_report(summary))
        if summary["source"]["replicas"] == 0:
            print(f"[dlcfn-tpu] no replica run dirs under {path}",
                  file=sys.stderr)
            return 1
        return 0
    try:
        summary = summarize(path, since_step=args.since_step)
    except OSError as e:
        print(f"[dlcfn-tpu] ERROR: cannot read {path}: {e}",
              file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(summary))
    else:
        print(render_report(summary))
    if summary["source"]["records"] == 0:
        print(f"[dlcfn-tpu] no JSONL records found under {path} "
              f"(empty run dir?)", file=sys.stderr)
        return 1
    return 0


def _cmd_obs_export(args) -> int:
    """JSONL streams → Chrome/Perfetto trace.json (load in
    ui.perfetto.dev or chrome://tracing)."""
    from ..obs.export import export_fleet_trace, export_trace

    path = args.path
    if not os.path.exists(path):
        print(f"[dlcfn-tpu] ERROR: no metrics file or directory at {path}",
              file=sys.stderr)
        return 1
    fleet = getattr(args, "fleet", False)
    if fleet and not os.path.isdir(path):
        print(f"[dlcfn-tpu] ERROR: --fleet needs a fleet trace "
              f"directory, got a file: {path}", file=sys.stderr)
        return 1
    out = args.out
    if not out:
        d = path if os.path.isdir(path) else os.path.dirname(path) or "."
        out = os.path.join(d, "trace.json")
    try:
        summary = export_fleet_trace(path, out) if fleet \
            else export_trace(path, out)
    except OSError as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 1
    for p in summary["problems"]:
        print(f"[dlcfn-tpu] WARNING: trace problem: {p}", file=sys.stderr)
    extra = (f", {summary['flow_events']} flow link(s) across "
             f"{len(summary['shards'])} shard(s)") if fleet else ""
    print(f"[dlcfn-tpu] wrote {summary['out']}: {summary['events']} "
          f"events ({summary['spans']} spans{extra}) from "
          f"{summary['records']} records — open in "
          f"https://ui.perfetto.dev")
    if summary["records"] == 0:
        print(f"[dlcfn-tpu] no JSONL records found under {path}",
              file=sys.stderr)
        return 1
    return 0


def _cmd_obs_check(args) -> int:
    """Evaluate SLO rules over a recorded run; rc=0 clean, rc=1 when any
    rule fired (the CI gate), rc=2 on unusable inputs."""
    from ..obs.slo import RuleError, check_run

    if not os.path.exists(args.path):
        print(f"[dlcfn-tpu] ERROR: no metrics file or directory at "
              f"{args.path}", file=sys.stderr)
        return 2
    try:
        result = check_run(args.path, args.rules)
    except (RuleError, OSError) as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(result))
    else:
        for a in result["alerts"]:
            print(f"ALERT {a['rule']}: {a.get('detail', '')}")
        state = "OK" if result["ok"] else "BREACH"
        print(f"[dlcfn-tpu] obs check {state}: {len(result['alerts'])} "
              f"alert(s) from {result['rules']} rule(s) over "
              f"{result['records']} records")
    return 0 if result["ok"] else 1


def _cmd_obs_diff(args) -> int:
    """Align two runs' metric series and report p50/p95 deltas; rc=1 when
    any shared metric regressed beyond --tolerance."""
    from ..obs.diff import diff_runs, render_diff

    for p in (args.run_a, args.run_b):
        if not os.path.exists(p):
            print(f"[dlcfn-tpu] ERROR: no metrics file or directory at "
                  f"{p}", file=sys.stderr)
            return 2
    try:
        report = diff_runs(args.run_a, args.run_b,
                           tolerance=args.tolerance)
    except OSError as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report))
    else:
        print(render_diff(report))
    return 0 if report["ok"] else 1


def _cmd_obs_tail(args) -> int:
    """Follow a live run's JSONL streams with a one-line status; optional
    --rules evaluates SLOs as records arrive."""
    from ..obs.tail import tail

    engine = None
    if args.rules:
        from ..obs.slo import RuleError, SloEngine
        try:
            engine = SloEngine.from_file(args.rules)
        except RuleError as e:
            print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
            return 2
    if getattr(args, "fleet", False) and not os.path.isdir(args.path):
        print(f"[dlcfn-tpu] ERROR: --fleet needs a directory of replica "
              f"run dirs, got {args.path}", file=sys.stderr)
        return 2
    try:
        return tail(args.path, interval_s=args.interval,
                    max_seconds=args.duration or None, once=args.once,
                    slo_engine=engine, fleet=getattr(args, "fleet", False))
    except KeyboardInterrupt:
        return 0


def _cmd_data_prepare_imagenet(args) -> int:
    from ..data.imagenet import prepare_imagenet

    index = prepare_imagenet(args.src, args.out, size=args.size,
                             shard_records=args.shard_records,
                             limit=args.limit or None)
    n = sum(s["num_records"] for s in index["shards"])
    print(f"[dlcfn-tpu] wrote {n} records in {len(index['shards'])} shards "
          f"({index['num_classes']} classes) to {args.out}")
    return 0


def _cmd_data_prepare_text(args) -> int:
    from ..data.text import prepare_lm_text

    try:
        info = prepare_lm_text(args.src, args.out, args.seq_len,
                               args.eval_fraction)
    except (OSError, ValueError) as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 1
    print(f"[dlcfn-tpu] wrote {info['train_examples']} train / "
          f"{info['eval_examples']} eval examples to {args.out}; train "
          f"with: --preset gpt_small_lm data.name=lm_text "
          f"data.data_dir={args.out} data.synthetic=false "
          f"data.vocab_size={info['vocab_size']} "
          f"data.seq_len={info['seq_len']}")
    return 0


def _cmd_data_prepare_coco(args) -> int:
    from ..data.coco import prepare_coco

    try:
        info = prepare_coco(args.annotations, args.images, args.out,
                            args.split, image_size=args.image_size,
                            max_boxes=args.max_boxes, limit=args.limit)
    except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 1
    print(f"[dlcfn-tpu] wrote {info['images']} images / {info['objects']} "
          f"objects to {args.out}/{args.split}.npz (skipped "
          f"{info['skipped_crowd']} crowds + "
          f"{info['skipped_degenerate']} degenerate, dropped "
          f"{info['dropped_over_max']} over max-boxes); train with: "
          f"--preset maskrcnn_coco data.data_dir={args.out} "
          f"data.synthetic=false data.image_size={info['image_size']} "
          f"model.kwargs.image_size={info['image_size']} "
          f"data.max_boxes={info['max_boxes']}")
    return 0


def _cmd_data_prepare_wikipedia(args) -> int:
    from ..data.text import prepare_mlm_text

    try:
        info = prepare_mlm_text(args.src, args.out, args.seq_len,
                                vocab_size=args.vocab_size,
                                eval_fraction=args.eval_fraction,
                                vocab_path=args.vocab, seed=args.seed)
    except (OSError, ValueError) as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 1
    print(f"[dlcfn-tpu] wrote {info['train_examples']} train / "
          f"{info['eval_examples']} eval examples to {args.out} "
          f"(vocab {info['vocab_size']}); train with: "
          f"--preset bert_base_wikipedia data.data_dir={args.out} "
          f"data.synthetic=false data.vocab_size={info['vocab_size']} "
          f"data.seq_len={info['seq_len']}")
    return 0


def _cmd_data_prepare_wmt(args) -> int:
    from ..data.text import prepare_nmt_text

    try:
        info = prepare_nmt_text(args.src, args.tgt, args.out, args.seq_len,
                                vocab_size=args.vocab_size,
                                eval_fraction=args.eval_fraction,
                                vocab_path=args.vocab)
    except (OSError, ValueError) as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 1
    print(f"[dlcfn-tpu] wrote {info['train_examples']} train / "
          f"{info['eval_examples']} eval pairs to {args.out} "
          f"(vocab {info['vocab_size']}, skipped {info['skipped_pairs']} "
          f"over-length); train with: --preset transformer_nmt_wmt "
          f"data.data_dir={args.out} data.synthetic=false "
          f"data.vocab_size={info['vocab_size']} "
          f"data.seq_len={info['seq_len']}")
    return 0


def _cmd_data_feed_rate(args) -> int:
    """Host-side input pipeline throughput: no device in the loop."""
    from ..data.imagenet import measure_feed_rate
    from ..data.pipeline import build_pipeline

    cfg = apply_overrides(get_preset(args.preset), args.overrides)
    if not any(o.startswith("data.prefetch=") for o in args.overrides):
        # Measure raw producer rate: a prefetch queue that starts full
        # would inflate the first `depth` timed batches.
        cfg.data.prefetch = 0
    pipe = build_pipeline(cfg.data, args.local_batch,
                          cfg.model.num_classes, seed=0, train=True)
    rate = measure_feed_rate(pipe, num_batches=args.batches)
    print(json.dumps({"metric": f"{args.preset}_feed_images_per_sec",
                      **{k: round(v, 2) for k, v in rate.items()}}))
    return 0


def _add_stack_args(p: argparse.ArgumentParser) -> None:
    defaults = StackConfig()
    p.add_argument("--state-dir", default=defaults.state_dir)


def _cmd_bench(args) -> int:
    """The JAX package's ``bench`` verb with its flags, guards (rc 2) and
    failures (rc 1: a speculative parity break, an int8 divergence past its
    bound, a failed process of a bench over several), on the device
    ``--accelerator`` names. On the card a verb that ran ends with one
    stderr line: the attention kernels' launches in this process, in all
    and by variant (a ``--net`` fleet's children and the processes of a
    bench over several count their own, each in its log)."""
    rc = _bench(args)
    if rc != 2 and args.accelerator == "gpu":
        from ..ops import attention as attn

        kernels = {"flash_attn_fwd": attn.flash_attention_forward,
                   "flash_attn_bwd_dkdv": attn.flash_attn_bwd_dkdv,
                   "flash_attn_bwd_dq": attn.flash_attn_bwd_dq}
        launches = {name: fn.launches for name, fn in kernels.items()}
        launches["variants"] = {name: dict(fn.variant_launches)
                                for name, fn in kernels.items()}
        print(f"[dlcfn-tpu] bench kernel launches {json.dumps(launches)}",
              file=sys.stderr)
    return rc


def _bench(args) -> int:
    if getattr(args, "smoke", False) and not (
            getattr(args, "serve", False) or getattr(args, "fleet", False)):
        print("[dlcfn-tpu] --smoke is a serving-scenario mode — pass it "
              "with --serve or --fleet", file=sys.stderr)
        return 2
    if (getattr(args, "autoscale", False)
            or getattr(args, "trace", None)) \
            and not getattr(args, "fleet", False):
        print("[dlcfn-tpu] --trace/--autoscale are fleet-scenario flags — "
              "pass them with --fleet", file=sys.stderr)
        return 2
    if getattr(args, "radix_cache", False) \
            and not getattr(args, "fleet", False):
        print("[dlcfn-tpu] --radix-cache is a fleet-scenario flag — pass "
              "it with --fleet", file=sys.stderr)
        return 2
    if (getattr(args, "chaos_plan", None)
            or getattr(args, "degrade", False)) \
            and not getattr(args, "fleet", False):
        print("[dlcfn-tpu] --chaos-plan/--degrade are fleet-scenario "
              "flags — pass them with --fleet", file=sys.stderr)
        return 2
    if getattr(args, "radix_cache", False) \
            and (getattr(args, "fleet_prefill", 0)
                 or getattr(args, "fleet_decode", 0)):
        print("[dlcfn-tpu] --radix-cache needs co-located replicas — a "
              "phase-split stream never owns a reusable finished block "
              "table (drop --fleet-prefill/--fleet-decode)",
              file=sys.stderr)
        return 2
    if getattr(args, "prefill_chunk", 0) \
            and (getattr(args, "fleet_prefill", 0)
                 or getattr(args, "fleet_decode", 0)):
        print("[dlcfn-tpu] --prefill-chunk is the co-located answer to "
              "prefill-induced decode stall — disaggregated phases "
              "already split prefill off the decode tick (drop "
              "--fleet-prefill/--fleet-decode)", file=sys.stderr)
        return 2
    if getattr(args, "net", False) and not getattr(args, "fleet", False):
        print("[dlcfn-tpu] --net is a fleet-scenario flag — pass it "
              "with --fleet", file=sys.stderr)
        return 2
    if getattr(args, "fleet", False):
        if getattr(args, "ops", None) or args.collectives or \
                getattr(args, "sweep_batches", None) or \
                getattr(args, "serve", False):
            print("[dlcfn-tpu] --fleet is its own scenario — don't combine "
                  "with --serve/--ops/--collectives/--sweep-batches",
                  file=sys.stderr)
            return 2
        if getattr(args, "net", False):
            # Real child processes over unix sockets — the wall-clock
            # fleet record (bench --fleet without --net stays the
            # in-process simulation).
            if getattr(args, "trace", None) or args.chaos_plan or \
                    args.degrade or args.radix_cache or \
                    getattr(args, "prefill_chunk", 0) or \
                    args.trace_mix != "uniform":
                print("[dlcfn-tpu] --net runs the process-fleet record "
                      "— --trace/--trace-mix/--chaos-plan/--degrade/"
                      "--radix-cache/--prefill-chunk are in-process "
                      "scenario flags", file=sys.stderr)
                return 2
            import tempfile

            from ..net.bench import run_net_fleet_bench

            run_root = tempfile.mkdtemp(prefix="dlcfn-netbench-")
            line = run_net_fleet_bench(
                run_root,
                smoke=args.smoke,
                accelerator=args.accelerator,
                replicas=args.fleet_replicas,
                num_requests=args.requests_count,
                slots=args.slots,
                decode_window=args.decode_window,
                policy=args.fleet_policy,
                disagg=True,
                chaos_kill=bool(args.fleet_chaos_step),
                autoscale=args.autoscale,
                trace_dir=args.fleet_trace_dir or "")
            print(json.dumps(line))
            return 0
        if getattr(args, "autoscale", False) and not args.trace:
            print("[dlcfn-tpu] --autoscale needs --trace (the controller "
                  "runs on the open-loop replay clock)", file=sys.stderr)
            return 2
        from ..fleet.bench import run_fleet_bench

        line = run_fleet_bench(replicas=args.fleet_replicas,
                               num_requests=args.requests_count,
                               slots=args.slots,
                               decode_window=args.decode_window,
                               policy=args.fleet_policy,
                               chaos_kill_step=args.fleet_chaos_step,
                               smoke=args.smoke,
                               trace_dir=args.fleet_trace_dir,
                               prefill_replicas=args.fleet_prefill,
                               decode_replicas=args.fleet_decode,
                               trace_mix=args.trace_mix,
                               speculate=args.speculate,
                               speculate_device=args.speculate_device,
                               kv_quant=args.kv_quant,
                               radix=args.radix_cache,
                               trace_spec=args.trace,
                               autoscale=args.autoscale,
                               min_replicas=args.min_replicas,
                               max_replicas=args.max_replicas,
                               prefill_chunk=getattr(
                                   args, "prefill_chunk", 0),
                               chaos_plan=args.chaos_plan,
                               degrade=args.degrade,
                               accelerator=args.accelerator)
        print(json.dumps(line))
        return 0
    if getattr(args, "obs_smoke", False):
        from ..bench import run_obs_overhead_smoke

        return _bench_over_processes(args, lambda: [run_obs_overhead_smoke(
            preset=args.preset, steps=args.steps,
            global_batch=args.global_batch, accelerator=args.accelerator)])
    if getattr(args, "serve", False):
        if getattr(args, "ops", None) or args.collectives or \
                getattr(args, "sweep_batches", None):
            print("[dlcfn-tpu] --serve is its own scenario — don't combine "
                  "with --ops/--collectives/--sweep-batches",
                  file=sys.stderr)
            return 2
        from ..serve.bench import run_serve_bench

        line = run_serve_bench(num_requests=args.requests_count,
                               slots=args.slots, beam_size=args.beam_size,
                               decode_window=args.decode_window,
                               kv_block_size=args.kv_block_size,
                               kv_blocks=args.kv_blocks,
                               prefix_cache=args.prefix_cache,
                               prefix_dup=args.prefix_dup,
                               speculate=args.speculate,
                               speculate_device=args.speculate_device,
                               draft=args.draft,
                               quantize=args.quantize,
                               kv_quant=args.kv_quant,
                               smoke=args.smoke,
                               accelerator=args.accelerator)
        print(json.dumps(line))
        # The speculative contract is token-identity with plain greedy;
        # a parity break is a correctness bug, not a perf datapoint —
        # fail the run so a gate can rely on the exit code.
        if line.get("token_identical") is False:
            print("[dlcfn-tpu] speculative decode broke greedy token "
                  "parity", file=sys.stderr)
            return 1
        if line.get("divergence_ok") is False:
            print("[dlcfn-tpu] int8 logits divergence exceeded the "
                  "bound", file=sys.stderr)
            return 1
        if line.get("kv_divergence_ok") is False:
            print("[dlcfn-tpu] int8 KV-cache logits divergence exceeded "
                  "the bound", file=sys.stderr)
            return 1
        return 0
    if getattr(args, "sweep_batches", None):
        if getattr(args, "ops", None) or args.collectives:
            print("[dlcfn-tpu] --sweep-batches only applies to the "
                  "training-step bench (not --ops/--collectives)",
                  file=sys.stderr)
            return 2
        if args.global_batch:
            print("[dlcfn-tpu] pass either --sweep-batches or "
                  "--global-batch, not both", file=sys.stderr)
            return 2
    if getattr(args, "ops", None):
        from ..opsbench import main as opsbench_main

        ops_argv = ["--suite", args.ops, "--steps", str(args.steps),
                    "--accelerator", args.accelerator]
        if args.global_batch:
            ops_argv += ["--batch", str(args.global_batch)]
        opsbench_main(ops_argv)
        return 0
    if args.collectives:
        # The nccl-tests role: psum/all-gather/ppermute/reduce-scatter bus
        # bandwidth over this host's processes (one per card, as the JAX
        # bench runs over every local device), one JSON line per op from
        # run_collectives_bench in process 0.
        from ..parallel.collectives_bench import main as collectives_main

        return collectives_main(
            ["--size-mb", str(args.size_mb), "--accelerator",
             args.accelerator] + ([] if args.processes is None
                                  else ["--processes", str(args.processes)]))
    from ..bench import run_bench

    if getattr(args, "sweep_batches", None):
        # Batch-size tuning table (how BASELINE.md's 512-vs-1024 row was
        # found): one JSON line per global batch, same process so later
        # sizes reuse the warm backend.
        try:
            batches = [int(b) for b in args.sweep_batches.split(",") if b]
        except ValueError:
            print(f"[dlcfn-tpu] bad --sweep-batches {args.sweep_batches!r}: "
                  "expected comma-separated integers, e.g. 256,512,768",
                  file=sys.stderr)
            return 2
        if not batches or any(b <= 0 for b in batches):
            print("[dlcfn-tpu] --sweep-batches values must be positive "
                  "integers", file=sys.stderr)
            return 2
        return _bench_over_processes(args, lambda: (
            run_bench(preset=args.preset, steps=args.steps, global_batch=gb,
                      include_input=args.with_input,
                      step_window=args.step_window,
                      accelerator=args.accelerator) for gb in batches))
    return _bench_over_processes(args, lambda: [run_bench(
        preset=args.preset, steps=args.steps,
        global_batch=args.global_batch, include_input=args.with_input,
        step_window=args.step_window, accelerator=args.accelerator)])


def _bench_over_processes(args, records) -> int:
    """Print each record of ``records()`` as one JSON line as it is made,
    over this host's processes, as the JAX verb runs one process over every
    local device: ``--processes`` of them, by default one per card (one on
    the CPU; on a one-card host the bench runs in this process). Each
    process of the job is a ``cli bench`` of its own in the process group
    (``runtime.cluster.initialize``), and process 0 prints the records."""
    from ..runtime.cluster import current_cluster, initialize, \
        local_processes

    if current_cluster() is None:
        processes, cards = local_processes(args.processes, args.accelerator)
        if processes > 1:
            return _bench_job(args, processes, cards)
    spec = initialize(accelerator=args.accelerator)
    for record in records():
        if spec.process_id == 0:
            print(json.dumps(record), flush=True)
    if spec.is_multi_host:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    return 0


def _bench_job(args, processes: int, cards: int) -> int:
    """The bench as ``processes`` processes of this host through the
    launcher (NCCL when the ``cards`` cover them, else gloo), process 0's
    log streaming to stderr; then process 0's records on stdout, as one
    process prints them. A process that fails fails the verb (rc 1),
    naming its log; the others are stopped and print nothing."""
    import tempfile

    from ..launch import run_local

    argv = [sys.executable, "-m", "deeplearning_cfn_tpu_torch.cli", "bench",
            "--preset", args.preset, "--steps", str(args.steps),
            "--global-batch", str(args.global_batch),
            "--step-window", str(args.step_window),
            "--accelerator", args.accelerator]
    argv += ["--with-input"] if args.with_input else []
    argv += ["--obs-smoke"] if args.obs_smoke else []
    if args.sweep_batches:
        argv += ["--sweep-batches", args.sweep_batches]
    log_dir = tempfile.mkdtemp(prefix="dlcfn-bench-")
    failed: List[int] = []
    result = run_local(argv, processes, cards, log_dir,
                       on_failure=lambda i, host: failed.append(i),
                       tail_stream=sys.stderr)
    log = lambda i: os.path.join(log_dir, f"attempt0-host{i}.log")
    if not result.success:
        for i in failed or [i for i, c in enumerate(result.exit_codes)
                            if c != 0]:
            print(f"[dlcfn-tpu] bench process {i} of {processes} FAILED "
                  f"(exit code {result.exit_codes[i]}; its log: {log(i)})",
                  file=sys.stderr)
        return 1
    print(f"[dlcfn-tpu] bench on {processes} processes finished (logs in "
          f"{log_dir})", file=sys.stderr)
    with open(log(0), errors="replace") as fh:
        for line in fh:
            if line.startswith("{"):
                print(line.rstrip("\n"), flush=True)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m deeplearning_cfn_tpu_torch.cli",
        description="PyTorch/CUDA port of dlcfn-tpu: stack create → train "
                    "(locally or on a stack), eval, generate, serve, and "
                    "the operator verbs")
    sub = parser.add_subparsers(dest="command", required=True)

    # stack ------------------------------------------------------------------
    stack = sub.add_parser("stack", help="cluster lifecycle")
    ssub = stack.add_subparsers(dest="stack_command", required=True)

    defaults = StackConfig()
    sc = ssub.add_parser("create", help="create a TPU pod-slice stack")
    sc.add_argument("--name", default=defaults.name)
    sc.add_argument("--slice-type", default=defaults.slice_type)
    sc.add_argument("--zone", default=defaults.zone)
    sc.add_argument("--project", default=defaults.project)
    sc.add_argument("--runtime-version", default=defaults.runtime_version)
    sc.add_argument("--accelerator", default=defaults.accelerator,
                    choices=["tpu", "cpu"])
    sc.add_argument("--preemptible", action="store_true")
    sc.add_argument("--provisioner", default=defaults.provisioner,
                    choices=["auto", "gcp", "dryrun"])
    sc.add_argument("--create-timeout-s", type=int,
                    default=defaults.create_timeout_s)
    _add_stack_args(sc)
    sc.set_defaults(fn=_cmd_stack_create)

    sr = ssub.add_parser(
        "resize",
        help="scale a stack to a new slice type (delete + recreate; "
             "training resumes from the last checkpoint on relaunch)")
    sr.add_argument("name")
    sr.add_argument("--slice", required=True, dest="slice_type",
                    help="new slice type, e.g. v5p-16")
    _add_stack_args(sr)
    sr.set_defaults(fn=_cmd_stack_resize)

    sd = ssub.add_parser("delete", help="delete a stack")
    sd.add_argument("name")
    _add_stack_args(sd)
    sd.set_defaults(fn=_cmd_stack_delete)

    st = ssub.add_parser("status", help="describe a stack")
    st.add_argument("name")
    _add_stack_args(st)
    st.set_defaults(fn=_cmd_stack_status)

    sl = ssub.add_parser("list", help="list stacks")
    _add_stack_args(sl)
    sl.set_defaults(fn=_cmd_stack_list)

    # train ------------------------------------------------------------------
    tr = sub.add_parser("train", help="train a preset (locally or on a stack)")
    tr.add_argument("--preset", required=True)
    tr.add_argument("--stack", default="",
                    help="stack name to fan out to (empty = this host only)")
    tr.add_argument("--accelerator", default="gpu", choices=["gpu", "cpu"])
    tr.add_argument("--max-steps", type=int, default=None)
    tr.add_argument("--max-restarts", type=int, default=2)
    tr.add_argument("--processes", type=int, default=None,
                    help="processes on this host without --stack (default: "
                         "one per CUDA card, 1 on the CPU); the counterpart "
                         "of the JAX package's forced host device count on "
                         "the CPU. More than the cards share them over "
                         "gloo, fewer take the first cards")
    tr.add_argument("overrides", nargs="*",
                    help="config overrides, e.g. train.global_batch=256")
    _add_stack_args(tr)
    tr.set_defaults(fn=_cmd_train)
    ev = sub.add_parser(
        "eval",
        help="evaluate a trained checkpoint (full weighted eval + the "
             "workload's acceptance metric) without training")
    ev.add_argument("--preset", required=True)
    ev.add_argument("--accelerator", default="gpu", choices=["gpu", "cpu"])
    ev.add_argument("--step", type=int, default=0,
                    help="committed checkpoint step (0 = latest)")
    ev.add_argument("overrides", nargs="*",
                    help="config overrides — at least the workdir the "
                         "training run used")
    ev.set_defaults(fn=_cmd_eval)
    gen = sub.add_parser(
        "generate",
        help="generate text from a trained causal-LM checkpoint "
             "(byte-level prompt in, KV-cached decoding out)")
    gen.add_argument("--preset", default="gpt_small_lm")
    gen.add_argument("--accelerator", default="gpu", choices=["gpu", "cpu"])
    gen.add_argument("--prompt", required=True,
                     help="prompt text (byte-level tokenized)")
    gen.add_argument("--max-new-tokens", type=int, default=128)
    gen.add_argument("--temperature", type=float, default=0.0,
                     help="0 = greedy")
    gen.add_argument("--top-k", type=int, default=0)
    gen.add_argument("--seed", type=int, default=0)
    gen.add_argument("--vocab", default="",
                     help="BPE vocab.json; default is the byte tokenizer")
    gen.add_argument("--step", type=int, default=0,
                     help="committed checkpoint step (0 = latest)")
    gen.add_argument("overrides", nargs="*",
                     help="config overrides — at least the workdir the "
                          "training run used")
    gen.set_defaults(fn=_cmd_generate)
    sv = sub.add_parser(
        "serve",
        help="continuous-batching inference over an NMT checkpoint "
             "(offline driver: JSONL requests in, completions out)")
    sv.add_argument("--preset", required=True)
    sv.add_argument("--accelerator", default="gpu", choices=["gpu", "cpu"])
    sv.add_argument("--requests", required=True,
                    help="JSONL request trace path, or - for stdin; each "
                         "line {\"text\": ...} or {\"src_ids\": [...]} "
                         "plus optional id/max_new_tokens/beam_size/"
                         "deadline_s/tenant/qos_class")
    sv.add_argument("--slots", type=int, default=4,
                    help="slot-table capacity (concurrent KV-cache rows)")
    sv.add_argument("--queue-depth", type=int, default=64,
                    help="bounded queue size; beyond it submits are "
                         "rejected (the driver drains and retries)")
    sv.add_argument("--max-new-tokens", type=int, default=64)
    sv.add_argument("--beam-size", type=int, default=1,
                    help="default beam width for requests that don't set "
                         "their own (1 = greedy)")
    sv.add_argument("--decode-window", type=int, default=4,
                    help="max fused greedy decode steps per tick when no "
                         "scheduling work is pending")
    sv.add_argument("--kv-block-size", type=int, default=16,
                    help="paged KV-cache block size in token positions; "
                         "must divide the model max_len (0 = dense per-"
                         "slot rows)")
    sv.add_argument("--kv-blocks", type=int, default=0,
                    help="paged KV pool size in blocks (0 = slots x "
                         "max_len worth plus the null sentinel)")
    sv.add_argument("--prefix-cache", type=int, default=32,
                    help="encoder prefix-cache entries, keyed on the "
                         "unpadded source tokens (0 = disabled)")
    sv.add_argument("--radix-cache", action="store_true",
                    help="radix token-prefix KV cache: finished greedy "
                         "streams' blocks are kept and shared with later "
                         "identical-source requests; needs "
                         "--kv-block-size > 0")
    sv.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: admission encodes this many "
                         "source tokens per engine tick (0 = one-shot "
                         "prefill; tokens unchanged)")
    sv.add_argument("--speculate", type=int, default=0,
                    help="speculative decoding: draft tokens proposed per "
                         "verify step (0 = off); self-draft unless --draft "
                         "— greedy output is token-identical either way")
    sv.add_argument("--speculate-device", action="store_true",
                    help="chain speculative windows on the device (one "
                         "host sync per chain; needs --speculate > 0)")
    sv.add_argument("--draft", default="",
                    help="committed distilled-draft preset for --speculate "
                         "(e.g. tiny-distilled; empty = self-draft)")
    sv.add_argument("--quantize", default="", choices=["", "int8"],
                    help="weight-only quantization for serving (int8 = "
                         "per-channel symmetric, ~4x smaller weights; "
                         "checkpoints stay fp32 on disk)")
    sv.add_argument("--kv-quant", default="", choices=["", "int8"],
                    help="paged KV-cache quantization: int8 block codes "
                         "+ per-block scales (~4x smaller KV pool, "
                         "bounded logits divergence; needs "
                         "--kv-block-size > 0)")
    sv.add_argument("--vocab", default="",
                    help="BPE vocab.json — required for \"text\" requests")
    sv.add_argument("--step", type=int, default=0,
                    help="committed checkpoint step (0 = latest)")
    sv.add_argument("--allow-init", action="store_true",
                    help="serve seeded random weights when no checkpoint "
                         "exists (smoke mode)")
    sv.add_argument("--metrics-path", default="",
                    help="append serve_* metrics records to this JSONL file")
    sv.add_argument("--emit-every", type=int, default=20,
                    help="metrics emission period in engine steps")
    sv.add_argument("overrides", nargs="*",
                    help="config overrides — at least the workdir the "
                         "training run used")
    sv.set_defaults(fn=_cmd_serve)

    # fleet ------------------------------------------------------------------
    fl = sub.add_parser(
        "fleet",
        help="multi-replica serving: supervised serve processes, request "
             "routing, rolling checkpoint upgrades")
    flsub = fl.add_subparsers(dest="fleet_command", required=True)

    def _add_fleet_engine_flags(p, requests_required=True):
        p.add_argument("--preset", required=True)
        p.add_argument("--accelerator", default="gpu",
                       choices=["gpu", "cpu"])
        p.add_argument("--requests", required=requests_required,
                       help="JSONL request trace path, or - for stdin "
                            "(same line format as `serve`)")
        p.add_argument("--replicas", type=int, default=2,
                       help="replica count (default 2)")
        p.add_argument("--slots", type=int, default=4,
                       help="per-replica slot-table capacity")
        p.add_argument("--max-new-tokens", type=int, default=64)
        p.add_argument("--decode-window", type=int, default=4,
                       help="fused decode steps per device call")
        p.add_argument("--speculate", type=int, default=0,
                       help="per-replica speculative decode draft depth "
                            "(0 = off; self-draft)")
        p.add_argument("--speculate-device", action="store_true",
                       help="per-replica device-resident speculative "
                            "chains (requires --speculate > 0)")
        p.add_argument("--quantize", default="", choices=["", "int8"],
                       help="per-replica weight-only quantization; "
                            "rolling upgrades re-quantize the incoming "
                            "fp32 checkpoint on swap")
        p.add_argument("--kv-quant", default="", choices=["", "int8"],
                       help="per-replica int8 paged KV cache (needs the "
                            "paged path; disagg topologies are paged "
                            "already)")
        p.add_argument("--radix-cache", action="store_true",
                       help="per-replica radix token-prefix KV cache "
                            "(forces the paged path; co-located "
                            "replicas only — pair with the "
                            "prefix_affinity policy to keep repeats on "
                            "one replica's cache)")
        p.add_argument("--prefill-chunk", type=int, default=0,
                       help="per-replica chunked prefill: admission "
                            "encode proceeds this many source tokens "
                            "per tick interleaved with decode "
                            "(co-located replicas only; 0 = one-shot)")
        p.add_argument("--vocab", default="",
                       help="BPE vocab.json — required for \"text\" "
                            "requests")
        p.add_argument("--allow-init", action="store_true",
                       help="serve random weights when no checkpoint "
                            "exists (smoke/CI mode)")

    flup = flsub.add_parser(
        "up",
        help="one command → serving fleet: N supervised serve child "
             "processes, the trace round-robin sharded across them, each "
             "replica writing metrics/launch streams to its own run dir; "
             "--prefill/--decode instead builds a disaggregated "
             "phase-split fleet (in-process, KV handoff between phases)")
    _add_fleet_engine_flags(flup)
    flup.add_argument("--prefill", type=int, default=0,
                      help="disaggregated topology: prefill replica "
                           "count (pair with --decode; replaces the "
                           "co-located --replicas processes with an "
                           "in-process phase-split fleet)")
    flup.add_argument("--decode", type=int, default=0,
                      help="disaggregated topology: decode replica count "
                           "(pair with --prefill)")
    flup.add_argument("--kv-block-size", type=int, default=16,
                      help="disaggregated topology: paged KV block size "
                           "(the handoff artifact is block-structured)")
    flup.add_argument("--policy", default="least_loaded",
                      choices=["least_loaded", "round_robin",
                               "prefix_affinity"],
                      help="disaggregated topology: routing policy")
    flup.add_argument("--run-root", default="",
                      help="fleet run root; per-replica run dirs are "
                           "created under it (default: <workdir>/<preset>"
                           "/fleet)")
    flup.add_argument("--net", action="store_true",
                      help="socket fleet: replica SERVER processes "
                           "(net/server.py children behind unix "
                           "sockets) spawned through SupervisedSpawner "
                           "spec factories and driven by the NetRouter "
                           "— requests stream over the wire instead of "
                           "being sharded into files; children serve "
                           "the seeded tiny-NMT recipe engine, so the "
                           "trace must stay inside its vocab")
    flup.add_argument("--max-restarts", type=int, default=1,
                      help="per-replica restart budget on hang/crash "
                           "(default 1)")
    flup.add_argument("--timeout", type=float, default=0.0,
                      help="give up after N seconds (default: wait "
                           "until every replica exits)")
    flup.add_argument("--emit-every", type=int, default=20,
                      help="per-replica metrics emission period in "
                           "engine steps")
    flup.add_argument("overrides", nargs="*",
                      help="config overrides, forwarded to every replica")
    flup.set_defaults(fn=_cmd_fleet_up)

    flrt = flsub.add_parser(
        "route",
        help="in-process fleet: N engine replicas from one checkpoint "
             "behind the router; one result line per request")
    _add_fleet_engine_flags(flrt)
    flrt.add_argument("--policy", default="least_loaded",
                      choices=["least_loaded", "round_robin",
                               "prefix_affinity"],
                      help="routing policy (prefix_affinity: rendezvous-"
                           "hash each request's cache-affinity key — "
                           "its leading source tokens — to a preferred "
                           "replica, least-loaded fallback)")
    flrt.add_argument("overrides", nargs="*",
                      help="config overrides — at least the workdir the "
                           "training run used")
    flrt.set_defaults(fn=_cmd_fleet_route)

    flro = flsub.add_parser(
        "rollout",
        help="rolling checkpoint upgrade while serving: drain → swap → "
             "probe → readmit, one replica at a time, zero dropped "
             "requests")
    _add_fleet_engine_flags(flro)
    flro.add_argument("--policy", default="least_loaded",
                      choices=["least_loaded", "round_robin",
                               "prefix_affinity"],
                      help="routing policy")
    flro.add_argument("--to-step", type=int, default=0,
                      help="committed checkpoint step to upgrade to "
                           "(0 = latest)")
    flro.add_argument("overrides", nargs="*",
                      help="config overrides — at least the workdir the "
                           "training run used")
    flro.set_defaults(fn=_cmd_fleet_rollout)

    flst = flsub.add_parser(
        "status",
        help="fleet-wide status over a run root of per-replica run dirs: "
             "total tokens/sec, worst p95, alert count, launch outcomes")
    flst.add_argument("run_root", help="fleet run root (from `fleet up`)")
    flst.add_argument("--json", action="store_true",
                      help="emit the aggregate summary as one JSON object")
    flst.set_defaults(fn=_cmd_fleet_status)

    # introspection ----------------------------------------------------------
    pr = sub.add_parser("presets", help="list training presets")
    pr.set_defaults(fn=_cmd_presets)

    co = sub.add_parser("config", help="print a preset's resolved config")
    co.add_argument("--preset", required=True)
    co.add_argument("overrides", nargs="*")
    co.set_defaults(fn=_cmd_show_config)

    inf = sub.add_parser("info", help="device / mesh info")
    inf.set_defaults(fn=_cmd_info)

    doc = sub.add_parser(
        "doctor",
        help="preflight checks: backend init (stage-timestamped), native "
             "loader build, preset integrity")
    doc.add_argument("--skip-backend", action="store_true",
                     help="skip accelerator init (for hosts where the "
                          "backend is known-hung)")
    doc.set_defaults(fn=_cmd_doctor)

    met = sub.add_parser(
        "metrics",
        help="summarize a run's metrics.jsonl (last step, best eval, "
             "mean throughput)")
    met.add_argument("path", help="metrics.jsonl path (or its directory)")
    met.set_defaults(fn=_cmd_metrics)

    # bench ------------------------------------------------------------------
    be = sub.add_parser("bench", help="run the benchmark harness")
    be.add_argument("--preset", default="cifar10_resnet20")
    be.add_argument("--processes", type=int, default=None,
                    help="processes on this host for --preset (with "
                         "--obs-smoke, --sweep-batches) and --collectives "
                         "(default: one per CUDA card, 1 on the CPU); "
                         "more than the cards share them over gloo")
    be.add_argument("--steps", type=int, default=30)
    be.add_argument("--global-batch", type=int, default=0)
    be.add_argument("--with-input", action="store_true",
                    help="also report value_with_input (host pipeline + "
                         "transfer in the timed loop)")
    be.add_argument("--step-window", type=int, default=1,
                    help="K train steps per call, each a CUDA graph "
                         "replay on the card (train.step_window=K; 1 = "
                         "per-step)")
    be.add_argument("--collectives", action="store_true",
                    help="run the collectives microbench (nccl-tests role) "
                         "instead of a training-step bench")
    be.add_argument("--size-mb", type=float, default=64.0,
                    help="collectives payload size in MB")
    be.add_argument("--ops", choices=["detection", "resnet", "all"],
                    help="run the op-level microbench suite (opsbench) "
                         "instead of a training-step bench")
    be.add_argument("--sweep-batches",
                    help="comma-separated global batch sizes to bench in "
                         "sequence (one JSON line each), e.g. 256,512,768")
    be.add_argument("--serve", action="store_true",
                    help="run the serving scenario (fixed request trace "
                         "through the continuous-batching engine) instead "
                         "of a training-step bench")
    be.add_argument("--requests-count", type=int, default=16,
                    help="serving scenario: trace length")
    be.add_argument("--slots", type=int, default=4,
                    help="serving scenario: slot-table capacity")
    be.add_argument("--beam-size", type=int, default=1,
                    help="serving scenario: beam width (1 = greedy)")
    be.add_argument("--decode-window", type=int, default=4,
                    help="serving scenario: fused decode steps per device "
                         "call (1 = the host-driven per-token loop)")
    be.add_argument("--kv-block-size", type=int, default=16,
                    help="serving scenario: paged KV block size (0 = "
                         "dense slot rows)")
    be.add_argument("--kv-blocks", type=int, default=0,
                    help="serving scenario: KV pool blocks (0 = match "
                         "dense memory)")
    be.add_argument("--prefix-cache", type=int, default=16,
                    help="serving scenario: encoder prefix-cache entries "
                         "(0 = disabled)")
    be.add_argument("--prefix-dup", type=float, default=0.0,
                    help="serving scenario: fraction of trace requests "
                         "repeating the first source — exercises the "
                         "prefix cache")
    be.add_argument("--speculate", type=int, default=0,
                    help="serving scenario: speculative decode draft "
                         "depth γ (self-draft); the record gains "
                         "spec_accept_rate / tokens_per_target_step and "
                         "the run fails on a greedy-parity break")
    be.add_argument("--speculate-device", action="store_true",
                    help="serving scenario: device-resident speculative "
                         "chains; the record gains spec_chain_len_p50 "
                         "and host_syncs_per_token (plus the host-path "
                         "comparison number)")
    be.add_argument("--draft", default="self",
                    help="serving scenario: draft for --speculate — "
                         "'self' (acceptance ceiling) or a committed "
                         "preset like 'tiny-distilled' (measured accept "
                         "rate)")
    be.add_argument("--quantize", default="", choices=["", "int8"],
                    help="serving scenario: weight-only quantization; "
                         "the record reports weight_bytes vs fp32 and a "
                         "bounded logits-divergence check")
    be.add_argument("--kv-quant", default="", choices=["", "int8"],
                    help="serving scenario: int8 paged KV cache; the "
                         "record reports kv_cache_bytes vs fp32 and a "
                         "bounded KV logits-divergence check (the run "
                         "fails when it exceeds the bound)")
    be.add_argument("--smoke", action="store_true",
                    help="serving scenario: CI fast mode (few requests, "
                         "tiny budget, same record contract)")
    be.add_argument("--fleet", action="store_true",
                    help="fleet scenario: the fixed trace routed across N "
                         "in-process engine replicas; reports aggregate "
                         "tokens/sec, per-replica utilization, and the "
                         "zero-drop contract (dropped_requests)")
    be.add_argument("--net", action="store_true",
                    help="fleet scenario: REAL child-process replicas "
                         "over unix sockets behind the network front "
                         "door (tiny-NMT recipe engines) — the record "
                         "gains wall-clock net_decode_p95_disagg vs "
                         "_colocated, net_stream_ttfb_p50/p95 measured "
                         "client-side, and (with --autoscale) "
                         "autoscale_time_to_scale_s including process "
                         "fork + model build + warmup; "
                         "--fleet-chaos-step N (any N > 0) SIGKILLs a "
                         "replica mid-stream and asserts the zero-drop "
                         "contract")
    be.add_argument("--fleet-replicas", type=int, default=2,
                    help="fleet scenario: replica count (default 2)")
    be.add_argument("--fleet-prefill", type=int, default=0,
                    help="fleet scenario: disaggregated topology — "
                         "prefill replica count (pair with "
                         "--fleet-decode; overrides --fleet-replicas and "
                         "arms the co-located contract run)")
    be.add_argument("--fleet-decode", type=int, default=0,
                    help="fleet scenario: disaggregated topology — "
                         "decode replica count (pair with "
                         "--fleet-prefill)")
    be.add_argument("--trace-mix", default="uniform",
                    choices=["uniform", "prefill-heavy", "tenants",
                             "prefix-heavy"],
                    help="fleet scenario: arrival mix — 'prefill-heavy' "
                         "interleaves long-prompt/short-decode "
                         "adversaries with short-prompt latency streams "
                         "(the decode-interference trace); 'tenants' is "
                         "the multi-tenant QoS mix (tenant-b batch-class "
                         "bulk jobs flooding tenant-a latency-class "
                         "streams — arms DRR admission + preemption and "
                         "the qos_* record fields); 'prefix-heavy' "
                         "repeats a handful of whole prompts round-robin "
                         "(the shared-system-prompt trace the radix "
                         "cache feeds on — with --radix-cache the "
                         "record gains the sharing sweep and the "
                         "prefix_affinity-vs-round_robin hit-rate "
                         "comparison)")
    be.add_argument("--fleet-policy", default="least_loaded",
                    choices=["least_loaded", "round_robin",
                             "prefix_affinity"],
                    help="fleet scenario: routing policy")
    be.add_argument("--radix-cache", action="store_true",
                    help="fleet scenario: per-replica radix token-prefix "
                         "KV cache (forces the paged path fleet-wide; "
                         "the parity baseline stays cold-cache, and the "
                         "record gains radix_hit_rate / "
                         "radix_hit_tokens_per_request / "
                         "prefill_tokens_saved_ratio)")
    be.add_argument("--prefill-chunk", type=int, default=0,
                    help="fleet scenario: per-replica chunked prefill "
                         "quota in source tokens per tick (co-located "
                         "replicas only; 0 = one-shot) — the record "
                         "gains the chunked-vs-unchunked decode-p95 "
                         "pair and token_identical_unchunked")
    be.add_argument("--fleet-chaos-step", type=int, default=0,
                    help="fleet scenario: crash-inject replica-0 on its "
                         "Nth decode step (0 = off) — the chaos variant "
                         "of the zero-drop contract")
    be.add_argument("--chaos-plan", default=None, metavar="PLAN.json",
                    help="fleet scenario: site-addressable fault plan "
                         "(FaultPlan JSON) consulted at replica.step/"
                         "replica.submit/handoff.export/handoff.import/"
                         "router.cancel — the record gains chaos_plan + "
                         "faults_injected, same zero-drop/parity/"
                         "balanced-ledger contract")
    be.add_argument("--degrade", action="store_true",
                    help="fleet scenario: brownout graceful degradation "
                         "— SignalBus queue pressure steps the fleet "
                         "through no-spec → window-cap → batch-shed "
                         "(and hysteretically back); transitions land "
                         "in degrade_events and "
                         "<trace-dir>/degrade.jsonl")
    be.add_argument("--trace", default=None, metavar="SPEC",
                    help="fleet scenario: open-loop trace replay — "
                         "'poisson' | 'burst' | 'diurnal', optionally "
                         "parameterized ('burst:requests=12,"
                         "burst_s=0.2'); drives Router.submit on a "
                         "virtual clock from a seeded arrival schedule")
    be.add_argument("--autoscale", action="store_true",
                    help="fleet scenario: closed-loop autoscaling over "
                         "the replayed trace — starts at --min-replicas, "
                         "scales between the bounds on SignalBus "
                         "pressure with hysteresis + cooldown, "
                         "scale-down as a zero-drop drain (needs "
                         "--trace)")
    be.add_argument("--min-replicas", type=int, default=1,
                    help="fleet scenario: autoscale floor (default 1)")
    be.add_argument("--max-replicas", type=int, default=0,
                    help="fleet scenario: autoscale ceiling (default: "
                         "--fleet-replicas)")
    be.add_argument("--fleet-trace-dir", default=None,
                    help="fleet scenario: write per-replica span shards, "
                         "router fleet.request spans and the signal "
                         "snapshot under DIR (merge with "
                         "'obs export --fleet DIR')")
    be.add_argument("--accelerator", default="gpu", choices=["gpu", "cpu"],
                    help="the device (gpu: the CUDA card, raising without "
                         "one)")
    be.add_argument("--obs-smoke", action="store_true",
                    help="obs overhead smoke: step time instrumented vs "
                         "spans disabled (the <=5%% gate; use "
                         "--preset transformer_nmt_wmt on CPU)")
    be.set_defaults(fn=_cmd_bench)

    # obs --------------------------------------------------------------------
    ob = sub.add_parser(
        "obs",
        help="observability: run reports over metrics/span JSONL streams")
    obsub = ob.add_subparsers(dest="obs_command", required=True)
    obsum = obsub.add_parser(
        "summarize",
        help="render a run report (step-time p50/p95, tokens/sec, ckpt "
             "latency + retries, queue wait, per-attempt outcomes) from a "
             "metrics.jsonl file or a run directory of *.jsonl streams")
    obsum.add_argument("path", help="metrics.jsonl path or run directory")
    obsum.add_argument("--json", action="store_true",
                       help="emit the summary as one JSON object instead "
                            "of the text report")
    obsum.add_argument("--since-step", type=int, default=None,
                       help="ignore records with a numeric step below N "
                            "(post-restart triage: report only the "
                            "resumed window)")
    obsum.add_argument("--fleet", action="store_true",
                       help="treat PATH as a fleet run root (one run dir "
                            "per replica) and aggregate: total tokens/sec, "
                            "worst p95, alert count, per-replica lines")
    obsum.set_defaults(fn=_cmd_obs_summarize)

    obexp = obsub.add_parser(
        "export",
        help="convert a run's span/metric JSONL into Chrome/Perfetto "
             "trace-event JSON (trace.json, loadable in ui.perfetto.dev)")
    obexp.add_argument("path", help="metrics.jsonl path or run directory")
    obexp.add_argument("-o", "--out", default="",
                       help="output path (default: trace.json next to "
                            "the input)")
    obexp.add_argument("--fleet", action="store_true",
                       help="treat PATH as a fleet trace root (router "
                            "*.jsonl at the top, one shard dir per "
                            "replica) and merge every shard into ONE "
                            "timeline with cross-process flow arrows")
    obexp.set_defaults(fn=_cmd_obs_export)

    obchk = obsub.add_parser(
        "check",
        help="evaluate declarative SLO rules (threshold/percentile/drop) "
             "over a run; nonzero exit on any breach — the CI gate")
    obchk.add_argument("path", help="metrics.jsonl path or run directory")
    obchk.add_argument("--rules", required=True,
                       help="rules JSON file ({\"rules\": [...]}; see "
                            "docs/OBSERVABILITY.md)")
    obchk.add_argument("--json", action="store_true",
                       help="emit the check result as one JSON object")
    obchk.set_defaults(fn=_cmd_obs_check)

    obdif = obsub.add_parser(
        "diff",
        help="align two runs' metric series and report p50/p95 deltas; "
             "nonzero exit when a shared metric regressed beyond the "
             "tolerance")
    obdif.add_argument("run_a", help="baseline run (file or directory)")
    obdif.add_argument("run_b", help="candidate run (file or directory)")
    obdif.add_argument("--tolerance", type=float, default=0.10,
                       help="relative regression tolerance on p50/p95 "
                            "deltas (default 0.10 = 10%%)")
    obdif.add_argument("--json", action="store_true",
                       help="emit the diff report as one JSON object")
    obdif.set_defaults(fn=_cmd_obs_diff)

    obtail = obsub.add_parser(
        "tail",
        help="follow a live run's JSONL streams, rendering a one-line "
             "train/serve status as records arrive (truncation-tolerant)")
    obtail.add_argument("path", help="run directory or one JSONL file")
    obtail.add_argument("--interval", type=float, default=1.0,
                        help="poll interval seconds (default 1.0)")
    obtail.add_argument("--duration", type=float, default=0.0,
                        help="stop after N seconds (default: follow "
                             "until interrupted)")
    obtail.add_argument("--once", action="store_true",
                        help="render the current status once and exit")
    obtail.add_argument("--rules", default="",
                        help="also evaluate SLO rules live, printing "
                             "alerts as they fire")
    obtail.add_argument("--fleet", action="store_true",
                        help="treat PATH as a fleet run root and render "
                             "one aggregated fleet status line")
    obtail.set_defaults(fn=_cmd_obs_tail)

    ck = sub.add_parser("ckpt", help="checkpoint inspection / rollback")
    cksub = ck.add_subparsers(dest="ckpt_cmd", required=True)

    def add_retry_flags(p):
        p.add_argument("--retry-attempts", type=int, default=1,
                       help="total store-I/O tries per operation; >1 "
                            "enables transient-fault retries with "
                            "exponential backoff (default 1 = off)")
        p.add_argument("--retry-backoff", type=float, default=0.5,
                       help="base backoff seconds between retries "
                            "(default 0.5)")

    ckl = cksub.add_parser("list", help="list committed checkpoint steps")
    ckl.add_argument("dir", help="checkpoint directory (or gs:// url)")
    add_retry_flags(ckl)
    ckl.set_defaults(fn=_cmd_ckpt_list)
    ckr = cksub.add_parser(
        "rollback",
        help="delete every checkpoint past STEP so the next training "
             "launch auto-resumes from STEP (one-shot, irreversible)")
    ckr.add_argument("dir", help="checkpoint directory (or gs:// url)")
    ckr.add_argument("--step", type=int, required=True,
                     help="committed step to roll back to")
    add_retry_flags(ckr)
    ckr.set_defaults(fn=_cmd_ckpt_rollback)

    # data -------------------------------------------------------------------
    data = sub.add_parser("data", help="dataset preparation / diagnostics")
    dsub = data.add_subparsers(dest="data_command", required=True)

    dp = dsub.add_parser(
        "prepare-imagenet",
        help="JPEG class-dir tree → dlcfn binary shards (run per split)")
    dp.add_argument("--src", required=True,
                    help="class-per-subdirectory image tree")
    dp.add_argument("--out", required=True, help="output shard directory")
    dp.add_argument("--size", type=int, default=256,
                    help="stored square resolution (default 256)")
    dp.add_argument("--shard-records", type=int, default=8192)
    dp.add_argument("--limit", type=int, default=0,
                    help="stop after N images (smoke tests)")
    dp.set_defaults(fn=_cmd_data_prepare_imagenet)

    dt = dsub.add_parser(
        "prepare-text",
        help="tokenize a raw text file (byte-level, offline) into the "
             "lm_text train/eval npz contract")
    dt.add_argument("--src", required=True, help="raw text/bytes file")
    dt.add_argument("--out", required=True, help="output directory")
    dt.add_argument("--seq-len", type=int, default=1024)
    dt.add_argument("--eval-fraction", type=float, default=0.05)
    dt.set_defaults(fn=_cmd_data_prepare_text)

    dc = dsub.add_parser(
        "prepare-coco",
        help="COCO instances_*.json + image dir → the detection npz "
             "contract (boxes, labels, box-aligned 28×28 masks); run per "
             "split")
    dc.add_argument("--annotations", required=True,
                    help="instances_train2017.json-style file")
    dc.add_argument("--images", required=True, help="image directory")
    dc.add_argument("--out", required=True, help="output directory")
    dc.add_argument("--split", required=True, choices=["train", "eval"])
    dc.add_argument("--image-size", type=int, default=1024)
    dc.add_argument("--max-boxes", type=int, default=100)
    dc.add_argument("--limit", type=int, default=0,
                    help="stop after N images (smoke tests)")
    dc.set_defaults(fn=_cmd_data_prepare_coco)

    dw = dsub.add_parser(
        "prepare-wikipedia",
        help="raw text corpus → BPE vocab + pre-masked MLM+NSP npz shards "
             "(the wikipedia_mlm real-data contract)")
    dw.add_argument("--src", required=True, help="raw UTF-8 text file")
    dw.add_argument("--out", required=True, help="output directory")
    dw.add_argument("--seq-len", type=int, default=512)
    dw.add_argument("--vocab-size", type=int, default=8192,
                    help="total ids incl. 4 specials + 256 bytes")
    dw.add_argument("--vocab", default="",
                    help="reuse an existing vocab.json instead of training")
    dw.add_argument("--eval-fraction", type=float, default=0.05)
    dw.add_argument("--seed", type=int, default=0)
    dw.set_defaults(fn=_cmd_data_prepare_wikipedia)

    dm = dsub.add_parser(
        "prepare-wmt",
        help="parallel src/tgt line files → shared BPE vocab + seq2seq npz "
             "shards (the wmt_en_de real-data contract)")
    dm.add_argument("--src", required=True, help="source-language lines")
    dm.add_argument("--tgt", required=True, help="target-language lines")
    dm.add_argument("--out", required=True, help="output directory")
    dm.add_argument("--seq-len", type=int, default=128)
    dm.add_argument("--vocab-size", type=int, default=8192)
    dm.add_argument("--vocab", default="",
                    help="reuse an existing vocab.json instead of training")
    dm.add_argument("--eval-fraction", type=float, default=0.05)
    dm.set_defaults(fn=_cmd_data_prepare_wmt)

    df = dsub.add_parser(
        "feed-rate",
        help="host-side input pipeline throughput (images/sec)")
    df.add_argument("--preset", default="imagenet_resnet50")
    df.add_argument("--local-batch", type=int, default=256)
    df.add_argument("--batches", type=int, default=30)
    df.add_argument("overrides", nargs="*")
    df.set_defaults(fn=_cmd_data_feed_rate)

    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
