"""The port's command line: the ``train``, ``eval``, ``generate``, ``serve``
and ``ckpt`` verbs.

    python -m deeplearning_cfn_tpu_torch.cli train --preset transformer_nmt_wmt \\
        [--max-steps N] [overrides ...]
    python -m deeplearning_cfn_tpu_torch.cli train --preset bert_base_wikipedia
    python -m deeplearning_cfn_tpu_torch.cli eval --preset bert_base_wikipedia \\
        [--step N] workdir=...
    python -m deeplearning_cfn_tpu_torch.cli train --preset gpt_small_lm
    python -m deeplearning_cfn_tpu_torch.cli generate --preset gpt_small_lm \\
        --prompt "..." [--max-new-tokens N] [--temperature T --top-k K] \\
        [--vocab vocab.json] [--step N] workdir=...
    python -m deeplearning_cfn_tpu_torch.cli serve --preset transformer_nmt_wmt \\
        --allow-init --requests reqs.jsonl [--speculate G [--speculate-device] \\
        [--draft tiny-distilled]] [--radix-cache] [--prefill-chunk N] \\
        [--quantize int8] [--kv-quant int8] [--vocab vocab.json] \\
        [overrides ...]
    python -m deeplearning_cfn_tpu_torch.cli ckpt list <ckpt dir>
    python -m deeplearning_cfn_tpu_torch.cli ckpt rollback <ckpt dir> --step N
    python -m deeplearning_cfn_tpu_torch.cli train --preset maskrcnn_coco

Same flags, defaults, result lines and stderr summary as the JAX package's
``dlcfn-tpu train``/``eval``/``generate``/``serve``/``ckpt`` for the options
these slices port (``train`` runs on this host only: no ``--stack``; a rerun
resumes from the latest committed checkpoint). ``--accelerator`` takes ``gpu`` (the
default — the CUDA card, raising without one) or ``cpu``. Serve
requests are JSONL lines ``{"src_ids": [...]}``, or ``{"text": "..."}`` with
``--vocab`` (BPE-encoded, ``data/bpe.py``, plus EOS; each result line then
carries the decoded ``"text"``), with optional ``id``, ``max_new_tokens``,
``beam_size``, ``deadline_s``, ``tenant`` and ``qos_class``; ``--quantize
int8`` and ``--kv-quant int8`` serve int8 weights and an int8 paged KV pool.
``generate`` takes a byte-level prompt (byte + 4), or a BPE one with
``--vocab``. The ``data`` verbs
(``data prepare-coco`` and the rest) are not ported yet and raise, naming
ROADMAP A.13; ``data/coco.py:prepare_coco`` converts COCO from Python.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from ..config import apply_overrides
from ..presets import get_preset


def _cmd_train(args) -> int:
    """Train a preset on this host's card (or the CPU with
    ``--accelerator cpu``) and print the final metrics."""
    from ..runtime.platform import resolve_device
    from ..train.run import run_experiment

    cfg = apply_overrides(get_preset(args.preset), args.overrides)
    cfg.stack.accelerator = args.accelerator
    try:
        device = resolve_device(args.accelerator)
    except RuntimeError as e:
        print(f"[dlcfn-tpu] ERROR: {e}", file=sys.stderr)
        return 1
    final = run_experiment(cfg, max_steps=args.max_steps, device=device)
    print(f"[dlcfn-tpu] final metrics: "
          f"{ {k: round(v, 4) for k, v in final.items()} }")
    return 0


def _cmd_data(args) -> int:
    raise NotImplementedError(
        f"cli data {args.verb} is not ported yet (ROADMAP A.13); "
        f"deeplearning_cfn_tpu_torch.data.coco.prepare_coco converts COCO "
        f"from Python")


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
    if writer is not None:
        writer.close()
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m deeplearning_cfn_tpu_torch.cli",
        description="PyTorch/CUDA port of dlcfn-tpu (serve the NMT; train "
                    "and evaluate the NMT, the ResNets, BERT, GPT and Mask "
                    "R-CNN; generate with GPT)")
    sub = parser.add_subparsers(dest="command", required=True)
    tr = sub.add_parser("train", help="train a preset on this host")
    tr.add_argument("--preset", required=True)
    tr.add_argument("--accelerator", default="gpu", choices=["gpu", "cpu"])
    tr.add_argument("--max-steps", type=int, default=None)
    tr.add_argument("overrides", nargs="*",
                    help="config overrides, e.g. train.global_batch=256")
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

    dt = sub.add_parser("data", help="dataset preparation (not ported "
                                     "yet: ROADMAP A.13)")
    dt.add_argument("verb", help="e.g. prepare-coco")
    dt.add_argument("args", nargs=argparse.REMAINDER)
    dt.set_defaults(fn=_cmd_data)

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
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
