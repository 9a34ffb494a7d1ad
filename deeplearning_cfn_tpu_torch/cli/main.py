"""The port's command line: the ``train`` and ``serve`` verbs.

    python -m deeplearning_cfn_tpu_torch.cli train --preset transformer_nmt_wmt \\
        [--max-steps N] [overrides ...]
    python -m deeplearning_cfn_tpu_torch.cli serve --preset transformer_nmt_wmt \\
        --allow-init --requests reqs.jsonl [overrides ...]

Same flags, defaults, result lines and stderr summary as the JAX package's
``dlcfn-tpu train``/``serve`` for the options these slices port (``train``
runs on this host only: no ``--stack``). ``--accelerator`` takes ``gpu``
(the default — the CUDA card, raising without one) or ``cpu``. Serve
requests are JSONL lines ``{"src_ids": [...]}`` with optional ``id``,
``max_new_tokens``, ``beam_size`` and ``deadline_s``; text requests need
the BPE tokenizer, which is not ported yet.
"""

from __future__ import annotations

import argparse
import json
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


def _cmd_serve(args) -> int:
    """Offline continuous-batching driver: a JSONL request trace in, one
    result JSON line per request out."""
    from ..metrics.jsonl import MetricsWriter
    from ..models.decoding import strip_special
    from ..serve import OverloadError
    from ..serve.loader import load_engine

    cfg = apply_overrides(get_preset(args.preset), args.overrides)
    cfg.stack.accelerator = args.accelerator
    try:
        engine, _, at_step = load_engine(
            cfg, capacity=args.slots, queue_depth=args.queue_depth,
            default_max_new_tokens=args.max_new_tokens,
            decode_window=args.decode_window,
            kv_block_size=args.kv_block_size, kv_blocks=args.kv_blocks,
            prefix_cache_size=args.prefix_cache,
            step=args.step, allow_init=args.allow_init,
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
        if "src_ids" not in rec:
            print(f"[dlcfn-tpu] ERROR: requests line {lineno} has no "
                  "\"src_ids\" (text requests need the tokenizer, not "
                  "ported yet)", file=sys.stderr)
            return 1
        src_ids = [int(t) for t in rec["src_ids"]]
        kwargs = dict(
            max_new_tokens=int(rec.get("max_new_tokens",
                                       args.max_new_tokens)),
            beam_size=int(rec.get("beam_size", args.beam_size)),
            request_id=rec.get("id"),
        )
        if rec.get("deadline_s") is not None:
            kwargs["deadline_s"] = float(rec["deadline_s"])
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
        print(json.dumps({
            "id": req.id,
            "state": req.state.value,
            "tokens": [int(t) for t in strip_special(req.tokens)],
            "ttft_s": req.ttft_s,
            "latency_s": req.latency_s,
        }), flush=True)
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
        description="PyTorch/CUDA port of dlcfn-tpu (slices 1-2: serve, "
                    "train)")
    sub = parser.add_subparsers(dest="command", required=True)
    tr = sub.add_parser("train", help="train a preset on this host")
    tr.add_argument("--preset", required=True)
    tr.add_argument("--accelerator", default="gpu", choices=["gpu", "cpu"])
    tr.add_argument("--max-steps", type=int, default=None)
    tr.add_argument("overrides", nargs="*",
                    help="config overrides, e.g. train.global_batch=256")
    tr.set_defaults(fn=_cmd_train)
    sv = sub.add_parser(
        "serve",
        help="continuous-batching inference over an NMT checkpoint "
             "(offline driver: JSONL requests in, completions out)")
    sv.add_argument("--preset", required=True)
    sv.add_argument("--accelerator", default="gpu", choices=["gpu", "cpu"])
    sv.add_argument("--requests", required=True,
                    help="JSONL request trace path, or - for stdin; each "
                         "line {\"src_ids\": [...]} plus optional "
                         "id/max_new_tokens/beam_size/deadline_s")
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
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
