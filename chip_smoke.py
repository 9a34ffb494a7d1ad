#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit. It imports only torch, numpy, the standard library and the port
(``deeplearning_cfn_tpu_torch``) — never JAX or the JAX package. Phases, in
order; a failing phase raises, so the exit code is nonzero:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of the path from ``csrc/`` (one ``nvcc`` per source,
   in parallel) and print the build seconds;
3. hold the flash-attention kernel against its plain PyTorch version on the
   card: the serving path's three shapes at 8 slots, contiguous and in the
   model's strided [B,S,H,D] layout, plus causal, ragged Sq != Sk, the
   boundaries of the bf16 variants (Sq 15/16/65, head dims 16 and 128) and
   the lse output; f32 within 1e-4, bf16 within 2e-2 (absolute), and every
   output on its own scale as well (``scaled_error``: relative norm error
   <= 1e-2, largest error <= 2e-2 of the largest |ref|); each bf16
   call must take the variant ``forward_variant`` names (tc or decode on
   the main path's shapes); with them the speculative verify spans, Sq 2,
   5 and 9 (γ 1, 4, 8) at 8 slots against 128 cache slots, dense and as
   the paged gather (null-block entries filled with values the bias must
   hide), with the model's span bias at per-row positions whose last
   spans run past max_len (bf16 on ``decode``);
4. time each of the three shapes: the kernel, the first port's kernel
   body on the same inputs (the ``simt`` variant, the CUDA-core kernel
   before the tensor-core redesign: ``*_before``), the plain version and one
   ``scaled_dot_product_attention`` call (a yardstick only; the port never
   calls it) with CUDA events over back-to-back calls (``ms``,
   ``kernel_ms_before``, ``plain_ms``, ``library_ms``: the host's time
   included, as the first timings were taken), and all but the plain
   version by their device time per call (``device_ms``,
   ``device_ms_before``, ``library_device_ms``: CUDA events around calls
   queued behind a busy-wait on the card, so that they run back to back
   with the host's time hidden; the kernel also in the model's strided
   layout,
   ``device_ms_strided``), beside the byte/operation bound;
5. serve: ``load_engine`` on the ``transformer_nmt_wmt`` preset at full
   width (seeded random init, seed 0, bf16), 8 slots, paged KV blocks of
   16, decode window 4, prefix cache 32; 24 seeded requests (sources of 8
   to 120 tokens, 32 new tokens, 4 of them beam 4), drained. Every request
   must be done, the kernel's launch count over this phase must equal
   6 per encoder forward plus 12 per decoder step, as the engine tallied,
   and every one of those bf16 launches must have taken the tc or decode
   variant (none the CUDA-core simt kernel);
6. the same engine in f32 through the kernel and through the plain
   version: the first decode step's logits agree within 1e-3, and the
   number of token-identical greedy requests is printed;
7. hold the backward kernels (dK/dV, dQ) against their plain versions on
   the card — the training shape, causal and not, ragged Sq != Sk (37/101),
   lengths off the tile, head dims 16 and 128, f32 within 5e-4 and bf16
   within 5e-2 (absolute + relative, the tolerances of tests/test_ops.py's
   flash backward tests), and on each output's own scale as phase 3 (the
   tc variants' 64-row Q tiles end at Sq
   63/64/65 and 127/128/129, keys off the 64-key tile, strided views
   included, every bf16 launch of both kernels on the variant
   ``backward_variant`` names) — and the autograd Function's (dq, dk, dv)
   against ``torch.autograd.grad`` of ``attention_reference``; rows that saw
   no key (lse = +1e30) must get a dQ of exactly 0 on the tc variant, and
   two backward calls must be bit-identical;
8. time, as phase 4 does, at the training shape (q/k/v/dO [128, 8, 128,
   64] bf16, causal) the forward kernel with lse, dK/dV and dQ, beside
   each one's simt body, their plain versions, their byte/operation
   bounds and, as a yardstick the port never calls,
   ``scaled_dot_product_attention`` forward and backward;
9. train ``transformer_nmt_wmt`` at full width in bf16 through
   ``train.run.run_experiment``: global batch 128, dropout 0.1, label
   smoothing 0.1, AdamW + rsqrt with warmup 10 and base lr 1e-3 (peak
   3.2e-4; the schedule clamps warmup to steps - 1, so in a 30-step run the
   preset's base lr 1.0 would peak at 0.19 and diverge), 30 steps, then the
   eval loss and BLEU on 128 eval examples (decode length 32).
   Every loss must be finite, the mean of the last 5 below the mean of the
   first 5, and the launch counts over the 30 steps exactly 18 forward,
   6 dK/dV, 6 dQ and 12 reference-VJP recomputes per microbatch step,
   every forward, dK/dV and dQ launch on its tc variant;
10. f32 gradient parity at full width (batch 16): one train step from the
   same init and dropout seed through the kernels and through the plain
   attention — losses within 1e-5 relative, every parameter's gradient
   within 1e-3 of its norm (floored at 1e-4 of the largest gradient norm:
   the key biases' true gradient is 0), and every attention projection's
   gradient present and nonzero.

11. train ``imagenet_resnet50`` at full width in bf16 through
   ``train.run.run_experiment`` (224² images, the 7×7/s2 stem, [3, 4, 6, 3]
   bottlenecks, 1000 classes, LARS + cosine, label smoothing 0.1) on
   synthetic ImageNet: global batch 256, 2 warm-up steps then 10 timed,
   each step synced (log every step). Cuts, printed by the phase: batch 256
   for the preset's 8192 (the lr follows the preset's ``scale_with_batch``
   rule), 1024 train examples for 8192, warmup scaled to the step count,
   eval on 512 examples. It prints step time p50 and images/s p50 (host
   clock), the MFU share (images/s × 3 × the forward FLOPs counted from
   the model's conv and Dense shapes, over 989 TFLOP/s), the peak memory,
   the loss (first-5 and last-5 means, which must fall), eval top-1 and
   top-5, and asserts that every parameter and buffer is on the card, the
   activations are channels_last, the running statistics finite and moved.
   It then measures the host's feed rate of the sharded ImageNet source
   through the C++ ``dataio`` loader (1024 synthetic u8 256² images written
   by ``write_shards``, batch 256) against the card's images/s. The ResNet
   launches none of the three kernels; the counts stay as phase 9 left them;
12. f32 ``cifar10_resnet20`` at full width (batch 128) on the card against
   the CPU, from one seeded init and the same 3 host batches (TF32 off, as
   the trainer sets it for an f32 run): losses within 1e-4 relative, every
   gradient within 1e-5 of the global gradient norm, running statistics
   within 1e-5.

13. train ``bert_base_wikipedia`` at full width in bf16 through
   ``train.run.run_experiment`` (vocab 30522, hidden 768, 12 layers, 12
   heads of 64, MLP 3072, sequence 128, dropout 0.1, LAMB with weight decay
   0.01 behind the 1.0 clip, cosine) on the synthetic MLM source: global
   batch 1024 as 2 microbatches of 512, 2 warm-up steps then 8 timed, each
   synced. Cuts, printed by the phase. It prints the step time p50 and
   sequences/s p50 (host clock), the MFU share (sequences/s × 3 × the
   forward FLOPs counted from the model's shapes, over 989 TFLOP/s), the
   peak memory, the first-5 and last-5 mean losses (finite and falling),
   the eval metrics, and the f32 MLM decoder's product ([512·25, 768] ×
   [768, 30522], forward and backward, TF32 off) by CUDA events. Over the
   run the forward kernel must have launched on ``tc`` 12 times per
   microbatch step plus 12 per eval batch, the reference VJP 12 times per
   microbatch step, dK/dV and dQ never. The forward kernel is then timed at
   BERT's shape ([512, 12, 128, 64] bf16 with a padding bias), as phase 4
   times it, beside ``scaled_dot_product_attention`` with the same additive
   mask;
14. checkpoint and resume on the card: BERT at full width cut to 2 layers,
   f32, batch 32, dropout 0.1, through ``run_experiment``: a run to step
   2k = 6 against a run killed after step k = 3 (mid-epoch; its step-3
   checkpoint committed) and resumed to 6 with ``train.profile_steps=2``.
   The resumed losses must match the uninterrupted run's within 1e-4
   relative (not bit for bit: the embedding backward's atomics make the
   card's order of additions vary), the trace file must exist, and the
   ``ckpt list``, ``eval --step`` and ``ckpt rollback`` verbs run on the
   checkpoint directory.
15. train ``maskrcnn_coco`` at full width in bf16 through
   ``train.run.run_experiment`` (1024² images, ResNet-50-FPN P2–P6, 91
   classes, 261,888 anchors, ``pre_nms_topk`` 1024, ``post_nms_topk`` 256
   plus the 100 GT slots, 64 mask RoIs, momentum with weight decay 1e-4
   and the clip at 10, the step schedule) on the synthetic COCO source:
   global batch 8 in one microbatch, 2 warm-up steps then 10 timed, each
   synced. Cuts, printed by the phase (``MRCNN_CUTS``). It prints the step
   time p50 and images/s p50 (host clock), the MFU share (images/s × 3 ×
   the forward FLOPs counted from the model's shapes at 356 box RoIs and
   64 mask RoIs, over 989 TFLOP/s), the peak memory, the five losses and
   proposal recall first to last, the final eval's box and mask mAP (16
   images, ``detect_topk`` 100) and the device-busy share of two profiled
   steady steps; it asserts every loss finite, the total falling (first-3
   against last-3 mean), every mAP key in [0, 1], every parameter and
   buffer on the card, and that no attention kernel launched;
16. the tiny f32 Mask R-CNN (``tests/test_detection.py``'s config: 64², 7
   classes, batch 4) on the card against the CPU from the same seeded
   weights and batch (TF32 off): the chosen proposals (anchor indices and
   keep flags) equal, the five losses and proposal recall within 1e-5
   relative, every gradient within 1e-3 of the global norm (the loss is
   piecewise smooth: an input change of 1e-7 relative moves its gradients
   by up to 5.7e-4 of the norm on the CPU alone) and the running
   statistics within 1e-5 (the ROI-align gather's backward is an
   ``index_add`` with atomics on the card, so not bit for bit), and
   ``predict_fn``'s classes equal, its boxes, scores and masks within 1e-4
   of the largest value.
17. train ``gpt_small_lm`` at full width in bf16 through
   ``train.run.run_experiment`` (vocab 32768, hidden 768, 12 layers, 12
   heads of 64, MLP 3072, sequence 1024, dropout 0.1, AdamW (0.9, 0.95)
   with weight decay 0.1 behind the 1.0 clip, cosine; the tied logits in
   f32, TF32 as the process has it, printed) on the synthetic ``lm_text``
   source: global batch 16 in one microbatch, 2 warm-up steps then 20
   timed, each synced. Cuts, printed by the phase (``GPT_CUTS``). It prints
   the step time p50 and tokens/s p50 (host clock), the MFU share
   (tokens/s × 3 × the forward FLOPs per token counted from the shapes:
   trunk GEMMs, causal attention, tied logits, over 989 TFLOP/s), the peak
   memory, the first-5 and last-5 mean losses (finite and falling), eval
   ``ce_loss``, ``perplexity`` and ``token_accuracy`` on 64 sequences, and
   the f32 tied-logits product ([16384, 768] × [768, 32768], forward and
   backward) by CUDA events. Over the run the forward, dK/dV and dQ
   kernels must each have launched on ``tc`` 12 times per step, the
   forward 12 more per eval batch, the reference VJP never. It then times
   the three kernels at [16, 12, 1024, 64] bf16 causal as phase 8 does and
   holds O, lse, dK, dV and dQ against their plain versions there, each on
   its own scale (phases 3 and 7 hold them at 1023/1024/1025 keys, off the
   64-key tile both ways);
18. ``cli generate --preset gpt_small_lm`` from phase 17's checkpoint: a
   16-byte prompt and 64 new tokens, greedy; it must exit 0 and print
   text, and the forward kernel must have launched on ``decode`` 12 times
   per position (12 × 79). Then one seeded full-width GPT through the
   kernels and through the plain attention: in f32 (TF32 off; the exact
   ``simt`` variant) the first generated position's logits within 1e-3; in
   bf16 (the ``decode`` variant, launched 12 × 95 times) within a relative
   norm error of 5e-2 and a largest error of 5e-2 of the largest logit;
   and in both the number of token-identical greedy rows of
   ``lm_generate`` at batch 8 (printed); the bf16 decode
   step's p50 and tokens/s at batch 1 and 8 (host clock, synced); and the
   forward kernel timed at the decode shape (q [1, 12, 1, 64] against the
   1024-slot cache with the step bias) as phase 4 times the serving
   shapes.
19. speculative serving: phase 5's engine and 24 requests (beams
   included; they fall back to the host step) with γ = 4, in three runs —
   (a) self-draft on the host path, (b) self-draft on the device chain
   (decode window 4), (c) a seeded 2+2-layer draft (same vocab and
   max_len), so that proposals are rejected. Each run: every request done,
   the kernel's launches equal to the engine's tally (6 per target encode,
   12 per decoder and verify step, the draft's own depth for its encodes
   and steps), none on ``simt``; it prints accepted / proposed, verify
   steps per emitted token, host syncs per speculative token, tokens/s and
   the decode-step p50. Then in f32 (TF32 off) the greedy requests through
   plain greedy, the host path and the chain: the token-identical count,
   and every request that differs must first differ where the plain run's
   top two logits lie within 1e-4 of each other; the first verify's
   logits (dense and paged) within 1e-4 of the largest logit of γ+1
   sequential steps. Then the forward kernel at the verify shape (q [8, 8,
   5, 64], span bias, the 128-slot cache and the paged span) timed as
   phase 4 times the serving shapes.
20. the radix cache, chunked prefill (32-token chunks) and QoS in one run
   of 48 requests: 24 sources (a quarter of the requests 120 tokens long),
   each served twice, in four waves — 16 batch-class originals (tenant
   ``t-batch``: preemptible, 64/s rate limit; an overload is waited out
   and resubmitted in the same class), 8 latency-class originals that find
   every slot busy, then the repeats at budgets the cache covers (instant
   completes) or exceeds (resumes). Every request done; radix instant
   completes and resumes > 0; preemptions > 0 with no token lost; the
   launches equal the tally (partial encodes included); and the tokens
   against a plain engine's (no radix, no chunks, untagged) on the same
   weights: the identical count, and a request that differs must first
   differ at a near-tie of the plain run's top two logits (within 2e-2 of
   the largest). It prints queue-wait p50 / p95 per class, TTFT p50,
   tokens/s and the radix block count.
21. train ``imagenet_vit_s16`` at full width in bf16 through
   ``train.run.run_experiment`` (224² images, patch 16: 196 tokens, hidden
   384, 12 layers, 6 heads of 64, MLP 1536, dropout 0.1, label smoothing
   0.1, AdamW with weight decay 0.05 behind the 1.0 clip, cosine) on
   synthetic ImageNet: global batch 1024 as 4 microbatches of 256, 2
   warm-up steps then 8 timed, each synced. Cuts, printed by the phase
   (``VIT_CUTS``). It prints the step time p50 and images/s p50 (host
   clock), the MFU share (images/s × 3 × the forward FLOPs counted from
   the shapes, over 989 TFLOP/s), the peak memory, the first-5 and last-5
   mean losses (finite and falling) and the eval's top-1 and top-5. Over
   the run the forward, dK/dV and dQ kernels must each have launched on
   ``tc`` 12 times per microbatch, the forward 12 more per eval batch, the
   reference VJP never: ViT is the first train path whose backward kernels
   run without causality and without a bias. It then times the three
   kernels at [256, 6, 196, 64] bf16, non-causal, as phase 8 does and
   holds O, lse, dK, dV and dQ against their plain versions there (196
   keys: every row ends in a partial 64-key tile, and the last Q tile
   holds 4 rows); then the tiny f32 ViT on the card against the CPU
   (logits, loss, gradients; TF32 off) and 5 Adafactor steps of it on
   each (``vit_parity``);
22. train ``bert_moe_wikipedia`` at full width in bf16 (BERT-base with 8
   experts in every other layer, top-2, capacity factor 1.25: 40 slots per
   expert; LAMB) as phase 13 trains BERT-base: batch 1024 as 2 × 512, 10
   steps. It prints phase 13's figures (the MFU share counting the expert
   einsums at every capacity slot they execute), and ``moe_load_balance``
   and ``moe_router_z`` at every step, which must be finite; the launch
   checks are phase 13's. Then the tiny f32 BERT-MoE and GPT-MoE on the
   card against the CPU: dispatch masks equal, loss and gradients within
   tolerance, GPT-MoE's greedy ``lm_generate`` rows token-identical
   (``moe_parity``);
23. train ``bert_pipelined_wikipedia`` at full width on one card (the
   stacked trunk as the plain layer scan; the preset's 8 microbatches and
   4-way pipe axis are ignored and printed) in bf16, as phase 13: batch
   1024 as 2 × 512, 10 steps, phase 13's figures and launch checks;
24. ``train.step_window=4`` (``train/graphs.py``): ``imagenet_vit_s16``
   (bf16, batch 1024 as 4 × 256) and ``transformer_nmt_wmt`` (bf16, batch
   128, dropout 0.1) each train 16 steps twice from one seed over the same
   4 staged batches: K = 1 eager steps, then K = 4 windows whose steps
   replay one captured CUDA graph (the first step eager). Printed: both
   runs' per-step losses, the largest loss and weight differences, which
   must stay within ``WINDOW_TOL`` (bit for bit where no atomics reorder
   additions), the launches per step of each kernel, which must be equal
   (replays counted, the capture not), the step time p50 of each (windows
   of 4 synced at their ends, the first left out) and the device-busy
   share: the device's span of a replayed step (CUDA events around a
   window; the host is ahead of the card, one launch per step) over each
   run's wall time per step. Then the other seven trainable presets as tiny
   f32 cuts, 8 steps each, K = 1 run twice (BERT with remat, dropout and
   two microbatches), under PyTorch's deterministic algorithms: the two
   eager runs and the graphs must agree bit for bit (without them Mask
   R-CNN's atomics can flip a top-k or NMS choice, and two runs part by
   a few percent of the loss). Then the
   ViT and the NMT through ``run_experiment``
   with ``step_window=4``, 8 steps: the steps logged (4 and 8, lagging one
   boundary), ``compile_s`` once, and the launches (the path's, in the
   kernels line as ``launches_vit_window`` and ``launches_nmt_window``).
   A capture or replay that fails raises.
25. int8 serving: phase 5's engine and 24 requests with ``quantize="int8"``
   and ``kv_quant="int8"`` (int8 weights; the paged pool as int8 codes
   with per-block, per-head scales). Every request done, no KV block held
   after the drain, the launches equal the tally, both the ``decode``
   variant and the ``tc`` encoder launched (none ``simt``). Printed and
   held to JAX's serving contracts: weight bytes int8 / f32 <= 0.35, KV
   pool bytes as stored / the f32 pool <= 0.30 (also against phase 5's
   bf16 pool, and ``serve_kv_quant_bytes``), and on a teacher-forced batch
   (8 sources, 32 positions through the paged decode) the weights, the KV
   and both against the unquantized bf16 model within 0.1 · max(1, max
   |ref|). Then the same requests with γ = 4 on the device chain, which
   must be token-identical to the plain int8 engine; one beam request at
   windows 1 and 4 (identical); ``swap_variables`` with the f32 state on an
   int8 radix engine (the radix sources dropped, the same tokens after);
   a tiny f32 NMT with int8 weights and pool, card against CPU (logits
   within 1e-3 of the largest, codes within ±1); and ``cli serve
   --quantize int8 --kv-quant int8 --vocab`` (a BPE vocab trained offline)
   on three text lines (exit 0, ``"text"`` on every result line). It
   prints tokens/s, TTFT p50 and the decode-step p50 beside phase 5's, and
   ``max_memory_allocated``.
26. the launched path, in a temporary directory, on phase 9's NMT config
   (full width, bf16, batch 128): (a) ``cli stack create --provisioner
   dryrun --slice-type v5p-4`` (one host), then ``cli train --stack`` in a
   child process for 12 steps with ``train.profile_steps=1``: exit 0 and
   ``job finished``, the worker's log names the CUDA device, the worker's
   Chrome trace names the three kernels, ``metrics.jsonl`` holds
   ``train.dispatch`` and ``ckpt.save`` spans, ``metrics.prom`` exists; the
   launched step p50 beside phase 9's; (b) ``launch/chaos.py:
   run_crash_recovery`` on the card, 8 steps, the worker SIGKILLed right
   after its (synchronous) step-4 save, ``max_restarts=2``: outcomes crash
   then ok, resumed from step 4, the per-step losses equal to the
   uninterrupted run's bit for bit, no uncommitted step directory; each
   attempt's wall time and the restart overhead (the launcher seeing the
   death to the resumed run's first step record); (c) ``cli obs
   summarize`` (the ``ckpt.save`` p50 and p95, the attempts),
   ``obs check`` (two rules the run must hold), ``obs export`` (the trace
   passes ``validate_trace``) and ``cli metrics`` on (b)'s run, each exit
   0; (d) ``cli doctor``: all checks pass. The workers' kernel launches
   happen in their own processes, so the kernels line does not count them.
27. the fleet, in phase 26's directory: (a) ``cli fleet up --prefill 1
   --decode 1`` in this process: phase 5's engine as a prefill and a
   decode replica (``load_engine(phase=...)``, paged blocks of 16) behind
   the ``Router``, serving phase 5's 24 requests: rc 0, every request
   done, none dropped, one handoff each, the printed tokens equal to phase
   5's; the decode replica runs no encoder (no encode, no ``tc`` launch);
   each replica's launches (counted around its own steps, from 0 once the
   CLI has built both) equal its tally and none is ``simt``. It prints the
   handoff bytes per request (p50, max), the hop's host time (export,
   save, load, import, release) p50, the prefill replica's TTFT p50 and
   the decode replica's decode-step p50 beside phase 5's; (b) the same
   with ``--quantize int8 --kv-quant int8`` on phase 25's requests,
   token-identical to phase 25, and a bf16 artifact into the int8 decode
   replica refused with ValueError, nothing committed; (c) ``cli fleet
   route`` and ``cli fleet rollout`` (two replicas) on phase 26's chaos
   run: the replicas load its latest checkpoint, the rollout swaps them to
   the other in mid-stream; rc 0, every request done, the routed tokens
   equal to one engine at the latest step and those served after the swap
   to one engine at the new step; (d) ``cli fleet up``: two supervised
   ``cli serve`` children on the card, each on its shard; both ok, each
   child's log holds its results and its kernel launches after its
   warm-up, equal to its own tally; ``fleet status`` and ``obs summarize
   --fleet`` read the run root; (e) ``cli fleet up --net`` in a child
   process: two ``net.server`` children (the seeded tiny recipe) behind
   unix sockets, both SIGKILLed in mid-stream, one after the other, each
   with requests in flight, so that every request left is served by a
   restarted child: each child's first attempt is a crash, its second
   says ready and exits rc 0 after the drain with its launches (after its
   warm-up) equal to its own tally, the restarted children launched the
   kernel, and every request is done and equal to an in-process engine of
   the recipe on the card. The children's launches are in the kernels
   line as ``child_launches``, apart from ``launches``.
28. data parallelism across processes (ROADMAP A.10 part 1), in phase
   26's directory. Two processes share the one card over gloo, so every
   collective goes through the host and no time here is a data-parallel
   speed. (a) ``cli stack create --slice-type v5p-8`` (two dry-run hosts)
   and ``cli train --stack`` on it: phase 9's NMT config (full width,
   bf16, global batch 128 as 2 × 64) with dropout 0, 6 steps; exit 0, each
   process's log names gloo on ``cuda:0``, the mesh line says ``data=2``,
   and each process's flash kernel launches over its steps 2-6 (it prints
   them) are a one-process step's per step (18, 6, 6); (b) one process on
   the card trained on the same global batches (process 0's pipeline batch,
   then process 1's): per-step losses within ``DP_LOSS_REL_BOUND``, set
   between this cell's sound reading and its control's, two processes
   whose gradients are never summed, which must exceed it (the control's
   gradient sum is timed apart from its steps), and the losses must move by
   ``DP_MOVE_FACTOR`` bounds over the steps; (c)
   the f32 ResNet-20 (batch 32, 4 steps) on 2 processes
   (``chip_smoke.py --dp-worker``) against one, under strict deterministic
   algorithms: losses and BatchNorm running statistics within 1e-5, the two
   processes' statistics identical; (d) ``run_crash_recovery`` with two
   hosts: the tiny BERT under LAMB with ``shard_opt_state=True``, process 1
   SIGKILLed after the step-4 commit, both restarted and resumed from step
   4, the losses equal to an uninterrupted two-process run bit for bit, the
   checkpoint with ``manifest_p0``/``manifest_p1``, and the slot bytes per
   process against one process's; (e) ResNet-50 at full width, bf16, on 2
   processes through ``run_experiment`` (global batch 64, 3 steps): finite
   losses, identical running statistics on both, the step time per
   process beside the card's name and power limit.
29. the long presets on one process (ROADMAP A.10 part 2a; ``seq`` = 1, so
   the trunks run the flash kernels on whole rows): the three kernels timed
   at ``bert_long``'s [8,12,4096,64] (non-causal) and ``gpt_long``'s
   [1,12,16384,64] (causal) as phase 8 times its shape, and held against
   their plain versions with heads cut ([1,12,4096,64] and
   [1,2,16384,64]: the plain versions hold S x S in f32) on their own scale
   and the lse within 1e-3; ``cli train --preset bert_long_wikipedia``
   (full width, bf16, batch 8 x 4096, 4 steps) and ``--preset
   gpt_long_lm`` (batch 2 as the preset's 2 microbatches of 16384, 4
   steps), each with finite losses and 12 launches of each kernel per
   microbatch plus 12 forwards per eval batch, all ``tc``; ``cli generate``
   from gpt_long's checkpoint (recompute mode: 12 ``tc`` forwards per new
   token); the tiny f32 ``bert_long`` and ``gpt_long`` on the card against
   the CPU (loss within 1e-5, gradients within 1e-4 of the norm, the three
   kernels once per layer).
30. the ``seq`` axis across 2 processes (ROADMAP A.10 part 2b) on phase
   28a's dry-run stack, gloo-staged: ``cli train --stack`` with
   ``mesh.seq=2`` for ``bert_long`` with ring attention and ``gpt_long``
   with Ulysses (full width cut to 2 layers, 4096, bf16, 3 steps): the mesh
   line says ``seq=2``, each process launches per step what
   ``SEQ_PER_STEP`` says (the ring none, Ulysses the three kernels per
   layer and microbatch); one process on the same global batches within
   the job's ``SEQ_LOSS_REL_BOUND``, a control whose gradients are never
   summed beyond it, the losses moving by ``SEQ_MOVE_FACTOR`` bounds; the
   control's processes time the ring's rotations or Ulysses's all-to-alls,
   the heads' gather and the gradient sum apart from the step.
31. the ``pipe`` and ``expert`` axes across 4 processes (ROADMAP A.10 parts
   2c + 2d) on a four-host dry-run stack (``--slice-type v5p-16``),
   gloo-staged, at full width (hidden 768, 12 layers, 12 heads, MLP 3072,
   vocab 30522, sequence 128, bf16, batch 64, 3 steps): ``cli train
   --stack`` of ``bert_pipelined_wikipedia`` on ``(data=1, pipe=4)`` (three
   layers per process, the GPipe schedule over 8 microbatches) and of
   ``bert_moe_wikipedia`` on ``(data=1, expert=4)`` (two of the 8 experts
   per process, dropout 0): the mesh line says ``pipe=4`` or ``expert=4``,
   each process launches the forward kernel per step as
   ``PE_PER_STEP`` says (24: 3 layers x 8 microbatches; 12: 12 layers) and
   prints its peak device memory; one process on the same global batches
   within the job's ``PE_LOSS_REL_BOUND``, a control whose gradients are
   never summed beyond it, the losses moving by ``PE_MOVE_FACTOR`` bounds;
   the control's processes time the stage hops and the masked sum, or the
   all-to-alls, and the gradient sum apart from the step.
32. the ``model`` and ``spatial`` axes across 2 processes (ROADMAP A.10
   part 2e) on phase 28a's dry-run stack, gloo-staged: ``cli train
   --stack`` of ``gpt_small_lm`` at full width with ``mesh.model=2``
   (``(data=1, model=2)``: 6 of the 12 heads and 1536 of the 3072 hidden
   units per process, bf16, batch 16 x 1024, 4 steps, dropout 0) and of
   ``maskrcnn_coco`` on its published mesh (``data=-1, spatial=2`` over 2
   processes: each its 512 rows of every 1024² image, bf16, batch 8, 3
   steps): the mesh line says ``model=2`` or ``spatial=2``, each process
   launches per step what ``TS_PER_STEP`` says (12 of each kernel, one
   per layer, for GPT; none for Mask R-CNN) and prints its step p50 and
   peak device memory; one process on the same global batches within the
   job's ``TS_LOSS_REL_BOUND``, a control whose gradients are never summed
   beyond it, the losses moving by ``TS_MOVE_FACTOR`` bounds; the control's
   processes time the ``model`` group's sums, or the conv halos and the
   pyramid's gather, apart from the step; and the three kernels timed and
   held against their plain versions at the per-process shape
   [16,6,1024,64] causal. Beside them, the Adafactor leg: two phase-28
   worker processes train ``gpt_small_lm`` at full width under Adafactor
   on ``(data=1, model=2)`` (batch 8 x 1024, 6 steps), within
   ``TS_ADAFACTOR_REL_BOUND`` of one process on the same global batches,
   a control with every sum over a split leaf's pieces skipped beyond it,
   each process launching 12 of each kernel per step.
33. ``cli train`` over the processes of this one host (ROADMAP A.10 part
   2f), in phase 26's directory: (a) ``cli train --preset
   transformer_nmt_wmt --processes 2`` (the two processes share the one
   card over gloo) with phase 28's config (full width, bf16, batch 128,
   dropout 0), 8 steps logged every 4, with ``train.step_window=4`` and
   with K = 1, and the control, two processes fed the same global batches
   with their gradients never summed, all three at once: exit 0 with
   process 0's final metrics, each process's first line naming gloo and
   "windows run eagerly (gloo)", each process's launches per step a
   one-process step's (18, 6, 6; it prints them), the K = 4 losses within
   ``HOST_LOSS_REL_BOUND`` of K = 1 at steps 4 and 8, the control beyond
   it, the losses moving by ``HOST_MOVE_FACTOR`` bounds; (b) this process
   joins a one-rank NCCL group and captures ``all_reduce_sum_``'s
   bucketed sum (bf16 and f32 buckets) and ``global_total`` between
   device work in one CUDA graph on a trainer's capture stream, 4 replays
   on fresh inputs equal to the eager code bit for bit, and prints
   ``torch.cuda.nccl.version()`` (one rank: NCCL capture works on this
   build, not two ranks' sums); (c) only with two cards or more, (a) over
   NCCL, a card per process, the K = 4 run replaying CUDA graphs with
   NCCL inside (its first lines say so), else it prints ``33c not run: 1
   card``; (d) ``parallel/collectives_bench.py`` on 2 processes sharing
   the card, 64 MB, the four ops' times and busbw (gloo: host-staged
   numbers, not a link's). On a machine with more cards, (a)'s and (d)'s
   processes see only the first.
34. the bench verb: (a) ``run_bench`` of the NMT, ResNet-50 with its input
   and the NMT at ``step_window=4``, each record measured on this card
   with its memory keys and an MFU share, the NMT's launches a step's
   worth per step, all ``tc``; (b) ``cli bench``'s record contracts
   (serve, speculation, int8, the fleets, ``--net``, the obs smoke) as
   processes of their own, beside phase 26; (c) ``bench --ops all
   --steps 3``, beside (d) ``cli bench --preset transformer_nmt_wmt
   --global-batch 128`` over ``--processes 2`` (the two share the card
   over gloo) and then ``1``: one record each, ``n_chips`` and
   ``mesh.data`` the process count, (a)'s NMT record's keys, each
   process's launches a step's worth per step, all ``tc``.

Phases 26-28 and 30-32 run their jobs at once (``at_once``), to keep the
script well inside its time limit: 26a beside 26b; 27a-27d beside 27e's
fleet; 28a-28b beside 28c, 28d and 28e; the four jobs of 30 and 31 (one
phase, "30-31"); the three of 32; 34c beside 34d. Each job's lines print
together once all have ended, with its seconds. The runs on the card in
this process (the one-process references, 27a-27d, 27e's reference
engine) take turns, so that this process's launch counts stay each path's
own. The jobs share the
card and the host's cores: a time that one of them measures (a step, an
exchange, an attempt, a TTFT) was taken beside the others. Every phase
prints its seconds, and the summary line carries them (``phase_s``).

``python3 chip_smoke.py --profile`` instead profiles steady greedy decode
ticks, ``--profile-train`` steady full-width bf16 NMT train steps, and
``--profile-resnet`` steady full-width bf16 ResNet-50 train steps (batch
256), ``--profile-bert`` steady full-width bf16 BERT-base train steps
(batch 1024 as 2 × 512), ``--profile-maskrcnn`` steady full-width bf16
Mask R-CNN train steps (batch 8), ``--profile-gpt`` steady full-width bf16
GPT-2-small train steps (batch 16 at 1024), ``--profile-vit`` steady
full-width bf16 ViT-S/16 train steps (batch 1024 as 4 × 256): host time
against device-busy time,
device ops per step, kernels ranked and, for the ResNet, BERT and Mask
R-CNN, device time by kind (convolutions forward / data-gradient /
weight-gradient, elementwise and reductions — BatchNorm's share —, copies
and casts, the optimizer; for BERT the bf16 and f32 GEMMs, the forward
kernel, softmax, layer norm and dropout; for Mask R-CNN the ROI-align
gathers and their ``index_add`` backward, the sorts, NMS's bool masks and
the targets' gathers; for GPT the three kernels, the bf16 GEMMs, the f32
tied logits, the log-softmax, layer norm, dropout and AdamW; for ViT the
three kernels, the patch convolution, the bf16 GEMMs, layer norm, dropout
and AdamW), and for BERT
and GPT the same step with ``train.remat`` in turns (step time, peak
memory, kernel launches); none prints a result line.

The script keeps the bytecode of what its processes import under
``deeplearning_cfn_tpu_torch/_build/pycache`` (``keep_bytecode``), so
that the processes it starts do not each compile torch from source.

Every ``run_experiment`` phase trains in a fresh workdir under
``deeplearning_cfn_tpu_torch/_build/`` and saves its checkpoint only at the
end (the save cadence is set past the run), so the timed steps hold no
save.

The whole script's seconds are printed before the card line. The line
before the last is the kernels JSON line; the last line is
``{"ok": true, "device": {...}}``. Without a card, or outside a checkout,
it exits nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"                 # the card every phase runs on
# cuBLAS's reproducible workspace setting, which strict deterministic
# algorithms (phase 24) require; PyTorch reads it once, at the first GEMM.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
SLOTS, SRC_LEN, HEADS, HEAD_DIM = 8, 128, 8, 64
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BWD_TOL = {"float32": 5e-4, "bfloat16": 5e-2}
TRAIN_BATCH, TRAIN_STEPS, PARITY_BATCH = 128, 12, 16
# Attention calls per microbatch step of the NMT model (6+6 layers): the
# forward kernel for every call; the backward kernels for the 6 bias-free
# causal decoder self-attentions; the reference VJP for the 6 encoder
# self-attentions and 6 cross-attentions (padding bias).
PER_STEP = {"fwd": 18, "dkdv": 6, "dq": 6, "vjp": 12}
# Phase 11: ResNet-50 at full width, bf16.
RESNET_BATCH, RESNET_WARMUP, RESNET_STEPS = 256, 2, 4
RESNET_CUTS = ["train.global_batch=256 (preset 8192, a 128-chip batch; lr "
               "by the preset's scale_with_batch rule)",
               "data.num_train_examples=1024 (preset 8192: 4.9 GB of f32 "
               "on the host)",
               "schedule.warmup_steps=2 (the preset's 5 of 90 epochs, "
               f"scaled to {RESNET_WARMUP + RESNET_STEPS} steps)",
               "eval on 512 examples"]
FEED_IMAGES, FEED_STORED, FEED_OUT = 1024, 256, 224
# Phase 12: ResNet-20 f32, card against CPU.
CIFAR_BATCH, CIFAR_STEPS = 128, 3
# Phase 13: BERT-base at full width, bf16. Attention calls per microbatch
# step: 12 self-attentions, each with the padding bias, so the forward
# kernel and the reference-VJP recompute for each, no backward kernel.
BERT_BATCH, BERT_ACCUM, BERT_WARMUP, BERT_STEPS = 1024, 2, 2, 8
BERT_SEQ, BERT_LAYERS, BERT_HEADS, BERT_PRED = 128, 12, 12, 25
BERT_PER_STEP = {"fwd": 12, "dkdv": 0, "dq": 0, "vjp": 12}
BERT_CUTS = ["train.grad_accum_steps=2 (the preset's global batch 1024 as "
             "2 microbatches of 512, to leave room on one 80 GB card)",
             f"train.steps={BERT_WARMUP + BERT_STEPS} (preset 100000: "
             f"{BERT_WARMUP} warm-up steps, {BERT_STEPS} timed)",
             "schedule.warmup_steps=2 (preset 3000, scaled to the step "
             "count)",
             "train.shard_opt_state ignored (ZeRO-1 over one device is the "
             "unsharded update)",
             "one checkpoint, the final forced save (every_steps past the "
             "run), so no save lands among the timed steps",
             "eval on the synthetic source's 512 examples, once, at the end"]
# Phase 14: checkpoint and resume on the card — BERT at full width cut to
# 2 layers, f32, batch 32: a run to 2k steps against a run killed after k
# and resumed.
RESUME_K, RESUME_BATCH, RESUME_TOL = 3, 32, 1e-4
# Phase 15: Mask R-CNN (maskrcnn_coco) at full width, bf16. No kernel of
# ours is on this path: the attention counts must not move.
MRCNN_BATCH, MRCNN_ACCUM, MRCNN_WARMUP, MRCNN_STEPS = 8, 1, 2, 5
MRCNN_EXAMPLES, MRCNN_EVAL, MRCNN_LR = 96, 16, 0.01
MRCNN_ROIS, MRCNN_MASK_ROIS = 256 + 100, 64  # post_nms_topk + max_boxes
MRCNN_CUTS = ["train.global_batch=8 (one card's share of the preset's 64), "
              "in one microbatch",
              "schedule.base_lr=0.01 (the preset's 0.08 at batch 64, scaled "
              "linearly to batch 8)",
              "data.num_train_examples=96 (the default 512 would be 6.4 GB "
              "of f32 host images)",
              f"train.steps={MRCNN_WARMUP + MRCNN_STEPS} (preset 24 epochs: "
              f"{MRCNN_WARMUP} warm-up steps, {MRCNN_STEPS} timed)",
              "schedule.warmup_steps=2 (preset 500, scaled to the step "
              "count; the step boundaries stay at 0.66 and 0.88 of the run)",
              "eval on 16 images (batch 8) with eval.detect_topk=100",
              "mesh data=-1, spatial=2 ignored: one card (A.10)",
              "one checkpoint, the final forced save"]
MRCNN_LOSSES = ("rpn_cls_loss", "rpn_box_loss", "roi_cls_loss",
                "roi_box_loss", "mask_loss", "proposal_recall")
# Phase 16: the tiny f32 Mask R-CNN (tests/test_detection.py's config) on
# the card against the CPU. The gather's backward is an index_add with
# atomics on the card, so the two agree to a tolerance, not bit for bit.
# The gradients' tolerance is the loss's own: it is piecewise smooth (ReLU
# and max-pool kinks, the top-k and NMS choices), and on the CPU alone an
# input change of 1e-7 relative moves its gradients by up to 5.7e-4 of the
# global norm (tests/test_torch_cuda.py::
# test_detection_loss_on_card_matches_cpu).
MRCNN_TINY = ["model.num_classes=7", "model.kwargs.image_size=64",
              "model.kwargs.pre_nms_topk=64", "model.kwargs.post_nms_topk=16",
              "model.kwargs.num_mask_rois=4", "model.kwargs.anchor_scale=4.0",
              "data.image_size=64", "data.max_boxes=4",
              "train.global_batch=4", "train.dtype=float32"]
MRCNN_LOSS_TOL, MRCNN_GRAD_TOL, MRCNN_VALUE_TOL = 1e-5, 1e-3, 1e-4
# Phases 17-18: GPT-2-small (gpt_small_lm) at full width, bf16. Its 12
# self-attentions are causal with no bias: per step the forward, dK/dV and
# dQ kernels 12 times each (tc), the reference VJP never; per eval batch 12
# forwards; per generated position 12 forwards on the decode variant.
GPT_BATCH, GPT_WARMUP, GPT_STEPS, GPT_EVAL = 16, 2, 8, 64
GPT_SEQ, GPT_LAYERS, GPT_HEADS, GPT_VOCAB = 1024, 12, 12, 32768
GPT_SHAPE = (GPT_BATCH, GPT_HEADS, GPT_SEQ, GPT_SEQ, HEAD_DIM)
GPT_PER_STEP = {"fwd": 12, "dkdv": 12, "dq": 12, "vjp": 0}
GPT_PROMPT, GPT_NEW, GPT_PARITY_BATCH = 16, 64, 8
GPT_CUTS = ["train.global_batch=16 in one microbatch (the preset's 512 is a "
            "v5p-32 batch; 16 is the JAX bench's per-chip batch)",
            f"train.steps={GPT_WARMUP + GPT_STEPS} (preset 100000: "
            f"{GPT_WARMUP} warm-up steps, {GPT_STEPS} timed)",
            "schedule.warmup_steps=2 (preset 2000, scaled to the step "
            "count)",
            "train.shard_opt_state ignored (ZeRO-1 over one device is the "
            "unsharded update)",
            "eval on 64 sequences (data.num_eval_examples=64), once, at "
            "the end",
            "one checkpoint, the final forced save (every_steps past the "
            "run), so no save lands among the timed steps"]

# Phase 21: ViT-S/16 (imagenet_vit_s16) at full width, bf16. Its 12
# self-attentions carry neither a bias nor causality (196 tokens: 3 full
# 64-key tiles and 4 keys): per microbatch the forward, dK/dV and dQ
# kernels 12 times each (tc), the reference VJP never; per eval batch 12
# forwards.
VIT_BATCH, VIT_ACCUM, VIT_WARMUP, VIT_STEPS = 1024, 4, 2, 4
VIT_LAYERS, VIT_HEADS, VIT_TOKENS = 12, 6, 196
VIT_TRAIN_EXAMPLES, VIT_EVAL, VIT_EVAL_BATCH = 1024, 512, 256
VIT_SHAPE = (VIT_BATCH // VIT_ACCUM, VIT_HEADS, VIT_TOKENS, VIT_TOKENS,
             HEAD_DIM)
VIT_PER_STEP = {"fwd": 12, "dkdv": 12, "dq": 12, "vjp": 0}
VIT_CUTS = ["train.grad_accum_steps=4 (the preset's global batch 1024 as 4 "
            "microbatches of 256)",
            f"train.steps={VIT_WARMUP + VIT_STEPS} (preset 300 epochs: "
            f"{VIT_WARMUP} warm-up steps, {VIT_STEPS} timed)",
            "schedule.warmup_steps=2 (the preset's 5 of 300 epochs, scaled "
            "to the step count)",
            "data.num_train_examples=1024 (synthetic ImageNet, 616 MB of "
            "f32 on the host: one epoch per step)",
            "eval on 512 examples at batch 256, once, at the end",
            "train.shard_opt_state ignored (ZeRO-1 over one device is the "
            "unsharded update)",
            "one checkpoint, the final forced save (every_steps past the "
            "run)"]
# Phase 21's tiny f32 ViT (tests/test_torch_vit.py's config), card vs CPU.
VIT_TINY = ["model.name=vit_tiny", "model.num_classes=10",
            "model.kwargs.dropout_rate=0.0", "data.image_size=16",
            "train.dtype=float32", "data.num_train_examples=80",
            "train.global_batch=16", "schedule.warmup_steps=2",
            "schedule.warmup_epochs=0", "schedule.base_lr=3e-3"]
# Phase 22: BERT-base with Mixture-of-Experts FFNs (bert_moe_wikipedia): 8
# experts in every other layer, top-2, capacity factor 1.25 (40 slots per
# expert at sequence 128). Its attention calls are BERT-base's.
MOE_CUTS = BERT_CUTS + [
    "mesh.expert=8 ignored (one device holds every expert; phase 31 "
    "splits them over 4 processes)"]
# Phase 22's tiny f32 MoE models (tests/test_torch_moe.py's configs).
MOE_TINY = ["model.kwargs.num_experts=4", "model.kwargs.moe_every=2",
            "model.kwargs.moe_top_k=2", "model.kwargs.moe_capacity_factor=0.5",
            "model.kwargs.dropout_rate=0.0", "train.dtype=float32"]
MOE_BERT_TINY = ["model.name=bert_tiny", "model.kwargs.hidden_size=32",
                 "model.kwargs.num_layers=2", "model.kwargs.num_heads=2",
                 "model.kwargs.mlp_dim=64", "model.kwargs.max_len=32",
                 "data.vocab_size=64", "data.seq_len=16",
                 "data.num_train_examples=16"] + MOE_TINY
MOE_GPT_TINY = ["model.name=gpt_tiny", "model.kwargs.max_len=64",
                "data.vocab_size=512", "data.seq_len=16"] + MOE_TINY
# Phase 23: the pipelined BERT trunk (bert_pipelined_wikipedia) on one card:
# the plain layer scan of its stacked parameters; BERT-base's attention
# calls.
PIPE_CUTS = BERT_CUTS + [
    "model.kwargs.n_microbatches=8 and mesh.pipe=4 ignored (one device "
    "runs the plain layer scan; phase 31 runs the GPipe schedule over 4 "
    "processes)"]
# Phase 24: train.step_window=4 (ROADMAP A.5b): each run twice from one seed
# and the same batches, K = 1 (eager steps) then K = 4 (windows whose steps
# replay one captured CUDA graph, after the eager warm-up step). The batches
# are WINDOW distinct ones, staged on the card once and cycled.
WINDOW, WINDOW_STEPS, WINDOW_TINY_STEPS = 4, 8, 4
# A replay runs the eager step's kernels on the same addresses, so the two
# agree bit for bit where the step has no atomics. Where it has (the
# embedding and index_add backward, cuDNN's weight gradients), the order
# of additions changes from run to run — between two eager runs too — and
# the losses and weights then agree to these bounds, relative to the
# largest |value|: in f32 the resume check's 1e-4 (phase 14); in bf16 a
# last-bit difference in an f32 weight can flip a bf16 rounding
# downstream, 2e-3.
WINDOW_TOL = {"float32": 1e-4, "bfloat16": 2e-3}
# The tiny presets run K = 1 twice and K = 4, all three under
# ``deterministic``: there no atomics reorder additions, so every pair must
# agree bit for bit (a bound of 0). Without it a last-bit difference from
# Mask R-CNN's index_add can flip a top-k or NMS choice, and two eager runs
# part by up to 4% of the loss.
WINDOW_VIT = [f"train.global_batch={VIT_BATCH}",
              f"train.grad_accum_steps={VIT_ACCUM}",
              "schedule.warmup_steps=2",
              f"data.num_train_examples={VIT_TRAIN_EXAMPLES}",
              f"data.num_eval_examples={VIT_EVAL_BATCH}",
              f"train.eval_batch={VIT_EVAL_BATCH}",
              "train.eval_every_steps=1000000",
              "checkpoint.every_steps=1000000"]
WINDOW_CUTS = ["ViT: phase 21's cuts; NMT: phase 9's (batch 128, dropout "
               "0.1 kept)",
               f"{WINDOW} distinct batches, cycled over {WINDOW_STEPS} steps "
               f"(the other presets: tiny f32 cuts, {WINDOW_TINY_STEPS} "
               f"steps)",
               "through run_experiment (cli train's path): 8 steps, log "
               "every 4, eval on one batch"]
_BERT_TINY = ["model.name=bert_tiny", "model.kwargs.hidden_size=32",
              "model.kwargs.num_layers=2", "model.kwargs.num_heads=2",
              "model.kwargs.mlp_dim=64", "model.kwargs.max_len=32",
              "data.vocab_size=64", "data.seq_len=16", "train.global_batch=8",
              "data.num_train_examples=64"]
# The other trainable presets, as tiny f32 cuts (phases 12, 14, 16 and
# 22's). BERT runs with the forward recomputed in the backward, dropout on
# and two microbatches: the recompute's masks come from the twin
# generators a capture registers (train/graphs.py).
WINDOW_TINY = {
    "cifar10_resnet20": ["train.global_batch=32",
                         "data.num_train_examples=128"],
    "imagenet_resnet50": ["model.num_classes=10", "data.image_size=64",
                          "model.kwargs.num_filters=16",
                          "train.global_batch=8",
                          "data.num_train_examples=32"],
    "bert_base_wikipedia": _BERT_TINY + ["model.kwargs.dropout_rate=0.1",
                                         "train.remat=true",
                                         "train.grad_accum_steps=2"],
    "maskrcnn_coco": MRCNN_TINY + ["data.num_train_examples=16",
                                   "schedule.name=constant",
                                   "schedule.base_lr=0.01"],
    "gpt_small_lm": ["model.name=gpt_tiny", "model.kwargs.max_len=64",
                     "data.vocab_size=512", "data.seq_len=32",
                     "train.global_batch=8", "data.num_train_examples=64"],
    "bert_moe_wikipedia": MOE_BERT_TINY + ["train.global_batch=8"],
    "bert_pipelined_wikipedia": _BERT_TINY[1:] + [
        "model.kwargs.n_microbatches=2"],
}


_LINES = threading.local()    # a job's own lines while jobs run at once
# One run on the card in this process at a time, and one ``cli_inprocess``
# (its stdout redirection is the process's), while jobs run at once.
IN_PROCESS, CLI = threading.Lock(), threading.RLock()
PHASE_S = {}                    # each phase's seconds, by number
_PHASE = {}


def mfu_share(examples_per_s, flops):
    """A training rate's MFU share: 3 × the forward FLOPs per example
    (forward and backward) per second over 989 TFLOP/s, as
    ``deeplearning_cfn_tpu_torch.bench.run_bench`` counts it."""
    return examples_per_s * 3 * flops / BF16_FLOP_PER_S


def log(msg: str) -> None:
    lines = getattr(_LINES, "lines", None)
    if lines is None:
        print(msg, flush=True)
    else:
        lines.append(msg)


def end_phase() -> None:
    """Print the seconds of the phase under way, if any."""
    if _PHASE:
        number, t = _PHASE.pop("number"), _PHASE.pop("t")
        PHASE_S[number] = time.perf_counter() - t
        log(f"  phase {number} {PHASE_S[number]:.1f} s")


def phase(name: str):
    end_phase()
    log(f"== {name}")
    _PHASE.update(number=name.split(".")[0], t=time.perf_counter())
    return _PHASE["t"]


def at_once(jobs):
    """Run the ``(label, fn)`` jobs each in its own thread, all at once;
    then print each job's lines in turn, ending with its seconds. Returns
    ``{label: fn()}`` (a dict result gains ``phase_s``); the first failure
    is raised once every job has ended. The jobs are processes of their
    own or wait for ``IN_PROCESS``, and they share the card and the host's
    cores: a time that one of them measures was taken beside the
    others."""
    done = {}

    def run(label, fn):
        _LINES.lines = []
        t = time.perf_counter()
        try:
            result, error = fn(), None
        except BaseException as e:  # re-raised below, in this thread
            result, error = None, e
        done[label] = (result, error, time.perf_counter() - t,
                       _LINES.lines)

    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    out, errors = {}, []
    for label, _ in jobs:
        result, error, seconds, lines = done[label]
        for line in lines:
            log(line)
        log(f"  {label} {seconds:.1f} s"
            + (f" (failed: {error!r:.300})" if error else ""))
        if isinstance(result, dict):
            result["phase_s"] = seconds
        out[label] = result
        if error is not None:
            errors.append(error)
    if errors:
        raise errors[0]
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


# (name, Sq, bias?) of the three attention calls of the serving path at 8
# slots: encoder self-attention, decode cross-attention, decode
# self-attention over the gathered paged span (per-row step bias).
MAIN_PATH_SHAPES = [("encoder_self", SRC_LEN, True),
                    ("decode_cross", 1, True),
                    ("decode_self_paged", 1, True)]


def make_inputs(torch, seed, b, h, sq, sk, d, dtype, bias_kind,
                causal=False, strided=False):
    """q, k, v [b, h, s, d] (``strided``: the model's layout, a [b, s, h, d]
    tensor seen through ``transpose(1, 2)``) and an optional padding bias."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def mk(s):
        shape = (b, s, h, d) if strided else (b, h, s, d)
        x = torch.randn(shape, generator=g, device=DEVICE,
                        dtype=torch.float32).to(dtype)
        return x.transpose(1, 2) if strided else x

    q, k, v = mk(sq), mk(sk), mk(sk)
    bias = None
    if bias_kind:
        # A padding/step bias [b, 1, 1, sk]: row i keeps its first
        # lengths[i] keys; without causal the last row is all masked (an
        # all-PAD slot — see csrc/flash_attn_fwd.cu on causal + all-masked).
        lengths = torch.randint(1, sk + 1, (b,), generator=g, device=DEVICE)
        if not causal:
            lengths[-1] = 0
        keys = torch.arange(sk, device=DEVICE)
        bias = torch.where(keys[None, :] < lengths[:, None], 0.0, -1e30)
        bias = bias.float()[:, None, None, :]
    return q, k, v, bias


# Phase 3's speculative verify cases: γ = 1, 4, 8 (Sq = γ+1) at 8 slots
# against 128 cache slots, each row at its own position; the last rows'
# spans run past max_len (128), where every key is visible.
VERIFY_GAMMAS = (1, 4, 8)
VERIFY_POS = (0, 9, 40, 77, 118, 123, 126, 127)
SPEC_GAMMA = 4


def span_inputs(torch, seed, sq, dtype, paged):
    """q [8, 8, sq, 64] in the model's strided layout against a 128-slot
    cache — the dense row table, or (``paged``) the span gathered through
    block tables of 16-slot blocks, entries past a row's span pointing at
    the null block 0 (filled with large values the bias must hide) — and
    the model's own span bias [8, 1, sq, 128] from ``VERIFY_POS``."""
    from deeplearning_cfn_tpu_torch.models.transformer import span_bias

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    b, h, d, span, bs = SLOTS, HEADS, HEAD_DIM, SRC_LEN, 16

    def randn(*shape):
        return torch.randn(shape, generator=g, device=DEVICE,
                           dtype=torch.float32).to(dtype)

    q = randn(b, sq, h, d).transpose(1, 2)
    pos = torch.tensor(VERIFY_POS, device=DEVICE)
    if paged:
        mb = span // bs
        pools = [randn(b * mb + 1, h, bs, d) for _ in range(2)]
        for pool in pools:
            pool[0] = 100.0
        tables = (torch.randperm(b * mb, generator=g, device=DEVICE) + 1) \
            .view(b, mb)
        bound = (torch.clamp(pos + sq, max=span) + bs - 1) // bs
        tables = torch.where(torch.arange(mb, device=DEVICE)[None, :]
                             < bound[:, None], tables, 0)
        k, v = (pool[tables].transpose(1, 2).reshape(b, h, span, d)
                for pool in pools)
    else:
        k, v = randn(b, h, span, d), randn(b, h, span, d)
    return q, k, v, span_bias(pos, sq, span)


def check_kernel(torch, attn):
    """Phase 3: kernel vs plain version on the card. Returns max errors."""
    errs = {"float32": 0.0, "bfloat16": 0.0}
    cases = [(name, SLOTS, HEADS, sq, SRC_LEN, HEAD_DIM, False, bias, False)
             for name, sq, bias in MAIN_PATH_SHAPES]
    cases += [(name + "_strided", SLOTS, HEADS, sq, SRC_LEN, HEAD_DIM, False,
               bias, True) for name, sq, bias in MAIN_PATH_SHAPES]
    cases += [("train_strided", 4, HEADS, SRC_LEN, SRC_LEN, HEAD_DIM, True,
               False, True),
              ("causal", 2, 4, 96, 96, 64, True, False, False),
              ("ragged_causal", 2, 4, 37, 101, 64, True, False, False),
              ("ragged_bias", 3, 2, 45, 77, 64, False, True, False),
              ("decode_15", 2, 4, 15, 77, 64, True, False, False),
              ("tc_16", 2, 4, 16, 101, 64, False, True, False),
              ("tc_65", 2, 4, 65, 101, 64, True, False, True),
              ("head_dim_16", 2, 3, 50, 70, 16, False, True, False),
              ("head_dim_128", 2, 2, 33, 65, 128, True, True, False),
              ("head_dim_128_decode", 2, 2, 1, 65, 128, False, True, True),
              # GPT's rows (phase 17): 16 KV tiles, off the tile on both
              # sides, and its decode step over a 1024-slot cache.
              ("long_1023", 1, 2, 1023, 1023, 64, True, False, False),
              ("long_1024_strided", 1, 2, 1024, 1024, 64, True, False, True),
              ("long_1025", 1, 2, 1025, 1025, 64, True, False, False),
              ("decode_1024", 8, 12, 1, 1024, 64, False, True, True)]
    # The speculative verify spans (dense cache and paged gather).
    cases += [(f"verify_g{gm}{'_paged' if paged else ''}", SLOTS, HEADS,
               gm + 1, SRC_LEN, HEAD_DIM, False,
               "span_paged" if paged else "span", True)
              for gm in VERIFY_GAMMAS for paged in (False, True)]
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        for i, (name, b, h, sq, sk, d, causal, bias_kind, strided) in \
                enumerate(cases):
            if str(bias_kind).startswith("span"):
                q, k, v, bias = span_inputs(torch, 100 + i, sq, dtype,
                                            bias_kind == "span_paged")
            else:
                q, k, v, bias = make_inputs(torch, 100 + i, b, h, sq, sk, d,
                                            dtype, bias_kind, causal,
                                            strided)
            variant = attn.forward_variant(dtype, sq, d)
            if name.startswith("verify") and dtype == torch.bfloat16 \
                    and variant != "decode":
                raise AssertionError(f"{name}: bf16 verify takes {variant}")
            before = attn.flash_attention_forward.variant_launches[variant]
            out, lse = attn.flash_attention_forward(q, k, v, bias, causal,
                                                    return_lse=True)
            torch.cuda.synchronize()
            if attn.flash_attention_forward.variant_launches[variant] \
                    != before + 1:
                raise AssertionError(f"{name}: not launched as {variant}")
            ref = attn.attention_reference(q, k, v, bias, causal)
            err = (out.float() - ref.float()).abs().max().item()
            ref_lse = attn._reference_lse(q, k, bias, causal,
                                          1.0 / math.sqrt(d))
            lse_err = ((lse - ref_lse).abs()
                       / ref_lse.abs().clamp_min(1.0)).max().item()
            scaled = scaled_error(out, ref)
            ok = err <= TOL[dtype_name] and lse_err <= 1e-3 \
                and scaled["ok"]
            log(f"  {dtype_name:8s} {name:24s} [{b},{h},{sq},{sk},{d}] "
                f"causal={causal} {variant:6s} max_abs_err={err:.3e} "
                f"lse_rel_err={lse_err:.3e} {scaled_line(scaled)} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"flash kernel disagrees with its plain version: "
                    f"{dtype_name} {name} err={err} lse_err={lse_err} "
                    f"{scaled}")
            errs[dtype_name] = max(errs[dtype_name], err)
    return errs


def time_fn(torch, fn, iters=200, warmup=20):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters=50, warmup=5):
    """Device time per call: CUDA events around ``iters`` calls queued
    behind a busy-wait on the card (``torch.cuda._sleep``), so that the
    card runs them back to back with the host's time between launches
    hidden (at the serving shapes that time is most of a call, and
    ``time_fn`` counts it). The busy-wait is lengthened until it outlasts
    the host's queueing of the calls.

    torch.profiler's kernel rows are not used: over the whole of this
    script they recorded ever fewer of the launches the host made (1 of 50
    by phase 8, 6 of 20 by phase 17; none lost in a fresh process), and a
    short session's time per recorded launch read up to 14% high."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = 1 << 21
    for _ in range(8):
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ev[2].record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        ev[2].synchronize()
        slept_ms = ev[0].elapsed_time(ev[1])
        if slept_ms > 1.2 * queued_ms + 0.1:
            return ev[1].elapsed_time(ev[2]) / iters
        cycles = int(cycles * 2 * (queued_ms + 0.1) / max(slept_ms, 1e-3))
    raise AssertionError(f"the busy-wait ({slept_ms:.3f} ms) never outlasted "
                         f"queueing {iters} calls ({queued_ms:.3f} ms)")


def dev_time(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def kernel_rows(prof):
    """The profile's kernel rows. An operator's, autograd Function's or
    annotated range's row (the optimizer step is one, on the device timeline
    too) repeats the device time of the kernels it launched, which have rows
    of their own."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if dev_time(e) > 0 and e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def time_row(torch, kernel, strided, before, plain, library, iters, warmup,
             plain_iters, plain_warmup):
    """One timing row: CUDA events over back-to-back calls (``*_ms``, the
    host's time included where it is the slower side) and device times
    (``*device_ms*``) of the kernel, of the first port's kernel body on the
    same inputs (``before``: the ``simt`` variant, the CUDA-core kernel
    before the tensor-core redesign), and of the library call; events of the plain version; device time
    of the kernel on the model's strided layout."""
    return dict(
        kernel_ms=time_fn(torch, kernel, iters, warmup),
        kernel_ms_before=time_fn(torch, before, iters, warmup),
        plain_ms=time_fn(torch, plain, plain_iters, plain_warmup),
        library_ms=time_fn(torch, library, iters, warmup),
        device_ms=device_ms(torch, kernel, iters, warmup),
        device_ms_strided=device_ms(torch, strided, iters, warmup),
        device_ms_before=device_ms(torch, before, iters, warmup),
        library_device_ms=device_ms(torch, library, iters, warmup))


def bound_ms(b, h, sq, sk, d, elem_bytes, bias):
    """Least time for one call: each input read once and the output written
    once over HBM bandwidth, vs QKᵀ and PV operations over the peak rate."""
    nbytes = elem_bytes * (b * h * sq * d + 2 * b * h * sk * d
                           + b * h * sq * d)
    if bias is not None:
        nbytes += 4 * bias.numel()
    flops = 4.0 * b * h * sq * sk * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def time_kernel(torch, attn):
    """Phase 4: kernel / plain / library times at the three shapes (bf16,
    the serving dtype)."""
    F = torch.nn.functional
    rows = []
    for i, (name, sq, bias_kind) in enumerate(MAIN_PATH_SHAPES):
        q, k, v, bias = make_inputs(torch, 200 + i, SLOTS, HEADS, sq,
                                    SRC_LEN, HEAD_DIM, torch.bfloat16,
                                    bias_kind)
        qs, ks, vs, _ = make_inputs(torch, 200 + i, SLOTS, HEADS, sq,
                                    SRC_LEN, HEAD_DIM, torch.bfloat16,
                                    bias_kind, strided=True)
        lib_mask = None if bias is None else bias.to(torch.bfloat16)
        # (Timing launches are comparisons, not the main path's: the counts
        # are set to 0 before phase 5.)
        t = time_row(
            torch, lambda: attn.flash_attention_forward(q, k, v, bias),
            lambda: attn.flash_attention_forward(qs, ks, vs, bias),
            lambda: attn._launch(q, k, v, bias, False, HEAD_DIM ** -0.5,
                                 False, "simt"),
            lambda: attn.attention_reference(q, k, v, bias),
            lambda: F.scaled_dot_product_attention(q, k, v,
                                                   attn_mask=lib_mask),
            200, 20, 200, 20)
        b_ms, by, nbytes, flops = bound_ms(SLOTS, HEADS, sq, SRC_LEN,
                                           HEAD_DIM, 2, bias)
        row = dict(shape=name, q=[SLOTS, HEADS, sq, HEAD_DIM],
                   kv=[SLOTS, HEADS, SRC_LEN, HEAD_DIM], dtype="bfloat16",
                   variant=attn.forward_variant(torch.bfloat16, sq,
                                                HEAD_DIM),
                   **t, bound_ms=b_ms, bound_by=by, bytes=nbytes,
                   flops=flops)
        log_times(name, row)
        rows.append(row)
    return rows


def log_times(name, row):
    us = {k: v * 1e3 for k, v in row.items() if "_ms" in k}
    log(f"  {name:20s} {row['variant']:6s} per call (events): kernel "
        f"{us['kernel_ms']:8.2f} us (simt {us['kernel_ms_before']:8.2f})  "
        f"plain {us['plain_ms']:8.2f}  library {us['library_ms']:7.2f}; "
        f"device time: kernel {us['device_ms']:7.2f} (strided "
        f"{us['device_ms_strided']:7.2f}, simt {us['device_ms_before']:7.2f})"
        f"  library {us['library_device_ms']:7.2f}; bound "
        f"{us['bound_ms']:6.3f} ({row['bound_by']})")


def make_requests(n=24, n_beam=4, vocab=32000, seed=0):
    import numpy as np

    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        length = int(rng.randint(8, 121))
        src = [int(t) for t in rng.randint(3, vocab, size=length - 1)] + [2]
        beam = 4 if i % (n // n_beam) == n // n_beam - 1 else 1
        reqs.append((f"r{i}", src, 32, beam))
    return reqs


def no_checkpoint_dir():
    """A workdir that holds no checkpoint: engines serve a seeded init."""
    return os.path.join(REPO, "deeplearning_cfn_tpu_torch", "_build",
                        "no_checkpoint")


def smoke_cfg(dtype: str):
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.presets import get_preset

    return apply_overrides(get_preset("transformer_nmt_wmt"),
                           [f"workdir={no_checkpoint_dir()}",
                            f"train.dtype={dtype}", "train.seed=0"])


def build_engine(cfg, **kw):
    """Phase 5's engine (8 slots, paged blocks of 16, prefix cache 32,
    decode window 4, seeded init) with the loader options ``kw``."""
    from deeplearning_cfn_tpu_torch.serve.loader import load_engine

    kw.setdefault("decode_window", 4)
    engine, _, at_step = load_engine(
        cfg, capacity=SLOTS, max_src_len=SRC_LEN, kv_block_size=16,
        prefix_cache_size=32, allow_init=True, device="gpu", **kw)
    assert at_step == -1
    return engine


def serve(torch, attn, reqs):
    """Phase 5: the main path, with every launch count set to 0 first."""
    set_counts(attn, 0)
    t_build = time.perf_counter()
    engine = build_engine(smoke_cfg("bfloat16"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rid, src, budget, beam in reqs:
        engine.submit(src, max_new_tokens=budget, beam_size=beam,
                      request_id=rid)
    ticks = engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = attn.flash_attention_forward.launches
    variants = dict(attn.flash_attention_forward.variant_launches)
    model = engine.model
    states = {rid: engine.poll(rid).state.value for rid, *_ in reqs}
    bad = {r: s for r, s in states.items() if s != "done"}
    if bad:
        raise AssertionError(f"requests not done: {bad}")
    tokens = {rid: list(engine.poll(rid).tokens) for rid, *_ in reqs}
    for rid, toks in tokens.items():
        if not toks or any(not 0 <= t < model.vocab_size for t in toks):
            raise AssertionError(f"{rid}: bad tokens {toks}")
    expect = (model.num_layers * engine.encoder_forwards
              + 2 * model.num_layers * engine.decoder_steps)
    log(f"  model: vocab {model.vocab_size}, hidden {model.hidden_size}, "
        f"{model.num_layers}+{model.num_layers} layers, {model.num_heads} "
        f"heads, max_len {model.max_len}, {model.dtype}; engine built in "
        f"{t0 - t_build:.2f} s")
    log(f"  {len(reqs)} requests done in {ticks} ticks, {wall:.3f} s; "
        f"encoder forwards {engine.encoder_forwards}, decoder steps "
        f"{engine.decoder_steps}; flash launches {launches} (expected "
        f"{model.num_layers}*{engine.encoder_forwards} + "
        f"{2 * model.num_layers}*{engine.decoder_steps} = {expect})")
    if launches <= 0 or launches != expect:
        raise AssertionError(
            f"flash kernel launches {launches} != expected {expect}")
    log(f"  launches by variant: {variants}")
    if variants["simt"] or variants["tc"] + variants["decode"] != launches:
        raise AssertionError(f"bf16 serving launches off the tc/decode "
                             f"variants: {variants}")
    snap = engine.metrics.snapshot()
    generated = sum(len(t) for t in tokens.values())
    step_ms = snap["serve_step_latency_p50_s"] * 1e3
    log(f"  tokens/s {generated / wall:.1f} ({generated} tokens), TTFT p50 "
        f"{snap['serve_ttft_p50_s'] * 1e3:.2f} ms, decode-step p50 "
        f"{step_ms:.3f} ms, slot occupancy {snap['serve_slot_occupancy']}")
    return dict(launches=launches, variant_launches=variants,
                encoder_forwards=engine.encoder_forwards,
                decoder_steps=engine.decoder_steps, wall_s=wall,
                tokens=generated, tokens_per_s=generated / wall,
                ttft_p50_s=snap["serve_ttft_p50_s"],
                decode_step_p50_ms=step_ms, tokens_by_request=tokens)


def f32_parity(torch, reqs):
    """Phase 6: f32 engine through the kernel vs through the plain
    version — first decode step logits, then greedy tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = smoke_cfg("float32")
    engines = {impl: build_engine(cfg, attention_impl=impl)
               for impl in ("kernel", "reference")}
    greedy = [r for r in reqs if r[3] == 1]
    src = torch.zeros((SLOTS, SRC_LEN), dtype=torch.long, device="cuda")
    for i, (_, ids, _, _) in enumerate(greedy[:SLOTS]):
        src[i, :len(ids)] = torch.tensor(ids, device="cuda")
    mask = (src != 0).long()
    pos = torch.zeros((SLOTS,), dtype=torch.long, device="cuda")
    bos = torch.ones((SLOTS, 1), dtype=torch.long, device="cuda")
    logits = {}
    with torch.no_grad():
        for impl, eng in engines.items():
            model = eng.model
            enc = model.encode(src, mask)
            logits[impl] = model.decode_step_at(
                bos, enc, mask, pos, model.init_cache(SLOTS))
    err = (logits["kernel"] - logits["reference"]).abs().max().item()
    log(f"  first decode step logits, kernel vs plain (f32): max abs diff "
        f"{err:.3e}")
    if not err <= 1e-3:
        raise AssertionError(f"f32 logits differ by {err} > 1e-3")
    outs = {}
    for impl, eng in engines.items():
        for rid, ids, budget, _ in greedy:
            eng.submit(ids, max_new_tokens=budget, request_id=rid)
        eng.run_until_drained()
        outs[impl] = {rid: list(eng.poll(rid).tokens)
                      for rid, *_ in greedy}
    same = sum(outs["kernel"][r] == outs["reference"][r] for r in outs[
        "kernel"])
    log(f"  greedy requests token-identical, kernel vs plain (f32): "
        f"{same}/{len(greedy)}")
    return err, same, len(greedy)


# -- training slice: backward kernels, their timing, the train path --------

TRAIN_SHAPE = (TRAIN_BATCH, HEADS, SRC_LEN, SRC_LEN, HEAD_DIM)


def close_enough(got, ref, tol):
    """|got - ref| <= tol + tol * |ref| everywhere (absolute + relative)."""
    got, ref = got.float(), ref.float()
    return bool(((got - ref).abs() <= tol + tol * ref.abs()).all())


# Limits on the reference's own scale, which an absolute limit misses where
# the values are small (GPT's dK/dV past key 512 are ~0.02-0.05): the
# relative norm error, and the largest error against the largest |ref|.
SCALED_TOL = {"rel_norm": 1e-2, "max_err_of_max_ref": 2e-2}


# bf16 logits after 12 layers: rounding each attention output at 2^-9
# moves GPT-2-small's first-step logits by a relative norm of 1.1e-2 (CPU).
GEN_BF16_TOL = {"rel_norm": 5e-2, "max_err_of_max_ref": 5e-2}


def scaled_error(got, ref, tol=SCALED_TOL):
    """``got`` against ``ref`` on ref's scale: ‖got − ref‖ / ‖ref‖, the
    largest |got − ref|, the largest and the median |ref|, and ``ok``
    (both limits of ``tol`` hold and ``got`` is finite)."""
    got, ref = got.float(), ref.float()
    diff = got - ref
    e = dict(rel_norm=(diff.norm() / ref.norm().clamp_min(1e-30)).item(),
             max_abs_err=diff.abs().max().item(),
             max_ref=ref.abs().max().item(),
             median_ref=ref.abs().flatten().median().item(),
             rel_norm_limit=tol["rel_norm"],
             max_abs_limit=tol["max_err_of_max_ref"]
             * ref.abs().max().item())
    e["ok"] = (e["rel_norm"] <= e["rel_norm_limit"]
               and e["max_abs_err"] <= e["max_abs_limit"]
               and bool(got.isfinite().all()))
    return e


def scaled_line(e):
    """One log fragment: the errors beside their limits and median |ref|."""
    return (f"rel {e['rel_norm']:.2e} (<= {e['rel_norm_limit']:.0e}), "
            f"max {e['max_abs_err']:.2e} (<= {e['max_abs_limit']:.2e}), "
            f"median|ref| {e['median_ref']:.2e}")


def bwd_inputs(torch, attn, seed, b, h, sq, sk, d, dtype, causal,
               strided=False):
    q, k, v, _ = make_inputs(torch, seed, b, h, sq, sk, d, dtype, False,
                             strided=strided)
    g = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    do = torch.randn((b, sq, h, d) if strided else (b, h, sq, d),
                     generator=g, device=DEVICE).to(dtype)
    if strided:  # the gradient _merge hands back: a transposed view
        do = do.transpose(1, 2)
    out, lse = attn.flash_attention_forward(q, k, v, causal=causal,
                                            return_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    return q, k, v, do, lse, delta, causal, 1.0 / math.sqrt(d)


def check_backward(torch, attn):
    """Phase 7: the backward kernels and the autograd Function vs their
    plain versions on the card. Returns max abs errors per kernel."""
    errs = {"flash_attn_bwd_dkdv": 0.0, "flash_attn_bwd_dq": 0.0}
    cases = [("train_causal", *TRAIN_SHAPE, True, False),
             ("train_strided", *TRAIN_SHAPE, True, True),
             ("train_full", 8, HEADS, SRC_LEN, SRC_LEN, HEAD_DIM, False,
              False),
             ("ragged_causal", 2, 3, 37, 101, 64, True, False),
             ("ragged", 2, 3, 37, 101, 64, False, False),
             ("q_rows_1", 4, 8, 1, 128, 64, False, True),
             ("q_rows_63", 2, 3, 63, 63, 64, False, False),
             ("q_rows_64", 2, 3, 64, 100, 128, True, False),
             ("q_rows_65", 2, 3, 65, 77, 64, True, True),
             ("q_rows_127", 2, 3, 127, 129, 64, True, True),
             ("q_rows_129", 2, 3, 129, 200, 128, False, False),
             ("q_rows_129_causal", 2, 3, 129, 150, 64, True, False),
             ("off_tile_d16", 3, 2, 45, 45, 16, True, False),
             ("d16_ragged", 2, 2, 50, 70, 16, False, False),
             ("d128", 2, 2, 33, 65, 128, False, False),
             ("d128_causal", 1, 2, 70, 70, 128, True, False),
             ("long_1023", 1, 2, 1023, 1023, 64, True, False),
             ("long_1024", 1, 2, 1024, 1024, 64, True, True),
             ("long_1025", 1, 2, 1025, 1025, 64, True, False)]
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        tol = BWD_TOL[dtype_name]
        for i, (name, b, h, sq, sk, d, causal, strided) in enumerate(cases):
            args = bwd_inputs(torch, attn, 300 + i, b, h, sq, sk, d, dtype,
                              causal, strided)
            variant = attn.backward_variant(dtype, d)
            before = {fn: fn.variant_launches[variant] for fn in (
                attn.flash_attn_bwd_dkdv, attn.flash_attn_bwd_dq)}
            dk, dv = attn.flash_attn_bwd_dkdv(*args)
            dq = attn.flash_attn_bwd_dq(*args)
            torch.cuda.synchronize()
            for fn, n in before.items():
                if fn.variant_launches[variant] != n + 1:
                    raise AssertionError(f"{name}: {fn.__name__} not "
                                         f"launched as {variant}")
            rk, rv = attn.flash_bwd_dkdv_reference(*args)
            rq = attn.flash_bwd_dq_reference(*args)
            line, rel = [], []
            for kname, pairs in (("flash_attn_bwd_dkdv", ((dk, rk), (dv, rv))),
                                 ("flash_attn_bwd_dq", ((dq, rq),))):
                for got, ref in pairs:
                    scaled = scaled_error(got, ref)
                    err = scaled["max_abs_err"]
                    errs[kname] = max(errs[kname], err)
                    line.append(err)
                    rel.append(scaled["rel_norm"])
                    if not (close_enough(got, ref, tol) and scaled["ok"]):
                        raise AssertionError(
                            f"{kname} disagrees with its plain version: "
                            f"{dtype_name} {name} max abs err {err}; "
                            f"{scaled_line(scaled)}")
            # The Function against autograd of the plain attention.
            q, k, v = (t.detach().requires_grad_() for t in args[:3])
            g = args[3]
            got = torch.autograd.grad(
                attn.fused_attention(q, k, v, causal=causal), (q, k, v), g)
            ref = torch.autograd.grad(
                attn.attention_reference(q, k, v, causal=causal), (q, k, v),
                g)
            fn_err = max((a.float() - r.float()).abs().max().item()
                         for a, r in zip(got, ref))
            if not all(close_enough(a, r, tol) for a, r in zip(got, ref)):
                raise AssertionError(
                    f"FlashAttention grads disagree with autograd of the "
                    f"reference: {dtype_name} {name} max abs err {fn_err}")
            log(f"  {dtype_name:8s} {name:14s} [{b},{h},{sq},{sk},{d}] "
                f"causal={causal} {variant:4s} dk {line[0]:.3e} "
                f"dv {line[1]:.3e} dq {line[2]:.3e} (rel dk/dv/dq "
                f"{rel[0]:.1e}/{rel[1]:.1e}/{rel[2]:.1e} <= "
                f"{SCALED_TOL['rel_norm']:.0e}) Function vs autograd "
                f"{fn_err:.3e} ok")
    # Rows that saw no key carry lse = +1e30: their dQ is exactly 0.
    for causal in (False, True):
        q, k, v, do, lse, delta, _, scale = bwd_inputs(
            torch, attn, 398, 2, 3, 129, 150, HEAD_DIM, torch.bfloat16,
            causal)
        lse = lse.clone()
        lse[:, :, 5] = 1e30
        lse[1, 0, 63:] = 1e30
        args = (q, k, v, do, lse, delta, causal, scale)
        dq = attn.flash_attn_bwd_dq(*args)
        rq = attn.flash_bwd_dq_reference(*args)
        if not ((dq[:, :, 5] == 0).all() and (dq[1, 0, 63:] == 0).all()
                and close_enough(dq, rq, BWD_TOL["bfloat16"])):
            raise AssertionError(f"dQ of rows that saw no key is not 0 "
                                 f"(causal={causal})")
    log("  rows that saw no key (lse = +1e30): dQ exactly 0")
    # No atomics: a second call gives the same bits.
    args = bwd_inputs(torch, attn, 399, *TRAIN_SHAPE, torch.bfloat16, True)
    first = (*attn.flash_attn_bwd_dkdv(*args), attn.flash_attn_bwd_dq(*args))
    second = (*attn.flash_attn_bwd_dkdv(*args),
              attn.flash_attn_bwd_dq(*args))
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError("two backward calls are not bit-identical")
    log("  two backward calls at the training shape: bit-identical")
    return errs


def train_bounds(b, h, sq, sk, d, causal, elem_bytes=2):
    """Bytes and operations each kernel must spend at one shape: every
    input read once and every output written once; operations for the
    (query, key) pairs this causal mask keeps (forward: QKᵀ and PV, 4·D per
    pair; dK/dV: QKᵀ, dO Vᵀ, Pᵀ dO, dSᵀ Q, 8·D; dQ: QKᵀ, dO Vᵀ, dS K,
    6·D)."""
    if causal:
        pairs = sum(min(sk, i + 1 + sk - sq) for i in range(sq))
    else:
        pairs = sq * sk
    heads = b * h
    qd, kd = heads * sq * d * elem_bytes, heads * sk * d * elem_bytes
    row = heads * sq * 4  # one f32 per query row (lse, delta)
    nbytes = {"flash_attn_fwd": qd + 2 * kd + qd + row,
              "flash_attn_bwd_dkdv": 2 * qd + 2 * kd + 2 * row + 2 * kd,
              "flash_attn_bwd_dq": 2 * qd + 2 * kd + 2 * row + qd}
    flops = {"flash_attn_fwd": 4.0 * d * pairs * heads,
             "flash_attn_bwd_dkdv": 8.0 * d * pairs * heads,
             "flash_attn_bwd_dq": 6.0 * d * pairs * heads}
    out = {}
    for name in nbytes:
        t_bytes = nbytes[name] / HBM_BYTES_PER_S * 1e3
        t_ops = flops[name] / BF16_FLOP_PER_S * 1e3
        out[name] = dict(bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations",
                         bytes=nbytes[name], flops=flops[name])
    return out


def time_training_kernels(torch, attn, shape=TRAIN_SHAPE,
                          label="train_decoder_self", iters=(50, 5, 20, 3),
                          causal=True):
    """Phase 8 (and 17, 21): kernel / plain / library times of the three
    kernels at a bias-free training shape (bf16), causal or not.
    ``iters``: events and profiler iterations and warm-ups of the kernels,
    then of the plain versions."""
    F = torch.nn.functional
    args = bwd_inputs(torch, attn, 500, *shape, torch.bfloat16, causal)
    q, k, v, do, lse, delta, causal, scale = args
    # The same call in the model's layout: q/k/v and dO as transposed views.
    sargs = bwd_inputs(torch, attn, 500, *shape, torch.bfloat16, causal,
                       strided=True)
    strided = {
        "flash_attn_fwd": lambda: attn.flash_attention_forward(
            *sargs[:3], causal=causal, return_lse=True),
        "flash_attn_bwd_dkdv": lambda: attn.flash_attn_bwd_dkdv(*sargs),
        "flash_attn_bwd_dq": lambda: attn.flash_attn_bwd_dq(*sargs),
    }
    kernel = {
        "flash_attn_fwd": lambda: attn.flash_attention_forward(
            q, k, v, causal=causal, return_lse=True),
        "flash_attn_bwd_dkdv": lambda: attn.flash_attn_bwd_dkdv(*args),
        "flash_attn_bwd_dq": lambda: attn.flash_attn_bwd_dq(*args),
    }
    # The first port's kernel bodies (the ``simt`` variants) on the same
    # inputs.
    dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
    before = {
        "flash_attn_fwd": lambda: attn._launch(q, k, v, None, causal, scale,
                                               True, "simt"),
        "flash_attn_bwd_dkdv": lambda: attn._launch_bwd(
            "flash_attn_bwd_dkdv", *args, (dk, dv), "simt",
            attn.flash_attn_bwd_dkdv),
        "flash_attn_bwd_dq": lambda: attn._launch_bwd(
            "flash_attn_bwd_dq", *args, (dq,), "simt",
            attn.flash_attn_bwd_dq),
    }
    plain = {
        "flash_attn_fwd": lambda: (
            attn.attention_reference(q, k, v, causal=causal),
            attn._reference_lse(q, k, None, causal, scale)),
        "flash_attn_bwd_dkdv": lambda: attn.flash_bwd_dkdv_reference(*args),
        "flash_attn_bwd_dq": lambda: attn.flash_bwd_dq_reference(*args),
    }
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    library = {
        "flash_attn_fwd": lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal),
        # One call computes dq, dk and dv together; it stands beside both
        # backward kernels.
        "flash_attn_bwd_dkdv": lambda: torch.autograd.grad(
            sdpa_out, (qg, kg, vg), do, retain_graph=True),
    }
    library["flash_attn_bwd_dq"] = library["flash_attn_bwd_dkdv"]
    bounds = train_bounds(*shape, causal)
    rows = {}
    # (Launches made here and in phase 7 are comparisons, not the main
    # path's: every count is set to 0 before phase 9.)
    bwd = attn.backward_variant(q.dtype, q.shape[3])
    variant = {"flash_attn_fwd": attn.forward_variant(q.dtype, q.shape[2],
                                                      q.shape[3]),
               "flash_attn_bwd_dkdv": bwd, "flash_attn_bwd_dq": bwd}
    for name in kernel:
        t = time_row(torch, kernel[name], strided[name], before[name],
                     plain[name], library[name], *iters)
        rows[name] = dict(shape=label, q=list(q.shape),
                          kv=list(k.shape), dtype="bfloat16", causal=causal,
                          variant=variant[name], **t, **bounds[name])
        log_times(name, rows[name])
    return rows


def fresh_workdir(name: str) -> str:
    """An empty workdir under ``_build/`` (a checkpoint left by an earlier
    run there would be resumed)."""
    import shutil

    workdir = os.path.join(REPO, "deeplearning_cfn_tpu_torch", "_build",
                           name)
    shutil.rmtree(workdir, ignore_errors=True)
    return workdir


def train_cfg(torch, dtype, batch, steps, workdir_name):
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.presets import get_preset

    workdir = fresh_workdir(workdir_name)
    # Preset recipe kept (dropout 0.1, label smoothing 0.1, AdamW(0.9,
    # 0.98), rsqrt) but for the schedule's scale: warmup is clamped to
    # steps - 1, so a short run needs a small base lr for the loss to fall.
    return apply_overrides(get_preset("transformer_nmt_wmt"), [
        f"workdir={workdir}", f"train.dtype={dtype}", "train.seed=0",
        f"train.global_batch={batch}", f"train.steps={steps}",
        "train.log_every_steps=1", "schedule.warmup_steps=10",
        "schedule.base_lr=1e-3", "data.num_eval_examples=128",
        "eval.max_decode_len=32", "checkpoint.every_steps=1000000"])


def counts(attn):
    return {"fwd": attn.flash_attention_forward.launches,
            "dkdv": attn.flash_attn_bwd_dkdv.launches,
            "dq": attn.flash_attn_bwd_dq.launches,
            "vjp": attn.attention_reference_vjp.calls}


def variant_counts(attn):
    return {"fwd": dict(attn.flash_attention_forward.variant_launches),
            "dkdv": dict(attn.flash_attn_bwd_dkdv.variant_launches),
            "dq": dict(attn.flash_attn_bwd_dq.variant_launches)}


def set_counts(attn, value):
    for fn in (attn.flash_attention_forward, attn.flash_attn_bwd_dkdv,
               attn.flash_attn_bwd_dq):
        fn.launches = value
        fn.variant_launches = dict.fromkeys(fn.variant_launches, value)
    attn.attention_reference_vjp.calls = value


def train(torch, attn):
    """Phase 9: the training path, with every count set to 0 first."""
    from deeplearning_cfn_tpu_torch.train.run import run_experiment

    cfg = train_cfg(torch, "bfloat16", TRAIN_BATCH, TRAIN_STEPS,
                    "smoke_train")
    records, at_end = [], {}

    by_variant = {}

    def hook(step, state, record):
        records.append(record)
        if step == TRAIN_STEPS:
            at_end.update(counts(attn))  # before the eval's forwards
            by_variant.update(variant_counts(attn))

    torch.cuda.reset_peak_memory_stats()
    set_counts(attn, 0)
    t0 = time.perf_counter()
    final = run_experiment(cfg, device=DEVICE, hooks=(hook,))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in records]
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x)
                                             for x in losses):
        raise AssertionError(f"bad losses: {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    log(f"  losses: {' '.join(f'{x:.4f}' for x in losses)}")
    if not last < first:
        raise AssertionError(f"loss did not fall: first-5 mean {first}, "
                             f"last-5 mean {last}")
    accum = cfg.train.grad_accum_steps
    expect = {k: v * TRAIN_STEPS * accum for k, v in PER_STEP.items()}
    log(f"  launches over {TRAIN_STEPS} steps (accum {accum}): {at_end} "
        f"(expected {expect})")
    if at_end != expect:
        raise AssertionError(f"launch counts {at_end} != {expect}")
    log(f"  launches by variant: {by_variant}")
    if any(by_variant[key]["tc"] != at_end[key]
           for key in ("fwd", "dkdv", "dq")):
        raise AssertionError(f"bf16 training launches off the tc variant: "
                             f"{by_variant}")
    stepped = [r for r in records if "step_time_s" in r]
    step_s = sorted(r["step_time_s"] for r in stepped)
    tok_s = sorted(r["target_tokens_per_sec"] for r in stepped)
    p50 = lambda xs: xs[len(xs) // 2]
    out = dict(steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
               grad_accum_steps=accum, first5_loss=first, last5_loss=last,
               step_time_p50_s=p50(step_s),
               target_tokens_per_s_p50=p50(tok_s),
               first_step_s=records[0]["compile_s"],
               max_memory_allocated_bytes=peak, wall_s=wall,
               final_eval_loss=final["loss"],
               final_eval_token_accuracy=final["token_accuracy"],
               final_eval_bleu=final["bleu"], launches=at_end,
               variant_launches=by_variant)
    log(f"  step time p50 {out['step_time_p50_s'] * 1e3:.2f} ms, target "
        f"tokens/s p50 {out['target_tokens_per_s_p50']:.1f}, first step "
        f"{out['first_step_s']:.2f} s, max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; final eval loss {final['loss']:.4f}, "
        f"token accuracy {final['token_accuracy']:.4f}, BLEU "
        f"{final['bleu']:.4f}; run {wall:.1f} s")
    return out


def grad_parity(torch, attn):
    """Phase 10: one f32 train step through the kernels and through the
    plain attention, from the same init and dropout seed."""
    from deeplearning_cfn_tpu_torch.data.pipeline import (build_pipeline,
                                                          to_device)
    from deeplearning_cfn_tpu_torch.train.optim import (build_optimizer,
                                                        build_schedule)
    from deeplearning_cfn_tpu_torch.train.state import create_train_state
    from deeplearning_cfn_tpu_torch.train.task import build_task
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = train_cfg(torch, "float32", PARITY_BATCH, 1, "smoke_parity")
    dev = torch.device(DEVICE)
    host = next(iter(build_pipeline(cfg.data, PARITY_BATCH,
                                    seed=0).one_epoch()))
    results = {}
    for impl in ("kernel", "reference"):
        task = build_task(cfg, dev, attention_impl=impl)
        task.init(torch.Generator(device=dev).manual_seed(0))
        opt = build_optimizer(cfg.optimizer, build_schedule(
            cfg.schedule, 1, PARITY_BATCH), task.model)
        state = create_train_state(task.model, opt)
        before = counts(attn)
        metrics = Trainer(cfg, task, dev).train_step(
            state, to_device(host, dev))
        used = {k: counts(attn)[k] - before[k] for k in before}
        grads = {n: None if p.grad is None else p.grad.detach().clone()
                 for n, p in task.model.named_parameters()}
        results[impl] = (float(metrics["loss"]), grads, used)
    (lk, gk, used_k), (lr, gr, used_r) = results["kernel"], \
        results["reference"]
    if used_k["dkdv"] != PER_STEP["dkdv"] or used_r["dkdv"] != 0:
        raise AssertionError(f"kernel run launched {used_k}, plain run "
                             f"{used_r}")
    rel_loss = abs(lk - lr) / abs(lr)
    missing = [n for n in gr if gk[n] is None or gr[n] is None]
    if missing:
        raise AssertionError(f"gradients missing: {missing}")
    # The key projections' biases have a true gradient of 0 (they shift
    # every logit of a row alike), so their norm is rounding noise: each
    # norm is floored at 1e-4 of the largest parameter gradient norm.
    floor = 1e-4 * max(g.norm().item() for g in gr.values())
    worst, worst_name = 0.0, ""
    for name, ref in gr.items():
        rel = (gk[name] - ref).norm().item() / max(ref.norm().item(), floor)
        if rel > worst:
            worst, worst_name = rel, name
        if not rel <= 1e-3:
            raise AssertionError(f"{name}: gradient differs by {rel} of its "
                                 f"norm")
    projections = [n for n in gk if any(
        f"{a}.{p}.weight" in n for a in ("self_attn", "cross_attn")
        for p in ("query", "key", "value"))]
    dead = [n for n in projections if not gk[n].abs().sum().item() > 0]
    if len(projections) != 6 * 3 * 3 or dead:
        raise AssertionError(f"attention projections without gradient: "
                             f"{dead} of {len(projections)}")
    log(f"  loss kernel {lk:.7f} vs plain {lr:.7f} (rel {rel_loss:.2e}); "
        f"{len(gk)} parameters, worst gradient diff {worst:.2e} of its norm "
        f"({worst_name}); {len(projections)} attention projections all "
        f"have nonzero gradients")
    if not rel_loss <= 1e-5:
        raise AssertionError(f"f32 losses differ by {rel_loss} relative")
    return dict(loss_rel_diff=rel_loss, worst_grad_rel_diff=worst,
                worst_grad_param=worst_name, params=len(gk),
                projections=len(projections))


def profile_training(torch, steps: int = 3) -> None:
    """``--profile-train``: where a full-width bf16 train step (batch 128)
    spends its time — host wall time per step against device-busy time
    (torch.profiler), the CUDA kernels ranked by device time — and the step
    time through the kernels against the plain attention, in turns
    (kernel, plain, plain, kernel)."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning_cfn_tpu_torch.data.pipeline import (build_pipeline,
                                                          to_device)
    from deeplearning_cfn_tpu_torch.train.optim import (build_optimizer,
                                                        build_schedule)
    from deeplearning_cfn_tpu_torch.train.state import create_train_state
    from deeplearning_cfn_tpu_torch.train.task import build_task
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer

    cfg = train_cfg(torch, "bfloat16", TRAIN_BATCH, 100, "smoke_profile")
    dev = torch.device(DEVICE)
    batches = [to_device(b, dev) for _, b in zip(
        range(steps + 2), build_pipeline(cfg.data, TRAIN_BATCH,
                                         seed=0).one_epoch())]

    def setup(impl):
        task = build_task(cfg, dev, attention_impl=impl)
        task.init(torch.Generator(device=dev).manual_seed(0))
        opt = build_optimizer(cfg.optimizer, build_schedule(
            cfg.schedule, 100, TRAIN_BATCH), task.model)
        return Trainer(cfg, task, dev), create_train_state(task.model, opt)

    def run(trainer, state, bs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in bs:
            trainer.train_step(state, b)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    runs = {impl: setup(impl) for impl in ("kernel", "reference")}
    for impl in runs:
        run(*runs[impl], batches[:2])  # warm up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        wall = run(*runs["kernel"], batches[2:])
    report_profile(prof, wall, steps, "train step")
    times = {"kernel": [], "reference": []}
    for impl in ("kernel", "reference", "reference", "kernel"):
        times[impl].append(run(*runs[impl], batches[2:]) / steps * 1e3)
    log(f"  train step through the kernels "
        f"{' / '.join(f'{t:.2f}' for t in times['kernel'])} ms, through "
        f"the plain attention "
        f"{' / '.join(f'{t:.2f}' for t in times['reference'])} ms "
        f"(turns kernel, plain, plain, kernel; {steps} steps each)")


def report_profile(prof, wall, steps, what):
    events = kernel_rows(prof)
    busy_us = sum(dev_time(e) for e in events)
    n_kernels = sum(e.count for e in events)
    log(f"  {steps} {what}s in {wall * 1e3:.1f} ms: "
        f"{wall * 1e3 / steps:.3f} ms per {what} on the host clock, "
        f"{busy_us / 1e3 / steps:.3f} ms device-busy per {what} "
        f"({busy_us / (wall * 1e6):.1%} busy), {n_kernels / steps:.0f} "
        f"device ops per {what}")
    ranked = sorted(events, key=dev_time, reverse=True)
    # The top 15, then the port's own kernels wherever they rank.
    for i, e in enumerate(ranked):
        if i < 15 or "flash_attn" in e.key:
            log(f"    {dev_time(e) / steps:9.1f} us/{what}  "
                f"x{e.count / steps:5.1f}  #{i + 1:<3d} {e.key[:90]}")


# -- the ResNet path (no kernel of ours: cuDNN convs, eager f32 BatchNorm) --


def resnet_cfg(batch, steps, workdir_name):
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.presets import get_preset

    workdir = fresh_workdir(workdir_name)
    return apply_overrides(get_preset("imagenet_resnet50"), [
        f"workdir={workdir}", "train.seed=0", f"train.global_batch={batch}",
        f"train.steps={steps}", "train.log_every_steps=1",
        "train.eval_every_steps=1000000", "schedule.warmup_steps=2",
        "data.num_train_examples=1024", "data.num_eval_examples=512",
        "checkpoint.every_steps=1000000"])


def train_resnet(torch):
    """Phase 11: ResNet-50 at full width in bf16 through run_experiment:
    losses, the running statistics, the layouts and the host's feed rate
    (the step's throughput and MFU share: phase 34a's ``run_bench``)."""
    from deeplearning_cfn_tpu_torch.models.resnet import forward_flops
    from deeplearning_cfn_tpu_torch.train.run import run_experiment

    steps = RESNET_WARMUP + RESNET_STEPS
    cfg = resnet_cfg(RESNET_BATCH, steps, "smoke_resnet")
    for cut in RESNET_CUTS:
        log(f"  cut: {cut}")
    records, seen = [], {}

    def hook(step, state, record):
        records.append(record)
        if step == steps:
            seen["model"] = state.model

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    final = run_experiment(cfg, device=DEVICE, hooks=(hook,))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    model = seen["model"]
    losses = [r["loss"] for r in records]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"bad losses: {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    log(f"  losses: {' '.join(f'{x:.4f}' for x in losses)}")
    if not last < first:
        raise AssertionError(f"loss did not fall: first-5 mean {first}, "
                             f"last-5 mean {last}")
    off = [n for n, t in [*model.named_parameters(), *model.named_buffers()]
           if t.device.type != torch.device(DEVICE).type]
    if off:
        raise AssertionError(f"{len(off)} tensors not on the card, e.g. "
                             f"{off[:3]}")
    # The seeded init leaves every running mean at 0 and variance at 1.
    moved, buffers = 0, dict(model.named_buffers())
    for name, buf in buffers.items():
        if not bool(torch.isfinite(buf).all()):
            raise AssertionError(f"{name}: non-finite running statistic")
        start = 0.0 if name.endswith("running_mean") else 1.0
        moved += int(bool((buf != start).any()))
    if moved != len(buffers):
        raise AssertionError(f"only {moved} of {len(buffers)} running "
                             f"statistics moved")
    layouts = channels_last_share(torch, model, cfg.data.image_size)
    timed = [r for r in records[RESNET_WARMUP:] if "step_time_s" in r]
    step_s = sorted(r["step_time_s"] for r in timed)
    img_s = sorted(r["examples_per_sec"] for r in timed)
    p50 = lambda xs: xs[len(xs) // 2]
    flops = forward_flops(model, cfg.data.image_size)
    out = dict(steps=steps, timed_steps=len(timed),
               global_batch=RESNET_BATCH, image_size=cfg.data.image_size,
               params=sum(p.numel() for p in model.parameters()),
               forward_gflop_per_image=flops / 1e9,
               first5_loss=first, last5_loss=last,
               step_time_p50_s=p50(step_s), images_per_s_p50=p50(img_s),
               first_step_s=records[0]["compile_s"],
               max_memory_allocated_bytes=peak, wall_s=wall,
               final_eval_loss=final["loss"],
               final_eval_top1=final["accuracy"],
               final_eval_top5=final["accuracy_top5"],
               final_eval_examples=final["examples"],
               channels_last_activations=layouts, cuts=RESNET_CUTS)
    log(f"  model: ResNet-50, {out['params']} parameters, "
        f"{out['forward_gflop_per_image']:.3f} GFLOP forward per "
        f"{cfg.data.image_size}² image (counted from the conv/Dense shapes; "
        f"published ~8.2)")
    log(f"  step time p50 {out['step_time_p50_s'] * 1e3:.2f} ms, images/s "
        f"p50 {out['images_per_s_p50']:.1f} (the MFU share: phase 34a's "
        f"run_bench), first step {out['first_step_s']:.2f} s, "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; eval on "
        f"{final['examples']:.0f}: loss {final['loss']:.4f}, top-1 "
        f"{final['accuracy']:.4f}, top-5 {final['accuracy_top5']:.4f}; "
        f"{moved} running statistics moved, all finite; activations "
        f"channels_last: {layouts}; run {wall:.1f} s")
    out["feed"] = feed_rate(torch, out["images_per_s_p50"])
    return out


def channels_last_share(torch, model, size):
    """Every conv and BatchNorm output of one train-mode forward (batch 8)
    must be channels_last; returns 'n/n'. The forward runs under no_grad
    and its statistics update is undone."""
    from deeplearning_cfn_tpu_torch.models import resnet

    saved = {n: b.clone() for n, b in model.named_buffers()}
    flags = []
    handles = [m.register_forward_hook(lambda m, i, o: flags.append(
        o.is_contiguous(memory_format=torch.channels_last)))
        for m in model.modules()
        if isinstance(m, (resnet.Conv, resnet.BatchNorm))]
    try:
        with torch.no_grad():
            model(torch.randn(8, size, size, 3, device=DEVICE), train=True)
    finally:
        for h in handles:
            h.remove()
        with torch.no_grad():
            for n, b in model.named_buffers():
                b.copy_(saved[n])
    if not flags or not all(flags):
        raise AssertionError(f"activations not channels_last: "
                             f"{sum(flags)}/{len(flags)}")
    return f"{sum(flags)}/{len(flags)}"


def feed_rate(torch, card_images_per_s):
    """The host's feed rate of the sharded ImageNet source through dataio
    (random-resized-crop to 224, flip, normalize), at batch 256, with the
    preset's 4 loader threads and with one per core."""
    import shutil

    import numpy as np

    from deeplearning_cfn_tpu_torch import dataio
    from deeplearning_cfn_tpu_torch.data.imagenet import (
        ShardedImageNetSource, measure_feed_rate, write_shards)
    from deeplearning_cfn_tpu_torch.data.pipeline import DataPipeline

    if not dataio.available():
        raise AssertionError("the dataio C++ loader did not build (g++)")
    root = os.path.join(REPO, "deeplearning_cfn_tpu_torch", "_build",
                        "feed_shards")
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    write_shards(root, rng.randint(0, 256, (FEED_IMAGES, FEED_STORED,
                                            FEED_STORED, 3), dtype=np.uint8),
                 rng.randint(0, 1000, FEED_IMAGES), 1000, shard_records=256)
    write_s = time.perf_counter() - t0
    out = {"shards_write_s": write_s, "images": FEED_IMAGES,
           "stored": f"{FEED_STORED}x{FEED_STORED} u8", "out": FEED_OUT,
           "card_images_per_s": card_images_per_s}
    try:
        for workers in (4, os.cpu_count() or 4):
            source = ShardedImageNetSource(root, train=True,
                                           image_size=FEED_OUT,
                                           num_workers=workers)
            pipe = DataPipeline(source, RESNET_BATCH, prefetch=0)
            if not pipe._seeded or not source._native:
                raise AssertionError("feed path is not the native seeded "
                                     "gather")
            rate = measure_feed_rate(pipe, num_batches=8, warmup=1)
            out[f"images_per_s_{workers}_threads"] = rate["images_per_sec"]
            log(f"  feed rate ({workers} loader threads, batch "
                f"{RESNET_BATCH}, {FEED_STORED}² u8 → {FEED_OUT}² f32): "
                f"{rate['images_per_sec']:.1f} images/s — "
                f"{rate['images_per_sec'] / card_images_per_s:.2f}× the "
                f"card's {card_images_per_s:.1f}; "
                f"{'enough' if rate['images_per_sec'] >= card_images_per_s else 'NOT enough'} "
                f"to feed it")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def cifar_parity(torch):
    """Phase 12: f32 ResNet-20 at full width, the card against the CPU."""
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.data.pipeline import (build_pipeline,
                                                          to_device)
    from deeplearning_cfn_tpu_torch.presets import get_preset
    from deeplearning_cfn_tpu_torch.train.optim import (build_optimizer,
                                                        build_schedule)
    from deeplearning_cfn_tpu_torch.train.state import create_train_state
    from deeplearning_cfn_tpu_torch.train.task import build_task
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer
    from deeplearning_cfn_tpu_torch.train.optim import global_norm

    cfg = apply_overrides(get_preset("cifar10_resnet20"), [
        "train.seed=0", f"train.global_batch={CIFAR_BATCH}",
        f"data.num_train_examples={CIFAR_BATCH * CIFAR_STEPS}"])
    host = [b for _, b in zip(range(CIFAR_STEPS), build_pipeline(
        cfg.data, CIFAR_BATCH, cfg.model.num_classes, seed=0).one_epoch())]
    runs = {}
    init = None
    for name in ("cpu", DEVICE):
        dev = torch.device(name)
        task = build_task(cfg, dev)
        if init is None:
            task.init(torch.Generator(device=dev).manual_seed(0))
            init = {k: v.clone() for k, v in task.model.state_dict().items()}
        else:
            task.model.load_state_dict(init)
        sched = build_schedule(cfg.schedule, 100, CIFAR_BATCH, 100)
        state = create_train_state(task.model, build_optimizer(
            cfg.optimizer, sched, task.model))
        trainer = Trainer(cfg, task, dev)
        losses = [float(trainer.train_step(state, to_device(b, dev))["loss"])
                  for b in host]
        grads = {n: p.grad.detach().cpu() for n, p in
                 task.model.named_parameters()}
        stats = {n: b.detach().cpu() for n, b in
                 task.model.named_buffers()}
        runs[name] = (losses, grads, stats)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    (lc, gc, sc), (lg, gg, sg) = runs["cpu"], runs[DEVICE]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    gnorm = float(global_norm(list(gc.values())))
    grad_rel = max(float((gg[n] - gc[n]).norm()) for n in gc) / gnorm
    stat_err = max(float((sg[n] - sc[n]).abs().max() /
                         max(float(sc[n].abs().max()), 1.0)) for n in sc)
    log(f"  losses card {' '.join(f'{x:.7f}' for x in lg)} vs CPU "
        f"{' '.join(f'{x:.7f}' for x in lc)} (worst rel {loss_rel:.2e}); "
        f"{len(gc)} gradients, worst {grad_rel:.2e} of the global norm "
        f"{gnorm:.4f}; {len(sc)} running statistics, worst {stat_err:.2e}; "
        f"TF32 (cudnn, matmul) during the run: {tf32}")
    if tf32 != (False, False):
        raise AssertionError(f"TF32 on for an f32 run: {tf32}")
    if not (loss_rel <= 1e-4 and grad_rel <= 1e-5 and stat_err <= 1e-5):
        raise AssertionError(
            f"card vs CPU: losses {loss_rel}, gradients {grad_rel}, "
            f"statistics {stat_err}")
    return dict(steps=CIFAR_STEPS, global_batch=CIFAR_BATCH,
                losses_card=lg, losses_cpu=lc, loss_rel_diff=loss_rel,
                grad_rel_to_global_norm=grad_rel, running_stat_err=stat_err,
                params=len(gc))


# -- BERT-base (kernel #1 with a padding bias; the reference-VJP backward) --


def bert_cfg(overrides, workdir_name, preset="bert_base_wikipedia"):
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.presets import get_preset

    return apply_overrides(get_preset(preset), [
        f"workdir={fresh_workdir(workdir_name)}", "train.seed=0",
        "train.log_every_steps=1", *overrides])


def tied_decoder_ms(torch, rows, vocab):
    """The f32 tied decoder's product (BERT's MLM decoder, GPT's logits) at
    ``rows`` positions, forward and backward (TF32 off, as the port
    computes it), by CUDA events."""
    g = torch.Generator(device=DEVICE).manual_seed(7)
    h = torch.randn(rows, 768, generator=g, device=DEVICE,
                    requires_grad=True)
    w = torch.randn(vocab, 768, generator=g, device=DEVICE,
                    requires_grad=True)
    dy = torch.randn(rows, vocab, generator=g, device=DEVICE)

    def step():
        torch.autograd.grad(torch.matmul(h, w.t()), (h, w), dy)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return time_fn(torch, step, iters=10, warmup=2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def train_bert(torch, attn, preset="bert_base_wikipedia",
               workdir_name="smoke_bert", cuts=BERT_CUTS):
    """Phase 13 (and 22, 23): a BERT-base preset at full width in bf16
    through run_experiment, with every count set to 0 first. The forward
    FLOPs are counted by the model's own module (``bert.forward_flops``
    counts a MoE layer's expert einsums at every capacity slot); a MoE
    trunk's aux losses must be finite at every step."""
    from deeplearning_cfn_tpu_torch.train.run import run_experiment

    steps = BERT_WARMUP + BERT_STEPS
    cfg = bert_cfg([f"train.global_batch={BERT_BATCH}",
                    f"train.grad_accum_steps={BERT_ACCUM}",
                    f"train.steps={steps}", "schedule.warmup_steps=2",
                    "train.eval_every_steps=1000000",
                    "checkpoint.every_steps=1000000"], workdir_name, preset)
    for cut in cuts:
        log(f"  cut: {cut}")
    records, at_end, by_variant, seen = [], {}, {}, {}

    def hook(step, state, record):
        records.append(record)
        if step == steps:
            at_end.update(counts(attn))  # before the eval's forwards
            by_variant.update(variant_counts(attn))
            seen["model"] = state.model

    torch.cuda.reset_peak_memory_stats()
    set_counts(attn, 0)
    t0 = time.perf_counter()
    final = run_experiment(cfg, device=DEVICE, hooks=(hook,))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after_eval, by_variant_eval = counts(attn), variant_counts(attn)
    peak = torch.cuda.max_memory_allocated()
    model = seen["model"]
    losses = [r["loss"] for r in records]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"bad losses: {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    log(f"  losses: {' '.join(f'{x:.4f}' for x in losses)}")
    if not last < first:
        raise AssertionError(f"loss did not fall: first-5 mean {first}, "
                             f"last-5 mean {last}")
    micro = steps * BERT_ACCUM
    expect = {k: v * micro for k, v in BERT_PER_STEP.items()}
    eval_batches = math.ceil(final["examples"] / BERT_BATCH)
    log(f"  launches over {steps} steps (accum {BERT_ACCUM}): {at_end} "
        f"(expected {expect}); after the eval's {eval_batches} batch(es): "
        f"{after_eval}; by variant {by_variant}")
    if at_end != expect:
        raise AssertionError(f"launch counts {at_end} != {expect}")
    eval_fwd = BERT_LAYERS * eval_batches
    if after_eval != {**expect, "fwd": expect["fwd"] + eval_fwd}:
        raise AssertionError(f"eval launches {after_eval} != 12 per eval "
                             f"batch on top of {expect}")
    if by_variant["fwd"]["tc"] != at_end["fwd"] or \
            by_variant_eval["fwd"]["tc"] != after_eval["fwd"]:
        raise AssertionError(f"bf16 BERT launches off the tc variant: "
                             f"{by_variant}, with the eval "
                             f"{by_variant_eval}")
    moe = {}
    if getattr(model, "num_experts", 0):
        for key in ("moe_load_balance", "moe_router_z"):
            vals = [r[key] for r in records]
            if not all(math.isfinite(x) for x in vals):
                raise AssertionError(f"{key}: non-finite {vals}")
            moe[key] = vals
        for key, vals in moe.items():
            log(f"  {key}: {' '.join(f'{x:.4f}' for x in vals)}")
    timed = [r for r in records[BERT_WARMUP:] if "step_time_s" in r]
    step_s = sorted(r["step_time_s"] for r in timed)
    seq_s = sorted(r["examples_per_sec"] for r in timed)
    p50 = lambda xs: xs[len(xs) // 2]
    forward_flops = sys.modules[type(model).__module__].forward_flops
    flops = forward_flops(model, BERT_SEQ, BERT_PRED)
    mfu = mfu_share(p50(seq_s), flops)
    bound_step_s = BERT_BATCH * 3 * flops / BF16_FLOP_PER_S
    decoder = tied_decoder_ms(torch, BERT_BATCH // BERT_ACCUM * BERT_PRED,
                              30522)
    out = dict(steps=steps, timed_steps=len(timed), global_batch=BERT_BATCH,
               grad_accum_steps=BERT_ACCUM, seq_len=BERT_SEQ,
               params=sum(p.numel() for p in model.parameters()),
               forward_mflop_per_token=flops / BERT_SEQ / 1e6,
               first5_loss=first, last5_loss=last,
               step_time_p50_s=p50(step_s), sequences_per_s_p50=p50(seq_s),
               mfu_share=mfu, tensor_core_bound_step_s=bound_step_s,
               first_step_s=records[0]["compile_s"],
               max_memory_allocated_bytes=peak, wall_s=wall,
               mlm_decoder_f32_fwd_bwd_ms_per_microbatch=decoder,
               final_eval={k: v for k, v in final.items()},
               launches=at_end, launches_with_eval=after_eval,
               variant_launches=by_variant,
               variant_launches_with_eval=by_variant_eval, cuts=cuts,
               preset=preset, **moe)
    log(f"  model: {preset}, {out['params']} parameters, "
        f"{out['forward_mflop_per_token']:.1f} MFLOP forward per token "
        f"(counted from the shapes, MLM head at {BERT_PRED} of "
        f"{BERT_SEQ} positions); tensor-core bound of a step "
        f"{bound_step_s * 1e3:.1f} ms")
    log(f"  step time p50 {out['step_time_p50_s'] * 1e3:.2f} ms, sequences/s "
        f"p50 {out['sequences_per_s_p50']:.1f}, MFU share {mfu:.4f} (of 989 "
        f"TFLOP/s dense bf16), first step {out['first_step_s']:.2f} s, "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; f32 MLM decoder fwd+"
        f"bwd {decoder:.2f} ms per microbatch; eval {final}; run "
        f"{wall:.1f} s")
    return out


def time_forward_shape(torch, attn, name, b, h, sq, sk, seed, iters):
    """Kernel #1 at one biased bf16 shape of a main path — q [b, h, sq, 64]
    against k/v [b, h, sk, 64] with a [b, 1, 1, sk] padding or step bias
    (``make_inputs``; no row fully masked) — held against its plain version
    and timed as phase 4 times the serving shapes, beside SDPA with the
    same additive mask (cast to bf16, as phase 4 does). ``iters``: events
    and profiler iterations and warm-ups of the kernel, then of the plain
    version."""
    F = torch.nn.functional
    d = HEAD_DIM
    q, k, v, bias = make_inputs(torch, seed, b, h, sq, sk, d,
                                torch.bfloat16, True, causal=True)
    qs, ks, vs, _ = make_inputs(torch, seed, b, h, sq, sk, d,
                                torch.bfloat16, True, causal=True,
                                strided=True)
    out = attn.flash_attention_forward(q, k, v, bias)
    err = (out.float() - attn.attention_reference(q, k, v, bias).float()) \
        .abs().max().item()
    if err > TOL["bfloat16"]:
        raise AssertionError(f"{name}: kernel vs plain {err}")
    lib_mask = bias.to(torch.bfloat16)
    t = time_row(
        torch, lambda: attn.flash_attention_forward(q, k, v, bias),
        lambda: attn.flash_attention_forward(qs, ks, vs, bias),
        lambda: attn._launch(q, k, v, bias, False, d ** -0.5, False,
                             "simt"),
        lambda: attn.attention_reference(q, k, v, bias),
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask),
        *iters)
    b_ms, by, nbytes, flops = bound_ms(b, h, sq, sk, d, 2, bias)
    row = dict(shape=name, q=[b, h, sq, d], kv=[b, h, sk, d],
               dtype="bfloat16",
               variant=attn.forward_variant(torch.bfloat16, sq, d), **t,
               bound_ms=b_ms, bound_by=by, bytes=nbytes, flops=flops,
               max_abs_err=err)
    log_times(name, row)
    return row


def resume_on_card(torch):
    """Phase 14: a run to 2k steps against one killed after k and resumed,
    then the ckpt and eval verbs on its checkpoint directory."""
    import contextlib
    import io

    from deeplearning_cfn_tpu_torch.cli.main import main as cli
    from deeplearning_cfn_tpu_torch.runtime.profiling import trace_files
    from deeplearning_cfn_tpu_torch.train.run import run_experiment

    class Killed(Exception):
        pass

    over = ["model.kwargs.num_layers=2", "train.dtype=float32",
            f"train.global_batch={RESUME_BATCH}",
            f"train.steps={2 * RESUME_K}", "schedule.warmup_steps=2",
            "data.num_train_examples=512", "data.num_eval_examples=64",
            f"checkpoint.every_steps={RESUME_K}", "checkpoint.keep=0"]

    def run(cfg, kill_after=None):
        losses = {}

        def hook(step, state, record):
            losses[step] = record["loss"]
            if step == kill_after:
                raise Killed()

        try:
            run_experiment(cfg, device=DEVICE, hooks=(hook,))
        except Killed:
            pass
        return losses

    straight = run(bert_cfg(over, "smoke_resume_a"))
    resumed_cfg = bert_cfg(over, "smoke_resume_b")
    head = run(resumed_cfg, kill_after=RESUME_K)
    resumed_cfg.train.profile_steps = 2
    tail = run(resumed_cfg)
    if sorted(head) != list(range(1, RESUME_K + 1)) or \
            sorted(tail) != list(range(RESUME_K + 1, 2 * RESUME_K + 1)):
        raise AssertionError(f"steps run: {sorted(head)} then {sorted(tail)}")
    got = {**head, **tail}
    rel = max(abs(got[s] - straight[s]) / abs(straight[s]) for s in straight)
    log(f"  losses uninterrupted {[round(straight[s], 6) for s in sorted(straight)]}"
        f"; killed after {RESUME_K} and resumed "
        f"{[round(got[s], 6) for s in sorted(got)]}; worst rel diff "
        f"{rel:.2e} (tolerance {RESUME_TOL})")
    if not rel <= RESUME_TOL:
        raise AssertionError(f"resumed run differs by {rel}")
    workdir = os.path.join(resumed_cfg.workdir, "bert_base_wikipedia")
    traces = trace_files(os.path.join(workdir, "profile"))
    if len(traces) != 1:
        raise AssertionError(f"profile_steps=2 left {traces}")
    trace_mb = os.path.getsize(traces[0]) / 2**20
    ckpt_dir = os.path.join(workdir, "ckpt")
    overrides = [f"workdir={resumed_cfg.workdir}", *over]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rcs = [cli(["ckpt", "list", ckpt_dir]),
               cli(["eval", "--preset", "bert_base_wikipedia", "--step",
                    str(RESUME_K), "--accelerator",
                    "gpu" if DEVICE == "cuda" else "cpu", *overrides]),
               cli(["ckpt", "rollback", ckpt_dir, "--step", str(RESUME_K)]),
               cli(["ckpt", "list", ckpt_dir])]
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    listed = [json.loads(ln)["committed_steps"] for ln in lines
              if "committed_steps" in ln]
    evaluated = [json.loads(ln) for ln in lines if "checkpoint_step" in ln]
    log(f"  trace {os.path.basename(traces[0])} ({trace_mb:.1f} MiB); "
        f"ckpt list {listed[0]}, eval --step {RESUME_K} {evaluated}, "
        f"after rollback {listed[-1]}; rcs {rcs}")
    if rcs != [0, 0, 0, 0] or listed != [[RESUME_K, 2 * RESUME_K],
                                         [RESUME_K]] \
            or evaluated[0]["checkpoint_step"] != RESUME_K:
        raise AssertionError(f"ckpt verbs: rcs {rcs}, lists {listed}, "
                             f"eval {evaluated}")
    return dict(k=RESUME_K, steps=2 * RESUME_K, global_batch=RESUME_BATCH,
                losses_uninterrupted=[straight[s] for s in sorted(straight)],
                losses_resumed=[got[s] for s in sorted(got)],
                worst_rel_loss_diff=rel, tolerance=RESUME_TOL,
                trace_file=os.path.basename(traces[0]), trace_mib=trace_mb,
                ckpt_list=listed[0], after_rollback=listed[-1],
                eval_at_k=evaluated[0])


# -- Mask R-CNN (no kernel of ours: cuDNN convs, eager BatchNorm, gathers) --


def maskrcnn_cfg(overrides, workdir_name):
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.presets import get_preset

    return apply_overrides(get_preset("maskrcnn_coco"), [
        f"workdir={fresh_workdir(workdir_name)}", "train.seed=0",
        *overrides])


def train_maskrcnn(torch, attn):
    """Phase 15: maskrcnn_coco at full width in bf16 through
    run_experiment, on the synthetic COCO source."""
    from deeplearning_cfn_tpu_torch.models.maskrcnn import forward_flops
    from deeplearning_cfn_tpu_torch.train.run import run_experiment

    steps = MRCNN_WARMUP + MRCNN_STEPS
    cfg = maskrcnn_cfg([
        f"train.global_batch={MRCNN_BATCH}",
        f"train.grad_accum_steps={MRCNN_ACCUM}", f"train.steps={steps}",
        "train.log_every_steps=1", "train.eval_every_steps=1000000",
        f"schedule.base_lr={MRCNN_LR}", "schedule.warmup_steps=2",
        f"data.num_train_examples={MRCNN_EXAMPLES}",
        f"data.num_eval_examples={MRCNN_EVAL}",
        f"train.eval_batch={MRCNN_BATCH}", "eval.detect_topk=100",
        "checkpoint.every_steps=1000000"], "smoke_maskrcnn")
    for cut in MRCNN_CUTS:
        log(f"  cut: {cut}")
    records, seen = [], {}

    def hook(step, state, record):
        records.append(record)
        if step == steps:
            seen["model"] = state.model

    before = counts(attn)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    final = run_experiment(cfg, device=DEVICE, hooks=(hook,))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if counts(attn) != before:
        raise AssertionError("the Mask R-CNN path launched an attention "
                             "kernel")
    model = seen.pop("model")
    losses = [r["loss"] for r in records]
    if len(losses) != steps or not all(
            math.isfinite(r[k]) for r in records
            for k in ("loss",) + MRCNN_LOSSES):
        raise AssertionError(f"bad losses: {records}")
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    log(f"  losses: {' '.join(f'{x:.4f}' for x in losses)}")
    for k in MRCNN_LOSSES:
        log(f"    {k}: {records[0][k]:.4f} -> {records[-1][k]:.4f}")
    if not last < first:
        raise AssertionError(f"loss did not fall: first-3 mean {first}, "
                             f"last-3 mean {last}")
    off = [n for n, t in [*model.named_parameters(), *model.named_buffers()]
           if t.device.type != torch.device(DEVICE).type]
    if off:
        raise AssertionError(f"{len(off)} tensors not on the card, e.g. "
                             f"{off[:3]}")
    maps = {k: final[k] for k in ("map", "map50", "mask_map", "mask_map50")}
    if not all(0.0 <= v <= 1.0 for v in maps.values()):
        raise AssertionError(f"mAP keys out of [0, 1]: {maps}")
    timed = [r for r in records[MRCNN_WARMUP:] if "step_time_s" in r]
    step_s = sorted(r["step_time_s"] for r in timed)
    img_s = sorted(r["examples_per_sec"] for r in timed)
    p50 = lambda xs: xs[len(xs) // 2]
    flops = forward_flops(model, cfg.data.image_size, MRCNN_ROIS,
                          MRCNN_MASK_ROIS)
    mfu = mfu_share(p50(img_s), flops)
    n_params = sum(p.numel() for p in model.parameters())
    del model
    out = dict(steps=steps, timed_steps=len(timed),
               global_batch=MRCNN_BATCH, grad_accum_steps=MRCNN_ACCUM,
               image_size=cfg.data.image_size,
               num_classes=cfg.model.num_classes, params=n_params,
               forward_gflop_per_image=flops / 1e9,
               losses=losses, first3_loss=first, last3_loss=last,
               first_last={k: [records[0][k], records[-1][k]]
                           for k in MRCNN_LOSSES},
               step_time_p50_s=p50(step_s), images_per_s_p50=p50(img_s),
               mfu_share=mfu, first_step_s=records[0]["compile_s"],
               max_memory_allocated_bytes=peak, wall_s=wall,
               final_eval_loss=final["loss"], **maps,
               final_eval_examples=final["examples"], cuts=MRCNN_CUTS)
    log(f"  model: Mask R-CNN ResNet-50-FPN, {n_params} parameters, "
        f"{out['forward_gflop_per_image']:.1f} GFLOP forward per "
        f"{cfg.data.image_size}² image (counted from the conv/Dense shapes "
        f"at {MRCNN_ROIS} box RoIs and {MRCNN_MASK_ROIS} mask RoIs)")
    log(f"  step time p50 {out['step_time_p50_s'] * 1e3:.2f} ms, images/s "
        f"p50 {out['images_per_s_p50']:.2f}, MFU share {mfu:.4f} (of 989 "
        f"TFLOP/s dense bf16), first step {out['first_step_s']:.2f} s, "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; eval on "
        f"{final['examples']:.0f}: loss {final['loss']:.4f}, map "
        f"{maps['map']:.4f}, map50 {maps['map50']:.4f}, mask_map "
        f"{maps['mask_map']:.4f}; run {wall:.1f} s")
    out["device_busy"] = profile_maskrcnn(torch, steps=2, by_kind=False)
    return out


def conditioned_weights(torch, model, seed):
    """Seeded random weights with a spread (the tests' recipe): kernels at
    1/√fan_in, biases N(0, 0.1), BatchNorm scales in [0.5, 1.5] except each
    block's last in [0.1, 0.3] (the trunk near the identity, as Flax's
    zero init starts it, so f32 rounding stays small), random running
    statistics. Class scores spread out, so no two detections tie."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            shape = t.shape
            if name.endswith("running_mean"):
                v = torch.randn(shape, generator=g) * 0.5
            elif name.endswith("running_var"):
                v = torch.rand(shape, generator=g) * 1.5 + 0.5
            elif ".norms.2.weight" in name:
                v = torch.rand(shape, generator=g) * 0.2 + 0.1
            elif "norm" in name and name.endswith("weight"):
                v = torch.rand(shape, generator=g) + 0.5
            elif name.endswith("bias"):
                v = torch.randn(shape, generator=g) * 0.1
            else:
                v = torch.randn(shape, generator=g) / math.sqrt(
                    t[0].numel())
            t.copy_(v)


def maskrcnn_parity(torch):
    """Phase 16: the tiny f32 Mask R-CNN on the card against the CPU from
    the same weights and batch: the chosen proposals, the five losses and
    proposal recall, every gradient, the batch statistics, and predict_fn's
    outputs."""
    from deeplearning_cfn_tpu_torch.data.detection import \
        make_detection_source
    from deeplearning_cfn_tpu_torch.data.pipeline import to_device
    from deeplearning_cfn_tpu_torch.train.optim import global_norm
    from deeplearning_cfn_tpu_torch.train.task import build_task
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer

    cfg = maskrcnn_cfg(MRCNN_TINY, "smoke_maskrcnn_parity")
    host = make_detection_source(4, 64, 7, 4, seed=11).arrays
    runs, init = {}, None
    for name in ("cpu", DEVICE):
        dev = torch.device(name)
        task = build_task(cfg, dev)
        if init is None:
            conditioned_weights(torch, task.model, seed=0)
            init = {k: v.clone() for k, v in task.model.state_dict().items()}
        else:
            task.model.load_state_dict(init)
        Trainer(cfg, task, dev)  # TF32 off for an f32 run
        batch = to_device(host, dev)
        model = task.model
        with torch.no_grad():
            out = model(batch["image"], train=True)
            _, keep, idx = task._proposals_infer(out["rpn_logits"],
                                                 out["rpn_deltas"])
        model.load_state_dict(init)
        loss, aux = task.loss_fn(batch, True)
        loss.backward()
        pred = task.predict_fn(8, 0.05, 0.5)(batch["image"])
        runs[name] = dict(
            idx=idx.cpu(), keep=keep.cpu(),
            losses={k: float(v) for k, v in
                    (("loss", loss.detach()),
                     *((k, aux[k].detach()) for k in MRCNN_LOSSES))},
            grads={n: p.grad.detach().cpu()
                   for n, p in model.named_parameters()},
            stats={n: b.detach().cpu() for n, b in model.named_buffers()},
            pred={k: v.cpu() for k, v in pred.items()})
    cpu, card = runs["cpu"], runs[DEVICE]
    same_idx = bool(torch.equal(cpu["idx"], card["idx"]) and
                    torch.equal(cpu["keep"], card["keep"]))
    loss_rel = max(abs(card["losses"][k] - v) / abs(v)
                   for k, v in cpu["losses"].items())
    gnorm = float(global_norm(list(cpu["grads"].values())))
    by_leaf = sorted(((float((card["grads"][n] - g).norm()) / gnorm, n)
                      for n, g in cpu["grads"].items()), reverse=True)
    grad_rel = by_leaf[0][0]
    log("  worst gradient leaves (of the global norm): " + ", ".join(
        f"{n} {e:.2e}" for e, n in by_leaf[:4]))
    stat_err = max(float((card["stats"][n] - s).abs().max()
                         / max(float(s.abs().max()), 1.0))
                   for n, s in cpu["stats"].items())
    same_classes = bool(torch.equal(cpu["pred"]["classes"],
                                    card["pred"]["classes"]))
    pred_err = max(float((card["pred"][k] - cpu["pred"][k]).abs().max()
                         / max(float(cpu["pred"][k].abs().max()), 1e-30))
                   for k in ("boxes", "scores", "masks"))
    log(f"  losses card {card['losses']} vs CPU {cpu['losses']} (worst rel "
        f"{loss_rel:.2e}); chosen proposals equal: {same_idx} "
        f"({int(cpu['keep'].sum())} kept of {cpu['keep'].numel()}); "
        f"{len(cpu['grads'])} gradients, worst {grad_rel:.2e} of the global "
        f"norm {gnorm:.4f}; {len(cpu['stats'])} running statistics, worst "
        f"{stat_err:.2e}; predict: classes equal {same_classes}, boxes/"
        f"scores/masks worst {pred_err:.2e} of the largest "
        f"({int((cpu['pred']['classes'] > 0).sum())} detections)")
    if not (same_idx and same_classes and loss_rel <= MRCNN_LOSS_TOL
            and grad_rel <= MRCNN_GRAD_TOL and stat_err <= MRCNN_LOSS_TOL
            and pred_err <= MRCNN_VALUE_TOL):
        raise AssertionError(
            f"card vs CPU: proposals {same_idx}, classes {same_classes}, "
            f"losses {loss_rel}, gradients {grad_rel}, statistics "
            f"{stat_err}, predictions {pred_err}")
    return dict(global_batch=4, image_size=64, losses_card=card["losses"],
                losses_cpu=cpu["losses"], loss_rel_diff=loss_rel,
                chosen_proposals_equal=same_idx,
                grad_rel_to_global_norm=grad_rel, running_stat_err=stat_err,
                predict_classes_equal=same_classes,
                predict_rel_err=pred_err,
                tolerances=dict(loss=MRCNN_LOSS_TOL, grad=MRCNN_GRAD_TOL,
                                stats=MRCNN_LOSS_TOL,
                                predict=MRCNN_VALUE_TOL),
                tf32=[torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32])


# -- the GPT family (phases 17-18): all three kernels at sequence 1024 -------


def gpt_cfg(overrides, workdir_name):
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.presets import get_preset

    return apply_overrides(get_preset("gpt_small_lm"), [
        f"workdir={fresh_workdir(workdir_name)}", "train.seed=0",
        "train.log_every_steps=1", *overrides])


def gpt_overrides():
    return [f"train.global_batch={GPT_BATCH}",
            f"train.steps={GPT_WARMUP + GPT_STEPS}",
            "schedule.warmup_steps=2", "train.eval_every_steps=1000000",
            f"data.num_eval_examples={GPT_EVAL}",
            "checkpoint.every_steps=1000000"]


def train_gpt(torch, attn):
    """Phase 17: gpt_small_lm at full width in bf16 through run_experiment
    on the synthetic lm_text source, with every count set to 0 first."""
    from deeplearning_cfn_tpu_torch.models.lm import forward_flops
    from deeplearning_cfn_tpu_torch.train.run import run_experiment

    steps = GPT_WARMUP + GPT_STEPS
    cfg = gpt_cfg(gpt_overrides(), "smoke_gpt")
    for cut in GPT_CUTS:
        log(f"  cut: {cut}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    log(f"  TF32 for f32 matmuls (the tied logits): {tf32}")
    records, at_end, by_variant, seen = [], {}, {}, {}

    def hook(step, state, record):
        records.append(record)
        if step == steps:
            at_end.update(counts(attn))  # before the eval's forwards
            by_variant.update(variant_counts(attn))
            seen["model"] = state.model

    torch.cuda.reset_peak_memory_stats()
    set_counts(attn, 0)
    t0 = time.perf_counter()
    final = run_experiment(cfg, device=DEVICE, hooks=(hook,))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after_eval, by_variant_eval = counts(attn), variant_counts(attn)
    peak = torch.cuda.max_memory_allocated()
    model = seen.pop("model")
    losses = [r["loss"] for r in records]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"bad losses: {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    log(f"  losses: {' '.join(f'{x:.4f}' for x in losses)}")
    if not last < first:
        raise AssertionError(f"loss did not fall: first-5 mean {first}, "
                             f"last-5 mean {last}")
    expect = {k: v * steps for k, v in GPT_PER_STEP.items()}
    eval_batches = math.ceil(GPT_EVAL / GPT_BATCH)
    log(f"  launches over {steps} steps: {at_end} (expected {expect}); "
        f"after the eval's {eval_batches} batches: {after_eval}; by variant "
        f"{by_variant}")
    if at_end != expect:
        raise AssertionError(f"launch counts {at_end} != {expect}")
    if after_eval != {**expect, "fwd": expect["fwd"]
                      + GPT_LAYERS * eval_batches}:
        raise AssertionError(f"eval launches {after_eval} != 12 per eval "
                             f"batch on top of {expect}")
    if any(by[key]["tc"] != n[key] for by, n in
           ((by_variant, at_end), (by_variant_eval, after_eval))
           for key in ("fwd", "dkdv", "dq")):
        raise AssertionError(f"bf16 GPT launches off the tc variant: "
                             f"{by_variant}, with the eval "
                             f"{by_variant_eval}")
    timed = [r for r in records[GPT_WARMUP:] if "step_time_s" in r]
    step_s = sorted(r["step_time_s"] for r in timed)
    seq_s = sorted(r["examples_per_sec"] for r in timed)
    p50 = lambda xs: xs[len(xs) // 2]
    flops = forward_flops(model, GPT_SEQ)
    tok_s = p50(seq_s) * GPT_SEQ
    mfu = mfu_share(p50(seq_s), flops)
    bound_step_s = GPT_BATCH * 3 * flops / BF16_FLOP_PER_S
    logits_ms = tied_decoder_ms(torch, GPT_BATCH * GPT_SEQ, GPT_VOCAB)
    n_params = sum(p.numel() for p in model.parameters())
    del model
    out = dict(steps=steps, timed_steps=len(timed), global_batch=GPT_BATCH,
               seq_len=GPT_SEQ, params=n_params,
               forward_mflop_per_token=flops / GPT_SEQ / 1e6,
               first5_loss=first, last5_loss=last, losses=losses,
               step_time_p50_s=p50(step_s), sequences_per_s_p50=p50(seq_s),
               tokens_per_s_p50=tok_s, mfu_share=mfu,
               tensor_core_bound_step_s=bound_step_s,
               first_step_s=records[0]["compile_s"],
               max_memory_allocated_bytes=peak, wall_s=wall,
               tf32_matmul=tf32,
               tied_logits_f32_fwd_bwd_ms=logits_ms,
               final_eval={k: v for k, v in final.items()},
               launches=at_end, launches_with_eval=after_eval,
               variant_launches=by_variant,
               variant_launches_with_eval=by_variant_eval, cuts=GPT_CUTS,
               workdir=cfg.workdir)
    log(f"  model: GPT-2-small, {n_params} parameters, "
        f"{out['forward_mflop_per_token']:.1f} MFLOP forward per token "
        f"(counted from the shapes: trunk GEMMs, causal attention, tied "
        f"logits); tensor-core bound of a step {bound_step_s * 1e3:.1f} ms")
    log(f"  step time p50 {out['step_time_p50_s'] * 1e3:.2f} ms, tokens/s "
        f"p50 {tok_s:.1f}, MFU share {mfu:.4f} (of 989 TFLOP/s dense bf16), "
        f"first step {out['first_step_s']:.2f} s, max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; f32 tied logits fwd+bwd {logits_ms:.2f} "
        f"ms per step; eval ce_loss {final['ce_loss']:.4f}, perplexity "
        f"{final['perplexity']:.2f}, token accuracy "
        f"{final['token_accuracy']:.4f}; run {wall:.1f} s")
    return out


def check_train_kernels(torch, attn, rows, shape=GPT_SHAPE, causal=True):
    """The three kernels against their plain versions at a training shape
    (the inputs phase 17's or 21's timing used: GPT's causal rows, ViT's
    non-causal 196 keys). Every output (O, lse, dK, dV, dQ) on its own
    scale (``scaled_error``; most of GPT's dK/dV entries are far below
    phase 7's absolute limit), the lse within 1e-3 relative as phase 3
    holds it, and the forward within phase 3's absolute 2e-2 as well."""
    args = bwd_inputs(torch, attn, 500, *shape, torch.bfloat16, causal)
    q, k, v, do, lse, delta, causal, scale = args
    out, got_lse = attn.flash_attention_forward(q, k, v, causal=causal,
                                                return_lse=True)
    ref = attn.attention_reference(q, k, v, causal=causal)
    ref_lse = attn._reference_lse(q, k, None, causal, scale)
    lse_err = ((got_lse - ref_lse).abs()
               / ref_lse.abs().clamp_min(1.0)).max().item()
    checked = {"out": scaled_error(out, ref)}
    del out, ref
    got = attn.flash_attn_bwd_dkdv(*args) + (attn.flash_attn_bwd_dq(*args),)
    want = attn.flash_bwd_dkdv_reference(*args) \
        + (attn.flash_bwd_dq_reference(*args),)
    for name, a, b in zip(("dk", "dv", "dq"), got, want):
        checked[name] = scaled_error(a, b)
    del got, want
    for name, e in checked.items():
        log(f"  {name:3s} at {list(shape)}: {scaled_line(e)}")
    log(f"  lse rel err {lse_err:.3e} (<= 1e-3)")
    errs = {"flash_attn_fwd": checked["out"]["max_abs_err"],
            "flash_attn_bwd_dkdv": max(checked["dk"]["max_abs_err"],
                                       checked["dv"]["max_abs_err"]),
            "flash_attn_bwd_dq": checked["dq"]["max_abs_err"]}
    bad = [n for n, e in checked.items() if not e["ok"]]
    if bad or not lse_err <= 1e-3 \
            or not errs["flash_attn_fwd"] <= TOL["bfloat16"]:
        raise AssertionError(f"{list(shape)}: kernels vs plain {bad} "
                             f"{checked} lse {lse_err}")
    for name, err in errs.items():
        rows[name]["max_abs_err"] = err
    rows["flash_attn_fwd"]["lse_rel_err"] = lse_err
    for name, keys in (("flash_attn_fwd", ("out",)),
                       ("flash_attn_bwd_dkdv", ("dk", "dv")),
                       ("flash_attn_bwd_dq", ("dq",))):
        rows[name]["rel_norm_err"] = {key: checked[key]["rel_norm"]
                                      for key in keys}
    return errs


def generate_gpt(torch, attn, workdir):
    """Phase 18, first half: ``cli generate --preset gpt_small_lm`` from
    phase 17's checkpoint, greedy, a 16-byte prompt and 64 new tokens, with
    every count set to 0 first."""
    import contextlib
    import io

    from deeplearning_cfn_tpu_torch.cli.main import main as cli

    prompt = "The H100 port of"
    assert len(prompt.encode()) == GPT_PROMPT
    buf = io.StringIO()
    set_counts(attn, 0)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli(["generate", "--preset", "gpt_small_lm", "--prompt", prompt,
                  "--max-new-tokens", str(GPT_NEW),
                  *gpt_overrides(), f"workdir={workdir}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched, by_variant = counts(attn), variant_counts(attn)
    text = buf.getvalue()
    log("  " + text.strip().replace("\n", "\n  "))
    if rc != 0 or "checkpoint step" not in text or \
            len(text.strip().splitlines()) < 2:
        raise AssertionError(f"cli generate exited {rc}: {text!r}")
    expect = GPT_LAYERS * (GPT_PROMPT + GPT_NEW - 1)
    log(f"  launches: {launched}, by variant {by_variant} (expected "
        f"{expect} decode); {wall:.2f} s with the restore")
    if launched != {"fwd": expect, "dkdv": 0, "dq": 0, "vjp": 0} or \
            by_variant["fwd"]["decode"] != expect:
        raise AssertionError(f"generate launches {launched} "
                             f"{by_variant} != {expect} decode")
    return dict(rc=rc, text=text.strip().splitlines()[-1], wall_s=wall,
                launches=launched["fwd"], variant_launches=by_variant["fwd"])


def gpt_generate_parity(torch, attn):
    """Phase 18, second half: one seeded full-width GPT through the kernels
    and through the plain attention, in f32 (TF32 off; an f32 forward takes
    the exact ``simt`` variant) and in bf16 (the ``decode`` variant, as
    ``cli generate`` runs it): the first generated position's logits, and
    greedy ``lm_generate`` rows token for token at batch 8, with the
    variant's launches counted; then the bf16 decode step's time at batch 1
    and 8."""
    from deeplearning_cfn_tpu_torch.models import build_model
    from deeplearning_cfn_tpu_torch.models.decoding import lm_generate
    from deeplearning_cfn_tpu_torch.models.lm import init_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(4, GPT_VOCAB, (GPT_PARITY_BATCH, GPT_PROMPT),
                           generator=g, device=dev)

    def first_step(m):
        """The logits of the first generated position: the prompt through
        ``decode_step``, position by position."""
        cache = m.init_cache(GPT_PARITY_BATCH)
        for t in range(GPT_PROMPT):
            logits = m.decode_step(prompt[:, t:t + 1], t, cache)
        return logits

    def compare(dtype):
        models = {}
        for impl in ("kernel", "reference"):
            m = build_model("gpt_small", 0, dtype, device=dev,
                            attention_impl=impl)
            m.requires_grad_(False)
            models[impl] = m
        init_weights(models["kernel"],
                     torch.Generator(device=dev).manual_seed(0))
        models["reference"].load_state_dict(models["kernel"].state_dict())
        fwd = attn.flash_attention_forward
        before = dict(fwd.variant_launches)
        first = {impl: first_step(m) for impl, m in models.items()}
        outs = {impl: lm_generate(m, prompt, GPT_NEW)
                for impl, m in models.items()}
        torch.cuda.synchronize()
        launched = {v: n - before[v] for v, n in fwd.variant_launches.items()}
        variant = attn.forward_variant(dtype, 1, HEAD_DIM)
        # The kernel model only: 12 per prompt position in first_step, 12
        # per position but the last in lm_generate.
        expect = GPT_LAYERS * (2 * GPT_PROMPT + GPT_NEW - 1)
        if launched != {**{v: 0 for v in launched}, variant: expect}:
            raise AssertionError(f"{dtype}: launches {launched}, expected "
                                 f"{expect} on {variant}")
        same = sum(bool(torch.equal(a, b)) for a, b in
                   zip(outs["kernel"], outs["reference"]))
        return models["kernel"], first, same, launched, variant

    _, first, same, _, variant = compare(torch.float32)
    logit_err = (first["kernel"] - first["reference"]).abs().max().item()
    log(f"  f32 ({variant}), batch {GPT_PARITY_BATCH}: the first generated "
        f"position's logits max abs diff {logit_err:.3e} (limit 1e-3); "
        f"{same}/{GPT_PARITY_BATCH} greedy rows token-identical over "
        f"{GPT_NEW} new tokens")
    if not logit_err <= 1e-3:
        raise AssertionError(f"f32 GPT decode logits differ by {logit_err}")
    del first
    model, first, same_bf16, launched, variant = compare(torch.bfloat16)
    bf16 = scaled_error(first["kernel"], first["reference"], GEN_BF16_TOL)
    log(f"  bf16 ({variant}, {launched[variant]} launches), batch "
        f"{GPT_PARITY_BATCH}: the first generated position's logits "
        f"{scaled_line(bf16)}; {same_bf16}/{GPT_PARITY_BATCH} greedy rows "
        f"token-identical over {GPT_NEW} new tokens")
    if not bf16["ok"]:
        raise AssertionError(f"bf16 GPT decode logits differ: {bf16}")
    del first
    times = {1: [], GPT_PARITY_BATCH: []}
    # In turns (1, 8, 8, 1): the host clock of a shared machine drifts.
    for batch in (1, GPT_PARITY_BATCH, GPT_PARITY_BATCH, 1):
        cache = model.init_cache(batch)
        tok = prompt[:batch, :1]
        for t in range(GPT_PROMPT + GPT_NEW - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok = torch.argmax(model.decode_step(tok, t, cache)[:, 0],
                               dim=-1)[:, None]
            torch.cuda.synchronize()
            if t >= 2:
                times[batch].append(time.perf_counter() - t0)
    steps = {}
    for batch, ts in times.items():
        p50 = sorted(ts)[len(ts) // 2]
        steps[batch] = dict(decode_step_p50_s=p50, tokens_per_s=batch / p50)
        log(f"  bf16 decode step, batch {batch}: p50 {p50 * 1e3:.3f} ms "
            f"(host clock, synced, two runs in turns), {batch / p50:.1f} "
            f"tokens/s")
    return dict(logit_max_abs_diff=logit_err,
                greedy_token_identical=f"{same}/{GPT_PARITY_BATCH}",
                bf16_first_step_logits=bf16,
                bf16_greedy_token_identical=f"{same_bf16}/{GPT_PARITY_BATCH}",
                bf16_decode_launches=launched[variant],
                decode=steps)


# -- serving features: speculation, radix cache, chunked prefill, QoS -------

# Phase 19: a seeded 2+2-layer draft beside the 6+6-layer target; the f32
# limits (the plain run's top-two logit gap where a speculative run first
# differs from it, and the verify against sequential steps), both 1e-4.
SPEC_DRAFT_LAYERS, SPEC_F32_TOL = 2, 1e-4
# Phase 20: 24 sources, each served twice (48 requests in four waves),
# 32-token chunks, and the bf16 near-tie limit: 2e-2 of the largest logit.
FEATURE_SOURCES, FEATURE_CHUNK, FEATURE_BF16_TIE = 24, 32, 2e-2


def serve_tally(engine):
    """Flash kernel launches the engine's device calls make on the card:
    one per encoder layer per full or partial encode (the distinct draft's
    at its own depth), two per decoder layer per decoder, verify or draft
    step."""
    n_layers = engine.model.num_layers
    n = n_layers * (engine.encoder_forwards + engine.partial_encodes) \
        + 2 * n_layers * (engine.decoder_steps + engine.verify_steps)
    if engine.draft_model is not None:
        d_layers = engine.draft_model.num_layers
        n += d_layers * engine.draft_encoder_forwards \
            + 2 * d_layers * engine.draft_steps
    return n


def serve_main_path(torch, attn, label, make_engine, drive):
    """One main-path run: every launch count set to 0, the engine built
    (its warmup encodes are in the tally too) and driven by ``drive``
    (which returns the request ids), the counts read. Every request must be
    done with in-vocabulary tokens, the kernel's launches must equal the
    engine's tally, and every bf16 launch must be on ``tc`` or ``decode``."""
    set_counts(attn, 0)
    engine = make_engine()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = drive(engine)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd = attn.flash_attention_forward
    launches, variants = fwd.launches, dict(fwd.variant_launches)
    reqs = {rid: engine.poll(rid) for rid in rids}
    bad = {r: q.state.value for r, q in reqs.items()
           if q.state.value != "done"}
    if bad:
        raise AssertionError(f"{label}: requests not done: {bad}")
    tokens = {rid: list(q.tokens) for rid, q in reqs.items()}
    vocab = engine.model.vocab_size
    for rid, toks in tokens.items():
        if not toks or any(not 0 <= t < vocab for t in toks):
            raise AssertionError(f"{label}: {rid}: bad tokens {toks}")
    expect = serve_tally(engine)
    log(f"  {label}: {len(rids)} requests done in {wall:.3f} s; encodes "
        f"{engine.encoder_forwards} (+{engine.partial_encodes} partial, "
        f"{engine.draft_encoder_forwards} draft), decoder steps "
        f"{engine.decoder_steps}, verify steps {engine.verify_steps}, draft "
        f"steps {engine.draft_steps}; flash launches {launches} (tally "
        f"{expect}), by variant {variants}")
    if launches <= 0 or launches != expect:
        raise AssertionError(f"{label}: flash launches {launches} != tally "
                             f"{expect}")
    if variants["simt"] or variants["tc"] + variants["decode"] != launches:
        raise AssertionError(f"{label}: bf16 launches off the tc/decode "
                             f"variants: {variants}")
    snap = engine.metrics.snapshot()
    generated = sum(len(t) for t in tokens.values())
    return engine, tokens, snap, dict(
        launches=launches, variant_launches=variants, wall_s=wall,
        tokens=generated, tokens_per_s=generated / wall,
        ttft_p50_s=snap["serve_ttft_p50_s"],
        decode_step_p50_ms=snap["serve_step_latency_p50_s"] * 1e3,
        encoder_forwards=engine.encoder_forwards,
        partial_encodes=engine.partial_encodes,
        decoder_steps=engine.decoder_steps,
        verify_steps=engine.verify_steps, draft_steps=engine.draft_steps,
        draft_encoder_forwards=engine.draft_encoder_forwards)


def submit_all(reqs):
    """A drive function: submit (id, src, budget, beam) requests, drain."""
    def drive(engine):
        for rid, src, budget, beam in reqs:
            engine.submit(src, max_new_tokens=budget, beam_size=beam,
                          request_id=rid)
        engine.run_until_drained()
        return [r[0] for r in reqs]
    return drive


def first_divergence(a, b):
    """The first index where two token lists differ (None if equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def plain_top2(torch, model, items):
    """The plain run's logits where a compared run first differs from it,
    replayed through the single-position step at the engine's batch of
    ``SLOTS`` rows (the engine's GEMM shapes): ``items`` are (src, plain
    tokens, position t); returns each one's (largest logit, gap to the
    second largest)."""
    from deeplearning_cfn_tpu_torch.models.decoding import BOS_ID

    out = []
    for at in range(0, len(items), SLOTS):
        chunk = items[at:at + SLOTS]
        src = torch.zeros((SLOTS, SRC_LEN), dtype=torch.long, device=DEVICE)
        for i, (ids, _, _) in enumerate(chunk):
            src[i, :len(ids)] = torch.tensor(ids, device=DEVICE)
        mask = (src != 0).long()
        cache = model.init_cache(SLOTS)
        prev = torch.full((SLOTS,), BOS_ID, dtype=torch.long, device=DEVICE)
        found = {}
        with torch.no_grad():
            enc = model.encode(src, mask)
            for t in range(max(t for _, _, t in chunk) + 1):
                pos = torch.full((SLOTS,), t, dtype=torch.long,
                                 device=DEVICE)
                logits = model.decode_step_at(prev[:, None], enc, mask, pos,
                                              cache)[:, 0].float()
                for i, (_, toks, ti) in enumerate(chunk):
                    if ti == t:
                        top = logits[i].topk(2).values
                        found[i] = (top[0].item(), (top[0] - top[1]).item())
                prev = torch.tensor([toks[t] if t < len(toks) else 0
                                     for _, toks, _ in chunk]
                                    + [0] * (SLOTS - len(chunk)),
                                    device=DEVICE)
        out += [found[i] for i in range(len(chunk))]
    return out


def near_tie_check(torch, label, model, srcs, plain, other, limit, rel):
    """Requests whose tokens differ from the plain run's must first differ
    where the plain run's top two logits lie within ``limit`` of each other
    (times the largest logit's magnitude when ``rel``). Returns the count
    of token-identical requests."""
    diff = [(rid, first_divergence(plain[rid], other[rid])) for rid in plain]
    diff = [(rid, t) for rid, t in diff if t is not None]
    same = len(plain) - len(diff)
    log(f"  {label}: {same}/{len(plain)} requests token-identical")
    if not diff:
        return same
    tops = plain_top2(torch, model, [(srcs[rid], plain[rid], t)
                                     for rid, t in diff])
    for (rid, t), (top, gap) in zip(diff, tops):
        bound = limit * abs(top) if rel else limit
        log(f"    {rid} first differs at token {t}: the plain run's top two "
            f"logits {gap:.3e} apart (limit {bound:.3e})")
        if not gap <= bound:
            raise AssertionError(f"{label}: {rid} differs at token {t} "
                                 f"where the plain run has no near-tie "
                                 f"(gap {gap} > {bound})")
    return same


def verify_vs_sequential(torch, model, srcs, tokens):
    """The first verify (positions 0..γ: BOS and four greedy tokens per row)
    against γ+1 sequential single-position steps, over the paged pool and
    the dense cache: the largest logit difference over the largest
    |logit|, per layout."""
    from deeplearning_cfn_tpu_torch.models.decoding import BOS_ID

    src = torch.zeros((SLOTS, SRC_LEN), dtype=torch.long, device=DEVICE)
    tgt = torch.zeros((SLOTS, SPEC_GAMMA + 1), dtype=torch.long,
                      device=DEVICE)
    for i, (ids, toks) in enumerate(zip(srcs, tokens)):
        src[i, :len(ids)] = torch.tensor(ids, device=DEVICE)
        row = [BOS_ID] + list(toks[:SPEC_GAMMA])
        tgt[i, :len(row)] = torch.tensor(row, device=DEVICE)
    mask = (src != 0).long()
    mb = model.max_len // 16
    tables = torch.arange(1, SLOTS * mb + 1, device=DEVICE).view(SLOTS, mb)
    zero = torch.zeros((SLOTS,), dtype=torch.long, device=DEVICE)
    errs = {}
    with torch.no_grad():
        enc = model.encode(src, mask)
        for layout in ("paged", "dense"):
            paged = layout == "paged"
            c1, c2 = ((model.init_paged_cache(SLOTS * mb + 1, 16) if paged
                       else model.init_cache(SLOTS)) for _ in range(2))
            if paged:
                span = model.decode_span_paged(tgt, enc, mask, zero, tables,
                                               c1)
                seq = [model.decode_step_paged(tgt[:, j:j + 1], enc, mask,
                                               zero + j, tables, c2)
                       for j in range(SPEC_GAMMA + 1)]
            else:
                span = model.decode_span_at(tgt, enc, mask, zero, c1)
                seq = [model.decode_step_at(tgt[:, j:j + 1], enc, mask,
                                            zero + j, c2)
                       for j in range(SPEC_GAMMA + 1)]
            seq = torch.cat(seq, dim=1)
            errs[layout] = ((span - seq).abs().max()
                            / seq.abs().max()).item()
    return errs


def serve_speculative(torch, attn, reqs):
    """Phase 19: speculative serving at full width, bf16, γ = 4 — three
    main-path runs of phase 5's requests (beams fall back to the host
    step), then the f32 token identity against plain greedy."""
    from deeplearning_cfn_tpu_torch.config import apply_overrides

    draft_cfg = apply_overrides(smoke_cfg("bfloat16"), [
        f"model.kwargs.num_layers={SPEC_DRAFT_LAYERS}", "train.seed=1"])
    runs = (("a_self_draft_host", dict()),
            ("b_self_draft_device_chain", dict(speculate_device=True)),
            ("c_shrunk_draft_host", dict(draft_cfg=draft_cfg)))
    out, toks = {}, {}
    for name, kw in runs:
        engine, toks[name], snap, row = serve_main_path(
            torch, attn, name,
            lambda kw=kw: build_engine(smoke_cfg("bfloat16"),
                                         speculate_gamma=SPEC_GAMMA, **kw),
            submit_all(reqs))
        row.update(
            accepted=snap["serve_spec_accepted"],
            proposed=snap["serve_spec_proposed"],
            accept_rate=snap["serve_spec_accept_rate"],
            tokens_per_target_step=snap["serve_spec_tokens_per_target_step"],
            verify_steps_per_token=engine.verify_steps / row["tokens"],
            host_syncs_per_token=snap["serve_spec_host_syncs_per_token"],
            windows_per_chain=snap["serve_spec_windows_per_chain"])
        log(f"  {name}: accepted/proposed {row['accepted']}/"
            f"{row['proposed']} ({row['accept_rate']}), tokens per target "
            f"row-step {row['tokens_per_target_step']}, verify steps per "
            f"emitted token {row['verify_steps_per_token']:.4f}, host syncs "
            f"per speculative token {row['host_syncs_per_token']} "
            f"(windows per chain {row['windows_per_chain']}), tokens/s "
            f"{row['tokens_per_s']:.1f}, decode-step p50 "
            f"{row['decode_step_p50_ms']:.3f} ms")
        out[name] = row
        del engine
    a, b, c = (toks[n] for n, _ in runs)
    same_b = sum(a[r] == b[r] for r in a)
    same_c = sum(a[r] == c[r] for r in a)
    log(f"  bf16 requests token-identical to run a: b {same_b}/{len(a)}, c "
        f"{same_c}/{len(a)}")
    if not out["c_shrunk_draft_host"]["accepted"] \
            < out["c_shrunk_draft_host"]["proposed"]:
        raise AssertionError("the shrunk draft's proposals were all accepted")
    # f32 (TF32 off; f32 takes the exact simt variant): plain greedy against
    # the host path and the device chain, then the first verify against
    # sequential steps. Comparison launches, not the main path's.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    greedy = [r for r in reqs if r[3] == 1]
    srcs = {r[0]: r[1] for r in greedy}
    f32, syncs = {}, {}
    for name, kw in (("plain", dict()),
                     ("spec_host", dict(speculate_gamma=SPEC_GAMMA)),
                     ("spec_device", dict(speculate_gamma=SPEC_GAMMA,
                                          speculate_device=True))):
        engine = build_engine(smoke_cfg("float32"), **kw)
        submit_all(greedy)(engine)
        f32[name] = {r[0]: list(engine.poll(r[0]).tokens) for r in greedy}
        if name == "plain":
            model = engine.model
        else:
            syncs[name] = engine.metrics.spec_host_syncs_per_token
        del engine
    # Greedy-only traffic lets the chain run windows back to back once the
    # queue is drained (beams send every tick of their run to the host).
    log(f"  f32 greedy-only host syncs per speculative token: host path "
        f"{syncs['spec_host']}, device chain {syncs['spec_device']}")
    same = {name: near_tie_check(torch, f"f32 {name} vs plain", model, srcs,
                                 f32["plain"], f32[name], SPEC_F32_TOL,
                                 rel=False)
            for name in ("spec_host", "spec_device")}
    errs = verify_vs_sequential(torch, model,
                                [r[1] for r in greedy[:SLOTS]],
                                [f32["plain"][r[0]] for r in greedy[:SLOTS]])
    log(f"  f32 first verify vs {SPEC_GAMMA + 1} sequential steps: max "
        f"|diff| / max |logit| paged {errs['paged']:.3e}, dense "
        f"{errs['dense']:.3e} (limit {SPEC_F32_TOL:.0e})")
    if not max(errs.values()) <= SPEC_F32_TOL:
        raise AssertionError(f"verify vs sequential logits: {errs}")
    return dict(runs=out, bf16_token_identical_to_a={
        "b": f"{same_b}/{len(a)}", "c": f"{same_c}/{len(a)}"},
        f32_token_identical={k: f"{v}/{len(greedy)}"
                             for k, v in same.items()},
        f32_host_syncs_per_token=syncs,
        f32_verify_vs_sequential=errs)


def time_verify_shapes(torch, attn):
    """Kernel #1 at the verify shape, γ = 4: q [8, 8, 5, 64] with the span
    bias against the 128-slot dense cache and against the paged span
    gathered through block tables (``span_inputs``), held against its plain
    version on both scales and timed as phase 4 times the serving shapes
    (``device_ms_strided``: q in the model's strided layout)."""
    F = torch.nn.functional
    sq, rows = SPEC_GAMMA + 1, []
    for i, paged in enumerate((False, True)):
        name = f"verify_{'paged' if paged else 'dense'}_g{SPEC_GAMMA}"
        qs, k, v, bias = span_inputs(torch, 400 + i, sq, torch.bfloat16,
                                     paged)
        q = qs.contiguous()
        out = attn.flash_attention_forward(q, k, v, bias)
        ref = attn.attention_reference(q, k, v, bias)
        err = (out.float() - ref.float()).abs().max().item()
        scaled = scaled_error(out, ref)
        log(f"  {name}: max_abs_err={err:.3e} {scaled_line(scaled)}")
        if err > TOL["bfloat16"] or not scaled["ok"]:
            raise AssertionError(f"{name}: kernel vs plain {err} {scaled}")
        lib_mask = bias.to(torch.bfloat16)
        t = time_row(
            torch, lambda: attn.flash_attention_forward(q, k, v, bias),
            lambda: attn.flash_attention_forward(qs, k, v, bias),
            lambda: attn._launch(q, k, v, bias, False, HEAD_DIM ** -0.5,
                                 False, "simt"),
            lambda: attn.attention_reference(q, k, v, bias),
            lambda: F.scaled_dot_product_attention(q, k, v,
                                                   attn_mask=lib_mask),
            200, 20, 200, 20)
        b_ms, by, nbytes, flops = bound_ms(SLOTS, HEADS, sq, SRC_LEN,
                                           HEAD_DIM, 2, bias)
        row = dict(shape=name, q=[SLOTS, HEADS, sq, HEAD_DIM],
                   kv=[SLOTS, HEADS, SRC_LEN, HEAD_DIM], dtype="bfloat16",
                   variant=attn.forward_variant(torch.bfloat16, sq,
                                                HEAD_DIM),
                   **t, bound_ms=b_ms, bound_by=by, bytes=nbytes,
                   flops=flops, max_abs_err=err)
        log_times(name, row)
        rows.append(row)
    return rows


def feature_waves(seed=1, vocab=32000):
    """Phase 20's traffic: 24 sources (every fourth 120 tokens long, the
    rest 8 to 64), then a repeat of each at budget 24 (the cached stream
    covers it: an instant complete) or 48 (a resume at the block
    boundary). Four waves: 16 batch-class originals, 8 latency-class
    originals (which find every row busy), the 16 batch repeats, the 8
    latency repeats. Items: (id, src, budget, tenant, class)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    srcs = []
    for i in range(FEATURE_SOURCES):
        length = SRC_LEN - 8 if i % 4 == 0 else int(rng.randint(8, 65))
        srcs.append([int(t) for t in rng.randint(3, vocab, size=length - 1)]
                    + [2])
    tag = [("t-batch", "batch") if i < 16 else ("t-latency", "latency")
           for i in range(FEATURE_SOURCES)]
    orig = [(f"o{i}", srcs[i], 32, *tag[i]) for i in range(FEATURE_SOURCES)]
    rep = [(f"r{i}", srcs[i], 24 if i % 2 else 48, *tag[i])
           for i in range(FEATURE_SOURCES)]
    return [orig[:16], orig[16:], rep[:16], rep[16:]]


def serve_features(torch, attn):
    """Phase 20: the radix cache, chunked prefill and QoS at full width,
    bf16, in one main-path run, then a plain engine (no radix, no chunks,
    untagged) on the same weights and requests for the tokens."""
    from deeplearning_cfn_tpu_torch.serve import OverloadError

    waves = feature_waves()
    items = [it for wave in waves for it in wave]
    waits, submitted, resubmits = {}, [], [0]

    def tick(engine):
        engine.step()
        for rid in submitted:  # the first admission's queue wait
            req = engine.poll(rid)
            if rid not in waits and req.admitted_at is not None:
                waits[rid] = req.admitted_at - req.submitted_at

    def drive(engine):
        for wave, ticks in zip(waves, (4, None, 2, None)):
            for rid, src, budget, tenant, cls in wave:
                while True:
                    try:
                        engine.submit(src, max_new_tokens=budget,
                                      request_id=rid, tenant=tenant,
                                      qos_class=cls)
                        break
                    except OverloadError as e:
                        # A class rate limit or a full queue: step through
                        # the hint, then submit again in the same class.
                        resubmits[0] += 1
                        until = time.monotonic() + (e.retry_after_s or 0.0)
                        tick(engine)
                        while time.monotonic() < until:
                            tick(engine)
                submitted.append(rid)
            if ticks is None:
                while engine.queue.depth or engine.active_requests:
                    tick(engine)
            else:
                for _ in range(ticks):
                    tick(engine)
        return list(submitted)

    engine, tokens, snap, row = serve_main_path(
        torch, attn, "radix + chunked prefill + QoS",
        lambda: build_engine(smoke_cfg("bfloat16"), radix_cache=True,
                               prefill_chunk=FEATURE_CHUNK), drive)
    m = engine.metrics
    instant = snap["serve_radix_instant_completes"]
    resumed = snap["serve_radix_hits"] - instant
    reqs = {rid: engine.poll(rid) for rid, *_ in items}
    preempted = [rid for rid, q in reqs.items() if q.preemptions > 0]
    lost = [rid for rid in preempted if reqs[rid].tokens[
        :len(reqs[rid].parked_tokens)] != reqs[rid].parked_tokens]
    by_cls = {}
    for rid, _, _, _, cls in items:
        by_cls.setdefault(cls, []).append(waits[rid])
    qw = {cls: dict(p50_s=sorted(w)[len(w) // 2],
                    p95_s=sorted(w)[min(len(w) - 1, int(0.95 * len(w)))])
          for cls, w in by_cls.items()}
    log(f"  radix: hits {snap['serve_radix_hits']} ({instant} instant, "
        f"{resumed} resumed, {snap['serve_radix_hit_tokens']} tokens), "
        f"misses {snap['serve_radix_misses']}, evictions "
        f"{snap['serve_radix_evictions_by_cause']}, blocks held "
        f"{snap['serve_radix_blocks']}; chunk ticks "
        f"{snap['serve_chunk_ticks']}, chunk tokens "
        f"{snap['serve_chunk_tokens']}; preemptions {m.preemptions} "
        f"({len(preempted)} requests), tokens replayed "
        f"{m.preempted_tokens_replayed}, lost {m.qos_token_loss}; "
        f"resubmits after an overload hint {resubmits[0]}")
    for cls, w in sorted(qw.items()):
        log(f"  queue wait {cls}: p50 {w['p50_s'] * 1e3:.2f} ms, p95 "
            f"{w['p95_s'] * 1e3:.2f} ms")
    log(f"  TTFT p50 {row['ttft_p50_s'] * 1e3:.2f} ms, tokens/s "
        f"{row['tokens_per_s']:.1f}, decode-step p50 "
        f"{row['decode_step_p50_ms']:.3f} ms")
    if not (instant > 0 and resumed > 0):
        raise AssertionError(f"radix hits: {instant} instant, {resumed} "
                             f"resumed (both must be > 0)")
    if not m.preemptions > 0:
        raise AssertionError("no preemption")
    if m.qos_token_loss or lost:
        raise AssertionError(f"zero-loss audit: {m.qos_token_loss} tokens "
                             f"lost, requests {lost}")
    del engine
    plain = build_engine(smoke_cfg("bfloat16"))
    submit_all([(rid, src, budget, 1) for rid, src, budget, _, _ in items])(
        plain)
    plain_tokens = {rid: list(plain.poll(rid).tokens) for rid, *_ in items}
    same = near_tie_check(torch, "bf16 vs the plain engine", plain.model,
                          {it[0]: it[1] for it in items}, plain_tokens,
                          tokens, FEATURE_BF16_TIE, rel=True)
    row.update(radix_hits=snap["serve_radix_hits"],
               radix_instant=instant, radix_resumed=resumed,
               radix_hit_tokens=snap["serve_radix_hit_tokens"],
               radix_blocks=snap["serve_radix_blocks"],
               radix_evictions=snap["serve_radix_evictions_by_cause"],
               chunk_ticks=snap["serve_chunk_ticks"],
               preemptions=m.preemptions,
               preempted_requests=len(preempted),
               tokens_replayed=m.preempted_tokens_replayed,
               queue_wait=qw, resubmits=resubmits[0],
               token_identical=f"{same}/{len(items)}")
    return row


# -- slice 10: ViT-S/16, BERT with MoE FFNs, the pipelined BERT trunk -------


def vit_cfg(overrides, workdir_name):
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.presets import get_preset

    return apply_overrides(get_preset("imagenet_vit_s16"), [
        f"workdir={fresh_workdir(workdir_name)}", "train.seed=0",
        "train.log_every_steps=1", *overrides])


def train_vit(torch, attn):
    """Phase 21: imagenet_vit_s16 at full width in bf16 through
    run_experiment on synthetic ImageNet, with every count set to 0
    first."""
    from deeplearning_cfn_tpu_torch.models.vit import forward_flops
    from deeplearning_cfn_tpu_torch.train.run import run_experiment

    steps = VIT_WARMUP + VIT_STEPS
    cfg = vit_cfg([f"train.global_batch={VIT_BATCH}",
                   f"train.grad_accum_steps={VIT_ACCUM}",
                   f"train.steps={steps}", "schedule.warmup_steps=2",
                   f"data.num_train_examples={VIT_TRAIN_EXAMPLES}",
                   f"data.num_eval_examples={VIT_EVAL}",
                   f"train.eval_batch={VIT_EVAL_BATCH}",
                   "train.eval_every_steps=1000000",
                   "checkpoint.every_steps=1000000"], "smoke_vit")
    for cut in VIT_CUTS:
        log(f"  cut: {cut}")
    records, at_end, by_variant, seen = [], {}, {}, {}

    def hook(step, state, record):
        records.append(record)
        if step == steps:
            at_end.update(counts(attn))  # before the eval's forwards
            by_variant.update(variant_counts(attn))
            seen["model"] = state.model

    torch.cuda.reset_peak_memory_stats()
    set_counts(attn, 0)
    t0 = time.perf_counter()
    final = run_experiment(cfg, device=DEVICE, hooks=(hook,))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after_eval, by_variant_eval = counts(attn), variant_counts(attn)
    peak = torch.cuda.max_memory_allocated()
    model = seen.pop("model")
    losses = [r["loss"] for r in records]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"bad losses: {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    log(f"  losses: {' '.join(f'{x:.4f}' for x in losses)}")
    if not last < first:
        raise AssertionError(f"loss did not fall: first-5 mean {first}, "
                             f"last-5 mean {last}")
    micro = steps * VIT_ACCUM
    expect = {k: v * micro for k, v in VIT_PER_STEP.items()}
    eval_batches = math.ceil(VIT_EVAL / VIT_EVAL_BATCH)
    log(f"  launches over {steps} steps (accum {VIT_ACCUM}): {at_end} "
        f"(expected {expect}); after the eval's {eval_batches} batches: "
        f"{after_eval}; by variant {by_variant}")
    if at_end != expect:
        raise AssertionError(f"launch counts {at_end} != {expect}")
    if after_eval != {**expect, "fwd": expect["fwd"]
                      + VIT_LAYERS * eval_batches}:
        raise AssertionError(f"eval launches {after_eval} != 12 per eval "
                             f"batch on top of {expect}")
    if any(by[key]["tc"] != n[key] for by, n in
           ((by_variant, at_end), (by_variant_eval, after_eval))
           for key in ("fwd", "dkdv", "dq")):
        raise AssertionError(f"bf16 ViT launches off the tc variant: "
                             f"{by_variant}, with the eval "
                             f"{by_variant_eval}")
    timed = [r for r in records[VIT_WARMUP:] if "step_time_s" in r]
    step_s = sorted(r["step_time_s"] for r in timed)
    img_s = sorted(r["examples_per_sec"] for r in timed)
    p50 = lambda xs: xs[len(xs) // 2]
    flops = forward_flops(model)
    mfu = mfu_share(p50(img_s), flops)
    bound_step_s = VIT_BATCH * 3 * flops / BF16_FLOP_PER_S
    n_params = sum(p.numel() for p in model.parameters())
    del model
    out = dict(steps=steps, timed_steps=len(timed), global_batch=VIT_BATCH,
               grad_accum_steps=VIT_ACCUM, image_size=cfg.data.image_size,
               tokens=VIT_TOKENS, params=n_params,
               forward_gflop_per_image=flops / 1e9,
               first5_loss=first, last5_loss=last, losses=losses,
               step_time_p50_s=p50(step_s), images_per_s_p50=p50(img_s),
               mfu_share=mfu, tensor_core_bound_step_s=bound_step_s,
               first_step_s=records[0]["compile_s"],
               max_memory_allocated_bytes=peak, wall_s=wall,
               final_eval_loss=final["loss"],
               final_eval_top1=final["accuracy"],
               final_eval_top5=final["accuracy_top5"],
               final_eval_examples=final["examples"],
               launches=at_end, launches_with_eval=after_eval,
               variant_launches=by_variant,
               variant_launches_with_eval=by_variant_eval, cuts=VIT_CUTS)
    log(f"  model: ViT-S/16, {n_params} parameters, "
        f"{out['forward_gflop_per_image']:.3f} GFLOP forward per 224² image "
        f"(counted from the shapes: patch conv, trunk GEMMs, attention over "
        f"196² pairs, head); tensor-core bound of a step "
        f"{bound_step_s * 1e3:.1f} ms")
    log(f"  step time p50 {out['step_time_p50_s'] * 1e3:.2f} ms, images/s "
        f"p50 {out['images_per_s_p50']:.1f}, MFU share {mfu:.4f} (of 989 "
        f"TFLOP/s dense bf16), first step {out['first_step_s']:.2f} s, "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; eval on "
        f"{final['examples']:.0f}: loss {final['loss']:.4f}, top-1 "
        f"{final['accuracy']:.4f}, top-5 {final['accuracy_top5']:.4f}; run "
        f"{wall:.1f} s")
    return out


def _card_and_cpu(torch, task_cls, cfg, times=(), normal=()):
    """The same seeded init on the CPU and on the card (TF32 off): a task
    of ``task_cls`` on each, the CPU one initialised with seed 0, then
    every parameter whose name ends with a suffix in ``times`` multiplied
    by 3 and every one ending with a suffix in ``normal`` redrawn from
    ``normal(0, 0.5)``; the card one loads its weights."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = task_cls(cfg, torch.device("cpu"))
    cpu.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in cpu.model.named_parameters():
            if name.endswith(tuple(times)):
                p.mul_(3.0)
            if name.endswith(tuple(normal)):
                p.normal_(0.0, 0.5, generator=g)
    card = task_cls(cfg, torch.device(DEVICE))
    card.model.load_state_dict(cpu.model.state_dict())
    return cpu, card


def _grad_check(label, cpu_model, card_model, tol=1e-4):
    """Every parameter's gradient on the card within ``tol`` of the CPU's
    global gradient norm; returns the largest error over that norm."""
    import torch

    norm = torch.sqrt(sum((p.grad ** 2).sum()
                          for p in cpu_model.parameters()))
    worst = 0.0
    for (name, p), (_, r) in zip(card_model.named_parameters(),
                                 cpu_model.named_parameters()):
        err = ((p.grad.cpu() - r.grad).norm() / norm).item()
        worst = max(worst, err)
        if not err <= tol:
            raise AssertionError(f"{label}: gradient of {name} off by "
                                 f"{err:.3e} of the norm")
    return worst


def vit_parity(torch, attn):
    """Phase 21, last part: the tiny f32 ViT (tests/test_torch_vit.py's
    config, a random head so the trunk's gradients are nonzero) on the card
    against the CPU, TF32 off: logits within 1e-4 of the largest, the loss
    within 1e-5 relative, every gradient within 1e-4 of the global norm,
    the kernels launched once per layer (simt: f32) and the reference VJP
    never; then 5 Adafactor steps (``optimizer.name=adafactor``, optax's
    defaults behind the 1.0 clip) on each: losses within 1e-4 relative
    and the final parameters within 1e-3 of their norm (Adafactor's first
    update is sign-like, so an element whose true gradient is ~0 — the key
    biases — may step either way on either device; no output depends on
    the key biases)."""
    from deeplearning_cfn_tpu_torch.data.pipeline import (build_pipeline,
                                                          to_device)
    from deeplearning_cfn_tpu_torch.train.optim import (build_optimizer,
                                                        build_schedule)
    from deeplearning_cfn_tpu_torch.train.state import create_train_state
    from deeplearning_cfn_tpu_torch.train.task import ClassificationTask
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer

    cfg = vit_cfg(VIT_TINY, "smoke_vit_tiny")
    cpu, card = _card_and_cpu(torch, ClassificationTask, cfg,
                              normal=("head.weight",))
    batches = [b for _, b in zip(range(5), build_pipeline(
        cfg.data, 16, 10, seed=0).one_epoch())]
    host, dev = torch.device("cpu"), torch.device(DEVICE)
    with torch.no_grad():
        want = cpu.model(to_device(batches[0], host)["image"], train=False)
        got = card.model(to_device(batches[0], dev)["image"], train=False)
    logit_err = ((got.cpu() - want).abs().max() / want.abs().max()).item()
    ref, _ = cpu.loss_fn(to_device(batches[0], host), True)
    ref.backward()
    before = counts(attn)
    loss, _ = card.loss_fn(to_device(batches[0], dev), True)
    loss.backward()
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in counts(attn).items()}
    loss_err = abs(loss.item() - ref.item()) / abs(ref.item())
    grad_err = _grad_check("tiny ViT", cpu.model, card.model)
    log(f"  tiny f32 ViT, card vs CPU: logits {logit_err:.3e} of the "
        f"largest (<= 1e-4), loss {loss_err:.3e} relative (<= 1e-5), "
        f"gradients {grad_err:.3e} of the norm (<= 1e-4); launches "
        f"{launched}")
    if not (logit_err <= 1e-4 and loss_err <= 1e-5):
        raise AssertionError(f"tiny ViT: logits {logit_err}, loss "
                             f"{loss_err}")
    if launched != {"fwd": 2, "dkdv": 2, "dq": 2, "vjp": 0}:
        raise AssertionError(f"tiny ViT launches {launched}")

    ada = vit_cfg(VIT_TINY + ["optimizer.name=adafactor"], "smoke_vit_tiny")
    losses = {}
    finals = {}
    for name, task in (("cpu", cpu), ("card", card)):
        task.cfg = ada
        task.model.zero_grad(set_to_none=True)
        opt = build_optimizer(ada.optimizer, build_schedule(
            ada.schedule, 5, 16), task.model)
        state = create_train_state(task.model, opt)
        trainer = Trainer(ada, task, task.device)
        losses[name] = [float(trainer.train_step(
            state, to_device(b, task.device))["loss"]) for b in batches]
        finals[name] = torch.cat([p.detach().cpu().flatten()
                                  for p in task.model.parameters()])
    step_err = max(abs(a - b) / abs(b) for a, b in
                   zip(losses["card"], losses["cpu"]))
    param_err = ((finals["card"] - finals["cpu"]).norm()
                 / finals["cpu"].norm()).item()
    log(f"  tiny f32 ViT, 5 Adafactor steps: losses card "
        f"{' '.join(f'{x:.6f}' for x in losses['card'])}, CPU "
        f"{' '.join(f'{x:.6f}' for x in losses['cpu'])}: {step_err:.3e} "
        f"relative (<= 1e-4); final parameters {param_err:.3e} of their "
        f"norm (<= 1e-3)")
    if not (step_err <= 1e-4 and param_err <= 1e-3):
        raise AssertionError(f"tiny ViT Adafactor: {losses}, params "
                             f"{param_err}")
    return dict(logit_err_of_max=logit_err, loss_rel_err=loss_err,
                grad_err_of_norm=grad_err, launches=launched,
                adafactor_losses=losses, adafactor_loss_rel_err=step_err,
                adafactor_param_rel_err=param_err)


def _router_margin(torch, model, *inputs, **kw):
    """The smallest router margin of ``model`` on ``inputs`` (top-1 minus
    top-2 and top-2 minus top-3 of the router probabilities, over every
    token of every MoE layer), and each MoE layer's dispatch mask."""
    from deeplearning_cfn_tpu_torch.models.moe import MoeMlp

    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append(mod.route(args[0])))
        for m in model.modules() if isinstance(m, MoeMlp)]
    try:
        with torch.no_grad():
            model(*inputs, **kw)
    finally:
        for h in hooks:
            h.remove()
    top = torch.cat([r[1].flatten(0, -2) for r in seen]).topk(3, -1).values
    margin = torch.minimum(top[:, 0] - top[:, 1], top[:, 1] - top[:, 2])
    return float(margin.min()), [r[2] for r in seen]


def moe_parity(torch, attn):
    """Phase 22, last part: the tiny f32 BERT-MoE and GPT-MoE
    (tests/test_torch_moe.py's configs: 4 experts in layer 1 of 2, top-2,
    capacity factor 0.5 so tokens are dropped; Dense kernels ×3 and the
    routers at std 0.5, so routing margins stay far above f32 rounding) on
    the card against the CPU, TF32 off. BERT-MoE: every MoE layer's
    dispatch mask equal (the CPU's smallest router margin asserted above
    1e-6 first: a closer one would be a rounding tie), the loss with the
    aux terms within 1e-5 relative, every gradient within 1e-4 of the
    global norm. GPT-MoE: the same, then greedy ``lm_generate`` at batch 4,
    24 new tokens: every row token-identical."""
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.data.pipeline import (build_pipeline,
                                                          to_device)
    from deeplearning_cfn_tpu_torch.models.decoding import lm_generate
    from deeplearning_cfn_tpu_torch.presets import get_preset
    from deeplearning_cfn_tpu_torch.train.task import CausalLmTask, MlmTask

    host, dev = torch.device("cpu"), torch.device(DEVICE)
    out = {}
    for label, preset, over, task_cls in (
            ("bert_moe", "bert_moe_wikipedia", MOE_BERT_TINY, MlmTask),
            ("gpt_moe", "gpt_small_lm", MOE_GPT_TINY, CausalLmTask)):
        cfg = apply_overrides(get_preset(preset), over)
        cpu, card = _card_and_cpu(
            torch, task_cls, cfg,
            times=("mlp_in.weight", "mlp_out.weight", "w_in", "w_out"),
            normal=("router.weight",))
        batch = next(iter(build_pipeline(cfg.data, 8, seed=0).one_epoch()))
        tb, cb = to_device(batch, host), to_device(batch, dev)
        if task_cls is MlmTask:
            inputs = lambda b: (b["input_ids"], b["input_mask"],
                                b["segment_ids"], b["mlm_positions"])
            kw = {"train": False}
        else:
            inputs = lambda b: (b["tokens"][:, :-1],)
            kw = {}
        margin, want = _router_margin(torch, cpu.model, *inputs(tb), **kw)
        _, got = _router_margin(torch, card.model, *inputs(cb), **kw)
        if not margin > 1e-6:
            raise AssertionError(f"{label}: router margin {margin} is a "
                                 f"rounding tie")
        same = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
        dropped = sum(float(2 * d.shape[0] * d.shape[1] - d.sum())
                      for d in want)
        ref, ref_aux = cpu.loss_fn(tb, True)
        ref.backward()
        loss, aux = card.loss_fn(cb, True)
        loss.backward()
        loss_err = abs(loss.item() - ref.item()) / abs(ref.item())
        grad_err = _grad_check(label, cpu.model, card.model)
        log(f"  tiny f32 {label}, card vs CPU: router margin {margin:.3e} "
            f"(> 1e-6), dispatch masks equal {same} ({dropped:.0f} choices "
            f"dropped), loss {loss_err:.3e} relative (<= 1e-5; aux "
            f"load_balance {aux['moe_load_balance'].item():.4f}, router_z "
            f"{aux['moe_router_z'].item():.4f}), gradients {grad_err:.3e} "
            f"of the norm (<= 1e-4)")
        if not (same and loss_err <= 1e-5):
            raise AssertionError(f"{label}: dispatch equal {same}, loss "
                                 f"{loss_err}")
        out[label] = dict(router_margin=margin, dispatch_equal=same,
                          dropped_choices=dropped, loss_rel_err=loss_err,
                          grad_err_of_norm=grad_err)
    prompt = torch.from_numpy(batch["tokens"][:4, :8]).long()
    with torch.no_grad():
        want = lm_generate(cpu.model, prompt, 24)
        got = lm_generate(card.model, prompt.to(dev), 24).cpu()
    rows = sum(bool(torch.equal(a, b)) for a, b in zip(got, want))
    distinct = len(set(want[:, 8:].flatten().tolist()))
    log(f"  tiny f32 gpt_moe greedy lm_generate, batch 4, 24 new tokens: "
        f"{rows}/4 rows token-identical ({distinct} distinct tokens)")
    if rows != 4:
        raise AssertionError(f"gpt_moe generation: {rows}/4 rows identical")
    out["gpt_moe"]["greedy_rows_identical"] = f"{rows}/4"
    return out


# Device-time kinds of a Mask R-CNN step, by kernel name, first match
# wins: the ROI-align gathers (index_select) and their backward
# (index_add, atomics), the targets' and NMS's sorts and bool masks,
# casts, BatchNorm's reductions and elementwise work, convolutions.
MRCNN_KINDS = (("ROI-align backward (index_add)",
                ("indexFunc", "index_add")),
               ("ROI-align gather (index_select)", ("indexSelect",
                                                    "vectorized_gather")),
               ("sort / top-k (stable radix sort)", ("sort", "Sort",
                                                     "radix")),
               ("NMS loop and masks (bool elementwise)", ("<bool",
                                                          "bool>")),
               ("gather / scatter (targets, take_rows)",
                ("gather", "scatter")),
               ("copy / cast", ("copy_kernel",)),
               ("reduction (BN statistics, IoU max, losses)",
                ("reduce_kernel",)),
               ("optimizer (foreach)", ("multi_tensor",)),
               ("max-pool / upsample", ("max_pool", "upsample")),
               ("elementwise (BN, ReLU, box math, losses)",
                ("at::native",)),
               ("conv wgrad", ("wgrad",)),
               ("conv dgrad", ("dgrad",)),
               ("conv fprop", ("fprop",)),
               ("conv / gemm, other cuDNN and cuBLAS kernels",
                ("xmma", "gemm", "conv", "cudnn", "cutlass", "sm90",
                 "nvjet")))


def profile_maskrcnn(torch, steps: int = 3, by_kind: bool = True) -> float:
    """``--profile-maskrcnn`` (and phase 15's device-busy share): steady
    full-width bf16 Mask R-CNN train steps (batch 8, momentum) on one
    synthetic COCO batch: host clock against device-busy time, device ops
    per step, kernels ranked and, with ``by_kind``, device time by kind.
    Returns the busy share."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning_cfn_tpu_torch.data.detection import \
        make_detection_source
    from deeplearning_cfn_tpu_torch.data.pipeline import to_device
    from deeplearning_cfn_tpu_torch.train.optim import (build_optimizer,
                                                        build_schedule)
    from deeplearning_cfn_tpu_torch.train.state import create_train_state
    from deeplearning_cfn_tpu_torch.train.task import build_task
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer

    cfg = maskrcnn_cfg([f"train.global_batch={MRCNN_BATCH}",
                        f"schedule.base_lr={MRCNN_LR}"],
                       "smoke_maskrcnn_profile")
    dev = torch.device(DEVICE)
    batch = to_device(make_detection_source(
        MRCNN_BATCH, cfg.data.image_size, cfg.model.num_classes,
        cfg.data.max_boxes, seed=5).arrays, dev)
    task = build_task(cfg, dev)
    task.init(torch.Generator(device=dev).manual_seed(0))
    opt = build_optimizer(cfg.optimizer, build_schedule(
        cfg.schedule, 100, MRCNN_BATCH, 12), task.model)
    trainer, state = Trainer(cfg, task, dev), create_train_state(task.model,
                                                                 opt)

    def run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            trainer.train_step(state, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(2)  # warm up
    plain = run(steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        wall = run(steps)
    busy_us = sum(dev_time(e) for e in kernel_rows(prof))
    log(f"  host clock without the profiler: {plain * 1e3 / steps:.2f} ms "
        f"per step ({MRCNN_BATCH * steps / plain:.2f} images/s)")
    report_profile(prof, wall, steps, "train step")
    if by_kind:
        profile_by_kind(prof, steps, MRCNN_KINDS)
    return busy_us / (wall * 1e6)


# Device-time kinds of a ResNet step, by kernel name, first match wins.
# PyTorch's own kernels (at::native) are copies and casts, reductions,
# the optimizer's foreach ops, max-pool or elementwise; the rest are
# cuDNN's and cuBLAS's convolutions and GEMMs.
KINDS = (("copy / cast", ("copy_kernel",)),
         ("reduction (BN statistics and their backward)",
          ("reduce_kernel",)),
         ("optimizer (foreach)", ("multi_tensor",)),
         ("max-pool", ("max_pool",)),
         ("elementwise (BN, ReLU, residual)", ("at::native",)),
         ("conv wgrad", ("wgrad",)),
         ("conv dgrad", ("dgrad",)),
         ("conv fprop", ("fprop",)),
         ("conv / gemm, other cuDNN and cuBLAS kernels",
          ("xmma", "gemm", "conv", "cudnn", "cutlass", "sm90", "nvjet")))


# Device-time kinds of a BERT step, by kernel name, first match wins.
BERT_KINDS = (("flash forward (kernel #1)", ("flash_attn",)),
              ("GEMM, f32 (the tied MLM decoder, TF32 off)",
               ("sgemm", "f32f32", "simt")),
              ("GEMM, bf16", ("gemm", "nvjet", "xmma", "cutlass", "sm90")),
              ("softmax (reference VJP, log-softmax)", ("softmax",)),
              ("layer norm", ("layer_norm",)),
              ("dropout masks", ("bernoulli", "distribution")),
              ("copy / cast", ("copy_kernel",)),
              ("reduction", ("reduce_kernel",)),
              ("optimizer (foreach)", ("multi_tensor",)),
              ("gather / scatter / index (embeddings, MLM positions)",
               ("index", "gather", "scatter", "embedding")),
              ("elementwise (residual, dropout scale, GELU, masks)",
               ("at::native",)))


def profile_by_kind(prof, steps, kinds):
    """Device time per step by kind (``kinds``: first name match wins),
    with the top 3 kernels of each."""
    by_kind = {}
    for e in kernel_rows(prof):
        low = e.key.lower()
        kind = next((k for k, keys in kinds
                     if any(x.lower() in low for x in keys)), "other")
        t, n, rows = by_kind.get(kind, (0.0, 0, []))
        by_kind[kind] = (t + dev_time(e), n + e.count, rows + [e])
    busy = sum(t for t, _, _ in by_kind.values())
    log("  device time by kind (the top 3 kernels of each, names cut at "
        "200 characters):")
    for kind, (t, n, rows) in sorted(by_kind.items(),
                                      key=lambda kv: -kv[1][0]):
        log(f"    {t / steps / 1e3:9.3f} ms/step  {t / busy:6.1%}  "
            f"x{n / steps:6.1f}  {kind}")
        for e in sorted(rows, key=dev_time, reverse=True)[:3]:
            log(f"        {dev_time(e) / steps / 1e3:8.3f} ms  "
                f"x{e.count / steps:5.1f}  {e.key[:200]}")


def profile_bert(torch, steps: int = 3) -> None:
    """``--profile-bert``: where a steady full-width bf16 BERT-base train
    step (global batch 1024 as 2 × 512, LAMB) spends its time, then the
    same step with ``train.remat`` in turns (plain, remat, remat, plain):
    step time, peak memory and the forward kernel's launches per step."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning_cfn_tpu_torch.data.pipeline import (build_pipeline,
                                                          to_device)
    from deeplearning_cfn_tpu_torch.ops import attention as attn
    from deeplearning_cfn_tpu_torch.train.optim import (build_optimizer,
                                                        build_schedule)
    from deeplearning_cfn_tpu_torch.train.state import create_train_state
    from deeplearning_cfn_tpu_torch.train.task import build_task
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer

    dev = torch.device(DEVICE)
    common = [f"train.global_batch={BERT_BATCH}",
              f"train.grad_accum_steps={BERT_ACCUM}",
              f"data.num_train_examples={BERT_BATCH * (steps + 2)}"]
    cfgs = {"plain": bert_cfg(common, "smoke_bert_profile"),
            "remat": bert_cfg(common + ["train.remat=true"],
                              "smoke_bert_profile")}
    batches = [to_device(b, dev) for _, b in zip(
        range(steps + 2), build_pipeline(cfgs["plain"].data, BERT_BATCH,
                                         seed=0).one_epoch())]
    assert len(batches) == steps + 2

    def setup(cfg):
        task = build_task(cfg, dev)
        task.init(torch.Generator(device=dev).manual_seed(0))
        opt = build_optimizer(cfg.optimizer, build_schedule(
            cfg.schedule, 100, BERT_BATCH), task.model)
        return Trainer(cfg, task, dev), create_train_state(task.model, opt)

    runs = {name: setup(cfg) for name, cfg in cfgs.items()}

    def run(name, bs):
        trainer, state = runs[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in bs:
            trainer.train_step(state, b)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for name in runs:
        run(name, batches[:2])  # warm up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        wall = run("plain", batches[2:])
    report_profile(prof, wall, steps, "train step")
    profile_by_kind(prof, steps, BERT_KINDS)
    stats = {"plain": [], "remat": []}
    for name in ("plain", "remat", "remat", "plain"):
        torch.cuda.reset_peak_memory_stats()
        fwd0 = attn.flash_attention_forward.launches
        vjp0 = attn.attention_reference_vjp.calls
        ms = run(name, batches[2:]) / steps * 1e3
        stats[name].append((ms, torch.cuda.max_memory_allocated() / 2**30,
                            (attn.flash_attention_forward.launches - fwd0)
                            / steps,
                            (attn.attention_reference_vjp.calls - vjp0)
                            / steps))
    for name, rows in stats.items():
        log(f"  {name}: step {' / '.join(f'{r[0]:.2f}' for r in rows)} ms, "
            f"peak {' / '.join(f'{r[1]:.2f}' for r in rows)} GiB (both "
            f"models resident), per step {rows[0][2]:.0f} forward-kernel "
            f"launches and {rows[0][3]:.0f} reference-VJP recomputes")


# Device-time kinds of a GPT step, by kernel name, first match wins.
GPT_KINDS = (("flash kernels (#1 forward, #2 dK/dV, #3 dQ)", ("flash_attn",)),
             ("GEMM, f32 (the tied logits, TF32 off)",
              ("sgemm", "f32f32", "simt")),
             ("GEMM, bf16", ("gemm", "nvjet", "xmma", "cutlass", "sm90")),
             ("log-softmax (the f32 cross-entropy)", ("softmax",)),
             ("layer norm", ("layer_norm",)),
             ("dropout masks", ("bernoulli", "distribution")),
             ("copy / cast", ("copy_kernel",)),
             ("reduction", ("reduce_kernel",)),
             ("optimizer (AdamW, foreach)", ("multi_tensor",)),
             ("gather / scatter / index (embeddings, targets)",
              ("index", "gather", "scatter", "embedding")),
             ("elementwise (residual, dropout scale, GELU)",
              ("at::native",)))


def profile_gpt(torch, steps: int = 3) -> None:
    """``--profile-gpt``: where a steady full-width bf16 GPT-2-small train
    step (batch 16 at sequence 1024, AdamW) spends its time, then the same
    step with ``train.remat`` in turns (plain, remat, remat, plain): step
    time, peak memory and the three kernels' launches per step."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning_cfn_tpu_torch.data.pipeline import (build_pipeline,
                                                          to_device)
    from deeplearning_cfn_tpu_torch.ops import attention as attn
    from deeplearning_cfn_tpu_torch.train.optim import (build_optimizer,
                                                        build_schedule)
    from deeplearning_cfn_tpu_torch.train.state import create_train_state
    from deeplearning_cfn_tpu_torch.train.task import build_task
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer

    dev = torch.device(DEVICE)
    common = [f"train.global_batch={GPT_BATCH}",
              f"data.num_train_examples={GPT_BATCH * (steps + 2)}"]
    cfgs = {"plain": gpt_cfg(common, "smoke_gpt_profile"),
            "remat": gpt_cfg(common + ["train.remat=true"],
                             "smoke_gpt_profile")}
    batches = [to_device(b, dev) for _, b in zip(
        range(steps + 2), build_pipeline(cfgs["plain"].data, GPT_BATCH,
                                         seed=0).one_epoch())]

    def setup(cfg):
        task = build_task(cfg, dev)
        task.init(torch.Generator(device=dev).manual_seed(0))
        opt = build_optimizer(cfg.optimizer, build_schedule(
            cfg.schedule, 100, GPT_BATCH), task.model)
        return Trainer(cfg, task, dev), create_train_state(task.model, opt)

    runs = {name: setup(cfg) for name, cfg in cfgs.items()}

    def run(name, bs):
        trainer, state = runs[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in bs:
            trainer.train_step(state, b)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for name in runs:
        run(name, batches[:2])  # warm up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        wall = run("plain", batches[2:])
    report_profile(prof, wall, steps, "train step")
    profile_by_kind(prof, steps, GPT_KINDS)
    stats = {"plain": [], "remat": []}
    for name in ("plain", "remat", "remat", "plain"):
        torch.cuda.reset_peak_memory_stats()
        before = counts(attn)
        ms = run(name, batches[2:]) / steps * 1e3
        per_step = {k: (v - before[k]) / steps
                    for k, v in counts(attn).items()}
        stats[name].append((ms, torch.cuda.max_memory_allocated() / 2**30,
                            per_step))
    for name, rows in stats.items():
        log(f"  {name}: step {' / '.join(f'{r[0]:.2f}' for r in rows)} ms, "
            f"peak {' / '.join(f'{r[1]:.2f}' for r in rows)} GiB (both "
            f"models resident), launches per step {rows[0][2]}")


# Device-time kinds of a ViT step, by kernel name, first match wins.
VIT_KINDS = (("flash kernels (#1 forward, #2 dK/dV, #3 dQ)", ("flash_attn",)),
             ("patch embedding (cuDNN conv)", ("conv", "cudnn", "implicit",
                                               "dgrad", "wgrad")),
             ("GEMM, bf16", ("gemm", "nvjet", "xmma", "cutlass", "sm90")),
             ("layer norm", ("layer_norm",)),
             ("dropout masks", ("bernoulli", "distribution")),
             ("copy / cast", ("copy_kernel",)),
             ("reduction (GAP, LN's γ/β backward, norms)",
              ("reduce_kernel",)),
             ("optimizer (AdamW, foreach)", ("multi_tensor",)),
             ("log-softmax (the cross-entropy)", ("softmax",)),
             ("elementwise (residual, dropout scale, GELU)",
              ("at::native",)))


def profile_vit(torch, steps: int = 3) -> None:
    """``--profile-vit``: where a steady full-width bf16 ViT-S/16 train
    step (batch 1024 as 4 × 256, AdamW) spends its time: host time against
    device-busy time, device time by kind, and the three kernels' launches
    per step."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning_cfn_tpu_torch.data.pipeline import (build_pipeline,
                                                          to_device)
    from deeplearning_cfn_tpu_torch.ops import attention as attn
    from deeplearning_cfn_tpu_torch.train.optim import (build_optimizer,
                                                        build_schedule)
    from deeplearning_cfn_tpu_torch.train.state import create_train_state
    from deeplearning_cfn_tpu_torch.train.task import build_task
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer

    dev = torch.device(DEVICE)
    cfg = vit_cfg([f"train.global_batch={VIT_BATCH}",
                   f"train.grad_accum_steps={VIT_ACCUM}",
                   f"data.num_train_examples={VIT_TRAIN_EXAMPLES}"],
                  "smoke_vit_profile")
    batches = [to_device(b, dev) for _, b in zip(
        range(steps + 2), build_pipeline(cfg.data, VIT_BATCH, 1000,
                                         seed=0).epochs())]
    task = build_task(cfg, dev)
    task.init(torch.Generator(device=dev).manual_seed(0))
    opt = build_optimizer(cfg.optimizer, build_schedule(
        cfg.schedule, 100, VIT_BATCH), task.model)
    trainer, state = Trainer(cfg, task, dev), create_train_state(task.model,
                                                                 opt)

    def run(bs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in bs:
            trainer.train_step(state, b)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(batches[:2])  # warm up
    before = counts(attn)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        wall = run(batches[2:])
    per_step = {k: (v - before[k]) / steps for k, v in counts(attn).items()}
    report_profile(prof, wall, steps, "train step")
    profile_by_kind(prof, steps, VIT_KINDS)
    log(f"  launches per step {per_step} (expected "
        f"{ {k: v * VIT_ACCUM for k, v in VIT_PER_STEP.items()} })")


def profile_resnet(torch, steps: int = 3) -> None:
    """``--profile-resnet``: where a steady full-width bf16 ResNet-50 train
    step (batch 256, LARS) spends its time."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning_cfn_tpu_torch.train.optim import (build_optimizer,
                                                        build_schedule)
    from deeplearning_cfn_tpu_torch.train.state import create_train_state
    from deeplearning_cfn_tpu_torch.train.task import build_task
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer

    cfg = resnet_cfg(RESNET_BATCH, 100, "smoke_resnet_profile")
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(0)
    size = cfg.data.image_size
    batches = [{"image": torch.randn(RESNET_BATCH, size, size, 3, device=dev,
                                     generator=g),
                "label": torch.randint(0, 1000, (RESNET_BATCH,), device=dev,
                                       generator=g)}
               for _ in range(steps + 2)]
    task = build_task(cfg, dev)
    task.init(torch.Generator(device=dev).manual_seed(0))
    opt = build_optimizer(cfg.optimizer, build_schedule(
        cfg.schedule, 100, RESNET_BATCH, 4), task.model)
    trainer, state = Trainer(cfg, task, dev), create_train_state(task.model,
                                                                 opt)

    def run(bs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in bs:
            trainer.train_step(state, b)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(batches[:2])  # warm up
    plain = run(batches[2:])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        wall = run(batches[2:])
    log(f"  host clock without the profiler: {plain * 1e3 / steps:.2f} ms "
        f"per step ({RESNET_BATCH * steps / plain:.1f} images/s)")
    report_profile(prof, wall, steps, "train step")
    profile_by_kind(prof, steps, KINDS)


def profile_serving(torch, ticks: int = 16) -> None:
    """``--profile``: where a steady greedy decode tick spends its time —
    host wall time per tick against device-busy time (torch.profiler),
    and the CUDA kernels ranked by device time."""
    from torch.profiler import ProfilerActivity, profile

    engine = build_engine(smoke_cfg("bfloat16"))
    for rid, src, _, _ in make_requests(n=SLOTS, n_beam=1)[:SLOTS]:
        engine.submit(src, max_new_tokens=120, request_id=rid)
    engine.step()  # admission + prefill + the first window
    engine.step()
    torch.cuda.synchronize()
    steps_before = engine.decoder_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, wall, engine.decoder_steps - steps_before,
                   "decode step")


def window_runs(torch, attn, cfg_of, steps, again=False):
    """Phase 24's pair of runs of one preset: K = 1 (eager ``train_step``s)
    and K = WINDOW (``window_step``: the first step eager, the rest replays
    of the captured graph), each from the config's seed over the same
    WINDOW batches, staged on the card once and cycled. ``cfg_of(k)`` gives
    the config of each. Returns, for each K, the per-step losses, the
    per-step launches of each window, the final parameters, the wall time
    per step of each window (synced at its end) and its device span per
    step (CUDA events around the window). With ``again`` the K = 1 run is
    made twice (``runs["again"]``): how far two eager runs drift apart."""
    from deeplearning_cfn_tpu_torch.data.pipeline import (build_pipeline,
                                                          to_device)
    from deeplearning_cfn_tpu_torch.train.optim import (build_optimizer,
                                                        build_schedule)
    from deeplearning_cfn_tpu_torch.train.state import create_train_state
    from deeplearning_cfn_tpu_torch.train.task import build_task
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer

    dev = torch.device(DEVICE)
    first = cfg_of(1)
    stream = build_pipeline(first.data, first.train.global_batch,
                            first.model.num_classes,
                            seed=first.train.seed).epochs()
    staged = [to_device(next(stream), dev) for _ in range(WINDOW)]
    stream.close()
    runs = {}
    for key, k in ((1, 1), *((("again", 1),) if again else ()),
                   (WINDOW, WINDOW)):
        cfg = cfg_of(k)
        task = build_task(cfg, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(cfg.train.seed))
        task.init(gen)
        state = create_train_state(task.model, build_optimizer(
            cfg.optimizer, build_schedule(cfg.schedule, steps,
                                          cfg.train.global_batch),
            task.model), ema=cfg.train.ema_decay > 0)
        trainer = Trainer(cfg, task, dev)
        losses, step_s, span_s, launches = [], [], [], []
        set_counts(attn, 0)
        t_run = time.perf_counter()
        for _ in range(0, steps, WINDOW):
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            c0, t0 = counts(attn), time.perf_counter()
            ev[0].record()
            if k == 1:
                loss = torch.stack([trainer.train_step(state, b)["loss"]
                                    for b in staged])
            else:
                loss = trainer.window_step(state, staged)["loss"]
            ev[1].record()
            torch.cuda.synchronize()
            step_s.append((time.perf_counter() - t0) / WINDOW)
            span_s.append(ev[0].elapsed_time(ev[1]) / WINDOW / 1e3)
            c1 = counts(attn)
            launches.append({n: (c1[n] - c0[n]) / WINDOW for n in c1})
            losses += loss.float().tolist()
        runs[key] = dict(losses=losses, step_s=step_s, span_s=span_s,
                       launches=launches,
                       weights=[p.detach().clone() for p in state.params])
        log(f"    K={k}: {steps} steps in {time.perf_counter() - t_run:.1f} s")
        del trainer, state, task
        torch.cuda.empty_cache()
    return runs


@contextlib.contextmanager
def deterministic(torch):
    """PyTorch's deterministic algorithms, strict (an op that has none
    raises), and cuDNN's deterministic convolutions; restored on the way
    out."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        torch.backends.cudnn.deterministic = before[2]


def _drift(ra, rb):
    """(largest loss difference, that over the largest |loss|, the largest
    weight difference over its tensor's largest |value|, bit for bit)."""
    diff = max(abs(a - b) for a, b in zip(ra["losses"], rb["losses"]))
    weight = max(float((a - b).abs().max() / a.abs().max().clamp_min(1e-30))
                 for a, b in zip(ra["weights"], rb["weights"]))
    same = diff == 0 and all(bool((a == b).all()) for a, b in
                             zip(ra["weights"], rb["weights"]))
    return diff, diff / max(abs(x) for x in ra["losses"]), weight, same


def check_windows(name, runs, tol, kernels=False, timed=False):
    """Phase 24's checks of one pair: finite losses, the two trajectories
    within ``tol`` of the largest |value| (bit for bit reported; a ``tol``
    of 0 asks for bit for bit) — and, where the K = 1 run was made twice,
    the two eager runs as well — the same launches per step, and with
    ``kernels`` all three kernels launched; with ``timed`` the step times
    and busy shares. Logs and returns the figures."""
    r1, rk = runs[1], runs[WINDOW]
    l1, lk = r1["losses"], rk["losses"]
    if not all(math.isfinite(x) for x in l1 + lk):
        raise AssertionError(f"{name}: non-finite losses {l1} {lk}")
    loss_diff, loss_rel, weight_rel, bitwise = _drift(r1, rk)
    log(f"  {name} K=1 losses: {' '.join(f'{x:.6f}' for x in l1)}")
    log(f"  {name} K={WINDOW} losses: {' '.join(f'{x:.6f}' for x in lk)}")
    eager = None
    if "again" in runs:
        eager = _drift(r1, runs["again"])
        log(f"  {name}: two eager runs drift {eager[1]:.3e} (loss) and "
            f"{eager[2]:.3e} (weights); bitwise "
            f"{'equal' if eager[3] else 'not equal'}")
        if eager[1] > tol or eager[2] > tol or (tol == 0 and not eager[3]):
            raise AssertionError(f"{name}: two eager runs parted (loss "
                                 f"{eager[1]:.3e} or weights "
                                 f"{eager[2]:.3e} > {tol:.3g})")
    log(f"  {name}: largest loss difference {loss_diff:.3e} ({loss_rel:.3e} "
        f"of the largest loss), largest weight difference {weight_rel:.3e} "
        f"of its tensor's largest |value|; bitwise "
        f"{'equal' if bitwise else 'not equal'} (bound {tol:.3g})")
    if loss_rel > tol or weight_rel > tol or (tol == 0 and not bitwise):
        raise AssertionError(f"{name}: K={WINDOW} graphs left the eager "
                             f"trajectory (loss {loss_rel:.3e} or weights "
                             f"{weight_rel:.3e} > {tol:.3g})")
    if r1["launches"] != rk["launches"]:
        raise AssertionError(f"{name}: per-step launches under replay "
                             f"{rk['launches']} != eager {r1['launches']}")
    per_step = r1["launches"][0]
    log(f"  {name}: launches per step, K=1 and K={WINDOW} alike: "
        f"{per_step}")
    if kernels and min(per_step[n] for n in ("fwd", "dkdv", "dq")) <= 0:
        raise AssertionError(f"{name}: a kernel was not launched: "
                             f"{per_step}")
    out = dict(losses_k1=l1, losses_k4=lk, max_loss_diff=loss_diff,
               max_loss_diff_rel=loss_rel, max_weight_diff_rel=weight_rel,
               bitwise=bitwise, tol=tol, launches_per_step=per_step)
    if eager is not None:
        out.update(eager_drift_loss_rel=eager[1],
                   eager_drift_weight_rel=eager[2], eager_bitwise=eager[3])
    if timed:
        p50 = lambda xs: sorted(xs)[len(xs) // 2]
        # The first window of each run is left out: the K = WINDOW one
        # holds the eager warm-up step and the capture. The device's span
        # of a replayed step (the host far ahead of the card: one launch
        # per step) is the device time of the step's work, gaps between
        # the graph's kernels included; each run's busy share is that over
        # its own wall time per step.
        device = p50(rk["span_s"][1:])
        for k, key in ((1, "k1"), (WINDOW, "k4")):
            step = p50(runs[k]["step_s"][1:])
            out[f"step_time_p50_s_{key}"] = step
            out[f"device_span_p50_s_{key}"] = p50(runs[k]["span_s"][1:])
            out[f"device_busy_share_{key}"] = device / step
        out["first_window_step_s_k4"] = rk["step_s"][0]
        log(f"  {name}: step time p50 K=1 {out['step_time_p50_s_k1'] * 1e3:.2f}"
            f" ms, K={WINDOW} {out['step_time_p50_s_k4'] * 1e3:.2f} ms; "
            f"device span of a replayed step {device * 1e3:.2f} ms, so "
            f"device-busy {out['device_busy_share_k1']:.3f} (K=1) and "
            f"{out['device_busy_share_k4']:.3f} (K={WINDOW}); first K="
            f"{WINDOW} window {out['first_window_step_s_k4'] * 1e3:.1f} ms "
            f"per step (warm-up step and capture)")
    return out


def windowed_run(torch, attn, cfg, per_step, label):
    """Phase 24's main path: ``run_experiment`` (``cli train``'s path) with
    ``train.step_window`` = WINDOW, every count set to 0 first and read at
    the last step's hook, before the eval. The launches must be
    ``per_step`` × microbatch steps: each replay is counted once, the
    capture not at all."""
    from deeplearning_cfn_tpu_torch.train.run import run_experiment

    steps = cfg.train.steps
    at_end, by_variant = {}, {}

    def hook(step, state, record):
        if step == steps:
            at_end.update(counts(attn))
            by_variant.update(variant_counts(attn))

    set_counts(attn, 0)
    t0 = time.perf_counter()
    final = run_experiment(cfg, device=DEVICE, hooks=(hook,))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(os.path.join(cfg.workdir, cfg.preset, "metrics.jsonl")) as fh:
        records = [json.loads(line) for line in fh if line.strip()]
    logged = [r["step"] for r in records if "loss" in r]
    micro = steps * cfg.train.grad_accum_steps
    expect = {k: v * micro for k, v in per_step.items()}
    log(f"  {label} through run_experiment, step_window={WINDOW}: steps "
        f"logged {logged}, launches {at_end} (expected {expect}), by "
        f"variant {by_variant}; run {wall:.1f} s")
    if logged != list(range(WINDOW, steps + 1, WINDOW)):
        raise AssertionError(f"{label}: logged steps {logged}")
    if sum("compile_s" in r for r in records) != 1:
        raise AssertionError(f"{label}: compile_s is not logged once")
    if not all(math.isfinite(r["loss"]) for r in records if "loss" in r):
        raise AssertionError(f"{label}: non-finite loss in {records}")
    if at_end != expect:
        raise AssertionError(f"{label}: launch counts {at_end} != {expect}")
    if any(by_variant[k]["tc"] != at_end[k] for k in ("fwd", "dkdv", "dq")):
        raise AssertionError(f"{label}: bf16 launches off the tc variant: "
                             f"{by_variant}")
    return dict(steps=steps, steps_logged=logged, launches=at_end,
                variant_launches=by_variant, final_eval_loss=final["loss"],
                wall_s=wall)


def train_windows(torch, attn):
    """Phase 24: ``train.step_window=4``. ViT-S/16 and the NMT at full
    width in bf16, K = 1 against K = 4, with their step times and busy
    shares; the other trainable presets as tiny f32 cuts; then the ViT and
    the NMT through ``run_experiment`` with ``step_window=4``, the path's
    launch counts."""
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.presets import get_preset

    for cut in WINDOW_CUTS:
        log(f"  cut: {cut}")
    vit = lambda k, steps=WINDOW_STEPS: vit_cfg(WINDOW_VIT + [
        f"train.step_window={k}", f"train.steps={steps}",
        f"train.log_every_steps={WINDOW}"], "smoke_window_vit")
    nmt = lambda k, steps=WINDOW_STEPS: apply_overrides(
        train_cfg(torch, "bfloat16", TRAIN_BATCH, steps, "smoke_window_nmt"),
        [f"train.step_window={k}", f"train.log_every_steps={WINDOW}",
         "data.num_eval_examples=128"])
    out = {}
    for name, cfg_of in (("vit", vit), ("nmt", nmt)):
        out[name] = check_windows(
            name, window_runs(torch, attn, cfg_of, WINDOW_STEPS),
            WINDOW_TOL["bfloat16"], kernels=True, timed=True)
    for preset, over in WINDOW_TINY.items():
        cfg_of = lambda k, preset=preset, over=over: apply_overrides(
            get_preset(preset), over + [
                "train.dtype=float32", "train.seed=0",
                f"train.step_window={k}",
                f"workdir={fresh_workdir('smoke_window_tiny')}"])
        with deterministic(torch):
            runs = window_runs(torch, attn, cfg_of, WINDOW_TINY_STEPS,
                               again=True)
        out[preset] = check_windows(preset, runs, 0.0)
    out["vit_run"] = windowed_run(torch, attn, vit(WINDOW, 2 * WINDOW),
                                  VIT_PER_STEP, "vit")
    out["nmt_run"] = windowed_run(torch, attn, nmt(WINDOW, 2 * WINDOW),
                                  PER_STEP, "nmt")
    return out


# -- slice 12: int8 weights and the int8 paged KV pool ----------------------

# JAX's serving contracts (serve/bench.py): weight bytes <= 0.35 of f32, KV
# pool bytes <= 0.30 of the f32 pool, and teacher-forced logits within 0.1
# of max(1, the largest |logit|).
INT8_WEIGHT_RATIO, INT8_KV_RATIO, INT8_DIVERGENCE = 0.35, 0.30, 0.1
INT8_TF_STEPS = 32                # teacher-forced positions of the checks
INT8_CLI_LINES = ("the quick brown fox jumps over the lazy dog",
                  "a stitch in time saves nine",
                  "all that glitters is not gold")


def seeded_nmt(torch, dtype):
    """The seeded init the engines of phases 5 and 25 serve (the loader's
    ``allow_init`` path), as a model on the card."""
    from deeplearning_cfn_tpu_torch.models.transformer_nmt import init_weights
    from deeplearning_cfn_tpu_torch.serve.loader import build_nmt

    cfg = smoke_cfg(dtype)
    model = build_nmt(cfg, torch.device(DEVICE))
    init_weights(model, torch.Generator(device=DEVICE).manual_seed(
        int(cfg.train.seed)))
    return model.requires_grad_(False)


def teacher_forced(torch, model, src, mask, tgt, kv_quant):
    """Logits [B, T, V] of ``tgt`` fed position by position through the
    paged decode (blocks of 16, each row its own blocks)."""
    b = src.shape[0]
    mb = model.max_len // 16
    tables = torch.arange(1, b * mb + 1, device=DEVICE).view(b, mb)
    cache = model.init_paged_cache(b * mb + 1, 16, kv_quant=kv_quant)
    with torch.no_grad():
        enc = model.encode(src, mask)
        return torch.cat([
            model.decode_step_paged(tgt[:, t:t + 1], enc, mask,
                                    torch.full((b,), t, device=DEVICE),
                                    tables, cache).float()
            for t in range(tgt.shape[1])], dim=1)


def int8_divergence(torch, reqs):
    """Weights, KV and both against the unquantized bf16 model on one
    teacher-forced batch (the first ``SLOTS`` sources, seeded targets):
    max |Δlogit| and the bound 0.1 · max(1, max |ref|)."""
    from deeplearning_cfn_tpu_torch.serve.quant import quantize_model

    model = seeded_nmt(torch, "bfloat16")
    qmodel = quantize_model(model)
    src = torch.zeros((SLOTS, SRC_LEN), dtype=torch.long, device=DEVICE)
    for i, (_, ids, _, _) in enumerate(reqs[:SLOTS]):
        src[i, :len(ids)] = torch.tensor(ids, device=DEVICE)
    mask = (src != 0).long()
    g = torch.Generator(device=DEVICE).manual_seed(2)
    tgt = torch.randint(3, model.vocab_size, (SLOTS, INT8_TF_STEPS),
                        generator=g, device=DEVICE)
    ref = teacher_forced(torch, model, src, mask, tgt, "")
    with torch.no_grad():
        full = model(src, mask, tgt, train=False).float()
        full_q = qmodel(src, mask, tgt, train=False).float()
    out = {}
    for name, got, want in (
            ("weights", full_q, full),
            ("kv", teacher_forced(torch, model, src, mask, tgt, "int8"), ref),
            ("both", teacher_forced(torch, qmodel, src, mask, tgt, "int8"),
             ref)):
        diff = (got - want).abs().max().item()
        out[name] = dict(max_abs_diff=diff,
                         bound=INT8_DIVERGENCE
                         * max(1.0, want.abs().max().item()))
    log("  teacher-forced logits against the bf16 model (bound 0.1 * "
        "max(1, max |ref|)): " + ", ".join(
            f"{k} {v['max_abs_diff']:.4f} (bound {v['bound']:.4f})"
            for k, v in out.items()))
    for name, v in out.items():
        if not v["max_abs_diff"] <= v["bound"]:
            raise AssertionError(f"int8 {name}: logits diverge by "
                                 f"{v['max_abs_diff']} > {v['bound']}")
    return out


def int8_tiny_parity(torch):
    """A tiny f32 NMT with int8 weights and the int8 pool on the card
    against the CPU (TF32 off) from one seeded init and one prior pool:
    one paged verify span of 5 (rows past the table, an unbound entry, a
    row on the null block). Logits within 1e-3 of the largest, codes within
    ±1."""
    import numpy as np

    from deeplearning_cfn_tpu_torch.models.transformer_nmt import (
        init_weights, transformer_nmt_tiny)
    from deeplearning_cfn_tpu_torch.serve.quant import quantize_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = transformer_nmt_tiny(vocab_size=64, max_len=32)
    init_weights(cpu, torch.Generator().manual_seed(0))
    card = transformer_nmt_tiny(vocab_size=64, max_len=32, device=DEVICE)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    b, nb, bs, s = 4, 17, 8, 5
    src = torch.from_numpy(rng.integers(3, 64, (b, 8)))
    tgt = torch.from_numpy(rng.integers(3, 64, (b, s)))
    pos = torch.tensor([6, 9, 29, 31])
    tables = torch.tensor([[1, 0, 0, 0], [0, 0, 0, 0], [6, 7, 8, 9],
                           [10, 11, 12, 13]])
    prior = [torch.from_numpy(rng.integers(-127, 128, (nb, 4, bs, 16))
                              .astype(np.int8)) for _ in range(2)] + \
        [torch.from_numpy(rng.uniform(0.01, 0.05, (nb, 4))
                          .astype(np.float32)) for _ in range(2)]
    outs = []
    for model in (cpu, card):
        qm = quantize_model(model)
        dev = qm.device
        cache = qm.init_paged_cache(nb, bs, kv_quant="int8")
        for layer in cache:
            for t, p in zip(layer, prior):
                t.copy_(p)
        mask = torch.ones_like(src).to(dev)
        with torch.no_grad():
            logits = qm.decode_span_paged(
                tgt.to(dev), qm.encode(src.to(dev), mask), mask,
                pos.to(dev), tables.to(dev), cache)
        outs.append((logits.cpu(), [t.cpu() for layer in cache
                                    for t in layer[:2]]))
    (ref, ref_codes), (got, got_codes) = outs
    logit_err = ((got - ref).abs().max() / ref.abs().max()).item()
    code_err = max((a.int() - b.int()).abs().max().item()
                   for a, b in zip(ref_codes, got_codes))
    log(f"  tiny f32 card vs CPU (int8 weights + int8 pool, span 5): "
        f"logits max |diff| / max |logit| {logit_err:.3e} (limit 1e-3), "
        f"codes max |diff| {code_err} (limit 1)")
    if not (logit_err <= 1e-3 and code_err <= 1):
        raise AssertionError(f"int8 tiny card vs CPU: logits {logit_err}, "
                             f"codes {code_err}")
    return dict(logits_rel=logit_err, codes_max_diff=code_err)


def int8_cli():
    """Phase 25's ``cli serve --quantize int8 --kv-quant int8 --vocab`` (a
    process of its own; it times nothing) on three text
    lines, with a BPE vocab trained offline (``data/bpe.py``): exit 0, and
    on every result line a ``"text"`` field that is the vocab's decoding of
    its tokens (the random weights emit ids past the 300-id vocab too,
    which decode to nothing)."""
    from deeplearning_cfn_tpu_torch.data.bpe import NMT_SPECIALS, train_bpe

    workdir = fresh_workdir("smoke_int8_cli")
    os.makedirs(workdir)
    vocab = os.path.join(workdir, "vocab.json")
    bpe = train_bpe(list(INT8_CLI_LINES) * 4, 300, NMT_SPECIALS)
    bpe.save(vocab)
    reqs = os.path.join(workdir, "reqs.jsonl")
    with open(reqs, "w") as fh:
        for i, line in enumerate(INT8_CLI_LINES):
            fh.write(json.dumps({"text": line, "id": f"t{i}",
                                 "max_new_tokens": 8}) + "\n")
    cmd = [sys.executable, "-m", "deeplearning_cfn_tpu_torch.cli", "serve",
           "--preset", "transformer_nmt_wmt", "--allow-init", "--requests",
           reqs, "--quantize", "int8", "--kv-quant", "int8", "--vocab",
           vocab, f"workdir={workdir}", "train.seed=0"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    wall = time.perf_counter() - t0
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    log(f"  cli serve --quantize int8 --kv-quant int8 --vocab: rc "
        f"{proc.returncode} in {wall:.1f} s; {len(lines)} result lines, "
        f"tokens {[ln.get('tokens') for ln in lines]}, texts "
        f"{[ln.get('text') for ln in lines]}")
    if proc.returncode != 0 or len(lines) != len(INT8_CLI_LINES) \
            or not all(ln["state"] == "done"
                       and ln.get("text") == bpe.decode(ln["tokens"])
                       for ln in lines):
        raise AssertionError(f"cli serve (text): rc {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return dict(rc=proc.returncode, wall_s=wall, results=len(lines))


def serve_int8(torch, attn, reqs, served):
    """Phase 25: phase 5's engine and requests with ``quantize="int8"`` and
    ``kv_quant="int8"``, then the byte ratios, the divergence checks, the
    speculative and beam-window identities, the weight swap and the tiny
    f32 card-vs-CPU check (its text CLI, ``int8_cli``, runs beside phase
    26's jobs and joins the row as ``cli``)."""
    from deeplearning_cfn_tpu_torch.serve.quant import (kv_pool_bytes,
                                                        variables_bytes)

    torch.cuda.reset_peak_memory_stats()
    kw = dict(quantize="int8", kv_quant="int8")
    engine, tokens, snap, row = serve_main_path(
        torch, attn, "int8 weights + int8 KV",
        lambda: build_engine(smoke_cfg("bfloat16"), **kw), submit_all(reqs))
    peak = torch.cuda.max_memory_allocated()
    variants = row["variant_launches"]
    in_use = engine.allocator.blocks_in_use
    log(f"  forward launches by variant {variants}; KV blocks in use after "
        f"the drain {in_use}")
    if not (variants["decode"] > 0 and variants["tc"] > 0):
        raise AssertionError(f"int8 path launches: {variants} (decode and "
                             f"the tc encoder must both be > 0)")
    if in_use:
        raise AssertionError(f"{in_use} KV blocks held after the drain")
    f32_model = seeded_nmt(torch, "bfloat16")
    w_int8 = variables_bytes(engine.model)
    w_f32 = variables_bytes(f32_model)
    stored, f32_pool = kv_pool_bytes(engine.cache, engine.kv_blocks)
    bf16_pool = f32_pool // 2
    gauge = snap["serve_kv_quant_bytes"]
    log(f"  weight bytes int8 {w_int8} / f32 {w_f32} = "
        f"{w_int8 / w_f32:.4f} (limit {INT8_WEIGHT_RATIO}); KV pool bytes "
        f"stored {stored} / f32 {f32_pool} = {stored / f32_pool:.4f} (limit "
        f"{INT8_KV_RATIO}), / the bf16 pool of phase 5 {bf16_pool} = "
        f"{stored / bf16_pool:.4f}; serve_kv_quant_bytes {gauge}")
    if not (w_int8 <= INT8_WEIGHT_RATIO * w_f32
            and stored <= INT8_KV_RATIO * f32_pool and gauge == stored):
        raise AssertionError("int8 byte contracts broken")
    log(f"  tokens/s {row['tokens_per_s']:.1f} (phase 5: "
        f"{served['tokens_per_s']:.1f}), TTFT p50 "
        f"{row['ttft_p50_s'] * 1e3:.2f} ms (phase 5: "
        f"{served['ttft_p50_s'] * 1e3:.2f}), decode-step p50 "
        f"{row['decode_step_p50_ms']:.3f} ms (phase 5: "
        f"{served['decode_step_p50_ms']:.3f}); max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    del engine
    divergence = int8_divergence(torch, reqs)
    _, spec_tokens, spec_snap, spec_row = serve_main_path(
        torch, attn, "int8 + speculation (gamma 4, device chain)",
        lambda: build_engine(smoke_cfg("bfloat16"),
                             speculate_gamma=SPEC_GAMMA,
                             speculate_device=True, **kw), submit_all(reqs))
    same = sum(spec_tokens[r] == tokens[r] for r in tokens)
    log(f"  speculation on the int8 engine: {same}/{len(tokens)} requests "
        f"token-identical to the plain int8 engine; accepted/proposed "
        f"{spec_snap['serve_spec_accepted']}/"
        f"{spec_snap['serve_spec_proposed']}")
    if same != len(tokens):
        raise AssertionError(f"int8 speculation: {same}/{len(tokens)} "
                             f"token-identical")
    beam = next(r for r in reqs if r[3] > 1)
    beams = []
    for window in (1, 4):
        eng = build_engine(smoke_cfg("bfloat16"), decode_window=window, **kw)
        submit_all([beam])(eng)
        beams.append(list(eng.poll(beam[0]).tokens))
        del eng
    log(f"  beam {beam[3]} with the int8 pool: windows 1 and 4 "
        f"{'identical' if beams[0] == beams[1] else 'DIFFER'}")
    if beams[0] != beams[1]:
        raise AssertionError(f"int8 beam windows differ: {beams}")
    greedy = [r for r in reqs if r[3] == 1][:SLOTS]
    eng = build_engine(smoke_cfg("bfloat16"), radix_cache=True, **kw)
    submit_all(greedy)(eng)
    first = {r[0]: list(eng.poll(r[0]).tokens) for r in greedy}
    held = eng.radix.source_count
    eng.swap_variables(f32_model.state_dict())
    dropped = eng.radix.source_count
    again = [(rid + "_swapped", src, budget, beam)
             for rid, src, budget, beam in greedy]
    submit_all(again)(eng)
    same_swap = sum(list(eng.poll(r[0] + "_swapped").tokens) == first[r[0]]
                    for r in greedy)
    log(f"  swap_variables (the f32 state, requantized): radix sources "
        f"{held} before, {dropped} after; {same_swap}/{len(greedy)} "
        f"requests token-identical after the swap")
    if not (held > 0 and dropped == 0 and same_swap == len(greedy)):
        raise AssertionError("swap_variables check failed")
    del eng, f32_model
    tiny = int8_tiny_parity(torch)
    row.update(
        weight_bytes=w_int8, weight_bytes_f32=w_f32,
        weight_ratio=w_int8 / w_f32, kv_bytes=stored, kv_bytes_f32=f32_pool,
        kv_ratio=stored / f32_pool, kv_ratio_to_bf16=stored / bf16_pool,
        max_memory_allocated=peak, divergence=divergence,
        spec=dict(token_identical=f"{same}/{len(tokens)}",
                  launches=spec_row["launches"],
                  variant_launches=spec_row["variant_launches"],
                  accepted=spec_snap["serve_spec_accepted"],
                  proposed=spec_snap["serve_spec_proposed"]),
        beam_windows_identical=beams[0] == beams[1],
        swap=dict(radix_before=held, radix_after=dropped,
                  token_identical=f"{same_swap}/{len(greedy)}"),
        tiny_f32_card_vs_cpu=tiny,
        phase5=dict(tokens_per_s=served["tokens_per_s"],
                    ttft_p50_s=served["ttft_p50_s"],
                    decode_step_p50_ms=served["decode_step_p50_ms"]),
        tokens_by_request=tokens)
    return row


# Phase 26: the launched path (ROADMAP A.13). transformer_nmt_wmt at phase
# 9's widths and recipe (bf16, batch 128) through `cli stack create` (a
# one-host dry-run stack), `cli train --stack` (the launcher fans
# `train.worker` to the host as a local process on the card) and the crash
# recovery harness (`launch/chaos.py`). The workers' kernel launches happen
# in their own processes, which the parent's counters do not see: the
# worker's Chrome trace (train.profile_steps=1) shows them instead.
LAUNCH_STEPS = 12
LAUNCH_OVERRIDES = [
    "train.dtype=bfloat16", "train.seed=0",
    f"train.global_batch={TRAIN_BATCH}", "schedule.warmup_steps=10", "schedule.base_lr=1e-3",
    "data.num_eval_examples=128", "eval.max_decode_len=32"]
CHAOS = dict(total_steps=8, kill_at_step=4, ckpt_every=4, max_restarts=2)
# Synchronous saves: the step-4 save commits before the kill hook runs, so
# the restarted attempt resumes from step 4 (with asynchronous saves the
# SIGKILL lands before the commit and the restart begins again at 0).
CHAOS_OVERRIDES = LAUNCH_OVERRIDES + ["checkpoint.async_write=false"]
KERNEL_NAMES = ("flash_attn_fwd", "flash_attn_bwd_dkdv", "flash_attn_bwd_dq")
# Thresholds the runs must hold; a loss ceiling above ln(32000) + smoothing.
LAUNCH_RULES = {"rules": [
    {"name": "train-step-time-p95", "metric": "step_time_s",
     "kind": "percentile", "q": 95, "max": 5.0, "min_count": 3},
    {"name": "train-loss-ceiling", "metric": "loss", "kind": "threshold",
     "max": 20.0}]}


def cli_inprocess(argv):
    """``cli.main(argv)`` in this process; returns (exit code, stdout)."""
    import contextlib
    import io

    from deeplearning_cfn_tpu_torch.cli.main import main as cli

    out = io.StringIO()
    with CLI, contextlib.redirect_stdout(out):
        rc = cli(list(argv))
    return rc, out.getvalue()


def read_jsonl(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def step_p50(records):
    times = sorted(r["step_time_s"] for r in records if "step_time_s" in r)
    return times[len(times) // 2]


def trace_kernels(profile_dir):
    """Kernel launches by name in the worker's Chrome trace(s)."""
    import glob

    paths = glob.glob(os.path.join(profile_dir, "*.pt.trace.json"))
    if not paths:
        raise AssertionError(f"no Chrome trace under {profile_dir}")
    found = dict.fromkeys(KERNEL_NAMES, 0)
    for path in paths:
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
        for e in events:
            if e.get("cat") != "kernel":
                continue
            for name in KERNEL_NAMES:
                if f"{name}_" in e.get("name", ""):
                    found[name] += 1
    return found


def attempt_times(log_dir):
    """(wall seconds of each attempt, the ts of each attempt's end event)
    from the launcher's launch.jsonl."""
    recs = read_jsonl(os.path.join(log_dir, "launch.jsonl"))
    walls = [r["dur_s"] for r in recs if r.get("span") == "launch.attempt"]
    ends = [r["ts"] for r in recs if r.get("event") == "launch_attempt"]
    return walls, ends


def expected_device_line(torch):
    return f"one device: {torch.cuda.get_device_name(0)} (cuda:"


def launched_training(torch, root, trained, accelerator="gpu"):
    """Phase 26a: a one-host dry-run stack and `cli train --stack` on it."""
    state_dir = os.path.join(root, "stacks")
    rc, out = cli_inprocess(["stack", "create", "--name", "smoke",
                             "--slice-type", "v5p-4", "--provisioner",
                             "dryrun", "--state-dir", state_dir])
    if rc != 0 or "CREATE_COMPLETE: 1 hosts" not in out:
        raise AssertionError(f"stack create: rc {rc}\n{out}")
    workdir = os.path.join(root, "work")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning_cfn_tpu_torch.cli", "train",
         "--preset", "transformer_nmt_wmt", "--stack", "smoke",
         "--state-dir", state_dir, "--max-steps", str(LAUNCH_STEPS),
         "--accelerator", accelerator,
         f"workdir={workdir}", "train.log_every_steps=1",
         "train.profile_steps=1", *LAUNCH_OVERRIDES],
        cwd=root, capture_output=True, text=True, timeout=400)
    wall = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    if proc.returncode != 0 or "job finished" not in out:
        raise AssertionError(f"train --stack: rc {proc.returncode}\n"
                             f"{out[-4000:]}")
    run_dir = os.path.join(workdir, "transformer_nmt_wmt")
    with open(os.path.join(run_dir, "logs", "attempt0-host0.log")) as fh:
        worker_log = fh.read()
    device_line = [ln for ln in worker_log.splitlines()
                   if "one device:" in ln]
    if not device_line or expected_device_line(torch) not in device_line[0]:
        raise AssertionError(f"the worker's log names no CUDA device: "
                             f"{device_line}")
    kernels = trace_kernels(os.path.join(run_dir, "profile"))
    if not all(kernels.values()):
        raise AssertionError(f"the worker's trace lacks a kernel: {kernels}")
    recs = read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    spans = {r["span"] for r in recs if "span" in r}
    if not {"train.dispatch", "ckpt.save"} <= spans:
        raise AssertionError(f"metrics.jsonl spans {sorted(spans)}")
    if not os.path.exists(os.path.join(run_dir, "metrics.prom")):
        raise AssertionError("no metrics.prom")
    steps = [r for r in recs if "loss" in r and "step" in r
             and "span" not in r and "final_eval_loss" not in r]
    losses = [r["loss"] for r in steps]
    if len(losses) != LAUNCH_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"bad losses {losses}")
    walls, _ = attempt_times(os.path.join(run_dir, "logs"))
    out = dict(steps=LAUNCH_STEPS, step_time_p50_s=step_p50(steps),
               phase9_step_time_p50_s=trained["step_time_p50_s"],
               attempt_wall_s=walls, cli_wall_s=wall,
               device_line=device_line[0], trace_kernel_launches=kernels,
               spans=sorted(spans))
    log(f"  {device_line[0].strip()}")
    log(f"  train --stack: rc 0, job finished in {wall:.1f} s (attempt "
        f"wall {walls[0]:.2f} s); kernels in the worker's traced step: "
        f"{kernels}; spans {sorted(spans)}; metrics.prom written")
    log(f"  launched step p50 {out['step_time_p50_s'] * 1e3:.2f} ms against "
        f"phase 9's {trained['step_time_p50_s'] * 1e3:.2f} ms (one traced "
        f"step among {LAUNCH_STEPS}) [{card_line()}]")
    return out


def crash_recovery(root, accelerator="gpu"):
    """Phase 26b: SIGKILL the launched worker at step 4, restart, resume."""
    from deeplearning_cfn_tpu_torch.launch.chaos import run_crash_recovery

    workdir = os.path.join(root, "chaos")
    report = run_crash_recovery(workdir, preset="transformer_nmt_wmt",
                                overrides=CHAOS_OVERRIDES,
                                accelerator=accelerator, **CHAOS)
    outcomes = report.chaos_result.attempt_outcomes
    checks = {
        "baseline ok": report.baseline_result.success,
        "chaos ok": report.chaos_result.success,
        "outcomes crash, ok": outcomes == ["crash", "ok"],
        "resumed from 4": report.resumed_from == 4,
        "per-step losses bit for bit": report.parity_ok,
        "no uncommitted step dir": report.uncommitted_after == [],
        "report ok": report.ok,
    }
    log(f"  baseline steps {report.baseline_steps}, chaos steps "
        f"{report.chaos_steps}, outcomes {outcomes}, resumed from "
        f"{report.resumed_from}, mismatches {report.mismatches}, "
        f"uncommitted {report.uncommitted_after}")
    if not all(checks.values()):
        raise AssertionError(f"crash recovery: {checks}")
    base_walls, _ = attempt_times(os.path.join(workdir, "logs-baseline"))
    walls, ends = attempt_times(os.path.join(workdir, "logs-chaos"))
    # From the launcher seeing attempt 0's death (the SIGKILL, within one
    # 0.1 s poll) to the resumed attempt's first step record: the restart
    # backoff (2 s), the worker's start, the restore and the first step.
    recs = read_jsonl(os.path.join(workdir, "chaos", "transformer_nmt_wmt",
                                   "metrics.jsonl"))
    resumed = [r for r in recs if "loss" in r and "span" not in r
               and r["ts"] > ends[0]]
    overhead = resumed[0]["ts"] - ends[0]
    out = dict(baseline_attempt_wall_s=base_walls, attempt_wall_s=walls,
               outcomes=outcomes, resumed_from=report.resumed_from,
               first_resumed_step=resumed[0]["step"],
               restart_overhead_s=overhead,
               resumed_first_step_s=resumed[0].get("compile_s"),
               parity_ok=report.parity_ok,
               run_dir=os.path.join(workdir, "chaos", "transformer_nmt_wmt"),
               log_dir=os.path.join(workdir, "logs-chaos"))
    log(f"  attempt wall s: baseline {base_walls}, chaos {walls}; restart "
        f"overhead {overhead:.2f} s (SIGKILL seen -> step "
        f"{resumed[0]['step']} recorded; that step's own first-step time "
        f"{out['resumed_first_step_s']} s) [{card_line()}]")
    return out


def obs_verbs(root, chaos):
    """Phase 26c: the obs verbs and `metrics` on the chaos run."""
    from deeplearning_cfn_tpu_torch.obs.export import validate_trace

    rules = os.path.join(root, "rules.json")
    with open(rules, "w") as fh:
        json.dump(LAUNCH_RULES, fh)
    trace = os.path.join(root, "trace.json")
    run_dir = chaos["run_dir"]
    calls = {
        "summarize": ["obs", "summarize", run_dir, "--json"],
        "summarize_launch": ["obs", "summarize", chaos["log_dir"], "--json"],
        "check": ["obs", "check", run_dir, "--rules", rules],
        "export": ["obs", "export", run_dir, "-o", trace],
        "metrics": ["metrics", run_dir],
    }
    outs = {}
    for name, argv in calls.items():
        rc, outs[name] = cli_inprocess(argv)
        if rc != 0:
            raise AssertionError(f"cli {' '.join(argv)}: rc {rc}\n"
                                 f"{outs[name]}")
    with open(trace) as fh:
        problems = validate_trace(json.load(fh))
    if problems:
        raise AssertionError(f"exported trace: {problems[:5]}")
    summary = json.loads(outs["summarize"])
    launch = json.loads(outs["summarize_launch"])["launch"]
    save = summary["spans"]["ckpt.save"]
    if launch["outcomes"] != ["crash", "ok"]:
        raise AssertionError(f"obs summarize launch: {launch}")
    out = dict(ckpt_save_p50_s=save["p50"], ckpt_save_p95_s=save["p95"],
               ckpt_saves=save["count"], launch=launch,
               check=outs["check"].strip().splitlines()[-1],
               export=outs["export"].strip().splitlines()[-1])
    log(f"  obs summarize: ckpt.save p50 {save['p50']:.4f} s, p95 "
        f"{save['p95']:.4f} s over {save['count']} saves; attempts "
        f"{launch['outcomes']} [{card_line()}]")
    log(f"  {out['check']}")
    log(f"  {out['export']} (validate_trace: no problem)")
    return out


def launched_path(torch, trained, root, beside=()):
    """Phase 26: 26a-26d in the directory ``root`` (phase 27 reuses the
    chaos run's checkpoints; the caller removes it); 26a, 26b and the
    ``beside`` jobs at once (``at_once``), whose results come back under
    ``"beside"``."""
    # The workers find the package from any directory; this process's
    # cached blocks go back to the card first.
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p)
    torch.cuda.empty_cache()
    runs = at_once([("26a", lambda: launched_training(torch, root, trained)),
                    ("26b", lambda: crash_recovery(root)), *beside])
    launched, chaos = runs["26a"], runs["26b"]
    t = time.perf_counter()
    verbs = obs_verbs(root, chaos)
    log(f"  26c {time.perf_counter() - t:.1f} s")
    rc, out = cli_inprocess(["doctor"])
    log("  " + out.strip().replace("\n", "\n  "))
    if rc != 0 or "all checks passed" not in out:
        raise AssertionError(f"doctor: rc {rc}")
    return dict(launched=launched, crash_recovery=chaos, obs=verbs,
                doctor="all checks passed",
                beside={label: runs[label] for label, _ in beside})


# Phase 27: the fleet (ROADMAP A.6d + A.12). transformer_nmt_wmt at full
# width in bf16 as a disaggregated prefill/decode pair behind the router
# (the KV handoff through a store), route and rollout over phase 26's
# committed checkpoints, then `fleet up` with `cli serve` children and with
# `net.server` children behind unix sockets (the seeded tiny recipe). The
# children's kernel launches happen in their own processes: each prints its
# count, which the phase reads from the child's log.
FLEET_RUN_REQUESTS = 12
NET_REQUESTS, NET_SLOTS, NET_BUDGET = 64, 4, 48
NMT_LAYERS = 6  # transformer_nmt_wmt's encoder and decoder depth


def replica_launch_counts(attn, replicas):
    """Wrap each replica's ``step`` so that the forward kernel's launches
    during it are added to that replica's own count (the router steps the
    replicas in turn in this process; nothing else here launches)."""
    fwd = attn.flash_attention_forward
    counts = {}
    for rep in replicas:
        tally = counts[rep.id] = {"launches": 0,
                                  **dict.fromkeys(fwd.variant_launches, 0)}

        def counted(step=rep.step, tally=tally):
            n0, by0 = fwd.launches, dict(fwd.variant_launches)
            try:
                return step()
            finally:
                tally["launches"] += fwd.launches - n0
                for v, n in fwd.variant_launches.items():
                    tally[v] += n - by0[v]
        rep.step = counted
    return counts


def pctl(values, q):
    from deeplearning_cfn_tpu_torch.serve.metrics import percentile

    return percentile(list(values), q)


def write_requests(path, reqs):
    with open(path, "w") as fh:
        for rid, src, budget, beam in reqs:
            fh.write(json.dumps({"id": rid, "src_ids": src,
                                 "max_new_tokens": budget,
                                 "beam_size": beam}) + "\n")


def result_lines(out):
    return {r["id"]: r for r in (json.loads(ln) for ln in out.splitlines()
                                 if ln.startswith("{"))}


def disagg_pair(torch, attn, root, label, reqs, want, colocated, extra=()):
    """27a/27b: ``cli fleet up --prefill 1 --decode 1`` in this process. The
    CLI builds one prefill and one decode replica of phase 5's engine (8
    slots, paged blocks of 16, decode window 4, seeded init) through
    ``load_engine(phase=...)`` and routes the requests; the router moves
    every request through the store codec after its first token. The
    router class is wrapped to record the replicas and to count each one's
    launches around its own steps, from 0 once both are built. rc 0, every
    request done, none dropped, one handoff each, the printed tokens equal
    to the co-located engine's (``want``), the decode replica without an
    encoder call, both replicas on the CUDA kernel with launches equal to
    their tallies."""
    import deeplearning_cfn_tpu_torch.fleet as fleet
    from deeplearning_cfn_tpu_torch.models.decoding import strip_special

    name = label.split()[0]
    path = os.path.join(root, f"{name}_requests.jsonl")
    write_requests(path, reqs)
    built = {}
    cli_router = fleet.Router

    class CountedRouter(cli_router):
        def __init__(self, replicas, **kw):
            super().__init__(replicas, **kw)
            built.update(
                router=self, engines={r.id: r.engine for r in replicas},
                counts=replica_launch_counts(attn, replicas),
                before={r.id: (r.engine.encoder_forwards,
                               r.engine.decoder_steps) for r in replicas})
            torch.cuda.synchronize()
            set_counts(attn, 0)
            built["t0"] = time.perf_counter()

    fleet.Router = CountedRouter
    try:
        rc, out = cli_inprocess([
            "fleet", "up", "--prefill", "1", "--decode", "1", "--preset",
            "transformer_nmt_wmt", "--accelerator", "gpu", "--requests",
            path, "--slots", str(SLOTS), "--max-new-tokens", "32",
            "--decode-window", "4", "--kv-block-size", "16", "--allow-init",
            "--run-root", os.path.join(root, name), *extra,
            f"workdir={no_checkpoint_dir()}", "train.dtype=bfloat16",
            "train.seed=0"])
    finally:
        fleet.Router = cli_router
    torch.cuda.synchronize()
    wall = time.perf_counter() - built["t0"]
    if rc != 0:
        raise AssertionError(f"{label}: fleet up rc {rc}\n{out[-3000:]}")
    router, engines, counts = (built["router"], built["engines"],
                               built["counts"])
    pre, dec = engines["prefill-0"], engines["decode-0"]
    fwd = attn.flash_attention_forward
    stats = router.stats()
    rids = [rid for rid, *_ in reqs]
    lines = result_lines(out)
    bad = {r: lines.get(r, {}).get("state") for r in rids
           if lines.get(r, {}).get("state") != "done"}
    same = sum(lines.get(r, {}).get("tokens")
               == [int(t) for t in strip_special(want[r])] for r in rids)
    work = {n: (e.encoder_forwards - built["before"][n][0],
                e.decoder_steps - built["before"][n][1])
            for n, e in engines.items()}
    expect = {n: NMT_LAYERS * enc + 2 * NMT_LAYERS * steps
              for n, (enc, steps) in work.items()}
    nbytes = [router._requests[r].handoff_bytes for r in rids]
    hop_ms = [t * 1e3 for t in router.handoff_latencies]
    pre_snap, dec_snap = pre.metrics.snapshot(), dec.metrics.snapshot()
    row = dict(
        requests=len(rids), wall_s=wall, handoffs=stats["handoffs"],
        dropped=stats["dropped_requests"], token_identical=f"{same}/"
        f"{len(rids)}", launches=fwd.launches,
        variant_launches=dict(fwd.variant_launches), replicas=counts,
        encoder_forwards={n: w[0] for n, w in work.items()},
        decoder_steps={n: w[1] for n, w in work.items()},
        handoff_bytes_p50=pctl(nbytes, 50), handoff_bytes_max=max(nbytes),
        handoff_bytes_total=stats["handoff_bytes"],
        hop_host_ms_p50=pctl(hop_ms, 50), hop_host_ms_max=max(hop_ms),
        ttft_p50_s=pre_snap["serve_ttft_p50_s"],
        decode_step_p50_ms=dec_snap["serve_step_latency_p50_s"] * 1e3,
        colocated_decode_step_p50_ms=colocated["decode_step_p50_ms"],
        colocated_ttft_p50_s=colocated["ttft_p50_s"])
    log(f"  {label} (cli fleet up --prefill 1 --decode 1): {len(rids)} "
        f"requests in {wall:.3f} s, {row['handoffs']} handoffs, dropped "
        f"{row['dropped']}, printed tokens identical to the co-located "
        f"engine {row['token_identical']}; encodes "
        f"{row['encoder_forwards']}, decoder steps {row['decoder_steps']}; "
        f"flash launches by replica {counts} (tally {expect})")
    log(f"  handoff bytes per request p50 {row['handoff_bytes_p50']:.0f}, "
        f"max {row['handoff_bytes_max']}; hop host time (export, save, "
        f"load, import, release) p50 {row['hop_host_ms_p50']:.3f} ms, max "
        f"{row['hop_host_ms_max']:.3f} ms; TTFT p50 "
        f"{row['ttft_p50_s'] * 1e3:.2f} ms (co-located "
        f"{colocated['ttft_p50_s'] * 1e3:.2f}); decode replica's "
        f"decode-step p50 {row['decode_step_p50_ms']:.3f} ms (co-located "
        f"{colocated['decode_step_p50_ms']:.3f}) [{card_line()}]")
    if bad or row["dropped"] or row["handoffs"] != len(rids):
        raise AssertionError(f"{label}: not done {bad}, dropped "
                             f"{row['dropped']}, handoffs {row['handoffs']}")
    if same != len(rids):
        raise AssertionError(f"{label}: {same}/{len(rids)} requests "
                             f"token-identical to the co-located engine")
    dec_count = counts["decode-0"]
    if work["decode-0"][0] or dec_count["tc"]:
        raise AssertionError(f"{label}: the decode replica ran the encoder "
                             f"({work['decode-0'][0]} encodes, "
                             f"{dec_count['tc']} encoder-shaped launches)")
    for rep, tally in counts.items():
        if tally["launches"] <= 0 or tally["launches"] != expect[rep] \
                or tally["simt"]:
            raise AssertionError(f"{label}: {rep} launches {tally} != "
                                 f"tally {expect[rep]}")
    if sum(t["launches"] for t in counts.values()) != fwd.launches:
        raise AssertionError(f"{label}: launches outside the replicas' "
                             f"steps: {fwd.launches}")
    return row, engines


def cross_precision_refused(bf16_prefill, int8_decode, src):
    """27b: a bf16 exporter's artifact into an int8 importer is refused with
    ValueError before any state commits."""
    req = bf16_prefill.submit(src, max_new_tokens=8)
    bf16_prefill.run_until_drained()
    art = bf16_prefill.export_handoff(req.id)
    alloc = int8_decode.allocator
    state = (alloc.blocks_in_use, alloc.committed_blocks,
             int8_decode.active_rows, len(int8_decode._groups))
    try:
        int8_decode.import_handoff(art, request_id=req.id + "#a1")
    except ValueError as e:
        message = str(e)
    else:
        raise AssertionError("a bf16 artifact was imported into an int8 "
                             "pool")
    after = (alloc.blocks_in_use, alloc.committed_blocks,
             int8_decode.active_rows, len(int8_decode._groups))
    bf16_prefill.release_handoff(req.id)
    log(f"  bf16 artifact into the int8 decode replica: ValueError "
        f"({message}); importer state {after} (before {state})")
    if after != state:
        raise AssertionError("the refused import committed state")
    return message


def single_engine_tokens(cfg, reqs, step):
    """The tokens of one engine built as `fleet route` builds a replica
    (8 slots, dense KV, window 4), at checkpoint ``step``."""
    from deeplearning_cfn_tpu_torch.models.decoding import strip_special
    from deeplearning_cfn_tpu_torch.serve.loader import load_engine

    engine, _, at = load_engine(cfg, capacity=SLOTS, decode_window=4,
                                default_max_new_tokens=32, step=step,
                                device="gpu")
    assert at == step
    submit_all(reqs)(engine)
    return {rid: [int(t) for t in strip_special(engine.poll(rid).tokens)]
            for rid, *_ in reqs}


def fleet_route_rollout(torch, attn, root, workdir):
    """27c: `cli fleet route` and `cli fleet rollout` (two replicas, 8 slots
    each) on phase 26's chaos run, whose checkpoints are committed at steps
    4 and 8. The replicas load the latest; the rollout swaps both to the
    other in mid-stream. Every request done, none dropped; the routed
    tokens equal one engine at the latest step, and those of the requests
    submitted after the rollout one engine at the new step."""
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.convert import committed_steps
    from deeplearning_cfn_tpu_torch.presets import get_preset
    from deeplearning_cfn_tpu_torch.serve.loader import checkpoint_dir

    overrides = CHAOS_OVERRIDES + [f"workdir={workdir}"]
    cfg = apply_overrides(get_preset("transformer_nmt_wmt"), overrides)
    steps = committed_steps(checkpoint_dir(cfg))
    if len(steps) < 2:
        raise AssertionError(f"phase 26 committed {steps}, not two steps")
    latest, to_step = steps[-1], steps[0]
    reqs = make_requests(FLEET_RUN_REQUESTS, n_beam=2, seed=3)
    path = os.path.join(root, "fleet_requests.jsonl")
    write_requests(path, reqs)
    base = ["--preset", "transformer_nmt_wmt", "--accelerator", "gpu",
            "--requests", path, "--replicas", "2", "--slots", str(SLOTS),
            "--max-new-tokens", "32"]
    out = {}
    for verb, extra in (("route", []), ("rollout",
                                        ["--to-step", str(to_step)])):
        set_counts(attn, 0)
        t = time.perf_counter()
        rc, stdout = cli_inprocess(["fleet", verb, *base, *extra,
                                    *overrides])
        lines = result_lines(stdout)
        fwd = attn.flash_attention_forward
        out[verb] = dict(rc=rc, wall_s=time.perf_counter() - t,
                         launches=fwd.launches,
                         variant_launches=dict(fwd.variant_launches),
                         done=sum(ln["state"] == "done"
                                  for ln in lines.values()))
        if rc != 0 or out[verb]["done"] != len(reqs) \
                or fwd.launches <= 0 or fwd.variant_launches["simt"]:
            raise AssertionError(f"fleet {verb}: rc {rc}, {out[verb]}")
        out[verb]["tokens"] = {r: lines[r]["tokens"] for r in lines}
    half = len(reqs) // 2
    want_latest = single_engine_tokens(cfg, reqs, latest)
    want_new = single_engine_tokens(cfg, reqs[half:], to_step)
    routed = sum(out["route"]["tokens"][r] == want_latest[r]
                 for r, *_ in reqs)
    after = sum(out["rollout"]["tokens"][r] == want_new[r]
                for r, *_ in reqs[half:])
    for verb in ("route", "rollout"):
        del out[verb]["tokens"]
    out.update(from_step=latest, to_step=to_step,
               route_token_identical=f"{routed}/{len(reqs)}",
               after_swap_token_identical=f"{after}/{len(reqs) - half}")
    log(f"  fleet route: rc 0, {len(reqs)} done in "
        f"{out['route']['wall_s']:.1f} s, {routed}/{len(reqs)} "
        f"token-identical to one engine at step {latest}; flash launches "
        f"{out['route']['variant_launches']}")
    log(f"  fleet rollout {latest} -> {to_step}: rc 0, {len(reqs)} done in "
        f"{out['rollout']['wall_s']:.1f} s, the {len(reqs) - half} "
        f"requests after the swap {after}/{len(reqs) - half} "
        f"token-identical to one engine at step {to_step}; flash launches "
        f"{out['rollout']['variant_launches']}")
    if routed != len(reqs) or after != len(reqs) - half:
        raise AssertionError("fleet route/rollout tokens differ")
    return out


def child_launches(run_dir, marker):
    """``{log file: {"launches", "variants", "encodes", "steps"}}`` from
    each attempt log's line with ``marker``: the child's own launches after
    its warm-up, and the encoder forwards and decoder steps they served (a
    killed attempt has no such line)."""
    import glob
    import re

    found = {}
    for path in sorted(glob.glob(os.path.join(run_dir, "logs",
                                              "attempt*-host0.log"))):
        with open(path, errors="replace") as fh:
            for line in fh:
                m = re.search(marker + r" (\d+) (\{.*\}) over (\d+) encoder "
                              r"forwards and (\d+) decoder steps", line)
                if m:
                    found[os.path.basename(path)] = dict(
                        launches=int(m.group(1)),
                        variants=json.loads(m.group(2).replace("'", '"')),
                        encodes=int(m.group(3)), steps=int(m.group(4)))
    return found


def tally(layers, child):
    """The forward launches a child's encodes and decoder steps make."""
    return layers * child["encodes"] + 2 * layers * child["steps"]


def fleet_up_colocated(root, accelerator="gpu", overrides=()):
    """27d: `cli fleet up` with two supervised `cli serve` children on the
    card, each serving its shard of the trace (seeded init, phase 5's
    model); both end ok, each child's log holds its result lines and its
    kernel launches after its warm-up, equal to its own tally; `fleet
    status` and `obs summarize --fleet` read the run root."""
    run_root = os.path.join(root, "fleet_up")
    reqs = make_requests(8, n_beam=2, seed=4)
    path = os.path.join(root, "fleet_up_requests.jsonl")
    write_requests(path, reqs)
    t = time.perf_counter()
    rc, out = cli_inprocess([
        "fleet", "up", "--preset", "transformer_nmt_wmt", "--accelerator",
        accelerator, "--requests", path, "--replicas", "2", "--slots",
        str(SLOTS), "--max-new-tokens", "32", "--allow-init", "--run-root",
        run_root, "--timeout", "300", f"workdir={no_checkpoint_dir()}",
        "train.dtype=bfloat16", "train.seed=0", *overrides])
    wall = time.perf_counter() - t
    if rc != 0:
        raise AssertionError(f"fleet up: rc {rc}\n{out[-3000:]}")
    children = {}
    for i in range(2):
        run_dir = os.path.join(run_root, f"replica-{i}")
        counts = child_launches(run_dir, r"flash kernel launches")
        with open(os.path.join(run_dir, "logs", "attempt0-host0.log"),
                  errors="replace") as fh:
            done = sum('"state": "done"' in ln for ln in fh)
        children[f"replica-{i}"] = dict(launches=counts, done=done)
        if len(counts) != 1 or not all(
                0 < c["launches"] == tally(NMT_LAYERS, c)
                for c in counts.values()):
            raise AssertionError(f"replica-{i}: launches in its log "
                                 f"{counts}, not its tally")
    if sum(c["done"] for c in children.values()) != len(reqs):
        raise AssertionError(f"fleet up: results {children}")
    verbs = {}
    for name, argv in (("status", ["fleet", "status", run_root]),
                       ("summarize", ["obs", "summarize", "--fleet",
                                      run_root])):
        vrc, verbs[name] = cli_inprocess(argv)
        if vrc != 0 or "fleet 2 replica(s)" not in verbs[name]:
            raise AssertionError(f"{name}: rc {vrc}\n{verbs[name]}")
    log(f"  fleet up: rc 0 in {wall:.1f} s, both replicas ok; results done "
        f"by child {[c['done'] for c in children.values()]}; flash launches "
        f"in each child after its warm-up (its own log, each equal to its "
        f"tally) {[c['launches'] for c in children.values()]}")
    log("  " + verbs["status"].strip().splitlines()[0])
    return dict(wall_s=wall, children=children,
                status=verbs["status"].strip().splitlines()[0])


def net_requests(vocab, n):
    import numpy as np

    rng = np.random.RandomState(6)
    out = []
    for i in range(n):
        length = int(rng.randint(8, 17))
        src = [int(t) for t in rng.randint(3, vocab, size=length - 1)] + [2]
        out.append((f"n{i}", src, NET_BUDGET, 1))
    return out


def kill_in_flight(sock, deadline_s=120.0):
    """SIGKILL the server behind ``sock`` once it has a request in flight
    (its pid from its own health frame); returns what was seen."""
    import signal

    from deeplearning_cfn_tpu_torch.net.client import RemoteReplica

    probe = RemoteReplica("probe", "unix://" + sock,
                          connect_retry_deadline_s=240.0).connect()
    try:
        deadline = time.time() + deadline_s
        while time.time() < deadline:
            health = probe.health()
            if health["active_requests"] > 0:
                os.kill(health["pid"], signal.SIGKILL)
                return dict(pid=health["pid"],
                            active=health["active_requests"],
                            queued=health["queue_depth"],
                            steps=health["steps"])
            time.sleep(0.002)
    finally:
        probe.close()
    raise AssertionError(f"{sock}: never seen with a request in flight")


def fleet_up_net(root, accelerator="gpu", n_requests=NET_REQUESTS,
                 slots=NET_SLOTS, budget=NET_BUDGET):
    """27e: `cli fleet up --net` in a child process: two `net.server`
    children behind unix sockets, serving the seeded tiny recipe. Both are
    SIGKILLed in mid-stream, replica-1 and then replica-0, each with
    requests in flight, so that every request left is served by a child
    the supervisor restarted. Each child's first attempt is a crash; its
    second says ready, serves, and exits rc 0 after the drain with its
    launches (after its warm-up) equal to its own tally; the restarted
    children together served requests and, on the card, launched the
    kernel. Nothing drops, and the tokens equal an in-process engine of the
    same recipe on the same device."""
    from deeplearning_cfn_tpu_torch.models.decoding import strip_special
    from deeplearning_cfn_tpu_torch.net.server import (TINY_VOCAB,
                                                       tiny_recipe_engine)
    from deeplearning_cfn_tpu_torch.serve.queue import OverloadError

    run_root = os.path.join(root, "fleet_net")
    reqs = [(rid, src, budget, beam)
            for rid, src, _, beam in net_requests(TINY_VOCAB, n_requests)]
    path = os.path.join(root, "fleet_net_requests.jsonl")
    write_requests(path, reqs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    t = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning_cfn_tpu_torch.cli", "fleet",
         "up", "--net", "--preset", "transformer_nmt_wmt", "--accelerator",
         accelerator, "--requests", path, "--replicas", "2", "--slots",
         str(slots), "--max-new-tokens", str(budget), "--run-root",
         run_root, "--max-restarts", "1"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    killed = {}
    try:
        for i in (1, 0):
            killed[f"replica-{i}"] = kill_in_flight(os.path.join(
                run_root, f"replica-{i}", "replica.sock"))
            killed[f"replica-{i}"]["after_s"] = time.perf_counter() - t
        stdout, stderr = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"fleet up --net: rc {proc.returncode}\n"
                             f"{stderr[-3000:]}")
    lines = result_lines(stdout)
    with IN_PROCESS:
        ref = tiny_recipe_engine(
            slots=slots, src_len=max(len(r[1]) for r in reqs),
            max_new_tokens=budget, decode_window=4, device=accelerator)
        for rid, src, budget_, _ in reqs:
            while True:
                try:
                    ref.submit(src, max_new_tokens=budget_, request_id=rid)
                    break
                except OverloadError:
                    ref.step()
        ref.run_until_drained()
        want = {rid: [int(t) for t in strip_special(ref.poll(rid).tokens)]
                for rid, *_ in reqs}
    done = sum(lines.get(r, {}).get("state") == "done" for r, *_ in reqs)
    same = sum(lines.get(r, {}).get("tokens") == want[r] for r, *_ in reqs)
    layers = ref.model.num_layers
    dropped = [ln for ln in stderr.splitlines() if "dropped_requests=" in ln]
    replicas, problems = {}, []
    for i in range(2):
        rep = f"replica-{i}"
        run_dir = os.path.join(run_root, rep)
        attempts = read_jsonl(os.path.join(run_dir, "logs",
                                           "launch.jsonl"))
        outcomes = [a["outcome"] for a in attempts
                    if a.get("event") == "launch_attempt"]
        logs = {}
        for n in range(2):
            log_path = os.path.join(run_dir, "logs",
                                    f"attempt{n}-host0.log")
            if os.path.exists(log_path):
                with open(log_path, errors="replace") as fh:
                    logs[n] = fh.read()
        counts = child_launches(run_dir, r"flash kernel launches")
        restarted = counts.get("attempt1-host0.log")
        replicas[rep] = dict(outcomes=outcomes, restarted=restarted)
        if not outcomes or outcomes[0] != "crash":
            problems.append(f"{rep}: attempts {outcomes}")
        if "attempt0-host0.log" in counts:
            problems.append(f"{rep}: the killed attempt exited by itself")
        if f"[net.server] {rep} ready" not in logs.get(1, ""):
            problems.append(f"{rep}: no restarted child reached ready")
        if restarted is None or f"{rep} exiting rc 0" not in logs.get(1, ""):
            problems.append(f"{rep}: the restarted child did not exit "
                            f"cleanly: {restarted}")
        elif accelerator == "gpu" and \
                restarted["launches"] != tally(layers, restarted):
            problems.append(f"{rep}: restarted launches {restarted} != "
                            f"tally {tally(layers, restarted)}")
    served = [r["restarted"] for r in replicas.values() if r["restarted"]]
    steps = sum(c["steps"] for c in served)
    launched = sum(c["launches"] for c in served)
    log(f"  fleet up --net: rc 0 in {wall:.1f} s; SIGKILLed "
        + ", ".join(f"{rep} (pid {k['pid']}) {k['after_s']:.1f} s in with "
                    f"{k['active']} running and {k['queued']} queued"
                    for rep, k in killed.items())
        + f"; {dropped[-1].strip() if dropped else ''}; {done}/{len(reqs)} "
        f"done, {same}/{len(reqs)} token-identical to the in-process "
        f"engine; attempts and the restarted children's exit lines "
        f"(launches after warm-up, encodes, decoder steps) {replicas}")
    if done != len(reqs) or same != len(reqs):
        problems.append("fleet up --net results differ")
    if steps <= 0 or (accelerator == "gpu" and launched <= 0):
        problems.append(f"the restarted children served nothing: {served}")
    if problems:
        raise AssertionError("; ".join(problems))
    return dict(wall_s=wall, killed=killed, replicas=replicas,
                done=f"{done}/{len(reqs)}",
                token_identical=f"{same}/{len(reqs)}")


def fleet_phase(torch, attn, root, served, int8, reqs):
    """Phase 27: 27a-27d in this process, beside 27e, whose fleet is a
    process of its own (``at_once``); 27e's in-process reference engine
    waits for 27a-27d, whose launch counts are this process's."""
    def in_process():
        with IN_PROCESS:
            return fleet_in_process(torch, attn, root, served, int8, reqs)

    runs = at_once([("27a-27d", in_process),
                    ("27e", lambda: fleet_up_net(root))])
    return dict(runs["27a-27d"], fleet_up_net=runs["27e"])


def fleet_in_process(torch, attn, root, served, int8, reqs):
    """27a-27d."""
    out = {}
    t = time.perf_counter()
    out["disagg"], bf16 = disagg_pair(
        torch, attn, root, "27a bf16 pair", reqs,
        served["tokens_by_request"], served)
    log(f"  27a {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    out["disagg_int8"], q8 = disagg_pair(
        torch, attn, root, "27b int8 pair", reqs, int8["tokens_by_request"],
        int8, extra=["--quantize", "int8", "--kv-quant", "int8"])
    out["disagg_int8"]["cross_precision"] = cross_precision_refused(
        bf16["prefill-0"], q8["decode-0"], reqs[0][1])
    del bf16, q8
    torch.cuda.empty_cache()
    log(f"  27b {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    out["route_rollout"] = fleet_route_rollout(
        torch, attn, root, os.path.join(root, "chaos", "chaos"))
    torch.cuda.empty_cache()
    log(f"  27c {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    out["fleet_up"] = fleet_up_colocated(root)
    log(f"  27d {time.perf_counter() - t:.1f} s")
    return out


# Phase 28: data-parallel training across processes (ROADMAP A.10 part
# 1). Two processes share the one card over gloo (NCCL takes one rank per
# card), so every collective is staged through the host: the times here are
# not a data-parallel speed. Each process's kernel launches are its own: it
# prints them, and the phase reads them from its log.
DP_RANKS, DP_STEPS = 2, 6
DP_OVERRIDES = [
    "train.dtype=bfloat16", "train.seed=0",
    f"train.global_batch={TRAIN_BATCH}", "schedule.warmup_steps=10",
    "schedule.base_lr=1e-3", "model.kwargs.dropout_rate=0.0",
    "data.num_eval_examples=128", "eval.enabled=false",
    "train.log_every_steps=1", "train.eval_every_steps=1000000",
    "checkpoint.every_steps=1000000"]
# 28b's bound on |2-process loss - 1-process loss| / loss, per step, set
# from two readings of this cell on the card (NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md, phase 28): the sound two-process run parts from one
# process by 2.195e-6 (bf16 sums in another order), and the control, the
# same two processes with their gradients never summed (``grad_sum`` =
# ``"discard"``), by 7.913e-4. The bound sits between the two; 28b
# fails when the control does not exceed it, or when the losses move by less
# than DP_MOVE_FACTOR bounds over the steps (an update that never applies
# must show). On the CPU the tiny f32 NMT parts by 1.146e-7
# (tests/test_torch_dist_cli.py holds it to 1e-6).
DP_LOSS_REL_BOUND, DP_MOVE_FACTOR = 1e-4, 10
# 28c: the tiny f32 ResNet-20, 2 processes against 1 on the same global
# batch, deterministic algorithms: the BatchNorm sums and the gradients
# only change order. 1e-5 relative on the losses and the running
# statistics (f32 has 2^-24 ≈ 6e-8; 20 layers of reordered sums over 4
# steps stay below 1e-6 on the CPU).
DP_RESNET20 = ["train.dtype=float32", "train.global_batch=32",
               "data.num_train_examples=256", "data.num_eval_examples=32",
               "data.prefetch=0", "schedule.name=constant",
               "schedule.base_lr=0.1", "schedule.warmup_epochs=0",
               "train.seed=0"]
DP_RESNET20_STEPS, DP_F32_BOUND = 4, 1e-5
# 28d: the tiny BERT under LAMB with ZeRO-1, killed and resumed.
DP_BERT = ["model.name=bert_tiny", "model.kwargs.hidden_size=32",
           "model.kwargs.num_layers=2", "model.kwargs.num_heads=2",
           "model.kwargs.mlp_dim=64", "model.kwargs.max_len=32",
           "data.vocab_size=64", "data.seq_len=16", "train.global_batch=8",
           "data.num_train_examples=64", "data.num_eval_examples=16",
           "train.dtype=float32", "schedule.warmup_steps=2",
           "model.kwargs.dropout_rate=0.0", "checkpoint.async_write=false",
           "train.shard_opt_state=true"]
DP_CHAOS = dict(total_steps=6, kill_at_step=4, ckpt_every=2, max_restarts=2)
# 28e: ResNet-50 at full width on 2 processes.
DP_RESNET50_STEPS = 3
DP_RESNET50 = ["train.dtype=bfloat16", "train.global_batch=64",
               "data.num_train_examples=256", "data.num_eval_examples=64",
               "train.eval_batch=64", "train.log_every_steps=1",
               "train.eval_every_steps=1000000",
               "checkpoint.every_steps=1000000",
               "schedule.warmup_steps=1", "train.seed=0"]
DP_RESNET50_CUTS = ["train.global_batch=64, 32 per process (preset 8192; "
                    "two processes share one card's memory and time)",
                    "data.num_train_examples=256 (preset 8192: 4.9 GB of "
                    "f32 per process on the host)",
                    f"{DP_RESNET50_STEPS} steps, warmup 1"]


# Phase 29: the long presets on one process (seq = 1) at full width, bf16.
# Their 12 self-attentions carry no bias: per microbatch the forward, dK/dV
# and dQ kernels 12 times each (tc), the reference VJP never; per eval batch
# 12 forwards; per generated position of gpt_long's recompute mode 12
# forwards over the whole buffer (Sq >= 16, so tc, never decode).
LONG_LAYERS, LONG_HEADS, LONG_STEPS = 12, 12, 4
LONG_BERT_SEQ, LONG_BERT_BATCH, LONG_BERT_VOCAB = 4096, 8, 30522
LONG_BERT_PRED = int(LONG_BERT_SEQ * 0.2)  # data/text.py MAX_PRED_FRACTION
LONG_GPT_SEQ, LONG_GPT_BATCH, LONG_GPT_ACCUM = 16384, 2, 2
LONG_GPT_VOCAB, LONG_GPT_PROMPT, LONG_GPT_NEW = 32768, 16, 8
LONG_PER_MICRO = {"fwd": 12, "dkdv": 12, "dq": 12, "vjp": 0}
# The kernels' timing rows at the main path's shapes, and the cut shapes at
# which each is held against its plain version (the plain versions
# materialise S x S in f32: 12 heads at 16384 keys would be 12.9 GB per
# matrix).
LONG_BERT_SHAPE = (LONG_BERT_BATCH, LONG_HEADS, LONG_BERT_SEQ, LONG_BERT_SEQ,
                   HEAD_DIM)
LONG_GPT_SHAPE = (1, LONG_HEADS, LONG_GPT_SEQ, LONG_GPT_SEQ, HEAD_DIM)
LONG_BERT_CHECK = (1, LONG_HEADS, LONG_BERT_SEQ, LONG_BERT_SEQ, HEAD_DIM)
LONG_GPT_CHECK = (1, 2, LONG_GPT_SEQ, LONG_GPT_SEQ, HEAD_DIM)
LONG_COMMON = ["train.seed=0", "train.log_every_steps=1",
               f"train.steps={LONG_STEPS}", "schedule.warmup_steps=2",
               "train.eval_every_steps=1000000",
               "checkpoint.every_steps=1000000"]
LONG_BERT = [f"train.global_batch={LONG_BERT_BATCH}",
             "data.num_train_examples=32", "data.num_eval_examples=8",
             f"train.eval_batch={LONG_BERT_BATCH}"]
LONG_GPT = [f"train.global_batch={LONG_GPT_BATCH}",
            "data.num_train_examples=8", "data.num_eval_examples=2",
            f"train.eval_batch={LONG_GPT_BATCH}"]
LONG_CUTS = {
    "bert_long_wikipedia": [
        "train.global_batch=8 (preset 256; the JAX bench's one-chip cut)",
        "seq = 1: one process, so mesh.seq=4 is ignored and the trunk runs "
        "the flash kernels on whole rows",
        f"train.steps={LONG_STEPS} (1 warm-up step, 3 timed)",
        "schedule.warmup_steps=2 (preset 3000)",
        "data.num_train_examples=32, eval on 8 sequences once at the end",
        "train.shard_opt_state ignored (one device)"],
    "gpt_long_lm": [
        "train.global_batch=2 as the preset's grad_accum_steps=2, so one "
        "sequence of 16384 per microbatch (preset 64)",
        "seq = 1: one process, so mesh.seq=8 is ignored and the trunk runs "
        "the flash kernels on whole rows",
        f"train.steps={LONG_STEPS} (1 warm-up step, 3 timed)",
        "schedule.warmup_steps=2 (preset 2000)",
        "data.num_train_examples=8, eval on 2 sequences once at the end",
        "train.shard_opt_state ignored (one device)"],
}
# The tiny f32 long trunks, card against CPU (head dim 16: the kernels take
# 16..128).
LONG_TINY = ["model.kwargs.hidden_size=64", "model.kwargs.num_layers=2",
             "model.kwargs.num_heads=4", "model.kwargs.mlp_dim=128",
             "model.kwargs.max_len=64", "data.vocab_size=512",
             "data.seq_len=64", "train.dtype=float32",
             "data.num_train_examples=16"]
# Phase 30: the seq axis across 2 processes that share the card over gloo
# (phase 28a's dry-run stack): bert_long with ring attention and gpt_long
# with Ulysses, full width cut to 2 layers, at 4096, bf16, mesh (data=1,
# seq=2): both processes take the same rows, each its half of every row.
SEQ_STEPS = 3
SEQ_COMMON = ["model.kwargs.num_layers=2", "train.seed=0",
              "train.log_every_steps=1", "schedule.warmup_steps=1",
              "train.eval_every_steps=1000000",
              "checkpoint.every_steps=1000000", "mesh.seq=2"]
SEQ_JOBS = {
    "ring": ("bert_long_wikipedia", SEQ_COMMON + [
        "model.kwargs.seq_impl=ring", "train.global_batch=4",
        "data.num_train_examples=16", "data.num_eval_examples=4",
        "train.eval_batch=4", "schedule.base_lr=1e-3"]),
    "ulysses": ("gpt_long_lm", SEQ_COMMON + [
        "model.kwargs.seq_impl=ulysses", "model.kwargs.max_len=4096",
        "data.seq_len=4096", "train.global_batch=2",
        "data.num_train_examples=8", "data.num_eval_examples=2",
        "train.eval_batch=2", "schedule.base_lr=1e-3"]),
}
# Launches per step of each process: the ring computes its blocks with
# plain products (no kernel); Ulysses runs the three kernels once per layer
# per microbatch (2 layers, grad_accum_steps=2).
SEQ_PER_STEP = {"ring": {"fwd": 0, "dkdv": 0, "dq": 0},
                "ulysses": {"fwd": 4, "dkdv": 4, "dq": 4}}
SEQ_CUTS = ["12 layers cut to 2 (full width: hidden 768, 12 heads, MLP "
            "3072, the presets' vocabularies)",
            "bert_long: batch 4, sequence 4096 (preset 256 x 4096, seq=4); "
            "gpt_long: batch 2 as 2 microbatches of 1, sequence 4096 "
            "(preset 64 x 16384, seq=8): two processes share one card",
            f"{SEQ_STEPS} steps, warmup 1"]
# 30's bound on |2-process loss - 1-process loss| / loss, per step, for
# each job, set between two readings of this cell on the card (NVIDIA H100
# 80GB HBM3, 700.00 W; PERF.md, phase 30): the sound run and the control, the
# same two processes with their gradients never summed. The ring parts from
# one process by 2.745e-4 (its f32 block products against the flash
# kernels, bf16 rounding in other places), its control by 9.497e-2; Ulysses
# (the same kernels on head groups) by 2.439e-6, its control by 1.226e-3.
# The job fails when the control does not exceed its bound, or when the
# stack's losses move by less than SEQ_MOVE_FACTOR bounds from the first
# (largest change over the steps).
SEQ_LOSS_REL_BOUND = {"ring": 3e-3, "ulysses": 1e-4}
SEQ_MOVE_FACTOR = 10
# Phase 31: the pipe and expert axes across 4 processes that share the card
# over gloo (a four-host dry-run stack), at full width: the pipelined BERT
# on (data=1, pipe=4), three layers per process under the GPipe schedule
# with the preset's 8 microbatches, and BERT-MoE on (data=1, expert=4), two
# of the 8 experts per process (dropout 0: each process would draw its own
# masks). Both read the same global batches as one process would.
PE_RANKS, PE_STEPS = 4, 3
PE_COMMON = ["train.seed=0", "train.log_every_steps=1",
             "schedule.warmup_steps=0", "schedule.base_lr=1e-3",
             "train.global_batch=64", "data.num_train_examples=256",
             "data.num_eval_examples=64", "train.eval_batch=64",
             "train.eval_every_steps=1000000",
             "checkpoint.every_steps=1000000", "mesh.data=1"]
PE_JOBS = {
    "pipe": ("bert_pipelined_wikipedia", PE_COMMON + ["mesh.pipe=4"]),
    "expert": ("bert_moe_wikipedia", PE_COMMON + [
        "mesh.expert=4", "model.kwargs.dropout_rate=0.0"]),
}
# Launches per step of each process: the forward kernel once per layer it
# holds and microbatch it runs (the biased backward takes the reference
# VJP, as in phases 13, 22 and 23).
PE_PER_STEP = {"pipe": {"fwd": 24, "dkdv": 0, "dq": 0},
               "expert": {"fwd": 12, "dkdv": 0, "dq": 0}}
PE_CUTS = ["global batch 64 (preset 1024): four processes share one card",
           "bert_moe_wikipedia on expert=4 (preset 8; two experts per "
           "process), dropout 0 (preset 0.1)",
           f"{PE_STEPS} steps, no warmup, the final eval on 64 examples"]
# 31's bound on |4-process loss - 1-process loss| / loss, per step, for
# each job, set between two readings of this cell on the card (NVIDIA H100
# 80GB HBM3, 700.00 W; PERF.md, phase 31): the sound run and the control,
# the same four processes with their gradients never summed. The pipelined
# trunk parts from one process by 6.686e-5 (bf16 GEMMs over 8-row
# microbatches against the whole batch's), its control by 5.497e-4 (LAMB
# normalises the heads' quartered gradients, so the control sits close);
# BERT-MoE by 3.292e-5, its control by 8.743e-3 (each process's update
# from its quarter of the batch). The job fails when the control does not
# exceed its bound, or when the stack's losses move by less than
# PE_MOVE_FACTOR bounds from the first (largest change over the steps).
PE_LOSS_REL_BOUND = {"pipe": 2e-4, "expert": 3e-4}
PE_MOVE_FACTOR = 10
# Phase 32: the model and spatial axes across 2 processes that share the
# card over gloo (phase 28a's dry-run stack): gpt_small_lm at full width on
# (data=1, model=2), each process with 6 of the 12 heads and half of each
# MLP, and maskrcnn_coco on its published mesh (data=-1, spatial=2 over 2
# processes: data=1), each process on its 512 rows of every image. Both
# read the same global batches as one process would.
TS_RANKS = 2
TS_STEPS = {"model": 4, "spatial": 3}
TS_COMMON = ["train.seed=0", "train.log_every_steps=1",
             "schedule.warmup_steps=1", "train.eval_every_steps=1000000",
             "checkpoint.every_steps=1000000"]
TS_JOBS = {
    "model": ("gpt_small_lm", TS_COMMON + [
        f"train.global_batch={GPT_BATCH}", "schedule.base_lr=3e-3",
        "model.kwargs.dropout_rate=0.0", "data.num_eval_examples=16",
        "train.eval_batch=16", "mesh.model=2"]),
    "spatial": ("maskrcnn_coco", TS_COMMON + [
        f"train.global_batch={MRCNN_BATCH}", f"schedule.base_lr={MRCNN_LR}",
        "data.num_train_examples=24", "data.num_eval_examples=8",
        "train.eval_batch=8", "eval.detect_topk=100"]),
}
# Launches per step of each process: GPT's 12 causal self-attentions, each
# on its 6 heads (the forward, dK/dV and dQ kernels once per layer); Mask
# R-CNN launches no kernel of ours.
TS_PER_STEP = {"model": {"fwd": 12, "dkdv": 12, "dq": 12},
               "spatial": {"fwd": 0, "dkdv": 0, "dq": 0}}
TS_SHAPE = (GPT_BATCH, GPT_HEADS // 2, GPT_SEQ, GPT_SEQ, HEAD_DIM)
TS_CUTS = ["gpt_small_lm: batch 16 x 1024 (preset 512), 4 steps, warmup 1, "
           "dropout 0 (preset 0.1; the sound run and one process must draw "
           "the same masks), mesh.model=2 (no preset sets it), the final "
           "eval on 16 sequences",
           "maskrcnn_coco: batch 8 (preset 64) at 1024², 3 steps, warmup "
           "1, 24 training and 8 eval images",
           "two processes share one card over gloo"]
# 32's bound on |2-process loss - 1-process loss| / loss, per step, for
# each job, set between two readings of this cell on the card (NVIDIA H100
# 80GB HBM3, 700.00 W; PERF.md, phase 32): the sound run and the control,
# the same two processes with their gradients never summed. GPT on the
# model axis parts from one process by 1.105e-5 (bf16 products over half
# the heads and hidden units, summed in bf16), its control by 7.365e-4
# (AdamW's first steps move by the gradient's sign, which the partial
# gradients of the replicated leaves mostly keep); Mask R-CNN on the
# spatial axis by 1.666e-3 to 5.336e-3 over five calls (3.365e-4 already
# at the first step, before any update: bf16 convolutions over 512-row
# halves round apart from whole images', and the proposals' top-k
# follows; the third step's loss wanders between calls, on both sides,
# with the atomics of ROI-align's backward), its control by 1.344e-1 to
# 1.414e-1. The job fails when the control does not exceed its bound, or
# when the stack's losses move by less than the job's TS_MOVE_FACTOR
# bounds from the first (largest change over the steps; Mask R-CNN's
# three steps moved 2.188e-1 to 2.214e-1).
TS_LOSS_REL_BOUND = {"model": 5e-5, "spatial": 2e-2}
TS_MOVE_FACTOR = {"model": 10, "spatial": 5}
# 32a's Adafactor leg: gpt_small_lm at full width under Adafactor on the
# same mesh, its kernels' moments factored by the whole leaves' shapes and
# each mean over a split dim and each block RMS summed over the model
# group. Two processes (phase 28's workers, fed the same global batches)
# against one process; the control, the same two processes with every sum
# over the peers skipped (each piece's moments' means, rms(p) and rms(u)
# its own): skipping only rms(u)'s changes nothing on these steps, whose
# updates' RMS stays under the clip's 1 (a CPU run of GPT-2's dims at
# sequence 64 gave the sound run's losses to the bit). Batch 8 x 1024
# (32a's is 16) and a rate of 1e-2, Adafactor's scale (its updates are
# relative to each leaf's RMS).
TS_ADAFACTOR_STEPS = 6
TS_ADAFACTOR = [o for o in TS_JOBS["model"][1]
                if not o.startswith(("train.global_batch=",
                                     "schedule.base_lr="))] + [
    "train.global_batch=8", "schedule.base_lr=1e-2",
    "optimizer.name=adafactor"]
# The bound, set between readings of this leg on the card (NVIDIA H100
# 80GB HBM3, 700.00 W; PERF.md, PR 21): the two processes part from one
# process by 1.212e-5 (the first step's bf16 forward over half the heads;
# the later steps by 6.3e-7 to 4.6e-6), the control by 7.626e-5 at 4
# steps and 8.531e-5 at 6 (from the third step on, when the updates
# differ).
TS_ADAFACTOR_REL_BOUND = 4e-5
TS_ADAFACTOR_CUTS = [f"gpt_small_lm: batch 8 x 1024 (preset 512), "
                     f"{TS_ADAFACTOR_STEPS} steps, warmup 1, dropout 0, "
                     f"mesh.model=2",
                     "two processes share one card over gloo"]


def dp_batches(cfg, steps, ranks=DP_RANKS):
    """The global batch of each of the first ``steps`` steps as a job of
    ``ranks`` processes sees it: process 0's pipeline batch, then process
    1's (each the ``build_pipeline`` of its process index)."""
    import numpy as np

    from deeplearning_cfn_tpu_torch.data.pipeline import build_pipeline

    local = cfg.train.global_batch // ranks
    per_rank = []
    for r in range(ranks):
        pipe = build_pipeline(cfg.data, local, cfg.model.num_classes,
                              seed=cfg.train.seed, train=True,
                              process_index=r, process_count=ranks)
        it = pipe.epochs()
        per_rank.append([next(it) for _ in range(steps)])
        it.close()
    return [{k: np.concatenate([b[s][k] for b in per_rank])
             for k in per_rank[0][s]} for s in range(steps)]


def fed_run(torch, cfg, batches, device, init=None, step_s=None,
            total_steps=None, comm_s=None):
    """``run_experiment``'s set-up (seeded init, schedule, optimizer,
    state, trainer) on ``device``, trained on the given global batches;
    across processes each trains its rows. ``init``, named leaves as
    ``TrainState.load_named`` takes them, replaces the seeded state (a
    restored checkpoint's ``step`` included); ``step_s``, a list, gets each
    step's wall seconds; ``total_steps`` sizes the schedule (default: the
    number of batches); ``comm_s``, a list, gets after each step the
    sequence collectives' seconds so far (``collectives.comm_timer``, when
    on). With ``train.step_window`` K > 1 the batches go K at a time
    through ``Trainer.window_step`` (``step_s`` then gets each window's
    seconds). Returns the per-step losses (summed over the processes) and
    the state."""
    from deeplearning_cfn_tpu_torch.data.pipeline import to_device
    from deeplearning_cfn_tpu_torch.parallel import build_mesh, local_shard
    from deeplearning_cfn_tpu_torch.train.optim import build_optimizer, \
        build_schedule
    from deeplearning_cfn_tpu_torch.train.state import create_train_state
    from deeplearning_cfn_tpu_torch.train.task import build_task
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer

    dev = torch.device(device)
    mesh = build_mesh(cfg.mesh)
    task = build_task(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(cfg.train.seed))
    task.init(gen)
    schedule = build_schedule(cfg.schedule, total_steps or len(batches),
                              cfg.train.global_batch)
    state = create_train_state(
        task.model, build_optimizer(cfg.optimizer, schedule, task.model,
                                    cfg.train.shard_opt_state),
        ema=cfg.train.ema_decay > 0)
    if init is not None:
        state.load_named(init)
    trainer = Trainer(cfg, task, dev, mesh)
    losses = []
    window = cfg.train.step_window
    for i in range(0, len(batches), window):
        t0 = time.perf_counter()
        local = [to_device({k: local_shard(v, mesh) for k, v in b.items()},
                           dev) for b in batches[i:i + window]]
        if window == 1:
            steps = [trainer.train_step(state, local[0])]
        else:
            stacked = trainer.window_step(state, local)
            steps = [{n: v[j] for n, v in stacked.items()}
                     for j in range(len(local))]
        losses += [trainer._realize(m)["loss"] for m in steps]
        if step_s is not None:
            step_s.append(time.perf_counter() - t0)
        if comm_s is not None:
            from deeplearning_cfn_tpu_torch.parallel.collectives import \
                comm_timer

            comm_s.append(dict(comm_timer.seconds))
    return losses, state


def bn_stats(torch, model):
    """Every BatchNorm running statistic of ``model``, flattened, on the
    host (f32; empty for a model without BatchNorm)."""
    stats = [b.detach().float().reshape(-1).cpu()
             for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    return torch.cat(stats) if stats else torch.zeros(0)


def dp_worker(spec_path, rank):
    """``chip_smoke.py --dp-worker SPEC RANK``: one process of a phase-28
    or phase-30 job on the card (28b-c, 28e, 30b, 30d). It joins the group
    through ``runtime.cluster.initialize`` (processes that share a card:
    gloo), then either trains the given global batches (``fed``, strict
    deterministic algorithms when asked) or runs ``run_experiment``
    (``run``), and writes its losses, step times, kernel launches and
    BatchNorm statistics to ``<out>/rank<r>.json``/``.npy``; with ``comm``
    also the sequence collectives' seconds after each step and their
    calls."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.presets import get_preset
    from deeplearning_cfn_tpu_torch.runtime.cluster import ClusterSpec, \
        initialize

    with open(spec_path) as fh:
        spec = json.load(fh)
    out = {}
    if spec.get("grad_sum"):
        time_grad_sum(torch, spec["grad_sum"], out)
    if spec.get("peer_sums") == "skip":
        # 32a's Adafactor control: every sum over a leaf's pieces (the
        # moments' means over a split dim, rms(p), rms(u)) from this
        # process's piece alone, the peers' parts never added.
        from deeplearning_cfn_tpu_torch.train.optim import Adafactor

        Adafactor._peer_sums = lambda self, params, parts: parts
    if spec.get("comm"):
        from deeplearning_cfn_tpu_torch.parallel.collectives import \
            comm_timer

        comm_timer.enabled = True
        out["comm_s"] = []
    initialize(ClusterSpec(hosts=["127.0.0.1"] * spec["ranks"],
                           process_id=rank, chips_per_host=1,
                           coordinator_port=spec["port"]),
               timeout_s=300, accelerator=spec.get("accelerator", "gpu"))
    device = DEVICE if spec.get("accelerator", "gpu") == "gpu" else "cpu"
    cfg = apply_overrides(get_preset(spec["preset"]), spec["overrides"])
    with (deterministic(torch) if spec.get("deterministic")
          else contextlib.nullcontext()):
        if spec["mode"] == "fed":
            out["step_time_s"] = []
            out["losses"], state = fed_run(
                torch, cfg, load_batches(spec["batches"]), device,
                step_s=out["step_time_s"], comm_s=out.get("comm_s"))
            model = state.model
            if spec.get("comm"):
                out["comm_calls"] = comm_timer.calls
        else:
            from deeplearning_cfn_tpu_torch.train.run import run_experiment

            records, states = [], []

            def hook(step, st, record):
                records.append(record)
                states[:] = [st]

            run_experiment(cfg, max_steps=spec["steps"], device=device,
                           hooks=(hook,))
            out["losses"] = [r["loss"] for r in records]
            out["step_time_s"] = [r["step_time_s"] for r in records
                                  if "step_time_s" in r]
            model = states[0].model
    from deeplearning_cfn_tpu_torch.ops import attention as attn

    out["launches"] = {k: v for k, v in counts(attn).items() if k != "vjp"}
    np.save(os.path.join(spec["out"], f"rank{rank}.npy"),
            bn_stats(torch, model).numpy())
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


def time_grad_sum(torch, mode, out):
    """Time the trainer's gradient sum over the processes apart from the
    rest of the step (the card synchronized on both sides) into
    ``out["grad_sum_s"]``. With ``mode`` ``"discard"`` the sum runs on
    copies, so each process keeps its own gradients: a data-parallel step
    whose gradients are never summed, with the same traffic (28b's
    control)."""
    from deeplearning_cfn_tpu_torch.train import trainer

    real, times = trainer.all_reduce_sum_, out.setdefault("grad_sum_s", [])
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)

    def timed(tensors, groups=None):
        tensors = list(tensors)
        if mode == "discard":
            tensors = [t.clone() for t in tensors]
        sync()
        t0 = time.perf_counter()
        real(tensors, groups)
        sync()
        times.append(time.perf_counter() - t0)

    trainer.all_reduce_sum_ = timed


def spawn_dp_workers(root, name, spec, timeout=600, ranks=DP_RANKS):
    """The ``--dp-worker`` processes of one job; their results by rank."""
    import numpy as np

    from deeplearning_cfn_tpu_torch.runtime.cluster import free_local_port

    out = os.path.join(root, name)
    os.makedirs(out, exist_ok=True)
    spec = dict(spec, ranks=ranks, port=free_local_port(), out=out)
    path = os.path.join(out, "spec.json")
    with open(path, "w") as fh:
        json.dump(spec, fh)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--dp-worker",
         path, str(r)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(ranks)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{name} rank {r}: rc {p.returncode}\n"
                                 f"{text[-4000:]}")
    results = []
    for r in range(ranks):
        with open(os.path.join(out, f"rank{r}.json")) as fh:
            res = json.load(fh)
        res["bn_stats"] = np.load(os.path.join(out, f"rank{r}.npy"))
        res["log"] = logs[r]
        results.append(res)
    return results


def save_batches(path, batches):
    import numpy as np

    np.savez(path, **{f"{i}/{k}": v for i, b in enumerate(batches)
                      for k, v in b.items()})


def load_batches(path):
    """The global batches that ``save_batches`` wrote, in order."""
    import numpy as np

    with np.load(path) as data:
        n = len({k.split("/")[0] for k in data.files})
        return [{k.split("/", 1)[1]: data[k] for k in data.files
                 if k.startswith(f"{i}/")} for i in range(n)]


def worker_launches(log_text, rank):
    """The launches a train worker printed over its steps after the first:
    (counts, steps)."""
    import re

    m = re.search(rf"worker {rank} flash kernel launches over steps "
                  rf"\d+-\d+: (\{{.*?\}}) \((\d+) steps\)", log_text)
    if m is None:
        raise AssertionError(f"rank {rank} printed no launch count")
    return json.loads(m.group(1)), int(m.group(2))


def dp_stack_train(torch, root, accelerator="gpu"):
    """28a: a two-host dry-run stack and ``cli train --stack`` on it."""
    state_dir = os.path.join(root, "dp_stacks")
    rc, out = cli_inprocess(["stack", "create", "--name", "dp",
                             "--slice-type", "v5p-8", "--provisioner",
                             "dryrun", "--state-dir", state_dir])
    if rc != 0 or "CREATE_COMPLETE: 2 hosts" not in out:
        raise AssertionError(f"stack create: rc {rc}\n{out}")
    workdir = os.path.join(root, "dp_work")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning_cfn_tpu_torch.cli", "train",
         "--preset", "transformer_nmt_wmt", "--stack", "dp",
         "--state-dir", state_dir, "--max-steps", str(DP_STEPS),
         "--accelerator", accelerator, f"workdir={workdir}", *DP_OVERRIDES],
        cwd=root, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    if proc.returncode != 0 or "job finished (restarts=0" not in out:
        raise AssertionError(f"train --stack: rc {proc.returncode}\n"
                             f"{out[-4000:]}")
    run_dir = os.path.join(workdir, "transformer_nmt_wmt")
    logs = []
    for r in range(DP_RANKS):
        with open(os.path.join(run_dir, "logs",
                               f"attempt0-host{r}.log")) as fh:
            logs.append(fh.read())
    backend = "gloo, device cuda:0" if accelerator == "gpu" \
        else "gloo, device cpu"
    launches = {}
    for r, text in enumerate(logs):
        if f"process {r}/{DP_RANKS}: backend {backend}" not in text:
            raise AssertionError(f"rank {r} names no gloo rank on the "
                                 f"card: {text[:400]}")
        counts, steps = worker_launches(text, r)
        launches[f"rank{r}"] = counts
        per_step = {k: v / steps for k, v in counts.items()}
        want = {k: PER_STEP[k] for k in counts}
        log(f"  rank {r}: launches over {steps} steps {counts}, per step "
            f"{per_step} (a one-process step: {want})")
        if accelerator == "gpu" and per_step != want:
            raise AssertionError(f"rank {r} per-step launches {per_step} "
                                 f"!= {want}")
    mesh_line = [ln for ln in logs[0].splitlines() if "mesh[" in ln]
    if not mesh_line or "data=2" not in mesh_line[0]:
        raise AssertionError(f"no mesh line with data=2: {mesh_line}")
    recs = read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    steps = [r for r in recs if "loss" in r and "span" not in r
             and "final_eval_loss" not in r]
    losses = [r["loss"] for r in steps]
    if len(losses) != DP_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"bad losses {losses}")
    log(f"  {mesh_line[0].strip()}")
    log(f"  losses {' '.join(f'{x:.6f}' for x in losses)}; step p50 "
        f"{step_p50(steps) * 1e3:.1f} ms (gloo through the host; not a "
        f"data-parallel speed); job {wall:.1f} s [{card_line()}]")
    return dict(losses=losses, launches=launches, wall_s=wall,
                step_time_p50_s=step_p50(steps), mesh=mesh_line[0].strip())


def dp_reference(torch, root, stacked, device=None):
    """28b: one process on the card trained on 28a's global batches (the
    two processes' pipeline batches, rank 0's rows first); per-step losses
    within ``DP_LOSS_REL_BOUND``. The control, two processes on the same
    batches whose gradients are never summed, must exceed it, and 28a's
    losses must move by ``DP_MOVE_FACTOR`` bounds."""
    import statistics

    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.presets import get_preset

    device = device or DEVICE
    cfg = apply_overrides(get_preset("transformer_nmt_wmt"), DP_OVERRIDES)
    batches = dp_batches(cfg, DP_STEPS)
    with IN_PROCESS:
        losses = fed_run(torch, cfg, batches, device)[0]
        if device != "cpu":
            torch.cuda.empty_cache()
    path = os.path.join(root, "dp_nmt_batches.npz")
    save_batches(path, batches)
    control = spawn_dp_workers(root, "dp_nmt_unsummed", dict(
        mode="fed", preset="transformer_nmt_wmt", overrides=DP_OVERRIDES,
        batches=path, grad_sum="discard",
        accelerator="gpu" if device != "cpu" else "cpu"))
    relative = lambda got: [abs(a - b) / abs(b) for a, b in zip(got, losses)]
    rel, ctl = relative(stacked["losses"]), relative(control[0]["losses"])
    got = stacked["losses"]
    moved = abs(got[-1] - got[0]) / abs(got[0])
    # Steps after the first: the first holds the processes' warm-up.
    sums = [s for c in control for s in c["grad_sum_s"][1:]]
    steps = [s for c in control for s in c["step_time_s"][1:]]
    timing = dict(grad_sum_p50_s=statistics.median(sums),
                  step_p50_s=statistics.median(steps))
    log(f"  one process: {' '.join(f'{x:.6f}' for x in losses)}; max "
        f"relative difference {max(rel):.3e} (bound {DP_LOSS_REL_BOUND:.1e}"
        f"); the control (gradients never summed): "
        f"{' '.join(f'{x:.6f}' for x in control[0]['losses'])}, "
        f"{max(ctl):.3e}; 28a's losses moved {moved:.3e}")
    log(f"  the control's processes: gradient sum p50 "
        f"{timing['grad_sum_p50_s'] * 1e3:.2f} ms of a step p50 "
        f"{timing['step_p50_s'] * 1e3:.2f} ms (steps 2-{DP_STEPS}, both "
        f"processes; gloo through the host) [{card_line()}]")
    checks = {"within the bound": max(rel) <= DP_LOSS_REL_BOUND,
              "the control beyond it": max(ctl) > DP_LOSS_REL_BOUND,
              "the losses moved":
                  moved >= DP_MOVE_FACTOR * DP_LOSS_REL_BOUND}
    if not all(checks.values()):
        raise AssertionError(f"2 processes against 1: {checks}; relative "
                             f"{rel}, control {ctl}, moved {moved}")
    return dict(losses=losses, max_rel=max(rel), bound=DP_LOSS_REL_BOUND,
                control_losses=control[0]["losses"], control_max_rel=max(ctl),
                moved=moved, **timing)


def dp_batchnorm(torch, root, device=None):
    """28c: mesh-wide BatchNorm, forward and backward: the tiny f32
    ResNet-20 on 2 processes against 1 on the same global batches, under
    strict deterministic algorithms."""
    import numpy as np

    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.presets import get_preset

    device = device or DEVICE
    cfg = apply_overrides(get_preset("cifar10_resnet20"), DP_RESNET20)
    batches = dp_batches(cfg, DP_RESNET20_STEPS)
    path = os.path.join(root, "dp_resnet20_batches.npz")
    save_batches(path, batches)
    ranks = spawn_dp_workers(root, "dp_resnet20", dict(
        mode="fed", preset="cifar10_resnet20", overrides=DP_RESNET20,
        batches=path, deterministic=True,
        accelerator="gpu" if device != "cpu" else "cpu"))
    with IN_PROCESS, deterministic(torch):
        losses, state = fed_run(torch, cfg, batches, device)
        stats = bn_stats(torch, state.model).numpy()
        del state
    got = ranks[0]["losses"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got, losses))
    stat_err = float(np.max(np.abs(ranks[0]["bn_stats"] - stats)
                            / np.maximum(np.abs(stats), 1.0)))
    same = bool(np.array_equal(ranks[0]["bn_stats"], ranks[1]["bn_stats"]))
    log(f"  2 processes {' '.join(f'{x:.7f}' for x in got)}; 1 process "
        f"{' '.join(f'{x:.7f}' for x in losses)}; max relative "
        f"{loss_rel:.2e}; running statistics ({stats.size}) max "
        f"{stat_err:.2e} (bound {DP_F32_BOUND}); the ranks' statistics "
        f"identical: {same}")
    if loss_rel > DP_F32_BOUND or stat_err > DP_F32_BOUND or not same:
        raise AssertionError(f"mesh-wide BatchNorm: losses {loss_rel}, "
                             f"stats {stat_err}, ranks equal {same}")
    return dict(losses=got, reference=losses, max_rel=loss_rel,
                stats_max_err=stat_err, ranks_equal=same)


def dp_zero1_resume(root, accelerator="gpu"):
    """28d: ZeRO-1 and the multi-process checkpoint: the tiny BERT under
    LAMB through ``train --stack``'s worker on 2 processes, process 1
    SIGKILLed after the step-4 commit; the launcher restarts both."""
    import re

    from deeplearning_cfn_tpu_torch.launch.chaos import run_crash_recovery

    workdir = os.path.join(root, "dp_chaos")
    report = run_crash_recovery(
        workdir, preset="bert_base_wikipedia", overrides=DP_BERT,
        accelerator=accelerator, hosts=DP_RANKS, kill_process=1,
        **DP_CHAOS)
    logs = os.path.join(workdir, "logs-chaos")
    if not (report.baseline_result.success and report.chaos_result.success):
        tails = []
        for d in ("logs-baseline", "logs-chaos"):
            for name in sorted(os.listdir(os.path.join(workdir, d))):
                if name.endswith(".log"):
                    with open(os.path.join(workdir, d, name)) as fh:
                        tails.append(f"--- {d}/{name}\n{fh.read()[-1500:]}")
        raise AssertionError("ZeRO-1 jobs failed: "
                             f"{report.baseline_result.exit_codes} / "
                             f"{report.chaos_result.exit_codes}\n"
                             + "\n".join(tails))
    step_dir = os.path.join(workdir, "chaos", "bert_base_wikipedia", "ckpt",
                            f"step_{DP_CHAOS['total_steps']:08d}")
    files = sorted(os.listdir(step_dir))
    slots = {}
    for r in range(DP_RANKS):
        with open(os.path.join(logs, f"attempt0-host{r}.log")) as fh:
            m = re.search(r"ZeRO-1 optimizer slots (\d+) bytes on this "
                          r"process of (\d+)", fh.read())
        slots[f"rank{r}"] = (int(m.group(1)), int(m.group(2))) if m \
            else None
    checks = {
        "baseline ok": report.baseline_result.success,
        "outcomes crash, ok":
            report.chaos_result.attempt_outcomes == ["crash", "ok"],
        "resumed from 4": report.resumed_from == DP_CHAOS["kill_at_step"],
        "per-step losses bit for bit": report.parity_ok,
        "no uncommitted step dir": report.uncommitted_after == [],
        "manifest_p0 and manifest_p1": {"manifest_p0.json",
                                        "manifest_p1.json",
                                        "COMMIT"} <= set(files),
        "slots split": all(s and s[0] < s[1] for s in slots.values()),
    }
    log(f"  outcomes {report.chaos_result.attempt_outcomes}, resumed from "
        f"{report.resumed_from}, mismatches {report.mismatches or 'none'}; "
        f"checkpoint {files}")
    log(f"  ZeRO-1 slot bytes per process {slots} (one process: the "
        f"second number)")
    if not report.parity_ok:
        log(f"  not bit for bit: {report.mismatches}")
    if not all(checks.values()):
        raise AssertionError(f"ZeRO-1 resume: {checks}")
    return dict(outcomes=report.chaos_result.attempt_outcomes,
                resumed_from=report.resumed_from,
                parity_ok=report.parity_ok, files=files, slot_bytes=slots)


def dp_resnet50(torch, root, device=None):
    """28e: ResNet-50 at full width, bf16, on 2 processes through
    ``run_experiment``: finite losses, the two processes' BatchNorm
    running statistics identical, the step time per process."""
    import numpy as np

    device = device or DEVICE
    ranks = spawn_dp_workers(root, "dp_resnet50", dict(
        mode="run", preset="imagenet_resnet50",
        overrides=DP_RESNET50 + [
            f"workdir={os.path.join(root, 'dp_resnet50_work')}"],
        steps=DP_RESNET50_STEPS,
        accelerator="gpu" if device != "cpu" else "cpu"))
    losses = ranks[0]["losses"]
    same = bool(np.array_equal(ranks[0]["bn_stats"], ranks[1]["bn_stats"]))
    times = {f"rank{r}": res["step_time_s"] for r, res in enumerate(ranks)}
    log(f"  losses {losses}; the ranks' BatchNorm statistics identical: "
        f"{same}; step time per process {times} s (gloo-staged through "
        f"the host, two processes on one card; cuts: {DP_RESNET50_CUTS}) "
        f"[{card_line()}]")
    if len(losses) != DP_RESNET50_STEPS or \
            not all(map(math.isfinite, losses)) or not same:
        raise AssertionError(f"ResNet-50 on 2 processes: losses {losses}, "
                             f"statistics equal {same}")
    return dict(losses=losses, bn_stats_identical=same,
                step_time_s=times, cuts=DP_RESNET50_CUTS)


def dp_phase(torch, root):
    """Phase 28 in ``root``: 28a then 28b, beside 28c, 28d and 28e, all at
    once (``at_once``)."""
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p)
    torch.cuda.empty_cache()
    out = {}

    def nmt():
        for key, fn in (("28a", lambda: dp_stack_train(torch, root)),
                        ("28b", lambda: dp_reference(torch, root,
                                                     out["28a"]))):
            t = time.perf_counter()
            out[key] = fn()
            out[key]["phase_s"] = time.perf_counter() - t
            log(f"  {key} {out[key]['phase_s']:.1f} s")

    out.update(at_once([("28a-28b", nmt),
                        ("28c", lambda: dp_batchnorm(torch, root)),
                        ("28d", lambda: dp_zero1_resume(root)),
                        ("28e", lambda: dp_resnet50(torch, root))]))
    del out["28a-28b"]
    torch.cuda.empty_cache()
    return out



def long_cli_train(torch, attn, preset, overrides, per_step, accum, seq,
                   workdir_name):
    """``cli train --preset PRESET`` in this process at full width, bf16,
    with every count set to 0 first: finite losses, the launches of every
    step and of the final eval (all ``tc``), step times from
    ``metrics.jsonl``."""
    workdir = fresh_workdir(workdir_name)
    argv = ["train", "--preset", preset, f"workdir={workdir}",
            *LONG_COMMON, *overrides]
    for cut in LONG_CUTS[preset]:
        log(f"  cut: {cut}")
    torch.cuda.reset_peak_memory_stats()
    set_counts(attn, 0)
    t0 = time.perf_counter()
    rc, out = cli_inprocess(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched, by_variant = counts(attn), variant_counts(attn)
    peak = torch.cuda.max_memory_allocated()
    if rc != 0 or "final metrics" not in out:
        raise AssertionError(f"cli train {preset}: rc {rc}\n{out[-3000:]}")
    recs = read_jsonl(os.path.join(workdir, preset, "metrics.jsonl"))
    steps = [r for r in recs if "loss" in r and "span" not in r
             and "final_eval_loss" not in r]
    losses = [r["loss"] for r in steps]
    if len(losses) != LONG_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{preset}: bad losses {losses}")
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.presets import get_preset

    cfg = apply_overrides(get_preset(preset), overrides)
    eval_batches = math.ceil(cfg.data.num_eval_examples
                             / cfg.train.eval_batch)
    expect = {k: v * LONG_STEPS * accum for k, v in per_step.items()}
    expect["fwd"] += LONG_LAYERS * eval_batches
    log(f"  losses {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"  launches over {LONG_STEPS} steps (accum {accum}) and the eval's "
        f"{eval_batches} batch(es): {launched} (expected {expect}); by "
        f"variant {by_variant}")
    if launched != expect:
        raise AssertionError(f"{preset} launches {launched} != {expect}")
    if any(by_variant[k]["tc"] != launched[k] for k in ("fwd", "dkdv", "dq")):
        raise AssertionError(f"{preset} launches off the tc variant: "
                             f"{by_variant}")
    timed = [r for r in steps[1:] if "step_time_s" in r]
    p50 = lambda xs: sorted(xs)[len(xs) // 2]
    step_s = p50([r["step_time_s"] for r in timed])
    tokens_s = cfg.train.global_batch * seq / step_s
    return dict(preset=preset, losses=losses, launches=launched,
                variant_launches=by_variant, step_time_p50_s=step_s,
                tokens_per_s_p50=tokens_s, first_step_s=steps[0]["compile_s"],
                max_memory_allocated_bytes=peak, wall_s=wall,
                final=out.strip().splitlines()[-1], cuts=LONG_CUTS[preset],
                workdir=workdir, cfg=cfg)


def long_mfu(torch, run, flops_per_seq):
    """Add the forward FLOPs per token and the MFU share (3x the forward per
    step, of 989 TFLOP/s dense bf16) to a phase-29 run."""
    seq = run["cfg"].data.seq_len
    seqs_s = run["cfg"].train.global_batch / run["step_time_p50_s"]
    run["forward_mflop_per_token"] = flops_per_seq / seq / 1e6
    run["mfu_share"] = mfu_share(seqs_s, flops_per_seq)
    log(f"  step time p50 {run['step_time_p50_s'] * 1e3:.2f} ms, tokens/s "
        f"p50 {run['tokens_per_s_p50']:.1f}, MFU share {run['mfu_share']:.4f} "
        f"({run['forward_mflop_per_token']:.1f} MFLOP forward per token, "
        f"counted from the shapes), first step {run['first_step_s']:.2f} s, "
        f"max_memory_allocated "
        f"{run['max_memory_allocated_bytes'] / 2**30:.2f} GiB; run "
        f"{run['wall_s']:.1f} s [{card_line()}]")
    log(f"  {run['final']}")


def long_generate(torch, attn, workdir):
    """``cli generate --preset gpt_long_lm`` from phase 29's checkpoint,
    greedy: recompute mode, 12 forward launches (tc) per new token."""
    prompt = "The H100 port of"
    assert len(prompt.encode()) == LONG_GPT_PROMPT
    set_counts(attn, 0)
    t0 = time.perf_counter()
    rc, out = cli_inprocess(["generate", "--preset", "gpt_long_lm",
                             "--prompt", prompt, "--max-new-tokens",
                             str(LONG_GPT_NEW), f"workdir={workdir}",
                             *LONG_COMMON, *LONG_GPT])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched, by_variant = counts(attn), variant_counts(attn)
    log("  " + out.strip().replace("\n", "\n  "))
    expect = LONG_LAYERS * LONG_GPT_NEW
    log(f"  launches {launched}, by variant {by_variant} (expected {expect} "
        f"tc: recompute mode); {wall:.2f} s with the restore")
    if rc != 0 or "checkpoint step" not in out:
        raise AssertionError(f"cli generate gpt_long: rc {rc}: {out!r}")
    if launched != {"fwd": expect, "dkdv": 0, "dq": 0, "vjp": 0} or \
            by_variant["fwd"]["tc"] != expect:
        raise AssertionError(f"generate launches {launched} {by_variant}")
    return dict(rc=rc, text=out.strip().splitlines()[-1], wall_s=wall,
                launches=launched["fwd"], variant_launches=by_variant["fwd"])


def long_parity(torch, attn):
    """The tiny f32 bert_long and gpt_long (head dim 16) on the card against
    the CPU, TF32 off: the loss within 1e-5 relative, every gradient within
    1e-4 of the global norm, the three kernels once per layer (simt) and the
    reference VJP never."""
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.data.pipeline import (build_pipeline,
                                                          to_device)
    from deeplearning_cfn_tpu_torch.presets import get_preset
    from deeplearning_cfn_tpu_torch.train.task import CausalLmTask, MlmTask

    out = {}
    for preset, task_cls in (("bert_long_wikipedia", MlmTask),
                             ("gpt_long_lm", CausalLmTask)):
        cfg = apply_overrides(get_preset(preset), LONG_TINY)
        cpu, card = _card_and_cpu(torch, task_cls, cfg)
        batch = next(iter(build_pipeline(cfg.data, 4, cfg.model.num_classes,
                                         seed=0).one_epoch()))
        ref, _ = cpu.loss_fn(to_device(batch, torch.device("cpu")), True)
        ref.backward()
        before = counts(attn)
        loss, _ = card.loss_fn(to_device(batch, torch.device(DEVICE)), True)
        loss.backward()
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in counts(attn).items()}
        loss_err = abs(loss.item() - ref.item()) / abs(ref.item())
        grad_err = _grad_check(f"tiny {preset}", cpu.model, card.model)
        log(f"  tiny f32 {cfg.model.name}, card vs CPU: loss {loss_err:.3e} "
            f"relative (<= 1e-5), gradients {grad_err:.3e} of the norm (<= "
            f"1e-4); launches {launched}")
        if not loss_err <= 1e-5:
            raise AssertionError(f"tiny {preset}: loss {loss_err}")
        if launched != {"fwd": 2, "dkdv": 2, "dq": 2, "vjp": 0}:
            raise AssertionError(f"tiny {preset} launches {launched}")
        out[cfg.model.name] = dict(loss_rel_err=loss_err,
                                   grad_err_of_norm=grad_err,
                                   launches=launched)
    return out


def long_phase(torch, attn):
    """Phase 29: the kernels at the two long shapes (timed at the main
    path's shapes, held against the plain versions at the cut shapes), then
    bert_long_wikipedia and gpt_long_lm through ``cli train``, ``cli
    generate`` from gpt_long's checkpoint, and the tiny f32 trunks card
    against CPU."""
    import shutil

    from deeplearning_cfn_tpu_torch.models.bert_long import \
        forward_flops as bert_flops
    from deeplearning_cfn_tpu_torch.models.lm import \
        forward_flops as gpt_flops

    rows = {}
    for label, shape, check, causal in (
            ("long_bert_self", LONG_BERT_SHAPE, LONG_BERT_CHECK, False),
            ("long_gpt_self", LONG_GPT_SHAPE, LONG_GPT_CHECK, True)):
        log(f"  {label}: timed at {list(shape)}, held against the plain "
            f"versions at {list(check)} (the plain versions hold S x S in "
            f"f32) [{card_line()}]")
        torch.cuda.reset_peak_memory_stats()
        rows[label] = time_training_kernels(torch, attn, shape, label,
                                            (10, 2, 3, 1), causal=causal)
        check_train_kernels(torch, attn, rows[label], check, causal=causal)
        for row in rows[label].values():
            row["checked_at"] = list(check)
        log(f"  max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        torch.cuda.empty_cache()

    bert = long_cli_train(torch, attn, "bert_long_wikipedia", LONG_BERT,
                          LONG_PER_MICRO, 1, LONG_BERT_SEQ, "smoke_long_bert")
    from deeplearning_cfn_tpu_torch.models import build_model

    meta = lambda name, classes, **kw: build_model(
        name, classes, torch.bfloat16, device="meta", **kw)
    long_mfu(torch, bert, bert_flops(
        meta("bert_long", 2, vocab_size=LONG_BERT_VOCAB), LONG_BERT_SEQ,
        LONG_BERT_PRED))
    shutil.rmtree(bert.pop("workdir"), ignore_errors=True)
    torch.cuda.empty_cache()
    gpt = long_cli_train(torch, attn, "gpt_long_lm", LONG_GPT,
                         LONG_PER_MICRO, LONG_GPT_ACCUM, LONG_GPT_SEQ,
                         "smoke_long_gpt")
    long_mfu(torch, gpt, gpt_flops(
        meta("gpt_long", 0, vocab_size=LONG_GPT_VOCAB, max_len=LONG_GPT_SEQ),
        LONG_GPT_SEQ))
    torch.cuda.empty_cache()
    generated = long_generate(torch, attn, gpt["workdir"])
    shutil.rmtree(gpt.pop("workdir"), ignore_errors=True)
    torch.cuda.empty_cache()
    tiny = long_parity(torch, attn)
    for run in (bert, gpt):
        run.pop("cfg")
    return dict(rows=rows, bert=bert, gpt=gpt, generate=generated,
                tiny_f32_card_vs_cpu=tiny)


def seq_stack_train(torch, root, name, accelerator="gpu"):
    """30a/30c: ``cli train --stack`` on phase 28a's two-host dry-run stack
    with ``mesh.seq=2``: each process's launches per step held to
    :data:`SEQ_PER_STEP`, the mesh line, finite losses."""
    preset, overrides = SEQ_JOBS[name]
    workdir = os.path.join(root, f"seq_{name}_work")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning_cfn_tpu_torch.cli", "train",
         "--preset", preset, "--stack", "dp", "--state-dir",
         os.path.join(root, "dp_stacks"), "--max-steps", str(SEQ_STEPS),
         "--accelerator", accelerator, f"workdir={workdir}", *overrides],
        cwd=root, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    if proc.returncode != 0 or "job finished (restarts=0" not in out:
        raise AssertionError(f"train --stack ({name}): rc "
                             f"{proc.returncode}\n{out[-4000:]}")
    run_dir = os.path.join(workdir, preset)
    launches = {}
    for r in range(DP_RANKS):
        with open(os.path.join(run_dir, "logs",
                               f"attempt0-host{r}.log")) as fh:
            text = fh.read()
        if r == 0:
            mesh_line = [ln for ln in text.splitlines() if "mesh[" in ln]
        counts_r, steps = worker_launches(text, r)
        launches[f"rank{r}"] = counts_r
        per_step = {k: v / steps for k, v in counts_r.items()}
        log(f"  rank {r}: launches over {steps} steps {counts_r}, per step "
            f"{per_step} (expected {SEQ_PER_STEP[name]})")
        if accelerator == "gpu" and per_step != SEQ_PER_STEP[name]:
            raise AssertionError(f"{name} rank {r} per-step launches "
                                 f"{per_step} != {SEQ_PER_STEP[name]}")
    if not mesh_line or "seq=2" not in mesh_line[0]:
        raise AssertionError(f"no mesh line with seq=2: {mesh_line}")
    recs = read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    steps = [r for r in recs if "loss" in r and "span" not in r
             and "final_eval_loss" not in r]
    losses = [r["loss"] for r in steps]
    if len(losses) != SEQ_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{name}: bad losses {losses}")
    log(f"  {mesh_line[0].strip()}")
    log(f"  losses {' '.join(f'{x:.6f}' for x in losses)}; step p50 "
        f"{step_p50(steps) * 1e3:.1f} ms (gloo-staged); job {wall:.1f} s "
        f"[{card_line()}]")
    return dict(losses=losses, launches=launches, wall_s=wall,
                step_time_p50_s=step_p50(steps), mesh=mesh_line[0].strip())


def seq_reference(torch, root, name, stacked, device=None):
    """30b/30d: one process on the same global batches (both processes of
    the seq group read every row); per-step losses within the job's
    :data:`SEQ_LOSS_REL_BOUND`. The control, the same two processes with
    their gradients never summed, must exceed it, and the stack run's
    losses must move by :data:`SEQ_MOVE_FACTOR` bounds. The control's
    processes time the sequence collectives (``comm_timer``, the card
    synchronized around each exchange) apart from the step."""
    import statistics

    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.presets import get_preset

    device = device or DEVICE
    preset, overrides = SEQ_JOBS[name]
    cfg = apply_overrides(get_preset(preset), overrides)
    batches = dp_batches(cfg, SEQ_STEPS, ranks=1)
    with IN_PROCESS:
        losses = fed_run(torch, cfg, batches, device)[0]
        if device != "cpu":
            torch.cuda.empty_cache()
    path = os.path.join(root, f"seq_{name}_batches.npz")
    save_batches(path, batches)
    control = spawn_dp_workers(root, f"seq_{name}_unsummed", dict(
        mode="fed", preset=preset, overrides=overrides, batches=path,
        grad_sum="discard", comm=True,
        accelerator="gpu" if device != "cpu" else "cpu"))
    relative = lambda got: [abs(a - b) / abs(b) for a, b in zip(got, losses)]
    rel, ctl = relative(stacked["losses"]), relative(control[0]["losses"])
    got = stacked["losses"]
    moved = max(abs(x - got[0]) for x in got) / abs(got[0])
    bound = SEQ_LOSS_REL_BOUND[name]
    # Steps after the first (its warm-up), both processes.
    kind = "ring" if name == "ring" else "ulysses"
    per_step = lambda c, key: [b.get(key, 0.0) - a.get(key, 0.0) for a, b in
                               zip(c["comm_s"][:-1], c["comm_s"][1:])]
    timing = dict(
        comm_kind=kind,
        comm_p50_s=statistics.median(
            s for c in control for s in per_step(c, kind)),
        gather_p50_s=statistics.median(
            s for c in control for s in per_step(c, "gather")),
        grad_sum_p50_s=statistics.median(
            s for c in control for s in c["grad_sum_s"][1:]),
        step_p50_s=statistics.median(
            s for c in control for s in c["step_time_s"][1:]),
        comm_calls_per_step={k: v / SEQ_STEPS for k, v in
                             control[0]["comm_calls"].items()})
    log(f"  one process: {' '.join(f'{x:.6f}' for x in losses)}; max "
        f"relative difference {max(rel):.3e} (bound {bound:.1e}); the "
        f"control (gradients never summed): "
        f"{' '.join(f'{x:.6f}' for x in control[0]['losses'])}, "
        f"{max(ctl):.3e}; the stack's losses moved {moved:.3e} at most")
    log(f"  gloo-staged {kind} exchanges p50 {timing['comm_p50_s'] * 1e3:.2f}"
        f" ms per step ({timing['comm_calls_per_step']} calls per step), the "
        f"heads' gather {timing['gather_p50_s'] * 1e3:.2f} ms, the gradient "
        f"sum {timing['grad_sum_p50_s'] * 1e3:.2f} ms, of a step p50 "
        f"{timing['step_p50_s'] * 1e3:.2f} ms (the control's processes, "
        f"steps 2-{SEQ_STEPS}, the card synchronized around each exchange; "
        f"cuts: {SEQ_CUTS}) [{card_line()}]")
    checks = {"within the bound": max(rel) <= bound,
              "the control beyond it": max(ctl) > bound,
              "the losses moved": moved >= SEQ_MOVE_FACTOR * bound}
    if not all(checks.values()):
        raise AssertionError(f"{name}: 2 processes against 1: {checks}; "
                             f"relative {rel}, control {ctl}, moved {moved}")
    return dict(losses=losses, max_rel=max(rel), bound=bound,
                control_losses=control[0]["losses"], control_max_rel=max(ctl),
                moved=moved, **timing)


def seq_jobs(torch, root):
    """Phase 30's two jobs, ring (bert_long) and Ulysses (gpt_long), as
    ``at_once`` takes them: each the stack run in ``root`` (phase 28a made
    the stack), then its one-process reference with the control."""
    def job(name):
        stacked = seq_stack_train(torch, root, name)
        return dict(stack=stacked,
                    reference=seq_reference(torch, root, name, stacked))

    return [(name, lambda name=name: job(name)) for name in SEQ_JOBS]


def pe_stack_train(torch, root, name, accelerator="gpu"):
    """31a/31c: ``cli train --stack`` on a four-host dry-run stack with the
    job's mesh: each process's launches per step held to
    :data:`PE_PER_STEP`, its peak device memory, the mesh line, finite
    losses."""
    import re

    preset, overrides = PE_JOBS[name]
    state_dir = os.path.join(root, "pe_stacks")
    with CLI:
        if not os.path.isdir(state_dir):
            rc, out = cli_inprocess(["stack", "create", "--name", "pe",
                                     "--slice-type", "v5p-16",
                                     "--provisioner", "dryrun",
                                     "--state-dir", state_dir])
            if rc != 0 or f"CREATE_COMPLETE: {PE_RANKS} hosts" not in out:
                raise AssertionError(f"stack create: rc {rc}\n{out}")
    workdir = os.path.join(root, f"pe_{name}_work")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning_cfn_tpu_torch.cli", "train",
         "--preset", preset, "--stack", "pe", "--state-dir", state_dir,
         "--max-steps", str(PE_STEPS), "--accelerator", accelerator,
         f"workdir={workdir}", *overrides],
        cwd=root, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    if proc.returncode != 0 or "job finished (restarts=0" not in out:
        raise AssertionError(f"train --stack ({name}): rc "
                             f"{proc.returncode}\n{out[-4000:]}")
    run_dir = os.path.join(workdir, preset)
    launches, peak = {}, {}
    for r in range(PE_RANKS):
        with open(os.path.join(run_dir, "logs",
                               f"attempt0-host{r}.log")) as fh:
            text = fh.read()
        if r == 0:
            mesh_line = [ln for ln in text.splitlines() if "mesh[" in ln]
        counts_r, steps = worker_launches(text, r)
        launches[f"rank{r}"] = counts_r
        m = re.search(rf"worker {r} peak device memory (\d+) bytes", text)
        if accelerator == "gpu" and m is None:
            raise AssertionError(f"{name} rank {r} printed no peak memory")
        peak[f"rank{r}"] = int(m.group(1)) if m else 0
        per_step = {k: v / steps for k, v in counts_r.items()}
        log(f"  rank {r}: launches over {steps} steps {counts_r}, per step "
            f"{per_step} (expected {PE_PER_STEP[name]}); peak "
            f"{peak[f'rank{r}'] / 2**30:.2f} GiB")
        if accelerator == "gpu" and per_step != PE_PER_STEP[name]:
            raise AssertionError(f"{name} rank {r} per-step launches "
                                 f"{per_step} != {PE_PER_STEP[name]}")
    axis = f"{name}={PE_RANKS}"
    if not mesh_line or axis not in mesh_line[0]:
        raise AssertionError(f"no mesh line with {axis}: {mesh_line}")
    recs = read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    steps = [r for r in recs if "loss" in r and "span" not in r
             and "final_eval_loss" not in r]
    losses = [r["loss"] for r in steps]
    if len(losses) != PE_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{name}: bad losses {losses}")
    log(f"  {mesh_line[0].strip()}")
    log(f"  losses {' '.join(f'{x:.6f}' for x in losses)}; step p50 "
        f"{step_p50(steps) * 1e3:.1f} ms (gloo-staged, 4 processes on one "
        f"card); job {wall:.1f} s [{card_line()}]")
    return dict(losses=losses, launches=launches, peak_bytes=peak,
                wall_s=wall, step_time_p50_s=step_p50(steps),
                mesh=mesh_line[0].strip())


def pe_reference(torch, root, name, stacked, device=None):
    """31b/31d: one process on the same global batches; per-step losses
    within the job's :data:`PE_LOSS_REL_BOUND`. The control, the same four
    processes with their gradients never summed, must exceed it, and the
    stack run's losses must move by :data:`PE_MOVE_FACTOR` bounds. The
    control's processes time the pipe or expert collectives
    (``comm_timer``, the card synchronized around each exchange) and the
    gradient sum apart from the step."""
    import statistics

    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.parallel import build_mesh
    from deeplearning_cfn_tpu_torch.presets import get_preset

    device = device or DEVICE
    preset, overrides = PE_JOBS[name]
    cfg = apply_overrides(get_preset(preset), overrides)
    ways = build_mesh(cfg.mesh, num_processes=PE_RANKS, index=0).data_ways
    batches = dp_batches(cfg, PE_STEPS, ranks=ways)
    with IN_PROCESS:
        losses = fed_run(torch, cfg, batches, device)[0]
        if device != "cpu":
            torch.cuda.empty_cache()
    path = os.path.join(root, f"pe_{name}_batches.npz")
    save_batches(path, batches)
    control = spawn_dp_workers(root, f"pe_{name}_unsummed", dict(
        mode="fed", preset=preset, overrides=overrides, batches=path,
        grad_sum="discard", comm=True,
        accelerator="gpu" if device != "cpu" else "cpu"), ranks=PE_RANKS)
    relative = lambda got: [abs(a - b) / abs(b) for a, b in zip(got, losses)]
    rel, ctl = relative(stacked["losses"]), relative(control[0]["losses"])
    got = stacked["losses"]
    moved = max(abs(x - got[0]) for x in got) / abs(got[0])
    bound = PE_LOSS_REL_BOUND[name]
    # Steps after the first (its warm-up), every process.
    per_step = lambda c, key: [b.get(key, 0.0) - a.get(key, 0.0) for a, b in
                               zip(c["comm_s"][:-1], c["comm_s"][1:])]
    timing = dict(
        comm_p50_s=statistics.median(
            s for c in control for s in per_step(c, name)),
        grad_sum_p50_s=statistics.median(
            s for c in control for s in c["grad_sum_s"][1:]),
        step_p50_s=statistics.median(
            s for c in control for s in c["step_time_s"][1:]),
        comm_calls_per_step={k: v / PE_STEPS for k, v in
                             control[0]["comm_calls"].items()})
    timing["comm_share"] = timing["comm_p50_s"] / timing["step_p50_s"]
    what = "stage hops and masked sums" if name == "pipe" \
        else "all-to-alls"
    log(f"  one process: {' '.join(f'{x:.6f}' for x in losses)}; max "
        f"relative difference {max(rel):.3e} (bound {bound:.1e}); the "
        f"control (gradients never summed): "
        f"{' '.join(f'{x:.6f}' for x in control[0]['losses'])}, "
        f"{max(ctl):.3e}; the stack's losses moved {moved:.3e} at most")
    log(f"  gloo-staged {what} p50 {timing['comm_p50_s'] * 1e3:.2f} ms per "
        f"step ({timing['comm_share']:.1%} of the step; "
        f"{timing['comm_calls_per_step']} calls per step), the gradient sum "
        f"{timing['grad_sum_p50_s'] * 1e3:.2f} ms, of a step p50 "
        f"{timing['step_p50_s'] * 1e3:.2f} ms (the control's processes, "
        f"steps 2-{PE_STEPS}, the card synchronized around each exchange; "
        f"cuts: {PE_CUTS}) [{card_line()}]")
    checks = {"within the bound": max(rel) <= bound,
              "the control beyond it": max(ctl) > bound,
              "the losses moved": moved >= PE_MOVE_FACTOR * bound}
    if not all(checks.values()):
        raise AssertionError(f"{name}: 4 processes against 1: {checks}; "
                             f"relative {rel}, control {ctl}, moved {moved}")
    return dict(losses=losses, max_rel=max(rel), bound=bound,
                control_losses=control[0]["losses"], control_max_rel=max(ctl),
                moved=moved, **timing)


def pe_jobs(torch, root):
    """Phase 31's two jobs, the pipe axis (bert_pipelined) and the expert
    axis (bert_moe), as ``at_once`` takes them: each the stack run in
    ``root``, then its one-process reference with the control."""
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p)

    def job(name):
        stacked = pe_stack_train(torch, root, name)
        return dict(stack=stacked,
                    reference=pe_reference(torch, root, name, stacked))

    return [(name, lambda name=name: job(name)) for name in PE_JOBS]


def ts_stack_train(torch, root, name, accelerator="gpu"):
    """32a/32c: ``cli train --stack`` on phase 28a's two-host dry-run
    stack with the job's mesh: each process's launches per step held to
    :data:`TS_PER_STEP`, its step p50 and peak device memory, the mesh
    line, finite losses."""
    import re

    preset, overrides = TS_JOBS[name]
    workdir = os.path.join(root, f"ts_{name}_work")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning_cfn_tpu_torch.cli", "train",
         "--preset", preset, "--stack", "dp", "--state-dir",
         os.path.join(root, "dp_stacks"), "--max-steps",
         str(TS_STEPS[name]), "--accelerator", accelerator,
         f"workdir={workdir}", *overrides],
        cwd=root, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    if proc.returncode != 0 or "job finished (restarts=0" not in out:
        raise AssertionError(f"train --stack ({name}): rc "
                             f"{proc.returncode}\n{out[-4000:]}")
    run_dir = os.path.join(workdir, preset)
    launches, peak, step_s = {}, {}, {}
    for r in range(TS_RANKS):
        with open(os.path.join(run_dir, "logs",
                               f"attempt0-host{r}.log")) as fh:
            text = fh.read()
        if r == 0:
            mesh_line = [ln for ln in text.splitlines() if "mesh[" in ln]
        counts_r, steps = worker_launches(text, r)
        launches[f"rank{r}"] = counts_r
        m = re.search(rf"worker {r} peak device memory (\d+) bytes", text)
        t = re.search(rf"worker {r} step time p50 ([0-9.e+-]+) s", text)
        if accelerator == "gpu" and (m is None or t is None):
            raise AssertionError(f"{name} rank {r} printed no peak memory "
                                 f"or step time")
        peak[f"rank{r}"] = int(m.group(1)) if m else 0
        step_s[f"rank{r}"] = float(t.group(1)) if t else 0.0
        per_step = {k: v / steps for k, v in counts_r.items()}
        log(f"  rank {r}: step p50 {step_s[f'rank{r}'] * 1e3:.2f} ms; "
            f"launches over {steps} steps {counts_r}, per step {per_step} "
            f"(expected {TS_PER_STEP[name]}); peak "
            f"{peak[f'rank{r}'] / 2**30:.2f} GiB [{card_line()}]")
        if accelerator == "gpu" and per_step != TS_PER_STEP[name]:
            raise AssertionError(f"{name} rank {r} per-step launches "
                                 f"{per_step} != {TS_PER_STEP[name]}")
    axis = f"{name}=2"
    if not mesh_line or axis not in mesh_line[0]:
        raise AssertionError(f"no mesh line with {axis}: {mesh_line}")
    recs = read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    steps = [r for r in recs if "loss" in r and "span" not in r
             and "final_eval_loss" not in r]
    losses = [r["loss"] for r in steps]
    if len(losses) != TS_STEPS[name] or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{name}: bad losses {losses}")
    log(f"  {mesh_line[0].strip()}")
    log(f"  losses {' '.join(f'{x:.6f}' for x in losses)}; job {wall:.1f} s "
        f"[{card_line()}]")
    return dict(losses=losses, launches=launches, peak_bytes=peak,
                step_time_p50_s=step_s, wall_s=wall,
                mesh=mesh_line[0].strip())


def ts_reference(torch, root, name, stacked, device=None):
    """32b/32d: one process on the same global batches; per-step losses
    within the job's :data:`TS_LOSS_REL_BOUND`. The control, the same two
    processes with their gradients never summed, must exceed it, and the
    stack run's losses must move by the job's :data:`TS_MOVE_FACTOR`
    bounds. The control's processes time the ``model`` group's sums, or
    the halos and the pyramid's gather (``comm_timer``, the card
    synchronized around each exchange), and the gradient sum apart from
    the step."""
    import statistics

    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.presets import get_preset

    device = device or DEVICE
    preset, overrides = TS_JOBS[name]
    steps = TS_STEPS[name]
    cfg = apply_overrides(get_preset(preset), overrides)
    batches = dp_batches(cfg, steps, ranks=1)
    with IN_PROCESS:
        losses = fed_run(torch, cfg, batches, device)[0]
        if device != "cpu":
            torch.cuda.empty_cache()
    path = os.path.join(root, f"ts_{name}_batches.npz")
    save_batches(path, batches)
    control = spawn_dp_workers(root, f"ts_{name}_unsummed", dict(
        mode="fed", preset=preset, overrides=overrides, batches=path,
        grad_sum="discard", comm=True,
        accelerator="gpu" if device != "cpu" else "cpu"), ranks=TS_RANKS)
    relative = lambda got: [abs(a - b) / abs(b) for a, b in zip(got, losses)]
    rel, ctl = relative(stacked["losses"]), relative(control[0]["losses"])
    got = stacked["losses"]
    moved = max(abs(x - got[0]) for x in got) / abs(got[0])
    bound = TS_LOSS_REL_BOUND[name]
    kinds = ("model",) if name == "model" else ("halo", "spatial")
    # Steps after the first (its warm-up), per process.
    per_step = lambda c, key: [b.get(key, 0.0) - a.get(key, 0.0) for a, b in
                               zip(c["comm_s"][:-1], c["comm_s"][1:])]
    p50 = lambda xs: statistics.median(xs) if xs else 0.0
    timing = dict(
        comm_p50_s={f"rank{r}": {k: p50(per_step(c, k)) for k in kinds}
                    for r, c in enumerate(control)},
        grad_sum_p50_s={f"rank{r}": p50(c["grad_sum_s"][1:])
                        for r, c in enumerate(control)},
        step_p50_s={f"rank{r}": p50(c["step_time_s"][1:])
                    for r, c in enumerate(control)},
        comm_calls_per_step={k: v / steps for k, v in
                             control[0]["comm_calls"].items()})
    what = "the model group's sums" if name == "model" \
        else "the conv halos (halo) and the pyramid's gather (spatial)"
    log(f"  one process: {' '.join(f'{x:.6f}' for x in losses)}; max "
        f"relative difference {max(rel):.3e} (bound {bound:.1e}); the "
        f"control (gradients never summed): "
        f"{' '.join(f'{x:.6f}' for x in control[0]['losses'])}, "
        f"{max(ctl):.3e}; the stack's losses moved {moved:.3e} at most")
    for r in range(TS_RANKS):
        key = f"rank{r}"
        comm = ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in
                         timing["comm_p50_s"][key].items())
        log(f"  rank {r}: gloo-staged {what} p50 per step: {comm}; the "
            f"gradient sum {timing['grad_sum_p50_s'][key] * 1e3:.2f} ms; "
            f"of a step p50 {timing['step_p50_s'][key] * 1e3:.2f} ms (the "
            f"control's steps 2-{steps}, the card synchronized around each "
            f"exchange) [{card_line()}]")
    log(f"  calls per step {timing['comm_calls_per_step']}; cuts: "
        f"{TS_CUTS}")
    checks = {"within the bound": max(rel) <= bound,
              "the control beyond it": max(ctl) > bound,
              "the losses moved": moved >= TS_MOVE_FACTOR[name] * bound}
    if not all(checks.values()):
        raise AssertionError(f"{name}: 2 processes against 1: {checks}; "
                             f"relative {rel}, control {ctl}, moved {moved}")
    return dict(losses=losses, max_rel=max(rel), bound=bound,
                control_losses=control[0]["losses"], control_max_rel=max(ctl),
                moved=moved, **timing)


def ts_adafactor(torch, root, device=None):
    """32a's Adafactor leg: the two processes (``fed``), then the control
    (``peer_sums`` ``skip``), against one process on the same global
    batches: per-step relative loss differences, each process's launches
    per step held to :data:`TS_PER_STEP`'s ``model``, the losses moving."""
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.presets import get_preset

    device = device or DEVICE
    cfg = apply_overrides(get_preset("gpt_small_lm"), TS_ADAFACTOR)
    batches = dp_batches(cfg, TS_ADAFACTOR_STEPS, ranks=1)
    path = os.path.join(root, "ts_adafactor_batches.npz")
    save_batches(path, batches)
    spec = dict(mode="fed", preset="gpt_small_lm", overrides=TS_ADAFACTOR,
                batches=path, accelerator="gpu" if device != "cpu" else "cpu")
    sound = spawn_dp_workers(root, "ts_adafactor", spec, ranks=TS_RANKS)
    control = spawn_dp_workers(root, "ts_adafactor_no_peer_sums",
                               dict(spec, peer_sums="skip"), ranks=TS_RANKS)
    with IN_PROCESS:
        losses = fed_run(torch, cfg, batches, device)[0]
        if device != "cpu":
            torch.cuda.empty_cache()
    relative = lambda got: [abs(a - b) / abs(b) for a, b in zip(got, losses)]
    rel, ctl = relative(sound[0]["losses"]), relative(control[0]["losses"])
    got = sound[0]["losses"]
    moved = max(abs(x - got[0]) for x in got) / abs(got[0])
    for r, res in enumerate(sound):
        per_step = {k: v / TS_ADAFACTOR_STEPS
                    for k, v in res["launches"].items()}
        log(f"  rank {r}: launches per step {per_step} (expected "
            f"{TS_PER_STEP['model']})")
        if device != "cpu" and per_step != TS_PER_STEP["model"]:
            raise AssertionError(f"Adafactor rank {r} per-step launches "
                                 f"{per_step}")
    log(f"  Adafactor on model=2: two processes "
        f"{' '.join(f'{x:.6f}' for x in got)}, one process "
        f"{' '.join(f'{x:.6f}' for x in losses)}: max relative difference "
        f"{max(rel):.3e}; the control (no sum over the peers) "
        f"{' '.join(f'{x:.6f}' for x in control[0]['losses'])}, "
        f"{max(ctl):.3e} (bound {TS_ADAFACTOR_REL_BOUND:.1e}); the losses "
        f"moved {moved:.3e}; cuts: {TS_ADAFACTOR_CUTS} [{card_line()}]")
    checks = {"within the bound": max(rel) <= TS_ADAFACTOR_REL_BOUND,
              "the control beyond it": max(ctl) > TS_ADAFACTOR_REL_BOUND,
              "the losses moved":
              moved >= TS_MOVE_FACTOR["model"] * TS_ADAFACTOR_REL_BOUND}
    if not all(checks.values()):
        raise AssertionError(f"Adafactor, 2 processes against 1: {checks}; "
                             f"relative {rel}, control {ctl}")
    return dict(losses=got, reference_losses=losses, max_rel=max(rel),
                control_losses=control[0]["losses"], control_max_rel=max(ctl),
                bound=TS_ADAFACTOR_REL_BOUND, moved=moved,
                launches={f"rank{r}": res["launches"]
                          for r, res in enumerate(sound)})


def ts_phase(torch, attn, root):
    """Phase 32: for the model axis (gpt_small_lm) and the spatial axis
    (maskrcnn_coco), the stack run and its one-process reference with the
    control, in ``root`` (phase 28a made the stack), and the Adafactor leg
    (:func:`ts_adafactor`), the three jobs at once (``at_once``); then,
    alone, the three kernels timed and held against their plain versions
    at the model axis's per-process shape."""
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p)
    torch.cuda.empty_cache()

    def job(name):
        stacked = ts_stack_train(torch, root, name)
        return dict(stack=stacked,
                    reference=ts_reference(torch, root, name, stacked))

    out = at_once([(name, lambda name=name: job(name)) for name in TS_JOBS]
                  + [("model_adafactor", lambda: ts_adafactor(torch, root))])
    torch.cuda.empty_cache()
    rows = time_training_kernels(torch, attn, TS_SHAPE, "gpt_tp_self",
                                 (20, 3, 5, 2))
    check_train_kernels(torch, attn, rows, TS_SHAPE)
    out["rows"] = rows
    return out


# Phase 33: cli train over the processes of this one host (ROADMAP A.10
# part 2f): phase 28's NMT config (full width, bf16, batch 128, dropout 0),
# 8 steps logged every 4, with train.step_window=4 against K = 1. On one
# card the 2 processes share it over gloo, whose host staging a capture
# cannot hold, so both run their steps eagerly: the same arithmetic, and
# the gap between them is the card's own run-to-run noise.
HOST_PROCS, HOST_STEPS, HOST_WINDOW = 2, 8, 4
HOST_OVERRIDES = [o for o in DP_OVERRIDES if "log_every" not in o] + [
    f"train.log_every_steps={HOST_WINDOW}"]
# 33a's bound on |K=4 loss - K=1 loss| / loss at the logged steps (4, 8),
# set between two readings of this cell on the card (NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md, phase 33): the two eager runs agreed bit for bit
# (0 at both steps), and the control, two processes with their gradients
# never summed, parted by 4.315e-4 at step 4 and 8.527e-4 at step 8. The
# K=1 losses moved 8.792e-4 from step 4 to step 8 (the warmup's first
# steps), so the bound is 5e-5 and the move factor 10 (5e-4). The check
# fails when a window skips, repeats or reorders a step, or its sums.
HOST_LOSS_REL_BOUND, HOST_MOVE_FACTOR = 5e-5, 10
HOST_BENCH_MB = 64


def host_train_start(root, name, window, accelerator="gpu",
                     processes=HOST_PROCS):
    """``cli train --processes N`` of phase 33's NMT config with
    ``train.step_window=window``, started in its own workdir; returns
    ``(process, workdir)``."""
    workdir = os.path.join(root, name)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning_cfn_tpu_torch.cli", "train",
         "--preset", "transformer_nmt_wmt", "--processes", str(processes),
         "--max-steps", str(HOST_STEPS), "--accelerator", accelerator,
         f"workdir={workdir}", *HOST_OVERRIDES,
         f"train.step_window={window}"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return proc, workdir


def host_train_finish(proc, workdir, backend, windows, accelerator="gpu",
                      processes=HOST_PROCS, timeout=600):
    """The result of :func:`host_train_start`'s job: exit 0 with process
    0's final metrics and the logs' place, every process's first line
    naming ``backend`` and ``windows``, each process's launches per step
    a one-process step's (18, 6, 6 on the card), and the logged losses by
    step."""
    try:
        out = proc.communicate(timeout=timeout)[0]
    finally:
        proc.kill()
    if proc.returncode != 0 or "job finished (restarts=0" not in out \
            or "[dlcfn-tpu] final metrics:" not in out:
        raise AssertionError(f"cli train --processes {processes}: rc "
                             f"{proc.returncode}\n{out[-4000:]}")
    run_dir = os.path.join(workdir, "transformer_nmt_wmt")
    launches = {}
    for r in range(processes):
        with open(os.path.join(run_dir, "logs",
                               f"attempt0-host{r}.log")) as fh:
            text = fh.read()
        first = next((ln for ln in text.splitlines()
                      if f"process {r}/{processes}: backend" in ln), "")
        if f"backend {backend}" not in first or windows not in first:
            raise AssertionError(f"rank {r}'s first line {first!r} names "
                                 f"no {backend} with {windows!r}")
        counts, steps = worker_launches(text, r)
        launches[f"rank{r}"] = counts
        per_step = {k: v / steps for k, v in counts.items()}
        log(f"  rank {r}: {first.split('] ', 1)[-1]}; launches over {steps} "
            f"steps {counts}")
        if accelerator == "gpu" and per_step != {k: PER_STEP[k]
                                                 for k in counts}:
            raise AssertionError(f"rank {r} per-step launches {per_step}")
    recs = read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    losses = {r["step"]: r["loss"] for r in recs if "loss" in r
              and "span" not in r and "final_eval_loss" not in r}
    if sorted(losses) != list(range(HOST_WINDOW, HOST_STEPS + 1,
                                    HOST_WINDOW)) \
            or not all(map(math.isfinite, losses.values())):
        raise AssertionError(f"logged losses {losses}")
    return dict(losses=losses, launches=launches)


def host_windows(torch, root, accelerator="gpu", backend="gloo",
                 windows="windows run eagerly (gloo)", name="33a"):
    """33a (33c over NCCL): ``cli train --processes 2`` with
    ``train.step_window=4`` and with K = 1, and the control, two processes
    fed the same global batches step by step with their gradients never
    summed (``--dp-worker``; eager, since its timed sum synchronizes the
    card), all three at once; the K = 4 losses within
    ``HOST_LOSS_REL_BOUND`` of K = 1 at the logged steps, the control
    beyond it, the losses moving by ``HOST_MOVE_FACTOR`` bounds."""
    from deeplearning_cfn_tpu_torch.config import apply_overrides
    from deeplearning_cfn_tpu_torch.presets import get_preset

    t0 = time.perf_counter()
    started = {k: host_train_start(root, f"{name}_k{k}", k, accelerator)
               for k in (HOST_WINDOW, 1)}
    cfg = apply_overrides(get_preset("transformer_nmt_wmt"),
                          HOST_OVERRIDES)
    path = os.path.join(root, f"{name}_batches.npz")
    save_batches(path, dp_batches(cfg, HOST_STEPS, HOST_PROCS))
    control = spawn_dp_workers(root, f"{name}_unsummed", dict(
        mode="fed", preset="transformer_nmt_wmt", batches=path,
        overrides=HOST_OVERRIDES, grad_sum="discard",
        accelerator=accelerator), ranks=HOST_PROCS)
    runs = {k: host_train_finish(proc, workdir, backend, windows,
                                 accelerator)
            for k, (proc, workdir) in started.items()}
    wall = time.perf_counter() - t0
    ref = runs[1]["losses"]
    steps = sorted(ref)
    rel = [abs(runs[HOST_WINDOW]["losses"][s] - ref[s]) / abs(ref[s])
           for s in steps]
    ctl = [abs(control[0]["losses"][s - 1] - ref[s]) / abs(ref[s])
           for s in steps]
    moved = abs(ref[steps[-1]] - ref[steps[0]]) / abs(ref[steps[0]])
    log(f"  K=1 losses at steps {steps}: {[f'{ref[s]:.6f}' for s in steps]}"
        f"; K={HOST_WINDOW}: relative {max(rel):.3e} (bound "
        f"{HOST_LOSS_REL_BOUND:.1e}); the control (gradients never "
        f"summed): {max(ctl):.3e}; moved {moved:.3e}; the three jobs at "
        f"once {wall:.1f} s [{card_line()}]")
    checks = {"within the bound": max(rel) <= HOST_LOSS_REL_BOUND,
              "the control beyond it": max(ctl) > HOST_LOSS_REL_BOUND,
              "the losses moved":
                  moved >= HOST_MOVE_FACTOR * HOST_LOSS_REL_BOUND}
    if not all(checks.values()):
        raise AssertionError(f"{name}: {checks}; relative {rel}, control "
                             f"{ctl}, moved {moved}")
    return dict(losses={k: r["losses"] for k, r in runs.items()},
                launches=runs[HOST_WINDOW]["launches"], max_rel=max(rel),
                bound=HOST_LOSS_REL_BOUND, control_max_rel=max(ctl),
                moved=moved, wall_s=wall)


def nccl_capture(torch):
    """33b: one process joins a one-rank NCCL group and captures, in one
    CUDA graph on a trainer's capture stream, the collective code a step
    runs across processes (``all_reduce_sum_``'s bucketed sum over two
    dtypes, ``global_total``) between device work before and after it;
    4 replays on fresh inputs equal the eager code's outputs bit for bit.
    One rank shows that this build's c10d calls into NCCL can be captured
    and replayed, not two ranks' sums (at one rank an in-place all-reduce
    moves nothing)."""
    import torch.distributed as dist

    from deeplearning_cfn_tpu_torch.parallel import collectives
    from deeplearning_cfn_tpu_torch.runtime.cluster import free_local_port
    from deeplearning_cfn_tpu_torch.train.graphs import GraphedStep

    dev = torch.device(DEVICE, torch.cuda.current_device())
    version = ".".join(map(str, torch.cuda.nccl.version()))
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                            f"{free_local_port()}", world_size=1, rank=0)
    try:
        gen = torch.Generator(device=dev)
        shapes = [((768, 768), torch.bfloat16), ((3072,), torch.float32),
                  ((512, 64), torch.bfloat16), ((17,), torch.float32)]

        def inputs(seed):
            gen.manual_seed(seed)
            return [torch.randn(s, generator=gen, device=dev).to(d)
                    for s, d in shapes] + [
                torch.randint(1, 100, (), generator=gen, device=dev)
                .float()]

        def body(xs):
            grads = [x * 0.5 + 1 for x in xs[:-1]]
            collectives._bucketed_sum_(grads)
            total = collectives._total(xs[-1])
            return [g / total for g in grads] + [total]

        static = inputs(0)
        stream = GraphedStep(dev).stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            body(static)  # the communicator exists before the capture
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            out = body(static)
        same = []
        for seed in range(1, 5):
            fresh = inputs(seed)
            for s, f in zip(static, fresh):
                s.copy_(f)
            graph.replay()
            want = body(fresh)
            same.append(all(torch.equal(a, b) for a, b in zip(out, want)))
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize(dev)
        names = [e.key for e in prof.key_averages()
                 if e.device_type.name == "CUDA"]
        # At one rank NCCL's in-place all-reduce has nothing to move and
        # launches no kernel (on the H100: none named nccl among a
        # replay's kernels), so this counts what the graph runs; it is
        # not asserted.
        kernels = dict(all=len(names),
                       nccl=sum("nccl" in n.lower() for n in names))
    finally:
        dist.destroy_process_group()
    log(f"  NCCL {version}: {len(shapes)} tensors in 2 buckets and a "
        f"global total captured in one graph on the capture stream; 4 "
        f"replays bit for bit the eager code: {same}; kernel names in one "
        f"replay's trace: {kernels} [{card_line()}]")
    if not all(same):
        raise AssertionError(f"NCCL capture replays differ: {same}")
    return dict(nccl_version=version, replays_equal=same, kernels=kernels)


def host_collectives_bench(root, accelerator="gpu"):
    """33d: ``parallel/collectives_bench.py`` on 2 processes sharing the
    card (gloo: host-staged numbers, not a link's), 64 MB."""
    proc = subprocess.run(
        [sys.executable, "-m",
         "deeplearning_cfn_tpu_torch.parallel.collectives_bench",
         "--processes", str(HOST_PROCS), "--accelerator", accelerator,
         "--size-mb", str(HOST_BENCH_MB),
         "--log-dir", os.path.join(root, "bench_logs")],
        cwd=root, capture_output=True, text=True, timeout=600)
    records = [json.loads(ln) for ln in proc.stdout.splitlines()
               if ln.startswith('{"op"')]
    if proc.returncode != 0 or [r["op"] for r in records] != [
            "psum", "all_gather", "psum_scatter", "ppermute"]:
        raise AssertionError(f"collectives_bench: rc {proc.returncode}\n"
                             f"{(proc.stdout + proc.stderr)[-4000:]}")
    for r in records:
        log(f"  {r['op']}: {r['ranks']} ranks, {r['payload_mb']} MB per "
            f"rank, {r['mean_time_s'] * 1e3:.3f} ms, busbw "
            f"{r['busbw_gbps']} GB/s (gloo, staged through the host)")
    log(f"  [{card_line()}]")
    return records


@contextlib.contextmanager
def first_card_only():
    """Processes started inside see only this machine's first card, so
    that two of them share it over gloo on a machine with more."""
    was = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = (was or "0").split(",")[0]
    try:
        yield
    finally:
        if was is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES")
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = was


def host_phase(torch, root):
    """Phase 33: 33a and 33d at once (``at_once``; their processes share
    the first card whatever the machine), then 33b, then 33c where the
    machine has 2 cards."""
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p)
    torch.cuda.empty_cache()
    with first_card_only():
        out = at_once([("33a", lambda: host_windows(torch, root)),
                       ("33d", lambda: host_collectives_bench(root))])
    steps = [("33b", lambda: nccl_capture(torch))]
    if torch.cuda.device_count() >= 2:
        steps.append(("33c", lambda: host_windows(
            torch, root, backend="nccl",
            windows="windows replay CUDA graphs", name="33c")))
    else:
        log("  33c not run: 1 card")
    for key, fn in steps:
        t = time.perf_counter()
        out[key] = fn()
        log(f"  {key} {time.perf_counter() - t:.1f} s")
        torch.cuda.empty_cache()
    return out


# Phase 34: the bench verb. 34a's records come from run_bench in this
# process (steps timed after the first step and the warm-up, as the CLI's
# bench does with its own defaults of 30 and 5); 34b's processes run beside
# phase 26's (they time nothing), 34a alone, 34c beside 34d's processes.
BENCH_STEPS, BENCH_WARMUP = 6, 1
BENCH_RUNS = (("nmt", dict(preset="transformer_nmt_wmt")),
              ("resnet50", dict(preset="imagenet_resnet50",
                                include_input=True)),
              ("nmt_window", dict(preset="transformer_nmt_wmt",
                                  step_window=WINDOW)))
BENCH_HBM = ("hbm_gib_peak", "hbm_gib_in_use", "hbm_gib_limit")


def _fleet_ok(r):
    return (r["dropped_requests"] == 0 and r["token_identical"] is True
            and r["goodput_sum_ok"] is True)


# 34b: the record contracts of ``cli bench`` as processes of their own
# (their exit code is part of the contract), each with its check.
BENCH_CLI = (
    ("serve", ["--serve", "--smoke"], lambda r: r["value"] > 0),
    ("serve_spec", ["--serve", "--speculate", "2", "--smoke"],
     lambda r: r["token_identical"] is True
     and r["tokens_per_target_step"] > 1),
    ("serve_int8", ["--serve", "--quantize", "int8", "--kv-quant", "int8",
                    "--smoke"],
     lambda r: r["weight_bytes"] <= 0.35 * r["weight_bytes_fp32"]
     and r["kv_cache_bytes"] <= 0.30 * r["kv_cache_bytes_fp32"]
     and r["divergence_ok"] is True and r["kv_divergence_ok"] is True),
    ("fleet", ["--fleet", "--smoke"], _fleet_ok),
    ("fleet_disagg", ["--fleet", "--smoke", "--fleet-prefill", "1",
                      "--fleet-decode", "1"],
     lambda r: _fleet_ok(r) and r["token_identical_colocated"] is True),
    ("fleet_burst", ["--fleet", "--smoke", "--trace", "burst",
                     "--autoscale"],
     lambda r: _fleet_ok(r) and r["scale_ups"] >= 1
     and r["replicas_final"] == r["min_replicas"]),
    ("fleet_net", ["--fleet", "--net", "--smoke"],
     lambda r: r["dropped_requests"] == 0 and r["token_identical"] is True
     and r["token_identical_disagg"] is True),
    ("obs", ["--obs-smoke", "--preset", "transformer_nmt_wmt", "--steps",
             "10"], lambda r: r["trace_valid"] is True),
)
# 34c: the op suites at their default shapes, in the JAX suites' order.
OPS_NAMES = ["resnet50_fwd_bwd", "resnet50_s2d_fwd_bwd",
             "backbone_rpn_fwd_bwd", "proposals_decode_topk_nms",
             "rpn_top_k", "nms_static", "roi_align_box_fwd_bwd",
             "roi_align_mask_fwd_bwd", "box_and_mask_heads_fwd_bwd",
             "full_loss_fwd_bwd", "sum_of_pieces"]


def bench_records(torch, attn):
    """34a: ``run_bench`` once for each of BENCH_RUNS, every count set to 0
    just before and read just after. Each record must be measured, on this
    card, with its memory keys and an MFU share in (0, 1]; the NMT's runs
    launch all three kernels (tc), a step's worth of each per step; the
    ResNet's none."""
    import gc

    from deeplearning_cfn_tpu_torch.bench import run_bench

    kind = torch.cuda.get_device_name(0)
    out = {}
    for label, kw in BENCH_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        set_counts(attn, 0)
        rec = run_bench(steps=BENCH_STEPS, warmup=BENCH_WARMUP, **kw)
        launched, by_variant = counts(attn), variant_counts(attn)
        log(f"  34a {label}: {json.dumps(rec)}")
        bad = [k for k in BENCH_HBM if k not in rec]
        if rec["measured"] is not True or not 0 < rec["mfu"] <= 1 \
                or rec["device_kind"] != kind or bad:
            raise AssertionError(f"34a {label}: a bad record (missing "
                                 f"{bad}): {rec}")
        window = rec["step_window"]
        steps = rec["steps"] + window * (1 + BENCH_WARMUP)
        if kw.get("include_input"):
            steps += rec["steps"] + window
        per_step = PER_STEP if kw["preset"] == "transformer_nmt_wmt" \
            else dict.fromkeys(PER_STEP, 0)
        expect = {k: v * steps for k, v in per_step.items()}
        log(f"  34a {label}: launches over {steps} steps {launched} "
            f"(expected {expect}), by variant {by_variant}")
        if launched != expect or any(
                by_variant[k]["tc"] != launched[k]
                for k in ("fwd", "dkdv", "dq")):
            raise AssertionError(f"34a {label}: launches {launched} "
                                 f"{by_variant} != {expect} (all tc)")
        out[label] = dict(record=rec, launches=launched,
                          variant_launches=by_variant)
    log(f"  [{card_line()}]")
    return out


def bench_cli(label, argv, check):
    """34b: one ``cli bench`` process; rc 0, the record's last line passing
    ``check``, and the parent process's kernel launches from its stderr
    line (a ``--net`` fleet's children count their own)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning_cfn_tpu_torch.cli", "bench",
         *argv], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=600)
    marker = "[dlcfn-tpu] bench kernel launches "
    lines = [ln for ln in proc.stderr.splitlines() if ln.startswith(marker)]
    if proc.returncode != 0 or not lines or not proc.stdout.strip():
        raise AssertionError(f"34b {label}: rc {proc.returncode}\n"
                             f"{(proc.stdout + proc.stderr)[-4000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    launches = json.loads(lines[-1][len(marker):])
    log(f"  34b {label}: {json.dumps(rec)}")
    log(f"  34b {label}: kernel launches in the bench process {launches}")
    if rec.get("device", "gpu") != "gpu" or not check(rec):
        raise AssertionError(f"34b {label}: the record's contract failed")
    return dict(record=rec, launches=launches)


def bench_ops(torch):
    """34c: ``bench --ops all --steps 3`` at the default shapes (ResNet-50
    at batch 512, 224²; Mask R-CNN's pieces at batch 4, 1024²)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    rc, out = cli_inprocess(["bench", "--ops", "all", "--steps", "3"])
    records = [json.loads(ln) for ln in out.splitlines()
               if ln.startswith('{"op"')]
    for r in records:
        log(f"  34c {json.dumps(r)}")
    if rc != 0 or [r["op"] for r in records] != OPS_NAMES \
            or not all(r["ms"] > 0 for r in records):
        raise AssertionError(f"34c: rc {rc}, ops {[r['op'] for r in records]}")
    log(f"  [{card_line()}]")
    return records


# 34d: ``cli bench --preset`` over the processes of this host, as a
# process of its own that launches them: two processes that share the one
# card over gloo (so the rate times the host's staging of the gradient
# sum, not a link), and one process, at the NMT's global batch 128 for
# BENCH_CARDS_STEPS timed steps (after the first step and run_bench's 4
# warm-ups, as the verb runs them).
BENCH_CARDS_STEPS, BENCH_CARDS_BATCH, BENCH_CARDS_WARMUP = 4, 128, 4


def bench_cards(processes, nmt_keys):
    """34d: ``cli bench --preset transformer_nmt_wmt --processes N``: rc 0,
    one record, ``n_chips`` and ``mesh.data`` N, 34a's NMT record's keys,
    and each process's three kernels launched a step's worth each step (as
    34a), all ``tc``, read from its own line (in its log with N > 1)."""
    import re

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning_cfn_tpu_torch.cli", "bench",
         "--preset", "transformer_nmt_wmt", "--processes", str(processes),
         "--global-batch", str(BENCH_CARDS_BATCH), "--steps",
         str(BENCH_CARDS_STEPS)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=600)
    label = f"34d --processes {processes}"
    records = [json.loads(ln) for ln in proc.stdout.splitlines()
               if ln.startswith("{")]
    if proc.returncode != 0 or len(records) != 1:
        raise AssertionError(f"{label}: rc {proc.returncode}, "
                             f"{len(records)} records\n"
                             f"{(proc.stdout + proc.stderr)[-4000:]}")
    rec = records[0]
    texts = [proc.stderr]
    if processes > 1:
        log_dir = re.search(r"logs in (\S+)\)", proc.stderr).group(1)
        texts = []
        for r in range(processes):
            with open(os.path.join(log_dir, f"attempt0-host{r}.log"),
                      errors="replace") as fh:
                texts.append(fh.read())
    marker = "[dlcfn-tpu] bench kernel launches "
    steps = rec["steps"] + 1 + BENCH_CARDS_WARMUP
    expect = {k: PER_STEP[k] * steps for k in ("fwd", "dkdv", "dq")}
    names = {"fwd": "flash_attn_fwd", "dkdv": "flash_attn_bwd_dkdv",
             "dq": "flash_attn_bwd_dq"}
    launches = {}
    for r, text in enumerate(texts):
        line = [ln for ln in text.splitlines() if ln.startswith(marker)][-1]
        got = json.loads(line[len(marker):])
        launches[f"rank{r}"] = got
        ok = all(got[names[k]] == v == got["variants"][names[k]]["tc"]
                 for k, v in expect.items())
        log(f"  {label} rank {r}: launches over {steps} steps "
            f"{ {k: got[n] for k, n in names.items()} } (expected {expect}, "
            f"all tc: {ok})")
        if not ok:
            raise AssertionError(f"{label} rank {r}: launches {got} != "
                                 f"{expect} (all tc)")
    log(f"  {label}: {json.dumps(rec)}")
    shared = " (two processes share one card over gloo: the rate times the " \
        "host's staging of the gradient sum, not a link)" \
        if processes > 1 else ""
    log(f"  {label}: {rec['value']} seq/s per card, step "
        f"{rec['mean_step_s'] * 1e3:.2f} ms (the slowest process's), "
        f"global batch {rec['global_batch']}{shared} [{card_line()}]")
    if rec["n_chips"] != processes or rec["mesh"]["data"] != processes \
            or set(rec) != nmt_keys or rec["measured"] is not True:
        raise AssertionError(f"{label}: a bad record {rec} (34a's keys "
                             f"{sorted(nmt_keys)})")
    return dict(record=rec, launches=launches)


def bench_cli_jobs():
    """34b's ``at_once`` jobs (run beside phase 26's)."""
    return [(f"34b {label}", lambda a=argv, c=check, n=label:
             bench_cli(n, a, c)) for label, argv, check in BENCH_CLI]


def bench_phase(torch, attn, cli_runs):
    """Phase 34: 34a alone, then 34c beside 34d's two processes (at
    once); ``cli_runs``, 34b's results (``{job label: result}``), join the
    record."""
    t = time.perf_counter()
    out = {"34a": bench_records(torch, attn)}
    log(f"  34a {time.perf_counter() - t:.1f} s")
    for label, run in cli_runs.items():
        log(f"  {label} (beside phase 26, {run['phase_s']:.1f} s): "
            f"launches {run['launches']}")
    out["34b"] = cli_runs
    set_counts(attn, 0)
    keys = set(out["34a"]["nmt"]["record"])
    # 34d's two runs one after the other: beside 34c's ResNet-50 at batch
    # 512 (~56 GiB) there is room for one of them at a time.
    runs = at_once([("34c", lambda: bench_ops(torch)),
                    ("34d", lambda: {f"processes={n}": bench_cards(n, keys)
                                     for n in (2, 1)})])
    out["34c"], out["34d"] = runs["34c"], runs["34d"]
    return out


def keep_bytecode() -> None:
    """Let this process and every process it starts cache the bytecode of
    what they import under the checkout's ``_build/pycache``. An
    environment that sets ``PYTHONDONTWRITEBYTECODE`` and ships no
    ``.pyc`` files makes each new process compile torch's ~1900 modules
    from source again (7.4 s of a worker's 25 s start on the H100's host);
    the cache leaves the installed packages untouched."""
    prefix = os.path.join(REPO, "deeplearning_cfn_tpu_torch", "_build",
                          "pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = prefix
    sys.dont_write_bytecode = False


def main() -> int:
    if sys.argv[1:2] == ["--dp-worker"]:
        return dp_worker(sys.argv[2], int(sys.argv[3]))
    profiles = {"--profile": profile_serving,
                "--profile-train": profile_training,
                "--profile-resnet": profile_resnet,
                "--profile-bert": profile_bert,
                "--profile-maskrcnn": profile_maskrcnn,
                "--profile-gpt": profile_gpt,
                "--profile-vit": profile_vit}
    wanted = [a for a in sys.argv[1:] if a in profiles]
    if wanted:
        import torch

        if not torch.cuda.is_available():
            return 2
        sys.path.insert(0, REPO)
        from deeplearning_cfn_tpu_torch import kernels

        log(card_line())
        kernels.build(kernels.KERNEL_NAMES)
        for flag in wanted:
            phase(f"profile ({flag}), bf16, full width")
            profiles[flag](torch)
        return 0
    if not os.path.isdir(os.path.join(REPO, "deeplearning_cfn_tpu_torch")):
        print("chip_smoke.py: run it from a checkout of the repository "
              "(deeplearning_cfn_tpu_torch/ not found)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    keep_bytecode()
    sys.path.insert(0, REPO)
    from deeplearning_cfn_tpu_torch import kernels
    from deeplearning_cfn_tpu_torch.ops import attention as attn

    script_t0 = time.perf_counter()
    t = phase("1. card")
    card = card_line()
    log(card)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t = phase("2. build kernels")
    paths = kernels.build(kernels.KERNEL_NAMES)
    build_s = time.perf_counter() - t
    log(f"  built {sorted(paths)} in {build_s:.2f} s")

    phase("3. kernel vs plain version")
    errs = check_kernel(torch, attn)

    phase("4. timing (bf16, 8 slots)")
    rows = time_kernel(torch, attn)

    phase("5. serve transformer_nmt_wmt (full width, bf16)")
    served = serve(torch, attn, make_requests())

    phase("6. f32: kernel vs plain version through the engine")
    logit_err, same, n_greedy = f32_parity(torch, make_requests())

    phase("7. backward kernels vs plain versions")
    bwd_errs = check_backward(torch, attn)

    phase("8. timing at the training shape (bf16, [128,8,128,64], causal)")
    train_rows = time_training_kernels(torch, attn)

    phase("9. train transformer_nmt_wmt (full width, bf16, batch 128)")
    trained = train(torch, attn)

    phase("10. f32 gradients: kernels vs plain attention (batch 16)")
    parity = grad_parity(torch, attn)
    after_nmt = counts(attn)

    phase("11. train imagenet_resnet50 (full width, bf16, batch 256)")
    resnet = train_resnet(torch)
    if counts(attn) != after_nmt:
        raise AssertionError("the ResNet path launched an attention kernel")

    phase("12. f32 cifar10_resnet20 (full width, batch 128): card vs CPU")
    cifar = cifar_parity(torch)

    phase("13. train bert_base_wikipedia (full width, bf16, batch 1024)")
    bert = train_bert(torch, attn)
    bert_row = time_forward_shape(torch, attn, "bert_self",
                                  BERT_BATCH // BERT_ACCUM, BERT_HEADS,
                                  BERT_SEQ, BERT_SEQ, 300, (20, 3, 10, 2))

    phase("14. checkpoint and resume on the card (BERT, 2 layers, f32)")
    resumed = resume_on_card(torch)

    phase("15. train maskrcnn_coco (full width, bf16, 1024², batch 8)")
    maskrcnn = train_maskrcnn(torch, attn)

    phase("16. f32 tiny Mask R-CNN: card vs CPU")
    maskrcnn_f32 = maskrcnn_parity(torch)

    phase("17. train gpt_small_lm (full width, bf16, batch 16 at 1024)")
    gpt = train_gpt(torch, attn)
    gpt_rows = time_training_kernels(torch, attn, GPT_SHAPE, "gpt_train_self",
                                     (20, 3, 5, 2))
    check_train_kernels(torch, attn, gpt_rows)

    phase("18. generate with gpt_small_lm (cli generate; f32 kernel vs "
          "plain)")
    generated = generate_gpt(torch, attn, gpt["workdir"])
    gpt_parity = gpt_generate_parity(torch, attn)
    decode_row = time_forward_shape(torch, attn, "gpt_decode", 1, GPT_HEADS,
                                    1, GPT_SEQ, 600, (200, 20, 100, 10))

    phase("19. speculative serving (full width, bf16, gamma 4)")
    spec = serve_speculative(torch, attn, make_requests())
    verify_rows = time_verify_shapes(torch, attn)

    phase("20. radix cache, chunked prefill and QoS (full width, bf16)")
    features = serve_features(torch, attn)

    phase("21. train imagenet_vit_s16 (full width, bf16, batch 1024 as "
          "4 x 256)")
    vit = train_vit(torch, attn)
    vit_rows = time_training_kernels(torch, attn, VIT_SHAPE,
                                     "vit_train_self", (50, 5, 10, 2),
                                     causal=False)
    check_train_kernels(torch, attn, vit_rows, VIT_SHAPE, causal=False)
    vit_f32 = vit_parity(torch, attn)

    phase("22. train bert_moe_wikipedia (full width, bf16, batch 1024)")
    bert_moe = train_bert(torch, attn, "bert_moe_wikipedia",
                          "smoke_bert_moe", MOE_CUTS)
    moe_f32 = moe_parity(torch, attn)

    phase("23. train bert_pipelined_wikipedia (full width on one card, "
          "bf16, batch 1024)")
    bert_pipe = train_bert(torch, attn, "bert_pipelined_wikipedia",
                           "smoke_bert_pipelined", PIPE_CUTS)

    phase(f"24. train.step_window={WINDOW}: K = 1 eager against K = "
          f"{WINDOW} CUDA graph replays (ViT-S/16 and NMT at full width, "
          f"bf16; the other presets tiny, f32)")
    windows = train_windows(torch, attn)

    phase("25. int8 weights and KV (full width, bf16)")
    int8 = serve_int8(torch, attn, make_requests(), served)

    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="smoke_launch_")
    try:
        phase("26. launched training: dry-run stack, train --stack, "
              "SIGKILL and resume, obs verbs, doctor (NMT full width, "
              "bf16); beside them phase 34b's cli bench record contracts "
              "and phase 25's cli serve with int8 and text")
        launched = launched_path(
            torch, trained, root, beside=bench_cli_jobs() + [
                ("25 cli", int8_cli)])
        bench_cli_runs = launched.pop("beside")
        int8["cli"] = bench_cli_runs.pop("25 cli")

        phase("27. the fleet: disaggregated prefill/decode, route, "
              "rollout, fleet up and fleet up --net (NMT full width, "
              "bf16; the net children the tiny recipe)")
        fleet = fleet_phase(torch, attn, root, served, int8, make_requests())

        phase("28. data parallel across processes: train --stack on 2 "
              "hosts (NMT full width, bf16) against one process, "
              "mesh-wide BatchNorm, ZeRO-1 kill and resume, ResNet-50 "
              "on 2 processes")
        dp = dp_phase(torch, root)

        phase("29. the long presets on one process: bert_long_wikipedia "
              "at 4096 and gpt_long_lm at 16384 (full width, bf16), cli "
              "generate, the kernels at both shapes")
        long = long_phase(torch, attn)

        phase("30-31. the seq axis across 2 processes: train --stack with "
              "mesh.seq=2, bert_long (ring) and gpt_long (Ulysses) at "
              "4096 against one process; beside them the pipe and expert "
              "axes across 4 processes: train --stack of bert_pipelined on "
              "pipe=4 and bert_moe on expert=4 (full width, bf16) against "
              "one process")
        torch.cuda.empty_cache()
        runs = at_once(seq_jobs(torch, root) + pe_jobs(torch, root))
        seq = {name: runs[name] for name in SEQ_JOBS}
        pipe_expert = {name: runs[name] for name in PE_JOBS}

        phase("32. the model and spatial axes across 2 processes: train "
              "--stack of gpt_small_lm with mesh.model=2 and of "
              "maskrcnn_coco on its spatial=2 mesh (full width, bf16), and "
              "gpt_small_lm under Adafactor on model=2, against one "
              "process")
        model_spatial = ts_phase(torch, attn, root)

        phase("33. cli train over the processes of this host: "
              "--processes 2 with train.step_window=4 against K = 1 "
              "(NMT full width, bf16), NCCL under capture, "
              "collectives_bench")
        host = host_phase(torch, root)

        phase("34. the bench verb on the card: run_bench (NMT; ResNet-50 "
              "with its input; NMT with train.step_window=4), cli bench's "
              "record contracts (serve, fleet, net, obs), bench --ops all "
              "beside cli bench --preset over 2 processes and over 1")
        benched = bench_phase(torch, attn, bench_cli_runs)
        end_phase()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for row in (served, int8):
        row.pop("tokens_by_request")

    # The forward kernel serves every path: its numbers cover the three
    # serving shapes, the NMT training shape, BERT's, GPT's train shape,
    # GPT's decode step, the verify span over the dense cache and the
    # paged span, and ViT's train shape (one call at each; BERT-MoE's and
    # the pipelined trunk's attention calls are BERT's shape).
    long_rows = [long["rows"][label] for label in ("long_bert_self",
                                                   "long_gpt_self")]
    rows = rows + [train_rows["flash_attn_fwd"], bert_row,
                   gpt_rows["flash_attn_fwd"], decode_row] + verify_rows \
        + [vit_rows["flash_attn_fwd"]] \
        + [r["flash_attn_fwd"] for r in long_rows] \
        + [model_spatial["rows"]["flash_attn_fwd"]]
    timings = ("kernel_ms_before", "device_ms", "device_ms_strided",
               "device_ms_before", "plain_ms", "bound_ms", "library_ms",
               "library_device_ms")
    fwd_paths = {"serve": (served["launches"], served["variant_launches"]),
                 "train": (trained["launches"]["fwd"],
                           trained["variant_launches"]["fwd"]),
                 "bert": (bert["launches_with_eval"]["fwd"],
                          bert["variant_launches_with_eval"]["fwd"]),
                 "gpt_train": (gpt["launches_with_eval"]["fwd"],
                               gpt["variant_launches_with_eval"]["fwd"]),
                 "gpt_generate": (generated["launches"],
                                  generated["variant_launches"]),
                 "features": (features["launches"],
                              features["variant_launches"]),
                 "vit_train": (vit["launches_with_eval"]["fwd"],
                               vit["variant_launches_with_eval"]["fwd"]),
                 "bert_moe": (bert_moe["launches_with_eval"]["fwd"],
                              bert_moe["variant_launches_with_eval"]["fwd"]),
                 "bert_pipelined": (
                     bert_pipe["launches_with_eval"]["fwd"],
                     bert_pipe["variant_launches_with_eval"]["fwd"]),
                 "vit_window": (windows["vit_run"]["launches"]["fwd"],
                                windows["vit_run"]["variant_launches"]["fwd"]),
                 "nmt_window": (windows["nmt_run"]["launches"]["fwd"],
                                windows["nmt_run"]["variant_launches"]["fwd"])}
    for name, run in spec["runs"].items():
        fwd_paths[f"spec_{name[0]}"] = (run["launches"],
                                        run["variant_launches"])
    fwd_paths["int8"] = (int8["launches"], int8["variant_launches"])
    fwd_paths["int8_spec"] = (int8["spec"]["launches"],
                              int8["spec"]["variant_launches"])
    for name in ("disagg", "disagg_int8"):
        for rep, tally in fleet[name]["replicas"].items():
            fwd_paths[f"{name}_{rep.split('-')[0]}"] = (
                tally["launches"],
                {v: tally[v] for v in served["variant_launches"]})
    for verb in ("route", "rollout"):
        row = fleet["route_rollout"][verb]
        fwd_paths[f"fleet_{verb}"] = (row["launches"],
                                      row["variant_launches"])
    for name in ("bert", "gpt"):
        fwd_paths[f"long_{name}"] = (long[name]["launches"]["fwd"],
                                     long[name]["variant_launches"]["fwd"])
    fwd_paths["long_gpt_generate"] = (long["generate"]["launches"],
                                      long["generate"]["variant_launches"])
    for label, run in benched["34a"].items():
        fwd_paths[f"bench_{label}"] = (run["launches"]["fwd"],
                                       run["variant_launches"]["fwd"])
    # 34b's cli bench processes count their own launches, apart from the
    # total (as the children of phase 27 do).
    bench_cli_launches = {
        name: {f"launches_bench_cli_{label.split()[-1]}": run["launches"][
            name] for label, run in benched["34b"].items()}
        for name in ("flash_attn_fwd", "flash_attn_bwd_dkdv",
                     "flash_attn_bwd_dq")}
    # 34d's processes, each from its own line (apart from the total).
    cards = {leg: run for leg, run in benched["34d"].items()
             if leg != "phase_s"}
    bench_cards_launches = {
        name: {f"{leg} {rank}": got[name] for leg, run in cards.items()
               for rank, got in run["launches"].items()}
        for name in ("flash_attn_fwd", "flash_attn_bwd_dkdv",
                     "flash_attn_bwd_dq")}
    fwd = {
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "deeplearning_cfn_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "deeplearning_cfn_tpu/ops/attention.py:96 "
                    "(_flash_kernel, launched by _flash_forward at :291)",
        "launches": sum(n for n, _ in fwd_paths.values()),
        **{f"launches_{path}": n for path, (n, _) in fwd_paths.items()},
        **bench_cli_launches["flash_attn_fwd"],
        "variant_launches": {
            v: sum(by[v] for _, by in fwd_paths.values())
            for v in served["variant_launches"]},
        "max_abs_err": max(max(errs.values()), bert_row["max_abs_err"],
                           gpt_rows["flash_attn_fwd"]["max_abs_err"],
                           decode_row["max_abs_err"],
                           *(r["max_abs_err"] for r in verify_rows),
                           vit_rows["flash_attn_fwd"]["max_abs_err"],
                           *(r["flash_attn_fwd"]["max_abs_err"]
                             for r in long_rows),
                           model_spatial["rows"]["flash_attn_fwd"][
                               "max_abs_err"]),
        "max_abs_err_f32": errs["float32"],
        "max_abs_err_bf16": max(errs["bfloat16"], bert_row["max_abs_err"],
                                gpt_rows["flash_attn_fwd"]["max_abs_err"],
                                decode_row["max_abs_err"],
                                *(r["max_abs_err"] for r in verify_rows),
                                vit_rows["flash_attn_fwd"]["max_abs_err"],
                                *(r["flash_attn_fwd"]["max_abs_err"]
                                  for r in long_rows),
                                model_spatial["rows"]["flash_attn_fwd"][
                                    "max_abs_err"]),
        "ms": sum(r["kernel_ms"] for r in rows),
        **{key: sum(r[key] for r in rows) for key in timings},
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
        else "operations",
        # Launched in child processes (phase 27d/27e), read from each
        # child's log; not part of "launches".
        "child_launches": {
            "fleet_up": {r: c["launches"] for r, c in
                         fleet["fleet_up"]["children"].items()},
            "fleet_up_net": {r: c["restarted"] for r, c in
                             fleet["fleet_up_net"]["replicas"].items()},
            # Phase 28a's two train --stack processes, over their steps
            # after the first; phase 30's likewise (the ring launches no
            # kernel: its blocks are plain products).
            "dp_train": {r: c["fwd"] for r, c in
                         dp["28a"]["launches"].items()},
            **{f"seq_{name}": {r: c["fwd"] for r, c in
                               seq[name]["stack"]["launches"].items()}
               for name in SEQ_JOBS},
            # Phase 31's four train --stack processes of each job, over
            # their steps after the first; phase 32's two likewise.
            **{f"pipe_expert_{name}": {
                r: c["fwd"] for r, c in
                pipe_expert[name]["stack"]["launches"].items()}
               for name in PE_JOBS},
            **{f"model_spatial_{name}": {
                r: c["fwd"] for r, c in
                model_spatial[name]["stack"]["launches"].items()}
               for name in TS_JOBS},
            "model_spatial_model_adafactor": {
                r: c["fwd"] for r, c in
                model_spatial["model_adafactor"]["launches"].items()},
            "bench_cards": bench_cards_launches["flash_attn_fwd"]},
        "shapes": rows,
    }
    if sum(fwd["variant_launches"].values()) != fwd["launches"]:
        raise AssertionError(f"forward variants {fwd['variant_launches']} "
                             f"do not sum to {fwd['launches']} launches")
    replaces = {
        "flash_attn_bwd_dkdv": "deeplearning_cfn_tpu/ops/attention.py:344 "
                               "(_flash_bwd_dkdv_kernel, launched by "
                               "_flash_backward at :490)",
        "flash_attn_bwd_dq": "deeplearning_cfn_tpu/ops/attention.py:402 "
                             "(_flash_bwd_dq_kernel, launched by "
                             "_flash_backward at :511)",
    }
    records = [fwd]
    for name, key in (("flash_attn_bwd_dkdv", "dkdv"),
                      ("flash_attn_bwd_dq", "dq")):
        # The NMT training shape, GPT's, ViT's, the two long ones and
        # GPT's per-process shape on the model axis, one call at each.
        shapes = [train_rows[name], gpt_rows[name], vit_rows[name],
                  *(r[name] for r in long_rows),
                  model_spatial["rows"][name]]
        paths = {"train": trained, "gpt_train": gpt, "vit_train": vit,
                 "vit_window": windows["vit_run"],
                 "nmt_window": windows["nmt_run"],
                 "long_bert": long["bert"], "long_gpt": long["gpt"],
                 **{f"bench_{label}": run
                    for label, run in benched["34a"].items()}}
        records.append({
            "name": name, "route": "cuda",
            "source": f"deeplearning_cfn_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": sum(r["launches"][key] for r in paths.values()),
            **{f"launches_{path}": r["launches"][key]
               for path, r in paths.items()},
            **bench_cli_launches[name],
            "variant_launches": {
                v: sum(r["variant_launches"][key][v]
                       for r in paths.values())
                for v in trained["variant_launches"][key]},
            "max_abs_err": max(bwd_errs[name],
                               gpt_rows[name]["max_abs_err"],
                               vit_rows[name]["max_abs_err"],
                               *(r[name]["max_abs_err"] for r in long_rows),
                               model_spatial["rows"][name]["max_abs_err"]),
            "ms": sum(r["kernel_ms"] for r in shapes),
            **{t: sum(r[t] for r in shapes) for t in timings},
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in shapes) else "operations",
            # library_ms: SDPA's backward, one call giving dq, dk and dv.
            "child_launches": {
                "dp_train": {r: c[key] for r, c in
                             dp["28a"]["launches"].items()},
                **{f"seq_{job}": {r: c[key] for r, c in
                                  seq[job]["stack"]["launches"].items()}
                   for job in SEQ_JOBS},
                **{f"pipe_expert_{job}": {
                    r: c[key] for r, c in
                    pipe_expert[job]["stack"]["launches"].items()}
                   for job in PE_JOBS},
                **{f"model_spatial_{job}": {
                    r: c[key] for r, c in
                    model_spatial[job]["stack"]["launches"].items()}
                   for job in TS_JOBS},
                "model_spatial_model_adafactor": {
                    r: c[key] for r, c in
                    model_spatial["model_adafactor"]["launches"].items()},
                "bench_cards": bench_cards_launches[name]},
            "shapes": shapes,
        })
        if sum(records[-1]["variant_launches"].values()) \
                != records[-1]["launches"]:
            raise AssertionError(f"{name}: variants do not sum to launches")
    summary = {
        "build_s": build_s,
        "serve": served,
        "f32_first_step_logit_max_abs_diff": logit_err,
        "f32_greedy_token_identical": f"{same}/{n_greedy}",
        "train": trained,
        "f32_grad_parity": parity,
        "resnet50_train": resnet,
        "resnet20_f32_card_vs_cpu": cifar,
        "bert_base_train": bert,
        "bert_resume": resumed,
        "maskrcnn_train": maskrcnn,
        "maskrcnn_f32_card_vs_cpu": maskrcnn_f32,
        "gpt_small_train": gpt,
        "gpt_small_generate": generated,
        "gpt_small_f32_generate_parity": gpt_parity,
        "spec_serve": spec,
        "radix_chunk_qos_serve": features,
        "vit_s16_train": vit,
        "vit_tiny_f32_card_vs_cpu": vit_f32,
        "bert_moe_train": bert_moe,
        "moe_tiny_f32_card_vs_cpu": moe_f32,
        "bert_pipelined_train": bert_pipe,
        "step_window": windows,
        "int8_serve": int8,
        "launched_training": launched,
        "fleet": fleet,
        "data_parallel": dp,
        "long_presets": long,
        "seq_parallel": seq,
        "pipe_expert_parallel": pipe_expert,
        "model_spatial_parallel": {k: v for k, v in model_spatial.items()
                                   if k != "rows"},
        "host_processes": host,
        "bench": {"34a": {k: v["record"] for k, v in benched["34a"].items()},
                  "34b": {k: v["record"] for k, v in benched["34b"].items()},
                  "34c": benched["34c"],
                  "34d": {k: v["record"] for k, v in cards.items()}},
        "phase_s": PHASE_S,
        "script_s": time.perf_counter() - script_t0,
    }
    log(json.dumps({"summary": summary}))
    log(f"whole script {summary['script_s']:.1f} s")
    log(card)
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
