#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # every phase, as a release check runs it

Phases, numbered as they are described; any failure exits nonzero and
nothing is swallowed. They run in this order but for phase 3, which
runs after phase 11: the serving phases (4-11) launch K1 and K2 alone,
so they run while ``flash_bwd`` (K3/K4, the slowest file) still
compiles.

Depth: every llama3-8b path runs at full width on cut depth, as the
smoke's 1200 s limit on the slowest host asks: the serve and contig
phases at ``SERVE_LAYERS`` (16) of 32 layers, the handoff, bench, qos,
adapters, draft, recover and observe phases at ``CUT_LAYERS`` (8).

1. The card's name and power limit (``nvidia-smi``).
2. Build: every hand-written kernel of ``skypilot_tpu_torch/csrc`` with
   ``nvcc`` for ``sm_90a``, one process per source, all started at
   once; ``paged_attention`` and ``flash_fwd`` are waited for before
   phase 4, ``flash_bwd`` before phase 3; ptxas's registers and spills
   per kernel function.
3. Kernels: each kernel against its plain PyTorch version on the same
   CUDA inputs at its main path's shapes (K1/K2 serving, K3/K4 the
   llama3-1b training shape; K2, K3 and K4 also at the QLoRA-8B
   recipe's, batch 2 x 2048 over 32 q-heads and 8 kv-heads, and at the
   models phase's: moe-small's 4 x 2048 over 8 q-heads and 4 kv-heads,
   and ViT-S/16's 64 x 197, 6 q-heads over 6, head_dim 64,
   bidirectional), with its
   time (CUDA events over many
   launches), its bound (the larger of bytes over the memory rate and
   operations over the peak rate), the plain version's time and, where
   one PyTorch call computes the same function, that call's time; each
   line adds the achieved TFLOP/s, the share of the bound reached and
   the time over the library call's. The flash kernels' bf16 outputs
   are held per element to one bf16 ulp of the plain value plus 1e-3 of
   its largest magnitude, their float32 outputs and the logsumexp to
   1e-4 of it; K1's partial sums to 2e-3 of it, its length-0 slots
   exactly. K1 (which merges a slot's chunks inside its own launch) and
   the bf16 K3/K4 must give equal bits on a second call. K1 also runs a
   long-context case after the main path's (16 slots of 3000-4096 rows)
   and an int8 case at the int8 serve leg's shape (32 slots of int8
   pools, spans to 1280).
   K1's multi-row bodies (``paged_attention_rows``): the ``wgmma`` one
   runs at the serve chunk's shape (2048 query rows of a kv-head over
   the 512 rows below the chunk), at a chunk's start of 0, at two
   chunks of an 8192-token prompt (starts 3584 and 7680, on pools of 4
   layers whose K/V, cycled over the layers, exceeds the 50 MB L2) and
   at the serve chunk on int8 pools; the ``mma.sync`` one at the serve chunk
   on float32 pools; each case must run its own body only. SDPA over
   the same K/V, gathered, is printed beside each as a
   yardstick (no PyTorch call returns the unnormalized stats). A K1
   call takes less device time than its wrapper takes on the host, so
   its time comes from replaying 64 launches from a CUDA graph; the
   eager loop's time and the host's time per call are printed beside
   it.
4. Serve: the port's HTTP server (``infer/server.py``) at llama3-8b
   full width on ``SERVE_LAYERS`` layers with random bf16 weights from a fixed seed, in
   the reference server's default configuration (chunks of 512, a
   prefix pool of 8, n-gram speculation at K = 4), answers 9 concurrent
   ``/generate`` requests, two of them streamed twins of a chunked and
   of a wave prompt; prompts longer than 512 tokens go through chunked
   prefill. The kernels' launch counts and the engine's drafted,
   accepted and verify counts are set to 0 just before and read just
   after (at least one verify round must run; the ``wgmma`` multi-row
   body must launch once a layer per chunk not skipped by a prefix hit
   and the ``mma.sync`` one never, and trailers report the chunks).
   Then a shared-prefix pair (820 and 760 tokens sharing 600), one
   after the other: the first reports no hit and 2 chunks, the second
   a 512-token hit and 1 chunk (32 multi-row launches from start 512
   over the first's blocks); the second again after
   ``clear_prefix_cache()`` is its cold rerun (TTFT and any bf16
   divergence reported). One 512-token chunk of a
   long prompt at starts 3584 and 7680 of a one-slot cache of max_len
   8192 is timed (wall, and from one profiled chunk the device time of
   the multi-row body, of matmul and of the rest); two
   prompts (one chunked) are replayed through
   an engine that runs the plain attention versions on the same card
   beside one that runs the kernels, in bf16 (divergence reported) and
   on the first ``CUT_LAYERS`` (8) layers of the same weights in
   float32, where greedy tokens must agree
   wherever the plain logits' top-2 gap exceeds 1e-2. The float32 leg
   reads float32 pools, so its chunks run the ``mma.sync`` multi-row
   body: counts set to 0 before that leg and read after it, that body
   must launch once a layer per chunk and the ``wgmma`` one never. On
   the same float32 weights, kernel path: spec K 4 with an oracle
   drafter (every position accepts) and with an anti-oracle (none
   does) must give the spec-off tokens, and the prefix pair's warm
   request its cold rerun's, under the same 1e-2 rule. Two float32 int8
   legs repeat the kernel-against-plain, spec and prefix checks over int8
   KV pools on the first 8 layers (their chunks run the
   ``wgmma`` body on int8 pools, counted from 0): on the float32
   weights, under the 1e-2 rule, and on the same weights quantized once
   (w8a8), where the bound is the larger of 1e-2 and the plain logits'
   own shift on that context when the embedding moves by two float32
   ulps (w8a8 rounds activations to int8, so float32-sized noise moves
   its logits by ~0.2). The int8 leg (``serve[int8]``) then serves the
   reference's int8 recipe, ``llm/serve-8b-w8a8.yaml`` (32 slots,
   max_len 1280,
   ``--kv-int8 --weights-int8``, max burst 32, waves of 4), at llama3-8b
   full width on ``SERVE_LAYERS`` layers: int8 pools with bf16 scales, only the slim
   float tree resident (``memory_allocated`` held to the slim weights,
   the int8 weights and the int8 KV), the same 9 requests and prefix
   pair under the same checks, TTFT and decode rate beside the bf16
   leg's, one profiled decode burst over all 32 slots split into
   ``torch._int_mm``, the quantizers, K1 and the rest, and
   ``torch._int_mm`` timed at the recipe's shapes with the weight
   column-major (as stored) and row-major.
5. Handoff: the cross-replica KV handoff of disaggregated serving
   between two HTTP servers on the card, a prefill tier P and a decode
   tier D on one params tree: llama3-8b bf16 at ``CUT_LAYERS`` (8)
   layers in the serve phase's settings, the int8 recipe at 8 layers
   (32 slots, max_len 1280, quantized once) and float32 on the first 8
   layers. The single
   tier first (prompts of 775 and 597 tokens, 16 new tokens, on D's
   ``/generate``), then, launch counts set to 0, each prompt's
   ``/prefill`` on P and its ``/handoff`` on D, blocking and streamed,
   D's prefix cache cleared before each: every handoff imports the
   512-row prefix and resumes over it (``resumed_len`` 512, one prefix
   hit), the tokens agree with the single tier's under the serve
   phase's rules, a 491-token prompt gets the typed 409, each tier
   holds only its resident entries' blocks, K1's decode body and the
   multi-row body the pools pick launch (``wgmma`` on bf16 and int8,
   ``mma.sync`` on float32, never the other), K1 is held against its
   plain version at every shape of the leg and, with the trash block
   filled with 100.0, on D's imported blocks. Export, encode, wire,
   decode and import times, ``/prefill`` wall and the time to the
   first streamed decode token are printed beside the single tier's
   TTFT and decode rate.
6. Bench: the port's serving bench (``infer/bench_serve.py``) at
   llama3-8b full width on ``CUT_LAYERS`` layers, bf16, random weights
   from seed 0,
   through its own functions, launch counts set to 0 before each leg
   and read after it: ``run_http`` (8 streamed requests of mixed
   512-1024-token prompts over HTTP, 32 new tokens, two timed waves
   after a warmup wave; every response 200 with 32 tokens, finite
   positive TTFT, p99 TTFT, tokens/s and TPOT), ``run`` (16 requests of
   96 tokens on the engine alone, 64 tokens each) and
   ``run_prefix_share`` at its full-size shapes (a 768-token system
   prompt, 48-token tails, chunks of 256) with 6 requests of 24 new
   tokens (the reference's 12 and 48, cut for time): no cold hit,
   every warm request a hit of one suffix chunk, fewer chunks than
   cold, interference bursts run; where warm and cold tokens part,
   each divergence is held to the serve phase's 1e-2 top-2 gap rule,
   the gap read from the plain path on the weights in float32 and the
   floor raised to the bf16 noise on that context). The bench keeps
   the reference's max_len, so on the card its KV blocks are 8 rows
   (the engine's choice for K1). Each leg prints its report line; K1's
   decode and ``wgmma`` multi-row bodies and K2 must launch, the
   ``mma.sync`` body never; after each leg, K1 and K2 are held against
   their plain versions at every shape the leg gave them (random
   inputs, the leg's tables, lengths and spans). The kernels phase
   times K1 and K2 at the bench's main shapes.
7. QoS: multi-tenant scheduling, preemption, per-tenant KV quotas,
   lazy KV growth and the operator routes at llama3-8b, launch counts
   set to 0 before each leg and read after it. (a) The port's
   ``bench_serve.run_qos`` at the reference's chip defaults (8 slots,
   max_len 256, 2 background requests; bf16, ``CUT_LAYERS``) but for 12 hot
   requests and 32 new tokens (the reference's 24 and 64, cut for
   time): its report line; every preemption cycle
   preempts and resumes warm, WFQ admits the background tenant ahead of
   the flood where FIFO strands it, and wherever its scheduling or
   preemption parity parts, the tokens part under the bf16 floor rule.
   (b) The HTTP server at the reference server's defaults plus
   ``--kv-lazy``, with ``SKYTPU_QOS=1`` and two tenants (``hog``:
   burst 2 and one KV block; ``vip``: a lane above the default), in
   bf16 at ``CUT_LAYERS`` (8) layers and in float32 on the first 8: a quota
   stall, a typed 429 with Retry-After, a preemption of one of 16
   streamed 740-token requests whose tokens agree with its unpreempted
   twin's (float32: wherever the plain top-2 gap exceeds 1e-2; bf16:
   the bf16 floor rule), a ``/drain`` lifecycle (typed 503, /healthz
   draining, the in-flight request finishes), and ``/metrics`` deltas:
   the TTFT count grows by the requests answered, the shed,
   quota-stall, preemption and lazy-growth counters by what the leg
   caused. (c) K1 against its plain version, the trash block at 100.0,
   at the first resume chunk after a preemption and on a decode burst
   over lazily grown tables with a slot sitting out.
8. Adapters: multi-LoRA serving at llama3-8b, launch counts set to 0
   before each leg and read after it. Eight rank-16 fine-tunes from
   seeded numpy (``bench_serve.adapter_tree``) are written by the port's
   ``save_adapter`` into a temporary directory (~55 MB each), with one
   corrupt entry. (a) The HTTP server through ``make_engine`` (bf16,
   ``CUT_LAYERS``, the reference server's defaults) with ``--adapters`` and
   ``--adapter-slots 5`` (four fine-tunes resident, so the traffic
   evicts): 16 concurrent ``/generate`` requests, 12 under the eight
   fine-tunes (the body's ``model`` or the ``x-skytpu-model`` header)
   and 4 of the base model, 16 new tokens each; every trailer names
   its model and a fine-tune parts from the base on a shared prompt; an
   unknown name is the typed 404 blocking and streamed; the corrupt entry the typed 503
   and, streamed, a typed error chunk; ``/metrics`` counts at least 8
   loads and 4 evictions. Then K1 is held against its plain version
   (trash block at 100.0) at an adapter request's first chunk over
   cached rows and on a decode burst whose slots run two fine-tunes and
   the base, and K2 on a wave mixing them. (b) ``/prefill`` then
   ``/handoff`` under one fine-tune between two port replicas: the
   wire's salt is the fine-tune's content digest, D imports 512 rows
   under it and hits. (c) ``bench_serve.run_adapters`` (rank 16, 8
   fine-tunes, 8 requests of 128 tokens, 16 new): TPOT single and
   mixed, ``overhead_ratio`` (recorded, not gated), hot loads and
   evictions. Where (b) or (c)'s bf16 tokens part from their reference
   (single tier; sequential runs), the serve phase's bf16 floor rule
   holds them, the references carrying the fine-tunes. (d) Float32 on
   the first 8 layers: zero-adapter tokens equal the adapterless
   engine's, and a mixed batch under the base, ft-0 and ft-1 agrees with
   the sequential runs wherever the plain top-2 gap exceeds 1e-2.
9. Draft: the draft model and the async draft/verify pipeline, launch
   counts set to 0 before each leg and read after it, K1's split into
   the target's and the draft's. (a) llama3-8b full width on
   ``CUT_LAYERS`` layers, bf16, 16 slots, max_len 1024, spec K 4,
   target and draft from ``draft.self_distilled_pair(params, cfg, 4)``: 8 requests of 98-775
   tokens (two chunked), 48 new tokens each, spec-off, then the model
   drafter pipelined, then synchronous; per leg acceptance (> 0.8 in
   bf16), the draft engine's counters, TPOT and the overlap/verify wall
   ratio, and, pipelined, whether each predraft had finished on the
   card when the host fetched it and how long that fetch waited; every
   request on the model rung, predrafts reused and dispatched before
   every pipelined fetch, none synchronous, both pools drained; the
   draft's rollouts and ingest chunks on K1's decode and ``wgmma``
   bodies; tokens that part from spec-off held to the bf16 floor rule
   on the distilled target. (b) float32 on the first 8 layers, the
   draft ``self_distilled_pair(..., 4)``, pipelined and synchronous on
   float32 and on int8 pools, and a random 1-layer draft (acceptance
   near 0, rollbacks > 0): tokens equal spec-off wherever the plain
   top-2 gap exceeds 1e-2. (c) The HTTP server through ``make_engine``
   with ``--draft-model llama3-400m --spec-pipeline 1`` (the 400m at
   full width and depth with the 8B's vocabulary): 4 requests, one
   streamed; the trailers' drafter rungs (a random draft demotes) and
   ``skytpu_spec_draft_tokens_total{drafter="model"}`` > 0 in
   ``/metrics``. (d) K1 against its plain version on the draft engines'
   own inputs (their trash blocks at 100.0): the 8B draft's rollout (8
   kv-heads, 4 rows) and ingest chunk (1024 rows), the 400m's (4
   kv-heads, 3 rows; 768 rows), timed as in the kernel phase. (e) K1
   decode launches on two CUDA streams at once, each equal to its plain
   version (the ticket counters are per stream). (f)
   ``bench_serve.run_spec`` at llama3-8b, 8 requests of 24 new tokens
   (the reference's 256, cut for time; its warm-up passes run 10 new
   tokens): its report line and its pipeline structure.
10. Recover: crash recovery on the serve engine at llama3-8b bf16 (full
   width at ``CUT_LAYERS``, 8, layers; 16 slots, max_len 1024, blocks of 256, chunks of 512, a prefix pool of
   8, n-gram spec K 4), launch counts set to 0 before each leg and read
   after it: 8 requests (``RECOVER_LENS``, two chunked) of 24 new
   tokens, the uninterrupted twin, then one run per seeded fault of
   ``RECOVER_FAULTS`` (the admit, chunk, verify and decode dispatch
   seams and a KV block claim), each recovered through
   ``InferenceEngine.recover``: the fault fires and recovers once, a
   victim counts its recovery, every request returns its budget, the
   pool drains after ``clear_prefix_cache()``, and tokens that part
   from the twin's are held to the bf16 floor rule. K1 is held against
   its plain version (trash block 100.0) at the first resume chunk
   after the verify crash that reads cached rows. The HTTP server
   streams 4 requests through one verify fault: every stream ends with
   its budget, the trailers count the recovery and ``/metrics``'
   ``skytpu_engine_recoveries_total`` moves by exactly 1. Float32 on
   the first 8 layers: chunk and verify faults, and a 4-layer
   self-distilled draft pipelined with the fault at a verify while a
   predraft is pending; tokens equal the twin's wherever the plain
   top-2 gap exceeds 1e-2.
11. Observe: the observability stack on a replica at llama3-8b (full
   width at ``CUT_LAYERS``, 8, layers, bf16, the reference server's
   defaults), launch
   counts set to 0 before the traffic and read after it. The engine is
   warmed by ``server.warm_grid`` (``--warm-grid``: every program key
   dispatched once, then the compile watch armed; the keys and their
   first-dispatch host wall printed), then the HTTP server serves a
   mixed workload (four wave prompts, chunked prompts of 700 and 900
   tokens, a repeated phrase for the n-gram verify, one request with a
   ``traceparent``, then a shared-prefix pair whose second is a prefix
   hit), 16 new tokens each. Held: zero unexpected compiles, the
   records' decode and verify program identities equal the engine's
   ``decode_programs`` both ways, the traceparent's trace id on the
   request's records, ``/debug/flight`` and ``/debug/forensics`` read
   over HTTP with a ``?rid=`` ledger whose phases sum to its wall (90%
   named) and a 400 on a bad rid, K1 and K2 launched. Printed: the
   medians of ``dispatch_wall_ms``, ``fetch_wall_ms`` and ``dev_ms_est``
   by burst kind; the HBM ledger beside ``allocated_bytes.all.current``
   (its resident components must fit in it); then on the engine alone,
   one request a slot of ``OBSERVE_PARITY_NEW`` tokens, everything on,
   the recorder off, forensics off and calibration off, in that order
   and back: greedy tokens equal in every pass, and
   ``overhead_ratio``, ``forensics_overhead_ratio`` and
   ``devtime_overhead_ratio`` (best against best) reported; one decode
   program's ``dev_ms_est`` beside the profiler's
   kernel-time sum for one dispatch of it; and the flushed flight log
   read back. The HTTP leg runs with ``SKYTPU_TIMELINE_FILE_PATH`` set:
   the trace file's ``skytpu_prefill_seconds`` spans must be one a wave
   record and its ``skytpu_decode_step_seconds`` spans one a decode or
   verify dispatch (each the histogram's own sample).
12. Train: gradient parity of the kernels against the plain versions at
   llama3-1b width (2 layers, fp32 asserted, bf16 reported); then
   ``train.run`` at llama3-1b full width and depth for 6 steps on a
   repeated batch (counts set to 0 before, read after: K2 32, K3 16 and
   K4 16 launches a step; the loss must fall), with the goodput ledger
   on: every step's phases sum to its wall (0.05 ms), the snapshot's
   buckets to its elapsed wall, and ``compute`` is at least 0.85 of
   every warm step's wall; printed: each warm step's ledger,
   ``dev_ms_est`` beside ``compute``, the buckets, the goodput ratio and
   the train MFU (6·N·T over the data sheet's bf16 peak). The same 6
   steps again with ``SKYTPU_GOODPUT=0``: the median step ratio on/off
   over steps 2-6 is reported. One profiled step. Then llama3-tiny with
   ``SKYTPU_TIMELINE_FILE_PATH`` set: 4 steps, a checkpoint every 2; a
   twin killed by a ``train.checkpoint_save`` fault at step 4 and
   resumed from its step 2 must equal the uninterrupted run bit for bit
   and carry the first run's goodput stamps (``goodput.json``; steps
   counted across the restart, ``restart_replay`` > 0); the trace file
   holds the checkpoint save and wait spans; a recorder-off twin gives
   bit-equal losses and step-4 state.
13. Finetune: LoRA and QLoRA (``train/lora.py``, ``train/qlora.py``).
   (a) float32 at llama3-8b width (2 layers), a packed batch of 2 x
   2048, rank-16 adapters with B drawn nonzero: the QLoRA loss over a
   random int8 base and the LoRA loss over a random float base, and
   their adapter gradients, through the kernels against autograd of
   einsum attention (1e-5 relative on the loss, 1e-4 of max|plain| on
   each gradient). (b) The repo's recipe line ``train.run --config
   llama3-8b --qlora 16 --qlora-random-base --xent-chunk 512 --seq 2048
   --batch 2`` (``llm/qlora-8b.yaml``), full width and depth, 6 steps
   logged at each: finite losses that fall on the repeated batch, K2
   64 (forward and recompute), K3 32 and K4 32 launches a step (counts
   set to 0 before, read after); the median step (steps 2-6),
   tokens/s, peak allocated memory and the int8 base's bytes printed.
   (c) ``--config llama3-1b --lora 16``, batch 4 x 2048, chunked
   cross-entropy, the same checks, K2 32, K3 16 and K4 16 a step. (d)
   QLoRA at llama3-tiny resumed from its step-2 checkpoint equals the
   uninterrupted run bit for bit and books ``restart_replay``.

14. Models: the sparse MoE decoder and the ViT classifier
   (``models/moe.py``, ``models/vit.py``), launch counts set to 0
   before each leg and read after it. (a) MoE serving at Mixtral-8x7B's
   full width on ``MOE_LAYERS`` (8) of its 32 layers (a layer's experts
   are 2.82 GB in bf16), bf16, random weights drawn on the card, through
   ``InferenceEngine`` at the reference server's defaults (16 slots,
   max_len 1024, chunks of 512, a prefix pool of 8, n-gram K 4): the 8
   requests of the draft phase's lengths (98-775 tokens, two chunked),
   32 new tokens each, after a warm-up pass; the median TTFT, the
   decode rate and the launches (K1's decode and ``wgmma`` multi-row
   bodies and K2; ``mma.sync`` never). Then float32 at 2 layers of the
   same width: the kernel engine's greedy tokens against the plain
   engine's, parting only where the plain top-2 gap is below 1e-2
   (reported). (b) MoE training: ``llm/moe-train.yaml``'s line without
   ``--ep 4``, ``train.run --model moe --config moe-small --seq 2048
   --batch 4``, 6 steps: finite losses that fall, the aux loss a step,
   K2 16, K3 8 and K4 8 launches a step, the median step, tokens/s and
   peak memory. (c) ViT: float32 gradient parity at ViT-S/16 width (2
   layers, 8 images) through the kernels, bidirectional at a group of
   one, against autograd of einsum attention; then
   ``examples/vit_train.yaml``'s script: ViT-S/16, lr 1e-3,
   total_steps 500, one repeated batch of 64 images, 6 steps: finite
   losses that fall, K2 24, K3 12 and K4 12 launches a step.
15. Contig: the contiguous KV layout (``kv_block`` 0), launch counts set
   to 0 before each leg and read after it. (a) The HTTP server through
   ``make_engine`` at llama3-8b full width on ``SERVE_LAYERS`` layers,
   bf16, with the reference server's defaults (16 slots, max_len 1024, chunks of 512, a
   prefix pool of 8, n-gram K 4) and ``kv_block=0``: the serve phase's 9
   requests and its shared-prefix pair (the warm one a 512-token hit
   copied from its pool row), every check of the serve leg but that
   K2 alone launches (the big-cache reads are the gather, K1 never
   launches); TTFT median and max, the decode rate, peak memory and the
   contiguous KV's bytes (128 KiB a row). (b) Float32 at
   ``CONTIG_FP32_LAYERS`` (2) layers of llama3-8b's width: the
   contiguous engine against the paged one (K1) on a wave prompt, a
   chunked prompt and the prefix pair (warm hit), spec K 4 on and off,
   and on int8 KV pools; ``step()`` against the burst path; tokens agree
   wherever the plain top-2 gap exceeds 1e-2. (c) The bench's
   ``run_occupancy`` at its card size (llama3-400m, max_len 4096, 8
   contiguous slots against 64 paged at equal KV bytes),
   ``run_span_smoke`` and ``run_kernel_smoke``, in float32, the 400m
   at ``CONTIG_400M_LAYERS`` (4) of its 12 layers: each report
   line; where tokens part, the plain top-2 gap there is at most the
   larger of 1e-2 and twice the gather's own shift from the plain
   logits on that context (the gather rounds its weights to bf16).

16. Mesh: the trainer over a one-rank NCCL device mesh
   (``parallel/mesh.make_mesh``; one card runs one rank, so no
   collective is timed). (a) llama3-1b at full width and depth, bf16
   activations, batch 4 x 2048, chunked cross-entropy at 512, 6 steps
   from seed 0 on one batch, with ``mesh=None`` and then with the mesh
   (DTensor parameters, moments and batch; K2, K3 and K4 on the local
   shards): losses within 1e-2 relative of each other, K2 32, K3 16 and
   K4 16 launches a step in the mesh leg (counted from 0 before it),
   each leg's median step, tokens/s and peak memory; one profiled mesh
   step. (b) 2 layers in float32, 3 steps: loss and grad norm within
   1e-5 relative, parameters within 1e-5 of max|Δ|, and a checkpoint
   of the mesh leg's state restores into the plain leg's bit for bit.

17. Parallel: context and pipeline parallelism on one card (one rank,
   so the ring's shift, Ulysses's all-to-all and the pipeline's sends
   do not run). (a) llama3-1b's width and depth as a pipeline of 2
   stages and 4 microbatches, bf16, batch 4 x 2048, chunked
   cross-entropy at 512, 6 steps from seed 0 beside the plain
   llama3-1b leg, under GPipe and then 1F1B: K2 128, K3 64 and K4 64
   launches a step (counted from 0 before each leg), the first loss
   within 1e-2 of ``llama.loss_fn`` on the same weights, 1F1B's losses
   within 1e-2 of GPipe's; each leg's median step, tokens/s and peak
   memory, and one more GPipe step profiled (device time by kernel
   class, idle share); then 2 layers in float32, 3 steps, against the plain stack
   within 1e-5 on loss and grad norm. (b) The ring, the zigzag ring
   and Ulysses by ``ring_attention.loopback``: the module's distributed
   ring loop for 4 virtual sp ranks in one process, the ring's shift a
   hand-over of the next block, Ulysses's all-to-all a reshuffle of the
   ranks' chunks (its K2-K4 once over the stacked head groups), at
   ``llm/long-context-ring.yaml``'s per-rank attention (16 q over 4 kv
   heads, hd 128, 32768 packed rows), against K2 over the whole
   sequence and K3/K4: outputs and gradients within 2e-2 of max in
   bf16, 1e-4 in float32 at 4 x 1024; each scheme's wall and peak.
   (c) ``train.run --model pipeline --config pp-tiny``, and
   ``--zigzag`` on one rank (the same losses as without it).
18. Tp: tensor-parallel serving on one card (it runs after phase 11,
   beside the ``flash_bwd`` build). llama3-70b's width (d_model 8192,
   64 q over 8 kv heads, d_ff 28672, vocab 128256) on ``CUT_LAYERS``
   (8) of 80 layers, bf16, drawn by ``InferenceEngine.sharded_init``
   straight into 4 shards of the card (16 q over 2 kv heads each): the
   serve phase's 9 requests (32 new tokens, after one short warm-up
   request) through the engine with chunks of 512, a prefix pool of 8
   and n-gram speculation at K 4, then the longest prompt again (a
   prefix hit); launch counts set to 0 before and read after (K1's
   decode and ``wgmma`` multi-row bodies and K2 must launch), TTFT,
   decode rate and each shard's bytes printed; K1 and K2 then held
   against their plain versions at every shape the leg gave them. A
   tp-1 twin on the same weights gathered whole serves the same
   requests: where tokens part, the plain top-2 gap (float32 weights)
   must be within the bf16 noise floor (the serve phase's rule). On
   the first 2 layers of those weights in float32, tp 4 and tp 1 give
   the same greedy tokens, as they do with w8a8 weights and int8 KV
   pools, and tp 4 with an oracle drafter gives them too with every
   draft accepted; the float32 pools run the ``mma.sync`` multi-row
   body. ``python -m skypilot_tpu_torch.infer.server --tp 4`` on one
   card exits non-zero with the reference's "--tp 4 needs 4 devices"
   message. The 4 shards share the card, so no cross-card reduction
   is timed.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``; the line before them gives each
phase's wall. ``--phase kernels``, ``serve``, ``handoff``, ``bench``,
``qos``, ``adapters``, ``draft``, ``recover``, ``observe``, ``train``,
``finetune``, ``models``, ``contig``, ``mesh``, ``parallel`` or ``tp``
runs one of phases 3-18 alone (the build always runs).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

# The card's dense bf16 rate and HBM rate are the H100 row of the
# port's peaks table (``observability.attribution.datasheet_peaks``,
# NVIDIA's H100 SXM data sheet), the numbers the serving MFU on /metrics
# divides by too; the table alone, never an env override. The fp32 and
# int8 dense rates from the same sheet. Outside the repository the
# table is missing and main() says so.
try:
    from skypilot_tpu_torch.observability.attribution import \
        datasheet_peaks
    _BF16_OPS_PER_S, HBM_BYTES_PER_S = datasheet_peaks("nvidia h100")
except ImportError:
    datasheet_peaks = None
    _BF16_OPS_PER_S = HBM_BYTES_PER_S = None
PEAK_OPS_PER_S = {"bf16": _BF16_OPS_PER_S, "fp32": 67e12, "int8": 1979e12}
SEED = 0


def _log(*a) -> None:
    print(*a, flush=True)


def _bound_ms(n_bytes: float, n_ops: float, kind: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[kind]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _rates(ms: float, n_ops: float, bound_ms: float, library_ms) -> dict:
    """What a kernel's time means: its achieved rate, the share of the
    card's bound it reaches and its time over the library call's."""
    return {"tflops": n_ops / (ms * 1e-3) / 1e12,
            "bound_share": bound_ms / ms,
            "vs_library": None if library_ms is None else ms / library_ms}


def _rates_text(r: dict) -> str:
    lib = ("n/a" if r["vs_library"] is None
           else f"{r['vs_library']:.2f}x library")
    return (f"{r['tflops']:.1f} TFLOP/s, {100 * r['bound_share']:.1f}% of "
            f"bound, {lib}")


def _ptxas_summary(log: str):
    """Each warning line of an ``nvcc -Xptxas -v`` log (C7514/C7515 say
    a ``wgmma`` was serialized), then one line per kernel function: its
    (demangled) name, registers and spill bytes."""
    import re
    import shutil
    funcs = []  # [mangled name, registers, spill stores, spill loads]
    for line in log.splitlines():
        if "warning" in line.lower():
            yield line.strip()
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            funcs.append([m.group(1), "?", "0", "0"])
        elif funcs and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            funcs[-1][2:] = m.groups()
        elif funcs and (m := re.search(r"Used (\d+) registers", line)):
            funcs[-1][1] = m.group(1)
    names = [f[0] for f in funcs]
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if filt and names:
        out = subprocess.run([filt], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = out.stdout.splitlines()
    for name, (_, regs, st, ld) in zip(names, funcs):
        for old, new in (("(anonymous namespace)::", ""),
                         ("<unnamed>::", ""), ("(int)", ""), ("void ", ""),
                         ("(bool)1", "true"), ("(bool)0", "false"),
                         ("__nv_bfloat16", "bf16")):
            name = name.replace(old, new)
        yield (f"{name.split('(')[0]}: {regs} registers, spill stores "
               f"{st} B, loads {ld} B")


def _time_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``n`` calls, by CUDA events."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _graph_ms(fn, n: int) -> float:
    """Mean device time of ``fn(i)`` over ``n`` calls replayed from one
    CUDA graph, by CUDA events: the launches run back to back, without
    the host's time per call between them (which, for a kernel shorter
    than its Python wrapper's call, is what ``_time_ms`` would time)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * n)
    del graph
    torch.cuda.empty_cache()
    return ms


def _host_ms(fn, n: int) -> float:
    """Mean host time of one ``fn(i)`` call (its enqueue, not its run)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return ms


def _err(got, want, name: str, rel: float):
    """Max |got - want| and the check against rel * max|want|."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if not err <= rel * max(scale, 1e-30):
        raise AssertionError(f"{name}: max|kernel - plain| = {err:.3e} "
                             f"exceeds {rel} * max|plain| = "
                             f"{rel * scale:.3e}")
    return err


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _paged_case(quant: bool, gen, dev):
    """K1 inputs at the decode burst's shapes: 16 slots, 8 kv-heads, 4
    query rows each (the GQA repeat), head_dim 128, 256-row blocks in a
    pool of 65, a 32-layer pool read at layer 5, table of 4 + sentinel
    columns swept to span 768 (3 blocks). Lengths: 0, partial final
    blocks, full, and past the span; block ids scattered."""
    import torch
    L, n_blocks, bl, G, hd = 32, 65, 256, 8, 128
    B, R, nb, span_blocks, layer = 16, 4, 4, 3, 5
    shape = (L, n_blocks, bl, G, hd)
    if quant:
        kp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        sshape = (L, n_blocks, G, bl)
        ks = (torch.rand(sshape, generator=gen, device=dev) * 0.02
              + 1e-3).to(torch.bfloat16)
        vs = (torch.rand(sshape, generator=gen, device=dev) * 0.02
              + 1e-3).to(torch.bfloat16)
    else:
        kp = torch.randn(shape, generator=gen, device=dev,
                         dtype=torch.bfloat16)
        vp = torch.randn(shape, generator=gen, device=dev,
                         dtype=torch.bfloat16)
        ks = vs = None
    q = torch.randn((B, G, R, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    lengths = [0, 1, 255, 256, 257, 600, 767, 768, 1000, 1024,
               130, 511, 512, 700, 2, 900]
    perm = torch.randperm(n_blocks, generator=gen, device=dev).tolist()
    table = torch.full((B, nb + 1), n_blocks, dtype=torch.int32)
    for b, n in enumerate(lengths):
        have = -(-n // bl)
        table[b, :have] = torch.tensor(perm[b * nb: b * nb + have])
    table = table.to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return dict(q=q, k_pool=kp, v_pool=vp, k_scale=ks, v_scale=vs,
                table=table, lengths=lens, layer=layer,
                span_blocks=span_blocks)


def _paged_long_case(gen, dev):
    """K1 at long context: 16 slots of 3000-4096 rows, 8 kv-heads, 4
    query rows, head_dim 128, bf16, swept to span 16 blocks of 256 (the
    kernel's chunks: 24-32 a slot) in a 4-layer pool."""
    import torch
    L, bl, G, hd, B, R, nb = 4, 256, 8, 128, 16, 4, 16
    n_blocks = B * nb + 1
    shape = (L, n_blocks, bl, G, hd)
    kp = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    q = torch.randn((B, G, R, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    lengths = torch.randint(3000, 4097, (B,), generator=gen, device=dev)
    perm = torch.randperm(n_blocks, generator=gen, device=dev)
    table = torch.full((B, nb + 1), n_blocks, dtype=torch.int32, device=dev)
    table[:, :nb] = perm[:B * nb].reshape(B, nb).int()
    return dict(q=q, k_pool=kp, v_pool=vp, k_scale=None, v_scale=None,
                table=table, lengths=lengths.int(), layer=2, span_blocks=nb)


def _paged_int8_serve_case(gen, dev):
    """K1's decode body at the int8 serve leg's shapes (``--slots 32
    --max-len 1280 --kv-int8``): 32 slots of llama3-8b (8 kv-heads, 4
    query rows, head_dim 128) over int8 pools with bf16 scales, blocks of
    256 (5 a slot: 160 and the trash block), 32 layers read at layer 5,
    lengths from 0 to 1280 swept at the full span."""
    import torch
    L, bl, G, hd, B, R, nb = 32, 256, 8, 128, 32, 4, 5
    n_blocks = B * nb + 1
    kp, vp, ks, vs = _rows_pools((L, n_blocks, bl, G, hd), "int8", gen,
                                  dev)
    q = torch.randn((B, G, R, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    lengths = torch.randint(1, nb * bl + 1, (B,), generator=gen, device=dev)
    lengths[0], lengths[1] = 0, nb * bl
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev)
    table = torch.full((B, nb + 1), n_blocks - 1, dtype=torch.int32,
                       device=dev)
    table[:, :nb] = perm[:B * nb].reshape(B, nb).int()
    return dict(q=q, k_pool=kp, v_pool=vp, k_scale=ks, v_scale=vs,
                table=table, lengths=lengths.int(), layer=5, span_blocks=nb)


def _paged_rows_case(start: int, gen, dev, kv: str = "bf16"):
    """K1's multi-row body at the chunk program's shapes on the serve
    path (llama3-8b, chunk 512, max_len 1024): one slot, 8 kv-heads,
    512 x 4 = 2048 query rows each, head_dim 128, bf16 q; the slot's
    length is the chunk's ``start``, the span rung covering it is 512
    rows (2 blocks of 256), the pool is the serve cache's (32 layers,
    64 blocks and the trash block), read at layer 5. ``kv``: the pools'
    dtype, ``bf16``, ``int8`` (with bf16 scales, as the int8 KV cache
    stores them) or ``f32`` (the engine's float32 parity leg)."""
    import torch
    L, n_blocks, bl, G, hd = 32, 65, 256, 8, 128
    kp, vp, ks, vs = _rows_pools((L, n_blocks, bl, G, hd), kv, gen, dev)
    q = torch.randn((1, G, 512 * 4, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev)
    table = torch.full((1, 5), n_blocks - 1, dtype=torch.int32, device=dev)
    table[0, :3] = perm[:3].int()          # 775 tokens' blocks
    lens = torch.tensor([start], dtype=torch.int32, device=dev)
    return dict(q=q, k_pool=kp, v_pool=vp, k_scale=ks, v_scale=vs,
                table=table, lengths=lens, layer=5, span_blocks=2)


def _paged_bench_case(gen, dev):
    """K1's decode body at bench[http]'s shapes (llama3-8b, 16 slots,
    max_len 1064 = 1024 + 32 + 8): bf16 pools in blocks of 8, the one
    block length that tiles 1064 and that K1's multi-row body reads
    (``engine.kv_block_len``), 133 a slot and the trash block, 32
    layers read at layer 5, table columns scattered, lengths 512-1064
    with one empty and one full slot, swept at the full span."""
    import torch
    L, bl, G, hd, B, R, nb = 32, 8, 8, 128, 16, 4, 133
    n_blocks = B * nb + 1
    kp, vp, _, _ = _rows_pools((L, n_blocks, bl, G, hd), "bf16", gen, dev)
    q = torch.randn((B, G, R, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    lengths = torch.randint(512, nb * bl + 1, (B,), generator=gen,
                            device=dev)
    lengths[0], lengths[1] = 0, nb * bl
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev)
    table = torch.full((B, nb + 1), n_blocks - 1, dtype=torch.int32,
                       device=dev)
    table[:, :nb] = perm.reshape(B, nb).int()
    return dict(q=q, k_pool=kp, v_pool=vp, k_scale=None, v_scale=None,
                table=table, lengths=lengths.int(), layer=5, span_blocks=nb)


def _paged_rows_bench_case(start: int, gen, dev):
    """K1's multi-row body at bench[prefix]'s chunk shapes (llama3-8b,
    chunks of 256 tokens: 1024 query rows a kv-head; max_len 872 = 768 +
    48 + 48 + 8, so blocks of 8, 109 a slot): one slot of a 16-slot
    pool (32 layers, read at layer 5) whose length is the chunk's
    ``start``, swept to the engine's span rung covering it (the ladder
    109, 218, 436, 872 rows: 436 for 256, which is 54.5 blocks and so
    ends inside a block; all 872 for 768)."""
    import torch
    from skypilot_tpu_torch.infer import engine as eng
    L, bl, G, hd, nb = 32, 8, 8, 128, 109
    n_blocks = 16 * nb + 1
    kp, vp, _, _ = _rows_pools((L, n_blocks, bl, G, hd), "bf16", gen, dev)
    q = torch.randn((1, G, 256 * 4, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev)
    table = torch.full((1, nb + 1), n_blocks - 1, dtype=torch.int32,
                       device=dev)
    table[0, :nb] = perm[:nb].int()
    span = next(r for r in eng._span_ladder(None, nb * bl) if start <= r)
    lens = torch.tensor([start], dtype=torch.int32, device=dev)
    return dict(q=q, k_pool=kp, v_pool=vp, k_scale=None, v_scale=None,
                table=table, lengths=lens, layer=5,
                span_blocks=-(-span // bl))


def _rows_pools(shape, kv: str, gen, dev):
    """K and V pools of ``shape`` (bf16 or f32, or int8 with bf16 scales
    ``[L, n_blocks, G, bl]``) and their scales (None but for int8)."""
    import torch
    if kv != "int8":
        dtype = torch.bfloat16 if kv == "bf16" else torch.float32
        return (torch.randn(shape, generator=gen, device=dev, dtype=dtype),
                torch.randn(shape, generator=gen, device=dev, dtype=dtype),
                None, None)
    L, n, bl, G, _ = shape
    pools = [torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8) for _ in range(2)]
    scales = [(torch.rand((L, n, G, bl), generator=gen, device=dev) * 0.02
               + 1e-3).to(torch.bfloat16) for _ in range(2)]
    return pools[0], pools[1], scales[0], scales[1]


def _paged_rows_long_case(start: int, gen, dev):
    """The multi-row body on a long prompt's chunk: llama3-8b at max_len
    8192 (``models/llama.py``'s longest context), one slot, 8 kv-heads,
    2048 query rows each, head_dim 128, bf16; the slot's length is the
    chunk's ``start`` and the span the engine's rung covering it (4096
    rows for 3584, the full 8192 for 7680), blocks of 256. The pool
    holds 4 layers (the body reads one; 4 put the launches' combined
    K/V past the 50 MB L2, as the 32 layers of a chunk do) of the span's
    blocks and the trash block, read at layer 1."""
    import torch
    G, hd, bl = 8, 128, 256
    nb = 16 if start < 4096 else 32
    n_blocks = nb + 1
    kp, vp, _, _ = _rows_pools((4, n_blocks, bl, G, hd), "bf16", gen,
                                dev)
    q = torch.randn((1, G, 512 * 4, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    table = torch.full((1, nb + 1), nb, dtype=torch.int32, device=dev)
    table[0, :nb] = torch.randperm(nb, generator=gen, device=dev).int()
    lens = torch.tensor([start], dtype=torch.int32, device=dev)
    return dict(q=q, k_pool=kp, v_pool=vp, k_scale=None, v_scale=None,
                table=table, lengths=lens, layer=1, span_blocks=nb)


def _sdpa_yardstick(name: str, case) -> None:
    """SDPA on the rows case's q over the slot's K/V rows below its
    length, gathered beforehand (int8 rows cast to bf16, scales left
    out): a library yardstick line only, since no PyTorch call returns
    the unnormalized stats."""
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import paged_attention as pa
    n = int(case["lengths"][0])
    q = case["q"]
    k = pa.gather_kv_layer(case["k_pool"], case["layer"], case["table"],
                           n).transpose(1, 2).to(q.dtype).contiguous()
    v = pa.gather_kv_layer(case["v_pool"], case["layer"], case["table"],
                           n).transpose(1, 2).to(q.dtype).contiguous()
    ms = _time_ms(lambda i: F.scaled_dot_product_attention(q, k, v), 20)
    _log(f"kernel {name}: yardstick, not a library equivalent: SDPA of "
         f"the same q over the {n} rows gathered ({tuple(k.shape)}) "
         f"{ms:.4f} ms")


def _paged_err(name: str, case, fn) -> float:
    """The largest error of K1 through ``fn`` against the plain version
    on ``case``, held to 2e-3 of each output's largest magnitude; a
    second call must give the same bits and a length-0 slot the empty
    stats."""
    import torch
    from skypilot_tpu_torch.ops import paged_attention as pa
    args = (case["q"], case["k_pool"], case["v_pool"], case["k_scale"],
            case["v_scale"], case["table"], case["lengths"])
    lay, sb = case["layer"], case["span_blocks"]
    acc, m, l = fn(*args, lay, span_blocks=sb)
    again = fn(*args, lay, span_blocks=sb)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((acc, m, l), again)):
        raise AssertionError(f"{name}: a second call gave other bits")
    del again
    racc, rm, rl = pa.paged_attention_ref(*args, lay, sb)
    empty = case["lengths"] == 0
    if not (torch.all(m[empty] == -1e30) and torch.all(l[empty] == 0)
            and torch.all(acc[empty] == 0)):
        raise AssertionError(f"{name}: a length-0 slot must report "
                             f"m=-1e30, l=0, acc=0")
    live = ~empty
    rel = 2e-3
    err = 0.0
    if live.any():
        err = max(_err(acc[live], racc[live], f"{name} acc", rel),
                  _err(m[live], rm[live], f"{name} m", rel),
                  _err(l[live], rl[live], f"{name} l", rel))
    return err


def _check_paged(name: str, case, fn=None) -> dict:
    from skypilot_tpu_torch.ops import paged_attention as pa
    fn = fn or pa.paged_attention
    err = _paged_err(name, case, fn)
    args = (case["q"], case["k_pool"], case["v_pool"], case["k_scale"],
            case["v_scale"], case["table"], case["lengths"])
    sb = case["span_blocks"]
    live = case["lengths"] != 0
    L = case["k_pool"].shape[0]

    # Cycle the layer so each launch reads blocks no earlier launch left
    # in L2, as the loops over layers do.
    def kern(i):
        fn(*args, i % L, span_blocks=sb)

    def plain(i):
        pa.paged_attention_ref(*args, i % L, sb)

    # A call is shorter than the wrapper's host time, so the kernel's own
    # time comes from graph replay; the eager loop and the host's time a
    # call are reported beside it.
    ms = _graph_ms(kern, 64)
    eager_ms = _time_ms(kern, 64)
    host_ms = _host_ms(kern, 64)
    plain_ms = _time_ms(plain, 8)
    B, G, R, hd = case["q"].shape
    bl = case["k_pool"].shape[2]
    # The K/V rows (and scales) below each slot's length within the
    # span, and the q rows of the slots that have any: what this run's
    # data needs read.
    rows = case["lengths"].clamp(max=sb * bl).long().sum().item()
    kv_item = case["k_pool"].element_size()
    n_bytes = (live.sum().item() * G * R * hd * case["q"].element_size()
               + 2 * rows * G * hd * kv_item
               + (2 * rows * G * 2 if case["k_scale"] is not None
                  else 0)
               + case["table"].numel() * 4 + B * 4
               + (B * G * R * hd + 2 * B * G * R) * 4)
    n_ops = 4 * rows * G * R * hd
    # The wgmma multi-row body multiplies in bf16 on bf16 and int8 pools
    # (int8 rows are widened to bf16); the decode body reads int8 as
    # int8; float32 pools are bounded at the float32 peak, as the
    # float32 flash rows are.
    kind = ("fp32" if kv_item == 4
            else "int8" if kv_item == 1 and fn is pa.paged_attention
            else "bf16")
    bound_ms, bound_by = _bound_ms(n_bytes, n_ops, kind)
    rates = _rates(ms, n_ops, bound_ms, None)
    _log(f"kernel {name}: max_abs_err={err:.3e} ms={ms:.4f} (graph "
         f"replay; eager loop {eager_ms:.4f}, host {host_ms:.4f} a call) "
         f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}); "
         + _rates_text(rates))
    return dict(name=name, max_abs_err=err, ms=ms, eager_ms=eager_ms,
                host_ms=host_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, **rates)


def _flash_case(S: int, segments: bool, gen, dev, B: int = 8, H: int = 32,
                Hkv: int = 8, D: int = 128, causal: bool = True):
    """K2 inputs at the wave prefill's shapes: a wave of ``B`` prompts,
    32 q-heads over 8 kv-heads, head_dim 128, bf16, causal; ``H``,
    ``Hkv``, ``D`` and ``causal`` give the training paths' shapes (the
    ViT's: 6 q-heads over 6, head_dim 64, bidirectional)."""
    import torch
    q = torch.randn((B, S, H, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k = torch.randn((B, S, Hkv, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn((B, S, Hkv, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    seg = None
    if segments:
        # Packed documents: segment id steps at random cut points.
        cuts = torch.rand((B, S), generator=gen, device=dev) < 4.0 / S
        seg = cuts.int().cumsum(dim=1).to(torch.int32)
    return dict(q=q, k=k, v=v, seg=seg, causal=causal)


def _flash_err(name: str, case):
    """K2 against the plain version on ``case``: (largest error, O,
    lse)."""
    import torch
    from skypilot_tpu_torch.ops import flash_attention as fa
    q, k, v, seg = case["q"], case["k"], case["v"], case["seg"]
    causal = case.get("causal", True)
    o, lse = fa.flash_attention_fwd(q, k, v, seg, causal=causal)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_attention_fwd_ref(q, k, v, seg, causal=causal)
    # O is bf16 (P is rounded to bf16 before P V, as the plain version's
    # fp32 P is not): the bf16-ulp rule of K3/K4. lse is float32 on both
    # sides and differs only in the order of fp32 sums.
    err = max(_bf16_ulp_err(o, ro, f"{name} O"),
              _err(lse, rlse, f"{name} lse", 1e-4))
    return err, o, lse


def _check_flash(name: str, case) -> dict:
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import flash_attention as fa
    q, k, v, seg, c = (case[n] for n in ("q", "k", "v", "seg", "causal"))
    err, o, lse = _flash_err(name, case)
    B, S, H, D = q.shape
    ms = _time_ms(lambda i: fa.flash_attention_fwd(q, k, v, seg, c), 5)
    plain_ms = _time_ms(
        lambda i: fa.flash_attention_fwd_ref(q, k, v, seg, c), 2, warmup=1)
    # The library yardstick: one scaled_dot_product_attention call on
    # the same tensors ([B, H, S, D] views, GQA unexpanded).
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if c:
        causal = causal.tril()
    if seg is not None:
        same = seg[:, None, :, None] == seg[:, None, None, :]
        mask = same & causal
        lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
        pairs = mask.sum().item() * H
    else:
        lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=c, enable_gqa=True)
        pairs = B * H * (S * (S + 1) // 2 if c else S * S)
    library_ms = _time_ms(lib, 5)
    item = q.element_size()
    n_bytes = ((q.numel() + k.numel() + v.numel() + o.numel()) * item
               + lse.numel() * 4 + (seg.numel() * 4 if seg is not None
                                    else 0))
    n_ops = 4 * pairs * D
    bound_ms, bound_by = _bound_ms(n_bytes, n_ops, "bf16")
    rates = _rates(ms, n_ops, bound_ms, library_ms)
    _log(f"kernel {name}: max_abs_err={err:.3e} ms={ms:.4f} "
         f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}) "
         f"library_ms={library_ms:.4f}; " + _rates_text(rates))
    return dict(name=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, **rates)


def _bf16_ulp_err(got, want, name: str, floor_rel: float = 1e-3):
    """Max |got - want| for bf16 outputs, held per element to one bf16
    ulp of the plain value plus ``floor_rel`` * max|plain| (a flipped
    rounding costs one ulp; near zero, where fp32 summation order
    dominates, the floor applies)."""
    import torch
    w = want.float()
    d = (got.float() - w).abs()
    # ulp of a bf16 value x: 2^(floor(log2|x|) - 7); frexp gives
    # |x| = m 2^e with m in [0.5, 1), so floor(log2|x|) = e - 1.
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - 8)
    tol = ulp + floor_rel * w.abs().max()
    worst = (d / tol).max().item()
    if not worst <= 1.0:
        raise AssertionError(f"{name}: |kernel - plain| exceeds one bf16 "
                             f"ulp + {floor_rel} * max|plain| "
                             f"(worst ratio {worst:.3f})")
    return d.max().item()


def _bwd_case(dtype, segments: bool, gen, dev, B: int = 4, H: int = 16,
              Hkv: int = 8, S: int = 2048, D: int = 128,
              causal: bool = True):
    """K3/K4 inputs at llama3-1b's training shape: batch 4, S 2048, 16
    q-heads over 8 kv-heads, head_dim 128, causal; O and lse from the
    forward kernel, dO random. ``B=2, H=32``: the QLoRA-8B recipe's
    (a GQA group of 4); ``H``, ``Hkv``, ``S``, ``D`` and ``causal`` the
    MoE and ViT recipes'."""
    import torch
    from skypilot_tpu_torch.ops import flash_attention as fa

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q, k, v = randn(B, S, H, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
    do = randn(B, S, H, D)
    seg = None
    if segments:
        cuts = torch.rand((B, S), generator=gen, device=dev) < 4.0 / S
        seg = cuts.int().cumsum(dim=1).to(torch.int32)
    o, lse = fa.flash_attention_fwd(q, k, v, seg, causal)
    return dict(q=q, k=k, v=v, o=o, lse=lse, do=do, seg=seg, causal=causal,
                delta=fa.attention_delta(o, do))


def _check_bwd(name: str, case) -> dict:
    """K3 and K4 against the plain backward on the same inputs; each
    kernel's time, bound and plain time, and the library yardstick:
    the backward of one scaled_dot_product_attention call, which
    computes dQ, dK and dV together (on both rows)."""
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import flash_attention as fa
    q, k, v, o, lse, do, seg, delta, c = (case[n] for n in (
        "q", "k", "v", "o", "lse", "do", "seg", "delta", "causal"))
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, seg, c)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, seg, c)
    torch.cuda.synchronize()
    if q.dtype == torch.bfloat16:
        # No atomics: a second call gives the same bits.
        dq2 = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, seg, c)
        dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, seg,
                                              c)
        if not (torch.equal(dq, dq2) and torch.equal(dk, dk2)
                and torch.equal(dv, dv2)):
            raise AssertionError(f"{name}: K3/K4 gave other bits on a "
                                 f"second call")
        del dq2, dk2, dv2
    rq, rk, rv = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, seg, c)
    if q.dtype == torch.bfloat16:
        err_dkv = max(_bf16_ulp_err(dk, rk, f"{name} dK"),
                      _bf16_ulp_err(dv, rv, f"{name} dV"))
        err_dq = _bf16_ulp_err(dq, rq, f"{name} dQ")
        kind = "bf16"
    else:
        err_dkv = max(_err(dk, rk, f"{name} dK", 1e-4),
                      _err(dv, rv, f"{name} dV", 1e-4))
        err_dq = _err(dq, rq, f"{name} dQ", 1e-4)
        kind = "fp32"
    del rq, rk, rv
    ms_dkv = _time_ms(lambda i: fa.flash_attention_bwd_dkv(
        q, k, v, do, lse, delta, seg, c), 5)
    ms_dq = _time_ms(lambda i: fa.flash_attention_bwd_dq(
        q, k, v, do, lse, delta, seg, c), 5)
    plain_ms = _time_ms(lambda i: fa.flash_attention_bwd_ref(
        q, k, v, o, lse, do, seg, c), 2, warmup=1)
    B, S, H, D = q.shape
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if c:
        causal = causal.tril()
    if seg is not None:
        mask = (seg[:, None, :, None] == seg[:, None, None, :]) & causal
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                             enable_gqa=True)
        pairs = mask.sum().item() * H
    else:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=c,
                                             enable_gqa=True)
        pairs = B * H * (S * (S + 1) // 2 if c else S * S)
    dot = do.transpose(1, 2)
    library_ms = _time_ms(lambda i: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 5)
    del out
    item = q.element_size()
    # Each input read once, each output written once.
    n_in = ((q.numel() + k.numel() + v.numel() + do.numel()) * item
            + (lse.numel() + delta.numel()) * 4
            + (seg.numel() * 4 if seg is not None else 0))
    rows = []
    for kname, ms, err, n_out, ops_per_pair in (
            ("flash_attention_bwd_dkv", ms_dkv, err_dkv,
             (k.numel() + v.numel()) * item, 8),
            ("flash_attention_bwd_dq", ms_dq, err_dq, q.numel() * item, 6)):
        n_ops = ops_per_pair * pairs * D
        bound_ms, bound_by = _bound_ms(n_in + n_out, n_ops, kind)
        rates = _rates(ms, n_ops, bound_ms, library_ms)
        _log(f"kernel {kname}{name}: max_abs_err={err:.3e} ms={ms:.4f} "
             f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} "
             f"({bound_by}) library_ms={library_ms:.4f}; "
             + _rates_text(rates))
        rows.append((kname, dict(name=kname + name, max_abs_err=err, ms=ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, library_ms=library_ms,
                                 **rates)))
    return dict(rows)


def _rows_cases(gen, dev):
    """K1's multi-row bodies, each against the plain version, with its
    SDPA yardstick where the slot holds rows. The wgmma body: the serve
    chunk (start 512), an empty slot (start 0), two chunks of a long
    prompt (starts 3584 and 7680), the serve chunk on int8 pools and
    two of bench[prefix]'s 256-token chunks on blocks of 8 (starts 256
    and 768). The mma.sync body: the serve chunk on float32 pools (bf16 q, as the
    engine's float32 parity leg sends it). Returns (wgmma cases,
    mma.sync cases); each case must move its own body's count only."""
    import torch
    from skypilot_tpu_torch.ops import paged_attention as pa
    fn = pa.paged_attention_rows
    out = {"paged_attention_rows": [], "paged_attention_rows_mma": []}
    for kname, label, make, start in (
            ("paged_attention_rows", "bf16,start=512", _paged_rows_case, 512),
            ("paged_attention_rows", "bf16,start=0", _paged_rows_case, 0),
            ("paged_attention_rows", "bf16,start=3584",
             _paged_rows_long_case, 3584),
            ("paged_attention_rows", "bf16,start=7680",
             _paged_rows_long_case, 7680),
            ("paged_attention_rows", "int8,start=512",
             functools.partial(_paged_rows_case, kv="int8"), 512),
            ("paged_attention_rows", "bf16,blocks of 8,R=1024,start=256",
             _paged_rows_bench_case, 256),
            ("paged_attention_rows", "bf16,blocks of 8,R=1024,start=768",
             _paged_rows_bench_case, 768),
            ("paged_attention_rows_mma", "f32,start=512",
             functools.partial(_paged_rows_case, kv="f32"), 512)):
        case = make(start, gen, dev)
        name = f"{kname}[{label}]"
        before = (fn.launches, fn.mma_launches)
        out[kname].append(_check_paged(name, case, fn))
        moved = (fn.launches - before[0], fn.mma_launches - before[1])
        mma = kname == "paged_attention_rows_mma"
        if not moved[int(mma)] or moved[int(not mma)]:
            raise AssertionError(f"{name}: launches (wgmma, mma.sync) "
                                 f"{moved}; only the "
                                 f"{'mma.sync' if mma else 'wgmma'} body "
                                 f"should have run")
        if int(case["lengths"][0]):
            _sdpa_yardstick(name, case)
        del case
        torch.cuda.empty_cache()
    return out


# The models phase's attention shapes (``phase_models``): moe-small's
# training recipe (batch 4 x 2048, 8 q-heads over 4, head_dim 128,
# causal) and ViT-S/16's (64 images of 196 patches and the class token,
# 6 q-heads over 6, head_dim 64, bidirectional).
MODEL_ATTENTION = {
    "moe-small,B=4,S=2048,Hq=8,Hkv=4": dict(B=4, S=2048, H=8, Hkv=4, D=128,
                                            causal=True),
    "ViT-S/16,B=64,S=197,Hq=Hkv=6,D=64,bidirectional": dict(
        B=64, S=197, H=6, Hkv=6, D=64, causal=False),
}


def phase_kernels(dev):
    """Returns {kernel: [case results]}, the main-path case first."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED)
    paged = [_check_paged("paged_attention[bf16]",
                          _paged_case(False, gen, dev)),
             _check_paged("paged_attention[int8]",
                          _paged_case(True, gen, dev)),
             _check_paged("paged_attention[bf16,long]",
                          _paged_long_case(gen, dev)),
             _check_paged("paged_attention[int8,32 slots,max_len 1280]",
                          _paged_int8_serve_case(gen, dev)),
             _check_paged("paged_attention[bf16,blocks of 8,max_len 1064]",
                          _paged_bench_case(gen, dev))]
    torch.cuda.empty_cache()
    rows = _rows_cases(gen, dev)
    # The serve phase's waves (8 prompts), then the bench's: 16 x 96
    # (bench[engine]), and the monolith's 4 x 816 and 8 x 32
    # (bench[prefix]), whose last tiles are partial.
    # Then the QLoRA-8B recipe's training shape (2 x 2048, 32 q-heads
    # over 8 kv-heads).
    flash = [_check_flash(f"flash_attention_fwd[S={S},seg={int(s)}]"
                          + (f"[B={B}]" if B != 8 else ""),
                          _flash_case(S, s, gen, dev, B))
             for B, S, s in ((8, 1024, False), (8, 512, False),
                             (8, 1024, True), (8, 512, True),
                             (16, 96, False), (4, 816, False),
                             (8, 32, False), (2, 2048, False))]
    # The models phase's training shapes: moe-small's recipe (4 x 2048,
    # 8 q-heads over 4) and ViT-S/16's (64 images of 197 tokens, 6
    # q-heads over 6, head_dim 64, bidirectional).
    for label, kw in MODEL_ATTENTION.items():
        flash.append(_check_flash(f"flash_attention_fwd[{label}]",
                                  _flash_case(segments=False, gen=gen,
                                              dev=dev, **kw)))
        torch.cuda.empty_cache()
    cases = {"paged_attention": paged, **rows,
             "flash_attention_fwd": flash,
             "flash_attention_bwd_dkv": [], "flash_attention_bwd_dq": []}
    for dtype, segs, B, H in ((torch.bfloat16, False, 4, 16),
                              (torch.bfloat16, True, 4, 16),
                              (torch.float32, False, 4, 16),
                              (torch.bfloat16, False, 2, 32)):
        label = (f"[{str(dtype).split('.')[-1]},seg={int(segs)}"
                 + (",B=2,Hq=32,8B" if H == 32 else "") + "]")
        rows = _check_bwd(label, _bwd_case(dtype, segs, gen, dev, B, H))
        for kname, row in rows.items():
            cases[kname].append(row)
        torch.cuda.empty_cache()
    for label, kw in MODEL_ATTENTION.items():
        rows = _check_bwd(f"[bf16,{label}]", _bwd_case(
            torch.bfloat16, False, gen, dev, **kw))
        for kname, row in rows.items():
            cases[kname].append(row)
        torch.cuda.empty_cache()
    return cases


# ---------------------------------------------------------------------------
# Phase 4: the main path through the HTTP server
# ---------------------------------------------------------------------------

def _post(url: str, payload: dict):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if payload.get("stream"):
            chunks = [json.loads(line) for line in r.read().splitlines()
                      if line.strip()]
            toks = [t for c in chunks for t in c.get("tokens", [])]
            done = chunks[-1]
            if not done.get("done"):
                raise AssertionError(f"stream ended without done: {done}")
            return {**done, "tokens": toks}
        return json.loads(r.read())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _int8_step_logits(engine, params, ctx):
    """The plain path's logits for the token after ``ctx`` on an int8 KV
    engine, as its decode reads them: ``ctx[:-1]`` prefilled and inserted
    (quantized) into a one-slot int8 cache, then the next decode step of
    ``ctx[-1]`` over those rows (``kvcache.step_logits``, plain
    attention)."""
    import torch
    from skypilot_tpu_torch.infer import kvcache
    cfg, dev, bl, qw = engine.cfg, engine.device, engine.kv_block, \
        engine.qweights
    n = len(ctx) - 1
    nb = -(-len(ctx) // bl)
    cache = kvcache.init_paged_cache(cfg, 1, nb, bl, dev, kv_int8=True)
    table = torch.arange(nb + 1, dtype=torch.int32, device=dev)[None]
    toks = torch.tensor([ctx[:-1]], dtype=torch.long, device=dev)
    prefix, _ = kvcache.prefill_batch(
        params, toks, torch.tensor([n], device=dev), cfg,
        plain_attention=True, qweights=qw)
    kvcache.insert(cache, {k: prefix[k][:, 0] for k in ("k", "v")}, 0, n,
                   ctx[-1], table)
    return kvcache.step_logits(params, cache, cfg, table,
                               plain_attention=True, qweights=qw)


def _plain_logits(engine, params, prompt, ctx, adapter=None):
    """The plain path's logits for the token after ``ctx`` (``prompt``
    and the tokens that followed it): on an int8 KV engine, for a token
    read from the cache (any but a wave prompt's first), those of one
    decode step over the quantized context (:func:`_int8_step_logits`);
    else the prefill's. ``adapter``: a fine-tune of ``engine``'s catalog,
    whose deltas the prefill adds (float pools only)."""
    import torch
    from skypilot_tpu_torch.infer import kvcache
    from_cache = len(ctx) > len(prompt) or len(prompt) > (
        engine.prefill_chunk or len(prompt))
    lora = {}
    if adapter is not None:
        slot = engine.adapters.acquire(adapter)
        engine.adapters.release(slot)          # stays resident
        lora = {"lora": engine.adapters.pool,
                "aid": torch.tensor([slot], device=engine.device)}
    if "k_scale" in engine.cache and from_cache:
        if lora:
            raise AssertionError("adapter logits on int8 pools")
        return _int8_step_logits(engine, params, ctx)
    bucket = next(s for s in engine.buckets if s >= len(ctx))
    toks = torch.zeros((1, bucket), dtype=torch.long, device=engine.device)
    toks[0, :len(ctx)] = torch.tensor(ctx)
    lens = torch.tensor([len(ctx)], device=engine.device)
    return kvcache.prefill_batch(params, toks, lens, engine.cfg,
                                 plain_attention=True,
                                 qweights=engine.qweights, **lora)[1]


# Depth of the float32 int8 legs (llama3-8b has 32 layers): w8a8's noise
# floor is as large at 2 layers as at 32, and the legs hold the smoke's
# time near half its limit.
INT8_FP32_LAYERS = 8
# Depths of llama3-8b (full width; 32 layers) on the card. The serve
# and contig phases run ``SERVE_LAYERS``: their 9 requests must draft
# by n-gram at least once, which the contig leg's did not at 8 layers.
# The serve phase's float32 leg and the handoff, bench, qos, adapters,
# draft, recover and observe phases run ``CUT_LAYERS``: none of their
# checks depends on depth. The smoke must stay inside its 1200 s limit
# on the slowest host as phases are added: it passed that limit on
# one host with serve, bench, qos, adapters, draft and contig at 32
# layers and the rest at 12 (``CUT_LAYERS`` was 16 before that).
SERVE_LAYERS = 16
CUT_LAYERS = 8


@contextlib.contextmanager
def _at_depth(config: str, n_layers: int):
    """For the block, ``llama.CONFIGS[config]`` at ``n_layers`` layers
    (everything that builds the config by name, the server's
    ``make_engine`` included, sees the cut model)."""
    from skypilot_tpu_torch.models import llama
    full = llama.CONFIGS[config]
    llama.CONFIGS[config] = dataclasses.replace(full, n_layers=n_layers)
    try:
        yield
    finally:
        llama.CONFIGS[config] = full
# A relative perturbation of two float32 ulps of the embedding: the size
# of the summation-order noise between two correct attention paths.
W8A8_PROBE = 2.0 ** -22


def _divergence(ref_engine, prompt, got, want, low=None, adapter=None):
    """First step where tokens ``got`` (kernel path) and ``want`` (plain
    path) differ, with the plain path's top-2 logit gap there (read from
    its logits on the shared context, :func:`_plain_logits`) and its
    noise floor: (step, gap, noise), or (None, None, 0.0) when they agree
    throughout. Past a divergence the contexts differ and nothing more
    is comparable. The noise floor is 0 but on a w8a8 engine, where it
    is the largest shift of the plain logits on the same context when
    the embedding moves by two float32 ulps (``W8A8_PROBE``): w8a8
    rounds every projection's activations to int8, so noise of that size
    flips some roundings and moves the logits by far more than float32
    noise does. ``low``, a plain engine on the same weights in bf16
    (``ref_engine`` then holds them in float32): the floor is at least
    twice the largest difference between its logits and
    ``ref_engine``'s on the context. ``adapter``: the fine-tune both
    paths ran under (both reference engines carry it)."""
    for t, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        ctx = list(prompt) + list(want[:t])
        params = ref_engine.params
        logits = _plain_logits(ref_engine, params, prompt, ctx, adapter)
        top2 = logits[0].topk(2).values
        noise = 0.0
        if ref_engine.qweights is not None:
            probe = dict(params, embed=params["embed"] * (1 + W8A8_PROBE))
            noise = (_plain_logits(ref_engine, probe, prompt, ctx)
                     - logits).abs().max().item()
        if low is not None:
            noise = max(noise, 2 * (
                _plain_logits(low, low.params, prompt, ctx,
                              adapter).float()
                - logits).abs().max().item())
        return t, (top2[0] - top2[1]).item(), noise
    return None, None, 0.0


def _engine_like(params, cfg, like, dev, **kw):
    """An engine on ``params`` shaped like the server's engine ``like``
    (slots, max_len, buckets, wave cap, KV blocks, chunk); ``kw`` picks
    the attention path, the prefix pool, speculation and the int8
    recipe."""
    from skypilot_tpu_torch.infer import engine as eng
    return eng.InferenceEngine(
        params, cfg, n_slots=like.n_slots, max_len=like.max_len,
        prompt_buckets=like.buckets, max_wave=like.max_wave,
        kv_block=like.kv_block, prefill_chunk=like.prefill_chunk,
        device=dev, **kw)


def _kernel_vs_plain(params, cfg, like, dev, prompts, label, **kw):
    """Greedy tokens of ``prompts`` through two engines configured like
    the server's engine ``like`` (and ``kw``) that differ only in the
    attention path (batch shapes, and so the GEMMs' roundings, are the
    same in both), plus the prefill logits' largest difference on the
    longest prompt. Returns (kernel tokens, plain tokens, the plain
    engine)."""
    import torch
    from skypilot_tpu_torch.infer import kvcache
    runs = {}
    for plain in (False, True):
        e = _engine_like(params, cfg, like, dev, plain_attention=plain, **kw)
        runs[plain] = (e, e.generate(prompts, max_new_tokens=32))
    p = max(prompts, key=len)
    toks = torch.zeros((1, like.max_len), dtype=torch.long, device=dev)
    toks[0, :len(p)] = torch.tensor(p)
    n = torch.tensor([len(p)], device=dev)
    qw = kw.get("qweights")
    lk = kvcache.prefill_batch(params, toks, n, cfg, qweights=qw)[1]
    lp = kvcache.prefill_batch(params, toks, n, cfg, plain_attention=True,
                               qweights=qw)[1]
    _log(f"serve[{label}]: prefill logits max |kernel - plain| = "
         f"{(lk - lp).abs().max().item():.4e} (max |logit| "
         f"{lp.abs().max().item():.3f})")
    return runs[False][1], runs[True][1], runs[True][0]


def _long_chunks(engine, dev, card: str) -> None:
    """One 512-token ``prefill_chunk`` of llama3-8b at start 3584 and at
    7680 on the served weights, through a one-slot cache of max_len 8192
    (32 blocks of 256, ~1.1 GB): the chunk's wall time (after a warm-up
    chunk) and, from one profiled chunk, the multi-row body's launches
    and device time beside the matmuls' and the rest's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from skypilot_tpu_torch.infer import kvcache
    from skypilot_tpu_torch.ops import paged_attention as pa
    cfg, C, bl, max_len = engine.cfg, 512, 256, 8192
    nb = max_len // bl
    cache = kvcache.init_paged_cache(cfg, 1, nb, bl, dev)
    table = torch.full((1, nb + 1), nb, dtype=torch.int32, device=dev)
    table[0, :nb] = torch.arange(nb, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(1, cfg.vocab_size, (C,), generator=gen, device=dev)

    # The span is the rung of the engine's default ladder (max_len / 8,
    # / 4, / 2, max_len) that covers the chunk's start.
    def chunk(start):
        cache["length"][0] = start
        kvcache.prefill_chunk(
            engine.params, cache, toks, start, C, 0, max_len, cfg,
            engine.sampling_params, table, final=False,
            span=4096 if start < 4096 else None)
        torch.cuda.synchronize()

    for start in (3584, 7680):
        chunk(start)                                   # warm-up
        t0 = time.perf_counter()
        chunk(start)
        wall = (time.perf_counter() - t0) * 1e3
        n0 = pa.paged_attention_rows.launches
        mma0 = pa.paged_attention_rows.mma_launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            chunk(start)
        n = pa.paged_attention_rows.launches - n0
        mma = pa.paged_attention_rows.mma_launches - mma0
        by = {"rows": 0.0, "matmul": 0.0, "other": 0.0}
        for evt in prof.events():
            if getattr(evt, "device_type", None) != \
                    torch.autograd.DeviceType.CUDA:
                continue
            name = evt.name.lower()
            cls = ("rows" if "paged_rows_tc" in name else "matmul"
                   if any(k in name for k in ("gemm", "xmma", "cutlass",
                                              "cublas", "nvjet"))
                   else "other")
            by[cls] += evt.time_range.elapsed_us() / 1e3
        rows_ms = by["rows"] / n if n else float("nan")
        _log(f"serve[long chunk]: llama3-8b 512-token chunk at start "
             f"{start}: wall {wall:.2f} ms; multi-row body {n} launches x "
             f"{rows_ms:.4f} ms = {by['rows']:.2f} ms of device time, "
             f"matmul {by['matmul']:.2f} ms, other {by['other']:.2f} ms "
             f"(one profiled chunk); {card}")
        if n != cfg.n_layers or mma:
            raise AssertionError(f"long chunk: {n} launches of the wgmma "
                                 f"multi-row body (expected "
                                 f"{cfg.n_layers}), {mma} of the mma.sync "
                                 f"one (expected 0)")
    del cache


def _batch_bodies(chunk):
    """The serve legs' 9 requests: 7 prompts of 64-900 tokens (seed 0)
    and streamed twins of the first chunked and the first wave prompt.
    Returns (bodies, prompts, twins)."""
    import numpy as np
    from skypilot_tpu_torch.models import llama
    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 901, 7).tolist()
    prompts = [rng.integers(1, llama.CONFIGS["llama3-8b"].vocab_size,
                            n).tolist() for n in lens]
    bodies = [{"tokens": p, "max_new_tokens": 32} for p in prompts]
    twins = [next(i for i, n in enumerate(lens) if n > chunk),
             next(i for i, n in enumerate(lens) if n <= chunk)]
    bodies += [{"tokens": prompts[i], "max_new_tokens": 32,
                "stream": True} for i in twins]
    return bodies, prompts, twins


def _sub(tag: str, what: str) -> str:
    """A line tag: ``serve[what]`` on the bf16 leg, ``serve[int8, what]``
    on the int8 one."""
    return f"serve[{what}]" if tag == "serve" else f"{tag[:-1]}, {what}]"


def _serve_leg(engine, tag: str, card: str, chunk: int,
               max_burst: int = 8) -> dict:
    """The port's HTTP server over ``engine`` answers the 9 requests
    (:func:`_batch_bodies`) concurrently, then the shared-prefix pair.
    The kernels' launch counts and the engine's spec counters are set to
    0 just before the batch and read just after. Checked: every kernel
    of the path launched, at least one verify round, the wgmma multi-row
    body once a layer per chunk not skipped by a prefix hit and the
    mma.sync one never, the trailers' chunk counts, every request's
    budget. On a contiguous engine the path is K2 alone: K2 must launch
    and no body of K1 may. Returns the batch's launches, results, wall
    time, TTFTs and decode rate, and the pair's."""
    from skypilot_tpu_torch.infer import server as srv
    cfg = engine.cfg
    bodies, prompts, twins = _batch_bodies(chunk)
    port = _free_port()
    # The server coalesces arrivals (for coalesce_s) until a full wave's
    # worth is queued: with the bf16 leg's wave cap at the run's request
    # count, admission starts once all of them are queued, so the wave
    # prompt's twins share one prefill wave, whose GEMM shapes, and so
    # roundings, the streamed twin must reproduce.
    model, httpd = srv.serve(engine, host="127.0.0.1", port=port,
                             max_burst=max_burst, coalesce_s=0.5)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        model.wait_ready(timeout=600)
        url = f"http://127.0.0.1:{port}/generate"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=30) as r:
            if json.loads(r.read())["status"] != "ok":
                raise AssertionError(f"{tag}: /health is not ok")
        results = [None] * len(bodies)
        errors = []

        def one(i):
            try:
                results[i] = _post(url, bodies[i])
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {e!r}")

        _zero_launches()
        # The engine's own counters, read while the server is idle.
        spec0 = (engine._spec_drafted_total, engine._spec_accepted_total,
                 engine.verify_calls)
        t1 = time.time()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.time() - t1
        launches = _read_launches()
        mma_launches = launches.pop("paged_attention_rows_mma")
        spec = [n - n0 for n, n0 in zip(
            (engine._spec_drafted_total, engine._spec_accepted_total,
             engine.verify_calls), spec0)]
        if errors or any(r is None for r in results):
            raise AssertionError(f"{tag}: requests failed: {errors}")
        pair = _prefix_pair(model, engine, url, cfg, chunk, tag)
    finally:
        httpd.shutdown()
        model.shutdown()
        th.join(timeout=30)
    _log(f"{tag}: {len(bodies)} requests in {wall:.2f} s; launches "
         f"{launches} (K1 merges a slot's chunks inside its own launch: "
         f"no merge kernel, 0 merge launches)")
    for name, n in launches.items():
        if not engine.paged and name != "flash_attention_fwd":
            if n or mma_launches:
                raise AssertionError(f"{tag}: K1 ({name}) launched {n} "
                                     f"times on a contiguous engine")
        elif n <= 0:
            raise AssertionError(f"{tag}: kernel {name} never launched on "
                                 f"the main path")
    _log(f"{_sub(tag, 'spec')}: {spec[2]} verify calls (K+1 = 5 "
         f"decode-body launches a layer each, "
         f"{5 * cfg.n_layers * spec[2]} of the "
         f"{launches['paged_attention']} K1 decode launches); drafted "
         f"{spec[0]}, accepted {spec[1]} tokens; per request (drafted, "
         f"accepted, drafter): "
         + ", ".join(f"({r['spec_drafted']}, {r['spec_accepted']}, "
                     f"{r['drafter']})" for r in results))
    if spec[2] <= 0:
        raise AssertionError(f"{tag}: no verify round ran: speculation was "
                             f"never attempted on the main path")
    # Chunked prefill: one multi-row launch a layer per chunk of every
    # prompt longer than the chunk (the repeated prompt counts twice),
    # less the chunks a prefix hit skipped (its trailer's cached_tokens).
    cached = [r["cached_tokens"] for r in results]
    want_chunks = [-(-(len(b["tokens"]) - c) // chunk)
                   if len(b["tokens"]) > chunk else 0
                   for b, c in zip(bodies, cached)]
    want_rows = sum(want_chunks) * cfg.n_layers if engine.paged else 0
    chunked = [len(b["tokens"]) for b, c in zip(bodies, want_chunks) if c]
    _log(f"{tag}: chunked prompts {chunked} ({sum(want_chunks)} chunks; "
         f"cached tokens {cached}): multi-row launches "
         f"{launches['paged_attention_rows']}, expected {want_rows}")
    if launches["paged_attention_rows"] != want_rows or mma_launches:
        raise AssertionError(f"{tag}: the wgmma multi-row body launched "
                             f"{launches['paged_attention_rows']} times "
                             f"(expected {want_rows}), the mma.sync body "
                             f"{mma_launches} (expected 0)")
    trailers = [r.get("prefill_chunks") for r in results[:len(prompts)]]
    if trailers != want_chunks[:len(prompts)]:
        raise AssertionError(f"{tag}: trailers report prefill_chunks "
                             f"{trailers}, expected "
                             f"{want_chunks[:len(prompts)]}")
    for i, r in enumerate(results):
        toks = r["tokens"]
        if len(toks) != 32 and not (toks and toks[-1] == engine.eos_id):
            raise AssertionError(f"{tag}: request {i}: {len(toks)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{tag}: request {i}: token outside the "
                                 f"vocab")
    ttft = sorted(r["ttft_ms"] for r in results)
    n_tok = sum(len(r["tokens"]) for r in results)
    decode_s = wall - ttft[0] / 1e3
    tps = (n_tok - len(results)) / decode_s
    _log(f"{tag}: TTFT ms min {ttft[0]:.1f} median "
         f"{ttft[len(ttft) // 2]:.1f} max {ttft[-1]:.1f}; decode "
         f"{tps:.1f} tokens/s over {len(results)} requests on {card}")
    for label, is_chunked in (("chunked", True), ("wave", False)):
        part = sorted(r["ttft_ms"] for r, c in zip(results, want_chunks)
                      if bool(c) == is_chunked)
        _log(f"{tag}: TTFT ms of the {len(part)} {label} requests: "
             + ", ".join(f"{t:.1f}" for t in part))
    _log(f"{_sub(tag, 'prefix')}: cold {pair['cold_ttft']:.1f} ms TTFT, "
         f"warm {pair['warm_ttft']:.1f} ms, the warm prompt cold after "
         f"clear_prefix_cache() {pair['recold_ttft']:.1f} ms; {card}")
    return dict(launches=launches, results=results, prompts=prompts,
                twins=twins, wall=wall, ttft=ttft, tps=tps, pair=pair)


def _zero_launches() -> None:
    """Set the serving kernels' launch counts to 0: K2, K1's decode body
    and its two multi-row bodies."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    for f in (fa.flash_attention_fwd, pa.paged_attention,
              pa.paged_attention_rows):
        f.launches = 0
    pa.paged_attention_rows.mma_launches = 0


def _read_launches() -> dict:
    """The counts :func:`_zero_launches` sets, by ``KERNELS`` name."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    n = {f.__name__: f.launches for f in (
        fa.flash_attention_fwd, pa.paged_attention, pa.paged_attention_rows)}
    n["paged_attention_rows_mma"] = pa.paged_attention_rows.mma_launches
    return n


def phase_serve(dev, card: str):
    """Returns {path: {kernel: launches}}: the bf16 leg's 9-request run
    (``serve``), the float32 leg's kernel engine (``serve[fp32]``), the
    float32 int8 legs' (``serve[fp32,int8 KV]`` on the float32 weights,
    ``serve[fp32,int8]`` on them quantized) and the int8 leg's 9-request
    run (``serve[int8]``)."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import kvcache
    from skypilot_tpu_torch.infer import server as srv

    chunk = 512
    t0 = time.time()
    # The reference server's defaults: chunks of 512, a prefix pool of 8
    # and n-gram speculation at K = 4. The wave cap is the batch's
    # request count (see _serve_leg); it never binds on these waves (at
    # most 5 prompts share a bucket). Decode runs every slot at every
    # step, so it is batch-invariant.
    engine = srv.make_engine("llama3-8b", slots=16, max_len=1024,
                             admit_wave=len(_batch_bodies(chunk)[0]),
                             kv_block=256,
                             prefill_chunk=chunk, prefix_pool=8, spec_k=4,
                             device=dev, seed=SEED)
    cfg = engine.cfg
    torch.cuda.synchronize()
    _log(f"serve: llama3-8b {cfg.n_layers} layers d_model {cfg.d_model} "
         f"({cfg.num_params() / 1e9:.2f}B params, bf16) built in "
         f"{time.time() - t0:.1f} s")
    bf16 = _serve_leg(engine, "serve", card, chunk)
    results, prompts, twins = bf16["results"], bf16["prompts"], bf16["twins"]
    lens = [len(p) for p in prompts]
    # The wave prompt's twins share every program: equal tokens. The
    # chunked prompt's twins share their chunk programs, so their first
    # tokens are equal; they start decoding at different times, so
    # their bursts split the staged and cached columns at other
    # positions, which reorders fp32 sums that bf16 then rounds: from
    # there they may part (reported below with the plain top-2 gap).
    stream_chunk, stream_wave = results[len(prompts):]
    if stream_wave["tokens"] != results[twins[1]]["tokens"]:
        raise AssertionError("streamed tokens differ from the blocking "
                             "ones for the same wave prompt")
    if stream_chunk["tokens"][0] != results[twins[0]]["tokens"][0]:
        raise AssertionError("the streamed twin of a chunked prompt has "
                             "another first token than the blocking one")
    pair = bf16["pair"]
    t, gap, _ = _divergence(engine, pair["prompt"], pair["warm"],
                            pair["recold"])
    _log("serve[prefix, bf16]: the warm request's tokens " + (
        "equal its cold rerun's over 32 steps" if t is None
        else f"part from its cold rerun's at step {t}, plain top-2 gap "
             f"{gap:.3e} (its bursts start at other times)"))

    _long_chunks(engine, dev, card)

    # Kernels against plain attention, same card, same weights, the
    # shortest and the longest prompt. In bf16, the served numbers,
    # any fp32 summation-order difference flips some bf16 roundings and
    # 32 layers carry them to the logits (PERF.md), so the divergence
    # is reported; the 1e-2 gap rule is asserted on the same weights
    # widened to float32, where that noise is gone.
    pick = [int(np.argmin(lens)), int(np.argmax(lens))]
    picked = [prompts[i] for i in pick]
    got, want, ref = _kernel_vs_plain(engine.params, cfg, engine, dev,
                                      picked, "bf16")
    for i, g, w in zip(pick, got, want):
        t, gap, _ = _divergence(ref, prompts[i], g, w)
        _log(f"serve[bf16]: prompt {i} ({lens[i]} tokens): " + (
            "kernel and plain paths agree over 32 steps" if t is None
            else f"paths diverge at step {t}, plain top-2 gap "
                 f"{gap:.3e}") + "; the server gave "
             f"{'the same' if results[i]['tokens'] == g else 'other'} "
             f"tokens as the kernel path")
    t, gap, _ = _divergence(ref, prompts[twins[0]], stream_chunk["tokens"],
                            results[twins[0]]["tokens"])
    _log(f"serve[bf16]: the streamed twin of chunked prompt {twins[0]} " + (
        "equals the blocking one over 32 steps" if t is None
        else f"parts from the blocking one at step {t}, plain top-2 gap "
             f"{gap:.3e}"))
    del ref
    # The float32 leg: the first CUT_LAYERS layers of the same weights.
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                n_layers=CUT_LAYERS)
    params32 = {k: ({n: w[:CUT_LAYERS].float() for n, w in v.items()}
                    if k == "blocks" else v.float())
                for k, v in engine.params.items()}
    want_rows = sum(-(-len(p) // chunk) for p in picked
                    if len(p) > chunk) * cfg32.n_layers
    # The float32 leg's kernel engine reads float32 pools: its chunks
    # run the mma.sync multi-row body, counted from 0 here.
    _zero_launches()
    got, want, ref = _kernel_vs_plain(params32, cfg32, engine, dev, picked,
                                      "fp32")
    launches32 = _read_launches()
    _log(f"serve[fp32]: launches {launches32}; the mma.sync multi-row "
         f"body expected {want_rows}")
    if launches32["paged_attention_rows_mma"] != want_rows or not want_rows \
            or launches32["paged_attention_rows"]:
        raise AssertionError(
            f"fp32 leg: the mma.sync multi-row body launched "
            f"{launches32['paged_attention_rows_mma']} times (expected "
            f"{want_rows} > 0), the wgmma body "
            f"{launches32['paged_attention_rows']} (expected 0 on float32 "
            f"pools)")
    for i, g, w in zip(pick, got, want):
        _agree(ref, prompts[i], g, w, f"prompt {i} ({lens[i]} tokens)",
               "kernel and plain paths")
    _spec_and_prefix_fp32(params32, cfg32, engine, dev, picked, got, ref,
                          chunk)
    del ref

    # The float32 int8 legs, on int8 KV pools and the first
    # INT8_FP32_LAYERS layers of the same weights (the serve[int8] leg
    # runs the recipe at the phase's depth): their chunks send bf16 q to int8
    # pools, so they run the wgmma multi-row body, and their decode the
    # decode body on int8 pools. First on the float32 weights (int8 KV
    # alone leaves the paths' logits as close as float32 pools do), then
    # on them quantized once (w8a8), whose activation rounding sets its
    # own noise floor (_divergence), as large at 2 layers as at 32.
    cfg_i8 = dataclasses.replace(cfg32, n_layers=INT8_FP32_LAYERS)
    params_i8 = dict(params32, blocks={
        n: w[:INT8_FP32_LAYERS].clone()
        for n, w in params32["blocks"].items()})
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    want_chunks = want_rows // cfg32.n_layers
    launches_kv8 = _fp32_int8_leg(params_i8, cfg_i8, engine, dev, prompts,
                                  pick, chunk, want_chunks,
                                  "fp32, int8 KV", kv_int8=True)
    t0 = time.time()
    w8 = {"blocks": kvcache.quantize_block_weights(params_i8),
          "head": kvcache.quantize_head(params_i8, cfg_i8)}
    params_i8 = kvcache.slim_params(params_i8)
    _log(f"serve[fp32, int8]: llama3-8b float32 weights quantized in "
         f"{time.time() - t0:.1f} s ({INT8_FP32_LAYERS} of {cfg.n_layers} "
         f"layers)")
    launches32i = _fp32_int8_leg(params_i8, cfg_i8, engine, dev, prompts,
                                 pick, chunk, want_chunks,
                                 "fp32, int8", kv_int8=True, qweights=w8)
    del params_i8, w8, engine
    gc.collect()
    torch.cuda.empty_cache()

    launches8 = _serve_int8(dev, card, chunk, bf16)
    return {"serve": bf16["launches"], "serve[fp32]": launches32,
            "serve[fp32,int8 KV]": launches_kv8,
            "serve[fp32,int8]": launches32i, "serve[int8]": launches8}


def _fp32_int8_leg(params, cfg, like, dev, prompts, pick, chunk,
                   want_chunks, leg: str, **kw) -> dict:
    """A float32 int8 leg (``kw``: the int8 recipe's engine options):
    the kernel engine against the plain-attention engine on the shortest
    and the longest prompt, launches counted from 0 (the wgmma
    multi-row body once a layer per chunk, the mma.sync one never, the
    decode body on int8 pools), then speculation and the prefix pair
    (:func:`_spec_and_prefix_fp32`), every token comparison under
    :func:`_agree`. Returns the kernel engine's launches."""
    picked = [prompts[i] for i in pick]
    want_rows = want_chunks * cfg.n_layers
    _zero_launches()
    got, want, ref = _kernel_vs_plain(params, cfg, like, dev, picked, leg,
                                      **kw)
    launches = _read_launches()
    _log(f"serve[{leg}]: launches {launches}; the wgmma multi-row body "
         f"expected {want_rows}, on int8 pools")
    if launches["paged_attention_rows"] != want_rows \
            or launches["paged_attention_rows_mma"] \
            or not launches["paged_attention"]:
        raise AssertionError(
            f"{leg} leg: the wgmma multi-row body launched "
            f"{launches['paged_attention_rows']} times (expected "
            f"{want_rows}), the mma.sync one "
            f"{launches['paged_attention_rows_mma']} (expected 0), the "
            f"decode body {launches['paged_attention']} (expected > 0)")
    for i, g, w in zip(pick, got, want):
        _agree(ref, prompts[i], g, w,
               f"prompt {i} ({len(prompts[i])} tokens)",
               "kernel and plain paths", leg)
    _spec_and_prefix_fp32(params, cfg, like, dev, picked, got, ref, chunk,
                          leg, **kw)
    del ref
    gc.collect()
    return launches


def _serve_int8(dev, card: str, chunk: int, bf16: dict) -> dict:
    """The ``serve[int8]`` leg: the recipe of ``llm/serve-8b-w8a8.yaml``
    as far as the port's server has its flags (``--slots 32 --max-len
    1280 --weights-int8 --kv-int8 --max-burst 32 --admit-wave 4``, with
    the reference server's defaults: chunks of 512, a prefix pool of 8,
    spec K 4; its ``--open-burst`` waits for the rest of the server,
    ROADMAP Queue 1 item 7) at llama3-8b full width (``SERVE_LAYERS``), random
    bf16 weights from seed 0 quantized once on the card. Checks the int8
    pools and bf16 scales, the slim weight tree and the device memory
    after the build, then serves the bf16 leg's 9 requests and the
    shared-prefix pair (:func:`_serve_leg`) and profiles one decode
    burst over all 32 slots. Returns the batch's launches."""
    import torch
    from skypilot_tpu_torch.infer import server as srv
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    t0 = time.time()
    engine = srv.make_engine("llama3-8b", slots=32, max_len=1280,
                             admit_wave=4, kv_block=256,
                             prefill_chunk=chunk, prefix_pool=8, spec_k=4,
                             kv_int8=True, weights_int8=True, device=dev,
                             seed=SEED)
    torch.cuda.synchronize()
    gc.collect()
    built = time.time() - t0
    cfg = engine.cfg
    c = engine.cache
    if (c["k"].dtype, c["v"].dtype) != (torch.int8, torch.int8) or \
            (c["k_scale"].dtype, c["v_scale"].dtype) != (torch.bfloat16,
                                                         torch.bfloat16):
        raise AssertionError(f"serve[int8]: pools {c['k'].dtype}, scales "
                             f"{c['k_scale'].dtype}; int8 and bf16 "
                             f"expected")
    if set(engine.params) != {"embed", "final_norm", "blocks"} or \
            set(engine.params["blocks"]) != {"ln1", "ln2"}:
        raise AssertionError("serve[int8]: the engine kept float block "
                             "matrices or a float head")
    d, ff, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    # The int8 weights, the bf16 embedding and the int8 KV by the config,
    # and the bytes of every tensor the engine holds (those plus the
    # scales, norms and slot state).
    blocks = L * (2 * d * nh * hd + 2 * d * nkv * hd + 3 * d * ff)
    head, embed = d * v, 2 * v * d
    kv = c["k"].numel() * 2
    scales = c["k_scale"].numel() * 2 * 2

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(t) for t in tree.values())
        return tree.numel() * tree.element_size()

    held = nbytes(engine.params) + nbytes(engine.qweights) + nbytes(c)
    small = held - (blocks + head + embed + kv + scales)
    got = torch.cuda.memory_allocated(dev) - base
    gb = 1e9
    _log(f"serve[int8]: llama3-8b w8a8 + int8 KV built in {built:.1f} s; "
         f"memory_allocated after the build {got / gb:.3f} GB above the "
         f"baseline: weights {(blocks + head + embed + small) / gb:.3f} GB "
         f"(int8 block matrices {blocks / gb:.3f}, int8 head "
         f"{head / gb:.3f}, bf16 embedding {embed / gb:.3f}; scales, "
         f"norms and slot state {small / gb:.4f}), KV int8 "
         f"{kv / gb:.3f} GB + scales {scales / 1e6:.1f} MB "
         f"({c['k'].shape[1]} blocks of 256 rows); "
         f"the bf16 tree would be {cfg.num_params() * 2 / gb:.2f} GB; "
         f"{card}")
    # The smallest float block matrix (wk in bf16) is 0.27 GB.
    if not 0 <= small < 0.01 * gb or not held <= got <= held + 0.1 * gb:
        raise AssertionError(f"serve[int8]: {got / gb:.3f} GB allocated, "
                             f"the engine holds {held / gb:.3f} GB, "
                             f"{(held - small) / gb:.3f} GB of int8 "
                             f"weights, bf16 embedding and int8 KV: a "
                             f"float copy stayed resident")
    int8 = _serve_leg(engine, "serve[int8]", card, chunk, max_burst=32)
    med = [r['ttft'][len(r['ttft']) // 2] for r in (int8, bf16)]
    _log(f"serve[int8] beside serve (one call, {card}): TTFT ms median "
         f"{med[0]:.1f} (max {int8['ttft'][-1]:.1f}) against {med[1]:.1f} "
         f"(max {bf16['ttft'][-1]:.1f}); decode {int8['tps']:.1f} against "
         f"{bf16['tps']:.1f} tokens/s; wall {int8['wall']:.2f} against "
         f"{bf16['wall']:.2f} s; prefix pair warm/cold TTFT "
         f"{int8['pair']['warm_ttft']:.1f}/{int8['pair']['recold_ttft']:.1f} "
         f"against {bf16['pair']['warm_ttft']:.1f}/"
         f"{bf16['pair']['recold_ttft']:.1f} ms")
    _profile_int8_burst(engine, card)
    del engine
    _int_mm_layouts(dev, card)
    return int8["launches"]


def _int_mm_layouts(dev, card: str) -> None:
    """``torch._int_mm`` at llama3-8b's w8a8 shapes with the weight
    column-major (``kvcache.int8_layout``, what the port stores) and
    row-major: the time of each (CUDA events), or the error that refuses
    it."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for m, k, n in ((17, 4096, 4096), (17, 4096, 14336), (17, 14336, 4096),
                    (512, 4096, 14336), (17, 4096, 128256)):
        a = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        times = []
        for b in (w.t().contiguous().t(), w):
            try:
                ms = _time_ms(lambda i: torch._int_mm(a, b), 20)
                times.append(f"{ms:.4f} ms")
            except RuntimeError as e:
                times.append(f"refused ({str(e).splitlines()[0][:60]})")
        _log(f"serve[int8, _int_mm]: {m}x{k}x{n}: column-major weight "
             f"{times[0]}, row-major {times[1]}; {card}")


def _profile_int8_burst(engine, card: str) -> None:
    """All 32 slots decoding (prompts of 330-500 tokens, so every slot
    sits on the span rung of 640 rows and a burst is one group): one
    8-step decode burst timed on the host, then one profiled, its device
    time
    split by class: ``torch._int_mm`` (the kernels the
    ``aten::_int_mm`` op launched), the quantizers (the kernels of ops
    run inside ``_act_quant`` and ``quantize_rows``, marked for this
    burst by ``record_function``), K1's decode body (by kernel name) and
    the rest."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from skypilot_tpu_torch.infer import kvcache
    from skypilot_tpu_torch.ops import paged_attention as pa
    rng = np.random.default_rng(SEED + 2)
    for n in rng.integers(330, 501, engine.n_slots):
        engine.add_request(
            rng.integers(1, engine.cfg.vocab_size, n).tolist(), 64)
    engine.admit()
    if len(engine.slot_req) != engine.n_slots:
        raise AssertionError(f"serve[int8, decode burst]: "
                             f"{len(engine.slot_req)} of {engine.n_slots} "
                             f"slots admitted")
    k = 8
    engine.complete_decode_burst(engine.dispatch_decode_burst(k))   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.complete_decode_burst(engine.dispatch_decode_burst(k))
    wall = (time.perf_counter() - t0) * 1e3
    label = "w8a8.quantize"
    real = (kvcache._act_quant, kvcache.quantize_rows)

    def marked(fn):
        def inner(*a):
            with record_function(label):
                return fn(*a)
        return inner

    n0 = pa.paged_attention.launches
    kvcache._act_quant, kvcache.quantize_rows = map(marked, real)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            handle = engine.dispatch_decode_burst(k)
            engine.complete_decode_burst(handle)
            torch.cuda.synchronize()
    finally:
        kvcache._act_quant, kvcache.quantize_rows = real
    n_k1 = pa.paged_attention.launches - n0
    groups = len(handle.parts)
    by = {"int_mm": 0.0, "quantizers": 0.0, "K1": 0.0, "total": 0.0}
    cuda = torch.autograd.DeviceType.CUDA
    for evt in prof.events():
        if getattr(evt, "device_type", None) == cuda:
            if evt.name != label:
                ms = evt.time_range.elapsed_us() / 1e3
                by["total"] += ms
                if "paged_attention_kernel" in evt.name:
                    by["K1"] += ms
            continue
        kernels = sum(kn.duration for kn in getattr(evt, "kernels", ())
                      ) / 1e3
        # A kernel belongs to the innermost op that launched it; its
        # class is that of the nearest marked ancestor, itself included.
        up = evt
        while kernels and up is not None and up.name not in (
                "aten::_int_mm", label):
            up = up.cpu_parent
        if kernels and up is not None:
            by["int_mm" if up.name == "aten::_int_mm"
               else "quantizers"] += kernels
    rest = by["total"] - by["int_mm"] - by["quantizers"] - by["K1"]
    _log(f"serve[int8, decode burst]: {engine.n_slots} slots x {k} steps "
         f"in {groups} span group(s): "
         f"wall {wall:.2f} ms unprofiled ({wall / k:.2f} ms a step); one "
         f"profiled burst's device time {by['total']:.2f} ms: _int_mm "
         f"{by['int_mm']:.2f}, quantizers {by['quantizers']:.2f}, K1 "
         f"decode body {by['K1']:.2f} ({n_k1} launches), rest {rest:.2f}; "
         f"{card}")
    want = k * engine.cfg.n_layers * groups
    if n_k1 != want or groups != 1 or not by["int_mm"] or \
            not by["quantizers"] or not by["K1"]:
        raise AssertionError(f"serve[int8, decode burst]: {n_k1} K1 "
                             f"launches (expected {want}) in {groups} span "
                             f"groups (expected 1), or a class with no "
                             f"device time: {by}")
    engine.reset()


def _agree(ref, prompt, got, want, what: str, paths: str,
           leg: str = "fp32", low=None, adapter=None) -> None:
    """Greedy tokens ``got`` and ``want`` of ``prompt`` agree, or part
    only where the plain logits' top-2 gap is at most 1e-2 (a near-tie,
    which fp32 summation order may flip) or, on a w8a8 engine or with
    ``low`` (bf16 tokens), at most the noise floor there
    (:func:`_divergence`; ``adapter``: the fine-tune they ran under)."""
    t, gap, noise = _divergence(ref, prompt, got, want, low, adapter)
    bound = max(1e-2, noise)
    kind = ("w8a8" if ref.qweights is not None
            else "bf16" if low is not None else None)
    floor = f", {kind} noise floor {noise:.3e}" if kind else ""
    if t is not None and gap > bound:
        raise AssertionError(
            f"{leg}: {paths} differ on {what} at step {t} where the plain "
            f"top-2 logit gap is {gap:.4f} > {bound:.4f} (1e-2{floor})")
    _log(f"serve[{leg}]: {what}: " + (
        f"{paths} agree over {len(got)} steps" if t is None
        else f"{paths} diverge at step {t} on a near-tie (plain top-2 gap "
             f"{gap:.3e} <= {bound:.3e}: 1e-2{floor})"))


class _Replay:
    """Drafter factory (the engine's ``spec_drafter`` seam) that replays
    each prompt's known greedy continuation: the oracle, or with
    ``shift`` an anti-oracle whose every draft token is wrong."""

    def __init__(self, outputs, shift: int = 0, vocab: int = 0):
        self.outputs, self.shift, self.vocab = outputs, shift, vocab

    def __call__(self, req):
        return _Replay._Drafter(self, self.outputs[tuple(req.prompt)])

    class _Drafter:
        def __init__(self, factory, out):
            self.f, self.out, self.seen = factory, out, 0

        def catch_up(self, prompt, generated):
            self.seen = len(generated)

        def draft(self, k):
            nxt = self.out[self.seen:self.seen + k]
            if not self.f.shift:
                return list(nxt)
            return [(t + self.f.shift) % self.f.vocab for t in nxt]


def _spec_and_prefix_fp32(params, cfg, like, dev, prompts, spec_off, ref,
                          chunk, leg: str = "fp32", **kw) -> None:
    """The float32 legs' speculation and prefix checks, on the kernel
    path with the server engine's shapes (and ``kw``, the int8 recipe's
    options on the int8 legs; ``leg`` names the leg): greedy tokens with
    spec_k 4 and an oracle drafter (every verify position accepts, so
    K1's decode body runs at every window position) and with an
    anti-oracle (every draft rejected, none accepted) equal the spec-off
    tokens; a warm prefix hit equals its cold run after
    clear_prefix_cache(). Tokens that differ are held to :func:`_agree`'s
    rule."""
    import torch
    from skypilot_tpu_torch.ops import paged_attention as pa

    def engine(**more):
        return _engine_like(params, cfg, like, dev, **kw, **more)

    outputs = {tuple(p): t for p, t in zip(prompts, spec_off)}
    for label, factory in (
            ("oracle", _Replay(outputs)),
            ("anti-oracle", _Replay(outputs, 1, cfg.vocab_size))):
        e = engine(spec_k=4, spec_drafter=factory)
        e.spec_min_rate = 0.0         # keep drafting to the end
        d0 = pa.paged_attention.launches
        got = e.generate(prompts, max_new_tokens=32)
        drafted, accepted = e._spec_drafted_total, e._spec_accepted_total
        _log(f"serve[{leg}, spec {label}]: {e.verify_calls} verify calls, "
             f"drafted {drafted}, accepted {accepted}; K1 decode launches "
             f"{pa.paged_attention.launches - d0}")
        if not e.verify_calls or not drafted:
            raise AssertionError(f"{leg} {label}: no verify round ran")
        if label == "anti-oracle" and accepted:
            raise AssertionError(f"{leg} anti-oracle accepted {accepted}")
        if label == "oracle" and got == spec_off and accepted != drafted:
            raise AssertionError(f"{leg} oracle accepted {accepted} of "
                                 f"{drafted}")
        for p, g, w in zip(prompts, got, spec_off):
            _agree(ref, p, g, w, f"{len(p)}-token prompt, {label}",
                   "spec-on and spec-off tokens", leg)
        del e
        gc.collect()
        torch.cuda.empty_cache()
    cold_p, warm_p = _pair_prompts(cfg, chunk)
    e = engine(prefix_pool=8, spec_k=4)
    e.generate([cold_p], max_new_tokens=32)
    e.finished.clear()
    warm = e.generate([warm_p], max_new_tokens=32)[0]
    cached = e.finished[0].cached_len
    e.finished.clear()
    e.clear_prefix_cache()
    cold = e.generate([warm_p], max_new_tokens=32)[0]
    if cached != chunk or e.finished[0].cached_len:
        raise AssertionError(f"{leg} prefix pair: cached {cached} warm, "
                             f"{e.finished[0].cached_len} cold")
    _agree(ref, warm_p, warm, cold, f"{len(warm_p)}-token prompt",
           "warm (512 cached) and cold tokens", leg)
    del e
    gc.collect()
    torch.cuda.empty_cache()


def _pair_prompts(cfg, chunk):
    """Two prompts sharing a 600-token prefix, 820 and 760 tokens long:
    the first stores its first 512 tokens, the second hits them."""
    import numpy as np
    rng = np.random.default_rng(SEED + 1)
    shared = rng.integers(1, cfg.vocab_size, 600).tolist()
    return (shared + rng.integers(1, cfg.vocab_size, 220).tolist(),
            shared + rng.integers(1, cfg.vocab_size, 160).tolist())


def _prefix_pair(model, engine, url, cfg, chunk, tag: str) -> dict:
    """The shared-prefix pair through the server, one after the other,
    then the second again after clear_prefix_cache(): the first reports
    no hit and 2 chunks, the second a 512-token hit and 1 chunk whose
    multi-row launches (32) read the first's shared blocks from start
    512 (a contiguous engine: its pool row, through the gather, with no
    multi-row launch), and the rerun no hit again."""
    from skypilot_tpu_torch.ops import paged_attention as pa
    # One request at a time: the server's default admission window
    # (12 ms), not the batch's 0.5 s, so TTFT is the prefill's.
    model.coalesce_s = 0.012
    cold_p, warm_p = _pair_prompts(cfg, chunk)
    out = {}
    for label, prompt, want in (
            ("cold", cold_p, (False, 0, 2)), ("warm", warm_p,
                                              (True, chunk, 1)),
            ("recold", warm_p, (False, 0, 2))):
        if label == "recold":
            # The loop thread touches the engine only while a request is
            # in flight; none is.
            engine.clear_prefix_cache()
        pa.paged_attention_rows.launches = 0
        hits = engine.prefix_hits
        r = _post(url, {"tokens": prompt, "max_new_tokens": 32})
        rows = pa.paged_attention_rows.launches
        got = (r["cache_hit"], r["cached_tokens"], r["prefill_chunks"])
        _log(f"{_sub(tag, 'prefix')}: {label} {len(prompt)}-token prompt: "
             f"cache_hit {got[0]}, cached_tokens {got[1]}, prefill_chunks "
             f"{got[2]}, multi-row launches {rows}, TTFT {r['ttft_ms']} "
             f"ms, spec drafted {r['spec_drafted']} accepted "
             f"{r['spec_accepted']}")
        want_rows = want[2] * cfg.n_layers if engine.paged else 0
        if got != want or rows != want_rows \
                or engine.prefix_hits - hits != int(want[0]):
            raise AssertionError(
                f"{tag} prefix pair, {label}: (cache_hit, cached_tokens, "
                f"prefill_chunks) {got}, expected {want}; multi-row "
                f"launches {rows}, expected {want_rows}")
        out[label] = r["tokens"]
        out[f"{label}_ttft"] = r["ttft_ms"]
    out["prompt"] = warm_p
    return out


# name: (route, source, the TPU kernel it replaces)
KERNELS = {
    "paged_attention": ("cuda", "skypilot_tpu_torch/csrc/paged_attention.cu",
                        "skypilot_tpu/ops/paged_attention.py:67"),
    # The same TPU kernel's chunk-path use (C * rep rows a kv-head):
    # the wgmma + TMA body (bf16 q on bf16 or int8 pools) and the
    # mma.sync body (float32 pools).
    "paged_attention_rows": ("cuda",
                             "skypilot_tpu_torch/csrc/paged_attention.cu",
                             "skypilot_tpu/ops/paged_attention.py:67"),
    "paged_attention_rows_mma": ("cuda",
                                 "skypilot_tpu_torch/csrc/paged_attention.cu",
                                 "skypilot_tpu/ops/paged_attention.py:67"),
    "flash_attention_fwd": ("cuda", "skypilot_tpu_torch/csrc/flash_fwd.cu",
                            "skypilot_tpu/ops/flash_attention.py:58"),
    "flash_attention_bwd_dkv": ("cuda",
                                "skypilot_tpu_torch/csrc/flash_bwd.cu",
                                "skypilot_tpu/ops/flash_attention.py:170"),
    "flash_attention_bwd_dq": ("cuda", "skypilot_tpu_torch/csrc/flash_bwd.cu",
                               "skypilot_tpu/ops/flash_attention.py:226"),
}


# ---------------------------------------------------------------------------
# Phase 5: training
# ---------------------------------------------------------------------------

def _plain_attention(q, k, v, segment_ids=None):
    """Causal einsum attention on GQA-expanded K/V, which autograd
    differentiates independently of the kernels' formula."""
    from skypilot_tpu_torch.ops import attention
    rep = q.shape[2] // k.shape[2]
    return attention.xla_attention(q, attention.repeat_kv(k, rep),
                                   attention.repeat_kv(v, rep), causal=True,
                                   segment_ids=segment_ids)


def _grad_parity(dev, dtype) -> dict:
    """llama3-1b width (d_model 2048, 16/8 heads, head_dim 128, d_ff
    8192, vocab 128256) at 2 layers, one packed batch of 2 x 2048: loss
    and gradients through the kernels and through autograd of einsum
    attention, on the same card and weights. Returns the loss difference
    and, per parameter (over all its layers), max|kernel - plain| /
    max|plain|."""
    import torch
    from skypilot_tpu_torch.data import input_pipeline as ip
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer
    cfg = dataclasses.replace(llama.CONFIGS["llama3-1b"], n_layers=2,
                              dtype=dtype, xent_chunk=512)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = llama.init_params(cfg, gen, device=dev)
    docs = ip.synthetic_doc_stream(64, cfg.vocab_size, mean_len=600,
                                   seed=SEED)
    batch = ip.to_device(next(ip.packed_batches(docs, 2, 2048)), dev)
    got = trainer.grads_of(params, batch, cfg)
    want = trainer.grads_of(params, batch, cfg, attention=_plain_attention)
    # One name per entry of the gradient lists: a stacked block tensor
    # gives one gradient per layer.
    names = [f"{k}.{n}" if k == "blocks" else k
             for k, w in params.items()
             for n in (w if k == "blocks" else [None])
             for _ in range(w[n].shape[0] if k == "blocks" else 1)]
    diff, scale = {}, {}
    for n, g, w in zip(names, got[2], want[2]):
        diff[n] = max(diff.get(n, 0.0), (g - w).abs().max().item())
        scale[n] = max(scale.get(n, 0.0), w.abs().max().item())
    return {"loss_kernel": got[0].item(), "loss_plain": want[0].item(),
            "grad_rel": {n: diff[n] / scale[n] for n in diff}}


def _tree_equal(a, b) -> bool:
    import torch
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _run_main(argv) -> dict:
    """``train.run.main`` with its summary line kept off this script's
    stdout (whose last two lines are the contract's)."""
    import contextlib
    import io
    from skypilot_tpu_torch.train import run
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = run.main(argv)
    _log(f"train: run.main({' '.join(argv)}) -> {buf.getvalue().strip()}")
    return res


def _profile_train_step(dev, card: str) -> None:
    """One llama3-1b step (batch 4 x 2048, after a warm-up step) under
    torch.profiler (``_profile_step``)."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer
    cfg = dataclasses.replace(llama.CONFIGS["llama3-1b"], xent_chunk=512)
    tc = trainer.TrainConfig(warmup_steps=1, total_steps=6)
    state = trainer.create_train_state(cfg, tc, dev)
    step = trainer.make_train_step(cfg, tc)
    batch = trainer.synthetic_batch(cfg, 4, 2048, device=dev)
    _profile_step(lambda: step(state, batch), "train[profile]: llama3-1b",
                  card)


def _profile_step(run_step, label: str, card: str) -> None:
    """``run_step()`` once to warm up, then once under torch.profiler:
    device time by kernel class and the device's idle share of the
    step's wall time (kernels run on one stream, so their times add up
    without overlap). The device alone is traced: host operators would
    add the tracer's own cost to the wall and take seconds to parse."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run_step()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    classes = {"K2 flash_fwd": ("flash_fwd",), "K3 flash_bwd_dkv":
               ("flash_bwd_dkv",), "K4 flash_bwd_dq": ("flash_bwd_dq",),
               "K1 paged": ("paged",),
               "matmul": ("gemm", "xmma", "cutlass", "cublas", "nvjet")}
    by = {c: 0.0 for c in list(classes) + ["other"]}
    other = {}
    n = 0
    for evt in prof.events():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        name = evt.name.lower()
        cls = next((c for c, keys in classes.items()
                    if any(k in name for k in keys)), "other")
        by[cls] += us / 1e3
        if cls == "other":
            other[evt.name] = other.get(evt.name, 0.0) + us / 1e3
        n += 1
    busy = sum(by.values())
    if n == 0:
        _log(f"{label}: the profiler recorded no device activity; device "
             f"time by kernel not measured")
        return
    _log(f"{label} step wall {wall_ms:.1f} ms under the "
         f"profiler; {n} device activities, busy {busy:.1f} ms, idle "
         f"share {max(0.0, 1 - busy / wall_ms):.3f}; device ms by class "
         + ", ".join(f"{c} {t:.1f}" for c, t in by.items()) + f"; {card}")
    top = sorted(other.items(), key=lambda kv: -kv[1])[:8]
    _log(f"{label.split(':')[0]}: largest 'other' kernels (ms): "
         + "; ".join(f"{t:.1f} {name[:90]}" for name, t in top))


@contextlib.contextmanager
def _tap(module, name: str, seen: list, keep=None):
    """Wrap ``module.name`` for the block: each call's result (or
    ``keep`` of it) is appended to ``seen``; the result is returned."""
    real = getattr(module, name)

    def tapped(*a, **kw):
        out = real(*a, **kw)
        seen.append(keep(out) if keep else out)
        return out

    setattr(module, name, tapped)
    try:
        yield
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def _path_shapes(seen: dict):
    """Record, for the block, each distinct shape at which the serving
    path reaches K1 (``kvcache._paged_attn_stats`` off the plain path)
    and K2 (``attention.gqa_attention``). ``seen`` maps each shape to
    [calls, inputs to rebuild it]: K1's table and lengths (cloned at the
    first call), K2's segment ids and causal flag. It records only: the
    wrappers and their launch counts are untouched."""
    from skypilot_tpu_torch.infer import kvcache
    from skypilot_tpu_torch.ops import attention as attn_ops
    real_k1, real_k2 = kvcache._paged_attn_stats, attn_ops.gqa_attention

    def note(key, make):
        if key not in seen:
            seen[key] = [0, make()]
        seen[key][0] += 1

    def k1(cache, i, table, qh, lengths, span, plain=False):
        if not plain:
            k = cache["k"]
            M = span if span is not None else kvcache._logical_rows(
                cache, table)
            note(("K1", tuple(qh.shape), qh.dtype, tuple(k.shape[1:]),
                  k.dtype, tuple(table.shape), -(-M // k.shape[2])),
                 lambda: (table.clone(), lengths.clone()))
        return real_k1(cache, i, table, qh, lengths, span, plain)

    def k2(q, k, v, causal=True, segment_ids=None):
        note(("K2", tuple(q.shape), tuple(k.shape), q.dtype, causal,
              segment_ids is not None),
             lambda: (None if segment_ids is None
                      else segment_ids.clone()))
        return real_k2(q, k, v, causal, segment_ids)

    kvcache._paged_attn_stats, attn_ops.gqa_attention = k1, k2
    try:
        yield
    finally:
        kvcache._paged_attn_stats, attn_ops.gqa_attention = real_k1, real_k2


def _check_path_shapes(seen: dict, leg: str, dev) -> None:
    """K1 and K2 against their plain versions at every shape that
    :func:`_path_shapes` recorded, under the kernel phase's tolerances:
    random q, K and V (pools of two layers, read at layer 1) at the
    path's shapes, with its recorded table, lengths and span, or
    segment ids. Run after a leg's launches are read, so they count on
    no path."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    kv_name = {torch.bfloat16: "bf16", torch.int8: "int8",
               torch.float32: "f32"}
    pools, errs, shapes = {}, {"K1": 0.0, "K2": 0.0}, []
    for key, (n, saved) in seen.items():
        if key[0] == "K1":
            _, qshape, qdtype, pshape, kvdtype, tshape, sb = key
            B, G, R, hd = qshape
            name = (f"{leg} K1 B={B} R={R} blocks of {pshape[1]} "
                    f"x {tshape[1] - 1} span {sb}")
            if (pshape, kvdtype) not in pools:
                pools[(pshape, kvdtype)] = _rows_pools(
                    (2,) + pshape, kv_name[kvdtype], gen, dev)
            kp, vp, ks, vs = pools[(pshape, kvdtype)]
            table, lengths = saved
            case = dict(q=torch.randn(qshape, generator=gen, device=dev,
                                      dtype=qdtype),
                        k_pool=kp, v_pool=vp, k_scale=ks, v_scale=vs,
                        table=table, lengths=lengths, layer=1,
                        span_blocks=sb)
            from skypilot_tpu_torch.ops import paged_attention as pa
            err = _paged_err(name, case, pa.paged_attention)
            shapes.append(f"K1 B={B} R={R} bl={pshape[1]} span={sb} x{n}")
        else:
            _, qshape, kshape, dtype, causal, _ = key
            name = f"{leg} K2 {qshape}"

            def randn(shape):
                return torch.randn(shape, generator=gen, device=dev,
                                   dtype=dtype)

            err = _flash_err(name, dict(q=randn(qshape), k=randn(kshape),
                                        v=randn(kshape), seg=saved,
                                        causal=causal))[0]
            shapes.append(f"K2 B={qshape[0]} S={qshape[1]} x{n}")
        errs[key[0]] = max(errs[key[0]], err)
    del pools
    torch.cuda.empty_cache()
    _log(f"{leg}: the kernels agree with their plain versions at "
         f"all {len(seen)} shapes of the leg (max err K1 "
         f"{errs['K1']:.3e}, K2 {errs['K2']:.3e}): " + "; ".join(shapes))


def _bf16_divergence(dev, config: str, chunk: int, cold: dict,
                     passes, leg: str = "bench") -> None:
    """Hold each prompt whose tokens in a pass of ``passes`` ((what the
    two paths are, {prompt: tokens}) pairs) part from its ``cold`` ones
    to :func:`_bf16_hold`'s rule."""
    _bf16_hold(dev, config, chunk, [
        (f"request {i}", paths, prompt, warm[prompt], c)
        for paths, warm in passes
        for i, (prompt, c) in enumerate(cold.items())], leg)


def _bf16_hold(dev, config: str, chunk: int, cases, leg: str,
               adapters=None, distill=None) -> None:
    """Hold each case (what, the two paths, prompt, tokens, reference
    tokens[, adapter name]) whose tokens part to :func:`_agree`'s rule,
    with the top-2 gap taken from a plain engine on a float32 copy of
    the weights (seed 0) and the noise floor from the same context in
    bf16: twice the largest difference between the bf16 and float32
    plain logits there, since each bf16 run may move that far from the
    float32 logits. ``adapters`` ({name: rank-16 tree}, alpha 32): the
    fine-tunes the cases name, registered on both references.
    ``distill``: the references are the self-distilled target
    (``draft.self_distilled_pair``): ``wo`` and ``w_down`` zeroed past
    that many layers."""
    import torch
    from skypilot_tpu_torch.infer import adapters as ad_lib
    from skypilot_tpu_torch.infer import engine as eng
    from skypilot_tpu_torch.models import llama
    cases = [c for c in cases if list(c[3]) != list(c[4])]
    if not cases:
        return
    cfg = llama.CONFIGS[config]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, device=dev, dtype=cfg.dtype)
    if distill:
        for name in ("wo", "w_down"):
            params["blocks"][name][distill:] = 0
    refs = {}
    for c, p in ((cfg, params), (dataclasses.replace(
            cfg, dtype=torch.float32), {k: ({n: w.float() for n, w in
                                             v.items()}
                                            if isinstance(v, dict)
                                            else v.float())
                                        for k, v in params.items()})):
        cat = None
        if adapters:
            cat = ad_lib.AdapterCatalog(c, n_adapters=len(adapters) + 1,
                                        rank=ADAPTER_RANK, device=dev)
            for name, tree in adapters.items():
                cat.register(name, params=tree)
        refs[c.dtype] = eng.InferenceEngine(
            p, c, n_slots=1, max_len=1024, prompt_buckets=(1024,),
            prefill_chunk=chunk, device=dev, plain_attention=True,
            adapters=cat)
    del params
    for what, paths, prompt, got, want, *ad in cases:
        _agree(refs[torch.float32], list(prompt), got, want, what, paths,
               leg, low=refs[torch.bfloat16],
               adapter=ad[0] if ad else None)
    del refs
    gc.collect()
    torch.cuda.empty_cache()


def _positive(report: dict, keys, leg: str) -> None:
    for k in keys:
        v = report[k]
        if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0):
            raise AssertionError(f"bench[{leg}]: {k} = {v!r}, expected a "
                                 f"finite positive number")


def phase_bench(dev, card: str) -> dict:
    """The port's serving bench (``infer/bench_serve.py``) at llama3-8b,
    full width (``CUT_LAYERS``), bf16, random weights from seed 0, through its
    own functions: ``run_http`` (8 streamed requests of mixed 512-1024
    tokens, two timed waves), ``run`` (16 requests of 96 tokens on the
    engine alone) and ``run_prefix_share`` at its full-size shapes with
    6 requests of 24 new tokens. The launch counts are set to 0 just before each leg and read just
    after; then the kernels are held against their plain versions at
    each shape the leg gave them. Returns the launches by kernel,
    summed over the legs."""
    import torch
    from skypilot_tpu_torch.infer import bench_serve as bs
    from skypilot_tpu_torch.infer import engine as eng

    config, total = "llama3-8b", {}

    def leg(name: str, fn):
        seen = {}
        with _path_shapes(seen):
            _zero_launches()
            t0 = time.time()
            out = fn()
            n = _read_launches()
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        _log(f"bench[{name}]: {json.dumps(out)}")
        _log(f"bench[{name}]: {time.time() - t0:.1f} s, launches {n}; "
             f"{card}")
        gc.collect()
        torch.cuda.empty_cache()
        _check_path_shapes(seen, f"bench[{name}]", dev)
        return out

    # 1. HTTP: every response 200 (the client raises otherwise) with its
    # 32 tokens, in the warmup wave and the two timed ones (three until
    # the observe phase came).
    waves = []
    with _tap(bs, "_client_wave", waves):
        http = leg("http", lambda: bs.run_http(
            config=config, requests=8, slots=16, new_tokens=32,
            max_burst=8, open_burst=4, admit_wave=4, repeats=2,
            device=dev))
    counts = [[n for _, n, _ in res] for res in waves]
    if counts != [[32] * 8] * 3:
        raise AssertionError(f"bench[http]: tokens per response {counts}, "
                             f"expected 3 waves of 8 x 32")
    _positive(http, ("median_ttft_ms", "p99_ttft_ms", "out_tok_s",
                     "tpot_ms"), "http")
    if http["transport"] != "http_streaming":
        raise AssertionError(f"bench[http]: transport {http['transport']}")

    # 2. The engine alone: 16 requests finished, 64 tokens each.
    built = []
    with _tap(bs, "_build_engine", built):
        engine_only = leg("engine", lambda: bs.run(
            config=config, requests=16, slots=16, prompt_len=96,
            new_tokens=64, max_burst=32, device=dev))
    done = [len(r.tokens) for r in built[0][1].finished]
    del built
    if done != [64] * 16:
        raise AssertionError(f"bench[engine]: tokens per request {done}, "
                             f"expected 16 x 64")
    _positive(engine_only, ("median_ttft_ms", "out_tok_s"), "engine")

    # 3. Prefix share at the reference's full-size shapes (a system
    # prompt of 768 tokens and tails of 48, chunks of 256) with 6
    # requests of 24 new tokens (its 12 and 48, cut for time). The
    # engine's drains, as token maps by prompt: two one-request warmups,
    # then the cold and the warm pass.
    passes = []
    with _tap(eng.InferenceEngine, "run_to_completion", passes,
              keep=lambda done: {tuple(r.prompt): list(r.tokens)
                                 for r in done}):
        pfx = leg("prefix", lambda: bs.run_prefix_share(
            config=config, requests=6, new_tokens=24, device=dev))
    if not (pfx["cold_hits"] == 0 and pfx["hit_rate"] == 1.0
            and pfx["warm_chunks"] == pfx["requests"] < pfx["cold_chunks"]
            and pfx["interference"]["admission_bursts"] > 0):
        raise AssertionError(f"bench[prefix]: structure {pfx}")
    cold, warm = [p for p in passes if len(p) == pfx["requests"]][:2]
    if (cold == warm) != pfx["parity_ok"]:
        raise AssertionError("bench[prefix]: the drains read here are not "
                             "the passes the report compared")
    if not pfx["parity_ok"]:
        # bf16 batches differ between the passes.
        _bf16_divergence(dev, config, pfx["prefill_chunk"], cold,
                         [("warm and cold passes", warm)])

    for k in ("paged_attention", "paged_attention_rows",
              "flash_attention_fwd"):
        if not total.get(k):
            raise AssertionError(f"bench: {k} never launched ({total})")
    if total["paged_attention_rows_mma"]:
        raise AssertionError(f"bench: bf16 chunks ran the mma.sync "
                             f"multi-row body ({total}): the engine chose "
                             f"a block length the wgmma body does not "
                             f"read")
    return total


# ---------------------------------------------------------------------------
# The cross-replica KV handoff
# ---------------------------------------------------------------------------

def _handoff_prompts(cfg):
    """The handoff legs' prompts (seed 0): 775 and 597 tokens, both
    handed off over a 512-row prefix, and 491, which cannot hand off
    (its context plus one token does not pass one chunk)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 3)
    return [rng.integers(1, cfg.vocab_size, n).tolist()
            for n in (775, 597, 491)]


def _tiers(params, cfg, dev, slots: int, max_len: int, **kw):
    """A prefill tier P and a decode tier D: two engines on one params
    tree with the serving defaults ``make_engine`` gives them (prompt
    buckets, waves of 8, blocks of 256, chunks of 512, a prefix pool of
    8, spec K 4); ``kw``: the int8 recipe's options."""
    from skypilot_tpu_torch.infer import engine as eng
    buckets = tuple(sorted({128, 512, max_len}))
    return [eng.InferenceEngine(
        params, cfg, n_slots=slots, max_len=max_len, prompt_buckets=buckets,
        max_wave=8, kv_block=256, prefill_chunk=512, prefix_pool=8,
        spec_k=4, device=dev, seed=SEED, **kw) for _ in "PD"]


def _fill_trash(engine) -> None:
    """The trash block (every table entry past a slot's blocks) holds
    100.0: a read that leaks past a slot's rows shows at once."""
    n = engine.n_kv_blocks
    for name in ("k", "v", "k_scale", "v_scale"):
        if name in engine.cache:
            engine.cache[name][:, n] = 100


@contextlib.contextmanager
def _timed(obj, name: str, out: list, sync: bool = False):
    """Wrap ``obj.name`` (a module's function or an instance's method)
    for the block: each call appends (ms, args, result)."""
    import torch
    real = getattr(obj, name)
    own = name in vars(obj)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        res = real(*a, **kw)
        if sync:
            torch.cuda.synchronize()
        out.append(((time.perf_counter() - t0) * 1e3, a, res))
        return res

    setattr(obj, name, timed)
    try:
        yield
    finally:
        if own:
            setattr(obj, name, real)
        else:
            delattr(obj, name)


def _post_raw(url: str, body: bytes):
    """POST ``body``; returns (status, response bytes)."""
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _stream_timed(url: str, body: bytes, n_seeds: int):
    """POST a streamed ``body``; returns (tokens, the done line, ms from
    the send to the first token past the ``n_seeds`` committed ones, ms
    from that token to the done line)."""
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json"})
    toks, first = [], None
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            if not line.strip():
                continue
            obj = json.loads(line)
            if "error" in obj:
                raise AssertionError(f"handoff stream error: {obj}")
            if obj.get("done"):
                now = time.perf_counter()
                return toks, obj, (first - t0) * 1e3, (now - first) * 1e3
            toks.extend(obj.get("tokens") or [])
            if first is None and len(toks) > n_seeds:
                first = time.perf_counter()
    raise AssertionError("handoff stream ended without done")


@contextlib.contextmanager
def _first_rows_call(engine, out: list, when=lambda lengths: True):
    """Record, for the block, the inputs of the first multi-row K1 call
    on ``engine``'s cache for which ``when(lengths)`` holds: (layer,
    table, q, lengths, span)."""
    from skypilot_tpu_torch.infer import kvcache
    real = kvcache._paged_attn_stats
    rep = engine.cfg.n_heads // engine.cfg.n_kv_heads

    def keep(cache, i, table, qh, lengths, span, plain=False):
        if (cache is engine.cache and qh.shape[2] > rep and not out
                and when(lengths)):
            out.append((i, table.clone(), qh.clone(), lengths.clone(),
                        span))
        return real(cache, i, table, qh, lengths, span, plain)

    kvcache._paged_attn_stats = keep
    try:
        yield
    finally:
        kvcache._paged_attn_stats = real


def _handoff_leg(P, D, tag: str, card: str, new: int = 16) -> dict:
    """P (prefill tier) and D (decode tier) behind two HTTP servers on
    one card. First the single-tier reference: each handoff prompt on
    D's ``/generate``, then ``clear_prefix_cache()``. Then, launch
    counts set to 0 and K1's shapes recorded: each prompt's ``/prefill``
    on P (one committed token and the export, on the reference's wire)
    and, D's prefix cache cleared before each, its ``/handoff`` on D,
    blocking and then streamed. Checked: the committed token is the
    single tier's first; every handoff imported the 512-row prefix (the
    import's rows, D's ``prefix_hits`` up by one, the request's
    ``resumed_len`` 512); the stream starts with the committed token;
    ``/prefill`` of the 491-token prompt gets the typed 409; afterwards
    each tier's blocks are its resident entries'. D's trash block holds
    100.0 before the leg and again when K1 is held against its plain
    version on D's own cache (the imported blocks) at the first resume
    chunk's inputs. Returns the launches and the token maps."""
    import torch
    from skypilot_tpu_torch.infer import server as srv
    from skypilot_tpu_torch.ops import paged_attention as pa
    prompts = _handoff_prompts(D.cfg)
    handed, short = prompts[:2], prompts[2]
    _fill_trash(D)
    servers = []
    for e in (P, D):
        port = _free_port()
        model, httpd = srv.serve(e, host="127.0.0.1", port=port)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        servers.append((model, httpd, th, f"http://127.0.0.1:{port}"))
    purl, durl = servers[0][3], servers[1][3]
    out = {"single": {}, "blocking": {}, "stream": {}}
    seen, resume = {}, []
    calls = {k: [] for k in ("export", "encode", "decode", "import",
                             "retire")}
    try:
        for model, *_ in servers:
            model.wait_ready(timeout=600)
        for p in handed:
            r = _post(f"{durl}/generate", {"tokens": p,
                                           "max_new_tokens": new})
            out["single"][tuple(p)] = r["tokens"]
            tps = (len(r["tokens"]) - 1) / (
                (r["total_ms"] - r["ttft_ms"]) / 1e3)
            _log(f"{tag}: single tier, {len(p)}-token prompt on D: TTFT "
                 f"{r['ttft_ms']:.1f} ms, decode {tps:.1f} tokens/s; "
                 f"{card}")
        D.clear_prefix_cache()           # idle: no request in flight
        with contextlib.ExitStack() as stack:
            for ctx in (_path_shapes(seen), _first_rows_call(D, resume),
                        _timed(P, "export_prefix_for", calls["export"],
                               sync=True),
                        _timed(srv, "encode_export", calls["encode"]),
                        _timed(srv, "decode_export", calls["decode"]),
                        _timed(D, "import_prefix", calls["import"],
                               sync=True),
                        _timed(D, "_retire", calls["retire"])):
                stack.enter_context(ctx)
            _zero_launches()
            for p in handed:
                _handoff_one(p, purl, durl, D, calls, out, tag, card, new)
            launches = _read_launches()
        code, body = _post_raw(f"{purl}/prefill", json.dumps(
            {"tokens": short, "max_new_tokens": new}).encode())
        err = json.loads(body).get("error")
        if code != 409 or not isinstance(err, dict) or \
                err.get("type") != "handoff_ineligible":
            raise AssertionError(f"{tag}: /prefill of {len(short)} tokens "
                                 f"gave {code} {body[:200]!r}, the typed "
                                 f"409 expected")
    finally:
        for model, httpd, th, _ in servers:
            httpd.shutdown()
            model.shutdown()
            th.join(timeout=30)
    for name, e in (("P", P), ("D", D)):
        held = sum(len(p) for p in e._prefix_index.payloads())
        if e.blocks_used() != held:
            raise AssertionError(f"{tag}: {name} holds {e.blocks_used()} "
                                 f"blocks, its resident entries {held}")
    _log(f"{tag}: /prefill of the {len(short)}-token prompt: typed 409 "
         f"handoff_ineligible; blocks held after the leg: P "
         f"{P.blocks_used()}, D {D.blocks_used()}, each its resident "
         f"entries'; launches {launches}")
    if not (launches["paged_attention"] > 0
            and launches["paged_attention_rows"]
            + launches["paged_attention_rows_mma"] > 0):
        raise AssertionError(f"{tag}: K1's decode or multi-row body never "
                             f"launched: {launches}")
    _check_path_shapes(seen, tag, dev=D.device)
    # K1 on the imported blocks: the first resume chunk's inputs, D's
    # own pools, the trash block refilled with 100.0 (decode bursts
    # write dead slots' rows there).
    _fill_trash(D)
    i, table, qh, lengths, span = resume[0]
    c = D.cache
    sb = -(-(span or (table.shape[1] - 1) * D.kv_block) // D.kv_block)
    err = _paged_err(f"{tag} K1 resume over imported blocks", dict(
        q=qh, k_pool=c["k"], v_pool=c["v"], k_scale=c.get("k_scale"),
        v_scale=c.get("v_scale"), table=table, lengths=lengths, layer=i,
        span_blocks=sb), pa.paged_attention)
    _log(f"{tag}: K1 agrees with its plain version on D's imported blocks "
         f"at the first resume chunk (R={qh.shape[2]}, start "
         f"{int(lengths[0])}, {sb} blocks, trash block 100.0): max err "
         f"{err:.3e}")
    del resume
    torch.cuda.empty_cache()
    return dict(launches=launches, **out)


def _handoff_one(p, purl, durl, D, calls, out, tag, card, new) -> None:
    """One prompt through ``/prefill`` on P, then ``/handoff`` on D,
    blocking and streamed; see :func:`_handoff_leg`."""
    t0 = time.perf_counter()
    code, body = _post_raw(f"{purl}/prefill", json.dumps(
        {"tokens": p, "max_new_tokens": new}).encode())
    pre_ms = (time.perf_counter() - t0) * 1e3
    if code != 200:
        raise AssertionError(f"{tag}: /prefill {code}: {body[:300]!r}")
    pre = json.loads(body)
    committed = pre["committed"]
    want = out["single"][tuple(p)]
    if committed != want[:1] or pre["export"]["cached_len"] != 512:
        raise AssertionError(
            f"{tag}: /prefill committed {committed} over "
            f"{pre['export']['cached_len']} rows; the single tier's first "
            f"token {want[:1]} over 512 expected")
    exp_ms, _, exp = calls["export"][-1]
    _log(f"{tag}: {len(p)}-token prompt, /prefill on P: wall {pre_ms:.1f} "
         f"ms (TTFT {pre['ttft_ms']:.1f} ms), export {exp_ms:.1f} ms, "
         f"encode {calls['encode'][-1][0]:.1f} ms, wire "
         f"{len(body) / 2 ** 20:.1f} MiB ("
         + ", ".join(f"{n} {v.dtype}{list(v.shape)}"
                     for n, v in exp["tensors"].items()) + f"); {card}")
    for mode in ("blocking", "stream"):
        D.clear_prefix_cache()
        hits, n_ret = D.prefix_hits, len(calls["retire"])
        hbody = json.dumps({"tokens": p, "committed": committed,
                            "export": pre["export"], "max_new_tokens": new,
                            "stream": mode == "stream"}).encode()
        t0 = time.perf_counter()
        first_ms = None
        if mode == "stream":
            toks, done, first_ms, decode_ms = _stream_timed(
                f"{durl}/handoff", hbody, len(committed))
            ttft = done["ttft_ms"]
            if toks[:len(committed)] != committed or \
                    done["n_tokens"] != len(toks):
                raise AssertionError(f"{tag}: the stream did not start "
                                     f"with the committed token or its "
                                     f"done line miscounts")
        else:
            code, rb = _post_raw(f"{durl}/handoff", hbody)
            if code != 200:
                raise AssertionError(f"{tag}: /handoff {code}: "
                                     f"{rb[:300]!r}")
            r = json.loads(rb)
            toks, ttft = r["tokens"], r["ttft_ms"]
            decode_ms = r["total_ms"] - ttft
        wall = (time.perf_counter() - t0) * 1e3
        out[mode][tuple(p)] = toks
        req = next(a[0] for _, a, _ in calls["retire"][n_ret:]
                   if a[0].prompt == p)
        dec_ms = calls["decode"][-1][0]
        imp_ms, _, imp_rows = calls["import"][-1]
        # After D's first token, as the single tier's rate is read.
        tps = (len(toks) - len(committed) - 1) / (decode_ms / 1e3)
        _log(f"{tag}: {len(p)}-token prompt, /handoff {mode} on D: "
             f"decode+import {dec_ms + imp_ms:.1f} ms (decode_export "
             f"{dec_ms:.1f}, import {imp_ms:.1f}: {imp_rows} rows), TTFT "
             f"on D {ttft:.1f} ms (from the parsed request)"
             + (f", first streamed decode token at {first_ms:.1f} ms"
                if first_ms is not None else "")
             + f", decode {tps:.1f} tokens/s, wall {wall:.1f} ms; {card}")
        if (imp_rows, req.resumed_len, D.prefix_hits - hits) != (512, 512,
                                                                 1) \
                or len(toks) != new:
            raise AssertionError(
                f"{tag}: {mode} handoff of {len(p)} tokens: import "
                f"{imp_rows} rows, resumed_len {req.resumed_len}, D's "
                f"prefix hits +{D.prefix_hits - hits}, {len(toks)} tokens "
                f"(512, 512, +1 and {new} expected)")


def _plain_tier(params, cfg, dev, max_len: int, **kw):
    """A one-slot plain-attention engine shaped like a tier: the
    reference whose logits hold a leg's divergences."""
    from skypilot_tpu_torch.infer import engine as eng
    return eng.InferenceEngine(
        params, cfg, n_slots=1, max_len=max_len,
        prompt_buckets=tuple(sorted({128, 512, max_len})), kv_block=256,
        prefill_chunk=512, device=dev, plain_attention=True, **kw)


def _free_card() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def phase_handoff(dev, card: str) -> dict:
    """The cross-replica KV handoff (:func:`_handoff_leg`) at llama3-8b
    (``main`` runs it at ``CUT_LAYERS`` layers): bf16 (16 slots, max_len
    1024), the int8 recipe (``--kv-int8 --weights-int8``, 32 slots,
    max_len 1280, the
    weights quantized once and shared by both tiers) and float32 on the
    first 8 layers. Two-tier tokens are held to the single tier's: in
    float32 equal wherever the plain top-2 gap exceeds 1e-2; in bf16 and
    int8 the gap is read from the plain path on the weights in float32
    (the int8 recipe's float32 embedding beside the same int8 weights)
    and the floor raised to the bf16 noise on that context, and on the
    int8 recipe to w8a8's (:func:`_agree`). Returns {path: launches}."""
    import torch
    from skypilot_tpu_torch.infer import kvcache
    from skypilot_tpu_torch.models import llama
    config = "llama3-8b"
    cfg = llama.CONFIGS[config]

    def weights(c):
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        return llama.init_params(c, gen, device=dev, dtype=c.dtype)

    def modes(leg):
        return [(f"single-tier and two-tier ({m}) tokens", leg[m])
                for m in ("blocking", "stream")]

    def wgmma_only(leg, tag):
        n = leg["launches"]
        if not n["paged_attention_rows"] or n["paged_attention_rows_mma"]:
            raise AssertionError(f"{tag}: the wgmma multi-row body "
                                 f"launched {n['paged_attention_rows']} "
                                 f"times (> 0 expected), the mma.sync one "
                                 f"{n['paged_attention_rows_mma']} (0)")

    # bf16, the serve phase's engine settings.
    t0 = time.time()
    params = weights(cfg)
    P, D = _tiers(params, cfg, dev, 16, 1024)
    _log(f"handoff: llama3-8b ({cfg.n_layers} layers) bf16 tiers P and D "
         f"on one params tree in {time.time() - t0:.1f} s")
    bf16 = _handoff_leg(P, D, "handoff", card)
    wgmma_only(bf16, "handoff")
    del P, D, params
    _free_card()
    _bf16_divergence(dev, config, 512, bf16["single"], modes(bf16),
                     leg="handoff")
    _free_card()

    # The int8 recipe: quantized once, shared by P and D.
    t0 = time.time()
    params = weights(cfg)
    w8 = {"blocks": kvcache.quantize_block_weights(params),
          "head": kvcache.quantize_head(params, cfg)}
    slim = kvcache.slim_params(params)
    del params
    _free_card()
    P, D = _tiers(slim, cfg, dev, 32, 1280, kv_int8=True, qweights=w8)
    _log(f"handoff[int8]: llama3-8b w8a8 + int8 KV tiers on one int8 tree "
         f"in {time.time() - t0:.1f} s")
    int8 = _handoff_leg(P, D, "handoff[int8]", card)
    wgmma_only(int8, "handoff[int8]")
    del P, D
    _free_card()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    ref = _plain_tier({k: v.float() if torch.is_tensor(v) else
                       {n: w.float() for n, w in v.items()}
                       for k, v in slim.items()}, cfg32, dev, 1280,
                      kv_int8=True, qweights=w8)
    low = _plain_tier(slim, cfg, dev, 1280, kv_int8=True, qweights=w8)
    for paths, got in modes(int8):
        for i, (p, want) in enumerate(int8["single"].items()):
            _agree(ref, list(p), got[p], want, f"prompt {i}", paths,
                   "handoff[int8]", low=low)
    del ref, low, slim, w8
    _free_card()

    # float32, the first 8 layers at full width.
    cfg8 = dataclasses.replace(cfg, dtype=torch.float32,
                               n_layers=INT8_FP32_LAYERS)
    params = weights(cfg8)
    P, D = _tiers(params, cfg8, dev, 16, 1024)
    fp32 = _handoff_leg(P, D, "handoff[fp32]", card)
    n = fp32["launches"]
    if not n["paged_attention_rows_mma"] or n["paged_attention_rows"]:
        raise AssertionError(f"handoff[fp32]: float32 pools ran the wgmma "
                             f"body or never the mma.sync one: {n}")
    del P, D
    ref = _plain_tier(params, cfg8, dev, 1024)
    for paths, got in modes(fp32):
        for i, (p, want) in enumerate(fp32["single"].items()):
            _agree(ref, list(p), got[p], want, f"prompt {i}", paths,
                   "handoff[fp32]")
    del ref, params
    _free_card()
    return {"handoff": bf16["launches"],
            "handoff[int8]": int8["launches"],
            "handoff[fp32]": fp32["launches"]}


# ---------------------------------------------------------------------------
# Phase: QoS, preemption, KV quota, lazy growth and the operator routes
# ---------------------------------------------------------------------------

# The HTTP leg's tenants (SKYTPU_QOS_TENANTS): "hog" is rate-limited
# (burst 2, then a typed 429) and capped at one KV block, so its second
# concurrent request stalls on its quota; "vip" is configured a lane
# above the default tenant and preempts it.
QOS_TENANTS = {"hog": {"rate": 0.001, "burst": 2, "max_kv_blocks": 1},
               "vip": {"priority": 1}}
# ``run_qos``'s flood and budget on the card: the reference's chip
# defaults (24 hot requests, 64 new tokens) cut in half for the smoke's
# time limit.
QOS_BENCH_HOT = 12
QOS_BENCH_NEW = 32


def _qos_bench(dev, card: str) -> dict:
    """(a) ``bench_serve.run_qos`` at llama3-8b, the reference's chip
    defaults (8 slots, max_len 256, 2 background requests) but for a
    flood of ``QOS_BENCH_HOT`` hot requests and ``QOS_BENCH_NEW`` new
    tokens (the reference's 24 and 64, cut for time), bf16 at full
    depth. The
    report's structure is held (every preemption cycle preempted, WFQ
    admits the background tenant ahead of the flood where FIFO strands
    it); its two parity verdicts are held token by token: where bf16
    tokens part, at the bf16 floor rule (:func:`_bf16_hold`)."""
    from skypilot_tpu_torch.infer import bench_serve
    toks = {}
    _zero_launches()
    t0 = time.time()
    r = bench_serve.run_qos(config="llama3-8b", device=dev,
                            hot_requests=QOS_BENCH_HOT,
                            new_tokens=QOS_BENCH_NEW, tokens_out=toks)
    launches = _read_launches()
    _log(f"qos[bench]: run_qos(llama3-8b) in {time.time() - t0:.1f} s: "
         f"{json.dumps(r)}; launches {launches}; {card}")
    if r["preemptions"] < 4 or r["preempt_resumed_rows"] <= 0:
        raise AssertionError(f"qos[bench]: {r['preemptions']} preemptions "
                             f"in 4 cycles, {r['preempt_resumed_rows']} "
                             f"rows resumed warm")
    if not r["bg_ttft_wfq_ratio"] < r["bg_ttft_fifo_ratio"]:
        raise AssertionError("qos[bench]: WFQ did not admit the background "
                             "tenant ahead of the flood")
    _positive(r, ("fairness_ratio", "bg_tpot_idle_p99_ms",
                  "bg_tpot_contended_p99_ms", "bg_ttft_wfq_ratio",
                  "bg_ttft_fifo_ratio"), "qos[bench]")
    prompts, idle, wfq, fifo = toks["sched"]
    cases = [(f"background request {i}", f"idle and {name}", p, got[i],
              idle[i])
             for name, got in (("WFQ", wfq), ("FIFO", fifo))
             for i, p in enumerate(prompts)]
    cases += [(f"spec {k}, {'int8' if i8 else 'bf16'} KV", "unpreempted "
               "and preempted", p, got, want)
              for k, i8, p, want, got in toks["preempt"]]
    _free_card()
    _bf16_hold(dev, "llama3-8b", 8, cases, "qos[bench]")
    return launches


def _post_status(url: str, payload, headers=None):
    """POST JSON; returns (status, body, Retry-After)."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read()), r.headers.get(
                "Retry-After")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers.get("Retry-After")


def _scrape(url: str) -> dict:
    """{(family, sample labels): value} of one ``GET /metrics``."""
    from skypilot_tpu_torch.observability import metrics
    with urllib.request.urlopen(f"{url}/metrics", timeout=60) as r:
        fams = metrics.parse_exposition(r.read().decode())
    return {(name, tuple(sorted(lab.items()))): v
            for name, fam in fams.items() for lab, v in fam["samples"]}


def _delta(after: dict, before: dict, name: str, **labels) -> float:
    key = (name, tuple(sorted(labels.items())))
    return after.get(key, 0.0) - before.get(key, 0.0)


def _qos_server_leg(params, cfg, dev, tag: str, card: str) -> dict:
    """(b) The port's HTTP server at the reference server's defaults (16
    slots, max_len 1024, chunks of 512, a prefix pool of 8, spec K 4,
    blocks of 256) plus ``--kv-lazy``, with ``SKYTPU_QOS=1`` and
    :data:`QOS_TENANTS`, the engine's fair scheduler and the server's
    admission controller built from the environment as ``main`` builds
    them. In order: two concurrent "hog" requests (the second stalls on
    the quota), a third (the typed 429 with Retry-After); 16 streamed
    740-token requests of the default tenant fill the slots (their lazy
    tables grow while they decode) and a "vip" request preempts one of
    them; the victim's unpreempted twin (its
    prompt again, alone); a ``/drain`` lifecycle around one in-flight
    request. A ``/metrics`` scrape before and after: the TTFT count grows
    by the requests answered, the shed, quota-stall and preemption
    counters by what the leg caused. Returns launches and the victim's
    (prompt, preempted tokens, twin tokens)."""
    import os
    from skypilot_tpu_torch.infer import engine as eng
    from skypilot_tpu_torch.infer import qos as qos_lib
    from skypilot_tpu_torch.infer import server as srv
    saved = {k: os.environ.get(k) for k in ("SKYTPU_QOS",
                                            "SKYTPU_QOS_TENANTS")}
    os.environ["SKYTPU_QOS"] = "1"
    os.environ["SKYTPU_QOS_TENANTS"] = json.dumps(QOS_TENANTS)
    try:
        engine = eng.InferenceEngine(
            params, cfg, n_slots=16, max_len=1024,
            prompt_buckets=(128, 512, 1024), max_wave=8, kv_block=256,
            prefill_chunk=512, prefix_pool=8, spec_k=4, device=dev,
            seed=SEED, kv_lazy=True, qos=qos_lib.scheduler_from_env())
        ac = qos_lib.admission_from_env("server")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    import numpy as np
    rng = np.random.default_rng(SEED + 5)
    # 740 tokens: two chunks; the lazy reservation (740 + 16 rows, three
    # blocks) must grow once the context passes 763 rows.
    fill = [rng.integers(1, cfg.vocab_size, 740).tolist() for _ in range(16)]
    hog = [rng.integers(1, cfg.vocab_size, 100).tolist() for _ in range(3)]
    port = _free_port()
    model, httpd = srv.serve(engine, host="127.0.0.1", port=port, qos=ac)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{port}"
    answered = 0
    try:
        model.wait_ready(timeout=600)
        before = _scrape(url)
        _zero_launches()
        # Quota: hog's two requests at once; each needs one block of 256
        # rows (prompt + lazy headroom), its quota is one.
        res = [None, None]

        def hog_req(i):
            res[i] = _post_status(f"{url}/generate",
                                  {"tokens": hog[i], "max_new_tokens": 16},
                                  {"x-skytpu-tenant": "hog"})

        ths = [threading.Thread(target=hog_req, args=(i,)) for i in (0, 1)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=600)
        if [r[0] for r in res] != [200, 200]:
            raise AssertionError(f"{tag}: hog requests {res}")
        answered += 2
        code, body, retry = _post_status(
            f"{url}/generate", {"tokens": hog[2], "max_new_tokens": 16},
            {"x-skytpu-tenant": "hog"})
        if code != 429 or body["error"]["type"] != "rate_limited" or \
                int(retry) < 1:
            raise AssertionError(f"{tag}: third hog request gave {code} "
                                 f"{body} (Retry-After {retry}), the typed "
                                 f"429 expected")
        _log(f"{tag}: hog's third request: typed 429 {body['error']['type']}"
             f", Retry-After {retry} s")
        # Preemption: 16 streamed requests fill the slots, then vip.
        outs = [None] * 16
        preempted = []

        def fill_req(i):
            outs[i] = _post(f"{url}/generate", {
                "tokens": fill[i], "max_new_tokens": 64, "stream": True})

        real_preempt = engine.preempt_slot

        def spy(slot):
            req = engine.slot_req.get(slot)
            ok = real_preempt(slot)
            if ok:
                preempted.append(req.prompt)
            return ok

        engine.preempt_slot = spy
        ths = [threading.Thread(target=fill_req, args=(i,))
               for i in range(16)]
        for t in ths:
            t.start()
        # Every slot claimed and one decoding: the vip finds no free
        # slot and a resident it outranks.
        deadline = time.time() + 600
        while (engine.free_slots or not engine.slot_req) and \
                time.time() < deadline:
            time.sleep(0.005)
        code, vip, _ = _post_status(
            f"{url}/generate", {"tokens": hog[2][:40], "max_new_tokens": 8},
            {"x-skytpu-tenant": "vip"})
        for t in ths:
            t.join(timeout=600)
        engine.preempt_slot = real_preempt
        if code != 200 or any(o is None or len(o["tokens"]) != 64
                              for o in outs):
            raise AssertionError(f"{tag}: vip {code}, fill "
                                 f"{[o and len(o['tokens']) for o in outs]}")
        answered += 17
        victims = [i for i, o in enumerate(outs) if o["preemptions"]]
        if not preempted or not victims or \
                fill[victims[0]] != preempted[0]:
            raise AssertionError(f"{tag}: no preemption reported "
                                 f"(trailers {victims}, engine "
                                 f"{len(preempted)})")
        v = victims[0]
        twin = _post(f"{url}/generate", {"tokens": fill[v],
                                         "max_new_tokens": 64,
                                         "stream": True})["tokens"]
        answered += 1
        _log(f"{tag}: vip preempted fill request {v} (trailer preemptions "
             f"{outs[v]['preemptions']}), resumed; its tokens "
             + ("equal" if outs[v]["tokens"] == twin else "part from")
             + " its unpreempted twin's; vip TTFT "
             f"{vip['ttft_ms']:.1f} ms")
        # Drain around one in-flight request.
        drain_res = {}
        t = threading.Thread(target=lambda: drain_res.update(
            r=_post_status(f"{url}/generate",
                           {"tokens": fill[0], "max_new_tokens": 32})))
        t.start()
        while model.queue_depth() == 0 and t.is_alive():
            time.sleep(0.005)
        code, st, _ = _post_status(f"{url}/drain", {"grace_s": 60})
        if code != 200 or not st["draining"] or st["in_flight"] < 1:
            raise AssertionError(f"{tag}: /drain gave {code} {st}")
        code, body, retry = _post_status(f"{url}/generate",
                                         {"tokens": [1, 2]})
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            hz = json.loads(r.read())
        if (code, body["error"]["type"], retry, hz["status"]) != (
                503, "draining", "1", "draining"):
            raise AssertionError(f"{tag}: draining replica gave {code} "
                                 f"{body} {retry}, /healthz {hz}")
        t.join(timeout=600)
        if drain_res["r"][0] != 200:
            raise AssertionError(f"{tag}: in-flight request during the "
                                 f"drain gave {drain_res['r']}")
        answered += 1
        while not st["drained"]:
            time.sleep(0.05)
            code, st, _ = _post_status(f"{url}/drain", {"grace_s": 60})
        launches = _read_launches()
        after = _scrape(url)
    finally:
        httpd.shutdown()
        model.shutdown()
        th.join(timeout=30)
    n_ttft = _delta(after, before, "skytpu_ttft_seconds",
                    __name__="skytpu_ttft_seconds_count")
    counts = {
        "ttft": n_ttft,
        "shed": _delta(after, before, "skytpu_qos_shed_total",
                       tenant="hog", reason="rate_limited", where="server"),
        "quota_stalls": _delta(after, before,
                               "skytpu_qos_kv_quota_stalls_total",
                               tenant="hog"),
        "preemptions": _delta(after, before, "skytpu_qos_preemptions_total",
                              tenant="default"),
        "lazy_grows": _delta(after, before, "skytpu_kv_lazy_grows_total"),
    }
    _log(f"{tag}: /drain lifecycle: in-flight request finished, drained; "
         f"/metrics deltas {counts} over {answered} requests answered; "
         f"launches {launches}; {card}")
    if counts["ttft"] != answered or counts["shed"] != 1 or \
            counts["quota_stalls"] < 1 or counts["preemptions"] < 1 or \
            counts["lazy_grows"] < 1:
        raise AssertionError(f"{tag}: /metrics deltas {counts} "
                             f"({answered} answered)")
    if not launches["paged_attention"] or not (
            launches["paged_attention_rows"]
            + launches["paged_attention_rows_mma"]):
        raise AssertionError(f"{tag}: K1 never launched: {launches}")
    return {"launches": launches,
            "victim": (fill[v], outs[v]["tokens"], twin)}


def _k1_on_qos_tables(params, cfg, dev, tag: str) -> None:
    """(c) K1 against its plain version, the trash block filled with
    100.0: at the first resume chunk after a preemption (a 600-token
    request on a one-slot engine, evicted after a burst, resuming with a
    chunk at start 512 over its two stored blocks; the multi-row body),
    and on a decode burst over a lazily grown table in which one slot
    sits out (2 slots, blocks of 16 rows, a pool of 16 blocks: a
    190-token request grows until the pool is dry while a 20-token one
    finishes; the decode body)."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import engine as eng
    from skypilot_tpu_torch.infer import kvcache
    from skypilot_tpu_torch.infer import qos as qos_lib
    from skypilot_tpu_torch.ops import paged_attention as pa
    rng = np.random.default_rng(SEED + 6)
    e = eng.InferenceEngine(
        params, cfg, n_slots=1, max_len=1024, prompt_buckets=(128, 1024),
        kv_block=256, kv_blocks=8, prefill_chunk=512, prefix_pool=4,
        device=dev, qos=qos_lib.FairScheduler())
    _fill_trash(e)
    rid = e.add_request(rng.integers(1, cfg.vocab_size, 600).tolist(), 24)
    while not e.slot_req:
        e.step_burst(max_burst=4)
    e.decode_burst(max_burst=4)
    e.add_request([3, 1, 4], 4, priority=1)
    resume = []
    with _first_rows_call(e, resume):
        e.run_to_completion(max_burst=4)
    low = {r.rid: r for r in e.finished}[rid]
    if (low.preemptions, low.resumed_len) != (1, 512) or not resume:
        raise AssertionError(f"{tag}: preemptions {low.preemptions}, "
                             f"resumed_len {low.resumed_len}")
    _fill_trash(e)
    i, table, qh, lengths, span = resume[0]
    sb = -(-(span or (table.shape[1] - 1) * e.kv_block) // e.kv_block)
    c = e.cache
    err = _paged_err(f"{tag} K1 at the resume chunk", dict(
        q=qh, k_pool=c["k"], v_pool=c["v"], k_scale=c.get("k_scale"),
        v_scale=c.get("v_scale"), table=table, lengths=lengths, layer=i,
        span_blocks=sb), pa.paged_attention)
    _log(f"{tag}: K1 agrees with its plain version at the first resume "
         f"chunk after a preemption (R={qh.shape[2]}, start "
         f"{int(lengths[0])}, {sb} blocks, trash block 100.0): max err "
         f"{err:.3e}")
    del e, resume
    # Lazy growth with a slot sitting out.
    e = eng.InferenceEngine(
        params, cfg, n_slots=2, max_len=256, prompt_buckets=(256,),
        kv_block=16, kv_blocks=16, kv_lazy=True, device=dev)
    _fill_trash(e)
    for n, new in ((190, 50), (20, 20)):
        e.add_request(rng.integers(1, cfg.vocab_size, n).tolist(), new)
    rep = cfg.n_heads // cfg.n_kv_heads
    real = kvcache._paged_attn_stats
    calls, kept = [], None

    def keep(cache, i, table, qh, lengths, span, plain=False):
        if cache is e.cache and qh.shape[2] == rep and not calls:
            calls.append((i, table.clone(), qh.clone(), lengths.clone(),
                          span))
        return real(cache, i, table, qh, lengths, span, plain)

    kvcache._paged_attn_stats = keep
    try:
        while (e.waiting or e.slot_req) and kept is None:
            e.admit()
            calls.clear()
            lens = e.cache["length"].clone()
            e.decode_burst(max_burst=1)
            sat = [s for s in e.slot_req
                   if int(e.cache["length"][s]) == int(lens[s])]
            if sat and calls:
                kept = (sat[0], calls[0])
    finally:
        kvcache._paged_attn_stats = real
    if kept is None:
        raise AssertionError(f"{tag}: no slot sat a burst out")
    slot, (i, table, qh, lengths, span) = kept
    _fill_trash(e)
    sb = -(-(span or (table.shape[1] - 1) * e.kv_block) // e.kv_block)
    c = e.cache
    err = _paged_err(f"{tag} K1 decode over a lazily grown table", dict(
        q=qh, k_pool=c["k"], v_pool=c["v"], k_scale=c.get("k_scale"),
        v_scale=c.get("v_scale"), table=table, lengths=lengths, layer=i,
        span_blocks=sb), pa.paged_attention)
    grown = int((table[slot] < e.n_kv_blocks).sum())
    _log(f"{tag}: K1 agrees with its plain version on a decode burst over "
         f"lazily grown tables (slot {slot} sat the burst out at length "
         f"{int(lengths[slot])} over {grown} grown blocks of 16, trash "
         f"block 100.0): max err {err:.3e}")
    e.run_to_completion(max_burst=1)
    del e
    torch.cuda.empty_cache()


def phase_qos(dev, card: str) -> dict:
    """QoS, preemption, per-tenant KV quota, lazy growth and the operator
    routes at llama3-8b: (a) :func:`_qos_bench`; (b)
    :func:`_qos_server_leg` in bf16 at ``CUT_LAYERS`` layers and in
    float32 on the first 8, the preempted request's tokens held to its
    unpreempted twin's (float32: equal wherever the plain top-2 gap
    exceeds 1e-2; bf16: the bf16 floor rule); (c)
    :func:`_k1_on_qos_tables` on the bf16 weights. Returns {path:
    launches}."""
    import torch
    from skypilot_tpu_torch.models import llama
    out = {"qos[bench]": _qos_bench(dev, card)}
    _free_card()
    config = "llama3-8b"

    def weights(c):
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        return llama.init_params(c, gen, device=dev, dtype=c.dtype)

    with _at_depth(config, CUT_LAYERS):
        cfg = llama.CONFIGS[config]
        params = weights(cfg)
        leg = _qos_server_leg(params, cfg, dev, "qos", card)
        out["qos"] = leg["launches"]
        _free_card()
        _k1_on_qos_tables(params, cfg, dev, "qos[K1]")
        del params
        _free_card()
        prompt, got, twin = leg["victim"]
        _bf16_hold(dev, config, 512, [("the preempted request", "preempted "
                                       "and unpreempted", prompt, got,
                                       twin)], "qos")
        _free_card()
    cfg8 = dataclasses.replace(cfg, dtype=torch.float32,
                               n_layers=INT8_FP32_LAYERS)
    params = weights(cfg8)
    leg = _qos_server_leg(params, cfg8, dev, "qos[fp32]", card)
    out["qos[fp32]"] = leg["launches"]
    prompt, got, twin = leg["victim"]
    ref = _plain_tier(params, cfg8, dev, 1024)
    _agree(ref, prompt, got, twin, "the preempted request",
           "preempted and unpreempted", "qos[fp32]")
    del ref, params
    _free_card()
    return out


# ---------------------------------------------------------------------------
# Phase 8: multi-LoRA adapters
# ---------------------------------------------------------------------------

# The phase's fine-tunes: ``bench_serve.adapter_tree`` at rank 16 with
# seeds 100.., the trees ``run_adapters`` registers under the same names.
ADAPTER_RANK = 16
ADAPTER_NAMES = tuple(f"ft-{i}" for i in range(8))
# New tokens per request of the HTTP leg: enough to part a fine-tune from
# the base, few enough that requests held on pinned pool slots wait
# seconds, not tens of seconds.
ADAPTER_NEW = 16


def _adapter_trees(cfg, names=ADAPTER_NAMES) -> dict:
    from skypilot_tpu_torch.infer import bench_serve
    return {n: bench_serve.adapter_tree(cfg, ADAPTER_RANK,
                                        100 + int(n.split("-")[1]))
            for n in names}


def _write_catalog(tmp: str, trees: dict) -> str:
    """The trees as ``save_adapter`` .npz files in ``tmp`` plus one
    corrupt entry (``broken``); returns the ``--adapters`` JSON."""
    import os
    from skypilot_tpu_torch.infer import adapters as ad_lib
    paths = {}
    for name, tree in trees.items():
        paths[name] = os.path.join(tmp, f"{name}.npz")
        ad_lib.save_adapter(paths[name], tree)
    paths["broken"] = os.path.join(tmp, "broken.npz")
    with open(paths["broken"], "wb") as f:
        f.write(b"\x93NUMPY-not-a-checkpoint" * 64)
    return json.dumps(paths)


@contextlib.contextmanager
def _adapter_kernel_inputs(engine, rows: list, dec: list, wave: list):
    """Record, for the block, on ``engine``'s cache: the first multi-row
    K1 call that reads rows (``rows``), the first decode K1 call while
    the active slots run at least three pool ids (two fine-tunes and the
    base; ``dec``), and the first K2 call (``wave``)."""
    from skypilot_tpu_torch.infer import kvcache
    from skypilot_tpu_torch.ops import attention as attn_ops
    real_k1, real_k2 = kvcache._paged_attn_stats, attn_ops.gqa_attention
    rep = engine.cfg.n_heads // engine.cfg.n_kv_heads

    def k1(cache, i, table, qh, lengths, span, plain=False):
        if cache is engine.cache and not plain:
            keep = (i, table.clone(), qh.clone(), lengths.clone(), span)
            ids = {int(engine.adapter_ids[s]) for s in engine.slot_req}
            if qh.shape[2] > rep and not rows and bool(
                    (lengths > 0).any()):
                rows.append(keep)
            elif qh.shape[2] == rep and not dec and len(ids) >= 3:
                dec.append(keep)
        return real_k1(cache, i, table, qh, lengths, span, plain)

    def k2(q, k, v, causal=True, segment_ids=None):
        if not wave:
            wave.append((q.clone(), k.clone(), v.clone()))
        return real_k2(q, k, v, causal, segment_ids)

    kvcache._paged_attn_stats, attn_ops.gqa_attention = k1, k2
    try:
        yield
    finally:
        kvcache._paged_attn_stats, attn_ops.gqa_attention = real_k1, real_k2


def _hold_adapter_kernels(engine, tag: str) -> None:
    """K1 and K2 against their plain versions on adapter inputs, the
    trash block at 100.0: an adapter request's first chunk that reads
    rows (a 600-token prompt under ft-3, chunk 2 at start 512), a decode
    burst whose slots run ft-1, ft-2 and the base, and the K2 call of a
    wave mixing them."""
    import numpy as np
    from skypilot_tpu_torch.ops import paged_attention as pa
    rng = np.random.default_rng(SEED + 8)
    engine.reset()
    _fill_trash(engine)
    rows, dec, wave = [], [], []
    with _adapter_kernel_inputs(engine, rows, dec, wave):
        for n, name in ((600, "ft-3"), (90, "ft-1"), (70, "ft-2"),
                        (50, None)):
            engine.add_request(rng.integers(1, engine.cfg.vocab_size,
                                            n).tolist(), 24, adapter=name)
        engine.run_to_completion(max_burst=4)
    if not (rows and dec and wave) or any(
            r.error for r in engine.finished):
        raise AssertionError(f"{tag}: adapter kernel inputs not recorded "
                             f"({len(rows)}, {len(dec)}, {len(wave)})")
    engine.finished.clear()
    _fill_trash(engine)
    c = engine.cache
    for what, (i, table, qh, lengths, span) in (
            ("the adapter request's first chunk over cached rows", rows[0]),
            ("a decode burst mixing ft-1, ft-2 and the base", dec[0])):
        sb = -(-(span or (table.shape[1] - 1) * engine.kv_block)
               // engine.kv_block)
        err = _paged_err(f"{tag} K1 {what}", dict(
            q=qh, k_pool=c["k"], v_pool=c["v"], k_scale=c.get("k_scale"),
            v_scale=c.get("v_scale"), table=table, lengths=lengths,
            layer=i, span_blocks=sb), pa.paged_attention)
        _log(f"{tag}: K1 agrees with its plain version on {what} (R="
             f"{qh.shape[2]}, B={qh.shape[0]}, lengths up to "
             f"{int(lengths.max())}, {sb} blocks, trash block 100.0): max "
             f"err {err:.3e}")
    q, k, v = wave[0]
    err = _flash_err(f"{tag} K2 adapter wave", dict(q=q, k=k, v=v, seg=None,
                                                   causal=True))[0]
    _log(f"{tag}: K2 agrees with its plain version on the wave mixing "
         f"ft-1, ft-2 and the base ({tuple(q.shape)}): max err {err:.3e}")


def _adapter_server_leg(dev, card: str, catalog: str) -> dict:
    """The port's server through ``make_engine`` at llama3-8b (bf16, the
    reference server's defaults: 16 slots, max_len 1024, chunks of 512,
    a prefix pool of 8, spec K 4) with ``--adapters`` (8 fine-tunes and
    a corrupt entry) and ``--adapter-slots 5`` (4 fine-tunes resident,
    so the traffic evicts). Launch counts set to 0, then 16 concurrent
    ``/generate`` requests: 12 under ft-0..ft-7 (the body's ``model`` or
    the header), 4 of the base model, one of them ft-0's prompt;
    ``ADAPTER_NEW`` new tokens each, prompts of 33-700 tokens (three
    chunked). Every answer
    has its budget and a trailer naming its model, ft-0 and the base
    part on the shared prompt; then the typed 404 (blocking, streamed),
    the typed 503 and stream error chunk of the corrupt entry, and the
    catalog's loads and evictions from ``/metrics`` before and after.
    Returns (engine, launches, trailers)."""
    import numpy as np
    from skypilot_tpu_torch.infer import adapters as ad_lib
    from skypilot_tpu_torch.infer import server as srv
    engine = srv.make_engine("llama3-8b", device=dev, seed=SEED,
                             adapters=catalog, adapter_slots=5)
    _fill_trash(engine)
    port = _free_port()
    model, httpd = srv.serve(engine, host="127.0.0.1", port=port)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{port}"
    rng = np.random.default_rng(SEED + 7)
    lens = (600, 97, 240, 33, 589, 150, 61, 300, 128, 45, 700, 90)
    jobs = []
    for i, n in enumerate(lens):
        name = ADAPTER_NAMES[i % len(ADAPTER_NAMES)]
        jobs.append((rng.integers(1, engine.cfg.vocab_size, n).tolist(),
                     name, "header" if i % 2 else "body"))
    jobs += [(jobs[0][0], None, "none")] + [
        (rng.integers(1, engine.cfg.vocab_size, n).tolist(), None, "none")
        for n in (410, 77, 200)]
    results = [None] * len(jobs)
    try:
        model.wait_ready(timeout=900)

        def send(k):
            p, name, via = jobs[k]
            body = {"tokens": p, "max_new_tokens": ADAPTER_NEW}
            hdr = {}
            if via == "body":
                body["model"] = name
            elif via == "header":
                hdr[ad_lib.MODEL_HEADER] = name
            results[k] = _post_status(f"{url}/generate", body, hdr)

        before = _scrape(url)
        _zero_launches()
        t0 = time.time()
        threads = [threading.Thread(target=send, args=(k,))
                   for k in range(len(jobs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.time() - t0
        launches = _read_launches()
        after = _scrape(url)
        for (p, name, via), (code, out, _) in zip(jobs, results):
            if code != 200 or len(out.get("tokens", [])) != ADAPTER_NEW \
                    or out.get("model") != name:
                raise AssertionError(f"adapters: {name} via {via}: {code} "
                                     f"{str(out)[:300]}")
        if results[0][1]["tokens"] == results[12][1]["tokens"]:
            raise AssertionError("adapters: ft-0 gave the base model's "
                                 "tokens on the shared prompt")
        loads = _delta(after, before, "skytpu_adapter_loads_total")
        evictions = _delta(after, before, "skytpu_adapter_evictions_total")
        ttfts = sorted(r[1]["ttft_ms"] for r in results)
        _log(f"adapters: 16 concurrent requests (12 under 8 fine-tunes "
             f"through 4 pool slots, 4 base) in {wall:.2f} s, TTFT median "
             f"{ttfts[len(ttfts) // 2]:.1f} ms (max {ttfts[-1]:.1f}); "
             f"/metrics: loads +{loads:g}, evictions +{evictions:g}, "
             f"slots {after.get(('skytpu_adapter_slots', ()))}; every "
             f"trailer names its model; launches {launches}; {card}")
        if loads < len(ADAPTER_NAMES) or evictions < 4 or after.get(
                ("skytpu_adapter_slots", ())) != 4:
            raise AssertionError(f"adapters: loads +{loads}, evictions "
                                 f"+{evictions}")
        for stream in (False, True):
            code, out, _ = _post_status(f"{url}/generate", {
                "tokens": [1, 2, 3], "max_new_tokens": 4, "model": "nope",
                "stream": stream})
            err = out.get("error") if isinstance(out, dict) else None
            if code != 404 or not isinstance(err, dict) or \
                    err.get("type") != "unknown_adapter":
                raise AssertionError(f"adapters: unknown name (stream="
                                     f"{stream}): {code} {out}")
        code, out, _ = _post_status(f"{url}/generate", {
            "tokens": [1, 2, 3], "max_new_tokens": 4}, {
                ad_lib.MODEL_HEADER: "broken"})
        if code != 503 or out["error"]["type"] != "adapter_load_failed" \
                or "tokens" in out:
            raise AssertionError(f"adapters: corrupt entry: {code} {out}")
        code, body = _post_raw(f"{url}/generate", json.dumps({
            "tokens": [1, 2, 3], "max_new_tokens": 4, "stream": True,
            "model": "broken"}).encode())
        lines = [json.loads(x) for x in body.splitlines() if x.strip()]
        if code != 200 or not lines or lines[-1].get("error", {}).get(
                "type") != "adapter_load_failed" or any(
                "tokens" in c for c in lines):
            raise AssertionError(f"adapters: corrupt entry streamed: {code} "
                                 f"{lines}")
        _log("adapters: unknown name -> typed 404 blocking and streamed "
             "(no stream bytes); corrupt checkpoint -> typed 503 "
             "adapter_load_failed, and on a stream a typed error chunk "
             "with no tokens")
    finally:
        httpd.shutdown()
        model.shutdown()
        th.join(timeout=30)
    if not (launches["paged_attention"] > 0
            and launches["paged_attention_rows"] > 0
            and launches["flash_attention_fwd"] > 0
            and launches["paged_attention_rows_mma"] == 0):
        raise AssertionError(f"adapters: kernel launches {launches}")
    return engine, launches


def _adapter_handoff_leg(params, cfg, dev, card: str, catalog: str,
                         trees: dict) -> tuple:
    """``/prefill`` on a port replica P and ``/handoff`` on a replica D,
    each with its own catalog (the same files), ft-1 named by the
    header: D's single-tier tokens first, then P's committed token and
    export, whose wire salt must be ft-1's content digest; D imports
    512 rows under it (its prefix hits +1) and resumes. Returns the
    launches of the two-tier leg and the (what, paths, prompt, handoff
    tokens, single tokens, adapter) case for the bf16 floor rule."""
    import base64
    from skypilot_tpu_torch.infer import adapters as ad_lib
    from skypilot_tpu_torch.infer import engine as eng
    from skypilot_tpu_torch.infer import server as srv
    tiers = [eng.InferenceEngine(
        params, cfg, n_slots=16, max_len=1024, prompt_buckets=(128, 512,
                                                               1024),
        max_wave=8, kv_block=256, prefill_chunk=512, prefix_pool=8,
        spec_k=4, device=dev, seed=SEED,
        adapters=ad_lib.catalog_from_env(cfg, adapters_json=catalog,
                                         slots=5, device=dev))
        for _ in "PD"]
    P, D = tiers
    servers = []
    for e in tiers:
        port = _free_port()
        model, httpd = srv.serve(e, host="127.0.0.1", port=port)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        servers.append((model, httpd, th, f"http://127.0.0.1:{port}"))
    purl, durl = servers[0][3], servers[1][3]
    prompt = _handoff_prompts(cfg)[0]                   # 775 tokens
    hdr = {ad_lib.MODEL_HEADER: "ft-1"}
    imports = []
    try:
        for model, *_ in servers:
            model.wait_ready(timeout=900)
        code, single, _ = _post_status(f"{durl}/generate", {
            "tokens": prompt, "max_new_tokens": 32}, hdr)
        if code != 200 or single["model"] != "ft-1":
            raise AssertionError(f"adapters[handoff]: single tier {code}")
        D.clear_prefix_cache()
        hits = D.prefix_hits
        _zero_launches()
        with _timed(D, "import_prefix", imports):
            code, pre, _ = _post_status(f"{purl}/prefill", {
                "tokens": prompt, "max_new_tokens": 32}, hdr)
            salt = base64.b64decode(pre["export"]["salt"])
            want = ad_lib._content_digest(trees["ft-1"], 32.0)
            if code != 200 or salt != want or pre["model"] != "ft-1":
                raise AssertionError(f"adapters[handoff]: /prefill {code}, "
                                     f"salt {salt.hex()} (want "
                                     f"{want.hex()})")
            code, got, _ = _post_status(f"{durl}/handoff", {
                "tokens": prompt, "max_new_tokens": 32,
                "committed": pre["committed"], "export": pre["export"]},
                hdr)
        launches = _read_launches()
    finally:
        for model, httpd, th, _ in servers:
            httpd.shutdown()
            model.shutdown()
            th.join(timeout=30)
    if code != 200 or got["model"] != "ft-1" or len(got["tokens"]) != 32:
        raise AssertionError(f"adapters[handoff]: /handoff {code}")
    if [r for _, _, r in imports] != [512] or D.prefix_hits != hits + 1:
        raise AssertionError(f"adapters[handoff]: import rows "
                             f"{[r for _, _, r in imports]}, D's hits "
                             f"+{D.prefix_hits - hits}")
    same = got["tokens"] == single["tokens"]
    _log(f"adapters[handoff]: /prefill under ft-1 (x-skytpu-model) on P, "
         f"the wire's salt = ft-1's content digest {salt.hex()}, D "
         f"imported 512 rows under it and hit (prefix hits +1); the "
         f"handoff's 32 tokens {'equal' if same else 'part from'} the "
         f"single tier's; launches {launches}; {card}")
    del P, D, tiers
    return launches, [("the 775-token prompt under ft-1",
                       "handoff and single tier", prompt, got["tokens"],
                       single["tokens"], "ft-1")]


def _adapter_bench(dev, card: str) -> tuple:
    """``bench_serve.run_adapters`` at llama3-8b bf16, ``CUT_LAYERS``: rank
    16, 8 fine-tunes, 8 requests of 128 tokens (one under each
    fine-tune in the mixed batch; the reference's 16 cut to make room
    for the draft phase: the sequential parity runs, one a request,
    take most of the time), 16 new (the reference's 256 cut to hold the
    phase near 100 s; 64 took it to 199 s on a slow host, 32 until the
    observe phase came), max burst 8.
    Its report line
    and launches; the TPOT keys positive, the churn loaded and evicted.
    Returns (launches, parity cases for the bf16 floor rule)."""
    from skypilot_tpu_torch.infer import bench_serve
    toks = {}
    _zero_launches()
    t0 = time.time()
    r = bench_serve.run_adapters(config="llama3-8b", n_adapters=8,
                                 requests=8, prompt_len=128, new_tokens=16,
                                 device=dev, tokens_out=toks)
    launches = _read_launches()
    _log(f"adapters[bench]: run_adapters(llama3-8b) in "
         f"{time.time() - t0:.1f} s: {json.dumps(r)}; launches {launches}; "
         f"{card}")
    _positive(r, ("tpot_single_ms", "tpot_mixed_ms", "overhead_ratio"),
              "adapters[bench]")
    if r["hot_loads"] <= 0 or r["evictions"] <= 0 or not (
            launches["paged_attention"] and launches["flash_attention_fwd"]):
        raise AssertionError(f"adapters[bench]: {r}, launches {launches}")
    cases = [(f"request {i} under {a}", "mixed batch and sequential", p,
              got, want, a)
             for i, (p, a, got, want) in enumerate(toks["parity"])]
    return launches, cases


def _adapter_fp32_leg(dev, card: str) -> dict:
    """Float32 on the first 8 layers of llama3-8b, rank-16 fine-tunes
    ft-0 and ft-1 (8-layer trees), the server's engine settings at 4
    slots, kernel path: for the base, ft-0 and ft-1, zero-adapter tokens
    (an adapter engine with no request naming one) equal the adapterless
    engine's bit for bit, and a mixed batch (a 600-token chunked prompt
    and a 97-token wave prompt under each) equals the sequential runs
    wherever the plain top-2 gap exceeds 1e-2. Returns the launches of
    the mixed batch."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import adapters as ad_lib
    from skypilot_tpu_torch.infer import engine as eng
    from skypilot_tpu_torch.models import llama
    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"],
                              dtype=torch.float32,
                              n_layers=INT8_FP32_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = llama.init_params(cfg, gen, device=dev, dtype=cfg.dtype)
    trees = _adapter_trees(cfg, ("ft-0", "ft-1"))

    def catalog():
        cat = ad_lib.AdapterCatalog(cfg, n_adapters=3, rank=ADAPTER_RANK,
                                    device=dev)
        for name, tree in trees.items():
            cat.register(name, params=tree)
        return cat

    def engine(cat, plain=False):
        return eng.InferenceEngine(
            params, cfg, n_slots=4, max_len=1024,
            prompt_buckets=(128, 512, 1024), max_wave=8, kv_block=256,
            prefill_chunk=512, prefix_pool=8, spec_k=4, device=dev,
            seed=SEED, adapters=cat, plain_attention=plain)

    rng = np.random.default_rng(SEED + 9)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (600, 97)]
    base = engine(None).generate(prompts, 32)
    zero = engine(catalog()).generate(prompts, 32)
    if zero != base:
        raise AssertionError("adapters[fp32]: zero-adapter tokens differ "
                             "from the adapterless engine's")
    jobs = [(p, n) for n in (None, "ft-0", "ft-1") for p in prompts]
    e = engine(catalog())
    _zero_launches()
    ids = [e.add_request(p, 32, adapter=n) for p, n in jobs]
    e.run_to_completion()
    launches = _read_launches()
    mixed = {r.rid: r.tokens for r in e.finished}
    ref = engine(catalog(), plain=True)
    for rid, (p, n) in zip(ids, jobs):
        solo = engine(catalog())
        want = solo.generate([p], 32) if n is None else None
        if n is not None:
            srid = solo.add_request(p, 32, adapter=n)
            solo.run_to_completion()
            want = [r.tokens for r in solo.finished if r.rid == srid]
        _agree(ref, p, mixed[rid], want[0], f"a {len(p)}-token prompt "
               f"under {n or 'the base'}", "mixed batch and sequential",
               "adapters[fp32]", adapter=n)
        if n is not None and mixed[rid] == base[prompts.index(p)]:
            raise AssertionError(f"adapters[fp32]: {n} gave the base "
                                 f"model's tokens")
    _log(f"adapters[fp32]: zero-adapter tokens equal the adapterless "
         f"engine's on both prompts; the mixed batch (6 requests) agrees "
         f"with the sequential runs; launches {launches}; {card}")
    if not (launches["paged_attention_rows_mma"] > 0
            and launches["paged_attention_rows"] == 0):
        raise AssertionError(f"adapters[fp32]: launches {launches}")
    return launches


def phase_adapters(dev, card: str) -> dict:
    """Multi-LoRA serving at llama3-8b: the fine-tunes written as
    ``save_adapter`` files (8 rank-16 trees from seeded numpy, ~55 MB
    each on disk, and a corrupt entry) into a temporary directory; (a)
    :func:`_adapter_server_leg`, then :func:`_hold_adapter_kernels` on
    its engine; (b) :func:`_adapter_handoff_leg` on its weights; (c)
    :func:`_adapter_bench`; (d) :func:`_adapter_fp32_leg`; every bf16
    divergence of (b) and (c) under the bf16 floor rule. Returns {path:
    launches}."""
    import tempfile
    from skypilot_tpu_torch.models import llama
    t0 = time.time()
    cfg = llama.CONFIGS["llama3-8b"]
    trees = _adapter_trees(cfg)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        catalog = _write_catalog(tmp, trees)
        engine, out["adapters"] = _adapter_server_leg(dev, card, catalog)
        _hold_adapter_kernels(engine, "adapters")
        params = engine.params
        del engine
        _free_card()
        out["adapters[handoff]"], cases = _adapter_handoff_leg(
            params, cfg, dev, card, catalog, trees)
    del params
    _free_card()
    out["adapters[bench]"], more = _adapter_bench(dev, card)
    _free_card()
    _bf16_hold(dev, "llama3-8b", 512, cases + more, "adapters",
               adapters=trees)
    _free_card()
    out["adapters[fp32]"] = _adapter_fp32_leg(dev, card)
    _free_card()
    _log(f"adapters: phase in {time.time() - t0:.1f} s; {card}")
    return out


# ---------------------------------------------------------------------------
# The draft model and the async draft/verify pipeline
# ---------------------------------------------------------------------------

# The engine leg's 8 prompts (two of them chunked) and budget (64 cut to
# 48 for time), the depth of its self-distilled draft, and the float32
# leg's depth and draft.
DRAFT_LENS = (775, 597, 491, 289, 321, 98, 126, 400)
DRAFT_NEW = 48
DRAFT_LAYERS = 4
DRAFT_FP32_LAYERS = 8
DRAFT_FP32_DRAFT = 4
# The engine leg's least acceptance in bf16. The distilled pair read
# 0.903 pipelined and 0.924 synchronous on an H100 at 64 new tokens
# (bf16 near-ties flip some drafts; a request's last round drafts past
# its budget, which costs more of a shorter budget); a draft
# that has nothing to do with the target reads ~0. The float32 legs
# hold > 0.9 (they read 0.96-0.98).
DRAFT_BF16_ACCEPT = 0.8
# ``run_spec``'s budget on the card: the reference's 256 cut for time
# (64 until the models phase joined the smoke; its checks are the
# pipeline's structure, which a shorter budget keeps).
DRAFT_BENCH_NEW = 24
_K1_NAMES = ("paged_attention", "paged_attention_rows",
             "paged_attention_rows_mma")


@contextlib.contextmanager
def _draft_launches(de, into: dict, seen: dict):
    """For the block: K1's launches made inside the draft engine ``de``'s
    rollouts and ingest chunks, added to ``into`` by ``KERNELS`` name,
    and, in ``seen`` (by q shape), the inputs of every one of its layer-0
    K1 calls: q, table and lengths cloned on the device (no host sync),
    the span in blocks, and the draft's cache. It records only: the
    wrappers and their launch counts are untouched."""
    from skypilot_tpu_torch.infer import kvcache
    real_roll, real_ingest = de._dispatch_rollout, de._ingest
    real_k1 = kvcache._paged_attn_stats

    def k1(cache, i, table, qh, lengths, span, plain=False):
        if i == 0 and not plain:
            M = span if span is not None else kvcache._logical_rows(
                cache, table)
            seen.setdefault(tuple(qh.shape), []).append(dict(
                q=qh.clone(), table=table.clone(),
                lengths=lengths.clone(),
                span_blocks=-(-M // cache["k"].shape[2]), cache=cache))
        return real_k1(cache, i, table, qh, lengths, span, plain)

    def counted(fn):
        def run(*a, **kw):
            before = _read_launches()
            kvcache._paged_attn_stats = k1
            try:
                return fn(*a, **kw)
            finally:
                kvcache._paged_attn_stats = real_k1
                after = _read_launches()
                for k in _K1_NAMES:
                    into[k] = into.get(k, 0) + after[k] - before[k]
        return run

    de._dispatch_rollout, de._ingest = counted(real_roll), counted(
        real_ingest)
    try:
        yield
    finally:
        del de._dispatch_rollout, de._ingest


def _hold_draft_k1(de, seen: dict, tag: str) -> list:
    """(d) K1 against its plain version on the draft engine's own inputs
    (:func:`_draft_launches`), with its trash block filled with 100.0:
    for each q shape the draft gave K1 (its rollouts' decode shape and
    its ingest chunks' multi-row shape), the recorded call that read the
    most rows, over the draft's pools as they stand, under the kernel
    phase's rule and timings (:func:`_check_paged`). Returns the checked
    cases."""
    _fill_trash(de)
    out = []
    for shape, calls in sorted(seen.items()):
        call = max(calls, key=lambda c: c["lengths"].sum().item())
        cache = call["cache"]
        B, G, R, hd = shape
        body = "rollout" if R * hd <= 4096 else "ingest chunk"
        case = dict(q=call["q"], k_pool=cache["k"], v_pool=cache["v"],
                    k_scale=cache.get("k_scale"),
                    v_scale=cache.get("v_scale"), table=call["table"],
                    lengths=call["lengths"], layer=0,
                    span_blocks=call["span_blocks"])
        rows = int(call["lengths"].max())
        out.append(_check_paged(
            f"paged_attention {tag} draft {body} (B={B}, G={G}, R={R}, "
            f"blocks of {cache['k'].shape[2]}, longest {rows} rows, "
            f"{len(calls)} calls)", case))
    return out


@contextlib.contextmanager
def _predraft_fetches(de, into: list):
    """For the block, on the card: for each pipelined predraft the draft
    engine ``de`` dispatched, a CUDA event recorded on the current
    stream just before and just after its enqueue, and, at its deferred
    fetch (``DraftEngine._apply_pending`` with the rollout outstanding),
    whether the end event had completed (``Event.query``, no sync) and
    the host's wall in that fetch. Appends one dict per fetched predraft
    to ``into``; ``span_ms`` is read after the block. Records only."""
    import torch
    real_roll, real_apply = de.rollout, de._apply_pending
    events = []

    def roll(slots, k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sent = real_roll(slots, k)
        end.record()
        if sent:
            events.append((start, end))
        return sent

    def apply():
        if de._pending_roll is None or not events:
            return real_apply()
        start, end = events[-1]
        done = end.query()
        t0 = time.perf_counter()
        real_apply()
        into.append(dict(done=done, wait_ms=(time.perf_counter() - t0)
                         * 1e3, events=(start, end)))

    de.rollout, de._apply_pending = roll, apply
    try:
        yield
    finally:
        del de.rollout, de._apply_pending
        torch.cuda.synchronize()
        for r in into:
            start, end = r.pop("events")
            r["span_ms"] = start.elapsed_time(end)


def _predraft_report(fetches: list) -> dict:
    """Sums of :func:`_predraft_fetches`: how many fetched predrafts had
    finished on the card before the host asked for them, the fetches'
    host waits, and the predrafts' spans on the stream (from the
    verify's end to the predraft's: an upper bound of its device time,
    host-bound enqueue gaps included)."""
    if not fetches:
        return {"fetched": 0}
    waits = sorted(r["wait_ms"] for r in fetches)
    spans = sorted(r["span_ms"] for r in fetches)
    return {"fetched": len(fetches),
            "done_at_fetch": sum(r["done"] for r in fetches),
            "wait_ms_median": waits[len(waits) // 2],
            "wait_ms_max": waits[-1],
            "span_ms_median": spans[len(spans) // 2],
            "span_ms_max": spans[-1]}


def _spec_counters():
    from skypilot_tpu_torch.infer import engine as eng
    counts, total = eng.TPOT_SECONDS.labels().hist_state()
    return (eng.SPEC_VERIFY_WALL.labels().value,
            eng.SPEC_OVERLAP_WALL.labels().value, sum(counts), total)


def _draft_run(engine, prompts, new: int, tag: str, card: str,
               seen: dict) -> tuple:
    """One drain of ``prompts`` through ``engine``, launches counted from
    0 and split into the target's and the draft's; prints acceptance,
    the draft engine's counters, TPOT and the pipeline's overlap ratio.
    Returns (tokens, launches: {"target": ..., "draft": ..., "total":
    every serving kernel's}, report)."""
    de = engine.draft_engine
    draft = {k: 0 for k in _K1_NAMES}
    fetches = []
    timed = (de is not None and engine.spec_pipeline
             and engine.device.type == "cuda")
    before = _spec_counters()
    _zero_launches()
    t0 = time.time()
    with (_draft_launches(de, draft, seen) if de is not None
          else contextlib.nullcontext()), (
            _predraft_fetches(de, fetches) if timed
            else contextlib.nullcontext()):
        got = engine.generate(prompts, max_new_tokens=new)
    wall = time.time() - t0
    total = _read_launches()
    after = _spec_counters()
    target = {k: total[k] - draft[k] for k in _K1_NAMES}
    drafted = engine._spec_drafted_total
    rate = engine._spec_accepted_total / max(drafted, 1)
    verify_s, overlap_s = after[0] - before[0], after[1] - before[1]
    tpot_ms = (after[3] - before[3]) / max(after[2] - before[2], 1) * 1e3
    report = dict(wall_s=round(wall, 2), tpot_ms=round(tpot_ms, 2),
                  accept_rate=round(rate, 4), drafted=drafted,
                  verify_calls=engine.verify_calls,
                  overlap_ratio=round(overlap_s / verify_s, 4)
                  if verify_s else 0.0,
                  drafter=de.stats() if de is not None else None,
                  predraft=_predraft_report(fetches) if timed else None,
                  modes=sorted({r.spec_mode or "off"
                                for r in engine.finished}))
    _log(f"{tag}: {len(prompts)} requests x {new} tokens in {wall:.2f} s: "
         f"{json.dumps(report)}; K1 launches target {target}, draft "
         f"{draft}; {card}")
    return got, {"target": target, "draft": draft, "total": total}, report


def _draft_engine_leg(dev, card: str) -> tuple:
    """(a) llama3-8b at full width (``CUT_LAYERS``), bf16, 16 slots,
    max_len 1024, chunks of 512, spec K 4; target and draft from
    ``self_distilled_pair(params, cfg, DRAFT_LAYERS)``. The 8 requests (``DRAFT_LENS``,
    two chunked) run spec-off, then with the model drafter pipelined,
    then synchronous, each from a fresh engine. Held: acceptance above
    ``DRAFT_BF16_ACCEPT``, every request on the model rung,
    ``reuse_hits`` > 0 and a predraft dispatched before every fetch when
    pipelined (structure: the predraft's device overlap is what
    :func:`_predraft_fetches` reports, not what this holds) and no
    predraft when synchronous, the draft's
    rollouts and ingest chunks on K1's decode and ``wgmma`` multi-row
    bodies (never ``mma.sync``), both pools drained; then K1 on the
    pipelined draft's own inputs (:func:`_hold_draft_k1`). Returns
    (launches, bf16 cases for :func:`_bf16_hold`, kernel cases)."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import draft as draft_lib
    from skypilot_tpu_torch.infer import engine as eng
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.observability import flight as flight_lib
    cfg = llama.CONFIGS["llama3-8b"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = llama.init_params(cfg, gen, device=dev, dtype=cfg.dtype)
    target, dparams, dcfg = draft_lib.self_distilled_pair(params, cfg,
                                                          DRAFT_LAYERS)
    del params
    rng = np.random.default_rng(SEED + 11)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in DRAFT_LENS]

    def engine(**kw):
        return eng.InferenceEngine(
            target, cfg, n_slots=16, max_len=1024,
            prompt_buckets=(128, 512, 1024), max_wave=8, prefill_chunk=512,
            device=dev, **kw)

    want, off_n, _ = _draft_run(engine(spec_k=0), prompts, DRAFT_NEW,
                                "draft[off]", card, {})
    launches = dict(off_n["total"])
    cases, kcases = [], []
    for name, pipeline in (("pipelined", True), ("sync", False)):
        seen = {}
        de = draft_lib.DraftEngine(dparams, dcfg, n_slots=16,
                                   max_len=1024, device=dev)
        e = engine(spec_k=4, draft_engine=de, spec_pipeline=pipeline,
                   flight_recorder=flight_lib.FlightRecorder())
        got, n, rep = _draft_run(e, prompts, DRAFT_NEW,
                                 f"draft[{name}]", card, seen)
        for k, v in n["total"].items():
            launches[k] += v
        st = de.stats()
        recs = e.flight.tail()
        verifies = [r for r in recs if r["burst"] == "verify"]
        predrafts = [r for r in recs if r["burst"] == "draft"]
        if not (rep["accept_rate"] > DRAFT_BF16_ACCEPT
                and rep["modes"] == ["model"]):
            raise AssertionError(f"draft[{name}]: acceptance "
                                 f"{rep['accept_rate']}, rungs "
                                 f"{rep['modes']}")
        # Every model-drafted round carries its predraft: each of its
        # verify records (the parts of a round share its begin and end)
        # holds a "draft" record between its last enqueue and its fetch.
        model_verifies = [v for v in verifies if v["drafter"] == "model"]
        bare = [v for v in model_verifies if not (
            v.get("overlap_ms", 0) > 0 and any(
                v["ts_s"] + v["dispatch_wall_ms"] / 1e3 <= d["ts_s"] + 1e-6
                and d["ts_s"] + d["dur_s"] <= v["ts_s"] + v["dur_s"] + 1e-6
                for d in predrafts))]
        if pipeline and not (st["reuse_hits"] > 0
                             and rep["overlap_ratio"] > 0
                             and model_verifies and not bare):
            raise AssertionError(f"draft[{name}]: no pipelined reuse or "
                                 f"overlap: {st}, {rep}, {len(bare)} of "
                                 f"{len(model_verifies)} model-drafted "
                                 f"verify records without a predraft")
        if not pipeline and predrafts:
            raise AssertionError("draft[sync]: a predraft was dispatched")
        if not (n["draft"]["paged_attention"] > 0
                and n["draft"]["paged_attention_rows"] > 0
                and n["target"]["paged_attention"] > 0
                and n["target"]["paged_attention_rows"] > 0
                and not n["draft"]["paged_attention_rows_mma"]
                and not n["target"]["paged_attention_rows_mma"]):
            raise AssertionError(f"draft[{name}]: launches {n}")
        if de.blocks_used or e.blocks_used():
            raise AssertionError(f"draft[{name}]: pools not drained")
        cases += [(f"request {i} ({len(p)} tokens)",
                   f"spec-off and model-drafted ({name})", p, g, w)
                  for i, (p, g, w) in enumerate(zip(prompts, got, want))]
        if pipeline:
            kcases = _hold_draft_k1(de, seen, "8b")
        del e, de, seen
        _free_card()
    del target, dparams
    _free_card()
    return launches, cases, kcases


def _draft_fp32_leg(dev, card: str) -> dict:
    """(b) llama3-8b's width on its first 8 layers in float32, the draft
    ``self_distilled_pair(..., 4)``: pipelined and synchronous on float32
    pools and on int8 pools, and a random 1-layer draft on float32 pools
    (acceptance near 0, rollbacks > 0); 4 requests of ``DRAFT_NEW``
    tokens (a request's last round drafts past its budget, so a short
    budget caps the acceptance rate below 0.9). Every run's tokens equal the
    spec-off engine's on the same pools wherever the plain top-2 gap
    exceeds 1e-2 (:func:`_agree`). Returns the launches."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import draft as draft_lib
    from skypilot_tpu_torch.infer import engine as eng
    from skypilot_tpu_torch.models import llama
    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"],
                              n_layers=DRAFT_FP32_LAYERS,
                              dtype=torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = llama.init_params(cfg, gen, device=dev, dtype=torch.float32)
    target, dparams, dcfg = draft_lib.self_distilled_pair(
        params, cfg, DRAFT_FP32_DRAFT)
    del params
    rcfg = dataclasses.replace(cfg, n_layers=1)
    gen.manual_seed(SEED + 7)
    rparams = llama.init_params(rcfg, gen, device=dev, dtype=torch.float32)
    rng = np.random.default_rng(SEED + 11)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (775, 289, 98, 400)]

    def engine(kv8, **kw):
        return eng.InferenceEngine(
            target, cfg, n_slots=8, max_len=1024,
            prompt_buckets=(128, 512, 1024), max_wave=8, prefill_chunk=512,
            kv_int8=kv8, device=dev, **kw)

    launches = {}
    for kv8 in (False, True):
        pools = "int8" if kv8 else "fp32"
        want, n, _ = _draft_run(engine(kv8, spec_k=0), prompts, DRAFT_NEW,
                                f"draft[fp32, {pools} pools, off]", card,
                                {})
        for k, v in n["total"].items():
            launches[k] = launches.get(k, 0) + v
        ref = engine(kv8, spec_k=0, plain_attention=True)
        runs = [("distilled", dparams, dcfg, True),
                ("distilled", dparams, dcfg, False)]
        if not kv8:
            runs.append(("random 1-layer", rparams, rcfg, True))
        for what, dp, dc, pipeline in runs:
            de = draft_lib.DraftEngine(dp, dc, n_slots=8, max_len=1024,
                                       kv_int8=kv8, device=dev)
            e = engine(kv8, spec_k=4, draft_engine=de,
                       spec_pipeline=pipeline)
            mode = "pipelined" if pipeline else "sync"
            tag = f"draft[fp32, {pools} pools, {what}, {mode}]"
            got, n, rep = _draft_run(e, prompts, DRAFT_NEW, tag, card, {})
            for k, v in n["total"].items():
                launches[k] += v
            if what == "distilled" and not rep["accept_rate"] > 0.9:
                raise AssertionError(f"{tag}: acceptance "
                                     f"{rep['accept_rate']}")
            if what != "distilled" and not (
                    rep["accept_rate"] < 0.2 and de.rollbacks > 0):
                raise AssertionError(f"{tag}: acceptance "
                                     f"{rep['accept_rate']}, rollbacks "
                                     f"{de.rollbacks}")
            for i, (p, g, w) in enumerate(zip(prompts, got, want)):
                _agree(ref, p, g, w, f"request {i} ({len(p)} tokens)",
                       "spec-off and model-drafted", tag)
            if de.blocks_used or e.blocks_used():
                raise AssertionError(f"{tag}: pools not drained")
            del e, de
            _free_card()
        del ref
        _free_card()
    return launches


def _draft_server_leg(dev, card: str) -> tuple:
    """(c) The port's server through ``make_engine`` at llama3-8b (bf16,
    the reference server's defaults) with ``--draft-model llama3-400m
    --spec-pipeline 1``: the 400m draft at its full width and depth (12
    layers, d_model 1536, 4 kv-heads) with the target's 128256-token
    vocabulary. 4 concurrent ``/generate`` requests (one streamed, one
    chunked), 32 new tokens each: every answer has its budget; on random
    weights the draft's acceptance collapses, so trailers read
    ``model``, ``ngram`` or ``off`` (counts printed); ``/metrics`` counts
    ``skytpu_spec_draft_tokens_total{drafter="model"}`` > 0; the draft's
    K1 launches are split out, and K1 is then held on its own inputs
    (:func:`_hold_draft_k1`). Returns (launches, kernel cases)."""
    import numpy as np
    from skypilot_tpu_torch.infer import server as srv
    engine = srv.make_engine("llama3-8b", device=dev, seed=SEED,
                             draft_model="llama3-400m", spec_pipeline=True)
    from skypilot_tpu_torch.models import llama
    de = engine.draft_engine
    if de.cfg != dataclasses.replace(llama.CONFIGS["llama3-400m"],
                                     vocab_size=engine.cfg.vocab_size):
        raise AssertionError(f"draft[server]: draft config {de.cfg}")
    _log(f"draft[server]: draft llama3-400m, {de.cfg.n_layers} layers, "
         f"d_model {de.cfg.d_model}, {de.cfg.n_heads}/{de.cfg.n_kv_heads} "
         f"heads, vocab {de.cfg.vocab_size}, blocks of {de.kv_block}")
    _fill_trash(engine)
    _fill_trash(de)
    port = _free_port()
    model, httpd = srv.serve(engine, host="127.0.0.1", port=port)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{port}"
    rng = np.random.default_rng(SEED + 13)
    prompts = [rng.integers(1, engine.cfg.vocab_size, n).tolist()
               for n in (600, 300, 98, 200)]
    results = [None] * len(prompts)
    draft, seen = {k: 0 for k in _K1_NAMES}, {}
    try:
        model.wait_ready(timeout=900)

        def send(k):
            body = {"tokens": prompts[k], "max_new_tokens": 32}
            if k == 3:
                body["stream"] = True
                code, raw = _post_raw(f"{url}/generate",
                                      json.dumps(body).encode())
                lines = [json.loads(x) for x in raw.splitlines()
                         if x.strip()]
                results[k] = (code, dict(lines[-1], tokens=[
                    t for c in lines for t in c.get("tokens", [])]))
            else:
                results[k] = _post_status(f"{url}/generate", body)[:2]

        before = _scrape(url)
        _zero_launches()
        t0 = time.time()
        with _draft_launches(de, draft, seen):
            threads = [threading.Thread(target=send, args=(k,))
                       for k in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        wall = time.time() - t0
        total = _read_launches()
        after = _scrape(url)
    finally:
        httpd.shutdown()
        model.shutdown()
        th.join(timeout=30)
    for code, out in results:
        if code != 200 or len(out.get("tokens", [])) != 32 or out.get(
                "drafter") not in ("model", "ngram", "off"):
            raise AssertionError(f"draft[server]: {code} {str(out)[:300]}")
    rungs = {}
    for _, out in results:
        rungs[out["drafter"]] = rungs.get(out["drafter"], 0) + 1
    model_toks = _delta(after, before, "skytpu_spec_draft_tokens_total",
                        drafter="model")
    target = {k: total[k] - draft[k] for k in _K1_NAMES}
    _log(f"draft[server]: 4 requests (one streamed, one chunked) through "
         f"--draft-model llama3-400m --spec-pipeline 1 in {wall:.2f} s; "
         f"trailers' drafter {rungs} (demoted from model: "
         f"{sum(v for k, v in rungs.items() if k != 'model')}); /metrics "
         f"draft tokens model +{model_toks:g}, ngram "
         f"+{_delta(after, before, 'skytpu_spec_draft_tokens_total', drafter='ngram'):g}; "
         f"drafter {de.stats()}; K1 launches target {target}, draft "
         f"{draft}; {card}")
    if not (model_toks > 0 and draft["paged_attention"] > 0
            and draft["paged_attention_rows"] > 0
            and not total["paged_attention_rows_mma"]):
        raise AssertionError(f"draft[server]: model draft tokens "
                             f"+{model_toks}, launches {total}, draft "
                             f"{draft}")
    kcases = _hold_draft_k1(de, seen, "400m")
    del engine, de, seen
    _free_card()
    return total, kcases


def _draft_two_streams(dev) -> list:
    """(e) Two K1 decode launches at a time on two CUDA streams, 8 in
    turn on each, at the engine leg's decode shape (16 slots, 8
    kv-heads, 4 rows each): every result equals the plain version under
    K1's rule, as each stream counts off its own ticket counters."""
    import torch
    from skypilot_tpu_torch.ops import paged_attention as pa
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 21)
    cases = [_paged_case(False, gen, dev), _paged_case(True, gen, dev)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(8):
        for i, (s, c) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(s):
                outs[i].append(pa.paged_attention(
                    c["q"], c["k_pool"], c["v_pool"], c["k_scale"],
                    c["v_scale"], c["table"], c["lengths"], c["layer"],
                    span_blocks=c["span_blocks"]))
    torch.cuda.synchronize()
    errs = []
    for c, got in zip(cases, outs):
        want = pa.paged_attention_ref(
            c["q"], c["k_pool"], c["v_pool"], c["k_scale"], c["v_scale"],
            c["table"], c["lengths"], c["layer"], c["span_blocks"])
        live = c["lengths"] > 0
        for out in got:
            errs.append(max(_err(g[live], w[live], "two streams", 2e-3)
                            for g, w in zip(out, want)))
    keys = {k for k in pa._tickets if k[0] == dev}
    if not {(dev, s.cuda_stream) for s in streams} <= keys:
        raise AssertionError(f"two streams: ticket counters {keys}")
    _log(f"draft[streams]: 16 K1 decode launches (bf16 and int8 pools) on "
         f"two CUDA streams in turn, each on its own ticket counters, "
         f"agree with the plain version (max err {max(errs):.3e})")
    return errs


def phase_draft(dev, card: str) -> tuple:
    """The draft model and the async draft/verify pipeline: (a)
    :func:`_draft_engine_leg` (every bf16 divergence under the bf16
    floor rule, the references the distilled target), (b)
    :func:`_draft_fp32_leg`, (c) :func:`_draft_server_leg`, (d) K1 on the
    draft engines' own inputs, held inside (a) and (c), (e)
    :func:`_draft_two_streams`, (f) ``bench_serve.run_spec`` at
    llama3-8b, 8 requests of ``DRAFT_BENCH_NEW`` new tokens (the
    reference's 256 cut for time), its report printed and its overlap
    structure held. Returns
    ({path: launches}, {kernel: checked cases})."""
    from skypilot_tpu_torch.infer import bench_serve
    t0 = time.time()
    out = {}
    out["draft"], cases, k8 = _draft_engine_leg(dev, card)
    _bf16_hold(dev, "llama3-8b", 512, cases, "draft", distill=DRAFT_LAYERS)
    _free_card()
    out["draft[fp32]"] = _draft_fp32_leg(dev, card)
    _free_card()
    out["draft[server]"], k400 = _draft_server_leg(dev, card)
    kcases = {}
    for c in k8 + k400:
        name = ("paged_attention" if "rollout" in c["name"]
                else "paged_attention_rows")
        kcases.setdefault(name, []).append(c)
    _draft_two_streams(dev)
    _free_card()
    _zero_launches()
    t1 = time.time()
    r = bench_serve.run_spec(config="llama3-8b", requests=8,
                             new_tokens=DRAFT_BENCH_NEW, device=dev)
    out["draft[bench]"] = _read_launches()
    _log(f"draft[bench]: run_spec(llama3-8b, 8 requests, "
         f"{DRAFT_BENCH_NEW} new) in "
         f"{time.time() - t1:.1f} s: {json.dumps(r)}; launches "
         f"{out['draft[bench]']}; {card}")
    if not (r["overlap_ok"] and r["draft_records"] > 0
            and r["draft_reuse_hits"] > 0):
        raise AssertionError(f"draft[bench]: pipeline structure {r}")
    _positive(r, ("model_tpot_off_ms", "tpot_model_ms",
                  "tpot_model_sync_ms", "tpot_off_ms", "tpot_spec_ms",
                  "tpot_oracle_ms"), "draft")
    _free_card()
    _log(f"draft: phase in {time.time() - t0:.1f} s; {card}")
    return out, kcases


# ---------------------------------------------------------------------------
# Phase 10: crash recovery
# ---------------------------------------------------------------------------

# 8 requests of ``RECOVER_NEW`` new tokens, two chunked (775 and 597
# tokens); one seeded fault a run. The six short prompts stay on one
# span rung (their contexts below 512 rows), so a decode step runs two
# span groups, each a forward pass of every layer on this host-bound
# engine, where the serve phase's spread of lengths runs up to four.
RECOVER_LENS = (775, 597, 290, 320, 350, 380, 410, 440)
RECOVER_NEW = 24
RECOVER_FAULTS = {
    # The second admission pass: every request is resident or chunking.
    "admit": {"point": "engine.dispatch", "match": {"seam": "admit"},
              "after": 1},
    # The second prefill chunk: the 775-token prompt is half prefilled.
    "chunk": {"point": "engine.dispatch", "match": {"seam": "chunk"},
              "after": 1},
    "verify": {"point": "engine.dispatch", "match": {"seam": "verify"},
               "after": 1},
    # The second decode-seam hit: the first burst's completion, after
    # its dispatch (none of its tokens may commit).
    "decode": {"point": "engine.dispatch", "match": {"seam": "decode"},
               "after": 1},
    # The fourth block claim, in the middle of the first admission pass.
    "kv.alloc": {"point": "kv.alloc", "after": 3},
}


def _recover_drive(engine, prompts, new: int, fault=None, on_crash=None):
    """Drain ``prompts`` through ``engine`` under the chaos rule
    ``fault`` (None: uninterrupted), recovering through every
    ``EngineDispatchError`` as the server does; ``on_crash(ex)`` runs
    before each recovery. Returns (tokens, the requests, recoveries,
    faults fired)."""
    from skypilot_tpu_torch import chaos
    from skypilot_tpu_torch.infer import engine as eng
    ids = [engine.add_request(p, max_new_tokens=new) for p in prompts]
    chaos.configure({"seed": SEED, "faults": [dict(fault, times=1)]}
                    if fault else {"faults": []})
    recovered = 0
    try:
        while engine.waiting or engine.chunking or engine.slot_req:
            try:
                engine.step_burst(max_burst=8)
            except eng.EngineDispatchError as ex:
                if on_crash is not None:
                    on_crash(ex)
                engine.recover(ex)
                recovered += 1
        fired = len(chaos.injector().fired)
    finally:
        chaos.deactivate()
    reqs = {r.rid: r for r in engine.finished}
    engine.finished.clear()
    return ([list(reqs[i].tokens) for i in ids], [reqs[i] for i in ids],
            recovered, fired)


def _recover_runs(engine, prompts, tag: str, card: str, faults,
                  k1=None) -> tuple:
    """The uninterrupted twin, then one run per fault of ``faults`` (a
    name of ``RECOVER_FAULTS``), each from a reset engine with a cold
    prefix cache: the fault fires once, the run recovers once, a victim
    counts its recovery, every request returns its budget and the pool
    drains. ``k1`` (a list): the inputs of the first multi-row K1 call
    after the verify run's crash that reads cached rows. Returns (twin
    tokens, {fault: tokens})."""
    def fresh():
        engine.reset()
        engine.clear_prefix_cache()
        _fill_trash(engine)

    fresh()
    t0 = time.time()
    twin, _, _, _ = _recover_drive(engine, prompts, RECOVER_NEW)
    _log(f"{tag}: uninterrupted twin, {len(prompts)} requests x "
         f"{RECOVER_NEW} tokens in {time.time() - t0:.2f} s; {card}")
    out = {}
    for name in faults:
        fresh()
        crashed = []
        keep = (k1 is not None and name == "verify")
        t0 = time.time()
        with (_first_rows_call(
                engine, k1, lambda lens: bool(crashed)
                and int(lens.max()) > 0) if keep
              else contextlib.nullcontext()):
            got, reqs, rec, fired = _recover_drive(
                engine, prompts, RECOVER_NEW, RECOVER_FAULTS[name],
                on_crash=lambda ex: crashed.append(ex.seam))
        victims = sum(1 for r in reqs if r.recoveries)
        engine.clear_prefix_cache()
        if (fired, rec) != (1, 1) or not victims or any(
                len(t) != RECOVER_NEW for t in got) \
                or engine.blocks_used():
            raise AssertionError(
                f"{tag}[{name}]: fired {fired}, recoveries {rec}, victims "
                f"{victims}, tokens {[len(t) for t in got]}, blocks "
                f"{engine.blocks_used()}")
        parted = sum(g != w for g, w in zip(got, twin))
        _log(f"{tag}[{name}]: the fault at seam {crashed} recovered in "
             f"{time.time() - t0:.2f} s; {victims} victims; {parted} of "
             f"{len(prompts)} requests part from the twin; pool drained; "
             f"{card}")
        out[name] = got
    return twin, out


def _recover_server_leg(engine, prompts, twin, card: str) -> list:
    """The HTTP server over ``engine``: ``prompts`` streamed at once, one
    verify fault: every stream ends with its done line and the budget,
    a trailer counts the recovery, and ``/metrics``'
    ``skytpu_engine_recoveries_total`` moves by exactly 1. Returns the
    bf16 cases (against ``twin``)."""
    from skypilot_tpu_torch import chaos
    from skypilot_tpu_torch.infer import server as srv
    engine.reset()
    engine.clear_prefix_cache()
    port = _free_port()
    model, httpd = srv.serve(engine, host="127.0.0.1", port=port)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{port}"
    try:
        model.wait_ready(timeout=300)

        def recoveries():
            return sum(v for (name, _), v in _scrape(url).items()
                       if name == "skytpu_engine_recoveries_total")

        before = recoveries()
        chaos.configure({"seed": SEED, "faults": [
            dict(RECOVER_FAULTS["verify"], times=1)]})
        res = [None] * len(prompts)

        def one(i):
            body = json.dumps({"tokens": prompts[i], "stream": True,
                               "max_new_tokens": RECOVER_NEW}).encode()
            res[i] = _stream_timed(f"{url}/generate", body, 0)

        t0 = time.time()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.time() - t0
        fired = len(chaos.injector().fired)
        delta = recoveries() - before
    finally:
        chaos.deactivate()
        httpd.shutdown()
        httpd.server_close()
        model.shutdown()
    done = [r[1] if r else None for r in res]
    if (fired != 1 or delta != 1 or any(d is None for d in done)
            or any(d["n_tokens"] != RECOVER_NEW for d in done)
            or not sum(d["recoveries"] for d in done)):
        raise AssertionError(f"recover[server]: fired {fired}, metric "
                             f"delta {delta}, done lines {done}")
    _log(f"recover[server]: {len(prompts)} streams through one verify "
         f"fault in {wall:.2f} s, trailers' recoveries "
         f"{[d['recoveries'] for d in done]}, "
         f"skytpu_engine_recoveries_total +{delta:g}; {card}")
    return [(f"streamed request {i}", "recovered and uninterrupted",
             prompts[i], res[i][0], twin[i]) for i in range(len(prompts))]


def _recover_fp32_leg(dev, card: str) -> dict:
    """Float32 on llama3-8b's first 8 layers, the serve engine's shape:
    chunk and verify faults against the uninterrupted twin, then the
    self-distilled draft (4 layers) pipelined with the fault at a
    verify while a predraft is pending (the drafter's pool and table
    drained by the reset); tokens equal or part only where the plain
    top-2 gap is at most 1e-2. Returns the launches."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import draft as draft_lib
    from skypilot_tpu_torch.infer import engine as eng
    from skypilot_tpu_torch.models import llama
    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"],
                              n_layers=INT8_FP32_LAYERS, dtype=torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = llama.init_params(cfg, gen, device=dev, dtype=torch.float32)
    target, dparams, dcfg = draft_lib.self_distilled_pair(
        params, cfg, DRAFT_FP32_DRAFT)
    del params
    rng = np.random.default_rng(SEED + 13)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in RECOVER_LENS]
    kw = dict(n_slots=16, max_len=1024, prompt_buckets=(128, 512, 1024),
              kv_block=256, prefill_chunk=512, device=dev)
    ref = _plain_tier(target, cfg, dev, 1024)
    _zero_launches()
    e = eng.InferenceEngine(target, cfg, prefix_pool=8, spec_k=4, **kw)
    twin, got = _recover_runs(e, prompts, "recover[fp32]", card,
                              ("chunk", "verify"))
    del e
    de = draft_lib.DraftEngine(dparams, dcfg, n_slots=16, max_len=1024,
                               device=dev)
    e = eng.InferenceEngine(target, cfg, spec_k=4, draft_engine=de,
                            spec_pipeline=True, **kw)
    pending = []

    def at_crash(ex):
        pending.append(de.stats()["pending"])

    dtwin, _, _, _ = _recover_drive(e, prompts, RECOVER_NEW)
    e.reset()
    dgot, _, rec, fired = _recover_drive(
        e, prompts, RECOVER_NEW, dict(RECOVER_FAULTS["verify"], after=2),
        on_crash=at_crash)
    launches = _read_launches()
    if (fired, rec, pending) != (1, 1, [1]) or de.blocks_used \
            or e.blocks_used():
        raise AssertionError(f"recover[fp32, draft]: fired {fired}, "
                             f"recoveries {rec}, predraft pending at the "
                             f"crash {pending}, blocks {de.blocks_used} / "
                             f"{e.blocks_used()}")
    _log(f"recover[fp32, draft]: a verify fault with the pipelined "
         f"predraft pending recovered; drafter {de.stats()}; {card}")
    for name, toks, want in ([(n, t, twin) for n, t in got.items()]
                             + [("draft", dgot, dtwin)]):
        for i, (p, g, w) in enumerate(zip(prompts, toks, want)):
            _agree(ref, p, g, w, f"request {i} ({len(p)} tokens)",
                   "recovered and uninterrupted", f"recover[fp32, {name}]")
    del e, de, ref, target, dparams
    _free_card()
    return launches


def phase_recover(dev, card: str) -> dict:
    """Crash recovery on the serve engine at llama3-8b bf16 (16 slots,
    max_len 1024, blocks of 256, chunks of 512, a prefix pool of 8, spec
    K 4): 8 requests (two chunked) of 24 new tokens, uninterrupted, then
    one seeded fault a run at each of ``RECOVER_FAULTS`` (the admit,
    chunk, verify and decode seams and a block claim), held to the twin
    under the bf16 floor rule; K1 against its plain version at the first
    resume chunk after the verify crash that reads cached rows, the
    trash block at 100.0; the HTTP server through one verify fault
    (:func:`_recover_server_leg`); and :func:`_recover_fp32_leg`.
    Returns {path: launches}."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import engine as eng
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import paged_attention as pa
    t0 = time.time()
    config = "llama3-8b"
    cfg = llama.CONFIGS[config]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = llama.init_params(cfg, gen, device=dev, dtype=cfg.dtype)
    rng = np.random.default_rng(SEED + 12)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in RECOVER_LENS]
    e = eng.InferenceEngine(
        params, cfg, n_slots=16, max_len=1024,
        prompt_buckets=(128, 512, 1024), kv_block=256, prefill_chunk=512,
        prefix_pool=8, spec_k=4, device=dev)
    out = {}
    k1 = []
    _zero_launches()
    twin, got = _recover_runs(e, prompts, "recover", card,
                              tuple(RECOVER_FAULTS), k1)
    out["recover"] = _read_launches()
    if not k1:
        raise AssertionError("recover: no resume chunk read cached rows "
                             "after the verify crash")
    _fill_trash(e)
    i, table, qh, lengths, span = k1[0]
    sb = -(-(span or (table.shape[1] - 1) * e.kv_block) // e.kv_block)
    c = e.cache
    err = _paged_err("recover K1 at the resume chunk", dict(
        q=qh, k_pool=c["k"], v_pool=c["v"], k_scale=c.get("k_scale"),
        v_scale=c.get("v_scale"), table=table, lengths=lengths, layer=i,
        span_blocks=sb), pa.paged_attention)
    _log(f"recover: K1 agrees with its plain version at the first resume "
         f"chunk after the verify crash (R={qh.shape[2]}, start "
         f"{int(lengths.max())}, {sb} blocks, trash block 100.0): max err "
         f"{err:.3e}")
    del k1
    _zero_launches()
    cases = _recover_server_leg(e, prompts[:4], twin, card)
    out["recover[server]"] = _read_launches()
    del e, params
    _free_card()
    cases += [(f"request {i}", f"recovered at {name} and uninterrupted",
               prompts[i], toks[i], twin[i])
              for name, toks in got.items() for i in range(len(prompts))]
    # A case is checked where it first parts, on the twin's context up
    # to there: runs that part at the same place share one check.
    unique = {}
    for c in cases:
        t = next((j for j, (a, b) in enumerate(zip(c[3], c[4]))
                  if a != b), None)
        if t is not None:
            unique.setdefault((tuple(c[2]), tuple(c[4][:t])), c)
    _bf16_hold(dev, config, 512, list(unique.values()), "recover")
    _free_card()
    out["recover[fp32]"] = _recover_fp32_leg(dev, card)
    _log(f"recover: phase in {time.time() - t0:.1f} s; launches "
         f"{json.dumps(out)}; {card}")
    return out


# ---------------------------------------------------------------------------
# Phase 11: observe a replica (tracing, flight records, forensics)
# ---------------------------------------------------------------------------

OBSERVE_NEW = 16
# New tokens a request in each timed parity pass: 16 requests (one a
# slot) x 24 = 384 tokens a pass.
OBSERVE_PARITY_NEW = 24


def _observe_prompts(cfg, rng) -> dict:
    """The observe phase's mixed workload: waves (four short prompts),
    chunks at 512 (prompts of 700 and 900 tokens), an n-gram verify (a
    repeated 12-token phrase) and a shared-prefix pair (600 shared
    tokens, then 220 and 160 of their own: the second is a prefix hit).
    ``parity``: one prompt a slot for the timed passes, the two
    shortest, the phrase six times and thirteen of 32-100 tokens (waves,
    decode and verify in one span group of 128 rows; no chunk)."""
    def draw(n):
        return rng.integers(1, cfg.vocab_size, n).tolist()
    phrase = draw(12)
    base = draw(600)
    short = [draw(n) for n in (40, 96, 180, 300)]
    return {"batch": short + [draw(700), draw(900), phrase * 24],
            "pair": [base + draw(220), base + draw(160)],
            "parity": short[:2] + [phrase * 6]
            + [draw(int(n)) for n in rng.integers(32, 101, 13)]}


def _device_ms(prof) -> float:
    """The device time of every CUDA kernel a profile recorded, ms."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return sum(evt.time_range.elapsed_us() for evt in prof.events()
               if getattr(evt, "device_type", None) == cuda) / 1e3


def _observe_http(engine, card: str, prompts: dict) -> tuple:
    """The port's HTTP server over the warmed ``engine`` serves the mixed
    workload: the batch concurrently (one request with a ``traceparent``),
    then the shared-prefix pair one after the other; then ``/debug/flight``
    and ``/debug/forensics`` are read over HTTP. Returns (launches,
    the window's flight records, the traced request's trace id)."""
    from skypilot_tpu_torch.infer import engine as eng
    from skypilot_tpu_torch.infer import server as srv
    from skypilot_tpu_torch.observability import tracing
    from skypilot_tpu_torch.utils import timeline
    port = _free_port()
    model, httpd = srv.serve(engine, host="127.0.0.1", port=port,
                             max_burst=8, coalesce_s=0.5)
    trace = os.path.join(os.environ["SKYTPU_EVENTS_DIR"],
                         "observe_timeline.json")
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{port}"
    caller = tracing.SpanContext(tracing.new_trace_id(),
                                 tracing.new_span_id())
    try:
        model.wait_ready(timeout=600)
        engine.decode_programs.clear()
        seq0 = engine.flight.seq()
        os.environ[timeline.ENV_VAR] = trace
        timeline._events.clear()
        decode0 = sum(eng.DECODE_STEP_SECONDS.labels().hist_state()[0])
        _zero_launches()
        t0 = time.time()
        results, errors = [None] * len(prompts["batch"]), []

        def one(i, p):
            hdr = ({"traceparent": tracing.format_traceparent(caller)}
                   if i == 0 else None)
            try:
                code, body, _ = _post_status(
                    f"{base}/generate",
                    {"tokens": p, "max_new_tokens": OBSERVE_NEW}, hdr)
                results[i] = body if code == 200 else None
                if code != 200:
                    errors.append((i, code, body))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append((i, e))

        threads = [threading.Thread(target=one, args=(i, p))
                   for i, p in enumerate(prompts["batch"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        pair = [_post(f"{base}/generate",
                      {"tokens": p, "max_new_tokens": OBSERVE_NEW})
                for p in prompts["pair"]]
        wall = time.time() - t0
        launches = _read_launches()
        timeline.save_now()
        decodes = sum(eng.DECODE_STEP_SECONDS.labels().hist_state()[0]) \
            - decode0
        if errors or any(len(r["tokens"]) != OBSERVE_NEW
                         for r in results + pair):
            raise AssertionError(f"observe: failed requests {errors}")
        if not pair[1]["cache_hit"] or pair[0]["cache_hit"]:
            raise AssertionError(f"observe: the pair's prefix hits "
                                 f"{[r['cache_hit'] for r in pair]}")
        with urllib.request.urlopen(f"{base}/debug/flight?n=8192",
                                    timeout=60) as r:
            flight_body = json.loads(r.read())
        with urllib.request.urlopen(f"{base}/debug/forensics",
                                    timeout=60) as r:
            forensics_body = json.loads(r.read())
        window = [r for r in flight_body["records"] if r["seq"] > seq0]
        with open(trace) as f:
            spans = [e["name"] for e in json.load(f)["traceEvents"]
                     if e["ph"] == "X"]
        span_counts = {n: spans.count(n) for n in (
            "skytpu_prefill_seconds", "skytpu_decode_step_seconds",
            "skytpu_server_wave_flush_seconds")}
        waves = sum(r["burst"] == "wave" for r in window)
        if span_counts["skytpu_prefill_seconds"] != waves or not waves or \
                span_counts["skytpu_decode_step_seconds"] != decodes or \
                not decodes:
            raise AssertionError(f"observe: timeline spans {span_counts} "
                                 f"for {waves} wave records and {decodes} "
                                 f"decode-step samples")
        retired = [r["rids"][0] for r in window if r["burst"] == "retire"]
        if len(retired) != len(results) + len(pair):
            raise AssertionError(f"observe: {len(retired)} retire records "
                                 f"for {len(results) + len(pair)} "
                                 f"requests")
        # The longest request's ledger over HTTP: its phases partition
        # its wall.
        rid = retired[-2]
        with urllib.request.urlopen(f"{base}/debug/forensics?rid={rid}",
                                    timeout=60) as r:
            why = json.loads(r.read())
        led = why["ledger"]
        total = sum(ph["ms"] for ph in led["phases"])
        if abs(total - led["wall_ms"]) > 0.05 or \
                led["named_ms"] < 0.9 * led["wall_ms"]:
            raise AssertionError(f"observe: ledger of rid {rid} sums to "
                                 f"{total} for a wall of {led['wall_ms']}"
                                 f" ({led['named_ms']} named)")
        traced = [r for r in window if caller.trace_id in
                  (r.get("traces") or ())]
        if not any(r["burst"] == "retire" for r in traced) or not any(
                r["burst"] in ("wave", "chunk") for r in traced):
            raise AssertionError("observe: the traceparent's trace id is "
                                 "on no burst or retire record")
        try:
            with urllib.request.urlopen(
                    f"{base}/debug/forensics?rid=x", timeout=60):
                raise AssertionError("observe: a bad rid was answered")
        except urllib.error.HTTPError as e:
            if e.code != 400:
                raise
        _log(f"observe[http]: {len(results) + len(pair)} requests x "
             f"{OBSERVE_NEW} tokens in {wall:.2f} s, {len(window)} flight "
             f"records ({flight_body['seq']} in the ring), warm "
             f"{flight_body['warm']}, unexpected "
             f"{flight_body['unexpected']}, forensics keys "
             f"{sorted(forensics_body)}; /debug/forensics?rid={rid}: "
             f"wall {led['wall_ms']:.1f} ms over {led['n_records']} "
             f"records = "
             + ", ".join(f"{ph['phase']} {ph['ms']:.1f}"
                         for ph in led["phases"])
             + f"; timeline spans {span_counts}; launches {launches}; "
             f"{card}")
        return launches, window, caller.trace_id
    finally:
        os.environ.pop(timeline.ENV_VAR, None)
        timeline._events.clear()
        httpd.shutdown()
        httpd.server_close()
        model.shutdown()


def _observe_parity(engine, prompts: list, card: str) -> None:
    """Recording only observes, and what it costs: one request a slot
    (``prompts``, ``OBSERVE_PARITY_NEW`` new tokens each) in four
    settings, everything on, the recorder off, forensics off and
    calibration off (``SKYTPU_DEVTIME_EVERY=0``: no stream sync), run
    in that order and back again, so each setting runs twice, once in
    each half. The prefix cache is cleared before each pass, so each
    runs the same programs. Every pass gives the same greedy tokens, bit
    for bit (gated). Each setting's best TPOT against the best of
    everything on gives ``overhead_ratio`` (recorder),
    ``forensics_overhead_ratio`` and ``devtime_overhead_ratio``
    (calibration): reported, not gated."""
    import torch

    prior = os.environ.get("SKYTPU_DEVTIME_EVERY")

    def one(setting):
        samples = engine.devtime.samples
        engine.flight.enabled = setting != "recorder off"
        engine.forensics = setting != "forensics off"
        if setting == "calibration off":
            os.environ["SKYTPU_DEVTIME_EVERY"] = "0"
        try:
            engine.clear_prefix_cache()
            torch.cuda.synchronize()
            t0 = time.time()
            out = engine.generate(prompts,
                                  max_new_tokens=OBSERVE_PARITY_NEW)
            torch.cuda.synchronize()
            wall = time.time() - t0
        finally:
            engine.flight.enabled = engine.forensics = True
            if prior is None:
                os.environ.pop("SKYTPU_DEVTIME_EVERY", None)
            else:
                os.environ["SKYTPU_DEVTIME_EVERY"] = prior
        engine.finished.clear()
        return (out, wall / sum(len(o) for o in out),
                engine.devtime.samples - samples)

    settings = ("on", "recorder off", "forensics off", "calibration off")
    outs, tpots, brackets = {}, {}, []
    for setting in settings + settings[::-1]:
        out, tpot, n = one(setting)
        outs.setdefault(setting, []).append(out)
        tpots.setdefault(setting, []).append(tpot)
        brackets.append(n)
    want = outs["on"][0]
    same = {k: all(o == want for o in v) for k, v in outs.items()}
    best = {k: min(v) for k, v in tpots.items()}
    ratios = {name: round(best["on"] / best[k], 4) for name, k in (
        ("overhead_ratio", "recorder off"),
        ("forensics_overhead_ratio", "forensics off"),
        ("devtime_overhead_ratio", "calibration off"))}
    _log(f"observe[parity]: {len(prompts)} requests x "
         f"{OBSERVE_PARITY_NEW} tokens a pass, greedy tokens equal "
         f"{json.dumps(same)}; TPOT ms by setting (first half, second "
         f"half): "
         + ", ".join(f"{k} {v[0] * 1e3:.2f} / {v[1] * 1e3:.2f}"
                     for k, v in tpots.items())
         + f"; {json.dumps(ratios)} (best against best); calibration "
         f"brackets a pass in run order {brackets}; {card}")
    if not all(same.values()):
        raise AssertionError(f"observe: recording changed tokens: {same}")


def _observe_devtime(engine, card: str) -> None:
    """One decode program's calibrated ``dev_ms_est`` (a CUDA-event
    bracket: its kernels and the launch gaps between them) beside the
    profiler's kernel-time sum for one dispatch of the same program,
    and the dispatch's host wall."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(SEED + 17)
    for _ in range(engine.n_slots):
        engine.add_request(
            rng.integers(1, engine.cfg.vocab_size, 100).tolist(), 64)
    engine.admit()
    for _ in range(2):      # the first hit is the calibrated dispatch
        engine.complete_decode_burst(engine.dispatch_decode_burst(8))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        handle = engine.dispatch_decode_burst(8)
        host_ms = (time.perf_counter() - t0) * 1e3
        engine.complete_decode_burst(handle)
        torch.cuda.synchronize()
    key = handle.keys[0]
    est = engine.devtime.estimate(key)
    kernel_ms = _device_ms(prof)
    engine.reset()
    if len(handle.keys) != 1 or est is None or not est > 0 \
            or not kernel_ms > 0:
        raise AssertionError(f"observe: {handle.keys}, dev_ms_est {est}, "
                             f"kernel time {kernel_ms}")
    _log(f"observe[devtime]: {key} over {engine.n_slots} slots: "
         f"dev_ms_est {est * 1e3:.2f} ms (CUDA events, kernels and "
         f"launch gaps), profiler kernel sum {kernel_ms:.2f} ms "
         f"({kernel_ms / (est * 1e3):.3f} of it), dispatch host wall "
         f"{host_ms:.2f} ms; {card}")


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def phase_observe(dev, card: str) -> dict:
    """Observe a replica: llama3-8b (full width, ``CUT_LAYERS``, bf16) in the
    reference server's defaults, warmed by ``server.warm_grid`` (the
    ``--warm-grid`` startup), serving the mixed workload over HTTP.
    Checked: zero unexpected compiles after the warm-up, record/program
    coverage both ways, the traceparent on the request's records,
    ``/debug/flight`` and a ``/debug/forensics?rid=`` ledger that sums
    to its wall, identical tokens with recording off, the HBM ledger's
    resident components within ``allocated_bytes.all.current``, and K1
    and K2 launched. Returns {"observe": launches}."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import server as srv
    from skypilot_tpu_torch.observability import flight as flight_lib
    from skypilot_tpu_torch.observability import tracing
    t0 = time.time()
    engine = srv.make_engine("llama3-8b", slots=16, max_len=1024,
                             admit_wave=8, kv_block=256, prefill_chunk=512,
                             prefix_pool=8, spec_k=4, device=dev, seed=SEED)
    engine.flight = flight_lib.FlightRecorder()
    torch.cuda.synchronize()
    built = time.time() - t0
    t1 = time.time()
    n = srv.warm_grid(engine, max_burst=8)
    warm_s = time.time() - t1
    summ = engine.compile_watch.summary()
    slow = sorted(summ.items(), key=lambda kv: -kv[1])[:3]
    _log(f"observe[warm]: engine built in {built:.1f} s; warm_grid "
         f"dispatched {n} program keys in {warm_s:.1f} s, first-dispatch "
         f"wall {engine.compile_watch.total_compile_s():.2f} s (host, no "
         f"device sync), slowest "
         + ", ".join(f"{k} {v * 1e3:.0f} ms" for k, v in slow)
         + f"; {card}")
    prompts = _observe_prompts(engine.cfg, np.random.default_rng(SEED + 5))
    launches, window, trace_id = _observe_http(engine, card, prompts)
    unexpected = engine.compile_watch.unexpected
    rec_dv = {(r["program"]["k"], r["program"]["span"])
              for r in window if r["burst"] in ("decode", "verify")}
    eng_dv = {(k, sp) for kind, k, sp in engine.decode_programs
              if kind in ("burst", "verify")}
    kinds = {r["burst"] for r in window}
    if unexpected or rec_dv != eng_dv or not {
            "wave", "chunk", "decode", "verify", "retire"} <= kinds:
        raise AssertionError(f"observe: unexpected {unexpected}, records "
                             f"{sorted(rec_dv, key=str)} vs engine "
                             f"{sorted(eng_dv, key=str)}, kinds {kinds}")
    if not (launches["flash_attention_fwd"] > 0
            and launches["paged_attention"] > 0
            and launches["paged_attention_rows"] > 0):
        raise AssertionError(f"observe: launches {launches}")
    split = {}
    for kind in ("wave", "chunk", "decode", "verify"):
        recs = [r for r in window if r["burst"] == kind]
        split[kind] = {
            "n": len(recs),
            "dispatch_wall_ms": _median([r["dispatch_wall_ms"]
                                         for r in recs]),
            "fetch_wall_ms": _median([r["fetch_wall_ms"] for r in recs]),
            "dev_ms_est": _median([r["dev_ms_est"] for r in recs
                                   if "dev_ms_est" in r])}
    _log(f"observe[split]: medians by burst kind (host wall dispatch / "
         f"fetch, calibrated device-stream span): {json.dumps(split)}; "
         f"{card}")
    led = engine.hbm_ledger.snapshot()
    resident = sum(led[c] for c in ("weights", "kv_pool", "prefix_pool",
                                    "draft_pool", "adapter_pool"))
    alloc = torch.cuda.memory_stats(dev)["allocated_bytes.all.current"]
    stats = engine.hbm_ledger.cross_check(dev)
    _log(f"observe[hbm]: ledger {json.dumps(led)}; total "
         f"{engine.hbm_ledger.total() / 2**30:.3f} GiB (resident "
         f"{resident / 2**30:.3f} GiB) beside allocated_bytes.all.current "
         f"{alloc / 2**30:.3f} GiB, limit "
         f"{stats['bytes_limit'] / 2**30:.1f} GiB; {card}")
    if resident > alloc or stats["bytes_in_use"] <= 0:
        raise AssertionError(f"observe: resident ledger {resident} > "
                             f"allocated {alloc}")
    _observe_parity(engine, prompts["parity"], card)
    _observe_devtime(engine, card)
    engine.flight.flush()
    tracing.flush()
    files = flight_lib.load_records(dirs=[tracing.events_dir()])
    if not any(trace_id in (r.get("traces") or ()) for r in files):
        raise AssertionError("observe: the flushed flight log lacks the "
                             "traced request")
    _log(f"observe: {len(files)} flight records flushed to "
         f"{tracing.events_dir()}")
    del engine
    _free_card()
    return {"observe": launches}


def phase_train(dev, card: str):
    """Returns {kernel: launches} over the llama3-1b run."""
    import torch
    from skypilot_tpu_torch.ops import flash_attention as fa

    # 1. Gradient parity. In fp32 both paths differ only in how
    # attention orders its fp32 arithmetic (online softmax and per-tile
    # sums in the kernels, a full softmax and einsums in the reference),
    # about 1e-6 relative per attention output; two layers and the loss
    # carry it to ~1e-5 at most. Held to 1e-5 relative on the loss and
    # 1e-4 of max|plain| per parameter gradient. bf16 is reported, as in
    # the serve phase: a flipped bf16 rounding there is not an error
    # (and the einsum reference rounds its bf16 scores).
    par = _grad_parity(dev, torch.float32)
    worst = max(par["grad_rel"].items(), key=lambda kv: kv[1])
    dl = abs(par["loss_kernel"] - par["loss_plain"]) / abs(par["loss_plain"])
    _log(f"train[fp32 parity]: loss kernel {par['loss_kernel']:.7f} plain "
         f"{par['loss_plain']:.7f} (rel {dl:.2e}); worst grad {worst[0]} "
         f"max|diff|/max|plain| {worst[1]:.2e}")
    if not dl <= 1e-5 or not worst[1] <= 1e-4:
        raise AssertionError(f"fp32 gradient parity failed: loss rel {dl}, "
                             f"grads {par['grad_rel']}")
    par = _grad_parity(dev, torch.bfloat16)
    worst = max(par["grad_rel"].items(), key=lambda kv: kv[1])
    _log(f"train[bf16 parity, reported]: loss kernel "
         f"{par['loss_kernel']:.6f} plain {par['loss_plain']:.6f}; worst "
         f"grad {worst[0]} max|diff|/max|plain| {worst[1]:.2e}")
    del par
    gc.collect()
    torch.cuda.empty_cache()

    # 2. The main path: llama3-1b at full width and depth, the goodput
    # ledger on (the default).
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv,
               fa.flash_attention_bwd_dq)
    for f in kernels:
        f.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    steps = 6
    argv = ["--config", "llama3-1b", "--steps", str(steps),
            "--log-every", "1", "--xent-chunk", "512"]
    res = _run_main(argv)
    launches = {f.__name__: f.launches for f in kernels}
    peak = torch.cuda.max_memory_allocated(dev)
    losses = res["losses"]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"llama3-1b losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"llama3-1b loss did not fall on a repeated "
                             f"batch: {losses}")
    per_step = {n: c / steps for n, c in launches.items()}
    if per_step != {"flash_attention_fwd": 32, "flash_attention_bwd_dkv": 16,
                    "flash_attention_bwd_dq": 16}:
        raise AssertionError(f"launches per step {per_step}, expected "
                             f"K2 32 (forward + recompute), K3 16, K4 16")
    med = _median(res["step_ms"][1:])
    _log(f"train: llama3-1b batch 4 x 2048, {steps} steps, losses "
         f"{[round(x, 4) for x in losses]}; median step {med:.1f} ms "
         f"({4 * 2048 / med * 1e3:.0f} tokens/s, steps 2-{steps}); first "
         f"step {res['step_ms'][0]:.1f} ms; peak allocated "
         f"{peak / 2**30:.2f} GiB; launches per step {per_step}; {card}")
    _train_goodput(res, steps, card)
    on_ms, on_losses = res["step_ms"], losses
    del res
    gc.collect()
    torch.cuda.empty_cache()
    # The same run with the recorder off: what recording costs a step.
    os.environ["SKYTPU_GOODPUT"] = "0"
    try:
        off = _run_main(argv)
    finally:
        del os.environ["SKYTPU_GOODPUT"]
    if off["records"]:
        raise AssertionError("SKYTPU_GOODPUT=0 still recorded steps")
    _log(f"train[goodput off]: median step on/off (steps 2-{steps}) "
         f"{_median(on_ms[1:]):.2f} / {_median(off['step_ms'][1:]):.2f} ms "
         f"= {_median(on_ms[1:]) / _median(off['step_ms'][1:]):.4f} (the "
         f"reference's budget 1.01x, reported); losses equal "
         f"{off['losses'] == on_losses}; {card}")
    del off
    gc.collect()
    torch.cuda.empty_cache()
    _profile_train_step(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    _train_resume(card)
    return launches


def _train_goodput(res: dict, steps: int, card: str) -> None:
    """The llama3-1b run's goodput ledger: each record's phases must sum
    to its wall and the snapshot's buckets to its elapsed wall, and
    ``compute`` (which ends on the step's completion at a fetch step)
    must hold at least 0.85 of every warm step's wall."""
    recs, snap = res["records"], res["snapshot"]
    if [r["step"] for r in recs] != list(range(steps)):
        raise AssertionError(f"goodput: records for steps "
                             f"{[r['step'] for r in recs]}")
    for r in recs:
        total = sum(r["phases"].values())
        if abs(total - r["dur_s"] * 1e3) > 0.05:
            raise AssertionError(f"goodput: step {r['step']} phases sum to "
                                 f"{total} ms for a wall of "
                                 f"{r['dur_s'] * 1e3} ms")
    if abs(sum(snap["buckets"].values()) - snap["elapsed_s"]) > 1e-6:
        raise AssertionError(f"goodput: buckets {snap['buckets']} do not "
                             f"sum to {snap['elapsed_s']} s")
    warm = [r for r in recs if r["warm"]]
    if len(warm) != steps - 1:
        raise AssertionError(f"goodput: {len(warm)} warm steps")
    for r in warm:
        wall = r["dur_s"] * 1e3
        share = r["phases"]["compute"] / wall
        _log(f"train[goodput]: step {r['step'] + 1} wall {wall:.2f} ms = "
             + ", ".join(f"{k} {v:.2f}" for k, v in r["phases"].items())
             + f"; compute share {share:.4f}; dev_ms_est "
             f"{r['dev_ms_est']:.2f} beside compute "
             f"{r['phases']['compute']:.2f} ms; {card}")
        if share < 0.85:
            raise AssertionError(f"goodput: compute {share:.4f} of step "
                                 f"{r['step'] + 1}'s wall (< 0.85)")
    walls = sorted(r["dur_s"] for r in warm)
    mfu = warm[0]["flops"] / walls[len(walls) // 2] / PEAK_OPS_PER_S["bf16"]
    _log(f"train[goodput]: ratio {snap['goodput_ratio']:.4f} over "
         f"{snap['elapsed_s']:.2f} s; buckets (s) "
         + ", ".join(f"{k} {v:.3f}" for k, v in snap["buckets"].items())
         + f"; train MFU {mfu:.4f} (6 x {warm[0]['flops'] // 6 // warm[0]['toks']:,}"
         f" params x {warm[0]['toks']} tokens over the median warm step "
         f"{walls[len(walls) // 2] * 1e3:.2f} ms and "
         f"{PEAK_OPS_PER_S['bf16']:.3g} bf16 FLOP/s); {card}")


def _train_resume(card: str) -> None:
    """llama3-tiny, 4 steps with a checkpoint every 2, traced to a
    timeline file: the uninterrupted run; a twin killed by a
    ``train.checkpoint_save`` fault at step 4 and resumed from its step
    2, which must equal it bit for bit and fold the first run's goodput
    stamps in; then a recorder-off twin, bit-equal too. The kernels use
    no atomics, so the runs agree bit for bit."""
    import io
    import shutil
    import tempfile
    from skypilot_tpu_torch import chaos
    from skypilot_tpu_torch.observability import goodput
    from skypilot_tpu_torch.train import checkpoints, run
    from skypilot_tpu_torch.utils import timeline
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    a, b, c = (os.path.join(tmp, d) for d in "abc")
    trace = os.path.join(tmp, "trace.json")
    common = ["--config", "llama3-tiny", "--steps", "4", "--seq", "256",
              "--log-every", "1", "--ckpt-every", "2"]
    os.environ[timeline.ENV_VAR] = trace
    timeline._events.clear()
    try:
        full = _run_main(common + ["--ckpt-dir", a])
        inj = chaos.configure({"seed": 0, "faults": [
            {"point": "train.checkpoint_save", "match": {"step": "4"},
             "times": 1}]})
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                run.main(common + ["--ckpt-dir", b])
            raise AssertionError("resume: the checkpoint fault at step 4 "
                                 "did not fire")
        except chaos.ChaosError:
            pass
        finally:
            chaos.deactivate()
        with open(os.path.join(b, goodput.STAMPS_FILE)) as f:
            prior = json.load(f)
        resumed = _run_main(common + ["--ckpt-dir", b, "--resume"])
        timeline.save_now()
    finally:
        del os.environ[timeline.ENV_VAR]
        timeline._events.clear()
    if len(inj.fired) != 1:
        raise AssertionError(f"resume: faults fired {inj.fired}")
    if resumed["losses"] != full["losses"][2:]:
        raise AssertionError(f"resumed losses {resumed['losses']} != "
                             f"uninterrupted {full['losses'][2:]}")
    step4 = checkpoints.CheckpointManager(a).restore(step=4)
    if not _tree_equal(step4, checkpoints.CheckpointManager(b).restore(
            step=4)):
        raise AssertionError("the resumed run's step-4 state differs")
    if not os.path.exists(os.path.join(a, goodput.STAMPS_FILE)):
        raise AssertionError("resume: no goodput.json beside the "
                             "checkpoints")
    snap = resumed["snapshot"]
    if snap["steps"] != prior["steps"] + 2 or \
            not snap["buckets"]["restart_replay"] > 0 or \
            not snap["elapsed_s"] > snap["session_elapsed_s"]:
        raise AssertionError(f"resume: the snapshot {snap} does not fold "
                             f"the stamps {prior}")
    with open(trace) as f:
        spans = [e["name"] for e in json.load(f)["traceEvents"]
                 if e["ph"] == "X"]
    counts = {n: spans.count(n) for n in (
        "skytpu_checkpoint_save_seconds", "skytpu_checkpoint_wait_seconds")}
    if not all(counts.values()):
        raise AssertionError(f"resume: the trace file's checkpoint spans "
                             f"{counts}")
    os.environ["SKYTPU_GOODPUT"] = "0"
    try:
        off = _run_main(common + ["--ckpt-dir", c])
    finally:
        del os.environ["SKYTPU_GOODPUT"]
    if off["losses"] != full["losses"] or not _tree_equal(
            step4, checkpoints.CheckpointManager(c).restore(step=4)):
        raise AssertionError("resume: the recorder-off twin differs")
    shutil.rmtree(tmp, ignore_errors=True)
    _log(f"train: llama3-tiny resume from step 2 after a checkpoint fault "
         f"at step 4 equals the uninterrupted run (losses "
         f"{resumed['losses']}; step-4 states bit-equal); stamps folded "
         f"(steps {prior['steps']} + 2 = {snap['steps']}, restart_replay "
         f"{snap['buckets']['restart_replay'] * 1e3:.1f} ms, goodput "
         f"{snap['goodput_ratio']:.4f}); trace spans {counts}; the "
         f"recorder-off twin bit-equal; {card}")


# ---------------------------------------------------------------------------
# Phase 13: fine-tuning (LoRA and QLoRA)
# ---------------------------------------------------------------------------

# The repo's QLoRA recipe line (``llm/qlora-8b.yaml``), 6 steps logged at
# every step.
QLORA_RECIPE = ["--config", "llama3-8b", "--qlora", "16",
                "--qlora-random-base", "--xent-chunk", "512", "--seq",
                "2048", "--batch", "2"]
FT_STEPS = 6


def _finetune_parity(dev, card: str) -> None:
    """fp32 at llama3-8b width (2 layers, 32/8 heads, head_dim 128, vocab
    128256), one packed batch of 2 x 2048, rank-16 adapters with B
    drawn nonzero (at B = 0, A's gradient is 0): the QLoRA loss over a
    random int8 base and the LoRA loss over a random float base, and
    their adapter gradients, through the kernels and through autograd
    of einsum attention on the same card. Held as the train phase's
    parity is: 1e-5 relative on the loss, 1e-4 of max|plain| on each
    adapter gradient."""
    import torch
    from skypilot_tpu_torch.data import input_pipeline as ip
    from skypilot_tpu_torch.infer import kvcache
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import lora, qlora, trainer
    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"], n_layers=2,
                              dtype=torch.float32, xent_chunk=512)
    lc = lora.LoRAConfig(rank=16)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    adapters = lora.init_lora_params(cfg, lc, gen, dev)
    for ab in adapters.values():
        ab["b"].normal_(0.0, 0.01, generator=gen)
    docs = ip.synthetic_doc_stream(64, cfg.vocab_size, mean_len=600,
                                   seed=SEED)
    batch = ip.to_device(next(ip.packed_batches(docs, 2, 2048)), dev)
    names = [f"{t}.{k}" for t in adapters for k in adapters[t]]
    fp, qw = kvcache.random_quantized_params(cfg, seed=SEED, device=dev)
    base = llama.init_params(cfg, gen, device=dev)
    for what, lossf in (
            ("qlora", lambda a, attn: qlora.loss_fn(qw, fp, a, batch, cfg,
                                                    lc, attention=attn)),
            ("lora", lambda a, attn: lora.loss_fn(a, base, batch, cfg, lc,
                                                  attention=attn))):
        got = trainer.value_and_grads(adapters, lambda a: lossf(a, None))
        want = trainer.value_and_grads(
            adapters, lambda a: lossf(a, _plain_attention))
        dl = abs(got[0].item() - want[0].item()) / abs(want[0].item())
        rel = {n: (g - w).abs().max().item() / w.abs().max().item()
               for n, g, w in zip(names, got[2], want[2])}
        worst = max(rel.items(), key=lambda kv: kv[1])
        _log(f"finetune[fp32 parity, {what}]: loss kernel "
             f"{got[0].item():.7f} plain {want[0].item():.7f} (rel "
             f"{dl:.2e}); worst adapter grad {worst[0]} "
             f"max|diff|/max|plain| {worst[1]:.2e}; {card}")
        if not dl <= 1e-5 or not worst[1] <= 1e-4:
            raise AssertionError(f"{what} fp32 parity failed: loss rel {dl}, "
                                 f"grads {rel}")
        del got, want


def _int8_base_bytes(cfg) -> int:
    """Bytes of the int8 base ``kvcache.random_quantized_params`` builds
    for ``cfg``: int8 block weights and head, float32 scales (from the
    shapes)."""
    d, ff, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    weights = L * (2 * d * nh * hd + 2 * d * nkv * hd + 3 * d * ff) + d * v
    scales = L * (nh * hd + 2 * nkv * hd + 2 * d + 2 * ff) + v
    return weights + 4 * scales


def _finetune_run(argv, tokens: int, expect: dict, label: str,
                  card: str) -> dict:
    """``train.run.main(argv)`` for ``FT_STEPS`` steps at every-step
    logging, the kernels' counts set to 0 just before and read just
    after: finite losses that fall on the repeated batch, ``expect``
    launches a step. Prints the median step (steps 2-6), tokens/s
    (``tokens`` a step) and peak allocated memory. Returns the
    counts."""
    import torch
    from skypilot_tpu_torch.ops import flash_attention as fa
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv,
               fa.flash_attention_bwd_dq)
    torch.cuda.reset_peak_memory_stats()
    for f in kernels:
        f.launches = 0
    res = _run_main(argv + ["--steps", str(FT_STEPS), "--log-every", "1"])
    launches = {f.__name__: f.launches for f in kernels}
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"]
    if len(losses) != FT_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss did not fall on a "
                             f"repeated batch: {losses}")
    per_step = {n: c / FT_STEPS for n, c in launches.items()}
    if per_step != expect:
        raise AssertionError(f"{label}: launches per step {per_step}, "
                             f"expected {expect}")
    med = _median(res["step_ms"][1:])
    _log(f"{label}: {' '.join(argv)}; losses "
         f"{[round(x, 5) for x in losses]}; median step {med:.1f} ms "
         f"({tokens / med * 1e3:.0f} tokens/s, steps 2-{FT_STEPS}); first "
         f"step {res['step_ms'][0]:.1f} ms; peak allocated "
         f"{peak / 2**30:.2f} GiB; launches per step {per_step}; {card}")
    return launches


def _profile_qlora_step(dev, card: str) -> None:
    """One step of the recipe line (llama3-8b over a random int8 base,
    batch 2 x 2048, chunked cross-entropy, rank 16) under
    torch.profiler (``_profile_step``), after a warm-up step."""
    from skypilot_tpu_torch.infer import kvcache
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import lora, qlora, trainer
    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"], xent_chunk=512)
    lc = lora.LoRAConfig(rank=16)
    tc = trainer.TrainConfig(warmup_steps=1, total_steps=6)
    fp, qw = kvcache.random_quantized_params(cfg, device=dev)
    state = qlora.create_qlora_state(cfg, lc, tc, dev)
    step = qlora.make_qlora_train_step(cfg, lc, tc)
    batch = trainer.synthetic_batch(cfg, 2, 2048, device=dev)
    _profile_step(lambda: step(state, qw, fp, batch),
                  "finetune[profile]: qlora-8b", card)


def _finetune_resume(card: str) -> None:
    """QLoRA at llama3-tiny over a random int8 base, 4 steps with a
    checkpoint every 2; step 2 copied to a fresh directory and resumed
    to 4 must give the same losses and step-4 adapter state bit for
    bit, the restore booked as ``restart_replay``."""
    import shutil
    import tempfile
    from skypilot_tpu_torch.train import checkpoints
    tmp = tempfile.mkdtemp(prefix="chip_smoke_finetune_")
    a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
    common = ["--config", "llama3-tiny", "--qlora", "4",
              "--qlora-random-base", "--steps", "4", "--seq", "256",
              "--log-every", "1", "--ckpt-every", "2"]
    full = _run_main(common + ["--ckpt-dir", a])
    shutil.copytree(os.path.join(a, "2"), os.path.join(b, "2"))
    resumed = _run_main(common + ["--ckpt-dir", b, "--resume"])
    if resumed["losses"] != full["losses"][2:]:
        raise AssertionError(f"finetune resume: losses {resumed['losses']}"
                             f" != uninterrupted {full['losses'][2:]}")
    if not _tree_equal(checkpoints.CheckpointManager(a).restore(step=4),
                       checkpoints.CheckpointManager(b).restore(step=4)):
        raise AssertionError("finetune resume: the step-4 states differ")
    replay = resumed["snapshot"]["buckets"]["restart_replay"]
    if not replay > 0:
        raise AssertionError("finetune resume: no restart_replay booked")
    shutil.rmtree(tmp, ignore_errors=True)
    _log(f"finetune[resume]: llama3-tiny --qlora 4 resumed from step 2 "
         f"equals the uninterrupted run (losses {resumed['losses']}; "
         f"step-4 states bit-equal); restart_replay "
         f"{replay * 1e3:.1f} ms; {card}")


def phase_finetune(dev, card: str) -> dict:
    """Returns {path: {kernel: launches}}: the QLoRA recipe line
    (``finetune``) and LoRA at llama3-1b (``finetune[lora]``)."""
    import torch
    from skypilot_tpu_torch.models import llama
    _finetune_parity(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama.CONFIGS["llama3-8b"]
    _log(f"finetune: the int8 base of llama3-8b holds "
         f"{_int8_base_bytes(cfg) / 1e9:.3f} GB (int8 weights and head, "
         f"float32 scales; from the shapes)")
    paths = {"finetune": _finetune_run(
        QLORA_RECIPE, 2 * 2048, {"flash_attention_fwd": 64,
                       "flash_attention_bwd_dkv": 32,
                       "flash_attention_bwd_dq": 32},
        "finetune[qlora-8b]", card)}
    gc.collect()
    torch.cuda.empty_cache()
    _profile_qlora_step(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    paths["finetune[lora]"] = _finetune_run(
        ["--config", "llama3-1b", "--lora", "16", "--xent-chunk", "512",
         "--seq", "2048", "--batch", "4"], 4 * 2048,
        {"flash_attention_fwd": 32, "flash_attention_bwd_dkv": 16,
         "flash_attention_bwd_dq": 16}, "finetune[lora-1b]", card)
    gc.collect()
    torch.cuda.empty_cache()
    _finetune_resume(card)
    return paths



# ---------------------------------------------------------------------------
# Phase 14: mixture-of-experts and ViT
# ---------------------------------------------------------------------------

# Mixtral-8x7B's width on 8 of its 32 layers: a layer's experts are 2.82
# GB in bf16, so the whole depth (~93 GB) does not fit the card; the
# float32 parity leg on 2.
MOE_LAYERS = 8
MOE_FP32_LAYERS = 2
MOE_NEW = 32
MOE_FP32_NEW = 16
MODEL_STEPS = 6
# llm/moe-train.yaml's line without ``--ep 4`` (the port has no mesh).
MOE_RECIPE = ["--model", "moe", "--config", "moe-small", "--seq", "2048",
              "--batch", "4"]


def _moe_engine(params, cfg, dev, **kw):
    """The serving engine at the reference server's defaults (16 slots,
    max_len 1024, buckets 128/512/1024, waves of 8, blocks of 256,
    chunks of 512, a prefix pool of 8, n-gram K 4) on an MoE config."""
    from skypilot_tpu_torch.infer import engine as eng
    return eng.InferenceEngine(
        params, cfg, n_slots=16, max_len=1024,
        prompt_buckets=(128, 512, 1024), max_wave=8, kv_block=256,
        prefill_chunk=512, prefix_pool=8, spec_k=4, device=dev, **kw)


def _moe_serve(dev, card: str) -> dict:
    """(a) Mixtral-8x7B's width at ``MOE_LAYERS`` layers, bf16, random
    weights drawn on the card: 8 requests (``DRAFT_LENS``, two chunked)
    of ``MOE_NEW`` tokens through ``InferenceEngine`` after a warm-up
    pass of 4; launches counted from 0 over the timed pass (K1's decode
    and ``wgmma`` multi-row bodies and K2 must launch, ``mma.sync``
    never). Then float32 at ``MOE_FP32_LAYERS`` layers of the same
    width: the kernel engine's greedy tokens against the plain
    engine's. Returns the timed pass's launches."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.models import moe
    cfg = dataclasses.replace(moe.CONFIGS["mixtral-8x7b"],
                              n_layers=MOE_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = moe.init_params(cfg, gen, device=dev, dtype=cfg.dtype)
    _log(f"models[moe-serve]: mixtral-8x7b width at {MOE_LAYERS} of 32 "
         f"layers, {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB of "
         f"bf16 weights; {card}")
    rng = np.random.default_rng(SEED + 20)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in DRAFT_LENS]
    e = _moe_engine(params, cfg, dev)
    e.generate(prompts, max_new_tokens=4)         # first dispatches
    e.clear_prefix_cache()
    e.finished.clear()
    torch.cuda.synchronize(dev)
    _zero_launches()
    t0 = time.time()
    got = e.generate(prompts, max_new_tokens=MOE_NEW)
    torch.cuda.synchronize(dev)
    t_end = time.time()
    launches = _read_launches()
    reqs = e.finished
    ttft = [(r.first_token_s - r.submit_s) * 1e3 for r in reqs]
    decoded = sum(len(r.tokens) - 1 for r in reqs)
    rate = decoded / (t_end - min(r.first_token_s for r in reqs))
    if any(len(t) != MOE_NEW for t in got) or not all(
            0 <= x < cfg.vocab_size for t in got for x in t):
        raise AssertionError(f"models[moe-serve]: tokens {got}")
    if not (launches["paged_attention"] > 0
            and launches["paged_attention_rows"] > 0
            and launches["flash_attention_fwd"] > 0
            and not launches["paged_attention_rows_mma"]):
        raise AssertionError(f"models[moe-serve]: launches {launches}")
    # One 8-token decode burst over the wave prompts' slots, profiled.
    for p in prompts:
        if len(p) <= 512:
            e.add_request(p, max_new_tokens=64)
    e.admit()
    _profile_step(lambda: e.decode_burst(8),
                  "models[moe-serve profile]: one 8-token decode burst, "
                  f"{len(e.slot_req)} slots", card)
    _log(f"models[moe-serve]: {len(prompts)} requests of "
         f"{min(DRAFT_LENS)}-{max(DRAFT_LENS)} tokens x {MOE_NEW} new in "
         f"{t_end - t0:.2f} s; TTFT median {_median(ttft):.1f} ms (max "
         f"{max(ttft):.1f}); decode {rate:.1f} tokens/s; verify rounds "
         f"{e.verify_calls}, drafted {e._spec_drafted_total}, accepted "
         f"{e._spec_accepted_total}; launches {launches}; {card}")
    del e, params
    _free_card()

    cfg32 = dataclasses.replace(cfg, n_layers=MOE_FP32_LAYERS,
                                dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = moe.init_params(cfg32, gen, device=dev)
    runs = {}
    for plain in (False, True):
        e = _moe_engine(params, cfg32, dev, plain_attention=plain)
        _zero_launches()
        runs[plain] = (e, e.generate(prompts, max_new_tokens=MOE_FP32_NEW),
                       _read_launches())
    kernel, want = runs[False][1], runs[True][1]
    if not (runs[False][2]["paged_attention"] > 0
            and runs[False][2]["paged_attention_rows_mma"] > 0
            and runs[False][2]["flash_attention_fwd"] > 0
            and not any(runs[True][2].values())):
        raise AssertionError(f"models[moe-serve fp32]: launches kernel "
                             f"{runs[False][2]}, plain {runs[True][2]}")
    parts = []
    for i, (p, g, w) in enumerate(zip(prompts, kernel, want)):
        step, gap, _ = _divergence(runs[True][0], p, g, w)
        if step is not None:
            parts.append((i, step, gap))
            if gap > 1e-2:
                raise AssertionError(
                    f"models[moe-serve fp32]: request {i} parts at step "
                    f"{step} where the plain top-2 gap is {gap:.3e}")
    _log(f"models[moe-serve fp32]: {MOE_FP32_LAYERS} layers, "
         f"{len(prompts)} requests x {MOE_FP32_NEW} new: kernel tokens "
         f"equal the plain engine's: {not parts} (parted at near-ties "
         f"(request, step, gap): {parts}); kernel launches "
         f"{runs[False][2]}; {card}")
    del runs, params
    _free_card()
    return launches


def _vit_grad_parity(dev) -> dict:
    """ViT-S/16 at 2 layers in float32, 8 images: loss and gradients
    through the kernels (bidirectional, a group of one) against autograd
    of einsum attention, on the same card and weights."""
    import torch
    from skypilot_tpu_torch.models import vit
    from skypilot_tpu_torch.ops import attention
    from skypilot_tpu_torch.train import trainer
    cfg = dataclasses.replace(vit.CONFIGS["vit-s16"], n_layers=2,
                              dtype=torch.float32)
    params = vit.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    batch = vit.synthetic_batch(cfg, 8, seed=SEED, device=dev)
    got = trainer.grads_of(params, batch, cfg, model=vit)
    want = trainer.grads_of(
        params, batch, cfg, model=vit,
        attention=lambda q, k, v: attention.xla_attention(q, k, v,
                                                          causal=False))
    rel = max((g - w).abs().max().item() / w.abs().max().item()
              for g, w in zip(got[2], want[2]) if w.abs().max().item())
    return {"loss_kernel": got[0].item(), "loss_plain": want[0].item(),
            "grad_rel": rel}


def _vit_train(dev, card: str) -> dict:
    """(c) ``examples/vit_train.yaml``'s script on the port: ViT-S/16,
    lr 1e-3, total_steps 500, one repeated batch of 64 images, for
    ``MODEL_STEPS`` steps (counts from 0: K2 24, K3 12 and K4 12 a step,
    bidirectional); finite losses that fall."""
    import torch
    from skypilot_tpu_torch.models import vit
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.train import trainer
    par = _vit_grad_parity(dev)
    dl = abs(par["loss_kernel"] - par["loss_plain"]) / abs(par["loss_plain"])
    _log(f"models[vit fp32 parity]: loss kernel {par['loss_kernel']:.7f} "
         f"plain {par['loss_plain']:.7f} (rel {dl:.2e}); worst grad "
         f"max|diff|/max|plain| {par['grad_rel']:.2e}")
    if not dl <= 1e-5 or not par["grad_rel"] <= 1e-4:
        raise AssertionError(f"ViT fp32 gradient parity failed: {par}")
    _free_card()
    cfg = vit.CONFIGS["vit-s16"]
    tc = trainer.TrainConfig(learning_rate=1e-3, total_steps=500)
    state = trainer.create_train_state(cfg, tc, dev, model=vit)
    step = trainer.make_train_step(cfg, tc, model=vit)
    batch = vit.synthetic_batch(cfg, 64, device=dev)
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv,
               fa.flash_attention_bwd_dq)
    torch.cuda.reset_peak_memory_stats(dev)
    for f in kernels:
        f.launches = 0
    losses, step_ms = [], []
    for _ in range(MODEL_STEPS):
        t = time.time()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        step_ms.append((time.time() - t) * 1e3)
    launches = {f.__name__: f.launches for f in kernels}
    per_step = {n: c / MODEL_STEPS for n, c in launches.items()}
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"models[vit-train]: losses {losses}")
    if per_step != {"flash_attention_fwd": 24, "flash_attention_bwd_dkv": 12,
                    "flash_attention_bwd_dq": 12}:
        raise AssertionError(f"models[vit-train]: launches per step "
                             f"{per_step}, expected K2 24, K3 12, K4 12")
    med = _median(step_ms[1:])
    _log(f"models[vit-train]: vit-s16 batch 64 x {cfg.n_patches + 1} "
         f"tokens, "
         f"{MODEL_STEPS} steps, losses {[round(x, 5) for x in losses]}; "
         f"median step {med:.1f} ms ({64 / med * 1e3:.0f} images/s, steps "
         f"2-{MODEL_STEPS}); first step {step_ms[0]:.1f} ms; peak "
         f"allocated {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
         f"GiB; launches per step {per_step}; {card}")
    _profile_step(lambda: step(state, batch),
                  "models[vit-train profile]: vit-s16", card)
    return launches


def _profile_moe_step(dev, card: str) -> None:
    """One moe-small step of the recipe's shape (batch 4 x 2048) under
    torch.profiler (``_profile_step``), after a warm-up step."""
    from skypilot_tpu_torch.models import moe
    from skypilot_tpu_torch.train import trainer
    cfg = moe.CONFIGS["moe-small"]
    tc = trainer.TrainConfig(warmup_steps=1, total_steps=6)
    state = trainer.create_train_state(cfg, tc, dev, model=moe)
    step = trainer.make_train_step(cfg, tc, model=moe)
    batch = trainer.synthetic_batch(cfg, 4, 2048, device=dev)
    _profile_step(lambda: step(state, batch),
                  "models[moe-train profile]: moe-small", card)


def phase_models(dev, card: str) -> dict:
    """Returns {path: {kernel: launches}}: MoE serving at Mixtral-8x7B's
    width (``models[moe-serve]``), the MoE training recipe
    (``models[moe-train]``) and the ViT recipe (``models[vit-train]``)."""
    from skypilot_tpu_torch.train import trainer
    paths = {"models[moe-serve]": _moe_serve(dev, card)}
    aux = []
    with _tap(trainer, "grads_of", aux, keep=lambda out: out[1]["aux_loss"]):
        paths["models[moe-train]"] = _finetune_run(
            MOE_RECIPE, 4 * 2048, {"flash_attention_fwd": 16,
                                   "flash_attention_bwd_dkv": 8,
                                   "flash_attention_bwd_dq": 8},
            "models[moe-train]", card)
    aux = [float(a) for a in aux]
    if len(aux) != MODEL_STEPS or not all(map(math.isfinite, aux)):
        raise AssertionError(f"models[moe-train]: aux losses {aux}")
    _log(f"models[moe-train]: aux_loss per step {[round(a, 5) for a in aux]}")
    _free_card()
    _profile_moe_step(dev, card)
    _free_card()
    paths["models[vit-train]"] = _vit_train(dev, card)
    _free_card()
    return paths

# Depth of the contiguous phase's float32 parity leg at llama3-8b width.
CONTIG_FP32_LAYERS = 2
# The bench sections' llama3-400m at 4 of its 12 layers (full width):
# occupancy, span and parity do not depend on depth, and the occupancy
# sweep's 64 requests took 65 s of the smoke at 12.
CONTIG_400M_LAYERS = 4
CONTIG_NEW = 32


@contextlib.contextmanager
def _fp32_config(*names: str):
    """For the block, ``llama.CONFIGS[name]`` in float32 for each name
    (the bench's sections build their configs by name)."""
    import torch
    from skypilot_tpu_torch.models import llama
    full = {n: llama.CONFIGS[n] for n in names}
    for n, c in full.items():
        llama.CONFIGS[n] = dataclasses.replace(c, dtype=torch.float32)
    try:
        yield
    finally:
        llama.CONFIGS.update(full)


def _kv_gib(tree) -> float:
    return sum(t.numel() * t.element_size()
               for t in (tree or {}).values()) / 2**30


def _contig_serve(dev, card: str) -> dict:
    """(a) llama3-8b at full width (``SERVE_LAYERS``), bf16, through the server's
    ``make_engine`` with the reference server's defaults and
    ``kv_block=0``: the serve phase's 9 requests and its shared-prefix
    pair (:func:`_serve_leg`, launch counts from 0: K2 must launch and K1
    never). Prints TTFT, decode rate, peak memory and the contiguous KV's
    bytes. Returns the batch's launches."""
    import torch
    from skypilot_tpu_torch.infer import server as srv
    chunk = 512
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    engine = srv.make_engine("llama3-8b", slots=16, max_len=1024,
                             admit_wave=len(_batch_bodies(chunk)[0]),
                             kv_block=0, prefill_chunk=chunk,
                             prefix_pool=8, spec_k=4, device=dev, seed=SEED)
    cfg = engine.cfg
    if engine.paged or engine.pool is None:
        raise AssertionError("contig: make_engine(kv_block=0) built a "
                             "paged engine")
    row_kib = (2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
               * engine.cache["k"].element_size() / 1024)
    _log(f"contig: llama3-8b {cfg.n_layers} layers, bf16, contiguous KV "
         f"{row_kib:.0f} KiB a row: cache {_kv_gib(engine.cache):.3f} GiB "
         f"({engine.n_slots} slots + the trash slot of {engine.max_len} "
         f"rows), prefix pool {_kv_gib(engine.pool):.3f} GiB "
         f"({engine.prefix_pool} rows); built in {time.time() - t0:.1f} s")
    leg = _serve_leg(engine, "contig[bf16]", card, chunk)
    ttft = leg["ttft"]
    _log(f"contig: TTFT median {ttft[len(ttft) // 2]:.1f} ms, max "
         f"{ttft[-1]:.1f} ms; decode {leg['tps']:.1f} tokens/s over "
         f"{len(ttft)} requests; peak allocated "
         f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
         f"launches {leg['launches']}; {card}")
    del engine
    _free_card()
    return leg["launches"]


def _contig_fp32(dev, card: str) -> None:
    """(b) llama3-8b's width at ``CONTIG_FP32_LAYERS`` layers in float32:
    the contiguous engine (the gather) against the paged one (K1) with
    the serve defaults, on a wave prompt, a chunked prompt and the
    shared-prefix pair (the second a warm 512-token hit), spec K 4 on and
    off: greedy tokens agree wherever the plain top-2 gap exceeds 1e-2,
    and K1 never launches on the contiguous engine. On the contiguous
    engine, ``step()`` gives the burst path's tokens. Then the same
    pair of layouts on int8 KV pools."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import engine as eng
    from skypilot_tpu_torch.models import llama
    cfg = dataclasses.replace(llama.CONFIGS["llama3-8b"],
                              n_layers=CONTIG_FP32_LAYERS,
                              dtype=torch.float32)
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    rng = np.random.default_rng(SEED + 30)
    cold, warm = _pair_prompts(cfg, 512)
    first = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (300, 700)]
    first.append(cold)
    kw = dict(n_slots=16, max_len=1024, prompt_buckets=(128, 512, 1024),
              max_wave=8, prefill_chunk=512, prefix_pool=8, device=dev)

    def run(e):
        out = e.generate(first, max_new_tokens=CONTIG_NEW)
        out += e.generate([warm], max_new_tokens=CONTIG_NEW)
        return out

    for kv_int8 in (False, True):
        ref = eng.InferenceEngine(params, cfg, kv_block=256,
                                  plain_attention=True, kv_int8=kv_int8,
                                  **kw)
        for spec_k in ((0, 4) if not kv_int8 else (4,)):
            leg = (f"contig[fp32{', int8 KV' if kv_int8 else ''}, "
                   f"spec K {spec_k}]")
            paged = eng.InferenceEngine(params, cfg, kv_block=256,
                                        spec_k=spec_k, kv_int8=kv_int8, **kw)
            want = run(paged)
            del paged
            contig = eng.InferenceEngine(params, cfg, kv_block=0,
                                         spec_k=spec_k, kv_int8=kv_int8,
                                         **kw)
            _zero_launches()
            got = run(contig)
            launches = _read_launches()
            hit = contig.finished[-1]
            if hit.cached_len != 512 or launches["flash_attention_fwd"] <= 0 \
                    or any(n for k, n in launches.items()
                           if k != "flash_attention_fwd"):
                raise AssertionError(f"{leg}: warm cached_len "
                                     f"{hit.cached_len} (expected 512), "
                                     f"launches {launches}")
            for i, (p, g, w) in enumerate(zip(first + [warm], got, want)):
                _agree(ref, p, g, w, f"prompt {i} ({len(p)} tokens)",
                       "paged (K1) and contiguous (gather) engines", leg=leg)
            if spec_k == 0:
                for p in first[:2]:
                    contig.add_request(p, max_new_tokens=CONTIG_NEW)
                while contig.waiting or contig.chunking or contig.slot_req:
                    contig.step()
                stepped = [r.tokens for r in sorted(
                    contig.finished, key=lambda r: r.rid)[-2:]]
                keys = [k for k in contig.compile_watch.summary()
                        if k.startswith("decode1")]
                if not keys:
                    raise AssertionError(f"{leg}: step() dispatched no "
                                         f"decode1 program")
                for p, g, w in zip(first, stepped, got):
                    _agree(ref, p, g, w, f"{len(p)}-token prompt",
                           "step() and step_burst()", leg=leg)
            del contig
            _free_card()
        del ref
    del params
    _free_card()
    _log(f"contig[fp32]: {CONTIG_FP32_LAYERS} layers at llama3-8b width; "
         f"{card}")


def _gaps(params, cfg, dev, prompts, got, want, leg: str) -> list:
    """Requests whose greedy tokens ``got`` (paged, K1) and ``want``
    (contiguous, the gather) part, as (request, step, the plain
    prefill's top-2 gap there, the bound). The gather rounds its softmax
    weights to bf16 (the reference's read), so the bound is the larger
    of 1e-2 and twice the gather's own shift from the plain logits on
    that context (one step of a one-slot contiguous cache over the
    context); raises where a gap exceeds it."""
    import torch
    from skypilot_tpu_torch.infer import kvcache
    parts = []
    for i, (p, g, w) in enumerate(zip(prompts, got, want)):
        t = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if t is None:
            continue
        ctx = list(p) + list(w[:t])
        n = len(ctx) - 1
        _, logits = kvcache.prefill_batch(
            params, torch.tensor([ctx], device=dev),
            torch.tensor([len(ctx)], device=dev), cfg, plain_attention=True)
        cache = kvcache.init_cache(cfg, 1, len(ctx), device=dev)
        prefix, _ = kvcache.prefill_batch(
            params, torch.tensor([ctx[:-1]], device=dev),
            torch.tensor([n], device=dev), cfg, plain_attention=True)
        kvcache.insert(cache, {k: prefix[k][:, 0] for k in ("k", "v")}, 0,
                       n, ctx[-1])
        gather = kvcache.step_logits(params, cache, cfg, None)
        bound = max(1e-2, 2 * (gather - logits).abs().max().item())
        top = logits[0].float().topk(2).values
        gap = (top[0] - top[1]).item()
        parts.append((i, t, round(gap, 6), round(bound, 6)))
        if gap > bound:
            raise AssertionError(f"{leg}: request {i} parts at step {t} "
                                 f"where the plain top-2 gap is {gap:.4f} "
                                 f"> {bound:.4f}")
    return parts


def _contig_bench(dev, card: str) -> dict:
    """(c) The bench's sections of the contiguous layout on the card, in
    float32 (their configs by name): ``run_occupancy`` at its card size
    (llama3-400m, max_len 4096, 8 contiguous slots against 64 paged at
    equal KV bytes), ``run_span_smoke`` and ``run_kernel_smoke`` (the
    400m at their CI sizes), the 400m at ``CONTIG_400M_LAYERS``
    layers; each report line, the parity of each held to the gap rule
    of :func:`_gaps` on the seed-0 weights. Returns the occupancy run's
    launches."""
    from skypilot_tpu_torch.infer import bench_serve as bs
    from skypilot_tpu_torch.models import llama
    out = {}
    with _at_depth("llama3-400m", CONTIG_400M_LAYERS), \
            _fp32_config("llama3-400m", "llama3-tiny"):
        for name, fn in (("occupancy", bs.run_occupancy),
                         ("span", bs.run_span_smoke),
                         ("kernel", bs.run_kernel_smoke)):
            toks = {}
            _zero_launches()
            t = time.time()
            r = fn(device=dev, tokens_out=toks)
            wall = time.time() - t
            launches = _read_launches()
            cfg = llama.CONFIGS[r["config"]]
            params, _ = bs._random_weights(cfg, False, dev)
            parts = _gaps(params, cfg, dev, *toks["parity"],
                          f"contig[{name}]")
            del params
            _log(f"contig[{name}]: {json.dumps(r)}; parted at near-ties "
                 f"(request, step, gap, bound): {parts}; wall {wall:.1f} s; "
                 f"launches {launches}; {card}")
            if name == "occupancy" and not (
                    r["same_hbm"] and r["occupancy_x"] >= 4
                    and r["leak_free"]):
                raise AssertionError(f"contig[occupancy]: {r}")
            if name == "span" and not r["rows_span"] < r["rows_full"]:
                raise AssertionError(f"contig[span]: {r}")
            if name == "kernel" and not r["kernel_programs_ok"]:
                raise AssertionError(f"contig[kernel]: {r}")
            if launches["paged_attention"] <= 0:
                raise AssertionError(f"contig[{name}]: K1 never launched "
                                     f"on the paged engine")
            out[name] = launches
            _free_card()
    return out["occupancy"]


def phase_contig(dev, card: str) -> dict:
    """Returns {path: {kernel: launches}}: the contiguous engine at
    llama3-8b (``contig``: K2 alone) and the occupancy bench's paged and
    contiguous engines (``contig[occupancy]``)."""
    paths = {"contig": dict(_contig_serve(dev, card),
                            paged_attention_rows_mma=0)}
    _contig_fp32(dev, card)
    paths["contig[occupancy]"] = _contig_bench(dev, card)
    return paths


# ---------------------------------------------------------------------------
# Phase 16: the trainer over a device mesh
# ---------------------------------------------------------------------------

MESH_STEPS = 6


def _mesh_leg(dev, cfg, tc, batch, steps: int, mesh=None) -> dict:
    """``steps`` trainer steps from seed 0 on one batch, ``mesh`` or
    none: the losses and grad norms (each fetched, so each step's wall
    ends on its completion), the step walls, the peak memory and the
    final state."""
    import torch
    from skypilot_tpu_torch.train import trainer
    torch.cuda.reset_peak_memory_stats(dev)
    state = trainer.create_train_state(cfg, tc, dev, seed=SEED, mesh=mesh)
    step = trainer.make_train_step(cfg, tc, mesh=mesh)
    out = {"loss": [], "grad_norm": [], "ms": []}
    for _ in range(steps):
        t = time.time()
        _, m = step(state, batch)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["ms"].append((time.time() - t) * 1e3)
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    out["state"] = state
    out["step"] = step
    return out


def _mesh_line(tag: str, leg: dict, tokens: int, card: str) -> None:
    med = _median(leg["ms"][1:])
    _log(f"mesh[{tag}]: losses {[round(x, 5) for x in leg['loss']]}; "
         f"median step {med:.1f} ms (steps 2-{len(leg['ms'])}; first "
         f"{leg['ms'][0]:.1f}), {tokens / med * 1e3:.0f} tokens/s, peak "
         f"allocated {leg['peak'] / 2**30:.2f} GiB; {card}")


def _mesh_full(dev, card: str, mesh) -> dict:
    """(a) llama3-1b, bf16 activations, batch 4 x 2048, chunked
    cross-entropy at 512: the plain leg, then the mesh leg with the
    flash kernels' counts set to 0 before it and read after it."""
    import torch
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.train import trainer
    cfg = dataclasses.replace(llama.CONFIGS["llama3-1b"], xent_chunk=512)
    tc = trainer.TrainConfig(warmup_steps=1, total_steps=MESH_STEPS)
    batch = trainer.synthetic_batch(cfg, 4, 2048, seed=SEED, device=dev)
    plain = _mesh_leg(dev, cfg, tc, batch, MESH_STEPS)
    _mesh_line("plain", plain, 4 * 2048, card)
    plain_loss = plain["loss"]
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv,
               fa.flash_attention_bwd_dq)
    for f in kernels:
        f.launches = 0
    leg = _mesh_leg(dev, cfg, tc, batch, MESH_STEPS, mesh)
    launches = {f.__name__: f.launches for f in kernels}
    _mesh_line("mesh", leg, 4 * 2048, card)
    per_step = {n: c / MESH_STEPS for n, c in launches.items()}
    if per_step != {"flash_attention_fwd": 32, "flash_attention_bwd_dkv": 16,
                    "flash_attention_bwd_dq": 16}:
        raise AssertionError(f"mesh: launches per step {per_step}, expected "
                             f"K2 32 (forward + recompute), K3 16, K4 16")
    # bf16 activations: the mesh leg runs the plain leg's local products
    # on whole tensors; held to 1e-2 relative a step (a few bf16 ulps).
    rel = max(abs(a - b) / abs(b) for a, b in zip(leg["loss"], plain_loss))
    _log(f"mesh: launches per step {per_step}; losses mesh - plain max "
         f"rel {rel:.2e} (bound 1e-2); the loss fell "
         f"{plain_loss[0]:.4f} -> {plain_loss[-1]:.4f}")
    if not rel <= 1e-2 or not all(math.isfinite(x) for x in leg["loss"]):
        raise AssertionError(f"mesh: losses {leg['loss']} against the plain "
                             f"leg's {plain_loss}")
    if not plain_loss[-1] < plain_loss[0]:
        raise AssertionError(f"mesh: the loss did not fall: {plain_loss}")
    state, step = leg["state"], leg["step"]
    del leg
    _profile_step(lambda: step(state, batch), "mesh[profile]: llama3-1b, "
                  "one-rank mesh", card)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _mesh_fp32(dev, card: str, mesh) -> None:
    """(b) 2 layers of llama3-1b in float32: the mesh leg's losses, grad
    norms and parameters against the plain leg's, and a checkpoint of
    the mesh leg's state restored into the plain leg's, bit for bit."""
    import tempfile

    import torch
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.train import checkpoints, trainer
    cfg = dataclasses.replace(llama.CONFIGS["llama3-1b"], n_layers=2,
                              dtype=torch.float32, xent_chunk=512)
    tc = trainer.TrainConfig(warmup_steps=1, total_steps=MESH_STEPS)
    batch = trainer.synthetic_batch(cfg, 4, 2048, seed=SEED, device=dev)
    steps = 3
    plain = _mesh_leg(dev, cfg, tc, batch, steps)
    fa.flash_attention_fwd.launches = 0
    leg = _mesh_leg(dev, cfg, tc, batch, steps, mesh)
    if fa.flash_attention_fwd.launches != 4 * steps:
        raise AssertionError(f"mesh[fp32]: K2 launched "
                             f"{fa.flash_attention_fwd.launches} times")
    drel = max(abs(a - b) / abs(b) for k in ("loss", "grad_norm")
               for a, b in zip(leg[k], plain[k]))
    dp = max((a - b.full_tensor()).abs().max().item()
             for a, b in zip(trainer._layer_leaves(plain["state"]["params"]),
                             trainer._layer_leaves(leg["state"]["params"])))
    with tempfile.TemporaryDirectory() as tmp:
        with checkpoints.CheckpointManager(tmp) as mgr:
            mgr.save(steps, leg["state"])
            mgr.wait()
            mgr.restore(plain["state"])
    same = all(torch.equal(a, b.full_tensor()) for a, b in zip(
        trainer._layer_leaves(plain["state"]["params"]),
        trainer._layer_leaves(leg["state"]["params"])))
    _log(f"mesh[fp32, 2 layers]: losses {leg['loss']} against "
         f"{plain['loss']}; loss and grad norm max rel {drel:.2e} (bound "
         f"1e-5); parameters max|mesh - plain| {dp:.2e} (bound 1e-5); the "
         f"mesh state's checkpoint restored into the plain state bit for "
         f"bit: {same}; {card}")
    if not (drel <= 1e-5 and dp <= 1e-5 and same):
        raise AssertionError("mesh[fp32]: the mesh leg parts from the plain "
                             "leg")


def phase_mesh(dev, card: str) -> dict:
    """Returns {"mesh": {kernel: launches}} over the llama3-1b mesh leg.
    The one-rank NCCL group this opens is destroyed at the end."""
    import torch.distributed as dist
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.make_mesh(mesh_lib.MeshShape(), dev)
    try:
        _log(f"mesh: {mesh_lib.mesh_shape(mesh).as_dict()} over "
             f"{dist.get_world_size()} rank ({dist.get_backend()}); one card "
             f"runs one rank, so no collective is timed here")
        launches = _mesh_full(dev, card, mesh)
        _mesh_fp32(dev, card, mesh)
    finally:
        dist.destroy_process_group()
    return {"mesh": launches}


# ---------------------------------------------------------------------------
# Phase 17: context and pipeline parallelism
# ---------------------------------------------------------------------------

PP_STEPS = 6
PP_SEQ = 2048
# The long-context recipe's per-rank attention (llm/long-context-ring.yaml:
# llama3-8b at tp 2, sequence 32768 over sp 4).
RING_SEQ, RING_SP, RING_HQ, RING_HKV = 32768, 4, 16, 4
RING_FP32_SEQ = 4 * 1024


def _flash_counts() -> dict:
    from skypilot_tpu_torch.ops import flash_attention as fa
    return {f.__name__: f.launches for f in (
        fa.flash_attention_fwd, fa.flash_attention_bwd_dkv,
        fa.flash_attention_bwd_dq)}


def _zero_flash() -> None:
    from skypilot_tpu_torch.ops import flash_attention as fa
    for f in (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv,
              fa.flash_attention_bwd_dq):
        f.launches = 0


def _add(into: dict, counts: dict) -> None:
    for k, v in counts.items():
        into[k] = into.get(k, 0) + v


def _as_pipeline(cfg):
    """``cfg`` (a ``LlamaConfig``) as 2 stages of 4 microbatches."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import pipeline
    return pipeline.PipelineConfig(**{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(llama.LlamaConfig)},
        n_stages=2, n_microbatches=4)


def _pp_leg(dev, cfg, tc, batch, steps: int, model,
            profile: tuple = None) -> dict:
    """``steps`` trainer steps of ``model`` (``llama`` or ``pipeline``)
    from seed 0 on one batch: losses, grad norms, walls (each step's loss
    fetched), peak memory, the flash kernels' launches over the steps
    (counted from 0 just before them), and the first state's loss
    through the plain llama stack on the same weights (the
    stage-stacked blocks reshaped). With ``profile`` (a label, the card
    after it), one more step is profiled after them
    (:func:`_profile_step`)."""
    import torch
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer
    torch.cuda.reset_peak_memory_stats(dev)
    state = trainer.create_train_state(cfg, tc, dev, seed=SEED, model=model)
    out = {"loss": [], "grad_norm": [], "ms": []}
    if model is not llama:
        lcfg = llama.LlamaConfig(**{
            f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(llama.LlamaConfig)})
        p = state["params"]
        flat = dict(p, blocks={k: w.reshape(-1, *w.shape[2:])
                               for k, w in p["blocks"].items()})
        with torch.no_grad():
            out["llama_loss"] = float(llama.loss_fn(flat, batch, lcfg)[0])
    step = trainer.make_train_step(cfg, tc, model=model)
    _zero_flash()
    for _ in range(steps):
        t = time.time()
        _, m = step(state, batch)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["ms"].append((time.time() - t) * 1e3)
    out["launches"] = _flash_counts()
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    if profile is not None:
        label, card = profile
        _profile_step(lambda: step(state, batch), label, card)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _pp_full(dev, card: str) -> dict:
    """(a) llama3-1b's width and depth as a 2-stage, 4-microbatch
    pipeline, bf16, batch 4 x 2048, xent chunks of 512, 6 steps from
    seed 0: the plain llama3-1b leg, then GPipe, then 1F1B, the flash
    kernels counted from 0 before each pipeline leg."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import pipeline
    from skypilot_tpu_torch.train import trainer
    base = dataclasses.replace(llama.CONFIGS["llama3-1b"], xent_chunk=512)
    cfg = _as_pipeline(base)
    tc = trainer.TrainConfig(warmup_steps=1, total_steps=PP_STEPS)
    batch = trainer.synthetic_batch(cfg, 4, PP_SEQ, seed=SEED, device=dev)
    tokens = 4 * PP_SEQ
    plain = _pp_leg(dev, base, tc, batch, PP_STEPS, llama)
    _log(f"parallel[plain llama3-1b]: losses "
         f"{[round(x, 5) for x in plain['loss']]}; median step "
         f"{_median(plain['ms'][1:]):.1f} ms, "
         f"{tokens / _median(plain['ms'][1:]) * 1e3:.0f} tokens/s, peak "
         f"allocated {plain['peak'] / 2**30:.2f} GiB; {card}")
    launches = {}
    legs = {}
    for schedule in ("gpipe", "1f1b"):
        # One schedule's step profiled (the train phase profiles the
        # plain step; the schedules share every kernel).
        leg = _pp_leg(dev, dataclasses.replace(cfg, schedule=schedule), tc,
                      batch, PP_STEPS, pipeline,
                      (f"parallel[profile]: pipeline {schedule}", card)
                      if schedule == "gpipe" else None)
        counts = leg["launches"]
        _add(launches, counts)
        per_step = {n: c / PP_STEPS for n, c in counts.items()}
        med = _median(leg["ms"][1:])
        _log(f"parallel[pipeline {schedule}]: losses "
             f"{[round(x, 5) for x in leg['loss']]}; median step "
             f"{med:.1f} ms (steps 2-{PP_STEPS}; first {leg['ms'][0]:.1f}) "
             f"against the plain step's {_median(plain['ms'][1:]):.1f}, "
             f"{tokens / med * 1e3:.0f} tokens/s, peak allocated "
             f"{leg['peak'] / 2**30:.2f} GiB (plain "
             f"{plain['peak'] / 2**30:.2f}); launches per step {per_step}; "
             f"{card}")
        # 16 layers x 4 microbatches: K2 forward and remat recompute,
        # K3 and K4 once each.
        want = {"flash_attention_fwd": 128, "flash_attention_bwd_dkv": 64,
                "flash_attention_bwd_dq": 64}
        if per_step != want:
            raise AssertionError(f"parallel[pipeline {schedule}]: launches "
                                 f"per step {per_step}, expected {want}")
        rel = abs(leg["loss"][0] - leg["llama_loss"]) / abs(leg["llama_loss"])
        _log(f"parallel[pipeline {schedule}]: first loss "
             f"{leg['loss'][0]:.5f} against llama.loss_fn on the same "
             f"weights {leg['llama_loss']:.5f}, rel {rel:.2e} (bound 1e-2)")
        if not rel <= 1e-2 or not all(math.isfinite(x) for x in leg["loss"]):
            raise AssertionError(f"parallel[pipeline {schedule}]: first loss "
                                 f"{leg['loss'][0]} against llama's "
                                 f"{leg['llama_loss']}")
        legs[schedule] = leg
    rel = max(abs(a - b) / abs(b) for a, b in zip(legs["1f1b"]["loss"],
                                                  legs["gpipe"]["loss"]))
    _log(f"parallel[pipeline]: 1F1B - GPipe losses max rel {rel:.2e} (bound "
         f"1e-2); the loss fell {legs['gpipe']['loss'][0]:.4f} -> "
         f"{legs['gpipe']['loss'][-1]:.4f}")
    if not rel <= 1e-2:
        raise AssertionError("parallel[pipeline]: 1F1B parts from GPipe")
    if not legs["gpipe"]["loss"][-1] < legs["gpipe"]["loss"][0]:
        raise AssertionError("parallel[pipeline]: the loss did not fall")
    return launches


def _pp_fp32(dev, card: str) -> None:
    """2 layers of llama3-1b in float32, 3 steps: the pipeline (one layer
    a stage, GPipe and 1F1B) against the plain stack, loss and grad norm
    within 1e-5 relative."""
    import torch
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import pipeline
    from skypilot_tpu_torch.train import trainer
    base = dataclasses.replace(llama.CONFIGS["llama3-1b"], n_layers=2,
                               dtype=torch.float32, xent_chunk=512)
    cfg = _as_pipeline(base)
    tc = trainer.TrainConfig(warmup_steps=1, total_steps=PP_STEPS)
    batch = trainer.synthetic_batch(cfg, 4, PP_SEQ, seed=SEED, device=dev)
    plain = _pp_leg(dev, base, tc, batch, 3, llama)
    for schedule in ("gpipe", "1f1b"):
        leg = _pp_leg(dev, dataclasses.replace(cfg, schedule=schedule), tc,
                      batch, 3, pipeline)
        rel = max(abs(a - b) / abs(b) for k in ("loss", "grad_norm")
                  for a, b in zip(leg[k], plain[k]))
        _log(f"parallel[pipeline {schedule}, fp32, 2 layers]: losses "
             f"{leg['loss']} against the plain stack's {plain['loss']}; "
             f"loss and grad norm max rel {rel:.2e} (bound 1e-5); {card}")
        if not rel <= 1e-5:
            raise AssertionError(f"parallel[pipeline {schedule}, fp32]: the "
                                 f"pipeline parts from the plain stack")


def _ring_inputs(S: int, dtype, dev):
    """q [1, S, 16, 128], k/v [1, S, 4, 128], dO, and packed segment ids
    [1, S] from the input pipeline, seed 0."""
    import torch
    from skypilot_tpu_torch.data import input_pipeline as ip
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v, do = (torch.randn(1, S, h, 128, generator=gen, device=dev,
                               dtype=torch.float32).to(dtype)
                   for h in (RING_HQ, RING_HKV, RING_HKV, RING_HQ))
    docs = ip.synthetic_doc_stream(64, 32_768, mean_len=S // 6, seed=SEED)
    seg = torch.from_numpy(next(ip.packed_batches(docs, 1, S))[
        "segment_ids"]).to(dev, torch.int32)
    return q, k, v, do, seg


def _k2_reference(q, k, v, do, seg):
    """K2 over the whole sequence (all heads), K3/K4 for its gradients."""
    import torch
    from skypilot_tpu_torch.ops import attention
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = attention.gqa_attention(*leaves, causal=True, segment_ids=seg)
    return (o.detach(),) + torch.autograd.grad(o, leaves, grad_outputs=do)


def _ring_schemes(dev, card: str, S: int, dtype, bound: float,
                  launches: dict) -> None:
    """(b) The ring, the zigzag ring and Ulysses over ``RING_SP`` virtual
    ranks at sequence S, against K2/K3/K4 over the whole sequence: each
    output and gradient within ``bound`` of the reference's max; each
    scheme's wall and peak memory, by the module's ``loopback``: its
    distributed ring loop for the virtual ranks in one process, the ring's
    shift a hand-over of the next block and Ulysses's all-to-all a
    reshuffle of the ranks' chunks. Ulysses's launches into
    ``launches``."""
    import torch
    from skypilot_tpu_torch.parallel import ring_attention as ra
    name = str(dtype).replace("torch.", "")
    q, k, v, do, seg = _ring_inputs(S, dtype, dev)
    want = _k2_reference(q, k, v, do, seg)
    torch.cuda.synchronize()
    walls = {}
    for scheme in ("ring", "zigzag", "ulysses"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        if scheme == "ulysses":
            _zero_flash()
        t = time.time()
        got = ra.loopback(scheme, q, k, v, do, seg, RING_SP)
        torch.cuda.synchronize()
        walls[scheme] = (time.time() - t) * 1e3
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        extra = ""
        if scheme == "ulysses":
            counts = _flash_counts()
            _add(launches, counts)
            extra = f"; launches {counts}"
            # The virtual ranks' head groups stacked on the batch dim:
            # one launch of each.
            if set(counts.values()) != {1}:
                raise AssertionError(f"parallel[ulysses]: launches {counts}, "
                                     f"expected 1 of each")
        errs = {}
        for nm, g, w in zip(("o", "dq", "dk", "dv"), got, want):
            errs[nm] = ((g.float() - w.float()).abs().max()
                        / w.float().abs().max()).item()
        _log(f"parallel[{scheme}, {name}, S {S} over {RING_SP} virtual "
             f"ranks, {RING_HQ}/{RING_HKV} heads, hd 128, packed]: wall "
             f"{walls[scheme]:.1f} ms, peak above the inputs {peak:.2f} GiB; "
             f"max|Δ| / max|K2,K3,K4| "
             + ", ".join(f"{k_} {e:.2e}" for k_, e in errs.items())
             + f" (bound {bound:g}){extra}; {card}")
        if not all(e <= bound for e in errs.values()):
            raise AssertionError(f"parallel[{scheme}, {name}]: {errs} over "
                                 f"the bound {bound}")
        del got
    _log(f"parallel[{name}, S {S}]: the zigzag ring's wall "
         f"{walls['zigzag']:.1f} ms against the plain ring's "
         f"{walls['ring']:.1f} ({walls['ring'] / walls['zigzag']:.2f}x)")


def _pp_run_main(card: str) -> None:
    """(c) ``train.run --model pipeline --config pp-tiny --steps 4`` on
    the card, and ``--zigzag`` on one rank (the identity: the losses of
    the same run without it)."""
    res = _run_main(["--model", "pipeline", "--config", "pp-tiny",
                     "--steps", "4", "--log-every", "1"])
    if not (len(res["losses"]) == 4
            and all(math.isfinite(x) for x in res["losses"])):
        raise AssertionError(f"parallel[run]: losses {res['losses']}")
    argv = ["--config", "llama3-tiny", "--seq", "64", "--steps", "4",
            "--log-every", "1"]
    plain = _run_main(argv)["losses"]
    zig = _run_main(argv + ["--zigzag"])["losses"]
    _log(f"parallel[run]: --model pipeline (pp-tiny) losses "
         f"{res['losses']}; llama3-tiny --zigzag on one rank {zig} against "
         f"{plain} without it; {card}")
    if zig != plain:
        raise AssertionError("parallel[run]: --zigzag on one rank is not "
                             "the identity")


def phase_parallel(dev, card: str) -> dict:
    """Returns {"parallel": {kernel: launches}}: the pipeline legs' and
    Ulysses's, each counted from 0 just before it. One card runs one
    rank, so the collectives (the ring's shift, the all-to-all, the
    pipeline's sends) are not run here: the ring bodies run by loopback
    and the pipeline's stages in turn."""
    import torch
    _log(f"parallel: one card runs one rank; the ring's shift, Ulysses's "
         f"all-to-all and the pipeline's sends are not timed here")
    launches = _pp_full(dev, card)
    _pp_fp32(dev, card)
    _ring_schemes(dev, card, RING_SEQ, torch.bfloat16, 2e-2, launches)
    _ring_schemes(dev, card, RING_FP32_SEQ, torch.float32, 1e-4, launches)
    _pp_run_main(card)
    return {"parallel": launches}


# -- phase 18: tensor-parallel serving -----------------------------------------

TP = 4
# The float32 and w8a8 parity legs' depth (the bf16 leg runs CUT_LAYERS).
TP_FP32_LAYERS = 2
TP_NEW = 32


def _tp_run(engine, prompts, new: int):
    """``prompts`` as one batch of requests through ``engine``: (tokens by
    request, sorted TTFTs in ms, decode tokens/s after the first token,
    wall s)."""
    t = time.time()
    rids = [engine.add_request(p, new) for p in prompts]
    engine.run_to_completion()
    wall = time.time() - t
    by_rid = {r.rid: r for r in engine.finished}
    reqs = [by_rid[i] for i in rids]
    ttft = sorted((r.first_token_s - r.submit_s) * 1e3 for r in reqs)
    tps = (sum(len(r.tokens) for r in reqs) - len(reqs)) / max(
        wall - ttft[0] / 1e3, 1e-9)
    return [r.tokens for r in reqs], ttft, tps, wall


def _tp_serve(engine, batch, warm, tag: str, card: str):
    """The 9-request batch, then ``warm`` again (a prefix hit), through
    ``engine`` after one short request (the process's first launches of
    each kernel and GEMM shape land there): (tokens, the warm request's
    tokens)."""
    _tp_run(engine, [batch[0][:64]], 2)
    hits = engine.prefix_hits
    spec0 = (engine._spec_drafted_total, engine._spec_accepted_total,
             engine.verify_calls)
    got, ttft, tps, wall = _tp_run(engine, batch, TP_NEW)
    warm_got = _tp_run(engine, [warm], TP_NEW)[0][0]
    drafted, accepted, verify = (n - n0 for n, n0 in zip(
        (engine._spec_drafted_total, engine._spec_accepted_total,
         engine.verify_calls), spec0))
    _log(f"{tag}: {len(batch)} requests of {TP_NEW} new tokens in "
         f"{wall:.2f} s: TTFT ms min {ttft[0]:.1f} median "
         f"{ttft[len(ttft) // 2]:.1f} max {ttft[-1]:.1f}; decode "
         f"{tps:.1f} tokens/s; {verify} verify calls (drafted {drafted}, "
         f"accepted {accepted}); prefix hits {engine.prefix_hits - hits} "
         f"(the {len(warm)}-token prompt again); {card}")
    if engine.prefix_hits - hits < 1:
        raise AssertionError(f"{tag}: the repeated prompt did not hit the "
                             f"prefix cache")
    for i, toks in enumerate(got + [warm_got]):
        if len(toks) != TP_NEW or not all(0 <= t < engine.cfg.vocab_size
                                          for t in toks):
            raise AssertionError(f"{tag}: request {i}: {len(toks)} tokens "
                                 f"or a token outside the vocab")
    return got, warm_got


def _tp_profile(engine, prompt, tag: str, card: str) -> None:
    """One short request (the first 64 tokens of ``prompt``, 16 new)
    through ``engine`` under :func:`_profile_step`: the device's busy
    time and idle share of its wall, tp 4 beside tp 1."""
    _profile_step(lambda: _tp_run(engine, [prompt[:64]], 16),
                  f"{tag}: one 64-token request of 16 new tokens", card)


def _tp_bf16(dev, card: str, mesh):
    """The bf16 leg at llama3-70b's width on ``CUT_LAYERS`` layers: tp 4
    drawn into its shards, the 9 requests and a prefix hit (launches
    counted from 0 around them, K1 and K2 then held at every shape they
    ran, one short request profiled), then a tp-1 twin on the same
    weights (profiled alike) under the top-2 gap rule. Returns (the tp leg's launches, the whole bf16 tree, the
    config, the 9 prompts)."""
    import torch
    from skypilot_tpu_torch.infer import engine as eng
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import sharding
    cfg = dataclasses.replace(llama.CONFIGS["llama3-70b"],
                              n_layers=CUT_LAYERS)
    chunk = 512
    _, prompts, twins = _batch_bodies(chunk)
    batch = prompts + [prompts[i] for i in twins]
    warm = max(prompts, key=len)
    kw = dict(n_slots=16, max_len=1024, prompt_buckets=(128, 512, 1024),
              max_wave=len(batch), kv_block=256, prefill_chunk=chunk,
              prefix_pool=8, spec_k=4)
    t = time.time()
    params = eng.InferenceEngine.sharded_init(cfg, mesh, seed=SEED)
    e4 = eng.InferenceEngine(params, cfg, mesh=mesh, **kw)
    torch.cuda.synchronize()
    sb = e4.shard_bytes()
    _log(f"tp[bf16]: llama3-70b width (d_model {cfg.d_model}, "
         f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}) on "
         f"{cfg.n_layers} of 80 layers ({cfg.num_params() / 1e9:.2f}B "
         f"params, bf16), tp {TP} on one card, drawn into its shards and "
         f"built in {time.time() - t:.1f} s; each shard holds "
         f"{sb['weights'] / 2**30:.3f} GiB of weights and "
         f"{sb['kv_pool'] / 2**30:.3f} GiB of KV pool "
         f"({cfg.n_heads // TP} q over {cfg.n_kv_heads // TP} kv heads); "
         f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated "
         f"on the card; {card}")
    seen = {}
    _zero_launches()
    with _path_shapes(seen):
        got, warm_got = _tp_serve(e4, batch, warm, "tp[bf16]", card)
    torch.cuda.synchronize()
    launches = _read_launches()
    _log(f"tp[bf16]: launches {launches} (K1 decode body, wgmma and "
         f"mma.sync multi-row bodies, K2) over the shards' heads; {card}")
    for name in ("paged_attention", "paged_attention_rows",
                 "flash_attention_fwd"):
        if launches[name] <= 0:
            raise AssertionError(f"tp[bf16]: {name} never launched")
    _check_path_shapes(seen, "tp[bf16]", dev)
    _tp_profile(e4, batch[0], f"tp[bf16, tp {TP}]", card)
    whole = sharding.gather_tree(e4.params, llama.param_logical_axes(cfg),
                                 dev)
    del e4, params
    gc.collect()
    torch.cuda.empty_cache()
    e1 = eng.InferenceEngine(whole, cfg, device=dev, **kw)
    want, warm_want = _tp_serve(e1, batch, warm, "tp[bf16, tp 1]", card)
    _tp_profile(e1, batch[0], "tp[bf16, tp 1]", card)
    cases = [(f"request {i}", batch[i], g, w)
             for i, (g, w) in enumerate(zip(got, want))]
    cases.append(("the warm request", warm, warm_got, warm_want))
    parted = [c for c in cases if c[2] != c[3]]
    _log(f"tp[bf16]: {len(cases) - len(parted)} of {len(cases)} requests "
         f"give tp 1's tokens; {card}")
    if parted:
        # The gap from plain float32 logits on the same weights, the
        # floor from the bf16 twin's: the serve phase's bf16 rule.
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        ref = eng.InferenceEngine(
            {k: ({n: w.float() for n, w in v.items()}
                 if isinstance(v, dict) else v.float())
             for k, v in whole.items()}, cfg32, n_slots=1, max_len=1024,
            prompt_buckets=(1024,), prefill_chunk=chunk, device=dev,
            plain_attention=True)
        for what, prompt, g, w in parted:
            _agree(ref, prompt, g, w, what, "tp 4 and tp 1", "tp, bf16",
                   low=e1)
        del ref
    del e1
    gc.collect()
    torch.cuda.empty_cache()
    return launches, whole, cfg, batch


def _tp_exact(got, want, leg: str, paths: str) -> None:
    if got != want:
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        raise AssertionError(f"{leg}: {paths} give other greedy tokens on "
                             f"requests {bad}")
    _log(f"{leg}: {paths} give the same greedy tokens on all "
         f"{len(got)} requests")


def _tp_fp32(dev, card: str, mesh, whole, cfg, batch) -> dict:
    """The float32 and w8a8 + int8 KV legs on the first
    ``TP_FP32_LAYERS`` layers of the bf16 leg's weights, widened: tp 4
    against tp 1, greedy tokens identical; tp 4 with an oracle drafter
    (verify rounds that accept every position) gives them too. K1 and
    K2 are held against their plain versions at every shape each tp-4
    leg ran. Returns each leg's launches."""
    import torch
    from skypilot_tpu_torch.infer import engine as eng
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import sharding
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                n_layers=TP_FP32_LAYERS)
    params = {k: ({n: w[:TP_FP32_LAYERS].float() for n, w in v.items()}
                  if k == "blocks" else v.float())
              for k, v in whole.items()}
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    split = sharding.split_tree(params, llama.param_logical_axes(cfg32),
                                mesh)
    lens = [len(p) for p in batch]
    prompts = [batch[lens.index(min(lens))], batch[lens.index(max(lens))],
               [5, 6, 7, 8] * 40]
    kw = dict(n_slots=4, max_len=1024, prompt_buckets=(128, 512, 1024),
              kv_block=256, prefill_chunk=512, prefix_pool=8, spec_k=4)
    out, tokens = {}, {}
    for leg, extra in (("tp[fp32]", {}),
                       ("tp[fp32,int8]", dict(weights_int8=True,
                                              kv_int8=True))):
        seen = {}
        _zero_launches()
        e4 = eng.InferenceEngine(split, cfg32, mesh=mesh, **kw, **extra)
        with _path_shapes(seen):
            got = e4.generate(prompts, TP_NEW)
        torch.cuda.synchronize()
        out[leg] = _read_launches()
        _check_path_shapes(seen, leg, dev)
        _log(f"{leg}: {TP_FP32_LAYERS} layers at llama3-70b width, tp "
             f"{TP}: launches {out[leg]}; {card}")
        body = "paged_attention_rows" if extra else "paged_attention_rows_mma"
        for name in ("paged_attention", body, "flash_attention_fwd"):
            if out[leg][name] <= 0:
                raise AssertionError(f"{leg}: {name} never launched")
        del e4
        e1 = eng.InferenceEngine(params, cfg32, device=dev, **kw, **extra)
        want = e1.generate(prompts, TP_NEW)
        del e1
        _tp_exact(got, want, leg, "tp 4 and tp 1")
        tokens[leg] = want
    oracle = _Replay({tuple(p): w
                      for p, w in zip(prompts, tokens["tp[fp32]"])})
    e4 = eng.InferenceEngine(split, cfg32, mesh=mesh,
                             **dict(kw, spec_drafter=oracle))
    seen = {}
    with _path_shapes(seen):
        got = e4.generate(prompts, TP_NEW)
    _check_path_shapes(seen, "tp[fp32, oracle]", dev)
    _tp_exact(got, tokens["tp[fp32]"], "tp[fp32, oracle]",
              "spec on (an oracle drafter) and off")
    _log(f"tp[fp32, oracle]: {e4.verify_calls} verify calls, drafted "
         f"{e4._spec_drafted_total}, accepted {e4._spec_accepted_total}; "
         f"{card}")
    if not e4.verify_calls or \
            e4._spec_accepted_total != e4._spec_drafted_total:
        raise AssertionError("tp[fp32, oracle]: the oracle's drafts did "
                             "not all verify")
    del e4
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tp_server_refuses(card: str) -> None:
    """``infer.server --tp 4`` on a machine with fewer cards exits
    non-zero with the reference's message."""
    import torch
    found = torch.cuda.device_count()
    if found >= TP:
        _log(f"tp[server]: {found} cards: --tp {TP} would serve")
        return
    t = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "skypilot_tpu_torch.infer.server",
         "--config", "llama3-tiny", "--tp", str(TP), "--port",
         str(_free_port())], capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    want = f"--tp {TP} needs {TP} devices, found {found}"
    if proc.returncode == 0 or want not in proc.stderr:
        raise AssertionError(f"tp[server]: exit {proc.returncode}, "
                             f"stderr {proc.stderr[-500:]!r}")
    _log(f"tp[server]: --tp {TP} on {found} card(s) exits "
         f"{proc.returncode} with {want!r} in {time.time() - t:.1f} s; "
         f"{card}")


def phase_tp(dev, card: str) -> dict:
    """Returns {path: {kernel: launches}}: the bf16 leg's (``tp``) and the
    float32 and w8a8 legs' (``tp[fp32]``, ``tp[fp32,int8]``). The 4
    shards share the one card, so the joins are copies within it: no
    cross-card reduction is timed here."""
    t = time.time()
    mesh = [dev] * TP
    _log(f"tp: {TP} shards on one card: the joins at wo, w_down, the "
         f"embedding and the head are copies within it; no cross-card "
         f"reduction is timed here")
    launches, whole, cfg, batch = _tp_bf16(dev, card, mesh)
    out = {"tp": launches}
    out.update(_tp_fp32(dev, card, mesh, whole, cfg, batch))
    _tp_server_refuses(card)
    _log(f"tp: phase wall {time.time() - t:.1f} s; {card}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase",
                    choices=("all", "kernels", "serve", "handoff", "bench",
                             "qos", "adapters", "draft", "recover",
                             "observe", "train", "finetune", "models",
                             "contig", "mesh", "parallel", "tp"),
                    default="all")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 1
    try:
        from skypilot_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the skypilot_tpu_torch package is missing "
              f"({e}); run from the repository root", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _log(smi)
    dev = torch.device("cuda", 0)
    from skypilot_tpu_torch.observability import attribution
    kind = attribution.device_kind(dev)
    if datasheet_peaks(kind) != (PEAK_OPS_PER_S["bf16"], HBM_BYTES_PER_S):
        print(f"chip_smoke: the bounds are an H100's; this card is "
              f"{torch.cuda.get_device_name(dev)}", file=sys.stderr)
        return 1
    overrides = [k for k in ("SKYTPU_PEAK_TFLOPS", "SKYTPU_PEAK_GBPS")
                 if os.environ.get(k)]
    if overrides:
        # The engines' /metrics MFU would divide by another number than
        # the kernels' bounds.
        print(f"chip_smoke: unset {overrides}: the smoke's bounds and "
              f"the serving MFU divide by the data sheet's peaks",
              file=sys.stderr)
        return 1
    # The engines' span, event and flight logs flush to a directory of
    # this run's own.
    import tempfile
    os.environ["SKYTPU_EVENTS_DIR"] = tempfile.mkdtemp(
        prefix="chip_smoke_events_")
    # The plain versions are references: full float32 products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]}")

    t0 = time.time()
    # Every nvcc starts now; flash_bwd (K3/K4), the slowest file, is
    # waited for only after the serving phases, which launch K1 and K2.
    _build.start()
    try:
        return _phases(args, dev, smi, t0)
    finally:
        _build.stop()


def _wait_build(names, t0: float) -> None:
    """Wait for the listed kernels' builds; their ptxas summaries."""
    from skypilot_tpu_torch.ops import _build
    t = time.time()
    logs = _build.build_all(names)
    _log(f"build: {', '.join(names)} for sm_90a: waited "
         f"{time.time() - t:.1f} s, {time.time() - t0:.1f} s after the "
         f"start")
    for name, text in logs.items():
        for line in _ptxas_summary(text):
            _log(f"  {name}: {line}")


def _phases(args, dev, smi: str, t0: float) -> int:
    import torch
    _wait_build(("paged_attention", "flash_fwd"), t0)
    walls = {}

    def run(phase, fn):
        """Run one phase if ``--phase`` asks for it; its wall into
        ``walls``, then free the card."""
        if args.phase not in ("all", phase):
            return None
        t = time.time()
        out = fn(dev, smi) if phase != "kernels" else fn(dev)
        walls[phase] = round(time.time() - t, 1)
        gc.collect()
        torch.cuda.empty_cache()
        return out

    # Launches of each kernel on each main path, counted from 0 just
    # before that path runs and read just after it.
    by_path = {}
    with _at_depth("llama3-8b", SERVE_LAYERS):
        by_path.update(run("serve", phase_serve) or {})
    draft_cases = {}
    with _at_depth("llama3-8b", CUT_LAYERS):
        by_path.update(run("handoff", phase_handoff) or {})
        bench = run("bench", phase_bench)
        if bench is not None:
            by_path["bench"] = bench
        by_path.update(run("qos", phase_qos) or {})
        by_path.update(run("adapters", phase_adapters) or {})
        draft = run("draft", phase_draft)
        if draft is not None:
            paths, draft_cases = draft
            by_path.update(paths)
        by_path.update(run("recover", phase_recover) or {})
        by_path.update(run("observe", phase_observe) or {})
    by_path.update(run("tp", phase_tp) or {})
    _wait_build(("flash_bwd",), t0)
    cases = run("kernels", phase_kernels) or {}
    # K1 held on the draft engines' own inputs: after the kernel phase's
    # cases, whose first case heads each entry.
    for name, runs in draft_cases.items():
        cases.setdefault(name, []).extend(runs)
    train = run("train", phase_train)
    if train is not None:
        by_path["train"] = train
    by_path.update(run("finetune", phase_finetune) or {})
    by_path.update(run("models", phase_models) or {})
    with _at_depth("llama3-8b", SERVE_LAYERS):
        by_path.update(run("contig", phase_contig) or {})
    by_path.update(run("mesh", phase_mesh) or {})
    by_path.update(run("parallel", phase_parallel) or {})
    _log(f"phase walls (s): {json.dumps(walls)}; build and phases "
         f"{time.time() - t0:.1f} s; {smi}")

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        counts = {path: n[name] for path, n in by_path.items() if name in n}
        entry = {"name": name, "route": route, "source": source,
                 "replaces": replaces, "launches": sum(counts.values()),
                 "launches_by_path": counts}
        runs = cases.get(name)
        if runs:
            head = runs[0]
            entry.update(
                max_abs_err=max(c["max_abs_err"] for c in runs),
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=head["library_ms"], tflops=head["tflops"],
                bound_share=head["bound_share"],
                vs_library=head["vs_library"], cases=runs)
        kernels.append(entry)
    if args.phase == "all":
        for k in kernels:
            if k["launches"] <= 0:
                raise AssertionError(f"kernel {k['name']} never launched "
                                     f"on a main path")
    for k in kernels:
        if any(isinstance(v, float) and not math.isfinite(v)
               for v in k.values()):
            raise AssertionError(f"non-finite number in {k}")
    _log(json.dumps({"kernels": kernels}))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
