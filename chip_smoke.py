#!/usr/bin/env python3
"""Quickest proof that the PyTorch port of Galaxy runs on one NVIDIA GPU.

  python3 chip_smoke.py

Run from the root of a checkout (it imports ``src/repro_torch``), on a
host with one CUDA device and the CUDA toolkit.  Phases, each raising on
failure:

1. card    — CUDA present; the card's name and power limit; TF32 off.
2. build   — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
             ptxas's registers and spills (0 bytes in the attention
             kernels' mma_kernels and in every scan and connective
             kernel, or it fails); the tensor-core instructions
             ``cuobjdump --dump-sass`` finds (HMMA in tiled_gemm_valid and
             in both attention kernels, HGMMA in tiled_gemm; none fails).
3. kernels — each hand-written kernel against its plain PyTorch version at
             the GPT2-L main-path shapes, float32, float16 and bfloat16,
             with garbage in every pad region (pad outputs must be exact
             zeros) and the GEMM's live-tile counter against
             ``dense_block_count``; the GEMM at the ring tiles and at the
             served decode (one-row segments, 4 slots), its split plan
             printed; the GEMM's and the ragged attention's output equal bit
             for bit on a second call, fp16/bf16 on the tensor-core path
             ("mma") and fp32 on the CUDA cores ("fma" / "simt"); times the
             kernel (fp16, the served dtype), the plain version and one
             PyTorch library call.  The connective as the Galaxy layer
             launches it, one launch for the four shards of a site (four
             57-row padded tiles), and for unequal shards with an empty
             one, rate 0 and 0.1: each shard against the plain version,
             a second call bitwise equal, every launch on the register-row
             path ("warp"); timed at the site beside ``layer_norm(x +
             res)`` over the stacked rows.
4. parity  — two GPT2-L-width layers in float32 through the executor:
             kernel vs eager backend logits after the prefill of 4
             prompts and after each of 8 decode steps of the 4-slot
             batch, with equal greedy tokens.
5. serve   — the Galaxy path: ``launch.serve`` with GPT2-L at full width
             and depth in float16 on the planner's uneven 3:2:2:1 plan, 8
             requests of 37-300 prompt tokens, 16 new tokens each,
             ``max_batch=4``; each of its three kernels must have launched,
             every GEMM and every attention on the tensor-core path, the
             connective exactly once per site (72 launches a prefill) on
             the "warp" path, and
             the first served token of a request must match the eager
             backend.  Then a short bf16 serve of the same plan on the
             kernel backend (4 requests, 4 new tokens): every GEMM and
             attention on the tensor cores, the first served token checked
             the same way at bf16's tolerance.
6. zoo kernels — the dense flash attention and the RG-LRU scan against
             their plain versions at RecurrentGemma-9B's served prefill
             shapes: attention (2, 16, 2100, 256) on one KV head, causal,
             window 2048, float32, bfloat16 and float16 (the 16-bit types
             on the "mma" path, fp32 on "simt"); scan at both served
             waves, (4, 300, 4096) and (2, 2100, 4096) float32 with a
             nonzero h0, bitwise equal to the plain version and on a
             second call, on the TMA path.  Timed beside their plain
             versions, SDPA with the window mask (attention; the scan has
             no one PyTorch call) and their bounds.
7. zoo parity — RecurrentGemma-9B at full width cut to 5 layers (one
             rec,rec,attn group + the 2 tail rec blocks) in float32:
             kernel vs eager (plain) backend logits after a 2100-token
             prefill (longer than the window) of 2 prompts and after each
             of 8 decode steps.
8. zoo serve — the zoo path: ``launch.serve --executor zoo`` with
             RecurrentGemma-9B at full width and depth in bfloat16, 4
             requests of 300 and 2 of 2100 prompt tokens, 16 new tokens
             each, ``max_batch=4``: two waves, so exactly 24 flash and 52
             scan launches (12 attention and 26 recurrent layers per
             prefill; decode launches neither), every flash launch on the
             "mma" path and every scan on the "tma" path; the first served
             tokens of the 300-token wave must match the eager backend.
9. dense kernels — the dense ``tiled_gemm`` against its plain version at
             the reference's test shapes (128x256x128, 256x512x384,
             512x128x256) and one odd shape in float32, bfloat16 and
             float16, bf16/fp16 on the wgmma path and fp32 and the odd
             shape on the CUDA-core ("simt") path, counted; its own path,
             ``ops.tiled_gemm``, driven once at a served width,
             StableLM-12B's MLP up-projection on a 512-row chunk, (512 x
             5120) @ (5120 x 13824) bf16 (wgmma), and timed there beside
             its plain version, ``torch.matmul`` and its bound.
             The flash kernel at StableLM-12B's prefill chunk: 256
             queries at offset 1024 (Sq < Sk), 32 heads on 8 KV heads of
             dim 160, strided views of the gathered page view, fp32, bf16
             and fp16, timed (bf16) beside its plain version, SDPA and its
             bound.  Then with ``kv_len`` (the chunk at a device-held
             offset over the whole 97-page view, and a 5-row verify
             chunk): bitwise the call on the keys sliced to ``kv_len`` in
             all three dtypes, each on its path, timed (bf16) beside it.
10. dense parity — StableLM-12B at full width cut to 4 layers in float32,
             backend kernel and eager: the paged protocol's one-shot
             ``prefill_paged``, ``prefill_chunk`` in chunks of 64 at page-
             aligned offsets over a 300-token prompt, and a prefix-hit
             suffix prefill over 16 shared pages, each against the dense
             prefill's logits of the same rows; then 8 ``decode_paged``
             steps of the two slots against dense decode.
11. dense serve — the default serve path of the reference on the dense
             zoo: ``launch.serve --executor zoo`` with StableLM-12B at full
             width and depth in bfloat16, 8 requests of one shared
             1024-token system prompt plus their own 64-512 tokens, 16 new
             tokens each, ``max_batch=4``, page 16, prefix cache on,
             prefill chunks of 256: every request finishes, the prefix
             cache hits, computed + cached prompt tokens equal the prompt
             total, ``pool.check()`` passes, and the flash kernel launched
             exactly 40 times per prefill call (one-shot or chunk), each on
             the "mma" path; no other kernel launched.  The first served token of a prefix-hit
             request must match a dense eager prefill of its prompt.

The rest of Galaxy serving runs after phase 5, each at GPT2-L's full width
and depth, their three kernels' calls logged at ``kernels/ops.py``:

12. chunk parity — fp32, TF32 off: one request of a 256-token prefix and
             200 own tokens prefilled in 128-token chunks at offsets 0,
             128, 256, 384 against one one-shot prefill: every chunk row's
             logits, the last row's, and the written pages at every valid
             position and head slot, within 1e-3.
13. prefix serve — fp16, 8 requests of one shared 256-token system
             prompt plus 37-300 own tokens, 16 new, ``max_batch`` 4, page
             16, prefix cache on, chunks of 128: every request finishes,
             computed + cached prompt tokens equal the total, at least one
             hit and one shared page, ``pool.check()``; launch counts exact
             by ``galaxy_expect`` from the stats; a prefix-hit request's
             first token against an eager one-shot prefill.
14. spec serve — GPT2-L on 3:2:2:1 verifying a DistilBERT-shaped draft
             (Table IV) on a one-device plan placed by ``place_draft``, k
             4, 4 requests of 37-300 tokens, 16 new, greedy, spec on
             against spec off: in fp32 tokens equal, in fp16 equal up to
             near-ties (a top-2 logit gap below 0.05, each printed);
             ``pool.check()`` on both pools after every round; launch
             counts exact (target and draft).  The fp16 spec serve is
             built as ``launch.serve`` builds it (draft seed 2 = ``--seed``
             + 2): its tokens are phase 34's ``LocalRing`` twin.
15. wave serve — fp16, the same 4 requests with ``scheduler="wave"``:
             tokens equal the continuous serve's up to near-ties, and
             ``ragged_flash_attention`` launched exactly 36 x 4 x waves.
16. schedules — one GPT2-L layer at S 256, fp16: ``hmp``, ``hmp_ring``
             and ``megatron`` on the 3:2:2:1 plan's kernel backend, ``sp``
             on the even plan, each within 0.05 of the fp32
             ``reference_layer``; each one's per-layer device time.
17. telemetry — serving observability (``repro_torch.obs``): the
             prefix + chunk serve of phase 13 with a ``Tracer``, the drift
             monitor (``make_step_pricer`` over the served plan) and
             ``record_times`` on, then all three off, then ``record_times``
             alone: tokens bitwise equal, no open span, each request's
             spans covering >= 0.95 of it, ``ttft_s`` n = requests, the
             pages still used at the end exactly the prefix tree's, the
             ``ring_wire_*`` gauges equal to ``wire_stats()``, drift
             records of ``decode`` and ``prefill_chunk`` (finite, > 0),
             launch counts exact and every GEMM and attention on the
             tensor cores; the trace written and parsed back; tok/s, TTFT
             p50 and drift p50 per kind printed.  A traced speculative
             serve (2 requests, k 4, 8 new): its spec spans closed and a
             ``spec_verify`` drift record.  A traced zoo serve of
             qwen1.5-0.5b at full size (bf16, prefix cache, 256-token
             chunks, 4 requests on 2 slots; the dense flash kernel at hd
             64) between two untraced ones: tokens equal, drift records
             of both kinds.  ``HostProfiler`` (GPT2-L, seq 256, 20
             iterations) on the card beside
             ``AnalyticProfiler``'s capacity of a Jetson Nano-L.
18. replay — every distinct call of phases 12-17 to the three Galaxy
             kernels (GEMM shapes and valid counts, attention layouts,
             connective sites) replayed on fresh inputs with garbage pads
             in fp32, fp16 and bf16 against the plain versions, on the
             expected paths.

The MoE and xLSTM families run last, after StableLM's serve:

19. moe kernels — the flash kernel at an olmoe-1b-7b prefill chunk (256
             queries at offset 1024, 16 heads of 128, MHA) and a
             granite-moe-3b-a800m one-shot prefill (512 queries, 24 heads
             on 8 KV heads of 64), fp32, bf16 and fp16 against the plain
             version, timed (bf16) beside it, SDPA and the bound.
20. moe routing — one MoE sub-layer (norm, router, experts, residual) at
             olmoe's width (64 experts) and granite's (40 in 48 padded),
             fp32, 512 tokens from a seed, on the card and on the CPU:
             the same experts for every token, never a pad expert, the
             output within 1e-4 of the largest, equal aux values;
             ``moe_drop_frac`` printed.
21. xlstm parity — xlstm-350m's width cut to 2 layers (one mLSTM, one
             sLSTM), fp32, gates and norm scales random: a 256-token
             prefill (the chunked mLSTM path) and 2 decode steps against
             one pass over all 258 tokens (the step path), and the two
             paths at S 256; each within 1e-4 of the largest logit.
22. olmoe serve — olmoe-1b-7b at full width and depth in bf16 with the
             StableLM traffic (8 requests of one shared 1024-token prompt
             plus 64-512 own, 16 new, ``max_batch`` 4, page 16, prefix
             cache, 256-token chunks): flash launched exactly 16 x
             prefill calls, on the tensor cores, no other kernel; the
             last request's prefill calls replayed on both backends (the
             same MoE token groups as served): the kernel replay gives
             the served first token, the eager replay's argmax agrees up
             to a tie gap of 0.1.
23. granite serve — granite-moe-3b-a800m the same way, 4 requests of
             64-512 tokens, one-shot prefills: flash exactly 32 x prefill
             calls, at hd 64 on 3 query heads a KV head.
24. xlstm serve — xlstm-350m at full width and depth in bf16 in waves of
             4 x 256 and 2 x 300 tokens, 16 new: no kernel launched, 12
             mLSTM prefills on each path; the 256-token wave's first
             tokens against a pass on the step path (tie gap 0.1).

The training path and the rest of the zoo run after them:

25. train kernels — q, k, v gradients through ``FlashAttentionFn`` (the
             kernel forward, a torch-ops backward) against autograd
             through the plain version, causal, at qwen1.5-0.5b's (8, 16,
             128, 64) and llama-3.2-vision's (1, 64, 256, 128) on 8 KV
             heads, fp32 (1e-4 of the largest gradient) and bf16 (2e-2);
             the bare kernel's output carries no gradient (the fault the
             Function repairs).  a, b, h0 through ``RGLRUScanFn`` (the
             kernel forward and, on reversed time, backward: 2 launches)
             at (4, 300, 4096) fp32, nonzero h0, within 1e-5.  Times the
             forward kernel, the backward and plain autograd.
26. train — ``launch.train`` with qwen1.5-0.5b at full width and depth
             (bf16, remat on), 8 x 128 tokens, 20 steps: finite losses,
             the last 5 steps' mean below the first step's, flash
             launched exactly 2 x 24 a step (forward and remat's
             recompute) and no other kernel; median step, tokens/s and
             peak memory.  Then one fp32 step at full width cut to 4
             layers, kernel vs eager backend from the same weights and
             batch (``STEP_TOL``).
27. train zoo — musicgen-medium at full width and depth (48 layers,
             embed input, 4 codebooks, sinusoidal), 5 steps with finite
             losses; RecurrentGemma-9B at full width cut to one group,
             one fp32 step kernel vs eager (the scan 6 launches: forward,
             recompute, backward for each rec layer); olmoe-1b-7b at
             full width cut to 2 layers, one bf16 step (the aux losses
             in the loss, gradients into the router and the experts);
             qwen1.5-0.5b at 4 layers, bf16: 3 steps, a checkpoint,
             restored into fresh tensors, 3 steps, bitwise equal to 6
             uninterrupted steps.
28. xattn — llama-3.2-vision-90b at full width cut to one group (4 attn
             + 1 xattn, 1024 image tokens), bf16 and then fp32: a 2 x
             128-token prefill and 8 decode steps fed the eager backend's
             greedy tokens, kernel vs eager logits within ``XATTN_TOL``
             and greedy tokens equal except where the eager top-2 gap is
             below it; musicgen-medium at full width cut to 4 layers,
             fp32: prefill then decode against its train-mode forward.
29. dryrun — ``launch.dryrun.run_one`` at full width, cut to 4 layers,
             on fake tensors over the fake process group: qwen1.5-0.5b and
             granite-moe-3b-a800m (24 heads on the 16-way axis: the SP
             attention layout; experts) at the four ``SHAPES`` on 16 x
             16, and qwen1.5-110b's ``decode_32k`` on 2 x 16 x 16.  The
             card's ``memory_allocated`` must not move; every record has
             ``useful_flops_ratio`` <= 1.05, a bottleneck and
             collectives; one line per record; the group is torn down.
30. roofline — real steps of qwen1.5-0.5b at full width and depth, bf16,
             on the kernel backend (flash launches counted): one prefill
             of 4 x 4096 tokens and the train step at 8 x 128, each the
             median of 7 after 2 warm-ups, beside ``run_one``'s record of
             the same step on a 1 x 1 mesh: ``roofline_step_s``, the
             measured seconds, their ratio (<= 1.05, or it fails: no
             count may claim a step faster than the card allows) and
             ``mfu``.  The record's argument bytes must equal the live
             params' (and AdamW moments') bytes; its per-chip peak is
             printed beside ``max_memory_allocated`` of the same step on
             the eager backend (after a ``gc.collect()``), and beside what
             was resident on the card before that step: what each holds
             above what it was given must agree within 5 %.
31. calibrate — ``experiments/calibrate``: ``hmp_layer`` (sync, "hmp") and
             with the ring ("hmp_ring") on the kernel backend in fp16, 20
             timed calls each, for DistilBERT cut to one layer (128 rows)
             and GPT2-L cut to one layer on its served 3:2:2:1 plan (256
             rows); launches exact (a layer: 16 or 64 GEMMs, 4 attention,
             2 connective sites).  Each scenario's host device fitted to
             its own two layers: the loss must fall and both residual
             ratios lie within e^0.25; the joint fit of all four printed
             (its loss must fall).  The drift ratio of each layer with the
             fitted device and with the Jetson Nano-L the serve prices.
32. remat — qwen1.5-0.5b at full width and depth, bf16, 8 x 128, 3 steps
             under remat "full", "dots" and "none" from the same weights
             and batches: step ms and peak memory; losses equal to bf16
             rounding; "dots" runs fewer products in its backward than
             "full" (counted by a dispatch mode); flash launches exact.
             The fp32 RecurrentGemma group step, kernel vs eager, under
             "dots" within the train phase's bounds.  One qwen step with
             dropout 0.1 twice with one seed: finite, bitwise equal.
33. hillclimb — ``experiments/hillclimb`` at 8 layers a pair: the six
             variants, the TP-only baseline and their baselines through
             ``run_one(save=False)``, each variant beside its baseline;
             any error fails it, as does "dots" not counting fewer FLOPs
             a chip than "full", or query-chunked attention not lowering
             codeqwen's prefill peak (or raising granite's).

Galaxy across processes, then the zoo across processes, run last:

34. ranks — ``launch.serve --ranks 4`` as a user starts it: GPT2-L at full
             width and depth in fp16 on the 3:2:2:1 plan, one process per
             edge device (``core/ring.ProcessRing`` over gloo on loopback,
             CUDA tensors staged through pinned host buffers), the four
             ranks time-slicing the one card.  Phase 5's traffic and
             then phase 13's (prefix cache, chunks of 128): every rank's
             greedy tokens equal to phase 5's and 13's ``LocalRing``
             serves, launch counts per rank exact by ``galaxy_expect`` for
             one held device (a one-shot prefill: 576 GEMMs, 36
             attention, 72 connectives), every launch on its fast path,
             equal stats on every rank, the hop route printed.  Then
             ``launch.ring_times --ranks 4``: the median hop (a 72 x 1280
             fp16 tile, host-staged) and bytes per hop, and the prefill of
             the stack at S 256 under the overlapped ring with and
             without double buffering and under the sync schedule,
             launches per rank exact for each.  Then phase 14's fp16 spec
             traffic and draft across the ranks, ``--spec-k 4`` with
             ``--trace``, ``--metrics`` and ``--drift`` in the same run:
             every rank's tokens bitwise equal to phase 14's, equal stats
             and registry counters on every rank with at least one
             verify chunk, the draft's launches on the rank of
             ``place_draft``'s device only (printed), rank 0's trace
             written (the export refuses an open span) with
             ``spec_round``, ``draft_propose`` and ``spec_verify`` spans,
             the drift summary with a ``spec_verify`` kind.  A rank that
             fails or outlives its limit fails the phase.  Four contexts
             on one card are not four devices: no number here is a
             four-device speed-up.
35. zoo ranks — the model zoo under the HMP sharding rules across four
             gloo ranks on the one card, a (data 1, model 4) mesh.  First
             gloo's answer for CUDA tensors as they are: each collective
             the mesh issues on a pair of ranks joined without staging,
             the all-gather last (printed; the staging itself is held to
             the unstaged collectives on the CPU by
             ``tests/test_torch_zoo_ranks.py``, and runs for real in (a)
             and (b)).  (a) RecurrentGemma-9B at full width, 5 layers,
             fp32, TF32 off, kernel backend: phase 7's 2 x 2100-token
             prefill and 8 decode steps on the four ranks, each rank's
             weights drawn shard by shard from phase 7's seed; every
             rank's logits bitwise equal to rank 0's, and within 1e-4 of
             phase 7's one-process kernel logits (the sharded row-parallel
             sums only add in another order); 1 flash and 4 scan launches
             a rank in the prefill, none in decode.  Then the same weights
             cast to bf16 and the same tokens: every rank's logits bitwise
             equal, and within 4 bf16 units of the largest logit of one
             process's on those weights (the one-process kernel-vs-eager
             difference printed beside).  (b) ``launch.serve --executor
             zoo --model recurrentgemma-9b --ranks 4`` as a user starts
             it, with phase 8's traffic cut to 4 new tokens in bf16:
             every rank's tokens bitwise equal to the others'; then one
             process fed the ranks' 24 tokens wave by wave: at every step the ranks'
             token is its argmax, or below its top logit by at most twice
             phase 8's kernel-vs-eager bf16 logit error (every such gap
             printed, and where each request first parts from phase 8);
             exactly 12 flash (``mma``) and 26 scan (``tma``) launches a
             rank a wave; each rank's weights (in (a) too) the bytes
             reckoned apart from the rules: the model's bytes split four
             ways but for the norms' scales and wk and wv (one KV head),
             held whole; rank 0's distinct flash and scan calls
             (``kernels/ops.call_log``) replayed against their plain
             versions in bf16; tok/s, TTFT p50, each rank's peak memory
             and staged collectives printed beside phase 8's, as a ratio
             within this run (four contexts on one card, not four
             devices).
36. zoo paged ranks — the zoo's paged protocol under the same rules on
             four ranks.  First the flash kernel at a rank's share of
             phase 9's StableLM chunk (8 of 32 heads on 2 of 8 KV heads,
             256 queries at offset 1024; fp32, bf16, fp16 against the
             plain version, bf16 timed beside it, SDPA and the bound).
             (a) StableLM-12B at full width, 4 layers, fp32, TF32 off,
             kernel backend, phase 10's weights drawn shard by shard:
             phase 10's paged calls (a one-shot 300-token
             ``prefill_paged``, chunks of 64, the prefix-hit suffix over
             16 shared pages, 8 ``decode_paged`` steps of two slots) on
             the four ranks; every rank's logits bitwise equal to rank
             0's and within 1e-4 of phase 10's one-process kernel logits;
             4 flash launches a prefill call a rank (``simt``), none in
             decode; a ``decode_paged`` step stages the collectives of a
             lockstep ``decode`` step (printed, with a chunk's).  (c) on
             the same launch: qwen1.5-0.5b at full size in bf16, 2
             requests of 4 new tokens served by ``launch.serve.serve`` on
             the ranks with and without a qwen1.5-0.5b draft (seed + 2) on
             rank 0, k 4: tokens and stats bitwise equal on every rank,
             spec on equal to spec off up to near-ties within 4 bf16
             units (each printed), the draft's flash launches on rank 0
             alone, at least one verify chunk.  (b) ``launch.serve
             --executor zoo --model stablelm-12b --ranks 4`` as a user
             starts it, with phase 11's traffic cut to 3 requests on 2
             slots (the fewest with a prefix hit) behind a 256-token
             shared prompt, of 4 new tokens in bf16 at full depth,
             and one process serving the same: tokens and stats bitwise
             equal on every rank and the stats one process's, a prefix hit
             and chunks (each rank's pool refcounts checked at the end of
             its run), exactly 40 flash launches (``mma``) a prefill call
             a rank and no other kernel, each rank's pool 51 200 B a
             position; one process fed the ranks' tokens through the
             paged protocol: each its argmax, or below its top logit by at
             most twice the one-process kernel-vs-eager bf16 logit
             difference over the same calls (printed); each rank's pool,
             weight and peak bytes, staged collectives, tok/s and TTFT p50
             beside the one-process serve's as ratios within this run.

The captured steps (``serving/graphs.py``) run in parts, on the
executors and traffic of phases 5, 14, 15, 8, 11 and 24 (no model is
drawn again), each part after its phase (the spec and Galaxy wave parts
after the logged Galaxy phases):

37. graphs — phase 5's GPT2-L fp16 serve and then phase 11's StableLM-12B
             bf16 serve again with ``graphs=True``: tokens (and StableLM's
             stats) bitwise equal to the eager serve's, one decode
             capture and a replay for every later decode step, phase 5's
             exact launch counts (``n_req x 2304 + steps x 576`` GEMMs,
             all ``mma``) and phase 11's (40 flash a prefill call, no
             other kernel); StableLM's chunk shapes captured on their
             second call and replayed after, at least once.  (a) Phase 14's fp16
             spec serve again on its executor and draft with graphs:
             tokens and stats bitwise equal to phase 14's, launches exact
             by ``galaxy_expect``, every verify chunk after its row
             count's second call replayed, the draft's decode captured
             once.  Then, on random pages at each serve's pool geometry,
             one decode step replayed and run eagerly on copies of one
             pool: logits and pages bitwise equal; and (c) chunks (GPT2-L
             5 and 128 rows, StableLM 256 and 5 rows), each at two
             offsets, the first call eager, the second captured, a replay
             at the first offset again: logits and pages bitwise the
             eager step's, one capture.  Each step's or chunk's wall time
             eager against replay (blocks eager, replay, replay, eager;
             the median of 20 steps or 3 chunks each, host inputs to
             synced logits), the replay's device time, one eager and one
             replayed call's kernel time in the profiler's trace (the
             card's idle share of each), the capture's ms and the graph
             pool's bytes.  The wave protocol: (d) phase 8's
             RecurrentGemma-9B traffic again on its executor with graphs
             (held wave caches): tokens and stats bitwise phase 8's, its
             launch counts (24 flash, 52 scan; the wave prefills eager,
             each shape once), one wave decode capture a wave batch size
             (4 and 2 rows) and a replay for every later step; then a
             2-row wave of 300 and 250 tokens on the held cache: the
             prefill eager, captured (the windowed hd-256 flash kernel and
             the TMA scan inside a graph) and replayed, decode steps at
             per-row positions replayed at two others than the captured
             one, each beside the eager step on a fresh cache, logits and
             every cache leaf bitwise; the decode step's wall eager
             against replay and the idle share.  (e) phase 15's GPT2-L
             fp16 wave serve again with graphs: tokens and stats bitwise,
             launches exact by ``galaxy_expect`` (576 GEMMs a replayed
             decode step, 36 x 4 ragged attention a wave), all on the fast
             paths.  (f) phase 24's xlstm-350m waves again with graphs:
             tokens and stats bitwise, no kernel launched.  The one-shot
             prefill: (g) on each executor's held pool at the served
             geometry (random pages), a padded prompt (GPT2-L 288 rows,
             StableLM 256) at two real lengths of its bucket, eager, then
             captured at the other length and replayed, then replayed at
             the first: logits and pages bitwise the eager step's, one
             capture, exact launches; its wall eager against replay.  (h)
             graphs that outlive a run: phase 5's traffic served three
             times on one executor with graphs (``launch.serve`` keeps a
             taken executor's graphs and held pool), each bitwise phase
             5's tokens, stats and launches, the second serve capturing no
             decode step and replaying every one-shot prefill, the third
             capturing nothing; (a)'s spec serve a second time on the same
             target and draft, bitwise phase 14's, every call on a shape
             the first serve met replayed.  Not a claim of speed: graphs
             stay off by default.

Every serve and timing line ends with the card's name and power limit.
Where the serve time goes (``torch.profiler``) is measured apart, by
``python -m repro_torch.launch.trace_serve``.

The last two lines are the kernels' JSON record and the result.  Exits
non-zero without CUDA or without the package beside it.
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import itertools
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, FLOP/s of the
# fp16 tensor cores and of fp32 on the CUDA cores
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float16": 989e12, "bfloat16": 989e12, "float32": 67e12}

# tolerances of kernel vs plain version (both accumulate in fp32): fp32 —
# sums of up to K=1920 products (attention: 2048 keys) taken in another
# order; fp16/bf16 — the final rounding of O(1) outputs
ATOL = {"float32": 1e-4, "float16": 1e-2, "bfloat16": 1e-2}

REPLACES = {
    "tiled_gemm_valid": "src/repro/kernels/tiled_gemm.py:162",
    "ragged_flash_attention": "src/repro/kernels/flash_attention.py:212",
    "fused_connective": "src/repro/kernels/fused_connective.py:34",
    "flash_attention": "src/repro/kernels/flash_attention.py:88",
    "rglru_scan": "src/repro/kernels/rglru_scan.py:49",
    "tiled_gemm": "src/repro/kernels/tiled_gemm.py:77",
}
SOURCES = {
    "tiled_gemm_valid": "src/repro_torch/kernels/csrc/tiled_gemm_valid.cu",
    "ragged_flash_attention": "src/repro_torch/kernels/csrc/ragged_flash_attention.cu",
    "fused_connective": "src/repro_torch/kernels/csrc/fused_connective.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "rglru_scan": "src/repro_torch/kernels/csrc/rglru_scan.cu",
    "tiled_gemm": "src/repro_torch/kernels/csrc/tiled_gemm.cu",
}
GALAXY_KERNELS = ("tiled_gemm_valid", "ragged_flash_attention", "fused_connective")
ZOO_KERNELS = ("flash_attention", "rglru_scan")
# a unit in the last place of each dtype's output, relative: the dense
# GEMM's kernel and plain version round fp32 sums taken in another order,
# and at O(1) outputs one may round up where the other rounds down
ULP = {"float32": 1e-5, "float16": 2.0 ** -10, "bfloat16": 2.0 ** -7}


_T0 = time.perf_counter()


def log(phase: str, msg: str) -> None:
    """``[phase] msg``, after the seconds since the script started."""
    print(f"{time.perf_counter() - _T0:7.1f} s [{phase}] {msg}", flush=True)


def bound(nbytes: float, flops: float, dtype: str):
    """Least time (ms) the card could take, and what sets it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class Record:
    """One kernel's line of the JSON record, summed over its shapes."""

    def __init__(self, name: str, route: str):
        self.d = {"name": name, "route": route, "source": SOURCES[name],
                  "replaces": REPLACES[name], "launches": 0, "max_abs_err": 0.0,
                  "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                  "bound_by": "bytes", "library_ms": 0.0}
        self._t_bytes = self._t_ops = 0.0

    def err(self, e: float) -> None:
        self.d["max_abs_err"] = max(self.d["max_abs_err"], e)

    def timed(self, ms, plain_ms, library_ms, nbytes, flops, dtype) -> None:
        """Add one shape's times; ``library_ms`` None: no one PyTorch call
        computes the function."""
        self.d["ms"] += ms
        self.d["plain_ms"] += plain_ms
        self.d["library_ms"] = (None if library_ms is None
                                else self.d["library_ms"] + library_ms)
        self._t_bytes += nbytes / PEAK_BYTES
        self._t_ops += flops / PEAK_FLOPS[dtype]
        self.d["bound_ms"] = 1e3 * max(self._t_bytes, self._t_ops)
        self.d["bound_by"] = "bytes" if self._t_bytes >= self._t_ops else "operations"


def check_close(name, out, ref, dtype, what, ulp=False):
    """Max abs error of ``out`` against ``ref``: within ATOL, or with
    ``ulp`` within ATOL plus one unit in the last place of each ``ref``
    value (for outputs that both sides round from one fp32 result)."""
    diff = (out.float() - ref.float()).abs()
    lim = ATOL[dtype] + (ULP[dtype] * ref.float().abs() if ulp else 0.0)
    err = diff.max().item() if out.numel() else 0.0
    if not bool((diff <= lim).all()):
        raise AssertionError(f"{name} {what} {dtype}: max abs err {err} beyond {ATOL[dtype]}"
                             + (f" + {ULP[dtype]} |ref|" if ulp else ""))
    return err


def check_path(fn, before, path, n, what):
    """The kernel wrapper ``fn`` took ``path`` for its last ``n`` launches
    (``before``: its ``paths`` counts until then)."""
    if (fn.paths[path] != before[path] + n
            or sum(fn.paths.values()) != sum(before.values()) + n):
        raise AssertionError(f"{what}: not the {path} path: {before} -> {fn.paths}")


def check_flash_paths(ops, counts, what):
    """Every flash_attention launch of a serve took the tensor cores."""
    paths = ops.path_counts()["flash_attention"]
    if paths != {"mma": counts["flash_attention"], "simt": 0}:
        raise AssertionError(f"{what}: flash_attention off the tensor-core path: {paths}")
    log("serve", f"flash_attention paths: {paths} (every launch on the tensor cores)")


def expected_attention_path(dtype: str) -> str:
    """The attention kernels' path for a dtype (fp32 stays on the CUDA
    cores)."""
    return "simt" if dtype == "float32" else "mma"


def phase_kernels(rec, plan, torch):
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        ragged_flash_attention, ragged_flash_attention_plain)
    from repro_torch.kernels.fused_connective import (
        fused_connective_group, fused_connective_group_plain)
    from repro_torch.kernels.build import sm_count
    from repro_torch.kernels.tiled_gemm import (
        dense_block_count, plan_valid_gemm, tiled_gemm_valid, tiled_gemm_valid_plain)
    from repro_torch.launch.kernel_timing import time_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    lay = plan.seq_layout(200)          # tiles (57, 56, 56, 31), 228 rows
    pt, hd, ph, pc = lay.pad_tile, plan.head_dim, plan.pad_heads, plan.pad_columns
    d_model = plan.d_model
    vh, vc, rows_dev = plan.heads[1], plan.columns[1], lay.tiles[1]
    # one ring step of device 1 (5 heads, 1280 columns) on a 56-row tile of
    # the 57-row padded tile; a decode step of 4 slots as _decode_layer
    # launches it, (4, 1, d) folded to one-row segments, for QKV and W2;
    # and a 4-row segment (correctness only)
    gemms = {
        "qkv": (pt, 3 * ph * hd, d_model, rows_dev, vh * hd, d_model, pt, ph * hd),
        "wo": (pt, d_model, ph * hd, rows_dev, d_model, vh * hd, pt, d_model),
        "w1": (pt, pc, d_model, rows_dev, vc, d_model, pt, pc),
        "w2": (pt, d_model, pc, rows_dev, d_model, vc, pt, d_model),
        "decode_qkv_s1": (4, 3 * ph * hd, d_model, 1, vh * hd, d_model, 1, ph * hd),
        "decode_w2_s1": (4, d_model, pc, 1, d_model, vc, 1, d_model),
        "decode_qkv": (4, 3 * ph * hd, d_model, 4, vh * hd, d_model, 4, ph * hd),
    }
    sms = sm_count(dev)
    for key, (m, n, k, vm, vn, vk, seg_m, seg_n) in gemms.items():
        p = plan_valid_gemm(m, n, k, seg_m=seg_m, seg_n=seg_n, valid_m=vm, valid_n=vn,
                            valid_k=vk, sm_count=sms)
        log("kernels", f"tiled_gemm_valid plan {key}: {p.live_tiles} live tiles of "
            f"{p.m_tiles * p.n_tiles} ({p.pack} segment(s) a tile) x {p.splits} K slices of "
            f"{p.steps_per_split} steps = {p.live_tiles * p.splits} live blocks on {sms} SMs")
    junk = 1e3
    for dtype in ("float32", "float16", "bfloat16"):
        tdt = getattr(torch, dtype)
        esize = torch.finfo(tdt).bits // 8
        for key, (m, n, k, vm, vn, vk, seg_m, seg_n) in gemms.items():
            rows = (torch.arange(m, device=dev) % seg_m) < vm
            cols = (torch.arange(n, device=dev) % seg_n) < vn
            kk = torch.arange(k, device=dev) < vk
            x = torch.randn(m, k, generator=g, device=dev)
            w = torch.randn(k, n, generator=g, device=dev) / k ** 0.5
            x = torch.where(rows[:, None] & kk[None, :], x, junk).to(tdt)
            w = torch.where(kk[:, None] & cols[None, :], w, -junk).to(tdt)
            kw = dict(valid_m=vm, valid_n=vn, valid_k=vk, seg_m=seg_m, seg_n=seg_n)
            path = "fma" if dtype == "float32" else "mma"
            before = dict(tiled_gemm_valid.paths)
            out, cnt = tiled_gemm_valid(x, w, count_blocks=True, **kw)
            again = tiled_gemm_valid(x, w, **kw)
            plain = tiled_gemm_valid_plain(x, w, **kw)
            torch.cuda.synchronize()
            err = check_close("tiled_gemm_valid", out, plain, dtype, key)
            if out[~rows].any() or out[:, ~cols].any():
                raise AssertionError(f"tiled_gemm_valid {key} {dtype}: pad outputs not zero")
            want = dense_block_count(m, n, k, **kw)
            if int(cnt) != want:
                raise AssertionError(f"tiled_gemm_valid {key}: live tiles {int(cnt)} != {want}")
            if not torch.equal(out, again):
                raise AssertionError(f"tiled_gemm_valid {key} {dtype}: two calls differ")
            if tiled_gemm_valid.paths[path] != before[path] + 2:
                raise AssertionError(f"tiled_gemm_valid {key} {dtype}: not the {path} path: "
                                     f"{before} -> {tiled_gemm_valid.paths}")
            log("kernels", f"tiled_gemm_valid {key} {dtype} ({m}x{k})@({k}x{n}) seg_m={seg_m} "
                f"valid=({vm},{vn},{vk}) err={err:.3g} live_tiles={want} path={path}, "
                "bitwise equal on repeat")
            if dtype != "float16":
                continue
            rec["tiled_gemm_valid"].err(err)
            if key == "decode_qkv":
                continue
            # cycle weight copies past the 50 MB L2: the served model's
            # weights (2.2 GB) are cold when each GEMM reads them
            copies = max(2, int(200e6 // (w.numel() * esize)) + 1)
            ws = [w.clone() for _ in range(copies)]
            xm = torch.where(rows[:, None] & kk[None, :], x, 0)
            wm = [torch.where(kk[:, None] & cols[None, :], c, 0) for c in ws]
            it = iter(range(1 << 30))

            def nxt(lst):
                return lst[next(it) % len(lst)]

            ms = time_ms(lambda: tiled_gemm_valid(x, nxt(ws), **kw))
            plain_ms = time_ms(lambda: tiled_gemm_valid_plain(x, nxt(ws), **kw))
            lib_ms = time_ms(lambda: torch.matmul(xm, nxt(wm)))
            live_m = (m // seg_m) * vm
            live_n = (n // seg_n) * vn
            nbytes = esize * (live_m * vk + vk * live_n + m * n)
            flops = 2.0 * live_m * live_n * vk
            rec["tiled_gemm_valid"].timed(ms, plain_ms, lib_ms, nbytes, flops, dtype)
            bms, by = bound(nbytes, flops, dtype)
            log("kernels", f"tiled_gemm_valid {key} fp16: {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")

        # ragged attention on device 1's shard: (1, 8, 228, 64) views of
        # the fused QKV output, 5 valid heads
        s = lay.padded_len
        pos = lay.positions
        pad = torch.as_tensor(~lay.valid, device=dev)
        qkv = torch.randn(1, s, 3 * ph, hd, generator=g, device=dev)
        qkv[:, pad] = junk
        qkv[:, :, vh:ph] = -junk
        qkv = qkv.to(tdt)
        q, k, v = (t.transpose(1, 2) for t in qkv.split(ph, dim=2))
        apath = expected_attention_path(dtype)
        before = dict(ragged_flash_attention.paths)
        out = ragged_flash_attention(q, k, v, positions=pos, valid_heads=vh)
        again = ragged_flash_attention(q, k, v, positions=pos, valid_heads=vh)
        plain = ragged_flash_attention_plain(q, k, v, positions=pos, valid_heads=vh)
        torch.cuda.synchronize()
        err = check_close("ragged_flash_attention", out, plain, dtype, "shard")
        if out[:, :, pad].any() or out[:, vh:].any():
            raise AssertionError(f"ragged_flash_attention {dtype}: pad rows/heads not zero")
        if not torch.equal(out, again):
            raise AssertionError(f"ragged_flash_attention {dtype}: two calls differ")
        check_path(ragged_flash_attention, before, apath, 2, f"ragged_flash_attention {dtype}")
        log("kernels", f"ragged_flash_attention {dtype} (1,{ph},{s},{hd}) "
            f"valid_heads={vh} err={err:.3g} path={apath}, bitwise equal on repeat")
        if dtype == "float16":
            rec["ragged_flash_attention"].err(err)
            mask = torch.as_tensor(lay.attention_mask(), device=dev)
            qc, kc, vc_ = (t.contiguous() for t in (q, k, v))
            ms = time_ms(lambda: ragged_flash_attention(q, k, v, positions=pos,
                                                        valid_heads=vh))
            plain_ms = time_ms(lambda: ragged_flash_attention_plain(
                q, k, v, positions=pos, valid_heads=vh))
            lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qc, kc, vc_, attn_mask=mask))
            n_valid = lay.seq
            pairs = n_valid * (n_valid + 1) // 2      # visible (query, key) pairs
            flops = 4.0 * pairs * vh * hd
            nbytes = esize * (3 * n_valid * vh * hd + s * ph * hd)
            rec["ragged_flash_attention"].timed(ms, plain_ms, lib_ms, nbytes, flops, dtype)
            bms, by = bound(nbytes, flops, dtype)
            log("kernels", f"ragged_flash_attention fp16: {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")

        # connective as the layer launches it: one site of four 57-row
        # padded tiles, then unequal shards and an empty one; rate 0 (the
        # path) and 0.1 (dropout).  Kernel and plain version round one fp32
        # result, and at outputs of 2-4 one bf16 unit (0.0156) exceeds ATOL:
        # bf16 is held to ATOL plus one unit of its output
        groups = {"site": [pt] * len(lay.tiles), "unequal": [*lay.tiles, 0]}
        def draw(shape, scale=1.0, shift=0.0):
            return (shift + scale * torch.randn(shape, generator=g, device=dev)).to(tdt)

        for (key, rows), rate in itertools.product(groups.items(), (0.0, 0.1)):
            xs = [draw((r, d_model)) for r in rows]
            ress = [draw((r, d_model)) for r in rows]
            keeps = [(torch.rand(r, d_model, generator=g, device=dev) > rate).to(tdt)
                     for r in rows]
            scales = [draw(d_model, 0.1, 1.0) for _ in rows]
            biases = [draw(d_model, 0.1) for _ in rows]
            args = (xs, ress, keeps, scales, biases)
            before = dict(fused_connective_group.paths)
            outs = fused_connective_group(*args, rate=rate)
            again = fused_connective_group(*args, rate=rate)
            plain = fused_connective_group_plain(*args, rate=rate)
            torch.cuda.synchronize()
            err = max(check_close("fused_connective", o, p, dtype,
                                  f"{key} shard {i} rate={rate}", ulp=dtype == "bfloat16")
                      for i, (o, p) in enumerate(zip(outs, plain)))
            if not all(torch.equal(a, b) for a, b in zip(outs, again)):
                raise AssertionError(f"fused_connective {key} {dtype}: two calls differ")
            check_path(fused_connective_group, before, "warp", 2,
                       f"fused_connective {key} {dtype}")
            log("kernels", f"fused_connective {dtype} {key} shards {rows} x {d_model} "
                f"rate={rate}: one launch, err={err:.3g} path=warp, bitwise equal on repeat")
            if dtype == "float16" and rate == 0.0 and key == "site":
                rec["fused_connective"].err(err)
                ms = time_ms(lambda: ops.connective_group(xs, ress, scales, biases))
                plain_ms = time_ms(lambda: fused_connective_group_plain(
                    xs, ress, None, scales, biases))
                xcat, rcat = torch.cat(xs), torch.cat(ress)
                lib_ms = time_ms(lambda: torch.nn.functional.layer_norm(
                    xcat + rcat, (d_model,), scales[0], biases[0], 1e-5))
                n_rows = sum(rows)
                nbytes = esize * (3 * n_rows * d_model + 2 * len(rows) * d_model)
                flops = 8.0 * n_rows * d_model
                rec["fused_connective"].timed(ms, plain_ms, lib_ms, nbytes, flops, dtype)
                bms, by = bound(nbytes, flops, dtype)
                log("kernels", f"fused_connective fp16 site {rows} x {d_model}: {ms:.4f} ms "
                    f"a launch, plain {plain_ms:.4f} ms, layer_norm(x+res) stacked "
                    f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")


def phase_parity(cfg, plan, torch):
    """Two GPT2-L-width layers in fp32: kernel vs eager backend, prefill of
    4 prompts and 8 decode steps of the 4-slot batch, logits compared at
    every step and greedy tokens fed back."""
    from repro_torch.launch.serve import build_executor

    dev = torch.device("cuda")
    kern = build_executor(cfg, plan.with_backend("kernel"), device=dev,
                          dtype=torch.float32, seed=1, num_layers=2)
    eager = copy.copy(kern)  # the same weight shards, the oracle backend
    eager.plan = kern.plan.with_backend("eager")
    lens, page, width, steps = (91, 37, 64, 50), 16, 7, 8
    prompts = torch.randint(0, cfg.vocab_size, (len(lens), 96), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(2))
    block_table = 1 + torch.arange(len(lens) * width, device=dev).view(len(lens), width)
    pools, logits = {}, {}
    for name, ex in (("kernel", kern), ("eager", eager)):
        pools[name] = ex.make_pool(1 + len(lens) * width, page)
        rows = []
        for b, n in enumerate(lens):
            n_pad = -(-n // page) * page
            out, _ = ex.prefill_paged(prompts[b:b + 1, :n_pad], pools[name],
                                      block_table[b], length=n)
            rows.append(out)
        logits[name] = torch.cat(rows)
    # fp32 through two layers: GEMM sums of K <= 1920 taken in another order
    tol = 1e-4
    err = (logits["kernel"] - logits["eager"]).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"prefill logits kernel vs eager: max abs err {err} > {tol}")
    positions = torch.tensor(lens, device=dev)
    derr, tokens = 0.0, []
    for step in range(steps):
        tok = logits["kernel"].argmax(-1)
        if not torch.equal(tok, logits["eager"].argmax(-1)):
            raise AssertionError(f"decode step {step}: greedy tokens differ")
        tokens.append(tok.tolist())
        for name, ex in (("kernel", kern), ("eager", eager)):
            logits[name], _ = ex.decode_paged(tok[:, None], pools[name], block_table,
                                              positions + step)
        e = (logits["kernel"] - logits["eager"]).abs().max().item()
        if not e <= tol:
            raise AssertionError(f"decode step {step} logits kernel vs eager: "
                                 f"max abs err {e} > {tol}")
        derr = max(derr, e)
    log("parity", f"2 layers fp32, {len(lens)} slots: prefill logits max abs err "
        f"{err:.3g}; {steps} decode steps logits max abs err {derr:.3g}, greedy "
        f"tokens equal: {tokens}")


def phase_serve(torch, rec, dtype="float16", n_req=8, max_new=16):
    """The Galaxy serve on the kernel backend; ``rec`` (the served fp16
    run's record) takes its launch counts, or None for another dtype's."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = launch_serve.serve("gpt2-l", (3, 2, 2, 1), requests=n_req,
                             prompt_len=(37, 300), max_new=max_new, max_batch=4,
                             device="cuda", dtype=dtype, seed=0)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    reqs = out["requests"]
    log("serve", f"{out['plan']} ({dtype})")
    if len(reqs) != n_req or any(len(r.output) != max_new for r in reqs):
        raise AssertionError(f"unfinished requests: {[len(r.output) for r in reqs]}")
    steps = out["stats"]["decode_steps"]
    expect = {"tiled_gemm_valid": n_req * 2304 + steps * 576,
              "ragged_flash_attention": n_req * 144,
              "fused_connective": n_req * 72}
    for name in GALAXY_KERNELS:
        n = counts[name]
        if n <= 0:
            raise AssertionError(f"{name} never launched on the Galaxy path")
        if rec is not None:
            rec[name].d["launches"] = n
        note = "as expected" if n == expect[name] else f"expected {expect[name]}"
        log("serve", f"{name}: {n} launches ({note})")
    for name in ZOO_KERNELS + ("tiled_gemm",):
        if counts[name]:
            raise AssertionError(f"{name} launched {counts[name]} times on the Galaxy path")
    if counts["fused_connective"] != expect["fused_connective"]:
        raise AssertionError(f"fused_connective: {counts['fused_connective']} launches, not "
                             "one per connective site")
    check_galaxy_paths(ops, "served")
    paths = ops.path_counts()
    log("serve", f"paths: {', '.join(f'{n} {paths[n]}' for n in GALAXY_KERNELS)} (every served GEMM "
        "and attention on the tensor cores, every connective on the register-row path)")
    log("serve", f"{n_req} requests, prompts {[len(r.prompt) for r in reqs]}, "
        f"{out['new_tokens']} new tokens in {out['seconds']:.2f} s: "
        f"{out['tokens_per_s']:.1f} tok/s, TTFT p50 {1e3 * out['ttft_p50_s']:.1f} ms, "
        f"{steps} decode steps, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return out


def check_served_token(out, torch, dtype="float16", index=0, exact=True):
    """Request ``index``'s one-shot prefill logits from the kernel backend
    agree with the eager backend on the same weights at full depth, the
    first served token is the kernel backend's argmax (``exact``; else, for
    a token served through chunks, within the tolerance of its top), and
    it is the eager backend's argmax up to the working dtype's
    disagreement (a near-tie may flip the order)."""
    import numpy as np

    kern = out["executor"]
    eager = copy.copy(kern)
    eager.plan = kern.plan.with_backend("eager")
    req = out["requests"][index]
    s = len(req.prompt)
    s_pad = -(-s // 16) * 16
    toks = np.zeros((1, s_pad), np.int64)
    toks[0, :s] = req.prompt
    logits = {}
    for name, ex in (("kernel", kern), ("eager", eager)):
        pool = ex.make_pool(1 + s_pad // 16, 16)
        logits[name], _ = ex.prefill_paged(toks, pool, list(range(1, 1 + s_pad // 16)),
                                           length=s)
    # fp16 through 36 layers: the eager path rounds attention scores and
    # probabilities to fp16 where the kernel keeps them in fp32; bf16 keeps
    # 3 fewer mantissa bits, so its roundings are 8 times as large
    tol = {"float16": 5e-2, "bfloat16": 8 * 5e-2}[dtype]
    kl, el = logits["kernel"].float()[0], logits["eager"].float()[0]
    err = (kl - el).abs().max().item()
    first = int(kl.argmax())
    served = req.output[0]
    gap = (el.max() - el[served]).item()
    off_top = first != served if exact else (kl.max() - kl[served]).item() > tol
    if not np.isfinite(err) or err > tol or off_top or gap > tol:
        raise AssertionError(f"served token check: err {err}, served {req.output[0]}, "
                             f"kernel argmax {first}, eager argmax {int(el.argmax())} "
                             f"(gap {gap})")
    log("serve", f"request {req.uid} ({s} tokens, 36 layers {dtype}): kernel vs eager prefill "
        f"logits max abs err {err:.3g} (tolerance {tol}); kernel argmax {first}, served "
        f"{served}, eager top-to-served gap {gap:.3g}")


def phase_zoo_kernels(rec, torch):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain
    from repro_torch.launch.kernel_timing import time_ms, window_pairs

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    b, h, hkv, s, hd, window = 2, 16, 1, 2100, 256, 2048
    for dtype in ("float32", "bfloat16", "float16"):
        tdt = getattr(torch, dtype)
        # transposed views of the zoo's (B, S, H, hd) projections
        q = torch.randn(b, s, h, hd, generator=g, device=dev).to(tdt).transpose(1, 2)
        k, v = (torch.randn(b, s, hkv, hd, generator=g, device=dev).to(tdt).transpose(1, 2)
                for _ in range(2))
        before = dict(flash_attention.paths)
        out = flash_attention(q, k, v, causal=True, window=window)
        plain = flash_attention_plain(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        err = check_close("flash_attention", out, plain, dtype, "served prefill")
        apath = expected_attention_path(dtype)
        check_path(flash_attention, before, apath, 1, f"flash_attention {dtype}")
        log("kernels", f"flash_attention {dtype} q ({b},{h},{s},{hd}) kv ({b},{hkv},{s},{hd}) "
            f"causal window={window} err={err:.3g} path={apath}")
        if dtype != "bfloat16":
            continue
        rec["flash_attention"].err(err)
        pos = torch.arange(s, device=dev)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        ms = time_ms(lambda: flash_attention(q, k, v, causal=True, window=window), iters=10)
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, causal=True, window=window),
                           iters=5)
        lib_ms = time_ms(lambda: sdpa(qc, kc, vc, attn_mask=mask, enable_gqa=True), iters=10)
        esize = 2
        nbytes = esize * (2 * b * h * s * hd + 2 * b * hkv * s * hd)
        flops = 4.0 * window_pairs(s, s, window) * hd * h * b
        rec["flash_attention"].timed(ms, plain_ms, lib_ms, nbytes, flops, dtype)
        bms, by = bound(nbytes, flops, dtype)
        log("kernels", f"flash_attention bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")

    # the scan at both served waves: 4 x 300 and 2 x 2100 rows, fp32 (the
    # gates' dtype), held bit for bit: both round each product and sum once
    w = 4096
    for bs, ss in ((4, 300), (2, 2100)):
        a = 0.5 + 0.499 * torch.rand(bs, ss, w, generator=g, device=dev)
        bb = torch.randn(bs, ss, w, generator=g, device=dev)
        h0 = torch.randn(bs, w, generator=g, device=dev)
        before = dict(rglru_scan.paths)
        hs, hl = rglru_scan(a, bb, h0)
        hs2, hl2 = rglru_scan(a, bb, h0)
        ps, pl = rglru_scan_plain(a, bb, h0)
        torch.cuda.synchronize()
        err = max(check_close("rglru_scan", hs, ps, "float32", "h_seq"),
                  check_close("rglru_scan", hl, pl, "float32", "h_last"))
        if not (torch.equal(hs, ps) and torch.equal(hl, pl)):
            raise AssertionError(f"rglru_scan ({bs},{ss},{w}) fp32 not bitwise equal to "
                                 f"the plain version (max abs err {err})")
        if not (torch.equal(hs, hs2) and torch.equal(hl, hl2)):
            raise AssertionError(f"rglru_scan ({bs},{ss},{w}): two calls differ")
        check_path(rglru_scan, before, "tma", 2, f"rglru_scan ({bs},{ss},{w})")
        rec["rglru_scan"].err(err)
        log("kernels", f"rglru_scan float32 ({bs},{ss},{w}) nonzero h0: h_seq and h_last "
            "bitwise equal to the plain version and on repeat, path=tma")
        ms = time_ms(lambda: rglru_scan(a, bb, h0))
        plain_ms = time_ms(lambda: rglru_scan_plain(a, bb, h0), iters=3)
        nbytes = 4 * (3 * bs * ss * w + 2 * bs * w)
        flops = 2.0 * bs * ss * w
        rec["rglru_scan"].timed(ms, plain_ms, None, nbytes, flops, "float32")
        bms, by = bound(nbytes, flops, "float32")
        log("kernels", f"rglru_scan fp32 ({bs},{ss},{w}): {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, no library call, bound {bms:.4f} ms ({by})")
        del a, bb, hs, hs2, ps


def phase_zoo_parity(torch):
    """RecurrentGemma-9B at full width, 5 layers, fp32: kernel vs eager
    backend logits after a 2100-token prefill and 8 decode steps.  Returns
    the kernel backend's logits (prefill, then each step, on the host) and
    the steps' input tokens, which phase 35 holds the four ranks to."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import TransformerExecutor

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=5,
                              dtype="float32", param_dtype="float32")
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(5),
                         device=dev)
    kern = TransformerExecutor(params, cfg, backend="kernel")
    eager = TransformerExecutor(params, cfg, backend="eager")
    b, s, steps = 2, 2100, 8
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(6))
    ops.reset_launch_counts()
    lk, ck = kern.prefill(tokens, kern.make_cache(b, s + steps))
    counts = ops.launch_counts()
    if (counts["flash_attention"], counts["rglru_scan"]) != (1, 4):
        raise AssertionError(f"5-layer prefill launches: {counts}")
    le, ce = eager.prefill(tokens, eager.make_cache(b, s + steps))
    # fp32 through 5 full-width layers: the paths differ only in the
    # attention's and the scan's summation order
    tol = 1e-4
    err = (lk - le).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"zoo prefill logits kernel vs eager: max abs err {err} > {tol}")
    derr, toks, ref = 0.0, [], [lk.cpu()]
    for step in range(steps):
        tok = le.argmax(-1)
        if not torch.equal(tok, lk.argmax(-1)):
            raise AssertionError(f"zoo decode step {step}: greedy tokens differ")
        toks.append(tok.tolist())
        lk, ck = kern.decode(tok[:, None], ck, s + step)
        ref.append(lk.cpu())
        le, ce = eager.decode(tok[:, None], ce, s + step)
        e = (lk - le).abs().max().item()
        if not e <= tol:
            raise AssertionError(f"zoo decode step {step} logits kernel vs eager: "
                                 f"max abs err {e} > {tol}")
        derr = max(derr, e)
    if ops.launch_counts() != counts:
        raise AssertionError("a zoo decode step launched a prefill kernel")
    log("parity", f"RecurrentGemma-9B width, 5 layers fp32, {b} x {s}-token prefill "
        f"(window {cfg.window}): logits max abs err {err:.3g}; {steps} decode steps "
        f"max abs err {derr:.3g} (tolerance {tol}); greedy tokens equal: {toks}")
    return {"logits": ref, "tokens": toks}


def phase_zoo_serve(torch, rec):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve

    torch.cuda.reset_peak_memory_stats()
    lens, max_new = [300] * 4 + [2100] * 2, 16
    ops.reset_launch_counts()
    out = launch_serve.serve("recurrentgemma-9b", executor_kind="zoo", prompt_lens=lens,
                             max_new=max_new, max_batch=4, device="cuda",
                             dtype="bfloat16", seed=0)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    reqs = out["requests"]
    log("serve", out["plan"])
    if len(reqs) != len(lens) or any(len(r.output) != max_new for r in reqs):
        raise AssertionError(f"unfinished zoo requests: {[len(r.output) for r in reqs]}")
    cfg = out["executor"].cfg
    waves = 2
    expect = {name: 0 for name in counts}
    expect["flash_attention"] = cfg.layer_kinds().count("attn") * waves
    expect["rglru_scan"] = cfg.layer_kinds().count("rec") * waves
    for name in ZOO_KERNELS:
        rec[name].d["launches"] += counts[name]
        log("serve", f"{name}: {counts[name]} launches (expected {expect[name]})")
    if counts != expect:
        raise AssertionError(f"zoo launch counts {counts} != {expect}")
    check_flash_paths(ops, counts, "zoo serve")
    scan_paths = ops.path_counts()["rglru_scan"]
    if scan_paths != {"tma": counts["rglru_scan"], "simt": 0}:
        raise AssertionError(f"zoo serve: rglru_scan off the TMA path: {scan_paths}")
    log("serve", f"rglru_scan paths: {scan_paths} (every launch on the TMA ring)")
    steps = out["stats"]["decode_steps"]
    log("serve", f"{len(reqs)} requests, prompts {[len(r.prompt) for r in reqs]}, "
        f"{out['new_tokens']} new tokens in {out['seconds']:.2f} s: "
        f"{out['tokens_per_s']:.1f} tok/s, TTFT p50 {1e3 * out['ttft_p50_s']:.1f} ms, "
        f"{steps} decode steps, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return out


def check_zoo_served_tokens(out, torch):
    """The 300-token wave again, kernel vs eager backend at full depth in
    bf16: the kernel prefill reproduces the served first tokens, and each
    is the eager backend's argmax up to the bf16 disagreement.  Returns
    the two backends' largest logit difference."""
    import numpy as np

    from repro_torch.serving.engine import TransformerExecutor

    kern = out["executor"]
    eager = TransformerExecutor(kern.params, kern.cfg, backend="eager")
    reqs = [r for r in out["requests"] if len(r.prompt) == 300]
    tokens = np.array([r.prompt for r in reqs])
    served = torch.tensor([r.output[0] for r in reqs], device=kern.device)
    lk, _ = kern.prefill(tokens, kern.make_cache(len(reqs), 316))
    le, _ = eager.prefill(tokens, eager.make_cache(len(reqs), 316))
    # bf16 through 38 layers: the attention's fp32 sums in another order
    # flip the last bf16 bit of some outputs, and that propagates
    tol = 1e-1
    lk, le = lk.float(), le.float()
    err = (lk - le).abs().max().item()
    first = lk.argmax(-1)
    gap = (le.max(-1).values - le.gather(1, first[:, None])[:, 0]).max().item()
    if not np.isfinite(err) or err > tol or not torch.equal(first, served) or gap > tol:
        raise AssertionError(f"zoo served token check: err {err}, served {served.tolist()}, "
                             f"kernel argmax {first.tolist()}, eager argmax "
                             f"{le.argmax(-1).tolist()} (gap {gap})")
    log("serve", f"{len(reqs)} x 300 tokens, 38 layers bf16: kernel vs eager prefill logits "
        f"max abs err {err:.3g}; first tokens {first.tolist()} == served")
    return err


def phase_dense_kernels(rec, torch, card):
    from repro_torch.kernels import ops
    from repro_torch.kernels.tiled_gemm import tiled_gemm, tiled_gemm_plain
    from repro_torch.launch.kernel_timing import time_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    # (m, k, n): the reference's test sweep, then one shape no tile divides
    shapes = [(128, 256, 128), (256, 512, 384), (512, 128, 256), (201, 333, 157)]
    for dtype in ("float32", "bfloat16", "float16"):
        tdt = getattr(torch, dtype)
        for m, k, n in shapes:
            x = torch.randn(m, k, generator=g, device=dev).to(tdt)
            w = (torch.randn(k, n, generator=g, device=dev) / k ** 0.5).to(tdt)
            # the reference's test tiles its sweep in 128-blocks; the odd
            # shape takes the default blocks, each clipped to its axis
            blocks = ({"block_m": 128, "block_n": 128, "block_k": 128}
                      if m % 128 == k % 128 == n % 128 == 0 else {})
            # bf16/fp16 with 16-byte rows on the tensor cores; fp32 and the
            # odd shape's 666-byte rows on the CUDA cores
            path = "simt" if dtype == "float32" or (m, k, n) == (201, 333, 157) else "wgmma"
            before = dict(tiled_gemm.paths)
            out = tiled_gemm(x, w, **blocks)
            plain = tiled_gemm_plain(x, w)
            torch.cuda.synchronize()
            diff = (out.float() - plain.float()).abs()
            lim = ATOL[dtype] + ULP[dtype] * plain.float().abs()
            err = diff.max().item()
            if out.shape != (m, n) or out.dtype != tdt or not bool((diff <= lim).all()):
                raise AssertionError(f"tiled_gemm ({m}x{k})@({k}x{n}) {dtype}: max abs err "
                                     f"{err} beyond {ATOL[dtype]} + {ULP[dtype]} |ref|")
            if tiled_gemm.paths[path] != before[path] + 1:
                raise AssertionError(f"tiled_gemm ({m}x{k})@({k}x{n}) {dtype}: not the {path} "
                                     f"path: {before} -> {tiled_gemm.paths}")
            rec["tiled_gemm"].err(err)
            log("kernels", f"tiled_gemm {dtype} ({m}x{k})@({k}x{n}) err={err:.3g} path={path}")

    # its path: the public op, once, at a served width
    m, k, n = 512, 5120, 13824
    x = (torch.randn(m, k, generator=g, device=dev)).to(torch.bfloat16)
    w = (torch.randn(k, n, generator=g, device=dev) / k ** 0.5).to(torch.bfloat16)
    ops.reset_launch_counts()
    out = ops.tiled_gemm(x, w)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if counts != {name: int(name == "tiled_gemm") for name in counts}:
        raise AssertionError(f"ops.tiled_gemm launches: {counts}")
    if ops.path_counts()["tiled_gemm"] != {"wgmma": 1, "simt": 0}:
        raise AssertionError(f"served width off the wgmma path: {ops.path_counts()}")
    rec["tiled_gemm"].d["launches"] = counts["tiled_gemm"]
    plain = tiled_gemm_plain(x, w)
    diff = (out.float() - plain.float()).abs()
    err = diff.max().item()
    if not bool((diff <= ATOL["bfloat16"] + ULP["bfloat16"] * plain.float().abs()).all()):
        raise AssertionError(f"tiled_gemm served width: max abs err {err}")
    rec["tiled_gemm"].err(err)
    ms = time_ms(lambda: tiled_gemm(x, w), iters=10)
    plain_ms = time_ms(lambda: tiled_gemm_plain(x, w), iters=5)
    lib_ms = time_ms(lambda: torch.matmul(x, w), iters=30)
    nbytes = 2 * (m * k + k * n + m * n)
    flops = 2.0 * m * k * n
    rec["tiled_gemm"].timed(ms, plain_ms, lib_ms, nbytes, flops, "bfloat16")
    bms, by = bound(nbytes, flops, "bfloat16")
    log("kernels", f"tiled_gemm bf16 ({m}x{k})@({k}x{n}) via ops.tiled_gemm: 1 launch, "
        f"path wgmma, err={err:.3g}; {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
        f"{plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    del x, w, out, plain

    # the flash kernel at a StableLM-12B prefill chunk: 256 queries at
    # offset 1024 over a gathered view of 97 pages of 16
    check_time_flash(rec, torch, g, "dense chunk", 1, 32, 8, 256, 1024 + 256, 160, 97 * 16)
    # the same chunk, and a 5-row verify chunk, at a device-held offset
    for sq, sk in ((256, 1024 + 256), (5, 1029)):
        check_flash_kv_len(torch, g, card, 1, 32, 8, sq, sk, 160, 97 * 16)


def check_flash_kv_len(torch, g, card, b, h, hkv, sq, sk, hd, view):
    """The flash kernel with ``kv_len`` = ``sk`` over the whole gathered
    view of ``view`` positions (a chunk at a device-held offset, as the
    captured zoo chunk runs it) against the call on the keys sliced to
    ``sk``: bitwise in fp32, bf16 and fp16, on the same path, one launch
    each; then both timed in bf16 (sliced, kv_len, kv_len, sliced)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.kernel_timing import time_ms

    dev = torch.device("cuda")
    kv_len = torch.full((b,), sk, dtype=torch.int32, device=dev)
    for dtype in ("float32", "bfloat16", "float16"):
        tdt = getattr(torch, dtype)
        q = torch.randn(b, sq, h, hd, generator=g, device=dev).to(tdt).transpose(1, 2)
        kc, vc = (torch.randn(b, view, hkv, hd, generator=g, device=dev).to(tdt)
                  .transpose(1, 2) for _ in range(2))
        before = dict(flash_attention.paths)
        out = flash_attention(q, kc, vc, causal=True, kv_len=kv_len)
        want = flash_attention(q, kc[:, :, :sk], vc[:, :, :sk], causal=True)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"flash_attention kv_len {sk} of {view} {dtype}: not bitwise "
                                 f"the sliced call, max diff "
                                 f"{(out.float() - want.float()).abs().max().item()}")
        check_path(flash_attention, before, expected_attention_path(dtype), 2,
                   f"flash_attention kv_len {dtype}")
        if dtype != "bfloat16":
            continue
        sliced = lambda: flash_attention(q, kc[:, :, :sk], vc[:, :, :sk], causal=True)
        lened = lambda: flash_attention(q, kc, vc, causal=True, kv_len=kv_len)
        ms = {"sliced": [time_ms(sliced, iters=20)], "kv_len": [time_ms(lened, iters=20)]}
        ms["kv_len"].append(time_ms(lened, iters=20))
        ms["sliced"].append(time_ms(sliced, iters=20))
    log("kernels", f"flash_attention q ({b},{h},{sq},{hd}) with kv_len {sk} over kv "
        f"({b},{hkv},{view},{hd}): bitwise the call on keys sliced to {sk} in fp32, bf16 "
        f"and fp16, each on its path; bf16 ms sliced {ms['sliced'][0]:.4f} / kv_len "
        f"{ms['kv_len'][0]:.4f} / kv_len {ms['kv_len'][1]:.4f} / sliced "
        f"{ms['sliced'][1]:.4f} ({card})")


def check_time_flash(rec, torch, g, what, b, h, hkv, sq, sk, hd, view):
    """The flash kernel at one served prefill shape: ``sq`` queries
    right-aligned to ``sk`` keys, ``h`` heads on ``hkv`` KV heads of dim
    ``hd``, as strided views of a (gathered page) view of ``view``
    positions: fp32, bf16 and fp16 against the plain version, each on its
    path, then timed (bf16) beside its plain version, SDPA and its bound,
    added to the kernel's record."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.launch.kernel_timing import time_ms, window_pairs

    dev = torch.device("cuda")
    off = sk - sq
    for dtype in ("float32", "bfloat16", "float16"):
        tdt = getattr(torch, dtype)
        q = torch.randn(b, sq, h, hd, generator=g, device=dev).to(tdt).transpose(1, 2)
        kc, vc = (torch.randn(b, view, hkv, hd, generator=g, device=dev).to(tdt)
                  for _ in range(2))
        k, v = kc[:, :sk].transpose(1, 2), vc[:, :sk].transpose(1, 2)
        before = dict(flash_attention.paths)
        out = flash_attention(q, k, v, causal=True)
        plain = flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = check_close("flash_attention", out, plain, dtype, what)
        apath = expected_attention_path(dtype)
        check_path(flash_attention, before, apath, 1, f"flash_attention {dtype}")
        log("kernels", f"flash_attention {dtype} q ({b},{h},{sq},{hd}) kv ({b},{hkv},{sk},{hd}) "
            f"causal, queries at {off}.. err={err:.3g} path={apath}")
        if dtype != "bfloat16":
            continue
        rec["flash_attention"].err(err)
        qp = torch.arange(off, sk, device=dev)
        mask = torch.arange(sk, device=dev)[None, :] <= qp[:, None]
        qc, kcc, vcc = (t.contiguous() for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        ms = time_ms(lambda: flash_attention(q, k, v, causal=True), iters=10)
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, causal=True), iters=10)
        lib_ms = time_ms(lambda: sdpa(qc, kcc, vcc, attn_mask=mask, enable_gqa=True), iters=10)
        nbytes = 2 * (2 * b * h * sq * hd + 2 * b * hkv * sk * hd)
        flops = 4.0 * window_pairs(sq, sk, 0) * hd * h * b
        rec["flash_attention"].timed(ms, plain_ms, lib_ms, nbytes, flops, dtype)
        bms, by = bound(nbytes, flops, dtype)
        log("kernels", f"flash_attention bf16 {what}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")


def spill_check(build) -> str:
    """ptxas reports 0 bytes spilled in every tensor-core instantiation of
    both attention kernels (bf16 and fp16 at each head-dim instance) and in
    every kernel of the scan (both paths, three dtypes) and of the
    connective (three dtypes, with and without dropout: the loop path and
    the two register-row instances).
    Raises if one spills or if a log lists another number of them."""
    from repro_torch.kernels.flash_attention import DENSE_HEAD_DIMS, RAGGED_HEAD_DIMS

    found = []
    for name, want, pick in (
            ("flash_attention", 2 * len(DENSE_HEAD_DIMS["mma"]), "mma_kernel"),
            ("ragged_flash_attention", 2 * len(RAGGED_HEAD_DIMS["mma"]), "mma_kernel"),
            ("rglru_scan", 6, "_kernel"), ("fused_connective", 18, "_kernel")):
        fns = {f: s for f, s in build.spills(build.build_log(name)).items() if pick in f}
        if len(fns) != want:
            raise AssertionError(f"{name}: ptxas reports {len(fns)} {pick} "
                                 f"instantiations, expected {want}")
        bad = {f: s for f, s in fns.items() if s != (0, 0)}
        if bad:
            raise AssertionError(f"{name}: spill (stores, loads) bytes in {bad}")
        found.append(f"{name} {len(fns)} x 0 bytes")
    return ", ".join(found)


def sass_check(torch) -> str:
    """Count the tensor-core instructions ``cuobjdump --dump-sass`` finds:
    HMMA (mma.sync) in tiled_gemm_valid and in both attention kernels,
    HGMMA (wgmma) in tiled_gemm.  Raises if any has none."""
    import shutil

    from repro_torch.kernels import build

    tool = shutil.which("cuobjdump") or str(Path(build.nvcc_path()).parent / "cuobjdump")
    found = {}
    for name, op in (("tiled_gemm_valid", "HMMA"), ("tiled_gemm", "HGMMA"),
                     ("flash_attention", "HMMA"), ("ragged_flash_attention", "HMMA")):
        sass = subprocess.run([tool, "--dump-sass", str(build._target(name))], check=True,
                              capture_output=True, text=True, timeout=120).stdout
        found[name] = (op, sum(f" {op}." in line for line in sass.splitlines()))
        if not found[name][1]:
            raise AssertionError(f"no {op} instruction in the SASS of {name}")
    return ", ".join(f"{name}: {n} {op}" for name, (op, n) in found.items())


def phase_dense_parity(torch):
    """StableLM-12B at full width, 4 layers, fp32: the paged protocol
    (one-shot, chunks of 64, a prefix-hit suffix, 8 decode steps of two
    slots) against the dense path, on both backends.  Returns the calls'
    inputs and the kernel backend's logits of each (on the host), which
    phase 36 holds the ranks to."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import apply_model
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import TransformerExecutor

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("stablelm-12b"), num_layers=4,
                              dtype="float32", param_dtype="float32")
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(7),
                         device=dev)
    s, page, chunk, shared, steps = 300, 16, 64, 256, 8
    s_pad = -(-s // page) * page
    width = (s_pad + steps + page - 1) // page + 1
    gen = torch.Generator(device=dev).manual_seed(9)
    a = torch.randint(0, cfg.vocab_size, (1, s_pad), device=dev, generator=gen)
    bt = torch.cat([a[:, :shared], torch.randint(0, cfg.vocab_size, (1, s_pad - shared),
                                                  device=dev, generator=gen)], 1)
    eager = TransformerExecutor(params, cfg, backend="eager")
    # the dense path: logits of every prompt row, and the decode reference
    dense = {}
    for name, t in (("a", a), ("b", bt)):
        dense[name], _ = apply_model(params, cfg, tokens=t[:, :s], mode="prefill",
                                     cache=eager.make_cache(1, s), backend="eager")
    lref, cref = eager.prefill(torch.cat([a[:, :s], bt[:, :s]]),
                               eager.make_cache(2, s + steps))
    tol = 1e-4  # fp32 through 4 layers: GEMMs of other row counts, and the
    # attention's sums, in another order

    def close(what, got, want):
        e = (got.float() - want.float()).abs().max().item()
        if not e <= tol:
            raise AssertionError(f"dense parity {what}: max abs err {e} > {tol}")
        return e

    errs = {}
    calls = {"a": a.cpu(), "b": bt.cpu(), "s": s, "page": page, "chunk": chunk,
             "shared": shared, "width": width, "tokens": [], "logits": []}
    for backend in ("kernel", "eager"):
        kept = calls["logits"] if backend == "kernel" else []
        ex = TransformerExecutor(params, cfg, backend=backend)
        pool = ex.make_pool(1 + 3 * width, page)
        rows = [list(range(1 + i * width, 1 + (i + 1) * width)) for i in range(3)]
        ops.reset_launch_counts()
        # one-shot prefill of a into rows[0]
        lo, pool = ex.prefill_paged(a, pool, rows[0], length=s)
        kept.append(lo.float().cpu())
        e = close(f"{backend} one-shot", lo, dense["a"][:, s - 1])
        # a again in chunks of 64 into rows[1]; every real row compared
        n_chunks = 0
        for off in range(0, s_pad, chunk):
            size = min(chunk, s_pad - off)
            lc, pool = ex.prefill_chunk(a[:, off:off + size], pool, rows[1], offset=off,
                                        length=s)
            kept.append(lc.float().cpu())
            real = min(size, s - off)
            e = max(e, close(f"{backend} chunk at {off}", lc[:, :real],
                             dense["a"][:, off:off + real]))
            n_chunks += 1
        # the chunked pages hold the one-shot pages' K/V
        for key, leaves in pool["groups"].items():
            for nm, leaf in leaves.items():
                e = max(e, close(f"{backend} {key}.{nm} pages", leaf[:, rows[1]],
                                 leaf[:, rows[0]]))
        # b shares a's first 16 pages: only its suffix is computed
        rows[2][:shared // page] = rows[0][:shared // page]
        lh, pool = ex.prefill_chunk(bt[:, shared:], pool, rows[2], offset=shared, length=s)
        kept.append(lh.float().cpu())
        e = max(e, close(f"{backend} prefix-hit suffix", lh[:, :s - shared],
                         dense["b"][:, shared:s]))
        counts = ops.launch_counts()
        want = 4 * (2 + n_chunks) if backend == "kernel" else 0
        if counts["flash_attention"] != want or sum(counts.values()) != want:
            raise AssertionError(f"dense parity {backend} prefill launches {counts}, "
                                 f"expected {want} flash")
        # 8 decode steps of the two slots (a one-shot, b prefix-hit)
        table = torch.tensor([rows[0], rows[2]], device=dev)
        lg, lr = torch.cat([lo, lh[:, s - shared - 1]]), lref
        cr = copy.deepcopy(cref)  # dense decode writes its cache in place
        de = close(f"{backend} decode inputs", lg, lr)
        for step in range(steps):
            tok = lr.argmax(-1)
            pos = torch.full((2,), s + step, device=dev)
            lg, pool = ex.decode_paged(tok[:, None], pool, table, pos)
            kept.append(lg.float().cpu())
            if backend == "kernel":
                calls["tokens"].append(tok.cpu())
            lr, cr = eager.decode(tok[:, None], cr, s + step)
            de = max(de, close(f"{backend} decode step {step}", lg, lr))
        if ops.launch_counts() != counts:
            raise AssertionError("a paged decode step launched a kernel")
        errs[backend] = (e, de)
    log("parity", f"StableLM-12B width, 4 layers fp32, {s}-token prompts, page {page}: "
        f"one-shot, {chunk}-token chunks and a {shared}-token prefix hit vs dense prefill "
        f"max abs err kernel {errs['kernel'][0]:.3g} / eager {errs['eager'][0]:.3g}; "
        f"{steps} paged decode steps vs dense decode kernel {errs['kernel'][1]:.3g} / "
        f"eager {errs['eager'][1]:.3g} (tolerance {tol})")
    return calls


def phase_dense_serve(torch, rec):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve

    torch.cuda.reset_peak_memory_stats()
    n_req, max_new, shared = 8, 16, 1024
    ops.reset_launch_counts()
    out = launch_serve.serve("stablelm-12b", executor_kind="zoo", requests=n_req,
                             prompt_len=(64, 512), shared_prefix=shared, max_new=max_new,
                             max_batch=4, page_size=16, prefix_cache=True,
                             prefill_chunk=256, device="cuda", dtype="bfloat16", seed=0)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    reqs, st = out["requests"], out["stats"]
    log("serve", out["plan"])
    if len(reqs) != n_req or any(len(r.output) != max_new for r in reqs):
        raise AssertionError(f"unfinished dense requests: {[len(r.output) for r in reqs]}")
    total = sum(len(r.prompt) for r in reqs)
    if st["prefix_hits"] < 1 or st["prefill_chunks"] < 1:
        raise AssertionError(f"dense serve took no prefix hit or no chunk: {st}")
    if st["prefill_tokens"] + st["cached_prefix_tokens"] != total:
        raise AssertionError(f"computed {st['prefill_tokens']} + cached "
                             f"{st['cached_prefix_tokens']} != {total} prompt tokens")
    out["pool"].check()
    layers = out["executor"].cfg.num_layers
    log("serve", f"flash_attention: {counts['flash_attention']} launches (expected "
        f"{layers} x ({st['prefill_oneshots']} one-shot + {st['prefill_chunks']} chunks)); "
        f"tiled_gemm: {counts['tiled_gemm']}")
    check_zoo_flash_counts(ops, rec, out, "dense serve")
    log("serve", f"{n_req} requests, prompts {[len(r.prompt) for r in reqs]} ({total} "
        f"tokens: {st['prefill_tokens']} computed, {st['cached_prefix_tokens']} cached in "
        f"{st['prefix_hits']} hits, peak {st['peak_shared_pages']} shared pages), "
        f"{out['new_tokens']} new tokens in {out['seconds']:.2f} s: "
        f"{out['tokens_per_s']:.1f} tok/s, TTFT p50 {1e3 * out['ttft_p50_s']:.1f} ms, "
        f"{st['decode_steps']} decode steps, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; prefix tree "
        f"{out['prefix_stats']}")
    return out


def measure_decode_gather(out, torch):
    """The page gather of a decode step (every slot's whole block-table
    row copied into a dense view, as the reference does) against the whole
    step, at the served pool's geometry: the gather's device time (events),
    the step's device time (profiler) and its wall time (host clock)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.kernel_timing import time_ms
    from repro_torch.serving.kvcache import cache_bytes

    ex, pool = out["executor"], out["pool"]
    dev = ex.device
    n, w, page = pool.num_slots, pool.pages_per_slot, pool.page_size
    storage = ex.make_pool(pool.num_pages, page)
    bt = torch.arange(1, 1 + n * w, device=dev).view(n, w)
    pos = torch.full((n,), w * page - 64, device=dev)
    tok = torch.zeros((n, 1), dtype=torch.long, device=dev)
    gather_ms = time_ms(lambda: ex.gather_pages(storage, bt), iters=10)
    gathered = cache_bytes(ex.cfg, n, w * page)  # the dense view it writes
    for _ in range(2):
        ex.decode_paged(tok, storage, bt, pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex.decode_paged(tok, storage, bt, pos)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ex.decode_paged(tok, storage, bt, pos)
        torch.cuda.synchronize()
    busy_ms = sum(e.device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    log("serve", f"decode step of {n} slots x {w} pages of {page}: page gather "
        f"{gather_ms:.4f} ms on the device ({gathered / 1e9:.2f} GB copied), step "
        f"{busy_ms:.2f} ms device busy, {wall_ms:.2f} ms wall: the gather is "
        f"{100 * gather_ms / busy_ms:.1f} % of the step's device time and "
        f"{100 * gather_ms / wall_ms:.1f} % of its wall time")


def check_dense_served_token(out, torch):
    """The last request (admitted after the system prompt entered the
    tree, so a prefix hit) against a dense eager prefill of its whole
    prompt at full depth in bf16: its served first token is that
    prefill's argmax up to the bf16 disagreement."""
    from repro_torch.serving.engine import TransformerExecutor

    kern = out["executor"]
    eager = TransformerExecutor(kern.params, kern.cfg, backend="eager")
    req = out["requests"][-1]
    s = len(req.prompt)
    le, _ = eager.prefill([req.prompt], eager.make_cache(1, s))
    le = le.float()[0]
    gap = (le.max() - le[req.output[0]]).item()
    tol = 1e-1  # bf16 through 40 layers, chunked and paged vs one dense pass
    if not torch.isfinite(le).all() or gap > tol:
        raise AssertionError(f"dense served token {req.output[0]}: eager argmax "
                             f"{int(le.argmax())}, gap {gap}")
    log("serve", f"request {req.uid} ({s} tokens, {kern.cfg.num_layers} layers "
        f"{kern.cfg.dtype}): served first token "
        f"{req.output[0]}, dense eager argmax {int(le.argmax())} (logit gap {gap:.3g})")


# --- the rest of Galaxy serving: chunks at an offset, prefix cache, speculative
# decoding, waves and the baselines ----------------------------------------------

# fp16 logits of GPT2-L through 36 layers: kernel vs eager disagree by up to
# this much (check_served_token), so a top-2 gap below it is a near-tie
GALAXY_FP16_TOL = 5e-2


class CallLog:
    """The distinct calls the three Galaxy kernels and the dense flash
    kernel took while the phases inside ``with`` ran: recorded at
    ``kernels/ops.py``, where every launch passes, as kernel arguments
    (shapes, valid counts, positions; the flash kernel's strides, dtype and
    masks, which ``ops.CALLS`` keeps), so each can be replayed on fresh
    inputs against its plain version."""

    def __init__(self):
        self.gemm, self.attn, self.conn, self.flash = set(), set(), set(), set()

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.kernels.tiled_gemm import _resolve

        self._ops = ops
        ops.reset_call_log()
        self._orig = (ops.tiled_gemm_valid, ops.ragged_flash_attention,
                      ops.fused_connective_group)
        gemm, attn, conn = self._orig

        def log_gemm(x, w, **kw):
            m, k = x.shape
            n = w.shape[1]
            seg_m, seg_n, vm, vn, vk = _resolve(m, n, k, kw.get("valid_m"), kw.get("valid_n"),
                                                kw.get("valid_k"), kw.get("seg_m"),
                                                kw.get("seg_n"))
            self.gemm.add((m, n, k, vm, vn, vk, seg_m, seg_n))
            return gemm(x, w, **kw)

        def log_attn(q, k, v, *, positions, valid_heads=None):
            pos = tuple(int(t) for t in positions)
            self.attn.add((tuple(q.shape), k.shape[1], pos,
                           q.shape[1] if valid_heads is None else int(valid_heads)))
            return attn(q, k, v, positions=positions, valid_heads=valid_heads)

        def log_conn(xs, ress, keeps, scales, biases, **kw):
            self.conn.add(tuple(tuple(x.shape) for x in xs))
            return conn(xs, ress, keeps, scales, biases, **kw)

        ops.tiled_gemm_valid, ops.ragged_flash_attention = log_gemm, log_attn
        ops.fused_connective_group = log_conn
        return self

    def __exit__(self, *exc):
        ops = self._ops
        ops.tiled_gemm_valid, ops.ragged_flash_attention, ops.fused_connective_group = self._orig
        self.flash = set(ops.CALLS["flash_attention"])
        return False


def check_logged_calls(calls, rec, torch, card):
    """Replay every distinct Galaxy kernel call of the new phases on fresh
    inputs, with garbage in every pad region, in fp32, fp16 and bf16:
    each against its plain version (pad outputs exact zeros, the GEMM's
    live-tile count against ``dense_block_count``), on its expected path.
    Tolerances are phase 2's, except that the valid GEMM in bf16 is held
    to ATOL plus one bf16 unit of the output: the replay reaches outputs
    of 2-4, where one unit (0.0156) exceeds ATOL and both sides round one
    fp32 result.  Prints the split plan of the shapes no earlier path
    launched."""
    from repro_torch.kernels.build import sm_count
    from repro_torch.kernels.flash_attention import (
        ragged_flash_attention, ragged_flash_attention_plain)
    from repro_torch.kernels.fused_connective import (
        fused_connective_group, fused_connective_group_plain)
    from repro_torch.kernels.tiled_gemm import (
        dense_block_count, plan_valid_gemm, tiled_gemm_valid, tiled_gemm_valid_plain)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    junk = 1e3
    sms = sm_count(dev)
    errs = {name: {} for name in GALAXY_KERNELS}
    for (m, n, k, vm, vn, vk, seg_m, seg_n) in sorted(calls.gemm):
        p = plan_valid_gemm(m, n, k, seg_m=seg_m, seg_n=seg_n, valid_m=vm, valid_n=vn,
                            valid_k=vk, sm_count=sms)
        if (m == seg_m and m <= 2) or 768 in (n, k) or m == seg_m == 256:
            log("kernels", f"tiled_gemm_valid plan ({m}x{k})@({k}x{n}) seg_m={seg_m} "
                f"valid=({vm},{vn},{vk}): {p.live_tiles} live tiles of "
                f"{p.m_tiles * p.n_tiles} x {p.splits} K slices of {p.steps_per_split} steps")
        rows = (torch.arange(m, device=dev) % seg_m) < vm
        cols = (torch.arange(n, device=dev) % seg_n) < vn
        kk = torch.arange(k, device=dev) < vk
        x0 = torch.randn(m, k, generator=g, device=dev)
        w0 = torch.randn(k, n, generator=g, device=dev) / k ** 0.5
        for dtype in ("float32", "float16", "bfloat16"):
            x = torch.where(rows[:, None] & kk[None, :], x0, junk).to(getattr(torch, dtype))
            w = torch.where(kk[:, None] & cols[None, :], w0, -junk).to(getattr(torch, dtype))
            kw = dict(valid_m=vm, valid_n=vn, valid_k=vk, seg_m=seg_m, seg_n=seg_n)
            before = dict(tiled_gemm_valid.paths)
            out, cnt = tiled_gemm_valid(x, w, count_blocks=True, **kw)
            plain = tiled_gemm_valid_plain(x, w, **kw)
            torch.cuda.synchronize()
            what = f"({m}x{k})@({k}x{n}) seg_m={seg_m} valid=({vm},{vn},{vk})"
            e = check_close("tiled_gemm_valid", out, plain, dtype, what,
                            ulp=dtype == "bfloat16")
            if out[~rows].any() or out[:, ~cols].any():
                raise AssertionError(f"tiled_gemm_valid {what} {dtype}: pad outputs not zero")
            if int(cnt) != dense_block_count(m, n, k, **kw):
                raise AssertionError(f"tiled_gemm_valid {what}: live tiles {int(cnt)}")
            check_path(tiled_gemm_valid, before, "fma" if dtype == "float32" else "mma", 1,
                       f"tiled_gemm_valid {what} {dtype}")
            errs["tiled_gemm_valid"][dtype] = max(errs["tiled_gemm_valid"].get(dtype, 0.0), e)
    for (qshape, hkv, pos, vh) in sorted(calls.attn):
        b, h, s, hd = qshape
        valid = torch.as_tensor([t >= 0 for t in pos], device=dev)
        for dtype in ("float32", "float16", "bfloat16"):
            tdt = getattr(torch, dtype)
            q = torch.randn(b, h, s, hd, generator=g, device=dev)
            kv = [torch.randn(b, hkv, s, hd, generator=g, device=dev) for _ in range(2)]
            q[:, :, ~valid] = junk
            q[:, vh:] = -junk
            for t in kv:
                t[:, :, ~valid] = junk
            q, k, v = q.to(tdt), kv[0].to(tdt), kv[1].to(tdt)
            before = dict(ragged_flash_attention.paths)
            out = ragged_flash_attention(q, k, v, positions=pos, valid_heads=vh)
            plain = ragged_flash_attention_plain(q, k, v, positions=pos, valid_heads=vh)
            torch.cuda.synchronize()
            what = f"{qshape} kv {hkv} valid_heads {vh}"
            e = check_close("ragged_flash_attention", out, plain, dtype, what)
            if out[:, :, ~valid].any() or out[:, vh:].any():
                raise AssertionError(f"ragged_flash_attention {what} {dtype}: pads not zero")
            check_path(ragged_flash_attention, before, expected_attention_path(dtype), 1,
                       f"ragged_flash_attention {what} {dtype}")
            errs["ragged_flash_attention"][dtype] = max(
                errs["ragged_flash_attention"].get(dtype, 0.0), e)
    for shapes in sorted(calls.conn):
        d = shapes[0][-1]
        for dtype in ("float32", "float16", "bfloat16"):
            tdt = getattr(torch, dtype)
            xs = [torch.randn(sh, generator=g, device=dev).to(tdt) for sh in shapes]
            ress = [torch.randn(sh, generator=g, device=dev).to(tdt) for sh in shapes]
            scales = [(1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(tdt)
                      for _ in shapes]
            biases = [(0.1 * torch.randn(d, generator=g, device=dev)).to(tdt) for _ in shapes]
            before = dict(fused_connective_group.paths)
            outs = fused_connective_group(xs, ress, None, scales, biases)
            plain = fused_connective_group_plain(xs, ress, None, scales, biases)
            torch.cuda.synchronize()
            e = max(check_close("fused_connective", o, q, dtype, f"site {shapes} shard {i}",
                                ulp=dtype == "bfloat16")
                    for i, (o, q) in enumerate(zip(outs, plain)))
            check_path(fused_connective_group, before, "warp", 1,
                       f"fused_connective {shapes} {dtype}")
            errs["fused_connective"][dtype] = max(errs["fused_connective"].get(dtype, 0.0), e)
    for name in GALAXY_KERNELS:
        rec[name].err(errs[name].get("float16", 0.0))
    log("kernels", f"new Galaxy phases' calls replayed against the plain versions in fp32, "
        f"fp16 and bf16: {len(calls.gemm)} distinct tiled_gemm_valid shapes, "
        f"{len(calls.attn)} ragged_flash_attention, {len(calls.conn)} fused_connective sites; "
        f"max abs err {errs}; every launch on its path ({card})")
    check_logged_flash(calls, rec, torch, card, g)


def strided_randn(shape, stride, dtype, g, torch):
    """Fresh N(0, 1) values in the memory layout ``shape``/``stride`` (a
    view of a buffer just large enough to hold it)."""
    extent = 1 + sum((n - 1) * st for n, st in zip(shape, stride))
    base = torch.randn(extent, generator=g, device="cuda").to(getattr(torch, dtype))
    return base.as_strided(shape, stride)


def check_logged_flash(calls, rec, torch, card, g):
    """Replay every distinct dense flash-attention call of the logged
    phases (the traced qwen1.5-0.5b serve: hd 64, 256-query chunks right-
    aligned to their keys) on fresh inputs in the served layout, in its
    served dtype and the other two, against ``flash_attention_plain`` on
    its expected path.  The served dtype's error goes into the kernel's
    record."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    if not calls.flash:
        raise AssertionError("no flash_attention call was logged")
    errs, served = {}, set()
    for (qs, qst, ks, kst, vst, sdt, causal, window, has_len) in sorted(calls.flash):
        served.add(sdt)
        # a chunk at a device offset: each batch entry's key count drawn in
        # [Sq, Sk], as a served chunk's offset + S falls
        kv_len = (torch.randint(qs[2], ks[2] + 1, (qs[0],), generator=g, device="cuda",
                                dtype=torch.int32) if has_len else None)
        for dtype in ("float32", "float16", "bfloat16"):
            q = strided_randn(qs, qst, dtype, g, torch)
            k = strided_randn(ks, kst, dtype, g, torch)
            v = strided_randn(ks, vst, dtype, g, torch)
            before = dict(flash_attention.paths)
            out = flash_attention(q, k, v, causal=causal, window=window, kv_len=kv_len)
            plain = flash_attention_plain(q, k, v, causal=causal, window=window,
                                          kv_len=kv_len)
            torch.cuda.synchronize()
            what = (f"q {qs} kv {ks} causal {causal} window {window}"
                    + ("" if kv_len is None else f" kv_len {kv_len.tolist()}"))
            e = check_close("flash_attention", out, plain, dtype, what)
            check_path(flash_attention, before, expected_attention_path(dtype), 1,
                       f"flash_attention {what} {dtype}")
            errs[dtype] = max(errs.get(dtype, 0.0), e)
    for dtype in served:
        rec["flash_attention"].err(errs[dtype])
    shapes = sorted({(qs, ks, rest[-1]) for (qs, _, ks, *rest) in calls.flash})
    log("kernels", f"logged flash_attention calls replayed against flash_attention_plain in "
        f"fp32, fp16 and bf16: {len(calls.flash)} distinct calls (served in "
        f"{sorted(served)}), q/kv shapes and kv_len given {shapes}; max abs err {errs}; "
        f"every launch on its "
        f"path ({card})")


def galaxy_executor(torch, dtype, seed=0, model="gpt2-l", capacities=(3, 2, 2, 1)):
    """GPT2-L at full width and depth on the 3:2:2:1 plan (kernel backend),
    random weights from ``seed``, as ``launch.serve`` builds it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_executor, build_plan

    cfg = get_config(model)
    return build_executor(cfg, build_plan(cfg, capacities), device=torch.device("cuda"),
                          dtype=getattr(torch, dtype), seed=seed)


def one_shot_rows(ex, tokens, pool, row, torch):
    """Every row's logits of a one-shot paged prefill (the executor's
    ``prefill_paged`` returns the last real row only)."""
    from repro_torch.core import hmp

    t = ex._tensor(tokens)
    layout, x = ex._embed(t)
    y, pool = hmp.hmp_prefill(ex.layers, x, ex.ring, pool, plan=ex.plan, overlap=True,
                              seq=t.shape[1], block_row=ex._tensor(row))
    return layout.gather(y) @ ex.embed.T, pool


def phase_chunk_parity(torch, card):
    """GPT2-L at full depth in fp32 (TF32 off): one request of a 256-token
    prefix and 200 own tokens, prefilled in 128-token chunks at offsets 0,
    128, 256 and 384, against one one-shot prefill of the whole prompt:
    every chunk row's logits, the last row's, and the pages written at
    every valid position and head slot."""
    ex = galaxy_executor(torch, "float32", seed=3)
    s, page, chunk, tol = 456, 16, 128, 1e-3
    tokens = torch.randint(0, ex.embed.shape[0], (1, s), device=ex.device,
                           generator=torch.Generator(device=ex.device).manual_seed(4))
    n_pages = -(-s // page)
    row = torch.arange(1, 1 + n_pages, device=ex.device)
    one = ex.make_pool(1 + n_pages, page)
    ref, one = one_shot_rows(ex, tokens, one, row, torch)
    pool = ex.make_pool(1 + n_pages, page)
    row_err = 0.0
    for off in range(0, s, chunk):
        n = min(chunk, s - off)
        logits, pool = ex.prefill_chunk(tokens[:, off:off + n], pool, row, offset=off,
                                        length=s)
        row_err = max(row_err, (logits - ref[:, off:off + n]).abs().max().item())
        last = logits[0, -1]
    torch.cuda.synchronize()
    last_err = (last - ref[0, -1]).abs().max().item()
    page_err = 0.0
    for a, b in zip(one, pool):
        for kind in ("k", "v"):
            for i, (x, y) in enumerate(zip(a[kind], b[kind])):
                h = ex.plan.heads[i]
                xv = x[1:1 + n_pages, :, :h].reshape(-1, h, x.shape[-1])[:s]
                yv = y[1:1 + n_pages, :, :h].reshape(-1, h, y.shape[-1])[:s]
                page_err = max(page_err, (xv - yv).abs().max().item())
    if not (row_err <= tol and last_err <= tol and page_err <= tol):
        raise AssertionError(f"chunked vs one-shot prefill: rows {row_err}, last row "
                             f"{last_err}, pages {page_err} (tolerance {tol})")
    log("parity", f"GPT2-L 36 layers fp32, {s} tokens in chunks of {chunk} at offsets "
        f"{list(range(0, s, chunk))} vs one one-shot prefill: every row's logits max abs "
        f"err {row_err:.3g}, last row {last_err:.3g}, pages {page_err:.3g} (tolerance "
        f"{tol}; {card})")


def galaxy_expect(st, layers=36, devices=4, draft=None, draft_layers=6, held=None):
    """Exact launches of the three Galaxy kernels from a serve's stats: a
    one-shot prefill or a chunk runs 4 ring GEMMs x D steps x D devices a
    layer and 2 connective sites; the one-shot (and a wave prefill) also D
    attention launches a layer (a chunk's context attention is torch ops);
    a decode step 4 GEMMs a device a layer.  The one-device draft: 4 GEMMs
    a layer per prefill and per step, 1 attention and 2 sites a layer per
    prefill.  ``held`` devices of the D (default all: a ``LocalRing``; 1 on
    a rank of a ``ProcessRing``) launch their own GEMMs and attention, and
    each site is still one connective launch."""
    held = devices if held is None else held
    oneshots = st["prefill_oneshots"] + st["prefill_waves"]
    chunks = st["prefill_chunks"] + st["spec_steps"]
    decodes = st["decode_steps"] - st["spec_steps"]
    ring = 4 * devices * held * layers
    expect = {"tiled_gemm_valid": ring * (oneshots + chunks) + 4 * held * layers * decodes,
              "ragged_flash_attention": held * layers * oneshots,
              "fused_connective": 2 * layers * (oneshots + chunks)}
    if draft is not None:
        expect["tiled_gemm_valid"] += 4 * draft_layers * (draft.prefills + draft.steps)
        expect["ragged_flash_attention"] += draft_layers * draft.prefills
        expect["fused_connective"] += 2 * draft_layers * draft.prefills
    return expect


def check_galaxy_counts(ops, rec, st, what, draft=None):
    """The serve's launch counts equal ``galaxy_expect``; no other kernel
    launched.  The counts add to the kernels' records."""
    counts = ops.launch_counts()
    expect = dict.fromkeys(counts, 0)
    expect.update(galaxy_expect(st, draft=draft))
    if counts != expect:
        raise AssertionError(f"{what}: launch counts {counts} != {expect}")
    for name in GALAXY_KERNELS:
        rec[name].d["launches"] += counts[name]
    log("serve", f"{what}: launches {', '.join(f'{n} {counts[n]}' for n in GALAXY_KERNELS)} "
        f"(as expected from {st['prefill_oneshots']} one-shot, {st['prefill_chunks']} chunk, "
        f"{st['prefill_waves']} wave prefills, {st['spec_steps']} verify chunks, "
        f"{st['decode_steps'] - st['spec_steps']} decode steps"
        + ("" if draft is None else f"; draft {draft.prefills} prefills, {draft.steps} steps")
        + ")")


def serve_line(out, torch, card):
    return (f"{out['new_tokens']} new tokens in {out['seconds']:.2f} s: "
            f"{out['tokens_per_s']:.1f} tok/s, TTFT p50 {1e3 * out['ttft_p50_s']:.1f} ms, "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")


def phase_prefix_serve(torch, rec, card):
    """GPT2-L fp16 on the Galaxy executor with the prefix cache and
    128-token chunks: 8 requests behind one shared 256-token system prompt."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve

    torch.cuda.reset_peak_memory_stats()
    n_req, max_new = 8, 16
    ops.reset_launch_counts()
    out = launch_serve.serve("gpt2-l", (3, 2, 2, 1), requests=n_req, prompt_len=(37, 300),
                             shared_prefix=256, max_new=max_new, max_batch=4, page_size=16,
                             prefix_cache=True, prefill_chunk=128, device="cuda",
                             dtype="float16", seed=0)
    torch.cuda.synchronize()
    reqs, st = out["requests"], out["stats"]
    if len(reqs) != n_req or any(len(r.output) != max_new for r in reqs):
        raise AssertionError(f"unfinished requests: {[len(r.output) for r in reqs]}")
    total = sum(len(r.prompt) for r in reqs)
    if st["prefix_hits"] < 1 or st["peak_shared_pages"] < 1 or st["prefill_chunks"] < 1:
        raise AssertionError(f"Galaxy prefix serve took no hit, shared no page or ran no "
                             f"chunk: {st}")
    if st["prefill_tokens"] + st["cached_prefix_tokens"] != total:
        raise AssertionError(f"computed {st['prefill_tokens']} + cached "
                             f"{st['cached_prefix_tokens']} != {total} prompt tokens")
    out["pool"].check()
    check_galaxy_counts(ops, rec, st, "Galaxy prefix-cache + chunk serve")
    log("serve", f"Galaxy prefix cache + chunks of 128, {n_req} requests, prompts "
        f"{[len(r.prompt) for r in reqs]} ({total} tokens: {st['prefill_tokens']} computed, "
        f"{st['cached_prefix_tokens']} cached in {st['prefix_hits']} hits, peak "
        f"{st['peak_shared_pages']} shared pages, {st['prefill_chunks']} chunks), "
        + serve_line(out, torch, card))
    check_served_token(out, torch, index=-1, exact=False)
    return out


def tie_gap(ex, prompt, prefix, torch):
    """Top-2 logit gap of a kernel-backend one-shot prefill of ``prompt +
    prefix`` at its last row (the step where two runs' tokens parted)."""
    import numpy as np

    toks = list(prompt) + list(prefix)
    s_pad = -(-len(toks) // 16) * 16
    t = np.zeros((1, s_pad), np.int64)
    t[0, :len(toks)] = toks
    pool = ex.make_pool(1 + s_pad // 16, 16)
    logits, _ = ex.prefill_paged(t, pool, list(range(1, 1 + s_pad // 16)), length=len(toks))
    top = logits.float()[0].topk(2).values
    return (top[0] - top[1]).item()


def wave_tie_gap(ex, prompt, prefix, torch):
    """``tie_gap`` for an executor of the wave protocol: a one-row prefill
    of ``prompt + prefix``."""
    toks = [list(prompt) + list(prefix)]
    logits, _ = ex.prefill(toks, ex.make_cache(1, len(toks[0])))
    top = logits.float()[0].topk(2).values
    return (top[0] - top[1]).item()


def compare_tokens(a, b, ex, torch, what, exact, gap_fn=tie_gap, tol=GALAXY_FP16_TOL):
    """Greedy tokens of two runs of the same requests: equal, or (``exact``
    False) parted at a step whose top-2 logit gap (``gap_fn``) is below
    ``tol``, the fp16 logit tolerance by default: each such case is
    printed."""
    for ra, rb in zip(a, b):
        if ra.output == rb.output:
            continue
        j = next(i for i, (x, y) in enumerate(zip(ra.output, rb.output)) if x != y)
        if exact:
            raise AssertionError(f"{what}: request {ra.uid} tokens differ at {j}: "
                                 f"{ra.output} vs {rb.output}")
        gap = gap_fn(ex, ra.prompt, ra.output[:j], torch)
        if not gap < tol:
            raise AssertionError(f"{what}: request {ra.uid} parted at token {j} "
                                 f"({ra.output[j]} vs {rb.output[j]}) with a top-2 gap "
                                 f"{gap} >= {tol}")
        log("serve", f"{what}: request {ra.uid} parted at token {j} ({ra.output[j]} vs "
            f"{rb.output[j]}), a near-tie: top-2 logit gap {gap:.3g} < {tol}")


def phase_spec_serve(torch, rec, card):
    """Speculative decoding on the Galaxy executor: GPT2-L on 3:2:2:1
    verifies a DistilBERT-shaped draft (Table IV: 6 layers, d 768, 12
    heads, d_ff 3072, vocab 50304) on a one-device plan placed by
    ``place_draft``, k 4, 4 requests of 37-300 tokens, 16 new, greedy; in
    fp32 and fp16, each against the same serve with speculation off."""
    import repro_torch.serving.engine as engine_mod
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve

    orig = engine_mod.run_spec_round
    rounds = [0]

    def checked(engine, spec, slots, live, pool, storage):
        out = orig(engine, spec, slots, live, pool, storage)
        pool.check()
        spec.pool.check()
        rounds[0] += 1
        return out

    kw = dict(requests=4, prompt_len=(37, 300), max_new=16, max_batch=4, page_size=16,
              device="cuda", seed=0)
    fp16 = {}
    for dtype in ("float32", "float16"):
        ex = galaxy_executor(torch, dtype)
        draft = launch_serve.build_draft("galaxy", "distilbert", device=ex.device,
                                         dtype=dtype, seed=2)
        where = launch_serve.draft_placement("galaxy", (3, 2, 2, 1))
        ops.reset_launch_counts()
        plain = launch_serve.serve("gpt2-l", (3, 2, 2, 1), executor=ex, dtype=dtype, **kw)
        torch.cuda.synchronize()
        check_galaxy_counts(ops, rec, plain["stats"], f"spec off {dtype}")
        rounds[0] = 0
        engine_mod.run_spec_round = checked
        try:
            ops.reset_launch_counts()
            spec = launch_serve.serve("gpt2-l", (3, 2, 2, 1), executor=ex, dtype=dtype,
                                      draft_executor=draft, spec_k=4, **kw)
            torch.cuda.synchronize()
        finally:
            engine_mod.run_spec_round = orig
        st = spec["stats"]
        check_galaxy_counts(ops, rec, st, f"spec on {dtype}",
                            draft=spec["spec"])
        if st["spec_steps"] < 1 or rounds[0] < 1:
            raise AssertionError(f"no speculative round ran: {st}")
        compare_tokens(plain["requests"], spec["requests"], ex, torch,
                       f"spec on vs off {dtype}", exact=dtype == "float32")
        log("serve", f"speculative {dtype}: draft distilbert on cluster device {where} "
            f"(place_draft), k 4: {rounds[0]} rounds ({st['spec_steps']} verify chunks), "
            f"pool.check() on both pools after every round; acceptance "
            f"{st['spec_acceptance']:.3f}, accepted per round {st['spec_accept_counts']}; "
            f"spec off {plain['tokens_per_s']:.1f} tok/s, spec on "
            f"{spec['tokens_per_s']:.1f} tok/s ({card}; random weights: no claim)")
        if dtype == "float16":
            fp16 = {"executor": ex, "plain": plain, "spec": spec["requests"], "draft": draft,
                    "spec_stats": st, "kw": kw}
        del draft, spec
    return fp16


def phase_wave_serve(torch, rec, card, fp16):
    """The Galaxy wave protocol: the spec-off fp16 serve's 4 requests again
    with ``scheduler="wave"``, tokens equal under the tie rule."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve

    ex, plain = fp16["executor"], fp16["plain"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = launch_serve.serve("gpt2-l", (3, 2, 2, 1), executor=ex, requests=4,
                             prompt_len=(37, 300), max_new=16, max_batch=4,
                             scheduler="wave", device="cuda", dtype="float16", seed=0)
    torch.cuda.synchronize()
    st = out["stats"]
    if st["prefill_waves"] < 1 or any(len(r.output) != 16 for r in out["requests"]):
        raise AssertionError(f"wave serve: {st}")
    check_galaxy_counts(ops, rec, st, "Galaxy wave serve")
    if ops.launch_counts()["ragged_flash_attention"] != 36 * 4 * st["prefill_waves"]:
        raise AssertionError("wave serve: attention launches are not 36 x 4 x waves")
    compare_tokens(plain["requests"], out["requests"], ex, torch, "wave vs continuous fp16",
                   exact=False)
    log("serve", f"Galaxy waves fp16: {st['prefill_waves']} waves, ragged_flash_attention "
        f"36 x 4 x {st['prefill_waves']}; " + serve_line(out, torch, card))
    return out


def phase_schedules(torch, rec, card):
    """One GPT2-L layer at S 256 in fp16 through the four schedules (hmp,
    hmp_ring and megatron on the 3:2:2:1 plan's kernel backend, sp on the
    even plan) against the eager ``reference_layer`` in fp32 of the same
    weights; each one's per-layer times (shard compute on one card: the
    wire is not timed): device busy (``torch.profiler``, the sum of its
    kernels), events behind a device sleep, and the host's wall time of
    one synchronized call.  Where the host's issue is the longer, the
    event time is the host's too."""
    from repro_torch.configs import get_config
    from repro_torch.core import hmp
    from repro_torch.core.execplan import ExecPlan
    from repro_torch.core.ring import LocalRing
    from repro_torch.kernels import ops
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.kernel_timing import time_ms
    from repro_torch.launch.serve import build_plan

    dev = torch.device("cuda")
    cfg = get_config("gpt2-l")
    plan = build_plan(cfg, (3, 2, 2, 1))
    even = ExecPlan.even(4, num_heads=cfg.num_heads, d_ff=cfg.d_ff, head_dim=cfg.head_dim,
                         d_model=cfg.d_model).with_backend("kernel")
    gen = torch.Generator(device=dev).manual_seed(11)
    p = hmp.init_layer_params(cfg.d_model, cfg.num_heads, cfg.d_ff, generator=gen,
                              dtype=torch.float16)
    s, ring = 256, LocalRing(4)
    x = torch.randn(1, s, cfg.d_model, generator=gen, device=dev).to(torch.float16)
    ref = hmp.reference_layer({k: v.float() for k, v in p.items()}, x.float())
    lay = plan.seq_layout(s)
    shards = hmp.shard_layer_params(plan, p)
    runs = {
        "hmp": lambda: lay.gather(hmp.SCHEDULES["hmp"](shards, lay.scatter(x), ring,
                                                       plan=plan, seq=s)),
        "hmp_ring": lambda: lay.gather(hmp.SCHEDULES["hmp_ring"](
            shards, lay.scatter(x), ring, plan=plan, seq=s)),
        "megatron": lambda: hmp.SCHEDULES["megatron"](shards, x, ring, plan=plan),
        "sp": lambda: hmp.SCHEDULES["sp"](p, x, ring, plan=even),
    }
    res = []
    for name, fn in runs.items():
        ops.reset_launch_counts()
        y = fn()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        for k in GALAXY_KERNELS:
            rec[k].d["launches"] += counts[k]
        err = (y.float() - ref).abs().max().item()
        if not (torch.isfinite(y).all() and err <= GALAXY_FP16_TOL):
            raise AssertionError(f"schedule {name}: max abs err {err} vs reference_layer")
        ms = time_ms(fn, iters=5)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        busy = sum(e.device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        res.append(f"{name}: device busy {busy:.3f} ms, events {ms:.3f} ms, host wall "
                   f"{wall:.3f} ms (err {err:.3g}; "
                   + ", ".join(f"{k} {counts[k]}" for k in GALAXY_KERNELS) + ")")
    log("parity", f"one GPT2-L layer, S {s}, fp16, vs reference_layer in fp32 (tolerance "
        f"{GALAXY_FP16_TOL}), shard compute only: {'; '.join(res)} ({card})")


def check_galaxy_paths(ops, what):
    """Every Galaxy kernel launch since the last reset on its fast path:
    GEMMs and attention on the tensor cores, connectives in registers."""
    counts, paths = ops.launch_counts(), ops.path_counts()
    want = {"tiled_gemm_valid": {"mma": counts["tiled_gemm_valid"], "fma": 0},
            "ragged_flash_attention": {"mma": counts["ragged_flash_attention"], "simt": 0},
            "fused_connective": {"warp": counts["fused_connective"], "loop": 0}}
    for name, p in want.items():
        if paths[name] != p:
            raise AssertionError(f"{what}: {name} off its fast path: {paths[name]}")


def span_coverage(tracer, reqs):
    """Per request: the share of its submit-to-retire extent that its
    phase spans cover."""
    obj = tracer.to_json()
    names = {e["tid"]: e["args"]["name"] for e in obj["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    tids = {n: t for t, n in names.items()}
    spans = [e for e in obj["traceEvents"] if e["ph"] == "X"]
    cov = {}
    for r in reqs:
        track = [e for e in spans if e["tid"] == tids[f"req {r.uid}"]]
        lo = min(e["ts"] for e in track)
        hi = max(e["ts"] + e["dur"] for e in track)
        cov[r.uid] = sum(e["dur"] for e in track) / (hi - lo) if hi > lo else 1.0
    return cov


def check_drift(drift, kinds, what):
    """Drift records of each of ``kinds``, every ratio finite and > 0;
    returns the p50 ratio per kind."""
    import math

    got = {r["kind"] for r in drift.records}
    if not set(kinds) <= got:
        raise AssertionError(f"{what}: drift records of {sorted(got)}, not {kinds}")
    bad = [r for r in drift.records if not (math.isfinite(r["ratio"]) and r["ratio"] > 0)]
    if bad:
        raise AssertionError(f"{what}: drift ratios not finite and positive: {bad[:3]}")
    return {k: s["p50"] for k, s in drift.summary().items()}


def check_zoo_flash_counts(ops, rec, out, what):
    """A paged zoo serve launched the flash kernel exactly once a layer per
    prefill call (one-shot or chunk), every launch on the tensor cores, and
    no other kernel.  The count adds to the kernel's record (with ``rec``
    None, the caller adds the returned count once its calls are checked)."""
    counts, st = ops.launch_counts(), out["stats"]
    expect = dict.fromkeys(counts, 0)
    expect["flash_attention"] = out["executor"].cfg.num_layers * (
        st["prefill_oneshots"] + st["prefill_chunks"])
    if counts != expect:
        raise AssertionError(f"{what}: launch counts {counts} != {expect}")
    check_flash_paths(ops, counts, what)
    if rec is not None:
        rec["flash_attention"].d["launches"] += counts["flash_attention"]
    return counts["flash_attention"]


def phase_telemetry(torch, rec, card):
    """Serving observability on the card.  (1) The Galaxy prefix + chunk
    serve (GPT2-L fp16 on 3:2:2:1, 8 requests of one shared 256-token
    prompt plus 37-300 own tokens, chunks of 128, 16 new) on a warmed
    executor, three times with a tracer, the drift monitor and
    ``record_times`` on and three times with all three off, in the order
    on off off on on off, then once with ``record_times`` alone (its TTFT
    without the tracer and drift): tokens bitwise equal, no open span,
    every request's spans covering >= 0.95 of it, the registry's gauges
    and histograms, drift records of both kinds, launch counts exact, the
    trace written and parsed back; telemetry's cost on tok/s as the ratio
    of the medians beside each side's own spread.  (2) A short traced
    speculative serve (2 requests, k 4, 8 new, the DistilBERT-shaped
    draft).  (3) A traced zoo serve of qwen1.5-0.5b at full size (bf16,
    prefix cache, 256-token chunks, 4 requests, 2 slots) between two
    untraced ones; its flash launches are returned, to be added to the
    kernel's record once ``check_logged_flash`` has replayed their calls.
    (4) ``HostProfiler`` on the card beside ``AnalyticProfiler``."""
    import math
    import os
    import statistics
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core import costmodel
    from repro_torch.core.profiler import AnalyticProfiler, HostProfiler
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.obs import Tracer

    ex = galaxy_executor(torch, "float16")
    kw = dict(executor=ex, requests=8, prompt_len=(37, 300), shared_prefix=256, max_new=16,
              max_batch=4, page_size=16, prefix_cache=True, prefill_chunk=128,
              device="cuda", dtype="float16", seed=0)

    def galaxy_serve(name, tel, **over):
        """One serve: ``tel`` True = tracer, drift and record_times on;
        False = all off; None = record_times alone."""
        tracer = Tracer() if tel else None
        ops.reset_launch_counts()
        out = launch_serve.serve("gpt2-l", (3, 2, 2, 1), tracer=tracer, drift=bool(tel),
                                 record_times=tel is not False, **{**kw, **over})
        torch.cuda.synchronize()
        check_galaxy_counts(ops, rec, out["stats"], f"telemetry {name}")
        check_galaxy_paths(ops, f"telemetry {name}")
        return out, tracer

    # a short serve first: the allocator and first calls warm up on it
    galaxy_serve("warm-up", False, requests=2, max_new=2)
    order = (True, False, False, True, True, False, None)
    runs = [galaxy_serve({True: "on", False: "off", None: "stamps"}[tel], tel)
            for tel in order]
    toks = [[r.output for r in out["requests"]] for out, _ in runs]
    if any(t != toks[0] for t in toks):
        raise AssertionError("telemetry changed the served tokens")
    wire = ex.wire_stats()
    for (out, tr), tel in zip(runs, order):
        if not tel:
            continue
        if tr.open_spans():
            raise AssertionError(f"open spans after the serve: {tr.open_spans()}")
        cov = span_coverage(tr, out["requests"])
        if min(cov.values()) < 0.95:
            raise AssertionError(f"span coverage below 0.95: {cov}")
        snap = out["metrics"].snapshot()
        n_req = len(out["requests"])
        # every request retired: the pages still in use are the prefix
        # tree's, one full page per node
        if (snap["histograms"]["ttft_s"]["n"] != n_req
                or snap["gauges"]["kv_pages_used"] != snap["gauges"]["prefix_nodes"]):
            raise AssertionError(f"ttft_s n {snap['histograms']['ttft_s']['n']} (want "
                                 f"{n_req}), kv_pages_used {snap['gauges']['kv_pages_used']} "
                                 f"(want the prefix tree's {snap['gauges']['prefix_nodes']} "
                                 "pages)")
        if {k: snap["gauges"][k] for k in wire} != wire:
            raise AssertionError(f"ring_wire gauges {snap['gauges']} != wire_stats {wire}")
        check_drift(out["drift"], ("decode", "prefill_chunk"), "Galaxy telemetry serve")
    tps = {tel: [out["tokens_per_s"] for (out, _), t in zip(runs, order) if t is tel]
           for tel in (True, False)}
    on, tracer = runs[0]
    stamps = runs[-1][0]
    snap = on["metrics"].snapshot()
    n_req = len(on["requests"])
    cov = span_coverage(tracer, on["requests"])
    p50 = check_drift(on["drift"], ("decode", "prefill_chunk"), "Galaxy telemetry serve")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        tracer.write(path)
        with open(path) as f:
            parsed = json.load(f)
        size = os.path.getsize(path)
    if parsed != json.loads(json.dumps(tracer.to_json())):
        raise AssertionError("the written trace does not parse back to the tracer's events")
    med = {tel: statistics.median(v) for tel, v in tps.items()}
    spread = {tel: max(v) / min(v) for tel, v in tps.items()}
    ratio = med[True] / med[False]
    noise = max(spread.values()) - 1
    verdict = ("within the serves' own spread: unresolved" if abs(ratio - 1) <= noise
               else "outside the serves' own spread")
    pairs = [tps[True][0] / tps[False][0], tps[True][1] / tps[False][1],
             tps[True][2] / tps[False][2]]
    log("telemetry", f"Galaxy prefix + chunk serve, GPT2-L fp16 3:2:2:1, {n_req} requests "
        f"on a warmed executor, order on off off on on off stamps, tokens bitwise equal in "
        f"all seven: telemetry on (tracer, drift, record_times) tok/s "
        f"{[round(v, 4) for v in tps[True]]}, median {med[True]:.4f}, max/min "
        f"{spread[True]:.4f}; off {[round(v, 4) for v in tps[False]]}, median "
        f"{med[False]:.4f}, max/min {spread[False]:.4f}; on/off ratio of medians "
        f"{ratio:.4f} (pairs {[round(v, 4) for v in pairs]}), {verdict}; TTFT p50 on "
        f"{1e3 * on['ttft_p50_s']:.1f} ms (off: not stamped); record_times alone "
        f"{stamps['tokens_per_s']:.4f} tok/s, TTFT p50 {1e3 * stamps['ttft_p50_s']:.1f} ms "
        f"({card})")
    log("telemetry", f"trace: {len(tracer.events)} events, {size} bytes written and parsed "
        f"back, 0 open spans, span coverage min {min(cov.values()):.4f}; ttft_s n "
        f"{snap['histograms']['ttft_s']['n']}, itl_s n {snap['histograms']['itl_s']['n']}, "
        f"kv_pages_peak {snap['gauges']['kv_pages_peak']}, kv_pages_used at the end "
        f"{snap['gauges']['kv_pages_used']} (the prefix tree's), prefix_hit_rate "
        f"{snap['gauges']['prefix_hit_rate']:.3f}; wire {wire}")
    log("telemetry", "drift measured/simulated p50 (edge cluster of Jetson Nano-L over "
        f"1 Gbit/s priced, this card measured): "
        + ", ".join(f"{k} {v:.4g} (n {on['drift'].summary()[k]['n']})"
                    for k, v in p50.items()) + f" ({card})")
    del runs, on, stamps, tracer

    # (2) a short traced speculative serve
    draft = launch_serve.build_draft("galaxy", "distilbert", device=ex.device,
                                     dtype="float16", seed=2)
    tracer = Tracer()
    ops.reset_launch_counts()
    spec = launch_serve.serve("gpt2-l", (3, 2, 2, 1), executor=ex, requests=2,
                              prompt_len=(37, 300), max_new=8, max_batch=4, page_size=16,
                              device="cuda", dtype="float16", seed=0, draft_executor=draft,
                              spec_k=4, tracer=tracer, drift=True)
    torch.cuda.synchronize()
    check_galaxy_counts(ops, rec, spec["stats"], "traced spec serve", draft=spec["spec"])
    check_galaxy_paths(ops, "traced spec serve")
    names = {e["name"] for e in tracer.events if e["ph"] == "X"}
    if tracer.open_spans() or not {"spec_round", "draft_propose", "spec_verify"} <= names:
        raise AssertionError(f"spec spans: open {tracer.open_spans()}, closed {names}")
    sp50 = check_drift(spec["drift"], ("spec_verify",), "traced spec serve")
    log("telemetry", f"traced spec serve (k 4, 2 requests, 8 new): "
        f"{spec['stats']['spec_steps']} verify chunks, acceptance "
        f"{spec['stats']['spec_acceptance']:.3f}, spans closed; drift p50 "
        + ", ".join(f"{k} {v:.4g}" for k, v in sp50.items()) + f" ({card})")
    del spec, draft, ex
    torch.cuda.empty_cache()

    # (3) a traced zoo serve of qwen1.5-0.5b at full size
    # two slots: the last two requests are admitted after the first two
    # published their prompts, so they hit the prefix cache
    zkw = dict(executor_kind="zoo", requests=4, prompt_len=(64, 512), shared_prefix=1024,
               max_new=16, max_batch=2, page_size=16, prefix_cache=True, prefill_chunk=256,
               device="cuda", dtype="bfloat16", seed=0)
    # off, on, off: the first serve of a fresh model pays its warm-up, so
    # telemetry on is held against the untraced serves on both sides
    zruns, qwen_launches = {}, 0
    for name, tel in (("off", False), ("on", True), ("off again", False)):
        tracer = Tracer() if tel else None
        ops.reset_launch_counts()
        out = launch_serve.serve("qwen1.5-0.5b", tracer=tracer, drift=tel, record_times=tel,
                                 executor=zruns["off"][0]["executor"] if zruns else None,
                                 **zkw)
        torch.cuda.synchronize()
        qwen_launches += check_zoo_flash_counts(ops, None, out, f"qwen telemetry {name}")
        zruns[name] = (out, tracer)
    (zon, ztr), (zoff, _), (zoff2, _) = zruns["on"], zruns["off"], zruns["off again"]
    if not ([r.output for r in zon["requests"]] == [r.output for r in zoff["requests"]]
            == [r.output for r in zoff2["requests"]]):
        raise AssertionError("telemetry changed the qwen1.5-0.5b tokens")
    if ztr.open_spans() or zon["stats"]["prefix_hits"] < 1:
        raise AssertionError(f"qwen telemetry: open spans {ztr.open_spans()}, stats "
                             f"{zon['stats']}")
    zp50 = check_drift(zon["drift"], ("decode", "prefill_chunk"), "qwen telemetry")
    log("telemetry", f"{zon['plan']}: 4 requests, prompts "
        f"{[len(r.prompt) for r in zon['requests']]}, tokens equal traced and untraced; "
        f"on {zon['tokens_per_s']:.2f} tok/s, TTFT p50 {1e3 * zon['ttft_p50_s']:.1f} ms, "
        f"off before and after {zoff['tokens_per_s']:.2f} / {zoff2['tokens_per_s']:.2f} "
        f"tok/s; {len(ztr.events)} trace events; drift p50 "
        + ", ".join(f"{k} {v:.4g}" for k, v in zp50.items()) + f" ({card})")
    del zruns, zon, zoff, zoff2
    torch.cuda.empty_cache()

    # (4) HostProfiler on the card beside the analytic profile: five
    # measurements of the blocks, each with the capacity it gives
    # (1 / (MHA + MLP), as capacity() computes it from its own measurement)
    cfg = get_config("gpt2-l")
    hp = HostProfiler(cfg, 256, iters=20)
    meas = [hp.measure_blocks(cfg.num_heads, cfg.d_ff) for _ in range(5)]
    caps = [1.0 / (b["mha"] + b["mlp"]) for b in meas]
    cap = hp.capacity()
    vals = [v for b in meas for v in b.values()] + caps + [cap]
    if not all(math.isfinite(v) and v > 0 for v in vals):
        raise AssertionError(f"HostProfiler: {meas}, capacity {cap}")
    nano = AnalyticProfiler(cfg, 256).capacity(costmodel.jetson_nano("nano-l", 4.0))

    def ms_range(key):
        v = sorted(1e3 * b[key] for b in meas)
        return f"{statistics.median(v):.4f} ms (min {v[0]:.4f}, max {v[-1]:.4f})"

    log("telemetry", f"HostProfiler GPT2-L seq 256 fp32 (TF32 off), full blocks (20 heads, "
        f"5120 columns), 5 measurements of 20 synced iterations, median (min, max): MHA "
        f"{ms_range('mha')}, MLP {ms_range('mlp')}, connective {ms_range('con')}; capacity "
        f"V_d from each measurement {[round(c, 1) for c in caps]} /s, median "
        f"{statistics.median(caps):.1f} /s; capacity() from a sixth measurement {cap:.1f} "
        f"/s; AnalyticProfiler's Jetson Nano-L {nano:.4f} /s ({card})")
    return qwen_launches


# --- the MoE and xLSTM families -------------------------------------------------

def phase_moe_kernels(rec, torch):
    """The flash kernel at the MoE serves' prefill shapes: an olmoe chunk
    (256 queries at offset 1024, 16 heads of 128, MHA, in the gathered
    view of 97 pages) and a granite one-shot prefill (512 queries, 24
    heads on 8 KV heads of 64)."""
    g = torch.Generator(device=torch.device("cuda")).manual_seed(12)
    check_time_flash(rec, torch, g, "olmoe chunk", 1, 16, 16, 256, 1024 + 256, 128, 97 * 16)
    check_time_flash(rec, torch, g, "granite one-shot", 1, 24, 8, 512, 512, 64, 512)


def moe_sublayer_params(cfg, torch, g):
    """Random fp32 weights of one MoE sub-layer (norm, router, experts) of
    ``cfg``, drawn on the CPU from ``g``, pad experts included."""
    from repro_torch.models.params import model_spec

    spec = model_spec(cfg)["groups"]["b0_attn"]
    p = {"ln2": {"scale": 0.1 * torch.randn(spec["ln2"]["scale"].shape, generator=g)}}
    p["moe"] = {n: torch.randn(ps.shape, generator=g) / ps.shape[-2] ** 0.5
                for n, ps in spec["moe"].items()}
    return p


def phase_moe_routing(torch, card):
    """One MoE sub-layer at olmoe's and granite's full widths in fp32 (TF32
    off) on 512 tokens, the card against the CPU: the same experts chosen
    for every token (granite: never one of its 8 pad experts), outputs
    within 1e-4 of the largest, equal aux values."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import connective_norm
    from repro_torch.models.moe import _group_size, moe_block, moe_route

    dev = torch.device("cuda")
    for model in ("olmoe-1b-7b", "granite-moe-3b-a800m"):
        cfg = dataclasses.replace(get_config(model), dtype="float32", param_dtype="float32")
        g = torch.Generator().manual_seed(13)
        p = moe_sublayer_params(cfg, torch, g)
        x = torch.randn(1, 512, cfg.d_model, generator=g)
        pc = {k: {n: t.to(dev) for n, t in v.items()} for k, v in p.items()}
        t = _group_size(512)
        res = {}
        for where, pp, xx in (("cpu", p, x), ("cuda", pc, x.to(dev))):
            out, aux = moe_block(pp, xx, cfg)
            xn = connective_norm(xx, pp["ln2"], cfg.norm).view(-1, t, cfg.d_model)
            _, _, idx = moe_route(pp["moe"], xn, cfg)
            res[where] = (out.cpu(), {k: v.item() for k, v in aux.items()}, idx.cpu())
        (out, aux, idx), (out_c, aux_c, idx_c) = res["cpu"], res["cuda"]
        e_pad = pc["moe"]["router"].shape[1]
        if not torch.equal(idx, idx_c):
            n = int((idx != idx_c).sum())
            raise AssertionError(f"{model} MoE routing: {n} expert choices differ card vs CPU")
        if int(idx_c.max()) >= cfg.num_experts:
            raise AssertionError(f"{model}: a pad expert was selected ({int(idx_c.max())})")
        err = (out_c - out).abs().max().item()
        scale = out.abs().max().item()
        if not err <= 1e-4 * scale:
            raise AssertionError(f"{model} MoE sub-layer card vs CPU: max abs err {err} > "
                                 f"1e-4 x {scale}")
        for k in aux:
            if not abs(aux_c[k] - aux[k]) <= 1e-4 * max(1.0, abs(aux[k])):
                raise AssertionError(f"{model} {k}: card {aux_c[k]} vs CPU {aux[k]}")
        log("moe", f"{model} MoE sub-layer fp32, d {cfg.d_model}, {cfg.num_experts} experts "
            f"in {e_pad} (top {cfg.experts_per_token}), 512 tokens in groups of {t}: expert "
            f"choices equal card vs CPU, none a pad expert; output max abs err {err:.3g} "
            f"(largest {scale:.3g}); moe_drop_frac card {aux_c['moe_drop_frac']:.6f} / CPU "
            f"{aux['moe_drop_frac']:.6f}, lb {aux_c['moe_lb_loss']:.6f}, z "
            f"{aux_c['moe_z_loss']:.6f} ({card})")


def phase_xlstm_parity(torch, card):
    """xlstm-350m at full width cut to 2 layers (one mLSTM, one sLSTM) in
    fp32, gates and norm scales random: a 256-token prefill (the chunked
    mLSTM path) then 2 decode steps against one forward pass over all 258
    tokens (the step path), and at S 256 the chunked path against the
    step path; each within 1e-4 of the largest logit."""
    from repro_torch.configs import get_config
    from repro_torch.models import apply_model, xlstm
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import TransformerExecutor

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("xlstm-350m"), num_layers=2, dtype="float32",
                              param_dtype="float32")
    g = torch.Generator(device=dev).manual_seed(14)
    params = init_params(cfg, generator=g, device=dev)
    for block in params["groups"].values():  # the zero-init gates and scales
        for name in ("w_if", "b_if", "b_in"):
            if name in block:
                block[name].copy_(0.5 * torch.randn(block[name].shape, generator=g, device=dev))
        block["mh_norm"]["scale"].copy_(
            0.1 * torch.randn(block["mh_norm"]["scale"].shape, generator=g, device=dev))
    b, s, steps = 2, 256, 2
    tokens = torch.randint(0, cfg.vocab_size, (b, s + steps), device=dev, generator=g)
    ex = TransformerExecutor(params, cfg)
    tol = 1e-4

    def close(what, got, want):
        # the real vocabulary only: the pad columns are -1e30 on both sides
        got, want = got[..., :cfg.vocab_size], want[..., :cfg.vocab_size]
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        if not err <= tol * scale:
            raise AssertionError(f"xLSTM {what}: max abs err {err} > {tol} x {scale}")
        return err

    xlstm.reset_mlstm_paths()
    full, _ = apply_model(params, cfg, tokens=tokens)
    lg, cache = ex.prefill(tokens[:, :s], ex.make_cache(b, s + steps))
    errs = [close("prefill vs one pass", lg, full[:, s - 1])]
    for step in range(steps):
        lg, cache = ex.decode(tokens[:, s + step:s + step + 1], cache, s + step)
        errs.append(close(f"decode step {step} vs one pass", lg, full[:, s + step]))
    paths = dict(xlstm.MLSTM_PATHS)
    if paths != {"chunked": 1, "step": 1}:
        raise AssertionError(f"xLSTM parity mLSTM paths {paths}")
    chunked, _ = apply_model(params, cfg, tokens=tokens[:, :s])
    step, _ = apply_model(params, dataclasses.replace(cfg, mlstm_chunk=2 * s),
                          tokens=tokens[:, :s])
    cerr = close("chunked vs step at S 256", chunked, step)
    if dict(xlstm.MLSTM_PATHS) != {"chunked": 2, "step": 2}:
        raise AssertionError(f"xLSTM parity mLSTM paths {xlstm.MLSTM_PATHS}")
    log("xlstm", f"xlstm-350m width (d {cfg.d_model}, {cfg.num_heads} heads of "
        f"{2 * cfg.d_model // cfg.num_heads}), 2 layers fp32: {s}-token prefill (chunked) + "
        f"{steps} decode steps vs one {s + steps}-token pass (step) max abs err "
        f"{max(errs):.3g} (largest logit {full[..., :cfg.vocab_size].abs().max().item():.3g}); "
        f"chunked vs step "
        f"at S {s} max abs err {cerr:.3g}; tolerance {tol} of the largest ({card})")


def phase_moe_serve(torch, rec, card, model, **traffic):
    """``launch.serve --executor zoo`` with an MoE model at full width and
    depth in bf16 on the continuous scheduler, ``max_batch`` 4, page 16:
    every request finished, the prefix-cache identities when it is on,
    and the flash kernel exactly once a layer per prefill call, on the
    tensor cores, and no other kernel."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = launch_serve.serve(model, executor_kind="zoo", max_new=16, max_batch=4,
                             page_size=16, device="cuda", dtype="bfloat16", seed=0, **traffic)
    torch.cuda.synchronize()
    reqs, st, cfg = out["requests"], out["stats"], out["executor"].cfg
    log("serve", out["plan"])
    if len(reqs) != traffic["requests"] or any(len(r.output) != 16 for r in reqs):
        raise AssertionError(f"unfinished {model} requests: {[len(r.output) for r in reqs]}")
    total = sum(len(r.prompt) for r in reqs)
    if traffic.get("prefix_cache"):
        if st["prefix_hits"] < 1 or st["prefill_chunks"] < 1:
            raise AssertionError(f"{model} serve took no prefix hit or no chunk: {st}")
        out["pool"].check()
    if st["prefill_tokens"] + st["cached_prefix_tokens"] != total:
        raise AssertionError(f"computed {st['prefill_tokens']} + cached "
                             f"{st['cached_prefix_tokens']} != {total} prompt tokens")
    n = check_zoo_flash_counts(ops, rec, out, f"{model} serve")
    log("serve", f"{model} flash_attention: {n} launches = {cfg.num_layers} layers x "
        f"({st['prefill_oneshots']} one-shot + {st['prefill_chunks']} chunks) at hd "
        f"{cfg.head_dim}, {cfg.num_heads} heads on {cfg.num_kv_heads} KV heads")
    log("serve", f"{model}: {len(reqs)} requests, prompts {[len(r.prompt) for r in reqs]} "
        f"({total} tokens: {st['prefill_tokens']} computed, {st['cached_prefix_tokens']} "
        f"cached in {st['prefix_hits']} hits), {st['decode_steps']} decode steps, "
        + serve_line(out, torch, card))
    return out


def check_moe_served_token(out, torch, chunk=None, cached=0):
    """The last request's first token, replayed at full depth in bf16 on the
    kernel and the eager backend through the paged protocol with the served
    call sequence (the prefix's chunks, then the suffix's; or one one-shot
    prefill), so every MoE call routes the same token groups as served: the
    kernel replay gives the served token, and that token is the eager
    replay's argmax up to the bf16 disagreement."""
    import numpy as np

    from repro_torch.serving.engine import TransformerExecutor

    kern = out["executor"]
    req = out["requests"][-1]
    s, page = len(req.prompt), 16
    s_pad = -(-s // page) * page
    tokens = np.zeros((1, s_pad), np.int64)
    tokens[0, :s] = req.prompt
    row = list(range(1, 1 + s_pad // page))
    if chunk is None:
        calls = [(0, s_pad)]
    else:
        calls = ([(o, chunk) for o in range(0, cached, chunk)]
                 + [(o, min(chunk, s_pad - o)) for o in range(cached, s_pad, chunk)])
    logits = {}
    for backend in ("kernel", "eager"):
        ex = TransformerExecutor(kern.params, kern.cfg, backend=backend)
        pool = ex.make_pool(1 + len(row), page)
        for off, size in calls:
            if (off, size) == (0, s_pad):
                lg, pool = ex.prefill_paged(tokens, pool, row, length=s)
            else:
                lg, pool = ex.prefill_chunk(tokens[:, off:off + size], pool, row,
                                            offset=off, length=s)
                lg = lg[:, min(s - 1 - off, size - 1)] if off <= s - 1 < off + size else None
            if lg is not None:
                logits[backend] = lg.float()[0]
    lk, le = logits["kernel"], logits["eager"]
    err = (lk - le).abs().max().item()
    gap = (le.max() - le[req.output[0]]).item()
    tol = 1e-1  # bf16 through every layer: flash vs plain attention sums
    if not torch.isfinite(le).all() or int(lk.argmax()) != req.output[0] or gap > tol:
        raise AssertionError(f"{kern.cfg.name} served token {req.output[0]}: kernel replay "
                             f"argmax {int(lk.argmax())}, eager argmax {int(le.argmax())}, "
                             f"gap {gap}, err {err}")
    log("serve", f"{kern.cfg.name} request {req.uid} ({s} tokens, {len(calls)} prefill calls "
        f"replayed, {kern.cfg.num_layers} layers bf16): served first token {req.output[0]} "
        f"== kernel replay argmax; eager argmax {int(le.argmax())} (logit gap {gap:.3g}, "
        f"kernel vs eager max abs err {err:.3g})")


def phase_xlstm_serve(torch, card):
    """``launch.serve --executor zoo`` with xlstm-350m at full width and
    depth in bf16 (fp32 recurrent states), in waves: 4 x 256 tokens (the
    chunked mLSTM path) and 2 x 300 (the step path), 16 new each.  No
    kernel is on this path.  The 256-token wave's first served tokens
    against a bf16 pass over the same prompts on the step path, up to the
    bf16 disagreement."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import apply_model, xlstm

    torch.cuda.reset_peak_memory_stats()
    lens = [256] * 4 + [300] * 2
    ops.reset_launch_counts()
    xlstm.reset_mlstm_paths()
    out = launch_serve.serve("xlstm-350m", executor_kind="zoo", prompt_lens=lens, max_new=16,
                             max_batch=4, device="cuda", dtype="bfloat16", seed=0)
    torch.cuda.synchronize()
    reqs, st, ex = out["requests"], out["stats"], out["executor"]
    paths = dict(xlstm.MLSTM_PATHS)
    log("serve", out["plan"])
    if len(reqs) != len(lens) or any(len(r.output) != 16 for r in reqs):
        raise AssertionError(f"unfinished xLSTM requests: {[len(r.output) for r in reqs]}")
    if st["prefill_waves"] != 2 or any(ops.launch_counts().values()):
        raise AssertionError(f"xLSTM serve: {st['prefill_waves']} waves, launches "
                             f"{ops.launch_counts()}")
    layers = ex.cfg.count_kind("mlstm")
    if paths != {"chunked": layers, "step": layers}:
        raise AssertionError(f"xLSTM serve mLSTM prefills by path {paths}, expected "
                             f"{layers} each")
    log("serve", f"xlstm-350m mLSTM prefills by path: {paths} (the 256-token wave chunked, "
        f"the 300-token wave step by step); {st['decode_steps']} decode steps, "
        + serve_line(out, torch, card))
    wave = [r for r in reqs if len(r.prompt) == 256]
    tokens = torch.as_tensor(np.array([r.prompt for r in wave]), device=ex.device)
    step_cfg = dataclasses.replace(ex.cfg, mlstm_chunk=512)
    le, _ = apply_model(ex.params, step_cfg, tokens=tokens, rows=255)
    le = le.float()
    served = torch.tensor([r.output[0] for r in wave], device=ex.device)
    gap = (le.max(-1).values - le.gather(1, served[:, None])[:, 0]).max().item()
    tol = 1e-1  # bf16 through 24 layers: the fp32 recurrences summed in another order
    if not torch.isfinite(le).all() or gap > tol:
        raise AssertionError(f"xLSTM served tokens {served.tolist()}: step-path argmax "
                             f"{le.argmax(-1).tolist()}, gap {gap}")
    log("serve", f"xlstm-350m {len(wave)} x 256 tokens, {ex.cfg.num_layers} layers bf16: "
        f"served first tokens "
        f"{served.tolist()}, step-path pass argmax {le.argmax(-1).tolist()} (largest logit "
        f"gap {gap:.3g})")
    return out


# --- the training path and the rest of the zoo --------------------------------

# kernel-forward gradients against plain autograd, relative to each
# gradient's largest: fp32 sums in another order; bf16 inputs and outputs
# round the same fp32 math on both sides
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# one fp32 train step, kernel vs eager backend: loss and grad norm sum the
# same fp32 terms in another order; an updated parameter moves by
# lr * g / (|g| + eps), so only an element whose gradient is at the noise
# floor (|g| ~ eps) can move by a share of a step: half a step bounds it,
# and the 2-norm of the difference of the updates stays within 1e-3 of
# the updates' own
STEP_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "param_steps": 0.5, "update_norm": 1e-3}
# bf16 logits through the llama-3.2-vision group (d 8192, |logits| ~5),
# kernel vs eager: the two residual streams part by a bf16 unit at each
# attention (the kernel's P in two bf16 parts against the plain fp32 P)
# and carry it through the decode's K/V caches; between the MoE replays'
# 0.1 (<= 32 layers of d <= 2048) and the bf16 Galaxy serve's 0.4.  A
# greedy token may differ only where the eager top-2 gap is below it
XATTN_TOL = {"bfloat16": 0.25, "float32": 1e-4}


def _grad_pair(fn, inputs, weights):
    """Gradients of sum(out * w) over ``fn``'s outputs at fresh leaf copies
    of ``inputs``."""
    ts = [t.detach().clone().requires_grad_() for t in inputs]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum((o.float() * w).sum() for o, w in zip(outs, weights)).backward()
    return [t.grad for t in ts]


def _max_rel(got, want):
    return max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
               for a, b in zip(got, want))


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _tree_pairs(a, b):
    for k in a:
        if isinstance(a[k], dict):
            yield from _tree_pairs(a[k], b[k])
        else:
            yield a[k], b[k]


def phase_train_kernels(torch, card):
    """The two kernels of the training path with their gradients: q, k, v
    through ``FlashAttentionFn`` (kernel forward, torch-ops backward) and
    a, b, h0 through ``RGLRUScanFn`` (kernel forward, kernel backward on
    reversed time) against autograd through the plain versions.  The bare
    flash wrapper's output carries no gradient: the fault the Function
    repairs.  Times the forward kernel, the backward and plain autograd
    (forward and backward)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        FlashAttentionFn, flash_attention, flash_attention_backward, flash_attention_plain)
    from repro_torch.kernels.rglru_scan import (
        RGLRUScanFn, rglru_scan, rglru_scan_backward, rglru_scan_plain)
    from repro_torch.launch.kernel_timing import time_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    for model, (b, h, hkv, s, hd) in (("qwen1.5-0.5b", (8, 16, 16, 128, 64)),
                                      ("llama-3.2-vision-90b", (1, 64, 8, 256, 128))):
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            q = torch.randn(b, s, h, hd, generator=g, device=dev).to(tdt)
            k, v = (torch.randn(b, s, hkv, hd, generator=g, device=dev).to(tdt)
                    for _ in range(2))
            w = torch.randn(b, h, s, hd, generator=g, device=dev)

            def views(f):
                return lambda q, k, v: f(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2))

            bare = flash_attention(*(t.detach().requires_grad_().transpose(1, 2)
                                     for t in (q, k, v)))
            if bare.requires_grad:
                raise AssertionError("the bare flash kernel output carries a gradient")
            got = _grad_pair(views(lambda *a: FlashAttentionFn.apply(*a, True, 0)),
                             (q, k, v), (w,))
            want = _grad_pair(views(lambda *a: flash_attention_plain(*a, causal=True)),
                              (q, k, v), (w,))
            err = _max_rel(got, want)
            if not err <= GRAD_TOL[dtype]:
                raise AssertionError(f"flash_attention gradient {model} {dtype}: max rel err "
                                     f"{err} > {GRAD_TOL[dtype]}")
            line = (f"flash_attention grad {model} q ({b},{h},{s},{hd}) kv {hkv} causal "
                    f"{dtype}: dq/dk/dv max err {err:.3g} of the largest (tolerance "
                    f"{GRAD_TOL[dtype]}); the bare kernel output has no grad_fn")
            if dtype == "bfloat16":
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                out = flash_attention(qt, kt, vt, causal=True)
                dout = w.to(tdt)
                fwd = time_ms(lambda: flash_attention(qt, kt, vt, causal=True))
                bwd = time_ms(lambda: flash_attention_backward(qt, kt, vt, out, dout,
                                                               causal=True))
                plain = time_ms(lambda: _grad_pair(
                    views(lambda *a: flash_attention_plain(*a, causal=True)), (q, k, v), (w,)),
                    iters=10)
                line += (f"; kernel forward {fwd:.4f} ms, torch-ops backward {bwd:.4f} ms, "
                         f"plain autograd {plain:.4f} ms; {card}")
            log("train", line)

    b, s, w = 4, 300, 4096
    a = 0.5 + 0.499 * torch.rand(b, s, w, generator=g, device=dev)
    bb = torch.randn(b, s, w, generator=g, device=dev)
    h0 = torch.randn(b, w, generator=g, device=dev)
    w1 = torch.randn(b, s, w, generator=g, device=dev)
    w2 = torch.randn(b, w, generator=g, device=dev)
    before = ops.launch_counts()["rglru_scan"]
    got = _grad_pair(RGLRUScanFn.apply, (a, bb, h0), (w1, w2))
    if ops.launch_counts()["rglru_scan"] != before + 2:
        raise AssertionError("RGLRUScanFn: not one forward and one backward launch")
    want = _grad_pair(rglru_scan_plain, (a, bb, h0), (w1, w2))
    err = _max_rel(got, want)
    if not err <= 1e-5:
        raise AssertionError(f"rglru_scan gradient: max rel err {err} > 1e-5")
    hs, _ = rglru_scan(a, bb, h0)
    fwd = time_ms(lambda: rglru_scan(a, bb, h0))
    bwd = time_ms(lambda: rglru_scan_backward(a, h0, hs, w1, w2))
    plain = time_ms(lambda: _grad_pair(rglru_scan_plain, (a, bb, h0), (w1, w2)), iters=3)
    log("train", f"rglru_scan grad ({b},{s},{w}) fp32 nonzero h0: da/db/dh0 max err "
        f"{err:.3g} of the largest (tolerance 1e-5), 2 launches; kernel forward {fwd:.4f} "
        f"ms, backward (kernel on reversed time) {bwd:.4f} ms, plain autograd {plain:.4f} "
        f"ms; {card}")


def check_train_counts(ops, cfg, steps, what, scan_bwd=True):
    """Launches of a training run on the kernel backend: per step and
    layer, flash twice (the forward and remat's recompute) and the scan
    three times (forward, recompute, backward on reversed time); no other
    kernel."""
    counts = ops.launch_counts()
    remat = 2 if cfg.remat else 1
    expect = {name: 0 for name in counts}
    expect["flash_attention"] = remat * cfg.count_kind("attn") * steps
    expect["rglru_scan"] = (remat + int(scan_bwd)) * cfg.count_kind("rec") * steps
    if counts != expect:
        raise AssertionError(f"{what}: launch counts {counts} != {expect}")
    return counts


def train_step_pair(torch, cfg, what, card, batch=8, seq=128, seed=31):
    """One fp32 train step on the kernel and the eager backend from the
    same weights and batch: loss, grad norm and the updated params within
    ``STEP_TOL``.  Returns the kernel run's launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models.params import init_params

    dev = torch.device("cuda")
    p0 = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    lr = 1e-3
    runs = {}
    for backend in ("kernel", "eager"):
        ops.reset_launch_counts()
        runs[backend] = launch_train.train(
            cfg, steps=1, batch=batch, seq=seq, lr=lr, warmup=1, device=dev,
            backend=backend, params=_clone_tree(p0), log=lambda m: None)
        if backend == "kernel":
            counts = check_train_counts(ops, cfg, 1, what)
        torch.cuda.empty_cache()
    k, e = runs["kernel"], runs["eager"]
    loss_err = abs(k["losses"][0] - e["losses"][0]) / abs(e["losses"][0])
    gn_err = abs(k["grad_norms"][0] - e["grad_norms"][0]) / e["grad_norms"][0]
    pmax, num, den = 0.0, 0.0, 0.0
    for (pk, pe), (_, p) in zip(_tree_pairs(k["params"], e["params"]),
                                _tree_pairs(k["params"], p0)):
        pmax = max(pmax, (pk - pe).abs().max().item())
        num += (pk - pe).double().square().sum().item()
        den += (pe - p).double().square().sum().item()
    upd = (num / den) ** 0.5
    if not (loss_err <= STEP_TOL["loss"] and gn_err <= STEP_TOL["grad_norm"]
            and pmax <= STEP_TOL["param_steps"] * lr and upd <= STEP_TOL["update_norm"]):
        raise AssertionError(f"{what} train step kernel vs eager: loss rel err {loss_err}, "
                             f"grad norm rel err {gn_err}, params max abs err {pmax} "
                             f"(lr {lr}), update 2-norm rel err {upd}; tolerances {STEP_TOL}")
    log("train", f"{what}: one fp32 step kernel vs eager: loss {k['losses'][0]:.6f} vs "
        f"{e['losses'][0]:.6f} (rel err {loss_err:.3g}), grad norm rel err {gn_err:.3g}, "
        f"updated params max abs err {pmax:.3g} (lr {lr}), update 2-norm rel err {upd:.3g} "
        f"(tolerances {STEP_TOL}); launches {counts}; {card}")
    del runs, p0
    torch.cuda.empty_cache()
    return counts


def phase_train(torch, rec, card):
    """``launch.train`` for qwen1.5-0.5b at full width and depth (bf16,
    remat on), batch 8 x 128 tokens, 20 steps: finite losses, the last 5
    steps' mean below the first step's, flash launches exactly 2 x 24 a
    step and no other kernel; step time (median), tokens/s, peak memory.
    Then one fp32 step at full width cut to 4 layers, kernel vs eager."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train

    cfg = get_config("qwen1.5-0.5b")
    steps, batch, seq = 20, 8, 128
    ops.reset_launch_counts()
    out = launch_train.train(cfg, steps=steps, batch=batch, seq=seq, device="cuda",
                             log=lambda m: log("train", m))
    counts = check_train_counts(ops, cfg, steps, "qwen1.5-0.5b training")
    rec["flash_attention"].d["launches"] += counts["flash_attention"]
    losses = out["losses"]
    tail = sum(losses[-5:]) / 5
    if not all(math.isfinite(x) for x in losses) or not tail < losses[0]:
        raise AssertionError(f"qwen1.5-0.5b losses {losses}: not finite or not falling")
    log("train", f"qwen1.5-0.5b full width and depth ({cfg.num_layers} layers, d "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, bf16, remat), {batch} x {seq} tokens, "
        f"{steps} steps: loss {losses[0]:.4f} -> mean of the last 5 {tail:.4f}; median step "
        f"{1e3 * out['median_step_s']:.2f} ms, {out['tokens_per_s']:.0f} tok/s, peak memory "
        f"{out['peak_bytes'] / 2**30:.2f} GiB; flash launches {counts['flash_attention']} "
        f"(2 x {cfg.count_kind('attn')} x {steps}); {card}")
    del out
    torch.cuda.empty_cache()
    cfg4 = dataclasses.replace(cfg, num_layers=4, dtype="float32", param_dtype="float32")
    counts = train_step_pair(torch, cfg4, "qwen1.5-0.5b width, 4 layers", card)
    rec["flash_attention"].d["launches"] += counts["flash_attention"]


def phase_train_zoo(torch, rec, card):
    """musicgen-medium at full width and depth (5 steps, bf16); a
    RecurrentGemma-9B group at full width, one fp32 step kernel vs eager
    (the scan's backward on the card); an olmoe-1b-7b step at full width
    cut to 2 layers (the aux losses in the loss, gradients into the router
    and the experts); a qwen1.5-0.5b checkpoint at step 3 resumed
    bitwise."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, LMDataPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models.params import init_params
    from repro_torch.training import (AdamW, cosine_schedule, make_train_step,
                                      restore_checkpoint, save_checkpoint)
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_loop import batch_to_device, loss_fn

    dev = torch.device("cuda")
    cfg = get_config("musicgen-medium")
    steps = 5
    ops.reset_launch_counts()
    out = launch_train.train(cfg, steps=steps, batch=8, seq=128, device=dev,
                             log=lambda m: log("train", m))
    counts = check_train_counts(ops, cfg, steps, "musicgen-medium training")
    rec["flash_attention"].d["launches"] += counts["flash_attention"]
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"musicgen-medium losses {out['losses']}")
    log("train", f"musicgen-medium full width and depth ({cfg.num_layers} layers, d "
        f"{cfg.d_model}, {cfg.num_codebooks} codebooks, embed input, sinusoidal, "
        f"{cfg.param_count() / 1e9:.2f}e9 params, bf16, remat), 8 x 128, {steps} steps: "
        f"losses {[round(x, 4) for x in out['losses']]}; median step "
        f"{1e3 * out['median_step_s']:.2f} ms, {out['tokens_per_s']:.0f} tok/s, peak memory "
        f"{out['peak_bytes'] / 2**30:.2f} GiB; {card}")
    del out
    torch.cuda.empty_cache()

    rg = dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=3, dtype="float32",
                             param_dtype="float32")
    counts = train_step_pair(torch, rg, "recurrentgemma-9b width, one group", card, batch=4)
    for name in ZOO_KERNELS:
        rec[name].d["launches"] += counts[name]

    moe = dataclasses.replace(get_config("olmoe-1b-7b"), num_layers=2)
    params = init_params(moe, generator=torch.Generator(device=dev).manual_seed(41),
                         device=dev)
    pipe = LMDataPipeline(moe, DataConfig(batch_size=8, seq_len=128))
    batch = batch_to_device(next(iter(pipe)), dev)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    ops.reset_launch_counts()
    loss, m = loss_fn(params, batch, moe)
    grads = dict(zip(("router", "we_up"), torch.autograd.grad(
        loss, [params["groups"]["b0_attn"]["moe"][n] for n in ("router", "we_up")])))
    for t in leaves:
        t.requires_grad_(False)
    counts = check_train_counts(ops, moe, 1, "olmoe-1b-7b step")
    rec["flash_attention"].d["launches"] += counts["flash_attention"]
    want = (m["ce_loss"] + moe.load_balance_loss_weight * m["moe_lb_loss"]
            + 1e-3 * m["moe_z_loss"])
    gn = {n: g.float().norm().item() for n, g in grads.items()}
    if not (torch.isfinite(loss) and torch.allclose(loss, want, rtol=1e-6)
            and loss > m["ce_loss"] and all(v > 0 and math.isfinite(v) for v in gn.values())):
        raise AssertionError(f"olmoe step: loss {loss}, metrics {m}, grad norms {gn}")
    log("train", f"olmoe-1b-7b width, 2 layers, bf16, one step: loss {loss.item():.4f} = ce "
        f"{m['ce_loss'].item():.4f} + {moe.load_balance_loss_weight} x lb "
        f"{m['moe_lb_loss'].item():.4f} + 1e-3 x z {m['moe_z_loss'].item():.3f}; drop frac "
        f"{m['moe_drop_frac'].item():.3f}; router grad norm {gn['router']:.3g}, experts' "
        f"w_up grad norm {gn['we_up']:.3g}; {card}")
    del params, leaves, grads, loss, m
    torch.cuda.empty_cache()

    q4 = dataclasses.replace(get_config("qwen1.5-0.5b"), num_layers=4)
    opt = AdamW(cosine_schedule(1e-3, 2, 6))
    step = make_train_step(q4, opt)
    data = [batch_to_device(b, dev) for b, _ in
            zip(LMDataPipeline(q4, DataConfig(batch_size=8, seq_len=128)), range(6))]

    def run(params, st, batches):
        losses = []
        for b in batches:
            params, st, mt = step(params, st, b)
            losses.append(mt["loss"])
        return params, st, torch.stack(losses)

    def fresh(seed):
        return init_params(q4, generator=torch.Generator(device=dev).manual_seed(seed),
                           device=dev)

    p = fresh(51)
    full, _, full_losses = run(p, opt.init(p), data)
    p = fresh(51)
    p, st, first = run(p, opt.init(p), data[:3])
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 3, p, st, {"arch": q4.name})
        tmpl = fresh(52)
        del p, st
        manifest, p, st = restore_checkpoint(d, tmpl, opt.init(tmpl))
    p, _, rest = run(p, st, data[3:])
    same = all(torch.equal(a, b) for a, b in _tree_pairs(full, p))
    if not (same and manifest["step"] == 3 and torch.equal(torch.cat([first, rest]),
                                                           full_losses)):
        raise AssertionError("qwen1.5-0.5b checkpoint resume is not bitwise the "
                             "uninterrupted run")
    log("train", f"qwen1.5-0.5b width, 4 layers, bf16: 3 steps, checkpoint, restore into "
        f"fresh tensors, 3 steps: params and losses bitwise equal to 6 uninterrupted steps "
        f"(losses {[round(x, 4) for x in full_losses.tolist()]})")
    del full, p, tmpl, data
    torch.cuda.empty_cache()


def xattn_group(torch, rec, card, dtype):
    """The llama-3.2-vision group of :func:`phase_xattn` in ``dtype``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import apply_model
    from repro_torch.models.params import init_params
    from repro_torch.serving.kvcache import make_cache

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("llama-3.2-vision-90b"), num_layers=5, dtype=dtype,
                              param_dtype=dtype)
    tol = XATTN_TOL[dtype]
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(61), device=dev)
    g = torch.Generator(device=dev).manual_seed(62)
    b, s, steps = 2, 128, 8
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev)
    img = (torch.randn(b, cfg.num_image_tokens, cfg.d_model, generator=g, device=dev)
           * 0.1).to(getattr(torch, dtype))
    caches, logits = {}, {}
    for backend in ("kernel", "eager"):
        ops.reset_launch_counts()
        caches[backend] = make_cache(cfg, b, s + steps, device=dev)
        logits[backend], _ = apply_model(params, cfg, tokens=tokens, img_embeds=img,
                                         mode="prefill", cache=caches[backend],
                                         backend=backend, rows=s - 1)
        counts = ops.launch_counts()
        expect = {n: 0 for n in counts}
        expect["flash_attention"] = cfg.count_kind("attn") if backend == "kernel" else 0
        if counts != expect:
            raise AssertionError(f"llama-vision prefill ({backend}, {dtype}) launches {counts}")
        if backend == "kernel":
            rec["flash_attention"].d["launches"] += counts["flash_attention"]
    errs, gaps, scale = [], [], 0.0
    for step in range(steps + 1):
        lk, le = logits["kernel"].float(), logits["eager"].float()
        errs.append((lk - le).abs().max().item())
        scale = max(scale, le[:, :cfg.vocab_size].abs().max().item())
        top = le.topk(2, dim=-1).values
        gap = (top[:, 0] - top[:, 1])
        differ = lk.argmax(-1) != le.argmax(-1)
        if bool(differ.any()):
            gaps.append(gap[differ].max().item())
        if not (torch.isfinite(lk).all() and errs[-1] <= tol
                and bool((gap[differ] < tol).all())):
            raise AssertionError(f"llama-vision {dtype} step {step}: kernel vs eager max abs "
                                 f"err {errs[-1]}, greedy tokens differ with top-2 gaps "
                                 f"{gap[differ].tolist()} (tolerance {tol})")
        if step == steps:
            break
        tok = le.argmax(-1)[:, None]
        for backend in ("kernel", "eager"):
            lg, _ = apply_model(params, cfg, tokens=tok, mode="decode",
                                cache=caches[backend], cache_index=s + step, backend=backend)
            logits[backend] = lg[:, 0]
    log("xattn", f"llama-3.2-vision-90b width, one group ({cfg.block_pattern}, "
        f"{cfg.param_count() / 1e9:.2f}e9 params {dtype}, {cfg.num_image_tokens} image "
        f"tokens): {b} x {s}-token prefill and {steps} decode steps, kernel vs eager logits "
        f"max abs err {max(errs):.3g} (tolerance {tol}, largest logit {scale:.3g}); greedy "
        f"tokens equal"
        + (f" except near-ties (top-2 gaps {gaps})" if gaps else "") + f"; {card}")
    del params, caches, logits, img


def phase_xattn(torch, rec, card):
    """llama-3.2-vision-90b at full width cut to one group (4 attn + 1
    xattn, d 8192, 64 heads on 8 KV, 1024 image tokens): prefill 2 x 128
    tokens, then 8 decode steps fed the eager backend's greedy tokens,
    kernel vs eager backend, in bf16 and then in fp32 (whose error must
    sit near the other fp32 kernel-vs-eager comparisons).  Then
    musicgen-medium at full width cut to 4 layers, fp32: prefill then
    decode against its train-mode forward."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import apply_model
    from repro_torch.models.params import init_params, padded_vocab
    from repro_torch.serving.kvcache import make_cache

    dev = torch.device("cuda")
    for dtype in ("bfloat16", "float32"):
        xattn_group(torch, rec, card, dtype)
        torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(62)
    b = 2

    mg = dataclasses.replace(get_config("musicgen-medium"), num_layers=4, dtype="float32",
                             param_dtype="float32")
    params = init_params(mg, generator=torch.Generator(device=dev).manual_seed(63), device=dev)
    s0, steps = 256, 8
    embeds = torch.randn(b, s0 + steps, mg.d_model, generator=g, device=dev) * 0.3
    ops.reset_launch_counts()
    with torch.no_grad():
        ref, _ = apply_model(params, mg, embeds=embeds, mode="train")
        cache = make_cache(mg, b, s0 + steps, device=dev)
        pl, cache = apply_model(params, mg, embeds=embeds[:, :s0], mode="prefill", cache=cache)
        errs = [(pl - ref[:, :s0]).abs().max().item()]
        for t in range(s0, s0 + steps):
            dl, cache = apply_model(params, mg, embeds=embeds[:, t:t + 1], mode="decode",
                                    cache=cache, cache_index=t)
            errs.append((dl[:, 0] - ref[:, t]).abs().max().item())
    counts = ops.launch_counts()
    if counts["flash_attention"] != 2 * mg.num_layers:
        raise AssertionError(f"musicgen forward + prefill launches {counts}")
    rec["flash_attention"].d["launches"] += counts["flash_attention"]
    tol = 1e-4 * max(1.0, ref[..., :mg.vocab_size].abs().max().item())
    if not max(errs) <= tol or tuple(ref.shape) != (b, s0 + steps, 4, padded_vocab(mg)):
        raise AssertionError(f"musicgen prefill/decode vs forward: errs {errs} > {tol}, "
                             f"logits {tuple(ref.shape)}")
    log("xattn", f"musicgen-medium width, 4 layers, fp32: {s0}-token prefill and {steps} "
        f"decode steps against the train-mode forward ({tuple(ref.shape)} codebook logits): "
        f"max abs err {max(errs):.3g} (tolerance {tol:.3g}); {card}")
    del params, ref, cache
    torch.cuda.empty_cache()


# --- the multi-chip dry run and the roofline ------------------------------------

# records' useful / counted FLOPs above this claim more work than was done
USEFUL_MAX = 1.05
# a roofline above the measured step by more than this claims the card
# could not run the step as fast as it did
ROOFLINE_MAX = 1.05
# the dry run's peak above its arguments against the eager step's peak
# above what was resident before it (the same buffers, counted or held)
PEAK_TOL = 0.05
# layers of each dry-run record: full width, depth cut so the phase counts
# in ~25 s rather than ~80 s
DRYRUN_LAYERS = 4


def phase_dryrun(torch, card):
    """``run_one`` for qwen1.5-0.5b and granite-moe-3b-a800m x the four
    shapes on 16 x 16, and qwen1.5-110b decode_32k on 2 x 16 x 16, each cut
    to ``DRYRUN_LAYERS`` layers."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.shapes import SHAPES

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    runs = [(a, sh, False) for a in ("qwen1.5-0.5b", "granite-moe-3b-a800m") for sh in SHAPES]
    runs.append(("qwen1.5-110b", "decode_32k", True))
    records = []
    t0 = time.perf_counter()
    try:
        for arch, shape, multi_pod in runs:
            records.append(dryrun.run_one(arch, shape, multi_pod=multi_pod, save=False,
                                          verbose=False,
                                          cfg_overrides={"num_layers": DRYRUN_LAYERS}))
    finally:
        mesh_lib.destroy_fake_group()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    if after != before:
        raise AssertionError(f"the dry run moved the card's memory_allocated: {before} -> "
                             f"{after}")
    for r in records:
        coll = r["collective_bytes_per_chip"]
        if not (r["useful_flops_ratio"] <= USEFUL_MAX
                and r["bottleneck"] in ("compute", "memory", "collective")
                and coll.get("total", 0) > 0):
            raise AssertionError(f"dry run {r['arch']} {r['shape']} {r['mesh']}: useful "
                                 f"{r['useful_flops_ratio']}, bottleneck {r['bottleneck']}, "
                                 f"collectives {coll}")
        log("dryrun", f"{r['arch']} {r['shape']} mesh {r['mesh']}: flops/chip "
            f"{r['hlo_flops_per_chip']:.4e}, bytes/chip {r['hlo_bytes_per_chip']:.4e}, "
            f"collectives/chip {coll['total']:.4e} B, peak/chip "
            f"{r['peak_mem_bytes_per_chip'] / 1e9:.3f} GB, t compute/memory/collective "
            f"{r['t_compute_s']:.4g}/{r['t_memory_s']:.4g}/{r['t_collective_s']:.4g} s, "
            f"bottleneck {r['bottleneck']}, useful {r['useful_flops_ratio']:.4f}, roofline "
            f"MFU {r['roofline_mfu']:.4f}, counted in {r['count_s']:.1f} s")
    log("dryrun", f"{len(records)} records ({DRYRUN_LAYERS} layers each) in {time.perf_counter() - t0:.1f} s on fake "
        f"tensors; memory_allocated {before} -> {after}; the host ran it, {card}")


def _median_s(torch, fn, warm=2, runs=7):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return sorted(times)[len(times) // 2]


def phase_roofline(torch, rec, card):
    """Real qwen1.5-0.5b steps on the card against ``run_one``'s roofline
    of the same step on a 1 x 1 mesh."""
    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import h100_peak_flops
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import apply_model
    from repro_torch.models.params import init_params
    from repro_torch.serving.kvcache import make_cache
    from repro_torch.training.optimizer import AdamW, cosine_schedule, tree_leaves
    from repro_torch.training.train_loop import make_train_step

    dev = torch.device("cuda")
    cfg = get_config("qwen1.5-0.5b")
    layers = cfg.count_kind("attn")
    peak = h100_peak_flops(cfg.dtype)
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(71), device=dev)
    param_bytes = sum(t.nbytes for t in tree_leaves(params))
    g = torch.Generator(device=dev).manual_seed(72)
    try:
        for what, info in (("prefill", dict(seq=4096, batch=4, mode="prefill")),
                           ("train", dict(seq=128, batch=8, mode="train"))):
            r = dryrun.run_one(cfg.name, f"roofline_{what}", mesh_shape=(1, 1), shape_info=info,
                               save=False, verbose=False)
            b, s = info["batch"], info["seq"]
            tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev)
            if what == "prefill":
                cache = {}

                def step(backend="kernel"):
                    with torch.no_grad():
                        cache["c"] = make_cache(cfg, b, s, device=dev)
                        logits, _ = apply_model(params, cfg, tokens=tokens, mode="prefill",
                                                cache=cache["c"], backend=backend)
                        return logits[:, -1]

                live = param_bytes
                launches_per = layers
            else:
                opt = AdamW(cosine_schedule(3e-4, 100, 10000))
                state = {"s": opt.init(params)}
                batch = {"tokens": tokens,
                         "labels": torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                                 device=dev)}
                steps = {bk: make_train_step(cfg, opt, backend=bk) for bk in ("kernel", "eager")}

                def step(backend="kernel"):
                    _, state["s"], m = steps[backend](params, state["s"], batch)
                    return m["loss"]

                live = param_bytes + sum(t.nbytes for t in tree_leaves(state["s"].mu)
                                         + tree_leaves(state["s"].nu))
                launches_per = 2 * layers
            if r["argument_bytes"] != live:
                raise AssertionError(f"roofline {what}: the dry run's argument bytes "
                                     f"{r['argument_bytes']} != the card's {live}")
            ops.reset_launch_counts()
            measured = _median_s(torch, step)
            counts = ops.launch_counts()
            want = {n: 0 for n in counts}
            want["flash_attention"] = 9 * launches_per
            if counts != want:
                raise AssertionError(f"roofline {what}: launches {counts}, want {want}")
            rec["flash_attention"].d["launches"] += counts["flash_attention"]
            if what == "prefill":
                cache.clear()
            gc.collect()  # garbage of the timed steps is not the eager step's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            step("eager")
            torch.cuda.synchronize()
            eager_peak = torch.cuda.max_memory_allocated()
            if what == "prefill":
                cache.clear()  # the eager prefill's cache is not the train step's
            # what each step holds above what it was given
            counted = r["peak_mem_bytes_per_chip"] - r["argument_bytes"]
            held = eager_peak - resident
            ratio = r["roofline_step_s"] / measured
            mfu = r["model_flops_global"] / (measured * peak)
            log("roofline", f"qwen1.5-0.5b {what} {b} x {s}, bf16, kernel backend: "
                f"roofline_step_s {r['roofline_step_s']:.6f} ({r['bottleneck']}; compute "
                f"{r['t_compute_s']:.6f}, memory {r['t_memory_s']:.6f} s), measured "
                f"{measured:.6f} s (median of 7), ratio {ratio:.4f} (<= {ROOFLINE_MAX}), mfu "
                f"{mfu:.4f} (model FLOPs {r['model_flops_global']:.4e}; counted "
                f"{r['hlo_flops_per_chip']:.4e}, bytes {r['hlo_bytes_per_chip']:.4e}); "
                f"argument bytes {r['argument_bytes']} = the card's; predicted peak "
                f"{r['peak_mem_bytes_per_chip'] / 2**30:.3f} GiB (arguments "
                f"{r['argument_bytes'] / 2**30:.3f}, {counted / 2**30:.3f} above) vs eager "
                f"max_memory_allocated {eager_peak / 2**30:.3f} GiB (resident before the step "
                f"{resident / 2**30:.3f}, {held / 2**30:.3f} above); flash launches "
                f"{counts['flash_attention']}; {card}")
            if not ratio <= ROOFLINE_MAX:
                raise AssertionError(f"roofline {what}: roofline {r['roofline_step_s']} s over "
                                     f"measured {measured} s is {ratio} > {ROOFLINE_MAX}")
            if not abs(counted - held) <= PEAK_TOL * held:
                raise AssertionError(f"roofline {what}: the dry run holds {counted} B above its "
                                     f"arguments, the eager step {held} B above what was "
                                     f"resident: more than {PEAK_TOL:.0%} apart")
    finally:
        mesh_lib.destroy_fake_group()
    del params
    torch.cuda.empty_cache()


# --- the last training options and the experiments that need them ------------------

# the fitted constants must reproduce every measured layer within e^0.25
# (the reference's own test bound on its residual ratios)
CALIB_LOG_RATIO = 0.25


def phase_calibrate(torch, rec, card):
    """``experiments/calibrate``: ``hmp`` and ``hmp_ring`` measured on the
    card (kernel backend, fp16) for the reference's DistilBERT scenario and
    GPT2-L cut to one layer on its served 3:2:2:1 plan.  Each scenario's
    host device is fitted to its own two measurements, as the reference
    fits its one scenario: the loss must fall and both residual ratios lie
    within e^0.25.  The joint fit of all four is printed (its loss must
    fall): the cost model prices the ring by compute, the card's ring costs
    launches.  Then each layer priced through ``make_step_pricer`` with its
    fitted device and with the Jetson Nano-L the serve's drift monitor
    uses: the drift ratios (measured / priced), printed as a check
    (``serve`` keeps its pricing)."""
    from repro_torch.core import costmodel
    from repro_torch.core.simulator import make_step_pricer
    from repro_torch.experiments import calibrate
    from repro_torch.kernels import ops

    scenarios = list(calibrate.SCENARIOS)
    iters = calibrate.ITERS
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    measured = calibrate.measure(device="cuda", backend="kernel", scenarios=scenarios)
    counts = ops.launch_counts()
    # a layer: hmp 16 ring GEMMs (4 a device), hmp_ring 64 (4 x D steps x D
    # devices); D attention launches and 2 connective sites each
    calls = (iters + 1) * len(scenarios)
    expect = dict.fromkeys(counts, 0)
    expect.update(tiled_gemm_valid=calls * (16 + 64), ragged_flash_attention=calls * 2 * 4,
                  fused_connective=calls * 2 * 2)
    if counts != expect:
        raise AssertionError(f"calibrate: launch counts {counts} != {expect}")
    for name in GALAXY_KERNELS:
        rec[name].d["launches"] += counts[name]
    reports = calibrate.calibrate_scenarios(measured, rounds=calibrate.ROUNDS, backend="kernel")
    for fit, report in reports.items():
        for line in calibrate.summary(report).splitlines():
            log("calibrate", f"{fit} fit: {line.strip()}")
    log("calibrate", f"measured in {time.perf_counter() - t0:.1f} s, kernel backend fp16, "
        f"{iters} calls a schedule; launches "
        f"{', '.join(f'{n} {counts[n]}' for n in GALAXY_KERNELS)}; {card}")
    for fit, report in reports.items():
        bad = {k: r for k, r in report["residual_ratio"].items()
               if not abs(math.log(r)) < CALIB_LOG_RATIO}
        if not report["loss"] < report["start_loss"] or (fit != "joint" and bad):
            raise AssertionError(f"calibrate {fit}: loss {report['start_loss']} -> "
                                 f"{report['loss']}, ratios outside e^{CALIB_LOG_RATIO}: {bad}")
    jetson = [costmodel.jetson_nano("nano-l", 4.0)] * len(calibrate.CAPS)
    for scenario in scenarios:
        constants = reports[scenario]["constants"]
        devices, link = calibrate.host_cluster(constants)
        cfg, eplan, seq = calibrate._plan_and_cfg(scenario)
        eplan = eplan.with_backend("kernel")
        for name, overlap in calibrate.SCHEDULES:
            key = calibrate._key(scenario, name)
            prev = costmodel.apply_calibration({"TILE_OVERHEAD": constants["tile_overhead"]})
            try:
                fitted = make_step_pricer(eplan, cfg, devices, link, overlap=overlap)(
                    "prefill", rows=seq, context=seq)
            finally:
                costmodel.apply_calibration(prev)
            nano = make_step_pricer(eplan, cfg, jetson, costmodel.mbps(1000), overlap=overlap)(
                "prefill", rows=seq, context=seq)
            log("calibrate", f"{key}: drift ratio (measured / priced) "
                f"{measured[key] / fitted:.4f} with the fitted device, "
                f"{measured[key] / nano:.6f} with the Jetson Nano-L the serve prices (a check; "
                "serve keeps its pricing)")


# the three remat policies' loss sequences agree to a bf16 rounding of the loss
REMAT_LOSS_REL = 2.0 ** -8
_GEMMS = ("mm", "addmm", "bmm", "baddbmm", "mv", "dot")


def _gemm_counter(torch):
    """A dispatch mode counting the products it sees (the autograd
    engine's threads carry it into the backward)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class GemmCount(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._overloadpacket.__name__ in _GEMMS:
                self.n += 1
            return func(*args, **(kwargs or {}))

    return GemmCount


def phase_remat_dots(torch, rec, card):
    """qwen1.5-0.5b at full width and depth, bf16, 8 x 128 tokens, 3 steps
    under remat "full", "dots" and "none" from the same weights and
    batches: step ms and peak memory each; the loss sequences agree to
    bf16 rounding, and "dots" runs fewer products in its backward than
    "full".  Then the fp32 RecurrentGemma group step, kernel vs eager,
    under "dots" (the flash and scan kernels relaunched in its recompute);
    then one qwen step with dropout 0.1: a finite loss, bitwise equal when
    repeated with the same seed."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, LMDataPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models.params import init_params
    from repro_torch.training import AdamW, cosine_schedule, make_train_step
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_loop import batch_to_device, loss_fn

    dev = torch.device("cuda")
    base = get_config("qwen1.5-0.5b")
    p0 = init_params(base, generator=torch.Generator(device=dev).manual_seed(81), device=dev)
    steps, batch, seq = 3, 8, 128
    runs, gemms = {}, {}
    pipe = LMDataPipeline(base, DataConfig(batch_size=batch, seq_len=seq))
    b0 = batch_to_device(next(iter(pipe)), dev)
    counter = _gemm_counter(torch)
    for policy in ("full", "dots", "none"):
        cfg = dataclasses.replace(base, remat=policy != "none", remat_policy=policy)
        ops.reset_launch_counts()
        out = launch_train.train(cfg, steps=steps, batch=batch, seq=seq, device=dev,
                                 params=_clone_tree(p0), log=lambda m: None)
        # the next policy's peak must not hold this one's weights and moments
        runs[policy] = {k: out[k] for k in ("losses", "median_step_s", "peak_bytes")}
        del out
        gc.collect()
        torch.cuda.empty_cache()
        counts = check_train_counts(ops, cfg, steps, f"qwen1.5-0.5b remat {policy}")
        rec["flash_attention"].d["launches"] += counts["flash_attention"]
        # products a step, forward alone and forward with backward
        params = _clone_tree(p0)
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        with counter() as fwd:
            loss, _ = loss_fn(params, b0, cfg)
        with counter() as step:
            loss, _ = loss_fn(params, b0, cfg)
            torch.autograd.grad(loss, leaves)
        gemms[policy] = (fwd.n, step.n - fwd.n)
        del params, leaves, loss
        torch.cuda.empty_cache()
    for policy, out in runs.items():
        log("remat", f"qwen1.5-0.5b {policy}: losses {out['losses']}, median step "
            f"{1e3 * out['median_step_s']:.2f} ms, peak memory {out['peak_bytes'] / 2**30:.3f} "
            f"GiB, products forward {gemms[policy][0]} / backward {gemms[policy][1]}; {card}")
    want = runs["full"]["losses"]
    for policy in ("dots", "none"):
        got = runs[policy]["losses"]
        if not all(abs(a - b) <= REMAT_LOSS_REL * abs(b) for a, b in zip(got, want)):
            raise AssertionError(f"remat {policy} losses {got} vs full {want}: apart by more "
                                 f"than {REMAT_LOSS_REL} relative")
    if not 0 < gemms["dots"][1] < gemms["full"][1]:
        raise AssertionError(f"remat dots backward products {gemms['dots'][1]}, full "
                             f"{gemms['full'][1]}: dots must run fewer")
    del runs
    torch.cuda.empty_cache()

    rg = dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=3, dtype="float32",
                             param_dtype="float32", remat_policy="dots")
    counts = train_step_pair(torch, rg, "recurrentgemma-9b width, one group, remat dots", card,
                             batch=4)
    for name in ZOO_KERNELS:
        rec[name].d["launches"] += counts[name]

    cfg = dataclasses.replace(base, dropout_rate=0.1)
    step = make_train_step(cfg, AdamW(cosine_schedule(1e-3, 1, 10)))
    outs = []
    ops.reset_launch_counts()
    for _ in range(2):
        params = _clone_tree(p0)
        opt = AdamW(cosine_schedule(1e-3, 1, 10))
        params, _, m = step(params, opt.init(params), b0, 5)
        outs.append((m["loss"], params["final_norm"]["scale"].clone()))
        del params
    counts = check_train_counts(ops, cfg, 2, "qwen1.5-0.5b dropout steps")
    rec["flash_attention"].d["launches"] += counts["flash_attention"]
    plain, _ = loss_fn(p0, b0, base)
    (l1, s1), (l2, s2) = outs
    if not (torch.isfinite(l1) and torch.equal(l1, l2) and torch.equal(s1, s2)):
        raise AssertionError(f"dropout step: losses {l1} / {l2}, params equal "
                             f"{torch.equal(s1, s2)}")
    log("remat", f"qwen1.5-0.5b dropout 0.1, step seed 5: loss {l1.item():.6f} twice, bitwise "
        f"(updated params too); without dropout {plain.item():.6f}; flash launches "
        f"{counts['flash_attention']}; {card}")
    del p0
    torch.cuda.empty_cache()


# the smoke's hillclimb runs each pair cut to this depth (both sides of each
# comparison); ``python -m repro_torch.experiments.hillclimb`` runs them whole
HILLCLIMB_LAYERS = 8


def phase_hillclimb(torch, card):
    """``experiments/hillclimb``: the six variants and the TP-only baseline
    with their baselines through ``run_one(save=False)`` on 16 x 16, each
    pair cut to 8 layers; each variant printed beside its baseline.  Fails
    on any error, unless "dots" counts fewer FLOPs a chip than "full", and
    unless query-chunked attention lowers codeqwen's prefill peak a chip
    (and does not raise granite's, whose peak is the MoE's combine buffer
    in a recompute, not attention)."""
    from repro_torch.experiments import hillclimb
    from repro_torch.roofline.report import variants_table

    t0 = time.perf_counter()
    records, failures = hillclimb.run(save=False, num_layers=HILLCLIMB_LAYERS,
                                      log=lambda m: log("hillclimb", m))
    if failures:
        raise AssertionError(f"hillclimb: {len(failures)} failed: {failures}")
    variants = [r for r in records.values() if r["variant"]]
    bases = [r for r in records.values() if not r["variant"]]
    for line in variants_table(variants, bases).splitlines():
        log("hillclimb", line)
    r = {key[2] or f"{key[0]}/{key[1]}": v for key, v in records.items()}
    full, dots = r["granite-moe-3b-a800m/train_4k"], r["h1a_remat_dots"]
    chunk_pairs = [(r["codeqwen1.5-7b/prefill_32k"], r["h3a_attnchunk"]),
                   (r["h1b_cf125"], r["h1c_attnchunk"])]
    if not dots["hlo_flops_per_chip"] < full["hlo_flops_per_chip"]:
        raise AssertionError(f"hillclimb: dots {dots['hlo_flops_per_chip']} FLOPs a chip, full "
                             f"{full['hlo_flops_per_chip']}")
    (pb, pv), (gb, gv) = chunk_pairs
    if not (pv["peak_mem_bytes_per_chip"] < pb["peak_mem_bytes_per_chip"]
            and gv["peak_mem_bytes_per_chip"] <= gb["peak_mem_bytes_per_chip"]):
        raise AssertionError(f"hillclimb: attn_chunk peaks codeqwen {pb['peak_mem_bytes_per_chip']}"
                             f" -> {pv['peak_mem_bytes_per_chip']}, granite "
                             f"{gb['peak_mem_bytes_per_chip']} -> {gv['peak_mem_bytes_per_chip']}")
    log("hillclimb", f"{len(records)} records ({HILLCLIMB_LAYERS} layers each) in "
        f"{time.perf_counter() - t0:.1f} s on fake tensors; the host ran it, {card}")


#: seconds the ranks of one four-rank run may take, start-up included
RANKS_TIMEOUT = 300


def _ranks_run(module, args, what):
    """``python -m module args`` from the checkout, as a user starts it;
    its standard output (it fails the phase if the run fails)."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    # a session of its own: if the launcher outlives its limit, its ranks
    # are stopped with it
    proc = subprocess.Popen([sys.executable, "-m", module, *args], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=RANKS_TIMEOUT + 60)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"{what}: still running after {RANKS_TIMEOUT + 60} s")
    if proc.returncode != 0:
        raise AssertionError(f"{what}: exit {proc.returncode}\n{out[-2000:]}\n{err[-4000:]}")
    log("ranks", f"{what}: done in {time.perf_counter() - t0:.1f} s, start-up included")
    return out


def ranks_serve(rec, card, what, local, extra, requests=8, trace=False):
    """``launch.serve --ranks 4`` with phase 5's traffic (``requests`` of
    them) plus ``extra``: every rank's tokens equal the ``LocalRing``
    serve's (``local``), its launches exact for one held device (and the
    draft's, on the draft's rank alone) and on their fast paths, its stats
    and registry counters equal to rank 0's.  The ranks' launches add to
    the kernels' records.  Returns rank 0's standard output, its serve
    line, every rank's report and (``trace``) rank 0's trace events."""
    events = None
    with tempfile.TemporaryDirectory() as tmp:
        stdout = _ranks_run("repro_torch.launch.serve", [
            "--model", "gpt2-l", "--capacities", "3,2,2,1", "--ranks", "4",
            "--requests", str(requests), "--prompt-len", "37-300", "--max-new", "16",
            "--max-batch", "4", "--page-size", "16", "--dtype", "float16", "--seed", "0",
            "--rank-timeout", str(RANKS_TIMEOUT), "--report", tmp, *extra]
            + (["--trace", str(Path(tmp) / "trace.json")] if trace else []), what)
        reps = [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(4)]
        if trace:
            events = json.loads((Path(tmp) / "trace.json").read_text())["traceEvents"]
    line = next(json.loads(t) for t in stdout.splitlines() if t.startswith('{"ranks"'))
    if (line["ranks"], line["transport"]) != (4, "gloo"):
        raise AssertionError(f"{what}: serve line {line}")
    want = {str(uid): toks for uid, toks in local.items()}
    st = reps[0]["stats"]
    where = line["draft_device"]
    for r, rep in enumerate(reps):
        if rep["tokens"] != want:
            bad = [u for u in want if rep["tokens"].get(u) != want[u]]
            raise AssertionError(f"{what}: rank {r} tokens differ from the LocalRing serve's "
                                 f"for requests {bad}")
        if rep["stats"] != st or rep["counters"] != reps[0]["counters"]:
            raise AssertionError(f"{what}: rank {r} stats {rep['stats']} / counters "
                                 f"{rep['counters']} != rank 0's {st} / {reps[0]['counters']}")
        draft = rep["draft"]
        if (draft is not None) != (r == where):
            raise AssertionError(f"{what}: rank {r} draft {draft}, the draft's device is "
                                 f"{where}")
        expect = galaxy_expect(st, held=1, draft=None if draft is None else
                               types.SimpleNamespace(**draft))
        counts = {n: rep["launches"][n] for n in expect}
        if counts != expect or any(rep["launches"][n] for n in ZOO_KERNELS + ("tiled_gemm",)):
            raise AssertionError(f"{what}: rank {r} launches {rep['launches']} != {expect}")
        paths = rep["paths"]
        fast = {"tiled_gemm_valid": ("mma", "fma"), "ragged_flash_attention": ("mma", "simt"),
                "fused_connective": ("warp", "loop")}
        for n, (good, slow) in fast.items():
            if paths[n][good] != counts[n] or paths[n][slow]:
                raise AssertionError(f"{what}: rank {r} {n} off its fast path: {paths[n]}")
        if set(rep["routes"]) != {"host-staged"} or rep["hops"] <= 0:
            raise AssertionError(f"{what}: rank {r} hops {rep['hops']} by {rep['routes']}")
    for n in GALAXY_KERNELS:
        rec[n].d["launches"] += sum(rep["launches"][n] for rep in reps)
    expect = galaxy_expect(st, held=1)
    log("ranks", f"{what}: 4 ranks' tokens equal the LocalRing serve's for all "
        f"{len(want)} requests; launches per rank "
        f"{', '.join(f'{n} {expect[n]}' for n in GALAXY_KERNELS)} (as expected from "
        f"{st['prefill_oneshots']} one-shot and {st['prefill_chunks']} chunk prefills, "
        f"{st['spec_steps']} verify chunks, {st['decode_steps'] - st['spec_steps']} decode "
        f"steps)" + ("" if where is None else
                     f", plus the draft's on rank {where} alone ({reps[where]['draft']})")
        + ", all on the fast paths")
    log("ranks", f"{what}: hop route {reps[0]['routes']}; hops per rank "
        f"{[rep['hops'] for rep in reps]}, bytes per hop "
        f"{[round(rep['hop_bytes'] / rep['hops']) for rep in reps]}")
    log("ranks", f"{what}: {line['new_tokens']} new tokens in {line['seconds']:.2f} s: "
        f"{line['tokens_per_s']:.2f} tok/s, TTFT p50 {1e3 * line['ttft_p50_s']:.1f} ms on "
        f"4 ranks time-slicing one card, not four devices ({card})")
    return stdout, line, reps, events


def spec_ranks_serve(rec, card, local):
    """Phase 14's fp16 spec serve across the four ranks with all three
    telemetry flags: the checks of ``ranks_serve``, then the spec stats,
    rank 0's trace spans and the drift and metrics reports."""
    what = "4-rank spec + telemetry serve"
    stdout, line, reps, events = ranks_serve(
        rec, card, what, local, ["--draft-model", "distilbert", "--spec-k", "4",
                                 "--metrics", "--drift"], requests=4, trace=True)
    st = line["stats"]
    if st["spec_steps"] < 1:
        raise AssertionError(f"{what}: no verify chunk ran: {st}")
    spans = {e["name"] for e in events if e["ph"] == "X"}
    if not {"spec_round", "draft_propose", "spec_verify"} <= spans:
        raise AssertionError(f"{what}: rank 0's trace has spans {sorted(spans)}")
    for needle in ("  spec_verify: n=", "metrics snapshot:",
                   f"repro_spec_steps_total {st['spec_steps']}"):
        if needle not in stdout:
            raise AssertionError(f"{what}: rank 0 printed no {needle.strip()!r}")
    drift = [t.strip() for t in stdout.splitlines() if t.startswith("  ") and ": n=" in t]
    log("ranks", f"{what}: draft on rank {line['draft_device']} (place_draft), k 4: "
        f"{st['spec_steps']} verify chunks, acceptance {st['spec_acceptance']:.3f}, accepted "
        f"per round {st['spec_accept_counts']}; rank 0's trace {len(events)} events with "
        f"no open span; drift {drift}")


def phase_ranks(torch, rec, card, local):
    """Galaxy across processes (phase 34): the two four-rank serves,
    ``launch.ring_times``, then the four-rank spec and telemetry serve."""
    gc.collect()
    torch.cuda.empty_cache()
    ranks_serve(rec, card, "4-rank serve", local["serve"], [])
    ranks_serve(rec, card, "4-rank prefix-cache + chunk serve", local["prefix"],
                ["--shared-prefix", "256", "--prefix-cache", "on", "--prefill-chunk", "128"])
    out = _ranks_run("repro_torch.launch.ring_times",
                     ["--ranks", "4", "--timeout", str(RANKS_TIMEOUT)], "ring_times --ranks 4")
    res = json.loads(out.strip().splitlines()[-1])
    ring = {"tiled_gemm_valid": 576, "ragged_flash_attention": 36, "fused_connective": 72}
    want = {"ring": ring, "ring_double_buffer": ring,
            "sync": {**ring, "tiled_gemm_valid": 144}}
    for rr in res["per_rank"]:
        for sched, counts in want.items():
            got = {n: rr["launches"][sched][n] for n in counts}
            if got != counts:
                raise AssertionError(f"ring_times: rank {rr['rank']} {sched} prefill "
                                     f"launches {rr['launches'][sched]} != {counts}")
        for sched, err in rr["logit_err_vs_sync"].items():
            if not (math.isfinite(err) and err < GALAXY_FP16_TOL):
                raise AssertionError(f"ring_times: {sched} vs sync logits differ by {err}")
    per = res["per_rank"]
    log("ranks", f"hop of a {res['pad_tile']} x 1280 fp16 tile ({per[0]['hop_bytes']} bytes, "
        f"route {per[0]['routes']}): median per rank "
        f"{[round(rr['hop_ms'], 3) for rr in per]} ms, min "
        f"{[round(rr['hop_ms_min'], 3) for rr in per]} ms ({card})")
    ms = {s: [round(rr["prefill_ms"][s], 1) for rr in per] for s in want}
    log("ranks", f"prefill of GPT2-L 36 layers fp16 at S {res['seq']} on 4 ranks, medians per "
        f"rank: ring with double buffering {ms['ring_double_buffer']} ms, without "
        f"{ms['ring']} ms (the pair differs only in overlap), sync {ms['sync']} ms "
        f"(its psum all-gathers whole partials); launches per rank exact (576/144 GEMMs, "
        f"36 attention, 72 connectives); logits vs sync max abs err "
        f"{per[0]['logit_err_vs_sync']} ({card})")
    spec_ranks_serve(rec, card, local["spec"])


#: phase 35's question to gloo: each collective the zoo's mesh issues, on a
#: cuda:0 tensor over a pair of gloo ranks joined without the staging of
#: ``core/ring.stage_mesh_collectives``, held to its exact result; the
#: all-gather last, since it may kill the ranks.  Each result is written
#: to DIR/<collective>.<rank> as it ends.
_GLOO_PROBE = r"""
import sys
from pathlib import Path
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
a = sys.argv
out = Path(a[1])
rank, init = int(a[a.index("--rank") + 1]), a[a.index("--init-method") + 1]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
torch.cuda.set_device(0)
g = dist.group.WORLD
x = (torch.arange(8.0) + 100 * rank).cuda()
every = torch.stack([torch.arange(8.0) + 100 * r for r in range(2)])
probes = {
    "reduce_scatter_tensor": (lambda: funcol.reduce_scatter_tensor(torch.cat([x, x]), "sum", 0, g),
                              every.sum(0)),
    "all_reduce": (lambda: funcol.all_reduce(x, "sum", g), every.sum(0)),
    "broadcast": (lambda: funcol.broadcast(x, 0, g), every[0]),
    "all_to_all_single": (lambda: funcol.all_to_all_single(x, None, None, g),
                          torch.cat([every[r].chunk(2)[rank] for r in range(2)])),
    "all_gather_into_tensor": (lambda: funcol.all_gather_tensor(x, 0, g), every.reshape(-1)),
}
for name, (run, want) in probes.items():
    try:
        got = run().wait().cpu()
        said = "ok" if torch.equal(got, want) else f"wrong: {got.tolist()}"
    except RuntimeError as e:
        said = f"refused: {e}"[:200]
    (out / f"{name}.{rank}").write_text(said)
dist.barrier()
dist.destroy_process_group()
"""
GLOO_PROBES = ("reduce_scatter_tensor", "all_reduce", "broadcast", "all_to_all_single",
               "all_gather_into_tensor")


def gloo_probe():
    """Which collectives gloo takes on CUDA tensors as they are:
    {collective: "ok" | "wrong: ..." | "refused: ..." | "killed its ranks: ..."
    | "not asked"}; a collective after the one the ranks died in is not
    asked."""
    from repro_torch.launch import ranks as rank_procs

    said, died = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        try:
            rank_procs.launch([sys.executable, "-c", _GLOO_PROBE, tmp], 2, timeout=120,
                              capture=True)
        except rank_procs.RankFailure as e:
            died = str(e).strip().splitlines()[0].rstrip(":")
        killed = False
        for name in GLOO_PROBES:
            files = [Path(tmp, f"{name}.{r}") for r in range(2)]
            if all(f.exists() for f in files):
                texts = sorted({f.read_text() for f in files})
                said[name] = texts[0] if len(texts) == 1 else f"wrong: ranks said {texts}"
            elif died is None:
                raise AssertionError(f"gloo probe: the ranks ended without asking {name}")
            else:
                said[name] = "not asked" if killed else f"killed its ranks: {died}"
                killed = True
    return said


#: the four ranks of phase 35 (a): phase 7's prefill and decode steps
#: under the HMP rules in fp32, then on the same weights cast to bf16, each
#: rank's logits and counts written to DIR
_ZOO_RANKS_WORKER = r"""
import dataclasses, json, sys
from pathlib import Path
import torch
a = sys.argv
out = Path(a[1])
rank, init = int(a[a.index("--rank") + 1]), a[a.index("--init-method") + 1]
from repro_torch.launch import ranks
ring, dev = ranks.init(rank, 4, init, timeout=300)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from repro_torch.configs import get_config
from repro_torch.core.ring import MESH_STAGED
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.params import init_params, local_bytes
from repro_torch.models.sharding import make_rules
from repro_torch.serving.engine import TransformerExecutor
toks = json.loads((out / "tokens.json").read_text())
cfg = dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=5, dtype="float32",
                          param_dtype="float32")
rules = make_rules(make_mesh((1, 4), ("data", "model"), device="cuda"), "prefill")
params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(5), device=dev,
                     rules=rules)
b, s = 2, 2100
tokens = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(6))
def cast(tree, dtype):
    return {k: cast(v, dtype) if isinstance(v, dict) else v.to(dtype) for k, v in tree.items()}
res = {"weight_bytes": local_bytes(params)}
for dtype in ("float32", "bfloat16"):
    c = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
    ex = TransformerExecutor(cast(params, getattr(torch, dtype)), c, backend="kernel",
                             rules=rules)
    ops.reset_launch_counts()
    logits, cache = ex.prefill(tokens, ex.make_cache(b, s + len(toks)))
    prefill, paths = ops.launch_counts(), ops.path_counts()
    outs = [logits.float().cpu()]
    for step, tok in enumerate(toks):
        logits, cache = ex.decode(torch.tensor(tok, device=dev)[:, None], cache, s + step)
        outs.append(logits.float().cpu())
    torch.cuda.synchronize()
    res[dtype] = {"logits": outs, "prefill": prefill, "paths": paths,
                  "all": ops.launch_counts()}
    del ex, cache
res.update(staged=dict(MESH_STAGED), peak=torch.cuda.max_memory_allocated())
torch.save(res, out / f"rank{rank}.pt")
ranks.finish()
"""

#: phase 35 (a)'s fp32 tolerance: the same kernels on each rank's shards,
#: the row-parallel sums split over the ranks adding in another order
#: (phase 7's kernel-vs-eager bound)
ZOO_RANKS_TOL = 1e-4
#: phase 35 (a)'s bf16 tolerance, in bf16 units (2**-7 relative) of the
#: largest one-process logit: bf16 rounds each rank's partial sums and
#: every activation, so the ranks and one process may part by a few units
ZOO_BF16_UNITS = 4


def rank_weight_bytes(cfg, ranks: int) -> int:
    """The bytes of RecurrentGemma's weights one rank should hold on a (data
    1, model ``ranks``) mesh, reckoned apart from the rules: the whole
    model's bytes (``param_bytes``) split ``ranks`` ways, but for the leaves
    every rank holds whole: the norms' scales, and wk and wv, whose one KV
    head is not split."""
    from repro_torch.models.params import _leaves, abstract_params, param_bytes

    kept = sum(leaf.numel() * leaf.element_size()
               for path, leaf in _leaves(abstract_params(cfg))
               if path[-1] in ("scale", "wk", "wv"))
    return (param_bytes(cfg) - kept) // ranks + kept


def bf16_unit(logits) -> float:
    """One bf16 unit in the last place at the largest |logit|."""
    return 2.0 ** (math.floor(math.log2(logits.abs().max().item())) - 7)


def cast_tree(tree, dtype):
    return {k: cast_tree(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def zoo_one_bf16(torch, tokens):
    """Phase 7's 5-layer model cast to bf16 on one process, kernel and eager
    backends: the logits of the 2 x 2100 prefill and of each decode step
    fed ``tokens``."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import TransformerExecutor

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=5,
                              dtype="float32", param_dtype="float32")
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(5),
                         device=dev)
    cfg = dataclasses.replace(cfg, dtype="bfloat16", param_dtype="bfloat16")
    params = cast_tree(params, torch.bfloat16)
    b, s = 2, 2100
    prompt = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(6))
    out = {}
    for backend in ("kernel", "eager"):
        ex = TransformerExecutor(params, cfg, backend=backend)
        logits, cache = ex.prefill(prompt, ex.make_cache(b, s + len(tokens)))
        outs = [logits.float().cpu()]
        for step, tok in enumerate(tokens):
            logits, cache = ex.decode(torch.tensor(tok, device=dev)[:, None], cache, s + step)
            outs.append(logits.float().cpu())
        out[backend] = outs
        del ex, cache
    return out


def zoo_ranks_parity(torch, card, ref):
    """Phase 35 (a): the four ranks' fp32 logits against phase 7's, and
    their bf16 logits against one process's on the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.launch import ranks as rank_procs

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        Path(tmp, "tokens.json").write_text(json.dumps(ref["tokens"]))
        try:  # the launcher puts the checkout's src/ on the ranks' path
            rank_procs.launch([sys.executable, "-c", _ZOO_RANKS_WORKER, tmp], 4,
                              timeout=RANKS_TIMEOUT, capture=True)
        except rank_procs.RankFailure as e:
            raise AssertionError(f"zoo ranks parity: {e}")
        reps = [torch.load(Path(tmp, f"rank{r}.pt")) for r in range(4)]
    t_ranks = time.perf_counter() - t0
    want = {"flash_attention": 1, "rglru_scan": 4}
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=5, dtype="float32",
                              param_dtype="float32")
    shard_bytes = rank_weight_bytes(cfg, 4)
    for r, rep in enumerate(reps):
        if rep["weight_bytes"] != shard_bytes:
            raise AssertionError(f"zoo ranks parity: rank {r} holds {rep['weight_bytes']} bytes "
                                 f"of weights, not the {shard_bytes} reckoned for its shards")
        for dtype, flash_path in (("float32", "simt"), ("bfloat16", "mma")):
            run = rep[dtype]
            got = {n: run["prefill"][n] for n in want}
            if got != want or run["all"] != run["prefill"]:
                raise AssertionError(f"zoo ranks parity {dtype}: rank {r} launches "
                                     f"{run['prefill']} in the prefill, {run['all']} in all; "
                                     f"want {want}, none in decode")
            if (run["paths"]["flash_attention"][flash_path] != 1
                    or run["paths"]["rglru_scan"]["tma"] != 4):
                raise AssertionError(f"zoo ranks parity {dtype}: rank {r} paths {run['paths']}")
            for i, (got, base) in enumerate(zip(run["logits"], reps[0][dtype]["logits"])):
                if not torch.equal(got, base):
                    raise AssertionError(f"zoo ranks parity {dtype}: rank {r}'s logits at step "
                                         f"{i} differ from rank 0's")
    errs = []
    for i, (got, want_l) in enumerate(zip(reps[0]["float32"]["logits"], ref["logits"])):
        e = (got - want_l).abs().max().item()
        if not e <= ZOO_RANKS_TOL:
            raise AssertionError(f"zoo ranks parity: step {i} logits vs one process: max abs "
                                 f"err {e} > {ZOO_RANKS_TOL}")
        errs.append(e)
    one = zoo_one_bf16(torch, ref["tokens"])
    unit = max(bf16_unit(t) for t in one["kernel"])
    e_ranks = max((g - w).abs().max().item()
                  for g, w in zip(reps[0]["bfloat16"]["logits"], one["kernel"]))
    e_backends = max((k - e).abs().max().item() for k, e in zip(one["kernel"], one["eager"]))
    if not e_ranks <= ZOO_BF16_UNITS * unit:
        raise AssertionError(f"zoo ranks parity bf16: logits vs one process max abs err "
                             f"{e_ranks} > {ZOO_BF16_UNITS} bf16 units ({unit})")
    log("zoo ranks", f"(a) RecurrentGemma-9B width, 5 layers fp32 on 4 ranks (kernel backend, "
        f"flash on the 'simt' fp32 path and scan on 'tma' on each rank's shards): every "
        f"rank's logits bitwise equal; vs phase 7's one-process kernel logits max abs err "
        f"prefill {errs[0]:.3g}, decode {max(errs[1:]):.3g} (tolerance {ZOO_RANKS_TOL})")
    log("zoo ranks", f"(a) the same weights cast to bf16, the same prefill and decode tokens "
        f"(flash on 'mma'): every rank's logits bitwise equal; vs one process max abs err "
        f"{e_ranks:.4g} = {e_ranks / unit:.2f} bf16 units of the largest logit ({unit}; "
        f"tolerance {ZOO_BF16_UNITS}); one process kernel vs eager backend {e_backends:.4g} "
        f"= {e_backends / unit:.2f} units")
    log("zoo ranks", f"(a) weights a rank {[rep['weight_bytes'] for rep in reps]} bytes "
        f"(reckoned {shard_bytes}), peak {[round(rep['peak'] / 2**30, 2) for rep in reps]} GiB; "
        f"staged collectives rank 0 {reps[0]['staged']}; ranks {t_ranks:.1f} s with "
        f"start-up ({card})")


def teacher_forced_gaps(ex, waves, prompts, served, max_len, torch):
    """One process fed the tokens the ranks served, wave by wave as the
    engine ran them (the prompts' prefill, then a decode step per served
    token): for each request and step, the gap between the one-process top
    logit and the logit of the token served there."""
    import numpy as np

    gaps = {}
    for uids in waves:
        toks = torch.tensor([served[u] for u in uids], device=ex.device)
        (s,) = {len(prompts[u]) for u in uids}  # a wave of one prompt length
        logits, cache = ex.prefill(np.array([prompts[u] for u in uids]),
                                   ex.make_cache(len(uids), max_len))
        for step in range(toks.shape[1]):
            lf = logits.float()
            gap = lf.max(-1).values - lf.gather(1, toks[:, step:step + 1])[:, 0]
            for u, g in zip(uids, gap.tolist()):
                gaps.setdefault(u, []).append(g)
            if step + 1 < toks.shape[1]:
                logits, cache = ex.decode(toks[:, step:step + 1], cache, s + step)
    return gaps


def zoo_ranks_serve(torch, rec, card, one):
    """Phase 35 (b): ``launch.serve --executor zoo --ranks 4`` with phase
    8's traffic against phase 8's tokens and time."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain
    from repro_torch.launch.serve import build_zoo_executor

    what = "4-rank zoo serve"
    lens, max_new = [300] * 4 + [2100] * 2, 4
    with tempfile.TemporaryDirectory() as tmp:
        stdout = _ranks_run("repro_torch.launch.serve", [
            "--executor", "zoo", "--model", "recurrentgemma-9b", "--ranks", "4",
            "--prompt-lens", ",".join(map(str, lens)), "--max-new", str(max_new),
            "--max-batch", "4", "--dtype", "bfloat16", "--seed", "0",
            "--rank-timeout", str(RANKS_TIMEOUT), "--report", tmp], what)
        reps = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(4)]
    line = next(json.loads(t) for t in stdout.splitlines() if t.startswith('{"ranks"'))
    if (line["ranks"], line["transport"]) != (4, "gloo"):
        raise AssertionError(f"{what}: serve line {line}")
    waves = line["stats"]["prefill_waves"]
    want = {"flash_attention": 12 * waves, "rglru_scan": 26 * waves}
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), dtype="bfloat16",
                              param_dtype="bfloat16")
    shard_bytes = rank_weight_bytes(cfg, 4)
    for r, rep in enumerate(reps):
        if rep["tokens"] != reps[0]["tokens"]:
            raise AssertionError(f"{what}: rank {r}'s tokens differ from rank 0's")
        got = {n: rep["launches"][n] for n in want}
        if waves != 2 or got != want or sum(rep["launches"].values()) != sum(want.values()):
            raise AssertionError(f"{what}: rank {r} launches {rep['launches']} in {waves} "
                                 f"waves; want {want}")
        paths = rep["paths"]
        if (paths["flash_attention"] != {"mma": want["flash_attention"], "simt": 0}
                or paths["rglru_scan"] != {"tma": want["rglru_scan"], "simt": 0}):
            raise AssertionError(f"{what}: rank {r} off the fast paths: {paths}")
        if rep["weight_bytes"] != shard_bytes:
            raise AssertionError(f"{what}: rank {r} holds {rep['weight_bytes']} bytes of "
                                 f"weights, not the {shard_bytes} reckoned for its shards")
    for n in ZOO_KERNELS:
        rec[n].d["launches"] += sum(rep["launches"][n] for rep in reps)

    # every served token against one process fed the same tokens: the ranks'
    # token is the one-process argmax, or within twice the bf16 logit
    # disagreement of phase 8's two one-process backends of it
    served = {int(u): t for u, t in reps[0]["tokens"].items()}
    ex = build_zoo_executor(get_config("recurrentgemma-9b"), device=torch.device("cuda"),
                            dtype="bfloat16", seed=0)
    gaps = teacher_forced_gaps(ex, [[0, 1, 2, 3], [4, 5]], one["prompts"], served,
                               max(lens) + max_new, torch)
    del ex
    torch.cuda.empty_cache()
    limit = 2 * one["bf16_err"]
    flat = [g for u in sorted(gaps) for g in gaps[u]]
    if len(flat) != len(lens) * max_new or not all(math.isfinite(g) for g in flat):
        raise AssertionError(f"{what}: teacher-forced gaps {gaps}")
    off = {u: [(j, round(g, 5)) for j, g in enumerate(gaps[u]) if g > 0] for u in sorted(gaps)}
    if not max(flat) <= limit:
        raise AssertionError(f"{what}: a served token's one-process logit is {max(flat)} below "
                             f"the top, more than {limit}: {off}")
    parted = {u: next((j for j, (x, y) in enumerate(zip(served[u], one["tokens"][u]))
                       if x != y), None) for u in sorted(served)}

    # rank 0's distinct kernel calls, replayed in the served dtype
    g = torch.Generator(device="cuda").manual_seed(35)
    calls = reps[0]["kernel_calls"]
    ferr = serr = 0.0
    # (under the rules a chunk's offset is a host int: no call takes kv_len)
    for (qs, qst, ks, kst, vst, dtype, causal, window, has_len), _ in calls["flash_attention"]:
        if has_len:
            raise AssertionError(f"{what}: a flash call under the rules took kv_len")
        q = strided_randn(qs, qst, dtype, g, torch)
        k = strided_randn(ks, kst, dtype, g, torch)
        v = strided_randn(ks, vst, dtype, g, torch)
        out = flash_attention(q, k, v, causal=causal, window=window)
        plain = flash_attention_plain(q, k, v, causal=causal, window=window)
        ferr = max(ferr, check_close("flash_attention", out, plain, dtype,
                                     f"rank 0's q {qs} kv {ks} window {window}"))
    for (shape, dtype, h0_dtype), _ in calls["rglru_scan"]:
        a = torch.rand(shape, generator=g, device="cuda").to(getattr(torch, dtype))
        b = torch.randn(shape, generator=g, device="cuda").to(getattr(torch, dtype))
        h0 = torch.randn((shape[0], shape[2]), generator=g,
                         device="cuda").to(getattr(torch, h0_dtype))
        got, want_s = rglru_scan(a, b, h0), rglru_scan_plain(a, b, h0)
        serr = max(serr, check_close("rglru_scan", got[0], want_s[0], dtype,
                                     f"rank 0's scan {shape}"))
    torch.cuda.synchronize()
    rec["flash_attention"].err(ferr)
    rec["rglru_scan"].err(serr)
    log("zoo ranks", f"(b) {what}: 4 ranks' tokens bitwise equal; each request's first token "
        f"unlike phase 8's {parted}; one process fed the ranks' {len(flat)} tokens: "
        f"{sum(g == 0 for g in flat)} its argmax, the others below its top logit by "
        f"{off} (max {max(flat):.4g}; limit {limit:.4g}, twice phase 8's kernel-vs-eager "
        f"bf16 logit error {one['bf16_err']:.4g})")
    log("zoo ranks", f"(b) launches a rank {want} in {waves} waves on mma / tma; rank 0's "
        f"distinct calls replayed vs plain in bf16: flash {len(calls['flash_attention'])} "
        f"(q/kv {[(c[0][0], c[0][2]) for c in calls['flash_attention']]}) max abs err "
        f"{ferr:.3g}, scan {len(calls['rglru_scan'])} "
        f"({[c[0][0] for c in calls['rglru_scan']]}) max abs err {serr:.3g}")
    log("zoo ranks", f"(b) weights a rank {[rep['weight_bytes'] for rep in reps]} bytes "
        f"(reckoned {shard_bytes}, of {rank_weight_bytes(cfg, 1)} whole); peak memory a rank "
        f"{[round(rep['peak_memory_bytes'] / 2**30, 2) for rep in reps]} GiB; staged "
        f"collectives rank 0 (calls, bytes sent) {reps[0]['staged_collectives']}")
    log("zoo ranks", f"(b) {line['new_tokens']} new tokens in {line['seconds']:.2f} s: "
        f"{line['tokens_per_s']:.2f} tok/s, TTFT p50 {1e3 * line['ttft_p50_s']:.1f} ms; phase "
        f"8's one process {one['tokens_per_s']:.2f} tok/s, TTFT p50 "
        f"{1e3 * one['ttft_p50_s']:.1f} ms: ratio {line['tokens_per_s'] / one['tokens_per_s']:.3f}"
        f" in this run; 4 ranks time-slicing one card, not four devices ({card})")


def phase_zoo_ranks(torch, rec, card, ref, one):
    """The zoo under the HMP rules on four ranks (phase 35): the gloo
    probe, (a) phase 7's parity on the ranks, (b) phase 8's serve on them."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log("zoo ranks", f"gloo on CUDA tensors, unstaged: {gloo_probe()} "
        f"({time.perf_counter() - t0:.1f} s)")
    zoo_ranks_parity(torch, card, ref)
    t0 = time.perf_counter()
    zoo_ranks_serve(torch, rec, card, one)
    log("zoo ranks", f"(b) {time.perf_counter() - t0:.1f} s with start-up")


# --- the zoo's paged protocol under the HMP rules across ranks ----------------------

#: the four ranks of phase 36 (a) and (c): (a) phase 10's paged calls
#: under the HMP rules in fp32, each call's logits, launches and staged
#: collectives; (c) qwen1.5-0.5b served with and without a draft on rank
#: 0; each rank's results written to DIR
_ZOO_PAGED_WORKER = r"""
import dataclasses, json, sys
from pathlib import Path
import torch
a = sys.argv
out = Path(a[1])
rank, init = int(a[a.index("--rank") + 1]), a[a.index("--init-method") + 1]
from repro_torch.launch import ranks
ring, dev = ranks.init(rank, 4, init, timeout=300)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from repro_torch.configs import get_config
from repro_torch.core.ring import MESH_STAGED
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import serve
from repro_torch.models.params import init_params, local_bytes
from repro_torch.models.sharding import make_rules
from repro_torch.serving.engine import TransformerExecutor
inp = torch.load(out / "inputs.pt")
cfg = dataclasses.replace(get_config("stablelm-12b"), num_layers=4, dtype="float32",
                          param_dtype="float32")
rules = make_rules(make_mesh((1, 4), ("data", "model"), device="cuda"), "prefill")
params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(7), device=dev,
                     rules=rules)
ex = TransformerExecutor(params, cfg, backend="kernel", rules=rules)
s, page, chunk, shared, width = (inp[k] for k in ("s", "page", "chunk", "shared", "width"))
ta, tb = inp["a"].to(dev), inp["b"].to(dev)
def staged():
    return {k: v[0] for k, v in MESH_STAGED.items()}
def since(before):
    return {k: n - before.get(k, 0) for k, n in staged().items() if n > before.get(k, 0)}
res = {"weight_bytes": local_bytes(params), "logits": [], "staged": {}}
pool = ex.make_pool(1 + 3 * width, page)
rows = [list(range(1 + i * width, 1 + (i + 1) * width)) for i in range(3)]
ops.reset_launch_counts()
lo, pool = ex.prefill_paged(ta, pool, rows[0], length=s)
res["logits"].append(lo.float().cpu())
for off in range(0, ta.shape[1], chunk):
    before = staged()
    lc, pool = ex.prefill_chunk(ta[:, off:off + chunk], pool, rows[1], offset=off, length=s)
    res["staged"].setdefault("chunk", since(before))
    res["logits"].append(lc.float().cpu())
rows[2][:shared // page] = rows[0][:shared // page]
lh, pool = ex.prefill_chunk(tb[:, shared:], pool, rows[2], offset=shared, length=s)
res["logits"].append(lh.float().cpu())
res["prefill"], res["paths"] = ops.launch_counts(), ops.path_counts()
table = torch.tensor([rows[0], rows[2]], device=dev)
for step, tok in enumerate(inp["tokens"]):
    before = staged()
    lg, pool = ex.decode_paged(tok.to(dev)[:, None], pool, table,
                               torch.full((2,), s + step, device=dev))
    res["staged"].setdefault("decode_paged", since(before))
    res["logits"].append(lg.float().cpu())
res["all"] = ops.launch_counts()
before = staged()  # a lockstep wave decode step of the same batch
ex.decode(inp["tokens"][0].to(dev)[:, None], ex.make_cache(2, s + len(inp["tokens"])), s)
res["staged"]["decode"] = since(before)
torch.cuda.synchronize()
res["peak"] = torch.cuda.max_memory_allocated()
del ex, params, pool
torch.cuda.empty_cache()

# (c) speculative decoding across the ranks, the draft on rank 0
traffic = dict(executor_kind="zoo", requests=inp["spec_requests"], prompt_len=inp["spec_len"],
               max_new=inp["spec_new"], device=dev, dtype="bfloat16", seed=0, ring=ring)
spec = {}
for name, kw in (("off", {}), ("on", {"draft_model": "qwen1.5-0.5b", "spec_k": 4})):
    ops.reset_launch_counts()
    got = serve("qwen1.5-0.5b", **traffic, **kw,
                **({"executor": spec["executor"]} if spec else {}))
    spec["executor"] = got["executor"]
    spec[name] = {"tokens": {r.uid: r.output for r in got["requests"]},
                  "prompts": {r.uid: r.prompt for r in got["requests"]},
                  "stats": got["stats"], "launches": ops.launch_counts(),
                  "draft": None if got["spec"] is None else
                  {"prefills": got["spec"].prefills, "steps": got["spec"].steps},
                  "draft_device": got["draft_device"]}
# where spec on and off part, the top-2 gap of the mesh executor's logits
ex = spec.pop("executor")
gaps = {}
for uid, toks in spec["off"]["tokens"].items():
    other = spec["on"]["tokens"][uid]
    j = next((i for i, (x, y) in enumerate(zip(toks, other)) if x != y), None)
    if j is None:
        continue
    seq = spec["off"]["prompts"][uid] + toks[:j]
    n = -(-len(seq) // 16) * 16
    t = torch.zeros((1, n), dtype=torch.long, device=dev)
    t[0, :len(seq)] = torch.tensor(seq, device=dev)
    logits, _ = ex.prefill_paged(t, ex.make_pool(1 + n // 16, 16), list(range(1, 1 + n // 16)),
                                 length=len(seq))
    top = logits.float()[0].topk(2).values
    gaps[uid] = (j, (top[0] - top[1]).item(), top[0].item())
spec["gaps"] = gaps
for name in ("off", "on"):
    spec[name].pop("prompts")
res["spec"] = spec
torch.cuda.synchronize()
torch.save(res, out / f"rank{rank}.pt")
ranks.finish()
"""

#: the bytes of the StableLM-12B pool a rank holds a token on four ranks:
#: K and V, 40 layers, its 2 of the 8 KV heads, 160 wide, bf16
STABLELM_RANK_TOKEN_BYTES = 2 * 40 * 2 * 160 * 2


def zoo_paged_parity(torch, card, dense):
    """Phase 36 (a) and (c) on one launch of four ranks: (a) phase 10's
    paged calls on the ranks against phase 10's one-process kernel logits;
    (c) the qwen1.5-0.5b spec serve against spec off.  Returns the ranks'
    results (for the flash launches they add)."""
    from repro_torch.launch import ranks as rank_procs

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({**{k: v for k, v in dense.items() if k != "logits"},
                    "spec_requests": 2, "spec_len": (64, 256), "spec_new": 4},
                   Path(tmp, "inputs.pt"))
        try:  # the launcher puts the checkout's src/ on the ranks' path
            rank_procs.launch([sys.executable, "-c", _ZOO_PAGED_WORKER, tmp], 4,
                              timeout=RANKS_TIMEOUT, capture=True)
        except rank_procs.RankFailure as e:
            raise AssertionError(f"zoo paged ranks: {e}")
        reps = [torch.load(Path(tmp, f"rank{r}.pt")) for r in range(4)]
    t_ranks = time.perf_counter() - t0
    n_prefill = 2 + -(-dense["a"].shape[1] // dense["chunk"])
    want = {"flash_attention": 4 * n_prefill}
    for r, rep in enumerate(reps):
        if {n: rep["prefill"][n] for n in want} != want or rep["all"] != rep["prefill"]:
            raise AssertionError(f"zoo paged ranks (a): rank {r} launches {rep['prefill']} in the "
                                 f"prefill calls, {rep['all']} in all; want {want}, none in "
                                 f"decode")
        if rep["paths"]["flash_attention"] != {"simt": want["flash_attention"], "mma": 0}:
            raise AssertionError(f"zoo paged ranks (a): rank {r} paths {rep['paths']}")
        for i, (got, base) in enumerate(zip(rep["logits"], reps[0]["logits"])):
            if not torch.equal(got, base):
                raise AssertionError(f"zoo paged ranks (a): rank {r}'s logits of call {i} differ "
                                     f"from rank 0's")
        if rep["staged"]["decode_paged"] != rep["staged"]["decode"]:
            raise AssertionError(f"zoo paged ranks (a): rank {r} stages "
                                 f"{rep['staged']['decode_paged']} a decode_paged step, "
                                 f"{rep['staged']['decode']} a lockstep decode step")
    errs = [(got - want_l).abs().max().item()
            for got, want_l in zip(reps[0]["logits"], dense["logits"])]
    if len(errs) != len(dense["logits"]) or not max(errs) <= ZOO_RANKS_TOL:
        raise AssertionError(f"zoo paged ranks (a): logits vs phase 10's one process: max abs "
                             f"errs {errs} (tolerance {ZOO_RANKS_TOL})")
    steps = len(dense["tokens"])
    log("zoo paged", f"(a) StableLM-12B width, 4 layers fp32 on 4 ranks (kernel backend, each "
        f"rank's 8 of 32 heads on 2 of 8 KV heads): one-shot {dense['s']}-token prefill, "
        f"{n_prefill - 2} chunks of {dense['chunk']}, a prefix-hit suffix over "
        f"{dense['shared'] // dense['page']} shared pages, {steps} decode steps of two slots: "
        f"every rank's logits bitwise equal; vs phase 10's one-process kernel logits max abs "
        f"err prefill {max(errs[:-steps]):.3g}, decode {max(errs[-steps:]):.3g} (tolerance "
        f"{ZOO_RANKS_TOL}); flash {want['flash_attention']} a rank on 'simt', none in decode")
    log("zoo paged", f"(a) staged a rank (calls by collective): a {dense['chunk']}-token chunk "
        f"{reps[0]['staged']['chunk']}, a decode_paged step of 2 slots "
        f"{reps[0]['staged']['decode_paged']} = a lockstep decode step "
        f"{reps[0]['staged']['decode']}; weights a rank "
        f"{[rep['weight_bytes'] for rep in reps]} bytes, peak "
        f"{[round(rep['peak'] / 2**30, 2) for rep in reps]} GiB; ranks {t_ranks:.1f} s with "
        f"start-up and (c) ({card})")
    return reps


def zoo_spec_ranks(reps, rec):
    """Phase 36 (c): the four ranks' qwen1.5-0.5b serves, with the draft on
    rank 0 and without: tokens bitwise equal on every rank, spec on equal
    to spec off up to near-ties (each printed), the draft's launches on rank
    0 alone, at least one verify chunk."""
    from repro_torch.configs import get_config

    layers = get_config("qwen1.5-0.5b").num_layers
    on0, off0 = reps[0]["spec"]["on"], reps[0]["spec"]["off"]
    st = on0["stats"]
    if st["spec_steps"] < 1 or on0["draft_device"] != 0 or on0["draft"] is None:
        raise AssertionError(f"zoo spec ranks (c): no verify chunk or no draft on rank 0: {st}, "
                             f"draft {on0['draft']} on {on0['draft_device']}")
    for r, rep in enumerate(reps):
        for name in ("off", "on"):
            got = rep["spec"][name]
            if got["tokens"] != reps[0]["spec"][name]["tokens"] or got["stats"] != \
                    reps[0]["spec"][name]["stats"]:
                raise AssertionError(f"zoo spec ranks (c): rank {r}'s spec-{name} tokens or "
                                     f"stats differ from rank 0's")
            s = got["stats"]
            target = layers * (s["prefill_oneshots"] + s["prefill_chunks"] + s["spec_steps"])
            draft = got["draft"]
            if (draft is not None) != (name == "on" and r == 0):
                raise AssertionError(f"zoo spec ranks (c): rank {r} holds draft {draft}")
            want = target + (0 if draft is None else layers * draft["prefills"])
            if got["launches"]["flash_attention"] != want or sum(got["launches"].values()) != want:
                raise AssertionError(f"zoo spec ranks (c): rank {r} spec {name} launches "
                                     f"{got['launches']}, want flash {want}")
        rec["flash_attention"].d["launches"] += sum(rep["spec"][n]["launches"]["flash_attention"]
                                                    for n in ("off", "on"))
    parted = []
    for uid, (j, gap, top) in sorted(reps[0]["spec"]["gaps"].items()):
        lim = ZOO_BF16_UNITS * 2.0 ** (math.floor(math.log2(abs(top))) - 7)
        if not gap <= lim:
            raise AssertionError(f"zoo spec ranks (c): request {uid} parts from spec off at token "
                                 f"{j} with a top-2 gap {gap} > {lim}")
        parted.append(f"request {uid} at token {j}, top-2 gap {gap:.4g} <= {lim:.4g}")
    log("zoo paged", f"(c) qwen1.5-0.5b bf16 on 4 ranks, drafted by qwen1.5-0.5b (seed + 2) on "
        f"rank 0, k 4: tokens bitwise equal on every rank; {st['spec_steps']} verify chunks, "
        f"acceptance {st['spec_acceptance']:.3f}; the draft's {on0['draft']['prefills']} "
        f"prefills ({layers} flash each) and {on0['draft']['steps']} steps on rank 0 alone; "
        f"vs the 4-rank spec-off serve: "
        + ("all tokens equal" if not parted else "near-ties " + "; ".join(parted)))


def paged_teacher_forced(ex, eager, prompts, served, torch, chunk=256, page=16):
    """One process fed the tokens the ranks served, through the paged
    protocol as the engine feeds a prompt: each prompt in ``chunk``-token
    chunks, then its served tokens but the last as one chunk at the
    prompt's end.  For each request and position, the gap between the top
    logit and the served token's; and the largest kernel-vs-eager logit
    difference of the same calls (``eager``: the same weights on the eager
    backend)."""
    gaps, err = {}, 0.0
    for uid in sorted(served):
        prompt, toks = prompts[uid], served[uid]
        s = len(prompt)
        s_pad = -(-s // page) * page
        n_pages = -(-(s + len(toks)) // page) + 1
        rows = {}
        for name, e in (("kernel", ex), ("eager", eager)):
            pool = e.make_pool(1 + n_pages, page)
            row = list(range(1, 1 + n_pages))
            t = torch.zeros((1, s_pad), dtype=torch.long, device=e.device)
            t[0, :s] = torch.tensor(prompt, device=e.device)
            for off in range(0, s_pad, chunk):
                logits, pool = e.prefill_chunk(t[:, off:off + chunk], pool, row, offset=off,
                                               length=s)
                if off <= s - 1 < off + chunk:
                    first = logits[0, s - 1 - off].float()
            tail = torch.tensor([toks[:-1]], device=e.device)
            logits, pool = e.prefill_chunk(tail, pool, row, offset=s, length=s + tail.shape[1])
            rows[name] = torch.cat([first[None], logits[0].float()])
        err = max(err, (rows["kernel"] - rows["eager"]).abs().max().item())
        lf = rows["kernel"]
        idx = torch.tensor(toks, device=lf.device)[:, None]
        gaps[uid] = (lf.max(-1).values - lf.gather(1, idx)[:, 0]).tolist()
    return gaps, err


#: phase 36 (b)'s traffic: phase 11's cut to 3 requests on 2 slots, the
#: fewest of which one is admitted after a prompt entered the prefix tree,
#: behind a 256-token shared prompt, and 4 new tokens
ZOO_PAGED_TRAFFIC = dict(requests=3, prompt_len=(64, 512), shared_prefix=256, max_new=4,
                         max_batch=2, page_size=16, prefix_cache=True, prefill_chunk=256)


def zoo_paged_serve(torch, rec, card):
    """Phase 36 (b): ``launch.serve --executor zoo --model stablelm-12b
    --ranks 4`` with ``ZOO_PAGED_TRAFFIC``, against one process serving the
    same traffic and fed the ranks' tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serving.engine import TransformerExecutor

    what = "4-rank StableLM-12B continuous serve"
    tr = ZOO_PAGED_TRAFFIC
    with tempfile.TemporaryDirectory() as tmp:
        stdout = _ranks_run("repro_torch.launch.serve", [
            "--executor", "zoo", "--model", "stablelm-12b", "--ranks", "4",
            "--requests", str(tr["requests"]), "--prompt-len", "-".join(map(str, tr["prompt_len"])),
            "--shared-prefix", str(tr["shared_prefix"]), "--prefix-cache", "on",
            "--prefill-chunk", str(tr["prefill_chunk"]), "--max-new", str(tr["max_new"]),
            "--max-batch", str(tr["max_batch"]), "--page-size", str(tr["page_size"]),
            "--dtype", "bfloat16", "--seed", "0", "--rank-timeout", str(RANKS_TIMEOUT),
            "--report", tmp], what)
        reps = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(4)]
    line = next(json.loads(t) for t in stdout.splitlines() if t.startswith('{"ranks"'))
    st = line["stats"]
    if (line["ranks"], line["transport"]) != (4, "gloo") or "continuous scheduler" not in stdout:
        raise AssertionError(f"{what}: serve line {line}")
    if st["prefix_hits"] < 1 or st["prefill_chunks"] < 1:
        raise AssertionError(f"{what}: no prefix hit or no chunk: {st}")
    layers = get_config("stablelm-12b").num_layers
    calls = st["prefill_oneshots"] + st["prefill_chunks"]
    want = layers * calls
    for r, rep in enumerate(reps):
        if rep["tokens"] != reps[0]["tokens"] or rep["stats"] != st:
            raise AssertionError(f"{what}: rank {r}'s tokens or stats differ from rank 0's")
        if (rep["launches"]["flash_attention"] != want
                or sum(rep["launches"].values()) != want
                or rep["paths"]["flash_attention"] != {"mma": want, "simt": 0}):
            raise AssertionError(f"{what}: rank {r} launches {rep['launches']} paths "
                                 f"{rep['paths']['flash_attention']}; want flash {want} on mma")
        pool = rep["pool"]
        if pool["bytes"] != pool["pages"] * pool["page_size"] * STABLELM_RANK_TOKEN_BYTES:
            raise AssertionError(f"{what}: rank {r} holds {pool} of the pool, not "
                                 f"{STABLELM_RANK_TOKEN_BYTES} B a position")
    rec["flash_attention"].d["launches"] += sum(rep["launches"]["flash_attention"] for rep in reps)

    # the same traffic on one process, then every served token against one
    # process fed the same tokens: the one-process argmax, or within twice
    # its kernel-vs-eager bf16 logit difference over the same calls
    served = {int(u): t for u, t in reps[0]["tokens"].items()}
    out = launch_serve.serve("stablelm-12b", executor_kind="zoo", device="cuda",
                             dtype="bfloat16", seed=0, **tr)
    one = {"tokens": {r.uid: r.output for r in out["requests"]},
           "prompts": {r.uid: r.prompt for r in out["requests"]},
           "tokens_per_s": out["tokens_per_s"], "ttft_p50_s": out["ttft_p50_s"]}
    if out["stats"] != st:
        raise AssertionError(f"{what}: stats {st}, one process's {out['stats']}")
    ex = out.pop("executor")
    del out
    eager = TransformerExecutor(ex.params, ex.cfg, backend="eager")
    gaps, bf16_err = paged_teacher_forced(ex, eager, one["prompts"], served, torch)
    del ex, eager
    torch.cuda.empty_cache()
    limit = 2 * bf16_err
    flat = [g for u in sorted(gaps) for g in gaps[u]]
    if len(flat) != sum(map(len, served.values())) or not all(math.isfinite(g) for g in flat):
        raise AssertionError(f"{what}: teacher-forced gaps {gaps}")
    off = {u: [(j, round(g, 5)) for j, g in enumerate(gaps[u]) if g > 0] for u in sorted(gaps)}
    if not max(flat) <= limit:
        raise AssertionError(f"{what}: a served token's one-process logit is {max(flat)} below "
                             f"the top, more than {limit}: {off}")
    parted = {u: next((j for j, (x, y) in enumerate(zip(served[u], one["tokens"][u]))
                       if x != y), None) for u in sorted(served)}
    staged = {k: v[0] for k, v in reps[0]["staged_collectives"].items()}
    log("zoo paged", f"(b) {what}, bf16, full depth ({st['prefill_oneshots']} one-shot and "
        f"{st['prefill_chunks']} chunk prefills, {st['prefix_hits']} prefix hits, "
        f"{st['cached_prefix_tokens']} cached tokens, {st['decode_steps']} decode steps): "
        f"tokens and stats bitwise equal on the 4 ranks, each rank's pool refcounts checked; "
        f"flash {want} a rank ({layers} a prefill call) on mma, no other kernel")
    log("zoo paged", f"(b) one process fed the ranks' {len(flat)} tokens: "
        f"{sum(g == 0 for g in flat)} its argmax, the others below its top logit by {off} (max "
        f"{max(flat):.4g}; limit {limit:.4g}, twice its kernel-vs-eager bf16 logit difference "
        f"{bf16_err:.4g} over the same calls); first token unlike the one-process serve's "
        f"at {parted}")
    log("zoo paged", f"(b) a rank: pool {reps[0]['pool']['pages']} pages of "
        f"{reps[0]['pool']['page_size']}, {reps[0]['pool']['bytes']} B "
        f"({STABLELM_RANK_TOKEN_BYTES} B a position); weights "
        f"{[rep['weight_bytes'] for rep in reps]} B; peak "
        f"{[round(rep['peak_memory_bytes'] / 2**30, 2) for rep in reps]} GiB; staged on rank 0 "
        f"(calls by collective) {staged} over {calls} prefill calls and "
        f"{st['decode_steps']} decode steps")
    log("zoo paged", f"(b) {line['new_tokens']} new tokens in {line['seconds']:.2f} s: "
        f"{line['tokens_per_s']:.2f} tok/s, TTFT p50 {1e3 * line['ttft_p50_s']:.1f} ms; one "
        f"process on the same traffic {one['tokens_per_s']:.2f} tok/s, TTFT p50 "
        f"{1e3 * one['ttft_p50_s']:.1f} ms: ratios {line['tokens_per_s'] / one['tokens_per_s']:.3f}"
        f" and {line['ttft_p50_s'] / one['ttft_p50_s']:.2f} in this run; 4 ranks time-slicing "
        f"one card, not four devices ({card})")


def phase_zoo_paged_ranks(torch, rec, card, dense):
    """The zoo's paged protocol under the HMP rules on four ranks (phase
    36): the flash kernel at a rank's StableLM chunk shape, (a) phase 10's
    paged calls and (c) a spec serve on one launch of the ranks, (b) phase
    11's serve, cut in count, on them."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(36)
    # a rank's share of phase 9's chunk: 8 of 32 heads on 2 of 8 KV heads
    check_time_flash(rec, torch, g, "rank StableLM chunk", 1, 8, 2, 256, 1024 + 256, 160,
                     97 * 16)
    reps = zoo_paged_parity(torch, card, dense)
    zoo_spec_ranks(reps, rec)
    log("zoo paged", f"(a) and (c) {time.perf_counter() - t0:.1f} s with start-up")
    t0 = time.perf_counter()
    zoo_paged_serve(torch, rec, card)
    log("zoo paged", f"(b) {time.perf_counter() - t0:.1f} s with start-up")


# --- phase 37: the paged decode step captured as one CUDA graph ------------------

GRAPH_STEPS = 20  # timed steps a block; blocks eager, replay, replay, eager


def eager_vs_replay(eager, replay, n, torch):
    """An eager step against its replay, each ``call(i)`` giving the i-th
    call's logits: the wall ms of ``n`` calls (host inputs to synced
    logits) in blocks eager, replay, replay, eager (the median of each),
    the replay's device ms a call back to back (events), the kernel ms of
    one eager and one replayed call in the profiler's trace (None where
    the trace holds none) and so the card's idle share of each wall."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    def block(call):
        ts = []
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(i).argmax(-1).cpu()  # the engine's sampling sync
            ts.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(ts))

    eager_ms = [block(eager)]
    replay_ms = [block(replay), block(replay)]
    eager_ms.append(block(eager))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(n):
        replay(i)
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / n

    def busy(call):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call(0)
            torch.cuda.synchronize()
        t = sum(e.device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        return t or None

    busy_ms = {"eager": busy(eager), "replay": busy(replay)}
    walls = {"eager": float(np.median(eager_ms)), "replay": float(np.median(replay_ms))}
    idle = {k: "not measured" if v is None else f"{100 * (1 - v / walls[k]):.1f} %"
            for k, v in busy_ms.items()}
    return eager_ms, replay_ms, device_ms, busy_ms, idle


def _ms(v):
    return "not measured" if v is None else f"{v:.3f}"


def graph_step_check(ex, pool, vocab, torch, card, what):
    """One decode step of ``ex`` replayed and run eagerly on copies of one
    pool at the served geometry (``pool``: the serve's ``PagedKVPool``;
    pages drawn at random, the slots at 95/70/45/20 % of their rows):
    logits and pages bitwise equal.  Then the step's wall time, host
    inputs to synced logits as the engine takes it, eager against replay
    in one call (blocks eager, replay, replay, eager, the median of
    ``GRAPH_STEPS`` steps each), and the replay's device time (events)."""
    import numpy as np

    from repro_torch.serving.graphs import leaves

    n, w, page = pool.num_slots, pool.pages_per_slot, pool.page_size
    eager = copy.copy(ex)
    eager.graphs = False
    ex.graphs = True
    storage = ex.make_pool(pool.num_pages, page)  # the held pool: graphs on
    g = torch.Generator(device="cuda").manual_seed(37)
    for leaf in leaves(storage):
        leaf.normal_(generator=g)
    table = np.arange(1, 1 + n * w).reshape(n, w)
    pos = (np.array([0.95, 0.7, 0.45, 0.2])[np.arange(n) % 4] * w * page).astype(np.int64)
    tok = np.random.default_rng(37).integers(0, vocab, (n, 1))
    ex.decode_paged(tok, storage, table, pos)  # the warm-up step, then the capture
    twin = _clone_tree(storage)
    got, _ = ex.decode_paged(tok, storage, table, pos)
    want, _ = eager.decode_paged(tok, twin, table, pos)
    if not torch.equal(got, want) or not all(
            torch.equal(a, b) for a, b in zip(leaves(storage), leaves(twin))):
        raise AssertionError(f"{what}: a replayed decode step differs from the eager step: "
                             f"logits max diff {(got.float() - want.float()).abs().max().item()}")
    stats = ex.graph_stats["decode"]
    if (stats["captures"], stats["replays"]) != (1, 1):
        raise AssertionError(f"{what}: graph stats {stats}")

    eager_ms, replay_ms, device_ms, busy_ms, idle = eager_vs_replay(
        lambda i: eager.decode_paged(tok, twin, table, pos)[0],
        lambda i: ex.decode_paged(tok, storage, table, pos)[0], GRAPH_STEPS, torch)
    log("graphs", f"{what}: a replayed step's logits and pages bitwise equal to the eager "
        f"step's ({n} slots x {w} pages of {page}, positions {pos.tolist()}); step wall ms "
        f"eager {eager_ms[0]:.3f} / replay {replay_ms[0]:.3f} / replay {replay_ms[1]:.3f} / "
        f"eager {eager_ms[1]:.3f} (median of {GRAPH_STEPS} each, host inputs to synced "
        f"logits), replay device {device_ms:.3f} ms a step back to back; kernel time of one "
        f"step in the profiler's trace eager {_ms(busy_ms['eager'])} / replay "
        f"{_ms(busy_ms['replay'])} ms, so the card idles {idle['eager']} / {idle['replay']} of the step's wall; capture "
        f"{stats['capture_ms']:.1f} ms, graph pool {stats['pool_bytes']} B, allocated "
        f"after it {stats['allocated_bytes']} B ({card})")
    ex.graphs = False
    return {"eager_ms": eager_ms, "replay_ms": replay_ms, "replay_device_ms": device_ms,
            "busy_ms": busy_ms, "capture_ms": stats["capture_ms"],
            "pool_bytes": stats["pool_bytes"]}


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_clone_tree(v) for v in tree]
    return tree.clone()


def run_graph_line(gs):
    """One serve's own graph stats (``launch.serve``'s ``graph_stats`` of a
    side), kind by kind: captures, replays and capture ms."""
    return ", ".join(f"{k} {gs[k]['captures']}/{gs[k]['replays']} ({gs[k]['capture_ms']:.1f} ms)"
                     for k in ("decode", "prefill", "chunk") if gs[k]["captures"]
                     or gs[k]["replays"])


def phase_graphs_galaxy(torch, card, out):
    """Phase 37, Galaxy: phase 5's traffic served again on phase 5's
    executor with ``graphs=True``, and (h) twice more on the same executor,
    which keeps its graphs and held pool: each serve's tokens bitwise equal
    to phase 5's, phase 5's exact launch counts (576 ``tiled_gemm_valid`` a
    decode step, 2304 a one-shot prefill, all on ``mma``); the first serve
    one decode capture, the second none (every decode step and one-shot
    prefill replayed), the third no capture at all.  Then
    ``graph_step_check`` and (g) ``graph_prefill_check``."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve

    what = "GPT2-L fp16 Galaxy, graphs on"
    n_req, max_new = 8, 16
    eager = {r.uid: r.output for r in out["requests"]}
    runs = []
    for run in range(3):
        ops.reset_launch_counts()
        got = launch_serve.serve("gpt2-l", (3, 2, 2, 1), requests=n_req, prompt_len=(37, 300),
                                 max_new=max_new, max_batch=4, device="cuda",
                                 dtype="float16", seed=0, executor=out["executor"],
                                 graphs=True)
        torch.cuda.synchronize()
        counts, steps = ops.launch_counts(), got["stats"]["decode_steps"]
        if {r.uid: r.output for r in got["requests"]} != eager:
            raise AssertionError(f"{what}, serve {run + 1}: served tokens differ from phase "
                                 "5's eager serve")
        expect = dict.fromkeys(counts, 0)
        expect.update({"tiled_gemm_valid": n_req * 2304 + steps * 576,
                       "ragged_flash_attention": n_req * 144, "fused_connective": n_req * 72})
        if counts != expect or got["stats"] != out["stats"]:
            raise AssertionError(f"{what}, serve {run + 1}: launches {counts}, stats "
                                 f"{got['stats']}; want {expect}, {out['stats']}")
        check_galaxy_paths(ops, what)
        gs = got["graph_stats"]["target"]
        runs.append((got, gs))
        dec, pre = gs["decode"], gs["prefill"]
        want_dec = (1, steps - 1) if run == 0 else (0, steps)
        if (dec["captures"], dec["replays"]) != want_dec:
            raise AssertionError(f"{what}, serve {run + 1}: decode graph stats {dec} over "
                                 f"{steps} decode steps")
        if run and (pre["shapes"] or pre["replays"] != n_req):
            raise AssertionError(f"{what}, serve {run + 1}: one-shot prefill graph stats "
                                 f"{pre} over {n_req} prefills")
    if any(runs[2][1][k]["captures"] for k in ("decode", "prefill", "chunk")):
        raise AssertionError(f"{what}: the third serve captured: {runs[2][1]}")
    got, stats = runs[0][0], runs[0][1]["decode"]
    log("graphs", f"{what}: {n_req} requests' tokens bitwise equal to phase 5's; "
        f"tiled_gemm_valid {counts['tiled_gemm_valid']} launches = {n_req} x 2304 + {steps} "
        f"x 576, all mma; 1 capture ({stats['capture_ms']:.1f} ms, pool "
        f"{stats['pool_bytes']} B), {stats['replays']} replays; {got['new_tokens']} new "
        f"tokens in {got['seconds']:.2f} s: {got['tokens_per_s']:.1f} tok/s, TTFT p50 "
        f"{1e3 * got['ttft_p50_s']:.1f} ms (phase 5's eager serve {out['tokens_per_s']:.1f} "
        f"tok/s; not a claim: one serve each) ({card})")
    pre = runs[0][1]["prefill"]
    log("graphs", f"(h) {what}, three serves on one executor, each bitwise phase 5's tokens, "
        f"stats and launches: captures/replays (capture ms) by kind: "
        + "; ".join(f"serve {i + 1}: {run_graph_line(gs)}, {g['tokens_per_s']:.1f} tok/s, "
                    f"TTFT p50 {1e3 * g['ttft_p50_s']:.1f} ms" for i, (g, gs) in enumerate(runs))
        + f"; {pre['shapes']} padded prompt lengths, prefill graph pool "
        f"{runs[2][1]['prefill']['pool_bytes']} B, held pool "
        f"{runs[2][1]['paged_pool']['bytes']} B (not a claim: one serve each) ({card})")
    ops.reset_launch_counts()
    ex = out["executor"]
    graph_step_check(ex, got["pool"], ex.embed.shape[0], torch, card, "GPT2-L fp16 decode step")
    counts = ops.launch_counts()["tiled_gemm_valid"]
    # the warm-up step, the checked replay and eager step, 2 x GRAPH_STEPS
    # eager and 3 x GRAPH_STEPS replayed timed steps, one eager and one
    # replayed profiled step: 576 each
    want = 576 * (5 + 5 * GRAPH_STEPS)
    if counts != want or ops.path_counts()["tiled_gemm_valid"]["fma"]:
        raise AssertionError(f"{what}: the step check launched {counts} GEMMs, want {want} "
                             "on mma")
    ops.reset_launch_counts()
    graph_prefill_check(ex, got["pool"], 288, (283, 275), ex.embed.shape[0], torch, card,
                        "GPT2-L fp16 one-shot prefill")
    counts, calls = ops.launch_counts(), 8 + 5 * GRAPH_CHUNKS
    want = {"tiled_gemm_valid": 2304 * calls, "ragged_flash_attention": 144 * calls,
            "fused_connective": 72 * calls}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"{what}: the prefill check launched {counts}, want {want}")
    check_galaxy_paths(ops, what)


def phase_graphs_dense(torch, card, out):
    """Phase 37, the zoo: phase 11's traffic served again on phase 11's
    StableLM-12B executor with ``graphs=True``: tokens bitwise equal to
    phase 11's, flash exactly 40 a prefill call and no other kernel, one
    capture; then ``graph_step_check``."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve

    what = "StableLM-12B bf16 zoo, graphs on"
    ops.reset_launch_counts()
    got = launch_serve.serve("stablelm-12b", executor_kind="zoo", requests=8,
                             prompt_len=(64, 512), shared_prefix=1024, max_new=16,
                             max_batch=4, page_size=16, prefix_cache=True,
                             prefill_chunk=256, device="cuda", dtype="bfloat16", seed=0,
                             executor=out["executor"], graphs=True)
    torch.cuda.synchronize()
    if {r.uid: r.output for r in got["requests"]} != {r.uid: r.output
                                                      for r in out["requests"]}:
        raise AssertionError(f"{what}: served tokens differ from phase 11's eager serve")
    if got["stats"] != out["stats"]:
        raise AssertionError(f"{what}: stats {got['stats']}, phase 11's {out['stats']}")
    check_zoo_flash_counts(ops, None, got, what)
    steps = got["stats"]["decode_steps"]
    stats = got["graph_stats"]["target"]["decode"]
    if (stats["captures"], stats["replays"]) != (1, steps - 1):
        raise AssertionError(f"{what}: graph stats {stats} over {steps} decode steps")
    chunk = got["graph_stats"]["target"]["chunk"]
    check_chunk_graph_stats(chunk, got["stats"]["prefill_chunks"], what)
    if chunk["replays"] < 1:
        raise AssertionError(f"{what}: no chunk was replayed: {chunk}")
    log("graphs", f"{what}: 8 requests' tokens and stats bitwise equal to phase 11's; flash "
        f"{ops.launch_counts()['flash_attention']} launches, no other kernel; decode 1 "
        f"capture ({stats['capture_ms']:.1f} ms, pool {stats['pool_bytes']} B), "
        f"{stats['replays']} replays; chunks: {got['stats']['prefill_chunks']} in "
        f"{chunk['shapes']} shapes, {chunk['captures']} captures ({chunk['capture_ms']:.1f} "
        f"ms, pool {chunk['pool_bytes']} B), {chunk['replays']} replays; "
        f"{got['new_tokens']} new tokens in {got['seconds']:.2f} s: "
        f"{got['tokens_per_s']:.1f} tok/s, TTFT p50 {1e3 * got['ttft_p50_s']:.1f} ms (phase "
        f"11's eager serve {out['tokens_per_s']:.1f} tok/s, TTFT p50 "
        f"{1e3 * out['ttft_p50_s']:.1f} ms; not a claim: one serve each) ({card})")
    ex = out["executor"]
    graph_step_check(ex, got["pool"], ex.cfg.vocab_size, torch, card,
                     "StableLM-12B bf16 decode step")
    for rows, offsets in ((256, (1024, 1157)), (5, (1029, 1500))):
        graph_chunk_check(ex, got["pool"], rows, offsets, ex.cfg.vocab_size, torch, card,
                          f"StableLM-12B bf16 {rows}-row chunk")
    ops.reset_launch_counts()
    graph_prefill_check(ex, got["pool"], 256, (250, 241), ex.cfg.vocab_size, torch, card,
                        "StableLM-12B bf16 one-shot prefill")
    counts, want = ops.launch_counts(), 40 * (8 + 5 * GRAPH_CHUNKS)
    if counts["flash_attention"] != want or sum(counts.values()) != want:
        raise AssertionError(f"{what}: the prefill check launched {counts}, want {want} flash")
    check_flash_paths(ops, counts, what)


def check_chunk_graph_stats(chunk, calls, what):
    """A serve's chunk graphs: each shape's first call eager, its second
    captured, every later one replayed."""
    if (chunk["replays"] != calls - chunk["shapes"] or chunk["captures"] > chunk["shapes"]
            or chunk["captures"] < min(1, chunk["replays"])):
        raise AssertionError(f"{what}: chunk graph stats {chunk} over {calls} chunks")


GRAPH_CHUNKS = 3  # timed chunks a block; blocks eager, replay, replay, eager


def graph_chunk_check(ex, pool, rows, offsets, vocab, torch, card, what):
    """One ``rows``-row chunk of ``ex`` on its held pool of one slot at the
    served block row (``pool``: the serve's ``PagedKVPool``, W of its
    pages a slot; pages drawn at random, the block row pages 1..W) at the
    two ``offsets``, beside the eager step on a twin pool: the
    first call eager (the shape's warm-up), the second captured at the
    second offset and replayed, the third replayed at the first; logits and
    pages bitwise equal each time, one capture.  Then the chunk's wall
    time, host inputs to synced logits, eager against replay in one call
    (blocks eager, replay, replay, eager, the median of ``GRAPH_CHUNKS``
    chunks each, the offsets alternating), the replay's device time
    (events) and the kernel time of one eager and one replayed chunk in
    the profiler's trace, hence the card's idle share."""
    import numpy as np

    from repro_torch.serving.graphs import leaves

    w, page = pool.pages_per_slot, pool.page_size
    if max(offsets) + rows > w * page:
        raise AssertionError(f"{what}: offsets {offsets} past the block row ({w} x {page})")
    eager = copy.copy(ex)
    eager.graphs = False
    ex.graphs = True
    storage = ex.make_pool(1 + w, page)  # the held pool: graphs on
    g = torch.Generator(device="cuda").manual_seed(38)
    for leaf in leaves(storage):
        leaf.normal_(generator=g)
    twin = _clone_tree(storage)
    row = np.arange(1, 1 + w)
    tok = np.random.default_rng(38).integers(0, vocab, (1, rows))
    for off in (offsets[0], offsets[1], offsets[0]):
        got, _ = ex.prefill_chunk(tok, storage, row, offset=off, length=off + rows)
        want, _ = eager.prefill_chunk(tok, twin, row, offset=off, length=off + rows)
        if not torch.equal(got, want) or not all(
                torch.equal(a, b) for a, b in zip(leaves(storage), leaves(twin))):
            raise AssertionError(f"{what}: the chunk at offset {off} differs from the eager "
                                 f"step: logits max diff "
                                 f"{(got.float() - want.float()).abs().max().item()}")
    stats = ex.graph_stats["chunk"]
    if (stats["captures"], stats["replays"]) != (1, 2):
        raise AssertionError(f"{what}: chunk graph stats {stats}")

    eager_ms, replay_ms, device_ms, busy_ms, idle = eager_vs_replay(
        lambda i: eager.prefill_chunk(tok, twin, row, offset=offsets[i % 2],
                                      length=offsets[i % 2] + rows)[0],
        lambda i: ex.prefill_chunk(tok, storage, row, offset=offsets[i % 2],
                                   length=offsets[i % 2] + rows)[0], GRAPH_CHUNKS, torch)
    stats = ex.graph_stats["chunk"]
    log("graphs", f"{what}: one capture serves offsets {list(offsets)}, each replay's logits "
        f"and pages bitwise equal to the eager step's (block row {w} pages of {page}); chunk "
        f"wall ms eager {eager_ms[0]:.3f} / replay {replay_ms[0]:.3f} / replay "
        f"{replay_ms[1]:.3f} / eager {eager_ms[1]:.3f} (median of {GRAPH_CHUNKS} each, host "
        f"inputs to synced logits), replay device {device_ms:.3f} ms a chunk back to back; "
        f"kernel time of one chunk in the profiler's trace eager {_ms(busy_ms['eager'])} / "
        f"replay {_ms(busy_ms['replay'])} ms, so the card idles {idle['eager']} / "
        f"{idle['replay']} of the chunk's wall; capture {stats['capture_ms']:.1f} ms, graph "
        f"pool {stats['pool_bytes']} B, allocated after it {stats['allocated_bytes']} B "
        f"({card})")
    ex.graphs = False
    return {"eager_ms": eager_ms, "replay_ms": replay_ms, "replay_device_ms": device_ms,
            "busy_ms": busy_ms, "capture_ms": stats["capture_ms"],
            "pool_bytes": stats["pool_bytes"]}


def graph_prefill_check(ex, pool, rows, lengths, vocab, torch, card, what):
    """(g) One prompt of ``rows`` tokens (a padded length) through the
    one-shot ``prefill_paged`` of ``ex`` on its held pool at the served
    geometry (``pool``: the serve's ``PagedKVPool``; pages drawn at random,
    the block row pages 1..W) at the two real ``lengths`` of that padded
    length, beside the eager step on a twin pool: the first call eager
    (the shape's warm-up), the second captured at the second length and
    replayed, the third replayed at the first; logits and pages bitwise
    equal each time, one capture.  Then the prefill's wall time, host
    inputs to synced logits, eager against replay in one call (blocks
    eager, replay, replay, eager, the median of ``GRAPH_CHUNKS`` prefills
    each, the lengths alternating), the replay's device time and the idle
    share (``eager_vs_replay``)."""
    import numpy as np

    from repro_torch.serving.graphs import leaves

    w, page = pool.pages_per_slot, pool.page_size
    if rows > w * page or not all(rows - 16 < n <= rows for n in lengths):
        raise AssertionError(f"{what}: {rows} rows at lengths {lengths}: not one padded "
                             f"length within the block row ({w} x {page})")
    eager = copy.copy(ex)
    eager.graphs = False
    ex.graphs = True
    storage = ex.make_pool(pool.num_pages, page)  # the held pool: graphs on
    g = torch.Generator(device="cuda").manual_seed(40)
    for leaf in leaves(storage):
        leaf.normal_(generator=g)
    twin = _clone_tree(storage)
    row = np.arange(1, 1 + w)
    tok = np.random.default_rng(40).integers(0, vocab, (1, rows))
    for n in (lengths[0], lengths[1], lengths[0]):
        got, _ = ex.prefill_paged(tok, storage, row, length=n)
        want, _ = eager.prefill_paged(tok, twin, row, length=n)
        if not torch.equal(got, want) or not all(
                torch.equal(a, b) for a, b in zip(leaves(storage), leaves(twin))):
            raise AssertionError(f"{what}: the prefill at length {n} differs from the eager "
                                 f"step: logits max diff "
                                 f"{(got.float() - want.float()).abs().max().item()}")
    stats = ex.graph_stats["prefill"]
    if (stats["captures"], stats["replays"]) != (1, 2):
        raise AssertionError(f"{what}: prefill graph stats {stats}")

    eager_ms, replay_ms, device_ms, busy_ms, idle = eager_vs_replay(
        lambda i: eager.prefill_paged(tok, twin, row, length=lengths[i % 2])[0],
        lambda i: ex.prefill_paged(tok, storage, row, length=lengths[i % 2])[0],
        GRAPH_CHUNKS, torch)
    stats = ex.graph_stats["prefill"]
    log("graphs", f"(g) {what}: one capture serves lengths {list(lengths)} of a {rows}-token "
        f"prompt, each replay's logits and pages bitwise equal to the eager step's (block row "
        f"{w} pages of {page}); prefill wall ms eager {eager_ms[0]:.3f} / replay "
        f"{replay_ms[0]:.3f} / replay {replay_ms[1]:.3f} / eager {eager_ms[1]:.3f} (median of "
        f"{GRAPH_CHUNKS} each, host inputs to synced logits), replay device {device_ms:.3f} ms "
        f"a prefill back to back; kernel time of one prefill in the profiler's trace eager "
        f"{_ms(busy_ms['eager'])} / replay {_ms(busy_ms['replay'])} ms, so the card idles "
        f"{idle['eager']} / {idle['replay']} of the prefill's wall; capture "
        f"{stats['capture_ms']:.1f} ms, graph pool {stats['pool_bytes']} B, allocated after "
        f"it {stats['allocated_bytes']} B ({card})")
    ex.graphs = False


def phase_graphs_spec(torch, card, fp16):
    """Phase 37 (a), Galaxy: phase 14's fp16 spec serve again on its
    executor and draft with ``graphs=True``: tokens bitwise equal to phase
    14's, launches exact by ``galaxy_expect``, all on the fast paths; every
    verify chunk after its row count's second call replayed, the draft's
    decode step captured once.  Then ``graph_chunk_check`` for a 5-row
    verify chunk and a 128-row chunk at the serve's geometry."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve

    what = "GPT2-L fp16 spec serve, graphs on"
    ex, draft = fp16["executor"], fp16["draft"]
    ops.reset_launch_counts()
    got = launch_serve.serve("gpt2-l", (3, 2, 2, 1), executor=ex, dtype="float16",
                             draft_executor=draft, spec_k=4, graphs=True, **fp16["kw"])
    torch.cuda.synchronize()
    if {r.uid: r.output for r in got["requests"]} != {r.uid: r.output for r in fp16["spec"]}:
        raise AssertionError(f"{what}: served tokens differ from phase 14's eager spec serve")
    st = got["stats"]
    if st != fp16["spec_stats"]:
        raise AssertionError(f"{what}: stats {st}, phase 14's {fp16['spec_stats']}")
    counts = ops.launch_counts()
    expect = dict.fromkeys(counts, 0)
    expect.update(galaxy_expect(st, draft=got["spec"]))
    if counts != expect:
        raise AssertionError(f"{what}: launches {counts} != {expect}")
    check_galaxy_paths(ops, what)
    graphs = got["graph_stats"]
    chunk, dstep = graphs["target"]["chunk"], graphs["draft"]["decode"]
    check_chunk_graph_stats(chunk, st["spec_steps"], what)
    if graphs["target"]["decode"]["captures"] or chunk["shapes"] > 5:
        raise AssertionError(f"{what}: target graphs {graphs['target']}")
    if (dstep["captures"], dstep["replays"]) != (1, got["spec"].steps - 1):
        raise AssertionError(f"{what}: draft decode graphs {dstep} over "
                             f"{got['spec'].steps} steps")
    log("graphs", f"{what}: 4 requests' tokens and stats bitwise equal to phase 14's eager "
        f"spec serve; launches {', '.join(f'{n} {counts[n]}' for n in GALAXY_KERNELS)} as "
        f"galaxy_expect says ({st['spec_steps']} verify chunks, draft {got['spec'].prefills} "
        f"prefills and {got['spec'].steps} steps), on the fast paths; verify chunks in "
        f"{chunk['shapes']} row counts: {chunk['captures']} captures "
        f"({chunk['capture_ms']:.1f} ms, pool {chunk['pool_bytes']} B), {chunk['replays']} "
        f"replays; the draft's decode 1 capture, {dstep['replays']} replays; "
        f"{got['new_tokens']} new tokens in {got['seconds']:.2f} s: "
        f"{got['tokens_per_s']:.1f} tok/s, TTFT p50 {1e3 * got['ttft_p50_s']:.1f} ms (not a "
        f"claim: one serve) ({card})")
    first = graphs
    # (h) the same traffic again on the same target and draft, which keep
    # their graphs and held pools: every call on a shape the first serve
    # met replays, so no shape is new and no decode step is captured
    ops.reset_launch_counts()
    again = launch_serve.serve("gpt2-l", (3, 2, 2, 1), executor=ex, dtype="float16",
                               draft_executor=draft, spec_k=4, graphs=True, **fp16["kw"])
    torch.cuda.synchronize()
    if {r.uid: r.output for r in again["requests"]} != {r.uid: r.output
                                                        for r in fp16["spec"]}:
        raise AssertionError(f"(h) {what}: the second serve's tokens differ from phase 14's")
    if again["stats"] != fp16["spec_stats"]:
        raise AssertionError(f"(h) {what}: the second serve's stats {again['stats']}")
    counts = ops.launch_counts()
    expect = dict.fromkeys(counts, 0)
    expect.update(galaxy_expect(st, draft=again["spec"]))
    if counts != expect:
        raise AssertionError(f"(h) {what}: the second serve's launches {counts} != {expect}")
    check_galaxy_paths(ops, what)
    second = again["graph_stats"]
    calls = {("target", "prefill"): st["prefill_oneshots"], ("target", "chunk"): st["spec_steps"],
             ("draft", "prefill"): again["spec"].prefills, ("draft", "decode"): again["spec"].steps}
    for (side, kind), n in calls.items():
        gs = second[side][kind]
        if gs["shapes"] or gs["replays"] != n or (kind == "decode" and gs["captures"]):
            raise AssertionError(f"(h) {what}: the second serve's {side} {kind} graphs {gs} "
                                 f"over {n} calls")
    log("graphs", f"(h) {what}, twice on one target and draft, each bitwise phase 14's tokens, "
        f"stats and launches: captures/replays (capture ms) by kind: first serve target "
        f"{run_graph_line(first['target'])}, draft {run_graph_line(first['draft'])}; second "
        f"serve target {run_graph_line(second['target'])}, draft "
        f"{run_graph_line(second['draft'])}; {again['tokens_per_s']:.1f} tok/s, TTFT p50 "
        f"{1e3 * again['ttft_p50_s']:.1f} ms (the first {got['tokens_per_s']:.1f} tok/s; not a "
        f"claim: one serve each) ({card})")
    ops.reset_launch_counts()
    for rows, offsets in ((5, (200, 301)), (128, (128, 181))):
        graph_chunk_check(ex, got["pool"], rows, offsets, ex.embed.shape[0], torch, card,
                          f"GPT2-L fp16 {rows}-row chunk")
    # each check: 3 eager and 3 graph-side calls (a warm-up, a capture's
    # replay, a replay), 2 x GRAPH_CHUNKS eager and 3 x GRAPH_CHUNKS
    # replayed timed chunks, one eager and one replayed profiled chunk
    want = 2 * 2304 * (8 + 5 * GRAPH_CHUNKS)
    n = ops.launch_counts()["tiled_gemm_valid"]
    if n != want or ops.path_counts()["tiled_gemm_valid"]["fma"]:
        raise AssertionError(f"{what}: the chunk checks launched {n} GEMMs, want {want} "
                             "on mma")



WAVE_STEPS = 5  # timed wave decode steps a block; blocks eager, replay, replay, eager


def check_wave_graph_stats(stats, steps, what, prefill_captures=0):
    """A wave serve's graphs: one ``wave_decode`` capture a wave batch size
    (each shape's first call), every later step replayed, and
    ``prefill_captures`` wave prefill captures (a shape's second call)."""
    dec, pre = stats["wave_decode"], stats["wave_prefill"]
    if (dec["captures"] != dec["shapes"] or dec["replays"] != steps - dec["captures"]
            or pre["captures"] != prefill_captures or stats["decode"]["shapes"]
            or stats["chunk"]["shapes"]):
        raise AssertionError(f"{what}: graph stats {stats} over {steps} decode steps")


def wave_serve_graphs(torch, out, what, **kw):
    """``out``'s wave serve again on its executor with ``graphs=True``
    (``kw``: ``launch.serve``'s arguments): tokens and stats bitwise equal
    to the eager serve's; one wave decode capture a wave batch size and no
    wave prefill capture (each wave shape comes once).  Returns the
    serve."""
    from repro_torch.launch import serve as launch_serve

    got = launch_serve.serve(executor=out["executor"], graphs=True, **kw)
    torch.cuda.synchronize()
    if {r.uid: r.output for r in got["requests"]} != {r.uid: r.output
                                                      for r in out["requests"]}:
        raise AssertionError(f"{what}: served tokens differ from the eager serve's")
    if got["stats"] != out["stats"]:
        raise AssertionError(f"{what}: stats {got['stats']}, the eager serve's {out['stats']}")
    check_wave_graph_stats(got["graph_stats"]["target"], got["stats"]["decode_steps"], what)
    return got


def wave_line(got, out, card):
    """The graphs of a wave serve and its speed beside the eager serve's."""
    gs = got["graph_stats"]["target"]
    dec, held = gs["wave_decode"], gs["wave_caches"]
    return (f"wave decode {dec['captures']} captures ({dec['capture_ms']:.1f} ms, pool "
            f"{dec['pool_bytes']} B), {dec['replays']} replays; wave prefills "
            f"{gs['wave_prefill']['shapes']} shapes, eager; {held['caches']} held wave caches "
            f"of {held['bytes']} B; {got['new_tokens']} new tokens in {got['seconds']:.2f} s: "
            f"{got['tokens_per_s']:.1f} tok/s, TTFT p50 {1e3 * got['ttft_p50_s']:.1f} ms (the "
            f"eager serve {out['tokens_per_s']:.1f} tok/s, TTFT p50 "
            f"{1e3 * out['ttft_p50_s']:.1f} ms; not a claim: one serve each) ({card})")


def wave_step_check(ex, lengths, max_len, vocab, torch, card, what):
    """A wave of prompts right-padded to ``max(lengths)`` on ``ex`` with
    graphs on (its held cache), each call beside the eager executor on a
    fresh cache: the prefill three times (eager, captured, replayed), then
    decode steps at per-row positions ``lengths`` (captured), ``lengths +
    1`` and ``lengths + 4`` (replayed); logits and every cache leaf
    bitwise the eager step's.  Then the decode step's wall ms eager
    against replay (``eager_vs_replay``, ``WAVE_STEPS`` a block), the
    idle share, capture ms, the graph pools' and the held cache's bytes."""
    import numpy as np

    from repro_torch.serving.graphs import leaves

    lengths = np.asarray(lengths)
    b, s = len(lengths), int(lengths.max())
    eager = copy.copy(ex)
    eager.graphs = False
    ex.graphs = True
    rng = np.random.default_rng(39)
    prefill_ms = []
    for _ in range(3):
        tokens = rng.integers(1, vocab, (b, s))
        cache, twin = ex.make_cache(b, max_len), eager.make_cache(b, max_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, _ = ex.prefill(tokens, cache, lengths=lengths)
        got.argmax(-1).cpu()
        prefill_ms.append(1e3 * (time.perf_counter() - t0))
        want, _ = eager.prefill(tokens, twin, lengths=lengths)
        if not torch.equal(got, want) or not all(
                torch.equal(x, y) for x, y in zip(leaves(cache), leaves(twin))):
            raise AssertionError(f"{what}: a wave prefill through its graph differs from the "
                                 f"eager step: logits max diff "
                                 f"{(got.float() - want.float()).abs().max().item()}")
    tok = rng.integers(1, vocab, (b, 1))
    for step in (0, 1, 4):
        got, _ = ex.decode(tok, cache, lengths + step)
        want, _ = eager.decode(tok, twin, lengths + step)
        if not torch.equal(got, want) or not all(
                torch.equal(x, y) for x, y in zip(leaves(cache), leaves(twin))):
            raise AssertionError(f"{what}: the wave decode step at {lengths + step} differs "
                                 f"from the eager step: logits max diff "
                                 f"{(got.float() - want.float()).abs().max().item()}")
    stats = ex.graph_stats
    pre, dec = stats["wave_prefill"], stats["wave_decode"]
    if ((pre["captures"], pre["replays"]) != (1, 2)
            or (dec["captures"], dec["replays"]) != (1, 2)):
        raise AssertionError(f"{what}: graph stats {stats}")
    index = lengths + 4
    eager_ms, replay_ms, device_ms, busy_ms, idle = eager_vs_replay(
        lambda i: eager.decode(tok, twin, index)[0],
        lambda i: ex.decode(tok, cache, index)[0], WAVE_STEPS, torch)
    log("graphs", f"{what}: a wave of {b} rows right-padded to {s}: the prefill eager, "
        f"captured and replayed ({prefill_ms[0]:.1f} / {prefill_ms[1]:.1f} / "
        f"{prefill_ms[2]:.1f} ms, host inputs to synced logits; capture "
        f"{pre['capture_ms']:.1f} ms, pool {pre['pool_bytes']} B) and the decode step at "
        f"positions {lengths.tolist()} (captured), +1 and +4 (replayed), logits and every "
        f"cache leaf bitwise the eager step's; decode step wall ms eager {eager_ms[0]:.3f} / "
        f"replay {replay_ms[0]:.3f} / replay {replay_ms[1]:.3f} / eager {eager_ms[1]:.3f} "
        f"(median of {WAVE_STEPS} each), replay device {device_ms:.3f} ms a step back to "
        f"back; kernel time of one step in the profiler's trace eager "
        f"{_ms(busy_ms['eager'])} / replay {_ms(busy_ms['replay'])} ms, so the card idles "
        f"{idle['eager']} / {idle['replay']} of the step's wall; capture "
        f"{dec['capture_ms']:.1f} ms, pool {dec['pool_bytes']} B; held cache "
        f"{stats['wave_caches']['bytes']} B ({card})")
    ex.graphs = False


def phase_graphs_waves_zoo(torch, card, out):
    """Phase 37 (d): phase 8's RecurrentGemma-9B traffic served again on
    phase 8's executor with ``graphs=True``: tokens and stats bitwise
    phase 8's, phase 8's launch counts (24 flash on ``mma``, 52 scan on
    ``tma``: the wave prefills run eagerly, each shape once), one wave
    decode capture for each wave (4 rows, 2 rows); then
    ``wave_step_check`` of a 2-row wave of 300 and 250 tokens, the first
    time the hd-256 windowed flash kernel and the TMA scan run inside a
    graph."""
    from repro_torch.kernels import ops

    what = "RecurrentGemma-9B bf16 waves, graphs on"
    lens = [300] * 4 + [2100] * 2
    ops.reset_launch_counts()
    got = wave_serve_graphs(torch, out, what, model="recurrentgemma-9b", executor_kind="zoo",
                            prompt_lens=lens, max_new=16, max_batch=4, device="cuda",
                            dtype="bfloat16", seed=0)
    counts, cfg = ops.launch_counts(), out["executor"].cfg
    expect = dict.fromkeys(counts, 0)
    expect.update({"flash_attention": cfg.layer_kinds().count("attn") * 2,
                   "rglru_scan": cfg.layer_kinds().count("rec") * 2})
    if counts != expect:
        raise AssertionError(f"{what}: launches {counts} != {expect}")
    check_flash_paths(ops, counts, what)
    if ops.path_counts()["rglru_scan"] != {"tma": counts["rglru_scan"], "simt": 0}:
        raise AssertionError(f"{what}: rglru_scan off the TMA path: {ops.path_counts()}")
    if got["graph_stats"]["target"]["wave_decode"]["captures"] != 2:
        raise AssertionError(f"{what}: {got['graph_stats']['target']['wave_decode']}")
    log("graphs", f"{what}: 6 requests' tokens and stats bitwise equal to phase 8's; flash "
        f"{counts['flash_attention']} (mma), scan {counts['rglru_scan']} (tma); "
        + wave_line(got, out, card))
    ex = out["executor"]
    ops.reset_launch_counts()
    wave_step_check(ex, [300, 250], 320, cfg.vocab_size, torch, card,
                    "RecurrentGemma-9B bf16 wave")
    # the eager executor's 3 prefills and the graph side's eager one and its
    # capture's replay, a replay: 12 flash and 26 scan each
    counts = ops.launch_counts()
    if (counts["flash_attention"], counts["rglru_scan"]) != (6 * 12, 6 * 26):
        raise AssertionError(f"{what}: the step check launched {counts}")


def phase_graphs_waves_galaxy(torch, card, wave):
    """Phase 37 (e): phase 15's GPT2-L fp16 wave serve again on its
    executor with ``graphs=True``: tokens and stats bitwise phase 15's,
    launches exact by ``galaxy_expect`` (576 ``tiled_gemm_valid`` a decode
    step, true under replay, and ``ragged_flash_attention`` 36 x 4 a
    wave), all on the fast paths; one wave decode capture a wave batch
    size."""
    from repro_torch.kernels import ops

    what = "GPT2-L fp16 Galaxy waves, graphs on"
    ops.reset_launch_counts()
    got = wave_serve_graphs(torch, wave, what, model="gpt2-l", capacities=(3, 2, 2, 1),
                            requests=4, prompt_len=(37, 300), max_new=16, max_batch=4,
                            scheduler="wave", device="cuda", dtype="float16", seed=0)
    st, counts = got["stats"], ops.launch_counts()
    expect = dict.fromkeys(counts, 0)
    expect.update(galaxy_expect(st))
    if counts != expect or counts["ragged_flash_attention"] != 36 * 4 * st["prefill_waves"]:
        raise AssertionError(f"{what}: launches {counts} != {expect}")
    check_galaxy_paths(ops, what)
    log("graphs", f"{what}: 4 requests' tokens and stats bitwise equal to phase 15's; "
        f"launches {', '.join(f'{n} {counts[n]}' for n in GALAXY_KERNELS)} as galaxy_expect "
        f"says ({st['prefill_waves']} waves, {st['decode_steps']} decode steps of 576), on "
        f"the fast paths; " + wave_line(got, wave, card))


def phase_graphs_waves_xlstm(torch, card, out):
    """Phase 37 (f): phase 24's xlstm-350m traffic served again on its
    executor with ``graphs=True``: tokens and stats bitwise phase 24's, no
    kernel launched, one wave decode capture for each wave (4 rows, 2
    rows)."""
    from repro_torch.kernels import ops

    what = "xlstm-350m bf16 waves, graphs on"
    ops.reset_launch_counts()
    got = wave_serve_graphs(torch, out, what, model="xlstm-350m", executor_kind="zoo",
                            prompt_lens=[256] * 4 + [300] * 2, max_new=16, max_batch=4,
                            device="cuda", dtype="bfloat16", seed=0)
    if any(ops.launch_counts().values()):
        raise AssertionError(f"{what}: launches {ops.launch_counts()}")
    if got["graph_stats"]["target"]["wave_decode"]["captures"] != 2:
        raise AssertionError(f"{what}: {got['graph_stats']['target']['wave_decode']}")
    log("graphs", f"{what}: 6 requests' tokens and stats bitwise equal to phase 24's; "
        + wave_line(got, out, card))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no repro_torch package under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.kernel_timing import card_line

    t_start = time.perf_counter()

    card = card_line()
    log("card", f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import build_plan

    t0 = time.perf_counter()
    secs = build.build_all()
    log("build", f"{len(secs)} CUDA sources built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{name}: {line.strip()}")
    log("build", f"ptxas spills: {spill_check(build)}")
    log("build", f"SASS tensor-core instructions: {sass_check(torch)}")

    cfg = get_config("gpt2-l")
    plan = build_plan(cfg, (3, 2, 2, 1))
    rec = {"tiled_gemm_valid": Record("tiled_gemm_valid", "cuda"),
           "ragged_flash_attention": Record("ragged_flash_attention", "cuda"),
           "fused_connective": Record("fused_connective", "cuda"),
           "flash_attention": Record("flash_attention", "cuda"),
           "rglru_scan": Record("rglru_scan", "cuda"),
           "tiled_gemm": Record("tiled_gemm", "cuda")}
    phase_kernels(rec, plan, torch)
    phase_parity(cfg, plan, torch)
    out = phase_serve(torch, rec)
    check_served_token(out, torch)
    local_tokens = {"serve": {r.uid: r.output for r in out["requests"]}}
    phase_graphs_galaxy(torch, card, out)
    del out
    torch.cuda.empty_cache()
    out = phase_serve(torch, None, dtype="bfloat16", n_req=4, max_new=4)
    check_served_token(out, torch, dtype="bfloat16")
    del out
    torch.cuda.empty_cache()

    # the rest of Galaxy serving, its kernel calls logged and replayed
    with CallLog() as calls:
        phase_chunk_parity(torch, card)
        torch.cuda.empty_cache()
        out = phase_prefix_serve(torch, rec, card)
        local_tokens["prefix"] = {r.uid: r.output for r in out["requests"]}
        del out
        torch.cuda.empty_cache()
        fp16 = phase_spec_serve(torch, rec, card)
        local_tokens["spec"] = {r.uid: r.output for r in fp16["spec"]}
        wave = phase_wave_serve(torch, rec, card, fp16)
        torch.cuda.empty_cache()
        phase_schedules(torch, rec, card)
        torch.cuda.empty_cache()
        qwen_launches = phase_telemetry(torch, rec, card)
    check_logged_calls(calls, rec, torch, card)
    rec["flash_attention"].d["launches"] += qwen_launches
    phase_graphs_spec(torch, card, fp16)
    phase_graphs_waves_galaxy(torch, card, wave)
    del fp16, wave
    torch.cuda.empty_cache()

    phase_zoo_kernels(rec, torch)
    torch.cuda.empty_cache()
    zoo_ref = phase_zoo_parity(torch)
    torch.cuda.empty_cache()
    out = phase_zoo_serve(torch, rec)
    bf16_err = check_zoo_served_tokens(out, torch)
    zoo_one = {"tokens": {r.uid: r.output for r in out["requests"]}, "bf16_err": bf16_err,
               "prompts": {r.uid: r.prompt for r in out["requests"]},
               "tokens_per_s": out["tokens_per_s"], "ttft_p50_s": out["ttft_p50_s"]}
    phase_graphs_waves_zoo(torch, card, out)
    del out  # RecurrentGemma's 16 GiB go before StableLM is drawn
    torch.cuda.empty_cache()

    phase_dense_kernels(rec, torch, card)
    torch.cuda.empty_cache()
    dense_calls = phase_dense_parity(torch)
    torch.cuda.empty_cache()
    out = phase_dense_serve(torch, rec)
    check_dense_served_token(out, torch)
    measure_decode_gather(out, torch)
    phase_graphs_dense(torch, card, out)
    del out  # StableLM's 24 GiB go before the MoE models are drawn
    torch.cuda.empty_cache()

    phase_moe_kernels(rec, torch)
    phase_moe_routing(torch, card)
    phase_xlstm_parity(torch, card)
    torch.cuda.empty_cache()
    out = phase_moe_serve(torch, rec, card, "olmoe-1b-7b", requests=8, prompt_len=(64, 512),
                          shared_prefix=1024, prefix_cache=True, prefill_chunk=256)
    check_moe_served_token(out, torch, chunk=256, cached=1024)
    del out
    torch.cuda.empty_cache()
    out = phase_moe_serve(torch, rec, card, "granite-moe-3b-a800m", requests=4,
                          prompt_len=(64, 512))
    check_moe_served_token(out, torch)
    del out
    torch.cuda.empty_cache()
    out = phase_xlstm_serve(torch, card)
    phase_graphs_waves_xlstm(torch, card, out)
    del out
    torch.cuda.empty_cache()

    phase_train_kernels(torch, card)
    torch.cuda.empty_cache()
    phase_train(torch, rec, card)
    phase_train_zoo(torch, rec, card)
    phase_xattn(torch, rec, card)
    torch.cuda.empty_cache()
    phase_dryrun(torch, card)
    phase_roofline(torch, rec, card)
    torch.cuda.empty_cache()
    phase_calibrate(torch, rec, card)
    torch.cuda.empty_cache()
    phase_remat_dots(torch, rec, card)
    phase_hillclimb(torch, card)
    phase_ranks(torch, rec, card, local_tokens)
    phase_zoo_ranks(torch, rec, card, zoo_ref, zoo_one)
    phase_zoo_paged_ranks(torch, rec, card, dense_calls)

    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [r.d for r in rec.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
