#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--phases 2,2b,2c,2d,2e,2f,3,3b,3c,3d,3e,3f,3g,3h,
                           3i,3j,3k,3l,3m,3n,3o,3p,4,4b,4c,4d,4e,4f,4g,4h,
                           4i,4j,4k,4l,4m,4n,3q,3r,4o,3s,3t]

Phases (any failure raises and the script exits non-zero, printing no
result line; with no arguments every phase runs):

1. build — compile every kernel source of the serving and training
   paths from ``paddle_operator_tpu_torch/csrc/`` (one nvcc each, in
   parallel); report each flash kernel instantiation's design, its
   registers, spill bytes and shared memory (``-Xptxas -v``), and the
   registers, spills and shared memory of the three decode kernels'
   instantiations (the paged ones with their tile ring's dynamic shared
   memory at D 128) and of the int8-weight kernels' (A and B: the wgmma
   body by rows and product group, the two f32 bodies).
2. kernel vs plain — ``decode_attention`` against
   ``decode_attention_reference`` on the card: ragged lengths with 0, 1,
   a full cache and a non-multiple of any tile; the split's chunk edges
   (lengths 0, 1, chunk - 1, chunk, chunk + 1 and the whole cache, 1, 2
   and 4 query heads a block), a cache of one chunk and a stacked-layer
   view; MHA and GQA (n_rep 2, 4); D 64 and 128; float32
   (atol = rtol = 1e-4) and bfloat16 (atol 1e-2, against the plain
   version run in float32 on the bf16 inputs); NaN rows
   (``nan_lanes_check``, also in 2b and 2d: one all-NaN chunk among
   finite ones, every visible row NaN, a NaN V row, on the int8 pool a
   NaN scale and NaN tail rows) reach exactly the heads where they reach
   the plain version's output, every other value the bits of the run
   without them; the main path's shapes;
   the 7b shape at fills 128 and 2048; phase 3l's draft ring (the 7b
   ``cfg.draft()``: 8 lanes, 16 heads over 16, D 128, its 8 layers
   stacked; ``SPEC_DRAFT_ATTN``) at the burst's fills; a length-0 lane
   gives zeros and
   two runs are bit-identical.  Then the kernel, the plain version and
   ``scaled_dot_product_attention`` (the library yardstick, never used
   by the port) are timed at the 7b shape at fills 128, 528 and 2048 —
   device time from CUDA-graph replay, eager time from one-by-one calls
   — beside the bound and the chunk count; with each, the call's device
   time at chunks of 64, 128, 256 and 512 rows.
2b. paged kernel vs plain — ``paged_decode_attention`` against
   ``paged_decode_attention_reference`` under scrambled block maps:
   ragged lengths {0, 1, full, not a multiple of bs}, bs 16 and 256,
   MHA and GQA (n_rep 2, 4), D 64 and 128, a stacked-layer index, the
   ring's 7b shapes; the split's chunk and block edges (lengths 0, 1,
   chunk - 1, chunk, chunk + 1, bs - 1, bs + 1 and the table's reach at
   bs 16 and 256, 1, 2 and 4 query heads a block, D 64 and 128, and a
   stacked-layer view); same tolerances as phase 2; a length-0 lane
   gives zeros and two runs are bit-identical.  Then timed at 7b, B=8,
   bs=256, fills 128, 528 and 2048, in turns: the paged kernel, its
   plain version, kernel #1 on the same rows laid out contiguously, and
   ``scaled_dot_product_attention`` on those contiguous rows (the same
   work without the table walk; never used by the port); with each, the
   call's device time at chunks of 64, 128, 256, 512, 1024 and 2048 rows
   (2048: one chunk a lane, no split; each setting checked once against
   the plain version).
2d. int8 paged kernel vs plain — ``paged_decode_attention`` with the
   int8 pool's operands (codes, scales, staging tails) against
   ``paged_decode_attention_quant_reference`` under scrambled block
   maps: lengths {0, 1, bs-1, bs, bs+1, full, not a multiple of bs}, bs
   16 and 256, n_rep 1/2/4, D 64 and 128, unstacked and a stacked-layer
   index, the ring's 7b shapes; float32 at atol = rtol = 1e-4, bfloat16
   against the plain version in float32 on the same codes and tails
   (code x scale rounded to bfloat16, as the function does) element by
   element (``BF16_ATOL``) and as a whole (``QUANT_BF16_REL``, the
   relative Frobenius error: at the 7b fills |out| is only a few times
   ``BF16_ATOL``); phase 2b's chunk and block edges; a length-0 lane
   gives zeros and two runs are bit-identical.  Then timed at 7b, B=8,
   bs=256, fills 128, 528 and 2048, in turns: the int8 kernel, its
   plain version, the bf16 paged kernel on the same logical rows, and
   ``scaled_dot_product_attention`` on those rows laid out contiguously
   in bf16 (a yardstick of the same attention without the dequant: no
   PyTorch call computes this function; never used by the port), with
   phase 2b's sweep of chunk rows.  At each timed fill
   the int8 kernel's output must equal, bit for bit, the bf16 paged
   kernel's on the rows dequantized and rounded to bfloat16.
2e. int8-weight kernels vs plain — kernel A (``quant_matmul``, M 1, 4,
   8, 16, 24, 40 and 64: ``QMM_ROWS``) and kernel B (``quant_gemm``, M
   17, 40, 64, 256, 512 and 2048: ``QMM_GEMM_ROWS``) against
   ``quant_matmul_reference`` at the 7b shapes (K x N 4096 x 4096,
   4096 x 11008, 11008 x 4096 and the legacy lm_head's 4096 x 32000),
   the 7b draft's (``QMM_DRAFT_SHAPES``: 2048 x 2048, 2048 x 5504 and
   5504 x 2048, phase 3l (c)'s ``SERVE_DRAFT_QUANT=int8``) and
   tails off the tile (K and N not multiples of 128, N not of 16), int8
   and int4 codes, each with an all-zero column (output 0): float32 at
   ``QMM_F32_ATOL``, bfloat16 against the plain version in float32 on
   the same bf16 inputs at ``BF16_ATOL``; two runs bit-identical (A at
   M 8 and 40, B at its smallest routed M and 512); the kernel the route
   gives 40 rows, and kernel B at its smallest routed M, captured in a
   CUDA graph, replay equal.  Then timed at the 7b shapes (int8 codes,
   bf16 activations, each call on codes the L2 has not seen), kernel A
   at ``QMM_ROWS`` and kernel B at M 16 to 2048 (``QMM_GEMM_TIMED``;
   16-64 beside kernel A: the route's limit), in turns: the kernel, its
   plain version (dequantize-then-matmul) and bf16 ``torch.matmul`` on
   the same M, K, N (the bf16 replica's call, not the same function;
   never used by the port), beside the bound; kernel A at M 8 also as
   its variants (``QMM_PROBES``: no products, no split finish, a wait
   after every step), kernel B at M 512 and 2048 as its
   (``QMM_GEMM_PROBES``: no products, no split finish, products a stage
   at a time), launched from a second build of the source compiled with
   ``-DQMM_PROBE`` (``QMM_PROBE_BUILD``), which the port never loads.  The JSON line's numbers are one 7b layer's seven
   projections, kernel A at M 8 and kernel B at M 512.
2f. 8-bit AdamW update vs plain — ``adam8bit_update`` against
   ``adam8bit_update_reference`` over three updates (the clip biting at
   the second) from zero moments, at the 7b tensors' shapes (4096 x
   4096, 4096 x 11008, 11008 x 4096, the embedding's 32000 x 4096,
   lm_head's 4096 x 32000, a [4096] norm scale) and last axes off 256
   (3 x 1000: 16-byte loads; 5 x 77: value by value): p, the codes and
   the scales bit-identical after every update.  Then timed at the 7b
   shapes, in turns: the kernel, its plain version (eager) and
   ``torch._fused_adamw_`` on f32 moments of the same tensor (the
   library yardstick, not the same function; never used by the port),
   beside the bound (the bytes: p and g read, p written, both codes and
   scales read and written, at 3.35 TB/s); the JSON line's numbers are
   the whole 7b model's update (291 tensors) from those timings.
2c. flash kernels vs plain — ``flash_forward`` (O and lse),
   ``flash_backward_dkv`` and ``flash_backward_dq`` each against its
   plain version on the same inputs (the backward kernels get the plain
   forward's lse and delta): causal and not, n_rep 1/2/4, D 64 and 128,
   S 1, 63, 64, 65, 127, 128, 129, 300 and 2048 (the edges of the bf16
   bodies' 64- and 128-row tiles), Sq 300 / Sk 700 and Sq 700 / Sk 300,
   with and without three-document segment ids, plus rows whose query
   id no key carries (o = 0, lse = 0); float32 at
   atol = rtol = 1e-4, bfloat16 against the plain version in float32
   element by element (``FLASH_BF16_ATOL``, one limit a kernel, and
   ``FLASH_BF16_RTOL``) and as a whole (``FLASH_BF16_REL``: the
   relative Frobenius error of each output, and of the forward's O
   over the main path's second half of rows, where |O| is small).  Two
   runs of each backward kernel are bit-identical.  Then timed at the
   7b training shape (B 4, H 32, D 128, causal, bf16) at S 512 and
   2048: each kernel, its plain version, ``scaled_dot_product_attention``
   forward, the library's flash backward (``aten.
   _scaled_dot_product_flash_attention_backward``: dQ, dK and dV in one
   call, the yardstick of the dK/dV + dQ pair) and SDPA
   forward+backward through autograd (library yardsticks, never used by
   the port) and the port's forward+backward, beside their bounds.
3. batch main path — 7b at full width and depth, bf16, fresh init from
   seed 0: the port's batch server answers three ``/v1/generate``
   requests over real HTTP; the kernel's launch count over exactly that
   run must equal n_layers x decode steps.  Then decode ms/token is
   timed.
3b. ring main path — the continuous paged server
   (``make_server(continuous=True, paged=True, slots=8, chunk_tokens=8,
   block_size=256, max_len=2048)``) on the same 7b model answers a
   concurrent burst over real HTTP: 8 cold prompts, 4 followers of one
   512-token prefix, 1 streamed request, then a resubmission (a full
   prefix hit).  The server is built with ``prewarm=True``, which
   captures the ring's resident program as a CUDA graph while the ring
   is empty (capture seconds and the graph pool's bytes are printed);
   every dispatch of the run must be a replay of it.  Launches of the
   paged kernel over exactly that run must equal n_layers x
   chunk_tokens x chunks dispatched, kernel #1 must not launch,
   followers prefill only their suffixes, the pool's invariant holds
   and every block ends free or cached.
3c. training main path — 7b at full width cut to 8 layers (f32
   params, bf16 compute, full remat), fresh init from seed 0:
   ``make_model`` -> ``create_state`` -> ``make_train_step`` -> ``fit``
   over a ``DevicePrefetcher`` for 12 steps of one repeated batch of
   4 x 2049 tokens.  The loss must fall below 0.7x its first value;
   the flash kernels' launches over exactly that run must equal
   2 x layers x steps (forward and the remat recompute) for the forward
   and layers x steps for each backward kernel, and the decode kernels
   must not launch.  Step ms (median after the first two steps),
   tokens/s, MFU and peak memory are reported.
3d. int8 ring main path — the continuous paged server over the int8
   pool (3b's ``make_server`` arguments with ``kv_quant="int8"``, the
   same 64-block pool) on the same 7b model: 3b's burst plus one
   follower whose shared prefix ends mid-block (the first 600 tokens of
   the 1000-token prompt), then the full-prefix resubmission.  The int8
   kernel's launches over exactly that run must equal n_layers x
   chunk_tokens x chunks dispatched, the bf16 paged kernel and kernel
   #1 must not launch, followers prefill only their suffixes, CoW runs,
   ``/statusz`` reports ``kvQuantMode`` int8, the pool's invariant
   holds and every block ends free or cached.  ``kvPoolBytes``, new
   tok/s and TTFT are printed beside 3b's.
3e. megastep main path — 3b's server with ``megastep=4`` (four chunks
   fused into one dispatch, one CUDA graph replay) under 3b's burst:
   every request's tokens must equal 3b's for the same prompt, token
   for token; the paged kernel's launches must equal n_layers x
   chunk_tokens x 4 x dispatches; ``/statusz`` reports ``megastepN`` 4
   and a ``dispatchesPerToken`` below 3b's.  New tok/s, TTFT p50/p95
   and wall ms per token are printed beside 3b's.
3f. checkpoint main path — 7b at full width cut to 1 layer (f32
   params, bf16 compute, full remat), B 4 x 2049 tokens from
   ``deterministic_lm_batches(seed=0)``, lr 1e-3, checkpoints under a
   ``tempfile.mkdtemp()`` removed at the end (its free space printed
   first).  (a) U: a fresh model from seed 0 trained 6 steps through
   ``fit`` with a ``CheckpointManager`` at ``save_interval_steps=3``:
   steps 3 and 6 commit; U2, the same run without a manager, gives the
   spread of two unbroken runs.  (b) R: a fresh model from seed 0 with a
   manager at interval 1000 and an installed ``PreemptionWatcher``;
   ``inject_preemption(at_step=2, signal_self=True)`` delivers a real
   SIGTERM: the watcher drains, the state stops at step 3, step 3 is
   committed by the drain alone and the log says ``checkpoint=saved``.
   (c) A fresh model from seed 1, restored by ``resume_or_init``: its
   step, count and every parameter, ``mu`` and ``nu`` equal R's in
   memory bit for bit.  (d) ``fit`` continues 3 steps from
   ``deterministic_lm_batches(seed=0, start_step=3)``: its losses equal
   U's steps 4-6 bit for bit, and so do its final params (two unbroken
   runs are bit-identical: ``CKPT``'s note).  The flash launches of
   every ``fit`` run are held to 3c's formulas.  (e)
   ``load_serving_params`` reads R's parameter file into bf16 on the
   card, adding no more than the bf16 parameter bytes plus
   ``SERVE_LOAD_MARGIN`` to the allocated memory; the served params
   equal R's cast in memory; 3b's paged server over each generates 32
   greedy tokens for 4 prompts, the two give the same tokens, and the
   paged kernel's launches equal n_layers x chunk_tokens x dispatches.
   The bytes of a checkpoint, how long ``save`` held the loop (the
   snapshot), the background write (s, GB/s) and the two restores are
   printed beside the card's name and power limit.
3g. preemption main path — 3b's server at full width, depth cut to
   the 7b params' first ``CUT_LAYERS`` (2, for the script's time
   limit) (``SERVE_PRIORITIES=2``,
   preemption at its default, on) on the bf16 pool and on the int8
   pool, each also with ``SERVE_PREEMPT=0`` on the same requests: 8
   class-1 requests (cold 512-token prompts, 192 new tokens, streamed)
   fill the 8 lanes; once every lane has decoded 2 chunks, 2 class-0
   requests (``X-Request-Priority: 0``, 512-token prompts, 32 new
   tokens, streamed) arrive.  With preemption on, ``preemptedLanes`` ==
   the restored lanes >= 1 and ``parkedLanes`` 0 at the end; with it
   off, none.  Every class-1 stream must equal the same request's
   stream from the ``SERVE_PREEMPT=0`` run, token for token; the pool's
   invariant holds after every spill and restore and at the end;
   ``kvBlocksFree`` plus the blocks the burst's prompts left cached
   equals its value before the burst; every dispatch is a replay of the
   prewarm graphs, whose state keeps its addresses; the paged kernel
   (#2, or #3 on the int8 pool) launches n_layers x chunk_tokens x
   dispatches, and after each restore n_layers x chunk_tokens for every
   replay.  Printed: the class-0 requests' time to first token and to
   completion and the class-1 token gaps (p95, max), both ways; each
   spill's ms (host, waits for its copies) and bytes, each restore's
   host and device ms (CUDA events around its queued copies and
   scatter); the launch and replay counts.
3h. host tier and durable store main path — 3b's server (bf16 and
   int8 pools, every dispatch a graph replay) at full width, depth cut
   to the 7b params' first 2 layers (``TIER_LAYERS``; the tiers'
   megabytes scaled with it, so each holds the blocks it held at 32).
   Round 1: 24 distinct 1,024-token prefixes (4 blocks each: 96 blocks
   against the 64-block pool), each with its own 16-token suffix and 32
   new tokens; round 2: the same prefixes with fresh suffixes, in
   reverse order, so device hits, host hits and cold prefills all
   occur.  Requests stream over HTTP, each queued before the next is
   sent.  Six servers a pool: the tier off; the tier on
   (``SERVE_HOST_CACHE_MB=4096`` at 32 layers, 2048 at 16: 30 bf16
   blocks, 61 int8, sized by ``ring_kw_from_env``); the store leg (``SERVE_KV_STORE=dir:<tmp>``,
   round 1 on a server with a 15-block tier, which overflows whole
   chains into the store, then ``flush()`` and close; round 2 on a fresh
   server with a 61-block tier on the same directory, whose imports
   outlast its own demotes); and two references — a pool that never
   evicts (round 2 all device hits) and the prefix cache off (round 2
   all cold).  A prefix hit and a cold prefill round differently in
   bf16 (3b's resubmission note), so each round-2 stream of the three
   runs is held to the reference of the path its admission took (a
   hit — device, host or store, the same bytes — or a cold prefill),
   and round 1 (all cold) must be equal across the runs; a failure
   exits non-zero.  Also gated: >= 1 host promotion with the tier on,
   >= 1 store hit after the restart, every dispatch a replay of the
   prewarm graphs at their addresses, kernel #2 (#3) launches ==
   n_layers x chunk x dispatches, the pool's invariant.  Printed: each
   round-2 path, how many streams are equal across tier off / on /
   store restart, the pinned slab's bytes and boot ms, demote host ms
   and device ms (CUDA events around the queued slice and copy) with
   its GB/s, promote device ms a block, round 2's per-request TTFT and
   prefill tokens tier off / on / restart, the store's bytes, write
   GB/s (write + fsync + rename) and fetch ms, ``/statusz``'s host and
   store keys.  Then on a bare executor of 3b's geometry, three
   spill/restore cycles of a 528-token lane: each spill's ms and the
   caching host allocator's new pinned allocations (does a spill that
   follows a restore still pin?), each restore's host ms beside a
   dispatch in flight, its pieces and every synchronizing call PyTorch
   reports under ``set_sync_debug_mode("warn")``.
3i. weight-quantized ring main path — the 7b model at full width, depth
   cut to ``CUT_LAYERS`` (2, for the script's time limit), as
   ``serve.main`` builds it under ``SERVE_WEIGHT_QUANT=int8``
   (``load_serving_params``, then ``quantize_from_env``; ``paramBytes``
   must equal the shape arithmetic) on 3b's
   server and burst, over the bf16
   pool and the int8 pool: every request completes, the int8-weight
   kernels' launches equal 7 x n_layers x ticks plus 7 x n_layers a
   forward — kernel A's up to ``KERNEL_MAX_ROWS`` rows, kernel B's above
   — (the plain formula never runs), ``/statusz`` reports
   ``weightQuantMode`` int8 and the
   ``paramBytes``, ``/metrics`` the gauge at 1 (3b-3e hold it at
   "none" and the kernel at 0 launches).  Then, not gated, against the
   same init unquantized (the bf16 model): the max
   logit gap on one prompt; one ring chunk as a
   graph (8 lanes, fill 520-632) through the kernels, through the plain
   route and on the bf16 model, in turns; a quantized prefill, 8 cold
   512-token prompts one by one and one 2048-token prompt
   (``PREFILL_LONG``; kernel B: 7 x n_layers launches a prompt), the
   same three ways, each with the host's ms to queue it beside the
   device's.  Then a short run of
   ``SERVE_WEIGHT_QUANT=int4`` and one of ``QUANTIZE=int8`` (lm_head
   quantized too: one more launch a tick and a prefill), each held to
   its launch formula, status, gauge and ``paramBytes``.
3j. chunked prefill main path — 3b's server (every dispatch a graph
   replay) at full width and depth: 6 resident streams (64-token
   prompts, 256 new tokens) decode; once each has decoded 2 chunks, 2
   cold 1,536-token prompts (64 new tokens) arrive.  Five servers: the
   bf16 and int8 pools each with ``SERVE_PREFILL=inline`` and with
   ``chunked`` at ``SERVE_PREFILL_CHUNK=256``, and the bf16 pool with
   the default slice (64).  Gated: the decode kernel (#2, or #3 on the
   int8 pool) launches n_layers x chunk_tokens x dispatches and no other
   decode kernel launches; every dispatch is a replay of the prewarm
   graphs at their addresses; ``chunked_prefill_tokens`` equals the
   prompts' tokens under ``chunked`` (0 inline) and the prefill queue is
   empty at the end; the pool's invariant holds and every block ends
   free or cached.  Printed: the residents' token gap (max and p95, over
   the run and while the long prompts admit), the long prompts' TTFT,
   each admission's and each slice's hold of the ring thread (host
   clock) and device ms (CUDA events around the work it queued), the
   longest intervals between dispatches, and how many streams equal the
   inline run's (not gated: a slice and a whole-prompt prefill round
   differently in bf16).
3k. the single-card depth recipe — 7b width, B 4 x 2049 tokens, bf16
   compute, one repeated batch, through ``fit``: (a) full depth, 32
   layers (6.738B params), ``make_optimizer(moments="int8")`` resident,
   4 steps; (b) (c)'s int8 run with ``create_state(
   offload_opt_state=True)``, 3 steps (32 layers until the script's
   time limit cut it); (c) 6 steps each: 8 layers with int8 moments, and 2 layers
   with f32 moments resident and offloaded (phase 3c trains the f32
   step at 8 layers); (d) 8 layers, int8, ``remat_policy`` "save_attn"
   and "dots" ((c)'s int8 run is "full").  Each run reports step ms,
   tokens/s, MFU against 989 TFLOP/s, peak ``max_memory_allocated``, the
   update's device ms (an event pair around ``opt.update``) and,
   offloaded, the H2D and D2H GB/s of the copy streams and the seconds
   the host slab took to allocate and pin.  Gates: every loss falls below
   0.7x its first value; flash forward launches = 2 x layers x steps
   under "full" and "dots", layers x steps under "save_attn", dK/dV and
   dQ layers x steps; ``adam8bit_update`` launches = tensors x steps
   with int8 moments, 0 with f32; (b)'s losses and grad norms equal
   (c)'s int8 run's first 3 bit for bit, and (c)'s offloaded f32 run its
   resident one; (b)'s peak at least ``OFFLOAD_SAVING_GB`` below that
   run's; after
   the offloaded runs every moment tensor is in its pinned host slab
   view, at the address it had before the first step.
3l. speculative decoding main path — 3b's server (8 slots, block 256,
   the 64-block pool, every dispatch a graph replay) with
   ``spec_k=4`` at full width and depth, bf16: (a) ``SERVE_DRAFT=auto``
   through ``spec_kw_from_env`` (the entry point's draft boot: a random
   ``cfg.draft()``, 8 layers, dim 2048, from seed 1) under 3b's burst
   (the cold prompts, the followers and the stream together, as a
   speculative ring caches no prefix; then the resubmission), and the
   cold prompts again at megastep 4; (b) a self-draft (the target
   drafts for itself) on the cold prompts; (c) (a) with
   ``SERVE_DRAFT_QUANT=int8``; (d) (a) on the int8 pool, where the
   tail resync is live.  Gated in every run: each request completes,
   kernel #1 launches draft n_layers x (K+1) x rounds, kernels #2 and
   #3 not at all, kernel #7 7 x that in (c) and not at all elsewhere,
   every dispatch is a replay of the prewarm graphs, ``/statusz``
   reads ``specK`` 4, the ring's own ``acceptRate`` and the draft's
   mode (and ``/metrics`` their gauges), ``paramBytes`` is the
   target's plus the draft's; megastep 4 gives megastep 1's tokens;
   (b) accepts at least ``SPEC_SELF_ACCEPT_BF16`` of its drafts (not
   1.0 at bf16: the draft's single-row tick and the multi-row verify
   round differently, and random weights are full of near-ties); the
   verify's logits at (a)'s cold streams' committed tokens lie within
   ``SPEC_VERIFY_TOL`` of the plain single-row forward's (the verify's
   attention recipe at one row), while a planted fault, the same
   verify one position off, lies beyond it and its argmax share with
   kernel #1 predicts a self-draft keeping less than
   ``SPEC_SELF_ACCEPT_BF16``; (a)'s draft ring and (c)'s quantized
   projections have the shapes phases 2 and 2e held kernels #1 and #7
   to (``SPEC_DRAFT_ATTN``, ``QMM_DRAFT_SHAPES``); (e) ``serve.main()``
   in a process of its own, with ``SERVE_CONTINUOUS=1 SERVE_PAGED=1
   SERVE_SPEC_K=4`` and, at the same time in another, with
   ``SERVE_DRAFT_QUANT=int8`` too, boots,
   answers a request, reads ``specK`` 4, the response's acceptance
   and the draft's mode on ``/statusz`` (``paramBytes`` as in (a) or
   (c)) and exits 83 on SIGTERM.  Printed: those gaps, the
   agreement with 3b's streams, a round's device ms at fill 520 (the
   whole round as its graph; the draft's ticks, the verify and the
   acceptance each as a graph of its own, beside their byte bounds),
   the burst's new tok/s beside 3b's, the graph pool's bytes and
   ``paramBytes``.
3m. many-adapter serving main path — 3b's server (8 slots, block 256,
   the 64-block pool, every dispatch a graph replay) at full width and
   depth, bf16, with an ``AdapterRegistry`` of adapters a1, a2, a3
   (seeds 1-3; rank 8, capacity 8, the JAX defaults: 226,492,416 bytes
   of stacks at 7b): (a) 3b's 8 cold prompts over HTTP, the lanes
   alternating base / a1 / a2 / a3 in the same dispatches; each request
   completes, kernel #2 launches n_layers x chunk x dispatches, one
   graph replay each, ``/statusz`` lists the adapters; the base lanes'
   agreement with 3b's streams is printed.  (b) After capture, ``POST
   /v1/adapters`` loads a4 (seed 4) into free slot 4; a request with a4
   must stream what a ring booted with a4 streams.  (c) An evict of a4
   answers 409 while a lane serves it, 200 once idle, and ``/metrics``
   then marks a1-a3 loaded only; no captured tensor moved.  (d) On
   executors admitted alike (8 lanes at fill 520 on slots 0-3, 0-3),
   the adapter ring against the adapterless ring in turns: a chunk's
   device ms as a graph on the bf16 pool at megastep 1 and 4 and on the
   int8 pool, the aid-0 lanes' tokens bit-identical; the delta alone
   (``lora_qkv`` over every layer for one tick, as a graph) on that mix
   and on 8 distinct adapters, beside its byte bound; the launches of a
   tick on both rings (profiler); the graph pools.  (e) ``serve.main()``
   in a process of its own with ``SERVE_ADAPTERS=a1:seed:1,...``
   boots, answers a request with ``"adapter": "a2"``, lists the three
   on ``/v1/adapters``, ``/statusz`` and ``/metrics``
   (``tpujob_serve_adapter_loaded``) and exits 83 on SIGTERM.
3n. ring operations main path — 3b's server at full width and depth,
   bf16, with ``SERVE_NAN_CHECK`` and ``SERVE_TRACE`` on: (a) on
   executors admitted alike (8 lanes at fill 512), a chunk's device ms
   as a graph with the finite check and without it, in turns, the warm
   dispatch's tokens identical; (b) 3b's burst (``burst_requests``) with
   a ``nan_lane`` fault before dispatch 6 (or the first after it with
   such a lane) on a seeded pick of the resident lanes that will still
   decode that dispatch (``_live_victim_injector``): exactly that
   request fails (503, or the stream's error event) as quarantined,
   every other equals 3b's stream, the
   paged kernel launches n_layers x chunk x dispatches, the pool's
   invariant holds and every block ends free or cached; (d) every
   response carries a span tree with one root and the phase spans, and
   the host cost of span capture a dispatch is printed beside the
   burst's wall a dispatch; (c) one ``dispatch_fail``: a retriable 503,
   the ring heals, captures new graphs and serves the retry with 3b's
   tokens; (e) a mid-flight swap (a streamed request decoding) to the 7b
   params of seed 1, made on the card, then a checkpoint-less ``POST
   /v1/swap`` back to the retained base (``serve.host_state``, as
   ``SERVE_SWAP_RETAIN`` keeps it): the stream completes across each
   swap with its lane parked and restored, each swap's wall and its
   park, upload, flip, capture and restore seconds, the stream's largest
   token gap and the peak allocated memory are printed, and 3b's burst
   then equals 3b's streams; (f) ``POST /v1/swap {"weight_quant":
   "int8"}``: 3b's cold prompts through the int8 weights, kernel A and
   kernel B launched as ``qmm_launches_want`` counts them, ``/statusz``
   ``weightQuantMode`` int8.
3o. disaggregated prefill main path — 7b at full width and depth, bf16,
   3b's server with ``SERVE_PREFILL=disagg``: (a) 3b's burst through the
   in-process 1-lane engine (its own thread, stream and pool; the
   inline insert's prefill program), every stream equal to 3b's bit for
   bit, kernel #2 launched n_layers x chunk x dispatches times; (b) 3j's
   traffic (6 residents, two cold 1,536-token prompts) under
   chunked@256 (3j's run when 3j ran), the 1-lane engine and the 4-lane
   engine with streamed frames (SERVE_PREFILL_CHUNK 256), on the bf16
   and int8 pools: the residents' largest and p95 token gap, the long
   prompts' TTFT, the engine's dispatches' device ms (CUDA events on its
   stream), each handoff item's hold of the ring thread, the handoff and
   frame counters, kernel #2 / #3 launches, replays and peak allocated
   memory; (c) the same traffic on the bf16 pool against a prefill pod
   started as a subprocess (``python -m
   paddle_operator_tpu_torch.infer.prefill_serve``, 4 lanes, frames
   streamed) on the same card, through the client a replica builds from
   its environment (``remote_prefill_client_from_env``: two workers):
   every handoff remote, the most residents ever decoding at once and
   how many resolved before the long prompts came (they go once each
   resident has decoded two chunks or resolved), the long prompts'
   bytes and submit-to-final seconds, one whole-envelope POST's wire
   GB/s (the body's read alone), and the pod's exit code 83 after
   SIGTERM; (d) the handoff copy of a 1,536-token prompt alone (6
   blocks), device ms against its byte bound.
3p. fleet-level KV — 7b at full width, depth cut to the first
   ``CUT_LAYERS`` (2), bf16 weights: two port
   replicas in one process over one params tree, each 3b's ring with a
   64-block pool and a host tier (16 blocks on A, 2 on B), served on
   loopback and wired by ``wire_fleet_kv_from_env`` from the env a pod
   gets (SERVE_KV_MIGRATE=1, SERVE_KV_PEER_FETCH=1, SERVE_KV_PEERS naming
   the other).  (c) peer prefix fetch: B's cold admission of a 528-token
   prompt, waves of 8 cold 1,900-token prompts decoding 48 tokens each
   (together they map the whole pool) that push its chain out of B and
   demote its two full blocks into A's tier, then the prompt on B,
   which fetches them from A's ``/v1/kv/prefix``: one fetch, two blocks
   imported and promoted, 16 prefill tokens; B's TTFT fetched and cold,
   the export's ms and bytes.  (a) drain by migration on the bf16 pool:
   8 requests (prompts of 100-400 tokens, 256 new tokens, each with a
   ``request_id``) on A once their streams ran unmigrated on B; when
   every lane decoded two chunks A drains, every lane migrates to B over
   HTTP (A answers each request 503, ``LaneMigrated``) and each request,
   retried on B with its ``request_id``, completes there with the
   unmigrated run's tokens bit for bit; A's ``laneMigrations`` == B's
   ``adoptedLanes`` == the lanes resident at the drain, and B's kernel #2
   launches == n_layers x chunk x B's replays (counted replay by
   replay); readings: each spill's hold of A's ring thread, each lane's
   envelope bytes, encode ms, POST ms and GB/s, B's decode and adoption
   ms, adopt to first resumed token, the move's token gap and each
   stream's largest gap.  (b) the same with 4 lanes on the int8 pool
   (kernel #3 on B).  The peak memory allocated is printed.
4. kernel path == plain path — 7b width, 2 layers, float32: greedy
   ``generate`` through the kernel and through the plain version give
   the same tokens, and per-step logits agree within 1e-3.
4b. paged ring == contiguous ring == ``generate`` — 7b width, 2
   layers, float32: four prompts, one a prefix hit, give identical
   greedy tokens through the paged ring (paged kernel), the contiguous
   ring (kernel #1) and ``generate``.
4d. int8 ring kernel path == plain path — 7b width, 2 layers, float32,
   bs 16: four prompts (one a block-aligned full hit, one a mid-block
   hit) give identical greedy tokens through the int8 ring with the
   kernel and with the plain dequantizing view; per-tick logits of one
   lane over 44 ticks, each tick from the same state, agree within
   1e-3; the worst logit delta of the int8 pool against the unquantized
   pool is reported, not gated.
4e. megastep == single step, graph == eager — 7b width, 2 layers,
   float32, on the contiguous, paged and int8 rings (bs 16), four
   prompts through ``ContinuousBatcher``: megastep 4 gives megastep 1's
   tokens, also with an eos that fires inside a fused iteration and,
   on the paged rings, with every lane's step budget cut to one
   iteration (lanes freeze mid-megastep and resume).  Then, on two
   executors driven from the same admissions, six dispatches (1-step
   and 4-step, with an eos, a budget that runs out and a frozen lane):
   each graph replay's tokens, counts, positions and lane tokens equal
   the eager program's bit for bit.
4f. restore under graphs — 7b width, 2 layers, float32, bs 16, on the
   paged ring at megastep 1 and 4 and the int8 ring at megastep 1 (2
   slots, chunk 8): lane A (40 tokens) decodes alone in slot 0, every
   dispatch a graph replay; at a boundary with its frontier mid-block
   it is spilled, lane B takes slot 0 for one dispatch, A is restored
   into slot 1 and both continue.  A's tokens must equal its
   uninterrupted run's bit for bit (graphs both), and the same spill and
   restore driven eagerly through the plain attention path (the token
   identity phases 4b and 4d hold); the state's addresses and the graphs
   are those from before the restore, and the paged kernel launched on
   the dispatches after it.
4g. host tier equalities — 7b width, 2 layers, float32, bs 16, 2 slots,
   chunk 8, on the bf16 and int8 pools at megastep 1 and 4: three
   48-token prompts, two 112-token fillers, then the three prompts and
   a 40-token prompt whose hit ends mid-block.  Through a pool of one
   lane's worth of blocks (8) with a 16-block tier — the chains demote
   while the fillers run and host-hit back — with the kernel and with
   the plain attention path, and through a store restart (a 4-block
   tier spills the chains, a fresh ring on the same directory serves
   the second round), the tokens equal the tier-off ring's (a pool that
   never evicts), with >= 3 promoted blocks, >= 1 store hit, the graphs
   and the state's addresses those from before the host hits, and the
   paged kernel launched after them.
4h. weight-quantized rings == the plain route — 7b width, 2 layers,
   float32, int8 and int4 weights (the serving skip list), bs 16: four
   prompts (one a prefix hit) through the ring under graph replay at
   megastep 1 and 4, through the int8-weight kernels (the 129-token
   prompt's prefill through kernel B's f32 body, the rest through kernel
   A's; both must launch), give the greedy tokens of ``generate`` on the
   plain route (every projection by the formula) on the bf16 pool.  On
   the int8 pool, which quantizes each prefill's K/V, so that the
   kernels' f32 sums (in another order than cuBLAS's) can move a code
   and a near-tied argmax with it: megastep 4 gives megastep 1's
   tokens, and the agreement with the same ring on the plain route is
   printed with the first differing token; the port's route before
   kernel B (``_formula_above(16)``: the ticks and the hit's suffix
   through kernel A, prefills by the formula) gives the plain route's
   tokens at megastep 1 and 4; and each cold prompt's prefill into an
   int8 pool through the kernels and through the plain route from empty
   pools gives logits within ``QUANT_POOL_LOGIT_ATOL`` (1e-3, 4d's), codes
   at most one step apart and scales within ``QMM_F32_ATOL`` relatively,
   then 24 ticks through kernel A, each also run on the plain route from
   a copy of the same state, logits within the same limit.  A lane
   spilled and restored into another slot under graphs gives its
   uninterrupted tokens and the plain route's.
4i. chunked prefill equalities — 7b width, 2 layers, float32, bs 16,
   4 slots, chunk 8, slices of 24 rows (not a divisor of the block), on
   the contiguous, paged and int8 rings: four prompts (40, 300, 129 and
   64 tokens) together, then the 64-token prompt again (a full hit
   capped at 63 rows: a mid-block hit) and a 197-token follower of the
   300-token prompt's first 10 blocks (a hit, then two slices).  Under
   graph replay, chunked at megastep 4 gives megastep 1's greedy
   tokens, and so does the same chunked ring with every dispatch run
   eagerly; on the contiguous and paged rings they are the inline ring's
   tokens, which are ``generate``'s (on the int8 ring the agreement with
   inline and ``generate`` is printed, not gated: the int8 pool's tokens
   need not equal the exact cache's, nor a slice's — which reads its
   earlier blocks as codes — a whole prompt's).  Every graph run
   replays the prewarm graphs at their addresses for every dispatch,
   the ring's decode kernel launched n_layers x chunk x megastep x
   dispatches, every prefill token came in a slice, and the paged rings
   hit 63 + 160 rows.
4j. speculative rings == ``generate`` — 7b width, 2 layers, float32,
   K 4, bs 16, under graph replay: four prompts through the contiguous,
   paged and int8 spec rings with a random draft (seed 1) and a
   self-draft, at megastep 1 and 4, and with chunked prefill (24-row
   slices: the speculative final inserts).  Megastep 4 gives megastep
   1's tokens on every ring; on the contiguous and paged rings every
   stream (random, self-draft, chunked) equals ``generate``'s and the
   self-draft accepts at least 0.9 (the int8 ring is held to itself:
   its verify reads the blocks it completes as codes); kernel #1
   launches draft n_layers x (K+1) x rounds and the paged kernels not
   at all.  A lane spilled and restored mid-speculation (a class-0
   arrival on a one-slot ring, both pools) resumes its uninterrupted
   stream (and, on the paged ring, ``generate``'s).  A sampled stream
   (T 0.8) is the same on a second run with its seed and stays in the
   vocabulary.
4k. adapter rings — 7b width, 2 layers, float32, bs 16, 4 slots, chunk
   8, rank 8, under graph replay, on the contiguous, paged and int8
   rings: 4i's four prompts on the base model, a1, a2 and a3 in one
   batch, then a1's follower (a hit on a1's chain) and a3's prompt again
   (a capped full hit), inline, chunked (24-row slices) and chunked at
   megastep 4.  The base lane equals the adapterless ring's; each lane
   equals its run alone; megastep 4 equals 1; on the contiguous and
   paged rings every stream equals ``generate`` with the same ``lora``
   leg (the int8 ring is held to itself, as in 4i); an a1 lane
   preempted by a class-0 arrival on a one-slot paged ring resumes its
   uninterrupted stream (both pools); with each adapter, the prefill's
   and a kernel #1 decode step's logits lie within 1e-4 of a forward on
   merged weights W + A.B.  Graph replays, addresses, launches and the
   prefix hits (63 + 160 rows) are held as in 4i.
4l. ring operations — 7b width, 2 layers, float32, block 256, 4 slots,
   chunk 8, under graph replay, on the contiguous, paged and int8 rings
   at megastep 1 and 4, four prompts (two greedy, two sampled): a ring
   with ``SERVE_TRACE`` and ``SERVE_NAN_CHECK`` streams what an untraced
   ring streams (one span root a request); the prompts again take the
   prefix-hit path, and under a ``nan_lane`` fault on lane 1 (at the
   first dispatch that lane 1 decodes with tokens to spare,
   ``_live_victim_injector``) its request
   alone fails with ``LaneQuarantined`` while the others equal that
   chaos-free path; on the paged and int8 rings a mid-flight swap to
   identical weights (lanes parked, graphs captured again, lanes
   restored) changes no stream, and a swap to the seed-4 params streams
   what a fresh ring on them streams (the paged ring: ``generate``'s
   greedy tokens); every dispatch is a graph replay.
4m. disaggregated rings — 7b width, 2 layers, float32, bs 16, 4 slots,
   chunk 8, under graph replay, 4i's traffic (four cold prompts, then a
   full and a partial prefix hit, which admit inline): on the bf16 pool
   the 1-lane engine at megastep 1 and 4, the 4-lane engine (slices of
   24 rows, rounded to 32) with and without streamed frames and its own
   prefix cache, a remote prefill pod (a server in this process, 4
   lanes, frames streamed) and a speculative ring (self-draft, K 4)
   each equal the inline ring and ``generate``, and so does an inline
   speculative ring; on the int8 pool the 1-lane engine (megastep 1 and
   4) equals the inline ring, the speculative disaggregated ring the
   inline speculative ring, and the 4-lane rings and the pod equal each
   other (their slices read earlier blocks as codes).  Launches,
   replays, the handoff counters, the prefix hits and the pool
   invariant are held.
4n. fleet-level KV — 7b width, 2 layers, float32, bs 16, 2 slots,
   chunk 8, under graph replay: a lane drained off ring A by migration
   through the lane envelope's codec and adopted by ring B (the origin's
   handle raises ``LaneMigrated``) equals the same request run
   unmigrated on B — on the bf16 pool at megastep 1 and 4, on the int8
   pool at megastep 1 and 4, a speculative lane (self-draft, K 4) and an
   adapter lane — and ``generate`` (with the adapter's ``lora`` leg; on
   the int8 pool reported, not gated); B keeps its graphs and their
   addresses, every B dispatch is a replay, and the int8 envelope's
   never-committed blocks carry scale 0.0.  A 70-token prompt demoted
   on one server and fetched over HTTP by the other (SERVE_KV_PEERS)
   admits with the cold admission's tokens, which equal ``generate``.
3q. the operator's training pod on the port — ``python -m
   paddle_operator_tpu_torch.launch.launcher -- python <child>`` in a
   subprocess with ``TPUJOB_DRAIN=1`` and the env the JAX package's
   ``controller/builders.py`` gives the one worker of a one-worker job
   (``MOE_POD_ENV``; the checkpoint path a temporary directory).  The
   child (``MOE_TRAIN_CHILD``) calls ``launcher.initialize()``, restores
   or inits ``7b-moe`` at full width cut to 1 layer (f32 master, bf16
   compute, int8 moments through kernel #8: f32 moments made each save
   12.6 GB, a third of the phase, until the script's time limit cut
   them) and trains it through ``fit`` under a
   ``PreemptionWatcher`` on B=4 x 2,049 tokens, one line a step (loss,
   aux_loss).  After step 3 the shim gets SIGTERM: it forwards it, the
   child drains a checkpoint of the step in flight and exits 83, and the
   shim's own exit code must be 83.  A second launch through the shim
   resumes at the drained step and takes 2 steps (exit 0).  Gates: rc
   83; the resumed step; finite loss and aux_loss on every step; the
   checkpoint holds ``layers.0.moe.*``; kernels #4-#6 launched 2 x 1 /
   1 / 1 a step (full remat).  Read: step ms, MFU on active params.
3r. ``7b-moe`` served at full width, depth cut to ``CUT_LAYERS`` (2
   layers, bf16; 32 until the script's time limit cut it)
   — the dense 7b released first and the allocated memory logged before
   the init; 3b's server and burst (``phase_ring_main_path``: 8 slots,
   chunk 8, block 256, a 64-block pool; kernel #2 32 launches a tick),
   then the same model quantized in place under
   ``SERVE_WEIGHT_QUANT=int8`` (one expert weight at a time) on the same
   traffic (kernel A (4 + 2E) x 8 = 160 launches a tick, kernel B on
   the prompts above 64 tokens, ``paramBytes``); each ring's device ms
   a chunk (a graph, 8 lanes at fill 520) against the bound of reading
   every weight but the embedding and the lanes' KV each tick (the
   exact MoE FFN reads every expert every tick), TTFT and the peak
   allocated memory.  Gate: every stream ends and its tokens are in
   range.
4o. MoE equalities — ``7b-moe`` and ``7b-moe2`` at 7b width, 2 layers,
   float32, ``moe_capacity_factor`` 8 (>= E: no drop): the prefill's
   logits equal the training forward's (1e-4) and a decode step the
   forward's last position (2e-4); the paged ring through kernel #2
   equals ``generate`` token for token (a prefix hit among the
   prompts); a speculative ring (K 4, the random ``cfg.draft()``, an
   MoE model too) equals ``generate``; the int8-weight ring through
   kernels A and B equals the same ring through the formula; the
   int8-pool ring through kernel #3 equals the same ring through the
   plain version.
4c. training kernel path == plain path — 7b width, 2 layers, float32:
   three train steps with attention through the flash kernels and
   through ``reference_attention`` from the same init agree in loss
   (rtol 1e-5) and grad_norm (rtol 1e-4).
3s. the operator's training pod of a mesh job — ``python -m
   paddle_operator_tpu_torch.launch.launcher -- python <child>`` with the
   env the JAX package's ``controller/builders.py`` gives the one worker
   of a one-worker TPUJob whose ConfigMap carries ``TPUJOB_MESH`` of
   size 1 (``MESH_POD_ENV``).  The child (``MESH_TRAIN_CHILD``) runs the
   mesh path a multi-worker job runs: ``initialize()`` -> ``job_mesh``
   (a world-1 nccl group, every axis 1) -> ``state_shardings`` /
   ``create_state(mesh=...)`` -> ``make_step_for_mesh`` -> ``fit`` over
   ``DevicePrefetcher(mesh=...)``, on 7b at full width cut to
   ``MESH_TRAIN["layers"]`` layers (f32 master, bf16 compute, full
   remat), B=4 x 2,049 tokens; first the same 3 steps without a mesh
   (phase 3c's step) from the same seed on the same batches.  Gates: the
   mesh step's losses and grad norms (rtol 1e-5) and parameters (atol
   1e-5) equal the step without a mesh — the phase prints whether they
   are bit-equal or the largest differences; kernels #4-#6 launched
   2 x layers / layers / layers a step on both runs.  Read: step ms,
   tokens/s, MFU, peak memory over 6 more mesh steps.  (b): two
   processes, started before (a) so that their start overlaps it and
   waiting for the reference run before they train, on the one card
   try gloo's all-reduce, all-gather and
   reduce-scatter and the cp/pp exchange (``all_to_all_single`` with
   split sizes, one way, and even) on CUDA tensors (NCCL cannot put two
   ranks on one device) and print its answers; a refused one fails the
   phase.  Then the two ranks train ``MESH_PAIR`` (the 1b preset's
   width, 2 layers, f32, B=4 x 513) on each mesh of
   ``MESH_PAIR_MESHES`` in turn: fsdp=2, tp=2 (8 of 16 heads a rank
   through kernels #4-#6; both with int8 moments, below), cp=2 with
   ring attention (plain ops: no flash
   launch) and with Ulysses (8 heads a rank over all 512 positions
   through kernels #4-#6), pp=2 under GPipe and under 1F1B (1 layer a
   stage, 4 microbatches), 3 steps each, held to the same model's run
   without a mesh in this process: losses (rtol 1e-5), grad norms (rtol
   1e-4), the ranks' metrics equal, every parameter compared once, at
   most one in 10,000 off by more than 1e-5 and none by more than 2 lr a
   step (Adam's step is about lr whatever a gradient's size, so an
   element whose gradient sits at the f32 noise of the two summation
   orders can step either way; a wrong shard would move whole blocks),
   and each rank's flash launches the formula's
   (``mesh_pair_launches``).  Two more runs on the pair: dp=2, whose
   step 3 is saved and then restored on one card in this process through
   ``ft/elastic.py`` ``elastic_resume`` (the moments reassembled from the
   dp2 shard file) and trained 2 more steps, held by the same gate to the
   reference run's steps 4 and 5 (its plan's step 3, no step lost, kernels
   #4-#6 4/2/2 a step pair); and ep=2 at ``MESH_PAIR_MOE`` (``7b-moe`` at
   full width, 1 layer, f32, capacity factor 0.5: each rank runs 4 of
   the 8 experts on all 2,048 tokens), held by the same gate (and its
   ``aux_loss``, rtol 1e-5) to ``7b-moe`` without a mesh, kernels #4-#6
   6/3/3 a rank, and assignments dropped on every step.  The pair
   trains once (a) is done, while this process runs the references
   (int8 first), and reads each when it checks a mesh.  Each rank compares
   the region it holds of each parameter no earlier rank on its
   replicated axes holds.  fsdp=2 and tp=2 run with int8 moments
   (``MESH_PAIR_INT8``): fsdp=2 (every parameter aligned: a rank's
   256-wide blocks are its own columns), tp=2 (``w1``/``w3`` not aligned
   and ``lm_head``'s blocks replicated: their rows gathered over tp), and
   fsdp=2 once more with the moments offloaded for 2 steps, held to the
   int8 run without a mesh in this process: losses and grad norms rtol
   1e-5, the ranks' metrics equal, the parameters after step 3 by the
   gate above (counting off only elements under no code that came out
   other than the reference's at some step, as
   tests/test_torch_opt8bit.py does), codes more than one off in fewer
   than one in 10,000, kernel #8 launched once a parameter tensor a step
   on every rank and the plain update never; the offloaded run equals
   the resident fsdp=2 run bit for bit after each step, its moments in
   the pinned slab between steps.  tp=2 saves its step 3 and goes on to
   step 5; beside the pair's later meshes, this process restores step 3
   on one card (every region the ranks held, of each parameter, code and
   scale, equal bit for bit to their checksums) and trains 2 more steps,
   held by the same rule to tp=2's own steps 4 and 5 and by their
   losses and grad norms to the reference's (``_pair_int8_restore``;
   both are also read against the reference's step 5).
   And the launcher shim, given a
   ConfigMap of one pod of 2 cards (``CARDS2_POD_ENV``), starts 2
   children that refuse to share the one card by name before joining a
   group: the pod exits non-zero within seconds.  Read: each rank's step
   ms, peak memory, the bytes its cp/pp exchanges sent a step, its ep
   (and tp) all-reduces moved and its int8 gathers brought by case, the
   dropped assignments, the restores' seconds.
3t. tensor-parallel serving (``SERVE_TP``) on two processes that share
   the card over gloo (``TP_SERVE_CHILD``: ``make_serving_mesh(2)``, rank
   0 a ``ContinuousBatcher(mesh=...)``, rank 1 ``follow_ring``; NCCL
   cannot put two ranks on one device, so every dispatch runs eagerly
   and every collective crosses the host).  (a) 7b at full width cut to
   ``SERVE_TP_RUNS["a_layers"]`` layers, float32, each rank's cut of
   the same seeded init (``init_serving_shard``): the contiguous ring,
   the paged ring, the int8 pool, int8 weights and one adapter, each
   token-identical to the same ring at tp 1 in this process (the paged
   and contiguous rings also to ``generate``); the paged ring and the
   int8 pool take a second wave on the longest prompt's cached blocks
   (a whole-block hit that decodes on a copy-on-write copy, on the int8
   pool through a staging tail seeded from it, and a shared head with a
   suffix of its own), their prefix hits and copies nonzero; each
   rank's launches of kernels #1, #2, #3, A and B the formulas' and
   equal; kernels #1, #2,
   #3 and A on a rank's shapes (16 of 32 heads, 2,048 of wq's and of
   w1's columns, wo's rows) held to their plain versions (1e-4).  (b)
   7b at ``SERVE_TP_RUNS["b_layers"]`` layers, bf16: 3b's burst at tp 2,
   kernel #2's launches the formula's; each cold prompt's first-token
   logits (the tp prefill on the first n layers) within 0.15 of
   tp 1's at 2 layers (``SERVE_TP_RUNS["depths"]``' first), and at
   the full depth, where one card's own bf16 path is farther than 0.15
   from the same weights computed in f32, no more than 0.15 farther
   from that f32 value than tp 1 (each depth's three differences
   read); the share of tokens equal to 3b's read, beside the witness:
   the shares on which 3b's bf16 ring and tp 2 agree with 3b's ring run
   on the same weights computed in f32 on one card
   (``_tp_f32_burst``).  (c) ``SERVE_TP=2`` on this one-card pod
   refused by name.  Read: each rank's launches,
   all-reduce and all-gather calls and bytes a dispatch, a dispatch's
   wall and event ms.
5. report — a ``kernels`` JSON line, the card's name and power limit,
   and as the last line ``{"ok": true, "device": {...}}``.

float32 matrix products run in full float32 (TF32 off) throughout.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
PEAK_OPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
# kernel sources: decode_attention.cu holds decode_attention_launch,
# paged_decode_attention_launch and paged_decode_attention_quant_launch;
# flash_attention.cu the forward and both backward kernels;
# quant_matmul.cu the int8-weight kernels (A: the decode rows, B: the
# prefills); adam8bit.cu the 8-bit AdamW update
# phase 2e's timing build of csrc/quant_matmul.cu (its variants, compiled
# only with -DQMM_PROBE; the port's wrappers load the plain build)
QMM_PROBE_BUILD = "quant_matmul:QMM_PROBE"
KERNELS = ["decode_attention", "flash_attention", "quant_matmul", "adam8bit",
           QMM_PROBE_BUILD]
# bf16 kernels against their plain version in f32 on the same bf16
# inputs: about 3x the worst error read on the card over every case of
# phases 2 and 2b (1.9e-3 and 3.1e-3 on an H100 80GB HBM3 at 700 W)
BF16_ATOL = 1e-2
# bf16 flash kernels against their plain version in f32 on the same bf16
# inputs, element by element: |err| <= atol + rtol |want|.  rtol 2^-6
# covers a few bf16 roundings (the output's, p's, ds's); each kernel's
# atol is about 2.5x or more its own worst |err| - rtol |want| read on
# the card over every case of phase 2c in three runs (3.0e-3 forward,
# 1.2e-2 dK/dV, 5.5e-3 dQ on an H100 80GB HBM3 at 700 W)
FLASH_BF16_ATOL = {"flash_forward": 1e-2, "flash_backward_dkv": 3e-2,
                   "flash_backward_dq": 1.5e-2}
FLASH_BF16_RTOL = 2.0 ** -6
# and as a whole: ||got - want|| / ||want|| (Frobenius) of each output,
# about 4x the worst reading (2.4e-3, every output: a few bf16 roundings
# of relative size 2^-9); a fault confined to some rows or tiles moves
# it by their share of the norm
FLASH_BF16_REL = 1e-2
# phase 2d's bf16 cases as a whole, ||got - want|| / ||want||: the same
# few bf16 roundings (of code x scale, p and the output)
QUANT_BF16_REL = 1e-2
# phase 3c: 7b width cut to 8 layers, B x (S + 1) tokens, bf16 compute
TRAIN = dict(layers=8, batch=4, seq=2048, steps=12, lr=1e-3)
# phase 3f: 7b width cut to 1 layer (f32 master, bf16 compute; 2 layers
# took 78 s of a 1,266 s run on an H100 80GB HBM3 at 700 W), B x (S + 1)
# tokens; U saves every `interval` steps, R is preempted while the step
# consuming batch `drain_at` is in flight.  The continued run must equal
# U bit for bit (losses and final params): two unbroken runs of the
# phase read bit-identical with PyTorch's default algorithms (max |loss
# difference| 0.0 on an H100 80GB HBM3 at 700 W; the embedding backward
# sorts its indices, and cuBLAS on one stream and the flash kernels
# rerun bit for bit)
CKPT = dict(layers=1, batch=4, seq=2048, steps=6, interval=3, drain_at=2,
            lr=1e-3, new_tokens=32)
# phase 3f: what the serving restore may add to the allocated device
# memory beyond the bf16 parameter bytes — the f32 RoPE tables (1 MiB)
# and the allocator's 512-byte rounding
SERVE_LOAD_MARGIN = 16 << 20
PEAK_BF16 = 989e12                 # H100 SXM dense bf16, for MFU
# phase 3l's draft ring, kernel #1's operands: the 7b cfg.draft() (16
# heads over 16 KV heads, D 128, 8 layers stacked in one cache) on 3b's
# 8 lanes of 2048 rows; phase 2 holds the kernel to its plain version
# there at the burst's fills, and 3l checks its draft against it
SPEC_DRAFT_ATTN = dict(b=8, hq=16, hkv=16, d=128, s=2048, layers=8)
PHASES = ("2", "2b", "2c", "2d", "2e", "2f", "3", "3b", "3c", "3d", "3e",
          "3f", "3g", "3h", "3i", "3j", "3k", "3l", "3m", "3n", "4", "4b",
          "4c", "4d", "4e", "4f", "4g", "4h", "4i", "4j", "4k", "4l", "3o",
          "4m", "3p", "4n", "3q", "3r", "4o", "3s", "3t")
# phase 3t: (a) 7b width cut to `a_layers`, f32, seed `a_seed`, the
# rings' arguments and requests (prompt lengths, new tokens; the second
# wave's `shared_prefix`: the whole blocks of the longest prompt one
# request is, then the blocks another shares and its own tokens); (b)
# 7b at `b_layers`, bf16, seed 0 (make_7b's init) on 3b's burst, the
# first-token logits read at `depths`
# bf16 logits, the repo's bound (tests/test_kvquant.py TOL)
BF16_TOL = 0.15
SERVE_TP_RUNS = dict(a_layers=2, a_seed=7, b_layers=32, lens=(7, 40, 100),
                     new=16, ring=dict(slots=4, chunk_tokens=8, max_len=512),
                     block_size=16, timeout=600, depths=(2, 8, 32),
                     shared_prefix=(5, 3, 20))
# phase 3q: 7b-moe at full width cut to 1 layer (each layer adds 0.79B
# params, ~3.9 GB of f32 params and int8 moments to a save; with f32
# moments a save was 12.6 GB, 24 s of the phase); B x (S + 1)
# tokens; SIGTERM to the shim once step `drain_after` is logged; the
# resumed launch takes `resume_steps`
MOE_TRAIN = dict(layers=1, batch=4, seq=2048, steps=12, drain_after=3,
                 resume_steps=2, lr=1e-3, moments="int8")
# the env controller/builders.py of the JAX package gives the one worker
# of a one-worker TPUJob named moe-train (the ConfigMap's data and the
# pod's own vars, POD_IP its podIP); TPUJOB_CHECKPOINT_PATH is set per
# run.  tests/test_torch_launcher.py holds it equal to what
# controller/builders.py makes.
MOE_POD_ENV = {
    "TPUJOB_PORT": "8476", "TPUJOB_PORTS_NUM": "8",
    "TPUJOB_NAME": "moe-train", "TPUJOB_WORKER_HOSTS": "127.0.0.1",
    "TPUJOB_NUM_WORKERS": "1",
    "TPUJOB_COORDINATOR_ADDRESS": "127.0.0.1:8476",
    "POD_IP": "127.0.0.1", "TPUJOB_RANK": "0", "TPUJOB_ROLE_RANK": "0",
    "TPUJOB_RES_TYPE": "worker", "TPU_WORKER_ID": "0",
    "TPUJOB_ROLE": "TRAINER", "TRAINING_ROLE": "TRAINER",
}
# phase 3s: 7b at full width cut to `layers`, B x (S + 1) tokens; the
# mesh run and the run without a mesh take `steps` steps from the same
# init on the same batches, then the mesh state takes `timed_steps` more
MESH_TRAIN = dict(layers=4, batch=4, seq=2048, steps=3, timed_steps=6,
                  lr=1e-3)
# phase 3s (b): the 1b preset's width (dim 2048, 16 heads of 128, ffn
# 5504, vocab 32000) cut to 2 layers, f32, B x (S + 1) tokens, on two
# ranks sharing the one card
MESH_PAIR = dict(preset="1b", layers=2, batch=4, seq=512, steps=3, lr=1e-3)
# the int8-moment runs of 3s (b): kernel #8 launches a rank a step, one a
# parameter tensor (1b at 2 layers: 2 x 9 + the embedding, the final norm
# and lm_head); codes more than one off the reference's at most this
# share
MESH_PAIR_INT8 = dict(tensors=21, codes_far=1e-4)
# the env controller/builders.py gives the one worker of a one-worker
# TPUJob named mesh-train with a 1x1 TPU slice (so the ConfigMap carries
# TPUJOB_MESH, the mesh of size 1); tests/test_torch_mesh.py holds it
# equal to what controller/builders.py makes
MESH_POD_ENV = dict(
    MOE_POD_ENV, TPUJOB_NAME="mesh-train",
    TPUJOB_ACCELERATOR="tpu-v5-lite-podslice", TPUJOB_TOPOLOGY="1x1",
    TPUJOB_NUM_SLICES="1", TPUJOB_WORKERS_PER_SLICE="1",
    TPUJOB_MESH='{"dp": 1}')
# the env controller/builders.py gives the one worker of a one-worker
# TPUJob named two-cards with 2 chips a worker on a 2x1 slice, mesh fsdp 2
# (tests/test_torch_multicard.py holds it to the builders'): a pod of 2
# cards, which a machine of one card must refuse
CARDS2_POD_ENV = dict(MESH_POD_ENV, TPUJOB_NAME="two-cards",
                      TPUJOB_TOPOLOGY="2x1", TPUJOB_MESH='{"fsdp": 2}')


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int, warmup: int = 3, graph: bool = True) -> tuple:
    """Per-call time of ``fn(i)``: (device ms, eager ms).

    Device ms: ``iters`` calls captured into one CUDA graph, replayed
    between CUDA events — the card's time alone, without the host's
    per-call Python and launch cost (None with ``graph=False``).  Eager
    ms: the same calls issued one by one between CUDA events, which
    includes that host cost wherever the host issues slower than the
    card runs."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warmup):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    eager = start.elapsed_time(end) / iters
    if not graph:
        return None, eager

    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(iters):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    reps = 3
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    device = start.elapsed_time(end) / (iters * reps)
    del g
    return device, eager


def attention_bound_ms(b, hq, hkv, d, fill, dtype,
                       table_entries=0) -> tuple:
    """Least time for one decode-attention call: q, the filled K and V
    rows, lengths, the ``table_entries`` int32 block-table entries per
    lane that the fill needs (paged) and the output each moved once,
    against 4 * fill * D operations per (lane, query head) at the
    dtype's peak."""
    import torch

    e = torch.empty((), dtype=dtype).element_size()
    nbytes = (e * (2 * b * hq * d + 2 * b * hkv * fill * d) + 4 * b
              + 4 * b * table_entries)
    ops = 4 * b * hq * fill * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[str(dtype)] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_kernel_vs_plain(report: dict) -> None:
    import torch

    from paddle_operator_tpu_torch.ops import decode_attention as DA

    nan_lanes_check("contiguous", report)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # (name, B, Hq, Hkv, D, S, lengths, stacked layers or 0)
    cases = []
    for hq, hkv, d in [(8, 8, 64), (8, 4, 128), (16, 4, 64), (8, 2, 128)]:
        cases.append(("ragged", 4, hq, hkv, d, 517, [0, 1, 517, 300], 0))
    # the split's chunk edges: lengths 0, 1, chunk - 1, chunk, chunk + 1
    # and the whole cache, R = 1, 2 and 4 query heads a block, D 64 and
    # 128; a cache of exactly one chunk (no merge); a stacked-layer view
    cr = DA.CHUNK_ROWS
    edges = [0, 1, cr - 1, cr, cr + 1, 3 * cr + 45]
    for hq, hkv in ((8, 8), (8, 4), (16, 4)):
        for d in (64, 128):
            cases.append((f"chunk-edges-R{hq // hkv}", 6, hq, hkv, d,
                          3 * cr + 45, edges, 0))
    cases += [
        ("one-chunk", 3, 8, 4, 128, cr, [0, cr - 1, cr], 0),
        ("stacked-layer", 6, 8, 4, 128, 3 * cr + 45, edges, 3),
        ("main-path-b4", 4, 32, 32, 128, 2048, [513, 520, 530, 543], 0),
        ("main-path-b1", 1, 32, 32, 128, 2048, [95], 0),
        ("7b-fill128", 4, 32, 32, 128, 2048, [128] * 4, 0),
        ("7b-fill2048", 4, 32, 32, 128, 2048, [2048] * 4, 0),
        # 3l's draft ring: its burst's prompts (32 to 1000 tokens) a
        # few ticks on, and the last row of a 48-token answer
        ("spec-draft", *(SPEC_DRAFT_ATTN[k] for k in (
            "b", "hq", "hkv", "d", "s")),
         [33, 106, 262, 301, 514, 520, 611, 1052],
         SPEC_DRAFT_ATTN["layers"]),
    ]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype, atol, rtol in [(torch.float32, 1e-4, 1e-4),
                              (torch.bfloat16, BF16_ATOL, 0.0)]:
        for name, b, hq, hkv, d, s, lens, layers in cases:
            q = rand((b, hq, d), dtype)
            lead = (layers,) if layers else ()
            k = rand(lead + (b, hkv, s, d), dtype)
            v = rand(lead + (b, hkv, s, d), dtype)
            L = torch.tensor(lens, dtype=torch.int32, device=dev)
            layer = layers - 1 if layers else None
            got = DA.decode_attention(q, k, v, L, layer=layer).float()
            kl, vl = (k[layer], v[layer]) if layers else (k, v)
            want = DA.decode_attention_reference(q.float(), kl.float(),
                                                 vl.float(), L)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            lim = float((atol + rtol * want.abs()).min())
            ok = bool(((got - want).abs()
                       <= atol + rtol * want.abs()).all())
            log(f"kernel-vs-plain {name} {str(dtype)[6:]} B={b} Hq={hq} "
                f"Hkv={hkv} D={d} S={s} chunks={DA.split_chunks(s)} "
                f"layers={layers} lens={lens}: max_abs_err={err:.3e}"
                f" (atol {atol}, rtol {rtol})")
            if not ok:
                raise AssertionError(f"decode_attention disagrees with "
                                     f"its plain version: {name} {dtype} "
                                     f"max_abs_err {err} > {lim}")
            if 0 in lens and got[lens.index(0)].abs().max() != 0:
                raise AssertionError(f"decode_attention: a lane of length "
                                     f"0 does not give zeros ({name})")
            worst[dtype] = max(worst[dtype], err)
    report["max_abs_err_f32"] = worst[torch.float32]
    report["max_abs_err_bf16"] = worst[torch.bfloat16]
    report["max_abs_err"] = max(worst.values())

    # two runs on the same inputs give the same bits (the merge runs in
    # chunk order): the 7b shape at fill 2048 and the chunk edges
    for b, hq, hkv, s, lens in ((4, 32, 32, 2048, [2048] * 4),
                                (6, 16, 4, 3 * cr + 45, edges)):
        q = rand((b, hq, 128), torch.bfloat16)
        k, v = (rand((b, hkv, s, 128), torch.bfloat16) for _ in range(2))
        L = torch.tensor(lens, dtype=torch.int32, device=dev)
        first = DA.decode_attention(q, k, v, L)
        again = DA.decode_attention(q, k, v, L)
        torch.cuda.synchronize()
        if not torch.equal(first, again):
            raise AssertionError(f"two runs of decode_attention differ "
                                 f"(B={b} Hq={hq} Hkv={hkv} S={s})")
    log("decode_attention: two runs bit-identical (bf16, the 7b shape at "
        "fill 2048 and the chunk edges)")

    # timing at the 7b decode shape (bf16, the serving dtype): copies
    # rotate so the filled bytes of consecutive calls exceed the 50 MB
    # L2, as the 32 layers' caches do on the main path
    import torch.nn.functional as F

    b, h, d, s, copies = 4, 32, 128, 2048, 16
    dtype = torch.bfloat16
    lib = DA._library()
    qs = [rand((b, h, d), dtype) for _ in range(copies)]
    ks = [rand((b, h, s, d), dtype) for _ in range(copies)]
    vs = [rand((b, h, s, d), dtype) for _ in range(copies)]
    timings = []
    for fill in (128, 528, 2048):
        L = torch.full((b,), fill, dtype=torch.int32, device=dev)
        c = copies

        def kern(i):
            DA.decode_attention(qs[i % c], ks[i % c], vs[i % c], L)

        def plain(i):
            DA.decode_attention_reference(qs[i % c], ks[i % c],
                                          vs[i % c], L)

        def sdpa(i):
            F.scaled_dot_product_attention(
                qs[i % c][:, :, None], ks[i % c][:, :, :fill],
                vs[i % c][:, :, :fill])

        # in turns — plain, kernel, library, kernel, plain — so drift
        # shows as a gap between a repeat and its first reading
        row = {"fill": fill, "chunks": DA.split_chunks(s)}
        for key, fn, iters in (("plain_ms", plain, 16), ("ms", kern, 128),
                               ("library_ms", sdpa, 128),
                               ("ms_again", kern, 128),
                               ("plain_ms_again", plain, 16)):
            row[key], row[key.replace("ms", "eager_ms", 1)] = \
                time_ms(fn, iters)
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            b, h, h, d, fill, dtype)
        # the call's device ms at other chunk sizes (the wrapper takes
        # DA.CHUNK_ROWS)
        out = torch.empty_like(qs[0])
        sweep = {}
        for rows in (64, 128, 256, 512):
            sweep[rows], _ = time_ms(
                lambda i, rows=rows: DA._launch(
                    lib, qs[i % c], ks[i % c], vs[i % c], L, out,
                    d ** -0.5, torch.cuda.current_stream().cuda_stream,
                    chunk_rows=rows), 128)
        row["chunk_rows_ms"] = sweep
        log(f"timing 7b decode_attention bf16 B={b} H={h} D={d} S={s} "
            f"fill={fill}: " + json.dumps(row))
        timings.append(row)
    report["timings"] = timings
    main = next(r for r in timings if r["fill"] == 528)
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
        report[key] = main[key]
    del qs, ks, vs
    torch.cuda.empty_cache()


def nan_lanes_check(kind: str, report: dict) -> None:
    """Phases 2, 2b and 2d: NaN K/V rows reach the output of kernel #1
    (``kind`` "contiguous"), #2 ("paged") and #3 ("quant") as they reach
    the plain version's — the NaN-lane check (SERVE_NAN_CHECK) reads the
    logits.  At the 7b ring's heads (32 over 32, D 128), bs 256, 4
    chunks of rows, f32 and bf16, seven lanes: 0 and 5 finite, 4 of
    length 0; 1 (a) one all-NaN chunk in kv head 0 (the int8 pool: (c)
    a NaN K scale on a fully visible block); 2 (b) every visible row NaN
    in kv head 1, one chunk (int8: its staging tail); 3 (b) every
    visible row NaN in every head over three chunks (int8: the scales of
    its full blocks and its tail rows); 6 one NaN V row in kv head 2.
    The kernel must give non-finite values exactly where the plain
    version does — those heads — and, everywhere else, the bits of its
    own run on the same inputs without the NaNs."""
    import torch

    from paddle_operator_tpu_torch.ops import decode_attention as DA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    h, d, bs, cr = 32, 128, 256, DA.CHUNK_ROWS
    s = 4 * cr
    m = s // bs
    lens = [s, 2 * cr + 10, 100, 2 * cr + 10, 0, cr + 1, 3 * cr]
    b = len(lens)
    n = b * m + 1
    nan = float("nan")
    want = sorted({(1, 0), (2, 1), (6, 2)} | {(3, i) for i in range(h)})
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    table = (torch.randperm(n - 1, generator=gen, device=dev)[:b * m] + 1
             ).view(b, m).to(torch.int32)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        q = randn((b, h, d), dtype)
        if kind == "quant":
            kc, vc = (torch.randint(-127, 128, (n, h, bs, d), generator=gen,
                                    device=dev).to(torch.int8)
                      for _ in range(2))
            ks, vs = (torch.rand((n, h), generator=gen, device=dev) * 0.008
                      + 0.004 for _ in range(2))
            kt, vt = (randn((b + 1, h, bs, d), dtype) for _ in range(2))
            pks, pvs, pkt, pvt = (t.clone() for t in (ks, vs, kt, vt))
            pks[table[1, 1], 0] = nan
            pkt[2, 1, :100] = pvt[2, 1, :100] = nan
            for j in range(2):
                pks[table[3, j]] = pvs[table[3, j]] = nan
            pkt[3, :, :10] = pvt[3, :, :10] = nan
            pvt[6, 2, 1] = nan

            def run(ops):
                return DA.paged_decode_attention(
                    q, kc, vc, table, L, k_scale=ops[0], v_scale=ops[1],
                    k_tail=ops[2], v_tail=ops[3]).float()

            clean, poisoned = (ks, vs, kt, vt), (pks, pvs, pkt, pvt)
            plain = DA.paged_decode_attention_quant_reference(
                q.float(), kc, vc, table, L, *poisoned)
        else:
            k, v = (randn((b, h, s, d), dtype) for _ in range(2))
            pk, pv = k.clone(), v.clone()
            pk[1, 0, cr:2 * cr] = pv[1, 0, cr:2 * cr] = nan
            pk[2, 1, :100] = pv[2, 1, :100] = nan
            pk[3, :, :2 * cr + 10] = pv[3, :, :2 * cr + 10] = nan
            pv[6, 2, 5] = nan
            plain = DA.decode_attention_reference(q.float(), pk.float(),
                                                  pv.float(), L)
            if kind == "paged":
                def pool_of(x):
                    pool = torch.zeros((n, h, bs, d), dtype=dtype,
                                       device=dev)
                    pool[table.reshape(-1).long()] = x.view(
                        b, h, m, bs, d).transpose(1, 2).reshape(
                            b * m, h, bs, d)
                    return pool

                def run(ops):
                    return DA.paged_decode_attention(
                        q, pool_of(ops[0]), pool_of(ops[1]), table,
                        L).float()
            else:
                def run(ops):
                    return DA.decode_attention(q, ops[0], ops[1], L).float()

            clean, poisoned = (k, v), (pk, pv)
        got, base = run(poisoned), run(clean)
        torch.cuda.synchronize()
        fin = torch.isfinite(got)
        heads = sorted(tuple(x) for x in
                       (~fin).any(-1).nonzero().tolist())
        log(f"NaN lanes, {kind} kernel {str(dtype)[6:]}: non-finite "
            f"(lane, head) {len(heads)} (plain: "
            f"{int((~torch.isfinite(plain)).any(-1).sum())}, want "
            f"{len(want)}); the rest equals the clean run bit for bit: "
            f"{bool(torch.equal(got[fin], base[fin]))}")
        if not torch.equal(fin, torch.isfinite(plain)) or heads != want:
            raise AssertionError(
                f"{kind} kernel {dtype}: NaN rows do not reach the output "
                f"as in the plain version: non-finite heads {heads}, "
                f"expected {want}")
        if not torch.equal(got[fin], base[fin]):
            raise AssertionError(f"{kind} kernel {dtype}: the finite "
                                 "values differ from the clean run")
    report["nan_lanes"] = {"lanes": b, "nonfinite_heads": len(want),
                           "dtypes": ["float32", "bfloat16"]}


def _scrambled_table(rng, b, m, n_blocks):
    """[b, m] distinct pool ids drawn from 1..n_blocks-1 in a random
    order (block 0 is the trash block and is never mapped)."""
    import numpy as np

    ids = rng.permutation(np.arange(1, n_blocks))[:b * m]
    return ids.reshape(b, m).astype(np.int32)


def _paged_edges(DA, bs: int) -> tuple:
    """Lengths at a paged kernel's chunk and block edges for pool block
    size ``bs`` (0, 1, chunk - 1, chunk, chunk + 1, bs - 1, bs + 1 and
    the table's reach) and the table width M that holds them (four
    chunks or more)."""
    c = DA.paged_chunk_rows(bs)
    m = -(-(3 * c + 45) // bs)
    return [0, 1, c - 1, c, c + 1, bs - 1, bs + 1, m * bs], m


# a paged kernel's chunk rows swept beside its timing rows (2048: one
# chunk a lane at the timed shape, no split)
PAGED_SWEEP_ROWS = (64, 128, 256, 512, 1024, 2048)


def _paged_sweep(launch, q0, plain) -> dict:
    """The call's device ms at other chunk rows (the wrapper takes
    ``paged_chunk_rows``): ``launch(i, out, chunk_rows=...)`` runs call
    i into ``out``.  Each setting's first call is checked against
    ``plain`` (the plain version in float32) within ``BF16_ATOL``."""
    import torch

    out = torch.empty_like(q0)
    rows_ms = {}
    for rows in PAGED_SWEEP_ROWS:
        launch(0, out, chunk_rows=rows)
        torch.cuda.synchronize()
        err = float((out.float() - plain).abs().max())
        if err > BF16_ATOL:
            raise AssertionError(f"paged kernel at chunk rows {rows} "
                                 f"disagrees with its plain version by {err}")
        rows_ms[rows], _ = time_ms(
            lambda i, rows=rows: launch(i, out, chunk_rows=rows), 128)
    return {"chunk_rows_ms": rows_ms}


def phase_paged_kernel_vs_plain(report: dict) -> None:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from paddle_operator_tpu_torch.ops import decode_attention as DA

    nan_lanes_check("paged", report)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    rng = np.random.default_rng(2)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # (name, B, Hq, Hkv, D, bs, M, lengths, stacked layers or 0)
    cases = []
    for hq, hkv, d in [(8, 8, 64), (8, 4, 128), (16, 4, 64), (8, 2, 128)]:
        for bs in (16, 256):
            m = -(-517 // bs)
            cases.append((f"ragged-bs{bs}", 4, hq, hkv, d, bs, m,
                          [0, 1, m * bs, 300], 2))
    # the split's chunk and block edges: lengths 0, 1, chunk - 1, chunk,
    # chunk + 1, bs - 1, bs + 1 and the table's reach, R = 1, 2 and 4
    # query heads a block, D 64 and 128, bs 16 and 256; a stacked-layer
    # view
    for bs in (16, 256):
        lens, m = _paged_edges(DA, bs)
        for hq, hkv in ((8, 8), (8, 4), (16, 4)):
            for d in (64, 128):
                cases.append((f"chunk-edges-R{hq // hkv}-bs{bs}", len(lens),
                              hq, hkv, d, bs, m, lens, 0))
        cases.append((f"chunk-edges-stacked-bs{bs}", len(lens), 8, 4, 128,
                      bs, m, lens, 3))
    cases += [
        ("ring-7b-b8", 8, 32, 32, 128, 256, 8,
         [0, 33, 101, 258, 301, 512, 601, 1001], 0),
        ("7b-fill2048", 8, 32, 32, 128, 256, 8, [2048] * 8, 0),
    ]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype, atol, rtol in [(torch.float32, 1e-4, 1e-4),
                              (torch.bfloat16, BF16_ATOL, 0.0)]:
        for name, b, hq, hkv, d, bs, m, lens, layers in cases:
            n_blocks = b * m + 4
            shape = (n_blocks, hkv, bs, d)
            if layers:
                shape = (layers,) + shape
            q = rand((b, hq, d), dtype)
            kp = rand(shape, dtype)
            vp = rand(shape, dtype)
            table = torch.as_tensor(_scrambled_table(rng, b, m, n_blocks),
                                    device=dev)
            L = torch.tensor(lens, dtype=torch.int32, device=dev)
            layer = layers - 1 if layers else None
            got = DA.paged_decode_attention(q, kp, vp, table, L,
                                            layer=layer).float()
            kl, vl = (kp[layer], vp[layer]) if layers else (kp, vp)
            want = DA.paged_decode_attention_reference(
                q.float(), kl.float(), vl.float(), table, L)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            lim = float((atol + rtol * want.abs()).min())
            ok = bool(((got - want).abs()
                       <= atol + rtol * want.abs()).all())
            log(f"paged-kernel-vs-plain {name} {str(dtype)[6:]} B={b} "
                f"Hq={hq} Hkv={hkv} D={d} bs={bs} M={m} "
                f"chunks={DA.paged_split_chunks(m, bs)} lens={lens} "
                f"layer={layer}: max_abs_err={err:.3e} (atol {atol}, "
                f"rtol {rtol})")
            if not ok:
                raise AssertionError(
                    f"paged_decode_attention disagrees with its plain "
                    f"version: {name} {dtype} max_abs_err {err} > {lim}")
            if 0 in lens and got[lens.index(0)].abs().max() != 0:
                raise AssertionError(f"paged_decode_attention: a lane of "
                                     f"length 0 does not give zeros "
                                     f"({name})")
            worst[dtype] = max(worst[dtype], err)
    report["max_abs_err_f32"] = worst[torch.float32]
    report["max_abs_err_bf16"] = worst[torch.bfloat16]
    report["max_abs_err"] = max(worst.values())

    # two runs on the same inputs give the same bits (the partials merge
    # in chunk order): the chunk edges at bs 256, bf16
    lens, m = _paged_edges(DA, 256)
    b, n_blocks = len(lens), len(lens) * m + 1
    q = rand((b, 32, 128), torch.bfloat16)
    kp, vp = (rand((n_blocks, 32, 256, 128), torch.bfloat16)
              for _ in range(2))
    table = torch.as_tensor(_scrambled_table(rng, b, m, n_blocks),
                            device=dev)
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    first = DA.paged_decode_attention(q, kp, vp, table, L)
    again = DA.paged_decode_attention(q, kp, vp, table, L)
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError("two runs of paged_decode_attention differ")
    log("paged_decode_attention: two runs bit-identical (bf16, the chunk "
        "edges at bs 256)")
    del q, kp, vp

    # timing at the ring's 7b shape (bf16, 8 lanes, bs 256, 8 table
    # blocks per lane): the pool is stacked over 8 layers that the calls
    # rotate through, so consecutive calls' filled bytes exceed the
    # 50 MB L2 as the ring's 32 layers do.  Kernel #1 and SDPA read the
    # same rows gathered into a contiguous cache of their own.
    b, h, d, bs, m, layers = 8, 32, 128, 256, 8, 8
    dtype = torch.bfloat16
    n_blocks = b * m + 1
    lib = DA._library()
    qs = [rand((b, h, d), dtype) for _ in range(layers)]
    kp = rand((layers, n_blocks, h, bs, d), dtype)
    vp = rand((layers, n_blocks, h, bs, d), dtype)
    table = torch.as_tensor(_scrambled_table(rng, b, m, n_blocks),
                            device=dev)
    kc = [DA.gather_lane_view(kp[i], table) for i in range(layers)]
    vc = [DA.gather_lane_view(vp[i], table) for i in range(layers)]
    timings = []
    for fill in (128, 528, 2048):
        L = torch.full((b,), fill, dtype=torch.int32, device=dev)
        c = layers

        def kern(i):
            DA.paged_decode_attention(qs[i % c], kp, vp, table, L,
                                      layer=i % c)

        def plain(i):
            DA.paged_decode_attention_reference(qs[i % c], kp[i % c],
                                                vp[i % c], table, L)

        def contiguous(i):
            DA.decode_attention(qs[i % c], kc[i % c], vc[i % c], L)

        def sdpa(i):
            F.scaled_dot_product_attention(
                qs[i % c][:, :, None], kc[i % c][:, :, :fill],
                vc[i % c][:, :, :fill])

        # in turns, so drift shows as a gap between a repeat and its
        # first reading
        row = {"fill": fill}
        for key, fn, iters in (("plain_ms", plain, 16), ("ms", kern, 128),
                               ("kernel1_ms", contiguous, 128),
                               ("library_ms", sdpa, 128),
                               ("ms_again", kern, 128),
                               ("plain_ms_again", plain, 16)):
            row[key], row[key.replace("ms", "eager_ms", 1)] = \
                time_ms(fn, iters)
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            b, h, h, d, fill, dtype, table_entries=-(-fill // bs))
        row.update(_paged_sweep(
            lambda i, out, **kw: DA._paged_launch(
                lib, qs[i % c], kp[i % c], vp[i % c], table, L, out,
                d ** -0.5, torch.cuda.current_stream().cuda_stream, **kw),
            qs[0], DA.paged_decode_attention_reference(
                qs[0].float(), kp[0].float(), vp[0].float(), table, L)))
        log(f"timing 7b paged_decode_attention bf16 B={b} H={h} D={d} "
            f"bs={bs} M={m} fill={fill}: " + json.dumps(row))
        timings.append(row)
    report["timings"] = timings
    main = next(r for r in timings if r["fill"] == 528)
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "kernel1_ms"):
        report[key] = main[key]
    del qs, kp, vp, kc, vc
    torch.cuda.empty_cache()


def quant_attention_bound_ms(b, hq, hkv, d, fill, bs, dtype) -> tuple:
    """Least time for one int8-pool decode-attention call at a fill
    shared by the ``b`` lanes: the attended K and V rows — one byte an
    element in the full blocks, sizeof(T) in the write-frontier block
    the tail serves — the two f32 scales of each full block and kv
    head, the table entries the fill needs, lengths, q and the output,
    each moved once; against 4 * fill * D operations per (lane, query
    head) at the dtype's peak."""
    import torch

    e = torch.empty((), dtype=dtype).element_size()
    wb = max(fill - 1, 0) // bs
    full_rows, tail_rows = wb * bs, fill - wb * bs
    nbytes = (2 * b * hkv * d * (full_rows + e * tail_rows)
              + 2 * 4 * b * hkv * wb + 4 * b * (-(-fill // bs)) + 4 * b
              + e * 2 * b * hq * d)
    ops = 4 * b * hq * fill * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[str(dtype)] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _quant_pool(gen, n_blocks, hkv, bs, d, lanes, layers=0):
    """Random int8 codes, f32 scales and f32 staging tails (a lane row
    each plus the trash row), stacked over ``layers`` when given."""
    import torch

    lead = (layers,) if layers else ()
    dev = torch.device("cuda")

    def codes():
        return torch.randint(-127, 128, lead + (n_blocks, hkv, bs, d),
                             generator=gen, device=dev, dtype=torch.int8)

    def scales():
        # |code * scale| <= 1.5: the spread of K and V rows (phase 2b
        # draws them from a unit normal)
        return (torch.rand(lead + (n_blocks, hkv), generator=gen,
                           device=dev) * 0.008 + 0.004)

    def tails():
        return torch.randn(lead + (lanes + 1, hkv, bs, d), generator=gen,
                           device=dev)

    return codes(), codes(), scales(), scales(), tails(), tails()


def phase_quant_kernel_vs_plain(report: dict) -> None:
    """Phase 2d: the int8 pool's kernel against its plain version, then
    timings at the ring's 7b shape; see the module docstring."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from paddle_operator_tpu_torch.ops import decode_attention as DA

    nan_lanes_check("quant", report)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rng = np.random.default_rng(7)

    # (name, B, Hq, Hkv, D, bs, M, lengths, stacked layers or 0); the
    # lengths hold {0, 1, bs-1, bs, bs+1, full, a non-multiple}
    cases = []
    for hq, hkv, d in [(8, 8, 64), (8, 4, 128), (16, 4, 64), (8, 2, 128),
                       (16, 4, 128)]:
        for bs, m in ((16, 8), (256, 3)):
            lens = [0, 1, bs - 1, bs, bs + 1, m * bs, 2 * bs + 7]
            for layers in (0, 2):
                cases.append((f"bs{bs}-L{layers}", len(lens), hq, hkv, d,
                              bs, m, lens, layers))
    # the split's chunk and block edges (as phase 2b), R = 1, 2 and 4,
    # D 64 and 128, bs 16 and 256, unstacked and a stacked-layer index
    for bs in (16, 256):
        lens, m = _paged_edges(DA, bs)
        for hq, hkv in ((8, 8), (8, 4), (16, 4)):
            for d in (64, 128):
                cases.append((f"chunk-edges-R{hq // hkv}-bs{bs}", len(lens),
                              hq, hkv, d, bs, m, lens, 0))
        cases.append((f"chunk-edges-stacked-bs{bs}", len(lens), 8, 4, 128,
                      bs, m, lens, 2))
    cases += [
        ("ring-7b-b8", 8, 32, 32, 128, 256, 8,
         [0, 33, 101, 258, 301, 512, 601, 1001], 0),
        ("7b-fill2048", 8, 32, 32, 128, 256, 8, [2048] * 8, 0),
    ]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_rel = 0.0
    for dtype, atol, rtol in [(torch.float32, 1e-4, 1e-4),
                              (torch.bfloat16, BF16_ATOL, 0.0)]:
        for name, b, hq, hkv, d, bs, m, lens, layers in cases:
            n_blocks = b * m + 4
            kp, vp, ks, vs, kt, vt = _quant_pool(gen, n_blocks, hkv, bs, d,
                                                 b, layers)
            kt, vt = kt.to(dtype), vt.to(dtype)
            q = torch.randn((b, hq, d), generator=gen, device=dev).to(dtype)
            table = torch.as_tensor(_scrambled_table(rng, b, m, n_blocks),
                                    device=dev)
            L = torch.tensor(lens, dtype=torch.int32, device=dev)
            layer = layers - 1 if layers else None
            got = DA.paged_decode_attention(q, kp, vp, table, L, layer=layer,
                                            k_scale=ks, v_scale=vs,
                                            k_tail=kt, v_tail=vt).float()
            sel = ((lambda t: t[layer]) if layers else (lambda t: t))
            # f32 q; the tails in the kernel's dtype, so the plain view
            # rounds code x scale to it
            want = DA.paged_decode_attention_quant_reference(
                q.float(), sel(kp), sel(vp), table, L, sel(ks), sel(vs),
                sel(kt), sel(vt))
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = float((got - want).norm() / want.norm())
            ok = bool(((got - want).abs()
                       <= atol + rtol * want.abs()).all())
            if dtype == torch.bfloat16:
                ok = ok and rel <= QUANT_BF16_REL
                worst_rel = max(worst_rel, rel)
            log(f"quant-kernel-vs-plain {name} {str(dtype)[6:]} B={b} "
                f"Hq={hq} Hkv={hkv} D={d} bs={bs} M={m} "
                f"chunks={DA.paged_split_chunks(m, bs)} lens={lens} "
                f"layer={layer}: max_abs_err={err:.3e} (atol {atol}, "
                f"rtol {rtol}) rel={rel:.3e}"
                + (f" (limit {QUANT_BF16_REL})"
                   if dtype == torch.bfloat16 else ""))
            if not ok:
                raise AssertionError(
                    f"the int8 paged kernel disagrees with its plain "
                    f"version: {name} {dtype} max_abs_err {err}, "
                    f"rel {rel}")
            if 0 in lens and got[lens.index(0)].abs().max() != 0:
                raise AssertionError(f"the int8 paged kernel: a lane of "
                                     f"length 0 does not give zeros "
                                     f"({name})")
            worst[dtype] = max(worst[dtype], err)
    report["max_abs_err_f32"] = worst[torch.float32]
    report["max_abs_err_bf16"] = worst[torch.bfloat16]
    report["max_rel_err_bf16"] = worst_rel
    report["max_abs_err"] = max(worst.values())

    # two runs on the same inputs give the same bits: the chunk edges at
    # bs 256, bf16
    lens, m = _paged_edges(DA, 256)
    b, n_blocks = len(lens), len(lens) * m + 1
    kp, vp, ks, vs, kt, vt = _quant_pool(gen, n_blocks, 32, 256, 128, b)
    kw = dict(k_scale=ks, v_scale=vs, k_tail=kt.to(torch.bfloat16),
              v_tail=vt.to(torch.bfloat16))
    q = torch.randn((b, 32, 128), generator=gen,
                    device=dev).to(torch.bfloat16)
    table = torch.as_tensor(_scrambled_table(rng, b, m, n_blocks),
                            device=dev)
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    first = DA.paged_decode_attention(q, kp, vp, table, L, **kw)
    again = DA.paged_decode_attention(q, kp, vp, table, L, **kw)
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError("two runs of the int8 paged kernel differ")
    log("paged_decode_attention (int8 pool): two runs bit-identical (bf16, "
        "the chunk edges at bs 256)")
    del kp, vp, ks, vs, kt, vt, kw

    # timing at the ring's 7b shape (bf16, 8 lanes, bs 256, 8 table
    # blocks a lane), the pool stacked over 8 layers the calls rotate
    # through so the filled bytes exceed the 50 MB L2.  The bf16 paged
    # kernel reads the same logical rows from a bf16 pool (the int8
    # pool dequantized, the frontier block from the tail), kernel-free
    # SDPA from those rows laid out contiguously.
    b, h, d, bs, m, layers = 8, 32, 128, 256, 8, 8
    dtype = torch.bfloat16
    n_blocks = b * m + 1
    lib = DA._library()
    kp, vp, ks, vs, kt, vt = _quant_pool(gen, n_blocks, h, bs, d, b, layers)
    kt, vt = kt.to(dtype), vt.to(dtype)
    qs = [torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
          for _ in range(layers)]
    table = torch.as_tensor(_scrambled_table(rng, b, m, n_blocks),
                            device=dev)
    timings = []
    for fill in (128, 528, 2048):
        L = torch.full((b,), fill, dtype=torch.int32, device=dev)
        wb = torch.full((b,), (fill - 1) // bs, device=dev)
        kc = [DA.gather_lane_view_quant(kp[i], ks[i], kt[i], table, wb)
              for i in range(layers)]
        vc = [DA.gather_lane_view_quant(vp[i], vs[i], vt[i], table, wb)
              for i in range(layers)]
        # the same rows as a bf16 pool: lane b's frontier block written
        # into its table entry, every other block dequantized
        kb = torch.stack([(kp[i].float() * ks[i][..., None, None]).to(dtype)
                          for i in range(layers)])
        vb = torch.stack([(vp[i].float() * vs[i][..., None, None]).to(dtype)
                          for i in range(layers)])
        front = table[torch.arange(b, device=dev), wb].long()
        kb[:, front], vb[:, front] = kt[:, :b], vt[:, :b]
        c = layers

        def kern(i):
            DA.paged_decode_attention(qs[i % c], kp, vp, table, L,
                                      layer=i % c, k_scale=ks, v_scale=vs,
                                      k_tail=kt, v_tail=vt)

        def plain(i):
            DA.paged_decode_attention_quant_reference(
                qs[i % c], kp[i % c], vp[i % c], table, L, ks[i % c],
                vs[i % c], kt[i % c], vt[i % c])

        def paged_bf16(i):
            DA.paged_decode_attention(qs[i % c], kb, vb, table, L,
                                      layer=i % c)

        def sdpa(i):
            F.scaled_dot_product_attention(
                qs[i % c][:, :, None], kc[i % c][:, :, :fill],
                vc[i % c][:, :, :fill])

        # the kernel's output on these inputs equals the bf16 paged
        # kernel's on the dequantized rows rounded to bf16 (same values,
        # same order): this pins the rounding of code x scale to T
        same = DA.paged_decode_attention(qs[0], kp, vp, table, L, layer=0,
                                         k_scale=ks, v_scale=vs, k_tail=kt,
                                         v_tail=vt)
        ref = DA.paged_decode_attention(qs[0], kb, vb, table, L, layer=0)
        row = {"fill": fill,
               "vs_bf16_pool_max_abs_diff":
                   float((same.float() - ref.float()).abs().max())}
        if row["vs_bf16_pool_max_abs_diff"] != 0.0:
            raise AssertionError(
                f"the int8 paged kernel at fill {fill} differs from the "
                f"bf16 paged kernel on the same rows rounded to bf16 by "
                f"{row['vs_bf16_pool_max_abs_diff']}")
        for key, fn, iters in (("plain_ms", plain, 8), ("ms", kern, 128),
                               ("paged_bf16_ms", paged_bf16, 128),
                               ("library_ms", sdpa, 128),
                               ("ms_again", kern, 128),
                               ("plain_ms_again", plain, 8)):
            row[key], row[key.replace("ms", "eager_ms", 1)] = \
                time_ms(fn, iters)
        row["bound_ms"], row["bound_by"] = quant_attention_bound_ms(
            b, h, h, d, fill, bs, dtype)
        row.update(_paged_sweep(
            lambda i, out, **kw: DA._paged_quant_launch(
                lib, qs[i % c], kp[i % c], vp[i % c], ks[i % c], vs[i % c],
                kt[i % c], vt[i % c], table, L, out, d ** -0.5,
                torch.cuda.current_stream().cuda_stream, **kw),
            qs[0], DA.paged_decode_attention_quant_reference(
                qs[0].float(), kp[0], vp[0], table, L, ks[0], vs[0], kt[0],
                vt[0])))
        log(f"timing 7b paged_decode_attention_quant bf16 B={b} H={h} "
            f"D={d} bs={bs} M={m} fill={fill}: " + json.dumps(row))
        timings.append(row)
        del kc, vc, kb, vb
        torch.cuda.empty_cache()
    report["timings"] = timings
    main = next(r for r in timings if r["fill"] == 528)
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "paged_bf16_ms"):
        report[key] = main[key]
    del qs, kp, vp, ks, vs, kt, vt
    torch.cuda.empty_cache()


# phase 2e: the 7b projections (K x N) and the legacy lm_head, at the
# decode rows; tails off the kernel's tile (K not a multiple of 128 or of
# a split; N not a multiple of 128, or of 16: the bytewise fill)
QMM_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
# the 7b cfg.draft()'s projections, which phase 3l (c) runs at M = 8
# under SERVE_DRAFT_QUANT=int8 (3l checks its draft against these):
# wq, wk, wv, wo 2048 x 2048, w1 and w3 2048 x 5504, w2 5504 x 2048
QMM_DRAFT_SHAPES = ((2048, 2048), (2048, 5504), (5504, 2048))
QMM_TAILS = ((4100, 4112), (4100, 4104), (1000, 130), (77, 1001), (3, 5))
# kernel A's rows, held to the plain version and timed (the ring's 8
# lanes, a batch step, suffixes, the speculative verify's 8 x 5 = 40, a
# 64-row prefill slice)
QMM_ROWS = (1, 4, 8, 16, 24, 40, 64)
# kernel B's rows held to the plain version (a verify or a short prompt
# above kernel A's limit, prefills), and timed: from 16 to 64 beside
# kernel A (the route's limit), then the prefills
QMM_GEMM_ROWS = (17, 40, 64, 256, 512, 2048)
QMM_GEMM_TIMED = (16, 24, 40, 64, 256, 512, 1024, 1536, 2048)
# the JSON line's kernel B numbers: one 7b layer at a 512-token prompt
QMM_GEMM_LINE_ROWS = 512
# the kernels' timing variants (csrc/quant_matmul.cu's QMM_PROBE build,
# quant_matmul_set_probe's bits): the codes
# converted but no product, the partials written but no split finish,
# and the products' groups — kernel A at M = 8 with a wait after every
# 16-row step (the first design's), kernel B at M 512 and 2048 a stage at
# a time
QMM_PROBES = {"no_products": 1, "no_split_finish": 2, "wait_each_step": 4}
QMM_GEMM_PROBES = {"no_products": 1, "no_split_finish": 2,
                   "group_per_stage": 4}
QMM_GEMM_PROBE_ROWS = (512, 2048)
# a 7b layer's projections: wq, wk, wv, wo (4096 x 4096), w1 and w3
# (4096 x 11008), w2 (11008 x 4096)
QMM_LAYER = ((4096, 4096, 4), (4096, 11008, 2), (11008, 4096, 1))
# f32 kernel against its plain version: the same products summed in
# another order (K up to 11008 terms of |x w| ~ 0.004)
QMM_F32_ATOL = 1e-4
# the codes the timings cycle through, at least this many bytes a shape:
# a decode step streams each projection cold, so no call may find its
# codes in the 50 MB L2
QMM_STREAM_BYTES = 256 << 20


def qmm_bound_ms(m, k, n, dtype) -> tuple:
    """Least time for one int8-weight matmul: the codes (one byte a
    weight), x, the output and the f32 scales each moved once, against
    2 M K N operations at the activation dtype's peak."""
    import torch

    e = torch.empty((), dtype=dtype).element_size()
    nbytes = k * n + e * m * k + e * m * n + 4 * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * k * n / PEAK_OPS[str(dtype)] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def quant_build_report(report: dict, report_b: dict) -> None:
    """Per instantiation of the int8-weight kernels: registers, spills,
    stack and static shared memory from ``nvcc -Xptxas -v`` — the wgmma
    body by rows BM, product group G and warpgroups (one: kernel A, two:
    kernel B), kernel A's f32 body by rows and kernel B's — into
    ``report["ptxas"]`` (kernel A) and ``report_b["ptxas"]``."""
    import re

    report["ptxas"], report_b["ptxas"] = [], []
    for symbol, nums in ptxas_entries("quant_matmul") or ():
        wg = re.search(r"quant_matmul_wgmma_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                       symbol)
        fma = re.search(r"quant_matmul_fma_kernelILi(\d+)E", symbol)
        if wg:
            row = {"symbol": symbol, "body": "wgmma bf16",
                   "rows": int(wg.group(1)), "group": int(wg.group(2)),
                   "warpgroups": int(wg.group(3)), **nums}
            into = report if row["warpgroups"] == 1 else report_b
        elif fma:
            row = {"symbol": symbol, "body": "fma f32",
                   "rows": int(fma.group(1)), **nums}
            into = report
        elif "quant_gemm_f32_kernel" in symbol:
            row = {"symbol": symbol, "body": "tiled f32", **nums}
            into = report_b
        else:
            continue
        into["ptxas"].append(row)
        log("quant_matmul ptxas: " + json.dumps(row))


def adam8_build_report(report: dict) -> None:
    """The 8-bit AdamW kernel's two instantiations (16-byte loads, value
    by value): registers, spills, stack and static shared memory."""
    report["ptxas"] = []
    for symbol, nums in ptxas_entries("adam8bit") or ():
        row = {"symbol": symbol, "vector": "ILb1E" in symbol, **nums}
        report["ptxas"].append(row)
        log("adam8bit ptxas: " + json.dumps(row))


def _qmm_layer(rows: list, m: int, key: str) -> float:
    """One 7b layer's seven projections at ``m`` rows from timing rows."""
    at = {(r["k"], r["n"]): r for r in rows if r["m"] == m}
    return sum(at[k, n][key] * c for k, n, c in QMM_LAYER)


def phase_quant_matmul_vs_plain(report: dict, report_b: dict) -> None:
    """Phase 2e: the int8-weight kernels A (``report``) and B
    (``report_b``) against their plain version, bit-identical reruns and
    graph replays, then timings at the 7b shapes; see the module
    docstring."""
    import ctypes

    import torch

    from paddle_operator_tpu_torch.infer import quant as Q
    from paddle_operator_tpu_torch.ops import _build
    from paddle_operator_tpu_torch.ops import quant_matmul as QM

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    worst = {(f, d): 0.0 for f in ("quant_matmul", "quant_gemm")
             for d in ("float32", "bfloat16")}
    cases = 0
    for k, n in QMM_SHAPES + QMM_DRAFT_SHAPES + QMM_TAILS:
        # |out| about 0.25, so bf16's rounding of the output is well
        # inside BF16_ATOL; column n // 2 all zero (scale 1.0)
        w = torch.randn(k, n, generator=g, device="cuda") * (0.25 / k ** 0.5)
        w[:, n // 2] = 0.0
        for mode in ("int8", "int4"):
            leaf = Q.quantize_leaf(w, mode)
            for fn, rows in ((QM.quant_matmul, QMM_ROWS),
                             (QM.quant_gemm, QMM_GEMM_ROWS)):
                for m in rows:
                    x32 = torch.randn(m, k, generator=g, device="cuda")
                    for dtype, atol in ((torch.float32, QMM_F32_ATOL),
                                        (torch.bfloat16, BF16_ATOL)):
                        x = x32.to(dtype)
                        got = fn(x, leaf["q"], leaf["s"])
                        want = QM.quant_matmul_reference(
                            x.float(), leaf["q"], leaf["s"])
                        err = float((got.float() - want).abs().max())
                        name = str(dtype).split(".")[1]
                        worst[fn.__name__, name] = max(
                            worst[fn.__name__, name], err)
                        cases += 1
                        if err > atol or got.dtype != dtype \
                                or bool(got[:, n // 2].any()):
                            raise AssertionError(
                                f"{fn.__name__} {mode} {name} M={m} K={k} "
                                f"N={n}: max |err| {err} (limit {atol}), "
                                f"dtype {got.dtype}, zero column "
                                f"{not bool(got[:, n // 2].any())}")
                        if (k, n) == (11008, 4096) and m in (
                                8, 40, QM.KERNEL_MAX_ROWS + 1, 512):
                            again = fn(x, leaf["q"], leaf["s"])
                            if not torch.equal(got, again):
                                raise AssertionError(f"{fn.__name__}: two "
                                                     f"runs differ at M={m}")
        del w
    torch.cuda.synchronize()
    # a graph replay equals the eager call: the kernel the route gives
    # the verify's 40 rows, and kernel B at its smallest routed rows
    w = torch.randn(4096, 11008, generator=g, device="cuda") * (0.25 / 64)
    leaf = Q.quantize_leaf(w, "int8")
    replays = {}
    for m in (40, QM.KERNEL_MAX_ROWS + 1):
        x = torch.randn(m, 4096, generator=g, device="cuda").bfloat16()
        eager = QM.quant_mm(x, leaf["q"], leaf["s"])
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = QM.quant_mm(x, leaf["q"], leaf["s"])
        graph.replay()
        torch.cuda.synchronize()
        replays[m] = ("quant_matmul" if m <= QM.KERNEL_MAX_ROWS
                      else "quant_gemm")
        if not torch.equal(eager, out):
            raise AssertionError(f"{replays[m]}: a graph replay at M={m} "
                                 "differs from the eager call")
        del graph
    del w, leaf
    log(f"int8-weight kernels vs plain: {cases} cases (7b and 7b draft "
        f"shapes and tails, int8 and int4 codes; kernel A M {QMM_ROWS}, "
        f"kernel B M {QMM_GEMM_ROWS}), max |err| f32 A "
        f"{worst['quant_matmul', 'float32']:.3e} B "
        f"{worst['quant_gemm', 'float32']:.3e} (limit {QMM_F32_ATOL}), bf16 "
        f"A {worst['quant_matmul', 'bfloat16']:.3e} B "
        f"{worst['quant_gemm', 'bfloat16']:.3e} (limit {BF16_ATOL}); reruns "
        f"bit-identical; graph replays == eager ({replays})")
    for rep, fn in ((report, "quant_matmul"), (report_b, "quant_gemm")):
        rep["max_abs_err_f32"] = worst[fn, "float32"]
        rep["max_abs_err_bf16"] = worst[fn, "bfloat16"]
        rep["max_abs_err"] = max(rep["max_abs_err_f32"],
                                 rep["max_abs_err_bf16"])

    # timings: int8 codes, bf16 activations, each call on codes the L2
    # has not seen (a rotation of copies); in turns kernel, plain, bf16
    # torch.matmul (the bf16 replica's call: not the same function),
    # kernel; then the kernels' variants (QMM_PROBES, QMM_GEMM_PROBES)
    timings, timings_b = [], []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    probe_lib = QM.declare(_build.load(QMM_PROBE_BUILD))
    probe_lib.quant_matmul_set_probe.argtypes = [ctypes.c_int]

    def set_probe(bits):
        torch.cuda.synchronize()
        rc = probe_lib.quant_matmul_set_probe(bits)
        if rc != 0:
            raise RuntimeError(f"quant_matmul_set_probe: CUDA error {rc}")
    for k, n in QMM_SHAPES:
        copies = max(2, -(-QMM_STREAM_BYTES // (k * n)))
        w = torch.randn(k, n, generator=g, device="cuda") * (0.25 / k ** 0.5)
        leaf = Q.quantize_leaf(w, "int8")
        qs = [leaf["q"].clone() for _ in range(copies)]
        ws = [w.to(torch.bfloat16) for _ in range(copies)]
        s = leaf["s"]
        del w, leaf
        for fn, plan_of, rows, into in (
                (QM.quant_matmul, QM.matmul_plan, QMM_ROWS, timings),
                (QM.quant_gemm, QM.gemm_plan, QMM_GEMM_TIMED, timings_b)):
            for m in rows:
                x = torch.randn(m, k, generator=g, device="cuda").bfloat16()

                def kern(i):
                    fn(x, qs[i % copies], s)

                def plain(i):
                    QM.quant_matmul_reference(x, qs[i % copies], s)

                def library(i):
                    torch.matmul(x, ws[i % copies])

                plan = plan_of(m, k, n, torch.bfloat16, sms)
                row = {"m": m, "k": k, "n": n, "blocks": plan[0],
                       "splits": plan[2]}
                for key, f in (("ms", kern), ("plain_ms", plain),
                               ("library_ms", library), ("ms_again", kern)):
                    row[key], row[key.replace("ms", "eager_ms", 1)] = \
                        time_ms(f, 2 * copies)
                probes = (QMM_PROBES if fn is QM.quant_matmul and m == 8
                          else QMM_GEMM_PROBES if fn is QM.quant_gemm
                          and m in QMM_GEMM_PROBE_ROWS else {})
                x2, out, vec, xvec = QM._operands(x, qs[0])
                for name, bits in probes.items():
                    set_probe(bits)
                    row[name + "_ms"] = time_ms(
                        lambda i: QM._launch(
                            fn.__name__, x2, qs[i % copies], s, out, vec,
                            xvec, plan, probe_lib), 2 * copies)[0]
                    set_probe(0)
                row["bound_ms"], row["bound_by"] = qmm_bound_ms(
                    m, k, n, torch.bfloat16)
                row["share_of_bound"] = row["bound_ms"] / min(
                    row["ms"], row["ms_again"])
                log(f"timing {fn.__name__} int8 bf16 M={m} K={k} N={n}: "
                    + json.dumps(row))
                into.append(row)
        del qs, ws
        torch.cuda.empty_cache()
    report["timings"], report_b["timings"] = timings, timings_b
    # the JSON line's numbers: one 7b layer's seven projections, kernel A
    # at the ring's 8 lanes, kernel B at a 512-token prompt
    for rep, rows, m in ((report, timings, 8),
                         (report_b, timings_b, QMM_GEMM_LINE_ROWS)):
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            rep[key] = _qmm_layer(rows, m, key)
    report["bound_by"] = "bytes"
    at = {(r["k"], r["n"]): r for r in timings_b
          if r["m"] == QMM_GEMM_LINE_ROWS}
    report_b["bound_by"] = ("bytes" if all(
        at[k, n]["bound_by"] == "bytes" for k, n, _ in QMM_LAYER)
        else "operations")
    report["probes_ms"] = {name: _qmm_layer(timings, 8, name + "_ms")
                           for name in QMM_PROBES}
    report_b["probes_ms"] = {
        m: {name: _qmm_layer(timings_b, m, name + "_ms")
            for name in QMM_GEMM_PROBES} for m in QMM_GEMM_PROBE_ROWS}
    # the route's limit: kernel A against kernel B on a 7b layer
    limit = {m: {"A": _qmm_layer(timings, m, "ms"),
                 "B": _qmm_layer(timings_b, m, "ms")}
             for m in QMM_GEMM_TIMED if m in QMM_ROWS}
    report["limit_check"] = limit
    for rep, name, m in ((report, "kernel A", 8),
                         (report_b, "kernel B", QMM_GEMM_LINE_ROWS)):
        log(f"int8-weight {name}, one 7b layer (7 projections) at M={m}: "
            f"device {rep['ms']:.5f} ms, plain {rep['plain_ms']:.5f}, bf16 "
            f"torch.matmul {rep['library_ms']:.5f}, bound "
            f"{rep['bound_ms']:.5f} ({rep['bound_ms'] / rep['ms']:.2f} of "
            f"it) on {card_line()}")
    log(f"kernel A's variants, one 7b layer at M=8 (ms): "
        f"{json.dumps(report['probes_ms'])}; kernel B's at M "
        f"{QMM_GEMM_PROBE_ROWS}: {json.dumps(report_b['probes_ms'])}; A "
        f"against B by rows (ms a "
        f"layer; route limit {QM.KERNEL_MAX_ROWS}): {json.dumps(limit)}")


# phase 2f: the 8-bit AdamW update at the 7b tensors' shapes (the
# embedding, wq/wk/wv/wo, w1/w3, w2, lm_head, a norm scale) and at
# last axes off 256 (16-byte loads; value-by-value)
ADAM8_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (32000, 4096),
                (4096, 32000), (4096,), (3, 1000), (5, 77))
# the 7b model's tensors by shape: 32 layers x (4 attention projections,
# w1 and w3, w2, 2 norm scales), the embedding, lm_head, the final norm
ADAM8_MODEL = {(4096, 4096): 4 * 32, (4096, 11008): 2 * 32,
               (11008, 4096): 32, (32000, 4096): 1, (4096, 32000): 1,
               (4096,): 2 * 32 + 1}
# f32 operations an element the update needs: clip 2, mu 4, sqrt(nu)
# and nu 7, the update 5, decay and step 4, two requantizations 5
ADAM8_OPS = 27


def adam8_bound_ms(shape) -> tuple:
    from paddle_operator_tpu_torch.ops.adam8bit import bytes_moved

    n = 1
    for d in shape:
        n *= d
    by_bytes = bytes_moved(shape) / HBM_BYTES_PER_S * 1e3
    by_ops = ADAM8_OPS * n / PEAK_OPS["torch.float32"] * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def phase_adam8bit_vs_plain(report: dict) -> None:
    """Phase 2f: the 8-bit AdamW kernel against its plain version, bit
    for bit over three updates, then timings; see the module
    docstring."""
    import torch

    from paddle_operator_tpu_torch.ops import adam8bit as A8
    from paddle_operator_tpu_torch.train import opt8bit as Q8

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def consts(count):
        return A8.Adam8bitConsts.make(b1=0.9, b2=0.95, eps=1e-8,
                                      weight_decay=0.1, lr=1e-3, clip=1.0,
                                      count=count)

    for shape in ADAM8_SHAPES:
        p = torch.randn(shape, generator=gen, device="cuda") * 0.02
        mu = Q8.quantize_q8(torch.zeros(shape, device="cuda"))
        nu = Q8.quantize_q8u(torch.zeros(shape, device="cuda"))
        ref = [t.clone() for t in (p, *mu, *nu)]
        # the clip bites at the second update only
        for count, norm in ((1, 0.5), (2, 3.0), (3, 0.5)):
            g = torch.randn(shape, generator=gen, device="cuda") * 0.1
            nrm = torch.tensor(norm, device="cuda")
            A8.adam8bit_update(p, g, mu, nu, nrm, consts(count))
            A8.adam8bit_update_reference(ref[0], g, Q8.Q8(*ref[1:3]),
                                         Q8.Q8(*ref[3:5]), nrm,
                                         consts(count))
            torch.cuda.synchronize()
            for name, a, b in zip(("p", "mu codes", "mu scales",
                                   "nu codes", "nu scales"),
                                  (p, *mu, *nu), ref):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"adam8bit_update {shape} update {count}: {name} "
                        f"differs from the plain version in "
                        f"{int((a != b).sum())} of {a.numel()} values")
        del p, mu, nu, ref, g
    torch.cuda.empty_cache()
    log(f"adam8bit vs plain: {len(ADAM8_SHAPES)} shapes x 3 updates, p, "
        "codes and scales bit-identical")
    report["max_abs_err"] = 0.0

    timings = []
    for shape in ADAM8_SHAPES[:6]:
        p = torch.randn(shape, generator=gen, device="cuda") * 0.02
        g = torch.randn(shape, generator=gen, device="cuda") * 1e-3
        mu = Q8.quantize_q8(torch.zeros(shape, device="cuda"))
        nu = Q8.quantize_q8u(torch.zeros(shape, device="cuda"))
        nrm = torch.tensor(0.5, device="cuda")
        k = consts(2)
        # the library yardstick: torch's fused AdamW on f32 moments of
        # the same tensor (not the same function: no clip, no int8
        # moments; never used by the port)
        lp, lg = [p.clone()], [g.clone()]
        lm, lv = [torch.zeros_like(p)], [torch.zeros_like(p)]
        steps = [torch.ones((), device="cuda")]
        n = p.numel()
        iters = max(4, min(50, (1 << 31) // (16 * n)))

        def kern(i):
            A8.adam8bit_update(p, g, mu, nu, nrm, k)

        def plain(i):
            A8.adam8bit_update_reference(p, g, mu, nu, nrm, k)

        def library(i):
            torch._fused_adamw_(lp, lg, lm, lv, [], steps, lr=1e-3,
                                beta1=0.9, beta2=0.95, weight_decay=0.1,
                                eps=1e-8, amsgrad=False, maximize=False)

        row = {"shape": list(shape)}
        for key, fn, graph in (("ms", kern, True), ("plain_ms", plain, False),
                               ("library_ms", library, True),
                               ("ms_again", kern, True)):
            dev, eager = time_ms(fn, iters, graph=graph)
            row[key] = dev if graph else eager
            row[key.replace("ms", "eager_ms", 1)] = eager
        row["bound_ms"], row["bound_by"] = adam8_bound_ms(shape)
        row["share_of_bound"] = row["bound_ms"] / min(row["ms"],
                                                      row["ms_again"])
        row["gb_per_s"] = (A8.bytes_moved(shape) / 1e9
                           / (min(row["ms"], row["ms_again"]) / 1e3))
        log("timing adam8bit_update: " + json.dumps(row))
        timings.append(row)
        del p, g, mu, nu, lp, lg, lm, lv
        torch.cuda.empty_cache()
    report["timings"] = timings
    # the JSON line's numbers: one update of the whole 7b model (291
    # tensors), from the per-shape timings
    by_shape = {tuple(r["shape"]): r for r in timings}
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        report[key] = sum(by_shape[s][key] * c for s, c in ADAM8_MODEL.items())
    report["bound_by"] = "bytes"
    log(f"adam8bit_update, the whole 7b model ({sum(ADAM8_MODEL.values())} "
        f"tensors, 6.738B values): device {report['ms']:.3f} ms, plain "
        f"(eager) {report['plain_ms']:.3f}, torch._fused_adamw_ on f32 "
        f"moments {report['library_ms']:.3f}, bound {report['bound_ms']:.3f}"
        f" ({report['bound_ms'] / report['ms']:.2f} of it) on "
        f"{card_line()}")


FLASH_KERNELS = ("flash_forward", "flash_backward_dkv", "flash_backward_dq")


def flash_bound_ms(b, hq, hkv, s, d, dtype, kind: str) -> tuple:
    """Least time for one causal flash call at [B, S, H, D]: each input
    read once and each output written once, against the products the
    function needs at the dtype's peak — each an S x S x D product per
    (batch, query head), half of it under the causal mask: 2 for the
    forward (QK^T, PV), 4 for dK/dV (QK^T, dO V^T, P^T dO, dS^T Q), 3
    for dQ (QK^T, dO V^T, dS K) and 7 for the forward and backward as
    one function (whose backward computes QK^T and dO V^T once)."""
    import torch

    e = torch.empty((), dtype=dtype).element_size()
    # (q-like tensors, kv-like tensors, f32 rows per query row, products)
    moved = {"fwd": (2, 2, 1, 2), "dkv": (2, 4, 2, 4), "dq": (3, 2, 2, 3),
             "fwd_bwd": (4, 4, 0, 7)}[kind]
    nq, nkv, rows, products = moved
    nbytes = e * b * s * d * (nq * hq + nkv * hkv) + 4 * rows * b * hq * s
    ops = products * 2 * b * hq * s * s * d / 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[str(dtype)] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# per wrapper, the body each group of its instantiations in
# flash_attention.cu runs: (dtype and head dims, design)
FLASH_DESIGNS = {
    "flash_forward": [
        ("bf16 D64, D128", "wgmma: S, P and the O accumulator in "
         "registers; TMA loads into a 2-stage ring"),
        ("bf16 D256", "WMMA 16x16x16 through shared memory"),
        ("f32", "FMA through shared memory")],
    "flash_backward_dkv": [
        ("bf16 D64, D128", "wgmma: S^T, dP^T, P^T, dS^T and the dK, dV "
         "accumulators in registers; TMA loads into a 2-stage ring"),
        ("bf16 D256", "WMMA 16x16x16 through shared memory"),
        ("f32", "FMA through shared memory")],
    "flash_backward_dq": [
        ("bf16 D64, D128", "wgmma: S, dP, dS and the dQ accumulator in "
         "registers; TMA K/V loads into a 2-stage ring"),
        ("bf16 D256", "WMMA 16x16x16 through shared memory"),
        ("f32", "FMA through shared memory")],
}
_FLASH_SYMBOLS = {"flash_fwd": "flash_forward",
                  "flash_bwd_dkv": "flash_backward_dkv",
                  "flash_bwd_dq": "flash_backward_dq"}


def ptxas_entries(name: str):
    """(mangled symbol, counts) per kernel entry that ``nvcc -Xptxas -v``
    reported while building kernel source ``name`` in this process:
    registers, spill store and load bytes, stack and static shared
    memory bytes.  None when the library was built before this process
    (no output to report)."""
    import re

    from paddle_operator_tpu_torch.ops import _build

    log_text = _build.LOGS.get(name)
    if log_text is None:
        log(f"{name} ptxas: the library was built before this process; "
            "no -Xptxas -v output to report")
        return None
    out = []
    for block in log_text.split("ptxas info    : Compiling entry "
                                "function")[1:]:
        m = re.match(r" '(\S+)'", block)
        if m is None:
            continue
        nums = {key: int(v) for v, key in re.findall(
            r"(\d+) (bytes stack frame|bytes spill stores|bytes spill "
            r"loads|registers|bytes smem)", block)}
        out.append((m.group(1), {
            "registers": nums.get("registers"),
            "spill_store_bytes": nums.get("bytes spill stores"),
            "spill_load_bytes": nums.get("bytes spill loads"),
            "stack_bytes": nums.get("bytes stack frame"),
            "static_smem_bytes": nums.get("bytes smem", 0)}))
    return out


def flash_build_report(flash: dict) -> None:
    """Per instantiation of the flash kernels: its registers, spill
    bytes and static shared memory from ``nvcc -Xptxas -v`` and the
    dynamic shared memory its launch asks for; with each wrapper's
    designs, into ``flash[kernel]``."""
    import ctypes
    import re

    from paddle_operator_tpu_torch.ops import _build

    lib = _build.load("flash_attention")
    lib.flash_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.flash_smem_bytes.restype = ctypes.c_int
    for kern in FLASH_KERNELS:
        flash[kern]["designs"] = [{"instantiations": what, "body": body}
                                  for what, body in FLASH_DESIGNS[kern]]
        flash[kern]["ptxas"] = []
    entry = re.compile(r"(flash_(fwd|bwd_dkv|bwd_dq)_(hopper|kernel))I(.*?)"
                       r"Li(\d+)E")
    for symbol, nums in ptxas_entries("flash_attention") or ():
        m = entry.search(symbol)
        if m is None:
            continue
        kern = _FLASH_SYMBOLS[f"flash_{m.group(2)}"]
        d = int(m.group(5))
        dtype = 0 if m.group(4) == "f" else 1
        row = {"symbol": m.group(1), "dtype": ["f32", "bf16"][dtype],
               "d": d, **nums, "dynamic_smem_bytes": lib.flash_smem_bytes(
                   FLASH_KERNELS.index(kern), dtype, d)}
        flash[kern]["ptxas"].append(row)
        log(f"flash ptxas {kern}: " + json.dumps(row))


def decode_build_report(*reports: dict) -> None:
    """Per instantiation of the decode kernels (the contiguous split
    kernel, the paged kernel and the int8 pool's): registers, spill
    bytes, stack and static shared memory from ``nvcc -Xptxas -v``, and
    for the paged kernels (instantiated at head_dim 64, 128 and any
    other, ``d`` 0) the dynamic shared memory a launch asks for (at D 128
    for the generic one), into each report's ``ptxas``."""
    import ctypes
    import re

    from paddle_operator_tpu_torch.ops import _build

    lib = _build.load("decode_attention")
    lib.paged_decode_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.paged_decode_smem_bytes.restype = ctypes.c_int
    kernels = {r["name"]: r["name"] + "_kernel" for r in reports}
    for r in reports:
        r["ptxas"] = []
    for symbol, nums in ptxas_entries("decode_attention") or ():
        for r in reports:
            kern = kernels[r["name"]]
            # mangled: the name's length, the name, then its template
            # arguments (T, R and, for the paged kernels, D)
            m = re.search(rf"{len(kern)}{kern}I(f|13__nv_bfloat16)Li(\d)E"
                          r"(?:Li(\d+)E)?", symbol)
            if m is None:
                continue
            row = {"symbol": symbol, "dtype": "f32" if m.group(1) == "f"
                   else "bf16", "r": int(m.group(2)), **nums}
            if m.group(3) is not None:
                row["d"] = int(m.group(3))
                row["dynamic_smem_bytes"] = lib.paged_decode_smem_bytes(
                    int(row["dtype"] == "bf16"), row["r"], row["d"] or 128)
            r["ptxas"].append(row)
            log(f"decode ptxas {kern}: " + json.dumps(row))


def phase_flash_vs_plain(reports: dict) -> None:
    """Phase 2c: the three flash kernels against their plain versions,
    bit-identical reruns, then timings at the 7b training shape."""
    import torch
    import torch.nn.functional as F

    from paddle_operator_tpu_torch.ops import flash_attention as FA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def documents(b, s):
        """[b, s] int32 ids of three packed documents (ragged cuts)."""
        cuts = torch.tensor([0, s // 3, (2 * s) // 3 + 1], device=dev)
        ids = (torch.arange(s, device=dev)[None, :] >= cuts[:, None]).sum(0)
        return ids.to(torch.int32)[None].repeat(b, 1).contiguous()

    # (name, B, Hq, D, n_rep, Sq, Sk, causal, ids: none / docs / orphan
    # q rows); S holds the edges of the bf16 bodies' 64- and 128-row
    # tiles; the last case is the training main path's shape
    cases = [(f"D{d}-rep{n_rep}-S{s}", 2, 8, d, n_rep, s, s, causal, ids)
             for d in (64, 128) for n_rep in (1, 2, 4)
             for s in (1, 63, 64, 65, 127, 128, 129, 300, 2048)
             for causal in (True, False) for ids in ("none", "docs")]
    cases += [(f"Sq{sq}-Sk{sk}", 2, 8, 128, 2, sq, sk, causal, ids)
              for sq, sk in ((300, 700), (700, 300))
              for causal in (True, False) for ids in ("none", "docs")]
    cases += [("orphan-rows", 2, 8, 128, 2, 300, 300, causal, "orphan")
              for causal in (True, False)]
    cases.append(("main-path-7b", 4, 32, 128, 1, 2048, 2048, True, "none"))
    worst = {(k, dt): 0.0 for k in FLASH_KERNELS
             for dt in (torch.float32, torch.bfloat16)}
    excess = {k: 0.0 for k in FLASH_KERNELS}   # bf16 |err| - rtol |want|
    worst_rel = {k: 0.0 for k in FLASH_KERNELS}  # bf16 relative Frobenius
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, hq, d, n_rep, s, sk, causal, ids in cases:
            hkv = hq // n_rep
            q, do = rand((b, s, hq, d), dtype), rand((b, s, hq, d), dtype)
            k, v = rand((b, sk, hkv, d), dtype), rand((b, sk, hkv, d), dtype)
            seg_q = seg_k = None
            if ids != "none":
                seg_q, seg_k = documents(b, s), documents(b, sk)
            if ids == "orphan":
                # the last third of the query rows carry an id no key
                # has: fully masked rows, reachable only through the
                # internal entry points
                seg_q = seg_k.clone()
                seg_q[:, 2 * s // 3:] = 99
            o, lse = FA.flash_forward(q, k, v, seg_q, seg_k, causal=causal)
            qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
            po, plse = FA.flash_forward_reference(qf, kf, vf, seg_q,
                                                  causal=causal, seg_k=seg_k)
            delta = FA.attention_delta(po, dof)
            dk, dv = FA.flash_backward_dkv(q, k, v, do, plse, delta, seg_q,
                                           seg_k, causal=causal)
            dq = FA.flash_backward_dq(q, k, v, do, plse, delta, seg_q, seg_k,
                                      causal=causal)
            pdk, pdv = FA.flash_backward_dkv_reference(
                qf, kf, vf, dof, plse, delta, seg_q, seg_k, causal=causal)
            pdq = FA.flash_backward_dq_reference(qf, kf, vf, dof, plse, delta,
                                                 seg_q, seg_k, causal=causal)
            torch.cuda.synchronize()
            if ids == "orphan" and (o[:, 2 * s // 3:].abs().max() != 0
                                    or lse[:, :, 2 * s // 3:].abs().max()
                                    != 0):
                raise AssertionError("flash_forward: rows with no key do "
                                     "not give o = 0 and lse = 0")
            errs, rels = {}, {}
            what = f"{name} causal={causal} ids={ids} {dtype}"
            pairs = {"flash_forward": [("o", o, po), ("lse", lse, plse)],
                     "flash_backward_dkv": [("dk", dk, pdk), ("dv", dv, pdv)],
                     "flash_backward_dq": [("dq", dq, pdq)]}
            if name == "main-path-7b":
                # the long causal rows, where a typical |O| is ~0.04
                pairs["flash_forward"].append(
                    ("o[S/2:]", o[:, s // 2:], po[:, s // 2:]))
            for kern, outs in pairs.items():
                atol, rtol = ((1e-4, 1e-4) if dtype == torch.float32
                              else (FLASH_BF16_ATOL[kern], FLASH_BF16_RTOL))
                for out, got, want in outs:
                    diff = (got.float() - want).abs()
                    err = float(diff.max())
                    errs[kern] = max(errs.get(kern, 0.0), err)
                    if not bool((diff <= atol + rtol * want.abs()).all()):
                        failures.append(
                            f"{kern} {out} disagrees with its plain version "
                            f"element by element: {what} max_abs_err {err} "
                            f"(atol {atol}, rtol {rtol})")
                    if dtype != torch.bfloat16:
                        continue
                    excess[kern] = max(excess[kern], float(
                        (diff - rtol * want.abs()).max()))
                    if min(s, sk) == 1 and out in ("dk", "dq"):
                        # one key a row: the softmax gradient is 0, and
                        # both sides hold only rounding residue
                        continue
                    rel = float(diff.norm()) / float(want.norm())
                    rels[out] = rel
                    worst_rel[kern] = max(worst_rel[kern], rel)
                    if rel > FLASH_BF16_REL:
                        failures.append(
                            f"{kern} {out} disagrees with its plain version "
                            f"as a whole: {what} relative error {rel:.3e} "
                            f"(limit {FLASH_BF16_REL})")
                worst[kern, dtype] = max(worst[kern, dtype], errs[kern])
            log(f"flash-vs-plain {name} B={b} Hq={hq} {str(dtype)[6:]} "
                f"causal={causal} ids={ids}: " + " ".join(
                    f"{k[6:]}={e:.2e}" for k, e in errs.items())
                + ("; relative " + " ".join(f"{k}={e:.2e}"
                                           for k, e in rels.items())
                   if rels else ""))
    log(f"flash bf16 worst |err| - rtol |want| (rtol {FLASH_BF16_RTOL}): "
        + json.dumps(excess))
    log("flash bf16 worst relative Frobenius error: " + json.dumps(worst_rel))
    if failures:
        raise AssertionError(f"{len(failures)} flash checks failed:\n"
                             + "\n".join(failures[:20]))

    # two runs of each kernel on the same inputs give the same bits
    b, hq, d, s, hkv = 2, 8, 128, 2048, 4
    q, do = rand((b, s, hq, d), torch.bfloat16), rand((b, s, hq, d),
                                                      torch.bfloat16)
    k, v = rand((b, s, hkv, d), torch.bfloat16), rand((b, s, hkv, d),
                                                      torch.bfloat16)
    seg = documents(b, s)
    runs = []
    for _ in range(2):
        o, lse = FA.flash_forward(q, k, v, seg, seg)
        delta = FA.attention_delta(o, do)
        runs.append((o, lse) + FA.flash_backward_dkv(q, k, v, do, lse, delta,
                                                     seg, seg)
                    + (FA.flash_backward_dq(q, k, v, do, lse, delta, seg,
                                            seg),))
    if not all(torch.equal(x, y) for x, y in zip(*runs)):
        raise AssertionError("two runs of the flash kernels differ")
    log("flash kernels: two runs bit-identical (bf16, B=2 S=2048 H=8 "
        "Hkv=4 D=128, causal, 3 documents)")

    # timing at the 7b training shape, in turns: plain, kernel, kernel,
    # plain for each kernel; the library and the port's forward+backward
    b, h, d = 4, 32, 128
    dtype = torch.bfloat16
    for s in (512, 2048):
        q, k, v, do = (rand((b, s, h, d), dtype) for _ in range(4))
        o, lse = FA.flash_forward(q, k, v)
        delta = FA.attention_delta(o, do)
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, do))
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        tleaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
        plain_iters = 2 if s == 2048 else 4
        fns = {
            "flash_forward": (lambda i: FA.flash_forward(q, k, v),
                              lambda i: FA.flash_forward_reference(q, k, v),
                              "fwd"),
            "flash_backward_dkv": (
                lambda i: FA.flash_backward_dkv(q, k, v, do, lse, delta),
                lambda i: FA.flash_backward_dkv_reference(q, k, v, do, lse,
                                                          delta), "dkv"),
            "flash_backward_dq": (
                lambda i: FA.flash_backward_dq(q, k, v, do, lse, delta),
                lambda i: FA.flash_backward_dq_reference(q, k, v, do, lse,
                                                         delta), "dq"),
        }
        for kern, (kfn, pfn, kind) in fns.items():
            row = {"seq": s}
            for key, fn, iters in (("plain_ms", pfn, plain_iters),
                                   ("ms", kfn, 10), ("ms_again", kfn, 10),
                                   ("plain_ms_again", pfn, plain_iters)):
                row[key], row[key.replace("ms", "eager_ms", 1)] = \
                    time_ms(fn, iters)
            row["bound_ms"], row["bound_by"] = flash_bound_ms(
                b, h, h, s, d, dtype, kind)
            if kern == "flash_forward":
                row["library_ms"], row["library_eager_ms"] = time_ms(
                    lambda i: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True), 10)
            else:
                row["library_ms"] = None
            log(f"timing 7b {kern} bf16 B={b} H={h} D={d} S={s} causal: "
                + json.dumps(row))
            reports[kern].setdefault("timings", []).append(row)
        # forward + backward as one function (host clock of the eager
        # calls between CUDA events; autograd is not captured)
        pair = {"seq": s}
        _, pair["fwd_bwd_ms"] = time_ms(
            lambda i: torch.autograd.grad(
                FA.flash_attention(*leaves), leaves, do), 5, graph=False)
        _, pair["library_fwd_bwd_ms"] = time_ms(
            lambda i: torch.autograd.grad(
                F.scaled_dot_product_attention(*tleaves, is_causal=True),
                tleaves, dot), 5, graph=False)
        pair["fwd_bwd_bound_ms"], pair["fwd_bwd_bound_by"] = flash_bound_ms(
            b, h, h, s, d, dtype, "fwd_bwd")
        # the backward pair against the library's flash backward, which
        # computes dQ, dK and dV in one call from its own forward's lse
        lib = torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, True, False)
        lib_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
        pair["library_bwd_ms"], pair["library_bwd_eager_ms"] = time_ms(
            lambda i: lib_bwd(dot, qt, kt, vt, *lib[:6], 0.0, True,
                              *lib[6:8]), 10)
        pair["bwd_pair_ms"] = (
            reports["flash_backward_dkv"]["timings"][-1]["ms"]
            + reports["flash_backward_dq"]["timings"][-1]["ms"])
        log(f"timing 7b flash forward+backward vs SDPA (eager) and the "
            f"backward pair vs the library's flash backward (device), bf16 "
            f"B={b} H={h} D={d} S={s} causal: " + json.dumps(pair))
        reports["flash_forward"].setdefault("fwd_bwd", []).append(pair)
        del q, k, v, do, o, lse, delta, qt, kt, vt, dot, leaves, tleaves
        del lib
        torch.cuda.empty_cache()
    for kern in FLASH_KERNELS:
        r = reports[kern]
        r["max_abs_err_f32"] = worst[kern, torch.float32]
        r["max_abs_err_bf16"] = worst[kern, torch.bfloat16]
        r["max_abs_err"] = max(r["max_abs_err_f32"], r["max_abs_err_bf16"])
        main = next(t for t in r["timings"] if t["seq"] == 2048)
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
            r[key] = main[key]


def _post(base: str, body: dict) -> tuple:
    req = urllib.request.Request(
        base + "/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        out = r.status, json.loads(r.read())
    return out + (time.perf_counter() - t0,)


def _post_any(base: str, path: str, body: dict, headers=None) -> tuple:
    """A POST to ``path``: ``(HTTP status, the JSON body)``, error
    statuses included (``_post`` raises on them)."""
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post_stream(base: str, body: dict) -> tuple:
    """A ``"stream": true`` generate: (HTTP status, the ndjson events,
    seconds to the first event, seconds to the end)."""
    req = urllib.request.Request(
        base + "/v1/generate", data=json.dumps(dict(body, stream=True))
        .encode(), headers={"Content-Type": "application/json"},
        method="POST")
    t0 = time.perf_counter()
    first = None
    events = []
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            if line.strip():
                if first is None:
                    first = time.perf_counter() - t0
                events.append(json.loads(line))
        status = r.status
    return status, events, first, time.perf_counter() - t0


def _check_rows(cfg, prompt, out, n_new, what) -> None:
    """One generated row: the prompt echoed, ``n_new`` new tokens, every
    id inside the vocabulary."""
    if len(out) != len(prompt) + n_new or out[:len(prompt)] != prompt:
        raise AssertionError(f"{what}: {len(out)} tokens for a "
                             f"{len(prompt)}-token prompt + {n_new} new, or "
                             "the prompt is not echoed")
    if min(out) < 0 or max(out) >= cfg.vocab_size:
        raise AssertionError(f"{what}: tokens outside the vocabulary")


def make_7b():
    """7b at full width and depth, bf16, fresh init from seed 0."""
    import torch

    from paddle_operator_tpu_torch.models.llama import CONFIGS, make_model

    t0 = time.perf_counter()
    params, cfg = make_model("7b", device="cuda", seed=0,
                             param_dtype=CONFIGS["7b"].dtype)
    torch.cuda.synchronize()
    log(f"main path: 7b init on the card {time.perf_counter() - t0:.1f}s "
        f"({cfg.num_params() / 1e9:.2f}B params, {cfg.dtype}, "
        f"{cfg.n_layers} layers)")
    return params, cfg


def phase_main_path(report: dict, params, cfg) -> None:
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.infer.serve import make_server
    from paddle_operator_tpu_torch.ops import decode_attention as DA

    srv = make_server("127.0.0.1", 0, params, cfg)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    rng = np.random.default_rng(0)
    r1 = {"tokens": rng.integers(0, cfg.vocab_size, (1, 32)).tolist(),
          "max_new_tokens": 64}
    r2 = {"tokens": rng.integers(0, cfg.vocab_size, (4, 512)).tolist(),
          "max_new_tokens": 32}
    reqs = [r1, r2, r1]
    try:
        _zero_launches()
        results = [_post(base, r) for r in reqs]
        launches = DA.decode_attention.launches
        paged = DA.paged_decode_attention.launches
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    steps = 0
    for body, (code, out, secs) in zip(reqs, results):
        toks = np.asarray(out["tokens"])
        b, s = np.asarray(body["tokens"]).shape
        n = body["max_new_tokens"]
        if code != 200 or toks.shape != (b, s + n):
            raise AssertionError(f"request {b}x{s}+{n}: HTTP {code}, "
                                 f"shape {toks.shape}")
        if toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError("tokens outside the vocabulary")
        if not (toks[:, :s] == np.asarray(body["tokens"])).all():
            raise AssertionError("response does not echo the prompt")
        steps += n - 1
        log(f"main path: POST B={b} prompt={s} new={n}: HTTP {code} in "
            f"{secs:.3f}s ({b * n / secs:.1f} new tok/s end to end)")
    if results[0][1] != results[2][1]:
        raise AssertionError("greedy resubmission is not byte-identical")
    want = cfg.n_layers * steps
    log(f"main path: decode_attention launches {launches} "
        f"(n_layers {cfg.n_layers} x decode steps {steps} = {want})")
    if launches != want or paged:
        raise AssertionError(f"decode_attention launched {launches} "
                             f"times, expected {want}; the paged kernel "
                             f"{paged} times, expected 0")
    report["launches"] = launches

    # decode ms/token at B=4 after a 512-token prefill (the second
    # request's shape), device-synchronized host clock over 32 steps
    prompt = torch.as_tensor(np.asarray(r2["tokens"], np.int32),
                             device="cuda")
    with torch.inference_mode():
        logits, cache = D.prefill(params, cfg, prompt)
        tok = logits.argmax(-1).to(torch.int32)
        for _ in range(3):
            logits, cache = D.decode_step(params, cfg, tok, cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 32
        for _ in range(n):
            logits, cache = D.decode_step(params, cfg, tok, cache)
            tok = logits.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n * 1e3
    log(f"main path: decode {ms:.3f} ms/token-step at B=4 "
        f"(fill 516-547), {4 / ms * 1e3:.1f} tok/s")
    report["decode_ms_per_step_b4"] = ms
    del cache
    torch.cuda.empty_cache()


RING = dict(continuous=True, paged=True, slots=8, chunk_tokens=8,
            block_size=256, max_len=2048)


def quantized_per_layer(cfg) -> int:
    """The quantized projections of a layer: q, k, v, o and the FFN's
    three, or an MoE layer's two a expert (the router stays bf16)."""
    return 4 + (2 * cfg.n_experts if cfg.n_experts > 0 else 3)


def qmm_launches_want(cfg, ticks: int, forwards, lm_head: bool) -> tuple:
    """The int8-weight kernels' launches over a run of a quantized ring,
    (kernel A, kernel B): the projections of every layer
    (:func:`quantized_per_layer`: seven, or 4 + 2E) on each ring tick (8
    rows: kernel A) and on each forward of ``forwards`` (their row
    counts: a prompt's length, a prefix hit's padded suffix bucket) —
    kernel A up to ``KERNEL_MAX_ROWS`` rows, kernel B above; the legacy
    quantized lm_head once a tick and once a forward, on its one last
    row (kernel A)."""
    from paddle_operator_tpu_torch.ops.quant_matmul import KERNEL_MAX_ROWS

    per = quantized_per_layer(cfg) * cfg.n_layers
    short = sum(r <= KERNEL_MAX_ROWS for r in forwards)
    return ((per + int(lm_head)) * ticks + per * short
            + int(lm_head) * len(forwards), per * (len(forwards) - short))


def burst_requests(cfg) -> tuple:
    """3b's burst (3e, 3m and 3n send it again): 8 cold prompts of 32 to
    1,000 tokens (48 new tokens each) and a streamed 64-token prompt (32
    new), then 4 followers of the 512-token cold prompt (its 512 tokens
    + 16 of their own, 32 new).  Returns ``(cold, prefix, jobs, late,
    keys)``: ``jobs`` and ``late`` as (kind, index, prompt, new tokens),
    ``late`` to be sent once the radix holds ``keys`` (the prefix's
    chain), so each follower admits through the suffix-only insert."""
    import numpy as np

    from paddle_operator_tpu_torch.utils.radixkey import prefix_chain_key

    rng = np.random.default_rng(0)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    cold = [prompt(n) for n in (32, 100, 257, 300, 511, 512, 600, 1000)]
    prefix = cold[5]                       # the 512-token prompt
    followers = [prefix + prompt(16) for _ in range(4)]
    streamed = prompt(64)
    jobs = ([("cold", i, p, 48) for i, p in enumerate(cold)]
            + [("stream", 0, streamed, 32)])
    late = [("follower", i, p, 32) for i, p in enumerate(followers)]
    keys = [prefix_chain_key(prefix, RING["block_size"], max_blocks=2)[0]]
    return cold, prefix, jobs, late, keys


def phase_ring_main_path(report: dict, params, cfg,
                         kv_quant: str = "none", bf16_ring=None,
                         megastep: int = 1, ref=None,
                         wquant=None, ring_extra=None) -> dict:
    """The continuous paged server under a concurrent burst; see the
    module docstring (phases 3b, with ``kv_quant="int8"`` 3d and with
    ``megastep=4`` 3e, whose rings are held beside 3b's ``bf16_ring``
    readings; 3e's tokens against 3b's, ``ref``; with ``wquant`` — the
    quantized model's mode, its expected ``paramBytes`` and whether its
    lm_head is quantized — 3i; ``ring_extra``: more ring arguments, 3o's
    disaggregated engine).  Returns every request's output tokens, by
    (kind, index)."""
    import numpy as np

    from paddle_operator_tpu_torch.infer.serve import make_server
    from paddle_operator_tpu_torch.ops import decode_attention as DA
    from paddle_operator_tpu_torch.ops import quant_matmul as QM
    from paddle_operator_tpu_torch.utils.radixkey import prefix_chain_key
    from paddle_operator_tpu_torch.utils.tracing import hist_quantile

    quant = kv_quant != "none"
    kw = dict(RING, prewarm=True, **(ring_extra or {}))
    if quant:
        kw["kv_quant"] = kv_quant
    if megastep > 1:
        kw["megastep"] = megastep
    t_build = time.perf_counter()
    srv = make_server("127.0.0.1", 0, params, cfg, **kw)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    batcher = srv.generator.batcher
    ex = batcher.executor
    # the prewarm thread captures the resident programs (ring empty)
    if not batcher.prewarmed.wait(600) or ex.needs_capture:
        raise AssertionError(f"the ring's CUDA graphs were not captured at "
                             f"prewarm: {batcher.prewarm_error!r}")
    log(f"ring: CUDA graphs of steps {sorted(ex._graphs)} captured in "
        f"{ex.capture_s:.2f}s (server up to captured "
        f"{time.perf_counter() - t_build:.2f}s), graph pool "
        f"{ex.graph_pool_bytes()} bytes, launches recorded "
        f"{ {n: g.launches for n, g in ex._graphs.items()} } on "
        f"{card_line()}")
    bs, chunk = RING["block_size"], RING["chunk_tokens"]
    cold, prefix, jobs, late, keys = burst_requests(cfg)
    streamed = jobs[-1][2]
    if quant:
        # int8: one more follower, the first 600 tokens of the cold
        # 1000-token prompt — its hit (599 tokens) ends mid-block, so it
        # copies that block and seeds its tail from the dequantized copy
        late.append(("midblock", 0, cold[7][:600], 32))
        keys.append(prefix_chain_key(cold[7], bs, max_blocks=3)[0])
    results, errors = {}, []

    def send(kind, i, p, n):
        try:
            body = {"tokens": [p], "max_new_tokens": n}
            results[kind, i] = (_post_stream(base, body) if kind == "stream"
                                else _post(base, body))
        except Exception as e:               # surfaced after the join
            errors.append(f"{kind} {i}: {e!r}")

    try:
        stats0 = dict(batcher.stats)
        replays0 = ex.graph_replays
        _zero_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=send, args=j) for j in jobs]
        for t in threads:
            t.start()
        while not all(k in batcher.pool.entries for k in keys):
            if errors or time.perf_counter() - t0 > 600:
                raise AssertionError(f"the shared prefix was never "
                                     f"cached: {errors}")
            time.sleep(0.005)
        more = [threading.Thread(target=send, args=j) for j in late]
        for t in more:
            t.start()
        for t in threads + more:
            t.join()
        burst_s = time.perf_counter() - t0
        burst_chunks = batcher.stats["chunks"] - stats0["chunks"]
        # a full prefix hit: the cold 512-token prompt again
        send("resubmit", 0, prefix, 48)
        with urllib.request.urlopen(base + "/statusz", timeout=60) as r:
            statusz = json.loads(r.read())
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
        srv.generator.close()                # the ring thread has ended
    replays = ex.graph_replays - replays0
    kernels = {"decode_attention": DA.decode_attention.launches,
               "paged_decode_attention": DA.paged_decode_attention.launches,
               "paged_decode_attention_quant":
                   DA.paged_decode_attention.quant_launches,
               "quant_matmul": QM.quant_matmul.launches,
               "quant_gemm": QM.quant_gemm.launches}
    name = ("paged_decode_attention_quant" if quant
            else "paged_decode_attention")
    launches = kernels.pop(name)
    wmode = wquant["mode"] if wquant else "none"
    qmm = ((kernels.pop("quant_matmul"), kernels.pop("quant_gemm"))
           if wquant else None)
    if errors:
        raise AssertionError(f"ring requests failed: {errors}")
    stats = {k: batcher.stats[k] - stats0.get(k, 0)
             for k in ("chunks", "prefill_calls", "prefill_tokens",
                       "admitted", "evicted")}
    pool = batcher.pool

    new_tokens = 0
    outputs = {}
    for (kind, i, p, n) in jobs + late:
        if kind == "stream":
            code, events, first_s, secs = results[kind, i]
            toks = [e["token"] for e in events if "token" in e]
            done = events[-1]
            if code != 200 or not done.get("done") or len(toks) != n \
                    or done["tokens"] != p + toks:
                raise AssertionError(f"streamed request: HTTP {code}, "
                                     f"{len(toks)} token events, last "
                                     f"event {str(done)[:200]}")
            out = done["tokens"]
            log(f"ring: streamed prompt={len(p)} new={n}: first event "
                f"after {first_s:.3f}s, done in {secs:.3f}s")
        else:
            code, body, secs = results[kind, i]
            if code != 200 or len(body["tokens"]) != 1:
                raise AssertionError(f"{kind} {i}: HTTP {code}")
            out = body["tokens"][0]
        _check_rows(cfg, p, out, n, f"{kind} {i}")
        outputs[kind, i] = out
        new_tokens += n
    code, body, resub_s = results["resubmit", 0]
    _check_rows(cfg, prefix, body["tokens"][0], 48, "resubmission")
    outputs["resubmit", 0] = body["tokens"][0]
    cold_new = results["cold", 5][1]["tokens"][0][len(prefix):]
    resub_new = body["tokens"][0][len(prefix):]
    same = sum(a == b for a, b in zip(cold_new, resub_new)) / len(cold_new)

    want = cfg.n_layers * chunk * megastep * stats["chunks"]
    log(f"ring: {name} launches {launches} (n_layers {cfg.n_layers} x "
        f"chunk {chunk} x megastep {megastep} x dispatches "
        f"{stats['chunks']} = {want}); other decode kernels {kernels}; "
        f"CUDA graph replays {replays}")
    if launches != want or any(kernels.values()):
        raise AssertionError(f"{name} launched {launches} times, expected "
                             f"{want}; the other decode kernels {kernels} "
                             "times, expected 0")
    if replays != stats["chunks"]:
        raise AssertionError(f"{stats['chunks']} dispatches but {replays} "
                             "CUDA graph replays")
    # prefill work: every cold prompt whole, each follower its 16-token
    # suffix (the mid-block follower its last token), the resubmission
    # its last token
    want_tokens = (sum(map(len, cold)) + len(streamed) + 4 * 16 + 1
                   + (1 if quant else 0))
    log(f"ring: prefill calls {stats['prefill_calls']}, prefill tokens "
        f"{stats['prefill_tokens']} (expected {len(jobs) + len(late) + 1}"
        f", {want_tokens}); radix hit rate {pool.hit_rate()}, CoW copies "
        f"{pool.stats['cow_copies']}, blocks hwm {pool.stats['blocks_hwm']}")
    if (stats["prefill_tokens"] != want_tokens
            or stats["prefill_calls"] != len(jobs) + len(late) + 1):
        raise AssertionError("the followers or the resubmission did not "
                             "prefill only their suffixes")
    if not pool.hit_rate() > 0 or pool.stats["cow_copies"] < 1:
        raise AssertionError("no radix hit or no copy-on-write")
    pool.check_invariant()
    if pool.blocks_free() + pool.blocks_cached() != pool.num_blocks:
        raise AssertionError(f"blocks still mapped at the end: "
                             f"{pool.blocks_free()} free + "
                             f"{pool.blocks_cached()} cached of "
                             f"{pool.num_blocks}")
    if statusz.get("kvQuantMode") != kv_quant:
        raise AssertionError(f"/statusz kvQuantMode "
                             f"{statusz.get('kvQuantMode')!r}, expected "
                             f"{kv_quant!r}")
    if statusz.get("megastepN") != megastep:
        raise AssertionError(f"/statusz megastepN {statusz.get('megastepN')}"
                             f", expected {megastep}")
    gauge = next((ln for ln in metrics.splitlines()
                  if ln.startswith("tpujob_serve_weight_quant_mode{")), "")
    if statusz.get("weightQuantMode") != wmode \
            or f'mode="{wmode}"' not in gauge \
            or float(gauge.split(" ")[-1]) != float(wmode != "none"):
        raise AssertionError(f"/statusz weightQuantMode "
                             f"{statusz.get('weightQuantMode')!r}, gauge "
                             f"{gauge!r}; expected {wmode!r}")
    if wquant:
        # the forwards: every cold and streamed prompt at its length, the
        # 4 followers' 16-row suffix buckets, the resubmission's (and the
        # mid-block follower's) 1-token suffix in an 8-row bucket
        forwards = ([len(p) for kind, _, p, _ in jobs]
                    + [16 if kind == "follower" else 8
                       for kind, _, _, _ in late] + [8])
        ticks = chunk * megastep * stats["chunks"]
        want_q = qmm_launches_want(cfg, ticks, forwards, wquant["lm_head"])
        head = " + lm_head" if wquant["lm_head"] else ""
        log(f"ring weight quant {wmode}: (kernel A, kernel B) launches "
            f"{qmm}, expected {want_q} ({quantized_per_layer(cfg)} x "
            f"n_layers {cfg.n_layers}{head} a tick, {ticks} ticks, and a "
            f"forward, rows {forwards}); "
            f"/statusz weightQuantMode {statusz['weightQuantMode']}, "
            f"paramBytes {statusz['paramBytes']} (expected "
            f"{wquant['param_bytes']}); {gauge}")
        if qmm != want_q:
            raise AssertionError(f"(quant_matmul, quant_gemm) launched "
                                 f"{qmm} times, expected {want_q}")
        if statusz["paramBytes"] != wquant["param_bytes"]:
            raise AssertionError(f"/statusz paramBytes "
                                 f"{statusz['paramBytes']}, expected "
                                 f"{wquant['param_bytes']}")

    ttft = batcher.hist.ttft
    p50 = hist_quantile(ttft.bounds, ttft.counts, 0.50)
    p95 = hist_quantile(ttft.bounds, ttft.counts, 0.95)
    ring = {
        "kv_quant": kv_quant, "megastep": megastep, "weight_quant": wmode,
        "burst_s": burst_s, "burst_new_tokens": new_tokens,
        "burst_new_tok_s": new_tokens / burst_s,
        "burst_chunks": burst_chunks,
        "wall_ms_per_chunk": burst_s / burst_chunks * 1e3,
        "wall_ms_per_token": burst_s / new_tokens * 1e3,
        "dispatches_per_token": statusz["dispatchesPerToken"],
        "graph_capture_s": ex.capture_s,
        "graph_pool_bytes": ex.graph_pool_bytes(),
        "ttft_p50_ms": p50, "ttft_p95_ms": p95,
        "resubmit_s": resub_s, "resubmit_token_match_share": same,
        "pool_blocks": pool.num_blocks,
        "pool_gb": batcher.executor.pool_bytes() / 1e9,
        "kv_pool_bytes": statusz["kvPoolBytes"],
    }
    if wquant:
        ring["qmm_launches"] = list(qmm)
    log("ring: " + json.dumps(ring))
    log(f"ring {kv_quant} megastep {megastep} (a smoke reading of one "
        f"burst, not a benchmark): {new_tokens} new tokens in {burst_s:.3f}s "
        f"({ring['burst_new_tok_s']:.1f} new tok/s over the burst), TTFT "
        f"p50 {p50:.1f} ms, p95 {p95:.1f} ms (ring histogram), "
        f"{ring['wall_ms_per_chunk']:.1f} ms wall per dispatch; the "
        f"resubmission matches its cold run on {same:.3f} of its new "
        "tokens (not asserted: a prefill and a one-token suffix forward "
        "round differently in bf16)")
    if ref is not None:
        differ = [k for k in ref if outputs.get(k) != ref[k]]
        log(f"ring megastep {megastep} beside 3b (this run): "
            f"{len(ref) - len(differ)}/{len(ref)} requests token-identical; "
            f"new tok/s {ring['burst_new_tok_s']:.1f} vs "
            f"{bf16_ring['burst_new_tok_s']:.1f}; TTFT p50 {p50:.1f} vs "
            f"{bf16_ring['ttft_p50_ms']:.1f} ms, p95 {p95:.1f} vs "
            f"{bf16_ring['ttft_p95_ms']:.1f} ms; wall ms per token "
            f"{ring['wall_ms_per_token']:.2f} vs "
            f"{bf16_ring['wall_ms_per_token']:.2f}; dispatchesPerToken "
            f"{ring['dispatches_per_token']} vs "
            f"{bf16_ring['dispatches_per_token']}")
        if differ:
            raise AssertionError(f"megastep {megastep} tokens differ from "
                                 f"3b's for {differ}")
        if not ring["dispatches_per_token"] < \
                bf16_ring["dispatches_per_token"]:
            raise AssertionError("the megastep did not lower "
                                 "dispatchesPerToken")
        ring["single_step_ring"] = {k: bf16_ring[k] for k in (
            "burst_new_tok_s", "ttft_p50_ms", "ttft_p95_ms",
            "wall_ms_per_token", "dispatches_per_token")}
        report["ring_megastep"] = ring
        return outputs
    if bf16_ring is not None:
        log(f"ring int8 beside bf16 (3b, this run): kvPoolBytes "
            f"{ring['kv_pool_bytes']} vs {bf16_ring['kv_pool_bytes']} "
            f"({ring['kv_pool_bytes'] / bf16_ring['kv_pool_bytes']:.4f}x); "
            f"new tok/s {ring['burst_new_tok_s']:.1f} vs "
            f"{bf16_ring['burst_new_tok_s']:.1f}; TTFT p50 {p50:.1f} vs "
            f"{bf16_ring['ttft_p50_ms']:.1f} ms, p95 {p95:.1f} vs "
            f"{bf16_ring['ttft_p95_ms']:.1f} ms; wall ms per chunk "
            f"{ring['wall_ms_per_chunk']:.1f} vs "
            f"{bf16_ring['wall_ms_per_chunk']:.1f}")
        ring["bf16_ring"] = {k: bf16_ring[k] for k in (
            "kv_pool_bytes", "burst_new_tok_s", "ttft_p50_ms",
            "ttft_p95_ms", "wall_ms_per_chunk")}
    report["launches"] = launches
    report["ring"] = ring
    return outputs


# phase 3g: 3b's server; 8 class-1 requests (cold 512-token prompts,
# 192 new tokens) fill the lanes, then 2 class-0 requests (512-token
# prompts, 32 new tokens) arrive once every lane has decoded 2 chunks
PREEMPT = dict(prompt=512, victims=8, victim_new=192, urgent=2,
               urgent_new=32, chunks_first=2)


def _stream_timed(base: str, body: dict, headers=None) -> tuple:
    """A ``"stream": true`` generate: (HTTP status, the ndjson events,
    the host clock at each event, the clock at the send)."""
    req = urllib.request.Request(
        base + "/v1/generate", data=json.dumps(dict(body, stream=True))
        .encode(), headers={"Content-Type": "application/json",
                            **(headers or {})}, method="POST")
    t0 = time.perf_counter()
    events, times = [], []
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            if line.strip():
                events.append(json.loads(line))
                times.append(time.perf_counter())
        status = r.status
    return status, events, times, t0


def _preempt_burst(params, cfg, kv_quant: str, preempt: bool) -> dict:
    """One run of phase 3g's traffic on a fresh 3b server (``kv_quant``
    pool, ``SERVE_PREEMPT`` on or off): every request's tokens, the
    class-0 latencies, the class-1 token gaps, the spills and restores
    (timed by wrappers around the executor's methods), the launches and
    replays, and the pool's accounting."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer.qos import QoSConfig
    from paddle_operator_tpu_torch.infer.serve import make_server
    from paddle_operator_tpu_torch.ops import decode_attention as DA

    quant = kv_quant != "none"
    env = {"SERVE_PRIORITIES": "2"}
    if not preempt:
        env["SERVE_PREEMPT"] = "0"
    kw = dict(RING, prewarm=True, qos=QoSConfig.from_env(env))
    if quant:
        kw["kv_quant"] = kv_quant
    srv = make_server("127.0.0.1", 0, params, cfg, **kw)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    batcher = srv.generator.batcher
    ex = batcher.executor
    if not batcher.prewarmed.wait(600) or ex.needs_capture:
        raise AssertionError(f"3g: the ring's CUDA graphs were not captured "
                             f"at prewarm: {batcher.prewarm_error!r}")
    graphs = ex._graphs
    ptrs = ex._state_ptrs()
    counter = "quant_launches" if quant else "launches"
    spills, restores, broken = [], [], []
    marks = []              # (host clock, what) of dispatches, spills, restores
    real_spill, real_restore = ex.spill_lane, ex.restore_lane
    real_replay = ex.replay

    def spill_lane(slot):
        t0 = time.perf_counter()
        spill = real_spill(slot)
        t1 = time.perf_counter()
        marks.append((t0, f"spill {(t1 - t0) * 1e3:.1f} ms"))
        spills.append((t1 - t0, sum(
            v.numel() * v.element_size() for v in spill.values()
            if isinstance(v, torch.Tensor))))
        return spill

    def restore_lane(slot, spill):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        real_restore(slot, spill)
        e1.record()
        t1 = time.perf_counter()
        marks.append((t0, f"restore {(t1 - t0) * 1e3:.1f} ms"))
        restores.append((t1 - t0, e0, e1,
                         getattr(DA.paged_decode_attention, counter),
                         ex.graph_replays))

    def replay(plan):
        marks.append((time.perf_counter(), "dispatch"))
        return real_replay(plan)

    ex.spill_lane, ex.restore_lane = spill_lane, restore_lane
    ex.replay = replay
    for name in ("_preempt", "_try_restore"):
        real = getattr(batcher, name)

        def checked(*a, _real=real, _name=name):
            out = _real(*a)
            try:
                batcher.pool.check_invariant()
            except AssertionError as e:
                broken.append(f"{_name}: {e}")
            return out

        setattr(batcher, name, checked)
    rng = np.random.default_rng(7)
    n = PREEMPT["prompt"]
    victims = [rng.integers(0, cfg.vocab_size, n).tolist()
               for _ in range(PREEMPT["victims"])]
    urgent = [rng.integers(0, cfg.vocab_size, n).tolist()
              for _ in range(PREEMPT["urgent"])]
    results, errors = {}, []

    def send(kind, i, p, new, prio):
        try:
            results[kind, i] = _stream_timed(
                base, {"tokens": [p], "max_new_tokens": new},
                {"X-Request-Priority": str(prio)})
        except Exception as e:              # surfaced after the join
            errors.append(f"{kind} {i}: {e!r}")

    try:
        free0 = batcher.pool.blocks_free()
        stats0 = dict(batcher.stats)
        replays0 = ex.graph_replays
        _zero_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=send, args=(
            "class1", i, p, PREEMPT["victim_new"], 1))
            for i, p in enumerate(victims)]
        for t in threads:
            t.start()
        want_pos = n + PREEMPT["chunks_first"] * RING["chunk_tokens"]
        while not (all(r is not None for r in batcher.lane)
                   and min(batcher._lane_pos) >= want_pos):
            if errors or time.perf_counter() - t0 > 600:
                raise AssertionError(f"3g: the class-1 lanes never all "
                                     f"decoded 2 chunks: {errors}")
            time.sleep(0.002)
        late = [threading.Thread(target=send, args=(
            "class0", i, p, PREEMPT["urgent_new"], 0))
            for i, p in enumerate(urgent)]
        for t in late:
            t.start()
        for t in threads + late:
            t.join()
        burst_s = time.perf_counter() - t0
        with urllib.request.urlopen(base + "/statusz", timeout=60) as r:
            statusz = json.loads(r.read())
        torch.cuda.synchronize()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
        srv.generator.close()
    if errors:
        raise AssertionError(f"3g requests failed: {errors}")
    out, gaps, urgent_s, class1_done = {}, [], [], []
    for (kind, i), (code, events, times, t_send) in sorted(results.items()):
        p = (victims if kind == "class1" else urgent)[i]
        new = PREEMPT["victim_new" if kind == "class1" else "urgent_new"]
        toks = [e["token"] for e in events if "token" in e]
        done = events[-1]
        if code != 200 or not done.get("done") or len(toks) != new \
                or done["tokens"] != p + toks:
            raise AssertionError(f"3g {kind} {i}: HTTP {code}, {len(toks)} "
                                 f"token events, last {str(done)[:200]}")
        _check_rows(cfg, p, done["tokens"], new, f"3g {kind} {i}")
        out[kind, i] = done["tokens"]
        tt = [t for t, e in zip(times, events) if "token" in e]
        if kind == "class1":
            gaps += [b - a for a, b in zip(tt, tt[1:])]
            class1_done.append(times[-1] - t0)
        else:
            urgent_s.append((tt[0] - t_send, times[-1] - t_send))
    pool = batcher.pool
    pool.check_invariant()
    chunks = batcher.stats["chunks"] - stats0["chunks"]
    launches = getattr(DA.paged_decode_attention, counter)
    per = cfg.n_layers * RING["chunk_tokens"]
    after = [(launches - c, ex.graph_replays - g)
             for _, _, _, c, g in restores]
    gaps = np.asarray(gaps)
    # where the burst's wall time went: the longest host intervals
    # between two dispatches, with the spills and restores inside them
    ticks = [t for t, what in marks if what == "dispatch"]
    waits = sorted(zip(np.diff(ticks), ticks), reverse=True)[:4]
    stalls = [(round((a - t0) * 1e3, 1), round(float(w) * 1e3, 1),
               [what for t, what in marks if what != "dispatch"
                and a <= t < a + w]) for w, a in waits]
    return {
        "kv_quant": kv_quant, "preempt": preempt, "outputs": out,
        "burst_s": burst_s, "chunks": chunks,
        "replays": ex.graph_replays - replays0,
        "launches": launches, "launches_want": per * chunks,
        "other_kernels": (DA.decode_attention.launches,
                          getattr(DA.paged_decode_attention,
                                  "launches" if quant else "quant_launches")),
        "launches_after_restores": after,
        "per_dispatch": per,
        "preempted": statusz["preemptedLanes"],
        "restored": batcher.stats["restored_lanes"] - stats0.get(
            "restored_lanes", 0),
        "parked": statusz["parkedLanes"],
        "free_before": free0, "free_after": statusz["kvBlocksFree"],
        "cached_after": pool.blocks_cached(), "invariant_breaks": broken,
        "spill_ms": [s * 1e3 for s, _ in spills],
        "spill_bytes": [b for _, b in spills],
        "restore_host_ms": [h * 1e3 for h, _, _, _, _ in restores],
        "restore_device_ms": [e0.elapsed_time(e1)
                              for _, e0, e1, _, _ in restores],
        "urgent_ttft_s": [a for a, _ in urgent_s],
        "urgent_done_s": [b for _, b in urgent_s],
        "class1_itl_p95_ms": float(np.percentile(gaps, 95)) * 1e3,
        "class1_gap_max_ms": float(gaps.max()) * 1e3,
        "class1_done_s": sorted(class1_done),
        "dispatch_interval_median_ms": float(np.median(np.diff(ticks))) * 1e3,
        "longest_intervals": stalls,
        "same_graphs": ex._graphs is graphs and ex._state_ptrs() == ptrs,
    }


def _host_link_readings(nbytes: int) -> dict:
    """What a spill's bytes cost on this machine's host link, piece by
    piece: page-locking a fresh host buffer (``torch.empty(...,
    pin_memory=True)``), a device-to-host copy into it and again into the
    same buffer, a copy into pageable memory, and a host-to-device copy
    from the pinned buffer; each timed by the host clock around a
    synchronized copy."""
    import torch

    src = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, out

    alloc_ms, host = timed(lambda: torch.empty(nbytes, dtype=torch.uint8,
                                               pin_memory=True))
    first_ms, _ = timed(lambda: host.copy_(src, non_blocking=True))
    again_ms, _ = timed(lambda: host.copy_(src, non_blocking=True))
    h2d_ms, _ = timed(lambda: src.copy_(host, non_blocking=True))
    pageable_ms, _ = timed(lambda: src.cpu())
    out = {"bytes": nbytes, "pin_alloc_ms": alloc_ms, "d2h_pinned_ms":
           first_ms, "d2h_pinned_again_ms": again_ms, "h2d_pinned_ms": h2d_ms,
           "d2h_pageable_ms": pageable_ms}
    for key in ("d2h_pinned_again_ms", "h2d_pinned_ms", "d2h_pageable_ms"):
        out[key.replace("_ms", "_gb_s")] = nbytes / out[key] / 1e6
    del src, host
    torch.cuda.empty_cache()
    return out


def phase_preemption(reports: tuple, params, cfg) -> None:
    """Phase 3g: preemption on the 7b ring at full width, on the bf16 and
    int8 pools, each beside a ``SERVE_PREEMPT=0`` run of the same
    requests; see the module docstring."""
    import torch

    for report, kv_quant in zip(reports, ("none", "int8")):
        runs = {}
        for preempt in (True, False):
            runs[preempt] = _preempt_burst(params, cfg, kv_quant, preempt)
            gc.collect()
            torch.cuda.empty_cache()
        on, off = runs[True], runs[False]
        name = ("paged_decode_attention_quant" if kv_quant == "int8"
                else "paged_decode_attention")
        differ = [k for k in on["outputs"] if k[0] == "class1"
                  and on["outputs"][k] != off["outputs"][k]]
        for run in (on, off):
            log(f"preempt {kv_quant} SERVE_PREEMPT={int(run['preempt'])}: "
                f"{name} launches {run['launches']} (n_layers x chunk x "
                f"dispatches {run['launches_want']}), other decode kernels "
                f"{run['other_kernels']}, CUDA graph replays "
                f"{run['replays']} for {run['chunks']} dispatches; "
                f"preemptedLanes {run['preempted']}, restored "
                f"{run['restored']}, parkedLanes {run['parked']}; "
                f"kvBlocksFree {run['free_before']} before, "
                f"{run['free_after']} + {run['cached_after']} cached after; "
                f"class-0 TTFT s {run['urgent_ttft_s']}, done s "
                f"{run['urgent_done_s']}; class-1 token gap p95 "
                f"{run['class1_itl_p95_ms']:.2f} ms, max "
                f"{run['class1_gap_max_ms']:.1f} ms; burst "
                f"{run['burst_s']:.3f} s on {card_line()}")
            bad = []
            if run["launches"] != run["launches_want"] \
                    or any(run["other_kernels"]):
                bad.append("launch counts")
            if run["replays"] != run["chunks"] or not run["same_graphs"]:
                bad.append("not every dispatch a replay of the prewarm "
                           "graphs at their addresses")
            if run["parked"] or run["invariant_breaks"]:
                bad.append(f"parked {run['parked']}, invariant "
                           f"{run['invariant_breaks']}")
            if run["free_after"] + run["cached_after"] != run["free_before"]:
                bad.append("blocks neither free nor cached at the end")
            if bad:
                raise AssertionError(f"3g {kv_quant} preempt "
                                     f"{run['preempt']}: {bad}")
        for run in (on, off):
            log(f"preempt {kv_quant} SERVE_PREEMPT={int(run['preempt'])} "
                f"timeline: class-1 done at s "
                f"{[round(x, 3) for x in run['class1_done_s']]}; median "
                f"interval between dispatches "
                f"{run['dispatch_interval_median_ms']:.1f} ms, longest "
                f"(start ms, length ms, what ran in it) "
                f"{run['longest_intervals']}")
        log(f"preempt {kv_quant}: spills {len(on['spill_ms'])}, ms "
            f"{[round(x, 3) for x in on['spill_ms']]}, bytes "
            f"{on['spill_bytes']}; restores ms host "
            f"{[round(x, 3) for x in on['restore_host_ms']]}, device "
            f"{[round(x, 3) for x in on['restore_device_ms']]}; after each "
            f"restore (launches, replays) {on['launches_after_restores']}; "
            f"class-1 streams equal to SERVE_PREEMPT=0's: "
            f"{8 - len(differ)}/8")
        if not on["preempted"] == on["restored"] >= 1 or off["preempted"]:
            raise AssertionError(f"3g {kv_quant}: preempted "
                                 f"{on['preempted']}, restored "
                                 f"{on['restored']} (preemption on); "
                                 f"{off['preempted']} with it off")
        if differ:
            raise AssertionError(f"3g {kv_quant}: class-1 streams differ "
                                 f"from the SERVE_PREEMPT=0 run: {differ}")
        if not all(c == g * on["per_dispatch"] and g > 0
                   for c, g in on["launches_after_restores"]):
            raise AssertionError(f"3g {kv_quant}: the kernel did not run the "
                                 "restored lanes' dispatches")
        report["preempt"] = {
            k: {key: v for key, v in run.items() if key != "outputs"}
            for k, run in (("on", on), ("off", off))}
        link = _host_link_readings(on["spill_bytes"][0])
        report["preempt"]["host_link"] = link
        log(f"preempt {kv_quant}: the host link for one spill's "
            f"{link['bytes']} bytes: pinning a fresh buffer "
            f"{link['pin_alloc_ms']:.1f} ms, device to pinned host "
            f"{link['d2h_pinned_ms']:.1f} ms (again into the same buffer "
            f"{link['d2h_pinned_again_ms']:.1f} ms, "
            f"{link['d2h_pinned_again_gb_s']:.1f} GB/s), pinned host to "
            f"device {link['h2d_pinned_ms']:.1f} ms "
            f"({link['h2d_pinned_gb_s']:.1f} GB/s), device to pageable "
            f"{link['d2h_pageable_ms']:.1f} ms "
            f"({link['d2h_pageable_gb_s']:.1f} GB/s) on {card_line()}")


# phase 3h: 3b's ring with the host tier (SERVE_HOST_CACHE_MB) and the
# durable store (SERVE_KV_STORE); round 1 serves `prefixes` distinct
# `prefix`-token prefixes (4 blocks each: 96 blocks against 3b's 64),
# each with its own `suffix`-token suffix and `new` new tokens; round 2
# the same prefixes with fresh suffixes in reverse order.  `host_mb` is
# the tier-on run's tier (30 bf16 blocks, 61 int8); the store leg's
# tiers are `store_host_mb`: the first server's holds 15 blocks on
# either pool, so that round 1 overflows whole chains into the store
# (eviction takes the chains' last (leaf) blocks first, and at 30 / 61
# blocks no chain leaves the tier whole); the restarted server's holds
# 61, so the chains it imports from the store at submission outlast the
# ~45 demotes its own cold prefills make before their admission.
# `ref_blocks` is the hit reference's pool: round 1's 96
# prefix blocks and 8 lanes' private blocks, nothing evicted.
TIER = dict(prefixes=24, prefix=1024, suffix=16, new=32, host_mb=4096,
            store_host_mb={"none": (2048, 8192), "int8": (1024, 4096)},
            ref_blocks=112)
TIER_RUNS = ("hit_ref", "cold_ref", "off", "on", "store_a", "store_b")
# 3h runs on the first TIER_LAYERS of the 7b params (the script's time
# limit: on an H100 80GB HBM3 at 700 W 3h took 163 s of 1,100 at 32
# layers, 85.7 s at 16, 45.7 s at 8, 29.4 s at 4; the MoE phases 3q, 3r
# and 4o add about 135 s, the mesh phase 3s about 85 s, 3s (b)'s cp and
# pp meshes took it from 4 layers to 2), its tiers' megabytes scaled
# with the depth, so each tier holds the blocks it held at 32
TIER_LAYERS = 2
# 3g and 3p run on the first CUT_LAYERS of the 7b params (the script's
# time limit: on an H100 80GB HBM3 at 700 W they took 36.6 s
# and 53.6 s at 32 layers in a whole run of 1,266 s); their lanes,
# blocks and tiers are counts, not bytes, so nothing else scales.  3i
# and 3r serve fresh CUT_LAYERS-layer inits (32.1 s and 27.2 s at 32
# layers on that card; cut when 3s (b) ran its cp and pp meshes): their
# launch formulas, bounds and paramBytes follow the depth, and their
# kernels' shapes are a layer's, which the depth does not change.  8
# until 3s (b) ran its ep and elastic runs (at 8 layers 3g, 3i, 3p and
# 3r took 11.6, 12.5, 16.1 and 9.7 s in a whole run of 885.6 s on an
# H100 80GB HBM3 at 700 W), 4 until the int8 moments joined 3s (b) (at 4
# layers 10.6, 9.6, 10.6 and 6.6 s of a whole run of 890.8 s on that
# card)
CUT_LAYERS = 2


def _depth_cut(params, cfg, n_layers: int) -> tuple:
    """The first ``n_layers`` decoder layers of ``params`` as a model of
    their own, sharing every tensor (nothing is copied), and its
    config."""
    import copy

    from torch import nn

    cut = copy.copy(params)
    cut._modules = dict(params._modules)
    cut._modules["layers"] = nn.ModuleList(list(params.layers)[:n_layers])
    cut.cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cut, cut.cfg


def _tier_sizes(n_layers: int, cfg) -> dict:
    """TIER with its host megabytes scaled from ``cfg``'s depth to
    ``n_layers`` (a block's bytes scale with the depth)."""
    return dict(TIER, host_mb=TIER["host_mb"] * n_layers // cfg.n_layers,
                store_host_mb={k: tuple(mb * n_layers // cfg.n_layers
                                        for mb in v)
                               for k, v in TIER["store_host_mb"].items()})


def _ordered_round(base: str, batcher, prompts, new: int) -> list:
    """Stream ``prompts`` to the server in order — each request is
    queued before the next one is sent, so the ring admits them in that
    order — and return, per request, (HTTP status, events, event
    clocks, send clock)."""
    results, errors = {}, []
    queued = [0]
    real_submit = batcher.submit

    def submit(*a, **kw):
        out = real_submit(*a, **kw)
        queued[0] += 1
        return out

    batcher.submit = submit

    def send(i, p):
        try:
            results[i] = _stream_timed(
                base, {"tokens": [p], "max_new_tokens": new})
        except Exception as e:              # surfaced after the join
            errors.append(f"request {i}: {e!r}")

    threads = []
    t0 = time.perf_counter()
    try:
        for i, p in enumerate(prompts):
            th = threading.Thread(target=send, args=(i, p))
            th.start()
            threads.append(th)
            while queued[0] <= i:
                if errors or time.perf_counter() - t0 > 600:
                    raise AssertionError(f"3h: request {i} never queued: "
                                         f"{errors}")
                time.sleep(0.0005)
        for th in threads:
            th.join()
    finally:
        batcher.submit = real_submit
    if errors:
        raise AssertionError(f"3h requests failed: {errors}")
    return [results[i] for i in range(len(prompts))]


def _tier_run(params, cfg, kv_quant: str, mode: str, rounds, store_dir=None,
              sizes=TIER) -> dict:
    """One server of phase 3h (``mode`` in TIER_RUNS) serving ``rounds``
    (a list of prompt lists): every request's tokens, TTFT, prefill
    tokens and promoted blocks, and the tier's and the store's timings
    (demotes and promotes timed by CUDA events around their queued
    copies, the store's file writes and fetches by the host clock)."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import serve as S
    from paddle_operator_tpu_torch.ops import decode_attention as DA

    on_card = params.tok_embed.embedding.device.type == "cuda"
    quant = kv_quant != "none"
    kw = dict(RING, prewarm=True)
    if quant:
        kw["kv_quant"] = kv_quant
    if mode == "hit_ref":
        kw["num_blocks"] = sizes["ref_blocks"]
    elif mode == "cold_ref":
        kw["prefix_cache"] = False
    elif mode != "off":
        mb = (sizes["host_mb"] if mode == "on"
              else sizes["store_host_mb"][kv_quant][mode == "store_b"])
        kw["host_cache_blocks"] = S.ring_kw_from_env(
            {"SERVE_PAGED": "1", "SERVE_KV_QUANT": kv_quant,
             "SERVE_BLOCK_SIZE": str(kw["block_size"]),
             "SERVE_HOST_CACHE_MB": str(mb)}, cfg)["host_cache_blocks"]
    srv = S.make_server("127.0.0.1", 0, params, cfg, **kw)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    batcher = srv.generator.batcher
    ex = batcher.executor
    store = None
    if store_dir is not None:
        S.wire_kv_store_from_env(batcher,
                                 {"SERVE_KV_STORE": f"dir:{store_dir}"})
        store = batcher.kv_store
    if not batcher.prewarmed.wait(600) or ex.needs_capture:
        raise AssertionError(f"3h: the ring's CUDA graphs were not captured "
                             f"at prewarm: {batcher.prewarm_error!r}")
    graphs, ptrs = ex._graphs, ex._state_ptrs()
    pinned = bool(ex._slab is not None and ex._slab.registered)
    paths, demotes, promotes, puts, fetches = {}, [], [], [], []
    imports = []

    def event():
        return torch.cuda.Event(enable_timing=True) if on_card else None

    def timed_events(fn, out, size):
        def wrapper(*a):
            e0, e1 = event(), event()
            if on_card:
                e0.record()
            t = time.perf_counter()
            r = fn(*a)
            host = time.perf_counter() - t
            if on_card:
                e1.record()
            out.append((host, e0, e1, size(a)))
            return r
        return wrapper

    real_admit = batcher._admit_paged

    def admit(slot, req):
        t0 = (batcher.stats["prefill_tokens"], batcher.stats["promoted_blocks"])
        out = real_admit(slot, req)
        paths[tuple(req.prompt)] = (
            batcher.stats["prefill_tokens"] - t0[0],
            batcher.stats["promoted_blocks"] - t0[1])
        return out

    batcher._admit_paged = admit
    if batcher.pool.host is not None:
        batcher.pool.demote_fetch = timed_events(
            batcher.pool.demote_fetch, demotes, lambda a: 1)
        ex.dispatch_promotions = timed_events(ex.dispatch_promotions,
                                              promotes, lambda a: len(a[0]))
        batcher.pool.host_import = timed_events(batcher.pool.host_import,
                                                imports, lambda a: 1)
    if store is not None:
        real_put, real_fetch = store.backend.put, store.fetch

        def put(ns, key, blob):
            t = time.perf_counter()
            real_put(ns, key, blob)
            puts.append((time.perf_counter() - t, len(blob)))

        def fetch(*a, **k):
            t = time.perf_counter()
            out = real_fetch(*a, **k)
            fetches.append((time.perf_counter() - t, len(out[1])))
            return out

        store.backend.put, store.fetch = put, fetch
    outputs, ttfts = [], []
    try:
        stats0 = dict(batcher.stats)
        replays0 = ex.graph_replays
        _zero_launches()
        for prompts in rounds:
            res = _ordered_round(base, batcher, prompts, sizes["new"])
            outs, tt = [], []
            for p, (code, events, times, t_send) in zip(prompts, res):
                toks = [e["token"] for e in events if "token" in e]
                done = events[-1]
                if code != 200 or not done.get("done") \
                        or done["tokens"] != p + toks:
                    raise AssertionError(f"3h {mode}: HTTP {code}, last "
                                         f"event {str(done)[:200]}")
                _check_rows(cfg, p, done["tokens"], sizes["new"],
                            f"3h {mode}")
                outs.append(done["tokens"])
                tt.append(next(t for t, e in zip(times, events)
                               if "token" in e) - t_send)
            outputs.append(outs)
            ttfts.append(tt)
        with urllib.request.urlopen(base + "/statusz", timeout=60) as r:
            statusz = json.loads(r.read())
        if store is not None and not store.flush(timeout=600):
            raise AssertionError("3h: the store's writer did not drain")
        if on_card:
            torch.cuda.synchronize()
        batcher.pool.check_invariant()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
        srv.generator.close()
        if store is not None:
            store.close()
    pool = batcher.pool
    chunks = batcher.stats["chunks"] - stats0["chunks"]
    counter = "quant_launches" if quant else "launches"
    other = (DA.decode_attention.launches,
             getattr(DA.paged_decode_attention,
                     "launches" if quant else "quant_launches"))
    ms = (lambda e0, e1: e0.elapsed_time(e1)) if on_card else (
        lambda e0, e1: 0.0)
    blk_bytes = (ex._slab.slot_bytes if ex._slab is not None else 0)
    return {
        "mode": mode, "outputs": outputs, "ttft_s": ttfts,
        "paths": [[paths[tuple(p)] for p in prompts] for prompts in rounds],
        "chunks": chunks, "replays": ex.graph_replays - replays0,
        "launches": getattr(DA.paged_decode_attention, counter),
        "launches_want": cfg.n_layers * RING["chunk_tokens"] * chunks,
        "other_kernels": other,
        "same_graphs": ex._graphs is graphs and ex._state_ptrs() == ptrs,
        "host_blocks_cap": ex.host_cache_blocks,
        "slab_bytes": ex._slab.nbytes() if ex._slab is not None else 0,
        "slab_boot_ms": (ex._slab.boot_s * 1e3
                         if ex._slab is not None else 0.0),
        "slab_pinned": pinned,
        "block_bytes": blk_bytes,
        "demote_host_ms": [h * 1e3 for h, _, _, _ in demotes],
        "demote_device_ms": [ms(a, b) for _, a, b, _ in demotes],
        "promote_host_ms": [h * 1e3 for h, _, _, _ in promotes],
        "promote_device_ms": [ms(a, b) for _, a, b, _ in promotes],
        "promote_blocks": [n for _, _, _, n in promotes],
        "import_host_ms": [h * 1e3 for h, _, _, _ in imports],
        "cache_evictions": pool.stats["cache_evictions"],
        "host_promotions": pool.stats["host_promotions"],
        "host_demotions": pool.stats["host_demotions"],
        "kv_store_hits": batcher.stats["kv_store_hits"],
        "kv_store_probes": batcher.stats["kv_store_probes"],
        "store_bytes_written": (store.stats["bytes_written"]
                                if store is not None else 0),
        "store_spills": pool.stats["store_spills"],
        "store_put_drops": (store.stats["put_drops"]
                            if store is not None else 0),
        "store_puts": [(s, b) for s, b in puts],
        "store_fetch": fetches,
        "statusz": {k: statusz[k] for k in (
            "hostCacheBlocks", "hostHitRate", "promotedBlocks",
            "hostCacheEvictions", "kvStoreBlocks", "kvStoreBytes",
            "kvStoreHitRate", "kvStoreEvictions")},
    }


def _spill_after_restore(params, cfg) -> dict:
    """The two readings the host tier owed (PERF.md §7), on a bare
    executor of 3b's geometry: (a) does a spill that follows a restore
    still page-lock fresh host memory, or does PyTorch's caching host
    allocator hand it the blocks the restored spill gave back (spill ms
    and the allocator's counts, three spill/restore cycles of a
    528-token lane, 402,653,184 bytes on the bf16 pool); (b) what holds
    the host in the first restore: each restore runs while the other
    lane's dispatch is in flight, under
    ``torch.cuda.set_sync_debug_mode("warn")`` (which names every
    synchronizing call PyTorch makes), with its pieces timed by the host
    clock."""
    import torch

    from paddle_operator_tpu_torch.infer import executor as X

    with torch.inference_mode():
        return _spill_restore_cycles(X.RingExecutor(
            params, cfg, slots=2, max_len=RING["max_len"],
            chunk_tokens=RING["chunk_tokens"], paged=True,
            block_size=RING["block_size"], num_blocks=16), cfg)


def _spill_restore_cycles(ex, cfg) -> dict:
    """:func:`_spill_after_restore`'s three cycles on ``ex``."""
    import warnings

    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import executor as X

    ex.prewarm()
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, 512).tolist()
               for _ in range(2)]
    chunk = ex.chunk
    pos = {}

    def dispatch(wait=True):
        for s, p in pos.items():
            ex.pool.ensure(s, p + chunk)
        res = ex.replay(X.ExecPlan(1, [i in pos for i in range(ex.slots)],
                                   table=ex.pool.table))
        for s in pos:
            pos[s] += chunk
        if wait:
            res.host()
        return res

    for s, p in enumerate(prompts):
        _admit_cold(ex, s, p)
        pos[s] = len(p)
    dispatch()
    dispatch()
    stats = getattr(torch.cuda, "host_memory_stats", None)

    def host_allocs():
        st = stats() if stats is not None else {}
        return st.get("num_host_alloc", -1)

    pieces = {}

    def timed(name, fn):
        def wrapper(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            pieces.setdefault(name, []).append(
                (time.perf_counter() - t) * 1e3)
            return out
        return wrapper

    real = (X.to_device, ex._promote, ex.pool.ensure)
    X.to_device = timed("to_device", real[0])
    ex._promote = timed("promote scatter", real[1])
    ex.pool.ensure = timed("pool.ensure", real[2])
    cycles = []
    try:
        for _ in range(3):
            a0 = host_allocs()
            t = time.perf_counter()
            spill = ex.spill_lane(0)
            spill_ms = (time.perf_counter() - t) * 1e3
            a1 = host_allocs()
            nbytes = sum(v.numel() * v.element_size() for v in spill.values()
                         if isinstance(v, torch.Tensor))
            ex.pool.retire(0)
            del pos[0]
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            res = dispatch(wait=False)      # lane 1's dispatch in flight
            e1.record()
            pieces.clear()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                t = time.perf_counter()
                try:
                    ex.restore_lane(0, spill)
                finally:
                    restore_ms = (time.perf_counter() - t) * 1e3
                    torch.cuda.set_sync_debug_mode("default")
            done_at_return = e1.query()
            res.host()
            pos[0] = spill["pos"]
            del spill
            dispatch()
            cycles.append({
                "spill_ms": spill_ms, "spill_bytes": nbytes,
                "host_allocs_in_spill": a1 - a0 if a0 >= 0 else None,
                "restore_host_ms": restore_ms,
                "dispatch_in_flight_ms": e0.elapsed_time(e1),
                "dispatch_done_when_restore_returned": done_at_return,
                "restore_pieces_ms": {k: [round(x, 3) for x in v]
                                      for k, v in pieces.items()},
                "sync_warnings": sorted({str(w.message).splitlines()[0][:120]
                                         for w in caught}),
            })
    finally:
        X.to_device = real[0]
    # the lane-state write the restore and the admissions make, beside a
    # dispatch in flight: item assignment of a Python number against
    # fill_ (the lane's temperature is 0.0 already)
    writes = {"setitem": [], "fill_": []}
    for how in ("setitem", "fill_", "setitem", "fill_"):
        res = dispatch(wait=False)
        t = time.perf_counter()
        if how == "setitem":
            ex.temp[1] = 0.0
        else:
            ex.temp[1].fill_(0.0)
        writes[how].append((time.perf_counter() - t) * 1e3)
        res.host()
    return {"cycles": cycles, "scalar_write_ms": writes}


def _path(prompt, taken, suffix) -> str:
    """An admission's path from (prefill tokens, promoted blocks): a
    prefix hit (suffix-only forward; ``H`` when blocks came back from
    the host tier or the store, ``D`` when all were on the device) or a
    cold prefill ``C``."""
    prefill, promoted = taken
    if prefill == suffix:
        return "H" if promoted else "D"
    if prefill == len(prompt):
        return "C"
    return f"?{prefill}"


def phase_host_tier(reports: tuple, params, cfg, sizes=TIER) -> None:
    """Phase 3h: the host tier and the durable store on 3b's ring at full
    width (``params`` cut to TIER_LAYERS by the caller), bf16 and int8
    pools; see the module docstring."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    on_card = params.tok_embed.embedding.device.type == "cuda"
    rng = np.random.default_rng(11)
    v, n = cfg.vocab_size, sizes["prefixes"]
    prefixes = [rng.integers(0, v, sizes["prefix"]).tolist()
                for _ in range(n)]
    round1 = [p + rng.integers(0, v, sizes["suffix"]).tolist()
              for p in prefixes]
    round2 = [p + rng.integers(0, v, sizes["suffix"]).tolist()
              for p in prefixes][::-1]
    for report, kv_quant in zip(reports, ("none", "int8")):
        store_dir = tempfile.mkdtemp(prefix="chip-smoke-kvstore-")
        usage = shutil.disk_usage(store_dir)
        runs = {}
        try:
            for mode in TIER_RUNS:
                rounds = {"cold_ref": [round2], "store_a": [round1],
                          "store_b": [round2]}.get(mode, [round1, round2])
                runs[mode] = _tier_run(
                    params, cfg, kv_quant, mode, rounds, sizes=sizes,
                    store_dir=store_dir if mode.startswith("store") else None)
                gc.collect()
                if on_card:
                    torch.cuda.empty_cache()
        finally:
            shutil.rmtree(store_dir, ignore_errors=True)
        bad = []
        for mode, run in runs.items():
            if on_card and (run["launches"] != run["launches_want"]
                            or any(run["other_kernels"])
                            or run["replays"] != run["chunks"]
                            or not run["same_graphs"]):
                bad.append(f"{mode}: launches {run['launches']} (want "
                           f"{run['launches_want']}), other kernels "
                           f"{run['other_kernels']}, replays "
                           f"{run['replays']} of {run['chunks']} "
                           f"dispatches, prewarm graphs and addresses "
                           f"kept {run['same_graphs']}")
        r2 = {m: runs[m]["outputs"][-1] for m in runs if m != "store_a"}
        p2 = {m: [_path(p, t, len(p) - sizes["prefix"])
                  for p, t in zip(round2, runs[m]["paths"][-1])]
              for m in r2}
        r1 = [runs[m]["outputs"][0] for m in ("hit_ref", "off", "on",
                                               "store_a")]
        if any(r != r1[0] for r in r1):
            bad.append("round 1 (all cold) differs between runs")
        if set(p2["hit_ref"]) != {"D"} or runs["hit_ref"]["cache_evictions"]:
            bad.append(f"the hit reference did not hit every prefix on the "
                       f"device: {p2['hit_ref']}")
        if set(p2["cold_ref"]) != {"C"}:
            bad.append(f"the cold reference hit a prefix: {p2['cold_ref']}")
        for mode in ("off", "on", "store_b"):
            for i, path in enumerate(p2[mode]):
                ref = {"D": "hit_ref", "H": "hit_ref",
                       "C": "cold_ref"}.get(path)
                if ref is None or r2[mode][i] != r2[ref][i]:
                    bad.append(f"{mode} round-2 request {i} (path {path}) "
                               f"differs from its {ref} stream")
        on, sb = runs["on"], runs["store_b"]
        if not on["host_promotions"] >= 1:
            bad.append("no host promotion in the tier-on run")
        if not sb["kv_store_hits"] >= 1 or "H" not in p2["store_b"]:
            bad.append(f"no store hit after the restart ({sb['kv_store_hits']}"
                       f" hits, paths {p2['store_b']})")
        same3 = sum(r2["off"][i] == r2["on"][i] == r2["store_b"][i]
                    for i in range(n))
        counts = {m: {k: p2[m].count(k) for k in sorted(set(p2[m]))}
                  for m in p2}
        card = card_line() if on_card else "the CPU"
        dem = on["demote_device_ms"]
        blk = on["block_bytes"]
        prom = [ms / nb for ms, nb in zip(on["promote_device_ms"],
                                          on["promote_blocks"])]
        puts = runs["store_a"]["store_puts"]
        put_s = sum(s for s, _ in puts)
        fetch = sb["store_fetch"]
        tier = {
            "kv_quant": kv_quant, "paths_round2": counts,
            "equal_across_off_on_store": same3,
            "tier_blocks": on["host_blocks_cap"],
            "store_tier_blocks": sb["host_blocks_cap"],
            "slab_bytes": on["slab_bytes"], "slab_pinned": on["slab_pinned"],
            "slab_boot_ms": on["slab_boot_ms"],
            "block_bytes": blk, "demotes": len(dem),
            "demote_host_ms_p50": float(np.median(on["demote_host_ms"]))
            if dem else None,
            "demote_host_ms_max": max(on["demote_host_ms"]) if dem else None,
            "demote_device_ms_p50": float(np.median(dem)) if dem else None,
            "demote_gb_s": blk / float(np.median(dem)) / 1e6
            if dem and on_card else None,
            "promote_device_ms_per_block": prom,
            "round2_ttft_s": {m: runs[m]["ttft_s"][-1]
                              for m in ("off", "on", "store_b")},
            "round2_prefill_tokens": {
                m: [t[0] for t in runs[m]["paths"][-1]]
                for m in ("off", "on", "store_b")},
            "store_bytes_written": runs["store_a"]["store_bytes_written"],
            "store_spills": runs["store_a"]["store_spills"],
            "store_put_drops": runs["store_a"]["store_put_drops"],
            "store_files": len(puts),
            "store_write_gb_s": (sum(b for _, b in puts) / put_s / 1e9
                                 if put_s else None),
            "store_fetch_ms": [round(s * 1e3, 3) for s, _ in fetch],
            "store_import_host_ms": [round(x, 3)
                                     for x in sb["import_host_ms"]],
            "store_fetch_blocks": [b for _, b in fetch],
            "store_disk_free_gb_before": usage.free / 1e9,
            "statusz": {m: runs[m]["statusz"]
                        for m in ("off", "on", "store_a", "store_b")},
            "launches": {m: (runs[m]["launches"], runs[m]["launches_want"])
                         for m in runs},
        }
        log(f"host tier {kv_quant}: round-2 paths (D device hit, H host "
            f"or store hit, C cold) {counts}; {same3}/{n} round-2 streams "
            f"equal tier off / on / after the store restart, every stream "
            f"equal to its path's reference; tier {tier['tier_blocks']} "
            f"blocks (store leg {tier['store_tier_blocks']}), slab "
            f"{tier['slab_bytes']} bytes pinned={tier['slab_pinned']} in "
            f"{tier['slab_boot_ms']:.1f} ms; {len(dem)} demotes, host ms "
            f"p50 {tier['demote_host_ms_p50']} max "
            f"{tier['demote_host_ms_max']}, device ms p50 "
            f"{tier['demote_device_ms_p50']} ({tier['demote_gb_s']} GB/s "
            f"for {blk} bytes); promote device ms a block "
            f"{[round(x, 3) for x in prom]}; on {card}")
        log(f"host tier {kv_quant}: round-2 TTFT s, tier off "
            f"{[round(x, 3) for x in tier['round2_ttft_s']['off']]}; on "
            f"{[round(x, 3) for x in tier['round2_ttft_s']['on']]}; store "
            f"restart {[round(x, 3) for x in tier['round2_ttft_s']['store_b']]}"
            f"; prefill tokens off {tier['round2_prefill_tokens']['off']}, "
            f"on {tier['round2_prefill_tokens']['on']}, store restart "
            f"{tier['round2_prefill_tokens']['store_b']}")
        log(f"host tier {kv_quant}: the first store server offered "
            f"{tier['store_spills']} overflowing blocks, shed "
            f"{tier['store_put_drops']} (drop-oldest: a full slab takes "
            f"back a queued offer's slot) and wrote "
            f"{tier['store_bytes_written']} bytes in {tier['store_files']} "
            f"files "
            f"({tier['store_write_gb_s']} GB/s, write + fsync + rename; "
            f"{tier['store_disk_free_gb_before']:.1f} GB free before), "
            f"fetch ms {tier['store_fetch_ms']} for blocks "
            f"{tier['store_fetch_blocks']} (submit thread), the ring "
            f"thread's copy into the slab ms a block "
            f"{tier['store_import_host_ms']}; /statusz {tier['statusz']}; "
            f"launches (got, want) {tier['launches']}")
        if bad:
            raise AssertionError(f"3h {kv_quant}: {bad}")
        report["host_tier"] = tier
    if on_card:
        cyc = _spill_after_restore(params, cfg)
        gc.collect()
        torch.cuda.empty_cache()
        reports[0]["host_tier"]["spill_after_restore"] = cyc
        for i, c in enumerate(cyc["cycles"]):
            log(f"host tier: spill/restore cycle {i}: spill "
                f"{c['spill_ms']:.1f} ms for {c['spill_bytes']} bytes "
                f"(pinned allocations {c['host_allocs_in_spill']}); restore "
                f"held the host {c['restore_host_ms']:.1f} ms beside a "
                f"{c['dispatch_in_flight_ms']:.1f} ms dispatch in flight "
                f"(done when it returned: "
                f"{c['dispatch_done_when_restore_returned']}); pieces ms "
                f"{c['restore_pieces_ms']}; synchronizing calls "
                f"{c['sync_warnings']} on {card_line()}")
        log(f"host tier: a lane-state write beside a dispatch in flight, "
            f"host ms: tensor[i] = number {cyc['scalar_write_ms']['setitem']}"
            f", tensor[i].fill_(number) {cyc['scalar_write_ms']['fill_']} "
            f"on {card_line()}")


def expected_param_bytes(cfg, lm_head: bool) -> int:
    """``paramBytes`` of a weight-quantized model in the serving dtype,
    by shape arithmetic: one byte a code (int4 too) and four a scale for
    each quantized projection (the seven of every layer, and ``lm_head``
    under the legacy call), two a value for the embedding, the norms and
    an unquantized ``lm_head`` (bf16); an MoE layer's experts (two
    projections each) are quantized and its router stays bf16."""
    d, f, v, n_layers, hd = (cfg.dim, cfg.ffn_dim, cfg.vocab_size,
                             cfg.n_layers, cfg.head_dim)
    ffn_in, ffn_out = ((d, f), (f, d)) if cfg.n_experts > 0 \
        else ((d, d, f), (f, f, d))
    experts = max(cfg.n_experts, 1)
    ins = (d, d, d, cfg.n_heads * hd) + ffn_in * experts
    outs = (cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.n_kv_heads * hd,
            d) + ffn_out * experts
    quantized = n_layers * sum(i * o + 4 * o for i, o in zip(ins, outs))
    rest = 2 * (v * d + (2 * n_layers + 1) * d
                + n_layers * d * cfg.n_experts)
    return quantized + rest + (d * v + 4 * v if lm_head else 2 * d * v)


def _quantized_7b(environ: dict):
    """The 7b model cut to ``CUT_LAYERS`` as ``serve.main`` builds it
    under ``environ``: a fresh bf16 init from seed 0
    (``load_serving_params`` with no checkpoint) quantized by
    ``quantize_from_env`` (``environ`` empty: left bf16)."""
    import torch

    from paddle_operator_tpu_torch.infer import serve as S
    from paddle_operator_tpu_torch.models.llama import CONFIGS

    t0 = time.perf_counter()
    model, cfg, _ = S.load_serving_params(
        None, dataclasses.replace(CONFIGS["7b"], n_layers=CUT_LAYERS),
        "cuda")
    mode = S.quantize_from_env(model, cfg, environ)
    torch.cuda.synchronize()
    log(f"weight quant: 7b at {cfg.n_layers} layers {environ} -> {mode} "
        f"in {time.perf_counter() - t0:.1f}s (init and quantize)")
    return model, cfg


def _quant_short_run(model, cfg, mode: str, lm_head: bool) -> dict:
    """3b's server over ``model``: one cold 300-token prompt with 40 new
    tokens, then a follower of its first block (256 tokens) and 16 more
    (a 16-row suffix forward); both kernels' launches against the formula,
    ``/statusz``, ``paramBytes`` and the gauge."""
    import numpy as np

    from paddle_operator_tpu_torch.infer.serve import make_server
    from paddle_operator_tpu_torch.ops import quant_matmul as QM

    srv = make_server("127.0.0.1", 0, model, cfg, **dict(RING, prewarm=True))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    batcher = srv.generator.batcher
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, cfg.vocab_size, 300).tolist()
    follower = prompt[:256] + rng.integers(0, cfg.vocab_size, 16).tolist()
    try:
        if not batcher.prewarmed.wait(600):
            raise AssertionError("the ring's graphs were not captured")
        c0 = batcher.stats["chunks"]
        _zero_launches()
        outs = [_post(base, {"tokens": [p], "max_new_tokens": 40})
                for p in (prompt, follower)]
        with urllib.request.urlopen(base + "/statusz", timeout=60) as r:
            statusz = json.loads(r.read())
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            gauge = next(ln for ln in r.read().decode().splitlines()
                         if ln.startswith("tpujob_serve_weight_quant_mode{"))
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
        srv.generator.close()
    ticks = RING["chunk_tokens"] * (batcher.stats["chunks"] - c0)
    # the cold prompt at its length, the follower's 16-row suffix bucket
    want = qmm_launches_want(cfg, ticks, [len(prompt), 16], lm_head)
    got = (QM.quant_matmul.launches, QM.quant_gemm.launches)
    for p, (code, body, _) in zip((prompt, follower), outs):
        if code != 200:
            raise AssertionError(f"weight quant {mode}: HTTP {code}")
        _check_rows(cfg, p, body["tokens"][0], 40, f"weight quant {mode}")
    run = {"mode": mode, "lm_head": lm_head, "launches": got,
           "want": want, "statusz_mode": statusz["weightQuantMode"],
           "param_bytes": statusz["paramBytes"],
           "expected_param_bytes": expected_param_bytes(cfg, lm_head),
           "gauge": gauge}
    log(f"weight quant short run: {json.dumps(run)}")
    if got != want or statusz["weightQuantMode"] != mode \
            or f'mode="{mode}"' not in gauge or not gauge.endswith(" 1.0") \
            or run["param_bytes"] != run["expected_param_bytes"]:
        raise AssertionError(f"weight quant {mode} short run: {run}")
    return run


@contextlib.contextmanager
def _plain_route():
    """Every quantized projection through the formula (the JAX package's
    ``x @ q.to(dtype) * s``), neither int8-weight kernel launched: the
    phases' own comparison route, patched in for a block, not a switch of
    the package, wherever a projection looks ``quant_mm`` up (the
    projections' ``quant_matmul.dense_mm``, ``decode``'s experts,
    ``llama.Dense``)."""
    from unittest import mock

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.models import llama
    from paddle_operator_tpu_torch.ops import quant_matmul as QM

    plain = QM.quant_matmul_reference
    with mock.patch.object(D, "quant_mm", plain), \
            mock.patch.object(QM, "quant_mm", plain), \
            mock.patch.object(llama, "quant_mm", plain):
        yield


@contextlib.contextmanager
def _formula_above(rows: int):
    """Projections of at most ``rows`` rows through kernel A, more rows
    through the formula: the route of the port before kernel B (16 rows),
    patched in for a block as :func:`_plain_route` is."""
    from unittest import mock

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.models import llama
    from paddle_operator_tpu_torch.ops import quant_matmul as QM

    def route(x, q, s):
        if x.numel() // x.shape[-1] <= rows:
            return QM.quant_matmul(x, q, s)
        return QM.quant_matmul_reference(x, q, s)

    with mock.patch.object(D, "quant_mm", route), \
            mock.patch.object(QM, "quant_mm", route), \
            mock.patch.object(llama, "quant_mm", route):
        yield


def _chunk_ms_turns(rings: dict, turns, prompts, dispatches: int) -> dict:
    """Device ms of one ring dispatch (a chunk of 8 ticks, every lane
    live, a CUDA graph replay) of each ring in ``rings`` (name -> (model,
    cfg, route)), timed in ``turns`` on executors admitted alike: CUDA
    events around ``dispatches`` back-to-back replays."""
    import torch

    from paddle_operator_tpu_torch.infer import executor as X

    exs = {}
    with torch.inference_mode():
        for name, (model, cfg, route) in rings.items():
            with (route() if route else contextlib.nullcontext()):
                ex = X.RingExecutor(model, cfg, slots=RING["slots"],
                                    max_len=1024,
                                    chunk_tokens=RING["chunk_tokens"],
                                    paged=True,
                                    block_size=RING["block_size"])
                ex.prewarm()
                for slot, p in enumerate(prompts):
                    _admit_cold(ex, slot, p)
            exs[name] = [ex, len(prompts[0])]
        out = {name: [] for name in rings}
        for name in turns:
            ms, exs[name][1], _ = _time_dispatches(*exs[name], dispatches)
            out[name].append(ms)
    return out


def _time_dispatches(ex, fill: int, dispatches: int,
                     n_steps: int = 1) -> tuple:
    """(device ms a CHUNK over ``dispatches`` graph replays of every lane
    after a warm one, each ``n_steps`` fused chunks; the lanes' fill
    after them; the warm dispatch's tokens on the host)."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import executor as X

    slots, chunk = RING["slots"], RING["chunk_tokens"]
    plans = []
    for _ in range(dispatches + 1):
        for slot in range(slots):
            ex.pool.ensure(slot, fill + n_steps * chunk)
        plans.append(X.ExecPlan(n_steps, [True] * slots, table=ex.pool.table,
                                eos=np.full(slots, -1, np.int32),
                                left=np.full(slots, 1 << 20, np.int32),
                                steps=np.full(slots, n_steps, np.int32)))
        fill += n_steps * chunk
    warm = ex.replay(plans[0]).host()[0]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for plan in plans[1:]:
        ex.replay(plan)
    end.record()
    end.synchronize()
    return (start.elapsed_time(end) / (dispatches * n_steps), fill,
            np.array(warm))


# phase 3i's long prompt: one prefill of this many tokens (kernel B's
# rows; 2048 is the 7b config's max_seq_len)
PREFILL_LONG = 2048


def _prefill_ms(model, cfg, prompts, route=None) -> tuple:
    """(device ms of prefilling ``prompts`` one after another, as cold
    admissions forward them — ``decode.prefill`` of [1, n] — after a warm
    one; the host's ms to queue that work, which is below the device's
    only when the host keeps ahead of the card; each int8-weight kernel's
    launches over the timed prefills)."""
    import torch

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.ops import quant_matmul as QM

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with (route() if route else contextlib.nullcontext()), \
            torch.inference_mode():
        D.prefill(model, cfg, prompts[0], prompts[0].shape[1])
        torch.cuda.synchronize()
        n0 = (QM.quant_matmul.launches, QM.quant_gemm.launches)
        t0 = time.perf_counter()
        start.record()
        for p in prompts:
            D.prefill(model, cfg, p, p.shape[1])
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
    return start.elapsed_time(end), host_ms, (
        QM.quant_matmul.launches - n0[0], QM.quant_gemm.launches - n0[1])


def phase_weight_quant_ring(report: dict, report_b: dict) -> None:
    """Phase 3i: the weight-quantized 7b replica, cut to ``CUT_LAYERS``;
    see the module docstring (``report``: kernel A's, ``report_b``:
    kernel B's)."""
    import gc as _gc

    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.infer import quant as Q
    from paddle_operator_tpu_torch.ops import quant_matmul as QM

    qmodel, qcfg = _quantized_7b({"SERVE_WEIGHT_QUANT": "int8"})
    # the same init unquantized: the bf16 model the readings compare with
    params, cfg = _quantized_7b({})
    want_bytes = expected_param_bytes(qcfg, False)
    got_bytes = Q.param_bytes(qmodel)
    log(f"weight quant int8: paramBytes {got_bytes} (expected "
        f"{want_bytes}; bf16 model {Q.param_bytes(params)})")
    if got_bytes != want_bytes or Q.weight_quant_mode(qmodel) != "int8":
        raise AssertionError("the int8 model's paramBytes or mode")
    wq = {"mode": "int8", "param_bytes": want_bytes, "lm_head": False}
    runs = {}
    for kv in ("none", "int8"):
        r = {}
        phase_ring_main_path(r, qmodel, qcfg, kv, wquant=wq)
        runs[kv] = r["ring"]
        if kv == "none":
            report["launches"] = QM.quant_matmul.launches
            report_b["launches"] = QM.quant_gemm.launches
        _gc.collect()
        torch.cuda.empty_cache()

    # the max logit gap against the bf16 model on one prompt (prefill and
    # 8 decode steps through kernel A): reported
    prompt = torch.as_tensor(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (1, 64)), dtype=torch.int32, device="cuda")
    gap = 0.0
    with torch.inference_mode():
        lb, cb = D.prefill(params, cfg, prompt, 256)
        lq, cq = D.prefill(qmodel, qcfg, prompt, 256)
        gap = float((lb - lq).abs().max())
        tok = lb.argmax(-1).to(torch.int32)
        for _ in range(8):
            lb, cb = D.decode_step(params, cfg, tok, cb)
            lq, cq = D.decode_step(qmodel, qcfg, tok, cq)
            gap = max(gap, float((lb - lq).abs().max()))
            tok = lb.argmax(-1).to(torch.int32)
    del cb, cq
    log(f"weight quant int8: max |logit gap| against the bf16 model, one "
        f"64-token prompt and 8 steps: {gap:.4f} (not gated)")

    # one chunk as a graph: the int8 model through the kernel, through
    # the formula, and the bf16 model, in turns
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, 512).tolist()
               for _ in range(RING["slots"])]
    chunk = _chunk_ms_turns(
        {"kernel": (qmodel, qcfg, None), "plain": (qmodel, qcfg, _plain_route),
         "bf16": (params, cfg, None)},
        ("kernel", "plain", "bf16", "bf16", "plain", "kernel"), prompts, 6)
    log(f"weight quant int8: ring chunk (8 lanes x 8 ticks, fill 520-632, "
        f"graph replay) device ms: kernel {chunk['kernel']}, plain route "
        f"{chunk['plain']}, bf16 model {chunk['bf16']} on {card_line()}")

    # a quantized prefill, through the kernels (kernel B), through the
    # plain route and on the bf16 model, in turns: 8 cold 512-token
    # prompts one by one (3b's burst admits 8 cold prompts), then one
    # 2048-token prompt (a long prompt's TTFT, where the host keeps ahead
    # of the card)
    prompts = [torch.as_tensor([p], dtype=torch.int32, device="cuda")
               for p in prompts]
    long_prompt = [torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (1, PREFILL_LONG)), dtype=torch.int32,
        device="cuda")]
    prefill = {}
    for label, batch in (("8 x 512", prompts),
                         (f"1 x {PREFILL_LONG}", long_prompt)):
        got = {"kernel": [], "plain": [], "bf16": [], "host_ms": {
            "kernel": [], "plain": [], "bf16": []}}
        for name in ("kernel", "plain", "bf16", "bf16", "plain", "kernel"):
            model, mcfg, route = {"kernel": (qmodel, qcfg, None),
                                  "plain": (qmodel, qcfg, _plain_route),
                                  "bf16": (params, cfg, None)}[name]
            ms, host_ms, n = _prefill_ms(model, mcfg, batch, route)
            got[name].append(ms)
            got["host_ms"][name].append(host_ms)
            if name == "kernel":
                got["launches"] = n
            elif n != (0, 0):
                raise AssertionError(f"the {name} prefill launched the "
                                     f"int8-weight kernels {n} times")
        want = (0, 7 * cfg.n_layers * len(batch))
        log(f"weight quant int8: prefill of {label}-token prompts one by "
            f"one, device ms: kernels {got['kernel']}, plain route "
            f"{got['plain']}, bf16 model {got['bf16']}; host ms to queue "
            f"them {json.dumps(got['host_ms'])}; (kernel A, kernel B) "
            f"launches {got['launches']} (expected {want}) on "
            f"{card_line()}")
        if got["launches"] != want:
            raise AssertionError(f"the quantized prefill launched "
                                 f"{got['launches']}, expected {want}")
        prefill[label] = got
    del qmodel, params
    _gc.collect()
    torch.cuda.empty_cache()

    short = []
    for env, mode, head in (({"SERVE_WEIGHT_QUANT": "int4"}, "int4", False),
                            ({"QUANTIZE": "int8"}, "int8", True)):
        model, mcfg = _quantized_7b(env)
        short.append(_quant_short_run(model, mcfg, mode, head))
        del model
        _gc.collect()
        torch.cuda.empty_cache()
    report["ring"] = {"bf16_pool": runs["none"], "int8_pool": runs["int8"],
                      "chunk_device_ms": chunk, "logit_gap": gap,
                      "param_bytes": want_bytes, "short_runs": short}
    report_b["prefill"] = prefill


# phase 3j: 3b's ring with `residents` streams of `resident_prompt`-token
# prompts and `resident_new` new tokens; once every resident has decoded
# `chunks_first` chunks, `long` cold prompts of `long_prompt` tokens with
# `long_new` new tokens arrive.  Each pool is served inline and with
# SERVE_PREFILL=chunked at SERVE_PREFILL_CHUNK=256 (one block a slice);
# the bf16 pool also with SERVE_PREFILL_CHUNK unset (the default, 64).
INTERLEAVE = dict(residents=6, resident_prompt=64, resident_new=256,
                  long=2, long_prompt=1536, long_new=64, chunks_first=2)
# the longest wait for the residents to decode before the long prompts
INTERLEAVE_WAIT_S = 600
INTERLEAVE_RUNS = (("none", "inline", None), ("none", "chunked", 256),
                   ("none", "chunked", None), ("int8", "inline", None),
                   ("int8", "chunked", 256))


def _interleave_run(params, cfg, kv_quant: str, mode: str,
                    chunk_env, extra_env=None, ring_extra=None,
                    wait_all: bool = True) -> dict:
    """One run of phase 3j's traffic on a fresh 3b server (``kv_quant``
    pool, ``SERVE_PREFILL`` ``mode``, ``SERVE_PREFILL_CHUNK``
    ``chunk_env`` or unset, and ``extra_env``'s other SERVE_PREFILL_*
    knobs; ``ring_extra``: ring arguments beside them, 3o's remote
    client): every request's tokens, the residents' token gaps,
    the long prompts' TTFT, each admission's and each slice's hold of
    the ring thread (host clock) and device time (CUDA events around the
    work it queued), the launches and replays, and the pool's
    accounting.  The ring thread's CPU time (``time.thread_time``) beside
    each hold tells work from waiting, and the first three slices run
    under ``torch.cuda.set_sync_debug_mode("warn")``, which names every
    synchronizing call PyTorch makes.  A disaggregated ring (3o) also
    gives each handoff item's hold of the ring thread, the prefill
    engine's dispatches' device ms (CUDA events on the engine's stream),
    its handoff counters and the run's peak allocated bytes.

    ``wait_all`` False (3o's remote run, whose handoffs may come in
    slower than a resident decodes): the long prompts go once every
    resident has decoded ``chunks_first`` chunks OR resolved, and the
    run records the most residents ever decoding at once
    (``residents_overlap_max``) and how many had resolved before the
    long prompts arrived (``residents_done_before_long``)."""
    import warnings

    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer.serve import (
        make_server,
        ring_kw_from_env,
    )
    from paddle_operator_tpu_torch.ops import decode_attention as DA

    quant = kv_quant != "none"
    env = {"SERVE_PREFILL": mode}
    if chunk_env:
        env["SERVE_PREFILL_CHUNK"] = str(chunk_env)
    env.update(extra_env or {})
    prefill_kw = {k: v for k, v in ring_kw_from_env(env).items()
                  if k.startswith("prefill_")}
    kw = dict(RING, prewarm=True, **prefill_kw, **(ring_extra or {}))
    if quant:
        kw["kv_quant"] = kv_quant
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    srv = make_server("127.0.0.1", 0, params, cfg, **kw)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    batcher = srv.generator.batcher
    ex = batcher.executor
    if not batcher.prewarmed.wait(600) or ex.needs_capture:
        raise AssertionError(f"3j: the ring's CUDA graphs were not captured "
                             f"at prewarm: {batcher.prewarm_error!r}")
    graphs = ex._graphs
    ptrs = ex._state_ptrs()
    counter = "quant_launches" if quant else "launches"
    marks = []          # (host clock, what) of dispatches and prefill work
    holds = {"admit": [], "slice": [], "handoff": []}
    real_replay = ex.replay

    def replay(plan):
        marks.append((time.perf_counter(), "dispatch"))
        return real_replay(plan)

    syncs = []          # the first slices' synchronizing calls, if any

    def timed(name, real):
        def run(*a):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            watch = name == "slice" and len(holds[name]) < 3
            with warnings.catch_warnings(record=True) as caught:
                if watch:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                c0, t0 = time.thread_time(), time.perf_counter()
                e0.record()
                try:
                    out = real(*a)
                finally:
                    e1.record()
                    t1, c1 = time.perf_counter(), time.thread_time()
                    if watch:
                        torch.cuda.set_sync_debug_mode("default")
            if watch:
                syncs.extend(str(w.message).splitlines()[0][:160]
                             for w in caught)
            marks.append((t0, name))
            holds[name].append((t1 - t0, e0, e1, c1 - c0))
            return out
        return run

    ex.replay = replay
    batcher._admit = timed("admit", batcher._admit)
    batcher._advance_prefill = timed("slice", batcher._advance_prefill)
    batcher._land_item = timed("handoff", batcher._land_item)
    engine = []         # (dispatch, start event, end event) on its stream
    pe = ex.prefill_exec
    if pe is not None and not ex.prefill_remote:
        def on_engine(what, real):
            def run(*a, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = real(*a, **k)
                e1.record()
                engine.append((what, e0, e1))
                return out
            return run
        if pe.lanes > 1:
            pe._slice_prog = on_engine("slice", pe._slice_prog)
            pe._final_prog = on_engine("final", pe._final_prog)
        else:
            pe._progs = {b: on_engine("prefill", prog)
                         for b, prog in pe._progs.items()}
    rng = np.random.default_rng(11)
    cfg_i = INTERLEAVE
    residents = [rng.integers(0, cfg.vocab_size,
                              cfg_i["resident_prompt"]).tolist()
                 for _ in range(cfg_i["residents"])]
    longs = [rng.integers(0, cfg.vocab_size, cfg_i["long_prompt"]).tolist()
             for _ in range(cfg_i["long"])]
    results, errors = {}, []

    def send(kind, i, p, new):
        try:
            results[kind, i] = _stream_timed(
                base, {"tokens": [p], "max_new_tokens": new})
        except Exception as e:              # surfaced after the join
            errors.append(f"{kind} {i}: {e!r}")

    try:
        free0 = batcher.pool.blocks_free()
        stats0 = dict(batcher.stats)
        replays0 = ex.graph_replays
        _zero_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=send, args=(
            "resident", i, p, cfg_i["resident_new"]))
            for i, p in enumerate(residents)]
        for t in threads:
            t.start()
        want_pos = (cfg_i["resident_prompt"]
                    + cfg_i["chunks_first"] * RING["chunk_tokens"])
        overlap_max = 0
        while True:
            # residents decoding: a lane past its prefill and handoff
            live = [s for s, r in enumerate(batcher.lane)
                    if r is not None and s not in batcher._prefilling
                    and s not in batcher._disagg_waiting]
            overlap_max = max(overlap_max, len(live))
            past = sum(batcher._lane_pos[s] >= want_pos for s in live)
            if past + (0 if wait_all else len(results)) \
                    == cfg_i["residents"]:
                break
            if (errors or (results and wait_all)
                    or time.perf_counter() - t0 > INTERLEAVE_WAIT_S):
                # a resident that resolved already cannot be waited for
                raise AssertionError(
                    f"3j: the residents never all decoded "
                    f"{cfg_i['chunks_first']} chunks: {errors}; resolved "
                    f"{ {k: str(v)[:400] for k, v in results.items()} }; "
                    f"ring stats {batcher.stats}; flight recorder "
                    f"{str(batcher.flightrec.dump('3j'))[-1500:]}")
            time.sleep(0.002)
        done_before_long = len(results)
        t_long = time.perf_counter()
        late = [threading.Thread(target=send, args=(
            "long", i, p, cfg_i["long_new"])) for i, p in enumerate(longs)]
        for t in late:
            t.start()
        for t in threads + late:
            t.join()
        wall_s = time.perf_counter() - t0
        with urllib.request.urlopen(base + "/statusz", timeout=60) as r:
            statusz = json.loads(r.read())
        torch.cuda.synchronize()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
        srv.generator.close()
    peak = torch.cuda.max_memory_allocated()
    if errors:
        raise AssertionError(f"3j requests failed: {errors}")
    out, gaps, gaps_during, ttft = {}, [], [], []
    for (kind, i), (code, events, times, t_send) in sorted(results.items()):
        p = (residents if kind == "resident" else longs)[i]
        new = cfg_i["resident_new" if kind == "resident" else "long_new"]
        toks = [e["token"] for e in events if "token" in e]
        done = events[-1]
        if code != 200 or not done.get("done") or len(toks) != new \
                or done["tokens"] != p + toks:
            raise AssertionError(f"3j {kind} {i}: HTTP {code}, {len(toks)} "
                                 f"token events, last {str(done)[:200]}")
        _check_rows(cfg, p, done["tokens"], new, f"3j {kind} {i}")
        out[kind, i] = done["tokens"]
        tt = [t for t, e in zip(times, events) if "token" in e]
        if kind == "resident":
            gaps += [b - a for a, b in zip(tt, tt[1:])]
        else:
            ttft.append(tt[0] - t_send)
    # the residents' gaps while the long prompts admit: from their
    # arrival until both emitted their first token
    t_first = t_long + max(ttft)
    for (kind, i), (_, events, times, _) in results.items():
        if kind == "resident":
            tt = [t for t, e in zip(times, events) if "token" in e]
            gaps_during += [b - a for a, b in zip(tt, tt[1:])
                            if b > t_long and a < t_first]
    pool = batcher.pool
    pool.check_invariant()
    chunks = batcher.stats["chunks"] - stats0["chunks"]
    launches = getattr(DA.paged_decode_attention, counter)
    ticks = [t for t, what in marks if what == "dispatch"]
    waits = sorted(zip(np.diff(ticks), ticks), reverse=True)[:3]
    stalls = [(round((a - t0) * 1e3, 1), round(float(w) * 1e3, 1),
               sum(1 for t, what in marks if what != "dispatch"
                   and a <= t < a + w)) for w, a in waits]

    def ms(name):
        return ([h * 1e3 for h, _, _, _ in holds[name]],
                [e0.elapsed_time(e1) for _, e0, e1, _ in holds[name]],
                [c * 1e3 for _, _, _, c in holds[name]])

    admit_host, admit_dev, admit_cpu = ms("admit")
    slice_host, slice_dev, slice_cpu = ms("slice")
    hand_host, _, hand_cpu = ms("handoff")
    gaps, gaps_during = np.asarray(gaps), np.asarray(gaps_during or [0.0])
    prompt_tokens = (cfg_i["residents"] * cfg_i["resident_prompt"]
                     + cfg_i["long"] * cfg_i["long_prompt"])
    return {
        "kv_quant": kv_quant, "mode": mode,
        "chunk_rows": ex.prefill_chunk if mode == "chunked" else None,
        "outputs": out, "wall_s": wall_s, "chunks": chunks,
        "replays": ex.graph_replays - replays0,
        "same_graphs": ex._graphs is graphs and ex._state_ptrs() == ptrs,
        "launches": launches,
        "launches_want": cfg.n_layers * RING["chunk_tokens"] * chunks,
        "other_kernels": (DA.decode_attention.launches,
                          getattr(DA.paged_decode_attention,
                                  "launches" if quant else "quant_launches")),
        "chunked_tokens": (batcher.stats["chunked_prefill_tokens"]
                           - stats0["chunked_prefill_tokens"]),
        "chunked_want": prompt_tokens if mode == "chunked" else 0,
        "prefill_tokens": (batcher.stats["prefill_tokens"]
                           - stats0["prefill_tokens"]),
        "token_share": statusz["chunkedPrefillTokenShare"],
        "queue_depth_end": statusz["prefillQueueDepth"],
        "free_before": free0, "free_after": statusz["kvBlocksFree"],
        "cached_after": pool.blocks_cached(),
        "resident_gap_max_ms": float(gaps.max()) * 1e3,
        "resident_gap_p95_ms": float(np.percentile(gaps, 95)) * 1e3,
        "resident_gap_max_during_ms": float(gaps_during.max()) * 1e3,
        "resident_gap_p95_during_ms": float(
            np.percentile(gaps_during, 95)) * 1e3,
        "long_ttft_s": ttft,
        "admit_host_ms": admit_host, "admit_device_ms": admit_dev,
        "admit_cpu_ms": admit_cpu,
        "slice_host_ms": slice_host, "slice_device_ms": slice_dev,
        "slice_cpu_ms": slice_cpu, "slice_syncs": syncs,
        "dispatch_interval_median_ms": float(np.median(np.diff(ticks)))
        * 1e3,
        "longest_intervals": stalls,
        "handoff_host_ms": hand_host, "handoff_cpu_ms": hand_cpu,
        "engine_ms": [(what, e0.elapsed_time(e1))
                      for what, e0, e1 in engine],
        "engine_lanes": (ex.prefill_lanes if pe is not None else 0),
        "disagg": {k: batcher.stats[k] - stats0[k] for k in (
            "disagg_prefills", "remote_prefills", "handoff_frames",
            "overlapped_frames")},
        "peak_gb": peak / 1e9,
        "residents_overlap_max": overlap_max,
        "residents_done_before_long": done_before_long,
    }


def _slice_timings(params, cfg) -> dict:
    """One intermediate slice alone, at 3j's geometry (7b, a lane of the
    64-block pool at rows [512, 512 + rows) of a 1,536-token prompt), on
    each pool at 64 and 256 rows: device ms from CUDA-graph replay, eager
    ms from calls issued one by one (what the ring thread pays), beside
    the bound (the weights streamed once: the bytes bound it)."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import executor as X

    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    out = {}
    for kv_quant in ("none", "int8"):
        with torch.inference_mode():
            ex = X.RingExecutor(
                params, cfg, slots=RING["slots"], max_len=RING["max_len"],
                chunk_tokens=RING["chunk_tokens"], paged=True,
                block_size=RING["block_size"], kv_quant=kv_quant)
            prompt = np.random.default_rng(5).integers(
                0, cfg.vocab_size, INTERLEAVE["long_prompt"]).tolist()
            ex.pool.admit(0, prompt)
            row = X.to_device(ex.pool.table[0], ex.device, torch.int32)
            for rows in (64, 256):
                ex.prefill_chunk = rows
                prog = ex.chunk_prog(None)
                toks = X.to_device(np.asarray([prompt[512:512 + rows]],
                                              np.int32), ex.device)
                tail = (0,) if kv_quant == "int8" else ()
                dev, eager = time_ms(
                    lambda i: prog(params, ex.cache, row, toks, 512,
                                   512 + rows, *tail), iters=4, warmup=2)
                bound = max(weight_bytes / HBM_BYTES_PER_S,
                            2 * cfg.num_params() * rows / PEAK_BF16) * 1e3
                out[f"{kv_quant}@{rows}"] = {"ms": dev, "eager_ms": eager,
                                             "bound_ms": bound}
            del ex
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _spread(xs) -> str:
    """min / median / max of a list of ms readings."""
    import numpy as np

    if not len(xs):
        return "-"
    return (f"{min(xs):.3f} / {float(np.median(xs)):.3f} / "
            f"{max(xs):.3f}")


def phase_interleave(reports: tuple, params, cfg) -> dict:
    """Phase 3j: long prompts admitted while residents decode, inline
    against chunked prefill, on the bf16 and int8 pools; see the module
    docstring.  Returns the runs by (pool, mode, slice rows): 3o reuses
    the chunked@256 ones."""
    import torch

    runs = {}
    for kv_quant, mode, chunk_env in INTERLEAVE_RUNS:
        run = _interleave_run(params, cfg, kv_quant, mode, chunk_env)
        rows = run["chunk_rows"]
        runs[kv_quant, mode, rows] = run
        gc.collect()
        torch.cuda.empty_cache()
        name = ("paged_decode_attention_quant" if kv_quant == "int8"
                else "paged_decode_attention")
        tag = f"{mode}" + (f"@{rows}" if rows else "")
        log(f"interleave {kv_quant} {tag}: residents' token gap max "
            f"{run['resident_gap_max_ms']:.1f} ms, p95 "
            f"{run['resident_gap_p95_ms']:.1f} ms (while the long prompts "
            f"admit: max {run['resident_gap_max_during_ms']:.1f}, p95 "
            f"{run['resident_gap_p95_during_ms']:.1f}); long prompts' TTFT "
            f"s {[round(x, 3) for x in run['long_ttft_s']]}; admissions' "
            f"ring-thread hold ms min/median/max "
            f"{_spread(run['admit_host_ms'])}, its thread's CPU "
            f"{_spread(run['admit_cpu_ms'])}, device "
            f"{_spread(run['admit_device_ms'])}; slices "
            f"{len(run['slice_host_ms'])}, hold "
            f"{_spread(run['slice_host_ms'])}, CPU "
            f"{_spread(run['slice_cpu_ms'])}, device "
            f"{_spread(run['slice_device_ms'])}, synchronizing calls in "
            f"the first 3 {run['slice_syncs']}; median interval between "
            f"dispatches {run['dispatch_interval_median_ms']:.1f} ms, "
            f"longest (start ms, ms, prefill calls in it) "
            f"{run['longest_intervals']}; {name} launches "
            f"{run['launches']} (n_layers x chunk x dispatches "
            f"{run['launches_want']}), other decode kernels "
            f"{run['other_kernels']}, replays {run['replays']} for "
            f"{run['chunks']} dispatches; chunked prefill tokens "
            f"{run['chunked_tokens']} of {run['prefill_tokens']} "
            f"(share {run['token_share']}); wall {run['wall_s']:.3f} s on "
            f"{card_line()}")
        bad = []
        if run["launches"] != run["launches_want"] \
                or any(run["other_kernels"]):
            bad.append("launch counts")
        if run["replays"] != run["chunks"] or not run["same_graphs"]:
            bad.append("not every dispatch a replay of the prewarm graphs "
                       "at their addresses")
        if run["chunked_tokens"] != run["chunked_want"] \
                or run["queue_depth_end"]:
            bad.append(f"chunked prefill tokens {run['chunked_tokens']} "
                       f"(want {run['chunked_want']}), queue depth "
                       f"{run['queue_depth_end']}")
        if run["free_after"] + run["cached_after"] != run["free_before"]:
            bad.append("blocks neither free nor cached at the end")
        if mode == "chunked" and not run["slice_host_ms"]:
            bad.append("no slice ran")
        if bad:
            raise AssertionError(f"3j {kv_quant} {tag}: {bad}")
    alone = _slice_timings(params, cfg)
    log(f"interleave: one intermediate slice alone (rows 512.. of a "
        f"1,536-token lane), device ms (graph) / eager ms / bound ms: "
        + "; ".join(f"{k} {v['ms']:.3f} / {v['eager_ms']:.3f} / "
                    f"{v['bound_ms']:.3f}" for k, v in alone.items())
        + f" on {card_line()}")
    for report, kv_quant in zip(reports, ("none", "int8")):
        inline = runs[kv_quant, "inline", None]
        report["interleave"] = {"slice_alone": {
            k: v for k, v in alone.items() if k.startswith(kv_quant)}}
        for (kq, mode, rows), run in runs.items():
            if kq != kv_quant:
                continue
            same = sum(run["outputs"][k] == inline["outputs"][k]
                       for k in inline["outputs"])
            run["equal_to_inline"] = f"{same}/{len(inline['outputs'])}"
            if mode == "chunked":
                log(f"interleave {kv_quant} chunked@{rows}: streams equal "
                    f"to inline's {run['equal_to_inline']} (not gated: a "
                    "slice and a whole-prompt prefill round differently "
                    "in bf16)")
            report["interleave"][f"{mode}@{rows}" if rows else mode] = {
                key: v for key, v in run.items() if key != "outputs"}
    return runs


# phase 3o: disaggregated prefill at 7b, full width and depth.  (a) 3b's
# burst through the in-process 1-lane engine, held to 3b's streams bit
# for bit; (b) 3j's traffic under chunked@256 (3j's own run when 3j ran
# in this call), the 1-lane engine, and the 4-lane engine with streamed
# frames, on both pools; (c) the same traffic on the bf16 pool against a
# prefill pod started as a subprocess on the same card (4 lanes, frames
# streamed), with one whole-envelope POST timed on the wire; (d) the
# handoff copy alone.
DISAGG_CHUNK = 256
DISAGG_RUNS = (("disagg", {}),
               ("disagg", {"SERVE_PREFILL_LANES": "4",
                           "SERVE_PREFILL_STREAM": "1"}))


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _log_tail(logf, n: int = 3000) -> str:
    logf.seek(0)
    return logf.read()[-n:].decode(errors="replace")


def _start_prefill_pod(lanes: int):
    """A prefill pod as the operator starts one, on this card: ``python
    -m paddle_operator_tpu_torch.infer.prefill_serve`` (7b from seed 0:
    the weights :func:`make_7b` builds), ``lanes`` engine lanes.  Returns
    (process, endpoint, its output file, seconds to ready)."""
    import tempfile

    port = _free_port()
    env = dict(os.environ, MODEL_PRESET="7b", TPUJOB_PORT=str(port),
               SERVE_BLOCK_SIZE=str(RING["block_size"]),
               SERVE_MAX_LEN=str(RING["max_len"]),
               SERVE_PREFILL_LANES=str(lanes),
               SERVE_PREFILL_CHUNK=str(DISAGG_CHUNK),
               PYTHONPATH=str(ROOT))
    env.pop("TPUJOB_CHECKPOINT_PATH", None)
    logf = tempfile.TemporaryFile()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_operator_tpu_torch.infer.prefill_serve"],
        cwd=str(ROOT), env=env, stdout=logf, stderr=subprocess.STDOUT)
    ep = f"127.0.0.1:{port}"
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"3o: the prefill pod exited with "
                                 f"{proc.returncode}: {_log_tail(logf)}")
        try:
            with urllib.request.urlopen(f"http://{ep}/readyz",
                                        timeout=5) as r:
                if r.status == 200:
                    break
        except (urllib.error.URLError, OSError):
            pass
        if time.perf_counter() - t0 > 300:
            proc.kill()
            proc.wait()
            raise AssertionError(f"3o: the prefill pod was not ready in "
                                 f"300 s: {_log_tail(logf)}")
        time.sleep(0.5)
    return proc, ep, logf, time.perf_counter() - t0


def _stop_prefill_pod(proc):
    """SIGTERM (the pod drains and exits EXIT_PREEMPTED, 83); killed if
    it has not exited within 60 s.  Returns its exit code (None:
    killed)."""
    proc.terminate()
    try:
        return proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        return None


def _wire_reading(ep: str, prompt, fingerprint) -> dict:
    """One whole-envelope POST of ``prompt`` to the pod: the response
    headers leave after the prefill and the encoding, so the body's read
    is the loopback wire alone."""
    from http.client import HTTPConnection

    from paddle_operator_tpu_torch.utils import fleetkv as FK

    host, _, port = ep.rpartition(":")
    conn = HTTPConnection(host, int(port), timeout=300)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/v1/prefill", body=json.dumps(
            {"tokens": prompt, "fingerprint": fingerprint}).encode(),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        t_head = time.perf_counter()
        raw = resp.read()
        t_end = time.perf_counter()
    finally:
        conn.close()
    if resp.status != 200:
        raise AssertionError(f"3o: POST /v1/prefill -> {resp.status}: "
                             f"{raw[:200]!r}")
    meta, arrays = FK.decode_handoff(raw)
    want = -(-len(prompt) // RING["block_size"])
    if meta["nBlocks"] != want or meta["promptLen"] != len(prompt):
        raise AssertionError(f"3o: the pod's envelope says {meta} for a "
                             f"{len(prompt)}-token prompt")
    return {"bytes": len(raw), "to_headers_s": t_head - t0,
            "body_s": t_end - t_head,
            "wire_gb_s": len(raw) / (t_end - t_head) / 1e9}


def _stamp_client(client) -> dict:
    """Per request (by prompt length and submit order): the client's
    submit time, its first frame's and its terminal item's arrival and
    the payload bytes landed (the queue ``put`` and ``submit`` wrapped,
    no behaviour changed)."""
    stamps = {}
    real_submit, real_put = client.submit, client.results.put

    def submit(req, slot):
        stamps[id(req)] = {"n": len(req.prompt), "t0": time.perf_counter(),
                           "bytes": 0, "frames": 0}
        real_submit(req, slot)

    def put(item, *a, **k):
        if isinstance(item[0], str):
            st = stamps.get(id(item[1]))
            if st is not None:
                now = time.perf_counter()
                st["bytes"] += sum(t.numel() * t.element_size()
                                   for t in item[3].values())
                if item[0] == "frame":
                    st["frames"] += 1
                    st.setdefault("t_first_frame", now)
                else:
                    st["t_final"] = now
        return real_put(item, *a, **k)

    client.submit = submit
    client.results.put = put
    return stamps


def _handoff_timings(params, cfg) -> dict:
    """The handoff copy alone at 3o's geometry: a 1,536-token prompt's 6
    blocks from a 1-lane engine's pool into the 64-block decode pool
    (int8: codes, scales and the tail row), device ms from CUDA-graph
    replay and eager ms, beside the bound (each block read once and
    written once at 3.35 TB/s)."""
    import torch

    from paddle_operator_tpu_torch.infer import executor as X
    from paddle_operator_tpu_torch.infer import paged as PG

    out = {}
    n = -(-INTERLEAVE["long_prompt"] // RING["block_size"])
    for kv_quant in ("none", "int8"):
        with torch.inference_mode():
            ex = X.RingExecutor(
                params, cfg, slots=RING["slots"], max_len=RING["max_len"],
                chunk_tokens=RING["chunk_tokens"], paged=True,
                block_size=RING["block_size"], kv_quant=kv_quant,
                prefill_mode="disagg")
            pe = ex.prefill_exec
            try:
                src = torch.arange(1, n + 1, device="cuda")
                dst = torch.arange(1, n + 1, device="cuda")

                def land(i):
                    # a 1-lane terminal item's landing: the block copy,
                    # then (int8) the tail row from engine lane 0
                    ex._frame_transfer(ex.cache, pe.cache, src, dst)
                    if ex.quant:
                        ex._tail_copy(ex.cache, pe.cache, 0, 0)

                dev, eager = time_ms(land, iters=8, warmup=2)
            finally:
                pe.close()
            nbytes = n * PG.host_block_bytes(cfg, RING["block_size"],
                                              kv_quant)
            out[kv_quant] = {"ms": dev, "eager_ms": eager,
                             "bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3,
                             "bytes": nbytes}
            del ex, pe
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _disagg_line(tag: str, run: dict) -> str:
    eng = [ms for _, ms in run["engine_ms"]]
    return (f"disagg {run['kv_quant']} {tag}: residents' token gap max "
            f"{run['resident_gap_max_ms']:.1f} ms, p95 "
            f"{run['resident_gap_p95_ms']:.1f} ms (while the long prompts "
            f"admit: max {run['resident_gap_max_during_ms']:.1f}, p95 "
            f"{run['resident_gap_p95_during_ms']:.1f}); long prompts' TTFT s "
            f"{[round(x, 3) for x in run['long_ttft_s']]}; engine "
            f"dispatches {len(eng)}, device ms min/median/max "
            f"{_spread(eng)}, total {sum(eng):.1f}; handoff items "
            f"{len(run['handoff_host_ms'])}, ring-thread hold ms "
            f"{_spread(run['handoff_host_ms'])} (its CPU "
            f"{_spread(run['handoff_cpu_ms'])}); slices on the ring "
            f"{len(run['slice_host_ms'])}, hold "
            f"{_spread(run['slice_host_ms'])}; {run['disagg']}; launches "
            f"{run['launches']} (want {run['launches_want']}), replays "
            f"{run['replays']} for {run['chunks']} dispatches; peak "
            f"allocated {run['peak_gb']:.2f} GB; wall {run['wall_s']:.3f} s "
            f"on {card_line()}")


def _disagg_checks(tag: str, run: dict, handoffs: int,
                   frames: bool) -> None:
    bad = []
    if run["launches"] != run["launches_want"] or any(run["other_kernels"]):
        bad.append(f"launch counts {run['launches']} (want "
                   f"{run['launches_want']}), other {run['other_kernels']}")
    if run["replays"] != run["chunks"] or not run["same_graphs"]:
        bad.append("not every dispatch a replay of the prewarm graphs at "
                   "their addresses")
    if run["queue_depth_end"] or \
            run["free_after"] + run["cached_after"] != run["free_before"]:
        bad.append(f"queue depth {run['queue_depth_end']}, or blocks "
                   "neither free nor cached at the end")
    if run["mode"] == "disagg":
        d = run["disagg"]
        if d["disagg_prefills"] != handoffs or run["slice_host_ms"]:
            bad.append(f"{d['disagg_prefills']} handoffs (want "
                       f"{handoffs}), {len(run['slice_host_ms'])} slices "
                       "on the ring")
        if frames and not (d["handoff_frames"] and d["overlapped_frames"]):
            bad.append(f"streamed frames {d}")
    if bad:
        raise AssertionError(f"3o {tag}: {bad}")


def phase_disagg(reports: tuple, params, cfg, ring_tokens,
                 runs_3j=None) -> None:
    """Phase 3o: disaggregated prefill at 7b; see the module docstring."""
    import torch

    from paddle_operator_tpu_torch.infer.prefill_serve import (
        handoff_fingerprint,
        remote_prefill_client_from_env,
    )

    out = {"none": {}, "int8": {}}
    # (a) 3b's burst through the 1-lane engine: the same prefill program
    # as 3b's inline insert, its bytes copied — bit-equal streams
    burst = phase_ring_main_path({}, params, cfg,
                                 ring_extra={"prefill_mode": "disagg"})
    gc.collect()
    torch.cuda.empty_cache()
    differ = sorted(k for k in ring_tokens if burst.get(k) != ring_tokens[k])
    log(f"disagg: 3b's burst through the 1-lane engine: "
        f"{len(ring_tokens) - len(differ)}/{len(ring_tokens)} requests "
        f"token-identical to 3b's inline ring")
    if ring_tokens and differ:
        raise AssertionError(f"3o: the 1-lane engine's streams differ from "
                             f"3b's for {differ}")
    out["none"]["burst_equal"] = f"{len(ring_tokens) - len(differ)}/" \
                                 f"{len(ring_tokens)}"
    # (b) 3j's traffic, both pools
    n_req = INTERLEAVE["residents"] + INTERLEAVE["long"]
    for kv_quant in ("none", "int8"):
        runs = {}
        chunked = (runs_3j or {}).get((kv_quant, "chunked", DISAGG_CHUNK))
        if chunked is None:
            chunked = _interleave_run(params, cfg, kv_quant, "chunked",
                                      DISAGG_CHUNK)
            gc.collect()
            torch.cuda.empty_cache()
        runs[f"chunked@{DISAGG_CHUNK}"] = chunked
        for mode, extra in DISAGG_RUNS:
            lanes = int(extra.get("SERVE_PREFILL_LANES", "1"))
            tag = f"disagg lanes {lanes}" + (
                ", stream" if extra.get("SERVE_PREFILL_STREAM") else "")
            run = _interleave_run(params, cfg, kv_quant, mode, DISAGG_CHUNK,
                                  extra_env=extra)
            gc.collect()
            torch.cuda.empty_cache()
            log(_disagg_line(tag, run))
            _disagg_checks(tag, run, n_req,
                           bool(extra.get("SERVE_PREFILL_STREAM")))
            runs[tag] = run
        base = runs[f"chunked@{DISAGG_CHUNK}"]
        for tag, run in runs.items():
            same = sum(run["outputs"][k] == base["outputs"][k]
                       for k in base["outputs"])
            run["equal_to_chunked"] = f"{same}/{len(base['outputs'])}"
        log(f"disagg {kv_quant}: streams equal to chunked@{DISAGG_CHUNK}'s "
            + "; ".join(f"{t} {r['equal_to_chunked']}"
                        for t, r in runs.items())
            + " (not gated: a whole-prompt prefill, a slice and the "
              "engine's batched slices round differently in bf16)")
        if kv_quant == "none":
            inproc4 = runs["disagg lanes 4, stream"]["outputs"]
        out[kv_quant]["traffic"] = {
            t: {k: v for k, v in r.items() if k != "outputs"}
            for t, r in runs.items()}
    # (c) the remote run: a prefill pod in its own process on this card
    free_gb = torch.cuda.mem_get_info()[0] / 1e9
    proc, ep, logf, boot_s = _start_prefill_pod(lanes=4)
    # the client as a replica builds it from its environment, with its
    # two workers: a handoff of 7b's 128 MiB blocks crosses the loopback
    # wire in about a second (Queue B item 14), so the residents may
    # attach two at a time and the first may finish before the last
    # attaches — the run records how many ever decoded together
    remote_env = {"SERVE_PREFILL_REMOTE": "1", "SERVE_PREFILL_PEERS": ep,
                  "SERVE_PREFILL_STREAM": "1"}
    client = remote_prefill_client_from_env(remote_env)
    try:
        stamps = _stamp_client(client)
        run = _interleave_run(
            params, cfg, "none", "disagg", DISAGG_CHUNK,
            extra_env=remote_env, ring_extra={"prefill_client": client},
            wait_all=False)
        gc.collect()
        torch.cuda.empty_cache()
        long_stamps = [st for st in stamps.values()
                       if st["n"] == INTERLEAVE["long_prompt"]]
        wire = _wire_reading(ep, list(range(1, INTERLEAVE["long_prompt"]
                                            + 1)),
                             handoff_fingerprint(
                                 cfg, block_size=RING["block_size"],
                                 kv_quant="none", top_k=None, top_p=None))
    except Exception:
        try:
            with urllib.request.urlopen(f"http://{ep}/statusz",
                                        timeout=10) as r:
                pod = r.read().decode()[:1500]
        except OSError as e:
            pod = repr(e)
        log(f"3o remote failed: the card's free memory "
            f"{torch.cuda.mem_get_info()[0] / 1e9:.2f} GB now, "
            f"{free_gb:.2f} GB before the pod; client {client.stats}, "
            f"its workers alive {[t.is_alive() for t in client._threads]}"
            f", jobs queued {client.jobs.qsize()}; the pod's /statusz "
            f"{pod}")
        raise
    finally:
        code = _stop_prefill_pod(proc)
        client.close()
        log(f"3o: the prefill pod's output (tail): {_log_tail(logf, 1500)}")
    tag = "remote (a prefill pod, 4 lanes, stream)"
    handoff = [{"bytes": st["bytes"], "frames": st["frames"],
                "first_frame_s": st.get("t_first_frame", 0) - st["t0"],
                "final_s": st.get("t_final", 0) - st["t0"],
                "gb_s": st["bytes"] / max(1e-9, st.get("t_final", 0)
                                          - st["t0"]) / 1e9}
               for st in long_stamps]
    log(_disagg_line(tag, run))
    log(f"disagg remote: the card's free memory before the pod "
        f"{free_gb:.2f} GB; pod ready {boot_s:.1f} s after its start, exit "
        f"code {code} after SIGTERM; the long prompts' handoffs "
        f"{handoff} (bytes over submit-to-final: prefill and wire "
        f"together); one whole-envelope POST of a 1,536-token prompt "
        f"{wire}; the client's workers {len(client._threads)}; residents "
        f"decoding at once at most {run['residents_overlap_max']} of "
        f"{INTERLEAVE['residents']}, {run['residents_done_before_long']} "
        f"resolved before the long prompts came; streams equal to the "
        f"in-process 4-lane run's "
        f"{sum(run['outputs'][k] == inproc4[k] for k in inproc4)}/"
        f"{len(inproc4)} (not gated: the batch each slice runs in may "
        f"differ)")
    if code != 83:
        raise AssertionError(f"3o: the prefill pod exited {code} after "
                             f"SIGTERM, not EXIT_PREEMPTED (83): "
                             f"{_log_tail(logf)}")
    if run["disagg"]["remote_prefills"] != n_req:
        raise AssertionError(f"3o remote: {run['disagg']} (want "
                             f"{n_req} remote prefills)")
    _disagg_checks(tag, run, n_req, frames=True)
    out["none"]["remote"] = dict(
        {k: v for k, v in run.items() if k != "outputs"},
        pod_boot_s=boot_s, pod_exit=code, long_handoffs=handoff, wire=wire)
    # (d) the copy alone
    alone = _handoff_timings(params, cfg)
    log(f"disagg: the handoff copy of a 1,536-token prompt (6 blocks) "
        f"alone, device ms (graph) / eager ms / bound ms / bytes: "
        + "; ".join(f"{k} {v['ms']:.4f} / {v['eager_ms']:.4f} / "
                    f"{v['bound_ms']:.4f} / {v['bytes']}"
                    for k, v in alone.items()) + f" on {card_line()}")
    for report, kv_quant in zip(reports, ("none", "int8")):
        report["disagg"] = dict(out[kv_quant], copy_alone=alone[kv_quant])


# phase 3p: fleet-level KV at 7b, full width and depth, bf16 weights —
# two port replicas in this process over one params tree, each 3b's ring
# with a 64-block pool and a host tier (16 blocks on A, 2 on B: B's tier
# is small enough for a wave of cold prompts to push a chain out of it
# whole), served on loopback, wired by ``wire_fleet_kv_from_env`` with
# SERVE_KV_MIGRATE=1, SERVE_KV_PEER_FETCH=1 and SERVE_KV_PEERS naming
# the other.  (a) 8 lanes (prompts of 100-400 tokens, 256 new) drained
# off A by migration on the bf16 pool, (b) 4 on the int8 pool, both once
# every lane decoded `chunks_first` chunks; (c) a 512-token prefix (+16)
# fetched by B from A's host tier
FLEET = dict(num_blocks=64, host_blocks=(16, 2), lanes=8, int8_lanes=4,
             new=256, prompt_lens=(100, 143, 186, 229, 271, 314, 357, 400),
             chunks_first=2, prefix=512, suffix=16, fetched_new=16,
             wave_len=1900, wave_new=48)


def _fleet_pair(params, cfg, kv_quant: str) -> list:
    """Phase 3p's two replicas, A then B (built one at a time: each ring
    captures its graphs at prewarm before the next is made), each a
    ``make_server`` on loopback wired for fleet-level KV from the env a
    replica pod gets.  Returns ``[(server, batcher, base url), ...]``."""
    from paddle_operator_tpu_torch.infer.serve import (
        make_server,
        wire_fleet_kv_from_env,
    )

    reps = []
    for host in FLEET["host_blocks"]:
        kw = dict(RING, prewarm=True, num_blocks=FLEET["num_blocks"],
                  host_cache_blocks=host)
        if kv_quant != "none":
            kw["kv_quant"] = kv_quant
        srv = make_server("127.0.0.1", 0, params, cfg, **kw)
        b = srv.generator.batcher
        if not b.prewarmed.wait(600) or b.executor.needs_capture:
            raise AssertionError(f"3p: a replica's graphs were not "
                                 f"captured: {b.prewarm_error!r}")
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        reps.append((srv, b, f"http://127.0.0.1:{srv.server_address[1]}"))
    eps = [f"127.0.0.1:{srv.server_address[1]}" for srv, _, _ in reps]
    for (srv, b, _), other in zip(reps, reversed(eps)):
        wire_fleet_kv_from_env(b, srv.server_address[1], {
            "SERVE_KV_MIGRATE": "1", "SERVE_KV_PEER_FETCH": "1",
            "SERVE_KV_PEERS": other, "POD_IP": "127.0.0.1"})
        if b.migrate_out is None or b.peer_fetch is None \
                or b.peer_fetch.__self__.peers != [other]:
            raise AssertionError("3p: the env did not wire fleet-level KV")
    return reps


def _close_pair(reps) -> None:
    import torch

    for srv, _, _ in reps:
        srv.shutdown()
        srv.server_close()
        srv.generator.close()
    gc.collect()
    torch.cuda.empty_cache()


def _stamp_consumes(batcher, stamps: dict, where: str) -> None:
    """Stamp, after every consumed dispatch boundary of ``batcher``, the
    host clock and each identified request's emitted-token count:
    ``stamps[request id]`` gets ``(t, tokens, where)``."""
    real = batcher._consume

    def consume(chunk_reqs, toks, *a, **k):
        real(chunk_reqs, toks, *a, **k)
        now = time.perf_counter()
        for i, r in chunk_reqs:
            if r is None or r.request_id is None:
                continue
            if batcher.lane[i] is r:
                n = len(batcher._lane_out[i])
            elif r.done.is_set() and r.out is not None:
                n = len(r.out) - len(r.prompt)
            else:
                continue
            stamps.setdefault(r.request_id, []).append((now, n, where))

    batcher._consume = consume


def _wave(base: str, batcher, cfg, rng) -> None:
    """Pool pressure: one cold prompt of ``FLEET['wave_len']`` tokens per
    lane, each decoding ``FLEET['wave_new']`` tokens, so that together
    they map the whole pool — every block cached before the wave is
    evicted (demoted into the host tier), inner chain blocks too.  The
    ring's dispatches are slowed meanwhile, so every lane is admitted
    before the first finishes."""
    prompts = [rng.integers(0, cfg.vocab_size, FLEET["wave_len"]).tolist()
               for _ in range(RING["slots"])]
    res = [None] * len(prompts)
    ex = batcher.executor
    real = ex.replay

    def slow(plan):
        time.sleep(0.1)
        return real(plan)

    def send(i):
        res[i] = _post_any(base, "/v1/generate",
                           {"tokens": [prompts[i]],
                            "max_new_tokens": FLEET["wave_new"]})

    ex.replay = slow
    try:
        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        ex.replay = real
    if any(r is None or r[0] != 200 for r in res):
        raise AssertionError(f"3p: a pressure prompt failed: "
                             f"{[r and r[0] for r in res]}")


def _migration_run(reps, cfg, n_lanes: int, tag: str) -> dict:
    """Phase 3p (a)/(b): the lanes' reference run on B, then the same
    requests on A, A drained by migration once every lane decoded
    ``chunks_first`` chunks, each request retried on B with its
    ``request_id``.  Returns the readings; raises on a failed gate."""
    import numpy as np

    from paddle_operator_tpu_torch.ops import decode_attention as DA
    from paddle_operator_tpu_torch.utils import fleetkv as FK

    (sa, A, base_a), (sb, B, base_b) = reps
    quant = A.kv_quant != "none"
    attr = "quant_launches" if quant else "launches"
    chunk, new = RING["chunk_tokens"], FLEET["new"]
    rng = np.random.default_rng(11 if quant else 10)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in FLEET["prompt_lens"][:n_lanes]]

    def run(base, rid_tag, retry=None):
        first, final = [None] * n_lanes, [None] * n_lanes

        def send(i):
            body = {"tokens": [prompts[i]], "max_new_tokens": new,
                    "request_id": f"{rid_tag}-{i}"}
            first[i] = _post_any(base, "/v1/generate", body)
            final[i] = first[i]
            if retry is not None and first[i][0] == 503:
                final[i] = _post_any(retry, "/v1/generate", body)

        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(n_lanes)]
        for t in threads:
            t.start()
        return threads, first, final

    # the unmigrated streams, on the adopter's ring
    threads, _, ref = run(base_b, f"{tag}-ref")
    for t in threads:
        t.join()
    if any(r[0] != 200 for r in ref):
        raise AssertionError(f"3p {tag}: reference run {[r[0] for r in ref]}")
    ref = [r[1]["tokens"][0] for r in ref]

    # instrumentation: the spill's hold of A's ring thread, the encode
    # and the POST of each lane (the client the env built), B's decode
    # and adoption, every boundary's token counts on both rings, and B's
    # kernel launches replay by replay (A parks every lane before B's
    # first adopted dispatch, so no A replay overlaps a B replay)
    holds, wires, adopts, stamps = [], [], {}, {}
    real_spill = A.executor.spill_lane

    def spill(slot):
        t0 = time.perf_counter()
        out = real_spill(slot)
        holds.append((time.perf_counter() - t0) * 1e3)
        return out

    A.executor.spill_lane = spill
    client = A.peer_fetch.__self__
    # (a)'s cold admissions on A must not host-hit B's chains: its
    # streams are held to the unmigrated run's bit for bit
    A.peer_fetch = None

    def migrate_out(meta, spill_):
        t0 = time.perf_counter()
        buf = FK.encode_lane(meta, spill_)
        t1 = time.perf_counter()
        target = client.migrate_out(buf)
        t2 = time.perf_counter()
        wires.append({"rid": meta["requestId"], "bytes": len(buf),
                      "blocks": int(spill_["n_blocks"]),
                      "encode_ms": (t1 - t0) * 1e3,
                      "post_ms": (t2 - t1) * 1e3, "ok": target is not None})
        return target is not None

    A.migrate_out = migrate_out
    real_adopt = sb.generator.adopt_envelope

    def adopt_envelope(buf):
        t0 = time.perf_counter()
        rid = real_adopt(buf)
        adopts[rid] = (t0, time.perf_counter())
        return rid

    sb.generator.adopt_envelope = adopt_envelope
    _stamp_consumes(A, stamps, "A")
    _stamp_consumes(B, stamps, "B")
    b_launch = {"n": 0, "replays": 0}
    real_replay = B.executor.replay
    fn = DA.paged_decode_attention

    def replay(plan):
        c0 = getattr(fn, attr)
        res = real_replay(plan)
        b_launch["n"] += getattr(fn, attr) - c0
        b_launch["replays"] += 1
        return res

    B.executor.replay = replay
    b_chunks0, b_adopt0 = B.stats["chunks"], B.stats["adopted_lanes"]
    other0 = DA.decode_attention.launches

    threads, first, final = run(base_a, tag, retry=base_b)
    t0 = time.perf_counter()
    want = 1 + FLEET["chunks_first"] * chunk
    while not (sum(r is not None for r in A.lane) == n_lanes and all(
            len(A._lane_out[i]) >= want for i, r in enumerate(A.lane)
            if r is not None)):
        if time.perf_counter() - t0 > 600:
            raise AssertionError(f"3p {tag}: the lanes never all decoded "
                                 f"{FLEET['chunks_first']} chunks")
        time.sleep(0.002)
    resident = sum(r is not None for r in A.lane)
    a_chunks = A.stats["chunks"]
    t_drain = time.perf_counter()
    sa.state.draining = True
    A.drain(budget_s=600)
    drain_s = time.perf_counter() - t_drain
    for t in threads:
        t.join()
    bad = []
    if any(r[0] != 503 or "migrated" not in r[1].get("error", "")
           for r in first):
        bad.append(f"A answered {[r[0] for r in first]}")
    if any(r[0] != 200 for r in final):
        bad.append(f"B answered {[r[0] for r in final]}")
    got = [r[1]["tokens"][0] if r[0] == 200 else None for r in final]
    same = sum(g == w for g, w in zip(got, ref))
    migrated = A.stats["lane_migrations"]
    adopted = B.stats["adopted_lanes"] - b_adopt0
    b_chunks = B.stats["chunks"] - b_chunks0
    want_launch = cfg.n_layers * chunk * b_launch["replays"]
    if not resident == migrated == adopted == n_lanes:
        bad.append(f"resident {resident}, laneMigrations {migrated}, "
                   f"adoptedLanes {adopted}, want {n_lanes}")
    if same != n_lanes:
        bad.append(f"{same}/{n_lanes} streams equal the unmigrated run's")
    if b_launch["n"] != want_launch or not b_launch["n"] \
            or b_launch["replays"] != b_chunks:
        bad.append(f"B's kernel launches {b_launch['n']}, want "
                   f"{want_launch} (n_layers x chunk x {b_launch['replays']}"
                   f" replays; {b_chunks} dispatches)")
    if DA.decode_attention.launches != other0:
        bad.append("kernel #1 launched")
    if len(wires) != n_lanes or not all(w["ok"] for w in wires):
        bad.append(f"wires {wires}")
    B.pool.check_invariant()
    # readings, lane by lane
    lanes = []
    for w in wires:
        rid = w["rid"]
        st = sorted(stamps.get(rid, []))
        a_last = max((s for s in st if s[2] == "A"), default=None)
        at_move = a_last[1] if a_last else 0
        b_first = next((s for s in st if s[2] == "B" and s[1] > at_move),
                       None)
        prog = [s for i, s in enumerate(st) if i == 0 or s[1] > st[i - 1][1]]
        gaps = [(b[0] - a[0]) * 1e3 for a, b in zip(prog, prog[1:])]
        ad = adopts.get(rid)
        lanes.append(dict(
            w, wire_gb_s=w["bytes"] / w["post_ms"] / 1e6,
            decode_adopt_ms=(ad[1] - ad[0]) * 1e3 if ad else None,
            adopt_to_first_token_ms=((b_first[0] - ad[1]) * 1e3
                                     if ad and b_first else None),
            move_gap_ms=((b_first[0] - a_last[0]) * 1e3
                         if a_last and b_first else None),
            largest_gap_ms=max(gaps) if gaps else None,
            tokens_at_move=at_move))
    out = {"lanes": n_lanes, "kv_quant": A.kv_quant,
           "resident_at_drain": resident, "lane_migrations": migrated,
           "adopted_lanes": adopted, "streams_equal_unmigrated":
           f"{same}/{n_lanes}", "a_dispatches": a_chunks,
           "b_dispatches": b_chunks, "b_launches": b_launch["n"],
           "b_launches_want": want_launch, "drain_s": drain_s,
           "spill_hold_ms": holds, "per_lane": lanes}

    def spread(key):
        xs = [ln[key] for ln in lanes if ln[key] is not None]
        return f"{min(xs):.1f}-{max(xs):.1f}" if xs else "n/a"

    log(f"fleet kv {tag} ({A.kv_quant} pool, {n_lanes} lanes, 7b bf16): A "
        f"drained by migration in {drain_s:.2f} s, laneMigrations "
        f"{migrated} == B adoptedLanes {adopted} == resident {resident}; "
        f"streams == unmigrated {same}/{n_lanes}; B's "
        f"{'#3' if quant else '#2'} launches {b_launch['n']} (want "
        f"{want_launch}); spill hold of A's ring thread ms "
        f"{[round(h, 1) for h in holds]}; a lane's envelope "
        f"{[w['bytes'] for w in wires]} bytes, encode ms {spread('encode_ms')}"
        f", POST ms {spread('post_ms')} ({spread('wire_gb_s')} GB/s), B's "
        f"decode + adopt ms {spread('decode_adopt_ms')}, adopt to first "
        f"resumed token ms {spread('adopt_to_first_token_ms')}, the move's "
        f"token gap ms {spread('move_gap_ms')}, largest gap per stream ms "
        f"{spread('largest_gap_ms')} on {card_line()}")
    if bad:
        raise AssertionError(f"3p {tag}: {bad}")
    return out


def _prefix_fetch_run(reps, cfg) -> dict:
    """Phase 3p (c): B's cold admission of a 528-token prompt, a wave of
    cold prompts that pushes its chain out of B's pool and tier, the
    prompt cold on A and a wave that demotes its two full blocks into
    A's tier, then the prompt on B: B's submit thread fetches the blocks
    from A's ``/v1/kv/prefix`` and the admission host-hits them."""
    import numpy as np

    from paddle_operator_tpu_torch.utils.radixkey import chain_key

    (sa, A, base_a), (sb, B, base_b) = reps
    bs, new = RING["block_size"], FLEET["fetched_new"]
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, cfg.vocab_size,
                          FLEET["prefix"] + FLEET["suffix"]).tolist()
    keys, key = [], None
    for j in range(FLEET["prefix"] // bs):
        key = chain_key(key, tuple(prompt[j * bs:(j + 1) * bs]))
        keys.append(key)
    body = {"tokens": [prompt], "max_new_tokens": new}
    # B's cold admission runs with its peer leg off: the submit probe
    # asks the fleet once per chain, and the fetched admission below
    # must be B's first ask of this one
    real_fetch = B.peer_fetch
    B.peer_fetch = None
    code, events, cold_ttft, _ = _post_stream(base_b, body)
    B.peer_fetch = real_fetch
    cold = events[-1]["tokens"]
    # the first wave demotes the chain into B's two-block tier, the
    # second pushes it out of the tier
    _wave(base_b, B, cfg, rng)
    _wave(base_b, B, cfg, rng)
    if any(k in B.pool.entries for k in keys):
        raise AssertionError("3p (c): the prefix is still on B")
    if _post_any(base_a, "/v1/generate", body)[0] != 200:
        raise AssertionError("3p (c): A's cold admission failed")
    _wave(base_a, A, cfg, rng)
    if not all(k in A.pool.entries and A.pool.entries[k].block is None
               and k in A.pool.host for k in keys):
        raise AssertionError("3p (c): the prefix was not demoted into A's "
                             "host tier")
    timing = {}
    real_export = A.pool.export_host_chain

    def export(tokens, ns=0):
        t0 = time.perf_counter()
        out = real_export(tokens, ns=ns)
        timing["export_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    A.pool.export_host_chain = export

    def fetch(tokens, ns):
        t0 = time.perf_counter()
        buf = real_fetch(tokens, ns)
        timing["fetch_ms"] = (time.perf_counter() - t0) * 1e3
        timing["bytes"] = len(buf) if buf else 0
        return buf

    B.peer_fetch = fetch
    s0 = dict(B.stats)
    p0 = dict(B.pool.stats)
    code, events, fetched_ttft, _ = _post_stream(base_b, body)
    got = events[-1]["tokens"]
    st = json.loads(urllib.request.urlopen(base_b + "/statusz",
                                           timeout=60).read())
    out = {"prefix_tokens": FLEET["prefix"], "bytes": timing.get("bytes"),
           "export_ms": timing.get("export_ms"),
           "fetch_ms": timing.get("fetch_ms"),
           "cold_ttft_s": cold_ttft, "fetched_ttft_s": fetched_ttft,
           "peer_prefix_fetches": B.stats["peer_prefix_fetches"]
           - s0["peer_prefix_fetches"],
           "peer_blocks_imported": B.pool.stats["peer_blocks_imported"]
           - p0["peer_blocks_imported"],
           "host_promotions": B.pool.stats["host_promotions"]
           - p0["host_promotions"],
           "prefill_tokens": B.stats["prefill_tokens"] - s0["prefill_tokens"],
           "statusz_peer_prefix_fetches": st["peerPrefixFetches"],
           "tokens_equal_cold": sum(a == b for a, b in zip(
               got[len(prompt):], cold[len(prompt):])) / new}
    log(f"fleet kv (c) peer prefix fetch (7b bf16, a {FLEET['prefix']}-token "
        f"prefix + {FLEET['suffix']}): B's TTFT {fetched_ttft * 1e3:.1f} ms "
        f"fetched against {cold_ttft * 1e3:.1f} ms cold; the export "
        f"{out['export_ms']} ms on A's handler thread, the fetch "
        f"{out['fetch_ms']} ms for {out['bytes']} bytes; "
        f"peerPrefixFetches {out['peer_prefix_fetches']}, blocks imported "
        f"{out['peer_blocks_imported']}, promoted {out['host_promotions']},"
        f" prefill tokens {out['prefill_tokens']}; new tokens equal to the "
        f"cold run's {out['tokens_equal_cold']:.3f} (not gated: a hit and a "
        f"cold prefill round differently in bf16) on {card_line()}")
    n = FLEET["prefix"] // bs
    if (code != 200 or out["peer_prefix_fetches"] != 1
            or out["peer_blocks_imported"] != n
            or out["host_promotions"] != n
            or out["statusz_peer_prefix_fetches"] < 1
            or out["prefill_tokens"] != FLEET["suffix"]):
        raise AssertionError(f"3p (c): {out}")
    return out


def phase_fleet_kv(reports: tuple, params, cfg) -> None:
    """Phase 3p: fleet-level KV at 7b; see the module docstring."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    reps = _fleet_pair(params, cfg, "none")
    try:
        fetch = _prefix_fetch_run(reps, cfg)
        bf16 = _migration_run(reps, cfg, FLEET["lanes"], "a")
    finally:
        _close_pair(reps)
    reps = _fleet_pair(params, cfg, "int8")
    try:
        int8 = _migration_run(reps, cfg, FLEET["int8_lanes"], "b")
    finally:
        _close_pair(reps)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"fleet kv: peak memory allocated {peak:.2f} GB (one 7b params tree "
        f"and two 64-block pools) on {card_line()}")
    reports[0]["fleet_kv"] = {"migration": bf16, "prefix_fetch": fetch,
                              "peak_gb": peak}
    reports[1]["fleet_kv"] = {"migration": int8, "peak_gb": peak}


def _zero_launches() -> None:
    from paddle_operator_tpu_torch.ops import adam8bit as A8
    from paddle_operator_tpu_torch.ops import decode_attention as DA
    from paddle_operator_tpu_torch.ops import flash_attention as FA
    from paddle_operator_tpu_torch.ops import quant_matmul as QM

    for fn in (DA.decode_attention, DA.paged_decode_attention,
               FA.flash_forward, FA.flash_backward_dkv, FA.flash_backward_dq,
               QM.quant_matmul, QM.quant_gemm, A8.adam8bit_update):
        fn.launches = 0
    DA.paged_decode_attention.quant_launches = 0


def _synced_clock() -> float:
    """Host clock read after the card has finished its queued work, so
    StepTimer's intervals are whole steps."""
    import torch

    torch.cuda.synchronize()
    return time.perf_counter()


def phase_train_main_path(reports: dict) -> None:
    """Phase 3c: 7b width, 8 layers, trained through ``fit``; see the
    module docstring."""
    import itertools
    import statistics

    import numpy as np
    import torch

    from paddle_operator_tpu_torch.models.llama import make_model
    from paddle_operator_tpu_torch.ops import decode_attention as DA
    from paddle_operator_tpu_torch.ops import flash_attention as FA
    from paddle_operator_tpu_torch.train import trainer as T
    from paddle_operator_tpu_torch.train.data import (
        DevicePrefetcher, deterministic_lm_batches)
    from paddle_operator_tpu_torch.utils.observability import StepTimer

    layers, b, s, steps = (TRAIN[k] for k in ("layers", "batch", "seq",
                                              "steps"))
    # what earlier phases left allocated is not the training's
    base_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    model, cfg = make_model("7b", device="cuda", seed=0, n_layers=layers)
    opt = T.make_optimizer(TRAIN["lr"], warmup_steps=1, decay_steps=1000)
    state = T.create_state(model, opt)
    step = T.make_train_step(opt)
    torch.cuda.synchronize()
    log(f"train: 7b width, {layers} layers ({cfg.num_params() / 1e9:.3f}B "
        f"params, f32 params, {cfg.dtype} compute, remat {cfg.remat}), "
        f"model + AdamW state built in "
        f"{time.perf_counter() - t0:.1f}s")
    batch = next(deterministic_lm_batches(b, s + 1, cfg.vocab_size, seed=0))
    batches = DevicePrefetcher(itertools.repeat(batch, steps), device="cuda")
    timer = StepTimer(b * s, cfg.flops_per_token(), PEAK_BF16,
                      window=steps, clock=_synced_clock)
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = _synced_clock()
    state, history = T.fit(state, step, batches, steps=steps, timer=timer)
    wall = _synced_clock() - t0
    fwd = FA.flash_forward.launches
    dkv = FA.flash_backward_dkv.launches
    dq = FA.flash_backward_dq.launches
    decode = (DA.decode_attention.launches
              + DA.paged_decode_attention.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - base_gb
    losses = [h["loss"] for h in history]
    norms = [h["grad_norm"] for h in history]
    log(f"train: losses {losses}")
    log(f"train: grad norms {norms}")
    if len(history) != steps or not all(np.isfinite(losses + norms)):
        raise AssertionError(f"fit ran {len(history)} of {steps} steps, or "
                             "a loss or grad norm is not finite")
    if not losses[-1] < 0.7 * losses[0]:
        raise AssertionError(f"the loss did not fall below 0.7x its first "
                             f"value: {losses[0]} -> {losses[-1]}")
    want = {"fwd": 2 * layers * steps, "dkv": layers * steps,
            "dq": layers * steps}
    log(f"train: launches flash_forward {fwd} (2 x {layers} layers x "
        f"{steps} steps = {want['fwd']}), flash_backward_dkv {dkv}, "
        f"flash_backward_dq {dq} ({layers} x {steps} = {want['dq']}); "
        f"decode kernels {decode}")
    if (fwd, dkv, dq) != (want["fwd"], want["dkv"], want["dq"]) or decode:
        raise AssertionError("the training path's kernel launches do not "
                             "match the formulas")
    times = list(timer.times)           # steps 2..N
    step_ms = statistics.median(times[1:]) * 1e3
    tok_s = b * s / (step_ms / 1e3)
    train = {
        "layers": layers, "batch": b, "seq": s, "steps": steps,
        "lr": TRAIN["lr"], "params": cfg.num_params(),
        "first_loss": losses[0], "last_loss": losses[-1],
        "fit_wall_s": wall, "step_ms_median": step_ms,
        "step_ms": [t * 1e3 for t in times],
        "tokens_per_s": tok_s,
        "flops_per_token": cfg.flops_per_token(),
        "mfu": tok_s * cfg.flops_per_token() / PEAK_BF16,
        "max_memory_allocated_gb": peak_gb,
        "allocated_before_gb": base_gb,
    }
    log("train: " + json.dumps(train))
    log(f"train (one run of {steps} steps, not a benchmark): step "
        f"{step_ms:.1f} ms (median of steps 3..{steps}), {tok_s:.0f} "
        f"tokens/s, MFU {train['mfu']:.3f} against {PEAK_BF16 / 1e12:.0f} "
        f"TFLOP/s bf16, peak memory {peak_gb:.1f} GB (above the "
        f"{base_gb:.1f} GB allocated before it); loss {losses[0]:.3f}"
        f" -> {losses[-1]:.3f}")
    for kern, n in (("flash_forward", fwd), ("flash_backward_dkv", dkv),
                    ("flash_backward_dq", dq)):
        reports[kern]["launches"] = n
    reports["flash_forward"]["train"] = train
    del state, step, model, opt, batches
    torch.cuda.empty_cache()


def phase_checkpoint(reports: dict) -> None:
    """Phase 3f: save, drain, restore, continue and serve a checkpoint;
    see the module docstring."""
    import itertools
    import logging
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from paddle_operator_tpu_torch.ft.preemption import (
        PreemptionWatcher, inject_preemption)
    from paddle_operator_tpu_torch.infer.quant import serving_params
    from paddle_operator_tpu_torch.infer.serve import (load_serving_params,
                                                       make_server)
    from paddle_operator_tpu_torch.models.llama import CONFIGS, make_model
    from paddle_operator_tpu_torch.ops import decode_attention as DA
    from paddle_operator_tpu_torch.ops import flash_attention as FA
    from paddle_operator_tpu_torch.train import trainer as T
    from paddle_operator_tpu_torch.train.checkpoint import (
        CheckpointManager, resume_or_init)
    from paddle_operator_tpu_torch.train.data import (
        DevicePrefetcher, deterministic_lm_batches)
    from paddle_operator_tpu_torch.utils.observability import StepTimer

    layers, b, s = CKPT["layers"], CKPT["batch"], CKPT["seq"]
    steps, drain_at = CKPT["steps"], CKPT["drain_at"]
    card = card_line()

    def new_state(seed):
        model, _ = make_model("7b", device="cuda", seed=seed,
                              n_layers=layers)
        opt = T.make_optimizer(CKPT["lr"], warmup_steps=1, decay_steps=1000)
        return T.create_state(model, opt), T.make_train_step(opt)

    def batches(start, n):
        return DevicePrefetcher(itertools.islice(deterministic_lm_batches(
            b, s + 1, CONFIGS["7b"].vocab_size, seed=0, start_step=start),
            n), device="cuda")

    def run_fit(what, state, step, data, n, **kw):
        """``fit`` with the flash launches of exactly that run held to
        3c's formulas."""
        timer = StepTimer(b * s, 1.0, 1.0, window=n, clock=_synced_clock)
        _zero_launches()
        t0 = _synced_clock()
        state, hist = T.fit(state, step, data, steps=n, timer=timer, **kw)
        secs = _synced_clock() - t0
        done = len(hist)
        got = (FA.flash_forward.launches, FA.flash_backward_dkv.launches,
               FA.flash_backward_dq.launches)
        want = (2 * layers * done, layers * done, layers * done)
        decode = (DA.decode_attention.launches
                  + DA.paged_decode_attention.launches
                  + DA.paged_decode_attention.quant_launches)
        losses = [h["loss"] for h in hist]
        log(f"checkpoint {what}: {done} steps in {secs:.2f}s (step ms "
            f"{[round(t * 1e3, 1) for t in timer.times]}), losses "
            f"{losses}; flash launches fwd/dkv/dq {got} (2 x {layers} x "
            f"{done}, {layers} x {done}, {layers} x {done} = {want}), "
            f"decode kernels {decode}; {card}")
        if got != want or decode:
            raise AssertionError(f"checkpoint {what}: the flash launches "
                                 "do not match the formulas")
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"checkpoint {what}: a loss is not finite")
        return state, losses

    def same_state(got, want) -> list:
        """Names of what differs between two TrainStates, bit for bit."""
        bad = [k for k, v in want.model.state_dict().items()
               if not torch.equal(got.model.state_dict()[k], v)]
        for part in ("mu", "nu"):
            g, w = getattr(got.opt_state, part), getattr(want.opt_state, part)
            bad += [f"{part}.{k}" for k in w
                    if g[k].dtype != w[k].dtype or not torch.equal(g[k], w[k])]
        if (got.step, got.opt_state.count) != (want.step,
                                               want.opt_state.count):
            bad.append("step/count")
        return bad

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(root).free
        params_n = dataclasses.replace(CONFIGS["7b"],
                                       n_layers=layers).num_params()
        need = 2 * 3 * 4 * params_n          # two steps of f32 p, mu, nu
        log(f"checkpoint: 7b width, {layers} layers ({params_n / 1e9:.3f}B "
            f"params, f32 master, bf16 compute), B={b} S={s}; "
            f"{free / 1e9:.1f} GB free under {root} (U keeps two steps, "
            f"{need / 1e9:.1f} GB)")
        if free < need:
            raise AssertionError("not enough disk for phase 3f's "
                                 "checkpoints")

        # (a) the unbroken run U, saving under the interval; U2, the same
        # run without a manager, reads the spread of two unbroken runs
        state, step = new_state(0)
        ck_u = CheckpointManager(os.path.join(root, "U"), max_to_keep=2,
                                 save_interval_steps=CKPT["interval"])
        state, losses_u = run_fit("U", state, step, batches(0, steps),
                                  steps, checkpoint=ck_u)
        ck_u.wait()
        save_u = dict(ck_u.last_save)
        if ck_u.all_steps() != [3, 6]:
            raise AssertionError(f"U committed {ck_u.all_steps()}, "
                                 "expected [3, 6]")
        u_final = {k: v.clone() for k, v in state.model.state_dict().items()}
        shutil.rmtree(ck_u.path)
        del state, step
        state, step = new_state(0)
        state, losses_u2 = run_fit("U2", state, step, batches(0, steps),
                                   steps)
        spread = max(abs(x - y) for x, y in zip(losses_u, losses_u2))
        same = "bit-identical" if losses_u == losses_u2 else "differ"
        log(f"checkpoint: two unbroken runs, max |loss difference| "
            f"{spread!r} ({same}; {card})")
        del state, step

        # (b) the drained run R: a real SIGTERM while step 3 is in flight
        state_r, step_r = new_state(0)
        ck_r = CheckpointManager(os.path.join(root, "R"), max_to_keep=2)
        records = []
        logger = logging.getLogger("chip_smoke.checkpoint")
        logger.setLevel(logging.INFO)
        handler = logging.Handler()
        handler.emit = lambda r: records.append(r.getMessage())
        logger.addHandler(handler)
        watcher = PreemptionWatcher.install()
        try:
            data = batches(0, steps)
            state_r, losses_r = run_fit(
                "R", state_r, step_r,
                inject_preemption(data, drain_at, watcher, signal_self=True),
                steps, checkpoint=ck_r, preemption=watcher, logger=logger)
            committed = ck_r.all_steps()     # before any wait of ours
        finally:
            watcher.uninstall()
            logger.removeHandler(handler)
        list(data)                           # let the prefetcher finish
        save_r = dict(ck_r.last_save)
        log(f"checkpoint R: watcher draining {watcher.draining} "
            f"({watcher.reason}), step {state_r.step}, committed "
            f"{committed}; log {records}")
        if not (watcher.draining and state_r.step == drain_at + 1
                and committed == [drain_at + 1]
                and any(f"step={drain_at + 1} checkpoint=saved" in m
                        for m in records)):
            raise AssertionError("the drain did not leave a durable "
                                 "checkpoint of the in-flight step")
        if losses_r != losses_u[:drain_at + 1]:
            log(f"checkpoint R: losses {losses_r} differ from U's first "
                f"{drain_at + 1} {losses_u[:drain_at + 1]}")

        # (c) restore R's checkpoint into a model from another seed
        fresh, step_c = new_state(1)
        t0 = _synced_clock()
        state_c, resumed = resume_or_init(CheckpointManager(ck_r.path),
                                          lambda: fresh)
        restore_s = _synced_clock() - t0
        bad = same_state(state_c, state_r)
        log(f"checkpoint restore: resumed {resumed}, step {state_c.step}, "
            f"count {state_c.opt_state.count} in {restore_s:.3f}s; "
            f"{len(bad)} tensors differ from R's in memory; {card}")
        if not resumed or bad:
            raise AssertionError(f"the restore is not bit-exact: {bad[:8]}")

        # (d) continue 3 steps from the restored state
        state_c, losses_d = run_fit(
            "continued", state_c, step_c, batches(drain_at + 1, steps),
            steps - drain_at - 1)
        worst = max(abs(x - y)
                    for x, y in zip(losses_d, losses_u[drain_at + 1:]))
        params_same = all(torch.equal(state_c.model.state_dict()[k], v)
                          for k, v in u_final.items())
        log(f"checkpoint continued: losses {losses_d} against U's "
            f"{losses_u[drain_at + 1:]}, max |difference| {worst!r}; "
            f"final params bit-identical to U's: {params_same}; {card}")
        if losses_d != losses_u[drain_at + 1:] or not params_same:
            raise AssertionError("the continued run is not bit-identical "
                                 "to the unbroken run")
        del state_c, step_c, fresh, u_final
        gc.collect()
        torch.cuda.empty_cache()

        # (e) serve R's checkpoint: the parameter file only, cast to bf16
        # on its way to the card
        scfg = dataclasses.replace(CONFIGS["7b"], n_layers=layers)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        served, scfg, resumed = load_serving_params(ck_r.path, scfg, "cuda")
        torch.cuda.synchronize()
        serve_restore_s = time.perf_counter() - t0
        added = torch.cuda.memory_allocated() - base
        bf16_bytes = 2 * scfg.num_params()
        log(f"checkpoint serve restore: resumed {resumed} in "
            f"{serve_restore_s:.3f}s; allocated +{added} bytes against "
            f"{bf16_bytes} bf16 parameter bytes (margin "
            f"{SERVE_LOAD_MARGIN}); {card}")
        if not resumed or added > bf16_bytes + SERVE_LOAD_MARGIN:
            raise AssertionError("the serving restore did not resume, or "
                                 "added more than the bf16 parameters")
        in_memory = serving_params(state_r.model, scfg.dtype)
        del state_r, step_r
        differ = [k for k, v in in_memory.state_dict().items()
                  if not torch.equal(served.state_dict()[k], v)]
        if differ:
            raise AssertionError(f"served params differ from R's cast in "
                                 f"memory: {differ[:8]}")
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, scfg.vocab_size, n).tolist()
                   for n in (100, 257, 512, 600)]
        n_new = CKPT["new_tokens"]
        tokens = {}
        for what, params in (("restored", served), ("in memory", in_memory)):
            srv = make_server("127.0.0.1", 0, params, scfg,
                              **dict(RING, prewarm=True))
            th = threading.Thread(target=srv.serve_forever, daemon=True)
            th.start()
            base_url = f"http://127.0.0.1:{srv.server_address[1]}"
            batcher = srv.generator.batcher
            results, errors = {}, []

            def send(i, p):
                try:
                    results[i] = _post(base_url, {"tokens": [p],
                                                  "max_new_tokens": n_new})
                except Exception as e:        # surfaced after the join
                    errors.append(f"{i}: {e!r}")

            try:
                if not batcher.prewarmed.wait(600) or \
                        batcher.executor.needs_capture:
                    raise AssertionError("the ring's CUDA graphs were not "
                                         "captured at prewarm")
                chunks0 = batcher.stats["chunks"]
                _zero_launches()
                threads = [threading.Thread(target=send, args=(i, p))
                           for i, p in enumerate(prompts)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                chunks = batcher.stats["chunks"] - chunks0
            finally:
                srv.shutdown()
                srv.server_close()
                th.join(timeout=30)
                srv.generator.close()
            launches = DA.paged_decode_attention.launches
            others = (DA.decode_attention.launches,
                      DA.paged_decode_attention.quant_launches,
                      FA.flash_forward.launches)
            if errors:
                raise AssertionError(f"serving requests failed: {errors}")
            rows = []
            for i, p in enumerate(prompts):
                code, body, _ = results[i]
                if code != 200:
                    raise AssertionError(f"{what} {i}: HTTP {code}")
                _check_rows(scfg, p, body["tokens"][0], n_new, f"{what} {i}")
                rows.append(body["tokens"][0])
            tokens[what] = rows
            want = scfg.n_layers * RING["chunk_tokens"] * chunks
            log(f"checkpoint serve ({what}): 4 prompts x {n_new} greedy "
                f"tokens; paged_decode_attention launches {launches} "
                f"(n_layers {scfg.n_layers} x chunk {RING['chunk_tokens']} "
                f"x dispatches {chunks} = {want}); kernel #1, int8 kernel, "
                f"flash forward {others}")
            if launches != want or any(others):
                raise AssertionError(f"checkpoint serve ({what}): the "
                                     "paged kernel's launches do not match "
                                     "the formula, or another kernel ran")
        if tokens["restored"] != tokens["in memory"]:
            raise AssertionError("the restored checkpoint's tokens differ "
                                 "from the in-memory model's")
        del served, in_memory

        summary = {
            "layers": layers, "params": params_n,
            "checkpoint_bytes": save_u["bytes"],
            "snapshot_s": [save_u["snapshot_s"], save_r["snapshot_s"]],
            "write_s": [save_u["write_s"], save_r["write_s"]],
            "write_gb_s": [save_u["bytes"] / save_u["write_s"] / 1e9,
                           save_r["bytes"] / save_r["write_s"] / 1e9],
            "train_restore_s": restore_s,
            "serve_restore_s": serve_restore_s,
            "serve_restore_added_bytes": added,
            "bf16_param_bytes": bf16_bytes,
            "unbroken_spread": spread, "continued_worst": worst,
            "losses_u": losses_u, "losses_u2": losses_u2,
            "losses_continued": losses_d, "card": card,
        }
        log("checkpoint: " + json.dumps(summary))
        log(f"checkpoint (one run, not a benchmark): "
            f"{save_u['bytes'] / 1e9:.3f} GB a step; save() held the loop "
            f"{save_u['snapshot_s']:.3f}s (U, step 6) / "
            f"{save_r['snapshot_s']:.3f}s (R's drain); background write "
            f"{save_u['write_s']:.2f}s ({summary['write_gb_s'][0]:.2f} "
            f"GB/s) / {save_r['write_s']:.2f}s "
            f"({summary['write_gb_s'][1]:.2f} GB/s); restore "
            f"{restore_s:.3f}s (training) / {serve_restore_s:.3f}s "
            f"(serving, bf16); {card}")
        reports["flash_forward"]["checkpoint"] = summary
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# phase 3k: the single-card depth recipe at 7b width, B x (S + 1) tokens,
# bf16 compute, one repeated batch.  (a) full depth with int8 moments
# resident, (b) the same offloaded, then at 8 layers f32 against int8
# moments and f32 offloaded, and the remat policies (int8 moments).  lr
# 3e-4, make_optimizer's default: at 3c's 1e-3 the 32-layer run spiked
# and ended at 0.78x its first loss (12 steps, int8 moments; 8 layers
# at 1e-3 fall to 0.03x in 5 steps, int8 as f32) on an H100 80GB HBM3
# at 700 W.  For the script's limit, once 3s (b) ran its cp and pp
# meshes, (a) runs 6 steps (12 before), (b) 3 (6), and the f32 pair 2
# layers (8; phase 3c trains 8 layers with f32 moments): 70.9 -> 40.7 s
# on an H100 80GB HBM3 at 700 W, most of it the f32 slab's pinning; once
# 3s (b) ran its ep and elastic runs, (b) offloads (c)'s 8-layer int8 run
# (32 layers before: 11.5 s of its 42.5 s the slab's pinning on an H100
# 80GB HBM3 at 700 W) and (a) runs 4 steps (6 before; 1.13 s a step)
DEPTH = dict(batch=4, seq=2048, lr=3e-4, steps=6, offload_steps=3,
             full_depth_steps=4)
DEPTH_RUNS = (("a", 32, "int8", False, "full", "full_depth_steps"),
              ("b", 8, "int8", True, "full", "offload_steps"),
              ("c_f32", 2, "f32", False, "full", "steps"),
              ("c_int8", 8, "int8", False, "full", "steps"),
              ("c_f32_offload", 2, "f32", True, "full", "steps"),
              ("d_save_attn", 8, "int8", False, "save_attn", "steps"),
              ("d_dots", 8, "int8", False, "dots", "steps"))
# (b)'s peak must sit this far below c_int8's: the int8 codes and scales
# (3.82 GB at 7b width and 8 layers; 13.69 GB at 32, where the offload
# saved 13.09) leave the card, the staging ring (3 slots of the largest
# tensor's, 0.27 GB each) stays; 9/10 of what that leaves, for the
# allocator's rounding
OFFLOAD_SAVING_GB = 0.9 * (3.82 - 3 * 0.27)


def _depth_run(name, layers, moments, offload, policy, steps) -> dict:
    """One run of phase 3k: build, train ``steps`` steps through ``fit``,
    read the counters and the clocks, free everything."""
    import itertools
    import statistics

    import numpy as np
    import torch

    from paddle_operator_tpu_torch.models.llama import make_model
    from paddle_operator_tpu_torch.ops import adam8bit as A8
    from paddle_operator_tpu_torch.ops import flash_attention as FA
    from paddle_operator_tpu_torch.train import trainer as T
    from paddle_operator_tpu_torch.train.data import (
        DevicePrefetcher, deterministic_lm_batches)
    from paddle_operator_tpu_torch.utils.observability import StepTimer

    b, s = DEPTH["batch"], DEPTH["seq"]
    gc.collect()
    torch.cuda.empty_cache()
    base_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    model, cfg = make_model("7b", device="cuda", seed=0, n_layers=layers,
                            remat_policy=policy)
    opt = T.make_optimizer(DEPTH["lr"], warmup_steps=1, decay_steps=1000,
                           moments=moments)
    state = T.create_state(model, opt, offload_opt_state=offload)
    off = state.opt_state.offload
    if off is not None:
        off.timed = True
    moments_at = {(f, k): t.data_ptr() for f, field in
                  state.opt_state.tensors().items() for k, t in field.items()}
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    marks = []
    update = opt.update

    def timed_update(params, grads, st):
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        norm = update(params, grads, st)
        pair[1].record()
        marks.append(pair)
        return norm

    opt.update = timed_update          # make_train_step calls opt.update
    step = T.make_train_step(opt)
    batch = next(deterministic_lm_batches(b, s + 1, cfg.vocab_size, seed=0))
    batches = DevicePrefetcher(itertools.repeat(batch, steps), device="cuda")
    timer = StepTimer(b * s, cfg.flops_per_token(), PEAK_BF16, window=steps,
                      clock=_synced_clock)
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = _synced_clock()
    state, history = T.fit(state, step, batches, steps=steps, timer=timer)
    wall = _synced_clock() - t0
    counts = {"fwd": FA.flash_forward.launches,
              "dkv": FA.flash_backward_dkv.launches,
              "dq": FA.flash_backward_dq.launches,
              "adam8bit": A8.adam8bit_update.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - base_gb
    losses = [h["loss"] for h in history]
    norms = [h["grad_norm"] for h in history]
    tensors = len(list(model.parameters()))
    step_ms = statistics.median(list(timer.times)[1:]) * 1e3
    tok_s = b * s / (step_ms / 1e3)
    run = {
        "layers": layers, "moments": moments, "offload": offload,
        "remat_policy": policy, "steps": steps,
        "params": cfg.num_params(), "build_s": build_s,
        "losses": losses, "grad_norms": norms, "fit_wall_s": wall,
        "step_ms_median": step_ms,
        "step_ms": [t * 1e3 for t in timer.times],
        "tokens_per_s": tok_s,
        "mfu": tok_s * cfg.flops_per_token() / PEAK_BF16,
        "max_memory_allocated_gb": peak_gb,
        "allocated_before_gb": base_gb,
        "update_device_ms": [a.elapsed_time(z) for a, z in marks],
        "launches": counts, "tensors": tensors,
    }
    run["update_device_ms_median"] = statistics.median(
        run["update_device_ms"][1:])
    if off is not None:
        h2d_ms, d2h_ms = off.copy_ms()
        run.update(pin_s=off.pin_s, bytes_each_way=off.bytes_each_way,
                   h2d_ms=h2d_ms, d2h_ms=d2h_ms,
                   h2d_gb_per_s=off.bytes_each_way / 1e9 / (h2d_ms / 1e3),
                   d2h_gb_per_s=off.bytes_each_way / 1e9 / (d2h_ms / 1e3))
        host = [((f, k), t) for f, field in state.opt_state.tensors().items()
                for k, t in field.items()]
        bad = [k for k, t in host if t.device.type != "cpu"
               or not t.is_pinned() or t.data_ptr() != moments_at[k]]
        if bad:
            raise AssertionError(f"3k {name}: moments not in their pinned "
                                 f"host tensors between steps: {bad[:5]}")
    log(f"depth {name}: " + json.dumps({k: v for k, v in run.items()
                                        if k != "step_ms"}))
    if len(history) != steps or not all(np.isfinite(losses + norms)):
        raise AssertionError(f"3k {name}: fit ran {len(history)} of {steps} "
                             "steps, or a loss or grad norm is not finite")
    if not losses[-1] < 0.7 * losses[0]:
        raise AssertionError(f"3k {name}: the loss did not fall below 0.7x "
                             f"its first value: {losses[0]} -> {losses[-1]}")
    fwd_per = 1 if policy == "save_attn" else 2
    want = {"fwd": fwd_per * layers * steps, "dkv": layers * steps,
            "dq": layers * steps,
            "adam8bit": tensors * steps if moments == "int8" else 0}
    if counts != want:
        raise AssertionError(f"3k {name}: launches {counts}, the formulas "
                             f"say {want}")
    del state, step, model, opt, batches, timer
    gc.collect()
    torch.cuda.empty_cache()
    return run


def phase_depth_recipe(report: dict) -> None:
    """Phase 3k: the depth recipe; see the module docstring."""
    t0 = time.perf_counter()
    runs = {}
    for name, layers, moments, offload, policy, steps in DEPTH_RUNS:
        runs[name] = _depth_run(name, layers, moments, offload, policy,
                                DEPTH[steps])
    a, b = runs["c_int8"], runs["b"]
    n = b["steps"]
    if (a["losses"][:n], a["grad_norms"][:n]) != (b["losses"],
                                                  b["grad_norms"]):
        raise AssertionError("3k: the offloaded run's losses or grad norms "
                             "differ from the resident run's")
    f32, f32_off = runs["c_f32"], runs["c_f32_offload"]
    if (f32["losses"], f32["grad_norms"]) != (f32_off["losses"],
                                              f32_off["grad_norms"]):
        raise AssertionError("3k: the offloaded f32 run differs from the "
                             "resident one")
    saved = a["max_memory_allocated_gb"] - b["max_memory_allocated_gb"]
    if saved < OFFLOAD_SAVING_GB:
        raise AssertionError(f"3k: the offloaded peak is {saved:.2f} GB "
                             f"below the resident one (need "
                             f"{OFFLOAD_SAVING_GB})")
    for name, r in runs.items():
        log(f"depth {name} ({r['layers']} layers, {r['moments']} moments"
            f"{', offloaded' if r['offload'] else ''}, remat "
            f"{r['remat_policy']}; one run of {r['steps']} steps, not a "
            f"benchmark): step {r['step_ms_median']:.1f} ms, "
            f"{r['tokens_per_s']:.0f} tokens/s, MFU {r['mfu']:.3f}, peak "
            f"{r['max_memory_allocated_gb']:.2f} GB, update "
            f"{r['update_device_ms_median']:.2f} device ms"
            + (f", H2D {r['h2d_gb_per_s']:.1f} / D2H {r['d2h_gb_per_s']:.1f}"
               f" GB/s, pinning {r['pin_s']:.1f} s" if r["offload"] else "")
            + f"; loss {r['losses'][0]:.3f} -> {r['losses'][-1]:.3f}")
    log(f"depth: offloaded == resident bit for bit ({n} steps, int8; "
        f"{f32['steps']} steps, f32); the offload saves {saved:.2f} GB of "
        f"peak; on {card_line()}; {time.perf_counter() - t0:.1f}s")
    report["launches"] = a["launches"]["adam8bit"]
    report["depth"] = runs


def phase_kernel_path_equals_plain() -> None:
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.models.llama import make_model

    params, cfg = make_model("7b", device="cuda", seed=1, n_layers=2,
                             dtype=torch.float32)
    kcfg = dataclasses.replace(cfg, decode_attn="kernel")
    pcfg = dataclasses.replace(cfg, decode_attn="plain")
    prompt = torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 64)),
        dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        a = D.generate(params, kcfg, prompt, max_new_tokens=16, max_len=256)
        b = D.generate(params, pcfg, prompt, max_new_tokens=16, max_len=256)
        if not torch.equal(a, b):
            raise AssertionError("greedy tokens differ between the kernel "
                                 "and the plain decode path")
        lk, ck = D.prefill(params, kcfg, prompt, 256)
        lp, cp = D.prefill(params, pcfg, prompt, 256)
        err = 0.0
        for t in range(16):
            tok = a[:, 64 + t]
            lk, ck = D.decode_step(params, kcfg, tok, ck)
            lp, cp = D.decode_step(params, pcfg, tok, cp)
            err = max(err, float((lk - lp).abs().max()))
    log(f"kernel path == plain path (7b width, 2 layers, f32): tokens "
        f"identical, max logit diff {err:.3e} (limit 1e-3)")
    if err > 1e-3:
        raise AssertionError(f"kernel vs plain decode logits differ by "
                             f"{err}")
    del params
    torch.cuda.empty_cache()


def phase_rings_equal_generate() -> None:
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
    from paddle_operator_tpu_torch.models.llama import make_model
    from paddle_operator_tpu_torch.ops import decode_attention as DA

    params, cfg = make_model("7b", device="cuda", seed=3, n_layers=2,
                             dtype=torch.float32)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (300, 64, 513)]
    # a prefix hit: the 513-token prompt's two full blocks + 7 tokens
    prompts.append(prompts[2][:512]
                   + rng.integers(0, cfg.vocab_size, 7).tolist())
    n_new, max_len = 16, 1024
    with torch.inference_mode():
        want = [D.generate(params, cfg,
                           torch.tensor([p], dtype=torch.int32,
                                        device="cuda"),
                           max_new_tokens=n_new, max_len=max_len)[0]
                .tolist() for p in prompts]
    for paged in (True, False):
        DA.decode_attention.launches = 0
        DA.paged_decode_attention.launches = 0
        ring = ContinuousBatcher(params, cfg, slots=4, max_len=max_len,
                                 chunk_tokens=8, paged=paged,
                                 block_size=256)
        try:
            got = [h.result(timeout=600) for h in
                   [ring.submit(p, max_new_tokens=n_new) for p in prompts]]
        finally:
            ring.close()
        contiguous = DA.decode_attention.launches
        launched = DA.paged_decode_attention.launches
        name = "paged" if paged else "contiguous"
        hit = ring.pool.stats["prefix_hit_tokens"] if paged else 0
        log(f"{name} ring == generate (7b width, 2 layers, f32): "
            f"{sum(g == w for g, w in zip(got, want))}/{len(want)} rows "
            f"equal; paged kernel launches {launched}, kernel #1 "
            f"{contiguous}; prefix hit tokens {hit}")
        if got != want:
            raise AssertionError(f"the {name} ring's greedy tokens differ "
                                 "from generate")
        if paged and (not launched or contiguous or hit < 512):
            raise AssertionError("the paged ring did not run the paged "
                                 "kernel alone, or missed the prefix hit")
        if not paged and (launched or not contiguous):
            raise AssertionError("the contiguous ring did not run kernel "
                                 "#1 alone")
    del params
    torch.cuda.empty_cache()


def phase_quant_ring_kernel_equals_plain() -> None:
    """Phase 4d: the int8 ring through its kernel and through the plain
    dequantizing view; see the module docstring."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.infer import paged as PG
    from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
    from paddle_operator_tpu_torch.models.llama import make_model
    from paddle_operator_tpu_torch.ops import decode_attention as DA

    params, cfg = make_model("7b", device="cuda", seed=4, n_layers=2,
                             dtype=torch.float32)
    kcfg = dataclasses.replace(cfg, decode_attn="kernel")
    pcfg = dataclasses.replace(cfg, decode_attn="plain")
    bs, max_len, n_new = 16, 256, 24
    rng = np.random.default_rng(4)
    a = rng.integers(0, cfg.vocab_size, 48).tolist()     # three blocks
    first = [a, rng.integers(0, cfg.vocab_size, 37).tolist()]
    # once a's blocks are cached: a again (a block-aligned full hit,
    # capped at 47 tokens) and a[:40] (its hit ends mid-block)
    then = [a, a[:40]]
    got = {}
    for name, c in (("kernel", kcfg), ("plain", pcfg)):
        DA.paged_decode_attention.launches = 0
        DA.paged_decode_attention.quant_launches = 0
        ring = ContinuousBatcher(params, c, slots=4, max_len=max_len,
                                 chunk_tokens=8, paged=True, block_size=bs,
                                 kv_quant="int8")
        try:
            rows = [h.result(timeout=600) for h in
                    [ring.submit(p, max_new_tokens=n_new) for p in first]]
            rows += [h.result(timeout=600) for h in
                     [ring.submit(p, max_new_tokens=n_new) for p in then]]
            hits = ring.pool.stats["prefix_hit_tokens"]
            cow = ring.pool.stats["cow_copies"]
            ring.pool.check_invariant()
        finally:
            ring.close()
        launched = DA.paged_decode_attention.quant_launches
        log(f"int8 ring, {name} path (7b width, 2 layers, f32, bs {bs}): "
            f"int8 kernel launches {launched}, bf16 paged kernel "
            f"{DA.paged_decode_attention.launches}; prefix hit tokens "
            f"{hits}, CoW copies {cow}")
        if DA.paged_decode_attention.launches or \
                (launched == 0) != (name == "plain"):
            raise AssertionError(f"the int8 ring's {name} path ran the "
                                 "wrong kernels")
        if hits != 47 + 39 or cow < 2:
            raise AssertionError(f"expected a full hit (47) and a mid-block "
                                 f"hit (39) with copy-on-write, got {hits} "
                                 f"hit tokens and {cow} copies")
        got[name] = rows
    if got["kernel"] != got["plain"]:
        raise AssertionError("greedy tokens differ between the int8 ring's "
                             "kernel and plain paths")

    # per-tick logits: one lane prefilled through the cold paged prefill
    # (37 tokens), then 44 ticks (blocks complete at 47, 63 and 79).  Each
    # tick runs the plain path from a copy of the kernel path's state, so
    # the two are held against each other one tick at a time: from free
    # running states a last-bit difference upstream can move a code
    # across a midpoint when a block quantizes, and that difference then
    # stays.  The unquantized pool (here f32) runs beside them (reported,
    # not gated).
    n = 37
    prompt = torch.tensor([first[1]], dtype=torch.int32, device="cuda")
    table = torch.arange(1, max_len // bs + 1, dtype=torch.int32,
                         device="cuda")[None]
    caches = {}
    with torch.inference_mode():
        for name, quant in (("int8", "int8"), ("plain-pool", "none")):
            cache = PG.init_paged_cache(kcfg, 1, max_len // bs + 1, bs,
                                        quant=quant)
            out = D.paged_prefill(params, kcfg, prompt, cache, table[0],
                                  block_size=bs, last_only=True,
                                  quant=quant == "int8", prompt_len=n)
            if quant == "int8":
                cache["kt"][:, 0], cache["vt"][:, 0] = out[2][:, 0], \
                    out[3][:, 0]
            cache["pos"][0] = n
            caches[name] = cache
        tok = out[0][0, -1].argmax(-1).reshape(1).to(torch.int32)
        err = vs_pool = 0.0
        for _ in range(44):
            twin = {k: t.clone() for k, t in caches["int8"].items()}
            lk, _ = PG.paged_ring_forward(kcfg, params, tok, caches["int8"],
                                          table, quant=True)
            lp, _ = PG.paged_ring_forward(pcfg, params, tok, twin, table,
                                          quant=True)
            lb, _ = PG.paged_ring_forward(kcfg, params, tok,
                                          caches["plain-pool"], table)
            for cache in caches.values():
                cache["pos"] += 1
            err = max(err, float((lk - lp).abs().max()))
            vs_pool = max(vs_pool, float((lk - lb).abs().max()))
            tok = lk[0].argmax(-1).reshape(1).to(torch.int32)
    log(f"int8 ring kernel path == plain path (7b width, 2 layers, f32, bs "
        f"{bs}): tokens identical over {len(first) + len(then)} requests, "
        f"max logit diff {err:.3e} over 44 ticks from the same state "
        f"(limit 1e-3); int8 against the unquantized pool (not gated): "
        f"worst logit delta {vs_pool:.3e}")
    if err > 1e-3:
        raise AssertionError(f"int8 kernel vs plain ring logits differ by "
                             f"{err}")
    del params, caches
    torch.cuda.empty_cache()


MEGA_RINGS = (("contiguous", {"paged": False}),
              ("paged", {"paged": True, "block_size": 16}),
              ("int8", {"paged": True, "block_size": 16,
                        "kv_quant": "int8"}))


def _admit_cold(ex, slot, prompt, aid: int = 0) -> None:
    """A cold admission into a bare executor, as the scheduler makes it:
    map the lane's blocks (paged), set the lane's adapter slot ``aid`` (an
    adapter ring) and run the bucket's insert."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import executor as X

    n = len(prompt)
    bucket = next(b for b in ex.buckets if n <= b)
    dev_prompt = X.to_device(np.asarray([prompt], np.int32), ex.device)
    ex.set_aid(slot, aid)
    lora = ex.lora_insert_tail(slot)
    if ex.paged:
        ex.pool.admit(slot, prompt,
                      ns=ex.adapters.ns_of(aid) if aid else 0)
        row = X.to_device(ex.pool.table[slot], ex.device, torch.int32)
        ex.inserts[bucket](ex.params, ex.cache, row, ex.tok, ex.temp,
                           ex.seeds, dev_prompt, n, slot, 0.0, 0, lora=lora)
    else:
        ex.inserts[bucket](ex.params, ex.cache, ex.tok, ex.temp, ex.seeds,
                           dev_prompt, n, slot, 0.0, 0, lora=lora)


def phase_megastep_rings() -> None:
    """Phase 4e: megastep 4 == megastep 1 on the three rings, and graph
    replay == the eager program; see the module docstring."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import executor as X
    from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
    from paddle_operator_tpu_torch.models.llama import make_model

    params, cfg = make_model("7b", device="cuda", seed=5, n_layers=2,
                             dtype=torch.float32)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (40, 300, 129, 64)]
    n_new, max_len, chunk = 40, 512, 8

    def serve(ring, megastep, eos=None, freeze=False):
        b = ContinuousBatcher(params, cfg, slots=4, max_len=max_len,
                              chunk_tokens=chunk, megastep=megastep,
                              prewarm=True, **ring)
        budgets = []
        if freeze:
            # a huge per-iteration estimate: every lane's step budget is
            # 1 of 4 iterations, so lanes freeze mid-megastep
            b._step_s_est = 3000.0
            real = b.executor.replay

            def spy(plan):
                budgets.append(int(np.min(
                    plan.steps[np.asarray(plan.active, bool)])))
                return real(plan)

            b.executor.replay = spy
        try:
            b.prewarmed.wait(600)
            out = [h.result(timeout=600) for h in [
                b.submit(p, max_new_tokens=n_new, eos_token=eos,
                         deadline_s=3000.0 if freeze else None)
                for p in prompts]]
            if b.pool is not None:
                b.pool.check_invariant()
            return out, dict(b.stats), budgets
        finally:
            b.close()

    for name, ring in MEGA_RINGS:
        one, s1, _ = serve(ring, 1)
        four, s4, _ = serve(ring, 4)
        # an eos that first fires inside a fused iteration, after the
        # first (new token 0 comes from the prefill, 1-8 from iteration
        # 0), and not on a chunk's last tick
        r, at = next((r, i) for r, out in enumerate(one)
                     for i in range(10, n_new)
                     if out[len(prompts[r]) + i]
                     not in out[len(prompts[r]):len(prompts[r]) + i]
                     and i % chunk)
        eos = one[r][len(prompts[r]) + at]
        one_e, _, _ = serve(ring, 1, eos)
        four_e, _, _ = serve(ring, 4, eos)
        cut = len(one_e[r]) - len(prompts[r])
        if cut != at + 1:
            raise AssertionError(f"{name} ring: eos {eos} cut request {r} "
                                 f"to {cut} new tokens, expected {at + 1}")
        line = (f"megastep {name} ring (7b width, 2 layers, f32): N=4 "
                f"tokens == N=1 on {sum(a == b for a, b in zip(four, one))}"
                f"/{len(one)} requests, dispatches {s4['chunks']} vs "
                f"{s1['chunks']}; eos {eos} cut request {r} to {cut} new "
                f"tokens, N=4 == N=1 on "
                f"{sum(a == b for a, b in zip(four_e, one_e))}/{len(one)}")
        if four != one or four_e != one_e or not s4["chunks"] < s1["chunks"]:
            raise AssertionError(line)
        if ring["paged"]:
            frozen, _, budgets = serve(ring, 4, freeze=True)
            line += (f"; frozen lanes (step budgets {sorted(set(budgets))})"
                     f" resume == N=1 on "
                     f"{sum(a == b for a, b in zip(frozen, one))}/{len(one)}")
            if frozen != one or min(budgets) != 1:
                raise AssertionError(line)
        log(line)

    # graph replay == the eager program, on executors driven alike
    with torch.inference_mode():
        for name, ring in MEGA_RINGS:
            exs = []
            for _ in range(2):
                ex = X.RingExecutor(params, cfg, slots=4, max_len=max_len,
                                    chunk_tokens=chunk, megastep=4, **ring)
                exs.append(ex)
            graph, eager = exs
            graph.prewarm()
            for ex in exs:
                for slot, p in enumerate(prompts):
                    _admit_cold(ex, slot, p)
            gone = 0
            for k in range(6):
                n = 4 if k % 2 else 1
                for ex in exs:
                    if ex.paged:
                        for slot, p in enumerate(prompts):
                            ex.pool.ensure(slot, len(p) + (k + 1) * 4 * chunk)
                plan = X.ExecPlan(
                    n, [True, True, True, k < 4],
                    table=graph.pool.table if graph.paged else None,
                    eos=np.asarray([-1, eos, -1, -1], np.int32),
                    left=np.asarray([500, 500, 20, 500], np.int32),
                    steps=np.asarray([4, 4, 4, 2 if graph.paged else 4],
                                     np.int32))
                gt, gc_ = graph.replay(plan).host()
                et, ec = X.DispatchResult(*eager.run(plan), n).host()
                same = (np.array_equal(gt, et)
                        and (n == 1 or np.array_equal(gc_, ec))
                        and torch.equal(graph.cache["pos"],
                                        eager.cache["pos"])
                        and torch.equal(graph.tok, eager.tok))
                if not same:
                    raise AssertionError(f"{name} ring: graph replay {k} "
                                         f"({n} steps) differs from the "
                                         "eager program")
                if n > 1:
                    gone += int((ec.sum(axis=0) < 4 * chunk).sum())
            log(f"megastep {name} ring: 6 graph replays (1- and 4-step) == "
                f"the eager program bit for bit (toks, counts, pos, tok); "
                f"lanes cut short in fused dispatches {gone}; capture "
                f"{graph.capture_s:.2f}s, graph pool "
                f"{graph.graph_pool_bytes()} bytes")
            del exs, graph, eager
    del params
    torch.cuda.empty_cache()


def _restore_run(ex, prompts, megastep, graphs: bool, spill_at=None):
    """Phase 4f's drive of one executor, every dispatch a graph replay
    (``graphs``) or the eager program: lane A (``prompts[0]``) decodes
    alone in slot 0; with ``spill_at`` set it is spilled after that many
    dispatches, lane B (``prompts[1]``) takes slot 0 for one dispatch,
    A is restored into slot 1 and both continue.  Returns A's tokens
    over the dispatches (the admission's first token aside) and what
    the restore saw: the state's addresses before and after, the graphs
    object before and after, and A's kernel launches after it."""
    import numpy as np

    from paddle_operator_tpu_torch.infer import executor as X
    from paddle_operator_tpu_torch.ops import decode_attention as DA

    chunk, total = ex.chunk, 3 if megastep > 1 else 6
    pos = {0: len(prompts[0])}
    slot_a, seen = 0, {}

    def dispatch():
        for slot, p in pos.items():
            ex.pool.ensure(slot, p + megastep * chunk)
        active = [i in pos for i in range(ex.slots)]
        plan = X.ExecPlan(megastep, active, table=ex.pool.table,
                          eos=np.full(ex.slots, -1, np.int32),
                          left=np.full(ex.slots, 1000, np.int32),
                          steps=np.full(ex.slots, megastep, np.int32))
        res = ex.replay(plan) if graphs else X.DispatchResult(
            *ex.run(plan), megastep)
        toks, _ = res.host()
        for slot in pos:
            pos[slot] += megastep * chunk
        return toks.reshape(-1, ex.slots)

    _admit_cold(ex, 0, prompts[0])
    got = []
    for k in range(total):
        if k == spill_at:
            spill = ex.spill_lane(0)
            ex.pool.retire(0)
            del pos[0]
            _admit_cold(ex, 0, prompts[1])
            pos[0] = len(prompts[1])
            dispatch()
            seen["ptrs"], seen["graphs"] = ex._state_ptrs(), ex._graphs
            ex.restore_lane(1, spill)
            seen["ptrs_after"], seen["graphs_after"] = (ex._state_ptrs(),
                                                        ex._graphs)
            pos[1] = spill["pos"]
            slot_a = 1
            seen["launches"] = (DA.paged_decode_attention.launches
                                + DA.paged_decode_attention.quant_launches)
        got += dispatch()[:, slot_a].tolist()
    if spill_at is not None:
        seen["launches"] = (DA.paged_decode_attention.launches
                            + DA.paged_decode_attention.quant_launches
                            - seen["launches"])
        ex.pool.check_invariant()
    return got, seen


def phase_restore_under_graphs() -> None:
    """Phase 4f: a lane spilled at a boundary and restored into another
    slot under CUDA graph replay resumes the uninterrupted stream bit for
    bit; see the module docstring."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import executor as X
    from paddle_operator_tpu_torch.models.llama import make_model

    params, cfg = make_model("7b", device="cuda", seed=6, n_layers=2,
                             dtype=torch.float32)
    pcfg = dataclasses.replace(cfg, decode_attn="plain")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (40, 57)]
    rings = (("paged", {"paged": True, "block_size": 16}, 1),
             ("paged", {"paged": True, "block_size": 16}, 4),
             ("int8", {"paged": True, "block_size": 16, "kv_quant": "int8"},
              1))
    with torch.inference_mode():
        for name, ring, megastep in rings:
            def executor(c):
                return X.RingExecutor(params, c, slots=2, max_len=256,
                                      chunk_tokens=8, megastep=megastep,
                                      **ring)

            spill_at = 1 if megastep > 1 else 2
            ref_ex = executor(cfg)
            ref_ex.prewarm()
            want, _ = _restore_run(ref_ex, prompts, megastep, True)
            del ref_ex
            ex = executor(cfg)
            ex.prewarm()
            replays0 = ex.graph_replays
            got, seen = _restore_run(ex, prompts, megastep, True, spill_at)
            replays = ex.graph_replays - replays0
            del ex
            plain, _ = _restore_run(executor(pcfg), prompts, megastep,
                                    False, spill_at)
            line = (f"restore under graphs, {name} ring megastep {megastep} "
                    f"(7b width, 2 layers, f32, bs 16): spilled at pos "
                    f"{len(prompts[0]) + spill_at * megastep * 8}, restored "
                    f"into slot 1; {len(got)} tokens == uninterrupted: "
                    f"{got == want}, == plain path (eager): {plain == got}; "
                    f"addresses kept {seen['ptrs'] == seen['ptrs_after']}, "
                    f"no recapture {seen['graphs'] is seen['graphs_after']}; "
                    f"{replays} replays, paged kernel launches after the "
                    f"restore {seen['launches']}")
            log(line)
            if (got != want or plain != got
                    or seen["ptrs"] != seen["ptrs_after"]
                    or seen["graphs"] is not seen["graphs_after"]
                    or not seen["launches"]):
                raise AssertionError(line)
    del params
    torch.cuda.empty_cache()



# phase 4g: 7b width, 2 layers, f32, bs 16: a ring whose pool holds one
# lane's worth of blocks demotes the prompts' chains while two 7-block
# fillers run, and host-hits them back; `ref` is the tier-off ring, a
# pool that never evicts (so its round 2 is all device hits); the store
# leg's tier (4 blocks) overflows the chains whole into the store
TIER_4G = dict(slots=2, max_len=128, chunk_tokens=8, block_size=16,
               small=8, ref=64, tier=16, store_tier=4, new=16, filler_new=8)


def phase_host_tier_equalities(params=None, cfg=None) -> None:
    """Phase 4g: host hits and store restarts give the tier-off ring's
    tokens, on the kernel and the plain path, bf16 and int8 pools,
    megastep 1 and 4, with the graphs and addresses kept; see the module
    docstring."""
    import tempfile

    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
    from paddle_operator_tpu_torch.infer.kvstore import (
        DirBackend,
        KVBlockStore,
    )
    from paddle_operator_tpu_torch.models.llama import make_model
    from paddle_operator_tpu_torch.ops import decode_attention as DA

    if params is None:
        params, cfg = make_model("7b", device="cuda", seed=7, n_layers=2,
                                 dtype=torch.float32)
    on_card = params.tok_embed.embedding.device.type == "cuda"
    pcfg = dataclasses.replace(cfg, decode_attn="plain")
    z = TIER_4G
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, 48).tolist()
               for _ in range(3)]
    prompts.append(prompts[0][:40])      # its hit ends mid-block
    fillers = [rng.integers(0, cfg.vocab_size, 112).tolist()
               for _ in range(2)]

    def serve(b, ps, new):
        return [b.submit(p, max_new_tokens=new).result(timeout=600)
                for p in ps]

    for kv_quant in ("none", "int8"):
        for megastep in (1, 4):
            def ring(c, **kw):
                return ContinuousBatcher(
                    params, c, slots=z["slots"], max_len=z["max_len"],
                    chunk_tokens=z["chunk_tokens"], paged=True,
                    block_size=z["block_size"], kv_quant=kv_quant,
                    megastep=megastep, prewarm=True, **kw)

            def round1(b):
                out = serve(b, prompts[:3], z["new"])
                serve(b, fillers, z["filler_new"])
                return out

            ref = ring(cfg, num_blocks=z["ref"])
            try:
                cold = round1(ref)
                want = serve(ref, prompts, z["new"])
                if ref.pool.stats["cache_evictions"]:
                    raise AssertionError("4g: the tier-off reference evicted")
            finally:
                ref.close()
            seen = {}
            for name, c in (("kernel", cfg), ("plain", pcfg)):
                b = ring(c, num_blocks=z["small"],
                         host_cache_blocks=z["tier"])
                try:
                    assert b.prewarmed.wait(600)
                    ex = b.executor
                    graphs, ptrs = ex._graphs, ex._state_ptrs()
                    first = round1(b)
                    _zero_launches()
                    got = serve(b, prompts, z["new"])
                    seen[name] = {
                        "round1": first == cold, "round2": got == want,
                        "promoted": b.stats["promoted_blocks"],
                        "kept": (ex._graphs is graphs
                                 and ex._state_ptrs() == ptrs),
                        "launches": (DA.paged_decode_attention.launches
                                     + DA.paged_decode_attention
                                     .quant_launches)}
                    b.pool.check_invariant()
                finally:
                    b.close()
            store_dir = tempfile.mkdtemp(prefix="chip-smoke-4g-")
            for leg in ("a", "b"):
                b = ring(cfg, num_blocks=z["small"],
                         host_cache_blocks=z["store_tier"])
                store = KVBlockStore(DirBackend(store_dir),
                                     fingerprint=b._fingerprint())
                b.attach_kv_store(store)
                try:
                    if leg == "a":
                        round1(b)
                        spilled = b.pool.stats["store_spills"]
                        assert store.flush(timeout=300)
                    else:
                        ex = b.executor
                        assert b.prewarmed.wait(600)
                        graphs, ptrs = ex._graphs, ex._state_ptrs()
                        got = serve(b, prompts, z["new"])
                        seen["store"] = {
                            "round2": got == want, "spilled": spilled,
                            "hits": b.stats["kv_store_hits"],
                            "promoted": b.stats["promoted_blocks"],
                            "kept": (ex._graphs is graphs
                                     and ex._state_ptrs() == ptrs)}
                    b.pool.check_invariant()
                finally:
                    b.close()
                    store.close()
            line = (f"host tier equalities, {kv_quant} pool megastep "
                    f"{megastep} (7b width, 2 layers, f32, bs 16): {seen}")
            log(line)
            k, p, s = seen["kernel"], seen["plain"], seen["store"]
            if not (k["round1"] and k["round2"] and p["round1"]
                    and p["round2"] and s["round2"]
                    and k["promoted"] >= 3 and p["promoted"] >= 3
                    and s["hits"] >= 1 and s["promoted"] >= 1
                    and (not on_card or (k["kept"] and p["kept"]
                                         and s["kept"]
                                         and k["launches"] > 0))):
                raise AssertionError(line)
    del params
    if on_card:
        torch.cuda.empty_cache()


def _first_difference(got, ref) -> list:
    """Per request: the first position of its sequence (prompt and new
    tokens) where ``got`` leaves ``ref`` (None where they agree)."""
    out = []
    for a, b in zip(got, ref):
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        out.append(i if i is not None or len(a) == len(b)
                   else min(len(a), len(b)))
    return out


# phase 4h's int8-pool steps: kernel route against the plain route from
# the same state, as 4d holds the int8 ring's attention (f32 logits)
QUANT_POOL_LOGIT_ATOL = 1e-3


def _quant_pool_steps(model, cfg, mode: str, prompts, n_new: int,
                      max_len: int) -> None:
    """Phase 4h (2): each prompt's cold paged prefill into an int8 pool
    through the kernels (kernel B above ``KERNEL_MAX_ROWS`` rows, kernel
    A below) and through the plain route, from empty pools: the logits
    of every position within :data:`QUANT_POOL_LOGIT_ATOL`, the pools'
    codes at most one step apart (a last-bit difference in an f32 sum
    moves a code across a rounding midpoint, no further) and the scales
    within :data:`QMM_F32_ATOL` of each other, relatively; then ``n_new`` ticks through kernel A, each also
    run on the plain route from a copy of the same state, the logits
    within the same limit.  The kernels must launch where the route
    sends each call."""
    import torch

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.infer import paged as PG
    from paddle_operator_tpu_torch.ops import quant_matmul as QM

    bs = 16
    table = torch.arange(1, max_len // bs + 1, dtype=torch.int32,
                         device="cuda")[None]
    per_call = 7 * cfg.n_layers
    for prompt in prompts:
        n = len(prompt)
        tokens = torch.tensor([prompt], dtype=torch.int32, device="cuda")
        caches, logits, launched = {}, {}, None
        for route in ("kernel", "plain"):
            cache = PG.init_paged_cache(cfg, 1, max_len // bs + 1, bs,
                                        quant="int8")
            n0 = (QM.quant_matmul.launches, QM.quant_gemm.launches)
            with (_plain_route() if route == "plain"
                  else contextlib.nullcontext()):
                out = D.paged_prefill(model, cfg, tokens, cache, table[0],
                                      block_size=bs, quant=True,
                                      prompt_len=n)
            if route == "kernel":
                launched = (QM.quant_matmul.launches - n0[0],
                            QM.quant_gemm.launches - n0[1])
            cache["kt"][:, 0], cache["vt"][:, 0] = out[2][:, 0], \
                out[3][:, 0]
            cache["pos"][0] = n
            caches[route], logits[route] = cache, out[0]
        k_cache, p_cache = caches["kernel"], caches["plain"]
        err = float((logits["kernel"] - logits["plain"]).abs().max())
        step = max(int((k_cache[key].int() - p_cache[key].int()).abs().max())
                   for key in ("k", "v"))
        moved = sum(int((k_cache[key] != p_cache[key]).sum())
                    for key in ("k", "v"))
        scale_err = max(float(((k_cache[key] - p_cache[key]).abs()
                               / p_cache[key].abs()).max())
                        for key in ("ks", "vs"))  # limit QMM_F32_ATOL
        want = ((0, per_call) if n > QM.KERNEL_MAX_ROWS
                else (per_call, 0))
        tok = logits["kernel"][0, -1].argmax(-1).reshape(1).to(torch.int32)
        tick_err, tick_a = 0.0, QM.quant_matmul.launches
        for _ in range(n_new):
            twin = {key: t.clone() for key, t in k_cache.items()}
            lk, _ = PG.paged_ring_forward(cfg, model, tok, k_cache, table,
                                          quant=True)
            with _plain_route():
                lp, _ = PG.paged_ring_forward(cfg, model, tok, twin, table,
                                              quant=True)
            k_cache["pos"] += 1
            tick_err = max(tick_err, float((lk - lp).abs().max()))
            tok = lk[0].argmax(-1).reshape(1).to(torch.int32)
        tick_a = QM.quant_matmul.launches - tick_a
        line = (f"weight quant {mode} int8 pool, {n}-token prefill and "
                f"{n_new} ticks, kernels against the plain route from the "
                f"same state (7b width, 2 layers, f32): prefill logits max "
                f"|diff| {err:.3e}, codes moved {moved} (at most {step} "
                f"step), scales rel diff {scale_err:.3e}, tick logits max "
                f"|diff| {tick_err:.3e} (limit {QUANT_POOL_LOGIT_ATOL}); "
                f"(kernel A, kernel B) prefill launches {launched} "
                f"(expected {want}), kernel A tick launches {tick_a} "
                f"(expected {per_call * n_new})")
        log(line)
        if err > QUANT_POOL_LOGIT_ATOL or tick_err > QUANT_POOL_LOGIT_ATOL \
                or step > 1 or scale_err > QMM_F32_ATOL or launched != want \
                or tick_a != per_call * n_new:
            raise AssertionError(line)
        del caches, logits, k_cache, p_cache


def phase_weight_quant_equalities() -> None:
    """Phase 4h: the weight-quantized rings under graph replay, through
    the int8-weight kernels, against the plain route; see the module
    docstring."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.infer import executor as X
    from paddle_operator_tpu_torch.infer import quant as Q
    from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
    from paddle_operator_tpu_torch.models.llama import CONFIGS, make_model
    from paddle_operator_tpu_torch.ops import quant_matmul as QM

    vocab = CONFIGS["7b"].vocab_size
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, vocab, n).tolist() for n in (40, 129, 64)]
    # a prefix hit: the 129-token prompt's first 16-token block and more
    prompts.append(prompts[1][:16] + rng.integers(0, vocab, 9).tolist())
    n_new, max_len = 24, 256
    pools = (("bf16 pool", {"paged": True, "block_size": 16}),
             ("int8 pool", {"paged": True, "block_size": 16,
                            "kv_quant": "int8"}))

    def ring(model, cfg, pool, megastep, route=None):
        with (route() if route else contextlib.nullcontext()):
            b = ContinuousBatcher(model, cfg, slots=4, max_len=max_len,
                                  chunk_tokens=8, megastep=megastep,
                                  prewarm=True, **pool)
            try:
                b.prewarmed.wait(600)
                if b.executor.needs_capture:
                    raise AssertionError("the ring's graphs were not "
                                         "captured")
                n0 = (QM.quant_matmul.launches, QM.quant_gemm.launches)
                out = [h.result(timeout=600) for h in [
                    b.submit(p, max_new_tokens=n_new) for p in prompts]]
                b.pool.check_invariant()
                return (out, b.executor.graph_replays,
                        (QM.quant_matmul.launches - n0[0],
                         QM.quant_gemm.launches - n0[1]))
            finally:
                b.close()

    with torch.inference_mode():
        for mode in ("int8", "int4"):
            model, cfg = make_model("7b", device="cuda", seed=8, n_layers=2,
                                    dtype=torch.float32)
            Q.quantize_params(model, cfg, mode=mode, skip=Q.SERVING_SKIP)
            with _plain_route():
                want = [D.generate(model, cfg, torch.tensor(
                    [p], dtype=torch.int32, device="cuda"),
                    max_new_tokens=n_new, max_len=max_len)[0].tolist()
                    for p in prompts]
            for name, pool in pools:
                quant = "kv_quant" in pool
                if quant:
                    # the int8 pool quantizes the KV: its reference is the
                    # same ring on the plain route
                    ref, _, plain_launches = ring(model, cfg, pool, 1,
                                                  _plain_route)
                    if plain_launches != (0, 0):
                        raise AssertionError("the plain route launched the "
                                             "int8-weight kernels")
                else:
                    ref = want
                outs = {}
                for megastep in (1, 4):
                    got, replays, launched = ring(model, cfg, pool,
                                                  megastep)
                    outs[megastep] = got
                    same = sum(a == b for a, b in zip(got, ref))
                    line = (f"weight quant {mode} {name} megastep "
                            f"{megastep} (7b width, 2 layers, f32, graph "
                            f"replays {replays}): kernel route == plain "
                            f"route on {same}/{len(ref)} requests"
                            + (f" (not gated; first differing position, "
                               f"prompt included, "
                               f"{_first_difference(got, ref)})"
                               if quant else "")
                            + f"; (kernel A, kernel B) launches {launched}")
                    log(line)
                    # the 129-token prompt prefills through kernel B's f32
                    # body, the others and the ticks through kernel A's
                    if (got != ref and not quant) or not replays \
                            or not all(launched):
                        raise AssertionError(line)
                if outs[1] != outs[4]:
                    raise AssertionError(f"weight quant {mode} {name}: the "
                                         "kernel route's megastep 4 tokens "
                                         "differ from megastep 1's")
                if not quant:
                    continue
                # the int8 pool, through the kernels, gated two ways.
                # (1) the port's route before kernel B — ticks and the
                # hit's suffix through kernel A, prefills by the formula
                # — gives the plain route's tokens under graphs, as it
                # did with PR 12's kernel.
                for megastep in (1, 4):
                    got, replays, launched = ring(
                        model, cfg, pool, megastep,
                        lambda: _formula_above(16))
                    line = (f"weight quant {mode} {name} megastep "
                            f"{megastep}, prefills by the formula and the "
                            f"rest through kernel A (graph replays "
                            f"{replays}): == plain route on "
                            f"{sum(a == b for a, b in zip(got, ref))}/"
                            f"{len(ref)} requests; (kernel A, kernel B) "
                            f"launches {launched}")
                    log(line)
                    if got != ref or not replays or not launched[0] \
                            or launched[1]:
                        raise AssertionError(line)
                # (2) every prefill and tick through the kernels, held to
                # the plain route one step at a time from the same state
                _quant_pool_steps(model, cfg, mode, prompts[:3], n_new,
                                  max_len)

            # one spill and restore under graphs (bf16 pool, megastep 1)
            def executor():
                return X.RingExecutor(model, cfg, slots=2, max_len=max_len,
                                      chunk_tokens=8, paged=True,
                                      block_size=16)

            ref_ex = executor()
            ref_ex.prewarm()
            uninterrupted, _ = _restore_run(ref_ex, prompts, 1, True)
            del ref_ex
            ex = executor()
            ex.prewarm()
            got, seen = _restore_run(ex, prompts, 1, True, 2)
            del ex
            with _plain_route():
                plain, _ = _restore_run(executor(), prompts, 1, False, 2)
            line = (f"weight quant {mode} spill and restore (bf16 pool, "
                    f"graphs): {len(got)} tokens == uninterrupted "
                    f"{got == uninterrupted}, == plain route (eager) "
                    f"{plain == got}; addresses kept "
                    f"{seen['ptrs'] == seen['ptrs_after']}")
            log(line)
            if got != uninterrupted or plain != got \
                    or seen["ptrs"] != seen["ptrs_after"]:
                raise AssertionError(line)
            del model
            torch.cuda.empty_cache()


def phase_chunked_equalities() -> None:
    """Phase 4i: chunked prefill == inline == ``generate`` on the three
    rings under graph replay; see the module docstring."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.infer import executor as X
    from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
    from paddle_operator_tpu_torch.models.llama import make_model
    from paddle_operator_tpu_torch.ops import decode_attention as DA

    params, cfg = make_model("7b", device="cuda", seed=7, n_layers=2,
                             dtype=torch.float32)
    rng = np.random.default_rng(7)
    first = [rng.integers(0, cfg.vocab_size, n).tolist()
             for n in (40, 300, 129, 64)]
    # then: the 64-token prompt again (a full hit capped at 63 rows, mid
    # block at bs 16: one CoW'd slice), and the 300-token prompt's first
    # 10 blocks with a 37-token suffix (a hit, then two slices of 24)
    then = [first[3], first[1][:160]
            + rng.integers(0, cfg.vocab_size, 37).tolist()]
    n_new, max_len, slice_rows = 16, 512, 24
    with torch.inference_mode():
        want = [D.generate(params, cfg,
                           torch.tensor([p], dtype=torch.int32,
                                        device="cuda"),
                           max_new_tokens=n_new, max_len=max_len)[0]
                .tolist() for p in first + then]
    counters = {"contiguous": (DA.decode_attention, "launches"),
                "paged": (DA.paged_decode_attention, "launches"),
                "int8": (DA.paged_decode_attention, "quant_launches")}
    for name, ring in MEGA_RINGS:
        outs = {}
        for mode, megastep, graphed in (("inline", 1, True),
                                        ("chunked", 1, True),
                                        ("chunked", 4, True),
                                        ("chunked", 1, False)):
            b = ContinuousBatcher(params, cfg, slots=4, max_len=max_len,
                                  chunk_tokens=8, megastep=megastep,
                                  prewarm=True, prefill_mode=mode,
                                  prefill_chunk=slice_rows, **ring)
            ex = b.executor
            try:
                if not b.prewarmed.wait(600) or ex.needs_capture:
                    raise AssertionError(f"4i {name}: no graphs captured: "
                                         f"{b.prewarm_error!r}")
                graphs, ptrs = ex._graphs, ex._state_ptrs()
                if not graphed:
                    # every dispatch through the eager program instead
                    ex.replay = lambda plan, ex=ex: X.DispatchResult(
                        *ex.run(plan), plan.n_steps)
                _zero_launches()
                out = [h.result(timeout=600) for h in [
                    b.submit(p, max_new_tokens=n_new) for p in first]]
                out += [b.submit(p, max_new_tokens=n_new).result(
                    timeout=600) for p in then]
                fn, attr = counters[name]
                launched = getattr(fn, attr)
                hits = (b.pool.stats["prefix_hit_tokens"]
                        if b.pool is not None else 0)
                bad = []
                if ex.graph_replays != graphed * b.stats["chunks"] or not (
                        ex._graphs is graphs and ex._state_ptrs() == ptrs):
                    bad.append("not every dispatch a replay of the "
                               "prewarm graphs at their addresses")
                if launched != cfg.n_layers * 8 * megastep * b.stats[
                        "chunks"] or not launched:
                    bad.append(f"{name} kernel launches {launched}")
                if mode == "chunked" and b.stats[
                        "chunked_prefill_tokens"] != b.stats[
                        "prefill_tokens"]:
                    bad.append("prefill tokens outside the slices")
                if b.pool is not None:
                    b.pool.check_invariant()
                    if hits != 63 + 160:
                        bad.append(f"prefix hit tokens {hits}")
                if bad:
                    raise AssertionError(f"4i {name} {mode} megastep "
                                         f"{megastep}: {bad}")
                outs[mode, megastep, graphed] = out
            finally:
                b.close()
        inline, chunked = outs["inline", 1, True], outs["chunked", 1, True]

        def agree(a, b):
            return f"{sum(x == y for x, y in zip(a, b))}/{len(b)}"

        line = (f"chunked {name} ring (7b width, 2 layers, f32, slices of "
                f"{slice_rows} rows, graph replays): chunked at megastep 4 "
                f"== megastep 1 on {agree(outs['chunked', 4, True], chunked)}"
                f" requests, == the eager program on "
                f"{agree(outs['chunked', 1, False], chunked)}; chunked == "
                f"inline on {agree(chunked, inline)}, inline == generate on "
                f"{agree(inline, want)}")
        log(line)
        if not (outs["chunked", 4, True] == chunked
                == outs["chunked", 1, False]):
            raise AssertionError(line)
        # the int8 pool's tokens need not equal the exact cache's, nor a
        # slice's (which reads its earlier blocks as codes) a whole
        # prompt's (exact rows throughout): held to its own chunked ring
        if name != "int8" and not chunked == inline == want:
            raise AssertionError(line)
    del params
    torch.cuda.empty_cache()


# phase 4m: 4i's traffic on disaggregated rings at 7b width, 2 layers,
# f32, every dispatch a graph replay: the 1-lane engine (megastep 1 and
# 4), the 4-lane engine with and without streamed frames (its own prefix
# cache on), a remote prefill pod (4 lanes, frames streamed; a server in
# this process on the card) and a speculative ring (a self-draft, K 4),
# beside the inline ring and an inline speculative ring
DISAGG_VARIANTS = (
    ("inline", {}),
    ("lanes 1", {"prefill_mode": "disagg"}),
    ("lanes 1, megastep 4", {"prefill_mode": "disagg", "megastep": 4}),
    ("lanes 4", {"prefill_mode": "disagg", "prefill_lanes": 4}),
    ("lanes 4, stream", {"prefill_mode": "disagg", "prefill_lanes": 4,
                         "prefill_stream": True,
                         "prefill_prefix_blocks": 64}),
    ("remote", {"prefill_mode": "disagg"}),
    ("inline speculative", {"spec_k": 4}),
    ("speculative", {"prefill_mode": "disagg", "spec_k": 4}))


def phase_disagg_equalities() -> None:
    """Phase 4m: disaggregated rings == the inline ring == ``generate``
    on both pools under graph replay; see the module docstring."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
    from paddle_operator_tpu_torch.infer.prefill_serve import (
        RemotePrefillClient,
        make_prefill_server,
    )
    from paddle_operator_tpu_torch.models.llama import make_model
    from paddle_operator_tpu_torch.ops import decode_attention as DA

    params, cfg = make_model("7b", device="cuda", seed=7, n_layers=2,
                             dtype=torch.float32)
    rng = np.random.default_rng(7)
    first = [rng.integers(0, cfg.vocab_size, n).tolist()
             for n in (40, 300, 129, 64)]
    # then: a full hit capped at 63 rows and a 160-token hit with a
    # 37-token suffix — both admit inline through the suffix insert
    then = [first[3], first[1][:160]
            + rng.integers(0, cfg.vocab_size, 37).tolist()]
    n_new, max_len, slice_rows, bs = 16, 512, 24, 16
    with torch.inference_mode():
        want = [D.generate(params, cfg,
                           torch.tensor([p], dtype=torch.int32,
                                        device="cuda"),
                           max_new_tokens=n_new, max_len=max_len)[0]
                .tolist() for p in first + then]
    for pool, ring in (("paged", {"paged": True, "block_size": bs}),
                       ("int8", {"paged": True, "block_size": bs,
                                 "kv_quant": "int8"})):
        quant = pool == "int8"
        fn, attr = ((DA.paged_decode_attention, "quant_launches") if quant
                    else (DA.paged_decode_attention, "launches"))
        outs = {}
        for name, extra in DISAGG_VARIANTS:
            kw = dict(ring, **extra)
            psrv = None
            if name == "remote":
                psrv = make_prefill_server(
                    "127.0.0.1", 0, params, cfg, block_size=bs,
                    max_len=max_len, kv_quant=kw.get("kv_quant", "none"),
                    lanes=4, prefill_chunk=slice_rows, prefix_blocks=64)
                threading.Thread(target=psrv.serve_forever,
                                 daemon=True).start()
                kw["prefill_client"] = RemotePrefillClient(
                    peers=[f"127.0.0.1:{psrv.server_address[1]}"],
                    stream=True)
            spec = "spec_k" in extra
            if spec:
                kw.update(draft_params=params, draft_cfg=cfg)
            b = ContinuousBatcher(params, cfg, slots=4, max_len=max_len,
                                  chunk_tokens=8, prewarm=True,
                                  prefill_chunk=slice_rows, **kw)
            ex = b.executor
            try:
                if not b.prewarmed.wait(600) or ex.needs_capture:
                    raise AssertionError(f"4m {pool} {name}: no graphs "
                                         f"captured: {b.prewarm_error!r}")
                graphs, ptrs = ex._graphs, ex._state_ptrs()
                _zero_launches()
                out = [h.result(timeout=600) for h in [
                    b.submit(p, max_new_tokens=n_new) for p in first]]
                out += [b.submit(p, max_new_tokens=n_new).result(
                    timeout=600) for p in then]
                launched = getattr(fn, attr)
                bad = []
                if ex.graph_replays != b.stats["chunks"] or not (
                        ex._graphs is graphs and ex._state_ptrs() == ptrs):
                    bad.append("not every dispatch a replay of the prewarm "
                               "graphs at their addresses")
                if spec:
                    if not DA.decode_attention.launches:
                        bad.append("no draft tick on kernel #1")
                elif launched != cfg.n_layers * 8 * b.megastep \
                        * b.stats["chunks"] or not launched:
                    bad.append(f"{pool} kernel launches {launched}")
                b.pool.check_invariant()
                cold = ((len(first) + (len(then) if spec else 0))
                        if extra.get("prefill_mode") == "disagg" else 0)
                if b.stats["disagg_prefills"] != cold:
                    bad.append(f"{b.stats['disagg_prefills']} handoffs "
                               f"(want {cold})")
                if not spec and b.pool.stats["prefix_hit_tokens"] != 63 + 160:
                    bad.append(f"prefix hit tokens "
                               f"{b.pool.stats['prefix_hit_tokens']}")
                if name == "remote" and b.stats["remote_prefills"] != cold:
                    bad.append(f"{b.stats['remote_prefills']} remote "
                               "prefills")
                if name.endswith("stream") and not b.stats["handoff_frames"]:
                    bad.append("no streamed frame landed")
                if bad:
                    raise AssertionError(f"4m {pool} {name}: {bad}")
                outs[name] = out
            finally:
                b.close()
                if psrv is not None:
                    psrv.shutdown()
                    psrv.server_close()
                    psrv.frontend.close()

        def agree(a, b):
            return f"{sum(x == y for x, y in zip(a, b))}/{len(b)}"

        line = (f"disagg {pool} rings (7b width, 2 layers, f32, graph "
                f"replays): inline == generate on "
                f"{agree(outs['inline'], want)}; beside inline: "
                + "; ".join(f"{n} {agree(o, outs['inline'])}"
                            for n, o in outs.items() if n != "inline")
                + "; the 4-lane rings and the remote pod beside lanes 4: "
                + "; ".join(f"{n} {agree(outs[n], outs['lanes 4'])}"
                            for n in ("lanes 4, stream", "remote"))
                + "; speculative beside inline speculative "
                + agree(outs["speculative"], outs["inline speculative"]))
        log(line)
        if not quant:
            if not all(o == want for o in outs.values()):
                raise AssertionError(line)
        else:
            # the int8 pool's tokens need not equal the exact cache's,
            # nor the engine's slices' (which read earlier blocks as
            # codes) a whole prompt's: the 1-lane engine runs the inline
            # insert's program (a speculative ring's too), the 4-lane
            # rings and the pod one program
            if not (outs["lanes 1"] == outs["lanes 1, megastep 4"]
                    == outs["inline"]
                    and outs["speculative"] == outs["inline speculative"]
                    and outs["lanes 4"] == outs["lanes 4, stream"]
                    == outs["remote"]):
                raise AssertionError(line)
    del params
    torch.cuda.empty_cache()


# phase 4n: 7b width, 2 layers, f32, bs 16, 2 slots: a lane drained off
# ring A by migration (through the lane envelope's codec) and adopted by
# ring B equals the same request run unmigrated on B and ``generate`` —
# on the bf16 pool at megastep 1 and 4, on the int8 pool at megastep 1
# and 4, a speculative lane (self-draft, K 4) and an adapter lane; and a
# prefix fetched over HTTP from a peer's host tier admits as a cold
# prompt does
FLEET_4N = (("bf16", {}, 1), ("bf16", {}, 4),
            ("int8", {"kv_quant": "int8"}, 1),
            ("int8", {"kv_quant": "int8"}, 4),
            ("speculative", {"spec_k": 4}, 1), ("adapter", {}, 1))


def phase_fleet_kv_equalities() -> None:
    """Phase 4n: migrated lanes and a peer-fetched prefix at f32 under
    graph replay; see the module docstring."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
    from paddle_operator_tpu_torch.infer.resilience import LaneMigrated
    from paddle_operator_tpu_torch.infer.serve import (
        make_server,
        wire_fleet_kv_from_env,
    )
    from paddle_operator_tpu_torch.models.llama import make_model
    from paddle_operator_tpu_torch.ops import decode_attention as DA
    from paddle_operator_tpu_torch.utils import fleetkv as FK

    params, cfg = make_model("7b", device="cuda", seed=9, n_layers=2,
                             dtype=torch.float32)
    params.requires_grad_(False)
    dev = params.tok_embed.embedding.device
    bs, max_len, chunk = 16, 256, 8
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, cfg.vocab_size, 70).tolist()

    def want(new, lora=None):
        with torch.inference_mode():
            return D.generate(params, cfg, torch.tensor(
                [prompt], dtype=torch.int32, device=dev),
                max_new_tokens=new, max_len=max_len, lora=lora)[0].tolist()

    def ring(extra, megastep):
        kw = dict(slots=2, max_len=max_len, chunk_tokens=chunk, paged=True,
                  block_size=bs, megastep=megastep, prewarm=True)
        extra = dict(extra)
        if extra.get("spec_k"):
            extra.update(draft_params=params, draft_cfg=cfg)
        b = ContinuousBatcher(params, cfg, **kw, **extra)
        if not b.prewarmed.wait(600) or b.executor.needs_capture:
            raise AssertionError(f"4n: no graphs captured: "
                                 f"{b.prewarm_error!r}")
        return b

    lines = []
    for name, extra, megastep in FLEET_4N:
        new = 96 if megastep > 1 else 48
        sub, lora = {}, None
        if name == "adapter":
            sub = {"adapter": "a1"}
        rings = []
        try:
            regs = [_registry(cfg, ("a1",), 2, 8, device=dev)
                    if name == "adapter" else None for _ in range(2)]
            B = ring(extra if regs[1] is None
                     else dict(extra, adapters=regs[1]), megastep)
            rings.append(B)
            unmigrated = B.submit(prompt, max_new_tokens=new,
                                  **sub).result(timeout=600)
            A = ring(extra if regs[0] is None
                     else dict(extra, adapters=regs[0]), megastep)
            rings.append(A)
            if name == "adapter":
                stacks = regs[1].arrays()
                lora = (stacks, torch.tensor([regs[1].resolve("a1")],
                                             dtype=torch.int32, device=dev))
            graphs, ptrs = B.executor._graphs, B.executor._state_ptrs()
            replays0, chunks0 = B.executor.graph_replays, B.stats["chunks"]
            sent = {}

            def migrate_out(meta, spill):
                buf = FK.encode_lane(meta, spill)
                m, s = FK.decode_lane(buf)
                sent["meta"], sent["spill"] = m, s
                sent["handle"] = B.adopt(m, s)
                return True

            A.migrate_out = migrate_out
            A._migrate_on_drain = True
            real = A.executor.replay

            def slow(plan, real=real):
                time.sleep(0.05)
                return real(plan)

            A.executor.replay = slow
            h = A.submit(prompt, max_new_tokens=new, request_id="n/row0",
                         **sub)
            t0 = time.perf_counter()
            while A.stats["chunks"] < (1 if megastep > 1 else 2):
                if time.perf_counter() - t0 > 600:
                    raise AssertionError(f"4n {name}: no dispatch")
                time.sleep(0.002)
            _zero_launches()
            A.drain(budget_s=600)
            try:
                h.result(timeout=60)
                raised = None
            except LaneMigrated as e:
                raised = e
            got = sent["handle"].result(timeout=600)
            # a speculative ring's draft ticks run kernel #1 (its verify
            # the plain multi-row attention); the others the pool's kernel
            kname, launched = (
                ("#1", DA.decode_attention.launches) if "spec_k" in extra
                else ("#3", DA.paged_decode_attention.quant_launches)
                if "kv_quant" in extra
                else ("#2", DA.paged_decode_attention.launches))
            bad = []
            if raised is None:
                bad.append("the origin's handle did not raise LaneMigrated")
            out_at_move = len(sent["meta"]["out"])
            if not 0 < out_at_move < new:
                bad.append(f"moved with {out_at_move} of {new} tokens")
            if got != unmigrated:
                bad.append("!= the unmigrated run")
            ref = want(new, lora)
            if name != "int8" and got != ref:
                bad.append("!= generate")
            if not (B.executor._graphs is graphs
                    and B.executor._state_ptrs() == ptrs):
                bad.append("B captured again or moved its state")
            if B.executor.graph_replays - replays0 \
                    != B.stats["chunks"] - chunks0:
                bad.append("a B dispatch was not a graph replay")
            if not launched:
                bad.append("B's decode kernel never launched")
            scales = ""
            if name == "int8":
                done = int(sent["spill"]["pos"]) // bs
                ks = sent["spill"]["ks"]
                scales = (f"; the envelope's {ks.shape[1] - done} "
                          f"never-committed block(s) read scale "
                          f"{sorted(set(ks[:, done:].flatten().tolist()))}")
                if ks[:, done:].count_nonzero() or ks[:, :done].le(0).any():
                    bad.append("the never-committed scales are not 0.0")
            B.pool.check_invariant()
            gated = " (not gated on the int8 pool)" if name == "int8" else ""
            line = (f"fleet kv {name} lane, megastep {megastep} (7b width, "
                    f"2 layers, f32, graph replays): moved after "
                    f"{out_at_move} tokens, {len(got) - len(prompt)} "
                    f"tokens == unmigrated {got == unmigrated}, == generate "
                    f"{got == ref}{gated}"
                    f"; B's {kname} launches {launched}{scales}")
            log(line)
            lines.append(line)
            if bad:
                raise AssertionError(f"4n {name} megastep {megastep}: {bad}")
        finally:
            for b in rings:
                if b._thread.is_alive():
                    b.close()
            gc.collect()
            torch.cuda.empty_cache()
    # a prefix fetched over HTTP from a peer's tier (SERVE_KV_PEERS)
    srvs = []
    try:
        for _ in range(2):
            srv = make_server("127.0.0.1", 0, params, cfg, continuous=True,
                              slots=2, max_len=max_len, chunk_tokens=chunk,
                              paged=True, block_size=bs, num_blocks=16,
                              host_cache_blocks=16, prewarm=True)
            b = srv.generator.batcher
            if not b.prewarmed.wait(600) or b.executor.needs_capture:
                raise AssertionError("4n: no graphs captured")
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            srvs.append(srv)
        eps = [f"127.0.0.1:{s.server_address[1]}" for s in srvs]
        for srv in srvs:
            wire_fleet_kv_from_env(srv.generator.batcher,
                                   srv.server_address[1], {
                                       "SERVE_KV_PEER_FETCH": "1",
                                       "SERVE_KV_PEERS": ",".join(eps),
                                       "POD_IP": "127.0.0.1"})
        A, B = (s.generator.batcher for s in srvs)
        body = {"tokens": [prompt], "max_new_tokens": 48}
        code, cold = _post_any(f"http://{eps[0]}", "/v1/generate", body)
        for i in range(2):
            filler = rng.integers(0, cfg.vocab_size, 200).tolist()
            _post_any(f"http://{eps[0]}", "/v1/generate",
                      {"tokens": [filler], "max_new_tokens": 8})
        if A.pool.stats["host_demotions"] < 4:
            raise AssertionError("4n: the prefix was not demoted")
        code2, fetched = _post_any(f"http://{eps[1]}", "/v1/generate", body)
        ref = want(48)
        line = (f"fleet kv peer fetch (7b width, 2 layers, f32): fetched "
                f"admission == cold {fetched['tokens'] == cold['tokens']}, "
                f"== generate {fetched['tokens'][0] == ref}; "
                f"peerPrefixFetches {B.stats['peer_prefix_fetches']}, "
                f"blocks imported {B.pool.stats['peer_blocks_imported']}, "
                f"promoted {B.pool.stats['host_promotions']}")
        log(line)
        if (code != 200 or code2 != 200 or fetched["tokens"] != cold["tokens"]
                or fetched["tokens"][0] != ref
                or B.stats["peer_prefix_fetches"] != 1
                or B.pool.stats["peer_blocks_imported"] < 4):
            raise AssertionError(line)
        B.pool.check_invariant()
    finally:
        for srv in srvs:
            srv.shutdown()
            srv.server_close()
            srv.generator.close()
    del params
    gc.collect()
    torch.cuda.empty_cache()


# phase 3l: 3b's server and burst as speculative rings (SERVE_SPEC_K=4).
SPEC_K = 4
# (a)'s verify logits at its cold streams' committed tokens, against the
# plain single-row forward's (the verify's own attention recipe at one
# row) on the same lanes: max |gap| 0.125 read at 7b in bf16 (an H100
# 80GB HBM3 at 700 W).  A planted fault, the same verify one position
# off (``pos + 1``), is read in every run beside it and must land above
# the limit, or the gate could not see such a fault
SPEC_VERIFY_TOL = 0.15
# a self-draft's acceptance: at f32 (4j) every draft but a rare near-tie;
# at bf16 (3l) the draft's single-row tick (kernel #1) and the multi-row
# verify pick different argmaxes at the near-ties random weights are full
# of: they share the argmax on 0.906 of positions, which predicts
# (p + p^2 + p^3 + p^4) / 4 = 0.786 of drafts kept, and 0.7708 was read
# (7b on an H100 80GB HBM3 at 700 W).  The one-position-off verify's
# argmax share predicts what a fault in the draft's or the verify's
# positions keeps; 3l requires it below this limit, and the self-draft
# above it
SPEC_SELF_ACCEPT = 0.9
SPEC_SELF_ACCEPT_BF16 = 0.5


def _spec_burst(cfg, short: bool):
    """3b's burst, drawn from 3b's generator in 3b's order so each
    request is 3b's (kind, index): the 8 cold prompts (48 new tokens)
    and, unless ``short``, 3b's 4 followers of the 512-token prompt and
    its streamed request (32 new), then the resubmission.  A
    speculative ring caches no prefix, so the followers and the
    resubmission prefill whole and go with the rest."""
    _, prefix, burst, late, _ = burst_requests(cfg)
    jobs = [j for j in burst if j[0] == "cold"]
    if not short:
        jobs += late + [j for j in burst if j[0] == "stream"]
    return jobs, ([("resubmit", 0, prefix, 48)] if not short else [])


def _spec_run(params, cfg, what: str, ring_kw: dict, short: bool) -> dict:
    """One speculative server (3b's arguments plus ``ring_kw``: the
    draft, ``spec_k``, ``kv_quant``, ``megastep``) under 3b's burst over
    HTTP; gated: every request completes with its prompt echoed,
    kernel #1 launched draft n_layers x (K+1) x rounds, kernels #2/#3
    not at all, kernel #7 7 x that with a quantized draft (else 0),
    every dispatch a replay of the prewarm graphs, ``/statusz`` and
    ``/metrics`` reading the ring's own acceptance, ``specK`` and draft
    mode, and ``paramBytes`` the target's plus the draft's.  Returns the
    readings, the outputs by (kind, index) and the executor (its graphs
    and state kept for timing)."""
    from paddle_operator_tpu_torch.infer import quant as Q
    from paddle_operator_tpu_torch.infer.serve import make_server
    from paddle_operator_tpu_torch.ops import decode_attention as DA
    from paddle_operator_tpu_torch.ops import quant_matmul as QM

    kw = dict(RING, prewarm=True, **ring_kw)
    megastep = kw.get("megastep", 1)
    t_build = time.perf_counter()
    srv = make_server("127.0.0.1", 0, params, cfg, **kw)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    batcher = srv.generator.batcher
    ex = batcher.executor
    dcfg = ex.draft_cfg
    if not batcher.prewarmed.wait(600) or ex.needs_capture:
        raise AssertionError(f"3l {what}: the ring's CUDA graphs were not "
                             f"captured: {batcher.prewarm_error!r}")
    capture = {"capture_s": ex.capture_s,
               "up_s": time.perf_counter() - t_build,
               "graph_pool_bytes": ex.graph_pool_bytes(),
               "recorded": {n: g.launches for n, g in ex._graphs.items()}}
    jobs, late = _spec_burst(cfg, short)
    results, errors = {}, []

    def send(kind, i, p, n):
        try:
            body = {"tokens": [p], "max_new_tokens": n}
            results[kind, i] = (_post_stream(base, body) if kind == "stream"
                                else _post(base, body))
        except Exception as e:               # surfaced after the join
            errors.append(f"{kind} {i}: {e!r}")

    try:
        stats0 = dict(batcher.stats)
        replays0 = ex.graph_replays
        _zero_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=send, args=j) for j in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        burst_s = time.perf_counter() - t0
        for j in late:
            send(*j)
        with urllib.request.urlopen(base + "/statusz", timeout=60) as r:
            statusz = json.loads(r.read())
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
        srv.generator.close()
    if errors:
        raise AssertionError(f"3l {what}: requests failed: {errors}")
    outputs, new_tokens = {}, 0
    for kind, i, p, n in jobs + late:
        if kind == "stream":
            code, events, _, _ = results[kind, i]
            done = events[-1]
            if code != 200 or not done.get("done") \
                    or "accept_rate" not in done:
                raise AssertionError(f"3l {what}: streamed request: HTTP "
                                     f"{code}, last event {str(done)[:200]}")
            out = done["tokens"]
        else:
            code, body, _ = results[kind, i]
            if code != 200 or len(body.get("accept_rate", ())) != 1:
                raise AssertionError(f"3l {what}: {kind} {i}: HTTP {code} "
                                     f"or no accept_rate")
            out = body["tokens"][0]
        _check_rows(cfg, p, out, n, f"3l {what} {kind} {i}")
        outputs[kind, i] = out
        if (kind, i, p, n) in jobs:
            new_tokens += n
    dispatches = batcher.stats["chunks"] - stats0["chunks"]
    rounds = dispatches * megastep
    replays = ex.graph_replays - replays0
    ticks = dcfg.n_layers * (SPEC_K + 1) * rounds
    dquant = Q.weight_quant_mode(ex.draft_params)
    got = [DA.decode_attention.launches, DA.paged_decode_attention.launches,
           DA.paged_decode_attention.quant_launches,
           QM.quant_matmul.launches, QM.quant_gemm.launches]
    # a quantized draft: 7 projections a draft layer on each draft tick
    # (kernel A) and on each draft prefill (the whole prompt: kernel A up
    # to its limit, kernel B above)
    prefills = [len(p) for _, _, p, _ in jobs + late]
    short = sum(n <= QM.KERNEL_MAX_ROWS for n in prefills)
    per = 7 * dcfg.n_layers if dquant != "none" else 0
    want = [ticks, 0, 0, 7 * ticks + per * short if per else 0,
            per * (len(prefills) - short)]
    drafted = batcher.stats["spec_drafted"] - stats0["spec_drafted"]
    accepted = batcher.stats["spec_accepted"] - stats0["spec_accepted"]
    run = {"what": what, "megastep": megastep,
           "kv_quant": kw.get("kv_quant", "none"), "draft_quant": dquant,
           "draft_layers": dcfg.n_layers, "dispatches": dispatches,
           "rounds": rounds, "replays": replays,
           "launches": dict(zip(("decode_attention",
                                 "paged_decode_attention",
                                 "paged_decode_attention_quant",
                                 "quant_matmul", "quant_gemm"), got)),
           "accept_rate": round(accepted / drafted, 4) if drafted else 0.0,
           "statusz": {k: statusz.get(k) for k in (
               "specK", "acceptRate", "draftQuantMode", "weightQuantMode",
               "paramBytes", "kvQuantMode", "megastepN", "kvPoolBytes")},
           "burst_s": burst_s, "burst_new_tokens": new_tokens,
           "burst_new_tok_s": new_tokens / burst_s, **capture}
    gauges = {ln.split("{")[0]: ln for ln in metrics.splitlines()
              if ln.startswith(("tpujob_serve_accept_rate{",
                                "tpujob_serve_weight_quant_mode{"))}
    run["gauges"] = gauges
    log(f"3l {what}: {json.dumps(run)}")
    bad = []
    if got != want:
        bad.append(f"launches {got}, expected {want} (kernel #1 draft "
                   f"n_layers {dcfg.n_layers} x (K+1) x rounds {rounds})")
    if replays != dispatches:
        bad.append(f"{dispatches} dispatches but {replays} graph replays")
    if statusz.get("specK") != SPEC_K or statusz.get("draftQuantMode") \
            != dquant or statusz.get("acceptRate") != run["accept_rate"] \
            or statusz.get("megastepN") != megastep:
        bad.append(f"/statusz {run['statusz']}")
    rate = gauges.get("tpujob_serve_accept_rate", "")
    wq = gauges.get("tpujob_serve_weight_quant_mode", "")
    if not rate or float(rate.split(" ")[-1]) != run["accept_rate"] \
            or f'draft="{dquant}"' not in wq:
        bad.append(f"/metrics {gauges}")
    if statusz.get("paramBytes") != (Q.param_bytes(params)
                                     + Q.param_bytes(ex.draft_params)):
        bad.append(f"paramBytes {statusz.get('paramBytes')}")
    if bad:
        raise AssertionError(f"3l {what}: {bad}")
    return {"run": run, "outputs": outputs, "ex": ex}


def _kept_share(p: float) -> float:
    """The share of K drafts a greedy round keeps when each position's
    argmax agrees with probability ``p``: (p + ... + p^K) / K."""
    return sum(p ** j for j in range(1, SPEC_K + 1)) / SPEC_K


def _verify_logit_gap(params, cfg, streams) -> dict:
    """The verify's multi-row forward (rows of K+1 at the lanes'
    positions, teacher-forced with the streams' own tokens) against
    single-row forwards from the same prefilled lanes, at every
    committed position: the plain single-row forward (the same
    attention recipe as the verify: f32 scores, probabilities rounded
    to the compute dtype) and the one a non-speculative ring runs
    (kernel #1), and the two single-row forwards against each other.
    Beside them a planted fault: the same verify one position off
    (``pos + 1``, run first, so the sound verify overwrites its rows).
    ``streams`` [(prompt, output)].  Returns the largest |logit| gaps,
    over the whole vocabulary and at the committed tokens, and the share
    of positions whose argmax the verify (the plain forward, the
    shifted verify) shares with kernel #1's: a self-draft's chance to
    keep a draft."""
    import torch

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.infer import executor as X
    from paddle_operator_tpu_torch.infer import speculative as SP

    b = len(streams)
    dev = params.tok_embed.embedding.device
    plain = dataclasses.replace(cfg, decode_attn="plain")
    max_len = max(len(o) for _, o in streams) + SPEC_K + 1
    caches = [X.init_ring_cache(cfg, b, max_len, device=dev)
              for _ in range(3)]
    n_new = min(len(o) - len(p) for p, o in streams)
    gaps = {k: 0.0 for k in ("verify_vs_plain", "verify_vs_kernel",
                             "plain_vs_kernel", "shifted_vs_plain",
                             "token_verify_vs_plain",
                             "token_verify_vs_kernel",
                             "token_shifted_vs_plain")}
    same = {"argmax_verify_eq_kernel": 0, "argmax_plain_eq_kernel": 0,
            "argmax_shifted_eq_kernel": 0}
    rows_seen = 0
    with torch.inference_mode():
        for i, (p, _) in enumerate(streams):
            lane = D.init_cache(cfg, 1, len(p), device=dev)
            _, lane = D._forward(cfg, params, torch.tensor(
                [p], dtype=torch.int32, device=dev), lane, last_only=True)
            for c in caches:
                X._splice_lane(c, lane, i, len(p))
        for r in range((n_new - 1) // (SPEC_K + 1)):
            start = [len(p) + r * (SPEC_K + 1) for p, _ in streams]
            rows = [o[s:s + SPEC_K + 2] for (_, o), s in zip(streams, start)]
            seq = torch.tensor([x[:-1] for x in rows], dtype=torch.int32,
                               device=dev)
            nxt = torch.tensor([x[1:] for x in rows], dtype=torch.int64,
                               device=dev)
            pos = torch.tensor(start, dtype=torch.int32, device=dev)
            shifted, _ = SP._multi_forward(cfg, params, seq,
                                           dict(caches[0], pos=pos + 1))
            verify, _ = SP._multi_forward(cfg, params, seq,
                                          dict(caches[0], pos=pos))
            ones = [dict(caches[1], pos=pos), dict(caches[2], pos=pos)]
            for j in range(SPEC_K + 1):
                (lp, ones[0]), (lk, ones[1]) = (
                    X._ring_forward(plain, params, seq[:, j], ones[0]),
                    X._ring_forward(cfg, params, seq[:, j], ones[1]))
                v, t = verify[:, j], nxt[:, j:j + 1]
                sv = shifted[:, j]
                for key, a in (("verify", v), ("plain", lp),
                               ("shifted", sv)):
                    same[f"argmax_{key}_eq_kernel"] += int(
                        (a.argmax(-1) == lk.argmax(-1)).sum())
                rows_seen += b
                for key, a, c in (("verify_vs_plain", v, lp),
                                  ("verify_vs_kernel", v, lk),
                                  ("plain_vs_kernel", lp, lk),
                                  ("shifted_vs_plain", sv, lp)):
                    gaps[key] = max(gaps[key], float((a - c).abs().max()))
                    if key != "plain_vs_kernel":
                        gaps["token_" + key] = max(
                            gaps["token_" + key],
                            float((a.gather(1, t) - c.gather(1, t))
                                  .abs().max()))
    del caches
    torch.cuda.empty_cache()
    gaps.update({k: v / rows_seen for k, v in same.items()})
    return gaps


def _spec_round_ms(ex, cfg, fill: int, reps: int = 10) -> dict:
    """A round's device ms on the executor ``ex`` of a run (graphs and
    state kept, its ring thread ended): 8 lanes admitted cold at
    ``fill`` tokens, then the round's CUDA graph replayed ``reps`` times
    between CUDA events, and its pieces, each as a graph of its own
    (``time_ms``): the draft's K+1 ticks, the verify over the pool, the
    acceptance.  Beside each, a bound: the bytes the piece must read
    (weights once, the lanes' filled K/V rows once) at 3.35 TB/s."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import executor as X
    from paddle_operator_tpu_torch.infer import quant as Q
    from paddle_operator_tpu_torch.infer import speculative as SP

    rng = np.random.default_rng(3)
    slots = ex.slots
    k = SPEC_K
    with torch.inference_mode():
        for slot in range(slots):
            p = rng.integers(0, cfg.vocab_size, fill).tolist()
            n = len(p)
            bucket = next(b for b in ex.buckets if n <= b)
            dev = X.to_device(np.asarray([p], np.int32), ex.device)
            ex.pool.admit(slot, p)
            ex.pool.ensure(slot, fill + (reps + 4) * (k + 1))
            row = X.to_device(ex.pool.table[slot], ex.device, torch.int32)
            ex.inserts[bucket](ex.params, ex.cache, row, ex.tok, ex.temp,
                               ex.seeds, dev, n, slot, 0.0, 0)
            ex.draft_prefill(slot, dev, n)
        plan = X.ExecPlan(1, [True] * slots, table=ex.pool.table)
        ex._upload(plan)
        g = ex._graphs[1]
        g.graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            g.graph.replay()
        end.record()
        end.synchronize()
        round_ms = start.elapsed_time(end) / reps
        committed = int(g.counts.sum())
        _, _, _, _, table = ex._plan_views()
        dcfg, dparams = ex.draft_cfg, ex.draft_params
        tok = ex.tok.clone()
        dcache = dict(ex.dcache)
        seq = torch.randint(0, cfg.vocab_size, (slots, k + 1),
                            dtype=torch.int32, device=ex.device)
        active = torch.ones(slots, dtype=torch.bool, device=ex.device)

        def draft(_):
            dc = dict(dcache)
            for _ in range(k + 1):
                _, dc = X._ring_forward(dcfg, dparams, tok, dc)

        def verify(_):
            return SP._multi_forward_paged(cfg, ex.params, seq,
                                           dict(ex.cache), table,
                                           quant=ex.quant)

        tl = torch.randn(slots, k + 1, cfg.vocab_size, device=ex.device)
        dl = torch.randn(slots, k, cfg.vocab_size, device=ex.device)
        drafts = seq[:, 1:].contiguous()
        pos = ex.cache["pos"].clone()

        def accept(_):
            return SP.spec_accept(tl, dl, drafts, ex.temp, ex.seeds, pos,
                                  active)

        draft_ms, _ = time_ms(draft, 2)
        verify_ms, _ = time_ms(verify, 2)
        accept_ms, _ = time_ms(accept, 4)
        resync_ms = None
        if ex.quant:
            # the int8 tail resync, every lane needing it (its cost does
            # not depend on how many do: no branch)
            end = pos + k + 1

            def resync(_):
                SP._resync_tails(ex.cache, table, end, pos, active)

            resync_ms, _ = time_ms(resync, 4)
    kv_row = 2 * cfg.n_kv_heads * cfg.head_dim * (
        1 if ex.quant else torch.empty((), dtype=cfg.dtype).element_size())
    dkv_row = 2 * dcfg.n_kv_heads * dcfg.head_dim * torch.empty(
        (), dtype=dcfg.dtype).element_size()
    fills = slots * fill
    draft_bytes = (k + 1) * (Q.param_bytes(dparams)
                             + dcfg.n_layers * dkv_row * fills)
    verify_bytes = (Q.param_bytes(ex.params) + cfg.n_layers * kv_row * fills)
    out = {"fill": fill, "lanes": slots, "round_ms": round_ms,
           "tokens_per_round": committed / slots,
           "draft_ms": draft_ms, "verify_ms": verify_ms,
           "accept_ms": accept_ms, "resync_ms": resync_ms,
           "draft_bound_ms": draft_bytes / HBM_BYTES_PER_S * 1e3,
           "verify_bound_ms": verify_bytes / HBM_BYTES_PER_S * 1e3}
    for slot in range(slots):
        ex.pool.retire(slot)
    return out


def _main_boot(cfg, extra: dict, tag: str, body_extra=None) -> dict:
    """``serve.main()`` as a pod runs it: ``python -m
    paddle_operator_tpu_torch.infer.serve`` in a process of its own with
    3b's ring (``SERVE_CONTINUOUS=1 SERVE_PAGED=1``, 8 slots, block 256,
    64 blocks) plus ``extra`` (phase ``tag``'s knobs: 3l's
    ``SERVE_SPEC_K=4``, 3m's ``SERVE_ADAPTERS``); no checkpoint, so the
    7b target from seed 0 (and a ``SERVE_DRAFT=auto`` draft from seed 1).
    Once ``/readyz`` answers: one request (its body with
    ``body_extra``), then ``/statusz``, ``/metrics`` and
    ``/v1/adapters``; then SIGTERM, which must drain and exit 83.  The
    process is killed if it is still up when this returns.  Returns the
    startup line, the response, the status keys, the pages and the exit
    code."""
    import signal
    import socket

    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("TPUJOB_CHECKPOINT_PATH",
                        "TPUJOB_DRAFT_CHECKPOINT_PATH")}
    env.update(MODEL_PRESET="7b", SERVE_CONTINUOUS="1", SERVE_PAGED="1",
               SERVE_SLOTS=str(RING["slots"]),
               SERVE_CHUNK=str(RING["chunk_tokens"]),
               SERVE_BLOCK_SIZE=str(RING["block_size"]),
               SERVE_NUM_BLOCKS="64", SERVE_MAX_LEN=str(RING["max_len"]),
               TPUJOB_PORT=str(port),
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + ([env["PYTHONPATH"]]
                                  if env.get("PYTHONPATH") else [])),
               **extra)
    what = " ".join(f"{k}={v}" for k, v in extra.items()) or "no extra"
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_operator_tpu_torch.infer.serve"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout),
                              daemon=True)
    reader.start()
    base = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"{tag} main() ({what}) exited "
                                     f"{proc.returncode} before it was "
                                     f"ready: {''.join(lines)[-3000:]}")
            if time.perf_counter() - t0 > 600:
                raise AssertionError(f"{tag} main() ({what}) not ready in "
                                     f"600 s: {''.join(lines)[-3000:]}")
            try:
                with urllib.request.urlopen(base + "/readyz",
                                            timeout=5) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            time.sleep(1.0)
        ready_s = time.perf_counter() - t0
        prompt = list(range(1, 40))
        code, body, _ = _post(base, {"tokens": [prompt],
                                     "max_new_tokens": 16,
                                     **(body_extra or {})})
        pages = {}
        for page in ("/statusz", "/metrics", "/v1/adapters"):
            with urllib.request.urlopen(base + page, timeout=60) as r:
                pages[page] = r.read().decode()
        statusz = json.loads(pages["/statusz"])
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
    if code != 200:
        raise AssertionError(f"{tag} main() ({what}): HTTP {code}")
    _check_rows(cfg, prompt, body["tokens"][0], 16, f"{tag} main() {what}")
    startup = next((ln.strip() for ln in lines
                    if ln.startswith("serving ")), "")
    return {"startup": startup, "ready_s": ready_s, "rc": rc,
            "accept_rate": body.get("accept_rate"),
            "statusz": {k: statusz.get(k) for k in (
                "specK", "acceptRate", "draftQuantMode", "paramBytes",
                "tokensTotal", "activeAdapters", "adapterNames")},
            "adapters": json.loads(pages["/v1/adapters"]),
            "adapter_gauges": sorted(
                ln for ln in pages["/metrics"].splitlines()
                if ln.startswith("tpujob_serve_adapter_loaded{"))}


def phase_spec_ring(contiguous: dict, qmm: dict, params, cfg,
                    ring_tokens=None, bf16_ring=None) -> None:
    """Phase 3l: speculative decoding on 3b's server; see the module
    docstring."""
    import torch

    from paddle_operator_tpu_torch.infer import quant as Q
    from paddle_operator_tpu_torch.infer.serve import spec_kw_from_env

    base = {"SERVE_SPEC_K": str(SPEC_K)}
    runs = {}

    def clean():
        gc.collect()
        torch.cuda.empty_cache()

    # (a) SERVE_DRAFT=auto through the entry point's draft boot: a
    # random cfg.draft() from seed 1
    t0 = time.perf_counter()
    auto = spec_kw_from_env(dict(base, SERVE_DRAFT="auto"), cfg, "cuda")
    log(f"3l: draft {auto['draft_cfg'].n_layers} layers, dim "
        f"{auto['draft_cfg'].dim}, {auto['draft_cfg'].n_heads} heads "
        f"({Q.param_bytes(auto['draft_params'])} bytes) built in "
        f"{time.perf_counter() - t0:.1f}s")
    a = _spec_run(params, cfg, "a: random draft", auto, short=False)
    runs["a"] = a["run"]
    # kernel #1 ran at the draft-ring shape phase 2 checked
    dk = a["ex"].dcache["k"]
    want = tuple(SPEC_DRAFT_ATTN[k] for k in ("layers", "b", "hkv", "s",
                                               "d"))
    if tuple(dk.shape) != want or dk.dtype != torch.bfloat16 \
            or a["ex"].draft_cfg.n_heads != SPEC_DRAFT_ATTN["hq"]:
        raise AssertionError(f"3l: the draft ring {tuple(dk.shape)} "
                             f"{dk.dtype}, {a['ex'].draft_cfg.n_heads} "
                             f"heads, is not phase 2's {SPEC_DRAFT_ATTN}")
    timing = _spec_round_ms(a["ex"], cfg, fill=520)
    log(f"3l round (7b, 8 lanes, fill 520, K {SPEC_K}, random draft, "
        f"{card_line()}): {json.dumps(timing)}")
    del a["ex"]
    clean()
    gap = _verify_logit_gap(params, cfg, [
        (p, a["outputs"][kind, i])
        for kind, i, p, _ in _spec_burst(cfg, True)[0]])
    gap["kept_share_verify"] = _kept_share(gap["argmax_verify_eq_kernel"])
    gap["kept_share_shifted"] = _kept_share(gap["argmax_shifted_eq_kernel"])
    log(f"3l: the verify's logits at the committed positions against the "
        f"single-row forwards, and a verify one position off (max |gap|; "
        f"at the committed tokens the verify against the plain one is "
        f"held to {SPEC_VERIFY_TOL}, which the shifted one must exceed): "
        f"{json.dumps(gap)}")
    if gap["token_verify_vs_plain"] > SPEC_VERIFY_TOL:
        raise AssertionError(f"3l: verify logits at the committed tokens "
                             f"{gap['token_verify_vs_plain']} from the plain "
                             f"single-row forward's (limit "
                             f"{SPEC_VERIFY_TOL})")
    if gap["token_shifted_vs_plain"] <= SPEC_VERIFY_TOL:
        raise AssertionError(f"3l: a verify one position off reads "
                             f"{gap['token_shifted_vs_plain']}, within the "
                             f"limit {SPEC_VERIFY_TOL}: the gate cannot "
                             f"see it")
    if gap["kept_share_shifted"] >= SPEC_SELF_ACCEPT_BF16:
        raise AssertionError(f"3l: a verify one position off would keep "
                             f"{gap['kept_share_shifted']:.4f} of a "
                             f"self-draft's drafts, not below the limit "
                             f"{SPEC_SELF_ACCEPT_BF16}")
    # megastep 4 == megastep 1 (the cold requests)
    a4 = _spec_run(params, cfg, "a: random draft, megastep 4",
                   dict(auto, megastep=4), short=True)
    runs["a_megastep4"] = a4["run"]
    del a4["ex"]
    clean()
    differ = [k for k in a4["outputs"] if a4["outputs"][k]
              != a["outputs"][k]]
    if differ:
        raise AssertionError(f"3l: megastep 4 tokens differ from megastep "
                             f"1's for {differ}")
    # (b) a self-draft: the target drafts for itself
    b = _spec_run(params, cfg, "b: self-draft",
                  {"draft_params": params, "draft_cfg": cfg,
                   "spec_k": SPEC_K}, short=True)
    runs["b"] = b["run"]
    del b["ex"]
    clean()
    if b["run"]["accept_rate"] < SPEC_SELF_ACCEPT_BF16:
        raise AssertionError(f"3l: a self-draft accepted "
                             f"{b['run']['accept_rate']} of its drafts "
                             f"(at least {SPEC_SELF_ACCEPT_BF16} expected)")
    # (c) (a) with SERVE_DRAFT_QUANT=int8
    c = _spec_run(params, cfg, "c: random draft, SERVE_DRAFT_QUANT=int8",
                  spec_kw_from_env(dict(base, SERVE_DRAFT_QUANT="int8"), cfg,
                                   "cuda"), short=True)
    runs["c"] = c["run"]
    # kernel #7 ran at the projection shapes phase 2e checked
    shapes = {tuple(m.q.shape) for m in c["ex"].draft_params.modules()
              if getattr(m, "mode", "none") != "none"}
    if not shapes or not shapes <= set(QMM_DRAFT_SHAPES):
        raise AssertionError(f"3l (c): the draft's quantized projections "
                             f"{sorted(shapes)} are not phase 2e's "
                             f"{QMM_DRAFT_SHAPES}")
    del c["ex"]
    clean()
    # (d) (a) on the int8 pool, where the tail resync is live
    d = _spec_run(params, cfg, "d: random draft, int8 pool",
                  dict(auto, kv_quant="int8"), short=True)
    runs["d"] = d["run"]
    timing_int8 = _spec_round_ms(d["ex"], cfg, fill=520)
    log(f"3l round on the int8 pool (same shape, {card_line()}): "
        f"{json.dumps(timing_int8)}")
    del d["ex"], auto
    clean()
    # (e) serve.main() boots the speculative paged ring from the env, as
    # a pod does, with and without SERVE_DRAFT_QUANT=int8: the two pods
    # at once (two 7b replicas and this process fit the card)
    legs = (("e", {}, "a"), ("e_int8", {"SERVE_DRAFT_QUANT": "int8"}, "c"))
    boots, boot_errors = {}, []

    def boot_leg(key, extra):
        try:
            boots[key] = _main_boot(cfg, dict(base, **extra), "3l")
        except Exception as e:
            boot_errors.append(e)

    t_boot = time.perf_counter()
    threads = [threading.Thread(target=boot_leg, args=leg[:2])
               for leg in legs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if boot_errors:
        raise boot_errors[0]
    log(f"3l (e): both pods booted, served and drained in "
        f"{time.perf_counter() - t_boot:.1f}s")
    for key, extra, run in legs:
        boot = boots[key]
        log(f"3l ({key}) serve.main(): {json.dumps(boot)}")
        st, dq = boot["statusz"], runs[run]["draft_quant"]
        bad = []
        if boot["rc"] != 83:
            bad.append(f"exit {boot['rc']} on SIGTERM, 83 expected")
        if f"spec_k={SPEC_K}," not in boot["startup"] \
                or f"draft_quant={dq}," not in boot["startup"]:
            bad.append(f"startup line {boot['startup']!r}")
        if st["specK"] != SPEC_K or st["draftQuantMode"] != dq \
                or boot["accept_rate"] is None \
                or st["acceptRate"] != boot["accept_rate"][0] \
                or st["paramBytes"] != runs[run]["statusz"]["paramBytes"]:
            bad.append(f"/statusz {st} (the response's accept_rate "
                       f"{boot['accept_rate']}, paramBytes "
                       f"{runs[run]['statusz']['paramBytes']} expected)")
        if bad:
            raise AssertionError(f"3l ({key}) serve.main(): {bad}")
    agree = None
    if ring_tokens is not None:
        common = [k for k in a["outputs"] if k in ring_tokens]
        agree = (sum(a["outputs"][k] == ring_tokens[k] for k in common),
                 len(common))
    spec = {"k": SPEC_K, "launches": runs["a"]["launches"][
                "decode_attention"],
            "round": timing, "round_int8": timing_int8,
            "verify_logit_gap": gap,
            "main_boots": boots,
            "agree_with_3b": agree,
            "tok_s": runs["a"]["burst_new_tok_s"],
            "tok_s_3b": bf16_ring["burst_new_tok_s"] if bf16_ring else None,
            "runs": runs}
    tok_s_3b = spec["tok_s_3b"]
    log(f"3l (a smoke reading of one burst a run, not a benchmark; "
        f"{card_line()}): random draft {spec['tok_s']:.1f} new tok/s over "
        f"3b's burst against 3b's "
        f"{tok_s_3b if tok_s_3b is None else round(tok_s_3b, 1)}"
        f"; requests equal to 3b's {agree}; round {timing['round_ms']:.2f} "
        f"ms (draft {timing['draft_ms']:.2f}, verify "
        f"{timing['verify_ms']:.2f}, acceptance {timing['accept_ms']:.3f}) "
        f"committing {timing['tokens_per_round']:.2f} tokens a lane; "
        f"acceptance random {runs['a']['accept_rate']}, self "
        f"{runs['b']['accept_rate']}, draft int8 {runs['c']['accept_rate']}"
        f", int8 pool {runs['d']['accept_rate']}")
    contiguous["spec"] = spec
    qmm["draft_quant"] = {"launches": runs["c"]["launches"]["quant_matmul"],
                          "rounds": runs["c"]["rounds"],
                          "draft_layers": runs["c"]["draft_layers"]}


def phase_spec_equalities() -> None:
    """Phase 4j: the speculative rings == ``generate`` under graph
    replay; see the module docstring."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
    from paddle_operator_tpu_torch.infer.qos import QoSConfig
    from paddle_operator_tpu_torch.models.llama import Llama, make_model
    from paddle_operator_tpu_torch.ops import decode_attention as DA

    params, cfg = make_model("7b", device="cuda", seed=9, n_layers=2,
                             dtype=torch.float32)
    dcfg = cfg.draft()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    dparams = Llama(dcfg, "cuda").init_weights(gen)
    params.requires_grad_(False)
    dparams.requires_grad_(False)
    drafts = {"random": (dparams, dcfg), "self": (params, cfg)}
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (40, 300, 129, 64)]
    n_new, max_len = 24, 512
    with torch.inference_mode():
        want = [D.generate(params, cfg,
                           torch.tensor([p], dtype=torch.int32,
                                        device="cuda"),
                           max_new_tokens=n_new, max_len=max_len)[0]
                .tolist() for p in prompts]

    def ring(name, kw, draft="random", megastep=1, **extra):
        dp, dc = drafts[draft]
        args = dict(slots=4, max_len=max_len, chunk_tokens=8,
                    megastep=megastep, prewarm=True, draft_params=dp,
                    draft_cfg=dc, spec_k=SPEC_K, **kw)
        args.update(extra)
        return ContinuousBatcher(params, cfg, **args)

    def serve(b, what, reqs):
        ex = b.executor
        try:
            if not b.prewarmed.wait(600) or ex.needs_capture:
                raise AssertionError(f"4j {what}: no graphs captured: "
                                     f"{b.prewarm_error!r}")
            graphs, ptrs = ex._graphs, ex._state_ptrs()
            _zero_launches()
            out = [h.result(timeout=600) for h in [
                b.submit(p, max_new_tokens=n_new, **kw) for p, kw in reqs]]
            rounds = b.stats["chunks"] * b.megastep
            got = [DA.decode_attention.launches,
                   DA.paged_decode_attention.launches
                   + DA.paged_decode_attention.quant_launches]
            bad = []
            if ex.graph_replays != b.stats["chunks"] or not (
                    ex._graphs is graphs and ex._state_ptrs() == ptrs):
                bad.append("not every dispatch a replay of the prewarm "
                           "graphs at their addresses")
            if got != [ex.draft_cfg.n_layers * (SPEC_K + 1) * rounds, 0]:
                bad.append(f"decode kernel launches {got} over {rounds} "
                           "rounds")
            if b.pool is not None:
                b.pool.check_invariant()
            if bad:
                raise AssertionError(f"4j {what}: {bad}")
            return out, b.serving_status()["acceptRate"]
        finally:
            b.close()

    def agree(a, b):
        return f"{sum(x == y for x, y in zip(a, b))}/{len(b)}"

    greedy = [(p, {}) for p in prompts]
    for name, kw in MEGA_RINGS:
        outs = {}
        for draft in ("random", "self"):
            for megastep in (1, 4):
                outs[draft, megastep], rate = serve(
                    ring(name, kw, draft, megastep),
                    f"{name} {draft} megastep {megastep}", greedy)
                # (on the int8 pool the verify reads codes where the
                # draft read exact rows: its acceptance is printed)
                log(f"4j {name} {draft} megastep {megastep}: acceptRate "
                    f"{rate}")
                if draft == "self" and name != "int8" \
                        and rate < SPEC_SELF_ACCEPT:
                    raise AssertionError(f"4j {name}: a self-draft accepted "
                                         f"{rate} of its drafts")
        chunked, _ = serve(ring(name, kw, prefill_mode="chunked",
                                prefill_chunk=24),
                           f"{name} chunked", greedy)
        one = outs["random", 1]
        plain_line = ""
        if name == "int8":
            # the non-speculative int8 ring on the same prompts, for the
            # record: how far the int8 pool alone takes a stream from
            # generate's
            b = ring(name, kw, spec_k=0, draft_params=None, draft_cfg=None)
            try:
                b.prewarmed.wait(600)
                plain8 = [h.result(timeout=600) for h in [
                    b.submit(p, max_new_tokens=n_new) for p in prompts]]
            finally:
                b.close()
            plain_line = (f"; the non-speculative int8 ring == generate on "
                          f"{agree(plain8, want)}, == this ring on "
                          f"{agree(one, plain8)}")
        line = (f"spec {name} ring (7b width, 2 layers, f32, K {SPEC_K}, "
                f"graph replays): megastep 4 == 1 on "
                f"{agree(outs['random', 4], one)} (random draft) and "
                f"{agree(outs['self', 4], outs['self', 1])} (self-draft); "
                f"self == random on {agree(outs['self', 1], one)}; chunked "
                f"== inline on {agree(chunked, one)}; == generate on "
                f"{agree(one, want)}{plain_line}")
        log(line)
        if outs["random", 4] != one or outs["self", 4] != outs["self", 1]:
            raise AssertionError(line)
        # the int8 pool's tokens need not equal the exact cache's, and a
        # verify reads the blocks it completed as codes where a
        # single-row tick read its rows exact: held to itself
        if name != "int8" and not (
                one == outs["self", 1] == chunked == want):
            raise AssertionError(line)
    # a spill and restore mid-speculation, both pools: the victim
    # resumes its uninterrupted stream
    for name, kw in MEGA_RINGS[1:]:
        b = ring(name, kw, "self", slots=1, num_blocks=64,
                 qos=QoSConfig(priorities=2, default_priority=1))
        try:
            b.prewarmed.wait(600)
            victim = prompts[0]
            alone = b.submit(victim, max_new_tokens=40).result(timeout=600)
            real = b.executor.replay
            gate = threading.Event()
            gate.set()

            def slow(plan, real=real, gate=gate):
                gate.wait(timeout=120)
                time.sleep(0.02)
                return real(plan)

            b.executor.replay = slow
            n0, c0 = b.stats["admitted"], b.stats["chunks"]
            h = b.submit(victim, max_new_tokens=40)
            while b.stats["chunks"] < c0 + 2 or b.stats["admitted"] <= n0:
                time.sleep(0.001)
            gate.clear()
            h0 = b.submit(prompts[3][:7], max_new_tokens=4, priority=0)
            gate.set()
            h0.result(timeout=600)
            out = h.result(timeout=600)
            line = (f"spec {name} ring: a lane spilled and restored "
                    f"mid-speculation ({b.stats['preempted_lanes']} "
                    f"spills) == its uninterrupted stream: {out == alone}"
                    f"; == generate: {out[:len(victim) + n_new] == want[0]}")
            log(line)
            if out != alone or b.stats["restored_lanes"] < 1 or (
                    name == "paged" and out[:len(victim) + n_new]
                    != want[0]):
                raise AssertionError(line)
            b.pool.check_invariant()
        finally:
            b.close()
    # sampled streams: deterministic per seed, inside the vocabulary
    b = ring("contiguous", MEGA_RINGS[0][1])
    try:
        b.prewarmed.wait(600)
        s1, s2 = [b.submit(prompts[1], max_new_tokens=n_new,
                           temperature=0.8, seed=5).result(timeout=600)
                  for _ in range(2)]
    finally:
        b.close()
    log(f"spec sampled stream (T 0.8, seed 5): repeat equal {s1 == s2}, "
        f"in vocab {0 <= min(s1) and max(s1) < cfg.vocab_size}")
    if s1 != s2 or min(s1) < 0 or max(s1) >= cfg.vocab_size:
        raise AssertionError("4j: a sampled spec stream is not "
                             "deterministic per seed or left the vocab")
    del params, dparams
    torch.cuda.empty_cache()


# phase 3m: 3b's server with SERVE_ADAPTERS: adapters a1..a3 from seeds 1-3
# at the JAX defaults (rank 8, capacity 8); the burst's lanes alternate over
# the base model and the three adapters; a4 (seed 4) is loaded at runtime
ADAPT = dict(rank=8, capacity=8, names=("a1", "a2", "a3"), late="a4",
             new=48, fill=520, dispatches=10)


def _registry(cfg, names, capacity, rank, device="cuda"):
    """An adapter registry with ``names`` loaded from seeds 1, 2, ..."""
    from paddle_operator_tpu_torch.infer.qos import AdapterRegistry

    reg = AdapterRegistry(cfg, capacity=capacity, rank=rank, device=device)
    for i, name in enumerate(names):
        reg.load(name, seed=i + 1)
    return reg


def _count_kernels(fn):
    """Device kernels one call of ``fn`` launches, read from the
    profiler's CUDA activity (None when it records none: not
    measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not any(w in e.name.lower() for w in ("memcpy", "memset")))
    return n or None


def _delta_bound_ms(cfg, lanes: int, distinct: int, rank: int) -> float:
    """Least time of one tick's LoRA delta over every layer: the distinct
    adapters' A and B of the three projections read once (f32), each
    lane's post-norm activation read and its q, k and v read and written
    (bf16) — at 3.35 TB/s (the products, 2 x lanes x rank x (dim + out)
    a projection, are far below the peak rate)."""
    dims = [(cfg.dim, cfg.n_heads * cfg.head_dim)] + \
        [(cfg.dim, cfg.n_kv_heads * cfg.head_dim)] * 2
    stacks = distinct * sum(4 * rank * (i + o) for i, o in dims)
    acts = lanes * 2 * (cfg.dim + 2 * sum(o for _, o in dims))
    return cfg.n_layers * (stacks + acts) / HBM_BYTES_PER_S * 1e3


def _adapter_timings(params, cfg, reg, kv_quant: str, megastep: int) -> dict:
    """Device ms of a resident dispatch on an adapter ring (``reg``; the
    8 lanes on slots 0, 1, 2, 3, 0, 1, 2, 3) against the adapterless ring
    on the same admissions, in turns (plain, adapters, plain, adapters),
    each a CUDA graph replay of every lane at 3b's shape (chunk 8, block
    256, fill ``ADAPT["fill"]``); with ``megastep`` 4 the 4-step dispatch
    too.  The aid-0 lanes' tokens must equal the adapterless ring's.  Then
    the delta alone (``lora_qkv`` over every layer for one tick, as a
    graph) on this mix and on 8 distinct adapters, beside its bound; the
    launches of a tick (profiler) on both rings; the graph pools and the
    stacks' bytes."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import executor as X
    from paddle_operator_tpu_torch.infer import qos as QOS

    slots, chunk, fill = RING["slots"], RING["chunk_tokens"], ADAPT["fill"]
    aids = [i % (len(ADAPT["names"]) + 1) for i in range(slots)]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, fill).tolist()
               for _ in range(slots)]
    steps = sorted({1, megastep})
    exs, toks, out = {}, {}, {}
    with torch.inference_mode():
        for name, adapters in (("plain", None), ("adapters", reg)):
            ex = X.RingExecutor(params, cfg, slots=slots,
                                max_len=RING["max_len"],
                                chunk_tokens=chunk, paged=True,
                                block_size=RING["block_size"],
                                kv_quant=kv_quant, megastep=megastep,
                                adapters=adapters)
            ex.prewarm()
            for slot, p in enumerate(prompts):
                _admit_cold(ex, slot, p, aids[slot] if adapters else 0)
            exs[name] = [ex, fill]
        for n in steps:
            for name in ("plain", "adapters", "plain", "adapters"):
                ex, f = exs[name]
                ms, exs[name][1], tk = _time_dispatches(
                    ex, f, ADAPT["dispatches"], n)
                out.setdefault(f"{name}_ms_n{n}", []).append(ms)
                toks.setdefault(name, []).append(tk)
        # the aid-0 lanes decode as on the adapterless ring, bit for bit
        base = [i for i, a in enumerate(aids) if a == 0]
        for tp, ta in zip(toks["plain"], toks["adapters"]):
            if not np.array_equal(tp[..., base], ta[..., base]):
                raise AssertionError(f"3m {kv_quant} megastep {megastep}: "
                                     "an aid-0 lane's tokens differ from "
                                     "the adapterless ring's")
            if np.array_equal(tp, ta):
                raise AssertionError(f"3m {kv_quant}: the adapters changed "
                                     "no token")
        for name in ("plain", "adapters"):
            e = exs[name][0]
            for slot in range(slots):
                e.pool.ensure(slot, exs[name][1] + chunk)
            plan = X.ExecPlan(1, [True] * slots, table=e.pool.table)
            n = _count_kernels(lambda e=e, plan=plan: e.run(plan))
            out[f"{name}_launches_tick"] = None if n is None else n / chunk
            out[f"{name}_graph_pool_bytes"] = e.graph_pool_bytes()
        ex = exs["adapters"][0]
        h = torch.randn(slots, 1, cfg.dim, dtype=cfg.dtype, device="cuda")
        qkv = [torch.randn(slots, 1, o, dtype=cfg.dtype, device="cuda")
               for o in (cfg.n_heads * cfg.head_dim,
                         cfg.n_kv_heads * cfg.head_dim,
                         cfg.n_kv_heads * cfg.head_dim)]

        def delta(aid):
            def tick(_=None):
                for li in range(cfg.n_layers):
                    adp_l, _a = QOS.layer_lora((reg.arrays(), aid), li)
                    QOS.lora_qkv(h, adp_l, aid, *qkv, cfg.dtype)
            return tick

        mixed = ex.aid.clone()
        out["delta_ms_tick"], out["delta_eager_ms_tick"] = time_ms(
            delta(mixed), 2)
        out["delta_launches_tick"] = _count_kernels(delta(mixed))
        out["delta_bound_ms"] = _delta_bound_ms(
            cfg, slots, len(set(aids) - {0}), reg.rank)
        # 8 distinct adapters (the ISSUE's bound case): fill the pool
        added = [f"t{i}" for i in range(len(reg), reg.capacity)]
        for i, name in enumerate(added):
            reg.load(name, seed=100 + i)
        eight = torch.arange(1, slots + 1, dtype=torch.int32, device="cuda")
        out["delta_ms_tick_8"], _ = time_ms(delta(eight), 2)
        out["delta_bound_ms_8"] = _delta_bound_ms(cfg, slots, slots,
                                                  reg.rank)
        for name in added:
            reg.evict(name)
    out["stacks_bytes"] = reg.nbytes()
    out.update(kv_quant=kv_quant, megastep=megastep, fill=fill, lanes=slots,
               lane_adapters=aids)
    del exs, ex
    return out


def phase_adapter_ring(paged: dict, params, cfg, ring_tokens=None,
                       bf16_ring=None) -> None:
    """Phase 3m: many-adapter serving on 3b's server; see the module
    docstring."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
    from paddle_operator_tpu_torch.infer.serve import make_server
    from paddle_operator_tpu_torch.ops import decode_attention as DA

    def clean():
        gc.collect()
        torch.cuda.empty_cache()

    names, late = ADAPT["names"], ADAPT["late"]
    reg = _registry(cfg, names, ADAPT["capacity"], ADAPT["rank"])
    log(f"3m: {len(names)} adapters, rank {reg.rank}, capacity "
        f"{reg.capacity}: stacks {reg.nbytes()} bytes on the card")
    # (a) 3b's cold prompts over HTTP, lanes alternating base / a1 / a2 / a3
    srv = make_server("127.0.0.1", 0, params, cfg, prewarm=True,
                      adapters=reg, **RING)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    batcher = srv.generator.batcher
    ex = batcher.executor
    rng = np.random.default_rng(0)          # 3b's generator, 3b's order
    cold = [rng.integers(0, cfg.vocab_size, n).tolist()
            for n in (32, 100, 257, 300, 511, 512, 600, 1000)]
    lane_adapter = [None if i % 4 == 0 else names[i % 4 - 1]
                    for i in range(len(cold))]
    results, errors = {}, []

    def send(i, p, n, adapter, key=None):
        try:
            body = {"tokens": [p], "max_new_tokens": n}
            if adapter is not None:
                body["adapter"] = adapter
            results[key if key is not None else i] = _post(base, body)
        except Exception as e:
            errors.append(f"{key or i}: {e!r}")

    try:
        if not batcher.prewarmed.wait(600) or ex.needs_capture:
            raise AssertionError(f"3m: no graphs captured at prewarm: "
                                 f"{batcher.prewarm_error!r}")
        graphs, ptrs = ex._graphs, ex._state_ptrs()
        stats0 = dict(batcher.stats)
        replays0 = ex.graph_replays
        _zero_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=send,
                                    args=(i, p, ADAPT["new"], a))
                   for i, (p, a) in enumerate(zip(cold, lane_adapter))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        burst_s = time.perf_counter() - t0
        chunks = batcher.stats["chunks"] - stats0["chunks"]
        replays = ex.graph_replays - replays0
        launches = DA.paged_decode_attention.launches
        if errors:
            raise AssertionError(f"3m burst requests failed: {errors}")
        outputs = {}
        for i, p in enumerate(cold):
            code, body, _ = results[i]
            if code != 200:
                raise AssertionError(f"3m cold {i}: HTTP {code}")
            _check_rows(cfg, p, body["tokens"][0], ADAPT["new"],
                        f"3m cold {i}")
            outputs[i] = body["tokens"][0]
        want = cfg.n_layers * RING["chunk_tokens"] * chunks
        if launches != want or replays != chunks:
            raise AssertionError(f"3m: paged kernel launches {launches} "
                                 f"(expected {want}), replays {replays} for "
                                 f"{chunks} dispatches")
        with urllib.request.urlopen(base + "/statusz", timeout=60) as r:
            statusz = json.loads(r.read())
        if statusz["activeAdapters"] != 3 \
                or statusz["adapterNames"] != list(names):
            raise AssertionError(f"3m /statusz adapters: "
                                 f"{statusz['activeAdapters']} "
                                 f"{statusz['adapterNames']}")
        same_3b = None
        if ring_tokens is not None:
            same_3b = [outputs[i] == ring_tokens.get(("cold", i))
                       for i, a in enumerate(lane_adapter)]
        new_tokens = ADAPT["new"] * len(cold)
        burst = {"burst_s": burst_s, "new_tok_s": new_tokens / burst_s,
                 "dispatches": chunks,
                 "wall_ms_per_chunk": burst_s / chunks * 1e3,
                 "graph_pool_bytes": ex.graph_pool_bytes(),
                 "equal_to_3b": same_3b}
        log(f"3m burst ({card_line()}): {json.dumps(burst)}; lanes "
            f"{lane_adapter}; kernel #2 launches {launches} == n_layers x "
            f"chunk x {chunks} dispatches, one graph replay each")
        # (b) a4 loaded at runtime, after the capture, into a free slot
        code, body = _post_any(base, "/v1/adapters",
                               {"load": {"name": late, "seed": 4}})
        if code != 200 or body != {"loaded": late, "slot": 4}:
            raise AssertionError(f"3m runtime load: HTTP {code} {body}")
        probe = cold[3]
        code, body, _ = _post(base, {"tokens": [probe], "max_new_tokens": 32,
                                     "adapter": late})
        if code != 200:
            raise AssertionError(f"3m: generate with {late}: HTTP {code}")
        late_tokens = body["tokens"][0]
        # (c) an evict while a lane serves it: 409; once idle: 200
        holder = threading.Thread(target=send, args=(
            0, cold[1], 400, late, "holder"))
        holder.start()
        t1 = time.perf_counter()
        while 4 not in ex.aid_host.tolist():
            if time.perf_counter() - t1 > 120 or errors:
                raise AssertionError(f"3m: the holder never admitted "
                                     f"{errors}")
            time.sleep(0.002)
        code409, body409 = _post_any(base, "/v1/adapters", {"evict": late})
        holder.join()
        code200, body200 = _post_any(base, "/v1/adapters", {"evict": late})
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            gauges = sorted(ln for ln in r.read().decode().splitlines()
                            if ln.startswith("tpujob_serve_adapter_loaded{"))
        if (code409, code200) != (409, 200) or errors \
                or results["holder"][0] != 200:
            raise AssertionError(f"3m evict: in use HTTP {code409} "
                                 f"{body409}, idle HTTP {code200} "
                                 f"{body200}; {errors}")
        if len(gauges) != 3 or any(late in g for g in gauges):
            raise AssertionError(f"3m /metrics after the evict: {gauges}")
        if ex._graphs is not graphs or ex._state_ptrs() != ptrs:
            raise AssertionError("3m: the runtime load and evict moved a "
                                 "captured tensor or recaptured")
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
        srv.generator.close()
    del srv, batcher, ex
    clean()
    # the same request on a ring booted with a4
    booted = _registry(cfg, names + (late,), ADAPT["capacity"], ADAPT["rank"])
    b = ContinuousBatcher(params, cfg, prewarm=True, adapters=booted,
                          **{k: v for k, v in RING.items()
                             if k != "continuous"})
    try:
        if not b.prewarmed.wait(600):
            raise AssertionError("3m: booted ring never prewarmed")
        booted_tokens = b.submit(probe, max_new_tokens=32,
                                 adapter=late).result(timeout=600)
    finally:
        b.close()
    del b, booted
    clean()
    log(f"3m: {late} loaded after capture into slot 4 streams "
        f"{'==' if late_tokens == booted_tokens else '!='} a ring booted "
        f"with it ({len(late_tokens) - len(probe)} tokens); evict while in "
        f"use {code409}, idle {code200}; gauges after: {gauges}")
    if late_tokens != booted_tokens:
        raise AssertionError("3m: the runtime-loaded adapter's stream "
                             "differs from the booted ring's")
    # (d) a chunk's device ms, the delta's, launches, pools: bf16 pool at
    # megastep 1 and 4 (one ring), the int8 pool at megastep 1
    timings = {}
    for key, kvq, mega in (("bf16", "none", 4), ("int8", "int8", 1)):
        timings[key] = _adapter_timings(params, cfg, reg, kvq, mega)
        log(f"3m timings {key} ({card_line()}): "
            f"{json.dumps(timings[key])}")
        clean()
    # (e) serve.main() with SERVE_ADAPTERS, as a pod boots it
    env = {"SERVE_ADAPTERS": ",".join(f"{n}:seed:{i + 1}"
                                      for i, n in enumerate(names)),
           "SERVE_ADAPTER_RANK": str(ADAPT["rank"]),
           "SERVE_MAX_ADAPTERS": str(ADAPT["capacity"])}
    boot = _main_boot(cfg, env, "3m", {"adapter": names[1]})
    log(f"3m serve.main(): {json.dumps(boot)}")
    st = boot["statusz"]
    if (boot["rc"] != 83 or "adapters=3," not in boot["startup"]
            or st["activeAdapters"] != 3
            or st["adapterNames"] != list(names)
            or boot["adapters"] != {"adapters": list(names),
                                    "capacity": ADAPT["capacity"],
                                    "rank": ADAPT["rank"]}
            or len(boot["adapter_gauges"]) != 3):
        raise AssertionError(f"3m serve.main(): {boot}")
    from statistics import fmean as mean

    bf = timings["bf16"]
    report = {"burst": burst, "timings": timings, "main_boot": boot,
              "stacks_bytes": reg.nbytes(),
              "late_load_equal": late_tokens == booted_tokens,
              "burst_3b_new_tok_s": (bf16_ring["burst_new_tok_s"]
                                     if bf16_ring else None)}
    log(f"3m ({card_line()}): a chunk as a graph "
        f"{mean(bf['adapters_ms_n1']):.2f} ms with adapters against "
        f"{mean(bf['plain_ms_n1']):.2f} without "
        f"(megastep 4: {mean(bf['adapters_ms_n4']):.2f} / "
        f"{mean(bf['plain_ms_n4']):.2f} a chunk; int8 pool "
        f"{mean(timings['int8']['adapters_ms_n1']):.2f} / "
        f"{mean(timings['int8']['plain_ms_n1']):.2f}); the delta "
        f"{bf['delta_ms_tick']:.4f} ms a tick (bound "
        f"{bf['delta_bound_ms']:.4f}; 8 distinct adapters "
        f"{bf['delta_ms_tick_8']:.4f}, bound {bf['delta_bound_ms_8']:.4f}), "
        f"{bf['delta_launches_tick']} launches a tick of "
        f"{bf['adapters_launches_tick']} (without: "
        f"{bf['plain_launches_tick']}); stacks {reg.nbytes()} bytes; "
        f"burst {burst['new_tok_s']:.1f} new tok/s")
    paged["adapters"] = report
    del reg
    clean()


def phase_adapter_equalities() -> None:
    """Phase 4k: adapter rings at f32 under graph replay; see the module
    docstring."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
    from paddle_operator_tpu_torch.models.llama import make_model

    from paddle_operator_tpu_torch.ops import decode_attention as DA

    params, cfg = make_model("7b", device="cuda", seed=8, n_layers=2,
                             dtype=torch.float32)
    params.requires_grad_(False)
    names = ("a1", "a2", "a3")
    reg = _registry(cfg, names, 4, 8)
    rng = np.random.default_rng(8)
    first = [rng.integers(0, cfg.vocab_size, n).tolist()
             for n in (40, 300, 129, 64)]
    adapters = [None, "a1", "a2", "a3"]
    # then: a1's 300-token prompt's first 10 blocks with a 37-token suffix
    # (a hit on a1's chain, then two slices of 24), and the 64-token prompt
    # again under a3 (a full hit capped at 63 rows)
    then = [(first[1][:160] + rng.integers(0, cfg.vocab_size, 37).tolist(),
             "a1"), (first[3], "a3")]
    n_new, max_len, slice_rows = 16, 512, 24
    stacks = reg.arrays()

    def lora(adapter):
        return (stacks, torch.tensor([reg.resolve(adapter) if adapter
                                      else 0], dtype=torch.int32,
                                     device="cuda"))

    jobs = list(zip(first, adapters)) + then
    with torch.no_grad():
        want = [D.generate(params, cfg,
                           torch.tensor([p], dtype=torch.int32,
                                        device="cuda"),
                           max_new_tokens=n_new, max_len=max_len,
                           lora=lora(a))[0].tolist() for p, a in jobs]
        # the delta against merged weights W + A.B, prefill and a decode
        # step (kernel #1), each adapter: the kernels are merged in place
        # and put back from copies
        gaps = {}
        x = torch.tensor([first[2]], dtype=torch.int32, device="cuda")
        kernels = [(li, proj, getattr(lp.attn, proj).kernel)
                   for li, lp in enumerate(params.layers)
                   for proj in ("wq", "wk", "wv")]
        for a in names:
            idx = reg.resolve(a)
            got, cache = D.prefill(params, cfg, x, max_len, lora=lora(a))
            tok = got.argmax(-1).to(torch.int32)
            got2, _ = D.decode_step(params, cfg, tok, cache, lora=lora(a))
            saved = [w.clone() for _, _, w in kernels]
            for li, proj, w in kernels:
                w += stacks[proj]["a"][li, idx] @ stacks[proj]["b"][li, idx]
            try:
                ref, cache = D.prefill(params, cfg, x, max_len)
                ref2, _ = D.decode_step(params, cfg, tok, cache)
            finally:
                for (_, _, w), w0 in zip(kernels, saved):
                    w.copy_(w0)
            gaps[a] = max(float((got - ref).abs().max()),
                          float((got2 - ref2).abs().max()))
    log(f"4k: logits with the delta against a forward on merged weights "
        f"W + A.B (prefill and a kernel #1 decode step): {gaps}")
    if max(gaps.values()) > 1e-4:
        raise AssertionError(f"4k: delta vs merged weights {gaps} > 1e-4")
    counters = {"contiguous": (DA.decode_attention, "launches"),
                "paged": (DA.paged_decode_attention, "launches"),
                "int8": (DA.paged_decode_attention, "quant_launches")}
    for name, ring in MEGA_RINGS:
        def batcher(ring=ring, **kw):
            args = dict(slots=4, max_len=max_len, chunk_tokens=8,
                        prewarm=True, prefill_chunk=slice_rows,
                        adapters=reg, **ring)
            args.update(kw)
            return ContinuousBatcher(params, cfg, **args)

        outs = {}
        for mode, megastep in (("inline", 1), ("chunked", 1),
                               ("chunked", 4)):
            b = batcher(prefill_mode=mode, megastep=megastep)
            ex = b.executor
            try:
                if not b.prewarmed.wait(600) or ex.needs_capture:
                    raise AssertionError(f"4k {name}: no graphs captured: "
                                         f"{b.prewarm_error!r}")
                graphs, ptrs = ex._graphs, ex._state_ptrs()
                _zero_launches()
                out = [h.result(timeout=600) for h in [
                    b.submit(p, max_new_tokens=n_new, adapter=a)
                    for p, a in zip(first, adapters)]]
                out += [b.submit(p, max_new_tokens=n_new, adapter=a).result(
                    timeout=600) for p, a in then]
                fn, attr = counters[name]
                launched = getattr(fn, attr)
                bad = []
                if ex.graph_replays != b.stats["chunks"] or not (
                        ex._graphs is graphs and ex._state_ptrs() == ptrs):
                    bad.append("not every dispatch a replay of the "
                               "prewarm graphs at their addresses")
                if launched != cfg.n_layers * 8 * megastep * b.stats[
                        "chunks"] or not launched:
                    bad.append(f"{name} kernel launches {launched}")
                if b.pool is not None:
                    b.pool.check_invariant()
                    hits = b.pool.stats["prefix_hit_tokens"]
                    if hits != 63 + 160:
                        bad.append(f"prefix hit tokens {hits}")
                if bad:
                    raise AssertionError(f"4k {name} {mode} megastep "
                                         f"{megastep}: {bad}")
                outs[mode, megastep] = out
            finally:
                b.close()
        # each lane of the mixed batch alone (no prefix cache: cold, as
        # in the batch); the adapterless ring on the base prompt
        solo_kw = {"prefix_cache": False} if ring.get("paged") else {}
        b = batcher(**solo_kw)
        try:
            solo = [b.submit(p, max_new_tokens=n_new, adapter=a).result(
                timeout=600) for p, a in zip(first, adapters)]
        finally:
            b.close()
        b = batcher(adapters=None)
        try:
            plain = b.submit(first[0], max_new_tokens=n_new).result(
                timeout=600)
        finally:
            b.close()
        restored = None
        if ring.get("paged"):
            restored = _preempted_adapter_lane(batcher, first, n_new)
        inline = outs["inline", 1]
        chunked = outs["chunked", 1]

        def agree(a, b):
            return f"{sum(x == y for x, y in zip(a, b))}/{len(b)}"

        line = (f"adapter {name} ring (7b width, 2 layers, f32, lanes "
                f"{adapters}, graph replays): aid-0 lane == adapterless "
                f"ring {inline[0] == plain}; mixed == solo on "
                f"{agree(inline[:4], solo)}; chunked megastep 4 == 1 on "
                f"{agree(outs['chunked', 4], chunked)}; chunked == inline on "
                f"{agree(chunked, inline)}; inline == generate(lora) on "
                f"{agree(inline, want)}; preempted {restored}")
        log(line)
        if (inline[0] != plain or inline[:4] != solo
                or outs["chunked", 4] != chunked
                or (restored is not None and not restored["equal"])):
            raise AssertionError(line)
        if name != "int8" and not chunked == inline == want:
            raise AssertionError(line)
    del params, reg
    torch.cuda.empty_cache()


def _preempted_adapter_lane(batcher, first, n_new) -> dict:
    """A lane serving a1 (prompt 1, 40 tokens) on a one-slot ring,
    preempted by a class-0 base request and restored: its stream equals
    its uninterrupted run (no prefix cache, so both are cold)."""
    b = batcher(slots=1, prefix_cache=False)
    ex = b.executor
    try:
        if not b.prewarmed.wait(600):
            raise AssertionError("4k: preemption ring never prewarmed")
        want = b.submit(first[1], max_new_tokens=40,
                        adapter="a1").result(timeout=600)
        real = ex.replay
        gate = threading.Event()
        gate.set()

        def slow(plan):
            gate.wait(timeout=120)
            time.sleep(0.02)
            return real(plan)

        ex.replay = slow
        n0 = b.stats["admitted"]
        h = b.submit(first[1], max_new_tokens=40, adapter="a1")
        t0 = time.perf_counter()
        while b.stats["admitted"] == n0 or ex.aid_host[0] != 1:
            if time.perf_counter() - t0 > 120:
                raise AssertionError("4k: the adapter lane never admitted")
            time.sleep(0.001)
        gate.clear()
        h0 = b.submit(first[0], max_new_tokens=4, priority=0)
        gate.set()
        h0.result(timeout=600)
        got = h.result(timeout=600)
        return {"equal": got == want and b.stats["restored_lanes"] >= 1,
                "preempted": b.stats["preempted_lanes"],
                "restored": b.stats["restored_lanes"]}
    finally:
        b.close()


# phase 3n: 3b's server with SERVE_NAN_CHECK and SERVE_TRACE on.  The
# nan_lane fault fires before this dispatch of 3b's burst (or the first
# after it with a lane that decodes it), on a seeded pick of such lanes;
# a chunk's device ms takes this many graph replays a turn; the params swapped in are the 7b init from this seed;
# the mid-flight swaps ride a streamed request of this many new tokens
# (about 10 s of decoding: a swap from the retained base uploads 13.48 GB
# before it reaches the ring)
RINGOPS = dict(nan_at=6, chaos_seed=5, dispatches=12, seed2=1,
               stream_new=1024)


def _stream_events(base: str, body: dict, out: dict) -> None:
    """A streamed generate into ``out``: its events, each with the host
    time it arrived (``t``)."""
    req = urllib.request.Request(
        base + "/v1/generate", data=json.dumps(dict(body, stream=True))
        .encode(), headers={"Content-Type": "application/json"},
        method="POST")
    events = out.setdefault("events", [])
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            if line.strip():
                events.append(dict(json.loads(line),
                                   t=time.perf_counter()))


def _ops_burst(base: str, batcher, cfg, headers=None) -> dict:
    """3b's burst (``burst_requests``) against ``base``: ``{(kind, i):
    (status, body)}``, the streamed request's body its last event."""
    _, _, jobs, late, keys = burst_requests(cfg)
    results, errors = {}, []

    def send(kind, i, p, n):
        try:
            body = {"tokens": [p], "max_new_tokens": n}
            if kind == "stream":
                got = {}
                _stream_events(base, body, got)
                ev = got["events"]
                toks = [e["token"] for e in ev if "token" in e]
                results[kind, i] = (200, dict(ev[-1], streamed=toks))
            else:
                results[kind, i] = _post_any(base, "/v1/generate", body,
                                             headers)
        except Exception as e:               # surfaced after the join
            errors.append(f"{kind} {i}: {e!r}")

    threads = [threading.Thread(target=send, args=j) for j in jobs]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    while not all(k in batcher.pool.entries for k in keys):
        if errors or time.perf_counter() - t0 > 600:
            raise AssertionError(f"3n: the shared prefix was never cached: "
                                 f"{errors}")
        time.sleep(0.005)
    more = [threading.Thread(target=send, args=j) for j in late]
    for t in more:
        t.start()
    for t in threads + more:
        t.join()
    if errors:
        raise AssertionError(f"3n burst requests failed: {errors}")
    return results


def _burst_outcomes(results: dict, ring_tokens: dict, what: str) -> tuple:
    """Each request of a burst against 3b's tokens: ``(equal keys,
    failed {key: (status, error)})``; a completed request with other
    tokens than 3b's raises."""
    equal, failed = [], {}
    for key, (code, body) in sorted(results.items()):
        err = body.get("error")
        if code != 200 or err is not None:
            failed[key] = (code, err)
            continue
        toks = body["tokens"][0] if key[0] != "stream" else body["tokens"]
        if toks != ring_tokens[key]:
            raise AssertionError(f"3n {what}: {key} differs from 3b's "
                                 "stream")
        equal.append(key)
    return equal, failed


def _live_victim_injector(CH, spec: str, seed: int):
    """A ``ChaosInjector`` whose ``nan_lane`` victim is a lane that will
    still decode the poisoned dispatch: decode-active, not done, and
    with more tokens left than the dispatches already in flight can
    emit — the seeded pick among such lanes for an event that names no
    lane, the named lane once it is such a lane.  An empty lane, one
    still prefilling or one that the in-flight dispatches finish is
    dropped at the consume without a verdict, so poisoning it injects
    nothing; which lanes those are depends on how the requests arrived.
    While no lane qualifies, the event moves on to the next dispatch."""

    class LiveVictim(CH.ChaosInjector):
        def _apply(self, ev, idx):
            if ev.kind == "nan_lane":
                b = self.batcher
                pre = b._pending_prefill_slots()
                need = b.pipeline_depth * b.executor.chunk * b.megastep
                live = [i for i, r in enumerate(b.lane)
                        if r is not None and not r.done.is_set()
                        and i not in pre and b._lane_left[i] > need
                        and (ev.arg is None or i == int(ev.arg))]
                if not live:
                    self.events.setdefault(idx + 1, []).append(ev)
                    return
                ev = CH.ChaosEvent(ev.kind, idx, float(self.rng.choice(live)))
            super()._apply(ev, idx)

    return LiveVictim(spec, seed=seed)


def _trace_cost_us(TR, lanes: int, chunks: int = 200) -> float:
    """Host microseconds a consumed dispatch spends on span capture on
    a ring of ``lanes`` traced lanes (one ``decode_dispatch`` span a
    lane, as ``_consume_oldest`` adds them)."""
    traces = [TR.RequestTrace(pod="r") for _ in range(lanes)]
    t = time.monotonic()
    t0 = time.perf_counter()
    for i in range(chunks):
        if i % 100 == 0:
            traces = [TR.RequestTrace(pod="r") for _ in range(lanes)]
        for tr in traces:
            tr.add("decode_dispatch", t, t, steps=1)
    return (time.perf_counter() - t0) / chunks * 1e6


def phase_ring_ops(report: dict, params, cfg, ring_tokens) -> None:
    """Phase 3n: the ring operations on 3b's server; see the module
    docstring."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import chaos as CH
    from paddle_operator_tpu_torch.infer import executor as X
    from paddle_operator_tpu_torch.infer.resilience import RingResilience
    from paddle_operator_tpu_torch.infer.serve import host_state, make_server
    from paddle_operator_tpu_torch.models.llama import make_model
    from paddle_operator_tpu_torch.ops import decode_attention as DA
    from paddle_operator_tpu_torch.ops import quant_matmul as QM
    from paddle_operator_tpu_torch.utils import tracing as TR

    def clean():
        gc.collect()
        torch.cuda.empty_cache()

    out = {}
    slots, chunk = RING["slots"], RING["chunk_tokens"]
    # (a) one chunk as a graph, the check off and on, in turns, on
    # executors admitted alike (8 lanes at fill 512)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, 512).tolist()
               for _ in range(slots)]
    exs, ms, warm = {}, {"off": [], "on": []}, {}
    with torch.inference_mode():
        for name in ("off", "on"):
            ex = X.RingExecutor(params, cfg, slots=slots, max_len=1024,
                                chunk_tokens=chunk, paged=True,
                                block_size=RING["block_size"],
                                check_finite=name == "on")
            ex.prewarm()
            for slot, p in enumerate(prompts):
                _admit_cold(ex, slot, p)
            exs[name] = [ex, 512]
        for name in ("off", "on", "on", "off"):
            t, exs[name][1], w = _time_dispatches(*exs[name],
                                                  RINGOPS["dispatches"])
            ms[name].append(t)
            warm.setdefault(name, w)
    del exs, ex
    clean()
    log(f"3n (a) a chunk as a graph (8 lanes x 8 ticks, fill 520-720), "
        f"device ms: check off {ms['off']}, on {ms['on']}; tokens "
        f"identical: {bool(np.array_equal(warm['off'], warm['on']))} on "
        f"{card_line()}")
    if not np.array_equal(warm["off"], warm["on"]):
        raise AssertionError("3n: the finite check changed the tokens")
    out["chunk_ms_check_off"], out["chunk_ms_check_on"] = ms["off"], ms["on"]

    # (b)-(d) the server: 3b's, with the check and span tracing on
    srv = make_server("127.0.0.1", 0, params, cfg, prewarm=True, trace=True,
                      resilience=RingResilience(watchdog=False,
                                                nan_check=True), **RING)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    batcher = srv.generator.batcher
    ex = batcher.executor
    try:
        if not batcher.prewarmed.wait(600) or ex.needs_capture:
            raise AssertionError(f"3n: no graphs captured at prewarm: "
                                 f"{batcher.prewarm_error!r}")
        inj = _live_victim_injector(CH, f"nan_lane@{RINGOPS['nan_at']}",
                                    RINGOPS["chaos_seed"]).install(batcher)
        stats0 = dict(batcher.stats)
        _zero_launches()
        t0 = time.perf_counter()
        results = _ops_burst(base, batcher, cfg,
                             headers={TR.TRACE_HEADER: "3n-trace"})
        burst_s = time.perf_counter() - t0
        chunks = batcher.stats["chunks"] - stats0["chunks"]
        equal, failed = _burst_outcomes(results, ring_tokens, "(b)")
        launches = DA.paged_decode_attention.launches
        log(f"3n (b) 3b's burst with nan_lane at dispatch "
            f"{RINGOPS['nan_at']}: fired {inj.fired}; failed {failed}; "
            f"{len(equal)}/{len(results) - len(failed)} others equal 3b's "
            f"streams; quarantinedLanes "
            f"{batcher.stats['quarantined_lanes']}; {chunks} dispatches, "
            f"paged kernel launches {launches}, {burst_s:.2f}s")
        if (len(failed) != 1 or batcher.stats["quarantined_lanes"] != 1
                or [k for k, _ in inj.fired] != ["nan_lane"]):
            raise AssertionError(f"3n: expected one quarantined request, "
                                 f"got {failed}")
        (code, err), = failed.values()
        if "quarantined" not in str(err) or code not in (200, 503):
            raise AssertionError(f"3n: the victim failed with {code} {err}")
        if launches != cfg.n_layers * chunk * chunks:
            raise AssertionError(f"3n: paged kernel launches {launches}")
        pool = batcher.pool
        pool.check_invariant()
        if pool.blocks_free() + pool.blocks_cached() != pool.num_blocks:
            raise AssertionError("3n: blocks still mapped after the burst")
        # (d) every response's span tree has one root
        roots = {}
        for key, (code, body) in results.items():
            if key in failed:
                continue
            tree = body["trace"] if key[0] == "stream" else body["trace"][0]
            rs = TR.span_roots(tree["spans"])
            names = {s["name"] for s in tree["spans"]}
            if len(rs) != 1 or not {"queue_wait", "admit", "ttft",
                                    "decode_dispatch"} <= names:
                raise AssertionError(f"3n: {key}'s trace: roots {rs}, "
                                     f"spans {names}")
            roots[key] = len(tree["spans"])
        cost = _trace_cost_us(TR, slots)
        wall = burst_s / max(1, chunks) * 1e3
        log(f"3n (d) {len(roots)} responses, one root each, spans "
            f"{sorted(roots.values())}; span capture {cost:.1f} us of host "
            f"a dispatch of 8 traced lanes (against {wall:.1f} ms wall a "
            f"dispatch in this burst, "
            f"{report['ring']['wall_ms_per_chunk']:.1f} in 3b's)")
        out.update(quarantined=[list(k) for k in failed],
                   equal_streams=len(equal), burst_s=burst_s,
                   trace_us_per_dispatch=cost, wall_ms_per_dispatch=wall)

        # (c) one dispatch_fail: the ring heals, captures again, serves
        graphs = ex._graphs
        nxt = inj.dispatches
        inj.events[nxt] = [CH.ChaosEvent("dispatch_fail", nxt)]
        code, body = _post_any(base, "/v1/generate",
                               {"tokens": [burst_requests(cfg)[0][0]],
                                "max_new_tokens": 48})
        t0 = time.perf_counter()
        while not batcher.accepting and time.perf_counter() - t0 < 60:
            time.sleep(0.01)
        heal_s = time.perf_counter() - t0
        code2, body2 = _post_any(base, "/v1/generate",
                                 {"tokens": [burst_requests(cfg)[0][0]],
                                  "max_new_tokens": 48})
        log(f"3n (c) dispatch_fail: HTTP {code} ({body.get('error')!r}), "
            f"ready again after {heal_s:.2f}s, graphs captured again: "
            f"{ex._graphs is not graphs and not ex.needs_capture}; the "
            f"retry HTTP {code2}, equal to 3b's cold 0: "
            f"{code2 == 200 and body2['tokens'][0] == ring_tokens['cold', 0]}")
        if (code != 503 or code2 != 200
                or body2["tokens"][0] != ring_tokens["cold", 0]
                or ex._graphs is graphs or ex.needs_capture
                or batcher.stats["watchdog_restarts"] != 1):
            raise AssertionError("3n: the ring did not heal from an "
                                 "injected dispatch failure")

        # (e) a mid-flight swap to the seed-2 params, made on the card
        t0 = time.perf_counter()
        params2, _ = make_model("7b", device="cuda", seed=RINGOPS["seed2"],
                                param_dtype=cfg.dtype)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        streamed = burst_requests(cfg)[2][-1][2]
        swaps = {}

        def swap_mid_flight(what, fn):
            """``fn()`` runs the swap while a streamed request decodes;
            returns the stream's events."""
            got = {}
            st = threading.Thread(target=_stream_events, args=(
                base, {"tokens": [streamed],
                       "max_new_tokens": RINGOPS["stream_new"]}, got))
            st.start()
            while len([e for e in got.get("events", [])
                       if "token" in e]) < 16:
                time.sleep(0.005)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = fn()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            st.join()
            ev = got["events"]
            ts = [e["t"] for e in ev if "token" in e]
            toks = [e["token"] for e in ev if "token" in e]
            if (len(toks) != RINGOPS["stream_new"] or not ev[-1].get("done")
                    or res["parkedLanes"] != 1):
                raise AssertionError(f"3n {what}: the stream broke across "
                                     f"the swap: {len(toks)} tokens, last "
                                     f"event {str(ev[-1])[:200]}, {res}")
            split = {k: round(v, 4) for k, v in batcher.last_swap.items()}
            swaps[what] = dict(res, wall_s=wall, split_s=split,
                               peak_gb=peak / 1e9,
                               max_token_gap_s=max(np.diff(ts)))
            log(f"3n (e) {what}: {res}; wall {wall:.3f}s, split {split}; "
                f"the stream's largest token gap "
                f"{max(np.diff(ts)):.3f}s; peak allocated {peak / 1e9:.2f} "
                f"GB on {card_line()}")
            return toks

        swap_mid_flight("swap to seed-1 params",
                        lambda: batcher.swap_weights(params2))
        if batcher.executor.params is not params2 or batcher.generation != 1:
            raise AssertionError("3n: the swap did not flip the weights")
        # the retained base (SERVE_SWAP_RETAIN): a host copy of params
        t0 = time.perf_counter()
        srv.swap_base = {"params": host_state(params),
                         "weight_quant": "none"}
        retain_s = time.perf_counter() - t0
        del params2
        swap_mid_flight("checkpoint-less swap back to the retained base",
                        lambda: _post_any(base, "/v1/swap", {})[1])
        clean()
        results = _ops_burst(base, batcher, cfg)
        equal, failed = _burst_outcomes(results, ring_tokens, "(e)")
        log(f"3n (e) after the swap back: {len(equal)}/{len(results)} "
            f"streams equal 3b's; retaining the base took {retain_s:.1f}s "
            f"of host copy, the seed-1 init {init_s:.1f}s")
        if failed:
            raise AssertionError(f"3n: requests failed after the swap "
                                 f"back: {failed}")

        # (f) a flip to int8 weights: kernels A and B launched as
        # qmm_launches_want counts them
        t0 = time.perf_counter()
        code, res = _post_any(base, "/v1/swap", {"weight_quant": "int8"})
        flip_s = time.perf_counter() - t0
        if code != 200 or res["weightQuantMode"] != "int8":
            raise AssertionError(f"3n: the int8 flip answered {code} {res}")
        swaps["flip to int8"] = dict(
            res, wall_s=flip_s,
            split_s={k: round(v, 4) for k, v in batcher.last_swap.items()})
        cold = burst_requests(cfg)[0]
        stats0 = dict(batcher.stats)
        _zero_launches()
        got = {}
        threads = [threading.Thread(target=lambda i=i, p=p: got.__setitem__(
            i, _post_any(base, "/v1/generate",
                         {"tokens": [p], "max_new_tokens": 48})))
            for i, p in enumerate(cold)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        chunks = batcher.stats["chunks"] - stats0["chunks"]
        for i, p in enumerate(cold):
            code, body = got[i]
            if code != 200:
                raise AssertionError(f"3n int8 cold {i}: HTTP {code}")
            _check_rows(cfg, p, body["tokens"][0], 48, f"3n int8 cold {i}")
        qmm = (QM.quant_matmul.launches, QM.quant_gemm.launches)
        want = qmm_launches_want(cfg, chunk * chunks, [len(p) for p in cold],
                                 False)
        with urllib.request.urlopen(base + "/statusz", timeout=60) as r:
            statusz = json.loads(r.read())
        log(f"3n (f) int8 flip in {flip_s:.2f}s ({swaps['flip to int8']}): "
            f"(kernel A, kernel B) launches {qmm}, expected {want}; "
            f"/statusz weightQuantMode {statusz['weightQuantMode']}, "
            f"weightSwaps {statusz['weightSwaps']}, weightGeneration "
            f"{statusz['weightGeneration']}")
        if qmm != want or statusz["weightQuantMode"] != "int8":
            raise AssertionError(f"3n: int8 launches {qmm}, expected {want}")
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
        srv.generator.close()
        srv.swap_base = None
    out["swaps"] = swaps
    report["ring_ops"] = out


def phase_ring_ops_equalities() -> None:
    """Phase 4l: the ring operations at 7b width, 2 layers, float32,
    under graphs; see the module docstring."""
    import copy

    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import chaos as CH
    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
    from paddle_operator_tpu_torch.infer.resilience import (
        LaneQuarantined,
        RingResilience,
    )
    from paddle_operator_tpu_torch.models.llama import make_model
    from paddle_operator_tpu_torch.utils import tracing as TR

    params, cfg = make_model("7b", device="cuda", seed=3, n_layers=2,
                             dtype=torch.float32)
    params1, _ = make_model("7b", device="cuda", seed=4, n_layers=2,
                            dtype=torch.float32)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (300, 64, 513, 40)]
    temps, seeds, n_new, max_len = [0.0, 0.0, 0.8, 0.8], [0, 0, 11, 12], 80, 1024
    with torch.inference_mode():
        gen1 = [D.generate(params1, cfg, torch.tensor([p], dtype=torch.int32,
                                                      device="cuda"),
                           max_new_tokens=n_new, max_len=max_len)[0].tolist()
                for p in prompts[:2]]

    def ring(model, kind, megastep, **kw):
        return ContinuousBatcher(
            model, cfg, slots=4, max_len=max_len, chunk_tokens=8,
            megastep=megastep, paged=kind != "contiguous", block_size=256,
            kv_quant="int8" if kind == "int8" else "none", **kw)

    def submit(b):
        return [b.submit(p, max_new_tokens=n_new, temperature=t, seed=s)
                for p, t, s in zip(prompts, temps, seeds)]

    def served(model, kind, megastep):
        b = ring(model, kind, megastep)
        try:
            return [h.result(timeout=600) for h in submit(b)]
        finally:
            b.close()

    for kind in ("contiguous", "paged", "int8"):
        for megastep in (1, 4):
            what = f"{kind} ring, megastep {megastep}"
            want = served(params, kind, megastep)
            b = ring(params, kind, megastep, trace=True,
                     resilience=RingResilience(watchdog=False,
                                               nan_check=True))
            ex = b.executor
            try:
                hs = submit(b)
                got = [h.result(timeout=600) for h in hs]
                if got != want or any(
                        len(TR.span_roots(h.trace.to_wire()["spans"])) != 1
                        for h in hs):
                    raise AssertionError(f"4l {what}: traced != untraced")
                # the same prompts again: their full blocks now hit the
                # radix, the path the runs below take (on the int8 pool a
                # hit reads the quantized prefix where a cold prefill
                # attends the exact rows, so its tokens may differ)
                again = [h.result(timeout=600) for h in submit(b)]
                if kind != "int8" and again != want:
                    raise AssertionError(f"4l {what}: a prefix hit != the "
                                         "cold prefill")
                inj = _live_victim_injector(CH, "", seed=0).install(b)
                nxt = inj.dispatches
                inj.events[nxt] = [CH.ChaosEvent("nan_lane", nxt, 1)]
                outs = []
                for h in submit(b):
                    try:
                        outs.append(h.result(timeout=600))
                    except LaneQuarantined:
                        outs.append(None)
                bad = [i for i, o in enumerate(outs) if o is None]
                if (len(bad) != 1 or b.stats["quarantined_lanes"] != 1
                        or any(o != w for o, w in zip(outs, again)
                               if o is not None)):
                    raise AssertionError(f"4l {what}: nan_lane quarantined "
                                         f"{bad}; the others equal: "
                                         f"{[o == w for o, w in zip(outs, again)]}")
                swapped = "not swapped (an unpaged ring refuses)"
                if kind != "contiguous":
                    # replays paced, so the swap lands mid-flight; the
                    # identical weights are copied before the streams
                    # start (a copy inside the window once let the
                    # megastep-4 paged ring finish its lanes first)
                    same = copy.deepcopy(params)
                    replay = ex.replay
                    ex.replay = lambda plan: (time.sleep(0.05),
                                              replay(plan))[1]
                    hs = submit(b)
                    chunks = b.stats["chunks"]
                    while b.stats["chunks"] < chunks + 1:
                        time.sleep(0.001)
                    res = b.swap_weights(same)
                    got = [h.result(timeout=600) for h in hs]
                    ex.replay = replay
                    if not res["parkedLanes"]:
                        raise AssertionError(f"4l {what}: the swap parked "
                                             "no lane")
                    if got != again:
                        raise AssertionError(f"4l {what}: a mid-flight swap "
                                             "to identical weights changed "
                                             "the streams")
                    b.swap_weights(params1)
                    got = [h.result(timeout=600) for h in submit(b)]
                    fresh = served(params1, kind, megastep)
                    if got != fresh or (kind == "paged"
                                        and got[:2] != gen1):
                        raise AssertionError(f"4l {what}: the swap to "
                                             "seed-4 params != a fresh "
                                             "ring / generate on them")
                    swapped = (f"mid-flight swap ({res['parkedLanes']} "
                               "parked) == unswapped, swap to seed-4 == "
                               "fresh ring" + (" == generate"
                                               if kind == "paged" else ""))
                if ex.graph_replays != b.stats["chunks"]:
                    raise AssertionError(f"4l {what}: {b.stats['chunks']} "
                                         f"dispatches, {ex.graph_replays} "
                                         "graph replays")
            finally:
                b.close()
            log(f"4l {what} (7b width, 2 layers, f32, graphs): traced == "
                f"untraced (sampled lanes included), nan_lane victim "
                f"{bad} quarantined and the rest == the chaos-free run on "
                f"the same prefix-hit path, {swapped}")
    del params, params1
    torch.cuda.empty_cache()


def phase_train_kernel_equals_plain() -> None:
    """Phase 4c: three f32 train steps through the flash kernels and
    through the plain attention, from the same init."""
    from unittest import mock

    import numpy as np
    import torch

    from paddle_operator_tpu_torch.models import llama as LM
    from paddle_operator_tpu_torch.ops import flash_attention as FA
    from paddle_operator_tpu_torch.ops.attention import reference_attention
    from paddle_operator_tpu_torch.train import trainer as T
    from paddle_operator_tpu_torch.train.data import deterministic_lm_batches

    model, cfg = LM.make_model("7b", device="cuda", seed=2, n_layers=2,
                               dtype=torch.float32)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    data = deterministic_lm_batches(2, 513, cfg.vocab_size, seed=4)
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
               for _, b in zip(range(3), data)]

    def run():
        model.load_state_dict(init)
        opt = T.make_optimizer(1e-3, warmup_steps=1, decay_steps=100)
        state = T.create_state(model, opt)
        step = T.make_train_step(opt)
        out = []
        for b in batches:
            state, m = step(state, b)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out

    FA.flash_forward.launches = 0
    kern = run()
    launched = FA.flash_forward.launches
    with mock.patch.object(LM, "attention", reference_attention):
        plain = run()
    if not launched or FA.flash_forward.launches != launched:
        raise AssertionError("the kernel run did not launch the flash "
                             "forward, or the plain run did")
    log(f"train kernel path == plain path (7b width, 2 layers, f32, B=2 "
        f"S=512, 3 steps): kernel {kern}, plain {plain}")
    for (lk, gk), (lp, gp) in zip(kern, plain):
        if not (np.isclose(lk, lp, rtol=1e-5, atol=0)
                and np.isclose(gk, gp, rtol=1e-4, atol=0)):
            raise AssertionError(f"train step through the kernels differs "
                                 f"from the plain path: loss {lk} vs {lp}, "
                                 f"grad_norm {gk} vs {gp}")
    del model, init, batches
    torch.cuda.empty_cache()


# phase 3q's child: the user's training program in the pod, started by
# the launcher (``python -m paddle_operator_tpu_torch.launch.launcher --
# python <this file> <json>``).  It prints one JSON line an event.
MOE_TRAIN_CHILD = r'''
import itertools
import json
import logging
import sys
import time

import torch

from paddle_operator_tpu_torch.ft.preemption import (EXIT_PREEMPTED,
                                                     PreemptionWatcher)
from paddle_operator_tpu_torch.launch import launcher
from paddle_operator_tpu_torch.models.llama import make_model
from paddle_operator_tpu_torch.ops import flash_attention as FA
from paddle_operator_tpu_torch.train import trainer as T
from paddle_operator_tpu_torch.train.checkpoint import (CheckpointManager,
                                                        resume_or_init)
from paddle_operator_tpu_torch.train.data import (DevicePrefetcher,
                                                  deterministic_lm_batches)
from paddle_operator_tpu_torch.utils.observability import StepTimer


def emit(**kw):
    print(json.dumps(kw), flush=True)


def synced():
    torch.cuda.synchronize()
    return time.perf_counter()


def main():
    a = json.loads(sys.argv[1])
    env = launcher.initialize()            # one worker: no process group
    watcher = PreemptionWatcher.install()
    opt = T.make_optimizer(a["lr"], warmup_steps=1, decay_steps=1000,
                           moments=a["moments"])
    cfgs = {}

    def init():
        model, cfgs["cfg"] = make_model("7b-moe", device="cuda", seed=0,
                                        n_layers=a["layers"])
        return T.create_state(model, opt)

    t0 = time.perf_counter()
    ckpt = CheckpointManager(env.checkpoint_path,
                             save_interval_steps=10 ** 9)
    state, resumed = resume_or_init(ckpt, init)
    cfg = cfgs["cfg"]
    start = state.step
    emit(event="start", step=start, resumed=resumed, rank=env.rank,
         num_workers=env.num_workers, params=cfg.num_params(),
         active_params=cfg.active_params(), ready_s=time.perf_counter() - t0)
    b, s = a["batch"], a["seq"]
    data = DevicePrefetcher(itertools.islice(deterministic_lm_batches(
        b, s + 1, cfg.vocab_size, seed=0, start_step=start), a["steps"]),
        device="cuda")
    step = T.make_train_step(opt)

    def step_logged(st, batch):
        st, m = step(st, batch)
        emit(event="step", step=st.step, loss=float(m["loss"]),
             aux_loss=float(m["aux_loss"]),
             grad_norm=float(m["grad_norm"]))
        return st, m

    timer = StepTimer(b * s, cfg.flops_per_token(), a["peak"],
                      window=a["steps"], clock=synced)
    for fn in (FA.flash_forward, FA.flash_backward_dkv,
               FA.flash_backward_dq):
        fn.launches = 0
    logger = logging.getLogger("moe-train")
    logger.setLevel(logging.INFO)
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger.addHandler(handler)
    t0 = synced()
    state, hist = T.fit(state, step_logged, data, steps=a["steps"],
                        checkpoint=ckpt, timer=timer, preemption=watcher,
                        logger=logger)
    wall = synced() - t0
    ckpt.wait()
    emit(event="drained" if watcher.draining else "done", step=state.step,
         steps=len(hist), fit_wall_s=wall,
         step_ms=[t * 1e3 for t in timer.times],
         flops_per_token=cfg.flops_per_token(),
         launches=[FA.flash_forward.launches,
                   FA.flash_backward_dkv.launches,
                   FA.flash_backward_dq.launches],
         save=ckpt.last_save, log=records,
         peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return EXIT_PREEMPTED if watcher.draining else 0


if __name__ == "__main__":
    raise SystemExit(main())
'''


def _launch_pod(child: str, ckpt_dir: str, args: dict, logf,
                sigterm_after=None) -> tuple:
    """One run of the training pod: the launcher shim over ``child``
    with ``MOE_POD_ENV``, ``TPUJOB_DRAIN=1`` and ``ckpt_dir``; SIGTERM
    to the shim once the child logs step ``sigterm_after``.  Returns
    (the shim's exit code, the child's events, the host clock of the
    SIGTERM)."""
    import signal

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "TPUJOB_", "MEGASCALE_"))}
    env.update(MOE_POD_ENV, TPUJOB_DRAIN="1",
               TPUJOB_CHECKPOINT_PATH=ckpt_dir,
               PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_operator_tpu_torch.launch.launcher",
         "--", sys.executable, child, json.dumps(args)],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE, stderr=logf,
        text=True)
    events, sent = [], None
    try:
        for line in proc.stdout:
            line = line.strip()
            if not line.startswith("{"):
                continue
            ev = json.loads(line)
            events.append(ev)
            if (sigterm_after is not None and sent is None
                    and ev.get("event") == "step"
                    and ev["step"] >= sigterm_after):
                sent = time.perf_counter()
                proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rc, events, sent


def phase_moe_train_pod(reports: dict) -> None:
    """Phase 3q: the operator's training pod, supervised by the port's
    launcher, trains 7b-moe; see the module docstring."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from paddle_operator_tpu_torch.ft.preemption import EXIT_PREEMPTED
    from paddle_operator_tpu_torch.models.llama import CONFIGS

    card = card_line()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    child = os.path.join(root, "train_moe.py")
    ckpt_dir = os.path.join(root, "ckpt")
    Path(child).write_text(MOE_TRAIN_CHILD)
    logpath = os.path.join(root, "pod.log")
    cfg = dataclasses.replace(CONFIGS["7b-moe"],
                              n_layers=MOE_TRAIN["layers"])
    args = {k: MOE_TRAIN[k]
            for k in ("layers", "batch", "seq", "lr", "moments")}
    args["peak"] = PEAK_BF16
    try:
        free = shutil.disk_usage(root).free
        need = 6 * cfg.num_params()    # a step of f32 p, int8 mu and nu
        log(f"moe train pod: 7b-moe width, {cfg.n_layers} layer(s) "
            f"({cfg.num_params() / 1e9:.3f}B params, "
            f"{cfg.active_params() / 1e9:.3f}B active), B="
            f"{MOE_TRAIN['batch']} S={MOE_TRAIN['seq']}; {free / 1e9:.1f} "
            f"GB free under {root} (a save {need / 1e9:.1f} GB); {card}")
        if free < need:
            raise AssertionError("not enough disk for phase 3q's checkpoint")
        with open(logpath, "w") as logf:
            t0 = time.perf_counter()
            rc1, ev1, sent = _launch_pod(
                child, ckpt_dir, dict(args, steps=MOE_TRAIN["steps"]), logf,
                sigterm_after=MOE_TRAIN["drain_after"])
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            rc2, ev2, _ = _launch_pod(
                child, ckpt_dir, dict(args, steps=MOE_TRAIN["resume_steps"]),
                logf)
            second_s = time.perf_counter() - t0
        tail = Path(logpath).read_text()[-3000:]
        ends = [e for e in ev1 if e["event"] in ("drained", "done")]
        if rc1 != EXIT_PREEMPTED or sent is None or not ends \
                or ends[-1]["event"] != "drained":
            raise AssertionError(f"3q: the shim exited {rc1} after SIGTERM "
                                 f"(want {EXIT_PREEMPTED}); events "
                                 f"{str(ev1)[-1500:]}; log {tail}")
        drained = ends[-1]
        d_step = drained["step"]
        committed = sorted(int(n) for n in os.listdir(ckpt_dir)
                           if n.isdigit())
        saved = torch.load(os.path.join(ckpt_dir, str(d_step), "params.pt"),
                           mmap=True, weights_only=True, map_location="cpu")
        moe_keys = sorted(k for k in saved if k.startswith("layers.0.moe."))
        del saved
        start2 = next(e for e in ev2 if e["event"] == "start")
        done2 = [e for e in ev2 if e["event"] == "done"]
        steps1 = [e for e in ev1 if e["event"] == "step"]
        steps2 = [e for e in ev2 if e["event"] == "step"]
        finite = all(np.isfinite([e["loss"], e["aux_loss"], e["grad_norm"]]
                                 ).all() for e in steps1 + steps2)
        log(f"moe train pod: launch 1 exit {rc1} in {first_s:.1f}s (SIGTERM "
            f"to the shim after step {MOE_TRAIN['drain_after']}; the child "
            f"drained at step {d_step}, checkpoint steps {committed}, "
            f"{drained['log']}); launch 2 exit {rc2} in {second_s:.1f}s, "
            f"started at step {start2['step']} (resumed "
            f"{start2['resumed']}), ended at "
            f"{done2[-1]['step'] if done2 else None}; checkpoint keys "
            f"{moe_keys}; {card}")
        log(f"moe train pod: losses {[e['loss'] for e in steps1 + steps2]}, "
            f"aux_loss {[e['aux_loss'] for e in steps1 + steps2]}")
        if committed != [d_step] or d_step < MOE_TRAIN["drain_after"]:
            raise AssertionError(f"3q: the drain committed {committed}, the "
                                 f"child drained at step {d_step}")
        if rc2 != 0 or not start2["resumed"] or start2["step"] != d_step \
                or not done2 \
                or done2[-1]["step"] != d_step + MOE_TRAIN["resume_steps"]:
            raise AssertionError(f"3q: the second launch (exit {rc2}) did not "
                                 f"resume at step {d_step} and take "
                                 f"{MOE_TRAIN['resume_steps']} steps: "
                                 f"{str(ev2)[-1500:]}; log {tail}")
        if not finite or len(steps1) != drained["steps"]:
            raise AssertionError("3q: a loss, aux_loss or grad norm is not "
                                 "finite, or a step was not logged")
        if not {"layers.0.moe.router.kernel", "layers.0.moe.w1",
                "layers.0.moe.w2"} <= set(moe_keys):
            raise AssertionError(f"3q: the checkpoint lacks the MoE leaves: "
                                 f"{moe_keys}")
        layers = cfg.n_layers
        bad = []
        for what, e in (("launch 1", drained), ("launch 2", done2[-1])):
            n = e["steps"]
            want = [2 * layers * n, layers * n, layers * n]
            if e["launches"] != want:
                bad.append(f"{what}: flash launches {e['launches']}, "
                           f"expected {want}")
        if bad:
            raise AssertionError(f"3q: {bad}")
        times = drained["step_ms"]          # steps 2..N of launch 1
        step_ms = float(np.median(times[1:] if len(times) > 1 else times))
        b, s = MOE_TRAIN["batch"], MOE_TRAIN["seq"]
        tok_s = b * s / (step_ms / 1e3)
        mfu = tok_s * drained["flops_per_token"] / PEAK_BF16
        run = {"layers": layers, "batch": b, "seq": s,
               "params": cfg.num_params(),
               "active_params": cfg.active_params(),
               "drained_step": d_step, "exit_codes": [rc1, rc2],
               "resumed_at": start2["step"],
               "step_ms": times, "step_ms_median": step_ms,
               "tokens_per_s": tok_s, "mfu_active": mfu,
               "losses": [e["loss"] for e in steps1 + steps2],
               "aux_losses": [e["aux_loss"] for e in steps1 + steps2],
               "launches": {"launch1": drained["launches"],
                            "launch2": done2[-1]["launches"]},
               "drain_save": drained["save"],
               "launch_s": [first_s, second_s],
               "child_ready_s": [next(e for e in ev1
                                      if e["event"] == "start")["ready_s"],
                                 start2["ready_s"]],
               "peak_gb": [drained["peak_gb"], done2[-1]["peak_gb"]]}
        log("moe train pod: " + json.dumps(run))
        log(f"moe train pod (one run, not a benchmark): step {step_ms:.1f} ms "
            f"(median of steps 2..{len(times)}), {tok_s:.0f} tokens/s, MFU "
            f"{mfu:.3f} on active params against {PEAK_BF16 / 1e12:.0f} "
            f"TFLOP/s bf16; drain save {drained['save']}; {card}")
        reports["flash_forward"]["moe_train"] = run
        for kern, i in (("flash_forward", 0), ("flash_backward_dkv", 1),
                        ("flash_backward_dq", 2)):
            reports[kern].setdefault("moe_train_launches",
                                     drained["launches"][i]
                                     + done2[-1]["launches"][i])
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _moe_chunk_bound_ms(model, cfg, fill: int) -> float:
    """The least device ms of one ring chunk of the exact-FFN MoE model:
    every tick reads every weight but the embedding (each expert runs
    over every lane) and each lane's K and V rows up to its fill, at
    the card's memory rate."""
    emb = model.tok_embed.embedding
    weights = sum(t.numel() * t.element_size()
                  for t in model.state_dict().values()) \
        - emb.numel() * emb.element_size()
    chunk, slots = RING["chunk_tokens"], RING["slots"]
    kv_row = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2
    kv = sum(slots * kv_row * (fill + t) for t in range(chunk))
    return (chunk * weights + kv) / HBM_BYTES_PER_S * 1e3


def phase_moe_serving(paged: dict, qmm: dict, qmm_b: dict) -> None:
    """Phase 3r: 7b-moe cut to ``CUT_LAYERS`` on 3b's server, bf16 then int8
    weights; see the module docstring."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import quant as Q
    from paddle_operator_tpu_torch.infer import serve as S
    from paddle_operator_tpu_torch.models.llama import CONFIGS, make_model

    card = card_line()
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, cfg = make_model("7b-moe", device="cuda", seed=0,
                             param_dtype=CONFIGS["7b-moe"].dtype,
                             n_layers=CUT_LAYERS)
    params.requires_grad_(False)
    torch.cuda.synchronize()
    log(f"moe serving: allocated {before} bytes before the init; 7b-moe "
        f"init on the card {time.perf_counter() - t0:.1f}s "
        f"({cfg.num_params() / 1e9:.2f}B params, "
        f"{cfg.active_params() / 1e9:.2f}B active, {cfg.dtype}, "
        f"{cfg.n_layers} layers, {cfg.n_experts} experts, "
        f"{Q.param_bytes(params)} bytes); {card}")
    rng = np.random.default_rng(5)
    fill = 520
    prompts = [rng.integers(0, cfg.vocab_size, fill).tolist()
               for _ in range(RING["slots"])]
    readings = {}
    for mode in ("none", "int8"):
        if mode == "int8":
            t0 = time.perf_counter()
            got = S.quantize_from_env(params, cfg,
                                      {"SERVE_WEIGHT_QUANT": "int8"})
            torch.cuda.synchronize()
            log(f"moe serving: SERVE_WEIGHT_QUANT=int8 -> {got} in place in "
                f"{time.perf_counter() - t0:.1f}s, paramBytes "
                f"{Q.param_bytes(params)} (expected "
                f"{expected_param_bytes(cfg, False)}), allocated "
                f"{torch.cuda.memory_allocated()}")
        wquant = (None if mode == "none" else
                  {"mode": mode, "lm_head": False,
                   "param_bytes": expected_param_bytes(cfg, False)})
        report = {}
        outputs = phase_ring_main_path(report, params, cfg, wquant=wquant)
        gc.collect()
        torch.cuda.empty_cache()
        ms = _chunk_ms_turns({mode: (params, cfg, None)}, [mode] * 2,
                             prompts, dispatches=3)[mode]
        gc.collect()
        torch.cuda.empty_cache()
        bound = _moe_chunk_bound_ms(params, cfg, fill)
        ring = dict(report["ring"], paged_launches=report["launches"],
                    device_ms_per_chunk=ms, bound_ms_per_chunk=bound,
                    bound_fill=fill, param_bytes=Q.param_bytes(params))
        readings[mode] = ring
        for (kind, i), out in outputs.items():
            if len(out) <= 0 or min(out) < 0 or max(out) >= cfg.vocab_size:
                raise AssertionError(f"3r {mode}: {kind} {i} out of range")
        log(f"moe serving {mode} weights (one burst, not a benchmark): "
            f"{ring['wall_ms_per_chunk']:.1f} ms wall a chunk, device "
            f"{[round(x, 3) for x in ms]} ms a chunk (fill {fill}, a "
            f"graph) against the {bound:.2f} ms bound; TTFT p50 "
            f"{ring['ttft_p50_ms']:.1f} ms, p95 {ring['ttft_p95_ms']:.1f}; "
            f"{ring['burst_new_tok_s']:.1f} new tok/s; paged kernel "
            f"launches {report['launches']}; {card}")
    readings["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    readings["allocated_before"] = before
    log(f"moe serving: peak allocated "
        f"{readings['peak_allocated_gb']:.2f} GB; {card}")
    paged["moe"] = readings
    del params
    gc.collect()
    torch.cuda.empty_cache()


def phase_moe_equalities() -> None:
    """Phase 4o: the MoE serving paths held to each other and to the
    training forward at f32; see the module docstring."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.infer import quant as Q
    from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
    from paddle_operator_tpu_torch.models.llama import Llama, make_model
    from paddle_operator_tpu_torch.ops import decode_attention as DA
    from paddle_operator_tpu_torch.ops import quant_matmul as QM

    n_new, max_len, bs = 12, 512, 16
    for preset in ("7b-moe", "7b-moe2"):
        params, cfg = make_model(preset, device="cuda", seed=6, n_layers=2,
                                 dtype=torch.float32,
                                 moe_capacity_factor=8.0)
        params.requires_grad_(False)
        rng = np.random.default_rng(6)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in (40, 129, 64)]
        # a prefix hit: the 129-token prompt's 8 full blocks + 5 tokens
        prompts.append(prompts[1][:128]
                       + rng.integers(0, cfg.vocab_size, 5).tolist())
        res = {}
        with torch.inference_mode():
            toks = torch.tensor([prompts[1][:64], prompts[2][:64]],
                                dtype=torch.int32, device="cuda")
            train, _ = params(toks)
            cache = D.init_cache(cfg, 2, 128)
            logits, cache = D._forward(cfg, params, toks[:, :-1], cache)
            step, _ = D.decode_step(params, cfg, toks[:, -1], cache)
            res["prefill_vs_train"] = float(
                (logits - train[:, :-1]).abs().max())
            res["decode_vs_train"] = float(
                (step - train[:, -1]).abs().max())
            want = [D.generate(params, cfg, torch.tensor(
                [p], dtype=torch.int32, device="cuda"),
                max_new_tokens=n_new, max_len=max_len)[0].tolist()
                for p in prompts]
        if not (torch.allclose(logits, train[:, :-1], rtol=1e-4, atol=1e-4)
                and torch.allclose(step, train[:, -1], rtol=2e-4,
                                   atol=2e-4)):
            raise AssertionError(f"4o {preset}: the prefill or decode "
                                 f"logits differ from the training "
                                 f"forward's: {res}")

        def serve(model, c, what, route=None, **kw):
            with (route() if route else contextlib.nullcontext()):
                _zero_launches()
                ring = ContinuousBatcher(model, c, slots=4, max_len=max_len,
                                         chunk_tokens=8, paged=True,
                                         block_size=bs, **kw)
                try:
                    first = [h.result(timeout=600) for h in [
                        ring.submit(p, max_new_tokens=n_new)
                        for p in prompts[:3]]]
                    out = first + [ring.submit(
                        prompts[3], max_new_tokens=n_new).result(
                        timeout=600)]
                    hit = ring.pool.stats["prefix_hit_tokens"]
                    ring.pool.check_invariant()
                finally:
                    ring.close()
            seen = {"#1": DA.decode_attention.launches,
                    "#2": DA.paged_decode_attention.launches,
                    "#3": DA.paged_decode_attention.quant_launches,
                    "A": QM.quant_matmul.launches,
                    "B": QM.quant_gemm.launches, "hit": hit}
            res[what] = seen
            return out

        got = serve(params, cfg, "paged")
        if got != want or not res["paged"]["#2"] or res["paged"]["#1"] \
                or res["paged"]["hit"] < 128:
            raise AssertionError(f"4o {preset}: the paged ring != generate, "
                                 f"or not through kernel #2 alone, or no "
                                 f"prefix hit: {res['paged']}")
        dcfg = cfg.draft()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        draft = Llama(dcfg, "cuda").init_weights(gen)
        draft.requires_grad_(False)
        got = serve(params, cfg, "spec", draft_params=draft, draft_cfg=dcfg,
                    spec_k=4)
        if got != want or not res["spec"]["#1"]:
            raise AssertionError(f"4o {preset}: the speculative ring (K 4, "
                                 f"an MoE draft of {dcfg.n_experts} experts)"
                                 f" != generate: {res['spec']}")
        del draft
        kcfg = dataclasses.replace(cfg, decode_attn="kernel")
        pcfg = dataclasses.replace(cfg, decode_attn="plain")
        got_k = serve(params, kcfg, "int8_pool_kernel", kv_quant="int8")
        got_p = serve(params, pcfg, "int8_pool_plain", kv_quant="int8")
        if got_k != got_p or not res["int8_pool_kernel"]["#3"] \
                or res["int8_pool_plain"]["#3"]:
            raise AssertionError(f"4o {preset}: the int8 pool through kernel "
                                 f"#3 != its plain version: "
                                 f"{res['int8_pool_kernel']}, "
                                 f"{res['int8_pool_plain']}")
        qmodel = Llama(cfg, "cuda")
        qmodel.load_state_dict(params.state_dict())
        qmodel.requires_grad_(False)
        del params
        Q.quantize_params(qmodel, cfg, mode="int8", skip=Q.SERVING_SKIP)
        got_k = serve(qmodel, cfg, "wq_kernels")
        got_p = serve(qmodel, cfg, "wq_formula", route=_plain_route)
        if got_k != got_p or not res["wq_kernels"]["A"] \
                or not res["wq_kernels"]["B"] or res["wq_formula"]["A"] \
                or res["wq_formula"]["B"]:
            raise AssertionError(f"4o {preset}: the int8-weight ring through "
                                 f"kernels A/B != the formula: "
                                 f"{res['wq_kernels']}, {res['wq_formula']}")
        log(f"4o {preset} (7b width, 2 layers, f32, capacity factor 8): "
            f"prefill vs training forward {res['prefill_vs_train']:.3e} "
            f"(1e-4), decode step {res['decode_vs_train']:.3e} (2e-4); paged "
            f"ring == generate ({res['paged']}); speculative K 4 == generate "
            f"({res['spec']}); int8 pool kernel == plain "
            f"({res['int8_pool_kernel']}, {res['int8_pool_plain']}); int8 "
            f"weights kernels == formula ({res['wq_kernels']}, "
            f"{res['wq_formula']})")
        del qmodel
        gc.collect()
        torch.cuda.empty_cache()


# phase 3s's child: the user's training program in a pod of a one-worker
# mesh job, started by the launcher (``python -m
# paddle_operator_tpu_torch.launch.launcher -- python <this file>
# <json>``).  It prints one JSON line an event.
MESH_TRAIN_CHILD = r'''
import itertools
import json
import sys
import time

import torch
import torch.distributed as dist

from paddle_operator_tpu_torch.launch import launcher
from paddle_operator_tpu_torch.models.llama import make_model
from paddle_operator_tpu_torch.ops import flash_attention as FA
from paddle_operator_tpu_torch.parallel.sharding import to_local
from paddle_operator_tpu_torch.train import trainer as T
from paddle_operator_tpu_torch.train.data import (DevicePrefetcher,
                                                  deterministic_lm_batches)
from paddle_operator_tpu_torch.utils.observability import StepTimer

FLASH = (FA.flash_forward, FA.flash_backward_dkv, FA.flash_backward_dq)


def emit(**kw):
    print(json.dumps(kw), flush=True)


def synced():
    torch.cuda.synchronize()
    return time.perf_counter()


def zero():
    for fn in FLASH:
        fn.launches = 0


def counts():
    return [fn.launches for fn in FLASH]


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    a = json.loads(sys.argv[1])
    t0 = time.perf_counter()
    env = launcher.initialize()            # one worker: no group here
    mesh = launcher.job_mesh(env)          # a world-1 nccl group
    emit(event="mesh", names=list(mesh.mesh_dim_names),
         shape=list(mesh.mesh.shape), backend=dist.get_backend(),
         world=dist.get_world_size(), ready_s=time.perf_counter() - t0)
    b, s, steps = a["batch"], a["seq"], a["steps"]
    host = list(itertools.islice(deterministic_lm_batches(
        b, s + 1, 32000, seed=0), steps + a["timed_steps"]))
    opt = T.make_optimizer(a["lr"], warmup_steps=1, decay_steps=1000)

    # phase 3c's step without a mesh, from the same init on the same data
    model, cfg = make_model("7b", device="cuda", seed=0,
                            n_layers=a["layers"])
    state = T.create_state(model, opt)
    zero()
    state, plain = T.fit(state, T.make_train_step(opt), DevicePrefetcher(
        iter(host[:steps]), device="cuda"), steps=steps)
    plain_launches = counts()
    want = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    del state, model
    torch.cuda.empty_cache()

    # the mesh job's main path: state_shardings / create_state on the
    # job mesh, make_step_for_mesh, fit over DevicePrefetcher(mesh=...)
    model, cfg = make_model("7b", device="cuda", seed=0,
                            n_layers=a["layers"])
    plan = T.state_shardings(model, opt, mesh)
    state = T.create_state(model, opt, mesh=mesh)
    step = T.make_step_for_mesh(opt, mesh)
    replicated = all(p.is_replicate() for pl in plan.params.values()
                     for p in pl)
    torch.cuda.reset_peak_memory_stats()
    zero()
    state, got = T.fit(state, step, DevicePrefetcher(iter(host[:steps]),
                                                     mesh=mesh), steps=steps)
    launches = counts()
    bit_equal = all(torch.equal(to_local(p).detach(), want[n])
                    for n, p in state.model.named_parameters())
    param_diff = max(float((to_local(p).detach().float()
                            - want[n].float()).abs().max())
                     for n, p in state.model.named_parameters())
    del want
    torch.cuda.empty_cache()
    timer = StepTimer(b * s, cfg.flops_per_token(), a["peak"],
                      window=a["timed_steps"], clock=synced)
    zero()
    state, timed = T.fit(state, step, DevicePrefetcher(
        iter(host[steps:]), mesh=mesh), steps=a["timed_steps"], timer=timer)
    emit(event="done", plain=plain, mesh=got, bit_equal=bit_equal,
         max_param_diff=param_diff, replicated=replicated,
         launches=launches, plain_launches=plain_launches,
         timed_launches=counts(), timed=timed,
         step_ms=[t * 1e3 for t in timer.times],
         flops_per_token=cfg.flops_per_token(), params=cfg.num_params(),
         peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
'''

# phase 3s (b): one rank of the two-rank meshes on the one card over
# gloo.  It first tries each collective and exchange the mesh steps use
# on CUDA tensors and prints the answers (if gloo refuses one it stops
# there and the phase fails); then it trains on each mesh of ``meshes``
# in turn, each rank times its steps and counts its flash launches and
# the bytes its cp/pp exchanges sent, and every rank holds the
# parameters it is the first holder of (gathered over its mesh) to the
# reference run's (``ref``), one JSON line a mesh.
MESH_PAIR_CHILD = r"""
import faulthandler
import itertools
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from paddle_operator_tpu_torch.api.types import MeshSpec
from paddle_operator_tpu_torch.models.llama import make_model
from paddle_operator_tpu_torch.ops import adam8bit as A8
from paddle_operator_tpu_torch.ops import flash_attention as FA
from paddle_operator_tpu_torch.parallel import collectives as C
from paddle_operator_tpu_torch.parallel.mesh import (coordinates,
                                                     make_mesh,
                                                     mesh_axis_sizes)
from paddle_operator_tpu_torch.parallel.sharding import (local_slices,
                                                         shard_batch)
from paddle_operator_tpu_torch.train import trainer as T
from paddle_operator_tpu_torch.train.checkpoint import CheckpointManager
from paddle_operator_tpu_torch.train.data import deterministic_lm_batches

faulthandler.enable()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
a, rank = json.loads(sys.argv[1]), int(sys.argv[2])
torch.cuda.set_device(0)


def stage(what):
    print(f"rank {rank}: {what}", file=sys.stderr, flush=True)


dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{a['port']}",
                        world_size=2, rank=rank)
x = torch.full((4,), float(rank + 1), device="cuda")
other = 1 - rank


def uneven():
    # the cp/pp exchange: bytes to the other rank only, none to itself
    got = C.exchange({other: x}, {other: (4,)}, dist.group.WORLD, like=x)
    assert float(got[other][0]) == float(other + 1)


def one_way():
    # a pipeline hop: rank 0 sends, rank 1 receives, nothing back
    got = C.exchange({1: x} if rank == 0 else {},
                     {0: (4,)} if rank == 1 else {}, dist.group.WORLD,
                     like=x)
    assert rank == 0 or float(got[0][0]) == 1.0


def even():
    out = torch.empty(4, device="cuda")
    dist.all_to_all_single(out, x)
    assert float(out[2 * other]) == float(other + 1)


probes = {
    "all_reduce": lambda: dist.all_reduce(x.clone()),
    "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
        torch.empty(8, device="cuda"), x),
    "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
        torch.empty(2, device="cuda"), x),
    "all_to_all_single (split sizes, the cp/pp exchange)": uneven,
    "all_to_all_single (one way, a pipeline hop)": one_way,
    "all_to_all_single (even, Ulysses)": even,
}
probe = {}
for name, fn in probes.items():
    try:
        fn()
        torch.cuda.synchronize()
        probe[name] = "ok"
    except Exception as err:
        probe[name] = f"{type(err).__name__}: {str(err)[:200]}"
print(json.dumps({"probe": probe, "ready_s": time.time() - a["t_launch"]}),
      flush=True)
if set(probe.values()) != {"ok"}:
    raise SystemExit(0)
refs = {}


def wait_for(key):
    # a file the parent writes (by rename)
    deadline = time.time() + 900
    while not os.path.exists(a[key]):
        if time.time() > deadline:
            raise SystemExit(f"no {key} within 900 s")
        time.sleep(0.1)


def reference(key):
    # the run without a mesh that a mesh is held to, which the parent
    # writes while the first meshes train; read as a memory map, each
    # tensor moved to the card when compared
    if key not in refs:
        wait_for(key)
        refs[key] = torch.load(a[key], weights_only=True, mmap=True)
    return refs[key]


# the meshes go once (a) is done and the card is (b)'s
wait_for("go")


# calls of the 8-bit update's plain version (none may run on the card)
plain_calls = [0]
_plain_update = A8.adam8bit_update_reference


def _counted_plain(*args, **kwargs):
    plain_calls[0] += 1
    return _plain_update(*args, **kwargs)


A8.adam8bit_update_reference = _counted_plain


def in_slab(state):
    # every moment tensor a view of the offload's page-locked host slab
    off = state.opt_state.offload
    lo = off._slab.data_ptr()
    hi = lo + off._slab.numel()
    return off._registered and all(
        t.device.type == "cpu" and lo <= t.data_ptr() < hi
        for ts in state.opt_state.tensors().values() for t in ts.values())


def checksum(tensors):
    # every element's bit pattern times its position's weight, summed
    # (mod 2**64) on the card: equal tensors, equal sums, and a block
    # moved or swapped changes them
    total = 0
    for t in tensors:
        t = t.detach().to("cuda").contiguous().view(-1)
        bits = t.view(torch.int32 if t.element_size() == 4
                      else torch.int8).to(torch.int64)
        weight = torch.arange(bits.numel(), device="cuda") % 65521 + 1
        total += int((bits * weight).sum())
    return total


def first_holder(pm, spec, coords):
    # no rank before this one on the axes of `pm` that do not cut `spec`
    cut = {x for e in spec if e for x in ((e,) if isinstance(e, str) else e)}
    return all(coords[n] == 0 for n in pm.mesh_dim_names if n not in cut)


def holds_first(p):
    # no rank before this one on an axis that replicates parameter `p`
    return not any(c and pl.is_replicate() for c, pl in
                   zip(coordinates(p.device_mesh).values(), p.placements))


def spans(region):
    return [[r.start, r.stop] for r in region]


def regions(state, fields):
    # the regions this rank is the first holder of, of each parameter
    # ("params") and of each int8 moment field in `fields`:
    # key -> (spans, tensor on the host)
    o, out = state.opt_state, {}
    for n, p in state.model.named_parameters():
        pm = p.device_mesh
        if "params" in fields and holds_first(p):
            out[n] = (spans(local_slices(p.shape, pm, p.placements)),
                      p.to_local().detach().cpu())
        moments = [f for f in fields if f != "params"]
        if moments and first_holder(pm, o.layout[n].spec, coordinates(pm)):
            out.update((f"{f}:{n}", (spans(o.layout[n].field(f)[2]),
                                     o.tensors()[f][n].cpu()))
                       for f in moments)
    return out


def sums(state):
    # each region this rank holds, of every parameter and int8 moment
    # field: key -> (spans, checksum)
    o, out = state.opt_state, {}
    for n, p in state.model.named_parameters():
        out[n] = (spans(local_slices(p.shape, p.device_mesh, p.placements)),
                  checksum([p.to_local()]))
        for f, ts in o.tensors().items():
            out[f"{f}:{n}"] = (spans(o.layout[n].field(f)[2]),
                               checksum([ts[n]]))
    return out


def held(state, ref, flipped, int8):
    # the regions this rank is the first holder of against the
    # reference's after (b)'s steps (the parent sums the counts): int8,
    # the codes (more than one off, off); the parameters, off by more
    # than 1e-5 outside `flipped` (the elements under a code that came
    # out other than the reference's at some step, held only to 2 lr a
    # step)
    t_check = time.perf_counter()
    res, o = {}, state.opt_state
    if int8:
        far = diff_codes = codes = 0
        for f in ("mu_codes", "nu_codes"):
            for n, t in o.tensors()[f].items():
                lay = o.layout[n]
                pm = state.model.get_parameter(n).device_mesh
                if not first_holder(pm, lay.spec, coordinates(pm)):
                    continue
                want = ref[f"{f}:{n}@{a['steps']}"][lay.region]
                d = (t.to("cuda").int() - want.to("cuda").int()).abs()
                far += int((d > 1).sum())
                diff_codes += int((d > 0).sum())
                codes += d.numel()
        res.update(codes_far=far, codes_off=diff_codes, codes_total=codes)
    diff, off, total, under = 0.0, 0, 0, 0
    for n, p in state.model.named_parameters():
        if not holds_first(p):
            continue
        region = local_slices(p.shape, p.device_mesh, p.placements)
        d = (p.to_local() - ref[n][region].to("cuda")).abs()
        diff = max(diff, float(d.max()))
        total += d.numel()
        if n in flipped:
            under += int(flipped[n].sum())
            d = d[~flipped[n]]
        off += int((d > 1e-5).sum())
    res.update(max_param_diff=diff, params_off=off, params_total=total,
               under_flips=under, check_s=time.perf_counter() - t_check)
    return res


def codes_now(state):
    # a copy of this rank's codes, field -> name -> tensor on the card
    return {f: {n: t.to("cuda", copy=True) for n, t in
                state.opt_state.tensors()[f].items()}
            for f in ("mu_codes", "nu_codes")}


def mark_flips(state, codes, ref, step_no, flipped):
    # the elements of this rank's parameter regions under a code in
    # `codes` (codes_now after step `step_no`) other than the reference's
    # after that step (a rank whose blocks are not its columns' gathers
    # the rows' codes first: every rank calls the same gathers in the
    # same order)
    from paddle_operator_tpu_torch.train.opt8bit import _from_blocks

    o = state.opt_state
    for n, p in state.model.named_parameters():
        lay, local = o.layout[n], p.to_local()
        lead = lay.region[:-2]

        def on_params(blocks):
            if lay.case == "aligned":
                return _from_blocks(blocks.float(), local.shape,
                                    torch.float32) > 0
            return _from_blocks(blocks.float(),
                                (*local.shape[:-1], p.shape[-1]),
                                torch.float32)[..., lay.columns] > 0

        for f in ("mu_codes", "nu_codes"):
            t = codes[f][n]
            if lay.case == "unaligned":
                t = C.gather_along(t, -2, lay.groups)
            reg = lay.region if lay.case == "aligned" else lead
            want = ref[f"{f}:{n}@{step_no}"][reg].to("cuda")
            hit = on_params(t != want)
            flipped[n] = flipped.get(n, hit) | hit


flash = (FA.flash_forward, FA.flash_backward_dkv, FA.flash_backward_dq)
for spec in a["meshes"]:
    axes, over, opts, run = (spec["axes"], spec["model"], spec["step"],
                             spec["run"])
    t_setup = time.perf_counter()
    mesh = make_mesh(MeshSpec(**axes), device="cuda")
    model, cfg = make_model(run.get("preset", a["preset"]), device="cuda",
                            seed=0, n_layers=run.get("layers", a["layers"]),
                            dtype=torch.float32, **over)
    opt = T.make_optimizer(a["lr"], warmup_steps=1, decay_steps=1000,
                           moments=run.get("moments", "f32"))
    state = T.create_state(model, opt, mesh=mesh,
                           offload_opt_state=run.get("offload", False))
    step = T.make_step_for_mesh(opt, mesh, **opts)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_setup
    stage(f"{spec['tag']}: state")
    for fn in flash + (A8.adam8bit_update,):
        fn.launches = 0
    plain_calls[0] = 0
    for k in C.EXCHANGE:
        C.EXCHANGE[k] = 0
    int8, twin = run.get("moments") == "int8", run.get("same_as")
    steps = run.get("steps", a["steps"])
    out = {"tag": spec["tag"], "rank": rank, "setup_s": setup_s}
    metrics, step_ms, dropped, host, bits, codes, flipped, cont = \
        [], [], [], [], [], [], {}, {}
    for b in itertools.islice(deterministic_lm_batches(
            a["batch"], a["seq"] + 1, cfg.vocab_size, seed=1), steps):
        batch = shard_batch(b, mesh, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        done = len(metrics)
        # the MoE layers' assignments past the capacity this step
        dropped.append(sum(int(l.moe.dropped) for l in state.model.layers
                           if hasattr(l, "moe")))
        if run.get("offload"):
            host.append(in_slab(state))
        if int8:
            o = state.opt_state
            bits.append(checksum(
                [p.to_local() for p in state.model.parameters()]
                + [t for ts in o.tensors().values() for t in ts.values()]))
            if twin is None and done <= a["steps"]:
                codes.append(codes_now(state))
        if done == a["steps"] and twin is None:
            # held to the reference after (b)'s steps, read only now (a
            # mesh trains while the parent still computes it; a twin is
            # held to its run bit for bit by the parent)
            ref = reference(run.get("ref", "ref"))
            for i, c in enumerate(codes):
                mark_flips(state, c, ref, i + 1, flipped)
            codes = []
            out.update(held(state, ref, flipped, int8))
        if done == a["steps"] and run.get("save"):
            # saved for the parent's resume on one card (dp2: the elastic
            # resume; tp2_int8: the int8 restore, with this rank's
            # flipped elements so far and a checksum of each region it
            # holds, to hold the restore to bit for bit)
            ckpt = CheckpointManager(a[run["save"]])
            ckpt.save(state.step, state, force=True)
            ckpt.wait()
            if int8:
                torch.save({"flips": {
                    n: (spans(local_slices(p.shape, p.device_mesh,
                                           p.placements)), flipped[n].cpu())
                    for n, p in state.model.named_parameters()},
                    "sums": sums(state)},
                    os.path.join(a[run["save"]], f"record-{rank}.pt"))
            out["saved"] = ckpt.all_steps()
        if done > a["steps"]:
            # the steps after the save, which the parent's restore
            # resumes: the codes after each, the parameters after the last
            cont[f"codes@{done}"] = regions(state, ("mu_codes", "nu_codes"))
            if done == steps:
                cont[f"params@{done}"] = regions(state, ("params",))
        stage(f"{spec['tag']}: step {done}")
    if cont:
        cont["metrics"] = metrics
        path = os.path.join(a[run["save"]], f"cont-{rank}.pt")
        torch.save(cont, path + ".tmp")
        os.replace(path + ".tmp", path)
    sizes = mesh_axis_sizes(mesh)
    out.update(metrics=metrics, step_ms=step_ms, dropped=dropped,
               launches=[fn.launches for fn in flash],
               exchange_bytes_per_step={k: v / steps
                                        for k, v in C.EXCHANGE.items()},
               local_heads=cfg.n_heads // sizes["tp"],
               layers_here=len(state.model.stage_layers().layers),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    if int8:
        out.update(adam8bit_launches=A8.adam8bit_update.launches,
                   plain_updates=plain_calls[0], in_slab=host,
                   cases=sorted({l.case for l in
                                 state.opt_state.layout.values()}),
                   checksums=bits)
    print(json.dumps(out), flush=True)
    del state, model, step, opt
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
dist.destroy_process_group()
"""

# phase 3s (b)'s expert-parallel run: 7b-moe at full width (dim 4096, 32
# heads, 8 experts of ffn 11008) cut to 1 layer, f32, capacity factor 0.5
# (every step drops assignments), MESH_PAIR's batch; each ep rank runs 4
# experts on all 4 x 512 tokens
MESH_PAIR_MOE = dict(preset="7b-moe", layers=1, capacity_factor=0.5)
# the resumes on one card: the pair's dp2 step 3 through ft/elastic.py
# elastic_resume, then `steps` more steps held to the reference run's
# steps 4 and 5; tp2_int8's step 3 the same way, held to tp2_int8's own
# `steps` more
MESH_PAIR_ELASTIC = dict(steps=2)
# 3s (b)'s meshes, in turn on the one pair of processes: (tag, mesh axes,
# model overrides, step options, run options: another preset or depth,
# the reference it is held to, a save); the flash launches a rank makes
# over the run's steps: full remat (forward twice, dK/dV and dQ once a
# layer a step) through kernels #4-#6 everywhere but ring attention
# (plain ops: none); a pp stage's 1 layer over 4 microbatches, and under
# 1F1B stage 0 also forwards each microbatch once without a graph before
# its backward slot recomputes it (the last stage keeps the graph of its
# round).  dp2 saves its last step for the parent's elastic resume on one
# card (``MESH_PAIR_ELASTIC``); ep2_moe is ``MESH_PAIR_MOE`` over ep=2;
# fsdp2 and tp2 take int8 moments (``MESH_PAIR_INT8``), held to the int8
# run without a mesh (their f32 moments, sharded over fsdp and tp, are
# held on the CPU: tests/test_torch_sharded_train.py; dp2, cp2 and pp2
# keep the f32 update on a mesh here); fsdp2 once more with the moments
# offloaded for 2 steps (its twin, held to it bit for bit after each);
# tp2_int8 saves its step 3, which the parent restores on one card, and
# goes on to step 5, which the restore's 2 steps are held to
MESH_PAIR_MESHES = (
    ("fsdp2_int8", {"fsdp": 2}, {}, {},
     {"moments": "int8", "ref": "ref_int8"}),
    ("fsdp2_int8_offload", {"fsdp": 2}, {}, {},
     {"moments": "int8", "ref": "ref_int8", "offload": True,
      "same_as": "fsdp2_int8", "steps": 2}),
    ("tp2_int8", {"tp": 2}, {}, {},
     {"moments": "int8", "ref": "ref_int8", "save": "int8_ckpt",
      "steps": MESH_PAIR["steps"] + MESH_PAIR_ELASTIC["steps"]}),
    ("cp2_ring", {"cp": 2}, {"cp_impl": "ring"}, {}, {}),
    ("cp2_ulysses", {"cp": 2}, {"cp_impl": "ulysses"}, {}, {}),
    ("pp2_gpipe", {"pp": 2}, {}, {"schedule": "gpipe",
                                  "num_microbatches": 4}, {}),
    ("pp2_1f1b", {"pp": 2}, {}, {"schedule": "1f1b",
                                 "num_microbatches": 4}, {}),
    ("dp2", {"dp": 2}, {}, {}, {"save": "elastic_ckpt"}),
    ("ep2_moe", {"ep": 2},
     {"moe_capacity_factor": MESH_PAIR_MOE["capacity_factor"]}, {},
     {"preset": MESH_PAIR_MOE["preset"], "layers": MESH_PAIR_MOE["layers"],
      "ref": "ref_moe"}),
)


def mesh_pair_launches(tag: str, rank: int, layers: int, steps: int,
                       microbatches: int = 4) -> list:
    """The flash launches (#4, #5, #6) rank ``rank`` makes over
    ``steps`` steps on the 3s (b) mesh ``tag`` (``MESH_PAIR_MESHES``)."""
    if tag == "cp2_ring":
        return [0, 0, 0]
    if tag.startswith("pp2"):
        per = layers // 2 * microbatches * steps
        fwd = 3 if tag == "pp2_1f1b" and rank == 0 else 2
        return [fwd * per, per, per]
    return [2 * layers * steps, layers * steps, layers * steps]


def _mesh_pair_start() -> dict:
    """Phase 3s (b)'s two processes, started before (a) so that their
    start (imports, CUDA, gloo, the probe) overlaps it: they train once
    :func:`_mesh_pair_runs` writes ``go`` and read each reference it
    writes when they check a mesh."""
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_pair_")
    meshes = [{"tag": t, "axes": ax, "model": over, "step": opts,
               "run": run}
              for t, ax, over, opts, run in MESH_PAIR_MESHES]
    args = dict(MESH_PAIR, meshes=meshes, port=_free_port(),
                go=os.path.join(root, "go"),
                ref=os.path.join(root, "ref.pt"),
                ref_moe=os.path.join(root, "ref_moe.pt"),
                ref_int8=os.path.join(root, "ref_int8.pt"),
                elastic_ckpt=os.path.join(root, "elastic"),
                int8_ckpt=os.path.join(root, "int8"),
                t_launch=time.time())
    script = os.path.join(root, "pair.py")
    Path(script).write_text(MESH_PAIR_CHILD)
    env = dict(os.environ,
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, script, json.dumps(args), str(r)],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    return {"root": root, "args": args, "procs": procs,
            "t0": time.perf_counter()}


def _mesh_pair_stop(pair: dict) -> None:
    """Stops (b)'s processes if they still run and removes their
    directory."""
    import shutil

    for p in pair["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()
    shutil.rmtree(pair["root"], ignore_errors=True)


def _pair_reference(preset: str, layers: int, steps: int, keep: int,
                    moments: str = "f32", **over) -> tuple:
    """The run without a mesh that (b)'s meshes are held to: ``preset`` at
    ``layers`` layers, f32, with ``moments``, on ``MESH_PAIR``'s batches
    from seed 0, this process.  Returns (each step's metrics, the
    parameters after ``keep`` steps and after ``steps`` steps on the
    host — int8: with each moment's codes as ``"<field>:<name>"`` —, the
    parameter count, the seconds, and int8: the codes after every
    step)."""
    import itertools

    import torch

    from paddle_operator_tpu_torch.models.llama import make_model
    from paddle_operator_tpu_torch.train import trainer as T
    from paddle_operator_tpu_torch.train.data import deterministic_lm_batches

    a = MESH_PAIR
    t0 = time.perf_counter()
    model, cfg = make_model(preset, device="cuda", seed=0, n_layers=layers,
                            dtype=torch.float32, **over)
    opt = T.make_optimizer(a["lr"], warmup_steps=1, decay_steps=1000,
                           moments=moments)
    state, step = T.create_state(model, opt), T.make_train_step(opt)

    def host(state):
        out = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
        if moments == "int8":
            for f in ("mu_codes", "nu_codes"):
                out.update((f"{f}:{n}", t.cpu())
                           for n, t in state.opt_state.tensors()[f].items())
        return out

    want, trail = [], []
    for b in itertools.islice(deterministic_lm_batches(
            a["batch"], a["seq"] + 1, cfg.vocab_size, seed=1), steps):
        state, m = step(state, {"tokens": torch.as_tensor(b["tokens"],
                                                          device="cuda")})
        want.append({k: float(v) for k, v in m.items()})
        if len(want) == keep:
            kept = host(state)
        if moments == "int8":
            trail.append({k: v for k, v in host(state).items()
                          if ":" in k})
    final = kept if keep == steps else host(state)
    del state, model
    torch.cuda.empty_cache()
    return (want, kept, final, cfg.num_params(), time.perf_counter() - t0,
            trail)


def _publish(params: dict, path: str) -> None:
    """``params`` written to ``path`` by rename (a rank waits for it)."""
    import torch

    torch.save(params, path + ".tmp")
    os.replace(path + ".tmp", path)


def _pair_metrics_close(metrics: list, want: list,
                        grad_rtol: float = 1e-4) -> bool:
    """A run's steps' losses and aux losses within rtol 1e-5 of
    ``want``'s, its grad norms within ``grad_rtol``."""
    import numpy as np

    return (len(metrics) == len(want)
            and all(np.isclose(m[k], w[k], rtol=1e-5, atol=0)
                    for m, w in zip(metrics, want)
                    for k in ("loss", "aux_loss") if k in w)
            and all(np.isclose(m["grad_norm"], w["grad_norm"],
                               rtol=grad_rtol, atol=0)
                    for m, w in zip(metrics, want)))


def _pair_gate(metrics: list, want: list, diff: float, off: int,
               total: int, n_params: int, steps: int,
               grad_rtol: float = 1e-4) -> bool:
    """(b)'s gate for a run's steps against the run without a mesh's, the
    parameters after ``steps`` steps from the same init: losses and aux
    losses rtol 1e-5, grad norms rtol ``grad_rtol``, every
    parameter compared once, at most one in 10,000 off by more than 1e-5
    and none by more than 2 lr a step.  Adam moves an element by about lr
    a step whatever its gradient's size: an element whose gradient is at
    the f32 noise of the two summation orders can step either way, so a
    few elements may differ by up to 2 lr a step; a wrong shard would
    move whole blocks."""
    return (off <= 1e-4 * total and total == n_params
            and diff <= 2 * MESH_PAIR["lr"] * steps
            and _pair_metrics_close(metrics, want, grad_rtol))


def _checksum(tensors) -> int:
    """Every element's bit pattern times its position's weight, summed
    (mod 2**64) on the card, as 3s (b)'s ranks sum the regions they
    save: equal tensors, equal sums; a block moved or swapped changes
    them."""
    import torch

    total = 0
    for t in tensors:
        t = t.detach().to("cuda").contiguous().view(-1)
        bits = t.view(torch.int32 if t.element_size() == 4
                      else torch.int8).to(torch.int64)
        weight = torch.arange(bits.numel(), device="cuda") % 65521 + 1
        total += int((bits * weight).sum())
    return total


def _pair_resume(ckpt_dir: str, moments: str = "f32", seen=None) -> tuple:
    """The pair's saved step 3 restored on one card through
    ``ft/elastic.py`` ``elastic_resume`` (a state built without a mesh,
    its moments reassembled from the shard files), then
    ``MESH_PAIR_ELASTIC["steps"]`` steps from the plan's data offset;
    ``seen(state, i)`` reads the state after the restore (``i`` 0) and
    after each step.  Returns (resumed, plan, the restore's seconds,
    each step's metrics, step ms, the flash launches)."""
    import itertools

    import torch

    from paddle_operator_tpu_torch.ft.elastic import elastic_resume
    from paddle_operator_tpu_torch.ft.goodput import GoodputTracker
    from paddle_operator_tpu_torch.models.llama import make_model
    from paddle_operator_tpu_torch.ops import flash_attention as FA
    from paddle_operator_tpu_torch.train import trainer as T
    from paddle_operator_tpu_torch.train.checkpoint import CheckpointManager
    from paddle_operator_tpu_torch.train.data import deterministic_lm_batches

    a, n = MESH_PAIR, MESH_PAIR_ELASTIC["steps"]
    opt = T.make_optimizer(a["lr"], warmup_steps=1, decay_steps=1000,
                           moments=moments)

    def init_fn():
        model, _ = make_model(a["preset"], device="cuda", seed=0,
                              n_layers=a["layers"], dtype=torch.float32)
        return T.create_state(model, opt)

    tracker = GoodputTracker()
    state, resumed, plan = elastic_resume(
        CheckpointManager(ckpt_dir), init_fn, saved_global_batch=a["batch"],
        global_batch=a["batch"], goodput=tracker)
    if seen:
        seen(state, 0)
    step = T.make_train_step(opt)
    flash = (FA.flash_forward, FA.flash_backward_dkv, FA.flash_backward_dq)
    for fn in flash:
        fn.launches = 0
    got, step_ms = [], []
    for b in itertools.islice(deterministic_lm_batches(
            a["batch"], a["seq"] + 1, state.model.cfg.vocab_size, seed=1,
            start_step=plan["data_start_step"]), n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, {"tokens": torch.as_tensor(b["tokens"],
                                                          device="cuda")})
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        got.append({k: float(v) for k, v in m.items()})
        if seen:
            seen(state, len(got))
    launches = [fn.launches for fn in flash]
    del state
    torch.cuda.empty_cache()
    return (resumed, plan, tracker.badput()["restore"], got, step_ms,
            launches)


def _pair_elastic_resume(ckpt_dir: str, want: list, final: dict,
                         n_params: int) -> dict:
    """The parent's side of (b)'s elastic run: the pair's dp2 step
    resumed on one card (:func:`_pair_resume`), held by (b)'s gate to
    the reference run's next steps."""
    import torch

    a, n = MESH_PAIR, MESH_PAIR_ELASTIC["steps"]
    held = {}

    def seen(state, i):
        if i == n:
            for name, p in state.model.named_parameters():
                d = (p.detach() - final[name].to("cuda")).abs()
                held["diff"] = max(held.get("diff", 0.0), float(d.max()))
                held["off"] = held.get("off", 0) + int((d > 1e-5).sum())
                held["total"] = held.get("total", 0) + d.numel()

    resumed, plan, restore_s, got, step_ms, launches = _pair_resume(
        ckpt_dir, seen=seen)
    diff, off, total = held["diff"], held["off"], held["total"]
    want_launches = [2 * a["layers"] * n, a["layers"] * n, a["layers"] * n]
    run = {"resumed": resumed, "plan": plan, "restore_s": restore_s,
           "losses": [m["loss"] for m in got],
           "want_losses": [w["loss"] for w in want[-n:]],
           "grad_norms": [m["grad_norm"] for m in got],
           "max_param_diff": diff, "params_off": off, "params_total": total,
           "launches": launches, "step_ms": step_ms}
    log(f"mesh train pod (b) elastic: dp2's step {plan['step']} restored on "
        f"one card in {restore_s:.2f}s (resumed {resumed}, plan "
        f"{plan}); {n} steps, losses {run['losses']} (want "
        f"{run['want_losses']}), largest |param difference| {diff:.3e}, "
        f"{off} of {total} off by more than 1e-5; flash launches "
        f"{launches} (want {want_launches}); step ms {step_ms}")
    steps_lost = a["steps"] - plan["data_start_step"]
    if not (resumed and plan["step"] == a["steps"] and steps_lost == 0
            and launches == want_launches
            and _pair_gate(got, want[-n:], diff, off, total, n_params,
                           a["steps"] + n)):
        raise AssertionError("3s (b) elastic: the resumed run differs from "
                             "the run without a mesh")
    run["steps_lost"] = steps_lost
    torch.cuda.empty_cache()
    return run


def _pair_int8_restore(ckpt_dir: str, want: list, final: dict, trail: list,
                       n_params: int) -> dict:
    """(b)'s int8 restore: tp2_int8's step 3, its codes and scales
    reassembled as whole blocks on one card, then 2 steps on
    (:func:`_pair_resume`).  Held:

    - the restored state to the mesh's at the save, bit for bit: each
      rank's checksum of every region it held of each parameter and
      each moment field (``record-<rank>.pt`` beside the checkpoint);
    - the 2 steps to the mesh's own steps 4 and 5, the run the restore
      resumes (each rank's regions, ``cont-<rank>.pt``), by (b)'s rule:
      at most one in 10,000 parameters off by more than 1e-5 outside
      the elements under a code that came out other than the mesh's
      after step 4 or 5 (tests/test_torch_opt8bit.py's rule), none by
      more than 2 lr a step;
    - losses and grad norms to the reference's steps 4-5 (rtol 1e-5),
      codes more than one off the reference's after step 5 under
      ``MESH_PAIR_INT8["codes_far"]``, kernel #8 once a tensor a step.

    Read beside it, not gated: the restore's and the mesh's step 5
    against the reference's (``final``, ``trail``: its codes after each
    step) by the same rule, a flip counted against the reference's codes
    after every step (the mesh's before the save from the records), and
    how many of the elements off there had a second moment the
    reference stored as 0 before step 4 or 5."""
    import torch

    from paddle_operator_tpu_torch.ops import adam8bit as A8
    from paddle_operator_tpu_torch.train.opt8bit import _from_blocks

    a, n = MESH_PAIR, MESH_PAIR_ELASTIC["steps"]
    k = a["steps"]
    codes_f = ("mu_codes", "nu_codes")
    records = [torch.load(path, weights_only=True) for path in
               sorted(Path(ckpt_dir).glob("record-*.pt"))]
    conts = [torch.load(path, weights_only=True, mmap=True) for path in
             sorted(Path(ckpt_dir).glob("cont-*.pt"))]
    if len(records) != 2 or len(conts) != 2:
        raise AssertionError(f"3s (b) int8 restore: {len(records)} records "
                             f"and {len(conts)} continuations, not 2 each")
    mesh_metrics = conts[0]["metrics"]

    def cut(region):
        return tuple(slice(*r) for r in region)

    def assemble(key, like):
        # the mesh's whole tensors from the ranks' regions (each element
        # held by exactly one rank)
        out, covered = {}, {}
        for c in conts:
            for name, (region, t) in c[key].items():
                w = out.setdefault(name, torch.empty(
                    like(name).shape, dtype=t.dtype, device="cuda"))
                w[cut(region)] = t.to("cuda")
                covered[name] = covered.get(name, 0) + t.numel()
        if any(covered[x] != out[x].numel() for x in out):
            raise AssertionError(f"3s (b) int8 restore: the ranks' {key} "
                                 "regions do not cover their tensors")
        return out

    def on_params(blocks, p):
        return _from_blocks(blocks.float(), p.shape, torch.float32) > 0

    def mark(into, name, p, now, other):
        # elements of `name` under a code in `now` other than in `other`
        for f in codes_f:
            hit = on_params(now[f"{f}:{name}"].to("cuda")
                            != other[f"{f}:{name}"].to("cuda"), p)
            into[name] = into.get(name, hit) | hit

    def flips_of_records():
        out = {}
        for r in records:
            for name, (region, hit) in r["flips"].items():
                w = out.setdefault(name, torch.zeros(
                    final[name].shape, dtype=torch.bool, device="cuda"))
                w[cut(region)] |= hit.to("cuda")
        return out

    def zero_nu(name, p):
        # a second moment the reference stored as 0 (code -127: sqrt(nu)
        # under half its block's step) before step 4 or 5
        return on_params(
            (trail[k - 1][f"nu_codes:{name}"].to("cuda") == -127)
            | (trail[k][f"nu_codes:{name}"].to("cuda") == -127), p)

    def count(named, ours, theirs, flipped):
        diff = off = under = nu0 = 0
        for name, p in named.items():
            d = (ours(name) - theirs(name)).abs()
            diff = max(diff, float(d.max()))
            under += int(flipped[name].sum())
            bad = (d > 1e-5) & ~flipped[name]
            off += int(bad.sum())
            nu0 += int((bad & zero_nu(name, p)).sum())
        return {"max_param_diff": diff, "params_off": off,
                "under_flips": under, "off_nu_zero": nu0}

    # flips against the reference (the restore's and the mesh's), and
    # between the restore and the mesh after steps 4 and 5
    vs_ref, mesh_vs_ref, vs_mesh = flips_of_records(), flips_of_records(), {}
    mesh_codes = {s: assemble(f"codes@{s}", lambda x: final[x])
                  for s in range(k + 1, k + n + 1)}
    checked = {"regions": 0, "differ": []}
    held = {}

    def seen(state, i):
        o = state.opt_state
        named = dict(state.model.named_parameters())
        if i == 0:
            for r in records:
                for key, (region, s) in r["sums"].items():
                    f, _, name = key.rpartition(":")
                    t = o.tensors()[f][name] if f else named[name].detach()
                    checked["regions"] += 1
                    if _checksum([t[cut(region)]]) != s:
                        checked["differ"].append(key)
            return
        now = {f"{f}:{name}": t for f in codes_f
               for name, t in o.tensors()[f].items()}
        for name, p in named.items():
            mark(vs_ref, name, p, now, trail[k + i - 1])
            mark(vs_mesh, name, p, now, mesh_codes[k + i])
            mark(mesh_vs_ref, name, p, mesh_codes[k + i], trail[k + i - 1])
        if i < n:
            return
        mesh = assemble(f"params@{k + n}", lambda x: final[x])
        ours = lambda x: named[x].detach()           # noqa: E731
        ref = lambda x: final[x].to("cuda")          # noqa: E731
        held["mesh"] = count(named, ours, mesh.__getitem__, vs_mesh)
        held["ref"] = count(named, ours, ref, vs_ref)
        held["mesh_vs_ref"] = count(named, mesh.__getitem__, ref,
                                    mesh_vs_ref)
        far = total = 0
        for key, t in now.items():
            d = (t.int() - final[key].to("cuda").int()).abs()
            far, total = far + int((d > 1).sum()), total + d.numel()
        held.update(codes_far=far, codes_total=total)

    A8.adam8bit_update.launches = 0
    resumed, plan, restore_s, got, step_ms, launches = _pair_resume(
        ckpt_dir, "int8", seen)
    k8 = A8.adam8bit_update.launches
    want_launches = [2 * a["layers"] * n, a["layers"] * n, a["layers"] * n]
    vs_mesh_run, vs_ref_run = held["mesh"], held["ref"]
    witness = held["mesh_vs_ref"]
    run = {"resumed": resumed, "plan": plan, "restore_s": restore_s,
           "regions_checked": checked["regions"],
           "regions_differ": checked["differ"],
           "losses": [m["loss"] for m in got],
           "want_losses": [w["loss"] for w in want[-n:]],
           "mesh_losses": [m["loss"] for m in mesh_metrics[-n:]],
           "grad_norms": [m["grad_norm"] for m in got],
           "vs_mesh": vs_mesh_run, "vs_ref": vs_ref_run,
           "mesh_vs_ref": witness, "params_total": n_params,
           "codes_far": held["codes_far"], "codes_total": held["codes_total"],
           "launches": launches, "adam8bit_launches": k8,
           "step_ms": step_ms}
    log(f"mesh train pod (b) int8 restore: tp2_int8's step {plan['step']} "
        f"restored on one card in {restore_s:.2f}s (resumed {resumed}, "
        f"plan {plan}); {checked['regions']} regions of the ranks' "
        f"parameters, codes and scales checked, differing bit for bit "
        f"{checked['differ'][:8]}; {n} steps, losses {run['losses']} (the "
        f"reference's {run['want_losses']}, the mesh's "
        f"{run['mesh_losses']}); against the mesh's step {k + n}: "
        f"largest |param difference| {vs_mesh_run['max_param_diff']:.3e}, "
        f"{vs_mesh_run['params_off']} of {n_params} off by more than 1e-5 "
        f"outside the {vs_mesh_run['under_flips']} elements under a code "
        f"other than the mesh's after step {k + 1} or {k + n}; read beside "
        f"it, against the reference's step {k + n} (flips against its codes "
        f"after every step): the restore {vs_ref_run['params_off']} off "
        f"outside {vs_ref_run['under_flips']} (largest "
        f"{vs_ref_run['max_param_diff']:.3e}, of the off "
        f"{vs_ref_run['off_nu_zero']} with a second moment stored as 0 "
        f"before step {k + 1} or {k + n}), the mesh without a restore "
        f"{witness['params_off']} off outside {witness['under_flips']} "
        f"(largest {witness['max_param_diff']:.3e}, "
        f"{witness['off_nu_zero']} with it); flash launches {launches} "
        f"(want {want_launches}); kernel #8 launches {k8} (want "
        f"{MESH_PAIR_INT8['tensors'] * n}); codes more than one off the "
        f"reference's {held['codes_far']} of {held['codes_total']}; step "
        f"ms {step_ms}")
    steps_lost = a["steps"] - plan["data_start_step"]
    if not (resumed and plan["step"] == k and steps_lost == 0
            and checked["regions"] > 0 and not checked["differ"]
            and launches == want_launches
            and k8 == MESH_PAIR_INT8["tensors"] * n
            and held["codes_far"] < MESH_PAIR_INT8["codes_far"]
            * held["codes_total"]
            and vs_mesh_run["params_off"] <= 1e-4 * n_params
            and vs_mesh_run["max_param_diff"] <= 2 * a["lr"] * n
            and _pair_metrics_close(got, want[-n:], 1e-5)):
        raise AssertionError("3s (b) int8 restore: the restored run is not "
                             "the mesh's")
    run["steps_lost"] = steps_lost
    return run


def _mesh_pair_runs(pair: dict) -> tuple:
    """Phase 3s (b): the meshes of ``MESH_PAIR_MESHES`` on the two
    processes of ``pair`` (:func:`_mesh_pair_start`) sharing the one card
    over gloo (``MESH_PAIR`` width and depth, f32; ep2_moe at
    ``MESH_PAIR_MOE``), each held to the same model's run without a mesh
    in this process on the same batches, then the elastic resume of dp2's
    step and the int8 restore of tp2_int8's on one card
    (:func:`_pair_elastic_resume`, :func:`_pair_int8_restore`).  Returns
    (gloo's answer to each collective and exchange on CUDA tensors, the
    runs); a refused one fails the phase."""
    import torch

    a = dict(MESH_PAIR)
    args = pair["args"]
    n_el = MESH_PAIR_ELASTIC["steps"]
    # the ranks' meshes go now, and read each reference only to check a
    # mesh: the int8 one first (their first three meshes' own), written
    # while they train
    Path(args["go"]).touch()
    t_refs = time.perf_counter()
    want8, kept8, final8, _, ref8_s, trail8 = _pair_reference(
        a["preset"], a["layers"], a["steps"] + n_el, a["steps"],
        moments="int8")
    # the parameters after (b)'s steps and the codes after each of them,
    # for the ranks' record of which elements sat under a code other
    # than these
    kept8 = {k: v for k, v in kept8.items() if ":" not in k}
    kept8.update((f"{k}@{i + 1}", v) for i, codes in
                 enumerate(trail8[:a["steps"]]) for k, v in codes.items())
    t_pub = time.perf_counter()
    _publish(kept8, args["ref_int8"])
    del kept8
    pub8_s = time.perf_counter() - t_pub
    want, kept, final, n_params, ref_s, _ = _pair_reference(
        a["preset"], a["layers"], a["steps"] + n_el, a["steps"])
    _publish(kept, args["ref"])
    del kept
    moe = MESH_PAIR_MOE
    want_moe, kept_moe, _, n_moe, moe_s, _ = _pair_reference(
        moe["preset"], moe["layers"], a["steps"], a["steps"],
        moe_capacity_factor=moe["capacity_factor"])
    _publish(kept_moe, args["ref_moe"])
    del kept_moe
    refs_s = time.perf_counter() - t_refs
    procs = pair["procs"]
    outs = []
    try:
        # the int8 restore as soon as tp2_int8 has written its steps
        # after the save, beside the ranks' later meshes (which keep
        # gloo's host copies, not the card, busy)
        conts = [os.path.join(args["int8_ckpt"], f"cont-{r}.pt")
                 for r in range(2)]
        deadline = time.time() + 600
        while not all(os.path.exists(c) for c in conts):
            failed = [p.returncode for p in procs if p.poll()]
            if failed or time.time() > deadline:
                raise AssertionError(
                    f"3s (b): no tp2_int8 continuation from both ranks "
                    f"(exit codes {[p.poll() for p in procs]})")
            time.sleep(0.1)
        t_el = time.perf_counter()
        int8_restore = _pair_int8_restore(
            args["int8_ckpt"], want8, final8, trail8, n_params)
        int8_restore_s = time.perf_counter() - t_el
        for p in procs:
            out, err = p.communicate(timeout=600)
            if p.returncode != 0:
                raise AssertionError(f"3s (b): a rank exited "
                                     f"{p.returncode}: {err[-3000:]}")
            outs.append([json.loads(ln) for ln in out.splitlines()
                         if ln.startswith("{")])
        wall = time.perf_counter() - t_refs
        t_el = time.perf_counter()
        elastic = _pair_elastic_resume(args["elastic_ckpt"], want, final,
                                       n_params)
        elastic_s = time.perf_counter() - t_el
    finally:
        _mesh_pair_stop(pair)
    # the ranks' answers (they agree unless one rank failed)
    probe = {k: next((o[0]["probe"][k] for o in outs
                      if o[0]["probe"][k] != "ok"), "ok")
             for k in outs[0][0]["probe"]}
    refused = sorted(k for k, v in probe.items() if v != "ok")
    log(f"mesh train pod (b): gloo on CUDA tensors, two processes on the "
        f"one card: {probe}")
    if refused:
        raise AssertionError(f"3s (b): gloo refused {', '.join(refused)} "
                             "on CUDA tensors, which the mesh steps need")
    runs = {}
    runs_of = {t: run for t, _, _, _, run in MESH_PAIR_MESHES}
    for mesh_out in zip(*(o[1:] for o in outs)):
        first = mesh_out[0]
        tag = first["tag"]
        run_opts = runs_of[tag]
        is_moe = run_opts.get("ref") == "ref_moe"
        is_int8 = run_opts.get("moments") == "int8"
        twin = run_opts.get("same_as")
        steps = run_opts.get("steps", a["steps"])
        layers = moe["layers"] if is_moe else a["layers"]
        want_tag = (want_moe if is_moe else want8 if is_int8
                    else want)[:steps]
        metrics = first["metrics"]
        same = all(o["metrics"] == metrics for o in mesh_out)
        launches = [o["launches"] for o in mesh_out]
        want_launches = [mesh_pair_launches(tag, o["rank"], layers, steps)
                         for o in mesh_out]
        step_ms = [o["step_ms"] for o in mesh_out]
        xbytes = [o["exchange_bytes_per_step"] for o in mesh_out]
        dropped = [o["dropped"] for o in mesh_out]
        secs = [(round(o["setup_s"], 2), round(o.get("check_s", 0.0), 2))
                for o in mesh_out]
        keys = ("loss", "aux_loss") if is_moe else ("loss",)
        pairs = [tuple(x for k in keys + ("grad_norm",)
                       for x in (m[k], w[k]))
                 for m, w in zip(metrics, want_tag)]
        if twin is None:
            # held to the reference after (b)'s steps
            diff = max(o["max_param_diff"] for o in mesh_out)
            off = sum(o["params_off"] for o in mesh_out)
            total = sum(o["params_total"] for o in mesh_out)
            held = (f"largest |param difference| {diff:.3e}, {off} of "
                    f"{total} parameters off by more than 1e-5 after step "
                    f"{a['steps']}")
        else:
            held = f"held to {twin} bit for bit"
        log(f"mesh train pod (b) {tag}: two ranks on the one card over "
            f"gloo, {first['local_heads']} heads a rank, "
            f"layers a rank {[o['layers_here'] for o in mesh_out]}, "
            f"({', '.join(f'{k}, want' for k in keys)}, grad_norm, want) "
            f"{pairs}; the ranks' metrics equal: {same}; {held}; flash "
            f"launches a rank {launches} (want {want_launches}"
            + ("; ring attention runs plain ops, no flash kernel"
               if tag == "cp2_ring" else "")
            + f"); step ms a rank {step_ms}; exchange bytes a step a rank "
            f"{xbytes}; s a rank to build the state and to check it "
            f"{secs}; peak GB a rank {[round(o['peak_gb'], 2) for o in mesh_out]}"
            + (f"; dropped assignments a step a rank {dropped}"
               if is_moe else "")
            + (f"; saved steps {first['saved']}" if "saved" in first
               else ""))
        int8_ok = True
        if is_int8:
            # kernel #8 once a tensor a step on every rank, never the
            # plain update; the codes; an offloaded run bit for bit the
            # resident one after each of its steps, its moments in the
            # pinned slab
            k8 = [o["adam8bit_launches"] for o in mesh_out]
            want_k8 = MESH_PAIR_INT8["tensors"] * steps
            sums = [o["checksums"] for o in mesh_out]
            slab = [o["in_slab"] for o in mesh_out]
            bits = twin is None or (
                [s[:steps] for s in runs[twin]["checksums"]] == sums
                and runs[twin]["losses"][:steps]
                == [m["loss"] for m in metrics]
                and runs[twin]["grad_norms"][:steps]
                == [m["grad_norm"] for m in metrics])
            codes = ""
            if twin is None:
                far = sum(o["codes_far"] for o in mesh_out)
                codes_off = sum(o["codes_off"] for o in mesh_out)
                n_codes = sum(o["codes_total"] for o in mesh_out)
                codes = (f"parameters held to 2 lr a step only (under a "
                         f"code that came out other than the reference's "
                         f"at some step) "
                         f"{sum(o['under_flips'] for o in mesh_out)}; codes "
                         f"more than one off the reference's {far}, off by "
                         f"one {codes_off}, of {n_codes}; ")
            log(f"mesh train pod (b) {tag}: int8 moments, cases "
                f"{[o['cases'] for o in mesh_out]}; {codes}kernel #8 "
                f"launches a rank {k8} (want {want_k8}), plain updates "
                f"{[o['plain_updates'] for o in mesh_out]}; int8 gather "
                f"bytes a step a rank "
                f"{[{k: v for k, v in x.items() if k.startswith('q8')} for x in xbytes]}"
                + (f"; bit-equal to {twin} after each of its {steps} "
                   f"steps: {bits}; moments in the pinned slab after each "
                   f"step {slab}" if twin else ""))
            int8_ok = (all(k == want_k8 for k in k8)
                       and all(o["plain_updates"] == 0 for o in mesh_out)
                       and bits
                       and (twin is not None or far < MESH_PAIR_INT8[
                           "codes_far"] * n_codes)
                       and (not run_opts.get("offload")
                            or all(all(x) and len(x) == steps
                                   for x in slab)))
        ok = (same and launches == want_launches
              and len(metrics) == steps
              and (_pair_metrics_close(metrics, want_tag, 1e-5)
                   if twin else _pair_gate(
                       metrics, want_tag, diff, off, total,
                       n_moe if is_moe else n_params, a["steps"],
                       1e-5 if is_int8 else 1e-4))
              and int8_ok
              and (not is_moe or all(d > 0 for r in dropped for d in r))
              and (not run_opts.get("save")
                   or first["saved"] == [a["steps"]]))
        if not ok:
            raise AssertionError(f"3s (b) {tag}: the two-rank mesh run "
                                 "differs from the run without a mesh")
        runs[tag] = {"losses": [m["loss"] for m in metrics],
                     "grad_norms": [m["grad_norm"] for m in metrics],
                     "want_losses": [w["loss"] for w in want_tag],
                     "launches": launches, "step_ms": step_ms,
                     "exchange_bytes": xbytes,
                     "peak_gb": [o["peak_gb"] for o in mesh_out]}
        if twin is None:
            runs[tag].update(max_param_diff=diff, params_off=off,
                             params_total=total)
        if is_moe:
            runs[tag].update(aux_losses=[m["aux_loss"] for m in metrics],
                             dropped=dropped)
        if is_int8:
            runs[tag].update(adam8bit_launches=k8, checksums=sums,
                             in_slab=slab)
            if twin is None:
                runs[tag].update(codes_far=far, codes_off=codes_off,
                                 codes_total=n_codes)
    if set(runs) != {m[0] for m in MESH_PAIR_MESHES}:
        raise AssertionError(f"3s (b): ran {sorted(runs)}, not every mesh "
                             "of MESH_PAIR_MESHES")
    runs["elastic"] = elastic
    runs["int8_restore"] = int8_restore
    runs["wall_s"] = wall
    log(f"mesh train pod (b): {len(MESH_PAIR_MESHES)} meshes in "
        f"{wall:.1f}s; beside them the runs without a mesh (int8 "
        f"{ref8_s:.1f}s, its codes and parameters published in "
        f"{pub8_s:.1f}s; f32 {ref_s:.1f}s; {moe['preset']} {moe_s:.1f}s; "
        f"all published after {refs_s:.1f}s) and the int8 restore "
        f"({int8_restore_s:.1f}s); then the elastic resume "
        f"{elastic_s:.1f}s; the ranks, started before (a), probed after "
        f"{[round(o[0]['ready_s'], 1) for o in outs]}s")
    return probe, runs


def _two_card_pod_start() -> dict:
    """The launcher shim of a pod of 2 cards (``CARDS2_POD_ENV``) on this
    one-card machine, each child calling ``launcher.initialize()``: one
    child a card, each must refuse to share the card by name before it
    joins a group.  Started before (b)'s references;
    :func:`_two_card_pod_check` reads it."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "TPUJOB_", "MEGASCALE_"))}
    env.update(CARDS2_POD_ENV,
               PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""))
    code = ("from paddle_operator_tpu_torch.launch import launcher; "
            "launcher.initialize(); print('joined', flush=True)")
    pod = {"t0": time.perf_counter(), "proc": subprocess.Popen(
        [sys.executable, "-m", "paddle_operator_tpu_torch.launch.launcher",
         "--", sys.executable, "-c", code],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)}

    def reap():
        # its output and the seconds to its exit, read while (b) runs
        try:
            pod["out"], pod["err"] = pod["proc"].communicate(timeout=120)
        except subprocess.TimeoutExpired:
            pod["out"], pod["err"] = "", "no exit within 120 s"
        pod["exit_s"] = time.perf_counter() - pod["t0"]

    pod["reaper"] = threading.Thread(target=reap, daemon=True)
    pod["reaper"].start()
    return pod


def _two_card_pod_check(pod: dict) -> dict:
    """Phase 3s's check of pods of several cards on a one-card machine:
    the 2-card pod exits non-zero, its children having named the card
    count before any joined a group (no ``joined`` line), within 60 s of
    its start."""
    proc = pod["proc"]
    pod["reaper"].join(timeout=130)
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    out, err, secs = pod["out"], pod["err"], pod["exit_s"]
    named = "runs 2 cards (one process a card) but sees 1 CUDA card"
    run = {"exit": proc.returncode, "seconds": secs,
           "named": err.count(named), "joined": "joined" in out}
    log(f"two-card pod: the shim of a pod of 2 cards (CARDS2_POD_ENV) on "
        f"this one-card machine exited {proc.returncode} in {secs:.1f}s; "
        f"{run['named']} child(ren) refused by name ({named!r}), joined a "
        f"group: {run['joined']}")
    if proc.returncode == 0 or run["named"] < 1 or run["joined"] \
            or secs > 60:
        raise AssertionError(f"3s: the 2-card pod was not refused by name: "
                             f"exit {proc.returncode}, {err[-2000:]}")
    return run


def phase_mesh_train_pod(reports: dict) -> None:
    """Phase 3s: the operator's training pod of a one-worker mesh job;
    see the module docstring."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from paddle_operator_tpu_torch.parallel.mesh import AXIS_ORDER

    card = card_line()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    child = os.path.join(root, "train_mesh.py")
    Path(child).write_text(MESH_TRAIN_CHILD)
    args = dict(MESH_TRAIN, peak=PEAK_BF16)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "TPUJOB_", "MEGASCALE_"))}
    env.update(MESH_POD_ENV,
               PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""))
    pair = _mesh_pair_start()
    two_cards = None
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "paddle_operator_tpu_torch.launch.launcher",
             "--", sys.executable, child, json.dumps(args)],
            env=env, cwd=str(ROOT), capture_output=True, text=True,
            timeout=600)
        launch_s = time.perf_counter() - t0
        events = [json.loads(ln) for ln in proc.stdout.splitlines()
                  if ln.startswith("{")]
        if proc.returncode != 0 or not events \
                or events[-1].get("event") != "done":
            raise AssertionError(f"3s: the pod exited {proc.returncode}; "
                                 f"events {str(events)[-1500:]}; log "
                                 f"{proc.stderr[-3000:]}")
        mesh_ev = next(e for e in events if e["event"] == "mesh")
        done = events[-1]
        layers, steps = MESH_TRAIN["layers"], MESH_TRAIN["steps"]
        axes = dict(zip(mesh_ev["names"], mesh_ev["shape"]))
        log(f"mesh train pod: job_mesh {axes} over {mesh_ev['backend']} "
            f"(world {mesh_ev['world']}, ready "
            f"{mesh_ev['ready_s']:.1f}s); 7b width, {layers} layers "
            f"({done['params'] / 1e9:.3f}B params), B={MESH_TRAIN['batch']} "
            f"S={MESH_TRAIN['seq']}; pod exit 0 in {launch_s:.1f}s; {card}")
        if mesh_ev["names"] != list(AXIS_ORDER) or set(mesh_ev["shape"]) \
                != {1} or mesh_ev["backend"] != "nccl" \
                or mesh_ev["world"] != 1 or not done["replicated"]:
            raise AssertionError(f"3s: the job mesh is not the one-card "
                                 f"nccl mesh of AXIS_ORDER: {mesh_ev}")
        plain = [(m["loss"], m["grad_norm"]) for m in done["plain"]]
        got = [(m["loss"], m["grad_norm"]) for m in done["mesh"]]
        loss_diff = max(abs(a - b) for a, b in zip(
            np.ravel(plain), np.ravel(got)))
        log(f"mesh train pod: {steps} steps, mesh (loss, grad_norm) {got}, "
            f"without a mesh {plain}; "
            + ("bit-equal (losses, grad norms and every parameter)"
               if done["bit_equal"] and plain == got else
               f"NOT bit-equal: largest |loss or grad norm difference| "
               f"{loss_diff:.3e}, largest |param difference| "
               f"{done['max_param_diff']:.3e}"))
        if len(got) != steps or not np.allclose(got, plain, rtol=1e-5,
                                                 atol=0) \
                or done["max_param_diff"] > 1e-5:
            raise AssertionError("3s: the mesh step differs from the step "
                                 "without a mesh")
        want = [2 * layers * steps, layers * steps, layers * steps]
        timed = MESH_TRAIN["timed_steps"]
        want_timed = [2 * layers * timed, layers * timed, layers * timed]
        log(f"mesh train pod: flash launches (#4/#5/#6) {done['launches']} "
            f"over the mesh run's {steps} steps (want {want}), "
            f"{done['timed_launches']} over the {timed} timed steps, "
            f"{done['plain_launches']} without a mesh")
        if done["launches"] != want or done["plain_launches"] != want \
                or done["timed_launches"] != want_timed:
            raise AssertionError("3s: flash launches do not match the "
                                 "formulas")
        times = done["step_ms"]                 # steps 2..N of the timed fit
        step_ms = float(np.median(times))
        b, s = MESH_TRAIN["batch"], MESH_TRAIN["seq"]
        tok_s = b * s / (step_ms / 1e3)
        mfu = tok_s * done["flops_per_token"] / PEAK_BF16
        timed_losses = [m["loss"] for m in done["timed"]]
        if not np.isfinite(timed_losses).all():
            raise AssertionError(f"3s: a timed loss is not finite: "
                                 f"{timed_losses}")
        # beside (b)'s references, which keep the card and not the host
        # busy (beside (a) it slowed (a)'s pod start by seconds)
        two_cards = _two_card_pod_start()
        probe, pair_runs = _mesh_pair_runs(pair)
        refused = _two_card_pod_check(two_cards)
        run = {"layers": layers, "batch": b, "seq": s, "steps": steps,
               "params": done["params"], "bit_equal": done["bit_equal"],
               "max_param_diff": done["max_param_diff"],
               "max_metric_diff": loss_diff,
               "losses": [m["loss"] for m in done["mesh"]],
               "timed_losses": timed_losses,
               "step_ms": times, "step_ms_median": step_ms,
               "tokens_per_s": tok_s, "mfu": mfu,
               "peak_gb": done["peak_gb"], "launches": done["launches"],
               "timed_launches": done["timed_launches"],
               "launch_s": launch_s, "gloo_cuda": probe, "pair": pair_runs,
               "two_card_pod": refused}
        log("mesh train pod: " + json.dumps(run))
        log(f"mesh train pod (one run, not a benchmark): step "
            f"{step_ms:.1f} ms (median of {len(times)} intervals), "
            f"{tok_s:.0f} tokens/s, MFU {mfu:.3f} against "
            f"{PEAK_BF16 / 1e12:.0f} TFLOP/s bf16, peak "
            f"{done['peak_gb']:.2f} GB; {card}")
        reports["flash_forward"]["mesh_train"] = run
        for i, kern in enumerate(FLASH_KERNELS):
            reports[kern]["mesh_train_launches"] = done["launches"][i]
    finally:
        _mesh_pair_stop(pair)
        if two_cards is not None and two_cards["proc"].poll() is None:
            two_cards["proc"].kill()
            two_cards["proc"].wait()
        shutil.rmtree(root, ignore_errors=True)


# phase 3t: one rank of the tensor-parallel serving pair on the one card
# over gloo (rank 0 the ring's leader, rank 1 its follower); writes
# rank<r>.pt into the out dir
TP_SERVE_CHILD = r"""
import dataclasses, json, sys, threading, time
import torch
import torch.distributed as dist

a = json.loads(open(sys.argv[1]).read())
rank = int(sys.argv[2])
torch.cuda.set_device(0)
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{a['port']}",
                        world_size=2, rank=rank)
from paddle_operator_tpu_torch.infer import decode as D
from paddle_operator_tpu_torch.infer import quant as Q
from paddle_operator_tpu_torch.infer.qos import AdapterRegistry
from paddle_operator_tpu_torch.infer.scheduler import (ContinuousBatcher,
                                                       follow_ring)
from paddle_operator_tpu_torch.models.llama import CONFIGS
from paddle_operator_tpu_torch.ops import decode_attention as DA
from paddle_operator_tpu_torch.ops import quant_matmul as QM
from paddle_operator_tpu_torch.parallel import collectives as C
from paddle_operator_tpu_torch.parallel.mesh import make_serving_mesh
from paddle_operator_tpu_torch.utils.radixkey import prefix_chain_key

mesh = make_serving_mesh(2, device="cuda")
out = {"rank": rank, "backend": dist.get_backend()}


def zero():
    DA.decode_attention.launches = 0
    DA.paged_decode_attention.launches = 0
    DA.paged_decode_attention.quant_launches = 0
    QM.quant_matmul.launches = 0
    QM.quant_gemm.launches = 0
    for k in C.SERVING:
        C.SERVING[k] = 0


def counts():
    return {"k1": DA.decode_attention.launches,
            "k2": DA.paged_decode_attention.launches,
            "k3": DA.paged_decode_attention.quant_launches,
            "A": QM.quant_matmul.launches, "B": QM.quant_gemm.launches,
            **C.SERVING}


def timed(b):
    # each dispatch's wall and CUDA-event ms on the leader (eager: the
    # events also span the card's waits on gloo's host copies)
    real = b.executor.replay
    rec = {"wall_s": 0.0, "events": []}

    def replay(plan):
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        t = time.perf_counter()
        s.record()
        res = real(plan)
        e.record()
        e.synchronize()
        rec["wall_s"] += time.perf_counter() - t
        rec["events"].append((s, e))
        return res

    b.executor.replay = replay
    return rec


def summary(rec, chunks):
    ev = [s.elapsed_time(e) for s, e in rec["events"]]
    n = max(1, len(ev))
    return {"dispatches": len(ev), "chunks": chunks,
            "wall_ms": rec["wall_s"] * 1e3 / n, "event_ms": sum(ev) / n}


def ring(name, model, cfg, kw, body):
    zero()
    if rank:
        follow_ring(model, cfg, mesh=mesh, **kw)
        out[name] = {"counts": counts()}
        return
    b = ContinuousBatcher(model, cfg, mesh=mesh, **kw)
    rec = timed(b)
    try:
        got = body(b)
        chunks = b.stats["chunks"]
        tp = b.serving_tp()
    finally:
        b.close()
    out[name] = dict(got, counts=counts(), tp=tp, **summary(rec, chunks))


# (a) 7b width cut to a_layers, f32: each rank's cut of one seeded init
cfg_a = dataclasses.replace(CONFIGS["7b"], n_layers=a["a_layers"],
                            dtype=torch.float32, param_dtype=torch.float32)
t0 = time.perf_counter()
base = D.init_serving_shard(cfg_a, mesh, seed=a["a_seed"], device="cuda")
qshard = D.init_serving_shard(
    cfg_a, mesh, seed=a["a_seed"], device="cuda",
    passes=Q.quant_passes({"SERVE_WEIGHT_QUANT": "int8"}))
out["a_init_s"] = time.perf_counter() - t0
for name, kw, reqs in a["a_runs"]:
    kw = dict(kw)
    if name == "adapter":
        reg = AdapterRegistry(cfg_a, capacity=1, rank=8, device="cuda")
        reg.load("acme", seed=5)
        kw["adapters"] = reg

    def body(b, reqs=reqs):
        got = []
        for wave in sorted({r[3] for r in reqs}):
            hs = [b.submit(p, max_new_tokens=n, adapter=ad)
                  for p, n, ad, w in reqs if w == wave]
            got += [h.result(timeout=300) for h in hs]
        pool = b.pool.stats if b.pool is not None else {}
        return {"tokens": got, "hit_tokens": pool.get("prefix_hit_tokens", 0),
                "cow": pool.get("cow_copies", 0)}

    ring(name, qshard if name == "int8_weights" else base, cfg_a, kw, body)
del base, qshard
torch.cuda.empty_cache()

# (b) 7b at b_layers, bf16, seed 0 (make_7b's draws): 3b's burst
cfg_b = dataclasses.replace(CONFIGS["7b"], n_layers=a["b_layers"],
                            param_dtype=CONFIGS["7b"].dtype)
t0 = time.perf_counter()
shard = D.init_serving_shard(cfg_b, mesh, seed=0, device="cuda")
torch.cuda.synchronize()
out["b_init_s"] = time.perf_counter() - t0
burst = a["burst"]


def burst_body(b):
    res, errors = {}, []

    def send(kind, i, p, n):
        try:
            res[f"{kind}:{i}"] = b.submit(p, max_new_tokens=n).result(
                timeout=600)
        except Exception as e:
            errors.append(f"{kind} {i}: {e!r}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=send, args=j) for j in burst["jobs"]]
    for t in threads:
        t.start()
    key = prefix_chain_key(burst["prefix"], a["b_block"], max_blocks=2)[0]
    while key not in b.pool.entries:
        if errors or time.perf_counter() - t0 > 600:
            raise AssertionError(f"the prefix was never cached: {errors}")
        time.sleep(0.005)
    more = [threading.Thread(target=send, args=j) for j in burst["late"]]
    for t in more:
        t.start()
    for t in threads + more:
        t.join()
    if errors:
        raise AssertionError(f"3t (b): {errors}")
    return {"tokens": res, "burst_s": time.perf_counter() - t0}


ring("burst", shard, cfg_b, a["b_ring"], burst_body)
# each cold prompt's first-token logits through the tp prefill (every
# rank runs it: its collectives pair), on the first n layers of the cut
# for each depth of a["depths"] (the whole cut last)
import copy
with torch.inference_mode():
    out["first_logits"] = {}
    for n in a["depths"]:
        cut = copy.copy(shard)
        cut._modules = dict(shard._modules)
        cut._modules["layers"] = torch.nn.ModuleList(shard.layers[:n])
        cfg_n = dataclasses.replace(cfg_b, n_layers=n)
        out["first_logits"][n] = torch.stack([D.prefill(
            cut, cfg_n, torch.tensor([p], device="cuda"), max_len=2048,
            mesh=mesh)[0][0].float().cpu() for p in burst["cold"]])
out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
torch.save(out, f"{a['out']}/rank{rank}.pt")
dist.destroy_process_group()
"""


def _tp_local_kernels() -> dict:
    """3t's kernels on a rank's shapes at 7b over tp 2 (16 of 32 heads,
    D 128; wq's and w1's column halves and wo's row half under int8
    weights), f32, each held to its plain version."""
    import torch

    from paddle_operator_tpu_torch.infer.quant import quantize_leaf
    from paddle_operator_tpu_torch.ops import decode_attention as DA
    from paddle_operator_tpu_torch.ops import quant_matmul as QM

    g = torch.Generator(device="cuda")
    g.manual_seed(31)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    b, h, d, s, bs = 8, 16, 128, 512, 16
    lengths = torch.tensor([1, 17, 128, 255, 256, 300, 511, 512],
                           dtype=torch.int32, device="cuda")
    q, k, v = rnd(b, h, d), rnd(b, h, s, d), rnd(b, h, s, d)
    errs = {"decode_attention": (DA.decode_attention(q, k, v, lengths)
                                 - DA.decode_attention_reference(
                                     q, k, v, lengths)).abs().max().item()}
    m = s // bs
    n = b * m + 1
    table = (1 + torch.randperm(n - 1, generator=g, device="cuda")
             ).reshape(b, m).int()
    kp, vp = rnd(n, h, bs, d), rnd(n, h, bs, d)
    errs["paged_decode_attention"] = (
        DA.paged_decode_attention(q, kp, vp, table, lengths)
        - DA.paged_decode_attention_reference(q, kp, vp, table, lengths)
    ).abs().max().item()
    codes = [torch.randint(-127, 128, (n, h, bs, d), generator=g,
                           device="cuda", dtype=torch.int8)
             for _ in range(2)]
    scales = [torch.rand((n, h), generator=g, device="cuda") * 0.02
              for _ in range(2)]
    tails = [rnd(b + 1, h, bs, d) for _ in range(2)]
    qargs = (codes[0], codes[1], table, lengths, scales[0], scales[1],
             tails[0], tails[1])
    errs["paged_decode_attention_quant"] = (
        DA.paged_decode_attention(q, *qargs[:4], k_scale=scales[0],
                                  v_scale=scales[1], k_tail=tails[0],
                                  v_tail=tails[1])
        - DA.paged_decode_attention_quant_reference(q, *qargs)
    ).abs().max().item()
    err_a = 0.0
    for rows, k_in, n_out in ((8, 4096, 2048), (8, 4096, 5504),
                              (8, 2048, 4096)):
        leaf = quantize_leaf(rnd(k_in, n_out) * 0.02)
        x = rnd(rows, k_in)
        got = QM.quant_matmul(x, leaf["q"], leaf["s"])
        want = QM.quant_matmul_reference(x, leaf["q"], leaf["s"])
        err_a = max(err_a, ((got - want).abs().max()
                            / want.abs().max().clamp(min=1)).item())
    errs["quant_matmul"] = err_a
    return errs


def _tp_a_runs(cfg) -> list:
    """3t (a)'s rings: (name, ring arguments, requests as (prompt, new
    tokens, adapter, wave)); a ring sends a wave once the one before it
    has finished.  The exact pool and the int8 pool take a second wave
    that shares the longest prompt's cached blocks (``shared_prefix``:
    its first whole blocks, so the lane decodes on a copy-on-write copy
    of the last one and, on the int8 pool, a staging tail seeded from
    it; and its first blocks and a suffix of its own)."""
    import numpy as np

    r = SERVE_TP_RUNS
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in r["lens"]]
    reqs = [(p, r["new"], None, 0) for p in prompts]
    whole, head, own = r["shared_prefix"]
    bs = r["block_size"]
    hits = reqs + [(prompts[-1][:whole * bs], r["new"], None, 1),
                   (prompts[-1][:head * bs]
                    + rng.integers(0, cfg.vocab_size, own).tolist(),
                    r["new"], None, 1)]
    paged = dict(r["ring"], paged=True, block_size=bs)
    return [("contiguous", dict(r["ring"]), reqs),
            ("paged", paged, hits),
            ("int8_pool", dict(paged, kv_quant="int8"), hits),
            ("int8_weights", paged, reqs),
            ("adapter", paged, [(prompts[0], r["new"], "acme", 0),
                                (prompts[1], r["new"], None, 0),
                                (prompts[2], r["new"], "acme", 0)])]


def _tp_a_refs(runs, cfg_a) -> dict:
    """3t (a) at tp 1 in this process: each ring's tokens (and
    ``generate``'s) on the whole model of the same seed."""
    import torch

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.infer import quant as Q
    from paddle_operator_tpu_torch.infer.qos import AdapterRegistry
    from paddle_operator_tpu_torch.infer.scheduler import ContinuousBatcher
    from paddle_operator_tpu_torch.models.llama import make_model

    over = dict(n_layers=cfg_a.n_layers, dtype=torch.float32,
                param_dtype=torch.float32)
    model, _ = make_model("7b", device="cuda", seed=SERVE_TP_RUNS["a_seed"],
                          **over)
    qmodel, _ = make_model("7b", device="cuda",
                           seed=SERVE_TP_RUNS["a_seed"], **over)
    Q.quantize_params(qmodel, cfg_a, mode="int8", skip=Q.SERVING_SKIP)
    refs = {}
    for name, kw, reqs in runs:
        kw = dict(kw)
        if name == "adapter":
            reg = AdapterRegistry(cfg_a, capacity=1, rank=8, device="cuda")
            reg.load("acme", seed=5)
            kw["adapters"] = reg
        b = ContinuousBatcher(qmodel if name == "int8_weights" else model,
                              cfg_a, **kw)
        try:
            refs[name] = []
            for wave in sorted({q[3] for q in reqs}):
                hs = [b.submit(p, max_new_tokens=n, adapter=ad)
                      for p, n, ad, w in reqs if w == wave]
                refs[name] += [h.result(timeout=300) for h in hs]
        finally:
            b.close()
    with torch.inference_mode():
        for key, m, reqs in (("generate", model, runs[1][2]),
                             ("generate_int8", qmodel, runs[3][2])):
            refs[key] = [D.generate(
                m, cfg_a, torch.tensor([p], device="cuda"),
                max_new_tokens=n, max_len=SERVE_TP_RUNS["ring"]["max_len"]
            )[0].tolist() for p, n, _, _ in reqs]
    return refs


def _tp_f32_burst(params, cfg, jobs, late, prefix) -> dict:
    """3t (b)'s witness: 3b's burst on one card through 3b's ring with
    the same bf16 weights computed in f32 (``cfg.dtype``: each product
    casts its weight, the pool holds f32).  Returns each request's
    tokens by (kind, index)."""
    import torch

    from paddle_operator_tpu_torch.infer.scheduler import ContinuousBatcher
    from paddle_operator_tpu_torch.utils.radixkey import prefix_chain_key

    kw = {k: v for k, v in RING.items() if k != "continuous"}
    b = ContinuousBatcher(params, dataclasses.replace(cfg,
                                                      dtype=torch.float32),
                          **kw)
    try:
        hs = {(kind, i): b.submit(p, max_new_tokens=n)
              for kind, i, p, n in jobs}
        key = prefix_chain_key(prefix, RING["block_size"], max_blocks=2)[0]
        t0 = time.perf_counter()
        while key not in b.pool.entries:
            if time.perf_counter() - t0 > 600:
                raise AssertionError("3t (b) f32: the prefix was never "
                                     "cached")
            time.sleep(0.005)
        hs.update({(kind, i): b.submit(p, max_new_tokens=n)
                   for kind, i, p, n in late})
        return {k: h.result(timeout=600) for k, h in hs.items()}
    finally:
        b.close()


def _tp_refusal_start():
    """3t (c): ``SERVE_TP=2`` through the serving entry point on this
    one-card pod (read by :func:`phase_serving_tp`)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SERVE_", "TPUJOB_", "MODEL_"))}
    env.update(SERVE_TP="2", SERVE_CONTINUOUS="1", MODEL_PRESET="7b",
               PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""))
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "paddle_operator_tpu_torch.infer.serve"],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def phase_serving_tp(reports: tuple, params, cfg, ring_tokens) -> None:
    """Phase 3t: tensor-parallel serving on two ranks sharing the card;
    see the module docstring."""
    import shutil
    import socket
    import tempfile

    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.models.llama import CONFIGS

    contiguous, paged, quant, qmm, qmm_b = reports
    card = card_line()
    r = SERVE_TP_RUNS
    t_c, refusal = _tp_refusal_start()
    root = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    cold, prefix, jobs, late, _ = burst_requests(cfg)
    cfg_a = dataclasses.replace(CONFIGS["7b"], n_layers=r["a_layers"],
                                dtype=torch.float32,
                                param_dtype=torch.float32)
    runs = _tp_a_runs(cfg_a)
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    b_ring = {k: v for k, v in RING.items() if k != "continuous"}
    args = {"port": port, "out": root, "a_layers": r["a_layers"],
            "a_seed": r["a_seed"], "a_runs": runs, "b_layers": r["b_layers"],
            "depths": r["depths"],
            "b_ring": b_ring, "b_block": RING["block_size"],
            "burst": {"jobs": jobs, "late": late, "prefix": prefix,
                      "cold": cold}}
    Path(root, "args.json").write_text(json.dumps(args))
    Path(root, "child.py").write_text(TP_SERVE_CHILD)
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    logs = [open(Path(root, f"rank{i}.log"), "w") for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(root, "child.py")),
         str(Path(root, "args.json")), str(i)], env=env, cwd=str(ROOT),
        stdout=logs[i], stderr=subprocess.STDOUT) for i in range(2)]
    try:
        errs = _tp_local_kernels()
        refs = _tp_a_refs(runs, cfg_a)
        gc.collect()
        torch.cuda.empty_cache()
        # tp 1's first-token logits at each depth of the same weights, in
        # bf16 and computed in f32 (the bf16 paths' common reference)
        want_logits, f32_logits = {}, {}
        with torch.inference_mode():
            for n in r["depths"]:
                cut, cfg_n = _depth_cut(params, cfg, n)
                for dst, c in ((want_logits, cfg_n), (f32_logits,
                               dataclasses.replace(cfg_n,
                                                   dtype=torch.float32))):
                    dst[n] = torch.stack([D.prefill(
                        cut, c, torch.tensor([p], device="cuda"),
                        max_len=2048)[0][0].float().cpu() for p in cold])
        t_w = time.perf_counter()
        f32_burst = _tp_f32_burst(params, cfg, jobs, late, prefix)
        witness_s = time.perf_counter() - t_w
        gc.collect()
        torch.cuda.empty_cache()
        deadline = time.monotonic() + r["timeout"]
        for i, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
            if p.wait() != 0:
                raise AssertionError(
                    f"3t: rank {i} exited {p.returncode}: "
                    + Path(root, f"rank{i}.log").read_text()[-4000:])
        wall = time.perf_counter() - t0
        outs = [torch.load(Path(root, f"rank{i}.pt"), weights_only=False)
                for i in range(2)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        if refusal.poll() is None:
            try:
                refusal.wait(timeout=60)
            except subprocess.TimeoutExpired:
                refusal.kill()
                refusal.wait()
        shutil.rmtree(root, ignore_errors=True)
    lead = outs[0]
    ok = True
    # (a): every ring equals its tp-1 ring (the exact pools also
    # generate), launches the formulas', the ranks' launches equal
    layers = r["a_layers"]
    ticks_of = {name: lead[name]["chunks"] * r["ring"]["chunk_tokens"]
                for name, _, _ in runs}
    short = sum(1 for n in r["lens"] if n <= 64)
    for name, _, reqs in runs:
        got = lead[name]["tokens"]
        same_tp1 = got == refs[name]
        same_gen = ({"contiguous": got == refs["generate"][:len(got)],
                     "paged": got == refs["generate"],
                     "int8_weights": got == refs["generate_int8"]}
                    .get(name))
        # the second wave's prefix hits (and their copy-on-write) ran
        hit_ok = (name not in ("paged", "int8_pool")
                  or (lead[name]["hit_tokens"] > 0 and lead[name]["cow"] > 0))
        c = [o[name]["counts"] for o in outs]
        t = layers * ticks_of[name]
        want = {"k1": t if name == "contiguous" else 0,
                "k2": t if name in ("paged", "int8_weights", "adapter")
                else 0,
                "k3": t if name == "int8_pool" else 0,
                "A": (7 * t + 7 * layers * short
                      if name == "int8_weights" else 0),
                "B": (7 * layers * (len(reqs) - short)
                      if name == "int8_weights" else 0)}
        launches_ok = all({k: x[k] for k in want} == want for x in c)
        run_ok = (same_tp1 and same_gen is not False and launches_ok
                  and hit_ok and lead[name]["tp"] == 2)
        ok = ok and run_ok
        n = max(1, lead[name]["dispatches"])
        log(f"serving tp (a) {name}: tp 2 == tp 1 {same_tp1}"
            + ("" if same_gen is None else f", == generate {same_gen}")
            + f"; prefix-hit tokens {lead[name]['hit_tokens']}, "
            f"copy-on-write blocks {lead[name]['cow']}"
            + f"; launches a rank {[{k: x[k] for k in want} for x in c]} "
            f"(want {want}); all-reduces a rank a dispatch "
            f"{[round(x['reduce_calls'] / n, 1) for x in c]} "
            f"({[round(x['reduce_bytes'] / n) for x in c]} B), all-gathers "
            f"{[round(x['gather_calls'] / n, 1) for x in c]} "
            f"({[round(x['gather_bytes'] / n) for x in c]} B); "
            f"{lead[name]['dispatches']} dispatches, "
            f"{lead[name]['wall_ms']:.2f} ms wall, "
            f"{lead[name]['event_ms']:.2f} ms event a dispatch")
    kern_ok = all(e <= 1e-4 for e in errs.values())
    ok = ok and kern_ok
    log(f"serving tp (a): kernels on a rank's shapes (16 of 32 heads, "
        f"D 128; int8 wq/w1 column halves and wo's row half), f32, max "
        f"|kernel - plain| {errs} (limit 1e-4; A relative to the output's "
        f"largest); init of a rank's two cuts {lead['a_init_s']:.1f}s")
    # (b): first-token logits within 0.15 of tp 1's; the share of tokens
    # equal to 3b's
    burst = lead["burst"]
    depth_read = {}
    for n in r["depths"]:
        got, ref, exact = (lead["first_logits"][n], want_logits[n],
                           f32_logits[n])
        depth_read[n] = {
            "tp2_tp1": (got - ref).abs().max().item(),
            "tp1_f32": (ref - exact).abs().max().item(),
            "tp2_f32": (got - exact).abs().max().item(),
            "logit_max": exact.abs().max().item()}
    # the gates: at the shallowest depth tp 2 within TOL of tp 1 (one
    # card's own bf16 path is closer than TOL to the f32 value there);
    # at full depth, where one card's bf16 path is itself farther than
    # TOL from the f32 value, tp 2 at most TOL farther from it than tp 1
    shallow = depth_read[min(r["depths"])]
    full = depth_read[r["b_layers"]]
    diff = full["tp2_tp1"]
    logits_ok = (shallow["tp2_tp1"] <= BF16_TOL
                 and full["tp2_f32"] <= full["tp1_f32"] + BF16_TOL)
    # the share of burst tokens equal, position by position: tp 2 and
    # 3b's (tp 1, bf16), and the witness beside it — one card's bf16
    # ring and tp 2 against the same ring computed in f32
    same = total = same_f32 = same_tp2_f32 = 0
    for kind, i, p, n in jobs + late:
        got = burst["tokens"][f"{kind}:{i}"][len(p):]
        ref = (ring_tokens or {}).get((kind, i))
        exact = f32_burst[(kind, i)][len(p):]
        if len(got) != n or len(exact) != n or (
                ref is not None and ref[:len(p)] != p):
            raise AssertionError(f"3t (b): {kind} {i} gave {len(got)} "
                                 f"new tokens ({len(exact)} in f32), "
                                 f"want {n}")
        same_tp2_f32 += sum(int(x == y) for x, y in zip(got, exact))
        if ref is not None:
            same += sum(int(x == y) for x, y in zip(got, ref[len(p):]))
            same_f32 += sum(int(x == y) for x, y in zip(ref[len(p):],
                                                         exact))
            total += n
    n_burst = sum(n for _, _, _, n in jobs + late)
    c = [o["burst"]["counts"] for o in outs]
    t = r["b_layers"] * burst["chunks"] * RING["chunk_tokens"]
    b_ok = logits_ok and all(x["k2"] == t for x in c) and burst["tp"] == 2
    ok = ok and b_ok
    n = max(1, burst["dispatches"])
    log(f"serving tp (b): 7b at {r['b_layers']} layers, bf16, 3b's burst "
        f"at tp 2 in {burst['burst_s']:.1f}s ({burst['chunks']} chunks); "
        f"first-token logits max |tp 2 - tp 1| {diff:.4f} (at "
        f"{min(r['depths'])} layers {shallow['tp2_tp1']:.4f}, limit "
        f"{BF16_TOL}; at {r['b_layers']} |tp 2 - f32| "
        f"{full['tp2_f32']:.4f} against |tp 1 - f32| "
        f"{full['tp1_f32']:.4f} + {BF16_TOL}: {logits_ok}); "
        f"tokens equal to 3b's (tp 1) {same} of {total} "
        f"({same / max(1, total):.3f}), beside the witness: 3b's equal to "
        f"the same ring in f32 {same_f32} of {total} "
        f"({same_f32 / max(1, total):.3f}), tp 2's {same_tp2_f32} of "
        f"{n_burst} ({same_tp2_f32 / max(1, n_burst):.3f}; the f32 ring "
        f"{witness_s:.1f}s); kernel #2 launches a rank "
        f"{[x['k2'] for x in c]} (want {t}); all-reduces a rank a "
        f"dispatch {[round(x['reduce_calls'] / n, 1) for x in c]} "
        f"({[round(x['reduce_bytes'] / n) for x in c]} B); "
        f"{burst['wall_ms']:.1f} ms wall, {burst['event_ms']:.1f} ms event "
        f"a dispatch; a rank's init {lead['b_init_s']:.1f}s, peak "
        f"{[round(o['peak_gb'], 2) for o in outs]} GB")
    log("serving tp (b): first-token logits by depth, max |difference| "
        "over the 8 cold prompts (f32: the same bf16 weights computed in "
        "f32): " + json.dumps({n: {k: round(v, 4) for k, v in d.items()}
                               for n, d in depth_read.items()}))
    # (c): SERVE_TP=2 on this one-card pod, refused by name
    named = "SERVE_TP=2 runs one process a card; this pod sees 1 CUDA card"
    err_c = refusal.stderr.read() if refusal.stderr else ""
    c_s = time.perf_counter() - t_c
    c_ok = refusal.returncode not in (0, None) and named in err_c
    ok = ok and c_ok
    log(f"serving tp (c): SERVE_TP=2 on this one-card pod exited "
        f"{refusal.returncode}, refused by name: {named in err_c}; "
        f"3t wall {wall:.1f}s; {card}")
    run = {"a": {name: {k: lead[name][k] for k in
                        ("dispatches", "wall_ms", "event_ms", "chunks")}
                 for name, _, _ in runs},
           "a_kernels_max_abs_err": errs,
           "b": {"layers": r["b_layers"], "logit_diff": diff,
                 "by_depth": depth_read,
                 "tokens_equal": same, "tokens": total,
                 "tokens_equal_tp1_f32": same_f32,
                 "tokens_equal_tp2_f32": same_tp2_f32,
                 "witness_s": witness_s,
                 "wall_ms": burst["wall_ms"],
                 "event_ms": burst["event_ms"]},
           "launches": {name: [o[name]["counts"] for o in outs]
                        for name in [x[0] for x in runs] + ["burst"]},
           "refused": c_ok}
    for rep, name, key, kern in (
            (contiguous, "contiguous", "k1", "decode_attention"),
            (paged, "paged", "k2", "paged_decode_attention"),
            (quant, "int8_pool", "k3", "paged_decode_attention_quant"),
            (qmm, "int8_weights", "A", "quant_matmul")):
        rep["serving_tp"] = {
            "launches_a_rank": [o[name]["counts"][key] for o in outs],
            "max_abs_err_rank_shapes": errs[kern]}
    paged["serving_tp"]["burst_launches_a_rank"] = [x["k2"] for x in c]
    qmm_b["serving_tp"] = {"launches_a_rank": [
        o["int8_weights"]["counts"]["B"] for o in outs]}
    log("serving tp: " + json.dumps(run))
    if not ok:
        raise AssertionError("3t: tensor-parallel serving failed a gate "
                             "(see the lines above)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (default: all; the build always runs)")
    phases = set(ap.parse_args().phases.split(","))
    if phases - set(PHASES):
        ap.error(f"unknown phases {sorted(phases - set(PHASES))}")
    if phases & {"3e", "3n", "3o", "3t"}:
        phases.add("3b")    # 3e, 3n, 3o and 3t are held to 3b's tokens
    if not (ROOT / "paddle_operator_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: the paddle_operator_tpu_torch package is not "
              "beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}; tf32 off")

    from paddle_operator_tpu_torch.ops import _build

    t_all = t0 = time.perf_counter()
    secs = _build.build(KERNELS)
    log(f"build: {json.dumps(secs)} ({time.perf_counter() - t0:.1f}s "
        "wall, parallel)")

    source = "paddle_operator_tpu_torch/csrc/decode_attention.cu"
    contiguous = {"name": "decode_attention", "route": "cuda",
                  "source": source,
                  "replaces": "paddle_operator_tpu/ops/decode_attention.py"
                              ":148"}
    paged = {"name": "paged_decode_attention", "route": "cuda",
             "source": source,
             "replaces": "paddle_operator_tpu/ops/decode_attention.py:281"}
    quant = {"name": "paged_decode_attention_quant", "route": "cuda",
             "source": source,
             "replaces": "paddle_operator_tpu/ops/decode_attention.py:294"}
    qmm = {"name": "quant_matmul", "route": "cuda",
           "source": "paddle_operator_tpu_torch/csrc/quant_matmul.cu",
           # no Pallas kernel: the XLA fusion of decode._mm's quantized
           # branch
           "replaces": "paddle_operator_tpu/infer/decode.py:99"}
    # kernel B: the same fusion at a prefill's rows
    qmm_b = dict(qmm, name="quant_gemm")
    adam8 = {"name": "adam8bit_update", "route": "cuda",
             "source": "paddle_operator_tpu_torch/csrc/adam8bit.cu",
             # no Pallas kernel: the XLA fusion of opt8bit.py's
             # blocked_update and the chain's tail
             "replaces": "paddle_operator_tpu/train/opt8bit.py:169"}
    flash = {kern: {"name": kern, "route": "cuda",
                    "source": "paddle_operator_tpu_torch/csrc/"
                              "flash_attention.cu",
                    "replaces": "paddle_operator_tpu/ops/pallas_attention.py"
                                f":{line}"}
             for kern, line in zip(FLASH_KERNELS, (86, 224, 276))}

    def run(phase, fn, *args):
        if phase in phases:
            t = time.perf_counter()
            out = fn(*args)
            log(f"phase {phase}: {time.perf_counter() - t:.1f}s")
            return out
        return None

    flash_build_report(flash)
    decode_build_report(contiguous, paged, quant)
    quant_build_report(qmm, qmm_b)
    adam8_build_report(adam8)
    log(f"build: flash_attention.cu {secs['flash_attention']:.1f}s")
    run("2", phase_kernel_vs_plain, contiguous)
    run("2b", phase_paged_kernel_vs_plain, paged)
    run("2d", phase_quant_kernel_vs_plain, quant)
    run("2e", phase_quant_matmul_vs_plain, qmm, qmm_b)
    run("2f", phase_adam8bit_vs_plain, adam8)
    run("2c", phase_flash_vs_plain, flash)
    if phases & {"3", "3b", "3d", "3e", "3g", "3h", "3i", "3j", "3l",
                  "3m", "3n", "3o", "3p", "3t"}:
        params, cfg = make_7b()
        run("3", phase_main_path, contiguous, params, cfg)
        ring_tokens = run("3b", phase_ring_main_path, paged, params, cfg)
        gc.collect()        # the servers' reference cycles hold the caches
        torch.cuda.empty_cache()
        run("3d", phase_ring_main_path, quant, params, cfg, "int8",
            paged.get("ring"))
        gc.collect()
        torch.cuda.empty_cache()
        run("3e", phase_ring_main_path, paged, params, cfg, "none",
            paged.get("ring"), 4, ring_tokens)
        gc.collect()
        torch.cuda.empty_cache()
        run("3g", phase_preemption, (paged, quant),
            *_depth_cut(params, cfg, CUT_LAYERS))
        gc.collect()
        torch.cuda.empty_cache()
        run("3h", phase_host_tier, (paged, quant),
            *_depth_cut(params, cfg, TIER_LAYERS),
            _tier_sizes(TIER_LAYERS, cfg))
        gc.collect()
        torch.cuda.empty_cache()
        run("3i", phase_weight_quant_ring, qmm, qmm_b)
        gc.collect()
        torch.cuda.empty_cache()
        runs_3j = run("3j", phase_interleave, (paged, quant), params, cfg)
        gc.collect()
        torch.cuda.empty_cache()
        run("3l", phase_spec_ring, contiguous, qmm, params, cfg,
            ring_tokens, paged.get("ring"))
        gc.collect()
        torch.cuda.empty_cache()
        run("3m", phase_adapter_ring, paged, params, cfg, ring_tokens,
            paged.get("ring"))
        gc.collect()
        torch.cuda.empty_cache()
        run("3n", phase_ring_ops, paged, params, cfg, ring_tokens)
        gc.collect()
        torch.cuda.empty_cache()
        run("3o", phase_disagg, (paged, quant), params, cfg, ring_tokens,
            runs_3j)
        gc.collect()
        torch.cuda.empty_cache()
        run("3p", phase_fleet_kv, (paged, quant),
            *_depth_cut(params, cfg, CUT_LAYERS))
        gc.collect()
        torch.cuda.empty_cache()
        run("3t", phase_serving_tp, (contiguous, paged, quant, qmm, qmm_b),
            params, cfg, ring_tokens)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    run("3c", phase_train_main_path, flash)
    run("3f", phase_checkpoint, flash)
    run("3k", phase_depth_recipe, adam8)
    run("4", phase_kernel_path_equals_plain)
    run("4b", phase_rings_equal_generate)
    run("4c", phase_train_kernel_equals_plain)
    run("4d", phase_quant_ring_kernel_equals_plain)
    run("4e", phase_megastep_rings)
    run("4f", phase_restore_under_graphs)
    run("4g", phase_host_tier_equalities)
    run("4h", phase_weight_quant_equalities)
    run("4i", phase_chunked_equalities)
    run("4j", phase_spec_equalities)
    run("4k", phase_adapter_equalities)
    run("4l", phase_ring_ops_equalities)
    run("4m", phase_disagg_equalities)
    run("4n", phase_fleet_kv_equalities)
    run("3q", phase_moe_train_pod, flash)
    run("3r", phase_moe_serving, paged, qmm, qmm_b)
    run("4o", phase_moe_equalities)
    run("3s", phase_mesh_train_pod, flash)
    log(f"all phases: {time.perf_counter() - t_all:.1f}s")

    order = ["name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "max_abs_err_f32", "max_abs_err_bf16",
             "nan_lanes", "ring_ops",
             "decode_ms_per_step_b4", "kernel1_ms", "paged_bf16_ms", "ring",
             "ring_megastep", "spec", "draft_quant", "preempt", "host_tier",
             "interleave", "disagg", "fleet_kv", "moe", "moe_train",
             "moe_train_launches", "mesh_train", "mesh_train_launches",
             "serving_tp",
             "prefill", "probes_ms",
             "limit_check", "train",
             "checkpoint", "depth",
             "fwd_bwd", "designs",
             "ptxas",
             "timings"]
    print(json.dumps({"kernels": [
        {k: r.get(k) for k in order if k in r or k in order[:11]}
        for r in (contiguous, paged, quant, *flash.values(), qmm, qmm_b,
                  adam8)]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
